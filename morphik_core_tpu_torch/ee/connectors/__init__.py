"""The connectors of `morphik_core_tpu/ee/connectors/`: a user's GitHub
repo, Google Drive, Zotero library or server directory, listed and
downloaded for ingestion."""
from morphik_core_tpu_torch.ee.connectors.base import (  # noqa: F401
    BaseConnector,
    ConnectorAuthStatus,
    ConnectorFile,
)
from morphik_core_tpu_torch.ee.connectors.registry import get_connector  # noqa: F401
