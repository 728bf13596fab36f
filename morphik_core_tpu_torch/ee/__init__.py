"""Enterprise extensions of the port: the external-source connectors of
`morphik_core_tpu/ee/`."""
from morphik_core_tpu_torch.ee.connectors.base import (  # noqa: F401
    BaseConnector,
    ConnectorAuthStatus,
    ConnectorFile,
)
from morphik_core_tpu_torch.ee.connectors.registry import get_connector  # noqa: F401
