"""The connector factory: port of `morphik_core_tpu/ee/connectors/registry.py`.

Difference from the reference, recorded in ROADMAP Queue 3: Google
Drive's OAuth client comes from the `ee` settings the caller passes (the
app that serves the request passes its own); the reference reads the
process-wide `get_settings().ee`, which this falls back to when given
none."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Type

from morphik_core_tpu_torch.config import EEConfig, get_settings
from morphik_core_tpu_torch.ee.connectors.base import BaseConnector
from morphik_core_tpu_torch.ee.connectors.github import GitHubConnector
from morphik_core_tpu_torch.ee.connectors.google_drive import GoogleDriveConnector
from morphik_core_tpu_torch.ee.connectors.local import LocalDirectoryConnector
from morphik_core_tpu_torch.ee.connectors.zotero import ZoteroConnector

CONNECTORS: Dict[str, Type[BaseConnector]] = {
    "local": LocalDirectoryConnector,
    "github": GitHubConnector,
    "google_drive": GoogleDriveConnector,
    "zotero": ZoteroConnector,
}


def get_connector(connector_type: str, user_id: str,
                  credentials_dir: str | Path = "./storage/connector_credentials",
                  ee: Optional[EEConfig] = None) -> BaseConnector:
    cls = CONNECTORS.get(connector_type)
    if cls is None:
        raise KeyError(f"unknown connector type: {connector_type}")
    if connector_type == "google_drive":
        ee = ee if ee is not None else get_settings().ee
        return cls(user_id, credentials_dir, client_id=ee.google_client_id,
                   client_secret=ee.google_client_secret, redirect_uri=ee.google_redirect_uri)
    return cls(user_id, credentials_dir)
