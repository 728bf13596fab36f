"""The connector framework: port of `morphik_core_tpu/ee/connectors/base.py`.

A connector links a user's external content source (GitHub repo, Google
Drive, Zotero library, server directory) to ingestion: authenticate,
list files, download by id. Credentials are stored per (connector, user)
as JSON files under a confined credentials directory, written byte for
byte as the reference writes them, so either package reads the other's.
`ConnectorFile` and `ConnectorAuthStatus` are dataclass mirrors of the
reference's pydantic models: `model_dump(mode="json")` gives the same
dict, in the same key order.
"""

from __future__ import annotations

import hashlib
import json
import re
from abc import ABC, abstractmethod
from dataclasses import dataclass
from io import BytesIO
from pathlib import Path
from typing import Any, Dict, Optional

from morphik_core_tpu_torch.models.schemas import _Model


@dataclass
class ConnectorFile(_Model):
    id: str
    name: str
    is_folder: bool = False
    mime_type: Optional[str] = None
    size: Optional[int] = None
    modified_date: Optional[str] = None


@dataclass
class ConnectorAuthStatus(_Model):
    is_authenticated: bool
    message: Optional[str] = None
    auth_url: Optional[str] = None


def sanitize_user_id(user_id: str) -> str:
    """Filesystem-safe, collision-resistant identifier."""
    safe = re.sub(r"[^A-Za-z0-9_-]", "_", user_id).strip("_")[:32]
    digest = hashlib.sha256(user_id.encode()).hexdigest()[:8]
    return f"{safe}_{digest}" if safe else f"user_{digest}"


class BaseConnector(ABC):
    connector_type: str = "base"

    def __init__(self, user_id: str, credentials_dir: str | Path = "./storage/connector_credentials"):
        self.user_id = user_id
        self.user_storage_id = sanitize_user_id(user_id)
        self.credentials_dir = Path(credentials_dir)

    # -------------------------------------------------- credential storage

    def _confined(self, name: str) -> Path:
        """`name` inside the credentials directory (created), resolved;
        a path that escapes it raises."""
        self.credentials_dir.mkdir(parents=True, exist_ok=True)
        base = self.credentials_dir.resolve()
        p = (base / name).resolve()
        if base not in p.parents:
            raise ValueError("credential path escapes credentials dir")
        return p

    def _cred_path(self) -> Path:
        return self._confined(f"{self.connector_type}_{self.user_storage_id}.json")

    def _save_credentials(self, creds: Dict[str, Any]) -> None:
        self._cred_path().write_text(json.dumps(creds))

    def _load_credentials(self) -> Optional[Dict[str, Any]]:
        p = self._cred_path()
        if not p.exists():
            return None
        try:
            return json.loads(p.read_text())
        except json.JSONDecodeError:
            return None

    def _delete_credentials(self) -> bool:
        p = self._cred_path()
        if p.exists():
            p.unlink()
            return True
        return False

    # ----------------------------------------------------------- interface

    @abstractmethod
    async def get_auth_status(self) -> ConnectorAuthStatus: ...

    @abstractmethod
    async def initiate_auth(self) -> Dict[str, Any]:
        """-> {"auth_url": ..., "state": ...} or {"credentials_required": [...]}"""

    @abstractmethod
    async def finalize_auth(self, auth_response_data: Dict[str, Any]) -> bool: ...

    @abstractmethod
    async def list_files(self, path: Optional[str] = None, page_token: Optional[str] = None,
                         **kwargs) -> Dict[str, Any]:
        """-> {"files": List[ConnectorFile], "next_page_token": Optional[str]}"""

    @abstractmethod
    async def download_file_by_id(self, file_id: str) -> Optional[BytesIO]: ...

    @abstractmethod
    async def get_file_metadata_by_id(self, file_id: str) -> Optional[ConnectorFile]: ...

    async def disconnect(self) -> bool:
        return self._delete_credentials()
