"""The server-directory connector: port of
`morphik_core_tpu/ee/connectors/local.py`, a directory tree behind the
connector interface.

Difference from the reference, recorded in ROADMAP Queue 3: a root that
equals, contains or lies inside the directory that holds the credentials
directory (`storage.storage_path` on a server) is refused, by
`finalize_auth` and when stored credentials name one. The reference takes
any server directory, so any user could read the other users' OAuth
tokens and the index files through `files` and `ingest`.
"""

from __future__ import annotations

from datetime import datetime, timezone
from io import BytesIO
from pathlib import Path
from typing import Any, Dict, Optional

from morphik_core_tpu_torch.ee.connectors.base import BaseConnector, ConnectorAuthStatus, ConnectorFile
from morphik_core_tpu_torch.storage.content_types import detect_content_type


class LocalDirectoryConnector(BaseConnector):
    connector_type = "local"

    def _allowed_root(self, root: Path) -> bool:
        """Neither the credentials directory's parent, nor inside it, nor
        above it."""
        root = root.resolve()
        guarded = self.credentials_dir.resolve().parent
        return root != guarded and root not in guarded.parents and guarded not in root.parents

    def _root(self) -> Optional[Path]:
        creds = self._load_credentials()
        if not creds or "root" not in creds or not self._allowed_root(Path(creds["root"])):
            return None
        return Path(creds["root"])

    def _resolve(self, file_id: str) -> Path:
        root = self._root()
        if root is None:
            raise PermissionError("connector not configured")
        p = (root / file_id).resolve()
        if root.resolve() != p and root.resolve() not in p.parents:
            raise ValueError("path escapes connector root")
        return p

    async def get_auth_status(self) -> ConnectorAuthStatus:
        root = self._root()
        if root is None or not root.is_dir():
            return ConnectorAuthStatus(is_authenticated=False,
                                       message="set a root directory via finalize_auth({'root': ...})")
        return ConnectorAuthStatus(is_authenticated=True, message=f"root={root}")

    async def initiate_auth(self) -> Dict[str, Any]:
        return {"credentials_required": ["root"]}

    async def finalize_auth(self, auth_response_data: Dict[str, Any]) -> bool:
        root = auth_response_data.get("root")
        if not root or not Path(root).is_dir() or not self._allowed_root(Path(root)):
            return False
        self._save_credentials({"root": str(Path(root).resolve())})
        return True

    def _to_file(self, p: Path, root: Path) -> ConnectorFile:
        st = p.stat()
        return ConnectorFile(
            id=str(p.relative_to(root)),
            name=p.name,
            is_folder=p.is_dir(),
            mime_type=None if p.is_dir() else detect_content_type(b"", p.name),
            size=None if p.is_dir() else st.st_size,
            modified_date=datetime.fromtimestamp(st.st_mtime, timezone.utc).isoformat(),
        )

    async def list_files(self, path: Optional[str] = None, page_token: Optional[str] = None,
                         **kwargs) -> Dict[str, Any]:
        root = self._root()
        if root is None:
            return {"files": [], "next_page_token": None}
        base = self._resolve(path) if path else root
        entries = sorted(base.iterdir(), key=lambda p: (not p.is_dir(), p.name))
        start = int(page_token or 0)
        page = entries[start : start + 100]
        next_token = str(start + 100) if start + 100 < len(entries) else None
        return {"files": [self._to_file(p, root) for p in page], "next_page_token": next_token}

    async def download_file_by_id(self, file_id: str) -> Optional[BytesIO]:
        p = self._resolve(file_id)
        if not p.is_file():
            return None
        return BytesIO(p.read_bytes())

    async def get_file_metadata_by_id(self, file_id: str) -> Optional[ConnectorFile]:
        root = self._root()
        p = self._resolve(file_id)
        if not p.exists():
            return None
        return self._to_file(p, root)
