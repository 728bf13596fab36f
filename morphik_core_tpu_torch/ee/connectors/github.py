"""The GitHub connector: port of `morphik_core_tpu/ee/connectors/github.py`.

Personal-access-token auth, the contents API listed 100 entries a page
(`?page=`), a file downloaded from its base64 `content` or its
`download_url`, and the recursive tree of `list_repository_tree`. The
transport is urllib in a thread (`asyncio.to_thread`), off the event
loop; `_request_json` / `_request_bytes` are the seams, and `API` the
base URL."""

from __future__ import annotations

import asyncio
import base64
import json
import urllib.request
from io import BytesIO
from typing import Any, Dict, Optional

from morphik_core_tpu_torch.ee.connectors.base import BaseConnector, ConnectorAuthStatus, ConnectorFile

API = "https://api.github.com"


class GitHubConnector(BaseConnector):
    connector_type = "github"

    def _headers(self) -> Dict[str, str]:
        creds = self._load_credentials() or {}
        h = {"Accept": "application/vnd.github+json", "User-Agent": "morphik-tpu"}
        if creds.get("token"):
            h["Authorization"] = f"Bearer {creds['token']}"
        return h

    def _request_json(self, url: str) -> Any:
        req = urllib.request.Request(url, headers=self._headers())
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())

    def _request_bytes(self, url: str) -> bytes:
        req = urllib.request.Request(url, headers=self._headers())
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.read()

    async def get_auth_status(self) -> ConnectorAuthStatus:
        creds = self._load_credentials()
        if not creds or not creds.get("token"):
            return ConnectorAuthStatus(
                is_authenticated=False,
                message="provide a GitHub personal access token via finalize_auth({'token': ..., 'repo': 'owner/name'})",
            )
        return ConnectorAuthStatus(is_authenticated=True, message=f"repo={creds.get('repo', '(unset)')}")

    async def initiate_auth(self) -> Dict[str, Any]:
        return {"credentials_required": ["token", "repo"]}

    async def finalize_auth(self, auth_response_data: Dict[str, Any]) -> bool:
        token = auth_response_data.get("token")
        repo = auth_response_data.get("repo")
        if not token or not repo or "/" not in repo:
            return False
        self._save_credentials({"token": token, "repo": repo})
        return True

    def _repo(self) -> str:
        repo = (self._load_credentials() or {}).get("repo")
        if not repo:
            raise PermissionError("github connector not configured")
        return repo

    @staticmethod
    def _to_file(entry: Dict[str, Any]) -> ConnectorFile:
        return ConnectorFile(id=entry["path"], name=entry["name"], is_folder=entry.get("type") == "dir",
                             size=entry.get("size"), mime_type=None)

    async def list_files(self, path: Optional[str] = None, page_token: Optional[str] = None,
                         **kwargs) -> Dict[str, Any]:
        # the contents API caps a listing at 1000 entries: without ?page=
        # a big directory would be cut short with no signal
        page = int(page_token) if page_token else 1
        url = f"{API}/repos/{self._repo()}/contents/{path or ''}?per_page=100&page={page}"
        entries = await asyncio.to_thread(self._request_json, url)
        if isinstance(entries, dict):  # a single file
            entries = [entries]
        next_token = str(page + 1) if len(entries) == 100 else None
        return {"files": [self._to_file(e) for e in entries], "next_page_token": next_token}

    async def download_file_by_id(self, file_id: str) -> Optional[BytesIO]:
        entry = await asyncio.to_thread(self._request_json, f"{API}/repos/{self._repo()}/contents/{file_id}")
        if isinstance(entry, list):
            return None  # a directory
        if entry.get("encoding") == "base64" and entry.get("content"):
            return BytesIO(base64.b64decode(entry["content"]))
        if entry.get("download_url"):
            return BytesIO(await asyncio.to_thread(self._request_bytes, entry["download_url"]))
        return None

    async def get_file_metadata_by_id(self, file_id: str) -> Optional[ConnectorFile]:
        entry = await asyncio.to_thread(self._request_json, f"{API}/repos/{self._repo()}/contents/{file_id}")
        if isinstance(entry, list):
            return ConnectorFile(id=file_id, name=file_id.rsplit("/", 1)[-1], is_folder=True)
        return self._to_file(entry)

    async def list_repository_tree(self, branch: str = "HEAD") -> Dict[str, Any]:
        """The repository's whole tree, recursively."""
        tree = await asyncio.to_thread(self._request_json, f"{API}/repos/{self._repo()}/git/trees/{branch}?recursive=1")
        files = [ConnectorFile(id=e["path"], name=e["path"].rsplit("/", 1)[-1], is_folder=(e["type"] == "tree"),
                               size=e.get("size"))
                 for e in tree.get("tree", [])]
        return {"files": files, "truncated": tree.get("truncated", False)}
