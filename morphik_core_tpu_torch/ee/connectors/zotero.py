"""The Zotero connector: port of `morphik_core_tpu/ee/connectors/zotero.py`.

API-key auth against the Zotero web API (`Zotero-API-Key`), the top
items of a user library 100 a page (`?start=`), an item's children, and
an attachment's file. urllib in a thread; `API` is the base URL."""

from __future__ import annotations

import asyncio
import json
import urllib.request
from io import BytesIO
from typing import Any, Dict, List, Optional

from morphik_core_tpu_torch.ee.connectors.base import BaseConnector, ConnectorAuthStatus, ConnectorFile

API = "https://api.zotero.org"


class ZoteroConnector(BaseConnector):
    connector_type = "zotero"

    def _creds(self) -> Dict[str, Any]:
        creds = self._load_credentials()
        if not creds or not creds.get("api_key") or not creds.get("user_library_id"):
            raise PermissionError("zotero connector not configured")
        return creds

    def _request(self, url: str, api_key: str, raw: bool = False) -> Any:
        req = urllib.request.Request(url, headers={"Zotero-API-Key": api_key})
        with urllib.request.urlopen(req, timeout=60) as resp:
            data = resp.read()
        return data if raw else json.loads(data)

    async def get_auth_status(self) -> ConnectorAuthStatus:
        try:
            self._creds()
        except PermissionError:
            return ConnectorAuthStatus(is_authenticated=False,
                                       message="provide api_key + user_library_id via finalize_auth")
        return ConnectorAuthStatus(is_authenticated=True)

    async def initiate_auth(self) -> Dict[str, Any]:
        return {"credentials_required": ["api_key", "user_library_id"]}

    async def finalize_auth(self, auth_response_data: Dict[str, Any]) -> bool:
        if not auth_response_data.get("api_key") or not auth_response_data.get("user_library_id"):
            return False
        self._save_credentials({"api_key": auth_response_data["api_key"],
                                "user_library_id": str(auth_response_data["user_library_id"])})
        return True

    @staticmethod
    def _to_file(item: Dict[str, Any]) -> ConnectorFile:
        data = item.get("data", {})
        return ConnectorFile(
            id=item.get("key", data.get("key", "")),
            name=data.get("title") or data.get("filename") or item.get("key", ""),
            is_folder=data.get("itemType") not in ("attachment",),
            mime_type=data.get("contentType"),
            modified_date=data.get("dateModified"),
        )

    async def list_files(self, path: Optional[str] = None, page_token: Optional[str] = None,
                         **kwargs) -> Dict[str, Any]:
        creds = self._creds()
        start = int(page_token or 0)
        if path:  # an item's children (its attachments)
            url = f"{API}/users/{creds['user_library_id']}/items/{path}/children?start={start}&limit=100"
        else:
            url = f"{API}/users/{creds['user_library_id']}/items/top?start={start}&limit=100"
        items: List[Dict[str, Any]] = await asyncio.to_thread(self._request, url, creds["api_key"])
        next_token = str(start + 100) if len(items) == 100 else None
        return {"files": [self._to_file(i) for i in items], "next_page_token": next_token}

    async def download_file_by_id(self, file_id: str) -> Optional[BytesIO]:
        creds = self._creds()
        url = f"{API}/users/{creds['user_library_id']}/items/{file_id}/file"
        return BytesIO(await asyncio.to_thread(self._request, url, creds["api_key"], True))

    async def get_file_metadata_by_id(self, file_id: str) -> Optional[ConnectorFile]:
        creds = self._creds()
        item = await asyncio.to_thread(self._request, f"{API}/users/{creds['user_library_id']}/items/{file_id}",
                                       creds["api_key"])
        return self._to_file(item)
