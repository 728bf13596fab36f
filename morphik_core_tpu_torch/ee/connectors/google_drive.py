"""The Google Drive connector: port of
`morphik_core_tpu/ee/connectors/google_drive.py`.

The OAuth2 authorization-code flow with a single-use state, the token
refresh, and the Drive v3 `files` list, get, download and export.
urllib in a thread; `_request_json` / `_request_bytes` / `_post_form`
are the seams, `AUTH_URL`, `TOKEN_URL` and `API` the endpoints.

Difference from the reference, recorded in ROADMAP Queue 3: the OAuth
state file is named with the sanitized user id and confined to the
credentials directory, as the credentials are; the reference names it
with the raw user id, so an id with path separators writes it elsewhere.
"""

from __future__ import annotations

import asyncio
import json
import secrets
import time
import urllib.parse
import urllib.request
from io import BytesIO
from pathlib import Path
from typing import Any, Dict, Optional

from morphik_core_tpu_torch.ee.connectors.base import BaseConnector, ConnectorAuthStatus, ConnectorFile

AUTH_URL = "https://accounts.google.com/o/oauth2/v2/auth"
TOKEN_URL = "https://oauth2.googleapis.com/token"
API = "https://www.googleapis.com/drive/v3"
SCOPE = "https://www.googleapis.com/auth/drive.readonly"


class GoogleDriveConnector(BaseConnector):
    connector_type = "google_drive"

    def __init__(self, user_id: str, credentials_dir="./storage/connector_credentials",
                 client_id: Optional[str] = None, client_secret: Optional[str] = None,
                 redirect_uri: str = "http://localhost:8000/ee/connectors/google_drive/oauth2callback"):
        super().__init__(user_id, credentials_dir)
        self.client_id = client_id
        self.client_secret = client_secret
        self.redirect_uri = redirect_uri

    # ------------------------------------------------------------ transport

    def _post_form(self, url: str, data: Dict[str, str]) -> Dict[str, Any]:
        req = urllib.request.Request(url, data=urllib.parse.urlencode(data).encode())
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())

    def _request_json(self, url: str, token: str) -> Dict[str, Any]:
        req = urllib.request.Request(url, headers={"Authorization": f"Bearer {token}"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())

    def _request_bytes(self, url: str, token: str) -> bytes:
        req = urllib.request.Request(url, headers={"Authorization": f"Bearer {token}"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.read()

    # ----------------------------------------------------------------- auth

    async def get_auth_status(self) -> ConnectorAuthStatus:
        creds = self._load_credentials()
        if not creds or not creds.get("access_token"):
            return ConnectorAuthStatus(is_authenticated=False, message="OAuth required", auth_url=None)
        return ConnectorAuthStatus(is_authenticated=True)

    async def initiate_auth(self) -> Dict[str, Any]:
        if not self.client_id:
            return {"credentials_required": ["client_id", "client_secret"],
                    "message": "google oauth client not configured"}
        state = secrets.token_urlsafe(16)
        self._state_path().write_text(state)
        params = {"client_id": self.client_id, "redirect_uri": self.redirect_uri, "response_type": "code",
                  "scope": SCOPE, "access_type": "offline", "state": state}
        return {"auth_url": f"{AUTH_URL}?{urllib.parse.urlencode(params)}", "state": state}

    def _state_path(self) -> Path:
        return self._confined(f"{self.user_storage_id}.google_drive.oauth_state")

    def _consume_oauth_state(self) -> Optional[str]:
        p = self._state_path()
        if not p.exists():
            return None
        state = p.read_text().strip()
        p.unlink(missing_ok=True)  # single use
        return state

    def _save_token(self, access_token: str, refresh_token: Optional[str], expires_in: float) -> None:
        self._save_credentials({"access_token": access_token, "refresh_token": refresh_token,
                                "expires_at": time.time() + expires_in})

    async def finalize_auth(self, auth_response_data: Dict[str, Any]) -> bool:
        code = auth_response_data.get("code")
        if code and self.client_id:
            # CSRF / code-injection guard: the callback's state must be the
            # one this user's initiate_auth issued (single use)
            issued = self._consume_oauth_state()
            if issued is None or auth_response_data.get("state") != issued:
                return False
        if not code or not self.client_id:
            # a token given directly (service accounts, tests)
            if auth_response_data.get("access_token"):
                self._save_token(auth_response_data["access_token"], auth_response_data.get("refresh_token"), 3600)
                return True
            return False
        tok = await asyncio.to_thread(self._post_form, TOKEN_URL, {
            "code": code, "client_id": self.client_id, "client_secret": self.client_secret or "",
            "redirect_uri": self.redirect_uri, "grant_type": "authorization_code"})
        if "access_token" not in tok:
            return False
        self._save_token(tok["access_token"], tok.get("refresh_token"), float(tok.get("expires_in", 3600)))
        return True

    async def _token(self) -> str:
        creds = self._load_credentials()
        if not creds:
            raise PermissionError("google drive connector not authenticated")
        if creds.get("expires_at", 0) < time.time() and creds.get("refresh_token") and self.client_id:
            tok = await asyncio.to_thread(self._post_form, TOKEN_URL, {
                "refresh_token": creds["refresh_token"], "client_id": self.client_id,
                "client_secret": self.client_secret or "", "grant_type": "refresh_token"})
            creds["access_token"] = tok.get("access_token", creds["access_token"])
            creds["expires_at"] = time.time() + float(tok.get("expires_in", 3600))
            self._save_credentials(creds)
        return creds["access_token"]

    # ---------------------------------------------------------------- files

    @staticmethod
    def _to_file(e: Dict[str, Any]) -> ConnectorFile:
        return ConnectorFile(
            id=e["id"],
            name=e.get("name", e["id"]),
            is_folder=e.get("mimeType") == "application/vnd.google-apps.folder",
            mime_type=e.get("mimeType"),
            size=int(e["size"]) if e.get("size") else None,
            modified_date=e.get("modifiedTime"),
        )

    async def list_files(self, path: Optional[str] = None, page_token: Optional[str] = None,
                         **kwargs) -> Dict[str, Any]:
        token = await self._token()
        params = {"q": f"'{path or 'root'}' in parents and trashed = false",
                  "fields": "nextPageToken, files(id,name,mimeType,size,modifiedTime)", "pageSize": "100"}
        if page_token:
            params["pageToken"] = page_token
        data = await asyncio.to_thread(self._request_json, f"{API}/files?{urllib.parse.urlencode(params)}", token)
        return {"files": [self._to_file(e) for e in data.get("files", [])],
                "next_page_token": data.get("nextPageToken")}

    async def download_file_by_id(self, file_id: str) -> Optional[BytesIO]:
        token = await self._token()
        meta = await self.get_file_metadata_by_id(file_id)
        if meta is None or meta.is_folder:
            return None
        if meta.mime_type and meta.mime_type.startswith("application/vnd.google-apps"):
            url = f"{API}/files/{file_id}/export?mimeType=application/pdf"
        else:
            url = f"{API}/files/{file_id}?alt=media"
        return BytesIO(await asyncio.to_thread(self._request_bytes, url, token))

    async def get_file_metadata_by_id(self, file_id: str) -> Optional[ConnectorFile]:
        token = await self._token()
        data = await asyncio.to_thread(self._request_json,
                                       f"{API}/files/{file_id}?fields=id,name,mimeType,size,modifiedTime", token)
        return self._to_file(data)
