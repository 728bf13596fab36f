"""The app registry of `morphik_core_tpu/services/user_service.py`
(`register_app`, `get_app`, `list_apps`, `delete_app`,
`rotate_app_token`, `rename_app`, `:161-237`) in the same
`{storage_path}/user_limits.db` file and DDL, so that either package
reads the other's apps and token versions: a token revoked by a rotation
on one server is refused by the other (`api/app.py::auth_of`).

The tier limits of that module (`get_user_limits`,
`check_and_increment_limits`, HTTP 402) only bite in
`morphik.mode="cloud"`, which `build_services` refuses (ROADMAP Queue 1
item 3e): the registry never counts against a quota here, and
`delete_app` keeps the reference's `apps_used` bookkeeping so that a
shared file stays consistent.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS user_limits (
    user_id TEXT PRIMARY KEY,
    tier TEXT DEFAULT 'free',
    pages_used REAL DEFAULT 0,
    queries_used INTEGER DEFAULT 0,
    storage_bytes INTEGER DEFAULT 0,
    apps_used INTEGER DEFAULT 0,
    period_start REAL,
    custom_limits TEXT
);
CREATE TABLE IF NOT EXISTS apps (
    app_id TEXT PRIMARY KEY,
    name TEXT,
    user_id TEXT,
    org_id TEXT,
    uri TEXT,
    token_version INTEGER DEFAULT 1,
    created_at REAL
);
"""


class UserService:
    def __init__(self, path: str | Path = ":memory:"):
        self.path = str(path)
        if self.path != ":memory:":
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.RLock()
        self._conn.executescript(_SCHEMA)

    async def register_app(self, app_id: str, name: str, user_id: str, uri: str,
                           org_id: Optional[str] = None) -> Dict[str, Any]:
        """Insert or replace the app; a re-registration keeps its token version."""
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO apps (app_id, name, user_id, org_id, uri, token_version, created_at)"
                " VALUES (?,?,?,?,?,COALESCE((SELECT token_version FROM apps WHERE app_id=?),1),?)",
                (app_id, name, user_id, org_id, uri, app_id, time.time()),
            )
            self._conn.commit()
        return (await self.get_app(app_id)) or {}

    async def get_app(self, app_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            row = self._conn.execute("SELECT * FROM apps WHERE app_id=?", (app_id,)).fetchone()
        return dict(row) if row else None

    async def list_apps(self, user_id: Optional[str] = None, org_id: Optional[str] = None) -> List[Dict[str, Any]]:
        sql, params, clauses = "SELECT * FROM apps", [], []
        if user_id:
            clauses.append("user_id=?")
            params.append(user_id)
        if org_id:
            clauses.append("org_id=?")
            params.append(org_id)
        if clauses:
            sql += " WHERE " + " AND ".join(clauses)
        with self._lock:
            rows = self._conn.execute(sql + " ORDER BY created_at", params).fetchall()
        return [dict(r) for r in rows]

    async def delete_app(self, app_id: str, user_id: str) -> bool:
        with self._lock:
            cur = self._conn.execute("DELETE FROM apps WHERE app_id=? AND user_id=?", (app_id, user_id))
            if cur.rowcount:
                self._conn.execute(
                    "UPDATE user_limits SET apps_used = MAX(apps_used - 1, 0) WHERE user_id=?", (user_id,)
                )
            self._conn.commit()
        return bool(cur.rowcount)

    async def rotate_app_token(self, app_id: str, user_id: str) -> Optional[int]:
        """Bump token_version: tokens minted at the old version stop
        verifying. -> the new version, None for an app not found."""
        with self._lock:
            cur = self._conn.execute(
                "UPDATE apps SET token_version = token_version + 1 WHERE app_id=? AND user_id=?", (app_id, user_id)
            )
            self._conn.commit()
        if not cur.rowcount:
            return None
        app = await self.get_app(app_id)
        return int(app["token_version"]) if app else None

    async def rename_app(self, app_id: str, user_id: str, new_name: str) -> bool:
        with self._lock:
            cur = self._conn.execute("UPDATE apps SET name=? WHERE app_id=? AND user_id=?", (new_name, app_id, user_id))
            self._conn.commit()
        return bool(cur.rowcount)

    def close(self) -> None:
        self._conn.close()
