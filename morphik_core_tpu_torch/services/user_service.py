"""User tiers, usage limits and the app registry: port of
`morphik_core_tpu/services/user_service.py`, in the same
`{storage_path}/user_limits.db` file and DDL, so that either package's
server sees the usage the other counted and the apps and token versions
it registered (a token revoked by a rotation on one server is refused by
the other, `api/app.py::auth_of`).

Limits bite only when `enforce` is set (`morphik.mode="cloud"`): a
self-hosted server is unlimited. `check_and_increment_limits` has the
reference's `verify_only` dry run; its guarded `UPDATE` is what holds
the cap under concurrent requests. Usage periods last 30 days.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from morphik_core_tpu_torch.models.tiers import TIER_LIMITS, AccountTier

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


_MONTH_S = 30 * 24 * 3600


class LimitExceededError(Exception):
    def __init__(self, limit_type: str, detail: str = ""):
        self.limit_type = limit_type
        super().__init__(f"limit exceeded: {limit_type}. {detail}".strip())


class UserService:
    def __init__(self, path: str | Path = ":memory:", enforce: bool = False):
        self.path = str(path)
        self.enforce = enforce
        if self.path != ":memory:":
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.RLock()
        self._conn.executescript(_SCHEMA)

    def _row(self, user_id: str) -> sqlite3.Row:
        """The user's usage row, created on first sight."""
        with self._lock:
            row = self._conn.execute("SELECT * FROM user_limits WHERE user_id=?", (user_id,)).fetchone()
            if row is None:
                self._conn.execute("INSERT INTO user_limits (user_id, period_start) VALUES (?, ?)",
                                   (user_id, time.time()))
                self._conn.commit()
                row = self._conn.execute("SELECT * FROM user_limits WHERE user_id=?", (user_id,)).fetchone()
            return row

    def _maybe_reset_period(self, user_id: str, row: sqlite3.Row) -> sqlite3.Row:
        """Zero the monthly counters once the period is over 30 days old."""
        if row["period_start"] and time.time() - row["period_start"] > _MONTH_S:
            with self._lock:
                self._conn.execute(
                    "UPDATE user_limits SET pages_used=0, queries_used=0, period_start=? WHERE user_id=?",
                    (time.time(), user_id),
                )
                self._conn.commit()
            return self._row(user_id)
        return row

    async def get_user_limits(self, user_id: str) -> Dict[str, Any]:
        row = self._maybe_reset_period(user_id, self._row(user_id))
        tier = AccountTier(row["tier"])
        return {
            "user_id": user_id,
            "tier": tier.value,
            "usage": {
                "pages_used": row["pages_used"],
                "queries_used": row["queries_used"],
                "storage_bytes": row["storage_bytes"],
                "apps_used": row["apps_used"],
            },
            "limits": TIER_LIMITS[tier],
        }

    async def set_tier(self, user_id: str, tier: str) -> None:
        self._row(user_id)
        with self._lock:
            self._conn.execute("UPDATE user_limits SET tier=? WHERE user_id=?", (AccountTier(tier).value, user_id))
            self._conn.commit()

    async def check_and_increment_limits(
        self,
        user_id: Optional[str],
        limit_type: str,
        amount: float = 1.0,
        *,
        verify_only: bool = False,
    ) -> None:
        """Count `amount` of `limit_type` (pages, queries, storage, apps)
        against the user's tier; raises LimitExceededError when it would
        cross the quota. `verify_only` checks without counting."""
        if not self.enforce or user_id is None:
            return
        row = self._maybe_reset_period(user_id, self._row(user_id))
        tier = AccountTier(row["tier"])
        limits = TIER_LIMITS[tier]
        col, cap = {
            "pages": ("pages_used", limits["pages_per_month"]),
            "queries": ("queries_used", limits["queries_per_month"]),
            "storage": ("storage_bytes", limits["storage_bytes"]),
            "apps": ("apps_used", limits["apps"]),
        }[limit_type]
        if cap is not None and row[col] + amount > cap:
            raise LimitExceededError(limit_type, f"{row[col]}+{amount} > {cap} ({tier.value})")
        if verify_only:
            return
        with self._lock:
            # the read above is advisory (its message); this guarded
            # UPDATE is what holds the cap under concurrent requests
            if cap is not None:
                cur = self._conn.execute(
                    f"UPDATE user_limits SET {col} = {col} + ? WHERE user_id = ? AND {col} + ? <= ?",
                    (amount, user_id, amount, cap),
                )
                if cur.rowcount == 0:
                    self._conn.commit()
                    raise LimitExceededError(limit_type, f"quota exceeded ({tier.value})")
            else:
                self._conn.execute(f"UPDATE user_limits SET {col} = {col} + ? WHERE user_id = ?", (amount, user_id))
            self._conn.commit()

    async def register_app(self, app_id: str, name: str, user_id: str, uri: str,
                           org_id: Optional[str] = None) -> Dict[str, Any]:
        """Insert or replace the app; a re-registration keeps its token
        version and does not count against the apps quota again."""
        if await self.get_app(app_id) is None:
            await self.check_and_increment_limits(user_id, "apps", 1)
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
