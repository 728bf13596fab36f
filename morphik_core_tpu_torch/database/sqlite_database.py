"""Metadata database on sqlite (stdlib): port of
`morphik_core_tpu/database/sqlite_database.py`: documents, folders (with
the tenant-scoped subtree rewrites of move and rename), chats, model
configs and storage-usage accounting. The DDL and the SQL are the
reference's, verbatim, so a database written by either package opens in
the other.

Access control follows the reference (cloud mode scopes by app_id,
self-hosted by owner_id); retrieval only sees status='completed'
documents; the metadata-filter tree compiles to SQL with an evaluator
fallback (database/metadata_filters.py).
"""

from __future__ import annotations

import json
import logging
import sqlite3
import threading
import uuid
from datetime import UTC, datetime
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from morphik_core_tpu_torch.database.metadata_filters import (
    compile_filter_sql,
    matches_filter,
    register_sql_functions,
)
from morphik_core_tpu_torch.models.schemas import AuthContext, Document

logger = logging.getLogger(__name__)


def _now_iso() -> str:
    return datetime.now(UTC).isoformat()


def _json_default(o: Any) -> Any:
    if isinstance(o, datetime):
        return o.isoformat()
    return str(o)


_SCHEMA = """
CREATE TABLE IF NOT EXISTS documents (
    external_id TEXT PRIMARY KEY,
    owner_id TEXT,
    app_id TEXT,
    content_type TEXT,
    filename TEXT,
    doc_metadata TEXT DEFAULT '{}',
    metadata_types TEXT DEFAULT '{}',
    storage_info TEXT DEFAULT '{}',
    system_metadata TEXT DEFAULT '{}',
    additional_metadata TEXT DEFAULT '{}',
    chunk_ids TEXT DEFAULT '[]',
    folder_name TEXT,
    folder_path TEXT,
    folder_id TEXT,
    end_user_id TEXT,
    status TEXT DEFAULT 'processing',
    created_at TEXT,
    updated_at TEXT
);
CREATE INDEX IF NOT EXISTS idx_docs_owner ON documents(owner_id);
CREATE INDEX IF NOT EXISTS idx_docs_app ON documents(app_id);
CREATE INDEX IF NOT EXISTS idx_docs_folder_path ON documents(folder_path);
CREATE INDEX IF NOT EXISTS idx_docs_status ON documents(status);
CREATE INDEX IF NOT EXISTS idx_docs_filename ON documents(filename);

CREATE TABLE IF NOT EXISTS folders (
    id TEXT PRIMARY KEY,
    name TEXT,
    path TEXT,
    parent_id TEXT,
    owner_id TEXT,
    app_id TEXT,
    description TEXT,
    system_metadata TEXT DEFAULT '{}',
    created_at TEXT,
    updated_at TEXT
);
CREATE UNIQUE INDEX IF NOT EXISTS idx_folders_scope_path ON folders(COALESCE(app_id,''), COALESCE(owner_id,''), path);

CREATE TABLE IF NOT EXISTS chats (
    chat_id TEXT PRIMARY KEY,
    user_id TEXT,
    app_id TEXT,
    title TEXT,
    history TEXT DEFAULT '[]',
    created_at TEXT,
    updated_at TEXT
);

CREATE TABLE IF NOT EXISTS model_configs (
    id TEXT PRIMARY KEY,
    user_id TEXT,
    app_id TEXT,
    provider TEXT,
    config_data TEXT DEFAULT '{}',
    created_at TEXT,
    updated_at TEXT
);

CREATE TABLE IF NOT EXISTS storage_usage (
    app_id TEXT,
    owner_id TEXT,
    bytes INTEGER DEFAULT 0,
    PRIMARY KEY (app_id, owner_id)
);
"""


class SQLiteDatabase:
    def __init__(self, path: str | Path = ":memory:"):
        self.path = str(path)
        self._lock = threading.RLock()
        if self.path != ":memory:":
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._conn.execute("PRAGMA journal_mode=WAL")
        register_sql_functions(self._conn)

    async def initialize(self) -> bool:
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()
        return True

    def close(self) -> None:
        self._conn.close()

    def _access_clause(self, auth: AuthContext) -> tuple[str, list]:
        """Cloud mode filters by app_id only; self-hosted by owner_id
        (reference postgres_database.py:1199-1217)."""
        if auth.app_id:
            return "app_id = ?", [auth.app_id]
        return "owner_id = ?", [auth.entity_id]

    def _can_access(self, row: sqlite3.Row, auth: AuthContext) -> bool:
        if auth.app_id:
            return row["app_id"] == auth.app_id
        return row["owner_id"] == auth.entity_id

    @staticmethod
    def _row_to_document(row: sqlite3.Row) -> Document:
        sm = json.loads(row["system_metadata"] or "{}")
        sm.setdefault("status", row["status"])
        return Document(
            external_id=row["external_id"],
            content_type=row["content_type"] or "",
            filename=row["filename"],
            metadata=json.loads(row["doc_metadata"] or "{}"),
            metadata_types=json.loads(row["metadata_types"] or "{}"),
            storage_info=json.loads(row["storage_info"] or "{}"),
            system_metadata=sm,
            additional_metadata=json.loads(row["additional_metadata"] or "{}"),
            chunk_ids=json.loads(row["chunk_ids"] or "[]"),
            folder_name=row["folder_name"],
            folder_path=row["folder_path"],
            folder_id=row["folder_id"],
            end_user_id=row["end_user_id"],
            app_id=row["app_id"],
        )

    async def store_document(self, document: Document, auth: Optional[AuthContext] = None) -> bool:
        owner_id = auth.entity_id if auth else document.system_metadata.get("owner_id")
        app_id = document.app_id or (auth.app_id if auth else None)
        now = _now_iso()
        sm = dict(document.system_metadata)
        status = sm.get("status", "processing")
        with self._lock:
            # INSERT OR REPLACE must not let a tenant take over another
            # tenant's document by guessing its external_id
            existing = self._conn.execute(
                "SELECT owner_id, app_id, created_at FROM documents WHERE external_id=?",
                (document.external_id,),
            ).fetchone()
            if existing is not None:
                if auth is not None and not self._can_access(existing, auth):
                    raise PermissionError(
                        f"document {document.external_id} belongs to another tenant"
                    )
                now_created = existing["created_at"]  # replace keeps creation time
            else:
                now_created = now
        with self._lock:
            self._conn.execute(
                """INSERT OR REPLACE INTO documents
                   (external_id, owner_id, app_id, content_type, filename, doc_metadata,
                    metadata_types, storage_info, system_metadata, additional_metadata,
                    chunk_ids, folder_name, folder_path, folder_id, end_user_id, status,
                    created_at, updated_at)
                   VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)""",
                (
                    document.external_id, owner_id, app_id, document.content_type,
                    document.filename,
                    json.dumps(document.metadata, default=_json_default),
                    json.dumps(document.metadata_types, default=_json_default),
                    json.dumps(document.storage_info, default=_json_default),
                    json.dumps(sm, default=_json_default),
                    json.dumps(document.additional_metadata, default=_json_default),
                    json.dumps(document.chunk_ids),
                    document.folder_name, document.folder_path, document.folder_id,
                    document.end_user_id, status, now_created, now,
                ),
            )
            self._conn.commit()
        return True

    async def get_document(self, document_id: str, auth: AuthContext) -> Optional[Document]:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM documents WHERE external_id = ?", (document_id,)
            ).fetchone()
        if row is None or not self._can_access(row, auth):
            return None
        return self._row_to_document(row)

    async def get_document_by_filename(
        self, filename: str, auth: AuthContext, system_filters: Optional[Dict[str, Any]] = None
    ) -> Optional[Document]:
        clause, params = self._access_clause(auth)
        sql = f"SELECT * FROM documents WHERE filename = ? AND {clause}"
        params = [filename] + params
        sql, params = self._apply_system_filters(sql, params, system_filters)
        with self._lock:
            row = self._conn.execute(sql + " ORDER BY updated_at DESC", params).fetchone()
        return self._row_to_document(row) if row else None

    def _apply_system_filters(self, sql: str, params: list, system_filters: Optional[Dict[str, Any]]):
        if not system_filters:
            return sql, params
        # "folder_name" accepts leaf names or full paths (reference API quirk,
        # documents.py:44-57); "folder_path" is always a path. folder_depth:
        # 0/None exact, -1 all descendants, n>0 up to n levels deeper.
        folder_depth = system_filters.get("folder_depth")
        targets = system_filters.get("folder_path", system_filters.get("folder_name"))
        if targets is not None:
            names = targets if isinstance(targets, list) else [targets]
            sub, subp = [], []
            for n in names:
                if n is None:
                    sub.append("folder_name IS NULL")
                    continue
                p = _normalize_path(str(n))
                if folder_depth in (0, None):
                    if isinstance(n, str) and "/" in n.strip("/"):
                        sub.append("folder_path = ?")
                        subp.append(p)
                    else:
                        sub.append("(folder_name = ? OR folder_path = ?)")
                        subp.extend([n, p])
                else:  # -1 all descendants; n>0 at most n levels deeper
                    prefix = p.rstrip("/") + "/%"
                    desc = "folder_path LIKE ?"
                    desc_params: list = [prefix]
                    if isinstance(folder_depth, int) and folder_depth > 0:
                        # depth = slash count; descendants within n levels
                        # have at most base_slashes + n slashes
                        base_slashes = p.rstrip("/").count("/")
                        desc = (
                            "(folder_path LIKE ? AND LENGTH(folder_path) - "
                            "LENGTH(REPLACE(folder_path, '/', '')) <= ?)"
                        )
                        desc_params = [prefix, base_slashes + folder_depth]
                    if isinstance(n, str) and "/" in n.strip("/"):
                        sub.append(f"(folder_path = ? OR {desc})")
                        subp.extend([p] + desc_params)
                    else:
                        sub.append(f"(folder_name = ? OR folder_path = ? OR {desc})")
                        subp.extend([n, p] + desc_params)
            sql += " AND (" + " OR ".join(sub) + ")"
            params.extend(subp)
        if system_filters.get("end_user_id") is not None:
            sql += " AND end_user_id = ?"
            params.append(system_filters["end_user_id"])
        if system_filters.get("status") is not None:
            sql += " AND status = ?"
            params.append(system_filters["status"])
        if system_filters.get("app_id") is not None:
            sql += " AND app_id = ?"
            params.append(system_filters["app_id"])
        return sql, params

    async def find_authorized_and_filtered_documents(
        self,
        auth: AuthContext,
        filters: Optional[Dict[str, Any]] = None,
        system_filters: Optional[Dict[str, Any]] = None,
    ) -> List[str]:
        """Doc-id pre-filter for retrieval (reference :1115-1168).
        Defaults to status='completed' like the reference."""
        system_filters = dict(system_filters or {})
        system_filters.setdefault("status", "completed")
        docs = await self._query_documents(auth, filters, system_filters)
        return [d.external_id for d in docs]

    async def get_documents(
        self,
        auth: AuthContext,
        skip: int = 0,
        limit: int = 10000,
        filters: Optional[Dict[str, Any]] = None,
        system_filters: Optional[Dict[str, Any]] = None,
    ) -> List[Document]:
        docs = await self._query_documents(auth, filters, system_filters)
        return docs[skip : skip + limit]

    async def _query_documents(self, auth, filters, system_filters) -> List[Document]:
        clause, params = self._access_clause(auth)
        # Compile the metadata-filter tree into the WHERE clause (reference
        # metadata_filters.py:29-856 compiles to Postgres jsonb SQL for the
        # same reason: retrieval must not scan all authorized rows in
        # Python). Rows flagged _needs_py carry metadata_types hints the
        # SQL can't honor and are re-checked by the evaluator; an
        # uncompilable (but valid) filter falls back to full evaluation.
        compiled = compile_filter_sql(filters) if filters else None
        select = "SELECT *, 0 AS _needs_py FROM documents"
        if compiled is not None:
            fclause, fparams, needs_py = compiled
            select = f"SELECT *, {needs_py} AS _needs_py FROM documents"
            clause = f"{clause} AND (({fclause}) OR {needs_py})"
            params = params + fparams
        sql = f"{select} WHERE {clause}"
        sql, params = self._apply_system_filters(sql, params, system_filters)
        with self._lock:
            rows = self._conn.execute(sql + " ORDER BY updated_at DESC", params).fetchall()
        out = []
        for row in rows:
            if filters and (compiled is None or row["_needs_py"]):
                md = json.loads(row["doc_metadata"] or "{}")
                mt = json.loads(row["metadata_types"] or "{}")
                cols = {"filename": row["filename"]}
                if not matches_filter(filters, md, mt, cols):
                    continue
            out.append(self._row_to_document(row))
        return out

    async def get_documents_by_id(
        self, document_ids: Sequence[str], auth: AuthContext, system_filters: Optional[Dict[str, Any]] = None
    ) -> List[Document]:
        if not document_ids:
            return []
        clause, params = self._access_clause(auth)
        qmarks = ",".join("?" * len(document_ids))
        sql = f"SELECT * FROM documents WHERE external_id IN ({qmarks}) AND {clause}"
        params = list(document_ids) + params
        sql, params = self._apply_system_filters(sql, params, system_filters)
        with self._lock:
            rows = self._conn.execute(sql, params).fetchall()
        return [self._row_to_document(r) for r in rows]

    async def update_document(
        self, document_id: str, updates: Dict[str, Any], auth: AuthContext
    ) -> bool:
        doc = await self.get_document(document_id, auth)
        if doc is None:
            return False
        data = doc.model_dump()
        updates = dict(updates)  # don't mutate the caller's dict
        sm_update = updates.pop("system_metadata", None)
        data.update({k: v for k, v in updates.items() if k in data})
        if sm_update:
            data["system_metadata"].update(sm_update)
        data["system_metadata"]["updated_at"] = _now_iso()
        new_doc = Document(**data)
        new_doc.app_id = doc.app_id
        status = new_doc.system_metadata.get("status", "processing")
        with self._lock:
            self._conn.execute(
                """UPDATE documents SET content_type=?, filename=?, doc_metadata=?,
                   metadata_types=?, storage_info=?, system_metadata=?, additional_metadata=?,
                   chunk_ids=?, folder_name=?, folder_path=?, folder_id=?, end_user_id=?,
                   status=?, updated_at=? WHERE external_id=?""",
                (
                    new_doc.content_type, new_doc.filename,
                    json.dumps(new_doc.metadata, default=_json_default),
                    json.dumps(new_doc.metadata_types, default=_json_default),
                    json.dumps(new_doc.storage_info, default=_json_default),
                    json.dumps(new_doc.system_metadata, default=_json_default),
                    json.dumps(new_doc.additional_metadata, default=_json_default),
                    json.dumps(new_doc.chunk_ids),
                    new_doc.folder_name, new_doc.folder_path, new_doc.folder_id,
                    new_doc.end_user_id, status, _now_iso(), document_id,
                ),
            )
            self._conn.commit()
        return True

    async def delete_document(self, document_id: str, auth: AuthContext) -> bool:
        doc = await self.get_document(document_id, auth)
        if doc is None:
            return False
        if "write" not in auth.permissions and "admin" not in auth.permissions:
            return False
        with self._lock:
            self._conn.execute("DELETE FROM documents WHERE external_id = ?", (document_id,))
            self._conn.commit()
        return True

    async def search_documents_by_name(
        self, auth: AuthContext, query: str, limit: int = 20, system_filters: Optional[Dict[str, Any]] = None
    ) -> List[Document]:
        clause, params = self._access_clause(auth)
        sql = f"SELECT * FROM documents WHERE {clause} AND filename LIKE ?"
        params = params + [f"%{query}%"]
        sql, params = self._apply_system_filters(sql, params, system_filters)
        with self._lock:
            rows = self._conn.execute(sql + " ORDER BY updated_at DESC LIMIT ?", params + [limit]).fetchall()
        return [self._row_to_document(r) for r in rows]

    # ------------------------------------------------------------- folders

    async def create_folder(
        self,
        name: str,
        auth: AuthContext,
        description: Optional[str] = None,
        parent_path: Optional[str] = None,
    ) -> Dict[str, Any]:
        """The folder at `parent_path/name` (an existing one is returned as
        it is); missing ancestors are created first, without description."""
        path = _normalize_path((parent_path.rstrip("/") + "/" + name) if parent_path else name)
        existing = await self.get_folder_by_path(path, auth)
        if existing:
            return existing
        parts = [p for p in path.strip("/").split("/") if p]
        parent_id = None
        for depth in range(1, len(parts) + 1):
            sub_path = "/" + "/".join(parts[:depth])
            row = await self.get_folder_by_path(sub_path, auth)
            if row:
                parent_id = row["id"]
                continue
            fid = str(uuid.uuid4())
            now = _now_iso()
            with self._lock:
                self._conn.execute(
                    "INSERT INTO folders (id, name, path, parent_id, owner_id, app_id, description, created_at, updated_at)"
                    " VALUES (?,?,?,?,?,?,?,?,?)",
                    (fid, parts[depth - 1], sub_path, parent_id,
                     auth.entity_id, auth.app_id,
                     description if depth == len(parts) else None, now, now),
                )
                self._conn.commit()
            parent_id = fid
        out = await self.get_folder_by_path(path, auth)
        assert out is not None
        return out

    def _folder_row_to_dict(self, row: sqlite3.Row) -> Dict[str, Any]:
        return {
            "id": row["id"],
            "name": row["name"],
            "path": row["path"],
            "full_path": row["path"],
            "parent_id": row["parent_id"],
            "description": row["description"],
            "system_metadata": json.loads(row["system_metadata"] or "{}"),
            "created_at": row["created_at"],
            "updated_at": row["updated_at"],
        }

    async def get_folder_by_path(self, path: str, auth: AuthContext) -> Optional[Dict[str, Any]]:
        path = _normalize_path(path)
        clause, params = self._access_clause(auth)
        with self._lock:
            row = self._conn.execute(
                f"SELECT * FROM folders WHERE path = ? AND {clause}", [path] + params
            ).fetchone()
        return self._folder_row_to_dict(row) if row else None

    async def get_folder(self, folder_id: str, auth: AuthContext) -> Optional[Dict[str, Any]]:
        clause, params = self._access_clause(auth)
        with self._lock:
            row = self._conn.execute(
                f"SELECT * FROM folders WHERE id = ? AND {clause}", [folder_id] + params
            ).fetchone()
        return self._folder_row_to_dict(row) if row else None

    async def list_folders(self, auth: AuthContext, parent_path: Optional[str] = None) -> List[Dict[str, Any]]:
        clause, params = self._access_clause(auth)
        sql = f"SELECT * FROM folders WHERE {clause}"
        if parent_path is not None:
            parent = await self.get_folder_by_path(parent_path, auth)
            if parent is None:
                return []
            sql += " AND parent_id = ?"
            params = params + [parent["id"]]
        with self._lock:
            rows = self._conn.execute(sql + " ORDER BY path", params).fetchall()
        return [self._folder_row_to_dict(r) for r in rows]

    async def delete_folder(self, folder_id: str, auth: AuthContext) -> bool:
        """The folder and its subtree, in the caller's tenant only (another
        tenant may own the same path); documents keep their paths."""
        folder = await self.get_folder(folder_id, auth)
        if folder is None:
            return False
        clause, params = self._access_clause(auth)
        with self._lock:
            self._conn.execute(
                f"DELETE FROM folders WHERE (path = ? OR path LIKE ?) AND {clause}",
                [folder["path"], folder["path"].rstrip("/") + "/%"] + params,
            )
            self._conn.commit()
        return True

    def _rewrite_subtree_paths(self, old_path: str, new_path: str, clause: str, params: list) -> None:
        """Re-root every descendant folder path and document folder_path
        from old_path to new_path, in the caller's tenant only and
        prefix-safe (a substring REPLACE would corrupt a sibling like
        '/a/ab'). The caller commits or rolls back."""
        prefix = old_path.rstrip("/") + "/"
        rows = self._conn.execute(
            f"SELECT id, path FROM folders WHERE path LIKE ? AND {clause}",
            [prefix + "%"] + params,
        ).fetchall()
        for r in rows:
            self._conn.execute(
                "UPDATE folders SET path = ? WHERE id = ?",
                (new_path.rstrip("/") + "/" + r["path"][len(prefix):], r["id"]),
            )
        self._conn.execute(
            f"UPDATE documents SET folder_path = ? || substr(folder_path, ?)"
            f" WHERE (folder_path = ? OR folder_path LIKE ?) AND {clause}",
            [new_path, len(old_path) + 1, old_path, prefix + "%"] + params,
        )

    def _move_subtree(self, folder_id: str, set_sql: str, set_params: tuple, old_path: str, new_path: str,
                      auth: AuthContext) -> None:
        """One transaction: the folder's own row, then its subtree."""
        clause, params = self._access_clause(auth)
        with self._lock:
            try:
                self._conn.execute(f"UPDATE folders SET {set_sql} WHERE id = ?", set_params + (folder_id,))
                self._rewrite_subtree_paths(old_path, new_path, clause, params)
                self._conn.commit()
            except Exception:
                self._conn.rollback()
                raise

    async def move_folder(self, folder_id: str, new_parent_path: Optional[str], auth: AuthContext) -> bool:
        """Move under `new_parent_path` (None: the root). Refused (False):
        a missing folder or parent, a move into its own subtree, a taken
        destination path."""
        folder = await self.get_folder(folder_id, auth)
        if folder is None:
            return False
        old_path = folder["path"]
        new_parent = _normalize_path(new_parent_path) if new_parent_path else ""
        new_path = (new_parent.rstrip("/") + "/" + folder["name"]) if new_parent else "/" + folder["name"]
        if new_path == old_path:
            return True
        if new_parent == old_path or new_parent.startswith(old_path.rstrip("/") + "/"):
            return False
        if await self.get_folder_by_path(new_path, auth) is not None:
            return False
        if new_parent:
            parent = await self.get_folder_by_path(new_parent, auth)
            if parent is None:
                return False
            parent_id = parent["id"]
        else:
            parent_id = None
        self._move_subtree(folder_id, "path = ?, parent_id = ?, updated_at = ?", (new_path, parent_id, _now_iso()),
                           old_path, new_path, auth)
        return True

    async def rename_folder(self, folder_id: str, new_name: str, auth: AuthContext) -> bool:
        """Rename the leaf segment of a folder path; subtree folder paths
        and document folder_path values follow. Refused (False): a
        missing folder, an empty name or one with '/', a taken name."""
        folder = await self.get_folder(folder_id, auth)
        if folder is None or not new_name or "/" in new_name:
            return False
        old_path = folder["path"]
        parent = old_path.rstrip("/").rsplit("/", 1)[0]
        new_path = (parent + "/" + new_name) if parent else "/" + new_name
        if new_path == old_path:
            return True
        if await self.get_folder_by_path(new_path, auth) is not None:
            return False
        self._move_subtree(folder_id, "name = ?, path = ?, updated_at = ?", (new_name, new_path, _now_iso()),
                           old_path, new_path, auth)
        return True

    async def update_folder_metadata(self, folder_id: str, updates: Dict[str, Any], auth: AuthContext) -> bool:
        """Merge keys into the folder's system_metadata JSON."""
        folder = await self.get_folder(folder_id, auth)
        if folder is None:
            return False
        merged = {**folder.get("system_metadata", {}), **updates}
        with self._lock:
            self._conn.execute(
                "UPDATE folders SET system_metadata=?, updated_at=? WHERE id=?",
                (json.dumps(merged), _now_iso(), folder_id),
            )
            self._conn.commit()
        return True

    async def list_folders_summary(self, auth: AuthContext) -> List[Dict[str, Any]]:
        """Compact folder list with document counts."""
        clause, params = self._access_clause(auth)
        with self._lock:
            rows = self._conn.execute(
                f"""SELECT f.id, f.name, f.path, f.updated_at,
                          (SELECT COUNT(*) FROM documents d
                            WHERE (d.folder_path = f.path OR d.folder_id = f.id)
                              AND d.owner_id IS f.owner_id
                              AND d.app_id IS f.app_id) AS doc_count
                    FROM folders f WHERE {clause} ORDER BY f.path""",
                params,
            ).fetchall()
        return [
            {"id": r["id"], "name": r["name"], "path": r["path"],
             "doc_count": r["doc_count"], "updated_at": r["updated_at"]}
            for r in rows
        ]

    async def set_document_folder(self, document_id: str, folder: Optional[Dict[str, Any]], auth: AuthContext) -> bool:
        """Put the document in `folder` (None: take it out of any)."""
        doc = await self.get_document(document_id, auth)
        if doc is None:
            return False
        with self._lock:
            if folder is None:
                self._conn.execute(
                    "UPDATE documents SET folder_name=NULL, folder_path=NULL, folder_id=NULL WHERE external_id=?",
                    (document_id,),
                )
            else:
                self._conn.execute(
                    "UPDATE documents SET folder_name=?, folder_path=?, folder_id=? WHERE external_id=?",
                    (folder["name"], folder["path"], folder["id"], document_id),
                )
            self._conn.commit()
        return True

    # --------------------------------------------------------------- chats

    @staticmethod
    def _chat_owned(row, user_id: Optional[str], app_id: Optional[str]) -> bool:
        """Chat scoping mirrors document scoping: cloud callers match on
        app_id, self-hosted on user_id. An anonymous caller (both None)
        only sees anonymous chats."""
        if app_id:
            return row["app_id"] == app_id
        if user_id:
            return row["user_id"] == user_id and row["app_id"] is None
        return row["user_id"] is None and row["app_id"] is None

    async def get_chat_history(self, chat_id: str, user_id: Optional[str], app_id: Optional[str]) -> Optional[List[Dict[str, Any]]]:
        with self._lock:
            row = self._conn.execute("SELECT * FROM chats WHERE chat_id = ?", (chat_id,)).fetchone()
        if row is None or not self._chat_owned(row, user_id, app_id):
            return None
        return json.loads(row["history"] or "[]")

    async def upsert_chat_history(
        self, chat_id: str, user_id: Optional[str], app_id: Optional[str], history: List[Dict[str, Any]]
    ) -> bool:
        now = _now_iso()
        with self._lock:
            row = self._conn.execute(
                "SELECT user_id, app_id FROM chats WHERE chat_id = ?", (chat_id,)
            ).fetchone()
            if row is not None and not self._chat_owned(row, user_id, app_id):
                return False  # chat id belongs to another user/app
            self._conn.execute(
                """INSERT INTO chats (chat_id, user_id, app_id, history, created_at, updated_at)
                   VALUES (?,?,?,?,?,?)
                   ON CONFLICT(chat_id) DO UPDATE SET history=excluded.history, updated_at=excluded.updated_at""",
                (chat_id, user_id, app_id, json.dumps(history, default=_json_default), now, now),
            )
            self._conn.commit()
        return True

    async def list_chats(self, user_id: Optional[str], app_id: Optional[str], limit: int = 100) -> List[Dict[str, Any]]:
        sql = "SELECT chat_id, user_id, app_id, title, created_at, updated_at FROM chats WHERE 1=1"
        params: list = []
        if app_id:
            sql += " AND app_id = ?"
            params.append(app_id)
        elif user_id:
            sql += " AND user_id = ?"
            params.append(user_id)
        with self._lock:
            rows = self._conn.execute(sql + " ORDER BY updated_at DESC LIMIT ?", params + [limit]).fetchall()
        return [dict(r) for r in rows]

    async def update_chat_title(self, chat_id: str, title: str, user_id: Optional[str], app_id: Optional[str]) -> bool:
        with self._lock:
            row = self._conn.execute("SELECT user_id, app_id FROM chats WHERE chat_id = ?", (chat_id,)).fetchone()
            if row is None or not self._chat_owned(row, user_id, app_id):
                return False
            cur = self._conn.execute(
                "UPDATE chats SET title = ?, updated_at = ? WHERE chat_id = ?", (title, _now_iso(), chat_id)
            )
            self._conn.commit()
        return cur.rowcount > 0

    # -------------------------------------------------------- model configs

    async def store_model_config(self, user_id: str, app_id: Optional[str], provider: str,
                                 config_data: Dict[str, Any]) -> str:
        cid = str(uuid.uuid4())
        now = _now_iso()
        with self._lock:
            self._conn.execute(
                "INSERT INTO model_configs (id, user_id, app_id, provider, config_data, created_at, updated_at) "
                "VALUES (?,?,?,?,?,?,?)",
                (cid, user_id, app_id, provider, json.dumps(config_data), now, now),
            )
            self._conn.commit()
        return cid

    async def get_model_configs(self, user_id: str, app_id: Optional[str]) -> List[Dict[str, Any]]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT * FROM model_configs WHERE user_id = ? AND (app_id IS ? OR app_id = ?)",
                (user_id, app_id, app_id),
            ).fetchall()
        return [
            {"id": r["id"], "provider": r["provider"], "config_data": json.loads(r["config_data"]),
             "created_at": r["created_at"], "updated_at": r["updated_at"]}
            for r in rows
        ]

    async def update_model_config(self, config_id: str, user_id: str, config_data: Dict[str, Any]) -> bool:
        with self._lock:
            cur = self._conn.execute(
                "UPDATE model_configs SET config_data = ?, updated_at = ? WHERE id = ? AND user_id = ?",
                (json.dumps(config_data), _now_iso(), config_id, user_id),
            )
            self._conn.commit()
        return cur.rowcount > 0

    async def delete_model_config(self, config_id: str, user_id: str) -> bool:
        with self._lock:
            cur = self._conn.execute("DELETE FROM model_configs WHERE id = ? AND user_id = ?", (config_id, user_id))
            self._conn.commit()
        return cur.rowcount > 0

    # ------------------------------------------------------- storage usage

    async def add_storage_bytes(self, auth: AuthContext, delta: int) -> int:
        key = (auth.app_id or "", auth.entity_id or "")
        with self._lock:
            self._conn.execute(
                """INSERT INTO storage_usage (app_id, owner_id, bytes) VALUES (?,?,?)
                   ON CONFLICT(app_id, owner_id) DO UPDATE SET bytes = bytes + excluded.bytes""",
                (key[0], key[1], delta),
            )
            self._conn.commit()
            row = self._conn.execute(
                "SELECT bytes FROM storage_usage WHERE app_id = ? AND owner_id = ?", key
            ).fetchone()
        return int(row["bytes"]) if row else 0

    async def get_storage_bytes(self, auth: AuthContext) -> int:
        key = (auth.app_id or "", auth.entity_id or "")
        with self._lock:
            row = self._conn.execute(
                "SELECT bytes FROM storage_usage WHERE app_id = ? AND owner_id = ?", key
            ).fetchone()
        return int(row["bytes"]) if row else 0


def _normalize_path(p: str) -> str:
    p = "/" + str(p).strip().strip("/")
    while "//" in p:
        p = p.replace("//", "/")
    return p
