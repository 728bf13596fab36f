"""The v2 chunk store: copy of `morphik_core_tpu/vector_store/chunk_v2_store.py`.
One in-memory table of chunks with their app and folder, unit vectors on
the host (numpy, as the reference keeps them), cosine scores, and
metadata filters evaluated in the store. Nothing is persisted: the
reference's store lives in memory too."""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from morphik_core_tpu_torch.database.metadata_filters import matches_filter
from morphik_core_tpu_torch.models.schemas import DocumentChunk


class ChunkV2Store:
    def __init__(self):
        self._rows: List[Dict[str, Any]] = []
        self._vectors: Optional[np.ndarray] = None
        self._lock = threading.RLock()

    async def initialize(self) -> bool:
        return True

    async def store_chunks(
        self,
        chunks: List[DocumentChunk],
        embeddings: Sequence[np.ndarray],
        app_id: Optional[str] = None,
        folder_path: Optional[str] = None,
    ) -> List[str]:
        """Append the chunks with their normalized embeddings -> their ids."""
        ids = []
        with self._lock:
            for c, e in zip(chunks, embeddings):
                v = np.asarray(e, dtype=np.float32).reshape(-1)
                n = float(np.linalg.norm(v))
                v = v / n if n else v
                self._rows.append({
                    "document_id": c.document_id,
                    "chunk_number": c.chunk_number,
                    "content": c.content,
                    "metadata": c.metadata,
                    "app_id": app_id,
                    "folder_path": folder_path,
                    "alive": True,
                })
                self._vectors = v[None] if self._vectors is None else np.vstack([self._vectors, v[None]])
                ids.append(f"{c.document_id}-{c.chunk_number}")
        return ids

    async def query(
        self,
        query_embedding: np.ndarray,
        k: int,
        app_id: Optional[str] = None,
        folder_path: Optional[str] = None,
        filters: Optional[Dict[str, Any]] = None,
        document_ids: Optional[Sequence[str]] = None,
    ) -> List[DocumentChunk]:
        """The top `k` live rows by cosine among those of `app_id`, under
        `folder_path` (a prefix), of `document_ids`, matching `filters`."""
        with self._lock:
            if not self._rows:
                return []
            q = np.asarray(query_embedding, dtype=np.float32).reshape(-1)
            n = float(np.linalg.norm(q))
            q = q / n if n else q
            allowed = None if document_ids is None else set(document_ids)
            mask = np.array([
                r["alive"]
                and (app_id is None or r["app_id"] == app_id)
                and (folder_path is None or (r["folder_path"] or "").startswith(folder_path))
                and (allowed is None or r["document_id"] in allowed)
                and matches_filter(filters, r["metadata"])
                for r in self._rows
            ], dtype=bool)
            if not mask.any():
                return []
            scores = self._vectors @ q
            scores[~mask] = -np.inf
            k = min(k, int(mask.sum()))
            top = np.argpartition(-scores, k - 1)[:k]
            top = top[np.argsort(-scores[top])]
            return [
                DocumentChunk(document_id=self._rows[int(i)]["document_id"],
                              chunk_number=self._rows[int(i)]["chunk_number"],
                              content=self._rows[int(i)]["content"], embedding=[],
                              metadata=self._rows[int(i)]["metadata"], score=float(scores[int(i)]))
                for i in top
            ]

    async def delete_document(self, document_id: str, app_id: Optional[str] = None) -> int:
        """Tombstone the document's live rows -> how many."""
        n = 0
        with self._lock:
            for r in self._rows:
                if r["document_id"] == document_id and (app_id is None or r["app_id"] == app_id) and r["alive"]:
                    r["alive"] = False
                    n += 1
        return n
