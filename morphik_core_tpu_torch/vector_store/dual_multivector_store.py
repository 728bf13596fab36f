"""Dual-store migration wrapper: copy of
`morphik_core_tpu/vector_store/dual_multivector_store.py:20-63`. Writes go
to BOTH stores concurrently, reads come from `read_from` — used while
migrating between multivector providers. A write raises only when both
stores fail."""

from __future__ import annotations

import asyncio
import logging
from typing import List, Optional

from morphik_core_tpu_torch.models.schemas import DocumentChunk
from morphik_core_tpu_torch.vector_store.base_vector_store import BaseVectorStore

logger = logging.getLogger(__name__)


class DualMultiVectorStore(BaseVectorStore):
    def __init__(self, primary: BaseVectorStore, secondary: BaseVectorStore, read_from: str = "primary"):
        self.primary = primary
        self.secondary = secondary
        self.read_from = read_from

    @property
    def _reader(self) -> BaseVectorStore:
        return self.primary if self.read_from == "primary" else self.secondary

    async def initialize(self) -> bool:
        for s in (self.primary, self.secondary):
            init = getattr(s, "initialize", None)
            if init:
                await init()
        return True

    async def store_embeddings(self, chunks: List[DocumentChunk], app_id: Optional[str] = None):
        results = await asyncio.gather(
            self.primary.store_embeddings(chunks, app_id),
            self.secondary.store_embeddings(chunks, app_id),
            return_exceptions=True,
        )
        for i, r in enumerate(results):
            if isinstance(r, Exception):
                logger.error("dual store %s write failed: %s", ("primary", "secondary")[i], r)
        ok_results = [r for r in results if not isinstance(r, Exception)]
        if not ok_results:
            raise RuntimeError("both stores failed")
        return ok_results[0]

    async def query_similar(self, query_embedding, k, doc_ids=None, app_id=None, skip_image_content=False):
        return await self._reader.query_similar(query_embedding, k, doc_ids, app_id, skip_image_content)

    async def get_chunks_by_id(self, chunk_identifiers, app_id=None, skip_image_content=False):
        return await self._reader.get_chunks_by_id(chunk_identifiers, app_id, skip_image_content)

    async def delete_chunks_by_document_id(self, document_id: str, app_id: Optional[str] = None) -> bool:
        results = await asyncio.gather(
            self.primary.delete_chunks_by_document_id(document_id, app_id),
            self.secondary.delete_chunks_by_document_id(document_id, app_id),
            return_exceptions=True,
        )
        return any(r is True for r in results)
