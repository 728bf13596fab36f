"""The port's multivector store: twin of
`morphik_core_tpu/vector_store/tpu_multivector_store.py:42-270` over the
port's `MultiVectorIndex`.

  - one index per namespace (app_id), created at first use, on the
    store's device (the card unless the caller passes `device="cpu"`);
    with `index_path` set, namespace `ns` persists under
    `{index_path}/{ns}` in the reference's file format and `save()`
    flushes every such index;
  - chunk payloads: inline for text, offloaded to storage for images
    with the reference's key `{app_id}/{doc_id}/{chunk_number}{ext}` in
    bucket `multivector-chunks`, restored on read;
  - document FDE rows computed by the embedder (the fused ingest FDE)
    pass through to the index;
  - a store-metrics dict per call.

Not ported yet: the binary index, `provider="binary"` (ROADMAP Queue 1
item 6).
"""

from __future__ import annotations

import logging
import re
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from morphik_core_tpu_torch.device import default_device
from morphik_core_tpu_torch.index.multivector_index import IndexRecord, MultiVectorIndex
from morphik_core_tpu_torch.models.schemas import DocumentChunk
from morphik_core_tpu_torch.ops.fde import FDEConfig
from morphik_core_tpu_torch.ops.pooling import pool_multivector
from morphik_core_tpu_torch.storage.base_storage import BaseStorage
from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri, data_uri_to_bytes
from morphik_core_tpu_torch.vector_store.base_vector_store import BaseVectorStore

logger = logging.getLogger(__name__)

MULTIVECTOR_CHUNKS_BUCKET = "multivector-chunks"
_DEFAULT_NS = "default"


def _detect_ext(content: str) -> str:
    m = re.match(r"data:image/(\w+);base64,", content)
    return f".{m.group(1)}" if m else ".png"


class TorchMultiVectorStore(BaseVectorStore):
    def __init__(
        self,
        storage: Optional[BaseStorage] = None,
        fde_config: Optional[FDEConfig] = None,
        index_path: Optional[str | Path] = None,
        device=None,
        prefilter_multiplier: int = 30,
        prefilter_cap: int = 300,
        use_pallas: Optional[bool] = None,
        provider: str = "fde",
        pooling_factor: int = 1,
        ann_dtype: str = "int8",
        device_block_rows: int = 65536,
        compact_dead_fraction: float = 0.25,
        compact_min_rows: int = 4096,
        device_cache_slots: int = 0,
        device_cache_token_bucket: int = 1024,
        rerank_dtype: str = "bf16",
        rerank_prefilter_pooling: int = 0,
        pooled_tier_factor: int = 0,
        pooled_tier_budget_mb: int = 6144,
        pooled_refine_iters: int = 3,
        query_token_dedup: float = 0.98,
    ):
        if provider != "fde":
            raise NotImplementedError(
                f"vector store provider {provider!r} is not ported (ROADMAP Queue 1 item 6: the binary index)"
            )
        self.storage = storage
        self.fde_config = fde_config or FDEConfig()
        self.device = torch.device(device) if device is not None else default_device()
        self.pooling_factor = max(1, int(pooling_factor))
        self.index_path = Path(index_path) if index_path else None
        self.index_kwargs = dict(
            prefilter_multiplier=prefilter_multiplier,
            prefilter_cap=prefilter_cap,
            use_pallas=use_pallas,
            ann_dtype=ann_dtype,
            device_block_rows=device_block_rows,
            compact_dead_fraction=compact_dead_fraction,
            compact_min_rows=compact_min_rows,
            device_cache_slots=device_cache_slots,
            device_cache_token_bucket=device_cache_token_bucket,
            rerank_dtype=rerank_dtype,
            rerank_prefilter_pooling=rerank_prefilter_pooling,
            pooled_tier_factor=pooled_tier_factor,
            pooled_tier_budget_mb=pooled_tier_budget_mb,
            pooled_refine_iters=pooled_refine_iters,
            query_token_dedup=query_token_dedup,
        )
        self._indexes: Dict[str, MultiVectorIndex] = {}
        self.last_store_metrics: Dict[str, Any] = {}

    async def initialize(self) -> bool:
        return True

    def _ns(self, app_id: Optional[str]) -> MultiVectorIndex:
        ns = app_id or _DEFAULT_NS
        if ns not in self._indexes:
            path = (self.index_path / ns) if self.index_path else None
            self._indexes[ns] = MultiVectorIndex(self.fde_config, device=self.device, path=path,
                                                 **self.index_kwargs)
        return self._indexes[ns]

    # ------------------------------------------------------------------

    async def _offload_payload(self, chunk: DocumentChunk, app_id: Optional[str]) -> Tuple[Optional[str], int]:
        """Images go to object storage; text stays inline. Returns (key, bytes)."""
        if self.storage is None or not chunk.metadata.get("is_image"):
            return None, 0
        ext = _detect_ext(chunk.content)
        key = f"{app_id or _DEFAULT_NS}/{chunk.document_id}/{chunk.chunk_number}{ext}"
        data = data_uri_to_bytes(chunk.content)
        await self.storage.upload_file(data, key, bucket=MULTIVECTOR_CHUNKS_BUCKET)
        return key, len(data)

    async def _restore_payload(self, rec: IndexRecord, skip_image_content: bool) -> str:
        if rec.content_key is None:
            return rec.metadata.get("_content", "")
        if skip_image_content:
            return rec.content_key
        data = await self.storage.download_file(MULTIVECTOR_CHUNKS_BUCKET, rec.content_key)
        ext = rec.content_key.rsplit(".", 1)[-1]
        return bytes_to_data_uri(data, f"image/{ext}")

    def _to_chunk(self, rec: IndexRecord, content: str, score: float) -> DocumentChunk:
        md = {mk: mv for mk, mv in rec.metadata.items() if mk != "_content"}
        return DocumentChunk(document_id=rec.document_id, chunk_number=rec.chunk_number, content=content,
                             embedding=[], metadata=md, score=score)

    async def store_embeddings(
        self,
        chunks: List[DocumentChunk],
        app_id: Optional[str] = None,
        fde_vectors: Optional[List[Optional[np.ndarray]]] = None,
    ) -> Tuple[bool, List[str], Dict[str, Any]]:
        """`fde_vectors` (chunk-aligned) carries document FDE rows the
        embedder computed on the device; when every row has one and no
        stored-token pooling rewrites the multivectors, the index skips
        its own FDE encode."""
        if not chunks:
            return True, [], {}
        index = self._ns(app_id)
        metrics: Dict[str, Any] = {"vector_store_backend": "torch_multivector", "vector_store_rows": len(chunks)}
        t0 = time.perf_counter()
        payload_bytes = 0
        records: List[IndexRecord] = []
        mvs: List[np.ndarray] = []
        for chunk in chunks:
            key, nbytes = await self._offload_payload(chunk, app_id)
            payload_bytes += nbytes
            md = dict(chunk.metadata)
            if key is None:
                md["_content"] = chunk.content
            records.append(IndexRecord(document_id=chunk.document_id, chunk_number=chunk.chunk_number,
                                       metadata=md, content_key=key))
            mv = np.asarray(chunk.embedding, dtype=np.float32)
            if self.pooling_factor > 1 and chunk.metadata.get("is_image"):
                mv = pool_multivector(mv, self.pooling_factor)
            mvs.append(mv)
        metrics["chunk_payload_bytes"] = payload_bytes
        metrics["chunk_payload_upload_s"] = time.perf_counter() - t0

        t1 = time.perf_counter()
        fde = None
        if (
            fde_vectors is not None
            and len(fde_vectors) == len(chunks)
            and all(v is not None for v in fde_vectors)
            and self.pooling_factor <= 1
        ):
            fde = np.stack([np.asarray(v, np.float32) for v in fde_vectors])
            metrics["fde_precomputed"] = True
        ids = index.store(mvs, records, fde_vectors=fde)
        metrics["vector_store_write_s"] = time.perf_counter() - t1
        self.last_store_metrics = metrics
        return True, ids, metrics

    async def query_similar(
        self,
        query_embedding: Union[np.ndarray, List[float]],
        k: int,
        doc_ids: Optional[Sequence[str]] = None,
        app_id: Optional[str] = None,
        skip_image_content: bool = False,
    ) -> List[DocumentChunk]:
        index = self._ns(app_id)
        q = np.asarray(query_embedding, dtype=np.float32)
        results = index.query(q, k, doc_ids=doc_ids, return_timing=True)
        return [self._to_chunk(rec, await self._restore_payload(rec, skip_image_content), score)
                for rec, score in results]

    async def get_chunks_by_id(
        self,
        chunk_identifiers: Sequence[Tuple[str, int]],
        app_id: Optional[str] = None,
        skip_image_content: bool = False,
    ) -> List[DocumentChunk]:
        index = self._ns(app_id)
        return [self._to_chunk(rec, await self._restore_payload(rec, skip_image_content), 0.0)
                for rec in index.get_chunks_by_id(chunk_identifiers) if rec is not None]

    async def delete_chunks_by_document_id(self, document_id: str, app_id: Optional[str] = None) -> bool:
        n = self._ns(app_id).delete_document(document_id)
        logger.info("deleted %d chunks of %s", n, document_id)
        return True

    def save(self) -> None:
        """Flush the pending rows and ops of every index that has a path."""
        for index in self._indexes.values():
            if index.path:
                index.save()
