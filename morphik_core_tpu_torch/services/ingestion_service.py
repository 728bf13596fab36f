"""Ingestion of page images: port of the ColPali path of
`morphik_core_tpu/services/ingestion_service.py` (`ingest_file_content`,
`process_ingestion_job`, `_embed_and_store_colpali`) for PNG pages.

Flow: upload (PNG only; document stub with status=processing, raw bytes
to storage) -> queue -> [worker] download -> decode (`utils/png.py`) ->
blank-page check -> u8 patches for the tower (`preprocess_array_u8`,
carried in chunk metadata `_patches`, as the reference's prep-mode PDF
path carries the raster worker's) -> batched device embed with the fused
document FDE in worker threads -> multivector store -> completed.

Two differences from the reference's image-file path, both recorded in
ROADMAP Queue 3: the page payload stored with the chunk is the uploaded
PNG, where the reference re-encodes a q80 JPEG of at most 1024 px (the
card's machine has no JPEG encoder), and the tower embeds the uploaded
pixels, where the reference embeds the decoded JPEG re-encode (the
reference's prep-mode PDF path embeds the in-hand pixels, as here).

Not ported yet (ROADMAP Queue 1): every other content type (item 3b:
PDF, JPEG, Office; refused at upload), text ingest and the text index
(item 3a; `use_colpali=False` raises), folders (item 3d).
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import json
import logging
import time
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, List, Optional

from morphik_core_tpu_torch.config import Settings
from morphik_core_tpu_torch.database.sqlite_database import SQLiteDatabase
from morphik_core_tpu_torch.embedding.colpali_embedding_model import ColpaliEmbeddingModel
from morphik_core_tpu_torch.models.colqwen.preprocess import is_blank_page, preprocess_array_u8
from morphik_core_tpu_torch.models.schemas import AuthContext, Chunk, Document
from morphik_core_tpu_torch.storage.base_storage import BaseStorage
from morphik_core_tpu_torch.storage.content_types import detect_content_type
from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri
from morphik_core_tpu_torch.utils.png import decode_png
from morphik_core_tpu_torch.vector_store.torch_multivector_store import TorchMultiVectorStore

logger = logging.getLogger(__name__)

SUPPORTED_CONTENT_TYPES = ("image/png",)


class UnsupportedContentType(ValueError):
    """An upload of a content type the port does not ingest yet."""


def _require_colpali(use_colpali: bool) -> None:
    if not use_colpali:
        raise NotImplementedError(
            "use_colpali=false needs the text index, which is not ported (ROADMAP Queue 1 item 3a)"
        )


class IngestionService:
    def __init__(
        self,
        database: SQLiteDatabase,
        storage: BaseStorage,
        colpali_embedding_model: ColpaliEmbeddingModel,
        colpali_vector_store: TorchMultiVectorStore,
        settings: Settings,
    ):
        self.db = database
        self.storage = storage
        self.colpali_embedding_model = colpali_embedding_model
        self.colpali_vector_store = colpali_vector_store
        self.settings = settings
        # serializes the device-bound embed+store phase across concurrent
        # ingest jobs; bound lazily to the running loop
        self._embed_lock: Optional[asyncio.Lock] = None

    def _get_embed_lock(self) -> asyncio.Lock:
        if self._embed_lock is None:
            self._embed_lock = asyncio.Lock()
        return self._embed_lock

    # ----------------------------------------------------------- ingest file

    async def ingest_file_content(
        self,
        file_bytes: bytes,
        filename: Optional[str],
        metadata: Dict[str, Any],
        auth: AuthContext,
        *,
        content_type: Optional[str] = None,
        folder_name: Optional[str] = None,
        end_user_id: Optional[str] = None,
        use_colpali: bool = True,
        metadata_types: Optional[Dict[str, str]] = None,
        external_id: Optional[str] = None,
    ) -> Document:
        """Create the document stub + upload raw bytes; processing happens
        in `process_ingestion_job`. Anything but a PNG raises
        `UnsupportedContentType` (the route answers 415)."""
        ctype = detect_content_type(file_bytes, filename, content_type)
        if ctype not in SUPPORTED_CONTENT_TYPES:
            raise UnsupportedContentType(
                f"content type {ctype!r} is not ingested by the port yet: only PNG page images "
                "(ROADMAP Queue 1 item 3b: PDF, JPEG and Office ingest wait for a decoder and a rasterizer)"
            )
        _require_colpali(use_colpali)
        if folder_name:
            raise NotImplementedError("folders are not ported (ROADMAP Queue 1 item 3d)")
        doc = Document(
            content_type=ctype,
            filename=filename,
            metadata=metadata or {},
            metadata_types=metadata_types or {},
            end_user_id=end_user_id,
            app_id=auth.app_id,
        )
        if external_id:
            doc.external_id = external_id
        key = f"ingest/{doc.external_id}/{filename or 'file'}"
        bucket, key = await self.storage.upload_file(file_bytes, key, ctype)
        doc.storage_info = {"bucket": bucket, "key": key}
        await self.db.store_document(doc, auth)
        await self.db.add_storage_bytes(auth, len(file_bytes))
        return doc

    def _page_chunks(self, data: bytes) -> List[Chunk]:
        """PNG bytes -> the page's image chunk with its u8 patches, or no
        chunk for a blank page."""
        page = decode_png(data)
        if is_blank_page(page):
            logger.info("skipping blank page 0")
            return []
        patches = preprocess_array_u8(page, self.settings.model.min_pixels, self.settings.model.max_pixels)
        return [Chunk(content=bytes_to_data_uri(data, "image/png"),
                      metadata={"is_image": True, "page": 0, "_patches": patches})]

    async def process_ingestion_job(self, document_id: str, auth: AuthContext, use_colpali: bool = True) -> Document:
        """The worker job body. A failure marks the document failed and
        re-raises."""
        phase_times: Dict[str, float] = {}
        t0 = time.perf_counter()
        doc = await self.db.get_document(document_id, auth)
        if doc is None:
            raise ValueError(f"document {document_id} not found")
        try:
            _require_colpali(use_colpali)
            data = await self.storage.download_file(doc.storage_info["bucket"], doc.storage_info["key"])
            phase_times["download"] = time.perf_counter() - t0
            t = time.perf_counter()
            image_chunks = await asyncio.to_thread(self._page_chunks, data)
            phase_times["rasterize"] = time.perf_counter() - t
            t = time.perf_counter()
            chunk_ids: List[str] = []
            if image_chunks:
                async with self._get_embed_lock():
                    await self._embed_and_store_colpali(doc, image_chunks, auth, chunk_ids)
            doc.chunk_ids = chunk_ids
            phase_times["embed_store"] = time.perf_counter() - t
            updates = {
                "system_metadata": {
                    "status": "completed",
                    "page_count": len(image_chunks) or None,
                    "phase_times": phase_times,
                    **({} if image_chunks else {"unsearchable": True}),
                },
                "additional_metadata": {},
                "chunk_ids": doc.chunk_ids,
            }
            await self.db.update_document(document_id, updates, auth)
            doc.system_metadata.update(updates["system_metadata"])
            total_s = time.perf_counter() - t0
            logger.info("ingested %s: %d image chunks in %.2fs %s", doc.filename, len(image_chunks), total_s,
                        phase_times)
            self._write_ingestion_summary(doc, status="completed", total_s=total_s, phase_times=phase_times,
                                          n_pages=len(image_chunks))
            return doc
        except Exception as e:
            logger.exception("ingestion of %s failed", document_id)
            await self.db.update_document(
                document_id, {"system_metadata": {"status": "failed", "error": str(e)}}, auth
            )
            self._write_ingestion_summary(doc, status="failed", total_s=time.perf_counter() - t0,
                                          phase_times=phase_times, error=str(e))
            raise

    def _write_ingestion_summary(self, doc: Document, *, status: str, total_s: float,
                                 phase_times: Dict[str, float], n_pages: int = 0,
                                 error: Optional[str] = None) -> None:
        """Per-job JSONL summary (`ingestion_service.py:295-336`), beside
        the telemetry directory (`./logs/` by default, as the reference)."""
        row = {
            "ts": datetime.now(timezone.utc).isoformat(),
            "document_id": doc.external_id,
            "filename": doc.filename,
            "app_id": doc.app_id,
            "status": status,
            "total_s": round(total_s, 3),
            "phase_times": {k: round(v, 3) for k, v in phase_times.items()},
            "text_chunks": 0,
            "pages": n_pages,
            "pages_per_s": round(n_pages / total_s, 3) if total_s > 0 else None,
        }
        if error:
            row["error"] = error
        if self.colpali_vector_store.last_store_metrics:
            row["store_metrics"] = self.colpali_vector_store.last_store_metrics
        try:
            path = Path(self.settings.telemetry.telemetry_dir).parent / "ingestion_summary.jsonl"
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(path, "a") as f:
                f.write(json.dumps(row, default=str) + "\n")
        except OSError:  # logging must never fail the job
            logger.debug("could not write ingestion summary")

    # --------------------------------------------------------- embed+store

    async def _embed_and_store_colpali(self, doc: Document, chunks: List[Chunk], auth: AuthContext,
                                       chunk_ids: List[str]) -> None:
        """Device-bound half of ingest (`ingestion_service.py:443-510`):
        batches of `worker.colpali_store_batch_size` chunks embed in worker
        threads, `worker.ingest_embed_prefetch` of them in flight, while
        the loop stores the batches before them."""
        batch = self.settings.worker.colpali_store_batch_size
        embed_sync = self.colpali_embedding_model.embed_for_ingestion_sync
        starts = list(range(0, len(chunks), batch))

        async def _embed(s: int):
            return await asyncio.to_thread(embed_sync, chunks[s : s + batch])

        depth = max(1, int(self.settings.worker.ingest_embed_prefetch))
        inflight = collections.deque(asyncio.ensure_future(_embed(s)) for s in starts[:depth])
        try:
            for bi, s in enumerate(starts):
                embs, fde = await inflight.popleft()
                if bi + depth < len(starts):
                    inflight.append(asyncio.ensure_future(_embed(starts[bi + depth])))
                sub = chunks[s : s + batch]
                for c in sub:  # transient artifacts never persist
                    c.metadata.pop("_patches", None)
                doc_chunks = [c.to_document_chunk(doc.external_id, s + j, e) for j, (c, e) in enumerate(zip(sub, embs))]
                _, ids, _ = await self.colpali_vector_store.store_embeddings(
                    doc_chunks, app_id=auth.app_id, fde_vectors=fde if len(fde) == len(doc_chunks) else None,
                )
                chunk_ids.extend(ids)
        except BaseException:
            for fut in inflight:
                if not fut.done():
                    fut.cancel()
            for fut in inflight:
                with contextlib.suppress(BaseException):
                    await fut
            raise
