"""Ingestion: port of `morphik_core_tpu/services/ingestion_service.py`
(`ingest_text`, `ingest_file_content`, `process_ingestion_job`,
`_embed_and_store`, `_embed_and_store_colpali`) for text and PNG pages.

Flow: upload (document stub with status=processing, raw bytes to
storage) -> queue -> [worker] download -> the parse ladder (XML chunks,
or parsed text split into chunks; a failed parse of a ColPali-native
file goes on image-only; nothing searchable -> the deep-parse rung ->
`unsearchable`) -> a PNG's page image: decode (`utils/png.py`), blank
check, u8 patches for the tower carried in chunk metadata `_patches` ->
the text store first (hashing embeddings), then, with `use_colpali`,
the ColPali store under the embed lock (the page image, or the text
chunks of a file without one) -> completed. `ingest_text` splits and
stores in the request.

Uploads: PNG and every type that is not ColPali-native (text/*,
markdown, html, json, xml, xlsx, ...) with either `use_colpali`; PDF,
DOCX and PPTX only with `use_colpali=false` (text only). The rest
answers 415.

Differences from the reference, recorded in ROADMAP Queue 3: an image
upload's bytes are not decoded as text (the reference indexes them as
UTF-8 text in the text store); the page payload stored with the chunk
is the uploaded PNG, where the reference re-encodes a q80 JPEG of at
most 1024 px; the tower embeds the uploaded pixels.

Not ported yet (ROADMAP Queue 1): JPEG and other images, PDF/Office
page images and video (item 3b), folders (item 3d).
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
from morphik_core_tpu_torch.embedding.base_embedding_model import BaseEmbeddingModel
from morphik_core_tpu_torch.embedding.colpali_embedding_model import ColpaliEmbeddingModel
from morphik_core_tpu_torch.models.colqwen.preprocess import is_blank_page, preprocess_array_u8
from morphik_core_tpu_torch.models.schemas import AuthContext, Chunk, Document
from morphik_core_tpu_torch.parser.morphik_parser import MorphikParser
from morphik_core_tpu_torch.storage.base_storage import BaseStorage
from morphik_core_tpu_torch.storage.content_types import DOCX, PPTX, detect_content_type, is_colpali_native_format
from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri
from morphik_core_tpu_torch.utils.png import decode_png
from morphik_core_tpu_torch.vector_store.text_vector_store import TextVectorStore
from morphik_core_tpu_torch.vector_store.torch_multivector_store import TorchMultiVectorStore

logger = logging.getLogger(__name__)

#: ColPali-native types the port parses for text when `use_colpali=false`
TEXT_ONLY_CONTENT_TYPES = ("application/pdf", DOCX, PPTX)


class UnsupportedContentType(ValueError):
    """An upload of a content type the port does not ingest yet."""


def check_upload(ctype: str, use_colpali: bool) -> None:
    """Raise `UnsupportedContentType` (the route answers 415) for an
    upload the port cannot ingest with this `use_colpali`."""
    if ctype == "image/png" or (not is_colpali_native_format(ctype) and not ctype.startswith("video/")):
        return
    if ctype in TEXT_ONLY_CONTENT_TYPES and not use_colpali:
        return
    why = ("its pages need the rasterizer; pass use_colpali=false for its text"
           if ctype in TEXT_ONLY_CONTENT_TYPES else "no decoder for it yet")
    raise UnsupportedContentType(
        f"content type {ctype!r} with use_colpali={str(use_colpali).lower()} is not ingested by the port yet: "
        f"{why} (ROADMAP Queue 1 item 3b: JPEG, PDF and Office page images, video)"
    )


def _refuse_folder(folder_name: Optional[str]) -> None:
    if folder_name:
        raise NotImplementedError("folders are not ported (ROADMAP Queue 1 item 3d)")


class IngestionService:
    def __init__(
        self,
        database: SQLiteDatabase,
        storage: BaseStorage,
        parser: MorphikParser,
        embedding_model: BaseEmbeddingModel,
        vector_store: TextVectorStore,
        colpali_embedding_model: Optional[ColpaliEmbeddingModel],
        colpali_vector_store: Optional[TorchMultiVectorStore],
        settings: Settings,
    ):
        self.db = database
        self.storage = storage
        self.parser = parser
        self.embedding_model = embedding_model
        self.vector_store = vector_store
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

    def _colpali_on(self, use_colpali: bool) -> bool:
        return bool(use_colpali) and self.colpali_vector_store is not None

    # ----------------------------------------------------------- ingest text

    async def ingest_text(
        self,
        content: str,
        filename: Optional[str],
        metadata: Dict[str, Any],
        auth: AuthContext,
        *,
        folder_name: Optional[str] = None,
        end_user_id: Optional[str] = None,
        use_colpali: bool = True,
        metadata_types: Optional[Dict[str, str]] = None,
    ) -> Document:
        """Split and store `content` in the request; the document is
        `completed` (or `failed`, re-raising) when this returns."""
        _refuse_folder(folder_name)
        doc = Document(
            content_type="text/plain",
            filename=filename,
            metadata=metadata or {},
            metadata_types=metadata_types or {},
            end_user_id=end_user_id,
            app_id=auth.app_id,
        )
        await self.db.store_document(doc, auth)
        try:
            chunks = await self.parser.split_text(content)
            await self._embed_and_store(doc, chunks, [], auth, use_colpali)
        except Exception as e:  # the document must never stay 'processing'
            await self.db.update_document(
                doc.external_id, {"system_metadata": {"status": "failed", "error": str(e)[:500]}}, auth
            )
            raise
        await self.db.update_document(
            doc.external_id,
            {"system_metadata": {"status": "completed", "content_length": len(content)}, "chunk_ids": doc.chunk_ids},
            auth,
        )
        doc.system_metadata["status"] = "completed"
        return doc

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
        in `process_ingestion_job`. An upload `check_upload` refuses
        raises `UnsupportedContentType`."""
        ctype = detect_content_type(file_bytes, filename, content_type)
        check_upload(ctype, use_colpali)
        _refuse_folder(folder_name)
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

    async def _parse_text(self, doc: Document, data: bytes, ctype: str, use_colpali: bool):
        """The text rungs of the ladder -> (additional_metadata, text
        chunks). A failed parse of a ColPali-native file goes on
        image-only; of any other file, it fails the job."""
        if ctype.startswith("image/"):  # an image's bytes are not text (ROADMAP Queue 3)
            return {}, []
        try:
            if self.parser.is_xml_file(doc.filename, ctype):
                return {}, self.parser.parse_and_chunk_xml(data.decode("utf-8", errors="replace"))
            additional_metadata, text = await self.parser.parse_file_to_text(data, doc.filename, ctype)
            if text.strip():
                return additional_metadata, await self.parser.split_text(text)
            logger.warning("no text extracted from %s", doc.filename)
            return additional_metadata, []
        except Exception as e:
            if self._colpali_on(use_colpali) and is_colpali_native_format(ctype):
                logger.warning("text parse of %s failed (%s); continuing image-only", doc.filename, e)
                return {"parse_error": str(e)}, []
            raise

    async def process_ingestion_job(self, document_id: str, auth: AuthContext, use_colpali: bool = True) -> Document:
        """The worker job body. A failure marks the document failed and
        re-raises."""
        phase_times: Dict[str, float] = {}
        t0 = time.perf_counter()
        doc = await self.db.get_document(document_id, auth)
        if doc is None:
            raise ValueError(f"document {document_id} not found")
        try:
            data = await self.storage.download_file(doc.storage_info["bucket"], doc.storage_info["key"])
            phase_times["download"] = time.perf_counter() - t0
            t = time.perf_counter()
            ctype = doc.content_type or detect_content_type(data, doc.filename)
            additional_metadata, text_chunks = await self._parse_text(doc, data, ctype, use_colpali)
            phase_times["parse"] = time.perf_counter() - t
            image_chunks: List[Chunk] = []
            if self._colpali_on(use_colpali) and ctype == "image/png":
                t = time.perf_counter()
                image_chunks = await asyncio.to_thread(self._page_chunks, data)
                phase_times["rasterize"] = time.perf_counter() - t
            # the deep-parse rung: nothing searchable so far -> OCR (none
            # configured: ({}, "")); still nothing -> accepted, but unsearchable
            unsearchable = False
            if not text_chunks and not image_chunks:
                t = time.perf_counter()
                deep_meta, deep_text = await self.parser.parse_file_to_text_deep(data, doc.filename, ctype)
                phase_times["deep_parse"] = time.perf_counter() - t
                if deep_text.strip():
                    additional_metadata.update(deep_meta)
                    text_chunks = await self.parser.split_text(deep_text)
                if not text_chunks:
                    unsearchable = True
                    logger.warning("document %s accepted but unsearchable", doc.filename)
            t = time.perf_counter()
            await self._embed_and_store(doc, text_chunks, image_chunks, auth, use_colpali)
            phase_times["embed_store"] = time.perf_counter() - t
            updates = {
                "system_metadata": {
                    "status": "completed",
                    "page_count": len(image_chunks) or None,
                    "phase_times": phase_times,
                    **({"unsearchable": True} if unsearchable else {}),
                },
                "additional_metadata": additional_metadata,
                "chunk_ids": doc.chunk_ids,
            }
            await self.db.update_document(document_id, updates, auth)
            doc.system_metadata.update(updates["system_metadata"])
            total_s = time.perf_counter() - t0
            logger.info("ingested %s: %d text + %d image chunks in %.2fs %s", doc.filename, len(text_chunks),
                        len(image_chunks), total_s, phase_times)
            self._write_ingestion_summary(doc, status="completed", total_s=total_s, phase_times=phase_times,
                                          n_text=len(text_chunks), n_pages=len(image_chunks))
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
                                 phase_times: Dict[str, float], n_text: int = 0, n_pages: int = 0,
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
            "text_chunks": n_text,
            "pages": n_pages,
            "pages_per_s": round(n_pages / total_s, 3) if total_s > 0 else None,
        }
        if error:
            row["error"] = error
        if self.colpali_vector_store is not None and self.colpali_vector_store.last_store_metrics:
            row["store_metrics"] = self.colpali_vector_store.last_store_metrics
        try:
            path = Path(self.settings.telemetry.telemetry_dir).parent / "ingestion_summary.jsonl"
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(path, "a") as f:
                f.write(json.dumps(row, default=str) + "\n")
        except OSError:  # logging must never fail the job
            logger.debug("could not write ingestion summary")

    # --------------------------------------------------------- embed+store

    async def _embed_and_store(self, doc: Document, text_chunks: List[Chunk], image_chunks: List[Chunk],
                               auth: AuthContext, use_colpali: bool) -> None:
        """The text store first (`ingestion_service.py:417-441`), then, with
        `use_colpali`, the ColPali store under the embed lock: the page
        images, or the text chunks of a file without any."""
        chunk_ids: List[str] = []
        if text_chunks:
            embeddings = await self.embedding_model.embed_for_ingestion(text_chunks)
            doc_chunks = [c.to_document_chunk(doc.external_id, i, e)
                          for i, (c, e) in enumerate(zip(text_chunks, embeddings))]
            _, ids, _ = await self.vector_store.store_embeddings(doc_chunks, app_id=auth.app_id)
            chunk_ids.extend(ids)
        colpali_chunks = image_chunks or text_chunks
        if self._colpali_on(use_colpali) and self.colpali_embedding_model is not None and colpali_chunks:
            async with self._get_embed_lock():
                await self._embed_and_store_colpali(doc, colpali_chunks, auth, chunk_ids)
        doc.chunk_ids = chunk_ids

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
