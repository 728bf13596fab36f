"""Ingestion: port of `morphik_core_tpu/services/ingestion_service.py`
(`ingest_text`, `ingest_file_content`, `process_ingestion_job`,
`_image_to_data_uri`, `_rasterize_pdf_pooled`,
`_create_chunks_multivector`, `_embed_and_store`,
`_embed_and_store_colpali`).

Flow: upload (document stub with status=processing, raw bytes to
storage) -> queue -> [worker] download -> the parse ladder (XML chunks,
or parsed text split into chunks; a failed parse of a ColPali-native
file goes on image-only) -> with `use_colpali`, page images: a PDF's
pages from the raster pool (q70 JPEG payloads, blank flags and u8
patches of the decoded payload, streamed in page order), an image
upload (its first frame or page), PPTX slides and DOCX text pages as q80 JPEG payloads of at most
1024 px (`_image_to_data_uri`), blank pages skipped -> the text store
first (hashing embeddings), then the ColPali store under the embed lock
(the page images, or the text chunks of a file without any) -> nothing
searchable: the deep-parse rung (OCR), else `unsearchable` -> completed.
`ingest_text` splits and stores in the request. With a remote embedder
(`morphik.colpali_mode="api"`) each chunk's `content` (a page's q80/q70
JPEG data URI) goes over the wire, one request in flight; its page
patches, prepared as for the tower, are dropped unused.

A PDF's pages reach the embed stage through a `PageStream` that holds at
most `ingest_embed_prefetch + 1` store batches of rastered pages, so a
long PDF never holds every page's patches at once; the stored rows are
those of the reference's whole-list order.

Uploads: everything but video, images whose bytes Pillow would open
with a plugin the port does not decode (AVIF, DDS, ...) or
that no plugin recognizes, the variants the decoders refuse (12-bit,
hierarchical and arithmetic-coded lossless JPEGs, arithmetic-coded ones
Pillow cannot load, progressive ones with coefficient bits left
unrefined; the TIFF, BMP, PSD and WebP variants their modules name) and
decompression bombs: those answer 415 (ROADMAP Queue 1 item 3b-ii). An
image upload is sniffed as `Image.open` sniffs it, whatever its content
type. PNG (Adam7, 16-bit), JPEG (progressive, multi-scan, CMYK / YCCK,
arithmetic-coded, lossless), GIF, BMP / DIB, TIFF (CCITT, LZW, Deflate,
PackBits, JPEG), WebP (lossy, lossless, animated), Netpbm, ICO / CUR,
PSD, PCX / DCX, TGA, SGI, Sun raster, QOI, XBM, XPM and JPEG 2000 (JP2,
JPH and raw codestreams: Part 1, HTJ2K and the Part 2 OpenJPEG reads; a
file Pillow cannot load fails its job) are ingested in
Pillow's modes (`utils/image.py::read_image`), a multi-frame file as its
first frame.

`folder_name` on either ingest path puts the document in that folder
(created, with its ancestors, when missing). `update_document` merges
metadata, or re-ingests new text or a new file under the same id (the
old chunks deleted from both stores first; a new file's type detected
again and its job run again, so its pages run the tower again).

Differences from the reference, recorded in ROADMAP Queue 3: an image
upload's bytes are not decoded as text (the reference indexes them as
UTF-8 text in the text store); an image, PPTX or DOCX that fails to
decode or render fails the job, where the reference logs it and goes on
without page images.
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
from typing import Any, AsyncIterator, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from morphik_core_tpu_torch.config import Settings
from morphik_core_tpu_torch.database.sqlite_database import SQLiteDatabase
from morphik_core_tpu_torch.embedding.base_embedding_model import BaseEmbeddingModel
from morphik_core_tpu_torch.embedding.colpali_api_embedding_model import ColpaliApiEmbeddingModel
from morphik_core_tpu_torch.embedding.colpali_embedding_model import ColpaliEmbeddingModel
from morphik_core_tpu_torch.models.colqwen.preprocess import is_blank_page, resize_mode_u8, to_rgb_u8
from morphik_core_tpu_torch.models.schemas import AuthContext, Chunk, Document
from morphik_core_tpu_torch.parser.morphik_parser import MorphikParser
from morphik_core_tpu_torch.parser.office import pptx_to_slides
from morphik_core_tpu_torch.parser.pdf import extract_pages_text, rasterize_pdf
from morphik_core_tpu_torch.parser.raster_pool import PageStream, RasterPool
from morphik_core_tpu_torch.parser.text_render import UnsupportedText, render_text_page
from morphik_core_tpu_torch.storage.base_storage import BaseStorage
from morphik_core_tpu_torch.storage.content_types import DOCX, PPTX, detect_content_type, is_colpali_native_format
from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri
from morphik_core_tpu_torch.utils.image import (UnsupportedImage, open_image, pillow_comment, probe_image,
                                                read_image)
from morphik_core_tpu_torch.utils.jpeg import JpegCoefficients, encode_jpeg
from morphik_core_tpu_torch.vector_store.text_vector_store import TextVectorStore
from morphik_core_tpu_torch.vector_store.torch_multivector_store import TorchMultiVectorStore

logger = logging.getLogger(__name__)

# Pillow's JPEG writer fails on a comment whose COM segment does not fit its first
# 64 KiB buffer beside SOI and APP0 (a payload is at most 1024 px wide)
MAX_PAYLOAD_COMMENT = 65511


class UnsupportedContentType(ValueError):
    """An upload of a content type the port does not ingest."""


def check_upload(ctype: str, data: bytes) -> None:
    """Raise `UnsupportedContentType` (the route answers 415) for an
    upload the port does not ingest: video, and an `image/*` upload whose
    bytes Pillow would open with a plugin the port does not decode (AVIF,
    DDS, ...) or that a decoder refuses by name (checked on the headers:
    `utils/image.py::probe_image` sniffs the bytes as `Image.open` does,
    whatever the content type says, `image/jph` too). Bytes `Image.open`
    fails on pass (no plugin identifies them, a broken header, a
    decompression bomb, a refusal marked `open_fails` such as a 12-bit
    JPEG): the reference stores no page for them and completes the job;
    a file that fails only in `load` (a JPEG 2000 OpenJPEG fails, a
    truncated scan) passes and fails its job, as the reference's does."""
    if ctype.startswith("video/"):
        raise UnsupportedContentType(f"content type {ctype!r} is not ingested: video is not ingested by the port "
                                     "(ROADMAP Queue 1 item 3b-ii)")
    if ctype.startswith("image/"):
        try:
            probe_image(data)
        except UnsupportedImage as e:
            if not e.open_fails:
                raise UnsupportedContentType(f"content type {ctype!r} is not ingested: {e}") from e
        except ValueError:
            pass


def _image_to_data_uri(pixels: np.ndarray, mode: str, palette: Optional[np.ndarray], max_width: int,
                       quality: int = 80, comment: bytes = b"") -> Tuple[str, JpegCoefficients]:
    """`ingestion_service.py:46-54`: resize (LANCZOS, Pillow's mode rules:
    I;16 in 16 bits) to at most `max_width`, convert to RGB unless RGB or
    L (I;16 clipped), q`quality` JPEG, with the upload's `info["comment"]`
    as Pillow's JPEG writer keeps it (`utils/image.py::pillow_comment`) ->
    (its data URI, its coefficients for `jpeg.decode_own`)."""
    h, w = pixels.shape[:2]
    if w > max_width:
        ratio = max_width / w
        pixels = resize_mode_u8(pixels, mode, (max(1, int(h * ratio)), max_width))
        if mode == "PA":   # Pillow's PA image resized by a filter comes back with an empty palette: all black
            palette = np.zeros_like(palette)
    if mode not in ("RGB", "L"):
        pixels = to_rgb_u8(pixels, mode, palette)
    if len(comment) > MAX_PAYLOAD_COMMENT:
        raise OSError("broken data stream when writing image file")
    data, coeffs = encode_jpeg(pixels, quality, comment)
    return bytes_to_data_uri(data, "image/jpeg"), coeffs


class IngestionService:
    def __init__(
        self,
        database: SQLiteDatabase,
        storage: BaseStorage,
        parser: MorphikParser,
        embedding_model: BaseEmbeddingModel,
        vector_store: TextVectorStore,
        colpali_embedding_model: Optional[Union[ColpaliEmbeddingModel, ColpaliApiEmbeddingModel]],
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
        self.raster_pool = RasterPool(settings.worker.raster_processes)
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
        doc = Document(
            content_type="text/plain",
            filename=filename,
            metadata=metadata or {},
            metadata_types=metadata_types or {},
            folder_name=folder_name,
            end_user_id=end_user_id,
            app_id=auth.app_id,
        )
        await self._resolve_folder(doc, folder_name, auth)
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
        check_upload(ctype, file_bytes)
        doc = Document(
            content_type=ctype,
            filename=filename,
            metadata=metadata or {},
            metadata_types=metadata_types or {},
            folder_name=folder_name,
            end_user_id=end_user_id,
            app_id=auth.app_id,
        )
        if external_id:
            doc.external_id = external_id
        await self._resolve_folder(doc, folder_name, auth)
        key = f"ingest/{doc.external_id}/{filename or 'file'}"
        bucket, key = await self.storage.upload_file(file_bytes, key, ctype)
        doc.storage_info = {"bucket": bucket, "key": key}
        await self.db.store_document(doc, auth)
        await self.db.add_storage_bytes(auth, len(file_bytes))
        return doc

    # ------------------------------------------------------- page images

    def _create_chunks_multivector(self, ctype: str, data: bytes, text: str) -> List[Chunk]:
        """File bytes -> page-image chunks (`ingestion_service.py:374-413`):
        q80 JPEG data URIs, blank pages skipped (checked on the page as
        rendered or uploaded). Each chunk carries its JPEG's coefficients
        in `_jpeg` for the embedder's `decode_own`."""
        max_w = 1024
        dpi = self.settings.pdf.colpali_pdf_dpi
        comment = b""
        if ctype.startswith("image/"):
            # the reference's two stages: where `Image.open` fails it logs and stores no page, where `load`
            # fails the job fails
            try:
                open_image(data)
            except Exception as e:  # noqa: BLE001
                logger.warning("image decode failed: %s", e)
                return []
            # a JPEG 2000's tier-1 and HT blocks run where the ColPali model runs (else on the card)
            images = [read_image(data, getattr(getattr(self, "colpali_embedding_model", None), "device", None))]
            comment = pillow_comment(data)
        elif ctype == "application/pdf":
            pages, backend = rasterize_pdf(data, dpi=dpi)
            logger.info("rasterized %d pdf pages via %s", len(pages), backend)
            images = [(p, "RGB", None) for p in pages]
        elif ctype == PPTX:
            images = [(render_text_page(s, dpi=100), "RGB", None) for s in pptx_to_slides(data)]
        elif ctype in (DOCX, "application/msword"):
            # no office -> PDF converter: the extracted text in 3200-character pages
            pages = [text[i : i + 3200] for i in range(0, max(len(text), 1), 3200)]
            images = [(render_text_page(p, dpi=100), "RGB", None) for p in pages]
        else:  # video and the other types: no page images
            return []
        chunks = []
        for page, (pixels, mode, palette) in enumerate(images):
            if is_blank_page(to_rgb_u8(pixels, mode, palette)):
                logger.info("skipping blank page %d", page)
                continue
            uri, coeffs = _image_to_data_uri(pixels, mode, palette, max_width=max_w, comment=comment)
            chunks.append(Chunk(content=uri, metadata={"is_image": True, "page": page, "_jpeg": coeffs}))
        return chunks

    async def _pdf_page_stream(self, data: bytes) -> Optional[PageStream]:
        """A PDF's pages from the raster pool in prep mode
        (`_rasterize_pdf_pooled`), as a stream that holds at most
        `ingest_embed_prefetch + 1` store batches; None for a PDF without
        pages (the caller goes down the ladder)."""
        texts = await asyncio.to_thread(extract_pages_text, data)
        if not texts:
            return None
        w = self.settings.worker
        window = (max(1, int(w.ingest_embed_prefetch)) + 1) * w.colpali_store_batch_size
        prep = (self.settings.model.min_pixels, self.settings.model.max_pixels)
        return self.raster_pool.stream_pages(texts, self.settings.pdf.colpali_pdf_dpi, prep=prep, window=window)

    @staticmethod
    async def _stream_chunks(stream: PageStream) -> AsyncIterator[Chunk]:
        async for page, jpeg, patches, grid, blank in stream:  # TRUE page indices
            if blank:
                logger.info("skipping blank page %d", page)
                stream.release(1)
                continue
            yield Chunk(content=bytes_to_data_uri(jpeg, "image/jpeg"),
                        metadata={"is_image": True, "page": page, "_patches": (patches, grid)})

    async def _parse_text(self, doc: Document, data: bytes, ctype: str, use_colpali: bool):
        """The text rungs of the ladder -> (additional_metadata, text, text
        chunks). A failed parse (with `parser_mode="api"`: every parse
        endpoint failed) of a ColPali-native file goes on image-only, with
        `parse_error` in the metadata; of any other file, it fails the job."""
        if ctype.startswith("image/") and self.parser.parser_mode != "api":
            return {}, "", []  # an image's bytes are not text (ROADMAP Queue 3); a parse endpoint reads images
        try:
            if self.parser.is_xml_file(doc.filename, ctype):
                return {}, "", self.parser.parse_and_chunk_xml(data.decode("utf-8", errors="replace"))
            additional_metadata, text = await self.parser.parse_file_to_text(data, doc.filename, ctype)
            if text.strip():
                return additional_metadata, text, await self.parser.split_text(text)
            logger.warning("no text extracted from %s", doc.filename)
            return additional_metadata, text, []
        except Exception as e:
            if self._colpali_on(use_colpali) and is_colpali_native_format(ctype):
                logger.warning("text parse of %s failed (%s); continuing image-only", doc.filename, e)
                return {"parse_error": str(e)}, "", []
            raise

    async def process_ingestion_job(self, document_id: str, auth: AuthContext, use_colpali: bool = True) -> Document:
        """The worker job body. A failure marks the document failed and
        re-raises."""
        phase_times: Dict[str, float] = {}
        t0 = time.perf_counter()
        doc = await self.db.get_document(document_id, auth)
        if doc is None:
            raise ValueError(f"document {document_id} not found")
        stream: Optional[PageStream] = None
        try:
            data = await self.storage.download_file(doc.storage_info["bucket"], doc.storage_info["key"])
            phase_times["download"] = time.perf_counter() - t0
            t = time.perf_counter()
            ctype = doc.content_type or detect_content_type(data, doc.filename)
            additional_metadata, text, text_chunks = await self._parse_text(doc, data, ctype, use_colpali)
            phase_times["parse"] = time.perf_counter() - t
            image_chunks: List[Chunk] = []
            if self._colpali_on(use_colpali):
                t = time.perf_counter()
                if ctype == "application/pdf":
                    stream = await self._pdf_page_stream(data)
                if stream is None:
                    image_chunks = await asyncio.to_thread(self._create_chunks_multivector, ctype, data, text)
                phase_times["rasterize"] = time.perf_counter() - t
            t = time.perf_counter()
            doc.chunk_ids = []
            pages = self._stream_chunks(stream) if stream is not None else image_chunks
            n_pages = await self._embed_and_store(doc, text_chunks, pages, auth, use_colpali,
                                                  release=stream.release if stream is not None else None)
            phase_times["embed_store"] = time.perf_counter() - t
            if stream is not None:  # the raster ran beside the embed
                phase_times["rasterize"] += stream.seconds
            # the deep-parse rung: nothing searchable -> OCR (none configured:
            # ({}, "")); still nothing -> accepted, but unsearchable
            unsearchable = False
            if not text_chunks and not n_pages:
                t = time.perf_counter()
                deep_meta, deep_text = await self.parser.parse_file_to_text_deep(data, doc.filename, ctype)
                phase_times["deep_parse"] = time.perf_counter() - t
                if deep_text.strip():
                    additional_metadata.update(deep_meta)
                    text_chunks = await self.parser.split_text(deep_text)
                    await self._embed_and_store(doc, text_chunks, [], auth, use_colpali)
                if not text_chunks:
                    unsearchable = True
                    logger.warning("document %s accepted but unsearchable", doc.filename)
            updates = {
                "system_metadata": {
                    "status": "completed",
                    "page_count": n_pages or None,
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
                        n_pages, total_s, phase_times)
            self._write_ingestion_summary(doc, status="completed", total_s=total_s, phase_times=phase_times,
                                          n_text=len(text_chunks), n_pages=n_pages)
            return doc
        except Exception as e:
            logger.exception("ingestion of %s failed", document_id)
            if isinstance(e, UnsupportedText):
                await self._drop_refused_rows(document_id, auth)
            await self.db.update_document(
                document_id, {"system_metadata": {"status": "failed", "error": str(e)}}, auth
            )
            self._write_ingestion_summary(doc, status="failed", total_s=time.perf_counter() - t0,
                                          phase_times=phase_times, error=str(e))
            raise
        finally:
            if stream is not None:
                await stream.aclose()

    async def _drop_refused_rows(self, document_id: str, auth: AuthContext) -> None:
        """Delete what a job refused by the port's own renderer stored
        before the refusal (its text chunks, the pages of a PDF embedded
        before the refused one) from both stores. The reference draws such
        a page and completes, so no row of the failed document may stay
        searchable or counted. `_embed_and_store` has unwound by now: no
        batch is in flight to be stored after the delete. Other failures
        keep their rows, as the reference's do."""
        if self.colpali_vector_store is not None:
            await self.colpali_vector_store.delete_chunks_by_document_id(document_id, auth.app_id)
        await self.vector_store.delete_chunks_by_document_id(document_id, auth.app_id)

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

    async def _embed_and_store(self, doc: Document, text_chunks: List[Chunk],
                               image_chunks: Union[Sequence[Chunk], AsyncIterator[Chunk]], auth: AuthContext,
                               use_colpali: bool, release=None) -> int:
        """The text store first (`ingestion_service.py:417-441`), then, with
        `use_colpali`, the ColPali store under the embed lock: the page
        images, or the text chunks of a file without any. `doc.chunk_ids`
        gains the ids stored. -> the number of page images stored."""
        chunk_ids: List[str] = list(doc.chunk_ids)
        if text_chunks:
            embeddings = await self.embedding_model.embed_for_ingestion(text_chunks)
            doc_chunks = [c.to_document_chunk(doc.external_id, i, e)
                          for i, (c, e) in enumerate(zip(text_chunks, embeddings))]
            _, ids, _ = await self.vector_store.store_embeddings(doc_chunks, app_id=auth.app_id)
            chunk_ids.extend(ids)
        n_pages = 0
        if self._colpali_on(use_colpali) and self.colpali_embedding_model is not None:
            async with self._get_embed_lock():
                n_pages = await self._embed_and_store_colpali(doc, image_chunks, auth, chunk_ids, release)
                if not n_pages and text_chunks:
                    await self._embed_and_store_colpali(doc, text_chunks, auth, chunk_ids)
        doc.chunk_ids = chunk_ids
        return n_pages

    async def _embed_and_store_colpali(self, doc: Document, chunks: Union[Sequence[Chunk], AsyncIterator[Chunk]],
                                       auth: AuthContext, chunk_ids: List[str], release=None) -> int:
        """Device-bound half of ingest (`ingestion_service.py:443-510`):
        batches of `worker.colpali_store_batch_size` chunks embed in worker
        threads, `worker.ingest_embed_prefetch` of them in flight, while
        the loop stores the batches before them. `chunks` may be a stream
        of page chunks: `release(n)` is told when n of them were embedded
        (their patches dropped). -> the number of chunks stored."""
        batch = self.settings.worker.colpali_store_batch_size
        embedder = self.colpali_embedding_model
        embed_sync = getattr(embedder, "embed_for_ingestion_sync", None)
        depth = max(1, int(self.settings.worker.ingest_embed_prefetch))
        if embed_sync is None:  # a remote embedder: one request in flight, as the reference keeps it
            depth = 1

        async def embed_remote(sub: List[Chunk]):
            return await embedder.embed_for_ingestion(sub), []
        inflight: collections.deque = collections.deque()
        n = 0

        async def store(fut, sub: List[Chunk], s: int) -> None:
            embs, fde = await fut
            if release is not None:
                release(len(sub))
            for c in sub:  # transient artifacts never persist
                c.metadata.pop("_patches", None)
                c.metadata.pop("_jpeg", None)
            doc_chunks = [c.to_document_chunk(doc.external_id, s + j, e) for j, (c, e) in enumerate(zip(sub, embs))]
            _, ids, _ = await self.colpali_vector_store.store_embeddings(
                doc_chunks, app_id=auth.app_id, fde_vectors=fde if len(fde) == len(doc_chunks) else None,
            )
            chunk_ids.extend(ids)

        async def launch(sub: List[Chunk]) -> None:
            """Start `sub`'s embed; with `depth` in flight, first wait for the
            oldest, then store it while the new one runs."""
            nonlocal n
            oldest = inflight.popleft() if len(inflight) == depth else None
            if oldest is not None:
                await oldest[0]
            fut = asyncio.to_thread(embed_sync, sub) if embed_sync is not None else embed_remote(sub)
            inflight.append((asyncio.ensure_future(fut), sub, n))
            n += len(sub)
            if oldest is not None:
                await store(*oldest)

        async def each(items):
            if isinstance(items, (list, tuple)):
                for c in items:
                    yield c
            else:
                async for c in items:
                    yield c

        try:
            pending: List[Chunk] = []
            async for c in each(chunks):
                pending.append(c)
                if len(pending) == batch:
                    await launch(pending)
                    pending = []
            if pending:
                await launch(pending)
            while inflight:
                await store(*inflight.popleft())
        except BaseException:
            for fut, _, _ in inflight:
                if not fut.done():
                    fut.cancel()
            for fut, _, _ in inflight:
                with contextlib.suppress(BaseException):
                    await fut
            raise
        return n

    # -------------------------------------------------------------- update

    async def update_document(
        self,
        document_id: str,
        auth: AuthContext,
        *,
        content: Optional[str] = None,
        file_bytes: Optional[bytes] = None,
        filename: Optional[str] = None,
        metadata: Optional[Dict[str, Any]] = None,
        use_colpali: bool = True,
    ) -> Optional[Document]:
        """`ingestion_service.py:514-563`: merge `metadata` into the
        document's; with `content` or `file_bytes`, delete its chunks from
        both stores and ingest the new content under the same id (a file:
        stored, its type detected again, its job run in this call). ->
        the document as stored, None when not found. A replacement the
        port does not ingest raises `UnsupportedContentType`."""
        doc = await self.db.get_document(document_id, auth)
        if doc is None:
            return None
        if file_bytes is not None:
            new_name = filename or doc.filename
            ctype = detect_content_type(file_bytes, new_name)
            check_upload(ctype, file_bytes)
        if metadata is not None:
            await self.db.update_document(document_id, {"metadata": {**doc.metadata, **metadata}}, auth)
        if content is None and file_bytes is None:
            return await self.db.get_document(document_id, auth)
        if self.colpali_vector_store is not None:
            await self.colpali_vector_store.delete_chunks_by_document_id(document_id, auth.app_id)
        await self.vector_store.delete_chunks_by_document_id(document_id, auth.app_id)
        if file_bytes is not None:
            key = f"ingest/{doc.external_id}/{new_name or 'file'}"
            bucket, key = await self.storage.upload_file(file_bytes, key, ctype)
            await self.db.update_document(
                document_id,
                {"storage_info": {"bucket": bucket, "key": key}, "filename": new_name, "content_type": ctype,
                 "system_metadata": {"status": "processing"}},
                auth,
            )
            return await self.process_ingestion_job(document_id, auth, use_colpali)
        text_chunks = await self.parser.split_text(content)
        doc.chunk_ids = []
        await self._embed_and_store(doc, text_chunks, [], auth, use_colpali)
        await self.db.update_document(
            document_id, {"system_metadata": {"status": "completed"}, "chunk_ids": doc.chunk_ids}, auth
        )
        return await self.db.get_document(document_id, auth)

    async def _resolve_folder(self, doc: Document, folder_name: Optional[str], auth: AuthContext) -> None:
        """Put `doc` in the folder `folder_name` names (a path or a leaf
        name), creating it and its ancestors when missing."""
        if not folder_name:
            return
        folder = await self.db.create_folder(folder_name.strip("/"), auth)
        doc.folder_name = folder["name"]
        doc.folder_path = folder["path"]
        doc.folder_id = folder["id"]
