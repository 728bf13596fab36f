"""The v2 pipeline: copy of `morphik_core_tpu/services/v2_document_service.py`.
A document becomes page-scoped XML chunks (`<page n=...>` with one item
per text block), embedded by the text path's single-vector embedder into
the `ChunkV2Store`; a retrieve embeds the query and runs the store's
filtered cosine query over the documents the caller may see.

A PDF's items carry the block's bbox and a layout role from
`parser/layout.py` (t/h/title/r/f/li); other files are split into
3000-character pages of paragraphs. No kernel runs here: the hashing
embedder and the store are host numpy, as in the reference.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional
from xml.sax.saxutils import escape

from morphik_core_tpu_torch.database.sqlite_database import SQLiteDatabase
from morphik_core_tpu_torch.embedding.base_embedding_model import BaseEmbeddingModel
from morphik_core_tpu_torch.models.schemas import AuthContext, Chunk, Document, DocumentChunk
from morphik_core_tpu_torch.parser.layout import classify_blocks
from morphik_core_tpu_torch.parser.morphik_parser import MorphikParser
from morphik_core_tpu_torch.parser.pdf import extract_pages_blocks, extract_pages_text
from morphik_core_tpu_torch.storage.base_storage import BaseStorage
from morphik_core_tpu_torch.storage.content_types import detect_content_type
from morphik_core_tpu_torch.vector_store.chunk_v2_store import ChunkV2Store

logger = logging.getLogger(__name__)


class V2DocumentService:
    def __init__(self, database: SQLiteDatabase, storage: BaseStorage, parser: MorphikParser,
                 embedding_model: BaseEmbeddingModel, chunk_store: ChunkV2Store):
        self.db = database
        self.storage = storage
        self.parser = parser
        self.embedding_model = embedding_model
        self.chunk_store = chunk_store

    @staticmethod
    def _page_xml(page_no: int, text: str, blocks=None) -> str:
        """One page's XML chunk: with positioned `blocks`, an item per block
        tagged with its layout role and bbox; else a <t> per paragraph."""
        if blocks:
            body = "".join(
                f'<{tag} bbox="{b.bbox[0]:.1f},{b.bbox[1]:.1f},{b.bbox[2]:.1f},{b.bbox[3]:.1f}">'
                f"{escape(b.text)}</{tag}>"
                for tag, b in classify_blocks(blocks, first_page=page_no == 0)
            )
            return f'<page n="{page_no}">{body}</page>'
        paras = [p.strip() for p in text.split("\n\n") if p.strip()]
        body = "".join(f"<t>{escape(p)}</t>" for p in paras) or f"<t>{escape(text)}</t>"
        return f'<page n="{page_no}">{body}</page>'

    async def ingest_document(self, file_bytes: bytes, filename: Optional[str], metadata: Dict[str, Any],
                              auth: AuthContext, folder_path: Optional[str] = None) -> Document:
        """Store the file and its chunks in the request -> the document,
        `completed` (or `failed`, re-raising)."""
        ctype = detect_content_type(file_bytes, filename)
        doc = Document(content_type=ctype, filename=filename, metadata=metadata or {}, folder_path=folder_path,
                       app_id=auth.app_id)
        bucket, key = await self.storage.upload_file(file_bytes, f"v2/{doc.external_id}/{filename or 'file'}", ctype)
        doc.storage_info = {"bucket": bucket, "key": key, "pipeline": "v2"}
        await self.db.store_document(doc, auth)
        try:
            return await self._process(doc, file_bytes, filename, ctype, metadata, folder_path, auth)
        except Exception as e:  # the document must never stay 'processing'
            await self.db.update_document(
                doc.external_id, {"system_metadata": {"status": "failed", "error": str(e)[:500]}}, auth
            )
            raise

    async def _process(self, doc: Document, file_bytes: bytes, filename: Optional[str], ctype: str,
                       metadata: Dict[str, Any], folder_path: Optional[str], auth: AuthContext) -> Document:
        if ctype == "application/pdf":
            pages = extract_pages_text(file_bytes)
            try:
                page_blocks = extract_pages_blocks(file_bytes)
            except Exception:  # noqa: BLE001 — bboxes are best-effort
                page_blocks = [None] * len(pages)
        else:
            _, text = await self.parser.parse_file_to_text(file_bytes, filename, ctype)
            pages = [text[i : i + 3000] for i in range(0, max(len(text), 1), 3000)]
            page_blocks = [None] * len(pages)
        chunks: List[Chunk] = [
            Chunk(content=self._page_xml(i, t, blocks=(page_blocks[i] if i < len(page_blocks) else None)),
                  metadata={"page": i, "pipeline": "v2", **(metadata or {})})
            for i, t in enumerate(pages)
            if t.strip()
        ] or [Chunk(content=self._page_xml(0, ""), metadata={"page": 0, "pipeline": "v2"})]
        embeddings = await self.embedding_model.embed_for_ingestion(chunks)
        doc_chunks = [c.to_document_chunk(doc.external_id, i, e) for i, (c, e) in enumerate(zip(chunks, embeddings))]
        ids = await self.chunk_store.store_chunks(doc_chunks, embeddings, auth.app_id, folder_path)
        await self.db.update_document(
            doc.external_id, {"chunk_ids": ids, "system_metadata": {"status": "completed", "page_count": len(chunks)}},
            auth,
        )
        return await self.db.get_document(doc.external_id, auth)

    async def retrieve_chunks(self, query: str, auth: AuthContext, k: int = 10,
                              filters: Optional[Dict[str, Any]] = None,
                              folder_path: Optional[str] = None) -> List[DocumentChunk]:
        q = await self.embedding_model.embed_for_query(query)
        doc_ids = await self.db.find_authorized_and_filtered_documents(auth, None, {})
        return await self.chunk_store.query(q, k, app_id=auth.app_id, folder_path=folder_path, filters=filters,
                                            document_ids=doc_ids)

    async def delete_document(self, document_id: str, auth: AuthContext) -> bool:
        doc = await self.db.get_document(document_id, auth)
        if doc is None:
            return False
        await self.chunk_store.delete_document(document_id, auth.app_id)
        return await self.db.delete_document(document_id, auth)
