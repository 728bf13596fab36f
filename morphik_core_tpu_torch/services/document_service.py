"""Query side of the service plane: port of
`morphik_core_tpu/services/document_service.py` (`retrieve_chunks`
`:85-168`, `_apply_padding`, `retrieve_chunks_grouped`, `retrieve_docs`,
`batch_retrieve_documents`, `batch_retrieve_chunks`, `query` `:265-330`,
`_create_chunk_results`, `_create_document_results`, `delete_document`,
the document and folder summaries `:446-515`).

The query embedding and the auth + filter document lookup run
concurrently. With ColPali (`use_colpali`, default
`morphik.enable_colpali`) the search runs on the multivector store,
ColPali padding adds neighbour pages (score 0, is_padding), and results
carry base64 data URIs or download URLs; an image query (`query_image`,
a data URI or base64 PNG or JPEG) is decoded by `utils/image.py`. Without it, the
hybrid text store answers (`query_text` for BM25), and `use_reranking`
oversamples max(k, min(3k, 20)) chunks for the reranker, then keeps k.
As in the reference, the reranker runs only off the ColPali path.
`folder_name` / `folder_depth` scope a retrieve through the document ids
the database yields. A summary is a UTF-8 blob of at most 256 KB in the
storage bucket `summaries`, versioned in its document's or folder's
system metadata.

Not ported yet (ROADMAP Queue 1 item 3g): `output_format="text"`, the
vision completion that transcribes a page.
"""

from __future__ import annotations

import asyncio
import logging
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from morphik_core_tpu_torch.completion.models import BaseCompletionModel
from morphik_core_tpu_torch.config import Settings
from morphik_core_tpu_torch.database.sqlite_database import SQLiteDatabase
from morphik_core_tpu_torch.embedding.base_embedding_model import BaseEmbeddingModel
from morphik_core_tpu_torch.embedding.colpali_embedding_model import ColpaliEmbeddingModel
from morphik_core_tpu_torch.models.schemas import (
    AuthContext,
    ChatMessage,
    ChunkGroup,
    ChunkResult,
    CompletionRequest,
    DocumentChunk,
    DocumentContent,
    Document,
    DocumentResult,
    GroupedChunkResponse,
)
from morphik_core_tpu_torch.reranker.rerankers import BaseReranker
from morphik_core_tpu_torch.services.telemetry import PerformanceTracker
from morphik_core_tpu_torch.storage.base_storage import BaseStorage
from morphik_core_tpu_torch.utils.fast_ops import data_uri_to_bytes
from morphik_core_tpu_torch.utils.image import decode_image
from morphik_core_tpu_torch.vector_store.text_vector_store import TextVectorStore
from morphik_core_tpu_torch.vector_store.torch_multivector_store import (
    MULTIVECTOR_CHUNKS_BUCKET,
    TorchMultiVectorStore,
)

logger = logging.getLogger(__name__)


def _page_number(c) -> "int | None":
    """1-based page label of an image chunk: the page recorded at ingest,
    else chunk_number + 1."""
    if not c.metadata.get("is_image"):
        return None
    page = c.metadata.get("page")
    return page + 1 if isinstance(page, int) else c.chunk_number + 1


def _check_ported(output_format: str = "base64") -> None:
    if output_format == "text":
        raise NotImplementedError(
            'output_format="text" needs the vision completion, which is not ported (ROADMAP Queue 1 item 3g)'
        )


class DocumentService:
    def __init__(
        self,
        database: SQLiteDatabase,
        storage: BaseStorage,
        colpali_embedding_model: Optional[ColpaliEmbeddingModel],
        colpali_vector_store: Optional[TorchMultiVectorStore],
        completion_model: Optional[BaseCompletionModel],
        settings: Settings,
        *,
        embedding_model: Optional[BaseEmbeddingModel] = None,
        vector_store: Optional[TextVectorStore] = None,
        reranker: Optional[BaseReranker] = None,
    ):
        self.db = database
        self.storage = storage
        self.colpali_embedding_model = colpali_embedding_model
        self.colpali_vector_store = colpali_vector_store
        self.completion_model = completion_model
        self.settings = settings
        self.embedding_model = embedding_model
        self.vector_store = vector_store
        self.reranker = reranker

    # -------------------------------------------------------------- retrieve

    async def retrieve_chunks(
        self,
        query: str,
        auth: AuthContext,
        filters: Optional[Dict[str, Any]] = None,
        k: int = 4,
        min_score: float = 0.0,
        use_reranking: Optional[bool] = None,
        use_colpali: Optional[bool] = None,
        folder_name: Optional[Union[str, List[str]]] = None,
        folder_depth: Optional[int] = None,
        end_user_id: Optional[str] = None,
        padding: int = 0,
        output_format: str = "base64",
        query_image: Optional[str] = None,
        perf: Optional[PerformanceTracker] = None,
    ) -> List[ChunkResult]:
        _check_ported(output_format)
        perf = perf or PerformanceTracker("retrieve_chunks")
        using_colpali = bool(
            use_colpali if use_colpali is not None else self.settings.morphik.enable_colpali
        ) and self.colpali_vector_store is not None and self.colpali_embedding_model is not None
        should_rerank = bool(use_reranking) and self.reranker is not None and not using_colpali
        system_filters: Dict[str, Any] = {}
        if folder_name is not None:
            system_filters["folder_name"] = folder_name
        if folder_depth is not None:
            system_filters["folder_depth"] = folder_depth
        if end_user_id:
            system_filters["end_user_id"] = end_user_id

        perf.start_phase("embed_and_auth")
        embed_model = self.colpali_embedding_model if using_colpali else self.embedding_model
        if query_image is not None and using_colpali:
            raw = data_uri_to_bytes(query_image)
            # the reference caps image queries at 10 MB
            if len(raw) > 10 * 1024 * 1024:
                raise ValueError("query_image exceeds the 10 MB limit")
            page = await asyncio.to_thread(decode_image, raw)
            embed_task = embed_model.embed_for_query(page)
        else:
            embed_task = embed_model.embed_for_query(query)
        q_embedding, doc_ids = await asyncio.gather(
            embed_task,
            self.db.find_authorized_and_filtered_documents(auth, filters, system_filters),
        )
        if not doc_ids:
            return []

        perf.start_phase("vector_search")
        if using_colpali:
            chunks = await self.colpali_vector_store.query_similar(
                q_embedding, k=k, doc_ids=doc_ids, app_id=auth.app_id,
                skip_image_content=(output_format == "url"),
            )
        else:
            # oversample for the reranker, never below k: it reorders, it must not shrink
            search_k = max(k, min(3 * k, 20)) if should_rerank else k
            chunks = await self.vector_store.query_similar(
                q_embedding, k=search_k, doc_ids=doc_ids, app_id=auth.app_id, query_text=query,
            )
        if should_rerank and chunks:
            perf.start_phase("rerank")
            chunks = (await self.reranker.rerank(query, chunks))[:k]
        chunks = [c for c in chunks if c.score >= min_score]
        if using_colpali and padding > 0 and chunks:
            perf.start_phase("padding")
            chunks = await self._apply_padding(chunks, padding, auth, skip_image_content=(output_format == "url"))

        perf.start_phase("materialize")
        results = await self._create_chunk_results(auth, chunks, output_format)
        perf.log_summary()
        return results

    async def _apply_padding(
        self, chunks: List[DocumentChunk], padding: int, auth: AuthContext, skip_image_content: bool = False,
    ) -> List[DocumentChunk]:
        """Expand image-chunk matches with neighbour pages; non-image
        chunks are dropped when padding > 0 (the reference's semantics).
        Padding chunks carry score 0 and is_padding metadata."""
        matched = [c for c in chunks if c.metadata.get("is_image")]
        have = {(c.document_id, c.chunk_number) for c in matched}
        wanted: List[Tuple[str, int]] = []
        for c in matched:
            for off in range(1, padding + 1):
                for num in (c.chunk_number - off, c.chunk_number + off):
                    if num >= 0 and (c.document_id, num) not in have:
                        wanted.append((c.document_id, num))
                        have.add((c.document_id, num))
        extra = await self.colpali_vector_store.get_chunks_by_id(
            wanted, app_id=auth.app_id, skip_image_content=skip_image_content
        ) if wanted else []
        for e in extra:
            e.score = 0.0
            e.metadata = dict(e.metadata)
            e.metadata["is_padding"] = True
        combined = matched + [e for e in extra if e.metadata.get("is_image")]
        combined.sort(key=lambda c: (-c.score, c.document_id, c.chunk_number))
        return combined

    async def retrieve_chunks_grouped(self, *args, **kwargs) -> GroupedChunkResponse:
        results = await self.retrieve_chunks(*args, **kwargs)
        groups: Dict[Tuple[str, int], ChunkGroup] = {}
        mains = [r for r in results if not r.is_padding]
        pads = [r for r in results if r.is_padding]
        for r in mains:
            groups[(r.document_id, r.chunk_number)] = ChunkGroup(main_chunk=r, padding_chunks=[], total_chunks=1)
        for p in pads:
            best, best_dist = None, None
            for (doc_id, num), g in groups.items():
                if doc_id != p.document_id:
                    continue
                d = abs(num - p.chunk_number)
                if best_dist is None or d < best_dist:
                    best, best_dist = g, d
            if best is not None:
                best.padding_chunks.append(p)
                best.total_chunks += 1
        return GroupedChunkResponse(chunks=results, groups=list(groups.values()), total_results=len(results),
                                    has_padding=bool(pads))

    async def retrieve_docs(self, query: str, auth: AuthContext, **kwargs) -> List[DocumentResult]:
        """`retrieve_chunks`, grouped by document: each document's best chunk."""
        results = await self.retrieve_chunks(query, auth, **kwargs)
        chunks = [DocumentChunk(document_id=r.document_id, chunk_number=r.chunk_number, content=r.content,
                                embedding=[], metadata=r.metadata, score=r.score) for r in results]
        return await self._create_document_results(auth, chunks)

    async def batch_retrieve_documents(
        self, document_ids: List[str], auth: AuthContext,
        folder_name: Optional[Union[str, List[str]]] = None, end_user_id: Optional[str] = None,
    ) -> List[Document]:
        system_filters: Dict[str, Any] = {}
        if folder_name is not None:
            system_filters["folder_name"] = folder_name
        if end_user_id:
            system_filters["end_user_id"] = end_user_id
        return await self.db.get_documents_by_id(document_ids, auth, system_filters)

    async def batch_retrieve_chunks(
        self,
        chunk_ids: Sequence[Tuple[str, int]],
        auth: AuthContext,
        use_colpali: Optional[bool] = None,
        output_format: str = "base64",
    ) -> List[ChunkResult]:
        """From the text store unless `use_colpali` is true (and ColPali is served)."""
        _check_ported(output_format)
        allowed = set(await self.db.find_authorized_and_filtered_documents(auth, None, {"status": None}))
        wanted = [(d, n) for d, n in chunk_ids if d in allowed]
        store = self.colpali_vector_store if use_colpali and self.colpali_vector_store is not None else self.vector_store
        chunks = await store.get_chunks_by_id(wanted, app_id=auth.app_id)
        return await self._create_chunk_results(auth, chunks, output_format)

    # ---------------------------------------------------------------- query

    async def query(
        self,
        query: str,
        auth: AuthContext,
        filters: Optional[Dict[str, Any]] = None,
        k: int = 4,
        min_score: float = 0.0,
        max_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        use_reranking: Optional[bool] = None,
        use_colpali: Optional[bool] = None,
        folder_name: Optional[Union[str, List[str]]] = None,
        end_user_id: Optional[str] = None,
        padding: int = 0,
        prompt_overrides: Optional[Dict[str, Any]] = None,
        response_schema: Optional[Dict[str, Any]] = None,
        chat_history: Optional[List[Dict[str, str]]] = None,
        llm_config: Optional[Dict[str, Any]] = None,
        inline_citations: bool = False,
        stream_response: bool = False,
    ):
        if self.completion_model is None:
            raise ValueError("no completion model configured")
        chunks = await self.retrieve_chunks(
            query, auth, filters, k, min_score,
            use_reranking=use_reranking, use_colpali=use_colpali,
            folder_name=folder_name, end_user_id=end_user_id, padding=padding,
        )
        documents = {d.external_id: d for d in await self.db.get_documents_by_id(
            list({c.document_id for c in chunks}), auth
        )}
        doc_results = await self._create_document_results(auth, chunks)
        context = []
        sources = []
        for c in chunks:
            doc = next((d for d in doc_results if d.document_id == c.document_id), None)
            content = c.augmented_content(doc) if doc else c.content
            if inline_citations and not content.startswith("data:image/"):
                page = _page_number(c)
                fn = documents.get(c.document_id)
                label = (fn.filename if fn else c.document_id) + (f" p.{page}" if page else "")
                content = f"[source: {label}]\n{content}"
            context.append(content)
            sources.append(
                {"document_id": c.document_id, "chunk_number": c.chunk_number, "score": c.score,
                 "filename": documents[c.document_id].filename if c.document_id in documents else None,
                 "page_number": _page_number(c)}
            )

        template = (prompt_overrides or {}).get("query", {}).get("prompt_template")
        request = CompletionRequest(
            query=query,
            context_chunks=context,
            max_tokens=max_tokens or self.settings.completion.default_max_tokens,
            temperature=temperature if temperature is not None else self.settings.completion.default_temperature,
            prompt_template=template,
            chat_history=[ChatMessage(**m) for m in chat_history] if chat_history else None,
            response_schema=response_schema,
            llm_config=llm_config,
            inline_citations=inline_citations,
        )
        if stream_response:
            return self.completion_model.complete_stream(request), sources
        response = await self.completion_model.complete(request)
        response.sources = sources
        return response

    # -------------------------------------------------------------- results

    async def _create_chunk_results(
        self, auth: AuthContext, chunks: List[DocumentChunk], output_format: str = "base64"
    ) -> List[ChunkResult]:
        if not chunks:
            return []
        docs = {d.external_id: d for d in await self.db.get_documents_by_id(
            list({c.document_id for c in chunks}), auth
        )}
        out = []
        for c in chunks:
            doc = docs.get(c.document_id)
            content = c.content
            download_url = None
            if c.metadata.get("is_image") and output_format == "url" and not content.startswith("data:"):
                # content is a storage key when skip_image_content was set
                download_url = await self.storage.get_download_url(MULTIVECTOR_CHUNKS_BUCKET, content)
                content = download_url
            out.append(
                ChunkResult(
                    content=content,
                    score=c.score,
                    document_id=c.document_id,
                    chunk_number=c.chunk_number,
                    metadata={**c.metadata, "is_image": bool(c.metadata.get("is_image"))},
                    content_type=doc.content_type if doc else "text/plain",
                    filename=doc.filename if doc else None,
                    download_url=download_url,
                    is_padding=bool(c.metadata.get("is_padding")),
                )
            )
        return out

    async def _create_document_results(self, auth: AuthContext, chunks: List[DocumentChunk]) -> List[DocumentResult]:
        if not chunks:
            return []
        best: Dict[str, DocumentChunk] = {}
        for c in chunks:
            if c.document_id not in best or c.score > best[c.document_id].score:
                best[c.document_id] = c
        docs = {d.external_id: d for d in await self.db.get_documents_by_id(list(best), auth)}
        out = []
        for doc_id, c in best.items():
            doc = docs.get(doc_id)
            if doc is None:
                continue
            if doc.content_type == "text/plain" and not c.metadata.get("is_image"):
                content = DocumentContent(type="string", value=c.content)
            else:
                key = doc.storage_info.get("key")
                bucket = doc.storage_info.get("bucket", "")
                url = await self.storage.get_download_url(bucket, key) if key else ""
                content = DocumentContent(type="url", value=url, filename=doc.filename or "file")
            out.append(DocumentResult(score=c.score, document_id=doc_id, metadata=doc.metadata, content=content,
                                      additional_metadata=doc.additional_metadata))
        return out

    # --------------------------------------------------------------- delete

    async def delete_document(self, document_id: str, auth: AuthContext) -> bool:
        doc = await self.db.get_document(document_id, auth)
        if doc is None:
            return False
        if self.colpali_vector_store is not None:
            await self.colpali_vector_store.delete_chunks_by_document_id(document_id, auth.app_id)
        await self.vector_store.delete_chunks_by_document_id(document_id, auth.app_id)
        key = doc.storage_info.get("key")
        if key:
            try:
                await self.storage.delete_file(doc.storage_info.get("bucket", ""), key)
            except Exception as e:  # noqa: BLE001
                logger.warning("storage delete failed: %s", e)
        return await self.db.delete_document(document_id, auth)

    # ------------------------------------------------------------- summaries

    SUMMARY_MAX_BYTES = 256 * 1024
    SUMMARY_BUCKET = "summaries"

    async def _summary_entity_metadata(self, entity: str, entity_id: str, auth: AuthContext):
        if entity == "document":
            doc = await self.db.get_document(entity_id, auth)
            return None if doc is None else doc.system_metadata
        folder = await self.db.get_folder(entity_id, auth)
        return None if folder is None else folder.get("system_metadata", {})

    async def get_summary(self, entity: str, entity_id: str, auth: AuthContext) -> Optional[Dict[str, Any]]:
        """{content, storage_key, bucket, version, updated_at} of the
        document's (`entity="document"`) or folder's summary; None when
        the entity or its summary is missing."""
        metadata = await self._summary_entity_metadata(entity, entity_id, auth)
        if metadata is None:
            return None
        key = metadata.get("summary_storage_key")
        if not key:
            return None
        try:
            content = (await self.storage.download_file(self.SUMMARY_BUCKET, key)).decode("utf-8")
        except FileNotFoundError:
            return None
        return {"content": content, "storage_key": key, "bucket": self.SUMMARY_BUCKET,
                "version": int(metadata.get("summary_version") or 1), "updated_at": metadata.get("summary_updated_at")}

    async def upsert_summary(self, entity: str, entity_id: str, content: str,
                             auth: AuthContext) -> Optional[Dict[str, Any]]:
        """Store the next version of the summary. Raises ValueError past
        256 KB; None when the entity is missing."""
        data = content.encode("utf-8")
        if len(data) > self.SUMMARY_MAX_BYTES:
            raise ValueError(f"summary exceeds {self.SUMMARY_MAX_BYTES // 1024}KB limit")
        metadata = await self._summary_entity_metadata(entity, entity_id, auth)
        if metadata is None:
            return None
        version = int(metadata.get("summary_version") or 0) + 1
        key = f"{entity}/{entity_id}/v{version}.txt"
        await self.storage.upload_file(data, key, "text/plain", bucket=self.SUMMARY_BUCKET)
        updated_at = datetime.now(timezone.utc).isoformat()
        updates = {"summary_storage_key": key, "summary_version": version, "summary_updated_at": updated_at}
        if entity == "document":
            await self.db.update_document(entity_id, {"system_metadata": updates}, auth)
        else:
            await self.db.update_folder_metadata(entity_id, updates, auth)
        return {"content": content, "storage_key": key, "bucket": self.SUMMARY_BUCKET, "version": version,
                "updated_at": updated_at}
