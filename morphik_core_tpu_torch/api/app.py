"""HTTP routes of the port's service plane: the ingest, retrieve and
document routes of `morphik_core_tpu/api/app.py` (`:76-397`) with the
reference's request and response bodies.

Routes: `/ping`, `/health`, `/ingest/text`, `/ingest/file`,
`/ingest/files`, `/documents/{id}` (GET, DELETE),
`/documents/{id}/status`, `/retrieve/chunks`, `/retrieve/chunks/grouped`,
`/batch/chunks` and `/query` (JSON, or SSE with `stream_response`).
`use_colpali=false` takes the text path: text chunks and the hybrid text
store, with `use_reranking`. An upload the port cannot ingest yet
answers 415 (`services/ingestion_service.py::check_upload`); an option
it does not serve yet, 501 (the router maps `NotImplementedError`).
`/health` reports the torch device in place of the JAX backend, and the
text store's rows per namespace (`text_index_rows`, a key of the port).

Not ported yet (ROADMAP Queue 1): the profiler route (item 3c), the
other route groups (item 3d: folders, models, apps with their token
revocation, chats, logs, migrate, v2, connectors, ...), user limits
(item 3e).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any, AsyncIterator, Dict, List

import torch

from morphik_core_tpu_torch import __version__
from morphik_core_tpu_torch.api.auth import verify_token
from morphik_core_tpu_torch.api.http import HTTPError, Request, Response, Router
from morphik_core_tpu_torch.models.schemas import AuthContext
from morphik_core_tpu_torch.services.ingestion_service import UnsupportedContentType
from morphik_core_tpu_torch.services_init import Services

logger = logging.getLogger(__name__)


def _backend(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def _colpali_health(store) -> Dict[str, Any]:
    """The ColPali store's `/health` component: device, rows and device-cache tiers."""
    colpali: Dict[str, Any] = {"enabled": True, "backend": _backend(store.device)}
    colpali["index_rows"] = {ns: len(ix) for ns, ix in store._indexes.items()}

    def _tier(pc):
        total = pc.hits + pc.misses
        return {"hits": pc.hits, "misses": pc.misses, "hit_rate": round(pc.hits / total, 3) if total else 0.0,
                "resident": len(pc._row_to_slot), "slots": pc.slots}

    cache_stats: Dict[str, Any] = {}
    for ns, ix in store._indexes.items():
        if ix._pool_cache is not None:
            cache_stats[ns] = _tier(ix._pool_cache)
        if ix._pooled_cache is not None:
            cache_stats.setdefault(ns, {})["pooled_tier"] = _tier(ix._pooled_cache)
    if cache_stats:
        colpali["device_cache"] = cache_stats
    return colpali


def build_app(services: Services) -> Router:
    router = Router()
    settings = services.settings
    telemetry = services.telemetry

    async def auth_of(req: Request) -> AuthContext:
        return verify_token(req, settings)

    def _require_write(auth: AuthContext) -> None:
        if "write" not in auth.permissions and "admin" not in auth.permissions:
            raise HTTPError(403, "write permission required")

    # ------------------------------------------------------------- health

    @router.get("/ping")
    async def ping(req: Request) -> Response:
        return Response.json({"status": "ok"})

    @router.get("/health")
    async def health(req: Request) -> Response:
        """Component health; unauthenticated callers get liveness only."""
        try:
            await auth_of(req)
        except HTTPError:
            return Response.json({"status": "healthy", "version": __version__})
        components: Dict[str, Any] = {}
        try:
            await services.database.get_documents(AuthContext(entity_id="__health__", permissions={"read"}), 0, 1)
            components["database"] = "ok"
        except Exception as e:  # noqa: BLE001
            components["database"] = f"error: {e}"
        try:
            await services.storage.get_object_size("", "__health_probe__")
            components["storage"] = "ok"
        except Exception as e:  # noqa: BLE001
            components["storage"] = f"error: {e}"
        store = services.colpali_vector_store
        if store is not None:
            components["colpali"] = _colpali_health(store)
        else:
            components["colpali"] = {"enabled": False}
        components["text_index_rows"] = {ns: n.n_alive() for ns, n in services.vector_store._ns_map.items()}
        ok = all(v == "ok" for v in components.values() if isinstance(v, str))
        return Response.json({
            "status": "healthy" if ok else "degraded",
            "version": __version__,
            "pending_jobs": services.job_queue.pending_count(),
            "colpali": store is not None,
            "components": components,
        })

    # ------------------------------------------------------------- ingest

    @router.post("/ingest/text")
    async def ingest_text(req: Request) -> Response:
        auth = await auth_of(req)
        _require_write(auth)
        body = req.json()
        if "content" not in body:
            raise HTTPError(422, "content is required")
        async with telemetry.track_operation("ingest_text", auth.entity_id):
            doc = await services.ingestion_service.ingest_text(
                content=body["content"],
                filename=body.get("filename"),
                metadata=body.get("metadata") or {},
                auth=auth,
                folder_name=body.get("folder_name"),
                end_user_id=body.get("end_user_id"),
                use_colpali=body.get("use_colpali", True),
                metadata_types=body.get("metadata_types"),
            )
        services.persist_indexes()
        return Response.json(doc.model_dump(mode="json"))

    async def _ingest_one_file(auth: AuthContext, upload, fields) -> Dict[str, Any]:
        metadata = json.loads(fields.get("metadata", "{}") or "{}")
        metadata_types = json.loads(fields.get("metadata_types", "{}") or "{}")
        use_colpali = (fields.get("use_colpali", "true") or "true").lower() != "false"
        doc = await services.ingestion_service.ingest_file_content(
            upload.data,
            upload.filename,
            metadata,
            auth,
            content_type=upload.content_type,
            folder_name=fields.get("folder_name"),
            end_user_id=fields.get("end_user_id"),
            use_colpali=use_colpali,
            metadata_types=metadata_types,
        )
        await services.job_queue.enqueue_job(
            "process_ingestion_job",
            document_id=doc.external_id,
            auth=auth.model_dump(mode="json"),
            use_colpali=use_colpali,
        )
        return doc.model_dump(mode="json")

    @router.post("/ingest/file")
    async def ingest_file(req: Request) -> Response:
        auth = await auth_of(req)
        _require_write(auth)
        fields, files = req.form()
        uploads = files.get("file") or []
        if not uploads:
            raise HTTPError(422, "file is required")
        try:
            async with telemetry.track_operation("ingest_file", auth.entity_id):
                doc = await _ingest_one_file(auth, uploads[0], fields)
        except UnsupportedContentType as e:
            raise HTTPError(415, str(e))
        return Response.json(doc)

    @router.post("/ingest/files")
    async def ingest_files(req: Request) -> Response:
        auth = await auth_of(req)
        _require_write(auth)
        fields, files = req.form()
        uploads = files.get("files") or files.get("file") or []
        if not uploads:
            raise HTTPError(422, "files are required")
        out, errors = [], []
        async with telemetry.track_operation("ingest_files", auth.entity_id):
            for up in uploads:
                try:
                    out.append(await _ingest_one_file(auth, up, fields))
                except Exception as e:  # noqa: BLE001
                    errors.append({"filename": up.filename, "error": str(e)})
        return Response.json({"documents": out, "errors": errors})

    # ----------------------------------------------------------- retrieve

    def _retrieve_kwargs(body: Dict[str, Any]) -> Dict[str, Any]:
        return dict(
            filters=body.get("filters"),
            k=body.get("k", 4),
            min_score=body.get("min_score", 0.0),
            use_reranking=body.get("use_reranking"),
            use_colpali=body.get("use_colpali"),
            folder_name=body.get("folder_name"),
            folder_depth=body.get("folder_depth"),
            end_user_id=body.get("end_user_id"),
            padding=body.get("padding", 0),
            output_format=body.get("output_format", "base64"),
            query_image=body.get("query_image"),
        )

    @router.post("/retrieve/chunks")
    async def retrieve_chunks(req: Request) -> Response:
        auth = await auth_of(req)
        body = req.json()
        try:
            async with telemetry.track_operation("retrieve_chunks", auth.entity_id):
                results = await services.document_service.retrieve_chunks(
                    body.get("query", ""), auth, **_retrieve_kwargs(body)
                )
        except ValueError as e:  # e.g. an oversized or undecodable query_image
            raise HTTPError(400, str(e))
        return Response.json([r.model_dump(mode="json") for r in results])

    @router.post("/retrieve/chunks/grouped")
    async def retrieve_chunks_grouped(req: Request) -> Response:
        auth = await auth_of(req)
        body = req.json()
        async with telemetry.track_operation("retrieve_chunks_grouped", auth.entity_id):
            grouped = await services.document_service.retrieve_chunks_grouped(
                body.get("query", ""), auth, **_retrieve_kwargs(body)
            )
        return Response.json(grouped.model_dump(mode="json"))

    @router.post("/batch/chunks")
    async def batch_chunks(req: Request) -> Response:
        auth = await auth_of(req)
        body = req.json()
        ids = [(s["document_id"], s["chunk_number"]) for s in body.get("sources", [])]
        results = await services.document_service.batch_retrieve_chunks(
            ids, auth, use_colpali=body.get("use_colpali"), output_format=body.get("output_format", "base64"),
        )
        return Response.json([r.model_dump(mode="json") for r in results])

    # -------------------------------------------------------------- query

    @router.post("/query")
    async def query(req: Request) -> Response:
        auth = await auth_of(req)
        body = req.json()
        q = body.get("query", "")
        chat_id = body.get("chat_id")
        history: List[Dict[str, str]] = []
        if chat_id:
            history = await services.database.get_chat_history(chat_id, auth.user_id, auth.app_id) or []
        kwargs = dict(
            filters=body.get("filters"),
            k=body.get("k", 4),
            min_score=body.get("min_score", 0.0),
            max_tokens=body.get("max_tokens"),
            temperature=body.get("temperature"),
            use_reranking=body.get("use_reranking"),
            use_colpali=body.get("use_colpali"),
            folder_name=body.get("folder_name"),
            end_user_id=body.get("end_user_id"),
            padding=body.get("padding", 0),
            prompt_overrides=body.get("prompt_overrides"),
            response_schema=body.get("response_schema") or body.get("schema"),
            chat_history=[{"role": m["role"], "content": m["content"]} for m in history],
            llm_config=body.get("llm_config"),
            inline_citations=body.get("inline_citations", False),
        )

        async def persist_history(answer: str) -> None:
            if not chat_id:
                return
            new_history = history + [
                {"role": "user", "content": q, "timestamp": time.time()},
                {"role": "assistant", "content": answer, "timestamp": time.time()},
            ]
            await services.database.upsert_chat_history(chat_id, auth.user_id, auth.app_id, new_history)

        if body.get("stream_response"):
            stream, sources = await services.document_service.query(q, auth, stream_response=True, **kwargs)

            async def events() -> AsyncIterator[str]:
                collected = []
                try:
                    async for tok in stream:
                        collected.append(tok)
                        yield f"data: {json.dumps({'type': 'assistant', 'content': tok})}\n\n"
                    yield f"data: {json.dumps({'type': 'sources', 'sources': sources})}\n\n"
                    yield "data: [DONE]\n\n"
                finally:
                    # a client disconnect mid-stream still records the exchange
                    if collected:
                        await persist_history("".join(collected))

            return Response.sse(events())

        async with telemetry.track_operation("query", auth.entity_id):
            resp = await services.document_service.query(q, auth, **kwargs)
        await persist_history(resp.completion if isinstance(resp.completion, str) else json.dumps(resp.completion))
        return Response.json(resp.model_dump(mode="json"))

    # ----------------------------------------------------------- documents

    @router.get("/documents/{document_id}")
    async def get_document(req: Request) -> Response:
        auth = await auth_of(req)
        doc = await services.database.get_document(req.path_params["document_id"], auth)
        if doc is None:
            raise HTTPError(404, "document not found")
        return Response.json(doc.model_dump(mode="json"))

    @router.get("/documents/{document_id}/status")
    async def document_status(req: Request) -> Response:
        auth = await auth_of(req)
        doc = await services.database.get_document(req.path_params["document_id"], auth)
        if doc is None:
            raise HTTPError(404, "document not found")
        sm = doc.system_metadata
        return Response.json({
            "document_id": doc.external_id,
            "status": sm.get("status", "unknown"),
            "filename": doc.filename,
            "error": sm.get("error"),
            "updated_at": sm.get("updated_at"),
        })

    @router.delete("/documents/{document_id}")
    async def delete_document(req: Request) -> Response:
        auth = await auth_of(req)
        _require_write(auth)
        ok = await services.document_service.delete_document(req.path_params["document_id"], auth)
        if not ok:
            raise HTTPError(404, "document not found")
        return Response.json({"status": "deleted", "document_id": req.path_params["document_id"]})

    return router
