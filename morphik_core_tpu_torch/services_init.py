"""Service container of the port: builds the serving stack from
`Settings`. Port of `morphik_core_tpu/services_init.py:62-330` for what
the port serves: the sqlite database, local storage, the parser, the
hashing text embedder and the hybrid text store (`{storage_path}/text_index`),
with `morphik.enable_colpali` the ColPali embedder and its multivector
store (persisted under `vector_store.index_path`), the reranker (the
ColQwen reranker beside the ColPali embedder, else the lexical one), the
stub completion model, telemetry with its log uploader, the job queue,
the app registry (`{storage_path}/user_limits.db`, shared with the JAX
package) and the v2 pipeline with its in-memory chunk store, all on one
device.

Settings that select a part the port does not have yet raise
`NotImplementedError` naming the ROADMAP item, rather than serve another
path. Without a card, `build_services` raises unless the caller passes
`device="cpu"` (as the CPU tests do).
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from morphik_core_tpu_torch.completion.models import BaseCompletionModel, build_completion_model
from morphik_core_tpu_torch.config import Settings, get_settings
from morphik_core_tpu_torch.database.sqlite_database import SQLiteDatabase
from morphik_core_tpu_torch.device import default_device
from morphik_core_tpu_torch.embedding.colpali_embedding_model import ColpaliEmbeddingModel
from morphik_core_tpu_torch.embedding.text_embedding import HashingEmbeddingModel
from morphik_core_tpu_torch.models.schemas import AuthContext, CompletionRequest
from morphik_core_tpu_torch.ops.fde import FDEConfig
from morphik_core_tpu_torch.parser.morphik_parser import MorphikParser
from morphik_core_tpu_torch.reranker.rerankers import ColQwenReranker, build_reranker
from morphik_core_tpu_torch.services.document_service import DocumentService
from morphik_core_tpu_torch.services.ingestion_service import IngestionService
from morphik_core_tpu_torch.services.log_uploader import Heartbeat, LogUploader
from morphik_core_tpu_torch.services.telemetry import TelemetryService
from morphik_core_tpu_torch.services.user_service import UserService
from morphik_core_tpu_torch.services.v2_document_service import V2DocumentService
from morphik_core_tpu_torch.storage.local_storage import LocalStorage
from morphik_core_tpu_torch.vector_store.chunk_v2_store import ChunkV2Store
from morphik_core_tpu_torch.vector_store.text_vector_store import TextVectorStore
from morphik_core_tpu_torch.vector_store.torch_multivector_store import TorchMultiVectorStore
from morphik_core_tpu_torch.workers.job_queue import JobQueue

logger = logging.getLogger(__name__)


def _refuse_unported(settings: Settings) -> None:
    """Raise on each setting whose path the port does not have yet."""
    refusals = (
        (settings.morphik.colpali_mode == "api",
         'morphik.colpali_mode="api" (remote embedding servers, ROADMAP Queue 1 item 3h)'),
        (settings.storage.provider == "aws-s3", 'storage.provider="aws-s3" (ROADMAP Queue 1 item 3h)'),
        (settings.tpu.auto_mesh, "tpu.auto_mesh=true (the multi-GPU paths, ROADMAP Queue 1 item 6)"),
        (settings.morphik.mode == "cloud", 'morphik.mode="cloud" (tier limits, ROADMAP Queue 1 item 3e)'),
        (settings.embedding.model in settings.registered_models,
         f"embedding.model={settings.embedding.model!r} of registered_models: the embedding endpoints "
         "(ROADMAP Queue 1 item 3g)"),
        (settings.parser.ocr_mode != "none",
         f"parser.ocr_mode={settings.parser.ocr_mode!r}: OCR of page images is not ported "
         "(ROADMAP Queue 1 item 3b-ii)"),
        (settings.parser.parser_mode == "api", 'parser.parser_mode="api" (parse endpoints, ROADMAP Queue 1 item 3h)'),
    )
    for refused, what in refusals:
        if refused:
            raise NotImplementedError(f"not ported: {what}")


@dataclass
class Services:
    settings: Settings
    database: SQLiteDatabase
    storage: LocalStorage
    embedding_model: HashingEmbeddingModel
    vector_store: TextVectorStore
    colpali_embedding_model: Optional[ColpaliEmbeddingModel]
    colpali_vector_store: Optional[TorchMultiVectorStore]
    completion_model: BaseCompletionModel
    document_service: DocumentService
    ingestion_service: IngestionService
    telemetry: TelemetryService
    job_queue: JobQueue
    user_service: UserService
    v2_document_service: V2DocumentService
    log_uploader: Optional[LogUploader] = None
    heartbeat: Optional[Heartbeat] = None

    async def initialize(self) -> None:
        await self.database.initialize()
        await self.vector_store.initialize()
        if self.colpali_vector_store is not None:
            await self.colpali_vector_store.initialize()
        self.job_queue.register("process_ingestion_job", self._process_ingestion_job)
        await self.job_queue.start()
        if self.settings.tpu.warmup_on_start and self.colpali_embedding_model is not None:
            await asyncio.to_thread(self.colpali_embedding_model.warmup)
        # background telemetry threads, as the reference starts them: each
        # uploader pass trims the telemetry directory to its budget; no
        # network send unless an endpoint is configured
        tcfg = self.settings.telemetry
        self.log_uploader = LogUploader(tcfg.telemetry_dir, tcfg.upload_url,
                                        interval_s=tcfg.upload_interval_s, budget_bytes=tcfg.local_budget_bytes)
        self.log_uploader.start()
        if tcfg.heartbeat_url:
            self.heartbeat = Heartbeat(tcfg.heartbeat_url, self.settings.storage.storage_path,
                                       self.settings.service.version)
            self.heartbeat.start()

    async def shutdown(self) -> None:
        """Drain the job queue, stop the raster processes and the telemetry
        threads, then write every index (the restart reloads them)."""
        await self.job_queue.stop()
        self.ingestion_service.raster_pool.shutdown()
        for thread in (self.log_uploader, self.heartbeat):
            if thread is not None:
                thread.stop()
                thread.join(timeout=30)
        if self.colpali_vector_store is not None:
            self.colpali_vector_store.save()
        self.vector_store.save()
        self.telemetry.flush()

    async def _process_ingestion_job(self, document_id: str, auth: dict, use_colpali: bool = True):
        ctx = AuthContext(**auth) if isinstance(auth, dict) else auth
        await self.ingestion_service.process_ingestion_job(document_id, ctx, use_colpali)
        self.persist_indexes()

    def persist_indexes(self) -> None:
        """Write each index, as the reference does after each ingest, so
        the rows survive an unclean shutdown: the ColPali index appends
        its rows since the last save (a DELETE is written with the next
        save); the text store rewrites its files."""
        try:
            if self.colpali_vector_store is not None:
                self.colpali_vector_store.save()
            self.vector_store.save()
        except Exception:  # noqa: BLE001
            logger.exception("index persistence failed")


def _colpali_store(settings: Settings, storage: LocalStorage, embedder: ColpaliEmbeddingModel,
                   device: torch.device) -> TorchMultiVectorStore:
    """The multivector store of `vector_store` settings; sets the
    embedder's fused ingest FDE when stored rows are not pooled."""
    vs = settings.vector_store
    fde_cfg = FDEConfig(
        dimension=embedder.embedding_dim,
        num_repetitions=vs.fde_num_repetitions,
        num_simhash_projections=vs.fde_num_simhash_projections,
        projection_dimension=vs.fde_projection_dimension,
        seed=vs.fde_seed,
    )
    # fused ingest FDE: the embedder computes each page's document FDE on
    # the device right after the forward; valid only when stored
    # multivectors are not pooled (pooling rewrites the rows it describes)
    if vs.multivector_pooling <= 1:
        embedder.fde_config = fde_cfg
    return TorchMultiVectorStore(
        storage=storage,
        fde_config=fde_cfg,
        index_path=vs.index_path,
        device=device,
        prefilter_multiplier=vs.prefilter_multiplier,
        prefilter_cap=vs.prefilter_cap,
        pooling_factor=vs.multivector_pooling,
        # None = the kernels; False = their plain versions, as the reference passes it
        use_pallas=None if settings.tpu.use_pallas else False,
        ann_dtype=vs.ann_dtype,
        device_block_rows=vs.device_block_rows,
        compact_dead_fraction=vs.compact_dead_fraction,
        compact_min_rows=vs.compact_min_rows,
        device_cache_slots=vs.device_cache_slots,
        device_cache_token_bucket=vs.device_cache_token_bucket,
        rerank_dtype=vs.rerank_dtype,
        rerank_prefilter_pooling=vs.rerank_prefilter_pooling,
        pooled_tier_factor=vs.pooled_tier_factor,
        pooled_tier_budget_mb=vs.pooled_tier_budget_mb,
        pooled_refine_iters=vs.pooled_refine_iters,
        query_token_dedup=vs.query_token_dedup,
    )


def build_services(
    settings: Optional[Settings] = None,
    *,
    colqwen_model=None,
    device=None,
) -> Services:
    """The stack `settings` describe, on `device` (the card by default).
    `colqwen_model` is served as given (its precisions must be the
    configured ones); without it, the `model.checkpoint_path` directory is
    loaded, or development mode serves the tiny random model."""
    settings = settings or get_settings()
    _refuse_unported(settings)
    device = torch.device(device) if device is not None else default_device()
    storage_root = Path(settings.storage.storage_path)
    database = SQLiteDatabase(settings.database.path)
    storage = LocalStorage(settings.storage.storage_path)
    completion_model = build_completion_model(settings.completion.model)

    async def complete_text(prompt: str) -> str:  # contextual chunking
        return str((await completion_model.complete(CompletionRequest(query=prompt))).completion)

    parser = MorphikParser(settings, complete_fn=complete_text)
    embedding_model = HashingEmbeddingModel(dim=settings.embedding.dimensions)
    embedder = store = None
    if settings.morphik.enable_colpali and settings.morphik.colpali_mode != "off":
        embedder = ColpaliEmbeddingModel.from_settings(settings, colqwen_model, device=device)
        store = _colpali_store(settings, storage, embedder, device)
    vector_store = TextVectorStore(path=storage_root / "text_index", device=device)
    # the text path's reranker: the ColQwen late-interaction scorer on the
    # tower already in process, else the lexical one
    reranker = (ColQwenReranker(embedder, use_kernel=settings.tpu.use_pallas) if embedder is not None
                else build_reranker(None))
    telemetry = TelemetryService(settings.telemetry.telemetry_dir, settings.telemetry.enabled)
    ingestion_service = IngestionService(database, storage, parser, embedding_model, vector_store, embedder, store,
                                         settings)
    document_service = DocumentService(database, storage, embedder, store, completion_model, settings,
                                       embedding_model=embedding_model, vector_store=vector_store, reranker=reranker)
    job_queue = JobQueue(
        path=storage_root / "jobs.db",
        max_jobs=settings.worker.max_jobs,
        job_timeout_s=settings.worker.job_timeout_s,
    )
    v2_document_service = V2DocumentService(database, storage, parser, embedding_model, ChunkV2Store())
    return Services(
        settings=settings,
        database=database,
        storage=storage,
        embedding_model=embedding_model,
        vector_store=vector_store,
        colpali_embedding_model=embedder,
        colpali_vector_store=store,
        completion_model=completion_model,
        document_service=document_service,
        ingestion_service=ingestion_service,
        telemetry=telemetry,
        job_queue=job_queue,
        user_service=UserService(storage_root / "user_limits.db"),
        v2_document_service=v2_document_service,
    )
