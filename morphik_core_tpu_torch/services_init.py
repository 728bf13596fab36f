"""Service container of the port: builds the serving stack from
`Settings`. Port of `morphik_core_tpu/services_init.py:33-330` for what
the port serves: the sqlite database, the storage (local, or S3 behind
the disk cache of `storage.cache_enabled`), the parser (local or remote
parse endpoints, the OCR engine of `parser.ocr_mode`), the text embedder
(a `registered_models` key routed to its endpoint, else the hashing
embedder) and the hybrid text store (`{storage_path}/text_index`), with
`morphik.enable_colpali` the ColPali embedder (the tower in process, or
with `colpali_mode="api"` the remote embedding servers of
`morphik_embedding_api_endpoints`, and no tower) and its multivector
store (persisted under `vector_store.index_path`, on the device in both
modes), the reranker (the ColQwen reranker beside an in-process tower,
else the lexical one), the
completion model of `completion.model` (a provider of `registered_models`
or the stub), the on-the-fly document query, telemetry with its log
uploader, the job queue, the user limits and app registry
(`{storage_path}/user_limits.db`, shared with the JAX package; limits
enforced in `morphik.mode="cloud"`) and the v2 pipeline with its
in-memory chunk store, all on one device.

`tpu.auto_mesh`, the one setting of a part the port does not have yet,
raises `NotImplementedError` naming its ROADMAP item, rather than serve
another path. Without a card, `build_services` raises unless the caller passes
`device="cpu"` (as the CPU tests do).
"""

from __future__ import annotations

import asyncio
import logging
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

import torch

from morphik_core_tpu_torch.completion.models import BaseCompletionModel, build_completion_model
from morphik_core_tpu_torch.config import Settings, get_settings
from morphik_core_tpu_torch.database.sqlite_database import SQLiteDatabase
from morphik_core_tpu_torch.device import default_device
from morphik_core_tpu_torch.embedding.colpali_api_embedding_model import ColpaliApiEmbeddingModel
from morphik_core_tpu_torch.embedding.colpali_embedding_model import ColpaliEmbeddingModel
from morphik_core_tpu_torch.embedding.base_embedding_model import BaseEmbeddingModel
from morphik_core_tpu_torch.embedding.text_embedding import HashingEmbeddingModel, RoutedEmbeddingModel
from morphik_core_tpu_torch.models.schemas import AuthContext, CompletionRequest
from morphik_core_tpu_torch.ops.fde import FDEConfig
from morphik_core_tpu_torch.parser.morphik_parser import MorphikParser
from morphik_core_tpu_torch.reranker.rerankers import ColQwenReranker, build_reranker
from morphik_core_tpu_torch.services.document_service import DocumentService
from morphik_core_tpu_torch.services.ingestion_service import IngestionService
from morphik_core_tpu_torch.services.log_uploader import Heartbeat, LogUploader
from morphik_core_tpu_torch.services.on_the_fly import OnTheFlyService
from morphik_core_tpu_torch.services.telemetry import TelemetryService
from morphik_core_tpu_torch.services.user_service import UserService
from morphik_core_tpu_torch.services.v2_document_service import V2DocumentService
from morphik_core_tpu_torch.storage.base_storage import BaseStorage
from morphik_core_tpu_torch.storage.cache_manager import CachedStorage, FileCacheManager
from morphik_core_tpu_torch.storage.local_storage import LocalStorage
from morphik_core_tpu_torch.storage.s3_storage import S3Storage
from morphik_core_tpu_torch.vector_store.chunk_v2_store import ChunkV2Store
from morphik_core_tpu_torch.vector_store.text_vector_store import TextVectorStore
from morphik_core_tpu_torch.vector_store.torch_multivector_store import TorchMultiVectorStore
from morphik_core_tpu_torch.workers.job_queue import JobQueue

logger = logging.getLogger(__name__)


def _refuse_unported(settings: Settings) -> None:
    """Raise on a setting whose path the port does not have yet."""
    if settings.tpu.auto_mesh:
        raise NotImplementedError("not ported: tpu.auto_mesh=true (the multi-GPU paths, ROADMAP Queue 1 item 6)")


def build_storage(settings: Settings) -> BaseStorage:
    """`storage.provider`: the local filesystem, or S3 (boto3 imported
    here; without it the reference's RuntimeError), behind the disk LRU
    cache when `storage.cache_enabled` is set."""
    st = settings.storage
    if st.provider != "aws-s3":
        return LocalStorage(st.storage_path)
    s3 = S3Storage(
        default_bucket=st.bucket_name,
        region_name=st.region,
        endpoint_url=st.endpoint_url,
        aws_access_key_id=os.environ.get("AWS_ACCESS_KEY_ID"),
        aws_secret_access_key=os.environ.get("AWS_SECRET_ACCESS_KEY"),
        upload_concurrency=st.upload_concurrency,
    )
    if st.cache_enabled:
        return CachedStorage(s3, FileCacheManager(st.cache_path, st.cache_max_bytes))
    return s3


@dataclass
class Services:
    settings: Settings
    database: SQLiteDatabase
    storage: BaseStorage
    embedding_model: BaseEmbeddingModel
    vector_store: TextVectorStore
    colpali_embedding_model: Optional[Union[ColpaliEmbeddingModel, ColpaliApiEmbeddingModel]]
    colpali_vector_store: Optional[TorchMultiVectorStore]
    completion_model: BaseCompletionModel
    document_service: DocumentService
    ingestion_service: IngestionService
    telemetry: TelemetryService
    job_queue: JobQueue
    user_service: UserService
    v2_document_service: V2DocumentService
    on_the_fly: OnTheFlyService
    log_uploader: Optional[LogUploader] = None
    heartbeat: Optional[Heartbeat] = None

    async def initialize(self) -> None:
        await self.database.initialize()
        await self.vector_store.initialize()
        if self.colpali_vector_store is not None:
            await self.colpali_vector_store.initialize()
        self.job_queue.register("process_ingestion_job", self._process_ingestion_job)
        await self.job_queue.start()
        if self.settings.tpu.warmup_on_start and hasattr(self.colpali_embedding_model, "warmup"):
            await asyncio.to_thread(self.colpali_embedding_model.warmup)  # a remote embedder has none
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
        threads, then write every index (the restart reloads them) and
        release the ColPali store's namespace locks."""
        await self.job_queue.stop()
        self.ingestion_service.raster_pool.shutdown()
        for thread in (self.log_uploader, self.heartbeat):
            if thread is not None:
                thread.stop()
                thread.join(timeout=30)
        if self.colpali_vector_store is not None:
            self.colpali_vector_store.save()
            if hasattr(self.colpali_vector_store, "close"):
                self.colpali_vector_store.close()
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


def _colpali_store(settings: Settings, storage: BaseStorage,
                   embedder: Union[ColpaliEmbeddingModel, ColpaliApiEmbeddingModel],
                   device: torch.device) -> TorchMultiVectorStore:
    """The multivector store of `vector_store` settings; sets an
    in-process embedder's fused ingest FDE when stored rows are not
    pooled (a remote embedder's rows get their FDE when stored)."""
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
    if settings.morphik.colpali_mode == "local" and vs.multivector_pooling <= 1:
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
    loaded, or development mode serves the tiny random model. With
    `colpali_mode="api"` no model is loaded: pages and queries are
    embedded by the endpoints (at least one, else the reference's
    ValueError), authenticated by `morphik.morphik_embedding_api_key`."""
    settings = settings or get_settings()
    _refuse_unported(settings)
    device = torch.device(device) if device is not None else default_device()
    storage_root = Path(settings.storage.storage_path)
    database = SQLiteDatabase(settings.database.path)
    storage = build_storage(settings)
    completion_model = build_completion_model(settings.registered_models, settings.completion.model,
                                              environment=settings.service.environment)

    async def complete_text(prompt: str) -> str:  # contextual chunking
        return str((await completion_model.complete(CompletionRequest(query=prompt))).completion)

    parser = MorphikParser(settings, complete_fn=complete_text)
    # the text path's embedder: a registered_models key routes to its
    # endpoint; otherwise the offline hashing embedder
    if settings.embedding.model in settings.registered_models:
        embedding_model: BaseEmbeddingModel = RoutedEmbeddingModel(settings.embedding.model, settings)
    else:
        embedding_model = HashingEmbeddingModel(dim=settings.embedding.dimensions)
    embedder = store = None
    if settings.morphik.enable_colpali and settings.morphik.colpali_mode != "off":
        if settings.morphik.colpali_mode == "api":
            # the reference passes no auth_token, so its API node gets 401 from a
            # keyed endpoint (ROADMAP Queue 3): the port sends the key
            embedder = ColpaliApiEmbeddingModel(settings.morphik.morphik_embedding_api_endpoints,
                                                embedding_dim=settings.model.embedding_dim,
                                                auth_token=settings.morphik.morphik_embedding_api_key)
        else:
            embedder = ColpaliEmbeddingModel.from_settings(settings, colqwen_model, device=device)
        store = _colpali_store(settings, storage, embedder, device)
    vector_store = TextVectorStore(path=storage_root / "text_index", device=device)
    # the text path's reranker: the ColQwen late-interaction scorer on the
    # tower already in process, else the lexical one
    reranker = (ColQwenReranker(embedder, use_kernel=settings.tpu.use_pallas)
                if isinstance(embedder, ColpaliEmbeddingModel) else build_reranker(None))
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
        user_service=UserService(storage_root / "user_limits.db", enforce=settings.morphik.mode == "cloud"),
        v2_document_service=v2_document_service,
        on_the_fly=OnTheFlyService(parser, completion_model),
    )
