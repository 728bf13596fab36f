"""Configuration: `morphik_tpu.toml` -> cached `Settings`. Port of
`morphik_core_tpu/config.py:21-395` with plain dataclasses in place of
pydantic models (the card's machine has no pydantic).

The sections, field names and defaults are the reference's, and so is
the validation this slice relies on: a `Literal` field refuses a value
outside its choices (`ValueError`, where pydantic raises its
`ValidationError`), a section given as a table is validated field by
field, and unknown keys are ignored, as pydantic's default does.
`Settings.from_dict(raw)` stands in for `Settings.model_validate(raw)`.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import tomllib
import typing
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Literal, Optional

DEFAULT_CONFIG_FILENAME = "morphik_tpu.toml"


def _validate(cls, raw: Dict[str, Any]):
    """Build dataclass `cls` from a TOML table: nested sections recurse,
    `Literal` fields are checked, unknown keys are dropped."""
    if not isinstance(raw, dict):
        raise ValueError(f"{cls.__name__}: expected a table, got {type(raw).__name__}")
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in raw:
            continue
        value, hint = raw[f.name], hints[f.name]
        if dataclasses.is_dataclass(hint):
            value = _validate(hint, value)
        elif typing.get_origin(hint) is Literal and value not in typing.get_args(hint):
            raise ValueError(
                f"{cls.__name__}.{f.name}: {value!r} is not one of {list(typing.get_args(hint))}"
            )
        kwargs[f.name] = value
    return cls(**kwargs)


@dataclass
class ApiConfig:
    host: str = "0.0.0.0"
    port: int = 8000


@dataclass
class AuthConfig:
    jwt_algorithm: str = "HS256"
    jwt_secret_key: str = "dev-secret-key"
    bypass_auth_mode: bool = True
    dev_user_id: str = "dev_user"
    dev_entity_type: str = "developer"
    dev_permissions: List[str] = field(default_factory=lambda: ["read", "write", "admin"])
    local_uri_password: Optional[str] = None


@dataclass
class ServiceConfig:
    environment: Literal["development", "staging", "production"] = "development"
    version: str = "0.1.0"
    enable_profiling: bool = False


@dataclass
class TPUConfig:
    """The reference's device knobs. The port reads `embed_batch_size`,
    `use_pallas` and, with `auto_mesh=true` and more than one card, builds
    the serving mesh of `mesh_shape` (`mesh_axis_names` must then be the
    default ["data", "model"]); the rest is kept so that one TOML serves
    both packages."""

    mesh_shape: List[int] = field(default_factory=lambda: [-1, 1])
    mesh_axis_names: List[str] = field(default_factory=lambda: ["data", "model"])
    auto_mesh: bool = False
    compute_dtype: Literal["bfloat16", "float32"] = "bfloat16"
    token_buckets: List[int] = field(default_factory=lambda: [256, 512, 1024, 2048])
    embed_batch_size: int = 8
    maxsim_candidate_tile: int = 128
    maxsim_doc_token_tile: int = 256
    use_pallas: bool = True
    warmup_on_start: bool = False


@dataclass
class ModelConfig:
    name: str = "colqwen2.5-3b"
    checkpoint_path: Optional[str] = None
    embedding_dim: int = 128
    max_query_tokens: int = 64
    matmul_precision: Literal["bf16", "int8"] = "int8"
    attention_precision: Literal["bf16", "int8"] = "bf16"
    static_act_scales: bool = False
    min_pixels: int = 4 * 28 * 28
    max_pixels: int = 768 * 28 * 28


@dataclass
class EmbeddingConfig:
    model: str = "colqwen2.5-3b"
    dimensions: int = 128
    similarity_metric: Literal["cosine", "dotProduct"] = "cosine"


@dataclass
class CompletionConfig:
    model: str = "stub"
    default_max_tokens: int = 1000
    default_temperature: float = 0.3


@dataclass
class ParserConfig:
    chunk_size: int = 6000
    chunk_overlap: int = 300
    use_contextual_chunking: bool = False
    xml_max_tokens: int = 350
    frame_sample_rate: int = 120
    parser_mode: Literal["local", "api"] = "local"
    parse_api_endpoints: List[str] = field(default_factory=list)
    parse_api_key: Optional[str] = None
    ocr_mode: str = "none"
    ocr_api_endpoint: Optional[str] = None
    ocr_api_key: Optional[str] = None
    ocr_tables: bool = True
    transcription_api_base: Optional[str] = None
    transcription_api_key: Optional[str] = None
    transcription_model: str = "whisper-1"


@dataclass
class PdfConfig:
    colpali_pdf_dpi: int = 150
    high_density_threshold_bytes: int = 1_000_000
    high_density_batch_pages: int = 2


@dataclass
class StorageConfig:
    provider: Literal["local", "aws-s3"] = "local"
    storage_path: str = "./storage"
    cache_enabled: bool = True
    cache_path: str = "./storage/cache"
    cache_max_bytes: int = 10 * 1024**3
    bucket_name: str = "morphik-storage"
    region: Optional[str] = None
    endpoint_url: Optional[str] = None
    upload_concurrency: int = 8


@dataclass
class DatabaseConfig:
    provider: Literal["sqlite"] = "sqlite"
    path: str = "./storage/morphik.db"
    max_retries: int = 3
    retry_delay: float = 1.0


@dataclass
class VectorStoreConfig:
    """The index knobs; their meaning is documented at
    `morphik_core_tpu/config.py:176-263`."""

    provider: Literal["tpu", "memory"] = "tpu"
    fde_dimension: int = 128
    fde_num_repetitions: int = 20
    fde_num_simhash_projections: int = 5
    fde_projection_dimension: int = 16
    fde_seed: int = 42
    prefilter_multiplier: int = 30
    prefilter_cap: int = 300
    multivector_pooling: int = 1
    index_path: str = "./storage/index"
    ann_dtype: Literal["int8", "bfloat16", "float32"] = "int8"
    device_block_rows: int = 65536
    compact_dead_fraction: float = 0.25
    compact_min_rows: int = 4096
    device_cache_slots: int = 2048
    device_cache_token_bucket: int = 1024
    rerank_dtype: Literal["bf16", "int8"] = "int8"
    rerank_prefilter_pooling: int = 4
    pooled_tier_factor: int = 32
    pooled_tier_budget_mb: int = 6144
    pooled_refine_iters: int = 3
    query_token_dedup: float = 0.98


@dataclass
class WorkerConfig:
    max_jobs: int = 2
    job_timeout_s: int = 7200
    colpali_store_batch_size: int = 16
    raster_processes: int = 0
    ingest_embed_prefetch: int = 2


@dataclass
class MorphikFlags:
    enable_colpali: bool = True
    colpali_mode: Literal["off", "local", "api"] = "local"
    morphik_embedding_api_endpoints: List[str] = field(default_factory=list)
    morphik_embedding_api_key: Optional[str] = None
    mode: Literal["self_hosted", "cloud"] = "self_hosted"


@dataclass
class TelemetryConfig:
    enabled: bool = True
    telemetry_dir: str = "./logs/telemetry"
    upload_url: Optional[str] = None
    heartbeat_url: Optional[str] = None
    upload_interval_s: float = 4 * 3600
    local_budget_bytes: int = 1024**3


@dataclass
class EEConfig:
    google_client_id: Optional[str] = None
    google_client_secret: Optional[str] = None
    google_redirect_uri: str = "http://localhost:8000/ee/connectors/google_drive/oauth2callback"


@dataclass
class Settings:
    api: ApiConfig = field(default_factory=ApiConfig)
    auth: AuthConfig = field(default_factory=AuthConfig)
    service: ServiceConfig = field(default_factory=ServiceConfig)
    tpu: TPUConfig = field(default_factory=TPUConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    completion: CompletionConfig = field(default_factory=CompletionConfig)
    parser: ParserConfig = field(default_factory=ParserConfig)
    pdf: PdfConfig = field(default_factory=PdfConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    database: DatabaseConfig = field(default_factory=DatabaseConfig)
    vector_store: VectorStoreConfig = field(default_factory=VectorStoreConfig)
    worker: WorkerConfig = field(default_factory=WorkerConfig)
    morphik: MorphikFlags = field(default_factory=MorphikFlags)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    ee: EEConfig = field(default_factory=EEConfig)
    registered_models: Dict[str, Dict[str, Any]] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Settings":
        """Validate a parsed TOML table (the reference's `model_validate`)."""
        return _validate(cls, raw)

    def model_dump(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


_settings_lock = threading.Lock()
_settings: Optional[Settings] = None
_settings_path: Optional[str] = None


def _apply_env_overrides(s: Settings) -> Settings:
    """Secrets come from env vars, never the TOML (`config.py:346-364`)."""
    if os.environ.get("JWT_SECRET_KEY"):
        s.auth.jwt_secret_key = os.environ["JWT_SECRET_KEY"]
    if os.environ.get("LOCAL_URI_PASSWORD"):
        s.auth.local_uri_password = os.environ["LOCAL_URI_PASSWORD"]
    if os.environ.get("MORPHIK_EMBEDDING_API_KEY"):
        s.morphik.morphik_embedding_api_key = os.environ["MORPHIK_EMBEDDING_API_KEY"]
    if os.environ.get("MORPHIK_PARSE_API_KEY"):
        s.parser.parse_api_key = os.environ["MORPHIK_PARSE_API_KEY"]
    if os.environ.get("MORPHIK_OCR_API_KEY"):
        s.parser.ocr_api_key = os.environ["MORPHIK_OCR_API_KEY"]
    if os.environ.get("MORPHIK_TRANSCRIPTION_API_KEY"):
        s.parser.transcription_api_key = os.environ["MORPHIK_TRANSCRIPTION_API_KEY"]
    if os.environ.get("MORPHIK_GOOGLE_CLIENT_SECRET"):
        s.ee.google_client_secret = os.environ["MORPHIK_GOOGLE_CLIENT_SECRET"]
    return s


def load_settings(path: Optional[str | Path] = None) -> Settings:
    """Parse the TOML config at `path` (or defaults if absent)."""
    if path is None:
        env = os.environ.get("MORPHIK_TPU_CONFIG")
        path = env if env else DEFAULT_CONFIG_FILENAME
    p = Path(path)
    if not p.exists():
        return _apply_env_overrides(Settings())
    with open(p, "rb") as f:
        raw = tomllib.load(f)
    return _apply_env_overrides(Settings.from_dict(raw))


def get_settings(path: Optional[str | Path] = None, *, reload: bool = False) -> Settings:
    """Cached settings singleton."""
    global _settings, _settings_path
    with _settings_lock:
        key = str(path) if path is not None else None
        if _settings is None or reload or (key is not None and key != _settings_path):
            _settings = load_settings(path)
            _settings_path = key
        return _settings


def override_settings(settings: Settings) -> None:
    """Inject settings (tests)."""
    global _settings
    with _settings_lock:
        _settings = settings
