"""Public data schemas of the service plane: port of the parts of
`morphik_core_tpu/models/schemas.py:28-252` that the ColPali serving
path uses, as plain dataclasses (the card's machine has no pydantic).

Field names, defaults and order are the reference's. `model_dump()`
gives the python form (nested records as dicts) and
`model_dump(mode="json")` the JSON form pydantic gives for the same field
values: datetimes as ISO 8601 strings with `Z` for UTC, sets and tuples
as lists, enums as their values, non-finite floats as null. The
validation the slice relies on is kept: `Document.storage_info` values
are stringified at construction, `AuthContext` coerces its entity type
and permissions, `ChatMessage` checks its role.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import uuid
from dataclasses import dataclass, field
from datetime import UTC, date, datetime
from enum import Enum
from typing import Any, Dict, List, Optional, Union

import numpy as np

Embedding = Union[List[float], List[List[float]], np.ndarray]


def _now() -> datetime:
    return datetime.now(UTC)


def _json_value(v: Any) -> Any:
    if isinstance(v, _Model):
        return v.model_dump(mode="json")
    if isinstance(v, Enum):
        return _json_value(v.value)
    if isinstance(v, datetime):
        s = v.isoformat()
        return s[:-6] + "Z" if s.endswith("+00:00") else s
    if isinstance(v, date):
        return v.isoformat()
    if isinstance(v, dict):
        return {str(_json_value(k)): _json_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_json_value(x) for x in v]
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def _python_value(v: Any) -> Any:
    if isinstance(v, _Model):
        return v.model_dump()
    if isinstance(v, dict):
        return {k: _python_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_python_value(x) for x in v]
    return v


class _Model:
    """`model_dump` for the dataclasses below (pydantic's two modes)."""

    def model_dump(self, mode: str = "python", exclude=()) -> Dict[str, Any]:
        conv = _json_value if mode == "json" else _python_value
        return {f.name: conv(getattr(self, f.name)) for f in dataclasses.fields(self) if f.name not in exclude}


@dataclass
class Chunk(_Model):
    """A parsed piece of content (text or an image data-URI) pre-embedding."""

    content: str
    metadata: Dict[str, Any] = field(default_factory=dict)

    def to_document_chunk(self, document_id: str, chunk_number: int, embedding: Embedding) -> "DocumentChunk":
        return DocumentChunk(
            document_id=document_id,
            content=self.content,
            embedding=embedding,
            chunk_number=chunk_number,
            metadata=self.metadata,
        )


@dataclass
class DocumentChunk(_Model):
    """A chunk as stored in / returned by a vector store."""

    document_id: str
    content: str
    embedding: Embedding
    chunk_number: int
    metadata: Dict[str, Any] = field(default_factory=dict)
    score: float = 0.0


@dataclass(eq=False)
class Document(_Model):
    """A document row in the metadata database."""

    content_type: str
    external_id: str = field(default_factory=lambda: str(uuid.uuid4()))
    filename: Optional[str] = None
    metadata: Dict[str, Any] = field(default_factory=dict)
    metadata_types: Dict[str, str] = field(default_factory=dict)
    storage_info: Dict[str, Any] = field(default_factory=dict)
    system_metadata: Dict[str, Any] = field(
        default_factory=lambda: {"created_at": _now(), "updated_at": _now(), "status": "processing"}
    )
    additional_metadata: Dict[str, Any] = field(default_factory=dict)
    chunk_ids: List[str] = field(default_factory=list)
    folder_name: Optional[str] = None
    folder_path: Optional[str] = None
    folder_id: Optional[str] = None
    end_user_id: Optional[str] = None
    app_id: Optional[str] = None

    def __post_init__(self):
        if isinstance(self.storage_info, dict):  # `schemas.py:87-92`
            self.storage_info = {k: "" if v is None else str(v) for k, v in self.storage_info.items()}

    def model_dump(self, mode: str = "python", exclude=()) -> Dict[str, Any]:
        out = super().model_dump(mode, exclude)  # the reference's field order: external_id first
        return {"external_id": out.pop("external_id"), **out}

    def __hash__(self):
        return hash(self.external_id)

    def __eq__(self, other):
        return isinstance(other, Document) and self.external_id == other.external_id


@dataclass
class DocumentContent(_Model):
    type: str  # "url" | "string"
    value: str
    filename: Optional[str] = None

    def __post_init__(self):
        if self.type not in ("url", "string"):
            raise ValueError(f"DocumentContent.type: {self.type!r} is not 'url' or 'string'")
        if self.type == "url" and self.filename is None:
            raise ValueError("filename is required when type is url")


class TimeSeriesData:
    """time -> content map for videos, with reverse lookup and nearest-time query."""

    def __init__(self, time_to_content: Dict[float, str]):
        self.time_to_content = time_to_content

    @property
    def timestamps(self) -> List[float]:
        return sorted(self.time_to_content.keys())

    @property
    def content_to_times(self) -> Dict[str, List[float]]:
        out: Dict[str, List[float]] = {}
        for t, c in self.time_to_content.items():
            out.setdefault(c, []).append(t)
        return out

    def at_time(self, time: float, padding_seconds: float = 0.0) -> str:
        ts = self.timestamps
        if not ts:
            return ""
        if padding_seconds > 0:
            lo = bisect.bisect_left(ts, time - padding_seconds)
            hi = bisect.bisect_right(ts, time + padding_seconds)
            window = ts[max(0, lo - 1) : hi]
            return " ".join(self.time_to_content[t] for t in window)
        idx = bisect.bisect_right(ts, time) - 1
        return self.time_to_content[ts[max(0, idx)]]


@dataclass
class DocumentResult(_Model):
    score: float
    document_id: str
    metadata: Dict[str, Any]
    content: DocumentContent
    additional_metadata: Dict[str, Any]


@dataclass
class ChunkResult(_Model):
    content: str
    score: float
    document_id: str
    chunk_number: int
    metadata: Dict[str, Any]
    content_type: str
    filename: Optional[str] = None
    download_url: Optional[str] = None
    is_padding: bool = False

    def augmented_content(self, doc: DocumentResult) -> str:
        """Splice video frame description + transcript for timestamped
        chunks (`schemas.py:168-187`)."""
        if "timestamp" not in self.metadata:
            return self.content
        frame_description = doc.additional_metadata.get("frame_description")
        transcript = doc.additional_metadata.get("transcript")
        if not isinstance(frame_description, dict) or not isinstance(transcript, dict):
            return self.content
        ts_frame = TimeSeriesData(frame_description)
        ts_transcript = TimeSeriesData(transcript)
        times = ts_frame.content_to_times.get(self.content, []) + ts_transcript.content_to_times.get(
            self.content, []
        )
        if not times:
            return self.content
        return "\n\n".join(
            f"Frame description: {ts_frame.at_time(t)} \n \n Transcript: {ts_transcript.at_time(t)}"
            for t in times
        )


@dataclass
class ChunkGroup(_Model):
    main_chunk: ChunkResult
    padding_chunks: List[ChunkResult] = field(default_factory=list)
    total_chunks: int = 0

    @property
    def all_chunks(self) -> List[ChunkResult]:
        padding = sorted(self.padding_chunks, key=lambda c: c.chunk_number)
        before = [c for c in padding if c.chunk_number < self.main_chunk.chunk_number]
        after = [c for c in padding if c.chunk_number > self.main_chunk.chunk_number]
        return before + [self.main_chunk] + after


@dataclass
class GroupedChunkResponse(_Model):
    chunks: List[ChunkResult]
    groups: List[ChunkGroup]
    total_results: int = 0
    has_padding: bool = False


class EntityType(str, Enum):
    USER = "user"
    DEVELOPER = "developer"


@dataclass
class AuthContext(_Model):
    """Authenticated request context. `permissions` is a set, and a
    `model_dump(mode="json")` of it round-trips through `AuthContext(**d)`."""

    entity_type: EntityType = EntityType.DEVELOPER
    entity_id: str = ""
    app_id: Optional[str] = None
    permissions: set = field(default_factory=lambda: {"read"})
    user_id: Optional[str] = None
    token_version: Optional[int] = None

    def __post_init__(self):
        self.entity_type = EntityType(self.entity_type)
        self.permissions = set(self.permissions)


@dataclass
class ChatMessage(_Model):
    role: str  # "user" | "assistant" | "system"
    content: str

    def __post_init__(self):
        if self.role not in ("user", "assistant", "system"):
            raise ValueError(f"ChatMessage.role: {self.role!r} is not user, assistant or system")


@dataclass
class CompletionRequest(_Model):
    query: str
    context_chunks: List[str] = field(default_factory=list)
    max_tokens: Optional[int] = None
    temperature: Optional[float] = None
    prompt_template: Optional[str] = None
    chat_history: Optional[List[ChatMessage]] = None
    stream_response: bool = False
    response_schema: Optional[Dict[str, Any]] = None
    llm_config: Optional[Dict[str, Any]] = None
    inline_citations: bool = False


@dataclass
class CompletionResponse(_Model):
    completion: Any
    usage: Dict[str, int] = field(default_factory=dict)
    finish_reason: Optional[str] = None
    sources: List[Dict[str, Any]] = field(default_factory=list)
    metadata: Dict[str, Any] = field(default_factory=dict)
