"""Telemetry: JSONL span export + phase timers. Copy of
`morphik_core_tpu/services/telemetry.py` (`PerformanceTracker`,
`TelemetryService`: `track_operation`, `flush`; `TelemetryEventReader`
for `GET /logs`), as the routes use them.

Hand-rolled equivalent of the reference's OpenTelemetry +
PerformanceTracker setup: spans written as JSONL under logs/telemetry/,
a `track_operation` async context manager per operation, and a
PerformanceTracker for phase timing that services thread through
retrieve/query."""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from contextlib import asynccontextmanager
from datetime import UTC, datetime
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class PerformanceTracker:
    """Phase timing for one request (reference api.py:93-147)."""

    def __init__(self, operation: str = ""):
        self.operation = operation
        self.start = time.perf_counter()
        self.phases: Dict[str, float] = {}
        self._phase_start: Optional[float] = None
        self._phase_name: Optional[str] = None

    def start_phase(self, name: str) -> None:
        self.end_phase()
        self._phase_name, self._phase_start = name, time.perf_counter()

    def end_phase(self) -> None:
        if self._phase_name is not None and self._phase_start is not None:
            self.phases[self._phase_name] = self.phases.get(self._phase_name, 0.0) + (
                time.perf_counter() - self._phase_start
            )
        self._phase_name = self._phase_start = None

    def summary(self) -> Dict[str, Any]:
        self.end_phase()
        return {
            "operation": self.operation,
            "total_s": time.perf_counter() - self.start,
            "phases": dict(self.phases),
        }

    def log_summary(self, log: logging.Logger = logger) -> None:
        s = self.summary()
        phases = " ".join(f"{k}={v*1e3:.1f}ms" for k, v in s["phases"].items())
        log.info("perf %s total=%.1fms %s", s["operation"], s["total_s"] * 1e3, phases)


class TelemetryService:
    """Process-wide singleton writing spans to JSONL."""

    _instance: Optional["TelemetryService"] = None
    _lock = threading.Lock()

    def __new__(cls, *a, **kw):
        with cls._lock:
            if cls._instance is None:
                cls._instance = super().__new__(cls)
                cls._instance._initialized = False
            return cls._instance

    def __init__(self, telemetry_dir: str | Path = "./logs/telemetry", enabled: bool = True):
        if self._initialized:
            return
        self.enabled = enabled
        self.dir = Path(telemetry_dir)
        self._file_lock = threading.Lock()
        self._buffer: List[Dict[str, Any]] = []
        self._initialized = True

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._instance = None

    def record_span(self, span: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        with self._file_lock:
            self._buffer.append(span)
            if len(self._buffer) >= 20:
                self._flush_locked()

    def flush(self) -> None:
        with self._file_lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._buffer:
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        fname = self.dir / f"spans_{datetime.now(UTC):%Y%m%d}.jsonl"
        with open(fname, "a") as f:
            for span in self._buffer:
                f.write(json.dumps(span, default=str) + "\n")
        self._buffer.clear()

    @asynccontextmanager
    async def track_operation(
        self,
        operation_type: str,
        user_id: Optional[str] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ):
        span: Dict[str, Any] = {
            "span_id": uuid.uuid4().hex,
            "operation": operation_type,
            "user_id": user_id,
            "start": datetime.now(UTC).isoformat(),
            "metadata": metadata or {},
            "status": "ok",
        }
        t0 = time.perf_counter()
        try:
            yield span
        except Exception as e:
            span["status"] = "error"
            span["error"] = str(e)
            raise
        finally:
            span["duration_s"] = time.perf_counter() - t0
            self.record_span(span)


class TelemetryEventReader:
    """Recent spans of the local JSONL files, newest first, filtered by
    operation type, status, user and start time (`GET /logs`)."""

    def __init__(self, log_dir: str | Path = "./logs/telemetry"):
        self.log_dir = Path(log_dir)

    def query(
        self,
        since: Optional[datetime] = None,
        operation_type: Optional[str] = None,
        status: Optional[str] = None,
        user_id: Optional[str] = None,
        limit: int = 100,
    ) -> List[Dict[str, Any]]:
        if not self.log_dir.exists():
            return []
        events: List[Dict[str, Any]] = []
        for path in sorted(self.log_dir.glob("spans_*.jsonl"), reverse=True):
            try:
                lines = path.read_text().splitlines()
            except OSError:
                continue
            for line in reversed(lines):
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if operation_type and ev.get("operation") != operation_type:
                    continue
                if status and ev.get("status") != status:
                    continue
                if user_id and ev.get("user_id") != user_id:
                    continue
                if since is not None:
                    try:
                        ts = datetime.fromisoformat(ev.get("start", ""))
                    except ValueError:
                        continue
                    if ts < since:
                        continue
                events.append(ev)
                if len(events) >= limit:
                    return events
        return events
