"""Persistent async job queue: copy of `morphik_core_tpu/workers/job_queue.py`
(same sqlite schema, so a `jobs.db` opens in either package): the
reference's arq+Redis worker pool (reference
core/workers/ingestion_worker.py:1816-1840), rebuilt on stdlib.

Jobs persist in sqlite (survive restarts -> requeue semantics of
POST /ingest/requeue, ref routes/ingest.py:272), execute on asyncio
worker tasks with bounded concurrency (`max_jobs`, default 1 like arq),
a per-job timeout, retries with backoff, and status transitions
queued -> running -> complete|failed that mirror the reference's
document status machine."""

from __future__ import annotations

import asyncio
import json
import logging
import sqlite3
import threading
import time
import traceback
import uuid
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Awaitable, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

JobFn = Callable[..., Awaitable[Any]]

_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
    job_id TEXT PRIMARY KEY,
    function TEXT,
    kwargs TEXT,
    status TEXT DEFAULT 'queued',
    attempts INTEGER DEFAULT 0,
    max_attempts INTEGER DEFAULT 3,
    error TEXT,
    enqueued_at REAL,
    started_at REAL,
    finished_at REAL
);
CREATE INDEX IF NOT EXISTS idx_jobs_status ON jobs(status);
"""


@dataclass
class Job:
    job_id: str
    function: str
    kwargs: Dict[str, Any]
    status: str = "queued"
    attempts: int = 0
    error: Optional[str] = None


class JobQueue:
    def __init__(
        self,
        path: str | Path = ":memory:",
        max_jobs: int = 1,
        job_timeout_s: float = 7200.0,
        retry_delay_s: float = 1.0,
    ):
        self.path = str(path)
        if self.path != ":memory:":
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.RLock()
        self._conn.executescript(_SCHEMA)
        self.max_jobs = max_jobs
        self.job_timeout_s = job_timeout_s
        self.retry_delay_s = retry_delay_s
        self.functions: Dict[str, JobFn] = {}
        self._wake = asyncio.Event()
        self._workers: List[asyncio.Task] = []
        self._stopping = False

    def register(self, name: str, fn: JobFn) -> None:
        self.functions[name] = fn

    # ------------------------------------------------------------- enqueue

    async def enqueue_job(self, function: str, **kwargs: Any) -> str:
        job_id = uuid.uuid4().hex
        with self._lock:
            self._conn.execute(
                "INSERT INTO jobs (job_id, function, kwargs, enqueued_at) VALUES (?,?,?,?)",
                (job_id, function, json.dumps(kwargs, default=str), time.time()),
            )
            self._conn.commit()
        self._wake.set()
        return job_id

    async def requeue(self, job_id: str) -> bool:
        with self._lock:
            cur = self._conn.execute(
                "UPDATE jobs SET status='queued', error=NULL WHERE job_id=? AND status IN ('failed','complete')",
                (job_id,),
            )
            self._conn.commit()
        if cur.rowcount:
            self._wake.set()
        return cur.rowcount > 0

    def get_job(self, job_id: str) -> Optional[Job]:
        with self._lock:
            row = self._conn.execute("SELECT * FROM jobs WHERE job_id=?", (job_id,)).fetchone()
        if row is None:
            return None
        return Job(
            job_id=row["job_id"], function=row["function"], kwargs=json.loads(row["kwargs"]),
            status=row["status"], attempts=row["attempts"], error=row["error"],
        )

    def pending_count(self) -> int:
        with self._lock:
            row = self._conn.execute(
                "SELECT COUNT(*) n FROM jobs WHERE status IN ('queued','running')"
            ).fetchone()
        return int(row["n"])

    # -------------------------------------------------------------- workers

    async def start(self) -> None:
        """Spawn worker tasks; also requeues jobs left 'running' by a
        crash and prunes finished rows (the table is append-only
        otherwise — a year of ingests would mean a year of rows)."""
        with self._lock:
            self._conn.execute("UPDATE jobs SET status='queued' WHERE status='running'")
            self._conn.execute(
                "DELETE FROM jobs WHERE status IN ('complete','failed') AND finished_at < ?",
                (time.time() - 7 * 86400,),
            )
            self._conn.commit()
        self._stopping = False
        for i in range(self.max_jobs):
            self._workers.append(asyncio.create_task(self._worker_loop(i)))

    async def stop(self, grace_s: float = 30.0) -> None:
        """Graceful stop: let in-flight jobs finish (they persist partial
        chunk/index writes — cancelling mid-job leaves status='running'
        rows to crash-requeue on next boot). Workers exit their loop at
        the next iteration; only after `grace_s` are they cancelled."""
        self._stopping = True
        self._wake.set()
        if self._workers:
            done, pending = await asyncio.wait(self._workers, timeout=grace_s)
            for w in pending:
                logger.warning("worker still busy after %.0fs grace; cancelling", grace_s)
                w.cancel()
            await asyncio.gather(*self._workers, return_exceptions=True)
        self._workers.clear()

    async def drain(self, timeout: float = 60.0) -> bool:
        """Wait until queue is empty (tests / shutdown)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.pending_count() == 0:
                return True
            await asyncio.sleep(0.02)
        return False

    def _claim(self) -> Optional[Job]:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM jobs WHERE status='queued' ORDER BY enqueued_at LIMIT 1"
            ).fetchone()
            if row is None:
                return None
            self._conn.execute(
                "UPDATE jobs SET status='running', started_at=?, attempts=attempts+1 WHERE job_id=?",
                (time.time(), row["job_id"]),
            )
            self._conn.commit()
        return Job(
            job_id=row["job_id"], function=row["function"], kwargs=json.loads(row["kwargs"]),
            attempts=row["attempts"] + 1,
        )

    def _finish(self, job_id: str, status: str, error: Optional[str] = None) -> None:
        with self._lock:
            self._conn.execute(
                "UPDATE jobs SET status=?, error=?, finished_at=? WHERE job_id=?",
                (status, error, time.time(), job_id),
            )
            self._conn.commit()

    async def _worker_loop(self, worker_id: int) -> None:
        while not self._stopping:
            job = self._claim()
            if job is None:
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=1.0)
                except asyncio.TimeoutError:
                    pass
                continue
            fn = self.functions.get(job.function)
            if fn is None:
                self._finish(job.job_id, "failed", f"unknown function {job.function}")
                continue
            try:
                await asyncio.wait_for(fn(**job.kwargs), timeout=self.job_timeout_s)
                self._finish(job.job_id, "complete")
            except Exception as e:  # noqa: BLE001
                err = f"{e}\n{traceback.format_exc(limit=5)}"
                logger.error("job %s (%s) attempt %d failed: %s", job.job_id, job.function, job.attempts, e)
                with self._lock:
                    row = self._conn.execute(
                        "SELECT attempts, max_attempts FROM jobs WHERE job_id=?", (job.job_id,)
                    ).fetchone()
                if row and row["attempts"] < row["max_attempts"]:
                    await asyncio.sleep(self.retry_delay_s * (2 ** (job.attempts - 1)))
                    self._finish(job.job_id, "queued", err)
                    self._wake.set()
                else:
                    self._finish(job.job_id, "failed", err)
