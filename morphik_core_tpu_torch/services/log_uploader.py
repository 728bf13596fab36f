"""Telemetry log uploader and installation heartbeat threads: copy of
`morphik_core_tpu/services/log_uploader.py` (stdlib only).

Both send nothing unless an endpoint is configured
(`telemetry.upload_url` / `telemetry.heartbeat_url`). The local budget
(trim the telemetry directory, oldest files first) runs on every pass
of the uploader regardless, since it protects the local disk."""

from __future__ import annotations

import contextlib
import hashlib
import hmac
import json
import logging
import threading
import time
import urllib.request
import uuid
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

DEFAULT_LOCAL_BUDGET_BYTES = 1 * 1024**3  # reference: 1 GiB local cap


def enforce_local_budget(telemetry_dir: str | Path, budget_bytes: int = DEFAULT_LOCAL_BUDGET_BYTES) -> int:
    """Delete the oldest telemetry files until the directory fits the
    budget. Returns the bytes freed."""
    d = Path(telemetry_dir)
    if not d.exists():
        return 0
    files = sorted((p for p in d.glob("*.jsonl") if p.is_file()), key=lambda p: p.stat().st_mtime)
    total = sum(p.stat().st_size for p in files)
    freed = 0
    while total > budget_bytes and files:
        victim = files.pop(0)
        size = victim.stat().st_size
        victim.unlink(missing_ok=True)
        total -= size
        freed += size
        logger.info("telemetry budget: dropped %s (%d B)", victim.name, size)
    return freed


def _installation_id(state_dir: str | Path) -> str:
    p = Path(state_dir) / "installation_id"
    if p.exists():
        return p.read_text().strip()
    p.parent.mkdir(parents=True, exist_ok=True)
    iid = uuid.uuid4().hex
    p.write_text(iid)
    return iid


class LogUploader(threading.Thread):
    """Every `interval_s`: trims the telemetry directory to its budget,
    then, with an `upload_url`, POSTs the span files with an HMAC
    signature and removes what was sent."""

    def __init__(
        self,
        telemetry_dir: str | Path,
        upload_url: Optional[str] = None,
        signing_key: str = "morphik",
        interval_s: float = 4 * 3600,
        budget_bytes: int = DEFAULT_LOCAL_BUDGET_BYTES,
    ):
        super().__init__(daemon=True, name="log-uploader")
        self.telemetry_dir = Path(telemetry_dir)
        self.upload_url = upload_url
        self.signing_key = signing_key
        self.interval_s = interval_s
        self.budget_bytes = budget_bytes
        # not `_stop`: `threading.Thread` has a `_stop` method that `join` calls
        self._halt = threading.Event()

    def stop(self) -> None:
        self._halt.set()

    def upload_once(self) -> bool:
        enforce_local_budget(self.telemetry_dir, self.budget_bytes)
        if not self.upload_url:
            return False
        files = sorted(self.telemetry_dir.glob("spans_*.jsonl"))
        if not files:
            return False
        # snapshot each file's read extent: spans appended between the
        # read and the cleanup must survive to the next pass
        snaps = [(p, p.read_bytes()) for p in files]
        payload = b"\n".join(data for _, data in snaps)
        sig = hmac.new(self.signing_key.encode(), payload, hashlib.sha256).hexdigest()
        req = urllib.request.Request(
            self.upload_url,
            data=payload,
            headers={"Content-Type": "application/x-ndjson", "X-Telemetry-Signature": sig},
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                ok = 200 <= resp.status < 300
        except Exception as e:  # noqa: BLE001
            logger.warning("telemetry upload failed: %s", e)
            return False
        if ok:
            # hold the telemetry writer's lock, so no span is appended
            # between the size check and the unlink or replace
            from morphik_core_tpu_torch.services.telemetry import TelemetryService

            svc = TelemetryService._instance
            lock = svc._file_lock if svc is not None else contextlib.nullcontext()
            with lock:
                for p, data in snaps:
                    try:
                        size_now = p.stat().st_size
                    except OSError:
                        continue
                    if size_now <= len(data):
                        p.unlink(missing_ok=True)
                    else:  # the live day-file grew after the read: keep the tail
                        with open(p, "rb") as fh:
                            fh.seek(len(data))
                            tail = fh.read()
                        tmp = p.with_suffix(".tmp")
                        tmp.write_bytes(tail)
                        tmp.replace(p)
        return ok

    def run(self) -> None:
        while not self._halt.wait(self.interval_s):
            try:
                self.upload_once()
            except Exception:  # noqa: BLE001
                logger.exception("log uploader cycle failed")


class Heartbeat(threading.Thread):
    """Periodic installation ping."""

    def __init__(self, heartbeat_url: Optional[str], state_dir: str | Path, version: str, interval_s: float = 3600):
        super().__init__(daemon=True, name="heartbeat")
        self.heartbeat_url = heartbeat_url
        self.installation_id = _installation_id(state_dir)
        self.version = version
        self.interval_s = interval_s
        self._halt = threading.Event()

    def stop(self) -> None:
        self._halt.set()

    def ping_once(self) -> bool:
        if not self.heartbeat_url:
            return False
        body = json.dumps({"installation_id": self.installation_id, "version": self.version, "ts": time.time()}).encode()
        req = urllib.request.Request(self.heartbeat_url, data=body, headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                return 200 <= resp.status < 300
        except Exception as e:  # noqa: BLE001
            logger.debug("heartbeat failed: %s", e)
            return False

    def run(self) -> None:
        self.ping_once()
        while not self._halt.wait(self.interval_s):
            self.ping_once()
