"""Per-request CPU profiling: copy of `morphik_core_tpu/api/middleware.py`.
With `service.enable_profiling`, every request runs under cProfile (the
stdlib; the stats read in snakeviz/pstats) and its profile is written as
`profile_{METHOD}_{path slug}_{ms}.prof` in `profile_dir`."""

from __future__ import annotations

import cProfile
import logging
import re
import time
from pathlib import Path

logger = logging.getLogger(__name__)


def make_profiling_wrapper(profile_dir: str | Path = "./logs"):
    out_dir = Path(profile_dir)
    # CPython allows one active profiler per interpreter (a second enable()
    # raises ValueError): a request that overlaps a profiled one is not profiled
    state = {"active": False}

    async def profile_request(req, call_next):
        if state["active"]:
            return await call_next(req)
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        try:
            prof.enable()
        except ValueError:  # raced another profiler
            return await call_next(req)
        state["active"] = True
        try:
            return await call_next(req)
        finally:
            prof.disable()
            state["active"] = False
            out_dir.mkdir(parents=True, exist_ok=True)
            slug = re.sub(r"[^a-zA-Z0-9]+", "_", req.path).strip("_") or "root"
            fname = out_dir / f"profile_{req.method}_{slug}_{int(time.time() * 1e3)}.prof"
            try:
                prof.dump_stats(str(fname))
                logger.info("profiled %s %s (%.1f ms) -> %s", req.method, req.path,
                            (time.perf_counter() - t0) * 1e3, fname)
            except Exception:  # noqa: BLE001
                logger.exception("failed to write profile")

    return profile_request
