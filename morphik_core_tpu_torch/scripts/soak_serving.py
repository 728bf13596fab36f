"""Live-server concurrency soak: PyTorch port of `scripts/soak_serving.py`.

Boots the full service stack and the HTTP server, then drives concurrent
ingest / retrieve / filtered-retrieve / RAG-query traffic for --seconds
(two ingesters, two queriers), and passes when there was no 5xx answer,
the job queue drained, and no asyncio task is pending after shutdown
(the SIGTERM path). The clients are the stdlib's urllib (no httpx beside
the card), each request on a worker thread; pages are drawn with the
port's glyph atlas and encoded with its PNG encoder (no PIL).

    python -m morphik_core_tpu_torch.scripts.soak_serving [--seconds 180] [--root DIR] [--device cpu]

From the command line the server serves the development model of the
default settings; `run_soak(..., settings=, colqwen_model=)` serves a
given configuration and model. Without --root the stack's files go to a
fresh directory under the temporary directory (TMPDIR).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import socket
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np

_BOUNDARY = "soak-boundary-5d1c"


def page_png(i: int) -> bytes:
    """A 320 x 240 white page with two lines of text, as PNG."""
    from morphik_core_tpu_torch.parser.text_render import _blend_black, load_font
    from morphik_core_tpu_torch.utils.png import encode_png

    font = load_font(100)
    page = np.full((240, 320), 255, np.uint8)
    for y, line in ((30, f"SOAK DOC {i}"), (60, f"serial S-{1000 + i} torque {i * 3} Nm")):
        mask, ox, oy = font.line_mask(line)
        _blend_black(page, mask, 10 + ox, y + oy)
    return encode_png(np.repeat(page[..., None], 3, axis=2))


def _multipart(filename: str, data: bytes, ctype: str, fields: dict):
    body = b"".join(f'--{_BOUNDARY}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
                    for k, v in fields.items())
    body += (f'--{_BOUNDARY}\r\nContent-Disposition: form-data; name="file"; filename="{filename}"\r\n'
             f"Content-Type: {ctype}\r\n\r\n").encode() + data + f"\r\n--{_BOUNDARY}--\r\n".encode()
    return body, f"multipart/form-data; boundary={_BOUNDARY}"


def _post(base: str, path: str, timeout: float, json_body=None, upload=None):
    """-> (status, text) of one POST; `upload` = (filename, bytes, content
    type, form fields). Raises TimeoutError when the server does not
    answer in `timeout` s."""
    if upload is not None:
        data, ctype = _multipart(*upload)
    else:
        data, ctype = json.dumps(json_body).encode(), "application/json"
    req = urllib.request.Request(base + path, data=data, method="POST", headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode(errors="replace")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(errors="replace")
    except urllib.error.URLError as e:
        if isinstance(e.reason, (TimeoutError, socket.timeout)):
            raise TimeoutError(str(e)) from e
        raise


def soak_settings(root: str):
    from morphik_core_tpu_torch.config import Settings

    return Settings.from_dict({
        "api": {"port": 0},
        "storage": {"storage_path": f"{root}/storage"},
        "database": {"path": f"{root}/db.sqlite"},
        "vector_store": {"index_path": f"{root}/index", "fde_num_repetitions": 8,
                         "fde_num_simhash_projections": 4, "fde_projection_dimension": 8},
        "telemetry": {"telemetry_dir": f"{root}/logs/telemetry"},
    })


async def run_soak(seconds: int, root: str, device=None, settings=None, colqwen_model=None) -> dict:
    from morphik_core_tpu_torch.api.app import build_app
    from morphik_core_tpu_torch.api.http import HTTPServer
    from morphik_core_tpu_torch.services_init import build_services

    services = build_services(settings or soak_settings(root), colqwen_model=colqwen_model, device=device)
    await services.initialize()
    srv = HTTPServer(build_app(services), "127.0.0.1", 0)
    await srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    stats = {"ingest": 0, "retrieve": 0, "query": 0, "filtered": 0, "errors": [], "client_timeouts": 0}

    async def post(path, timeout, **kw):
        return await asyncio.to_thread(_post, base, path, timeout, **kw)

    # warm-up before the clock: the first ingest, retrieve, filtered
    # retrieve and query
    t0 = time.time()
    status, text = await post("/ingest/file", 600, upload=("warm.png", page_png(0), "image/png",
                                                           {"metadata": "{}", "use_colpali": "true"}))
    assert status == 200, text
    for _ in range(240):
        if services.job_queue.pending_count() == 0:
            break
        await asyncio.sleep(0.5)
    for body in ({"query": "torque warm", "k": 2, "use_colpali": True},
                 {"query": "torque warm", "k": 2, "use_colpali": True, "filters": {"wid": {"$eq": 1}}}):
        await post("/retrieve/chunks", 600, json_body=body)
    await post("/query", 600, json_body={"query": "warm?", "k": 2, "use_colpali": True})
    warm_s = time.time() - t0
    deadline = time.time() + seconds

    async def hit(path, **kw) -> bool:
        try:
            status, text = await post(path, 180, **kw)
        except TimeoutError:
            stats["client_timeouts"] += 1
            return False
        if status >= 500:
            stats["errors"].append((path, status, text[:120]))
            return False
        return True

    async def ingester(wid: int) -> None:
        i = wid * 1000
        while time.time() < deadline:
            i += 1
            if await hit("/ingest/file", upload=(f"doc{i}.png", page_png(i), "image/png",
                                                 {"metadata": json.dumps({"wid": wid}), "use_colpali": "true"})):
                stats["ingest"] += 1
            await asyncio.sleep(0.3)

    async def querier() -> None:
        while time.time() < deadline:
            if await hit("/retrieve/chunks", json_body={
                    "query": f"torque of serial S-{random.randint(1000, 1040)}", "k": 3, "use_colpali": True}):
                stats["retrieve"] += 1
            if await hit("/retrieve/chunks", json_body={
                    "query": "torque", "k": 3, "use_colpali": True, "filters": {"wid": {"$eq": 1}}}):
                stats["filtered"] += 1
            if await hit("/query", json_body={"query": "what torque values exist?", "k": 2, "use_colpali": True}):
                stats["query"] += 1
            await asyncio.sleep(0.5)

    await asyncio.gather(ingester(1), ingester(2), querier(), querier())
    drained = await services.job_queue.drain(timeout=180)
    await srv.stop()
    await services.shutdown()
    await asyncio.get_running_loop().shutdown_default_executor()  # the client threads
    pend = [t for t in asyncio.all_tasks() if not t.done() and t is not asyncio.current_task()]
    return {**stats, "errors": stats["errors"][:5], "n_errors": len(stats["errors"]),
            "warmup_s": round(warm_s, 1), "drained": drained, "pending_after_drain": len(pend)}


def passed(out: dict) -> bool:
    """The soak's pass rule: no 5xx, a drained queue, no pending tasks."""
    return out["n_errors"] == 0 and out["drained"] and out["pending_after_drain"] == 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seconds", type=int, default=180)
    ap.add_argument("--root", default=None, help="directory of the stack's files (default: a fresh temporary one)")
    ap.add_argument("--device", default=None, help="torch device of the stack (default: the card)")
    args = ap.parse_args(argv)
    root = args.root or tempfile.mkdtemp(prefix="soak_")
    out = asyncio.run(run_soak(args.seconds, root, device=args.device))
    print(json.dumps(out))
    return 0 if passed(out) else 1


if __name__ == "__main__":
    raise SystemExit(main())
