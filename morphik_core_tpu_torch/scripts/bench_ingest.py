#!/usr/bin/env python3
"""The ingest pipeline's end-to-end throughput and where it goes, on the
port: twin of `scripts/bench_ingest.py`, with its corpus, parts and report
keys.

The serving-side embed rate says nothing of what a tenant sees when they
upload a corpus: the full ingest path is parse -> rasterize -> JPEG
payload -> decode -> preprocess -> embed -> FDE -> store, plus per-doc
job and database work. This script measures, with the 3B int8 tower
(random weights from a seed, `Settings()`'s precision and scales):

  A. end to end: N docs x P pages through the job queue's
     `process_ingestion_job` with `worker.max_jobs` workers (printed),
     with the service's own phase_times summed;
  B. each stage alone on the same corpus: raster, the JPEG encode and
     decode of the payloads, preprocess (threaded), embed, FDE + store;
     one batch's split into preprocess, upload and device step; and the
     raster pool's pages/s at 1, 2, 4 and 8 processes.

The original's `vs_chip_north_star` (a ratio to a TPU figure) is not
reported.

    python -m morphik_core_tpu_torch.scripts.bench_ingest [--docs 25] [--pages-per-doc 20]
        [--small] [--cpu] [--out INGEST.json]

`--small` is the tiny model over 3 docs x 4 pages (and the raster pool at
1 and 2 processes over 8 pages). It runs on the card, or on the CPU with
`--cpu`, and writes a file only with `--out` (the original writes
INGEST_r05.json at the repo root).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np

WORDS = (
    "alpha bridge casing dynamo ember flux gasket helix ion joule kelvin lumen "
    "motor nacelle orbit piston quartz rotor stator torque valve winding yoke zenith"
).split()


def make_pdf(pages: list[str]) -> bytes:
    """Minimal text PDF the parser reads (as the original builds it)."""
    objs = []
    n_pages = len(pages)
    kids = " ".join(f"{3 + 2 * i} 0 R" for i in range(n_pages))
    objs.append("1 0 obj<</Type/Catalog/Pages 2 0 R>>endobj\n".encode())
    objs.append(f"2 0 obj<</Type/Pages/Count {n_pages}/Kids[{kids}]>>endobj\n".encode())
    for i, text in enumerate(pages):
        page_num, content_num = 3 + 2 * i, 4 + 2 * i
        objs.append(
            f"{page_num} 0 obj<</Type/Page/Parent 2 0 R/Contents {content_num} 0 R"
            f"/MediaBox[0 0 612 792]>>endobj\n".encode()
        )
        lines = []
        for j, ln in enumerate(text.split("\n")):
            esc = ln.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")
            lines.append(f"1 0 0 1 72 {720 - 14 * j} Tm ({esc}) Tj")
        stream = ("BT /F1 12 Tf " + " ".join(lines) + " ET").encode()
        comp = zlib.compress(stream)
        objs.append(
            f"{content_num} 0 obj<</Length {len(comp)}/Filter/FlateDecode>>stream\n".encode()
            + comp
            + b"\nendstream endobj\n"
        )
    return b"%PDF-1.4\n" + b"".join(objs) + b"trailer<</Root 1 0 R>>\n%%EOF"


def page_text(rng, kw: str) -> str:
    lines = [f"UNIT SPEC {kw}"]
    for _ in range(int(rng.integers(14, 24))):
        lines.append(" ".join(rng.choice(WORDS, rng.integers(4, 10)).tolist()))
    lines.insert(int(rng.integers(1, len(lines))), f"rated torque of {kw} is {rng.integers(10, 990)} Nm")
    return "\n".join(lines)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_bench(n_docs: int, pages_per_doc: int, small: bool, model=None, device=None) -> dict:
    """Measure the ingest pipeline; returns the result dict. `model`: a
    prebuilt tower (default the tiny or 3B random one in the configured
    precision); `device`: the services' (default the card)."""
    import torch

    from morphik_core_tpu_torch.config import Settings
    from morphik_core_tpu_torch.device import default_device
    from morphik_core_tpu_torch.models.colqwen.config import ColQwenConfig
    from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel, quantize_colqwen_params
    from morphik_core_tpu_torch.models.schemas import AuthContext
    from morphik_core_tpu_torch.services_init import build_services

    device = torch.device(device) if device is not None else default_device()
    rng = np.random.default_rng(11)

    # ---- corpus ----------------------------------------------------------
    docs = []
    for _ in range(n_docs):
        kws = [f"{rng.choice(WORDS).upper()}-{rng.integers(1000, 9999)}" for _ in range(pages_per_doc)]
        docs.append(make_pdf([page_text(rng, kw) for kw in kws]))
    _log(f"corpus: {n_docs} docs x {pages_per_doc} pages ({sum(map(len, docs)) / 1e6:.1f} MB pdf)")

    # ---- services with the tower at the configured precision -------------
    root = Path(tempfile.mkdtemp(prefix="bench_ingest_"))
    settings = Settings.from_dict(
        {
            "storage": {"storage_path": str(root / "storage")},
            "database": {"path": str(root / "db.sqlite")},
            "vector_store": {"index_path": str(root / "index")},
            "service": {"environment": "development"},
            "telemetry": {"telemetry_dir": str(root / "telemetry")},
        }
    )
    if model is None:
        t0 = time.time()
        model = ColQwenModel.init_random(ColQwenConfig.tiny() if small else ColQwenConfig(), seed=0,
                                         device=device, dtype=torch.bfloat16)
        if settings.model.matmul_precision == "int8":
            quantize_colqwen_params(model)
        _log(f"model init ({settings.model.matmul_precision}): {time.time() - t0:.1f}s")

    services = build_services(settings, colqwen_model=model, device=device)
    ing = services.ingestion_service
    auth = AuthContext(entity_type="developer", entity_id="bench", permissions={"read", "write", "admin"})

    # ---- A: end to end through the job queue -----------------------------
    # worker.max_jobs workers: doc k+1's parse/raster overlaps doc k's embed
    # (serialized on the device); the proof of overlap is sum(phase_times)
    # exceeding the wall clock
    async def run_all():
        t_start = time.perf_counter()
        doc_ids = []
        for d, pdf in enumerate(docs):
            doc = await ing.ingest_file_content(pdf, f"doc{d}.pdf", {}, auth)
            await services.job_queue.enqueue_job(
                "process_ingestion_job",
                document_id=doc.external_id,
                auth=auth.model_dump(mode="json"),
                use_colpali=True,
            )
            doc_ids.append(doc.external_id)
        ok = await services.job_queue.drain(timeout=3600)
        wall = time.perf_counter() - t_start
        assert ok, "queue failed to drain"
        phase_sums: dict[str, float] = {}
        total_pages = 0
        for doc_id in doc_ids:
            done = await services.database.get_document(doc_id, auth)
            assert done.system_metadata.get("status") == "completed", (
                doc_id, done.system_metadata.get("status"), done.system_metadata.get("error"))
            for k, v in done.system_metadata.get("phase_times", {}).items():
                phase_sums[k] = phase_sums.get(k, 0.0) + v
            total_pages += done.system_metadata.get("page_count") or 0
        return wall, phase_sums, total_pages

    async def _phase_a():
        await services.initialize()
        # warmup: one throwaway doc
        warm = await ing.ingest_file_content(make_pdf([page_text(rng, "WARM-0000")]), "warm.pdf", {}, auth)
        await ing.process_ingestion_job(warm.external_id, auth)
        out = await run_all()
        # shut down in the loop the services started in (the queue's workers are bound to it)
        await services.shutdown()
        return out

    t_e2e, phase_sums, total_pages = asyncio.run(_phase_a())
    e2e_pages_per_s = total_pages / t_e2e
    phase_total = sum(phase_sums.values())
    _log(f"A. e2e: {total_pages} pages in {t_e2e:.1f}s = {e2e_pages_per_s:.2f} pages/s "
         f"(phase sum {phase_total:.1f}s -> overlap x{phase_total / max(t_e2e, 1e-9):.2f}); "
         f"max_jobs {settings.worker.max_jobs}")

    # ---- B: stage isolation ---------------------------------------------
    from concurrent.futures import ThreadPoolExecutor

    from morphik_core_tpu_torch.models.colqwen.preprocess import preprocess_array_u8, resize_bicubic_u8
    from morphik_core_tpu_torch.parser.pdf import rasterize_pdf
    from morphik_core_tpu_torch.parser.raster_pool import RasterPool
    from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri, data_uri_to_bytes
    from morphik_core_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg

    stage = {}
    sample_docs = docs[: max(2, len(docs) // 5)]
    t0 = time.perf_counter()
    images = []
    for pdf in sample_docs:
        imgs, _ = rasterize_pdf(pdf, dpi=settings.pdf.colpali_pdf_dpi)
        images.extend(imgs)
    stage["raster_pages_per_s"] = len(images) / (time.perf_counter() - t0)

    t0 = time.perf_counter()
    uris = []
    for img in images:
        h, w = img.shape[:2]
        small_img = resize_bicubic_u8(img, (int(h * min(1, 1024 / w)), min(w, 1024)))
        uris.append(bytes_to_data_uri(encode_jpeg(small_img, quality=80)[0], "image/jpeg"))
    stage["jpeg_encode_pages_per_s"] = len(images) / (time.perf_counter() - t0)

    t0 = time.perf_counter()
    decoded = [decode_jpeg(data_uri_to_bytes(u)) for u in uris]
    stage["jpeg_decode_pages_per_s"] = len(images) / (time.perf_counter() - t0)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as pool:
        prepped = list(pool.map(
            lambda im: preprocess_array_u8(im, min_pixels=settings.model.min_pixels,
                                           max_pixels=settings.model.max_pixels), decoded))
    stage["preprocess_pages_per_s"] = len(images) / (time.perf_counter() - t0)

    # embed: the embedder over the whole decoded sample (the device stage)
    emb_model = services.ingestion_service.colpali_embedding_model
    emb_model.embed_images(decoded[: min(8, len(decoded))])  # warm
    t0 = time.perf_counter()
    embs = emb_model.embed_images(decoded)
    stage["embed_pages_per_s"] = len(decoded) / (time.perf_counter() - t0)

    # one batch of 8 split into preprocess / host->device upload / device
    # step and fetch; each upload sends fresh bytes
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    bsz = min(8, len(prepped))
    arr = np.stack([p for p, _ in prepped[:bsz]])
    grid = prepped[0][1]
    up_times = []
    for r in range(5):
        a = arr.copy()
        a[..., r % arr.shape[-1]] ^= np.uint8(r + 1)
        t0 = time.perf_counter()
        torch.from_numpy(a).to(device)
        sync()
        up_times.append(time.perf_counter() - t0)
    upload_s = float(np.median(up_times))
    tot_times = []
    for r in range(3):
        a = arr.copy()
        a[..., (7 + r) % arr.shape[-1]] ^= np.uint8(17 + r)
        t0 = time.perf_counter()
        emb_model.model.embed_image_batch(a, *grid, as_device=True).cpu()
        tot_times.append(time.perf_counter() - t0)
    total_s = float(np.median(tot_times))
    prep_rate = stage["preprocess_pages_per_s"]
    attribution = {
        "batch": bsz,
        "patch_mb_per_batch": round(arr.nbytes / 1e6, 2),
        "preprocess_s_per_batch": round(bsz / prep_rate, 3),
        "upload_s_per_batch": round(upload_s, 3),
        "upload_mb_per_s": round(arr.nbytes / 1e6 / max(upload_s, 1e-9), 1),
        "embed_total_s_per_batch": round(total_s, 3),
        "step_fetch_s_per_batch": round(max(total_s - upload_s, 0.0), 3),
        "serial_pages_per_s": round(bsz / (total_s + bsz / prep_rate), 2),
        "pipelined_bound_pages_per_s": round(
            bsz / max(upload_s, max(total_s - upload_s, 1e-9), bsz / prep_rate), 2
        ),
    }
    _log(f"B2. embed attribution: {attribution}")

    # ---- the raster pool's scaling with process count ----
    n_scale, procs_list = (8, (1, 2)) if small else (32, (1, 2, 4, 8))
    scale_doc = make_pdf([page_text(rng, f"SCAL-{i:04d}") for i in range(n_scale)])
    raster_scaling = {"host_cpus": os.cpu_count(), "pages": n_scale}
    for procs in procs_list:
        rp = RasterPool(procs)

        async def _rate(rp=rp):
            t0 = time.perf_counter()
            pages = await rp.rasterize_pdf_jpegs(scale_doc, dpi=settings.pdf.colpali_pdf_dpi)
            return len(pages) / (time.perf_counter() - t0)

        asyncio.run(_rate())  # warm: worker start and imports
        raster_scaling[f"procs_{procs}_pages_per_s"] = round(asyncio.run(_rate()), 2)
        rp.shutdown()
    _log(f"B3. raster scaling: {raster_scaling}")

    # FDE + store (device FDE encode + host rows)
    from morphik_core_tpu_torch.models.schemas import DocumentChunk

    store = services.ingestion_service.colpali_vector_store
    chunks = [DocumentChunk(document_id="bench-stage", chunk_number=i, content="", embedding=e)
              for i, e in enumerate(embs)]
    t0 = time.perf_counter()
    asyncio.run(store.store_embeddings(chunks, app_id=None))
    stage["fde_store_pages_per_s"] = len(chunks) / (time.perf_counter() - t0)
    store.close()
    _log(f"B. stages: { {k: round(v, 2) for k, v in stage.items()} }")

    return {
        "metric": f"ingest e2e throughput (job queue path, max_jobs={settings.worker.max_jobs} overlapped)",
        "value": round(e2e_pages_per_s, 3),
        "unit": "pages/s",
        "pages": total_pages,
        "docs": n_docs,
        "max_jobs": settings.worker.max_jobs,
        "phase_split_s": {k: round(v, 2) for k, v in phase_sums.items()},
        "phase_sum_s": round(phase_total, 2),
        "wall_s": round(t_e2e, 2),
        "overlap_factor": round(phase_total / max(t_e2e, 1e-9), 2),
        "stage_isolation_pages_per_s": {k: round(v, 2) for k, v in stage.items()},
        "embed_attribution": attribution,
        "raster_pool_scaling": raster_scaling,
        "backend": device.type,
        "small": small,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=25)
    ap.add_argument("--pages-per-doc", type=int, default=20)
    ap.add_argument("--small", action="store_true", help="the tiny model over 3 docs x 4 pages")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    ap.add_argument("--out", type=Path, default=None, help="write the result here too")
    args = ap.parse_args(argv)
    if args.small:
        args.docs, args.pages_per_doc = 3, 4
    result = run_bench(args.docs, args.pages_per_doc, args.small, device="cpu" if args.cpu else None)
    print(json.dumps(result), flush=True)
    if args.out:
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
