#!/usr/bin/env python3
"""Drive the PyTorch port's ColPali ingest -> retrieve path once on one
NVIDIA H100, at the full ColQwen2.5-3B geometry with random weights.

    python3 chip_smoke.py

Phases (each raises on failure; none is caught):
  1. the card's name and power limit; build the kernels of
     morphik_core_tpu_torch/csrc/ with nvcc.
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes and at ragged edges; times by CUDA events
     (plain, kernel, kernel, plain).
  3. ingest: the 3B model in bf16 embeds one batch of 8 pages at grid
     20 x 28 from seeded uint8 patches, with the fused document FDE.
  4. store: the 8 pages plus seeded synthetic unit multivectors into the
     index, over several device blocks.
  5. query with the shipped retrieval config (int8 ANN, pooled tier
     factor 32, int8 rerank through the device cache): text queries and
     one self-query that must come back top-1.
  6. the same with rerank_dtype="bf16".
  7. both kernels' launch counts grew during the main path (phases 3-6;
     the counts are reset after phase 2's comparison launches).
The last line is {"ok": true, "device": {...}}. Without CUDA, an sm_90
card, nvcc or the package beside this file, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
GRID = (20, 28)  # pages at grid 20 x 28 units (560 x 784 px)
BATCH = 8
N_SYNTH = 2040  # synthetic rows stored beside the 8 pages
BLOCK_ROWS = 1024  # small device blocks: the 2048-row index spans 2
SHIPPED = dict(  # morphik_tpu.toml [vector_store], no mesh, no persistence
    prefilter_multiplier=30, prefilter_cap=300, ann_dtype="int8",
    device_cache_slots=2048, device_cache_token_bucket=1024, rerank_dtype="int8",
    rerank_prefilter_pooling=4, pooled_tier_factor=32, pooled_tier_budget_mb=6144,
    query_token_dedup=0.98,
)
QUERIES = ["quarterly revenue growth", "table of contents", "signature page of the contract",
           "figure 3: latency distribution"]
# K1: per-token products are bit-identical to the plain version; only the
# f32 sum over <= 640 query tokens is reordered (|err| <= 640 * 2^-24 * sum|terms|).
K1_RTOL, K1_ATOL = 1e-5, 1e-4
# K2: f32 dots over D = 128 accumulate in another order than the plain
# einsum (~128 * 2^-24 relative each), summed over <= 640 query tokens.
K2_RTOL, K2_ATOL = 1e-4, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def setup():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    if not (ROOT / "morphik_core_tpu_torch" / "csrc" / "maxsim.cu").is_file():
        raise SystemExit("chip_smoke: morphik_core_tpu_torch/ not found beside this script")
    sys.path.insert(0, str(ROOT))
    from morphik_core_tpu_torch.device import kernels_available

    if not kernels_available():
        raise SystemExit(f"chip_smoke: needs an sm_90 card, got {torch.cuda.get_device_capability(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return torch, smi


def build_kernels():
    from morphik_core_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.build(verbose=True)
    _kernels.library()
    log(f"phase 1: kernels built (nvcc, from source) and loaded in {time.perf_counter() - t0:.3f} s")


def _time_ms(torch, fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _compare(torch, name, kernel_fn, plain_fn, rtol, atol, exact=False):
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if exact and not torch.equal(got, want):
        raise AssertionError(f"{name}: expected bit-identical scores, max err {err}")
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: max err {err} beyond rtol={rtol} atol={atol}")
    p1 = _time_ms(torch, plain_fn)
    k1 = _time_ms(torch, kernel_fn)
    k2 = _time_ms(torch, kernel_fn)
    p2 = _time_ms(torch, plain_fn)
    res = {"case": name, "max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}
    log(f"  {name}: max_abs_err={err:.3e} kernel_ms={res['ms']:.5f} plain_ms={res['plain_ms']:.5f}")
    return res


def kernel_checks(torch):
    """Phase 2: K1 and K2 against their plain versions on the card."""
    import numpy as np

    from morphik_core_tpu_torch.ops.maxsim import (
        maxsim, maxsim_plain, maxsim_q8, maxsim_q8_plain, quantize_query_q8,
    )

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    D = 128

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def query_q8(nq):
        q = rng.standard_normal((nq, D)).astype(np.float32)
        q8, qs = quantize_query_q8(q / np.linalg.norm(q, axis=1, keepdims=True))
        return t(q8), t(qs)

    def pool_q8(rows, n_pad, lengths):  # large pools are drawn on the card
        d8 = torch.randint(-127, 128, (rows, n_pad, D), generator=gen, device=dev, dtype=torch.int8)
        ds = torch.rand((rows, n_pad), generator=gen, device=dev) * 0.01 + 1e-3
        mask = t((np.arange(n_pad)[None, :] < lengths[:, None]).astype(np.float32))
        return d8, ds * mask, mask

    def docs_f(rows, n_pad):
        return torch.randn((rows, n_pad, D), generator=gen, device=dev) / D**0.5

    def query_f32(nq, pad_to):
        q = np.zeros((pad_to, D), np.float32)
        q[:nq] = rng.standard_normal((nq, D)).astype(np.float32) / np.sqrt(D)
        return t(q)

    k1, k2 = [], []
    log("phase 2: kernels vs plain on the card")
    # K1 at the pooled stage: tier block (1024 rows, bucket 24), pool 304
    # gathered in-kernel, rows of the other block = -1
    d8, ds, m = pool_q8(BLOCK_ROWS, 24, rng.integers(1, 25, BLOCK_ROWS))
    idx = rng.integers(0, BLOCK_ROWS, 304).astype(np.int32)
    idx[rng.random(304) < 0.5] = -1
    q8, qs = query_q8(32)
    idx_t = t(idx)
    k1.append(_compare(torch, "K1 pooled stage C=304 Np=24 NQ=32 (idx)",
                       lambda: maxsim_q8(q8, qs, d8, ds, m, idx_t),
                       lambda: maxsim_q8_plain(q8, qs, d8, ds, m, idx_t), K1_RTOL, K1_ATOL))
    # K1 at the cache rerank: 2048 int8 slots of 1024 tokens, 32 gathered
    d8, ds, m = pool_q8(2048, 1024, rng.integers(500, 1025, 2048))
    idx_t = t(rng.choice(2048, 32, replace=False).astype(np.int32))
    k1.append(_compare(torch, "K1 cache rerank C=32 Np=1024 NQ=32 (idx)",
                       lambda: maxsim_q8(q8, qs, d8, ds, m, idx_t),
                       lambda: maxsim_q8_plain(q8, qs, d8, ds, m, idx_t), K1_RTOL, K1_ATOL))
    main_k1 = k1[-1]
    # one real query token (+7 zero rows): score = one max, bit-identical
    q8_1, qs_1 = query_q8(1)
    _compare(torch, "K1 single query token (exact)",
             lambda: maxsim_q8(q8_1, qs_1, d8, ds, m, idx_t),
             lambda: maxsim_q8_plain(q8_1, qs_1, d8, ds, m, idx_t), 0.0, 0.0, exact=True)
    # ragged: C = 13, one fully masked candidate, zero query rows, NQ > 256
    lengths = rng.integers(1, 700, 13)
    lengths[5] = 0
    d8r, dsr, mr = pool_q8(13, 700, lengths)
    q8r, qsr = query_q8(633)  # padded to 640: 7 zero rows
    got = _compare(torch, "K1 ragged C=13 Np=700 NQ=640, masked cand",
                   lambda: maxsim_q8(q8r, qsr, d8r, dsr, mr),
                   lambda: maxsim_q8_plain(q8r, qsr, d8r, dsr, mr), K1_RTOL, K1_ATOL)
    if float(maxsim_q8(q8r, qsr, d8r, dsr, mr)[5]) != 0.0:
        raise AssertionError("K1: a fully masked candidate must score exactly 0")
    k1.append(got)

    # K2 at the bf16 cache rerank: 2048 bf16 slots of 1024 tokens
    docs = docs_f(2048, 1024).to(torch.bfloat16)
    mask = m  # same ragged slot lengths
    qf = query_f32(29, 32)
    k2.append(_compare(torch, "K2 cache rerank bf16 C=32 Np=1024 NQ=32 (idx)",
                       lambda: maxsim(qf, docs, mask, idx_t),
                       lambda: maxsim_plain(qf, docs, mask, idx_t), K2_RTOL, K2_ATOL))
    main_k2 = k2[-1]
    del docs
    # K2 cold rerank layout (no idx), bf16, C = 32, Np = round_up(max_n, 128)
    docs_c = docs_f(32, 768).to(torch.bfloat16)
    mask_c = t((np.arange(768)[None] < rng.integers(600, 700, 32)[:, None]).astype(np.float32))
    k2.append(_compare(torch, "K2 cold rerank bf16 C=32 Np=768 NQ=32",
                       lambda: maxsim(qf, docs_c, mask_c),
                       lambda: maxsim_plain(qf, docs_c, mask_c), K2_RTOL, K2_ATOL))
    # ragged f32: C = 13, fully masked candidate, zero query rows, NQ = 640
    docs_r = docs_f(13, 700)
    mask_r = t((np.arange(700)[None] < lengths[:, None]).astype(np.float32))
    qfr = query_f32(633, 640)
    k2.append(_compare(torch, "K2 ragged f32 C=13 Np=700 NQ=640, masked cand",
                       lambda: maxsim(qfr, docs_r, mask_r),
                       lambda: maxsim_plain(qfr, docs_r, mask_r), K2_RTOL, K2_ATOL))
    if float(maxsim(qfr, docs_r, mask_r)[5]) != 0.0:
        raise AssertionError("K2: a fully masked candidate must score exactly 0")
    return main_k1, main_k2, k1 + k2


def ingest(torch):
    """Phase 3: the 3B model embeds one batch of 8 pages with fused FDE."""
    import numpy as np

    from morphik_core_tpu_torch.embedding.colpali_embedding_model import ColpaliEmbeddingModel
    from morphik_core_tpu_torch.models.colqwen.config import ColQwenConfig
    from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel
    from morphik_core_tpu_torch.ops.fde import FDEConfig

    t0 = time.perf_counter()
    cfg = ColQwenConfig()
    model = ColQwenModel.init_random(cfg, seed=SEED, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 3: ColQwen2.5-3B geometry, {n_params} params in bf16, init {time.perf_counter() - t0:.3f} s")
    emb = ColpaliEmbeddingModel(model, batch_size=BATCH, fde_config=FDEConfig())
    rng = np.random.default_rng(SEED)
    s = GRID[0] * GRID[1] * cfg.vision.merge_unit
    pages = rng.integers(0, 256, (BATCH, s, cfg.vision.patch_input_dim // 2), dtype=np.uint8)
    prepped = [(p, GRID) for p in pages]
    times = []
    for _ in range(2):  # first run includes cuBLAS start-up
        t0 = time.perf_counter()
        embs, fdes = emb._embed_prepped(prepped, with_fde=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    n_seq = len(model.image_sequence_ids(GRID[0] * GRID[1]))
    for e, f in zip(embs, fdes):
        if e.shape != (n_seq, cfg.embedding_dim) or f.shape != (FDEConfig().fde_dim,):
            raise AssertionError(f"ingest shapes {e.shape} {f.shape}")
        if not (np.isfinite(e).all() and np.isfinite(f).all()):
            raise AssertionError("ingest produced non-finite values")
        norms = np.linalg.norm(e, axis=1)
        if np.abs(norms - 1.0).max() > 1e-3:
            raise AssertionError(f"rows not unit-norm: {norms.min()} .. {norms.max()}")
    log(f"  8 pages -> {BATCH} x ({n_seq}, {cfg.embedding_dim}) + FDE ({FDEConfig().fde_dim},); "
        f"batch wall s first={times[0]:.4f} second={times[1]:.4f} "
        f"pages/s(second)={BATCH / times[1]:.3f}; peak mem GB={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    return emb, embs, fdes


def synthetic_rows(n_tok_range, n: int):
    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    out = []
    for _ in range(n):
        x = rng.standard_normal((int(rng.integers(*n_tok_range)), 128)).astype(np.float32)
        out.append((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float16))
    return out


def make_index(torch, rows, page_fdes, synth_fdes=None, **over):
    """An index with the shipped retrieval config over the 8 pages (with
    their fused ingest FDE) and the synthetic rows (FDE by the store's
    own device encoder unless given)."""
    from morphik_core_tpu_torch.index.multivector_index import IndexRecord, MultiVectorIndex
    from morphik_core_tpu_torch.ops.fde import FDEConfig

    index = MultiVectorIndex(FDEConfig(), device="cuda", device_block_rows=BLOCK_ROWS,
                             **dict(SHIPPED, **over))
    recs = [IndexRecord(document_id=f"page{i}" if i < BATCH else f"synth{i - BATCH}", chunk_number=0)
            for i in range(len(rows))]
    t0 = time.perf_counter()
    index.store(rows[:BATCH], recs[:BATCH], fde_vectors=page_fdes)
    index.store(rows[BATCH:], recs[BATCH:], fde_vectors=synth_fdes)
    torch.cuda.synchronize()
    return index, time.perf_counter() - t0


def run_queries(torch, emb, index, rows, label):
    import numpy as np

    lat = []
    for text in QUERIES:
        t0 = time.perf_counter()
        res = index.query(emb.embed_for_query(text), k=10, return_timing=True)
        lat.append((time.perf_counter() - t0) * 1e3)
        if len(res) != 10 or not all(np.isfinite(s) for _, s in res):
            raise AssertionError(f"{label}: query {text!r} returned {len(res)} results")
        if not index.last_timing["pooled_tier"]:
            raise AssertionError(f"{label}: the pooled tier did not serve the query")
    self_row = BATCH + 123
    q = np.asarray(rows[self_row], np.float32)
    t0 = time.perf_counter()
    res = index.query(q, k=10, return_timing=True)
    self_ms = (time.perf_counter() - t0) * 1e3
    top = res[0][0].document_id
    if top != f"synth{self_row - BATCH}":
        raise AssertionError(f"{label}: self-query top-1 is {top}")
    log(f"  {label}: text query ms {[round(x, 3) for x in lat]} (embed + index); "
        f"self-query top-1 ok, score {res[0][1]:.4f} vs n_tokens {q.shape[0]}, ms {self_ms:.3f}, "
        f"index timing {json.dumps({k: round(v, 4) if isinstance(v, float) else v for k, v in index.last_timing.items()})}")
    return q, res


def brute_force_top1(torch, rows, q):
    """Exact f32 MaxSim of q against every stored row, chunked, on the card."""
    import numpy as np

    from morphik_core_tpu_torch.ops.maxsim import maxsim_scores_ref, pad_multivectors

    scores = []
    qt = torch.from_numpy(q).cuda()
    for s in range(0, len(rows), 128):
        dense, mask = pad_multivectors(rows[s : s + 128])
        scores.append(maxsim_scores_ref(qt, torch.from_numpy(dense).cuda(), torch.from_numpy(mask).cuda()))
    return int(torch.cat(scores).argmax())


def main() -> None:
    torch, smi = setup()
    import numpy as np

    from morphik_core_tpu_torch.ops import _kernels

    t_all = time.perf_counter()
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__} cuda {torch.version.cuda}")
    build_kernels()
    main_k1, main_k2, all_cases = kernel_checks(torch)
    _kernels.reset_launch_counts()  # the main path starts here
    emb, page_embs, page_fdes = ingest(torch)
    rows = [e.astype(np.float16) for e in page_embs] + synthetic_rows((600, 661), N_SYNTH)
    index, store_s = make_index(torch, rows, np.stack(page_fdes))
    log(f"phase 4: stored {len(rows)} rows (device FDE + pooling + host copy) in {store_s:.3f} s")
    log("phase 5: queries, shipped retrieval config (int8 rerank)")
    q_self, _ = run_queries(torch, emb, index, rows, "int8 rerank")
    n_blocks = len(index._dev_blocks)
    if n_blocks < 2:
        raise AssertionError(f"index spans {n_blocks} device block(s), expected >= 2")
    if brute_force_top1(torch, rows, q_self) != BATCH + 123:
        raise AssertionError("exact f32 MaxSim over all rows disagrees on the self-query top-1")
    log("phase 6: queries, rerank_dtype='bf16'")
    fdes = np.stack(index._fde_host)
    index_bf16, _ = make_index(torch, rows, fdes[:BATCH], fdes[BATCH:], rerank_dtype="bf16")
    run_queries(torch, emb, index_bf16, rows, "bf16 rerank")
    counts = dict(_kernels.launch_counts)
    log(f"phase 7: launch counts over the main path (phases 3-6): {counts}")
    if counts["maxsim_q8"] <= 0 or counts["maxsim"] <= 0:
        raise AssertionError(f"a kernel of the path was never launched: {counts}")
    src = "morphik_core_tpu_torch/csrc/maxsim.cu"
    kernels = [
        {"name": "maxsim_q8", "route": "cuda", "source": src,
         "replaces": "morphik_core_tpu/ops/maxsim.py:248", "launches": counts["maxsim_q8"],
         "max_abs_err": main_k1["max_abs_err"], "ms": main_k1["ms"], "plain_ms": main_k1["plain_ms"],
         "shape": main_k1["case"]},
        {"name": "maxsim", "route": "cuda", "source": src,
         "replaces": "morphik_core_tpu/ops/maxsim.py:111", "launches": counts["maxsim"],
         "max_abs_err": main_k2["max_abs_err"], "ms": main_k2["ms"], "plain_ms": main_k2["plain_ms"],
         "shape": main_k2["case"]},
    ]
    log(f"total wall s {time.perf_counter() - t_all:.3f}")
    log(json.dumps({"cases": all_cases}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
