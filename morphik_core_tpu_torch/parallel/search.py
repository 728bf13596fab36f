"""Blocked ANN scan + pooled-tier rescore, single device. PyTorch port of
`morphik_core_tpu/parallel/search.py:80-261, 453-473`.

The FDE matrix lives in fixed-size device blocks; a query scores every
block (one matvec each), takes a per-block top-k, and merges. The
int8 variant keeps the reference's exact int32 dot. The pooled stage
rescores the ANN pool by MaxSim over the device-resident pooled int8
tier through the K1 kernel (`ops/maxsim.py::maxsim_q8`), gathering the
candidate rows inside the kernel. Results travel as one packed
`[scores | ids]` f32 tensor (ids are exact in f32 below 2^24 rows).

Top-k ties go to the lower index, as `jax.lax.top_k` orders them: a
stable descending sort, never `torch.topk`, whose tie order is not
specified.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Largest contraction whose int8 x int8 dot stays exact in f32:
# 1024 * 127 * 127 < 2^24.
_EXACT_F32_CHUNK = 1024


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries, ties to the lower index."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def int8_matvec(fq: torch.Tensor, qq: torch.Tensor) -> torch.Tensor:
    """Exact int8 (B, D) x int8 (D,) -> int32 (B,). The contraction is
    cut into chunks that are exact in f32 (TF32 is off), and the exact
    partial sums are added in int32."""
    acc = torch.zeros(fq.shape[0], dtype=torch.int32, device=fq.device)
    for d0 in range(0, fq.shape[1], _EXACT_F32_CHUNK):
        d1 = d0 + _EXACT_F32_CHUNK
        part = fq[:, d0:d1].float() @ qq[d0:d1].float()
        acc += part.to(torch.int32)
    return acc


def _gate(scores, m, c, allowed):
    gate = m * allowed[c]
    return torch.where(gate > 0, scores, torch.full_like(scores, float("-inf")))


def _merge(vs, gis, pool: int):
    v = torch.cat(vs)
    gi = torch.cat(gis)
    vm, sel = topk_stable(v, min(pool, int(v.shape[0])))
    return vm, gi[sel].to(torch.int32)


def _scan_body(blocks, masks, codes, allowed, q, k: int, pool: int):
    """Blocked float/bf16 ANN scan: per-block matvec + top-k + merge.
    Returns (scores (pool,) f32, global row ids (pool,) int32)."""
    vs, gis = [], []
    for b, (f, m, c) in enumerate(zip(blocks, masks, codes)):
        scores = (f @ q.to(f.dtype)).float()
        v, i = topk_stable(_gate(scores, m, c, allowed), k)
        vs.append(v)
        gis.append(i + b * f.shape[0])
    return _merge(vs, gis, pool)


def _scan_body_q(blocks, scales, masks, codes, allowed, qq, q_scale, k: int, pool: int):
    """int8 variant of `_scan_body` (per-row scales, exact int32 dot)."""
    vs, gis = [], []
    for b, (fq, s, m, c) in enumerate(zip(blocks, scales, masks, codes)):
        scores = int8_matvec(fq, qq).float() * s * q_scale
        v, i = topk_stable(_gate(scores, m, c, allowed), k)
        vs.append(v)
        gis.append(i + b * fq.shape[0])
    return _merge(vs, gis, pool)


def _pack(vm, gi):
    return torch.cat([vm, gi.float()])


def scan_blocks_topk(blocks, masks, codes, allowed, q, k: int, pool: int):
    """Blocked float/bf16 ANN scan -> packed [scores | ids]."""
    return _pack(*_scan_body(blocks, masks, codes, allowed, q, k, pool))


def scan_blocks_topk_q(blocks, scales, masks, codes, allowed, qq, q_scale, k: int, pool: int):
    """int8 variant of `scan_blocks_topk`."""
    return _pack(*_scan_body_q(blocks, scales, masks, codes, allowed, qq, q_scale, k, pool))


def _pooled_stage(vm, gi, pblocks, pscales, pmasks, q8p, qsp, m: int, n_valid: int,
                  guard: int = 0, use_kernel: bool = True):
    """Rescore the ANN pool (vm scores, gi global row ids) by MaxSim over
    the pooled int8 tier and keep the top `m` (packed [scores | ids]).

    pblocks: (B, T, D) int8 pooled tokens per block; pscales: (B, T) f32
    per-token scales; pmasks: (B, T) f32 validity (scale > 0). Each block
    scores the pool rows it owns through K1 with a row-index vector
    (-1 for rows of other blocks, which score exactly 0), so the sum over
    blocks keeps one real score per row. `n_valid` masks the pool's
    padding; `guard` > 0 keeps the first `guard` pool entries (the FDE
    head) through a +1e6 bonus — the union guard of the reference.
    `use_kernel=False` scores with K1's plain version."""
    from morphik_core_tpu_torch.ops.maxsim import maxsim_q8

    B = pblocks[0].shape[0]
    P_ = gi.shape[0]
    total = torch.zeros(P_, dtype=torch.float32, device=gi.device)
    for b in range(len(pblocks)):
        sel = torch.div(gi, B, rounding_mode="floor") == b
        idx = torch.where(sel, gi - b * B, torch.full_like(gi, -1)).to(torch.int32)
        total = total + maxsim_q8(q8p, qsp, pblocks[b], pscales[b], pmasks[b], idx, use_kernel=use_kernel)
    pos = torch.arange(P_, device=gi.device)
    valid = torch.isfinite(vm) & (pos < n_valid)
    if guard > 0:
        total = total + torch.where(pos < guard, 1e6, 0.0)
    total = torch.where(valid, total, torch.full_like(total, float("-inf")))
    vals, sel = topk_stable(total, min(m, P_))
    return torch.cat([vals, gi[sel].float()])


def scan_blocks_topk_q_pooled(
    blocks, scales, masks, codes, allowed, qq, q_scale,
    pblocks, pscales, pmasks, q8p, qsp,
    k: int, pool: int, m: int, guard: int = 0, use_kernel: bool = True,
):
    """int8 ANN scan + pooled-tier rescore. `pool` is the true candidate
    count; the scan pads it to a multiple of 8 and masks the padding."""
    pool8 = -(-pool // 8) * 8
    vm, gi = _scan_body_q(blocks, scales, masks, codes, allowed, qq, q_scale, k, pool8)
    return _pooled_stage(vm, gi, pblocks, pscales, pmasks, q8p, qsp, m, pool, guard, use_kernel)


def scan_blocks_topk_pooled(
    blocks, masks, codes, allowed, q,
    pblocks, pscales, pmasks, q8p, qsp,
    k: int, pool: int, m: int, guard: int = 0, use_kernel: bool = True,
):
    """float/bf16-ANN twin of `scan_blocks_topk_q_pooled`."""
    pool8 = -(-pool // 8) * 8
    vm, gi = _scan_body(blocks, masks, codes, allowed, q, k, pool8)
    return _pooled_stage(vm, gi, pblocks, pscales, pmasks, q8p, qsp, m, pool, guard, use_kernel)


def quantize_vec_int8(qe: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-side symmetric int8 quantization of one vector (round half
    to even, as `jnp.rint`). Returns (int8 (D,), f32 scalar scale)."""
    qe = qe.float()
    s = qe.abs().max() / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    q8 = torch.clamp(torch.round(qe / s), -127, 127).to(torch.int8)
    return q8, s


def quantize_rows_int8(x) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy mirror: symmetric per-row int8 quantization (host-side).
    Returns (int8 rows, float32 per-row scales)."""
    x = np.asarray(x, dtype=np.float32)
    s = np.max(np.abs(x), axis=-1) / 127.0
    s = np.where(s == 0, 1.0, s).astype(np.float32)
    q = np.clip(np.rint(x / s[..., None]), -127, 127).astype(np.int8)
    return q, s

