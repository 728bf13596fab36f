"""Blocked ANN scan + pooled-tier rescore, on one device and on a mesh.
PyTorch port of `morphik_core_tpu/parallel/search.py`.

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

The mesh searches (`make_sharded_search`, `make_mesh_block_search`,
`make_mesh_block_search_pooled`) are plain functions over lists of
per-shard tensors, one list entry a data shard in device order, each on
its own device (`parallel/mesh.py`); replicated inputs are copied to each
shard's device. Each shard scans its rows, takes a local top-k, and the
lists merge by one gather onto the mesh's first device
(`parallel/collectives.py`) and a top-k there. Global row ids are `b * B + d * n_local + i`
(block b of B rows, data shard d of n_local rows, local row i).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from morphik_core_tpu_torch.parallel.collectives import broadcast, gather

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


def _replicate(shards, *tensors) -> list:
    """The replicated inputs on each shard's device: one tuple a shard."""
    devs = [t.device for t in shards]
    return list(zip(*(broadcast(t, devs) for t in tensors)))


def _check_shards(name: str, shards, n: int) -> None:
    if len(shards) != n:
        raise ValueError(f"{name}: {len(shards)} shards for a data axis of {n}")


def make_sharded_search(mesh, k: int):
    """Search over a row-sharded matrix: (F shards (n_local, D), q (D,),
    mask shards (n_local,)) -> (top-k scores, global row ids) on the
    mesh's first device."""
    ndev = mesh.n_data

    def search(f_shards, q, mask_shards):
        _check_shards("F", f_shards, ndev)
        vs, gis = [], []
        for d, (f, m, (qd,)) in enumerate(zip(f_shards, mask_shards, _replicate(f_shards, q))):
            scores = f @ qd
            v, i = topk_stable(torch.where(m > 0, scores, torch.full_like(scores, float("-inf"))), k)
            vs.append(v)
            gis.append(i + d * f.shape[0])
        v_all, i_all = gather(vs), gather(gis)
        vm, im = topk_stable(v_all, k)
        return vm, i_all[im]

    return search


def _shard_scan(d, n_blocks, ndev, k_of, score_fn, masks, codes, allowed):
    """Data shard d's scan of its slice of every block: (scores, global
    ids, local ids) of each block's local top-`k_of(n_local)`."""
    out = []
    for b in range(n_blocks):
        scores = score_fn(b)
        n_local = scores.shape[0]
        v, i = topk_stable(_gate(scores, masks[b][d], codes[b][d], allowed), k_of(n_local))
        out.append((v, i + b * n_local * ndev + d * n_local, i))
    return out


def make_mesh_block_search(mesh, n_blocks: int, k: int, quantized: bool):
    """Blocked + sharded ANN search: block b is a list of row shards, data
    shard d holding rows [b B + d n_local, b B + (d+1) n_local). Each shard
    scans its slice of every block, keeps its top-k, and the shards' lists
    merge by one gather onto the first device. Returns a function
      quantized: (qq, qs, allowed, blocks_q8, scales, masks, codes)
      float:     (q,      allowed, blocks,            masks, codes)
    -> packed [top-k scores | global row ids] on the mesh's first device."""
    ndev = mesh.n_data

    def merge(per_shard):
        vs, gis = [], []
        for lists in per_shard:
            v, sel = topk_stable(torch.cat([x[0] for x in lists]), k)
            vs.append(v)
            gis.append(torch.cat([x[1] for x in lists])[sel])
        v_all, i_all = gather(vs), gather(gis)
        vm, im = topk_stable(v_all, k)
        return _pack(vm, i_all[im])

    if quantized:

        def search_q(qq, qs, allowed, blocks, scales, masks, codes):
            _check_shards("blocks", blocks[0], ndev)
            per_shard = []
            for d, (qqd, qsd, ad) in enumerate(_replicate(blocks[0], qq, qs, allowed)):
                per_shard.append(_shard_scan(
                    d, n_blocks, ndev, lambda n: k,
                    lambda b: int8_matvec(blocks[b][d], qqd).float() * scales[b][d] * qsd, masks, codes, ad))
            return merge(per_shard)

        return search_q

    def search_f(q, allowed, blocks, masks, codes):
        _check_shards("blocks", blocks[0], ndev)
        per_shard = []
        for d, (qd, ad) in enumerate(_replicate(blocks[0], q, allowed)):
            per_shard.append(_shard_scan(
                d, n_blocks, ndev, lambda n: k,
                lambda b: (blocks[b][d] @ qd.to(blocks[b][d].dtype)).float(), masks, codes, ad))
        return merge(per_shard)

    return search_f


def make_mesh_block_search_pooled(mesh, n_blocks: int, pool: int, pool_true: int, m: int, guard: int,
                                  use_kernel: bool = True):
    """Mesh twin of `scan_blocks_topk_q_pooled` (reference `:353-450`):
    sharded int8 ANN scan + pooled-tier rescore + union guard. Each shard
    keeps its local FDE top-`pool` and rescores exactly those rows against
    its own shard of the pooled tier through K1 (`maxsim_q8` with local
    row indices; a fully masked row scores 0), so the pooled rows never
    cross devices. One gather of (FDE score, pooled score, global id)
    triples follows; the merge takes the global FDE top-`pool_true` (the
    exact configured pool, not the padded `pool`), adds the +1e6 union
    guard to the first `guard`, and keeps the top `m` by that score.
    int8 ANN blocks only. Returns a function
      (qq, qs, allowed, blocks_q8, scales, masks, codes,
       pblocks, pscales, pmasks, q8p, qsp)
    -> packed [scores (m,) | global ids (m,)] on the mesh's first device.
    `use_kernel=False` scores with K1's plain version."""
    from morphik_core_tpu_torch.ops.maxsim import maxsim_q8

    ndev = mesh.n_data

    def search(qq, qs, allowed, blocks, scales, masks, codes, pblocks, pscales, pmasks, q8p, qsp):
        _check_shards("blocks", blocks[0], ndev)
        vs, gis, ps = [], [], []
        for d, (qqd, qsd, ad, q8d, qspd) in enumerate(_replicate(blocks[0], qq, qs, allowed, q8p, qsp)):
            lists = _shard_scan(
                d, n_blocks, ndev, lambda n: min(pool, n),
                lambda b: int8_matvec(blocks[b][d], qqd).float() * scales[b][d] * qsd, masks, codes, ad)
            p = torch.cat([maxsim_q8(q8d, qspd, pblocks[b][d], pscales[b][d], pmasks[b][d],
                                     local.to(torch.int32), use_kernel=use_kernel)
                           for b, (_, _, local) in enumerate(lists)])
            v, sel = topk_stable(torch.cat([x[0] for x in lists]), min(pool, sum(x[0].shape[0] for x in lists)))
            vs.append(v)
            gis.append(torch.cat([x[1] for x in lists])[sel])
            ps.append(p[sel])
        v_all, i_all, p_all = (gather(x) for x in (vs, gis, ps))
        kp = min(pool_true, v_all.shape[0])
        vm, sel = topk_stable(v_all, kp)
        im, total = i_all[sel], p_all[sel]
        pos = torch.arange(kp, device=total.device)
        if guard > 0:
            total = total + torch.where(pos < guard, 1e6, 0.0)
        total = torch.where(torch.isfinite(vm), total, torch.full_like(total, float("-inf")))
        vals, top = topk_stable(total, min(m, kp))
        return _pack(vals, im[top])

    return search


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

