"""MaxSim late-interaction scoring, PyTorch port of
`morphik_core_tpu/ops/maxsim.py`.

score(Q, D) = sum_{q in Q} max_{d in D} <q, d>

Two kernels carry it on the card (`csrc/maxsim.cu`):
- `maxsim_q8` (K1): int8 query x int8 doc tokens, exact int32 dot, then
  per-doc-token and per-query-token scales;
- `maxsim` (K2): f32 query against f32/bf16 doc tokens.
Each wrapper checks its inputs, then dispatches on the device of the
tensors: a CPU tensor goes to the plain PyTorch version beside it, a
CUDA tensor launches the kernel (or raises). `use_kernel=False` runs the
plain version on the card instead: the reference's `use_pallas=False`,
which the index takes from `tpu.use_pallas`. Both versions take an
optional int32 row-index vector, so a gather over a larger buffer
never materialises (C, Np, D). On the card a call runs a grid of
(candidate, doc-token split, query tile) blocks that `maxsim_plan`
picks, then a pass that merges the splits in a fixed order.

Kernel semantics (which the plain versions share): masked doc tokens
score -1e30, per-(candidate, query token) maxima at or below -5e29 are
zeroed, so a fully masked candidate (or index -1) scores 0, and a zero
query row adds 0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from morphik_core_tpu_torch.device import default_device
from morphik_core_tpu_torch.ops import _kernels
from morphik_core_tpu_torch.parallel.search import quantize_rows_int8, topk_stable

NEG_INF = -1.0e30
_CLAMP = NEG_INF * 0.5


# The kernels' launch plan (csrc/maxsim.cu): a block scores one query
# tile (<= 64 tokens, resident in shared memory) against one split of a
# candidate's doc tokens. Splits are multiples of 16 tokens (one warp's
# rows), and a call aims at two blocks per SM of an H100 (132 SMs).
TARGET_BLOCKS = 264
SPLIT_GRANULE = 16
QUERY_TILE_BYTES = 64 * 1024  # shared memory for the resident query tile


class MaxSimPlan(NamedTuple):
    q_tile: int  # query tokens per block
    n_qtiles: int
    tok_per_split: int  # doc tokens per block (the last split may hold fewer)
    n_splits: int


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _cdiv(x: int, m: int) -> int:
    return -(-x // m)


def maxsim_plan(n_cand: int, np_: int, nq: int, dim: int, q_bytes: int) -> MaxSimPlan:
    """Grid of the K1/K2 kernels for C candidates of Np doc tokens and NQ
    query tokens of width D. `q_bytes` is the shared-memory bytes of one
    query value: 1 for K1 (int8), 4 for K2 (bf16 hi + lo). A small C
    spreads each candidate's tokens over splits until the grid reaches
    TARGET_BLOCKS (or one split per SPLIT_GRANULE tokens); a C that fills
    the card alone keeps one split."""
    q_tile = 64
    while q_tile * dim * q_bytes > QUERY_TILE_BYTES and q_tile > 16:
        q_tile //= 2
    if q_tile * dim * q_bytes > QUERY_TILE_BYTES:
        raise ValueError(f"maxsim kernels take D <= {QUERY_TILE_BYTES // (16 * q_bytes)}, got {dim}")
    n_qtiles = _cdiv(nq, q_tile)
    want = _cdiv(TARGET_BLOCKS, max(1, n_cand * n_qtiles))
    if want <= 1 or np_ <= SPLIT_GRANULE:
        return MaxSimPlan(q_tile, n_qtiles, max(np_, 1), 1)
    tok = max(SPLIT_GRANULE, _cdiv(np_, want) // SPLIT_GRANULE * SPLIT_GRANULE)
    return MaxSimPlan(q_tile, n_qtiles, tok, _cdiv(np_, tok))


def pad_multivectors(
    mvs: Sequence[np.ndarray],
    token_bucket: Optional[int] = None,
    dim: Optional[int] = None,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy mirror: pack a ragged list of (n_i, dim) multivectors into
    a dense (C, N_pad, dim) array + validity mask (C, N_pad); N_pad
    defaults to max n rounded up to 128."""
    if not len(mvs):
        raise ValueError("empty multivector list")
    d = dim or mvs[0].shape[-1]
    max_n = max(int(m.shape[0]) for m in mvs)
    n_pad = token_bucket if token_bucket is not None else _round_up(max_n, 128)
    if n_pad < max_n:
        raise ValueError(f"token_bucket {n_pad} < longest multivector {max_n}")
    c = len(mvs)
    out = np.zeros((c, n_pad, d), dtype=dtype)
    mask = np.zeros((c, n_pad), dtype=np.float32)
    for i, m in enumerate(mvs):
        n = int(m.shape[0])
        out[i, :n] = np.asarray(m, dtype=dtype)
        mask[i, :n] = 1.0
    return out, mask


def maxsim_scores_ref(
    query: torch.Tensor, docs: torch.Tensor, doc_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain MaxSim in f32, as the JAX reference computes it (no clamp:
    a fully masked candidate scores about -nq * 1e30). query (Nq, D),
    docs (C, Nd, D), doc_mask (C, Nd) -> (C,) f32."""
    q = query.float()
    d = docs.float()
    sim = torch.einsum("qd,cnd->cqn", q, d)
    if doc_mask is not None:
        sim = torch.where(doc_mask[:, None, :] > 0, sim, torch.full_like(sim, NEG_INF))
    return sim.amax(dim=-1).sum(dim=-1)


def _clamped_sum(sim: torch.Tensor, token_dim: int) -> torch.Tensor:
    """Max over doc tokens (axis `token_dim` of a (C, ., .) score tensor),
    entries <= -5e29 -> 0 as the kernels clamp them, sum over query tokens."""
    if sim.shape[token_dim]:
        per_q = sim.amax(dim=token_dim)
    else:  # no doc tokens at all: every candidate is fully masked
        per_q = sim.new_full((sim.shape[0], sim.shape[3 - token_dim]), NEG_INF)
    return torch.where(per_q <= _CLAMP, torch.zeros_like(per_q), per_q).sum(dim=-1)


def _gather(idx: Optional[torch.Tensor], *arrays: torch.Tensor):
    """Rows idx of each array (idx < 0 -> row 0, masked by the caller)."""
    if idx is None:
        return arrays
    safe = idx.clamp(min=0).long()
    return tuple(a[safe] for a in arrays)


def maxsim_plain(query, docs, mask, idx=None) -> torch.Tensor:
    """Plain version of K2: `maxsim_scores_ref` with the kernel's clamp."""
    d, m = _gather(idx, docs, mask)
    if idx is not None:
        m = m * (idx >= 0).to(m.dtype)[:, None]
    sim = torch.einsum("qd,cnd->cqn", query.float(), d.float())
    sim = torch.where(m[:, None, :] > 0, sim, torch.full_like(sim, NEG_INF))
    return _clamped_sum(sim, token_dim=2)


def maxsim_q8_plain(q8, qs, d8, ds, mask, idx=None) -> torch.Tensor:
    """Plain version of K1. `d8.float() @ q8.float().T` is exact in f32
    (|sum| <= D * 127^2 < 2^24 for D <= 1040, with TF32 off), so every
    per-token product f32(s32) * ds * qs equals the kernel's; only the
    final sum over query tokens may differ by f32 reordering."""
    d, s, m = _gather(idx, d8, ds, mask)
    if idx is not None:
        m = m * (idx >= 0).to(m.dtype)[:, None]
    s32 = torch.matmul(d.float(), q8.float().T)  # (C, Np, NQ), exact integers
    sim = s32 * s[:, :, None] * qs.reshape(1, 1, -1)
    sim = torch.where(m[:, :, None] > 0, sim, torch.full_like(sim, NEG_INF))
    return _clamped_sum(sim, token_dim=1)


def _check(name, t, dtypes, ndim, dev):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got shape {tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if dev.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(docs, mask, idx, dev):
    rows, np_ = docs.shape[0], docs.shape[1]
    _check("mask", mask, (torch.float32,), 2, dev)
    if tuple(mask.shape) != (rows, np_):
        raise ValueError(f"mask shape {tuple(mask.shape)} != {(rows, np_)}")
    if idx is not None:
        _check("idx", idx, (torch.int32,), 1, dev)
    return rows if idx is None else idx.shape[0]


def maxsim_q8(q8, qs, d8, ds, mask, idx=None, use_kernel: bool = True) -> torch.Tensor:
    """K1 wrapper, the twin of `_maxsim_pallas_q8` over already-padded
    device tensors. q8 (NQ, D) int8, qs (NQ,) or (1, NQ) f32, d8 (R, Np, D)
    int8, ds and mask (R, Np) f32, idx (C,) int32 or None (C = R).
    Returns (C,) f32; `use_kernel=False` takes the plain version."""
    dev = d8.device
    _check("d8", d8, (torch.int8,), 3, dev)
    _check("q8", q8, (torch.int8,), 2, dev)
    qs = qs.reshape(-1)
    _check("qs", qs, (torch.float32,), 1, dev)
    _check("ds", ds, (torch.float32,), 2, dev)
    if q8.shape[1] != d8.shape[2] or qs.shape[0] != q8.shape[0]:
        raise ValueError(f"query {tuple(q8.shape)} / scales {tuple(qs.shape)} vs docs {tuple(d8.shape)}")
    if tuple(ds.shape) != tuple(d8.shape[:2]):
        raise ValueError(f"ds shape {tuple(ds.shape)} != {tuple(d8.shape[:2])}")
    c = _check_common(d8, mask, idx, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cpu" or not use_kernel:
        return maxsim_q8_plain(q8, qs, d8, ds, mask, idx)
    if d8.shape[2] % 4:
        raise ValueError(f"maxsim_q8 kernel needs D % 4 == 0, got {d8.shape[2]}")
    plan = maxsim_plan(c, d8.shape[1], q8.shape[0], d8.shape[2], q_bytes=1)
    out = torch.empty(c, dtype=torch.float32, device=dev)
    part = torch.empty(c * plan.n_splits * q8.shape[0], dtype=torch.float32, device=dev)
    _kernels.launch_maxsim_q8(q8, qs, d8, ds, mask, idx, part, out, plan)
    return out


def maxsim(query, docs, mask, idx=None, use_kernel: bool = True) -> torch.Tensor:
    """K2 wrapper, the twin of `_maxsim_pallas`. query (NQ, D) f32, docs
    (R, Np, D) f32 or bf16, mask (R, Np) f32, idx (C,) int32 or None.
    Returns (C,) f32; `use_kernel=False` takes the plain version."""
    dev = docs.device
    _check("docs", docs, (torch.float32, torch.bfloat16), 3, dev)
    _check("query", query, (torch.float32,), 2, dev)
    if query.shape[1] != docs.shape[2]:
        raise ValueError(f"query {tuple(query.shape)} vs docs {tuple(docs.shape)}")
    c = _check_common(docs, mask, idx, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cpu" or not use_kernel:
        return maxsim_plain(query, docs, mask, idx)
    plan = maxsim_plan(c, docs.shape[1], query.shape[0], docs.shape[2], q_bytes=4)
    out = torch.empty(c, dtype=torch.float32, device=dev)
    part = torch.empty(c * plan.n_splits * query.shape[0], dtype=torch.float32, device=dev)
    _kernels.launch_maxsim(query, docs, mask, idx, part, out, plan)
    return out


def maxsim_scores(query, docs, doc_mask=None, use_kernel: bool = True) -> torch.Tensor:
    """MaxSim scores of `query` (Nq, D) against `docs` (C, Nd, D) on the
    docs' device (K2 on CUDA). Invalid query rows must be zero."""
    docs = docs.contiguous()
    if doc_mask is None:
        doc_mask = torch.ones(docs.shape[:2], dtype=torch.float32, device=docs.device)
    q = torch.as_tensor(query, dtype=torch.float32, device=docs.device).contiguous()
    return maxsim(q, docs, doc_mask.float().contiguous(), use_kernel=use_kernel)


def quantize_pool_int8(mvs: Sequence[np.ndarray], token_bucket: Optional[int] = None):
    """Numpy mirror: per-token int8 quantization of a ragged pool.
    Returns (q8 (C, N_pad, D) int8, scales (C, N_pad) f32, mask)."""
    dense, mask = pad_multivectors(mvs, token_bucket=token_bucket)
    q8, scales = quantize_rows_int8(dense)
    return q8, scales, mask


def quantize_query_q8(query, nq_pad: Optional[int] = None):
    """Numpy mirror: row-quantize a query multivector and zero-pad to
    `nq_pad` rows (default: round up to 8).
    Returns (q8 (NQ_pad, D) int8, qs (1, NQ_pad) f32)."""
    q = np.asarray(query, dtype=np.float32)
    q8_host, qs_host = quantize_rows_int8(q)
    nq = q8_host.shape[0]
    nq_pad = nq_pad or _round_up(max(nq, 8), 8)
    q8 = np.zeros((nq_pad, q.shape[1]), np.int8)
    q8[:nq] = q8_host
    qs = np.zeros((1, nq_pad), np.float32)
    qs[0, :nq] = qs_host
    return q8, qs


def maxsim_scores_q8(query, docs_q8, doc_scales, doc_mask, device=None, use_kernel: bool = True) -> torch.Tensor:
    """MaxSim over per-token int8-quantized candidates (K1 on CUDA). The
    float query is row-quantized on the host (`quantize_query_q8`).
    Candidates may be numpy arrays or tensors; they are scored on
    `device` (default: their own device, or the card for numpy)."""
    if device is None:
        device = docs_q8.device if isinstance(docs_q8, torch.Tensor) else default_device()
    q8, qs = quantize_query_q8(query)

    def dev(x, dt):
        return torch.as_tensor(x, device=device).to(dt).contiguous()

    return maxsim_q8(
        dev(q8, torch.int8), dev(qs, torch.float32), dev(docs_q8, torch.int8),
        dev(doc_scales, torch.float32), dev(doc_mask, torch.float32), use_kernel=use_kernel,
    )


def maxsim_topk(query, docs, doc_mask=None, k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k candidates by MaxSim, ties to the lower index (as
    `jax.lax.top_k`). Returns (scores, indices)."""
    scores = maxsim_scores(query, docs, doc_mask)
    return topk_stable(scores, min(k, scores.shape[0]))
