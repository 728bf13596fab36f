"""Qwen2.5-VL vision tower, PyTorch port of
`morphik_core_tpu/models/colqwen/vision.py` (bf16/f32 and W8A8).

Every page sits on a static grid bucket whose llm-grid dims are
multiples of the 4-unit window, so the windowed blocks run
`ops.window_attention` (K3 on the card) over (B*S, heads, head_dim)
rows, 64-row windows contiguous in window order, and the window
permutation is a reshape/transpose. Python picks full or window
attention per block from `fullatt_block_indexes` (the reference's
`lax.cond`, or its static branch in the unrolled int8 tower).

The int8 tower's blocks hold `QuantizedWeight` leaves, each block its
own static activation scales once calibrated (the reference's unrolled
int8 tower, `vision.py:229-237`). For calibration, `VisionTower.forward(
..., capture=True)` returns the per-site activation maxima instead of
the merged output, in the reference's capture order.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from morphik_core_tpu_torch.models.colqwen.config import VisionConfig
from morphik_core_tpu_torch.models.colqwen.layers import (
    QuantizedWeight,
    apply_rotary,
    attention,
    linear,
    linear_multi,
    rms_norm,
)
from morphik_core_tpu_torch.ops.window_attention import window_attention


@functools.lru_cache(maxsize=64)
def vision_rotary_cos_sin(h_units: int, w_units: int, cfg: VisionConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy mirror: (S, head_dim) cos/sin for every patch, in WINDOW order."""
    m = cfg.spatial_merge_size
    wu = cfg.window_units
    if h_units % wu or w_units % wu or h_units == 0 or w_units == 0:
        raise ValueError(
            f"grid ({h_units},{w_units}) must be positive multiples of window_units={wu} "
            f"(resize images to multiples of {wu * m * cfg.patch_size} px)"
        )
    h, w = h_units * m, w_units * m
    hpos = np.arange(h)[:, None].repeat(w, 1)
    wpos = np.arange(w)[None, :].repeat(h, 0)

    def unit_order(x):
        return x.reshape(h_units, m, w_units, m).transpose(0, 2, 1, 3)

    hpos, wpos = unit_order(hpos), unit_order(wpos)

    def win_order(x):
        return (
            x.reshape(h_units // wu, wu, w_units // wu, wu, m, m)
            .transpose(0, 2, 1, 3, 4, 5)
            .reshape(-1)
        )

    hpos, wpos = win_order(hpos), win_order(wpos)
    half = cfg.head_dim // 2
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, half, 2, dtype=np.float64) / half))
    freqs = np.concatenate(
        [hpos[:, None] * inv_freq[None, :], wpos[:, None] * inv_freq[None, :]], axis=1
    )  # (S, half)
    emb = np.concatenate([freqs, freqs], axis=1)  # (S, head_dim)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def to_window_order(x: torch.Tensor, h_units: int, w_units: int, wu: int) -> torch.Tensor:
    """(B, S, ...) patch order -> window order (reshape/transpose)."""
    b, s = x.shape[0], x.shape[1]
    rest = tuple(x.shape[2:])
    mu = s // (h_units * w_units)
    x = x.reshape(b, h_units // wu, wu, w_units // wu, wu, mu, *rest)
    return torch.movedim(x, 3, 2).reshape(b, s, *rest)


def from_window_order(x: torch.Tensor, h_units: int, w_units: int, wu: int) -> torch.Tensor:
    """Inverse of `to_window_order` at merged-unit granularity."""
    b, u = x.shape[0], x.shape[1]
    rest = tuple(x.shape[2:])
    x = x.reshape(b, h_units // wu, w_units // wu, wu, wu, *rest)
    return torch.movedim(x, 2, 3).reshape(b, u, *rest)


def _param(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


def _weight(k: int, n: int, device, dtype, int8: bool):
    """A (K, N) matmul weight: a parameter, or an int8 leaf to fill."""
    return QuantizedWeight(k, n, device=device) if int8 else _param(k, n, device=device, dtype=dtype)


def _amax(x: torch.Tensor) -> torch.Tensor:
    return x.float().abs().amax()


class VisionBlock(nn.Module):
    """One vision block; parameter names follow the JAX tree's
    `visual/blocks/<name>` leaves, one layer's slice each."""

    def __init__(self, cfg: VisionConfig, device, dtype, int8: bool = False):
        super().__init__()
        self.cfg = cfg
        h, ih = cfg.hidden_size, cfg.intermediate_size
        p = functools.partial(_param, device=device, dtype=dtype)
        w = functools.partial(_weight, device=device, dtype=dtype, int8=int8)
        self.norm1, self.norm2 = p(h), p(h)
        self.q_w, self.k_w, self.v_w, self.proj_w = w(h, h), w(h, h), w(h, h), w(h, h)
        self.q_b, self.k_b, self.v_b, self.proj_b = p(h), p(h), p(h), p(h)
        self.gate_w, self.up_w, self.down_w = w(h, ih), w(h, ih), w(ih, h)
        self.gate_b, self.up_b, self.down_b = p(ih), p(ih), p(h)

    def forward(self, x, is_full: bool, cos, sin, stats: Optional[List[torch.Tensor]] = None):
        """`stats` given: append max|x| at the four matmul inputs (qkv,
        proj, gate/up, down) and then (max|q|, max|k|) after rotary."""
        cfg = self.cfg
        b, s, h = x.shape
        nh, hd = cfg.num_heads, cfg.head_dim
        win = cfg.window_units**2 * cfg.merge_unit  # patches per window (64)
        y1 = rms_norm(x, self.norm1, cfg.rms_norm_eps)
        q, k, v = linear_multi(y1, (self.q_w, self.k_w, self.v_w), (self.q_b, self.k_b, self.v_b))
        q, k = apply_rotary(q.reshape(b, s, nh, hd), k.reshape(b, s, nh, hd),
                            cos[None, :, None, :], sin[None, :, None, :])
        v = v.reshape(b, s, nh, hd)
        if is_full:
            o = attention(q, k, v)
        else:
            o = window_attention(q.reshape(b * s, nh, hd), k.reshape(b * s, nh, hd),
                                 v.reshape(b * s, nh, hd), window=win)
        o = o.reshape(b, s, h)
        x = x + linear(o, self.proj_w, self.proj_b)
        y2 = rms_norm(x, self.norm2, cfg.rms_norm_eps)
        g, u = linear_multi(y2, (self.gate_w, self.up_w), (self.gate_b, self.up_b))
        mid = F.silu(g) * u
        if stats is not None:
            stats.extend([torch.stack([_amax(t) for t in (y1, o, y2, mid)]),
                          torch.stack([_amax(q), _amax(k)])])
        return x + linear(mid, self.down_w, self.down_b)


class Merger(nn.Module):
    def __init__(self, cfg: VisionConfig, device, dtype):
        super().__init__()
        h = cfg.hidden_size
        mh = h * cfg.merge_unit
        p = functools.partial(_param, device=device, dtype=dtype)
        self.ln_q = p(h)
        self.fc1_w, self.fc1_b = p(mh, mh), p(mh)
        self.fc2_w, self.fc2_b = p(mh, cfg.out_hidden_size), p(cfg.out_hidden_size)


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig, device, dtype, int8: bool = False):
        super().__init__()
        self.cfg = cfg
        self.patch_embed_w = _param(cfg.patch_input_dim, cfg.hidden_size, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(VisionBlock(cfg, device, dtype, int8) for _ in range(cfg.depth))
        self.merger = Merger(cfg, device, dtype)

    def forward(self, patches, cos, sin, h_units: int, w_units: int, capture: bool = False):
        """patches (B, S, patch_input_dim), cos/sin (S, head_dim) in window
        order -> merged visual embeddings (B, U, out_hidden) in row-major
        llm-grid unit order. `capture=True` stops after the blocks and
        returns the calibration maxima instead: ((depth, 4) max|x| at the
        qkv, proj, gate/up and down inputs; (depth, 2) max|q|, max|k|)."""
        cfg = self.cfg
        wu = cfg.window_units
        if h_units % wu or w_units % wu:
            raise ValueError(f"grid ({h_units},{w_units}) must be multiples of window_units={wu}")
        x = to_window_order(patches @ self.patch_embed_w, h_units, w_units, wu)
        full = set(cfg.fullatt_block_indexes or ())
        stats: Optional[List[torch.Tensor]] = [] if capture else None
        for li, blk in enumerate(self.blocks):
            x = blk(x, li in full, cos, sin, stats)
        if stats is not None:
            return torch.stack(stats[0::2]), torch.stack(stats[1::2])
        b, s, h = x.shape
        m = self.merger
        y = rms_norm(x, m.ln_q, 1e-6).reshape(b, s // cfg.merge_unit, cfg.merge_unit * h)
        y = F.gelu(y @ m.fc1_w + m.fc1_b, approximate="none")
        y = y @ m.fc2_w + m.fc2_b
        return from_window_order(y, h_units, w_units, wu)
