"""Shared transformer building blocks, PyTorch port of the bf16/f32
paths of `morphik_core_tpu/models/colqwen/layers.py:123-242`.

Numerics follow the reference: RMSNorm in f32, split-half rotary in the
input dtype, f32 softmax. Weights keep the JAX (K, N) layout: `x @ w`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    out = x @ w
    return out if b is None else out + b


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dtype)


def apply_rotary(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """q, k: (..., S, H, hd); cos/sin broadcastable (..., S, 1, hd).
    Split-half form (both Qwen tables duplicate their halves), computed
    in the input dtype: [x1*c - x2*s, x2*c + x1*s]."""
    half = q.shape[-1] // 2

    def rot(x):
        c = cos[..., :half].to(x.dtype)
        s = sin[..., :half].to(x.dtype)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    return rot(q), rot(k)


def swiglu(x, gate_w, up_w, down_w, gate_b=None, up_b=None, down_b=None) -> torch.Tensor:
    g = linear(x, gate_w, gate_b)
    u = linear(x, up_w, up_b)
    return linear(F.silu(g) * u, down_w, down_b)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention with an f32 softmax, as the reference's bf16/f32
    path. q: (..., S, Hq, hd); k/v: (..., S, Hkv, hd), GQA by head
    repeat; bias: additive, broadcastable to (..., Hq, Sq, Sk)."""
    hq, hkv = q.shape[-2], k.shape[-2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=-2)
        v = v.repeat_interleave(hq // hkv, dim=-2)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("...qhd,...khd->...hqk", q, k).float() * scale
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("...hqk,...khd->...qhd", probs, v)
