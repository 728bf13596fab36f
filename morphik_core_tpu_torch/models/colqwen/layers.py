"""Shared transformer building blocks, PyTorch port of
`morphik_core_tpu/models/colqwen/layers.py` (the bf16/f32 path and the
W8A8 matmuls, `:15-120, 161-173`; the int8 QK^T attention is not ported).

Numerics follow the reference: RMSNorm in f32, split-half rotary in the
input dtype, f32 softmax. Weights keep the JAX (K, N) layout: `x @ w`.

W8A8: a `QuantizedWeight` is the JAX `{"q8", "s"[, "as"]}` leaf. The
int8 x int8 product is exact int32 (`torch._int_mm`, a library GEMM as
the reference's is XLA's). cuBLASLt takes it only for M > 16 rows and K,
N multiples of 8, so the leaf stores q8 zero-padded to multiples of 8
(the 3B vision MLP's 3420 becomes 3424) and the product pads x's rows and
columns with zeros and slices the output: zeros add nothing to an
integer sum, so every entry is the reference's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# The reference quantizes and serves under `jax.jit`, where XLA rewrites
# `max / 127.0` into `max * f32(1 / 127)`; the port computes that compiled
# form (it differs from the division in the last bit of some scales).
# The data-dependent `x / scale` stays a true division on both sides.
_INV_127 = float(np.float32(1.0 / 127.0))
_INT_MM_ALIGN = 8  # cuBLASLt int8 GEMM: K and N multiples of 8
_INT_MM_MIN_ROWS = 17  # and M > 16


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class QuantizedWeight(nn.Module):
    """Symmetric per-output-channel int8 weight: `q8` (K, N) int8 stored
    zero-padded to (round8(K), round8(N)), `s` (N,) f32 scales, and the
    optional calibrated static activation scale `a_scale` (f32 scalar,
    the JAX leaf's "as").

    `q8` is column-major (an (N, K) buffer seen transposed): against a
    row-major weight cuBLASLt runs an Ampere WMMA int8 kernel 4-6x
    slower than the mma.sync kernel it picks for this layout on an H100
    (PERF.md)."""

    def __init__(self, k: int, n: int, device):
        super().__init__()
        self.k, self.n = k, n
        kp, np_ = _round_up(k, _INT_MM_ALIGN), _round_up(n, _INT_MM_ALIGN)
        self.register_buffer("q8", torch.zeros((np_, kp), dtype=torch.int8, device=device).t())
        self.register_buffer("s", torch.ones((n,), dtype=torch.float32, device=device))
        self.register_buffer("a_scale", None)

    @classmethod
    def from_float(cls, w: torch.Tensor) -> "QuantizedWeight":
        out = cls(w.shape[0], w.shape[1], device=w.device)
        out.load(*quantize_weight_int8(w))
        return out

    @torch.no_grad()
    def load(self, q8: torch.Tensor, s: torch.Tensor, a_scale: Optional[torch.Tensor] = None) -> None:
        """Fill from unpadded (K, N) int8 and (N,) f32 (and a scalar)."""
        if tuple(q8.shape) != (self.k, self.n) or tuple(s.shape) != (self.n,):
            raise ValueError(f"q8 {tuple(q8.shape)} / s {tuple(s.shape)} != ({self.k}, {self.n})")
        dev = self.q8.device
        self.q8[: self.k, : self.n] = q8.to(device=dev, dtype=torch.int8)
        self.s.copy_(s.to(device=dev, dtype=torch.float32))
        self.set_act_scale(a_scale)

    def set_act_scale(self, a_scale) -> None:
        """Attach (a scalar) or drop (None) the static activation scale."""
        self.a_scale = None if a_scale is None else torch.as_tensor(
            a_scale, dtype=torch.float32, device=self.q8.device).reshape(())


def quantize_weight_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a (K, N) or stacked (L, K, N)
    weight -> (q8 int8, s f32 (..., N)), bit for bit the reference's."""
    wf = w.float()
    s = wf.abs().amax(dim=-2) * _INV_127
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(wf / s.unsqueeze(-2)), -127, 127).to(torch.int8)
    return q, s


def quantize_act_int8(x: torch.Tensor, a_scale: Optional[torch.Tensor] = None):
    """Symmetric int8 activations: per-token dynamic scales (a_scale None)
    or one calibrated static scale (values beyond it clip at +-127).
    Returns (xq int8, xs f32: (..., 1) column or scalar)."""
    xf = x.float()
    if a_scale is not None:
        xs = a_scale.float()
        return torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8), xs
    ax = xf.abs().amax(dim=-1, keepdim=True)
    xs = torch.where(ax == 0, torch.ones_like(ax), ax * _INV_127)
    return torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8), xs


def int8_dot(xq: torch.Tensor, w: QuantizedWeight) -> torch.Tensor:
    """Exact int32 (..., K) x (K, N) product through `torch._int_mm`,
    padding x to the leaf's aligned K and to > 16 rows."""
    lead = xq.shape[:-1]
    x2 = xq.reshape(-1, xq.shape[-1])
    m = x2.shape[0]
    pad_k = w.q8.shape[0] - w.k
    pad_m = max(0, _INT_MM_MIN_ROWS - m)
    if pad_k or pad_m:
        x2 = F.pad(x2, (0, pad_k, 0, pad_m))
    acc = torch._int_mm(x2, w.q8)
    return acc[:m, : w.n].reshape(*lead, w.n)


def _dequant(acc, xs, w: QuantizedWeight, b, dtype):
    out = acc.float() * xs * w.s
    if b is not None:
        out = out + b.float()
    return out.to(dtype)


def q8_matmul(x: torch.Tensor, w: QuantizedWeight, b=None, a_scale=None) -> torch.Tensor:
    """W8A8 matmul in the reference's order: quantize x, exact int32
    dot, `acc * xs * ws`, `+ b`, cast to x's dtype."""
    xq, xs = quantize_act_int8(x, a_scale)
    return _dequant(int8_dot(xq, w), xs, w, b, x.dtype)


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatches on the weight's form: a tensor runs in x's dtype, a
    `QuantizedWeight` the W8A8 path (with its static scale, if any)."""
    if isinstance(w, QuantizedWeight):
        return q8_matmul(x, w, b, w.a_scale)
    out = x @ w
    return out if b is None else out + b


def linear_multi(x: torch.Tensor, ws: Sequence, bs: Sequence) -> List[torch.Tensor]:
    """Several matmuls over one input (q/k/v, gate/up); W8A8 leaves share
    one activation quantization, with the first leaf's static scale."""
    if all(isinstance(w, QuantizedWeight) for w in ws):
        xq, xs = quantize_act_int8(x, ws[0].a_scale)
        return [_dequant(int8_dot(xq, w), xs, w, b, x.dtype) for w, b in zip(ws, bs)]
    return [linear(x, w, b) for w, b in zip(ws, bs)]


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
    g, u = linear_multi(x, (gate_w, up_w), (gate_b, up_b))
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
