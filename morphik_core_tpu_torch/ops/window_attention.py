"""Windowed self-attention for the Qwen2.5-VL vision tower, PyTorch port
of `morphik_core_tpu/ops/window_attention.py`.

q/k/v are (T, H, D) with windows of `window` consecutive rows along T;
each window attends only to itself. One kernel carries it on the card
(`csrc/window_attention.cu`, K3, the twin of `_window_attn_kernel`):
scores and softmax in f32, probabilities normalised and then rounded to
the input dtype, PV accumulated in f32. bf16 runs both products on the
tensor cores in bf16; f32 runs them on the tensor cores in three TF32
passes (each operand split into a TF32 hi and lo, lo*hi + hi*lo + hi*hi),
which keeps a product within about 2^-21 of its f32 value. The wrapper
dispatches on the tensors' device: a CPU tensor goes to
`window_attention_plain`, a CUDA tensor launches K3 (or raises). The
reference's `block_windows` is a Mosaic tiling knob and has no
counterpart here.

Numerics: the plain version mirrors `window_attention_ref`, whose score
einsum runs in the input dtype, so in bf16 it rounds the scores to bf16
before the f32 softmax; K3 keeps them in f32 as the Pallas kernel does.
`window_attention_pallas_numerics` mirrors the Pallas kernel's rounding
instead, so K3 can be held to it tightly (tests and chip_smoke.py only).
In f32 the three agree to summation order (and K3 to its 3xTF32 split).
"""

from __future__ import annotations

import torch

from morphik_core_tpu_torch.ops import _kernels

KERNEL_MAX_WINDOW = 128
KERNEL_MAX_DIM = 128


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int) -> torch.Tensor:
    """Batched-window attention, the mirror of `window_attention_ref`."""
    t, h, d = q.shape

    def to_win(x):
        return x.reshape(t // window, window, h, d)

    scores = torch.einsum("wqhd,wkhd->whqk", to_win(q), to_win(k)).float() * d**-0.5
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("whqk,wkhd->wqhd", probs, to_win(v)).reshape(t, h, d)


def window_attention_pallas_numerics(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                     window: int) -> torch.Tensor:
    """The Pallas kernel's numerics in plain PyTorch: inputs upcast to f32,
    scores and softmax in f32, probabilities rounded to the input dtype,
    PV in f32, output rounded to the input dtype."""
    t, h, d = q.shape

    def to_win(x):
        return x.float().reshape(t // window, window, h, d)

    scores = torch.einsum("wqhd,wkhd->whqk", to_win(q), to_win(k)) * d**-0.5
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("whqk,wkhd->wqhd", probs.float(), to_win(v)).reshape(t, h, d).to(q.dtype)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int) -> torch.Tensor:
    """Windowed self-attention over contiguous `window`-row blocks.
    q/k/v: (T, H, D) f32 or bf16, one dtype and device, T % window == 0.
    Returns (T, H, D) in q's dtype. On CUDA, K3 takes D <= 128 and
    window <= 128 and raises on anything else."""
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one (T, H, D) shape, got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q/k/v must share dtype float32 or bfloat16, got {q.dtype} {k.dtype} {v.dtype}")
    t, _, d = q.shape
    if window <= 0 or t % window:
        raise ValueError(f"T={t} not a multiple of window={window}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError(f"q/k/v on {dev}, {k.device}, {v.device}")
    if dev.type == "cpu":
        return window_attention_plain(q, k, v, window=window)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if d > KERNEL_MAX_DIM or window > KERNEL_MAX_WINDOW:
        raise ValueError(f"window_attention kernel takes D <= {KERNEL_MAX_DIM} and window <= "
                         f"{KERNEL_MAX_WINDOW}, got D={d} window={window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q/k/v must be contiguous")
    out = torch.empty_like(q)
    _kernels.launch_window_attention(q, k, v, out, window)
    return out
