"""Binary quantization and Hamming MaxSim: PyTorch port of
`morphik_core_tpu/ops/binary.py`.

  - bit_i = 1 iff x_i > 0;
  - packed bytes are MSB-first (128-dim f32 -> 16 bytes);
  - Hamming similarity of two token bit-vectors = 1 - popcount(xor)/dim;
  - binary MaxSim(Q, D) = sum_q max_{d valid} (1 - hamming(q, d)/dim),
    a fully masked row scores 0.

The host half is numpy, bit-identical to the reference's; on f32 input
`binary_quantize_packed` also gives the bits of the packing the
reference's index calls (`morphik_core_tpu/utils/fast_ops.py:133-149`,
a native library), so the port's index calls it.
The score runs on the card in K4 (`csrc/binary_maxsim.cu`): the
reference computes it in one fused XLA program (`binary.py:65-86`) and
PyTorch has no popcount op, so the port's counterpart is a kernel. A CPU
tensor goes to the plain version beside it, chunked over rows so that
its intermediates stay under `PLAIN_CHUNK_BYTES`; a CUDA tensor launches
K4 (or raises). Both take each row's valid token count: the index's
masks are prefixes, and `binary_maxsim_scores` turns the reference's
float mask into counts (and refuses a mask with holes).

Exactness: every term is 1 - k/dim for an integer k; at a power-of-two
dim each is a multiple of 2^-log2(dim), so every partial sum is exact in
f32 and K4, the plain version and the JAX function agree bit for bit in
any order of summation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from morphik_core_tpu_torch.device import default_device
from morphik_core_tpu_torch.ops import _kernels

PLAIN_CHUNK_BYTES = 1024**3  # the plain version's intermediates per chunk of rows
MAX_PACKED_BYTES = 32  # K4 keeps up to 8 u32 words of a query token in registers: dim <= 256


# ------------------------------------------------------------ numpy half


def binary_quantize(x: np.ndarray) -> np.ndarray:
    """f32 (..., d) -> uint8 bits in {0,1}: 1 iff value > 0."""
    return (np.asarray(x) > 0).astype(np.uint8)


def binary_quantize_packed(x: np.ndarray) -> np.ndarray:
    """f32 (..., d) -> (..., d//8) uint8, MSB-first within each byte."""
    bits = binary_quantize(x)
    if bits.shape[-1] % 8 != 0:
        raise ValueError("dimension must be a multiple of 8")
    return np.packbits(bits, axis=-1, bitorder="big")


def unpack_bits(packed: np.ndarray, dim: Optional[int] = None) -> np.ndarray:
    bits = np.unpackbits(packed, axis=-1, bitorder="big")
    if dim is not None:
        bits = bits[..., :dim]
    return bits


def hamming_distance_packed(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamming distance between packed bit vectors (broadcasting). Counted
    on unpacked bits, which gives the reference's integers on any numpy."""
    x = np.bitwise_xor(np.asarray(a, np.uint8), np.asarray(b, np.uint8))
    return np.unpackbits(x[..., None], axis=-1).sum(axis=(-2, -1))


# ------------------------------------------------------------ torch half


def _popcount_u8(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each byte of a uint8 tensor (SWAR; uint8 shifts are
    logical, so no sign bit leaks in)."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def binary_maxsim_plain(query_packed: torch.Tensor, docs_packed: torch.Tensor, ntok: torch.Tensor,
                        dim: int) -> torch.Tensor:
    """Plain version of K4: XOR of the packed bytes, a popcount per byte,
    the sum per token pair, the min over each row's first ntok[c] doc
    tokens, then sum_q (1 - min / dim) in f32 (a row without tokens
    scores 0). Rows go in chunks whose intermediates stay under
    PLAIN_CHUNK_BYTES."""
    c, nd, nb = docs_packed.shape
    nq = query_packed.shape[0]
    out = torch.zeros(c, dtype=torch.float32, device=docs_packed.device)
    if c == 0 or nd == 0 or nq == 0:
        return out
    per_row = nq * nd * (3 * nb + 8)  # the XOR and two SWAR temporaries, the int32 distances and mask
    step = max(1, PLAIN_CHUNK_BYTES // per_row)
    tok = torch.arange(nd, device=docs_packed.device)
    for s in range(0, c, step):
        d = docs_packed[s : s + step]
        x = torch.bitwise_xor(query_packed[None, :, None, :], d[:, None, :, :])  # (r, Nq, Nd, B)
        ham = _popcount_u8(x).sum(dim=-1, dtype=torch.int32)  # (r, Nq, Nd)
        valid = tok[None, :] < ntok[s : s + step, None]  # (r, Nd)
        ham = torch.where(valid[:, None, :], ham, torch.full_like(ham, torch.iinfo(torch.int32).max))
        best = ham.amin(dim=-1)  # (r, Nq)
        term = 1.0 - best.to(torch.float32) / float(dim)
        out[s : s + step] = torch.where(valid.any(dim=-1)[:, None], term, torch.zeros_like(term)).sum(dim=-1)
    return out


def _check(name, t, dtype, ndim, dev):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} dtype {t.dtype} != {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got shape {tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if dev.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def binary_maxsim(query_packed: torch.Tensor, docs_packed: torch.Tensor, ntok: torch.Tensor,
                  dim: int) -> torch.Tensor:
    """K4 wrapper. query_packed (Nq, B) uint8, docs_packed (C, Nd, B)
    uint8, ntok (C,) int32 valid tokens per row (0..Nd), dim the divisor
    of the distance (the bits a token has). Returns (C,) f32: the plain
    version on a CPU tensor, K4 on a CUDA tensor."""
    dev = docs_packed.device
    _check("docs_packed", docs_packed, torch.uint8, 3, dev)
    _check("query_packed", query_packed, torch.uint8, 2, dev)
    _check("ntok", ntok, torch.int32, 1, dev)
    c, nd, nb = docs_packed.shape
    if query_packed.shape[1] != nb or ntok.shape[0] != c:
        raise ValueError(f"query {tuple(query_packed.shape)} / ntok {tuple(ntok.shape)} vs docs "
                         f"{tuple(docs_packed.shape)}")
    if dim <= 0:
        raise ValueError(f"dim must be positive, got {dim}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cpu":
        return binary_maxsim_plain(query_packed, docs_packed, ntok, dim)
    if nb > MAX_PACKED_BYTES:
        raise ValueError(f"the binary_maxsim kernel takes at most {MAX_PACKED_BYTES} packed bytes, got {nb}")
    out = torch.empty(c, dtype=torch.float32, device=dev)
    if c:
        _kernels.launch_binary_maxsim(query_packed, docs_packed, ntok, out, dim)
    return out


def mask_to_ntok(doc_mask: torch.Tensor) -> torch.Tensor:
    """(C, Nd) validity mask -> (C,) int32 token counts; the mask must be a
    prefix in each row (as the index and `pad_multivectors` make it)."""
    valid = doc_mask > 0
    ntok = valid.sum(dim=-1, dtype=torch.int32)
    prefix = torch.arange(valid.shape[-1], device=valid.device)[None, :] < ntok[:, None]
    if not torch.equal(valid, prefix):
        raise ValueError("doc_mask must mark a prefix of each row's tokens")
    return ntok


def binary_maxsim_scores(query_packed, docs_packed, doc_mask=None, dim: int = 128) -> torch.Tensor:
    """Binary MaxSim over packed bit multivectors, the reference's
    signature: query_packed (Nq, dim//8) uint8, docs_packed (C, Nd,
    dim//8) uint8, doc_mask (C, Nd) or None. Numpy inputs go to the card;
    tensors stay on the docs' device (K4 on CUDA). Returns (C,) f32."""
    device = docs_packed.device if isinstance(docs_packed, torch.Tensor) else default_device()
    docs = torch.as_tensor(np.asarray(docs_packed) if not isinstance(docs_packed, torch.Tensor) else docs_packed,
                           dtype=torch.uint8, device=device).contiguous()
    q = torch.as_tensor(query_packed if isinstance(query_packed, torch.Tensor) else np.asarray(query_packed),
                        dtype=torch.uint8, device=device).contiguous()
    if doc_mask is None:
        ntok = torch.full((docs.shape[0],), docs.shape[1], dtype=torch.int32, device=device)
    else:
        mask = doc_mask if isinstance(doc_mask, torch.Tensor) else torch.from_numpy(np.asarray(doc_mask))
        ntok = mask_to_ntok(mask.to(device)).contiguous()
    return binary_maxsim(q, docs, ntok, dim)
