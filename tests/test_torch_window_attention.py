"""Parity of the port's `ops/window_attention.py` with the JAX package.

On the CPU the port's wrapper runs its plain version; the JAX side runs
the Pallas kernel in interpret mode and `window_attention_ref`. The same
seeded numpy inputs go to both.

Tolerances:
- f32: atol 2e-5, rtol 1e-4, those of tests/test_window_attention.py
  (softmax and the two einsums sum in another order);
- bf16 (plain vs reference, both round the scores and probabilities to
  bf16): atol 2e-2, rtol 2e-2, a few bf16 ulps of outputs of size ~1,
  since a score rounded the other way moves its probability by ~2^-8;
- bf16, `window_attention_pallas_numerics` vs the Pallas kernel in
  interpret mode (both keep the scores in f32 and round only P and the
  output): rtol 2^-7, atol 1e-3, one bf16 ulp of an output where an exp
  or a sum order tips a rounding (a few outputs in 10^5 differ);
- f32, `_window_attention_3xtf32` (the f32 kernel's numerics: every
  operand split into TF32 hi + lo, each k8 step summing lo*hi, hi*lo,
  hi*hi) vs the Pallas kernel in interpret mode and the plain version:
  atol 1e-5, rtol 0, K3's f32 tolerance on the card; a product is off by
  about 2^-21 of |x||y| and the scores are O(1).
K3 itself is held against the plain version and the Pallas-numerics
mirror on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphik_core_tpu.ops.window_attention import (
    window_attention as j_window_attention,
    window_attention_ref as j_window_attention_ref,
)
from morphik_core_tpu_torch.ops import _kernels
from morphik_core_tpu_torch.ops.window_attention import (
    window_attention,
    window_attention_pallas_numerics,
    window_attention_plain,
)

torch.set_num_threads(2)

_TF32_DROPPED = 0x1FFF  # the 13 low mantissa bits TF32 drops


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """`cvt.rna.tf32.f32` in plain PyTorch: f32 rounded to TF32's 10
    mantissa bits, to nearest with ties away from zero. Adding half a
    TF32 ulp to the sign-magnitude bits and dropping the 13 low bits does
    that (a carry may run into the exponent: the largest finite f32
    becomes inf); inf and NaN pass unchanged."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~_TF32_DROPPED).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def _split_tf32(x: torch.Tensor):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _window_attention_3xtf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int) -> torch.Tensor:
    """The f32 kernel's numerics (`window_attention_tf32_kernel`) in plain
    PyTorch, for tests only. Both products run as mma.sync m16n8k8 steps
    of 8 terms in 3xTF32, each step accumulating lo*hi, then hi*lo, then
    hi*hi (lo*lo left out). QK^T takes D padded to 16 in pairs of steps
    over features (0, 1, 4, 5, 8, 9, 12, 13) and (2, 3, 6, 7, 10, 11, 14,
    15) of each 16; PV takes the keys 8 at a time in order. Between them
    the f32 scale and a row softmax, normalised."""
    t, h, d = q.shape
    dp = -(-d // 16) * 16

    def to_win(x, width):
        x = x.float().reshape(t // window, window, h, d).permute(0, 2, 1, 3)  # (W, H, window, D)
        return torch.nn.functional.pad(x, (0, width - d))

    (qh, ql), (kh, kl) = _split_tf32(to_win(q, dp)), _split_tf32(to_win(k, dp))
    first = torch.tensor([0, 1, 4, 5, 8, 9, 12, 13])
    s = torch.zeros(qh.shape[:-1] + (window,))
    for p in range(dp // 16):
        for idx in (16 * p + first, 16 * p + first + 2):
            for a, b in ((ql, kh), (qh, kl), (qh, kh)):
                s = s + a[..., idx] @ b[..., idx].transpose(-1, -2)
    probs = torch.softmax(s * d**-0.5, dim=-1)
    (ph, pl), (vh, vl) = _split_tf32(probs), _split_tf32(to_win(v, d))
    o = torch.zeros(ph.shape[:-1] + (d,))
    for j in range(0, window, 8):
        sl = slice(j, j + 8)
        for a, b in ((pl, vh), (ph, vl), (ph, vh)):
            o = o + a[..., sl] @ b[..., sl, :]
    return o.permute(0, 2, 1, 3).reshape(t, h, d)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("t,h,d,win", [(256, 4, 16, 64), (384, 2, 8, 64), (128, 1, 32, 32), (256, 2, 80, 64)])
def test_matches_jax_kernel_and_reference(t, h, d, win):
    q, k, v = _qkv((t, h, d), t + d)
    got = window_attention(*(torch.from_numpy(x) for x in (q, k, v)), window=win).numpy()
    ref = np.asarray(j_window_attention_ref(*(jnp.asarray(x) for x in (q, k, v)), window=win))
    pal = np.asarray(j_window_attention(*(jnp.asarray(x) for x in (q, k, v)), window=win, interpret=True))
    assert got.shape == (t, h, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, pal, atol=2e-5, rtol=1e-4)


def test_bf16_plain_matches_jax_reference():
    q, k, v = _qkv((256, 4, 80), 5)
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    got = window_attention(*tb, window=64)
    assert got.dtype == torch.bfloat16
    ref = j_window_attention_ref(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), window=64)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("t,h,d,win", [
    (256, 4, 80, 64),  # the vision tower's head width and window
    (96, 3, 72, 48),  # ragged: D and the window not multiples of 16
    (64, 1, 20, 32),  # D not a multiple of 8, one head
])
def test_pallas_numerics_mirror_matches_jax_kernel_bf16(t, h, d, win):
    q, k, v = _qkv((t, h, d), 11 * t + d)
    got = window_attention_pallas_numerics(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), window=win)
    assert got.dtype == torch.bfloat16 and got.shape == (t, h, d)
    pal = j_window_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), window=win, interpret=True)
    torch.testing.assert_close(got.float(), torch.from_numpy(np.asarray(pal.astype(jnp.float32))),
                               rtol=2**-7, atol=1e-3)


def test_pallas_numerics_mirror_is_the_plain_version_in_f32():
    q, k, v = (torch.from_numpy(x) for x in _qkv((256, 2, 80), 3))
    torch.testing.assert_close(window_attention_pallas_numerics(q, k, v, window=64),
                               window_attention_plain(q, k, v, window=64), atol=2e-6, rtol=1e-5)


def test_windows_are_independent():
    """Perturbing the keys and values of window 1 leaves window 0 as it was."""
    t, h, d, win = 128, 2, 16, 64
    q, k, v = (torch.from_numpy(x) for x in _qkv((t, h, d), 0))
    base = window_attention(q, k, v, window=win)
    k2, v2 = k.clone(), v.clone()
    k2[win:] = k[win:] * -3.0 + 1.0
    v2[win:] = v[win:] * 2.0
    pert = window_attention(q, k2, v2, window=win)
    torch.testing.assert_close(pert[:win], base[:win], atol=0, rtol=0)
    assert float((pert[win:] - base[win:]).abs().max()) > 1e-3


def test_rejects_ragged_and_bad_inputs():
    q, k, v = (torch.from_numpy(x) for x in _qkv((100, 2, 8), 1))
    with pytest.raises(ValueError):
        window_attention(q, k, v, window=64)
    q, k, v = (torch.from_numpy(x) for x in _qkv((128, 2, 8), 1))
    with pytest.raises(ValueError):
        window_attention(q, k[:64], v, window=64)
    with pytest.raises(TypeError):
        window_attention(q, k.double(), v, window=64)
    with pytest.raises(TypeError):
        window_attention(q.half(), k.half(), v.half(), window=64)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _qkv((128, 2, 8), 2))
    before = dict(_kernels.launch_counts)
    torch.testing.assert_close(window_attention(q, k, v, window=64),
                               window_attention_plain(q, k, v, window=64), atol=0, rtol=0)
    assert _kernels.launch_counts == before


def _f32(bits):
    return torch.tensor(np.array(bits, dtype=np.uint32).view(np.int32)).view(torch.float32)


def test_tf32_rna_rounds_edge_bit_patterns():
    cases = [  # (f32 bits, TF32 bits by round to nearest, ties away from zero)
        (0x3F800000, 0x3F800000),  # 1.0: already TF32
        (0x3F800FFF, 0x3F800000),  # just below half an ulp: down
        (0x3F801000, 0x3F802000),  # an exact tie: away from zero
        (0x3F801001, 0x3F802000),  # just above the tie: up
        (0x3F805000, 0x3F806000),  # a tie above an even TF32 mantissa: away, where to-even stays
        (0x3FFFF000, 0x40000000),  # a tie whose carry runs into the exponent: 2.0
        (0xBF801000, 0xBF802000),  # a negative tie: away from zero
        (0xBF800FFF, 0xBF800000),  # a negative just below the tie: toward zero
        (0xBFFFF000, 0xC0000000),  # a negative carry into the exponent: -2.0
        (0x00000FFF, 0x00000000),  # a subnormal below the tie: +0
        (0x00001000, 0x00002000),  # a subnormal tie: the smallest TF32 subnormal
        (0x807FF000, 0x80800000),  # the largest subnormal's tie: -(smallest normal)
        (0x00000000, 0x00000000),  # +0
        (0x80000000, 0x80000000),  # -0
        (0x7F800000, 0x7F800000),  # +inf
        (0xFF800000, 0xFF800000),  # -inf
        (0x7F7FFFFF, 0x7F800000),  # the largest finite f32 rounds past TF32's largest: +inf
        (0xFF7FFFFF, 0xFF800000),  # and its negative: -inf
        (0x7F7FE000, 0x7F7FE000),  # TF32's largest finite stays
    ]
    got = _tf32_rna(_f32([c[0] for c in cases])).view(torch.int32).numpy().view(np.uint32)
    assert [hex(int(g)) for g in got] == [hex(c[1]) for c in cases]
    assert torch.isnan(_tf32_rna(_f32([0x7FC00000, 0xFFC00001]))).all()


def test_split_tf32_hi_lo_are_tf32_and_sum_close():
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(100_000).astype(np.float32) * 10.0)
    hi, lo = _split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & _TF32_DROPPED).any()
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0**-21


@pytest.mark.parametrize("t,h,d,win", [
    (256, 4, 80, 64),  # the vision tower's head width and window
    (256, 4, 16, 64),  # the tiny tower (ColQwenConfig.tiny(): D = 16)
    (256, 2, 128, 128),  # the kernel's largest window and D
    (256, 3, 20, 32),  # D not a multiple of 8
    (96, 3, 72, 48),  # D and the window not multiples of 16
])
def test_3xtf32_emulation_matches_jax_kernel_and_plain(t, h, d, win):
    q, k, v = _qkv((t, h, d), 13 * t + d + win)
    got = _window_attention_3xtf32(*(torch.from_numpy(x) for x in (q, k, v)), window=win)
    assert got.dtype == torch.float32 and got.shape == (t, h, d)
    pal = j_window_attention(*(jnp.asarray(x) for x in (q, k, v)), window=win, interpret=True)
    torch.testing.assert_close(got, torch.from_numpy(np.asarray(pal)), atol=1e-5, rtol=0)
    plain = window_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), window=win)
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=0)


def test_3xtf32_emulation_leaves_out_only_small_terms():
    """Without the two lo passes (TF32 alone) the same inputs miss 1e-5;
    with them they meet it: the split is what keeps K3 inside f32's tolerance."""
    q, k, v = (torch.from_numpy(x) for x in _qkv((256, 4, 80), 21))
    plain = window_attention_plain(q, k, v, window=64)
    tf32_only = window_attention_plain(_tf32_rna(q), _tf32_rna(k), _tf32_rna(v), window=64)
    assert float((tf32_only - plain).abs().max()) > 1e-4
    assert float((_window_attention_3xtf32(q, k, v, window=64) - plain).abs().max()) < 1e-5
