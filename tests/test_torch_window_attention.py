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
  or a sum order tips a rounding (a few outputs in 10^5 differ).
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
