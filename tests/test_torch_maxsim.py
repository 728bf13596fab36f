"""Parity of the PyTorch port's MaxSim (ops/maxsim.py, kernels K1/K2)
with the JAX package.

On the CPU the port's wrappers take their plain versions; the JAX side
runs its Pallas kernels in interpret mode, as its own tests do. Inputs
come from seeded numpy. Tolerances:
- numpy mirrors and int8 tensors: identical;
- K1 (int8): per-token products f32(s32) * ds * qs are computed in the
  same order on both sides, so maxima are identical and only the f32 sum
  over query tokens may be reordered: rtol 1e-6, atol 1e-5;
- K2 (f32/bf16): f32 dots over D accumulate in another order: rtol 1e-5,
  atol 1e-5 at these sizes (D = 32, Nq <= 13).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from morphik_core_tpu.ops import maxsim as jmax
from morphik_core_tpu_torch.ops import maxsim as tmax

torch.set_num_threads(2)

D = 32


def _pool(rng, n_cand=11, max_tok=40, empty=(3,)):
    """Ragged unit multivectors; candidates in `empty` get no tokens."""
    mvs = []
    for i in range(n_cand):
        n = 0 if i in empty else int(rng.integers(1, max_tok))
        x = rng.standard_normal((max(n, 1), D)).astype(np.float32)
        mvs.append((x / np.linalg.norm(x, axis=1, keepdims=True))[:n])
    return mvs


def _query(rng, nq=7, pad_to=None):
    q = rng.standard_normal((nq, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    if pad_to:
        q = np.concatenate([q, np.zeros((pad_to - nq, D), np.float32)])
    return q


@pytest.mark.parametrize("token_bucket", [None, 48])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_pad_multivectors_mirror_identical(token_bucket, dtype):
    mvs = _pool(np.random.default_rng(0), empty=())
    a = jmax.pad_multivectors(mvs, token_bucket=token_bucket, dtype=dtype)
    b = tmax.pad_multivectors(mvs, token_bucket=token_bucket, dtype=dtype)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_quantize_mirrors_identical():
    rng = np.random.default_rng(1)
    q = _query(rng, 13)
    for x, y in zip(jmax.quantize_query_q8(q), tmax.quantize_query_q8(q)):
        np.testing.assert_array_equal(x, y)
    mvs = _pool(rng, empty=())
    for x, y in zip(jmax.quantize_pool_int8(mvs), tmax.quantize_pool_int8(mvs)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("nq,pad_to", [(7, None), (5, 13)])
def test_k2_matches_jax_interpret_kernel(nq, pad_to):
    """K2 plain vs `maxsim_scores(interpret=True)`, including a fully
    masked candidate (kernel semantics: 0) and zero query rows."""
    rng = np.random.default_rng(2)
    dense, mask = tmax.pad_multivectors(_pool(rng))
    q = _query(rng, nq, pad_to)
    want = np.asarray(jmax.maxsim_scores(jnp.asarray(q), jnp.asarray(dense), jnp.asarray(mask), interpret=True))
    got = tmax.maxsim_scores(torch.from_numpy(q), torch.from_numpy(dense), torch.from_numpy(mask)).numpy()
    assert got[3] == 0.0 and want[3] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # against the XLA reference only where a candidate has a valid token
    ref = np.asarray(jmax.maxsim_scores_ref(jnp.asarray(q), jnp.asarray(dense), jnp.asarray(mask)))
    has = mask.sum(1) > 0
    np.testing.assert_allclose(got[has], ref[has], rtol=1e-5, atol=1e-5)
    ref_t = tmax.maxsim_scores_ref(torch.from_numpy(q), torch.from_numpy(dense), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(ref_t, ref, rtol=1e-5, atol=1e-5)


def test_k2_bf16_docs_match_jax():
    """bf16 doc tokens (the store's f16 rows cast to bf16) upcast to f32
    on both sides."""
    rng = np.random.default_rng(3)
    dense, mask = tmax.pad_multivectors(_pool(rng, empty=()), dtype=np.float16)
    q = _query(rng)
    jd = jnp.asarray(dense).astype(jnp.bfloat16)
    want = np.asarray(jmax.maxsim_scores(jnp.asarray(q), jd, jnp.asarray(mask), interpret=True))
    td = torch.from_numpy(dense).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(jd.astype(jnp.float32)), td.float().numpy())
    got = tmax.maxsim_scores(torch.from_numpy(q), td, torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nq", [1, 9])
def test_k1_matches_jax_interpret_kernel(nq):
    """K1 plain vs `maxsim_scores_q8(interpret=True)`: the exact int32
    dot and the scale order of the Pallas kernel."""
    rng = np.random.default_rng(4)
    d8, ds, mask = tmax.quantize_pool_int8(_pool(rng))
    q = _query(rng, nq)
    want = np.asarray(jmax.maxsim_scores_q8(jnp.asarray(q), d8, ds, mask, interpret=True))
    got = tmax.maxsim_scores_q8(q, d8, ds, mask).numpy()
    assert got[3] == 0.0 and want[3] == 0.0
    if nq == 1:  # one real query token: one max, no reordered sum
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    # the JAX CPU path dequantizes both sides: same numbers within f32 rounding
    cpu = np.asarray(jmax.maxsim_scores_q8(jnp.asarray(q), d8, ds, mask, use_pallas=False))
    has = mask.sum(1) > 0
    np.testing.assert_allclose(got[has], cpu[has], rtol=1e-5, atol=1e-5)


def test_k1_row_index_gathers_and_minus_one_scores_zero():
    """Both wrappers gather rows by index (no (C, Np, D) copy in the
    kernels); index -1 is a candidate with no row and scores 0."""
    rng = np.random.default_rng(5)
    mvs = _pool(rng, empty=())
    d8, ds, mask = (torch.from_numpy(a) for a in tmax.quantize_pool_int8(mvs))
    dense = torch.from_numpy(tmax.pad_multivectors(mvs)[0])
    q8, qs = (torch.from_numpy(a) for a in tmax.quantize_query_q8(_query(rng)))
    qf = torch.from_numpy(_query(rng))
    idx = torch.tensor([4, -1, 0, 4, 10], dtype=torch.int32)
    for got, full in (
        (tmax.maxsim_q8(q8, qs, d8, ds, mask, idx), tmax.maxsim_q8(q8, qs, d8, ds, mask)),
        (tmax.maxsim(qf, dense, mask, idx), tmax.maxsim(qf, dense, mask)),
    ):
        want = np.array([full[4], 0.0, full[0], full[4], full[10]], np.float32)
        np.testing.assert_array_equal(got.numpy(), want)


def test_topk_ties_to_lower_index():
    rng = np.random.default_rng(6)
    mvs = _pool(rng, n_cand=6, empty=())
    mvs = mvs + mvs[:3]  # duplicated candidates tie exactly
    dense, mask = tmax.pad_multivectors(mvs)
    q = _query(rng)
    _, ji = jmax.maxsim_topk(jnp.asarray(q), jnp.asarray(dense), jnp.asarray(mask), k=9, use_pallas=False)
    tv, ti = tmax.maxsim_topk(torch.from_numpy(q), torch.from_numpy(dense), torch.from_numpy(mask), k=9)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert jax.default_backend() == "cpu"


@pytest.mark.parametrize("bad", ["dtype", "dim", "mask_shape", "idx_dtype"])
def test_wrappers_reject_bad_inputs(bad):
    q8 = torch.zeros((8, D), dtype=torch.int8)
    qs = torch.ones((1, 8))
    d8 = torch.zeros((3, 16, D), dtype=torch.int8)
    ds = torch.ones((3, 16))
    mask = torch.ones((3, 16))
    idx = None
    if bad == "dtype":
        d8 = d8.float()
    elif bad == "dim":
        q8 = torch.zeros((8, D + 4), dtype=torch.int8)
    elif bad == "mask_shape":
        mask = torch.ones((3, 15))
    else:
        idx = torch.zeros(2, dtype=torch.int64)
    with pytest.raises((TypeError, ValueError)):
        tmax.maxsim_q8(q8, qs, d8, ds, mask, idx)
    with pytest.raises((TypeError, ValueError)):
        tmax.maxsim(q8.float() if bad != "dim" else torch.zeros((8, D + 4)),
                    d8.float() if bad != "dtype" else d8.to(torch.float16), mask, idx)
