"""Parity of the PyTorch port's MUVERA FDE (ops/fde.py) with the JAX
package.

- `FDEConfig` and the Philox-seeded `_matrices` are numpy mirrors:
  identical bit for bit.
- Bucket ids come from `> 0` on f32 projections; a reordered sum can
  flip a bit only where |x . g| is at rounding level, so bits must match
  exactly except where |x . g| < 1e-5.
- FDE values: f32 sums of projected tokens in another order, atol 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from morphik_core_tpu.ops import fde as jfde
from morphik_core_tpu_torch.ops import fde as tfde

torch.set_num_threads(2)

SMALL = dict(dimension=16, num_repetitions=4, num_simhash_projections=3, projection_dimension=8)


def _cfgs(**kw):
    return jfde.FDEConfig(**kw), tfde.FDEConfig(**kw)


@pytest.mark.parametrize("kw", [{}, SMALL, dict(SMALL, projection_type="IDENTITY"), dict(SMALL, seed=7)])
def test_config_and_matrices_bit_identical(kw):
    jc, tc = _cfgs(**kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (jc.fde_dim, jc.num_partitions, jc.proj_dim) == (tc.fde_dim, tc.num_partitions, tc.proj_dim)
    for a, b in zip(jfde._matrices(jc), tfde._matrices(tc)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _mv(rng, n, d=16):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_bucket_bits_exact_up_to_rounding():
    jc, tc = _cfgs(**SMALL)
    x = _mv(np.random.default_rng(0), 64)
    g, _ = jfde._matrices(jc)
    want = np.stack([np.asarray(jfde._partition_bits(jnp.asarray(x), jnp.asarray(gr))) for gr in g])
    got = tfde._partition_bits(torch.from_numpy(x)[None], torch.from_numpy(g).float())[0].numpy()
    margin = np.abs(np.einsum("nd,rdp->rnp", x.astype(np.float64), g.astype(np.float64)))
    flips = want != got
    assert not flips.any() or (margin[flips] < 1e-5).all()


@pytest.mark.parametrize("n", [1, 5, 40])
def test_fde_query_and_document_match_jax(n):
    jc, tc = _cfgs(**SMALL)
    x = _mv(np.random.default_rng(n), n)
    np.testing.assert_allclose(
        tfde.fde_query(torch.from_numpy(x), tc).numpy(),
        np.asarray(jfde.fde_query(jnp.asarray(x), jc)), atol=1e-5, rtol=1e-5,
    )
    # n = 1 and 5 leave most of the 8 buckets empty: the Hamming fill
    # (argmin ties to the lowest token index) decides them
    np.testing.assert_allclose(
        tfde.fde_document(torch.from_numpy(x), tc).numpy(),
        np.asarray(jfde.fde_document(jnp.asarray(x), jc)), atol=1e-5, rtol=1e-5,
    )


def test_fde_document_batch_with_padding_and_empty_doc():
    """Masked padding tokens never count; a fully masked document keeps
    zero centroids (no fill), as in the reference."""
    jc, tc = _cfgs(**SMALL)
    rng = np.random.default_rng(3)
    mvs = [_mv(rng, n) for n in (3, 17, 9)]
    dense = np.zeros((4, 24, 16), np.float32)
    mask = np.zeros((4, 24), np.float32)
    for i, m in enumerate(mvs):
        dense[i, : len(m)] = m
        mask[i, : len(m)] = 1.0
    dense[3] = _mv(rng, 24)  # tokens present but all masked
    want = np.asarray(jfde.fde_document_batch(jnp.asarray(dense), jnp.asarray(mask), jc))
    got = tfde.fde_document_batch(torch.from_numpy(dense), torch.from_numpy(mask), tc).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert not got[3].any()
    single = tfde.fde_document(torch.from_numpy(mvs[1]), tc).numpy()
    np.testing.assert_allclose(got[1], single, atol=1e-6, rtol=1e-6)


def test_full_size_config_matches_jax():
    """The shipped FDE geometry (d=128, R=20, P=5, p=16: 10,240 dims)."""
    jc, tc = _cfgs()
    x = _mv(np.random.default_rng(4), 30, d=128)
    np.testing.assert_allclose(
        tfde.fde_document(torch.from_numpy(x), tc).numpy(),
        np.asarray(jfde.fde_document(jnp.asarray(x), jc)), atol=1e-5, rtol=1e-5,
    )
    np.testing.assert_allclose(
        tfde.fde_query(torch.from_numpy(x), tc).numpy(),
        np.asarray(jfde.fde_query(jnp.asarray(x), jc)), atol=1e-5, rtol=1e-5,
    )


def test_dimension_mismatch_raises():
    _, tc = _cfgs(**SMALL)
    with pytest.raises(ValueError):
        tfde.fde_query(torch.zeros((3, 8)), tc)
