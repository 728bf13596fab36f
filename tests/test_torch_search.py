"""Parity of the port's blocked ANN scan, pooled-tier rescore
(parallel/search.py, K1) and device candidate cache (index/device_cache.py,
K1/K2) with the JAX package.

- int8 quantizers: identical (round half to even on both sides).
- int8 scans: the int32 dot is exact and the scale order is the
  reference's, so packed [scores | ids] are identical, ties included
  (duplicated FDE rows: the lower row id comes first, as jax.lax.top_k).
- pooled stage: survivor ids identical; scores within f32 reordering of
  the sum over query tokens (rtol 1e-5, atol 1e-5), compared with the
  Pallas q8 kernel in interpret mode as tests/test_pooled_tier.py runs it.
- cache: scores within f32 rounding of the JAX CPU path (which
  dequantizes both sides): rtol 1e-5, atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from morphik_core_tpu.index.device_cache import DevicePoolCache as JCache
from morphik_core_tpu.parallel import search as jsearch
from morphik_core_tpu.ops.maxsim import quantize_query_q8
from morphik_core_tpu_torch.index.device_cache import DevicePoolCache as TCache
from morphik_core_tpu_torch.parallel import search as tsearch

torch.set_num_threads(2)


def test_quantize_rows_int8_mirror_identical():
    x = np.random.default_rng(0).standard_normal((7, 33)).astype(np.float32)
    x[2] = 0.0  # all-zero row: scale 1
    for a, b in zip(jsearch.quantize_rows_int8(x), tsearch.quantize_rows_int8(x)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["ties", "random", "zero"])
def test_quantize_vec_int8_identical(case):
    if case == "ties":  # exact .5 quotients: half to even
        qe = np.array([127.0, 63.5, -0.5, 1.5, 2.5, -2.5, 0.49999997], np.float32)
    elif case == "random":
        qe = np.random.default_rng(1).standard_normal(300).astype(np.float32)
    else:
        qe = np.zeros(16, np.float32)
    jq, js = jsearch.quantize_vec_int8(jnp.asarray(qe))
    tq, ts = tsearch.quantize_vec_int8(torch.from_numpy(qe))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    assert np.float32(js) == ts.numpy()


def test_int8_matvec_exact_beyond_f32_integer_range():
    """D = 4096 at +-127 sums to 66M > 2^24: the chunked f32 dot must
    still be exact."""
    rng = np.random.default_rng(2)
    f = rng.integers(-127, 128, (40, 4096)).astype(np.int8)
    f[0] = 127
    q = np.full(4096, 127, np.int8)
    got = tsearch.int8_matvec(torch.from_numpy(f), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, (f.astype(np.int64) @ q.astype(np.int64)).astype(np.int32))


def _blocks(rng, n_blocks=2, B=64, D=48, dup=True):
    fde = rng.standard_normal((n_blocks * B, D)).astype(np.float32)
    if dup:  # exact ties across and within blocks
        fde[5] = fde[70] = fde[9]
    f8, fs = tsearch.quantize_rows_int8(fde)
    mask = np.ones(n_blocks * B, np.float32)
    mask[[3, 100]] = 0.0
    codes = (np.arange(n_blocks * B) % 5).astype(np.int32)
    return fde, f8, fs, mask, codes


def _split(a, n_blocks):
    return tuple(np.split(a, n_blocks))


@pytest.mark.parametrize("filtered", [False, True])
def test_scan_blocks_topk_q_identical(filtered):
    rng = np.random.default_rng(3)
    fde, f8, fs, mask, codes = _blocks(rng)
    allowed = np.ones(8, np.float32)
    if filtered:
        allowed[[1, 3]] = 0.0
    qv = fde[9] + 0.01 * rng.standard_normal(fde.shape[1]).astype(np.float32)
    q8, qs = tsearch.quantize_rows_int8(qv[None])
    want = np.asarray(jsearch.scan_blocks_topk_q(
        tuple(map(jnp.asarray, _split(f8, 2))), tuple(map(jnp.asarray, _split(fs, 2))),
        tuple(map(jnp.asarray, _split(mask, 2))), tuple(map(jnp.asarray, _split(codes, 2))),
        jnp.asarray(allowed), jnp.asarray(q8[0]), jnp.asarray(qs[0]), 32, 40,
    ))
    tt = lambda a: tuple(map(torch.from_numpy, _split(a, 2)))  # noqa: E731
    codes_l = tuple(c.long() for c in tt(codes))
    got = tsearch.scan_blocks_topk_q(
        tt(f8), tt(fs), tt(mask), codes_l, torch.from_numpy(allowed),
        torch.from_numpy(q8[0]), torch.tensor(qs[0]), 32, 40,
    ).numpy()
    np.testing.assert_array_equal(got, want)
    ids = list(got[40:].astype(int))
    if not filtered:
        assert ids.index(5) < ids.index(9) < ids.index(70)  # ties: lower id first


def test_scan_blocks_topk_float_identical_on_exact_dots():
    """Integer-valued rows make every f32 dot exact, so scores, ids and
    tie order must be identical."""
    rng = np.random.default_rng(4)
    fde = rng.integers(-8, 9, (128, 24)).astype(np.float32)
    fde[7] = fde[100] = fde[30]
    q = rng.integers(-3, 4, 24).astype(np.float32)
    mask, codes, allowed = np.ones(128, np.float32), np.zeros(128, np.int32), np.ones(4, np.float32)
    want = np.asarray(jsearch.scan_blocks_topk(
        tuple(map(jnp.asarray, _split(fde, 2))), tuple(map(jnp.asarray, _split(mask, 2))),
        tuple(map(jnp.asarray, _split(codes, 2))), jnp.asarray(allowed), jnp.asarray(q), 16, 20,
    ))
    got = tsearch.scan_blocks_topk(
        tuple(map(torch.from_numpy, _split(fde, 2))), tuple(map(torch.from_numpy, _split(mask, 2))),
        tuple(torch.from_numpy(c).long() for c in _split(codes, 2)), torch.from_numpy(allowed),
        torch.from_numpy(q), 16, 20,
    ).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("guard", [0, 4])
def test_pooled_stage_matches_jax_interpret_kernel(guard):
    """The fused int8 scan + pooled-tier rescore over two blocks, against
    `scan_blocks_topk_q_pooled(use_pallas=True, interpret=True)`."""
    rng = np.random.default_rng(6)
    B, D, T, dim = 64, 64, 16, 32
    fde = rng.standard_normal((2 * B, D)).astype(np.float32)
    f8, fs = tsearch.quantize_rows_int8(fde)
    mask = np.ones(2 * B, np.float32)
    mask[50:64] = 0.0
    codes = np.zeros(2 * B, np.int32)
    allowed = np.ones(8, np.float32)
    p8 = rng.integers(-127, 128, (2 * B, T, dim)).astype(np.int8)
    ps = np.abs(rng.standard_normal((2 * B, T))).astype(np.float32) + 0.1
    ps[:, 12:] = 0.0  # padded tokens
    ps[7] = 0.0  # a row with no pooled tokens scores 0
    qv = rng.standard_normal(D).astype(np.float32)
    q8v, qs = tsearch.quantize_rows_int8(qv[None])
    q8p, qsp = quantize_query_q8(rng.standard_normal((5, dim)).astype(np.float32))
    j = lambda a: tuple(map(jnp.asarray, _split(a, 2)))  # noqa: E731
    want = np.asarray(jsearch.scan_blocks_topk_q_pooled(
        j(f8), j(fs), j(mask), j(codes), jnp.asarray(allowed), jnp.asarray(q8v[0]), jnp.asarray(qs[0]),
        j(p8), j(ps), jnp.asarray(q8p), jnp.asarray(qsp), 32, 24, 8,
        use_pallas=True, interpret=True, guard=guard,
    ))
    t = lambda a: tuple(map(torch.from_numpy, _split(a, 2)))  # noqa: E731
    got = tsearch.scan_blocks_topk_q_pooled(
        t(f8), t(fs), t(mask), tuple(c.long() for c in t(codes)), torch.from_numpy(allowed),
        torch.from_numpy(q8v[0]), torch.tensor(qs[0]),
        t(p8), t(ps), tuple((p > 0).float() for p in t(ps)),
        torch.from_numpy(q8p), torch.from_numpy(qsp), 32, 24, 8, guard=guard,
    ).numpy()
    np.testing.assert_array_equal(got[8:], want[8:])
    np.testing.assert_allclose(got[:8], want[:8], rtol=1e-5, atol=1e-5)
    # and against the JAX XLA reference path (dequantized, clamped)
    ref = np.asarray(jsearch.scan_blocks_topk_q_pooled(
        j(f8), j(fs), j(mask), j(codes), jnp.asarray(allowed), jnp.asarray(q8v[0]), jnp.asarray(qs[0]),
        j(p8), j(ps), jnp.asarray(q8p), jnp.asarray(qsp), 32, 24, 8, use_pallas=False, guard=guard,
    ))
    np.testing.assert_array_equal(got[8:], ref[8:])


def _rows(rng, n, d=32, lo=5, hi=40):
    out = []
    for _ in range(n):
        x = rng.standard_normal((int(rng.integers(lo, hi)), d)).astype(np.float32)
        out.append((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float16))
    return out


@pytest.mark.parametrize("quantized", [True, False])
def test_device_cache_matches_jax(quantized):
    """Insert-on-miss, LRU eviction and scores (K1 for int8 slots, K2 for
    bf16 slots) against the JAX cache on the same query sequence."""
    rng = np.random.default_rng(7)
    rows = _rows(rng, 30)
    jc = JCache(6, 48, 32, quantized=quantized)
    tc = TCache(6, 48, 32, device="cpu", quantized=quantized)
    for pool in ([0, 1, 2, 3], [2, 3, 4, 5], [6, 7, 0, 1, 2], [6, 7], [8, 9, 10, 11, 12, 13]):
        q = rng.standard_normal((7, 32)).astype(np.float32)
        want = jc.score(pool, q, fetch_row=rows.__getitem__, n_tokens=lambda r: len(rows[r]), use_pallas=False)
        got = tc.score(pool, q, fetch_row=rows.__getitem__, n_tokens=lambda r: len(rows[r]))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert (tc.hits, tc.misses) == (jc.hits, jc.misses)
        assert list(tc._row_to_slot) == list(jc._row_to_slot)
    assert tc.score([0], q, fetch_row=rows.__getitem__, n_tokens=lambda r: 49) is None
