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
  atol 1e-5 at these sizes (D = 32, Nq <= 13);
- the emulation of K2's tensor-core numerics on the card (the f32 query
  split into bf16 hi + lo): K2's stated rtol 1e-4, atol 1e-3.
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
    got = tmax.maxsim_scores_q8(q, d8, ds, mask, device="cpu").numpy()
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


# --- the kernels' launch plan and K2's split-query numerics ---------------


def _spans(n, step, count):
    return [(i * step, min(n, (i + 1) * step)) for i in range(count)]


@pytest.mark.parametrize("n_cand,np_,nq,dim,q_bytes", [
    (32, 1024, 32, 128, 1), (32, 1024, 29, 128, 4), (32, 768, 29, 128, 4), (13, 700, 640, 128, 4),
    (304, 24, 32, 128, 1), (304, 24, 632, 128, 1), (32, 1024, 632, 128, 1), (1, 1, 1, 16, 4),
    (1, 1024, 1, 32, 1), (5, 0, 8, 32, 1), (3, 40, 70, 1024, 4), (2, 17, 300, 20, 4),
])
def test_plan_covers_every_token_once(n_cand, np_, nq, dim, q_bytes):
    """Every doc token lies in exactly one non-empty split, every query
    token in exactly one query tile of at most q_tile tokens."""
    plan = tmax.maxsim_plan(n_cand, np_, nq, dim, q_bytes)
    assert plan.q_tile in (16, 32, 64) and plan.q_tile * dim * q_bytes <= tmax.QUERY_TILE_BYTES
    doc = _spans(np_, plan.tok_per_split, plan.n_splits)
    assert [i for a, b in doc for i in range(a, b)] == list(range(np_))
    assert all(b > a for a, b in doc) or np_ == 0
    qry = _spans(nq, plan.q_tile, plan.n_qtiles)
    assert [i for a, b in qry for i in range(a, b)] == list(range(nq))
    assert all(b > a for a, b in qry)


@pytest.mark.parametrize("n_cand", [1, 13, 32])
@pytest.mark.parametrize("np_", [1, 24, 700, 1024])
@pytest.mark.parametrize("nq", [1, 29, 640])
def test_plan_fills_the_card_for_small_c(n_cand, np_, nq):
    """A small C reaches the block target (two per SM of an H100) unless
    Np has fewer 16-token granules; a C that fills the card keeps one
    split per candidate."""
    plan = tmax.maxsim_plan(n_cand, np_, nq, 128, 4)
    blocks = n_cand * plan.n_qtiles * plan.n_splits
    most = n_cand * plan.n_qtiles * -(-np_ // tmax.SPLIT_GRANULE)
    assert blocks >= min(tmax.TARGET_BLOCKS, most)
    assert tmax.maxsim_plan(304, np_, nq, 128, 1).n_splits == 1


def test_plan_rejects_a_query_row_wider_than_its_tile_budget():
    assert tmax.maxsim_plan(4, 64, 64, 1024, 4).q_tile == 16
    with pytest.raises(ValueError):
        tmax.maxsim_plan(4, 64, 64, 1025, 4)


def _k2_split_query(q: torch.Tensor, docs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K2's numerics on the card, emulated on the CPU: the f32 query is
    split into q_hi = bf16(q) and q_lo = bf16(q - q_hi), bf16 docs enter
    exact, f32 docs split the same way (the d_lo q_lo term dropped); each
    product is taken in f32."""
    bf = torch.bfloat16
    q_hi = q.to(bf).float()
    q_lo = (q - q_hi).to(bf).float()
    if docs.dtype == bf:
        d = docs.float()
        sim = torch.einsum("qd,cnd->cqn", q_hi, d) + torch.einsum("qd,cnd->cqn", q_lo, d)
    else:
        d_hi = docs.to(bf).float()
        d_lo = (docs - d_hi).to(bf).float()
        sim = (torch.einsum("qd,cnd->cqn", q_hi, d_hi) + torch.einsum("qd,cnd->cqn", q_lo, d_hi)
               + torch.einsum("qd,cnd->cqn", q_hi, d_lo))
    sim = torch.where(mask[:, None, :] > 0, sim, torch.full_like(sim, tmax.NEG_INF))
    per_q = sim.amax(dim=-1)
    return torch.where(per_q <= tmax.NEG_INF * 0.5, torch.zeros_like(per_q), per_q).sum(dim=-1)


@pytest.mark.parametrize("docs_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("nq,pad_to,dim,n_cand,max_tok", [(29, None, 32, 11, 40), (633, 640, 128, 13, 700)])
def test_k2_split_query_numerics_match_jax(docs_dtype, nq, pad_to, dim, n_cand, max_tok):
    """The split-query emulation against JAX `maxsim_scores(interpret=True)`
    and `maxsim_scores_ref` on the same inputs, at K2's stated tolerance
    (the long case is a page used as the query: 633 tokens + 7 zero rows)."""
    rng = np.random.default_rng(8 + nq)
    mvs = []
    for i in range(n_cand):
        n = 0 if i == 3 else int(rng.integers(1, max_tok))
        x = rng.standard_normal((max(n, 1), dim)).astype(np.float32)
        mvs.append((x / np.linalg.norm(x, axis=1, keepdims=True))[:n])
    dense, mask = tmax.pad_multivectors(mvs)
    q = rng.standard_normal((nq, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    if pad_to:
        q = np.concatenate([q, np.zeros((pad_to - nq, dim), np.float32)])
    jd = jnp.asarray(dense)
    td = torch.from_numpy(dense)
    if docs_dtype == "bf16":
        jd, td = jd.astype(jnp.bfloat16), td.to(torch.bfloat16)
    got = _k2_split_query(torch.from_numpy(q), td, torch.from_numpy(mask)).numpy()
    want = np.asarray(jmax.maxsim_scores(jnp.asarray(q), jd, jnp.asarray(mask), interpret=True))
    assert got[3] == 0.0 and want[3] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    ref = np.asarray(jmax.maxsim_scores_ref(jnp.asarray(q), jd, jnp.asarray(mask)))
    has = mask.sum(1) > 0
    np.testing.assert_allclose(got[has], ref[has], rtol=1e-4, atol=1e-3)
