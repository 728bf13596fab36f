"""Parity of the port's binary quantization, binary MaxSim (ops/binary.py,
the plain version of kernel K4) and binary index with the JAX package,
on the CPU.

- The numpy mirrors (`binary_quantize`, `binary_quantize_packed`,
  `unpack_bits`, `hamming_distance_packed`) are bit-identical to
  `morphik_core_tpu/ops/binary.py`, and on f32 input the packing to
  `morphik_core_tpu/utils/fast_ops.binary_quantize_packed`, which the
  reference's index calls.
- `binary_maxsim_scores` is bit-identical to the JAX function at
  power-of-two dims (every term is a multiple of 2^-log2(dim), so every
  partial sum is exact in f32 in any order), and within 1e-6 relative
  elsewhere.
- `tests/test_binary.py` and `tests/test_binary_index.py` run against the
  port, each test function of them parametrised over the two packages.
- The port's index answers the JAX index's store / delete / filter calls
  with the same ids and score bits, resident and streamed.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from morphik_core_tpu.index import binary_index as jbi
from morphik_core_tpu.index import multivector_index as jmi
from morphik_core_tpu.ops import binary as jbin
from morphik_core_tpu.utils import fast_ops as jfast
from morphik_core_tpu_torch.index import binary_index as tbi
from morphik_core_tpu_torch.index import multivector_index as tmi
from morphik_core_tpu_torch.ops import binary as tbin
from morphik_core_tpu_torch.ops import maxsim as tmax

torch.set_num_threads(2)

TESTS = Path(__file__).resolve().parent
DIMS = [8, 16, 24, 40, 64, 128, 136, 256]


def _x(rng, shape):
    """Signed values with exact zeros, -0.0 and NaNs among them."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    pick = rng.random(flat.shape[0])
    flat[pick < 0.05] = 0.0
    flat[(pick >= 0.05) & (pick < 0.08)] = -0.0
    flat[(pick >= 0.08) & (pick < 0.09)] = np.nan
    return x


# ------------------------------------------------------------ numpy mirrors


@pytest.mark.parametrize("dim", DIMS)
def test_numpy_mirrors_bit_identical(dim):
    rng = np.random.default_rng(dim)
    x = _x(rng, (3, 7, dim))
    np.testing.assert_array_equal(tbin.binary_quantize(x), jbin.binary_quantize(x))
    packed = jbin.binary_quantize_packed(x)
    for got in (tbin.binary_quantize_packed(x), jfast.binary_quantize_packed(x)):
        assert got.dtype == packed.dtype == np.uint8
        np.testing.assert_array_equal(got, packed)
    for d in (None, dim, dim - 3):
        np.testing.assert_array_equal(tbin.unpack_bits(packed, d), jbin.unpack_bits(packed, d))
    b = tbin.binary_quantize_packed(_x(rng, (7, dim)))
    for a in (packed[0, 0], packed[1], packed[2, :, None]):  # one against many, row by row, all pairs
        want = jbin.hamming_distance_packed(a, b)
        got = tbin.hamming_distance_packed(a, b)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_mirrors_refuse_a_dim_off_the_byte():
    x = np.ones((2, 12), np.float32)
    with pytest.raises(ValueError):
        tbin.binary_quantize_packed(x)


def test_hamming_on_every_byte_value():
    a = np.arange(256, dtype=np.uint8)
    for b in (np.zeros(256, np.uint8), np.full(256, 0xFF, np.uint8), a[::-1].copy()):
        np.testing.assert_array_equal(tbin.hamming_distance_packed(a[:, None], b[:, None]),
                                      jbin.hamming_distance_packed(a[:, None], b[:, None]))


# -------------------------------------------------------- binary MaxSim


def _case(rng, dim, n_cand=9, nq=7, max_tok=30, empty=(2,), full=(4,)):
    """Packed query and docs with ragged, fully-masked and full rows."""
    q = tbin.binary_quantize_packed(_x(rng, (nq, dim)))
    mvs = []
    for i in range(n_cand):
        n = 0 if i in empty else max_tok if i in full else int(rng.integers(1, max_tok))
        mvs.append(_x(rng, (n, dim)))
    dense, mask = tmax.pad_multivectors([m if len(m) else np.zeros((1, dim), np.float32) for m in mvs],
                                        token_bucket=max_tok)
    for i in empty:
        mask[i] = 0.0
    return q, tbin.binary_quantize_packed(dense), mask


def _jax_scores(q, d, mask, dim):
    return np.asarray(jbin.binary_maxsim_scores(jnp.asarray(q), jnp.asarray(d),
                                                None if mask is None else jnp.asarray(mask), dim=dim))


def _port_scores(q, d, mask, dim):
    return tbin.binary_maxsim_scores(torch.from_numpy(q), torch.from_numpy(d),
                                     None if mask is None else torch.from_numpy(mask), dim=dim).numpy()


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("masked", [True, False])
def test_binary_maxsim_matches_jax(dim, masked):
    rng = np.random.default_rng(100 + dim)
    q, d, mask = _case(rng, dim)
    want = _jax_scores(q, d, mask if masked else None, dim)
    got = _port_scores(q, d, mask if masked else None, dim)
    assert got.dtype == np.float32 and got.shape == want.shape
    if dim & (dim - 1) == 0:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if masked:
        assert got[2] == 0.0  # the fully masked row


@pytest.mark.parametrize("dim", [16, 128])
def test_sign_bit_words_and_all_ones(dim):
    """Words with the top bit set and 0xFFFFFFFF (torch's int32 shift is
    arithmetic; the plain version counts on uint8, whose shifts are not)."""
    nb = dim // 8
    q = np.array([[0xFF] * nb, [0x80] + [0x00] * (nb - 1), [0x7F] * nb, [0x00] * nb], np.uint8)
    docs = np.array([[[0xFF] * nb, [0x80] * nb, [0x01] * nb], [[0x00] * nb, [0xFE] * nb, [0x81] * nb],
                     [[0x80, 0x00] * (nb // 2), [0x00, 0x80] * (nb // 2), [0xFF] * nb]], np.uint8)
    mask = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0]], np.float32)
    want = _jax_scores(q, docs, mask, dim)
    np.testing.assert_array_equal(_port_scores(q, docs, mask, dim).view(np.int32), want.view(np.int32))


def test_plain_version_chunks_rows(monkeypatch):
    rng = np.random.default_rng(5)
    q, d, mask = _case(rng, 128, n_cand=23)
    want = _port_scores(q, d, mask, 128)
    monkeypatch.setattr(tbin, "PLAIN_CHUNK_BYTES", 1)  # one row a chunk
    np.testing.assert_array_equal(_port_scores(q, d, mask, 128), want)
    np.testing.assert_array_equal(want, _jax_scores(q, d, mask, 128))


def test_wrapper_checks_and_mask_prefix():
    q = torch.zeros((2, 16), dtype=torch.uint8)
    d = torch.zeros((3, 4, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="prefix"):
        tbin.binary_maxsim_scores(q, d, torch.tensor([[1, 0, 1, 0]] * 3, dtype=torch.float32))
    with pytest.raises(TypeError):
        tbin.binary_maxsim(q.int(), d, torch.zeros(3, dtype=torch.int32), 128)
    with pytest.raises(ValueError):
        tbin.binary_maxsim(q[:, :8], d, torch.zeros(3, dtype=torch.int32), 128)
    with pytest.raises(ValueError):
        tbin.binary_maxsim(q, d, torch.zeros(2, dtype=torch.int32), 128)
    got = tbin.binary_maxsim(q, d, torch.tensor([0, 2, 4], dtype=torch.int32), 128)
    assert got.tolist() == [0.0, 2.0, 2.0]  # identical bits: 1 per query token; no tokens: 0


# ------------------------------------- the reference's tests, both packages


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", TESTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _PortIndex(tbi.BinaryMultiVectorIndex):
    def __init__(self, *args, **kw):
        super().__init__(*args, device="cpu", **kw)


class _TorchArrays:
    """Stands in for `jax.numpy` in the reference tests: arrays become
    CPU tensors, which the port's function takes."""

    @staticmethod
    def asarray(x):
        return torch.from_numpy(np.ascontiguousarray(x))


_REF_BINARY = _load("test_binary")
_REF_INDEX = _load("test_binary_index")


def _test_names(mod):
    return sorted(n for n in vars(mod) if n.startswith("test_"))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("name", _test_names(_REF_BINARY))
def test_reference_binary_tests(pkg, name, monkeypatch):
    if pkg == "torch":
        for attr in ("binary_quantize", "binary_quantize_packed", "unpack_bits", "hamming_distance_packed",
                     "binary_maxsim_scores"):
            monkeypatch.setattr(_REF_BINARY, attr, getattr(tbin, attr))
        monkeypatch.setattr(_REF_BINARY, "pad_multivectors", tmax.pad_multivectors)
        monkeypatch.setattr(_REF_BINARY, "jnp", _TorchArrays)
    getattr(_REF_BINARY, name)()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("name", _test_names(_REF_INDEX))
def test_reference_binary_index_tests(pkg, name, monkeypatch):
    if pkg == "torch":
        # the module's own names and the ones its tests import inside
        monkeypatch.setattr(_REF_INDEX, "BinaryMultiVectorIndex", _PortIndex)
        monkeypatch.setattr(_REF_INDEX, "IndexRecord", tmi.IndexRecord)
        monkeypatch.setattr(jbi, "BinaryMultiVectorIndex", _PortIndex)
        monkeypatch.setattr(jmi, "IndexRecord", tmi.IndexRecord)
    getattr(_REF_INDEX, name)()


# ------------------------------------------------ the index against JAX's


def _corpus(rng, n, dim, tok=(1, 40)):
    return [rng.standard_normal((int(rng.integers(*tok)), dim)).astype(np.float32) for _ in range(n)]


def _same(a, b):
    assert [(r.document_id, r.chunk_number) for r, _ in a] == [(r.document_id, r.chunk_number) for r, _ in b]
    np.testing.assert_array_equal(np.array([s for _, s in a], np.float32).view(np.int32),
                                  np.array([s for _, s in b], np.float32).view(np.int32))


@pytest.mark.parametrize("budget", [1 << 30, 1])
@pytest.mark.parametrize("dim", [128, 16])
def test_index_matches_jax_index(budget, dim):
    """The same store / upsert / delete / filter calls: the same ids and
    score bits, resident (budget 1 GiB) and streamed (budget 1 byte, blocks
    of 16 rows). Coarse queries make many ties, which np.argsort orders."""
    rng = np.random.default_rng(dim)
    kw = dict(dim=dim, token_bucket=32, block_rows=16, device_budget_bytes=budget)
    j, t = jbi.BinaryMultiVectorIndex(**kw), tbi.BinaryMultiVectorIndex(device="cpu", **kw)
    mvs = _corpus(rng, 70, dim)
    for ix, rec in ((j, jmi.IndexRecord), (t, tmi.IndexRecord)):
        ix.store(mvs[:40], [rec(document_id=f"d{i // 2}", chunk_number=i % 2, metadata={"i": i}) for i in range(40)])
    queries = [rng.standard_normal((n, dim)).astype(np.float32) for n in (1, 4)] + [mvs[5][:4]]
    for q in queries:
        _same(t.query(q, k=50), j.query(q, k=50))
    for ix, rec in ((j, jmi.IndexRecord), (t, tmi.IndexRecord)):
        ix.store(mvs[40:], [rec(document_id=f"d{i // 2}", chunk_number=i % 2) for i in range(40, 70)])
        ix.store([mvs[0]], [rec(document_id="d3", chunk_number=0)])  # upsert
        assert ix.delete_document("d7") == 2 and ix.delete_document("nope") == 0
    assert len(t) == len(j) == 68
    for q in queries:
        _same(t.query(q, k=10), j.query(q, k=10))
        _same(t.query(q, k=100), j.query(q, k=100))
        _same(t.query(q, k=5, doc_ids=["d1", "d3", "d7", "d30"]), j.query(q, k=5, doc_ids=["d1", "d3", "d7", "d30"]))
        assert t.query(q, k=5, doc_ids=["d7"]) == j.query(q, k=5, doc_ids=["d7"]) == []
    assert t._device_count == j._device_count == (71 if budget > 1 else 0)
    got = t.get_chunks_by_id([("d3", 0), ("d7", 1), ("d4", 1)])
    want = j.get_chunks_by_id([("d3", 0), ("d7", 1), ("d4", 1)])
    assert [None if r is None else (r.document_id, r.chunk_number, r.n_tokens) for r in got] == [
        None if r is None else (r.document_id, r.chunk_number, r.n_tokens) for r in want]
    t.save()
    assert t.query(queries[0], k=0) == [] and tbi.BinaryMultiVectorIndex(device="cpu").query(queries[0], 3) == []


def test_resident_copy_grows_by_the_new_rows_only():
    rng = np.random.default_rng(3)
    ix = tbi.BinaryMultiVectorIndex(dim=16, token_bucket=8, device="cpu")
    ix.store(_corpus(rng, 5, 16, (1, 8)), [tmi.IndexRecord(document_id=f"d{i}", chunk_number=0) for i in range(5)])
    ix.query(rng.standard_normal((2, 16)).astype(np.float32), 3)
    first = ix._device_bits
    ix.store(_corpus(rng, 2, 16, (1, 8)), [tmi.IndexRecord(document_id=f"e{i}", chunk_number=0) for i in range(2)])
    ix.query(rng.standard_normal((2, 16)).astype(np.float32), 3)
    assert ix._device_count == 7 and torch.equal(ix._device_bits[:5], first)
    np.testing.assert_array_equal(ix._device_bits.numpy(), ix._bits[:7])
    np.testing.assert_array_equal(ix._device_ntok.numpy(), ix._ntok[:7])


def test_index_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbi.BinaryMultiVectorIndex()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbin.binary_maxsim_scores(np.zeros((1, 16), np.uint8), np.zeros((1, 1, 16), np.uint8))


def test_reruns_leave_the_reference_modules_as_they_were():
    """The re-runs patch names in the reference's modules, which other test
    files of the same worker import: each patch is undone."""
    assert jbi.BinaryMultiVectorIndex.__module__ == "morphik_core_tpu.index.binary_index"
    assert jmi.IndexRecord.__module__ == "morphik_core_tpu.index.multivector_index"
    assert _REF_INDEX.BinaryMultiVectorIndex is jbi.BinaryMultiVectorIndex
    assert _REF_BINARY.binary_maxsim_scores is jbin.binary_maxsim_scores and _REF_BINARY.jnp is jnp
