"""Index persistence of the port against the JAX package, on the CPU.

- One file format: the same store / upsert / delete / save sequence with
  the same precomputed FDE rows writes byte-identical `header.json`,
  `records.jsonl`, `fde.bin`, `mv.bin` and `pooled.bin` in both packages,
  after each of three saves, with and without a compaction on the way.
- Each package opens the other's index: the same records, the same
  multivector bytes, the same top-k ids (scores within f32 rounding,
  rtol 1e-5, atol 1e-4, as tests/test_torch_slice.py), and it keeps
  appending in the same format.
- The reference's persistence, compaction and pooled-store tests
  (`tests/test_index_persistence.py`, `tests/test_compaction_safety.py`,
  `tests/test_pooled_tier.py`), run against the port's index.
- `pool_multivector` and `pooled_token_count` (pooled.bin stores their
  output) are bit-identical to `morphik_core_tpu/ops/pooling.py`.
"""

import json
import time

import numpy as np
import pytest
import torch

from morphik_core_tpu.index.multivector_index import IndexRecord as JRecord, MultiVectorIndex as JIndex
from morphik_core_tpu.ops import pooling as jpooling
from morphik_core_tpu.ops.fde import FDEConfig as JFDE
from morphik_core_tpu_torch.index import multivector_index as tmi
from morphik_core_tpu_torch.index.multivector_index import IndexRecord, MultiVectorIndex
from morphik_core_tpu_torch.ops import pooling as tpooling
from morphik_core_tpu_torch.ops.fde import FDEConfig

torch.set_num_threads(2)

FDE_KW = dict(dimension=16, num_repetitions=4, num_simhash_projections=3, projection_dimension=8)
CFG = FDEConfig(**FDE_KW)
TIER = dict(pooled_tier_factor=4, pooled_refine_iters=3, pooled_tier_budget_mb=64, prefilter_cap=75)
FILES = ("header.json", "records.jsonl", "fde.bin", "mv.bin", "pooled.bin")


def _mk(path=None, **kw):
    return MultiVectorIndex(CFG, device="cpu", path=path, **kw)


def _rand_mvs(rng, n, tokens=8, d=16):
    return [rng.standard_normal((tokens, d)).astype(np.float32) for _ in range(n)]


def _recs(n, start=0, doc_prefix="doc"):
    return [IndexRecord(document_id=f"{doc_prefix}{start + i}", chunk_number=0, metadata={"i": start + i})
            for i in range(n)]


# ------------------------------------------------------- the shared format


def _unit_rows(rng, n, tok=(2, 30)):
    """Unit rows of ragged length; some are no longer than the tier
    factor, so they stay unpooled."""
    out = []
    for _ in range(n):
        x = rng.standard_normal((int(rng.integers(*tok)), 16)).astype(np.float32)
        out.append(x / np.linalg.norm(x, axis=1, keepdims=True))
    return out


def _record_fields(i):
    doc, chunk = f"d{i // 2}", i % 2
    md = {"i": i, "name": f"página {i}", "w": 0.1 * i, "tags": ["a", i, None]}
    key = None
    if i % 3 == 0:
        key = f"app/{doc}/{chunk}.png"
        md["is_image"] = True
    else:
        md["_content"] = f"text of chunk {i} ✓"
    return doc, chunk, md, key


def _apply(index, rec_cls, steps):
    """Run one package's side of a shared op sequence; returns the saved
    index after each step's save."""
    for kind, arg in steps:
        if kind == "store":
            rows, fde, ids = arg
            recs = []
            for i in ids:
                doc, chunk, md, key = _record_fields(i)
                recs.append(rec_cls(doc, chunk, metadata=md, content_key=key))
            index.store(rows, recs, fde_vectors=fde)
        elif kind == "delete":
            index.delete_document(arg)
        else:
            index.save()
            yield index


def _steps(rng):
    """Three jobs, each ending in a save: stores with precomputed FDE rows,
    an upsert of an existing (doc, chunk), deletes of whole documents."""
    def job(ids):
        rows = _unit_rows(rng, len(ids))
        return ("store", (rows, rng.standard_normal((len(ids), CFG.fde_dim)).astype(np.float32), ids))

    return [job(range(0, 20)), ("save", None),
            job(list(range(20, 30)) + [7]), ("delete", "d5"), ("delete", "nope"), ("save", None),
            job(range(30, 36)), ("delete", "d0"), ("delete", "d12"), ("delete", "d16"), ("save", None)]


@pytest.mark.parametrize("pooled_factor", [4, 0])
@pytest.mark.parametrize("compacting", [False, True])
def test_files_byte_identical_across_packages(tmp_path, pooled_factor, compacting):
    """The same calls write the same bytes. With `compacting`, the
    reference's trigger fires inside `delete_document` on the way."""
    kw = dict(TIER, pooled_tier_factor=pooled_factor)
    if compacting:
        kw.update(compact_min_rows=16, compact_dead_fraction=0.1)
    steps = _steps(np.random.default_rng(3))
    j = JIndex(JFDE(**FDE_KW), path=tmp_path / "jax", **kw)
    t = MultiVectorIndex(CFG, device="cpu", path=tmp_path / "torch", **kw)
    saves = 0
    for ji, ti in zip(_apply(j, JRecord, steps), _apply(t, IndexRecord, steps)):
        saves += 1
        assert (ti.count_rows, len(ti), ti.dead_fraction) == (ji.count_rows, len(ji), ji.dead_fraction)
        for name in FILES:
            jp, tp = tmp_path / "jax" / name, tmp_path / "torch" / name
            assert jp.exists() == tp.exists() == (name != "pooled.bin" or pooled_factor > 1), name
            if jp.exists():
                assert tp.read_bytes() == jp.read_bytes(), (saves, name)
    assert saves == 3
    assert (t.count_rows < 37) == compacting  # 37 rows stored, 36 + 1 upsert
    assert not (tmp_path / "torch.compact").exists()
    lines = (tmp_path / "torch" / "records.jsonl").read_text().splitlines()
    assert json.loads(lines[0])["metadata"]["name"].startswith("página ")


def _same_answers(ja, ta, queries, k=5):
    for q in queries:
        ra, rb = ja.query(q, k=k), ta.query(q, k=k)
        assert [(r.document_id, r.chunk_number) for r, _ in ra] == [(r.document_id, r.chunk_number) for r, _ in rb]
        np.testing.assert_allclose([s for _, s in rb], [s for _, s in ra], rtol=1e-5, atol=1e-4)


def _records(index):
    return [(r.document_id, r.chunk_number, r.metadata, r.content_key, r.n_tokens) for r in index.records]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_opens_the_others_index(tmp_path, writer):
    """One package writes, the other opens; then the reader appends and
    deletes, saves, and the writer's package opens the result."""
    rng = np.random.default_rng(4)
    steps = _steps(rng)
    path = tmp_path / "ix"
    kw = dict(TIER, rerank_dtype="int8", device_cache_slots=64, device_cache_token_bucket=32,
              device_block_rows=16)

    def open_j():
        return JIndex(JFDE(**FDE_KW), path=path, **kw)

    def open_t():
        return MultiVectorIndex(CFG, device="cpu", path=path, **kw)

    w_open, r_open, w_rec, r_rec = (open_j, open_t, JRecord, IndexRecord) if writer == "jax" else \
        (open_t, open_j, IndexRecord, JRecord)
    w = w_open()
    for _ in _apply(w, w_rec, steps):
        pass
    queries = [w._mv_row(r).astype(np.float32) for r in (1, 9, 22)] + _unit_rows(rng, 2, tok=(3, 6))
    r = r_open()
    assert r._pooled_store_ok and r.count_rows == w.count_rows
    assert _records(r) == _records(w) and len(r) == len(w) == 28
    for rec in w.records:
        a, b = w.get_multivector(rec.document_id, rec.chunk_number), r.get_multivector(rec.document_id, rec.chunk_number)
        assert (a is None and b is None) or a.tobytes() == b.tobytes()
    ja, ta = (w, r) if writer == "jax" else (r, w)
    _same_answers(ja, ta, queries)
    # the reader keeps writing in the same format
    more = _unit_rows(rng, 4)
    r.store(more, [r_rec(f"x{i}", 0, metadata={"i": i}) for i in range(4)],
            fde_vectors=rng.standard_normal((4, CFG.fde_dim)).astype(np.float32))
    r.delete_document("d3")
    r.save()
    w2 = w_open()
    assert _records(w2) == _records(r) and len(w2) == len(r) == 30
    ja, ta = (w2, r) if writer == "jax" else (r, w2)
    _same_answers(ja, ta, queries + [more[2]])


@pytest.mark.parametrize("factor", [1, 2, 4, 32])
@pytest.mark.parametrize("refine_iters", [0, 3])
def test_pool_multivector_bit_identical(factor, refine_iters):
    rng = np.random.default_rng(factor * 10 + refine_iters)
    for n in (1, factor, factor + 1, 37, 661):
        mv = rng.standard_normal((n, 128)).astype(np.float16).astype(np.float32)
        mv /= np.linalg.norm(mv, axis=1, keepdims=True)
        got = tpooling.pool_multivector(mv, factor, refine_iters=refine_iters)
        want = jpooling.pool_multivector(mv, factor, refine_iters=refine_iters)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), n
        assert got.shape[0] == tpooling.pooled_token_count(n, factor) == jpooling.pooled_token_count(n, factor)


# ------------------------------- the reference's tests/test_index_persistence.py


def test_save_cost_is_o_job_not_o_corpus(tmp_path):
    """Append-only: each save grows the files by exactly the job's rows."""
    rng = np.random.default_rng(0)
    idx = _mk(tmp_path / "ix")
    n0 = 5000
    idx.store(_rand_mvs(rng, n0), _recs(n0), fde_vectors=rng.standard_normal((n0, CFG.fde_dim)).astype(np.float32))
    idx.save()
    sizes0 = [(tmp_path / "ix" / f).stat().st_size for f in ("fde.bin", "mv.bin")]
    wal0 = sum(1 for _ in open(tmp_path / "ix" / "records.jsonl"))
    assert sizes0[0] == n0 * CFG.fde_dim * 4 and wal0 == n0
    job = 32
    idx.store(_rand_mvs(rng, job), _recs(job, start=n0),
              fde_vectors=rng.standard_normal((job, CFG.fde_dim)).astype(np.float32))
    t0 = time.perf_counter()
    idx.save()
    dt_small = time.perf_counter() - t0
    sizes1 = [(tmp_path / "ix" / f).stat().st_size for f in ("fde.bin", "mv.bin")]
    assert sizes1[0] - sizes0[0] == job * CFG.fde_dim * 4
    assert sizes1[1] - sizes0[1] == job * 8 * 16 * 2  # tokens x dim x f16
    assert sum(1 for _ in open(tmp_path / "ix" / "records.jsonl")) - wal0 == job
    idx.save()  # a save with nothing pending writes nothing
    assert (tmp_path / "ix" / "fde.bin").stat().st_size == sizes1[0]
    assert dt_small < 1.0


def test_restart_reload_and_query_parity(tmp_path):
    rng = np.random.default_rng(1)
    idx = _mk(tmp_path / "ix")
    mvs = _rand_mvs(rng, 200)
    idx.store(mvs, _recs(200))
    idx.delete_document("doc7")
    idx.store([mvs[3]], [IndexRecord(document_id="doc9", chunk_number=0)])  # upsert
    idx.save()
    idx2 = _mk(tmp_path / "ix")
    assert len(idx2) == len(idx) == 199
    assert idx2.get_multivector("doc7", 0) is None
    np.testing.assert_array_equal(idx2.get_multivector("doc9", 0), mvs[3].astype(np.float16).astype(np.float32))
    q = mvs[42][:4]
    r1 = [(r.document_id, s) for r, s in idx.query(q, k=5)]
    assert r1 == [(r.document_id, s) for r, s in idx2.query(q, k=5)]  # the same bits


def test_incremental_saves_across_restarts(tmp_path):
    rng = np.random.default_rng(2)
    idx = _mk(tmp_path / "ix")
    for j in range(5):
        idx.store(_rand_mvs(rng, 20), _recs(20, start=20 * j))
        idx.save()
    idx2 = _mk(tmp_path / "ix")
    assert len(idx2) == 100
    idx2.store(_rand_mvs(rng, 10), _recs(10, start=100))
    idx2.save()
    idx3 = _mk(tmp_path / "ix")
    assert len(idx3) == 110 and idx3.get_multivector("doc105", 0) is not None


def test_tombstone_compaction(tmp_path):
    rng = np.random.default_rng(3)
    idx = _mk(tmp_path / "ix", compact_min_rows=64, compact_dead_fraction=0.3)
    idx.store(_rand_mvs(rng, 100), _recs(100))
    idx.save()
    for i in range(50):
        idx.delete_document(f"doc{i}")
    assert idx.count_rows < 100 and len(idx) == 50  # the trigger fired on the way
    idx.compact()
    assert idx.dead_fraction == 0.0 and idx.count_rows == 50
    idx.save()
    assert (tmp_path / "ix" / "fde.bin").stat().st_size == 50 * CFG.fde_dim * 4
    assert sum(1 for _ in open(tmp_path / "ix" / "records.jsonl")) == 50
    idx2 = _mk(tmp_path / "ix")
    assert len(idx2) == 50
    assert idx2.get_multivector("doc25", 0) is None and idx2.get_multivector("doc75", 0) is not None
    assert len(idx2.query(rng.standard_normal((4, 16)).astype(np.float32), k=5)) == 5


def test_legacy_snapshot_migration(tmp_path):
    """A round-1 layout (meta.json + fde.npy + multivectors/) loads through
    the COMMIT swap and saves in the append-only format."""
    rng = np.random.default_rng(6)
    path = tmp_path / "ix"
    (path / "multivectors").mkdir(parents=True)
    n = 10
    mvs = _rand_mvs(rng, n)
    recs = []
    for i in range(n):
        recs.append({"document_id": f"doc{i}", "chunk_number": 0, "metadata": {"i": i}, "content_key": None,
                     "n_tokens": 8, "alive": i != 4})
        if i != 4:
            np.save(path / "multivectors" / f"{i}.npy", mvs[i].astype(np.float16))
    np.save(path / "fde.npy", rng.standard_normal((n, CFG.fde_dim)).astype(np.float32))
    with open(path / "meta.json", "w") as fh:
        json.dump({"count": n, "fde": {}, "records": recs}, fh)
    idx = _mk(path)
    assert len(idx) == 9 and idx.get_multivector("doc4", 0) is None
    np.testing.assert_array_equal(idx.get_multivector("doc3", 0), mvs[3].astype(np.float16).astype(np.float32))
    assert not (path / "meta.json").exists() and not (path / "multivectors").exists()
    idx.save()
    assert (path / "records.jsonl").exists() and len(_mk(path)) == 9


def test_crash_orphan_truncation(tmp_path):
    """Data appended without its WAL lines (a crash between the two
    writes) is truncated on load, so later appends stay row-aligned."""
    rng = np.random.default_rng(7)
    idx = _mk(tmp_path / "ix")
    idx.store(_rand_mvs(rng, 10), _recs(10))
    idx.save()
    with open(tmp_path / "ix" / "fde.bin", "ab") as fh:
        fh.write(b"\x00" * CFG.fde_dim * 4 * 3)
    with open(tmp_path / "ix" / "mv.bin", "ab") as fh:
        fh.write(b"\x00" * 8 * 16 * 2)
    idx2 = _mk(tmp_path / "ix")
    assert len(idx2) == 10
    idx2.store(_rand_mvs(rng, 5), _recs(5, start=10))
    idx2.save()
    idx3 = _mk(tmp_path / "ix")
    assert len(idx3) == 15
    np.testing.assert_array_equal(idx3.get_multivector("doc12", 0), idx2.get_multivector("doc12", 0))
    np.testing.assert_array_equal(idx3.get_multivector("doc3", 0), idx.get_multivector("doc3", 0))


def test_truncated_wal_line_stops_replay(tmp_path):
    rng = np.random.default_rng(9)
    idx = _mk(tmp_path / "ix")
    idx.store(_rand_mvs(rng, 6), _recs(6))
    idx.save()
    with open(tmp_path / "ix" / "records.jsonl", "a") as fh:
        fh.write('{"op": "add", "document_id": "doc6", "chunk_nu')
    idx2 = _mk(tmp_path / "ix")
    assert len(idx2) == 6 and idx2.get_multivector("doc5", 0) is not None


def test_bounded_rss_mmap_reads(tmp_path):
    """After a save and a reload, rows are read through mmaps: the index
    holds no pending copies."""
    rng = np.random.default_rng(8)
    idx = _mk(tmp_path / "ix")
    idx.store(_rand_mvs(rng, 100), _recs(100))
    idx.save()
    assert idx._mv_pending == [] and idx._fde_pending == []
    idx2 = _mk(tmp_path / "ix")
    assert idx2._mv_pending == [] and idx2._fde_pending == []
    assert isinstance(idx2._mv_mm, np.memmap) and isinstance(idx2._fde_mm, np.memmap)
    assert idx2.get_multivector("doc50", 0).shape == (8, 16)


# ------------------------------- the reference's tests/test_compaction_safety.py


def _fill(idx, n, seed=0, doc_prefix="d"):
    rng = np.random.default_rng(seed)
    mvs = []
    for _ in range(n):
        mv = rng.standard_normal((6, 16)).astype(np.float32)
        mvs.append(mv / np.linalg.norm(mv, axis=-1, keepdims=True))
    idx.store(mvs, [IndexRecord(document_id=f"{doc_prefix}{i}", chunk_number=0) for i in range(n)])
    return mvs


def test_upsert_dirties_cached_mask_blocks():
    """With a multi-block index and a warm device mask, an upsert into a
    lower block must not keep serving the dead row."""
    idx = _mk(device_block_rows=16, compact_min_rows=10_000)
    mvs = _fill(idx, 40)
    q = np.asarray(mvs[0][:4])
    assert idx.query(q, k=1)[0][0].document_id == "d0"
    new = np.random.default_rng(99).standard_normal((6, 16)).astype(np.float32)
    idx.store([new / np.linalg.norm(new, axis=-1, keepdims=True)], [IndexRecord(document_id="d0", chunk_number=0)])
    res = idx.query(q, k=40)
    assert 0 not in [idx._id_to_row[f"{r.document_id}-{r.chunk_number}"] for r, _ in res]
    assert len([s for r, s in res if r.document_id == "d0"]) == 1


@pytest.mark.parametrize("change", [
    {"projection_dimension": 16}, {"num_simhash_projections": 4}, {"seed": 7}, {"num_repetitions": 8},
    {"projection_type": "IDENTITY"},
])
def test_fde_header_mismatch_rejected_for_every_field(tmp_path, change):
    idx = _mk(tmp_path / "ix")
    _fill(idx, 4)
    idx.save()
    with pytest.raises(ValueError, match="different FDE config"):
        MultiVectorIndex(FDEConfig(**{**FDE_KW, **change}), device="cpu", path=tmp_path / "ix")
    assert len(_mk(tmp_path / "ix")) == 4


@pytest.mark.parametrize("commit", [True, False])
def test_compaction_is_crash_safe(tmp_path, commit):
    """A crash after the COMMIT marker and before the swap is completed on
    the next load; an unmarked side build is discarded."""
    path = tmp_path / "ix"
    idx = _mk(path, compact_min_rows=10_000)
    mvs = _fill(idx, 8)
    idx.delete_document("d1")
    idx.delete_document("d2")
    idx.save()
    tmp = path.with_name(path.name + ".compact")
    keep = [r for r in range(idx.count_rows) if idx._alive[r]]
    side = _mk(tmp)
    side.store([np.asarray(idx._mv_row(r), np.float32) for r in keep],
               [IndexRecord(document_id=idx.records[r].document_id, chunk_number=0) for r in keep])
    side.save()
    if commit:
        (tmp / "COMMIT").touch()
    else:
        (tmp / "records.jsonl").write_text("garbage\n")
    re = _mk(path)
    assert not tmp.exists()
    assert len(re) == 6
    assert re.dead_fraction == (0.0 if commit else 0.25)  # swapped in, or the tombstoned original
    assert re.query(np.asarray(mvs[0][:4]), k=1)[0][0].document_id == "d0"


def test_compaction_persistent_roundtrip(tmp_path):
    path = tmp_path / "ix"
    idx = _mk(path, compact_min_rows=4, compact_dead_fraction=0.2)
    mvs = _fill(idx, 10)
    idx.save()
    for d in ("d1", "d2", "d3"):
        idx.delete_document(d)  # crosses the trigger: compacts
    assert idx.dead_fraction == 0.0 and len(idx) == 7
    assert not path.with_name(path.name + ".compact").exists()
    assert idx.query(np.asarray(mvs[0][:4]), k=1)[0][0].document_id == "d0"
    re = _mk(path)
    assert len(re) == 7 and re.query(np.asarray(mvs[0][:4]), k=1)[0][0].document_id == "d0"


def test_compaction_with_zero_survivors(tmp_path):
    """No deleted row resurrects from the old WAL after a compaction that
    keeps nothing."""
    path = tmp_path / "ix"
    idx = _mk(path, compact_min_rows=4, compact_dead_fraction=0.2)
    rng = np.random.default_rng(0)
    idx.store([rng.standard_normal((6, 16)).astype(np.float32) for _ in range(4)],
              [IndexRecord(document_id="bigdoc", chunk_number=i) for i in range(4)])
    idx.save()
    assert idx.delete_document("bigdoc") == 4
    assert len(idx) == 0 and idx.dead_fraction == 0.0
    assert idx.query(np.ones((2, 16), np.float32), k=3) == []
    re = _mk(path)
    assert len(re) == 0 and re.query(np.ones((2, 16), np.float32), k=3) == []


def test_streaming_compaction_bounded_rss(tmp_path):
    """A persistent compaction streams rows mmap -> side files in
    COMPACT_BATCH_ROWS batches: its peak allocation stays far below the
    alive payload (the reference's test at 50k rows, cut to 36k here)."""
    import tracemalloc

    cfg = FDEConfig(dimension=32, num_repetitions=4, num_simhash_projections=3, projection_dimension=16)
    path = tmp_path / "big"
    idx = MultiVectorIndex(cfg, device="cpu", path=path, compact_min_rows=10**9)
    rng = np.random.default_rng(0)
    n, tok, chunk = 36_000, 32, 6_000
    for lo in range(0, n, chunk):
        mvs = [rng.standard_normal((tok, 32)).astype(np.float32) for _ in range(chunk)]
        recs = [IndexRecord(document_id=f"d{(lo + i) // 10}", chunk_number=(lo + i) % 10) for i in range(chunk)]
        idx.store(mvs, recs, fde_vectors=rng.standard_normal((chunk, cfg.fde_dim)).astype(np.float32))
        idx.save()
    for d in range(0, n // 10, 3):
        idx.delete_document(f"d{d}")
    assert idx.dead_fraction > 0.25
    alive_payload = len(idx) * (tok * 32 * 2 + cfg.fde_dim * 4)
    tracemalloc.start()
    tracemalloc.reset_peak()
    idx.compact()
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert peak < alive_payload / 2, f"compaction peak {peak / 1e6:.1f} MB, alive payload {alive_payload / 1e6:.1f} MB"
    assert idx.dead_fraction == 0.0
    re = MultiVectorIndex(cfg, device="cpu", path=path)
    assert len(re) == len(idx)
    assert re.get_multivector("d1", 0) is not None and re.get_multivector("d0", 0) is None


def test_compaction_preserves_n_tokens():
    idx = _mk(compact_min_rows=4, compact_dead_fraction=0.2)
    _fill(idx, 8)
    idx.delete_document("d0")
    idx.delete_document("d1")  # triggers the in-memory compaction
    assert idx.dead_fraction == 0.0 and idx.count_rows == 6
    assert all(r.n_tokens == 6 for r in idx.records)
    assert idx.get_multivector("d5", 0).shape == (6, 16)


# ------------------------------------- the reference's tests/test_pooled_tier.py

TIER_CFG = FDEConfig(dimension=32, num_repetitions=8, num_simhash_projections=4, projection_dimension=8)


def _corpus(rng, n_docs, d=32, tok=(10, 30)):
    concepts = rng.standard_normal((100, d)).astype(np.float32)
    concepts /= np.linalg.norm(concepts, axis=1, keepdims=True)
    mvs, topics = [], []
    for _ in range(n_docs):
        t = rng.choice(100, 3, replace=False)
        x = concepts[rng.choice(t, rng.integers(*tok))]
        x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        mvs.append((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32))
        topics.append(t)
    return concepts, mvs, topics


def _tier(path, refine_iters=3):
    return MultiVectorIndex(TIER_CFG, device="cpu", path=path, pooled_tier_factor=2, pooled_tier_budget_mb=64,
                            rerank_prefilter_pooling=2, prefilter_cap=75, pooled_refine_iters=refine_iters)


def _fill_tier(index, mvs):
    index.store(mvs, [IndexRecord(document_id=f"doc{i}", chunk_number=0, metadata={"i": i}) for i in range(len(mvs))])


def test_pooled_store_reload_runs_no_pooling(tmp_path, monkeypatch):
    """pooled.bin holds each row's pooled vector from ingest, so a reopened
    index builds its device tier without running pool_multivector."""
    concepts, mvs, topics = _corpus(np.random.default_rng(11), 60)
    idx = _tier(tmp_path / "ix")
    _fill_tier(idx, mvs)
    idx.save()
    assert (tmp_path / "ix" / "pooled.bin").exists()
    idx2 = _tier(tmp_path / "ix")
    assert idx2._pooled_store_ok

    def boom(*a, **k):
        raise AssertionError("pool_multivector must not run on reload")

    monkeypatch.setattr(tmi, "pool_multivector", boom)
    res = idx2.query(concepts[topics[17]], k=3, return_timing=True)
    assert idx2.last_timing["pooled_tier"] is True and res[0][0].document_id == "doc17"
    assert [(r.document_id, s) for r, s in res] == [(r.document_id, s) for r, s in idx.query(concepts[topics[17]], k=3)]


def test_pooled_store_config_change_disables_then_heals(tmp_path):
    """A changed refine count disables pooled.bin (rows pooled on the fly,
    answers still right); the next compaction rewrites it."""
    concepts, mvs, topics = _corpus(np.random.default_rng(12), 40)
    idx = _tier(tmp_path / "ix", refine_iters=3)
    _fill_tier(idx, mvs)
    idx.save()
    idx2 = _tier(tmp_path / "ix", refine_iters=0)
    assert not idx2._pooled_store_ok
    res = idx2.query(concepts[topics[9]], k=3, return_timing=True)
    assert idx2.last_timing["pooled_tier"] is True and res[0][0].document_id == "doc9"
    idx2.delete_document("doc0")
    idx2.compact()
    assert idx2._pooled_store_ok
    assert idx2.query(concepts[topics[9]], k=3)[0][0].document_id == "doc9"
    idx3 = _tier(tmp_path / "ix", refine_iters=0)
    assert idx3._pooled_store_ok and idx3.query(concepts[topics[9]], k=3)[0][0].document_id == "doc9"


def test_pooled_store_orphan_truncation(tmp_path):
    concepts, mvs, topics = _corpus(np.random.default_rng(16), 30)
    idx = _tier(tmp_path / "ix")
    _fill_tier(idx, mvs)
    idx.save()
    p = tmp_path / "ix" / "pooled.bin"
    good = p.stat().st_size
    with open(p, "ab") as fh:
        fh.write(b"\x00" * 4096)
    idx2 = _tier(tmp_path / "ix")
    assert idx2._pooled_store_ok and p.stat().st_size == good
    res = idx2.query(concepts[topics[8]], k=3, return_timing=True)
    assert idx2.last_timing["pooled_tier"] is True and res[0][0].document_id == "doc8"
