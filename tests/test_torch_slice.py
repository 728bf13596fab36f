"""The ingest -> retrieve slice end to end in both packages: the fixture
model embeds pages (uint8 patches) and text queries, the index stores
them beside synthetic rows and answers queries with the shipped
retrieval config of `morphik_tpu.toml` (int8 ANN, prefilter 30 / 300,
pooled tier factor 32, int8 rerank through a 2048-slot device cache of
bucket 1024, query dedup 0.98), then again with the index's code
default `rerank_dtype="bf16"`.

Tolerances:
- index on identical inputs: same ids; scores within f32 rounding
  (the JAX CPU path dequantizes, the port keeps the kernel's exact
  int32 dot): rtol 1e-5, atol 1e-4;
- whole slice (each package embeds for itself, embeddings agree to
  5e-4): scores atol 5e-3, ids equal wherever the score gap to the next
  rank exceeds that; `np.argsort` in the reference is unstable, so
  near-ties compare as sets.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from morphik_core_tpu.index import IndexRecord as JRecord, MultiVectorIndex as JIndex
from morphik_core_tpu.models.colqwen import ColQwenModel as JModel
from morphik_core_tpu.ops.fde import FDEConfig as JFDE
from morphik_core_tpu_torch.embedding.colpali_embedding_model import ColpaliEmbeddingModel
from morphik_core_tpu_torch.index.multivector_index import IndexRecord as TRecord, MultiVectorIndex as TIndex
from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel as TModel
from morphik_core_tpu_torch.ops.fde import FDEConfig as TFDE

torch.set_num_threads(2)

FIXTURE = Path(__file__).parent / "fixtures" / "tiny_colqwen.npz"
DIM = 32  # the fixture's embedding width
SHIPPED = dict(
    prefilter_multiplier=30, prefilter_cap=300, ann_dtype="int8", device_cache_slots=2048,
    device_cache_token_bucket=1024, rerank_dtype="int8", rerank_prefilter_pooling=4,
    pooled_tier_factor=32, pooled_tier_budget_mb=6144, query_token_dedup=0.98,
)
QUERIES = ["quarterly revenue", "table of contents", "signature page"]


def _synthetic(rng, n):
    """Concept-structured unit multivectors (well-separated topics)."""
    concepts = rng.standard_normal((60, DIM)).astype(np.float32)
    concepts /= np.linalg.norm(concepts, axis=1, keepdims=True)
    rows, topics = [], []
    for _ in range(n):
        t = rng.choice(60, 3, replace=False)
        x = concepts[rng.choice(t, int(rng.integers(40, 140)))]
        x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        rows.append((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32))
        topics.append(t)
    return concepts, rows, topics


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    pages = rng.integers(0, 256, (4, 4 * 4 * 4, 588), dtype=np.uint8)
    concepts, rows, topics = _synthetic(rng, 60)
    jm = JModel.from_fixture(FIXTURE)
    tm = TModel.from_fixture(FIXTURE, device="cpu")
    return dict(pages=pages, concepts=concepts, rows=rows, topics=topics, jm=jm, tm=tm,
                j_pages=list(jm.embed_image_batch(pages, 4, 4)),
                t_pages=list(tm.embed_image_batch(pages, 4, 4)))


def _build(mvs, **over):
    kw = dict(SHIPPED, **over)
    ji = JIndex(JFDE(dimension=DIM), device_block_rows=32, **kw)
    ti = TIndex(TFDE(dimension=DIM), device="cpu", device_block_rows=32, **kw)
    ji.store(mvs, [JRecord(f"doc{i}", 0) for i in range(len(mvs))])
    ti.store(mvs, [TRecord(f"doc{i}", 0) for i in range(len(mvs))])
    return ji, ti


def _same_ranking(ra, rb, atol):
    sa = np.array([s for _, s in ra])
    sb = np.array([s for _, s in rb])
    np.testing.assert_allclose(sb, sa, rtol=0, atol=atol)
    ia = [r.document_id for r, _ in ra]
    ib = [r.document_id for r, _ in rb]
    assert len(ia) == len(ib)
    # ranks strictly above the last score group are a set-equal prefix
    cut = [i for i in range(len(sa)) if sa[i] - sa[-1] > 2 * atol]
    assert {ia[i] for i in cut} == {ib[i] for i in cut}
    for i in range(len(sa) - 1):
        if sa[i] - sa[i + 1] > 2 * atol and (i == 0 or sa[i - 1] - sa[i] > 2 * atol):
            assert ia[i] == ib[i]


@pytest.mark.parametrize("rerank_dtype", ["int8", "bf16"])
def test_index_matches_jax_on_identical_inputs(corpus, rerank_dtype):
    """The same multivectors and queries into both indexes (64 rows over
    2 device blocks): text queries, a self-query, a filtered query and a
    query after a delete."""
    mvs = corpus["j_pages"] + corpus["rows"]
    ji, ti = _build(mvs, rerank_dtype=rerank_dtype)
    rng = np.random.default_rng(1)
    queries = list(corpus["jm"].embed_queries(QUERIES))
    for t in (5, 31):
        q = corpus["concepts"][corpus["topics"][t]] + 0.05 * rng.standard_normal((3, DIM)).astype(np.float32)
        queries.append(q / np.linalg.norm(q, axis=1, keepdims=True))
    queries.append(corpus["rows"][17])  # self-query, > 64 tokens: dedup runs
    for q in queries:
        ra, rb = ji.query(q, k=5, return_timing=True), ti.query(q, k=5, return_timing=True)
        assert ji.last_timing["pooled_tier"] and ti.last_timing["pooled_tier"]
        assert [r.document_id for r, _ in ra] == [r.document_id for r, _ in rb]
        np.testing.assert_allclose([s for _, s in rb], [s for _, s in ra], rtol=1e-5, atol=1e-4)
    assert rb[0][0].document_id == f"doc{4 + 17}"
    allowed = [f"doc{i}" for i in range(0, 64, 3)]
    ra, rb = ji.query(queries[3], k=5, doc_ids=allowed), ti.query(queries[3], k=5, doc_ids=allowed)
    assert [r.document_id for r, _ in ra] == [r.document_id for r, _ in rb]
    assert all(r.document_id in allowed for r, _ in rb)
    top = rb[0][0].document_id
    assert ji.delete_document(top) == ti.delete_document(top) == 1
    ra, rb = ji.query(queries[3], k=5), ti.query(queries[3], k=5)
    assert [r.document_id for r, _ in ra] == [r.document_id for r, _ in rb]
    assert top not in [r.document_id for r, _ in rb]


def test_slice_end_to_end_matches_jax(corpus):
    """Each package embeds pages and queries with the fixture weights and
    serves them from its own index (shipped config, fused ingest FDE on
    the port side)."""
    jm, tm = corpus["jm"], corpus["tm"]
    emb = ColpaliEmbeddingModel(tm, batch_size=8, fde_config=TFDE(dimension=DIM))
    t_pages, t_fdes = emb._embed_prepped([(p, (4, 4)) for p in corpus["pages"]], with_fde=True)
    rows = corpus["rows"]
    kw = dict(SHIPPED)
    ji = JIndex(JFDE(dimension=DIM), device_block_rows=32, **kw)
    ti = TIndex(TFDE(dimension=DIM), device="cpu", device_block_rows=32, **kw)
    ji.store(corpus["j_pages"] + rows, [JRecord(f"doc{i}", 0) for i in range(64)])
    ti.store(t_pages, [TRecord(f"doc{i}", 0) for i in range(4)], fde_vectors=np.stack(t_fdes))
    ti.store(rows, [TRecord(f"doc{i}", 0) for i in range(4, 64)])
    for text in QUERIES:
        ra = ji.query(jm.embed_queries([text])[0], k=5)
        rb = ti.query(emb.embed_query(text), k=5)
        _same_ranking(ra, rb, atol=5e-3)
    ra, rb = ji.query(rows[40], k=5), ti.query(rows[40], k=5)
    assert ra[0][0].document_id == rb[0][0].document_id == "doc44"
    _same_ranking(ra, rb, atol=5e-3)
