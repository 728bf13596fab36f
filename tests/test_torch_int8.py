"""Parity of the port's W8A8 serving mode (int8 weights and activations,
static activation scales) with the JAX package, on the committed tiny
trained fixture (`tests/fixtures/tiny_colqwen.npz`).

Tolerances, and why:
- weight and activation quantization: bit-identical to the reference
  as it runs, under `jax.jit` (same f32 arithmetic, round half to even,
  clip);
- `q8_matmul` / `linear_multi`: the int32 product is exact on both sides
  and the epilogue runs in the same order, so f32 rounding only: rtol
  1e-6, atol 1e-6;
- one tower block on identical inputs (vision) and the text decoder and
  query embeddings: the f32 tolerances of tests/test_torch_colqwen.py,
  2e-4 per tower and 5e-4 end to end;
- the chained vision tower, the page embeddings and the calibration
  maxima: an activation that lies within f32 rounding of a .5 step
  quantizes to neighbouring integers in the two packages (their f32
  matmuls sum in another order), and that one step then propagates. Per
  block on identical inputs no step differs; over whole pages a few do.
  So page embeddings are held by per-token cosine (mean > 0.999, every
  token > 0.98) and the calibration maxima at rtol 5e-5 (measured: most
  entries within 5e-7, the largest gap 2.7e-5 at a site downstream of
  such a step). Measured cosines: mean 0.9997, min 0.994 with the same
  weights; mean 0.9995, min 0.990 after each package calibrates for
  itself, since static scales that differ by ~1e-5 shift every
  activation a little and make such steps more frequent.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphik_core_tpu.index import IndexRecord as JRecord, MultiVectorIndex as JIndex
from morphik_core_tpu.models.colqwen import ColQwenModel as JModel
from morphik_core_tpu.models.colqwen import layers as jl
from morphik_core_tpu.models.colqwen import text as jtext
from morphik_core_tpu.models.colqwen import vision as jvision
from morphik_core_tpu.models.colqwen.calibrate import (
    attach_vision_act_scales as j_attach,
    calibrate_model_from_rendered_pages as j_calibrate_rendered,
    capture_vision_act_maxes as j_capture,
    render_calibration_pages as j_render,
)
from morphik_core_tpu.ops.fde import FDEConfig as JFDE
from morphik_core_tpu_torch.embedding import colpali_embedding_model as temb
from morphik_core_tpu_torch.index.multivector_index import IndexRecord as TRecord, MultiVectorIndex as TIndex
from morphik_core_tpu_torch.models.colqwen import calibrate as tcal
from morphik_core_tpu_torch.models.colqwen import layers as tl
from morphik_core_tpu_torch.models.colqwen.model import (
    ColQwenModel as TModel,
    load_config_npz,
    load_jax_params,
    quantize_colqwen_params,
)
from morphik_core_tpu_torch.ops.fde import FDEConfig as TFDE

torch.set_num_threads(2)

FIXTURE = Path(__file__).parent / "fixtures" / "tiny_colqwen.npz"
DIM = 32  # the fixture's embedding width
SHIPPED = dict(
    prefilter_multiplier=30, prefilter_cap=300, ann_dtype="int8", device_cache_slots=2048,
    device_cache_token_bucket=1024, rerank_dtype="int8", rerank_prefilter_pooling=4,
    pooled_tier_factor=32, pooled_tier_budget_mb=6144, query_token_dedup=0.98,
)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def int8_models():
    """The JAX int8 fixture model and the port model loaded from its
    already-quantized tree."""
    jm = JModel.from_fixture(FIXTURE, matmul_precision="int8")
    tm = TModel(load_config_npz(FIXTURE), device="cpu", dtype=torch.float32, matmul_precision="int8")
    load_jax_params(tm, jax.device_get(jm.params))
    return jm, tm


@pytest.fixture(scope="module")
def calibrated():
    """Both packages calibrated on the same committed pages, the JAX side
    through its own startup function (it renders the pages with PIL)."""
    jm = JModel.from_fixture(FIXTURE, matmul_precision="int8")
    j_calibrate_rendered(jm)
    tm = TModel.from_fixture(FIXTURE, device="cpu", matmul_precision="int8")
    emb = temb.ColpaliEmbeddingModel(tm, batch_size=8, fde_config=TFDE(dimension=DIM))
    return jm, tm, emb


def _cosine_close(a: np.ndarray, b: np.ndarray) -> None:
    assert a.shape == b.shape
    cos = (a * b).sum(-1)  # rows are unit-norm
    assert float(cos.mean()) > 0.999 and float(cos.min()) > 0.98, (float(cos.mean()), float(cos.min()))


# -- quantization -----------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 3420), (3, 48, 96), (3420, 64)])
def test_quantize_weight_int8_bit_identical(shape):
    w = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32) * 0.02
    w[..., 5] = 0.0  # an all-zero output channel takes scale 1
    jq = jax.jit(jl.quantize_weight_int8)(jnp.asarray(w))
    q8, s = tl.quantize_weight_int8(_t(w))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq["q8"]))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jq["s"]))
    if len(shape) == 3:  # stacked == per layer
        for li in range(shape[0]):
            np.testing.assert_array_equal(tl.quantize_weight_int8(_t(w[li]))[0].numpy(), q8[li].numpy())


@pytest.mark.parametrize("a_scale", [None, 0.004])
def test_quantize_act_int8_bit_identical(a_scale):
    x = np.random.default_rng(1).standard_normal((3, 9, 3420)).astype(np.float32)
    x[1, 2] = 0.0  # a zero row takes dynamic scale 1
    ja = None if a_scale is None else jnp.float32(a_scale)
    ta = None if a_scale is None else torch.tensor(a_scale, dtype=torch.float32)
    jq, js = jax.jit(jl.quantize_act_int8)(jnp.asarray(x), ja)
    tq, ts = tl.quantize_act_int8(_t(x), ta)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))  # static 0.004 clips most entries
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("m", [5, 40])
@pytest.mark.parametrize("k,n", [(3420, 64), (64, 3420), (48, 96)])
@pytest.mark.parametrize("static", [False, True])
def test_q8_matmul_and_linear_multi_match_jax(m, k, n, static):
    """Including K or N = 3420 (padded to 3424 in the leaf) and M < 17
    (rows padded for the int8 GEMM)."""
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((2, m, k)).astype(np.float32)
    ws = [rng.standard_normal((k, n)).astype(np.float32) * 0.02 for _ in range(2)]
    bs = [rng.standard_normal(n).astype(np.float32), None]
    a_scale = float(np.abs(x).max() / 127.0) if static else None
    jws = [dict(jax.jit(jl.quantize_weight_int8)(jnp.asarray(w))) for w in ws]
    tws = [tl.QuantizedWeight.from_float(_t(w)) for w in ws]
    if static:
        jws[0]["as"] = jnp.float32(a_scale)
        tws[0].set_act_scale(a_scale)
    assert tws[0].q8.shape == (-(-k // 8) * 8, -(-n // 8) * 8) and tws[0].q8.t().is_contiguous()
    want = np.asarray(jax.jit(jl.q8_matmul)(jnp.asarray(x), jws[0]["q8"], jws[0]["s"], jnp.asarray(bs[0]),
                                            jws[0].get("as")))
    got = tl.q8_matmul(_t(x), tws[0], _t(bs[0]), tws[0].a_scale).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tl.linear(_t(x), tws[0], _t(bs[0])).numpy(), want, rtol=1e-6, atol=1e-6)
    jouts = jax.jit(jl.linear_multi)(jnp.asarray(x), jws, [None if b is None else jnp.asarray(b) for b in bs])
    touts = tl.linear_multi(_t(x), tws, [None if b is None else _t(b) for b in bs])
    for a, b in zip(jouts, touts):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)


# -- towers -------------------------------------------------------------------


@pytest.mark.parametrize("static", [False, True])
def test_vision_blocks_match_jax_on_identical_inputs(int8_models, static):
    jm, tm = int8_models
    p = jm.params["visual"]
    if static:
        maxes = np.random.default_rng(0).uniform(2.0, 6.0, (jm.cfg.vision.depth, 4)).astype(np.float32)
        p = j_attach(p, maxes)
        tm = TModel(tm.cfg, device="cpu", dtype=torch.float32, matmul_precision="int8")
        load_jax_params(tm, dict(jax.device_get(jm.params), visual=jax.device_get(p)))
        assert float(tm.visual.blocks[2].up_w.a_scale) == float(np.asarray(p["blocks"]["up_w"]["as"])[2])
    grid = (4, 8)
    patches = np.random.default_rng(1).standard_normal((1, grid[0] * grid[1] * 4, 1176)).astype(np.float32)
    cos, sin = jvision.vision_rotary_cos_sin(*grid, jm.cfg.vision)
    x = np.asarray(jvision.to_window_order(jnp.asarray(patches) @ p["patch_embed_w"], *grid, 4))
    for li in range(jm.cfg.vision.depth):
        layer = jax.tree_util.tree_map(lambda w: w[li], p["blocks"])
        full = li in jm.cfg.vision.fullatt_block_indexes
        want = np.asarray(jvision._block(jnp.asarray(x), layer, full, jnp.asarray(cos), jnp.asarray(sin),
                                         jm.cfg.vision))
        with torch.no_grad():
            got = tm.visual.blocks[li](_t(x), full, _t(cos), _t(sin)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        x = want


def test_text_decoder_and_queries_match_jax(int8_models):
    jm, tm = int8_models
    rng = np.random.default_rng(2)
    b, s = 2, 40
    embeds = rng.standard_normal((b, s, jm.cfg.text.hidden_size)).astype(np.float32)
    mask = np.ones((b, s), np.float32)
    mask[1, 30:] = 0
    pos = jtext.mrope_position_ids(np.zeros((b, s), np.int64), -1, [None] * b, attention_mask=mask)
    cos, sin = jtext.mrope_cos_sin(pos, jm.cfg.text)
    want = np.asarray(jtext.text_forward(jm.params["text"], jnp.asarray(embeds), jnp.asarray(cos),
                                         jnp.asarray(sin), jnp.asarray(mask), jm.cfg.text))
    with torch.no_grad():
        got = tm.text(_t(embeds), _t(cos), _t(sin), _t(mask)).numpy()
    np.testing.assert_allclose(got * mask[..., None], want * mask[..., None], rtol=2e-4, atol=2e-4)
    queries = ["revenue", "a considerably longer query about quarterly revenue growth " * 2, "x"]
    for a, b_ in zip(jm.embed_queries(queries), tm.embed_queries(queries)):
        np.testing.assert_allclose(b_, a, rtol=5e-4, atol=5e-4)


def test_image_embeddings_track_jax(int8_models):
    jm, tm = int8_models
    for seed in (2, 3):
        u8 = np.random.default_rng(seed).integers(0, 256, (2, 4 * 8 * 4, 588), dtype=np.uint8)
        _cosine_close(tm.embed_image_batch(u8, 4, 8), jm.embed_image_batch(u8, 4, 8))


def test_float_tree_into_int8_model_equals_jax_quantization(int8_models):
    jm, tm = int8_models
    tq = TModel.from_fixture(FIXTURE, device="cpu", matmul_precision="int8")
    for a, b in ((tq.visual.blocks[1].down_w, tm.visual.blocks[1].down_w), (tq.text.layers[2].k_w, tm.text.layers[2].k_w)):
        assert torch.equal(a.q8, b.q8) and torch.equal(a.s, b.s) and a.a_scale is None
    np.testing.assert_array_equal(tm.text.layers[0].gate_w.q8.numpy(),
                                  np.asarray(jm.params["text"]["layers"]["gate_w"]["q8"][0]))


def test_quantize_in_place_and_precision_checks():
    tm = TModel.from_fixture(FIXTURE, device="cpu")
    ref = TModel.from_fixture(FIXTURE, device="cpu", matmul_precision="int8")
    assert quantize_colqwen_params(tm) is tm and tm.matmul_precision == "int8"
    blk = tm.visual.blocks[0]
    assert isinstance(blk.q_w, tl.QuantizedWeight) and blk.q_w.q8.dtype == torch.int8
    assert torch.equal(blk.q_w.q8, ref.visual.blocks[0].q_w.q8)
    assert blk.norm1.dtype == torch.float32 and tm.text.embed.dtype == torch.float32
    assert not isinstance(tm.visual.merger.fc1_w, tl.QuantizedWeight)
    assert not any(n.endswith("q_w") for n, _ in tm.named_parameters())
    with pytest.raises(ValueError):
        quantize_colqwen_params(tm)
    cfg = load_config_npz(FIXTURE)
    for kw in (dict(matmul_precision="fp8"), dict(attention_precision="int4"), dict(attention_precision="fp16")):
        with pytest.raises(ValueError):
            TModel(cfg, device="cpu", **kw)
    jq = jax.device_get(JModel.from_fixture(FIXTURE, matmul_precision="int8").params)
    with pytest.raises(ValueError):
        load_jax_params(TModel(cfg, device="cpu", dtype=torch.float32), jq)
    # the embedder serves the model's precision: a float model is not calibrated
    assert "calibration_s" not in temb.ColpaliEmbeddingModel(TModel.from_fixture(FIXTURE, device="cpu")).last_metrics


# -- calibration ---------------------------------------------------------------


def test_calibration_fixture_rerenders_exactly():
    """The committed pages are the JAX renderer's pages through the port's
    preprocessing, byte for byte; the port's renderer draws the same."""
    u8, grid = tcal.load_calibration_pages()
    assert u8.shape == (16, 1920, 588) and u8.dtype == np.uint8 and grid == (24, 20)
    j_pages = j_render()
    again, grid2 = tcal.pages_to_fixture(j_pages)
    assert grid2 == grid and again.tobytes() == u8.tobytes()
    for a, b in zip(j_pages, tcal.render_calibration_pages()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_capture_and_attach_match_jax(int8_models):
    jm, tm = int8_models
    u8, grid = tcal.load_calibration_pages()
    batches = tcal.calibration_batches(u8[:4], 2)
    j_act, j_qk = j_capture(jm.params["visual"], batches, *grid, jm.cfg.vision)
    t_act, t_qk = tcal.capture_vision_act_maxes(tm, batches, *grid)
    assert t_act.shape == (4, 4) and t_qk.shape == (4, 2)
    np.testing.assert_allclose(t_act, np.asarray(j_act), rtol=5e-5)
    np.testing.assert_allclose(t_qk, np.asarray(j_qk), rtol=5e-5)
    # the same maxima attach bit-identical scales
    j_vis = j_attach(jm.params["visual"], np.asarray(j_act), 1.05)
    tq = TModel(tm.cfg, device="cpu", dtype=torch.float32, matmul_precision="int8")
    load_jax_params(tq, jax.device_get(jm.params))
    tcal.attach_vision_act_scales(tq, np.asarray(j_act), 1.05)
    for name in ("q_w", "k_w", "v_w", "proj_w", "gate_w", "up_w", "down_w"):
        want = np.asarray(j_vis["blocks"][name]["as"])
        got = np.array([blk.get_submodule(name).a_scale.item() for blk in tq.visual.blocks], np.float32)
        np.testing.assert_array_equal(got, want)
    assert all(layer.q_w.a_scale is None for layer in tq.text.layers)


def test_calibrated_model_matches_jax(calibrated):
    jm, tm, emb = calibrated
    assert emb.last_metrics["calibration_s"] > 0
    want = np.asarray(jm.params["visual"]["blocks"]["gate_w"]["as"])
    got = np.array([blk.gate_w.a_scale.item() for blk in tm.visual.blocks], np.float32)
    np.testing.assert_allclose(got, want, rtol=5e-5)
    u8 = np.random.default_rng(4).integers(0, 256, (2, 4 * 8 * 4, 588), dtype=np.uint8)
    _cosine_close(tm.embed_image_batch(u8, 4, 8), jm.embed_image_batch(u8, 4, 8))


def test_calibration_failure_raises(monkeypatch):
    """A failed calibration stops the embedder (the reference would log it
    and serve dynamic quantization): here, pages of a grid that is not a
    multiple of the 4-unit window."""
    u8, _ = tcal.load_calibration_pages()
    monkeypatch.setattr(temb, "load_calibration_pages", lambda: (u8[:2, :100], (5, 5)))
    with pytest.raises(ValueError):
        temb.ColpaliEmbeddingModel(TModel.from_fixture(FIXTURE, device="cpu", matmul_precision="int8"))


def _same_ranking(ra, rb, rtol):
    """Scores within rtol; ids equal at every rank whose score stands
    more than twice that apart from its neighbours."""
    sa = np.array([s for _, s in ra])
    np.testing.assert_allclose([s for _, s in rb], sa, rtol=rtol, atol=1e-3)
    ia, ib = [r.document_id for r, _ in ra], [r.document_id for r, _ in rb]
    gap = 2 * rtol * np.abs(sa).max()
    for i in range(len(sa)):
        if (i == 0 or sa[i - 1] - sa[i] > gap) and (i == len(sa) - 1 or sa[i] - sa[i + 1] > gap):
            assert ia[i] == ib[i], (ia, ib)


def test_slice_int8_static_matches_jax(calibrated):
    """The shipped serving mode end to end: four rendered text pages
    through the calibrated int8 embedders, stored beside synthetic rows,
    queried with the shipped retrieval config. Page scores carry the page
    embeddings' per-token gap (cosine above): rtol 1e-2."""
    jm, _, emb = calibrated
    u8, grid = tcal.load_calibration_pages()
    pages = u8[[0, 5, 10, 15]]
    rng = np.random.default_rng(0)
    rows = []
    for _ in range(60):
        x = rng.standard_normal((int(rng.integers(40, 140)), DIM)).astype(np.float32)
        rows.append(x / np.linalg.norm(x, axis=1, keepdims=True))
    t_pages, t_fdes = emb._embed_prepped([(p, grid) for p in pages], with_fde=True)
    j_pages = list(jm.embed_image_batch(pages, *grid))
    for a, b in zip(t_pages, j_pages):
        _cosine_close(a, b)
    ji = JIndex(JFDE(dimension=DIM), device_block_rows=32, **SHIPPED)
    ti = TIndex(TFDE(dimension=DIM), device="cpu", device_block_rows=32, **SHIPPED)
    ji.store(j_pages + rows, [JRecord(f"doc{i}", 0) for i in range(64)])
    ti.store(t_pages, [TRecord(f"doc{i}", 0) for i in range(4)], fde_vectors=np.stack(t_fdes))
    ti.store(rows, [TRecord(f"doc{i}", 0) for i in range(4, 64)])
    texts = ("rotor torque", "SPEC-9174 valve", "quarterly revenue")
    queries = [(jm.embed_queries([t])[0], emb.embed_query(t)) for t in texts]
    queries += [(j_pages[i], t_pages[i]) for i in range(4)] + [(rows[40], rows[40])]
    for jq, tq in queries:
        _same_ranking(ji.query(jq, k=5), ti.query(tq, k=5), rtol=1e-2)
    for i in range(4):
        assert ti.query(t_pages[i], k=1)[0][0].document_id == f"doc{i}"
    assert ti.query(rows[40], k=1)[0][0].document_id == "doc44"
