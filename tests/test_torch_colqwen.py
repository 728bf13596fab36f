"""Parity of the port's ColQwen2.5 (models/colqwen/) and ColPali
embedder with the JAX package, on the committed tiny trained fixture
(`tests/fixtures/tiny_colqwen.npz`) and `ColQwenConfig.tiny()`.

- config, preprocessing, mrope and vision-rotary tables: numpy mirrors,
  identical;
- in f32, the tolerances of tests/test_colqwen_parity.py: 2e-4 for the
  vision tower, 5e-4 end to end (matmuls and softmax sum in another
  order; the u8 patch expansion may fuse into an FMA on one side).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from morphik_core_tpu.models.colqwen import ColQwenModel as JModel
from morphik_core_tpu.models.colqwen import config as jconfig
from morphik_core_tpu.models.colqwen import preprocess as jpre
from morphik_core_tpu.models.colqwen import text as jtext
from morphik_core_tpu.models.colqwen import vision as jvision
from morphik_core_tpu.models.colqwen.model import expand_patches_u8 as j_expand, load_params_npz
from morphik_core_tpu.ops.fde import FDEConfig as JFDEConfig, fde_document_batch as j_fde_batch
from morphik_core_tpu_torch.embedding.colpali_embedding_model import ColpaliEmbeddingModel
from morphik_core_tpu_torch.models.colqwen import config as tconfig
from morphik_core_tpu_torch.models.colqwen import preprocess as tpre
from morphik_core_tpu_torch.models.colqwen import text as ttext
from morphik_core_tpu_torch.models.colqwen import vision as tvision
from morphik_core_tpu_torch.models.colqwen.model import (
    ColQwenModel as TModel,
    expand_patches_u8 as t_expand,
    load_config_npz,
    load_jax_params,
)
from morphik_core_tpu_torch.ops.fde import FDEConfig as TFDEConfig

torch.set_num_threads(2)

FIXTURE = Path(__file__).parent / "fixtures" / "tiny_colqwen.npz"


@pytest.fixture(scope="module")
def models():
    return JModel.from_fixture(FIXTURE), TModel.from_fixture(FIXTURE, device="cpu")


@pytest.mark.parametrize("which", ["tiny", "default"])
def test_config_asdict_equal(which):
    j = jconfig.ColQwenConfig.tiny() if which == "tiny" else jconfig.ColQwenConfig()
    t = tconfig.ColQwenConfig.tiny() if which == "tiny" else tconfig.ColQwenConfig()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.vision.head_dim, j.vision.window_units, j.text.head_dim) == (
        t.vision.head_dim, t.vision.window_units, t.text.head_dim)


@pytest.mark.parametrize("size", [(448, 336), (1000, 700), (90, 2000), (2480, 3508)])
def test_preprocess_mirrors_identical(size):
    rng = np.random.default_rng(sum(size))
    img = Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8))
    for kw in ({}, dict(min_pixels=3136, max_pixels=602112)):
        assert jpre.smart_resize(size[1], size[0], **kw) == tpre.smart_resize(size[1], size[0], **kw)
        (ju, jg), (tu, tg) = jpre.preprocess_image_u8(img, **kw), tpre.preprocess_image_u8(img, **kw)
        assert jg == tg and ju.dtype == tu.dtype == np.uint8
        np.testing.assert_array_equal(ju, tu)
    (jf, jg), (tf, tg) = jpre.preprocess_image(img), tpre.preprocess_image(img)
    assert jg == tg
    np.testing.assert_array_equal(jf, tf)


@pytest.mark.parametrize("grid", [(4, 4), (4, 8), (20, 28)])
def test_rotary_tables_identical(grid):
    for cfg_j, cfg_t in ((jconfig.ColQwenConfig.tiny(), tconfig.ColQwenConfig.tiny()),
                         (jconfig.ColQwenConfig(), tconfig.ColQwenConfig())):
        for a, b in zip(jvision.vision_rotary_cos_sin(*grid, cfg_j.vision),
                        tvision.vision_rotary_cos_sin(*grid, cfg_t.vision)):
            np.testing.assert_array_equal(a, b)
    cfg_j, cfg_t = jconfig.ColQwenConfig.tiny(), tconfig.ColQwenConfig.tiny()
    n = grid[0] * grid[1]
    ids = np.array([[7, 9, cfg_j.vision_start_token_id] + [cfg_j.image_token_id] * n + [11, 12]] * 2)
    mask = np.ones(ids.shape, np.float32)
    mask[1, -3:] = 0
    for m in (None, mask):
        pj = jtext.mrope_position_ids(ids, cfg_j.image_token_id, [(1, *grid)] * 2, attention_mask=m)
        pt = ttext.mrope_position_ids(ids, cfg_t.image_token_id, [(1, *grid)] * 2, attention_mask=m)
        np.testing.assert_array_equal(pj, pt)
        for a, b in zip(jtext.mrope_cos_sin(pj, cfg_j.text), ttext.mrope_cos_sin(pt, cfg_t.text)):
            np.testing.assert_array_equal(a, b)


def test_expand_patches_u8_matches_jax():
    u8 = np.random.default_rng(0).integers(0, 256, (2, 16, 588), dtype=np.uint8)
    want = np.asarray(j_expand(jnp.asarray(u8), jnp.float32))
    got = t_expand(torch.from_numpy(u8), torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("grid", [(4, 4), (4, 8)])
def test_vision_tower_matches_jax(models, grid):
    jm, tm = models
    rng = np.random.default_rng(1)
    patches = rng.standard_normal((1, grid[0] * grid[1] * 4, 1176)).astype(np.float32)
    cos, sin = jvision.vision_rotary_cos_sin(*grid, jm.cfg.vision)
    want = np.asarray(jvision.vision_forward(
        jm.params["visual"], jnp.asarray(patches), jnp.asarray(cos), jnp.asarray(sin), *grid, jm.cfg.vision))
    with torch.no_grad():
        got = tm.visual(torch.from_numpy(patches), torch.from_numpy(cos), torch.from_numpy(sin), *grid).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_image_embeddings_match_jax(models):
    jm, tm = models
    u8 = np.random.default_rng(2).integers(0, 256, (2, 4 * 8 * 4, 588), dtype=np.uint8)
    want = jm.embed_image_batch(u8, 4, 8)
    got = tm.embed_image_batch(u8, 4, 8)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def test_query_embeddings_match_jax(models):
    jm, tm = models
    queries = ["revenue", "a considerably longer query about quarterly revenue growth " * 2, "x"]
    for a, b in zip(jm.embed_queries(queries), tm.embed_queries(queries)):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=5e-4, atol=5e-4)


def test_embedder_fused_fde_matches_jax(models):
    """`_embed_prepped(with_fde=True)`: bucket grouping, order, and the
    on-device document FDE of the fresh multivectors."""
    jm, tm = models
    rng = np.random.default_rng(3)
    grids = [(4, 4), (4, 8), (4, 4)]
    prepped = [(rng.integers(0, 256, (g[0] * g[1] * 4, 588), dtype=np.uint8), g) for g in grids]
    emb = ColpaliEmbeddingModel(tm, batch_size=2, fde_config=TFDEConfig(dimension=32))
    embs, fdes = emb._embed_prepped(prepped, with_fde=True)
    for (p, g), e, f in zip(prepped, embs, fdes):
        je = jm.embed_image_batch(p[None], *g)
        np.testing.assert_allclose(e, je[0], rtol=5e-4, atol=5e-4)
        jf = np.asarray(j_fde_batch(jnp.asarray(je), jnp.ones(je.shape[:2]), JFDEConfig(dimension=32)))[0]
        np.testing.assert_allclose(f, jf, rtol=1e-3, atol=1e-3)
    assert emb.embed_query("quarterly revenue").shape[1] == tm.cfg.embedding_dim
    assert emb.embed_images([Image.new("RGB", (448, 336), (255, 255, 255))])[0].shape[1] == 32


def test_load_jax_params_rejects_mismatch():
    tree = load_params_npz(FIXTURE)
    tm = TModel(load_config_npz(FIXTURE), device="cpu", dtype=torch.float32)
    bad = dict(tree, proj_w=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError):
        load_jax_params(tm, bad)
    with pytest.raises(KeyError):
        load_jax_params(tm, {k: v for k, v in tree.items() if k != "proj_b"})


def test_init_random_follows_reference_law():
    tm = TModel.init_random(tconfig.ColQwenConfig.tiny(), seed=3, device="cpu")
    again = TModel.init_random(tconfig.ColQwenConfig.tiny(), seed=3, device="cpu")
    assert torch.equal(tm.text.embed, again.text.embed)
    assert torch.all(tm.visual.blocks[0].norm1 == 1) and torch.all(tm.text.layers[0].q_b == 0)
    std = float(tm.text.layers[0].gate_w.std())
    assert 0.017 < std < 0.023
