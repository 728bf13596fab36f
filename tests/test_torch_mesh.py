"""The port's mesh paths on the CPU against the JAX package on its
virtual 8-device mesh (`mesh8`, a (2, 4) data x model mesh).

The port's mesh is `make_mesh((2, 4), devices=["cpu"] * 8)`: one process
drives every shard, on one repeated device, so all the shard math runs
(local top-k and global ids, the head split, the row-parallel int32 sum,
the per-shard pooled rescore, the per-shard forwards). The same seeded
numpy inputs and `ColQwenConfig.tiny()` weights (carried across by
`load_jax_params`) go through both packages.

Tolerances, and why:
- the f32 mesh embed against the JAX mesh embed: the reference's own
  mesh-vs-single bound, rtol 2e-5 / atol 2e-5 (`test_colqwen_model.py`);
  the port measures 6.4e-7;
- the int8 mesh embed: bit-equal to the port's single-device int8 embed
  of the same per-shard batches (the amax all-reduce and the exact int32
  sum make every head and channel compute what one device computes; a
  single-device f32 matmul already differs in the last bit between a
  batch of 2 and one of 3 on the CPU, so the batch each forward sees is
  held fixed), and within the reference's own mesh bound, rtol 2e-2 /
  atol 2e-3 (`test_quantized_serving.py`), of the JAX mesh (9.4e-4
  measured: the packages' f32 matmuls sum in other orders, and an
  activation on a rounding boundary quantizes to a neighbour);
- the searches: the same ids, scores within 1e-6 relative (f32 matvec
  sums in another order); the pooled survivors: the same set (K1's plain
  version sums its int32 products in f32, the reference its einsum over
  dequantized values);
- index queries, mesh against single device: the same ids and scores
  within 1e-5 (the same kernels on the same rows; only the merge differs).
"""

import asyncio
import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from morphik_core_tpu.index import IndexRecord as JRecord, MultiVectorIndex as JIndex
from morphik_core_tpu.models.colqwen import ColQwenConfig as JConfig, ColQwenModel as JModel
from morphik_core_tpu.models.colqwen.model import quantize_colqwen_params as j_quantize
from morphik_core_tpu.ops.fde import FDEConfig as JFDE
from morphik_core_tpu.parallel import mesh as jmesh_mod
from morphik_core_tpu.parallel import search as jsearch
from morphik_core_tpu_torch.config import Settings
from morphik_core_tpu_torch.index.multivector_index import IndexRecord, MultiVectorIndex
from morphik_core_tpu_torch.models.colqwen.config import ColQwenConfig
from morphik_core_tpu_torch.models.colqwen.layers import QuantizedWeight
from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel, load_jax_params, quantize_colqwen_params
from morphik_core_tpu_torch.ops import maxsim as tmaxsim
from morphik_core_tpu_torch.ops.fde import FDEConfig
from morphik_core_tpu_torch.parallel import collectives, mesh as tmesh_mod, search as tsearch
from morphik_core_tpu_torch.parallel.mesh import make_mesh, shard_colqwen_params, text_shard_ranges
from morphik_core_tpu_torch.services_init import build_services

CFG = FDEConfig(dimension=32, num_repetitions=8, num_simhash_projections=4, projection_dimension=8)
JCFG = JFDE(dimension=32, num_repetitions=8, num_simhash_projections=4, projection_dimension=8)
PATCH_GRID = (4, 4)


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh((2, 4), devices=["cpu"] * 8)


# --------------------------------------------------------------------- mesh


@pytest.mark.parametrize("shape,want", [((-1, 4), (2, 4)), ((2, -1), (2, 4)), ((4, 2), (4, 2)), ((1, 1), (1, 1))])
def test_make_mesh_infers_shapes_as_the_reference(shape, want):
    got = make_mesh(shape, devices=["cpu"] * 8)
    ref = jmesh_mod.make_mesh(shape)
    assert got.devices.shape == want == ref.devices.shape
    assert got.shape == dict(ref.shape) == {"data": want[0], "model": want[1]}
    assert got.size == want[0] * want[1] and got.axis_names == ("data", "model")


@pytest.mark.parametrize("shape,match", [
    ((-1, -1), "at most one -1 axis"),
    ((3, -1), "8 devices not divisible by 3"),
    ((4, 4), r"mesh shape \[4, 4\] needs 16 devices, have 8"),
])
def test_make_mesh_refuses_as_the_reference(shape, match):
    with pytest.raises(ValueError, match=match):
        jmesh_mod.make_mesh(shape)
    with pytest.raises(ValueError, match=match):
        make_mesh(shape, devices=["cpu"] * 8)


def test_best_mesh_one_host_and_the_multi_host_refusal(monkeypatch):
    monkeypatch.setattr(tmesh_mod, "local_device_count", lambda: 4)
    mesh = tmesh_mod.best_mesh(model_parallel=2)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.row(1) == [torch.device("cuda", 2), torch.device("cuda", 3)]
    monkeypatch.setattr(tmesh_mod, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="item 6c"):
        tmesh_mod.best_mesh(model_parallel=2)


def test_collectives_keep_device_order_and_one_tensor_a_device():
    parts = [torch.tensor([3.0, 1.0]), torch.tensor([3.0, 5.0]), torch.tensor([0.0, 2.0])]
    gathered = collectives.gather(parts)
    assert gathered.tolist() == [3.0, 1.0, 3.0, 5.0, 0.0, 2.0]
    v, i = tsearch.topk_stable(gathered, 3)  # ties go to the lower device, as all_gather + top_k
    assert i.tolist() == [3, 0, 2]
    maxed = collectives.all_reduce_max(parts)
    assert all(m is maxed[0] for m in maxed)  # one repeated device: one tensor
    assert maxed[2].tolist() == [3.0, 5.0]
    assert collectives.reduce_sum(parts).tolist() == [6.0, 8.0]
    ints = [torch.tensor([2**30], dtype=torch.int32), torch.tensor([2**30 - 1], dtype=torch.int32)]
    assert collectives.reduce_sum(ints).item() == 2**31 - 1  # int32 sums stay exact


@pytest.mark.parametrize("names", [("rows", "cols"), ("model", "data"), ("data",)])
def test_other_axis_names_raise(tmp_path, names):
    """The port serves the mesh axes ("data", "model") only: make_mesh and
    `tpu.auto_mesh` refuse any other `mesh_axis_names` up front."""
    with pytest.raises(ValueError, match="the port serves"):
        make_mesh((2, 4), names, devices=["cpu"] * 8)
    settings = _settings(tmp_path, True)
    settings.tpu.mesh_axis_names = list(names)
    with pytest.raises(ValueError, match="the port serves"):
        build_services(settings, device="cpu")


def test_kernel_launches_make_their_cards_device_current(monkeypatch):
    """A ctypes launch goes to the current device, which PyTorch's guards
    do not set for it: every launch wrapper makes its tensors' card
    current, and raises the kernels' shared-memory limits there before
    its first launch on that card. Spied here on a (2, 1) mesh of two
    cards whose second data row leads on cuda:1 (no card is touched)."""
    from types import SimpleNamespace

    from morphik_core_tpu_torch.ops import _kernels

    mesh = make_mesh((2, 1), devices=["cuda:0", "cuda:1"])
    lead = mesh.row_leads()[1]
    assert lead == torch.device("cuda", 1)
    current, seen = [torch.device("cuda", 0)], []

    class Device:  # stands in for torch.cuda.device
        def __init__(self, d):
            self.d = torch.device(d)

        def __enter__(self):
            self.prev = current[0]
            current[0] = self.d

        def __exit__(self, *exc):
            current[0] = self.prev

    def call(name):
        def fn(*args):
            seen.append((name, current[0]))
            return 0
        return fn

    lib = SimpleNamespace(**{n: call(n) for n in (
        "maxsim_init", "window_attention_init", "maxsim_q8_launch", "maxsim_launch", "window_attention_launch",
        "binary_maxsim_launch")})
    monkeypatch.setattr(_kernels, "library", lambda: lib)
    monkeypatch.setattr(_kernels, "_ready_devices", set())
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_kernels, "count_launch", lambda name: None)

    def t(*shape, device=lead, dtype=torch.bfloat16):
        return SimpleNamespace(shape=shape, device=device, dtype=dtype, data_ptr=lambda: 0)

    plan = SimpleNamespace(q_tile=1, tok_per_split=1, n_splits=1)
    _kernels.launch_window_attention(t(64, 2, 16), t(64, 2, 16), t(64, 2, 16), t(64, 2, 16), 64)
    _kernels.launch_maxsim_q8(t(4, 8), t(4), t(3, 5, 8), t(3, 5), t(3, 5), None, t(12), t(3), plan)
    _kernels.launch_maxsim(t(4, 8), t(3, 5, 8), t(3, 5), None, t(12), t(3), plan)
    _kernels.launch_binary_maxsim(t(4, 1), t(3, 5, 1), t(3), t(3), 8)
    home = torch.device("cuda", 0)
    _kernels.launch_maxsim_q8(t(4, 8, device=home), t(4, device=home), t(3, 5, 8, device=home), t(3, 5, device=home),
                              t(3, 5, device=home), None, t(12, device=home), t(3, device=home), plan)
    assert seen == [
        ("maxsim_init", lead), ("window_attention_init", lead), ("window_attention_launch", lead),
        ("maxsim_q8_launch", lead), ("maxsim_launch", lead), ("binary_maxsim_launch", lead),
        ("maxsim_init", home), ("window_attention_init", home), ("maxsim_q8_launch", home),
    ]
    assert current[0] == home and _kernels._ready_devices == {0, 1}


# ------------------------------------------------------------------- model


@pytest.fixture(scope="module")
def jparams():
    """The tiny JAX model's f32 params (numpy leaves) and the model."""
    jm = JModel.init_random(jax.random.PRNGKey(3), JConfig.tiny(), dtype=np.float32)
    return jm, jax.device_get(jm.params)


def _port(tree, precision="bf16", mesh=None):
    model = ColQwenModel(ColQwenConfig.tiny(), device="cpu", dtype=torch.float32, matmul_precision=precision,
                         mesh=mesh)
    load_jax_params(model, tree)
    return model


def _patches(b, seed=0):
    cfg = JConfig.tiny()
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, PATCH_GRID[0] * PATCH_GRID[1] * cfg.vision.merge_unit,
                                cfg.vision.patch_input_dim)).astype(np.float32)


def _shard_of(arr, device):
    return np.asarray(next(s.data for s in arr.addressable_shards if s.device == device))


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_shard_colqwen_params_leaves_match_the_reference(jparams, mesh8, tmesh, precision):
    """Every tensor-parallel leaf of each model shard equals the JAX
    leaf's shard for that model index, W8A8 leaves included (q8 follows
    the weight, the per-channel scales the output channels). K/V are the
    exception: the reference splits k_w / v_w's 24 columns 4 ways (half
    heads, resharded by GSPMD), the port gives each shard the whole KV
    head its query heads read, so they are held to that slice of the
    unsharded leaf. Biases and norms are replicated in the reference; a
    shard holds its columns of q/k/v's biases."""
    _, tree = jparams
    tm = _port(tree, precision, tmesh)
    params = jax.jit(j_quantize)(tree) if precision == "int8" else tree  # as JModel quantizes: under jit
    jsharded = jmesh_mod.shard_colqwen_params(params, mesh8)
    full = params["text"]["layers"]
    cfg = ColQwenConfig.tiny().text
    for li, layer in enumerate(tm.text.layers):
        assert len(layer.shards) == 4  # one a model index: the 8 devices are one
        for j in range(4):
            sh = layer.shards[f"{j}@cpu"]
            ranges = text_shard_ranges(cfg, 4, j)
            for name, split in tmesh_mod.COLQWEN_TEXT_SPECS.items():
                leaf = getattr(sh, name)
                lo, hi = ranges[name]
                if precision == "int8":
                    assert isinstance(leaf, QuantizedWeight)
                    got_q, got_s = leaf.q8[: leaf.k, : leaf.n].numpy(), leaf.s.numpy()
                    if name in ("k_w", "v_w"):
                        want_q, want_s = np.asarray(full[name]["q8"][li])[:, lo:hi], np.asarray(full[name]["s"][li])[lo:hi]
                    else:
                        jl = jsharded["text"]["layers"][name]
                        want_q = _shard_of(jl["q8"], mesh8.devices[0, j])[li]
                        want_s = _shard_of(jl["s"], mesh8.devices[0, j])[li]
                    np.testing.assert_array_equal(got_q, want_q)
                    np.testing.assert_array_equal(got_s, want_s)
                else:
                    want = (np.asarray(full[name][li])[:, lo:hi] if name in ("k_w", "v_w")
                            else _shard_of(jsharded["text"]["layers"][name], mesh8.devices[0, j])[li])
                    np.testing.assert_array_equal(leaf.detach().numpy(), want)
            for name in ("q_b", "k_b", "v_b"):
                lo, hi = ranges[name[0] + "_w"]
                np.testing.assert_array_equal(getattr(sh, name).numpy(), np.asarray(full[name][li])[lo:hi])
        # the replicated norms are the model's own tensors (one CPU device: no copy)
        assert layer._norms[torch.device("cpu")][0] is layer.input_ln


def test_replicated_leaves_are_one_tensor_on_a_repeated_device(jparams, tmesh):
    tm = _port(jparams[1], "int8", tmesh)
    visual, embed, proj_w, proj_b = tm._replicas[torch.device("cpu")]
    assert visual is tm.visual and embed is tm.text.embed and proj_w is tm.proj_w and proj_b is tm.proj_b
    assert tm.text._norms[torch.device("cpu")] is tm.text.norm
    with pytest.raises(ValueError, match="quantize before sharding"):
        quantize_colqwen_params(_port(jparams[1], "bf16", tmesh))
    with pytest.raises(ValueError, match="already on a mesh"):
        shard_colqwen_params(tm, tmesh)


@pytest.fixture(scope="module")
def jmesh_f32(jparams, mesh8):
    jm, tree = jparams
    return JModel(JConfig.tiny(), jm.params, dtype=jnp.float32, mesh=mesh8)


def test_mesh_embed_f32_matches_the_reference_mesh(jparams, jmesh_f32, tmesh):
    """A batch of 3 pads to the data axis (2) by repeating its last page
    and comes back as 3 rows."""
    patches = _patches(3)
    got = _port(jparams[1], "bf16", tmesh).embed_image_batch(patches, *PATCH_GRID)
    want = jmesh_f32.embed_image_batch(patches, *PATCH_GRID)
    assert got.shape == want.shape == (3, len(jmesh_f32.image_sequence_ids(16)), 16)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    single = _port(jparams[1], "bf16").embed_image_batch(patches, *PATCH_GRID)
    np.testing.assert_allclose(got, single, rtol=2e-5, atol=2e-5)


def test_int8_mesh_embed_is_the_single_device_embed(jparams, mesh8, tmesh):
    """Bit-equal to the single-device int8 model on the same per-shard
    batches ([p0, p1] and the padded [p2, p2]); within the reference's
    mesh bound of the JAX int8 mesh."""
    patches = _patches(3, seed=1)
    mesh_model, single = _port(jparams[1], "int8", tmesh), _port(jparams[1], "int8")
    got = mesh_model.embed_image_batch(patches, *PATCH_GRID)
    want = np.concatenate([single.embed_image_batch(patches[:2], *PATCH_GRID),
                           single.embed_image_batch(patches[[2, 2]], *PATCH_GRID)[:1]])
    np.testing.assert_array_equal(got, want)
    jq = JModel(JConfig.tiny(), jparams[0].params, dtype=jnp.float32, matmul_precision="int8", mesh=mesh8)
    np.testing.assert_allclose(got, jq.embed_image_batch(patches, *PATCH_GRID), rtol=2e-2, atol=2e-3)
    as_device = mesh_model.embed_image_batch(patches, *PATCH_GRID, as_device=True)
    assert as_device.device == tmesh.first_device and as_device.shape[0] == 3


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_mesh_queries_match(jparams, jmesh_f32, mesh8, tmesh, precision):
    """The tensor-parallel decoder on the first data row: int8 queries
    bit-equal to the single-device ones, f32 queries within 2e-5 of the
    JAX mesh's."""
    queries = ["quarterly revenue", "a longer query about the table of contents " * 3]
    got = _port(jparams[1], precision, tmesh).embed_queries(queries)
    single = _port(jparams[1], precision).embed_queries(queries)
    if precision == "int8":
        for g, s in zip(got, single):
            np.testing.assert_array_equal(g, s)
    else:
        for g, w in zip(got, jmesh_f32.embed_queries(queries)):
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)


def test_mesh_model_whole_kv_heads_on_a_model_axis_of_two(jparams):
    """A (4, 2) mesh: 2 query heads a shard, one KV head each (the other
    split of the tiny config), f32 within 2e-5 of one device."""
    mesh = make_mesh((4, 2), devices=["cpu"] * 8)
    tm = _port(jparams[1], "bf16", mesh)
    assert [(sh.n_heads, sh.n_kv, sh.kv_index.tolist()) for sh in tm.text.layers[0].shards.values()] == [
        (2, 1, [0, 0]), (2, 1, [0, 0])]
    patches = _patches(5, seed=2)  # pads to 8: four data shards of 2
    got = tm.embed_image_batch(patches, *PATCH_GRID)
    np.testing.assert_allclose(got, _port(jparams[1], "bf16").embed_image_batch(patches, *PATCH_GRID),
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------- searches


def _jshard(mesh8, x, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh8, spec))


def _tshards(tmesh, x):
    return tmesh_mod.data_sharding(tmesh, torch.from_numpy(np.ascontiguousarray(x)))


def test_sharded_search_matches_the_reference(mesh8, tmesh):
    rng = np.random.default_rng(5)
    f = rng.standard_normal((256, 48)).astype(np.float32)
    q = rng.standard_normal(48).astype(np.float32)
    mask = (rng.random(256) > 0.3).astype(np.float32)
    jv, ji = jsearch.make_sharded_search(mesh8, 20)(_jshard(mesh8, f, P("data", None)), jnp.asarray(q),
                                                    _jshard(mesh8, mask, P("data")))
    tv, ti = tsearch.make_sharded_search(tmesh, 20)(_tshards(tmesh, f), torch.from_numpy(q), _tshards(tmesh, mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


def _blocks(rng, n_blocks, B, D, n_docs):
    out = []
    for _ in range(n_blocks):
        f = rng.standard_normal((B, D)).astype(np.float32)
        q8, s = jsearch.quantize_rows_int8(f)
        out.append(dict(f=f, q8=q8, s=s, mask=(rng.random(B) > 0.2).astype(np.float32),
                        codes=rng.integers(0, n_docs, B).astype(np.int32)))
    return out


@pytest.mark.parametrize("quantized", [True, False])
def test_mesh_block_search_matches_the_reference(mesh8, tmesh, quantized):
    rng = np.random.default_rng(6)
    n_blocks, B, D, k = 3, 128, 40, 32
    blocks = _blocks(rng, n_blocks, B, D, n_docs=20)
    allowed = (rng.random(256) > 0.4).astype(np.float32)
    q = rng.standard_normal(D).astype(np.float32)
    qq, qs = jsearch.quantize_rows_int8(q[None])
    jfn = jsearch.make_mesh_block_search(mesh8, n_blocks, k, quantized)
    tfn = tsearch.make_mesh_block_search(tmesh, n_blocks, k, quantized)
    jrows, jvec = (lambda x: _jshard(mesh8, x, P("data", None))), (lambda x: _jshard(mesh8, x, P("data")))
    jm, jc = tuple(jvec(b["mask"]) for b in blocks), tuple(jvec(b["codes"]) for b in blocks)
    tm, tc = [_tshards(tmesh, b["mask"]) for b in blocks], [_tshards(tmesh, b["codes"].astype(np.int64)) for b in blocks]
    if quantized:
        want = jfn(jnp.asarray(qq[0]), jnp.asarray(qs[0]), jnp.asarray(allowed),
                   tuple(jrows(b["q8"]) for b in blocks), tuple(jvec(b["s"]) for b in blocks), jm, jc)
        got = tfn(torch.from_numpy(qq[0]), torch.tensor(qs[0]), torch.from_numpy(allowed),
                  [_tshards(tmesh, b["q8"]) for b in blocks], [_tshards(tmesh, b["s"]) for b in blocks], tm, tc)
    else:
        want = jfn(jnp.asarray(q), jnp.asarray(allowed), tuple(jrows(b["f"]) for b in blocks), jm, jc)
        got = tfn(torch.from_numpy(q), torch.from_numpy(allowed), [_tshards(tmesh, b["f"]) for b in blocks], tm, tc)
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_array_equal(got[k:], want[k:])  # the same global row ids
    np.testing.assert_allclose(got[:k], want[:k], rtol=1e-6)


def test_mesh_block_search_pooled_matches_the_reference(mesh8, tmesh):
    """The same survivors, through K1's plain version on the CPU; rows of
    a fully masked pooled row (a tombstone) score 0 on both sides."""
    rng = np.random.default_rng(7)
    n_blocks, B, D, T, dim = 2, 256, 40, 8, 16
    blocks = _blocks(rng, n_blocks, B, D, n_docs=30)
    pooled = []
    for b in blocks:
        dense = rng.standard_normal((B, T, dim)).astype(np.float32)
        dense[:, 5:] = 0.0  # padded tokens
        dense[b["mask"] == 0] = 0.0  # tombstones: no tokens at all
        q8, s = jsearch.quantize_rows_int8(dense)
        pooled.append((q8, s * (np.abs(dense).max(axis=-1) > 0)))
    q = rng.standard_normal(D).astype(np.float32)
    qq, qs = jsearch.quantize_rows_int8(q[None])
    qmv = rng.standard_normal((6, dim)).astype(np.float32)
    q8p, qsp = tmaxsim.quantize_query_q8(qmv)
    allowed = np.ones(256, np.float32)
    for pool, pool_true, m, guard in ((64, 50, 16, 8), (128, 100, 32, 16)):
        jfn = jsearch.make_mesh_block_search_pooled(mesh8, n_blocks, pool, pool_true, m, guard)
        want = np.asarray(jfn(
            jnp.asarray(qq[0]), jnp.asarray(qs[0]), jnp.asarray(allowed),
            tuple(_jshard(mesh8, b["q8"], P("data", None)) for b in blocks),
            tuple(_jshard(mesh8, b["s"], P("data")) for b in blocks),
            tuple(_jshard(mesh8, b["mask"], P("data")) for b in blocks),
            tuple(_jshard(mesh8, b["codes"], P("data")) for b in blocks),
            tuple(_jshard(mesh8, p[0], P("data", None, None)) for p in pooled),
            tuple(_jshard(mesh8, p[1], P("data", None)) for p in pooled),
            jnp.asarray(q8p), jnp.asarray(qsp)))
        tfn = tsearch.make_mesh_block_search_pooled(tmesh, n_blocks, pool, pool_true, m, guard)
        got = tfn(torch.from_numpy(qq[0]), torch.tensor(qs[0]), torch.from_numpy(allowed),
                  [_tshards(tmesh, b["q8"]) for b in blocks], [_tshards(tmesh, b["s"]) for b in blocks],
                  [_tshards(tmesh, b["mask"]) for b in blocks],
                  [_tshards(tmesh, b["codes"].astype(np.int64)) for b in blocks],
                  [_tshards(tmesh, p[0]) for p in pooled], [_tshards(tmesh, p[1]) for p in pooled],
                  [_tshards(tmesh, (p[1] > 0).astype(np.float32)) for p in pooled],
                  torch.from_numpy(q8p), torch.from_numpy(qsp)).numpy()
        assert set(got[m:].tolist()) == set(want[m:].tolist())
        np.testing.assert_array_equal(got[m : m + guard], want[m : m + guard])  # the guarded FDE head, in order


# ------------------------------------------------------------------- index


def _corpus(rng, n_docs, d=32, tok=(10, 30)):
    concepts = rng.standard_normal((100, d)).astype(np.float32)
    concepts /= np.linalg.norm(concepts, axis=1, keepdims=True)
    mvs, topics = [], []
    for _ in range(n_docs):
        t = rng.choice(100, 3, replace=False)
        x = concepts[rng.choice(t, rng.integers(*tok))]
        x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        mvs.append(x.astype(np.float32))
        topics.append(t)
    return concepts, mvs, topics


def _fill(index, mvs, record=IndexRecord):
    return index.store(mvs, [record(document_id=f"doc{i}", chunk_number=0, metadata={"i": i})
                             for i in range(len(mvs))])


def _ids(res):
    return [(r.document_id, round(s, 3)) for r, s in res]


def test_mesh_sharded_query_matches_single(mesh8, tmesh):
    """Twin of tests/test_index.py::test_mesh_sharded_query_matches_single,
    and the JAX mesh index's answer."""
    rng = np.random.default_rng(4)
    concepts, mvs, topics = _corpus(rng, 64)
    single, meshed = MultiVectorIndex(CFG, device="cpu"), MultiVectorIndex(CFG, mesh=tmesh)
    jmeshed = JIndex(JCFG, mesh=mesh8)
    for idx in (single, meshed):
        _fill(idx, mvs)
    _fill(jmeshed, mvs, JRecord)
    q = concepts[topics[42]]
    assert _ids(single.query(q, k=8)) == _ids(meshed.query(q, k=8))
    assert [r.document_id for r, _ in meshed.query(q, k=8)] == [r.document_id for r, _ in jmeshed.query(q, k=8)]
    assert meshed.device == torch.device("cpu") and len(meshed._dev_blocks[0][0]) == 2


def test_mesh_refresh_is_tail_incremental(tmesh):
    """Twin of tests/test_index.py::test_mesh_refresh_is_tail_incremental."""
    rng = np.random.default_rng(7)
    _, mvs, _ = _corpus(rng, 48)
    idx = MultiVectorIndex(CFG, mesh=tmesh, device_block_rows=16)
    _fill(idx, mvs[:32])
    idx.query(mvs[0][:4], k=4)
    assert idx.last_mesh_upload_rows == 32  # cold: everything uploads
    idx.query(mvs[1][:4], k=4)
    assert idx.last_mesh_upload_rows == 0  # warm: nothing re-uploads
    idx.store(mvs[32:48], [IndexRecord(document_id=f"tail{i}", chunk_number=0) for i in range(16)])
    idx.query(mvs[2][:4], k=4)
    assert 0 < idx.last_mesh_upload_rows <= 16 + 16  # tail + one partial block
    assert len(idx) == 48
    odd = MultiVectorIndex(CFG, mesh=make_mesh((3, 1), devices=["cpu"] * 3), device_block_rows=16)
    _fill(odd, mvs[:20])
    with pytest.raises(ValueError, match="not divisible by mesh data axis 3"):
        odd.query(mvs[0], k=2)


def test_mesh_filtered_query_matches_single(tmesh):
    """Twin of tests/test_index.py::test_mesh_filtered_query_matches_single;
    a delete and an overwrite dirty the mesh masks."""
    rng = np.random.default_rng(8)
    concepts, mvs, topics = _corpus(rng, 40)
    single, meshed = MultiVectorIndex(CFG, device="cpu"), MultiVectorIndex(CFG, mesh=tmesh)
    for idx in (single, meshed):
        _fill(idx, mvs)
    q = concepts[topics[9]]
    allowed = [f"doc{i}" for i in range(0, 40, 2)]
    r1, r2 = _ids(single.query(q, k=6, doc_ids=allowed)), _ids(meshed.query(q, k=6, doc_ids=allowed))
    assert r1 == r2 and all(d in allowed for d, _ in r1)
    top = r1[0][0]
    for idx in (single, meshed):
        idx.delete_document(top)
        idx.store([mvs[3]], [IndexRecord(document_id="doc3", chunk_number=0)])  # an overwrite
    r1, r2 = _ids(single.query(q, k=6, doc_ids=allowed)), _ids(meshed.query(q, k=6, doc_ids=allowed))
    assert r1 == r2 and top not in {d for d, _ in r2}


def _tier(mesh=None, **kw):
    return MultiVectorIndex(CFG, device="cpu" if mesh is None else None, mesh=mesh, pooled_tier_factor=2,
                            pooled_tier_budget_mb=64, rerank_prefilter_pooling=2, **kw)


def test_mesh_pooled_tier_matches_single(tmesh):
    """Twin of tests/test_pooled_tier.py::test_mesh_pooled_tier_matches_single."""
    rng = np.random.default_rng(13)
    concepts, mvs, topics = _corpus(rng, 96)
    single, meshed = _tier(prefilter_cap=75), _tier(tmesh, prefilter_cap=75)
    for idx in (single, meshed):
        _fill(idx, mvs)
    assert single._tier_active() and meshed._tier_active()
    for t in (5, 41, 77):
        q = concepts[topics[t]] + 0.05 * rng.standard_normal((3, 32)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        rs = single.query(q, k=5, return_timing=True)
        assert single.last_timing["pooled_tier"] is True
        rm = meshed.query(q, k=5, return_timing=True)
        assert meshed.last_timing["pooled_tier"] is True
        assert [r.document_id for r, _ in rs] == [r.document_id for r, _ in rm]
        np.testing.assert_allclose([s for _, s in rs], [s for _, s in rm], rtol=1e-5, atol=1e-5)
        assert rs[0][0].document_id == f"doc{t}"


def test_mesh_pooled_tier_filtered_and_tail_refresh(tmesh):
    """Twin of tests/test_pooled_tier.py::test_mesh_pooled_tier_filtered_and_tail_refresh."""
    rng = np.random.default_rng(14)
    concepts, mvs, topics = _corpus(rng, 60)
    idx = _tier(tmesh)
    _fill(idx, mvs)
    allowed = [f"doc{i}" for i in range(0, 60, 3)]
    res = idx.query(concepts[topics[7]], k=8, doc_ids=allowed, return_timing=True)
    assert idx.last_timing["pooled_tier"] is True
    assert res and all(r.document_id in allowed for r, _ in res)
    n_before, rows_before = len(idx._pooled_blocks), idx._pooled_rows
    idx.store([mvs[3]], [IndexRecord(document_id="newdoc", chunk_number=0)])
    res = idx.query(concepts[topics[3]], k=4)
    assert "newdoc" in {r.document_id for r, _ in res}
    assert idx._pooled_rows == rows_before + 1 and len(idx._pooled_blocks) >= n_before
    float_mesh = _tier(tmesh, ann_dtype="float32")
    _fill(float_mesh, mvs)
    assert not float_mesh._tier_active()  # the mesh tier is int8-ANN only, as the reference's
    assert [r.document_id for r, _ in float_mesh.query(concepts[topics[7]], k=3)][0] == "doc7"


def test_mesh_pool_cut_is_exact_not_padded(mesh8, tmesh):
    """Twin of tests/test_pooled_tier.py::test_mesh_pool_cut_is_exact_not_padded,
    and the JAX mesh index's survivors."""
    rng = np.random.default_rng(15)
    concepts, mvs, topics = _corpus(rng, 200)
    kw = dict(prefilter_cap=40)
    single, meshed = _tier(**kw), _tier(tmesh, **kw)
    jmeshed = JIndex(JCFG, mesh=mesh8, pooled_tier_factor=2, pooled_tier_budget_mb=64, rerank_prefilter_pooling=2,
                     **kw)
    for idx in (single, meshed):
        _fill(idx, mvs)
    _fill(jmeshed, mvs, JRecord)
    for t in (11, 99, 180):
        q = concepts[topics[t]].astype(np.float32)
        surv_s = single._ann_pooled_topm(single._encode_query(q), q, None, 40, 16)
        surv_m = meshed._ann_pooled_topm(meshed._encode_query(q), q, None, 40, 16)
        surv_j = jmeshed._mesh_pooled_topm(jmeshed._encode_query(q), q, None, 40, 16)
        assert set(surv_s) == set(surv_m) == set(surv_j), f"survivor sets diverged for doc{t}"
        assert [r.document_id for r, _ in single.query(q, k=5)] == [r.document_id for r, _ in meshed.query(q, k=5)]


def test_mesh_index_saves_the_single_device_files(tmp_path, tmesh):
    """A mesh index writes the same bytes as a single-device one, and
    either reopens the other's files with the same answers."""
    rng = np.random.default_rng(16)
    concepts, mvs, topics = _corpus(rng, 40)
    for name, mesh in (("single", None), ("mesh", tmesh)):
        idx = _tier(mesh, path=tmp_path / name)
        _fill(idx, mvs)
        idx.query(concepts[topics[1]], k=3)
        idx.delete_document("doc4")
        idx.save()
    for f in ("header.json", "records.jsonl", "fde.bin", "mv.bin", "pooled.bin"):
        assert (tmp_path / "single" / f).read_bytes() == (tmp_path / "mesh" / f).read_bytes(), f
    q = concepts[topics[9]]
    assert _ids(_tier(tmesh, path=tmp_path / "single").query(q, k=5)) == _ids(
        _tier(path=tmp_path / "mesh").query(q, k=5))


# ------------------------------------------------------------------ server


def _call(base, path, body=None, ctype="application/json"):
    data = json.dumps(body).encode() if isinstance(body, dict) else body
    req = urllib.request.Request(base + path, data=data, method="POST" if data is not None else "GET",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _pattern_pngs():
    """Twin of tests/test_mesh_serving.py::_images, drawn with numpy."""
    from morphik_core_tpu_torch.utils.png import encode_png

    specs = [("grid", (20, 90, 170)), ("bands", (170, 40, 30)), ("dots", (30, 150, 60)),
             ("cross", (120, 30, 160)), ("frame", (200, 160, 20))]
    out = []
    yy, xx = np.mgrid[0:336, 0:448]
    for name, color in specs:
        img = np.full((336, 448, 3), 255, np.uint8)
        if name == "grid":
            sel = (xx % 56) < 6
        elif name == "bands":
            sel = (yy % 48) <= 20
        elif name == "dots":
            sel = (((xx - 28) % 84 - 15) ** 2 + ((yy - 28) % 84 - 15) ** 2) <= 225
        elif name == "cross":
            sel = ((xx >= 200) & (xx <= 250)) | ((yy >= 150) & (yy <= 200))
        else:
            sel = ((xx >= 10) & (xx < 24)) | ((xx > 424) & (xx <= 438)) | ((yy >= 10) & (yy < 24)) | (
                (yy > 312) & (yy <= 326))
        img[sel] = color
        out.append((name, encode_png(img)))
    return out


def _settings(root, mesh: bool) -> Settings:
    return Settings.from_dict({
        "api": {"port": 0},
        "storage": {"storage_path": str(root / "storage")},
        "database": {"path": str(root / "db.sqlite")},
        "telemetry": {"telemetry_dir": str(root / "logs" / "telemetry")},
        "tpu": {"auto_mesh": mesh, "mesh_shape": [4, 2]},
        "vector_store": {"index_path": str(root / "index"), "fde_num_repetitions": 8,
                         "fde_num_simhash_projections": 4, "fde_projection_dimension": 8,
                         "device_block_rows": 2048},
    })


def test_mesh_server_ingest_query_parity(tmp_path):
    """Twin of tests/test_mesh_serving.py on the port's HTTP server, with
    an explicit [4, 2] CPU mesh (auto_mesh builds none on the CPU): the
    same identically seeded tiny int8 model single-device and on the
    mesh, the same filenames in the same order, scores within 1e-2."""
    from morphik_core_tpu_torch.api.app import build_app
    from morphik_core_tpu_torch.api.http import HTTPServer

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout=300)

    mesh = make_mesh((4, 2), devices=["cpu"] * 8)
    servers = []
    try:
        for name, m in (("single", None), ("mesh", mesh)):
            services = build_services(_settings(tmp_path / name, m is not None), mesh=m, device="cpu")
            run(services.initialize())
            srv = HTTPServer(build_app(services), "127.0.0.1", 0)
            run(srv.start())
            servers.append((f"http://127.0.0.1:{srv.port}", services, srv))
        (base_s, svc_s, _), (base_m, svc_m, _) = servers
        assert svc_m.colpali_vector_store.mesh is mesh and svc_m.colpali_embedding_model.model.mesh is mesh
        assert dict(zip(mesh.axis_names, svc_m.colpali_vector_store.mesh.devices.shape)) == {"data": 4, "model": 2}
        assert svc_s.colpali_vector_store.mesh is None
        images = _pattern_pngs()
        boundary = "mesh-test-boundary"
        for base in (base_s, base_m):
            docs = []
            for name, png in images:
                body = (f'--{boundary}\r\nContent-Disposition: form-data; name="metadata"\r\n\r\n'
                        f'{json.dumps({"pattern": name})}\r\n--{boundary}\r\nContent-Disposition: form-data; '
                        f'name="file"; filename="{name}.png"\r\nContent-Type: image/png\r\n\r\n').encode() + png + \
                    f"\r\n--{boundary}--\r\n".encode()
                docs.append(_call(base, "/ingest/file", body, f"multipart/form-data; boundary={boundary}")["external_id"])
            deadline = time.time() + 120
            while not all(_call(base, f"/documents/{d}/status")["status"] == "completed" for d in docs):
                assert time.time() < deadline
                time.sleep(0.05)
        for query in ("striped bands pattern", "dotted texture", "frame border"):
            body = {"query": query, "k": 5, "use_colpali": True, "output_format": "text"}
            rs, rm = _call(base_s, "/retrieve/chunks", body), _call(base_m, "/retrieve/chunks", body)
            assert rs and len(rs) == len(rm)
            assert [c["filename"] for c in rs] == [c["filename"] for c in rm]
            for a, b in zip(rs, rm):
                assert abs(a["score"] - b["score"]) < 1e-2 * max(1.0, abs(a["score"]))
        import base64

        name, png = images[2]
        top = _call(base_m, "/retrieve/chunks", {"query_image": "data:image/png;base64," + base64.b64encode(png).decode(),
                                                 "k": 1, "use_colpali": True, "output_format": "text"})
        assert top and top[0]["filename"] == f"{name}.png"
        rm = _call(base_m, "/retrieve/chunks", {"query": "pattern", "k": 3, "use_colpali": True,
                                                "filters": {"pattern": {"$in": ["grid", "cross"]}},
                                                "output_format": "text"})
        assert rm and all(c["filename"] in ("grid.png", "cross.png") for c in rm)
        blocks = svc_m.colpali_vector_store._indexes["default"]._dev_blocks
        assert blocks and len(blocks[0][0]) == 4  # the sharded device state served
    finally:
        for _, services, srv in servers:
            run(srv.stop())
            run(services.shutdown())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)
        loop.close()


def test_auto_mesh_on_the_cpu_serves_single_device(tmp_path):
    """auto_mesh no longer raises; on the CPU (no card) no mesh is built."""
    services = build_services(_settings(tmp_path, True), device="cpu")
    assert services.colpali_vector_store.mesh is None
    assert services.colpali_embedding_model.model.mesh is None


def test_a_given_model_must_be_on_the_services_mesh(tmp_path, jparams, tmesh):
    settings = _settings(tmp_path, False)
    settings.model.static_act_scales = False
    with pytest.raises(ValueError, match="the given model is on mesh None"):
        build_services(settings, mesh=tmesh, colqwen_model=_port(jparams[1], "int8"), device="cpu")
