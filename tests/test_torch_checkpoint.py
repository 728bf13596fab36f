"""Real checkpoints in the port, against the JAX package and the HF
packages on the CPU: the safetensors reader and writer
(`models/colqwen/safetensors.py`) against the `safetensors` package,
`from_hf_config`, `convert.py` against the reference's, `from_checkpoint`
with a `tokenizer.json` against the reference's, the int8 QK^T of
`attention_precision="int8"` with its calibrated `attn_qk_as` scales, a
tiny `Qwen2_5_VLForConditionalGeneration` saved by `transformers`, and a
server whose `model.checkpoint_path` is set.

Tolerances, and why:
- files, converted trees and int8 tensors: identical (the same bytes;
  f32 leaves bit for bit, bf16 leaves by their 16-bit storage);
- checkpoint-loaded f32 embeddings: 5e-4 end to end, as
  tests/test_torch_colqwen.py;
- int8 QK^T scores: the integer product is exact on both sides and the
  scale epilogue runs in the same order, so the attention outputs differ
  by f32 rounding of the softmax and PV only: rtol 1e-5, atol 1e-6;
- whole int8-attention models: the int8 tolerance of
  tests/test_torch_int8.py (per-token cosine, mean > 0.999, each token
  > 0.98): an activation within f32 rounding of a .5 step quantizes to
  neighbouring integers in the two packages;
- the HF model's hidden states before the projection: f32, 2e-4 per
  tower and 5e-4 end to end, as tests/test_colqwen_parity.py.
"""

import dataclasses
import json
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from morphik_core_tpu.models.colqwen import ColQwenModel as JModel
from morphik_core_tpu.models.colqwen import layers as jl
from morphik_core_tpu.models.colqwen import vision as jvision
from morphik_core_tpu.models.colqwen.calibrate import attach_vision_act_scales as j_attach
from morphik_core_tpu.models.colqwen.calibrate import capture_vision_act_maxes as j_capture
from morphik_core_tpu.models.colqwen.config import ColQwenConfig as JConfig
from morphik_core_tpu.models.colqwen.convert import convert_state_dict as j_convert
from morphik_core_tpu.models.colqwen.convert import load_hf_checkpoint as j_load_hf
from morphik_core_tpu_torch.models.colqwen import calibrate as tcal
from morphik_core_tpu_torch.models.colqwen import layers as tl
from morphik_core_tpu_torch.models.colqwen import safetensors as tst
from morphik_core_tpu_torch.models.colqwen.config import ColQwenConfig
from morphik_core_tpu_torch.models.colqwen.convert import (
    convert_state_dict,
    hf_tensors,
    write_hf_checkpoint,
)
from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel as TModel
from morphik_core_tpu_torch.models.colqwen.model import load_config_npz, load_jax_params
from morphik_core_tpu_torch.models.colqwen.text import mrope_cos_sin, mrope_position_ids
from morphik_core_tpu_torch.models.colqwen.vision import vision_rotary_cos_sin
from morphik_core_tpu_torch.models.colqwen.tokenizer import QwenTokenizer
from test_checkpoint_load import _write_checkpoint as j_write_flat_checkpoint

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "tiny_colqwen.npz"
TOKENIZER = ROOT / "tests" / "fixtures" / "tokenizer_bpe.json"
QUERIES = ["quarterly revenue growth", "Table of Contents", "it's the SIGNATURE page", "<|im_start|>x"]


def _qwen_ids(cfg):
    """A config with Qwen2.5's vocab and special ids (the fixture
    tokenizer's ids index its embedding)."""
    return dataclasses.replace(cfg, image_token_id=151655, vision_start_token_id=151652, vision_end_token_id=151653)


TINY_QWEN = _qwen_ids(ColQwenConfig.tiny(vocab_size=151936))


def _np(t: torch.Tensor) -> np.ndarray:
    """A port leaf as numpy, bf16 as ml_dtypes.bfloat16 (the reference's)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _same_bits(got: np.ndarray, want: np.ndarray, name: str) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, (name, got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), name


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _model_leaves(model) -> dict:
    """A float model's parameters under the reference tree's leaf names,
    the per-layer ones stacked as the tree stacks them."""
    out, stacks = {}, {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[1:2] in (["blocks"], ["layers"]):  # drop the layer index
            stacks.setdefault("/".join(parts[:2] + parts[3:]), []).append(p.detach())
        else:
            out["/".join(parts)] = p.detach()
    return out | {name: torch.stack(xs) for name, xs in stacks.items()}


# -- safetensors ----------------------------------------------------------------


_NP_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": ml_dtypes.bfloat16, "I8": np.int8, "U8": np.uint8,
              "I32": np.int32, "I64": np.int64}


def _tensors(seed: int, kinds) -> dict:
    """Seeded tensors of 0-3 dims, one per kind."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, kind in enumerate(kinds):
        shape = tuple(int(d) for d in rng.integers(1, 5, int(rng.integers(0, 4))))
        x = rng.standard_normal(shape) * 10 if kind[0] in "FB" else rng.integers(0 if kind == "U8" else -100, 100, shape)
        out[f"t{i}.{kind}"] = np.asarray(x).astype(_NP_DTYPES[kind])
    return out


_ALL_KINDS = ("F32", "F16", "BF16", "I8", "U8", "I32", "I64")


@pytest.mark.parametrize("kinds", [(k,) * 3 for k in _ALL_KINDS] + [_ALL_KINDS * 2])
def test_reader_equals_package(tmp_path, kinds):
    from safetensors.numpy import load_file, save_file

    tensors = _tensors(len(kinds), kinds)
    save_file(tensors, str(tmp_path / "x.safetensors"))
    want = load_file(str(tmp_path / "x.safetensors"))
    got = tst.load_file(tmp_path / "x.safetensors")
    assert sorted(got) == sorted(want)
    for name in want:
        _same_bits(_np(got[name]), want[name], name)


def test_sharded_reader_equals_package(tmp_path):
    from safetensors.numpy import save_file

    shards = [_tensors(1, _ALL_KINDS), {f"b{k}": v for k, v in _tensors(2, _ALL_KINDS).items()}]
    weight_map = {}
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-00002.safetensors"
        save_file(shard, str(tmp_path / fname))
        weight_map.update(dict.fromkeys(shard, fname))
    (tmp_path / tst.INDEX_FILE).write_text(json.dumps({"metadata": {}, "weight_map": weight_map}))
    state = tst.CheckpointDir(tmp_path)
    assert len(state) == len(weight_map) and set(state) == set(weight_map)
    for shard in shards:
        for name, want in shard.items():
            _same_bits(_np(state[name]), want, name)
    weight_map[next(iter(weight_map))] = "model-00002-of-00002.safetensors"
    (tmp_path / tst.INDEX_FILE).write_text(json.dumps({"metadata": {}, "weight_map": weight_map}))
    with pytest.raises(ValueError, match="disagrees"):
        tst.CheckpointDir(tmp_path)


@pytest.mark.parametrize("case", ["mixed", "metadata", "empty_and_scalar", "one"])
def test_writer_bytes_equal_package(tmp_path, case):
    from safetensors.numpy import load_file, save_file

    tensors = {"one": _tensors(3, ("F32",)), "mixed": _tensors(4, _ALL_KINDS * 2), "metadata": _tensors(5, _ALL_KINDS),
               "empty_and_scalar": {"e": np.zeros((2, 0), np.float32), "s": np.array(3.5, np.float32),
                                    "b": np.zeros((0,), ml_dtypes.bfloat16)}}[case]
    metadata = {"format": "pt"} if case == "metadata" else None
    save_file(tensors, str(tmp_path / "pkg.safetensors"), metadata=metadata)
    tst.save_file({k: _to_torch(np.asarray(v)) for k, v in tensors.items()}, tmp_path / "port.safetensors",
                  metadata=metadata)
    assert (tmp_path / "port.safetensors").read_bytes() == (tmp_path / "pkg.safetensors").read_bytes()
    back = load_file(str(tmp_path / "port.safetensors"))
    for name, want in tensors.items():
        _same_bits(back[name], np.asarray(want), name)


def _corrupt(path: Path, case: str) -> None:
    raw = path.read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8 : 8 + n])
    if case == "truncated":
        raw = raw[:-3]
    elif case == "header_past_end":
        raw = struct.pack("<Q", len(raw)) + raw[8:]
    elif case == "not_json":
        raw = raw[:8] + b"{" * n + raw[8 + n :]
    else:
        name = next(k for k in header if k != "__metadata__")
        if case == "f64":
            header[name]["dtype"] = "F64"
        elif case == "gap":
            header[name]["data_offsets"] = [x + 4 for x in header[name]["data_offsets"]]
        elif case == "shape":
            header[name]["shape"] = [99]
        text = json.dumps(header).encode()
        text += b" " * ((8 - len(text) % 8) % 8)
        raw = struct.pack("<Q", len(text)) + text + raw[8 + n :]
    path.write_bytes(raw)


@pytest.mark.parametrize("case", ["truncated", "header_past_end", "not_json", "f64", "gap", "shape"])
def test_reader_rejects_malformed_files(tmp_path, case):
    tst.save_file({"a": torch.ones(3), "b": torch.arange(4, dtype=torch.int64)}, tmp_path / "x.safetensors")
    _corrupt(tmp_path / "x.safetensors", case)
    with pytest.raises(ValueError):
        tst.load_file(tmp_path / "x.safetensors")


def test_checkpoint_dir_refuses_duplicates_and_empty_dirs(tmp_path):
    with pytest.raises(FileNotFoundError):
        tst.CheckpointDir(tmp_path)
    for name in ("a", "b"):
        tst.save_file({"w": torch.ones(2)}, tmp_path / f"{name}.safetensors")
    with pytest.raises(ValueError, match="both"):
        tst.CheckpointDir(tmp_path)


def test_device_reads_come_from_the_mapping_and_cpu_reads_are_copies(tmp_path):
    tst.save_file({"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)}, tmp_path / "x.safetensors")
    sf = tst.SafetensorsFile(tmp_path / "x.safetensors")
    arr = sf.array("w")
    assert isinstance(arr, np.memmap) and not arr.flags.writeable and arr.dtype == np.int16
    t = sf.tensor("w")
    assert t.dtype == torch.bfloat16 and t.tolist() == [[0, 1, 2], [3, 4, 5]]
    t += 1  # a CPU tensor is its own copy: the file stays as it was
    assert sf.tensor("w").tolist() == [[0, 1, 2], [3, 4, 5]]


# -- config.json ------------------------------------------------------------------


def _nested_config(cfg) -> dict:
    from morphik_core_tpu_torch.models.colqwen.convert import hf_config_dict

    return hf_config_dict(cfg)


@pytest.mark.parametrize("layout", ["flat", "nested", "empty"])
def test_from_hf_config_matches_reference(tmp_path, layout):
    cfg = ColQwenConfig.tiny()
    if layout == "flat":  # the layout of tests/test_checkpoint_load.py
        j_write_flat_checkpoint(tmp_path, JConfig.tiny(), np.random.default_rng(0))
    else:  # the nested text_config / vision_config of the rehearsal script
        (tmp_path / "config.json").write_text(json.dumps(_nested_config(cfg) if layout == "nested" else {}))
    got = ColQwenConfig.from_hf_config(tmp_path / "config.json")
    want = JConfig.from_hf_config(tmp_path / "config.json")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if layout != "empty":
        assert dataclasses.asdict(got) == dataclasses.asdict(cfg)


# -- convert.py -------------------------------------------------------------------


def _rename(state: dict, naming: str) -> dict:
    if naming == "flat":
        return state
    vision, text = {"namespaced": ("model.visual.", "model.language_model."),
                    "language_model": ("visual.", "language_model.model.")}[naming]
    out = {}
    for k, v in state.items():
        if k.startswith("visual."):
            k = vision + k[len("visual."):]
        elif k.startswith("model."):
            k = text + k[len("model."):]
        out[k] = v
    return out


@pytest.fixture(scope="module")
def flat_state(tmp_path_factory):
    """A tiny f32 state in colpali_engine's flat naming (the reference's
    test writer) and its file."""
    d = tmp_path_factory.mktemp("flat")
    state = j_write_flat_checkpoint(d, JConfig.tiny(), np.random.default_rng(11))
    return state, d


@pytest.mark.parametrize("naming", ["flat", "namespaced", "language_model"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_state_dict_matches_reference(flat_state, naming, dtype):
    state = _rename(flat_state[0], naming)
    want = j_convert(state, JConfig.tiny(), dtype=getattr(jnp, dtype))
    got = convert_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, ColQwenConfig.tiny(),
                             getattr(torch, dtype))
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got_leaves) == sorted(want_leaves)
    for name, w in want_leaves.items():
        _same_bits(_np(got_leaves[name].contiguous()), np.asarray(w), name)


def test_missing_projection_raises_and_its_test_head_matches_reference(flat_state):
    state = {k: v for k, v in flat_state[0].items() if not k.startswith("custom_text_proj")}
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    for convert, st, cfg in ((j_convert, state, JConfig.tiny()), (convert_state_dict, tstate, ColQwenConfig.tiny())):
        with pytest.raises(KeyError, match="custom_text_proj"):
            convert(st, cfg)
    want = j_convert(state, JConfig.tiny(), allow_missing_projection=True)
    got = convert_state_dict(tstate, ColQwenConfig.tiny(), allow_missing_projection=True)
    for name in ("proj_w", "proj_b"):
        _same_bits(_np(got[name]), np.asarray(want[name]), name)


def test_written_checkpoint_loads_in_both_packages(tmp_path):
    """The writer is the converter's inverse: a port model written as an
    HF checkpoint (sharded, with the index json) loads back through the
    served `from_checkpoint` as its own weights, equal leaf for leaf to
    the reference's tree of the same files, and the `safetensors` package
    reads the files."""
    from safetensors.numpy import load_file

    cfg = ColQwenConfig.tiny()
    model = TModel.init_random(cfg, seed=5, device="cpu", dtype=torch.bfloat16)
    stats = write_hf_checkpoint(model, tmp_path, shard_bytes=64 << 10)
    assert stats["shards"] > 2 and stats["tensors"] == len(hf_tensors(model))
    index = json.loads((tmp_path / tst.INDEX_FILE).read_text())
    assert sorted(set(index["weight_map"].values())) == sorted(p.name for p in tmp_path.glob("*.safetensors"))
    files = [load_file(str(p)) for p in tmp_path.glob("*.safetensors")]
    assert sum(a.nbytes for f in files for a in f.values()) == index["metadata"]["total_size"] == stats["bytes"]
    got = _model_leaves(TModel.from_checkpoint(tmp_path, device="cpu"))
    want = dict(_leaves(j_load_hf(tmp_path, JConfig.tiny(), jnp.bfloat16)))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        _same_bits(_np(got[name].contiguous()), np.asarray(w), name)
    for name, x in _model_leaves(model).items():
        assert torch.equal(got[name], x), name


# -- from_checkpoint ------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen_checkpoint(tmp_path_factory):
    """A tiny f32 checkpoint with Qwen2.5's vocab and the fixture
    tokenizer, written by the port."""
    d = tmp_path_factory.mktemp("qwen_ckpt")
    model = TModel.init_random(TINY_QWEN, seed=7, device="cpu", dtype=torch.float32)
    write_hf_checkpoint(model, d, shard_bytes=8 << 20, tokenizer_file=TOKENIZER)
    return d


def test_from_checkpoint_matches_reference(qwen_checkpoint):
    tm = TModel.from_checkpoint(qwen_checkpoint, dtype=torch.float32, device="cpu")
    jm = JModel.from_checkpoint(qwen_checkpoint, dtype=jnp.float32)
    assert isinstance(tm.tokenizer, QwenTokenizer) and dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    for q in QUERIES:
        assert tm.query_token_ids(q) == jm.query_token_ids(q)
    ids = tm.image_sequence_ids(32)
    np.testing.assert_array_equal(ids, jm.image_sequence_ids(32))
    assert ids[0] == 151644 and 151652 in ids and 151653 in ids  # <|im_start|>, vision start / end: single ids
    assert tm.query_token_ids("x")[-10:] == [151643] * 10  # <|endoftext|> augmentation
    for a, b in zip(tm.embed_queries(QUERIES), jm.embed_queries(QUERIES)):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-4)
    u8 = np.random.default_rng(3).integers(0, 256, (2, 4 * 8 * 4, 588), dtype=np.uint8)
    np.testing.assert_allclose(tm.embed_image_batch(u8, 4, 8), jm.embed_image_batch(u8, 4, 8), rtol=5e-4, atol=5e-4)


def test_from_checkpoint_bf16_leaves_equal_reference(qwen_checkpoint):
    tm = TModel.from_checkpoint(qwen_checkpoint, device="cpu")  # bf16, as served
    want = dict(_leaves(j_load_hf(qwen_checkpoint, _qwen_jcfg(), jnp.bfloat16)))
    assert tm.dtype == torch.bfloat16 and tm.proj_w.dtype == torch.bfloat16
    got = _model_leaves(tm)
    assert sorted(got) == sorted(want)
    for name, w in want.items():  # f32 on the disk, cast to bf16 by both
        _same_bits(_np(got[name].contiguous()), np.asarray(w), name)
    tq = TModel.from_checkpoint(qwen_checkpoint, device="cpu", matmul_precision="int8")
    jq = jax.device_get(JModel.from_checkpoint(qwen_checkpoint, matmul_precision="int8").params)
    np.testing.assert_array_equal(tq.text.layers[2].gate_w.q8[:48, :96].numpy(),
                                  np.asarray(jq["text"]["layers"]["gate_w"]["q8"][2]))
    np.testing.assert_array_equal(tq.visual.blocks[0].q_w.s.numpy(), np.asarray(jq["visual"]["blocks"]["q_w"]["s"][0]))


def _qwen_jcfg():
    return dataclasses.replace(JConfig.tiny(vocab_size=151936), image_token_id=151655,
                               vision_start_token_id=151652, vision_end_token_id=151653)


@pytest.mark.parametrize("fault", ["no_projection", "tokenizer_layout", "no_weights", "torn_shard"])
def test_from_checkpoint_refuses_a_bad_directory(qwen_checkpoint, tmp_path, fault):
    for p in qwen_checkpoint.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    shards = sorted(tmp_path.glob("*.safetensors"))
    if fault == "no_projection":
        (tmp_path / tst.INDEX_FILE).unlink()
        last = tst.load_file(shards[-1])
        tst.save_file({k: v for k, v in last.items() if not k.startswith("custom_text_proj")}, shards[-1])
        error = KeyError
    elif fault == "tokenizer_layout":
        spec = json.loads((tmp_path / "tokenizer.json").read_text(encoding="utf-8"))
        spec["normalizer"] = {"type": "NFKC"}
        (tmp_path / "tokenizer.json").write_text(json.dumps(spec), encoding="utf-8")
        error = ValueError
    elif fault == "no_weights":
        for p in shards:
            p.unlink()
        error = FileNotFoundError
    else:
        shards[0].write_bytes(shards[0].read_bytes()[:-8])
        error = ValueError
    with pytest.raises(error):
        TModel.from_checkpoint(tmp_path, device="cpu")


# -- the int8 QK^T --------------------------------------------------------------------


def test_quantize_rows_q8_bit_identical():
    x = np.random.default_rng(0).standard_normal((2, 40, 4, 80)).astype(np.float32)
    x[1, 3, 2] = 0.0  # an all-zero row takes scale 1
    jq, js = jax.jit(jl._quantize_rows_q8)(jnp.asarray(x))
    tq, ts = tl._quantize_rows_q8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("hd", [80, 128])
def test_int8_qk_scores_exact(hd):
    rng = np.random.default_rng(hd)
    qq = rng.integers(-127, 128, (3, 20, 4, hd)).astype(np.int8)
    kq = rng.integers(-127, 128, (3, 24, 4, hd)).astype(np.int8)
    qq[0, 0, 0] = kq[0, 0, 0] = 127  # the largest sum: hd * 127^2
    want = np.einsum("bqhd,bkhd->bhqk", qq.astype(np.int64), kq.astype(np.int64))
    got = tl.int8_qk_scores(torch.from_numpy(qq), torch.from_numpy(kq))
    assert got.dtype == torch.float32 and want[0, 0, 0, 0] == hd * 127 * 127
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("shape", [(2, 64, 4, 16, 4), (1, 12, 4, 12, 2)])  # (B, S, Hq, hd, Hkv): windows; GQA
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_qk_int8_matches_reference(static, shape, dtype):
    b, s, hq, hd, hkv = shape
    rng = np.random.default_rng(s + hq)
    q = rng.standard_normal((b, s, hq, hd)).astype(np.float32) * 2
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32) * 2
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    bias = np.where(np.tril(np.ones((s, s), bool)), 0.0, -1e30).astype(np.float32)[None, None]
    scales = (np.float32(np.abs(q).max() * 1.05 / 127), np.float32(np.abs(k).max() * 1.05 / 127)) if static else None
    jargs = [jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)]
    targs = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)]

    def jfn(q, k, v, bias, qs):
        return jl.attention(q, k, v, bias=bias, qk_int8=True, qk_static=qs)

    want = np.asarray(jax.jit(jfn)(*jargs, jnp.asarray(bias), None if scales is None else
                                   tuple(jnp.asarray(x) for x in scales)).astype(jnp.float32))
    got = tl.attention(*targs, bias=torch.from_numpy(bias), qk_int8=True,
                       qk_static=None if scales is None else tuple(torch.tensor(x) for x in scales)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:  # bf16 P and output: one bf16 ulp where an f32 P rounds to the other neighbour
        np.testing.assert_allclose(got, want, rtol=2**-7, atol=2e-3)


@pytest.fixture(scope="module")
def int8_attention_models():
    """The fixture model in both packages with int8 matmuls and int8
    attention, each calibrated on the same committed pages."""
    u8, grid = tcal.load_calibration_pages()
    batches = tcal.calibration_batches(u8[:8], 4)
    jm = JModel.from_fixture(FIXTURE, matmul_precision="int8", attention_precision="int8")
    jm.calibrate_static_act_scales(batches, *grid)
    tm = TModel(load_config_npz(FIXTURE), device="cpu", dtype=torch.float32, matmul_precision="int8",
                attention_precision="int8")
    load_jax_params(tm, jax.device_get(JModel.from_fixture(FIXTURE, matmul_precision="int8").params))
    tm.calibrate_static_act_scales(batches, *grid)
    return jm, tm, batches, grid


def test_calibrated_qk_scales_match_reference(int8_attention_models):
    jm, tm, batches, grid = int8_attention_models
    assert tm.cfg.vision.qk_int8 and tm.cfg.text.qk_int8
    want = np.asarray(jm.params["visual"]["blocks"]["attn_qk_as"])
    got = np.stack([blk.attn_qk_as.numpy() for blk in tm.visual.blocks])
    np.testing.assert_allclose(got, want, rtol=5e-5)
    # the same maxima attach bit-identical scales, and the leaf loads as it is
    _, qk = j_capture(jax.device_get(JModel.from_fixture(FIXTURE, matmul_precision="int8").params)["visual"],
                      batches[:1], *grid, jm.cfg.vision)
    acts = np.ones((tm.cfg.vision.depth, 4), np.float32)
    j_vis = j_attach(jm.params["visual"], acts, 1.05, np.asarray(qk))
    tq = TModel(tm.cfg, device="cpu", dtype=torch.float32, matmul_precision="int8")
    load_jax_params(tq, jax.device_get(JModel.from_fixture(FIXTURE, matmul_precision="int8").params))
    assert all(blk.attn_qk_as is None for blk in tq.visual.blocks)
    tcal.attach_vision_act_scales(tq, acts, 1.05, np.asarray(qk))
    _same_bits(np.stack([blk.attn_qk_as.numpy() for blk in tq.visual.blocks]),
               np.asarray(j_vis["blocks"]["attn_qk_as"]), "attn_qk_as")
    tl_ = TModel(tm.cfg, device="cpu", dtype=torch.float32, matmul_precision="int8")
    load_jax_params(tl_, dict(jax.device_get(jm.params), visual=jax.device_get(j_vis)))
    _same_bits(np.stack([blk.attn_qk_as.numpy() for blk in tl_.visual.blocks]),
               np.asarray(j_vis["blocks"]["attn_qk_as"]), "loaded attn_qk_as")


@pytest.mark.parametrize("static", [False, True])
def test_int8_attention_blocks_match_reference_on_identical_inputs(int8_attention_models, static):
    jm, tm, _, _ = int8_attention_models
    p = jax.device_get(jm.params["visual"])
    if not static:
        p = dict(p, blocks={k: v for k, v in p["blocks"].items() if k != "attn_qk_as"})
    tq = TModel(tm.cfg, device="cpu", dtype=torch.float32, matmul_precision="int8", attention_precision="int8")
    load_jax_params(tq, dict(jax.device_get(jm.params), visual=p))
    assert (tq.visual.blocks[0].attn_qk_as is not None) == static
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
            got = tq.visual.blocks[li](torch.from_numpy(x), full, torch.from_numpy(cos), torch.from_numpy(sin)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        x = want


def _cosine_close(a: np.ndarray, b: np.ndarray) -> None:
    assert a.shape == b.shape
    cos = (a * b).sum(-1)  # rows are unit-norm
    assert float(cos.mean()) > 0.999 and float(cos.min()) > 0.98, (float(cos.mean()), float(cos.min()))


@pytest.mark.parametrize("matmul", ["bf16", "int8_static"])
def test_int8_attention_model_tracks_reference(int8_attention_models, matmul):
    if matmul == "int8_static":
        jm, tm, _, _ = int8_attention_models
    else:  # f32 weights, int8 QK^T with dynamic scales
        jm = JModel.from_fixture(FIXTURE, attention_precision="int8")
        tm = TModel(load_config_npz(FIXTURE), device="cpu", dtype=torch.float32, attention_precision="int8")
        load_jax_params(tm, jax.device_get(jm.params))
    for seed in (2, 3):
        u8 = np.random.default_rng(seed).integers(0, 256, (2, 4 * 8 * 4, 588), dtype=np.uint8)
        _cosine_close(tm.embed_image_batch(u8, 4, 8), jm.embed_image_batch(u8, 4, 8))
    for a, b in zip(tm.embed_queries(QUERIES), jm.embed_queries(QUERIES)):
        _cosine_close(a, b)


def test_int8_attention_runs_no_window_kernel(monkeypatch):
    """With int8 attention the windowed blocks take the int8 QK^T, not K3
    (the reference's window path is XLA in both modes); with bf16
    attention every windowed block calls it."""
    from morphik_core_tpu_torch.models.colqwen import vision as tvision

    calls = []
    real = tvision.window_attention
    monkeypatch.setattr(tvision, "window_attention", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    u8 = np.random.default_rng(0).integers(0, 256, (1, 4 * 4 * 4, 588), dtype=np.uint8)
    for attention, want in (("int8", 0), ("bf16", 2)):  # tiny: 4 blocks, 2 of them full
        calls.clear()
        TModel.init_random(ColQwenConfig.tiny(), device="cpu", attention_precision=attention).embed_image_batch(u8, 4, 4)
        assert len(calls) == want, attention


# -- an HF-saved Qwen2.5-VL ----------------------------------------------------------


@pytest.mark.parametrize("naming", ["saved", "namespaced"])
def test_hf_qwen2_5_vl_checkpoint_parity(tmp_path, naming):
    """A tiny random Qwen2_5_VLForConditionalGeneration saved by
    `transformers` 4.57 (`save_pretrained` writes the flat legacy names,
    `visual.*` / `model.*`; its in-memory `state_dict()` has the
    namespaced `model.visual.*` / `model.language_model.*`), with a
    `custom_text_proj` added, is served by the port: its hidden states
    before the projection equal HF's."""
    transformers = pytest.importorskip("transformers")
    cfg = ColQwenConfig.tiny()
    v, t = cfg.vision, cfg.text
    hf_cfg = transformers.Qwen2_5_VLConfig(
        vision_config=dict(depth=v.depth, hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
                           num_heads=v.num_heads, patch_size=v.patch_size, spatial_merge_size=v.spatial_merge_size,
                           temporal_patch_size=v.temporal_patch_size, window_size=v.window_size,
                           out_hidden_size=v.out_hidden_size, fullatt_block_indexes=list(v.fullatt_block_indexes)),
        text_config=dict(vocab_size=t.vocab_size, hidden_size=t.hidden_size, intermediate_size=t.intermediate_size,
                         num_hidden_layers=t.num_hidden_layers, num_attention_heads=t.num_attention_heads,
                         num_key_value_heads=t.num_key_value_heads, rms_norm_eps=t.rms_norm_eps,
                         rope_theta=t.rope_theta, max_position_embeddings=4096,
                         rope_scaling={"type": "mrope", "mrope_section": list(t.mrope_section)}),
        image_token_id=cfg.image_token_id, vision_start_token_id=cfg.vision_start_token_id,
        vision_end_token_id=cfg.vision_end_token_id)
    torch.manual_seed(0)
    hf = transformers.Qwen2_5_VLForConditionalGeneration(hf_cfg).eval().float()
    hf.save_pretrained(tmp_path, safe_serialization=True)
    shard = next(tmp_path.glob("*.safetensors"))
    state = tst.load_file(shard)
    assert "visual.patch_embed.proj.weight" in state and "model.layers.0.self_attn.q_proj.weight" in state
    if naming == "namespaced":
        state = {k: v.detach().clone() for k, v in hf.state_dict().items()}
        assert "model.visual.patch_embed.proj.weight" in state and "model.language_model.norm.weight" in state
        tst.save_file(state, shard)
    with pytest.raises(KeyError, match="custom_text_proj"):
        TModel.from_checkpoint(tmp_path, device="cpu")
    state["custom_text_proj.weight"] = torch.randn(cfg.embedding_dim, t.hidden_size) * 0.05
    state["custom_text_proj.bias"] = torch.zeros(cfg.embedding_dim)
    tst.save_file(state, shard)
    hf_json = json.loads((tmp_path / "config.json").read_text())
    (tmp_path / "config.json").write_text(json.dumps(dict(hf_json, embedding_dim=cfg.embedding_dim)))  # the head's width
    model = TModel.from_checkpoint(tmp_path, dtype=torch.float32, device="cpu")
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(cfg)
    model._project = lambda hidden, mask: hidden * mask[..., None]  # the hidden states before the projection

    h_units = w_units = 4
    n_img = h_units * w_units
    patches = np.random.default_rng(2).standard_normal((n_img * 4, v.patch_input_dim)).astype(np.float32)
    # HF finds an image by the vision-start token before its pads
    ids = np.array([[5, 6, cfg.vision_start_token_id] + [cfg.image_token_id] * n_img + [cfg.vision_end_token_id, 8]])
    grid_thw = torch.tensor([[1, 2 * h_units, 2 * w_units]])
    cos_v, sin_v = (torch.from_numpy(x) for x in vision_rotary_cos_sin(h_units, w_units, cfg.vision))
    cos_t, sin_t = (torch.from_numpy(x) for x in mrope_cos_sin(
        mrope_position_ids(ids, cfg.image_token_id, [(1, h_units, w_units)]), cfg.text))
    with torch.no_grad():
        want_vis = hf.model.visual(torch.from_numpy(patches), grid_thw=grid_thw)
        want = hf.model(input_ids=torch.from_numpy(ids), pixel_values=torch.from_numpy(patches), image_grid_thw=grid_thw,
                        attention_mask=torch.ones(ids.shape, dtype=torch.long)).last_hidden_state
        got_vis = model.visual(torch.from_numpy(patches)[None], cos_v, sin_v, h_units, w_units)[0]
        got = model.image_forward(torch.from_numpy(patches)[None], cos_v, sin_v, torch.from_numpy(ids), cos_t, sin_t,
                                  h_units, w_units)
    np.testing.assert_allclose(got_vis.numpy(), want_vis.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-4, atol=5e-4)

    for q, got_q in zip(QUERIES[:2], model.embed_queries(QUERIES[:2])):  # padded to a bucket, masked
        q_ids = torch.tensor([model.query_token_ids(q)])
        with torch.no_grad():
            want_q = hf.model(input_ids=q_ids, attention_mask=torch.ones_like(q_ids)).last_hidden_state[0]
        np.testing.assert_allclose(got_q, want_q.numpy(), rtol=5e-4, atol=5e-4)


# -- a server of a checkpoint ---------------------------------------------------------


def _checkpoint_toml(root: Path, name: str, checkpoint: Path) -> Path:
    """The shipped serving precisions (int8 matmuls, static scales, bf16
    attention) with `model.checkpoint_path` set; every path under `root`."""
    d = root / name
    path = root / f"{name}.toml"
    path.write_text(f"""
[api]
port = 0
[model]
checkpoint_path = "{checkpoint}"
matmul_precision = "int8"
static_act_scales = true
attention_precision = "bf16"
[storage]
storage_path = "{d / 'storage'}"
[database]
path = "{d / 'db.sqlite'}"
[vector_store]
index_path = "{d / 'index'}"
fde_num_repetitions = 8
fde_num_simhash_projections = 4
fde_projection_dimension = 8
[telemetry]
telemetry_dir = "{d / 'logs' / 'telemetry'}"
[worker]
max_jobs = 2
""")
    return path


def test_checkpoint_server_answers_as_the_jax_server(qwen_checkpoint, tmp_path):
    """Both packages' servers boot from the same checkpoint directory (no
    model passed in; bf16 weights quantized to int8 and calibrated at
    boot), ingest the same PNG pages over HTTP and answer
    `/retrieve/chunks` with the same pages: each page's image self-query
    first, scores within rtol 1e-2 and the same page at every rank whose
    score stands twice that apart from the others (each package embeds
    for itself: the int8 gap of tests/test_torch_int8.py)."""
    from morphik_core_tpu.api.app import build_app as j_build_app
    from morphik_core_tpu.api.http import HTTPServer as JHTTPServer
    from morphik_core_tpu.config import load_settings as j_load_settings
    from morphik_core_tpu.services_init import build_services as j_build_services
    from morphik_core_tpu_torch.api.app import build_app
    from morphik_core_tpu_torch.api.http import HTTPServer
    from morphik_core_tpu_torch.config import load_settings
    from morphik_core_tpu_torch.services_init import build_services
    from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri
    from morphik_core_tpu_torch.utils.png import encode_png
    from test_torch_service import _LoopThread, _call, _page, _upload, _wait_completed

    rng = np.random.default_rng(5)
    pngs = [encode_png(_page(rng, 224, 336, n_blocks=5 + 2 * i)) for i in range(4)]
    lt = _LoopThread()
    running, answers = [], {}
    try:
        for name, boot, make_app, server_cls in (
                ("torch", lambda p: build_services(load_settings(p), device="cpu"), build_app, HTTPServer),
                ("jax", lambda p: j_build_services(j_load_settings(p)), j_build_app, JHTTPServer)):
            services = boot(_checkpoint_toml(tmp_path, name, qwen_checkpoint))
            model = services.colpali_embedding_model.model
            assert model.tokenizer is not None and model.cfg.image_token_id == 151655
            lt.run(services.initialize())
            srv = server_cls(make_app(services), "127.0.0.1", 0)
            lt.run(srv.start())
            running.append((srv, services))
            base = f"http://127.0.0.1:{srv.port}"
            docs = [_upload(base, f"p{i}.png", data)[1]["external_id"] for i, data in enumerate(pngs)]
            _wait_completed(base, docs)
            out = answers[name] = {}
            for q in QUERIES[:3] + [i for i in range(len(pngs))]:
                body = {"k": 4, **({"query": q} if isinstance(q, str) else
                                   {"query_image": bytes_to_data_uri(pngs[q], "image/png")})}
                status, res = _call(base, "POST", "/retrieve/chunks", body)
                assert status == 200, res
                out[q] = [(docs.index(r["document_id"]), r["score"]) for r in res]
        port = running[0][1].colpali_embedding_model.model
        assert port.matmul_precision == "int8" and port.visual.blocks[0].attn_qk_as is not None
        assert port.proj_w.dtype == torch.bfloat16
    finally:
        for srv, services in running:
            lt.run(srv.stop())
            lt.run(services.shutdown())
        lt.close()
    for q, got in answers["torch"].items():
        want = answers["jax"][q]
        if not isinstance(q, str):
            assert got[0][0] == want[0][0] == q, (q, got, want)
        scores = np.array([s for _, s in want])
        np.testing.assert_allclose([s for _, s in got], scores, rtol=1e-2, atol=1e-3)
        gap = 2e-2 * np.abs(scores).max()
        for i in range(len(want)):
            if all(abs(scores[i] - scores[j]) > gap for j in range(len(want)) if j != i):
                assert got[i][0] == want[i][0], (q, got, want)


def test_rehearsal_script_tiny(tmp_path, capsys):
    """The port's rehearsal end to end at the tiny geometry on the CPU:
    sharded write, `from_checkpoint`, a serving step, the failure modes."""
    from morphik_core_tpu_torch.scripts import rehearse_checkpoint

    assert rehearse_checkpoint.main(["--small", "--device", "cpu", "--dir", str(tmp_path / "ck")]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["failure_modes"] == {"missing_proj_rejected": True, "f32_checkpoint_converts": True}
    assert report["write"]["shards"] == 1 and report["load"]["emb_shape"][0] == 2 and report["load"]["peak_rss_gb"] > 0
    assert not (tmp_path / "ck").exists()  # deleted without --keep


@pytest.mark.parametrize("attention", ["bf16", "int8"])
def test_settings_serve_the_configured_attention(tmp_path, attention):
    """Development mode serves the tiny random model in the configured
    attention precision; a passed-in model of another precision raises."""
    from morphik_core_tpu_torch.config import Settings
    from morphik_core_tpu_torch.embedding.colpali_embedding_model import ColpaliEmbeddingModel

    settings = Settings.from_dict({"model": {"attention_precision": attention, "matmul_precision": "bf16"}})
    emb = ColpaliEmbeddingModel.from_settings(settings, device="cpu")
    assert emb.model.attention_precision == attention and emb.model.cfg.vision.qk_int8 == (attention == "int8")
    other = TModel.init_random(ColQwenConfig.tiny(), device="cpu",
                               attention_precision="bf16" if attention == "int8" else "int8")
    with pytest.raises(ValueError, match="attention_precision"):
        ColpaliEmbeddingModel.from_settings(settings, other, device="cpu")
