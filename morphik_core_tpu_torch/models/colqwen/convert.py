"""HF checkpoint <-> the port's ColQwen weights, PyTorch port of
`morphik_core_tpu/models/colqwen/convert.py`.

The safetensors naming is colpali_engine's ColQwen2_5 (a
Qwen2_5_VLForConditionalGeneration subclass + `custom_text_proj`), in
both key namings: the flat `visual.*` / `model.*` and the namespaced
`model.visual.*` / `model.language_model.*` / `language_model.model.*`.
Torch Linear weights (out, in) become the JAX tree's (in, out), and the
vision block's fused `qkv` is split into q, k and v.

`hf_leaves` yields the converted leaves one layer's tensor at a time,
each read from its own file mapping and converted on `device`, so the
host never holds more than one raw tensor beside the mapping:
`ColQwenModel.from_checkpoint` fills its modules from it. For a state
dict already in memory, `convert_state_dict` stacks them into the
reference's tree (for `load_jax_params`).

The writer is the inverse: `hf_tensors` names a float model's weights as
the released checkpoints do (flat naming, fused qkv, (out, in)), and
`write_hf_checkpoint` writes them sharded with the index json and
`config.json`, as `scripts/rehearse_checkpoint.py` of the reference does.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from morphik_core_tpu_torch.models.colqwen.config import ColQwenConfig
from morphik_core_tpu_torch.models.colqwen.safetensors import INDEX_FILE, CheckpointDir, save_file

logger = logging.getLogger(__name__)

#: a converted leaf: (path in the JAX tree, layer index or None, tensor)
Leaf = Tuple[Tuple[str, ...], Optional[int], torch.Tensor]

_VISION_LEAVES = ("norm1", "norm2", "q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "proj_w", "proj_b",
                  "gate_w", "gate_b", "up_w", "up_b", "down_w", "down_b")
_TEXT_LEAVES = ("input_ln", "post_ln", "q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "o_w", "gate_w", "up_w", "down_w")


def _find(state, *names: str) -> str:
    for n in names:
        if n in state:
            return n
    raise KeyError(f"none of {names} found (have {len(state)} keys, e.g. {list(state)[:5]})")


def _prefixes(state) -> Tuple[str, str]:
    """(vision, text) key prefixes of the checkpoint's naming."""
    vp = "visual."
    if f"{vp}patch_embed.proj.weight" not in state and "model.visual.patch_embed.proj.weight" in state:
        vp = "model.visual."
    tp = "model."
    if "model.layers.0.self_attn.q_proj.weight" not in state:
        if "model.language_model.layers.0.self_attn.q_proj.weight" in state:
            tp = "model.language_model."
        elif "language_model.model.layers.0.self_attn.q_proj.weight" in state:
            tp = "language_model.model."
    return vp, tp


def hf_leaves(state, cfg: ColQwenConfig, dtype=torch.bfloat16, device=None, *,
              allow_missing_projection: bool = False) -> Iterator[Leaf]:
    """The converted leaves of a torch-layout state (a dict of tensors or a
    `CheckpointDir`), on `device` (the CPU by default) in `dtype`, in the
    reference's tree paths. A state without `custom_text_proj` raises
    `KeyError` unless `allow_missing_projection` (tests only: a seeded
    random head, as the reference's)."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    read = state.tensor if isinstance(state, CheckpointDir) else (lambda n, d: state[n].to(d))

    def get(*names: str) -> torch.Tensor:
        return read(_find(state, *names), device)

    def t(x: torch.Tensor) -> torch.Tensor:  # torch Linear (out, in) -> (in, out), one pass
        return torch.empty(x.T.shape, dtype=dtype, device=x.device).copy_(x.T)

    def a(x: torch.Tensor) -> torch.Tensor:
        return x.to(dtype)

    vp, tp = _prefixes(state)
    pe = get(f"{vp}patch_embed.proj.weight")  # (h, C, T, ps, ps)
    yield ("visual", "patch_embed_w"), None, t(pe.reshape(pe.shape[0], -1))
    h = cfg.vision.hidden_size
    for i in range(cfg.vision.depth):
        p = f"{vp}blocks.{i}."
        leaves = {"norm1": a(get(p + "norm1.weight")), "norm2": a(get(p + "norm2.weight"))}
        # HF fuses qkv as one (3h, h) projection; the tree stores it split
        qkv_w, qkv_b = t(get(p + "attn.qkv.weight")), a(get(p + "attn.qkv.bias"))
        for j, name in enumerate("qkv"):
            leaves[f"{name}_w"] = qkv_w[:, j * h : (j + 1) * h]
            leaves[f"{name}_b"] = qkv_b[j * h : (j + 1) * h]
        leaves.update(proj_w=t(get(p + "attn.proj.weight")), proj_b=a(get(p + "attn.proj.bias")))
        for name in ("gate", "up", "down"):
            leaves[f"{name}_w"] = t(get(p + f"mlp.{name}_proj.weight"))
            leaves[f"{name}_b"] = a(get(p + f"mlp.{name}_proj.bias"))
        for name in _VISION_LEAVES:
            yield ("visual", "blocks", name), i, leaves[name]
    for name, key, conv in (("ln_q", "ln_q.weight", a), ("fc1_w", "mlp.0.weight", t), ("fc1_b", "mlp.0.bias", a),
                            ("fc2_w", "mlp.2.weight", t), ("fc2_b", "mlp.2.bias", a)):
        yield ("visual", "merger", name), None, conv(get(f"{vp}merger.{key}"))

    yield ("text", "embed"), None, a(get(f"{tp}embed_tokens.weight"))
    for i in range(cfg.text.num_hidden_layers):
        p = f"{tp}layers.{i}."
        leaves = {"input_ln": a(get(p + "input_layernorm.weight")),
                  "post_ln": a(get(p + "post_attention_layernorm.weight"))}
        for name in ("q", "k", "v"):
            leaves[f"{name}_w"] = t(get(p + f"self_attn.{name}_proj.weight"))
            leaves[f"{name}_b"] = a(get(p + f"self_attn.{name}_proj.bias"))
        leaves["o_w"] = t(get(p + "self_attn.o_proj.weight"))
        for name in ("gate", "up", "down"):
            leaves[f"{name}_w"] = t(get(p + f"mlp.{name}_proj.weight"))
        for name in _TEXT_LEAVES:
            yield ("text", "layers", name), i, leaves[name]
    yield ("text", "norm"), None, a(get(f"{tp}norm.weight"))

    if "custom_text_proj.weight" in state and "custom_text_proj.bias" in state:
        yield ("proj_w",), None, t(get("custom_text_proj.weight"))
        yield ("proj_b",), None, a(get("custom_text_proj.bias"))
        return
    # a checkpoint without the ColPali head is a base Qwen2.5-VL (or a
    # mismatched one): a random head would serve meaningless embeddings
    if not allow_missing_projection:
        raise KeyError("checkpoint has no custom_text_proj: this is not a ColPali-family "
                       "checkpoint (pass allow_missing_projection=True only for tests)")
    logger.warning("checkpoint has no custom_text_proj: using a random projection (test mode)")
    rng = np.random.default_rng(0)
    w = rng.standard_normal((cfg.text.hidden_size, cfg.embedding_dim)).astype(np.float32) * 0.02
    yield ("proj_w",), None, torch.from_numpy(w).to(device=device, dtype=dtype)
    yield ("proj_b",), None, torch.zeros((cfg.embedding_dim,), dtype=dtype, device=device)


def convert_state_dict(state, cfg: ColQwenConfig, dtype=torch.bfloat16, *,
                       allow_missing_projection: bool = False) -> dict:
    """A torch-layout state -> the reference's stacked-layer tree (torch
    leaves on the CPU)."""
    tree: dict = {}
    stacks: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    for path, layer, x in hf_leaves(state, cfg, dtype, allow_missing_projection=allow_missing_projection):
        if layer is None:
            _set(tree, path, x)
        else:
            stacks.setdefault(path, []).append(x)
    for path, xs in stacks.items():
        _set(tree, path, torch.stack(xs))
    return tree


def _set(tree: dict, path: Tuple[str, ...], value) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


# -- the writer ------------------------------------------------------------------


def hf_config_dict(cfg: ColQwenConfig) -> dict:
    """`config.json` in the nested layout of the released checkpoints."""
    v, t = cfg.vision, cfg.text
    return {
        "architectures": ["ColQwen2_5"],
        "model_type": "qwen2_5_vl",
        "embedding_dim": cfg.embedding_dim,
        "image_token_id": cfg.image_token_id,
        "vision_start_token_id": cfg.vision_start_token_id,
        "vision_end_token_id": cfg.vision_end_token_id,
        "tie_word_embeddings": t.tie_word_embeddings,
        "rope_scaling": {"mrope_section": list(t.mrope_section), "type": "mrope"},
        "vision_config": {
            "depth": v.depth, "hidden_size": v.hidden_size, "intermediate_size": v.intermediate_size,
            "num_heads": v.num_heads, "in_channels": v.in_channels, "patch_size": v.patch_size,
            "spatial_merge_size": v.spatial_merge_size, "temporal_patch_size": v.temporal_patch_size,
            "window_size": v.window_size, "out_hidden_size": v.out_hidden_size,
            "fullatt_block_indexes": list(v.fullatt_block_indexes),
        },
        "text_config": {
            "vocab_size": t.vocab_size, "hidden_size": t.hidden_size, "intermediate_size": t.intermediate_size,
            "num_hidden_layers": t.num_hidden_layers, "num_attention_heads": t.num_attention_heads,
            "num_key_value_heads": t.num_key_value_heads, "rms_norm_eps": t.rms_norm_eps,
            "rope_theta": t.rope_theta,
        },
    }


#: a named HF tensor: (name, shape, producer of the (out, in) tensor)
HFTensor = Tuple[str, Tuple[int, ...], Callable[[], torch.Tensor]]


def hf_tensors(model) -> List[HFTensor]:
    """A float model's weights under colpali_engine's flat names (visual.*,
    model.*, custom_text_proj.*), in the model's dtype and device; each
    tensor is made only when its producer is called."""
    if model.matmul_precision != "bf16":
        raise ValueError(f"only a float model is written (this one is {model.matmul_precision})")
    v = model.cfg.vision
    out: List[HFTensor] = []

    def add(name: str, fn: Callable[[], torch.Tensor], shape) -> None:
        out.append((name, tuple(shape), fn))

    def lin(name: str, w, b=None) -> None:
        add(f"{name}.weight", lambda: w.T.contiguous(), w.shape[::-1])
        if b is not None:
            add(f"{name}.bias", lambda: b.contiguous(), b.shape)

    pe = model.visual.patch_embed_w  # (C*T*ps*ps, h)
    add("visual.patch_embed.proj.weight",
        lambda: pe.T.reshape(v.hidden_size, v.in_channels, v.temporal_patch_size, v.patch_size, v.patch_size),
        (v.hidden_size, v.in_channels, v.temporal_patch_size, v.patch_size, v.patch_size))
    for i, blk in enumerate(model.visual.blocks):
        p = f"visual.blocks.{i}."
        add(p + "norm1.weight", lambda blk=blk: blk.norm1.contiguous(), blk.norm1.shape)
        add(p + "norm2.weight", lambda blk=blk: blk.norm2.contiguous(), blk.norm2.shape)
        add(p + "attn.qkv.weight", lambda blk=blk: torch.cat([blk.q_w, blk.k_w, blk.v_w], dim=1).T.contiguous(),
            (3 * v.hidden_size, v.hidden_size))
        add(p + "attn.qkv.bias", lambda blk=blk: torch.cat([blk.q_b, blk.k_b, blk.v_b]), (3 * v.hidden_size,))
        lin(p + "attn.proj", blk.proj_w, blk.proj_b)
        for name in ("gate", "up", "down"):
            lin(p + f"mlp.{name}_proj", getattr(blk, f"{name}_w"), getattr(blk, f"{name}_b"))
    m = model.visual.merger
    add("visual.merger.ln_q.weight", lambda: m.ln_q.contiguous(), m.ln_q.shape)
    lin("visual.merger.mlp.0", m.fc1_w, m.fc1_b)
    lin("visual.merger.mlp.2", m.fc2_w, m.fc2_b)
    txt = model.text
    add("model.embed_tokens.weight", lambda: txt.embed.contiguous(), txt.embed.shape)
    for i, layer in enumerate(txt.layers):
        p = f"model.layers.{i}."
        add(p + "input_layernorm.weight", lambda layer=layer: layer.input_ln.contiguous(), layer.input_ln.shape)
        add(p + "post_attention_layernorm.weight", lambda layer=layer: layer.post_ln.contiguous(),
            layer.post_ln.shape)
        for name in ("q", "k", "v"):
            lin(p + f"self_attn.{name}_proj", getattr(layer, f"{name}_w"), getattr(layer, f"{name}_b"))
        lin(p + "self_attn.o_proj", layer.o_w)
        for name in ("gate", "up", "down"):
            lin(p + f"mlp.{name}_proj", getattr(layer, f"{name}_w"))
    add("model.norm.weight", lambda: txt.norm.contiguous(), txt.norm.shape)
    lin("custom_text_proj", model.proj_w, model.proj_b)
    return out


def write_hf_checkpoint(model, out_dir, shard_bytes: int = 2 * 1024**3, tokenizer_file=None) -> dict:
    """Write `model` as an HF checkpoint directory: shards
    `model-0000i-of-0000n.safetensors` (a shard closes once it holds
    `shard_bytes`, as the reference's rehearsal splits them),
    `model.safetensors.index.json`, `config.json` and, when given, a copy
    of `tokenizer_file` as `tokenizer.json`. Returns {shards, tensors,
    bytes}."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tensors = hf_tensors(model)
    size = torch.empty((), dtype=model.dtype).element_size()
    shards: List[List[HFTensor]] = [[]]
    cur = total = 0
    for item in tensors:
        shards[-1].append(item)
        nbytes = int(np.prod(item[1])) * size
        cur += nbytes
        total += nbytes
        if cur >= shard_bytes:
            shards.append([])
            cur = 0
    shards = [s for s in shards if s]
    weight_map = {}
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        with torch.no_grad():
            save_file({name: fn().cpu() for name, _, fn in shard}, out_dir / fname)
        weight_map.update((name, fname) for name, _, _ in shard)
    (out_dir / INDEX_FILE).write_text(json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}))
    (out_dir / "config.json").write_text(json.dumps(hf_config_dict(model.cfg), indent=1))
    if tokenizer_file is not None:
        (out_dir / "tokenizer.json").write_bytes(Path(tokenizer_file).read_bytes())
    return {"shards": len(shards), "tensors": len(weight_map), "bytes": total}
