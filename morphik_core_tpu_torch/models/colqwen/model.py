"""ColQwen2.5 late-interaction embedder, PyTorch port of
`morphik_core_tpu/models/colqwen/model.py` (bf16/f32, W8A8 and the int8
QK^T of `attention_precision="int8"`).

Images and queries map to per-token L2-normalized multivectors. The
parameters keep the JAX param tree's names and (K, N) layout, so a JAX
tree (numpy leaves, e.g. from `load_params_npz` or `jax.device_get`),
float or already int8-quantized, loads with `load_jax_params` and both
packages compute one function.

`matmul_precision="int8"` is the shipped serving mode (`morphik_tpu.toml`):
the tower matmul weights of `_Q8_TEXT` / `_Q8_VISION` are `QuantizedWeight`
leaves, and `calibrate_static_act_scales` attaches static activation
scales to the vision tower's. Unlike the reference, which builds a new
param tree, `quantize_colqwen_params` converts a model in place, so a 3B
model never holds its float and int8 weights at once.

`from_checkpoint` serves an HF checkpoint directory: the weights through
`convert.hf_leaves`, the `tokenizer.json` through the port's own Qwen2
BPE (`tokenizer.py`), neither needing the HF packages.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from morphik_core_tpu_torch.device import default_device
from morphik_core_tpu_torch.models.colqwen.config import ColQwenConfig, TextConfig, VisionConfig
from morphik_core_tpu_torch.models.colqwen.convert import hf_leaves
from morphik_core_tpu_torch.models.colqwen.layers import QuantizedWeight, quantize_weight_int8
from morphik_core_tpu_torch.models.colqwen.preprocess import (
    IMAGE_MEAN,
    IMAGE_STD,
    PATCH_SIZE,
    TEMPORAL_PATCH_SIZE,
)
from morphik_core_tpu_torch.models.colqwen.safetensors import CheckpointDir
from morphik_core_tpu_torch.models.colqwen.text import TextDecoder, mrope_cos_sin, mrope_position_ids
from morphik_core_tpu_torch.models.colqwen.tokenizer import QwenTokenizer
from morphik_core_tpu_torch.models.colqwen.vision import VisionTower, _param, vision_rotary_cos_sin

#: weight leaves converted by `quantize_colqwen_params` (the big matmuls;
#: norms, biases, embeddings, patch embed, merger and projection stay)
_Q8_TEXT = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")
_Q8_VISION = ("q_w", "k_w", "v_w", "proj_w", "gate_w", "up_w", "down_w")

# (u8/255 - mean)/std == u8*scale + bias, constants folded on the host
# exactly as the reference folds them
_U8_SCALE = (1.0 / (255.0 * IMAGE_STD)).astype(np.float32)
_U8_BIAS = (-IMAGE_MEAN / IMAGE_STD).astype(np.float32)


def expand_patches_u8(u8: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """(B, S, 588) raw uint8 patches -> (B, S, 1176) CLIP-normalized
    patches with the temporal frame duplicated, on the tensor's device
    (the ingest transfer diet: the host ships 4x fewer bytes)."""
    b, s, f = u8.shape
    pp = PATCH_SIZE * PATCH_SIZE
    c = f // pp
    scale = torch.from_numpy(_U8_SCALE).to(u8.device)
    bias = torch.from_numpy(_U8_BIAS).to(u8.device)
    x = u8.float().reshape(b, s, c, pp)
    x = x * scale[:, None] + bias[:, None]
    x = x[:, :, :, None, :].expand(b, s, c, TEMPORAL_PATCH_SIZE, pp)
    return x.reshape(b, s, f * TEMPORAL_PATCH_SIZE).to(dtype)


def load_params_npz(path) -> dict:
    """Numpy mirror of the reference's npz loader: slash-joined keys ->
    nested dict of numpy arrays (metadata keys skipped)."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            if key.startswith("__"):
                continue
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(z[key])
    return out


def load_config_npz(path) -> Optional[ColQwenConfig]:
    """The embedded `__config__` of a fixture npz, or None."""
    with np.load(path) as z:
        if "__config__" not in z.files:
            return None
        d = json.loads(str(z["__config__"]))
    vis = dict(d.pop("vision"))
    vis["fullatt_block_indexes"] = tuple(vis.get("fullatt_block_indexes", ()))
    txt = dict(d.pop("text"))
    txt["mrope_section"] = tuple(txt.get("mrope_section", ()))
    return ColQwenConfig(vision=VisionConfig(**vis), text=TextConfig(**txt), **d)


def _check_precisions(matmul_precision: str, attention_precision: str) -> None:
    if matmul_precision not in ("bf16", "int8"):
        raise ValueError(f"unknown matmul_precision {matmul_precision!r}")
    if attention_precision not in ("bf16", "int8"):
        raise ValueError(f"unknown attention_precision {attention_precision!r}")


def _layers(model: "ColQwenModel"):
    """(module, quantized leaf names) for every vision block and decoder layer."""
    return [(blk, _Q8_VISION) for blk in model.visual.blocks] + [
        (layer, _Q8_TEXT) for layer in model.text.layers]


def quantize_colqwen_params(model: "ColQwenModel") -> "ColQwenModel":
    """W8A8 serving mode, in place: every `_Q8_TEXT` / `_Q8_VISION` weight
    of a float model becomes a symmetric per-channel int8
    `QuantizedWeight` (dynamic activation scales until calibrated)."""
    if model.matmul_precision != "bf16":
        raise ValueError(f"model is already {model.matmul_precision}")
    for mod, names in _layers(model):
        for name in names:
            q = QuantizedWeight.from_float(getattr(mod, name))
            delattr(mod, name)  # a module may not take a parameter's name
            setattr(mod, name, q)
    model.matmul_precision = "int8"
    return model


def _tensor(arr) -> torch.Tensor:
    """A torch leaf as it is; a numpy (or JAX) leaf copied: JAX hands out
    read-only buffers."""
    return arr if isinstance(arr, torch.Tensor) else torch.tensor(np.asarray(arr))


class _Filler:
    """Fills a model leaf by leaf from the JAX tree's paths, checking
    shapes and, at the end, that every parameter and int8 leaf was
    filled. An int8 model takes quantized leaves ({"q8", "s"[, "as"]}) or
    float leaves, which it quantizes; a float model takes float leaves
    only. The vision blocks' `attn_qk_as` (static scales of the int8
    QK^T) is optional."""

    def __init__(self, model: "ColQwenModel"):
        self.model = model
        self.assigned = set()

    def _put(self, param: nn.Parameter, arr, name: str) -> None:
        t = _tensor(arr)
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(t.to(device=param.device, dtype=param.dtype))
        self.assigned.add(id(param))

    def _put_weight(self, mod: nn.Module, key: str, leaf, name: str) -> None:
        target = getattr(mod, key)
        if not isinstance(target, QuantizedWeight):
            if isinstance(leaf, dict):
                raise ValueError(f"{name}: int8 leaf for a {self.model.matmul_precision} model")
            return self._put(target, leaf, name)
        if isinstance(leaf, dict):
            if set(leaf) - {"q8", "s", "as"}:
                raise ValueError(f"{name}: unknown quantized leaf keys {sorted(leaf)}")
            target.load(_tensor(leaf["q8"]), _tensor(leaf["s"]), _tensor(leaf["as"]) if "as" in leaf else None)
        else:
            t = _tensor(leaf)
            if tuple(t.shape) != (target.k, target.n):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != {(target.k, target.n)}")
            target.load(*quantize_weight_int8(t.to(target.q8.device)))
        self.assigned.add(id(target))

    def leaf(self, path: Tuple[str, ...], layer: Optional[int], value) -> None:
        """Fill the leaf at `path` of the JAX tree (`layer`: the slice of a
        stacked per-layer leaf)."""
        name = "/".join(path) + ("" if layer is None else f"[{layer}]")
        model = self.model
        if path[:2] in (("visual", "blocks"), ("text", "layers")):
            mods = model.visual.blocks if path[0] == "visual" else model.text.layers
            if layer is None or not 0 <= layer < len(mods):
                raise ValueError(f"{name}: no such layer of {len(mods)}")
            if path[2] == "attn_qk_as" and path[0] == "visual":
                return mods[layer].set_qk_scales(_tensor(value))
            if not isinstance(getattr(mods[layer], path[2], None), (nn.Parameter, QuantizedWeight)):
                raise ValueError(f"{name}: unknown leaf")
            return self._put_weight(mods[layer], path[2], value, name)
        owner = {("visual",): model.visual, ("visual", "merger"): model.visual.merger,
                 ("text",): model.text, (): model}.get(path[:-1])
        if owner is None or not isinstance(getattr(owner, path[-1], None), nn.Parameter):
            raise ValueError(f"{name}: unknown leaf")
        self._put(getattr(owner, path[-1]), value, name)

    def finish(self) -> None:
        model = self.model
        missing = [n for n, p in model.named_parameters() if id(p) not in self.assigned]
        missing += [n for n, m in model.named_modules() if isinstance(m, QuantizedWeight)
                    and id(m) not in self.assigned]
        if missing:
            raise ValueError(f"param tree lacks {missing[:5]} ({len(missing)} leaves)")


def load_jax_params(model: "ColQwenModel", tree: dict) -> None:
    """Fill `model` from a JAX ColQwen param tree with numpy (or torch)
    leaves. Stacked per-layer leaves (L, ...) are sliced into the
    per-layer modules (see `_Filler` for the int8 forms). Raises on a
    missing leaf, an extra leaf or a shape mismatch."""
    filler = _Filler(model)

    def stacked(path: Tuple[str, str], leaves: dict) -> None:
        want = len(model.visual.blocks if path[0] == "visual" else model.text.layers)
        for name, arr in leaves.items():
            n_layers = len(arr["q8"] if isinstance(arr, dict) else arr)
            if n_layers != want:
                raise ValueError(f"{'/'.join(path)}/{name}: {n_layers} layers != {want}")
            for li in range(n_layers):
                filler.leaf(path + (name,), li, {k: v[li] for k, v in arr.items()} if isinstance(arr, dict)
                            else arr[li])

    vis, txt = tree["visual"], tree["text"]
    filler.leaf(("visual", "patch_embed_w"), None, vis["patch_embed_w"])
    stacked(("visual", "blocks"), vis["blocks"])
    for name, arr in vis["merger"].items():
        filler.leaf(("visual", "merger", name), None, arr)
    filler.leaf(("text", "embed"), None, txt["embed"])
    filler.leaf(("text", "norm"), None, txt["norm"])
    stacked(("text", "layers"), txt["layers"])
    filler.leaf(("proj_w",), None, tree["proj_w"])
    filler.leaf(("proj_b",), None, tree["proj_b"])
    filler.finish()


class ColQwenModel(nn.Module):
    """Vision tower + text decoder + projection, with the reference's
    prompt templates, query length buckets and tokenizer (or its byte
    fallback)."""

    IMAGE_PREFIX = "<|im_start|>user\n<|vision_start|>"
    IMAGE_SUFFIX = "<|vision_end|>Describe the image.<|im_end|>\n"
    QUERY_PREFIX = "Query: "
    QUERY_AUGMENTATION_TOKENS = 10
    QUERY_BUCKETS = (32, 64, 128, 256)

    def __init__(
        self,
        cfg: ColQwenConfig,
        device=None,
        dtype=torch.bfloat16,
        matmul_precision: str = "bf16",
        attention_precision: str = "bf16",
        tokenizer: Optional[QwenTokenizer] = None,
    ):
        """Parameters are allocated uninitialised on `device`; fill them
        with `init_random`, `from_fixture`, `from_checkpoint` or
        `load_jax_params`. `matmul_precision`: "bf16" (the model's dtype)
        or "int8" (W8A8 leaves); `attention_precision`: "bf16" or "int8"
        (the int8 QK^T in every attention of both towers; the windowed
        vision blocks then run it in place of K3). Without a `tokenizer`,
        text goes through the reference's byte fallback."""
        super().__init__()
        _check_precisions(matmul_precision, attention_precision)
        if attention_precision == "int8":
            cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, qk_int8=True),
                                      text=dataclasses.replace(cfg.text, qk_int8=True))
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = torch.device(device) if device is not None else default_device()
        self.dtype = dtype
        self.matmul_precision = matmul_precision
        self.attention_precision = attention_precision
        int8 = matmul_precision == "int8"
        self.visual = VisionTower(cfg.vision, self.device, dtype, int8)
        self.text = TextDecoder(cfg.text, self.device, dtype, int8)
        self.proj_w = _param(cfg.text.hidden_size, cfg.embedding_dim, device=self.device, dtype=dtype)
        self.proj_b = _param(cfg.embedding_dim, device=self.device, dtype=dtype)

    # -- construction -----------------------------------------------------

    @classmethod
    def init_random(cls, cfg: Optional[ColQwenConfig] = None, seed: int = 0, device=None,
                    dtype=torch.float32, attention_precision: str = "bf16") -> "ColQwenModel":
        """Random weights by the reference's init law (N(0, 0.02) matrices
        and embeddings, unit norms, zero biases), drawn from a seeded
        `torch.Generator` on the target device in `dtype`."""
        model = cls(cfg or ColQwenConfig.tiny(), device=device, dtype=dtype, attention_precision=attention_precision)
        gen = torch.Generator(device=model.device)
        gen.manual_seed(seed)
        with torch.no_grad():
            for name, p in model.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if leaf.endswith("_w") or leaf == "embed":
                    for chunk in p.view(-1, p.shape[-1]).split(4096):
                        chunk.copy_(torch.randn(chunk.shape, generator=gen, device=model.device) * 0.02)
                elif leaf.endswith("_b"):
                    p.zero_()
                else:  # norm weights
                    p.fill_(1.0)
        return model

    @classmethod
    def from_fixture(cls, path, device=None, matmul_precision: str = "bf16") -> "ColQwenModel":
        """The committed tiny trained fixture (npz), in f32 (its matmul
        weights quantized with `matmul_precision="int8"`)."""
        path = Path(path)
        model = cls(load_config_npz(path) or ColQwenConfig.tiny(), device=device,
                    dtype=torch.float32, matmul_precision=matmul_precision)
        load_jax_params(model, load_params_npz(path))
        return model

    @classmethod
    def from_checkpoint(cls, path, dtype=torch.bfloat16, device=None, matmul_precision: str = "bf16",
                        attention_precision: str = "bf16") -> "ColQwenModel":
        """An HF-format ColQwen2.5 checkpoint directory (config.json,
        *.safetensors, an optional tokenizer.json), its weights converted
        to `dtype` on `device` one tensor at a time and, with
        `matmul_precision="int8"`, quantized there. A tokenizer.json in
        another layout, a malformed file or a missing `custom_text_proj`
        raises."""
        path = Path(path)
        cfg = ColQwenConfig.from_hf_config(path / "config.json")
        tok_file = path / "tokenizer.json"
        tokenizer = QwenTokenizer.from_file(tok_file) if tok_file.exists() else None
        state = CheckpointDir(path)
        model = cls(cfg, device=device, dtype=dtype, matmul_precision=matmul_precision,
                    attention_precision=attention_precision, tokenizer=tokenizer)
        filler = _Filler(model)
        for leaf_path, layer, value in hf_leaves(state, cfg, dtype, model.device):
            filler.leaf(leaf_path, layer, value)
        filler.finish()
        return model

    @torch.no_grad()
    def calibrate_static_act_scales(self, u8_batches: Sequence[np.ndarray], h_units: int,
                                    w_units: int, margin: float = 1.05) -> None:
        """Calibrate static per-(layer, site) activation scales of the int8
        vision tower on (B, S, 588) uint8 page batches of one grid and
        serve with them (models/colqwen/calibrate.py)."""
        if self.matmul_precision != "int8":
            raise ValueError("static activation scales require matmul_precision='int8'")
        from morphik_core_tpu_torch.models.colqwen.calibrate import (
            attach_vision_act_scales,
            capture_vision_act_maxes,
        )

        maxes, qk_maxes = capture_vision_act_maxes(self, u8_batches, h_units, w_units)
        attach_vision_act_scales(self, maxes, margin, qk_maxes)

    # -- forward ----------------------------------------------------------

    def _project(self, hidden, mask) -> torch.Tensor:
        proj = (hidden @ self.proj_w + self.proj_b).float()
        norm = torch.linalg.vector_norm(proj, dim=-1, keepdim=True)
        return proj / norm.clamp(min=1e-12) * mask[..., None]

    def image_forward(self, patches, cos_v, sin_v, input_ids, cos_t, sin_t,
                      h_units: int, w_units: int) -> torch.Tensor:
        """patches (B, S, 588) uint8 or (B, S, 1176) float -> (B, S_seq,
        embedding_dim) L2-normalized f32 multivectors."""
        if patches.dtype == torch.uint8:
            patches = expand_patches_u8(patches, self.dtype)
        vis = self.visual(patches.to(self.dtype), cos_v, sin_v, h_units, w_units)
        embeds = self.text.embed[input_ids]
        # image-pad positions are one contiguous run, identical across the
        # batch: align the visual stream by a cumsum index and select
        is_img = input_ids == self.cfg.image_token_id
        idx = (torch.cumsum(is_img.to(torch.int32), dim=1) - 1).clamp(0, vis.shape[1] - 1)
        vis_aligned = torch.gather(vis, 1, idx[..., None].long().expand(-1, -1, vis.shape[-1]))
        embeds = torch.where(is_img[..., None], vis_aligned.to(embeds.dtype), embeds)
        mask = torch.ones(input_ids.shape, dtype=torch.float32, device=input_ids.device)
        hidden = self.text(embeds, cos_t, sin_t, mask)
        return self._project(hidden, mask)

    def text_forward(self, input_ids, attention_mask, cos_t, sin_t) -> torch.Tensor:
        embeds = self.text.embed[input_ids]
        hidden = self.text(embeds, cos_t, sin_t, attention_mask)
        return self._project(hidden, attention_mask)

    # -- image path -------------------------------------------------------

    def image_sequence_ids(self, n_units: int) -> np.ndarray:
        prefix = self._encode(self.IMAGE_PREFIX)
        suffix = self._encode(self.IMAGE_SUFFIX)
        return np.array(list(prefix) + [self.cfg.image_token_id] * n_units + list(suffix), dtype=np.int64)

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    @torch.no_grad()
    def embed_image_batch(self, patches: np.ndarray, h_units: int, w_units: int,
                          as_device: bool = False):
        """patches (B, S, 588) uint8 or (B, S, 1176) float for one grid
        bucket -> (B, S_seq, dim) f32 numpy, or the device tensor with
        `as_device=True`."""
        b = patches.shape[0]
        cos_v, sin_v = vision_rotary_cos_sin(h_units, w_units, self.cfg.vision)
        ids = self.image_sequence_ids(h_units * w_units)
        input_ids = np.tile(ids[None], (b, 1))
        pos = mrope_position_ids(input_ids, self.cfg.image_token_id, [(1, h_units, w_units)] * b)
        cos_t, sin_t = mrope_cos_sin(pos, self.cfg.text)
        out = self.image_forward(
            self._dev(patches), self._dev(cos_v), self._dev(sin_v), self._dev(input_ids),
            self._dev(cos_t), self._dev(sin_t), h_units, w_units,
        )
        return out if as_device else out.cpu().numpy()

    # -- query path -------------------------------------------------------

    def _encode(self, text: str) -> List[int]:
        """The tokenizer's ids, or without one the reference's
        deterministic byte fallback."""
        if self.tokenizer is None:
            return [b % (self.cfg.text.vocab_size - 8) for b in text.encode()]
        return self.tokenizer.encode(text)

    def query_token_ids(self, query: str) -> List[int]:
        ids = self._encode(self.QUERY_PREFIX + query)
        eot = self._encode("<|endoftext|>")
        aug = (eot if len(eot) == 1 else [self.cfg.text.vocab_size - 1]) * self.QUERY_AUGMENTATION_TOKENS
        return ids + aug

    @torch.no_grad()
    def embed_queries(self, queries: Sequence[str]) -> List[np.ndarray]:
        """-> list of (n_tokens_i, dim) f32 multivectors. Queries are
        grouped by length bucket, so one long query does not re-pad the
        whole batch."""
        if not queries:
            return []
        all_ids = [self.query_token_ids(q) for q in queries]

        def bucket_of(n: int) -> int:
            return next((b for b in self.QUERY_BUCKETS if b >= n), n)

        groups: Dict[int, List[int]] = {}
        for i, ids in enumerate(all_ids):
            groups.setdefault(bucket_of(len(ids)), []).append(i)
        out: List[Optional[np.ndarray]] = [None] * len(all_ids)
        for bucket, idxs in sorted(groups.items()):
            b = len(idxs)
            input_ids = np.zeros((b, bucket), dtype=np.int64)
            mask = np.zeros((b, bucket), dtype=np.float32)
            for j, i in enumerate(idxs):
                n = min(len(all_ids[i]), bucket)
                input_ids[j, :n] = all_ids[i][:n]
                mask[j, :n] = 1.0
            pos = mrope_position_ids(input_ids, -1, [None] * b, attention_mask=mask)
            cos_t, sin_t = mrope_cos_sin(pos, self.cfg.text)
            emb = self.text_forward(
                self._dev(input_ids), self._dev(mask), self._dev(cos_t), self._dev(sin_t)
            ).cpu().numpy()
            for j, i in enumerate(idxs):
                out[i] = emb[j, : min(len(all_ids[i]), bucket)]
        return out  # type: ignore[return-value]
