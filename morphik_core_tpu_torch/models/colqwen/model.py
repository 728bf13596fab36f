"""ColQwen2.5 late-interaction embedder, PyTorch port of
`morphik_core_tpu/models/colqwen/model.py` (bf16/f32 and W8A8).

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
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from morphik_core_tpu_torch.device import default_device
from morphik_core_tpu_torch.models.colqwen.config import ColQwenConfig, TextConfig, VisionConfig
from morphik_core_tpu_torch.models.colqwen.layers import QuantizedWeight, quantize_weight_int8
from morphik_core_tpu_torch.models.colqwen.preprocess import (
    IMAGE_MEAN,
    IMAGE_STD,
    PATCH_SIZE,
    TEMPORAL_PATCH_SIZE,
)
from morphik_core_tpu_torch.models.colqwen.text import TextDecoder, mrope_cos_sin, mrope_position_ids
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
    if attention_precision == "int8":
        raise ValueError(
            "attention_precision='int8' (the int8 QK^T of morphik_core_tpu/models/colqwen/"
            "layers.py:213-231) is not ported; the shipped config serves bf16 attention")
    if attention_precision != "bf16":
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


def load_jax_params(model: "ColQwenModel", tree: dict) -> None:
    """Fill `model` from a JAX ColQwen param tree with numpy leaves.
    Stacked per-layer leaves (L, ...) are sliced into the per-layer
    modules. An int8 model takes quantized leaves ({"q8", "s"[, "as"]},
    as `quantize_colqwen_params` and `attach_vision_act_scales` of the
    reference make them) or float leaves, which it quantizes; a float
    model takes float leaves only. The reference's inert `attn_qk_as`
    leaf (static scales of the unported int8 QK^T) is skipped. Raises on
    a missing leaf, an extra leaf or a shape mismatch."""
    assigned = set()

    def tensor(arr) -> torch.Tensor:
        return torch.tensor(np.asarray(arr))  # a copy: JAX hands out read-only buffers

    def put(param: nn.Parameter, arr, name: str) -> None:
        t = tensor(arr)
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(t.to(device=param.device, dtype=param.dtype))
        assigned.add(id(param))

    def put_leaf(mod: nn.Module, key: str, leaf, name: str) -> None:
        target = getattr(mod, key)
        if not isinstance(target, QuantizedWeight):
            if isinstance(leaf, dict):
                raise ValueError(f"{name}: int8 leaf for a {model.matmul_precision} model")
            return put(target, leaf, name)
        if isinstance(leaf, dict):
            if set(leaf) - {"q8", "s", "as"}:
                raise ValueError(f"{name}: unknown quantized leaf keys {sorted(leaf)}")
            target.load(tensor(leaf["q8"]), tensor(leaf["s"]),
                        tensor(leaf["as"]) if "as" in leaf else None)
        else:
            t = tensor(leaf)
            if tuple(t.shape) != (target.k, target.n):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != {(target.k, target.n)}")
            target.load(*quantize_weight_int8(t.to(target.q8.device)))
        assigned.add(id(target))

    def stacked(modules, leaves: dict, prefix: str) -> None:
        for name, arr in leaves.items():
            if name == "attn_qk_as":
                continue
            n_layers = len(np.asarray(arr["q8"] if isinstance(arr, dict) else arr))
            if n_layers != len(modules):
                raise ValueError(f"{prefix}/{name}: {n_layers} layers != {len(modules)}")
            for li, mod in enumerate(modules):
                leaf = ({k: np.asarray(v)[li] for k, v in arr.items()} if isinstance(arr, dict)
                        else np.asarray(arr)[li])
                put_leaf(mod, name, leaf, f"{prefix}/{name}[{li}]")

    vis = tree["visual"]
    put(model.visual.patch_embed_w, vis["patch_embed_w"], "visual/patch_embed_w")
    stacked(model.visual.blocks, vis["blocks"], "visual/blocks")
    for name, arr in vis["merger"].items():
        put(getattr(model.visual.merger, name), arr, f"visual/merger/{name}")
    txt = tree["text"]
    put(model.text.embed, txt["embed"], "text/embed")
    put(model.text.norm, txt["norm"], "text/norm")
    stacked(model.text.layers, txt["layers"], "text/layers")
    put(model.proj_w, tree["proj_w"], "proj_w")
    put(model.proj_b, tree["proj_b"], "proj_b")
    missing = [n for n, p in model.named_parameters() if id(p) not in assigned]
    missing += [n for n, m in model.named_modules() if isinstance(m, QuantizedWeight) and id(m) not in assigned]
    if missing:
        raise ValueError(f"param tree lacks {missing[:5]} ({len(missing)} leaves)")


class ColQwenModel(nn.Module):
    """Vision tower + text decoder + projection, with the reference's
    prompt templates, query length buckets and byte-fallback tokenizer."""

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
    ):
        """Parameters are allocated uninitialised on `device`; fill them
        with `init_random`, `from_fixture` or `load_jax_params`.
        `matmul_precision`: "bf16" (the model's dtype) or "int8" (W8A8
        leaves); `attention_precision`: "bf16" only in the port."""
        super().__init__()
        _check_precisions(matmul_precision, attention_precision)
        self.cfg = cfg
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
                    dtype=torch.float32) -> "ColQwenModel":
        """Random weights by the reference's init law (N(0, 0.02) matrices
        and embeddings, unit norms, zero biases), drawn from a seeded
        `torch.Generator` on the target device in `dtype`."""
        model = cls(cfg or ColQwenConfig.tiny(), device=device, dtype=dtype)
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

        maxes, _ = capture_vision_act_maxes(self, u8_batches, h_units, w_units)
        attach_vision_act_scales(self, maxes, margin)

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
        """The reference's deterministic byte-fallback tokenizer (the HF
        tokenizer arrives with checkpoint loading, not ported yet)."""
        return [b % (self.cfg.text.vocab_size - 8) for b in text.encode()]

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
