"""Qwen2.5 text decoder with multimodal RoPE, PyTorch port of
`morphik_core_tpu/models/colqwen/text.py`.

3D (t/h/w) position ids and their cos/sin tables are computed on the
host in numpy (bit-identical mirrors of the reference), so the decoder
applies plain split-half rotary. GQA, causal + padding bias built once
per forward, f32 softmax and norms. The int8 decoder holds
`QuantizedWeight` leaves with dynamic activation scales (W8A8, the
reference's `text.py:147-168`); `linear` dispatches on the leaf. With
`qk_int8` the attention's QK^T runs in int8 with dynamic scales.

On a mesh (`TextDecoder.shard`) each layer is a
`TensorParallelDecoderLayer`: its model shards split attention by query
heads (each with the whole KV heads its heads read) and the MLP by the
intermediate dim (`parallel/mesh.py::text_shard_ranges`); norms, the
embedding and the residual stream stay on the first device of the data
row, and every head computes what the single-device layer computes.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from morphik_core_tpu_torch.models.colqwen.config import TextConfig
from morphik_core_tpu_torch.models.colqwen.layers import (
    apply_rotary,
    attention,
    linear,
    linear_multi,
    rms_norm,
    row_parallel_linear,
    shard_weight,
    swiglu,
)
from morphik_core_tpu_torch.parallel.collectives import broadcast, to_device
from morphik_core_tpu_torch.parallel.mesh import COLQWEN_TEXT_SPECS, replicated, text_shard_ranges
from morphik_core_tpu_torch.models.colqwen.vision import _param, _weight


def mrope_position_ids(
    input_ids: np.ndarray,
    image_token_id: int,
    grids: Sequence[Optional[Tuple[int, int, int]]],
    attention_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Numpy mirror: 3D rope indices, (3, B, S) (Qwen2.5-VL
    `get_rope_index` semantics; grids[b] = (t, h_units, w_units) or None)."""
    b, s = input_ids.shape
    out = np.zeros((3, b, s), dtype=np.int64)
    for i in range(b):
        ids = input_ids[i]
        valid = np.ones(s, dtype=bool) if attention_mask is None else attention_mask[i].astype(bool)
        pos = 0
        j = 0
        while j < s:
            if not valid[j]:
                out[:, i, j] = 1  # padded positions (value irrelevant, masked out)
                j += 1
                continue
            if ids[j] == image_token_id and grids[i] is not None:
                t, h, w = grids[i]
                n = t * h * w
                tt = np.repeat(np.arange(t), h * w)
                hh = np.tile(np.repeat(np.arange(h), w), t)
                ww = np.tile(np.tile(np.arange(w), h), t)
                out[0, i, j : j + n] = pos + tt
                out[1, i, j : j + n] = pos + hh
                out[2, i, j : j + n] = pos + ww
                pos = pos + max(t, h, w)
                j += n
            else:
                out[:, i, j] = pos
                pos += 1
                j += 1
    return out


def mrope_cos_sin(position_ids: np.ndarray, cfg: TextConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy mirror: (3, B, S) -> interleaved-section cos/sin (B, S, head_dim)."""
    hd = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    freqs = position_ids[..., None].astype(np.float64) * inv_freq  # (3, B, S, hd/2)
    emb = np.concatenate([freqs, freqs], axis=-1)  # (3, B, S, hd)
    cos3, sin3 = np.cos(emb), np.sin(emb)
    sections = list(cfg.mrope_section) + list(cfg.mrope_section)
    cos_parts, sin_parts = [], []
    start = 0
    for idx, sec in enumerate(sections):
        end = start + sec
        ch = idx % 3
        cos_parts.append(cos3[ch, ..., start:end])
        sin_parts.append(sin3[ch, ..., start:end])
        start = end
    cos = np.concatenate(cos_parts, axis=-1).astype(np.float32)
    sin = np.concatenate(sin_parts, axis=-1).astype(np.float32)
    return cos, sin


class DecoderLayer(nn.Module):
    """One decoder layer; names follow the JAX tree's `text/layers/<name>`."""

    def __init__(self, cfg: TextConfig, device, dtype, int8: bool = False):
        super().__init__()
        self.cfg = cfg
        h, ih = cfg.hidden_size, cfg.intermediate_size
        qd, kvd = cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
        p = functools.partial(_param, device=device, dtype=dtype)
        w = functools.partial(_weight, device=device, dtype=dtype, int8=int8)
        self.input_ln, self.post_ln = p(h), p(h)
        self.q_w, self.q_b = w(h, qd), p(qd)
        self.k_w, self.k_b = w(h, kvd), p(kvd)
        self.v_w, self.v_b = w(h, kvd), p(kvd)
        self.o_w = w(qd, h)
        self.gate_w, self.up_w, self.down_w = w(h, ih), w(h, ih), w(ih, h)

    def forward(self, x, cos, sin, bias):
        cfg = self.cfg
        b, s, _ = x.shape
        nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        res = x
        y = rms_norm(x, self.input_ln, cfg.rms_norm_eps)
        q, k, v = linear_multi(y, (self.q_w, self.k_w, self.v_w), (self.q_b, self.k_b, self.v_b))
        q, k = apply_rotary(q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd),
                            cos[:, :, None, :], sin[:, :, None, :])
        v = v.reshape(b, s, nkv, hd)
        o = attention(q, k, v, bias=bias, qk_int8=cfg.qk_int8)  # dynamic scales only, as the reference
        x = res + linear(o.reshape(b, s, nh * hd), self.o_w)
        y = rms_norm(x, self.post_ln, cfg.rms_norm_eps)
        return x + swiglu(y, self.gate_w, self.up_w, self.down_w)


class DecoderShard(nn.Module):
    """Model shard j of m of one decoder layer, on one device: the column
    slices of q/k/v (and their biases) and gate/up, the row slices of o
    and down (`text_shard_ranges`)."""

    def __init__(self, layer: DecoderLayer, m: int, j: int, device):
        super().__init__()
        cfg = self.cfg = layer.cfg
        ranges = text_shard_ranges(cfg, m, j)
        for name, split in COLQWEN_TEXT_SPECS.items():
            setattr(self, name, shard_weight(getattr(layer, name), split, *ranges[name], device))
        for name in ("q_b", "k_b", "v_b"):
            lo, hi = ranges[name[0] + "_w"]
            setattr(self, name, nn.Parameter(getattr(layer, name).detach()[lo:hi].to(device, copy=True),
                                             requires_grad=False))
        hd = cfg.head_dim
        (q0, q1), (kv0, _) = ranges["q_w"], ranges["k_w"]
        self.n_heads, self.n_kv = (q1 - q0) // hd, (ranges["k_w"][1] - kv0) // hd
        group = cfg.num_attention_heads // cfg.num_key_value_heads
        # the KV head each local query head reads, among the shard's KV heads
        self.register_buffer("kv_index", torch.arange(q0 // hd, q1 // hd, device=device) // group - kv0 // hd)

    def attention(self, y, cos, sin, bias):
        """The shard's heads of the layer's attention -> (B, S, heads x hd)."""
        cfg = self.cfg
        b, s, _ = y.shape
        hd = cfg.head_dim
        q, k, v = linear_multi(y, (self.q_w, self.k_w, self.v_w), (self.q_b, self.k_b, self.v_b))
        q, k = apply_rotary(q.reshape(b, s, self.n_heads, hd), k.reshape(b, s, self.n_kv, hd),
                            cos[:, :, None, :], sin[:, :, None, :])
        k = k.index_select(2, self.kv_index)
        v = v.reshape(b, s, self.n_kv, hd).index_select(2, self.kv_index)
        return attention(q, k, v, bias=bias, qk_int8=cfg.qk_int8).reshape(b, s, self.n_heads * hd)

    def mlp_in(self, y):
        g, u = linear_multi(y, (self.gate_w, self.up_w), (None, None))
        return F.silu(g) * u


class TensorParallelDecoderLayer(nn.Module):
    """A decoder layer split over a mesh's model axis: one `DecoderShard`
    for each (model index, distinct device) the mesh pairs, norms on the
    first device of each data row."""

    def __init__(self, layer: DecoderLayer, mesh):
        super().__init__()
        self.cfg = layer.cfg
        m = mesh.n_model
        shards = {}
        for (_, j), dev in np.ndenumerate(mesh.devices):
            key = f"{j}@{dev}"
            if key not in shards:
                shards[key] = DecoderShard(layer, m, j, dev)
        self.shards = nn.ModuleDict(shards)
        self.input_ln, self.post_ln = layer.input_ln, layer.post_ln
        ins, posts = (replicated(mesh, w) for w in (self.input_ln, self.post_ln))
        self._norms = {d: (ins[d], posts[d]) for d in ins}

    def forward(self, x, ctx, row):
        """x (B, S, H) on row[0]; ctx: device -> (cos, sin, bias) there;
        row: the data row's devices in model-axis order."""
        eps = self.cfg.rms_norm_eps
        input_ln, post_ln = self._norms[row[0]]
        shards = [self.shards[f"{j}@{d}"] for j, d in enumerate(row)]
        ys = broadcast(rms_norm(x, input_ln, eps), row)
        outs = [sh.attention(y, *ctx[d]) for sh, y, d in zip(shards, ys, row)]
        x = x + row_parallel_linear(outs, [sh.o_w for sh in shards])
        ys = broadcast(rms_norm(x, post_ln, eps), row)
        return x + row_parallel_linear([sh.mlp_in(y) for sh, y in zip(shards, ys)], [sh.down_w for sh in shards])


class TextDecoder(nn.Module):
    def __init__(self, cfg: TextConfig, device, dtype, int8: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device, dtype, int8) for _ in range(cfg.num_hidden_layers)
        )
        self.norm = _param(cfg.hidden_size, device=device, dtype=dtype)
        self._norms = {}  # device -> final norm there, once sharded

    def shard(self, mesh) -> None:
        """Split every layer over the model axis (in place; the full weights
        are dropped) and replicate the final norm over the data rows."""
        layers = list(self.layers)
        self.layers = nn.ModuleList()
        for i, layer in enumerate(layers):  # layer by layer: one full layer beside its shards at a time
            layers[i] = TensorParallelDecoderLayer(layer, mesh)
        self.layers = nn.ModuleList(layers)
        self._norms = replicated(mesh, self.norm)

    def forward(self, inputs_embeds, cos, sin, attention_mask, row=None) -> torch.Tensor:
        """inputs_embeds (B, S, H), cos/sin (B, S, hd), attention_mask (B, S)
        with 1 = valid -> final-norm hidden states (B, S, H). On a mesh,
        `row` is the data row's devices and the inputs live on row[0]."""
        s = inputs_embeds.shape[1]
        causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=inputs_embeds.device))
        mask = causal[None, None] & (attention_mask[:, None, None, :] > 0)
        zero = torch.zeros((), device=mask.device)
        bias = torch.where(mask, zero, torch.full_like(zero, -1e30))  # built once, f32
        x = inputs_embeds
        if row is None:
            for layer in self.layers:
                x = layer(x, cos, sin, bias)
            return rms_norm(x, self.norm, self.cfg.rms_norm_eps)
        ctx = {d: tuple(to_device(t, d) for t in (cos, sin, bias)) for d in dict.fromkeys(row)}
        for layer in self.layers:
            x = layer(x, ctx, row)
        return rms_norm(x, self._norms[row[0]], self.cfg.rms_norm_eps)
