"""ColQwen2.5 model configuration: a dataclass mirror of
`morphik_core_tpu/models/colqwen/config.py` (that package's `__init__`
imports jax). `dataclasses.asdict` of both agree for `tiny()` and the
defaults, which are the 3B ("Qwen2.5-VL-3B-Instruct") geometry.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    window_size: int = 112
    out_hidden_size: int = 2048
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    rms_norm_eps: float = 1e-6
    # int8 QK^T contraction (per-token/head scales, int32 MXU accumulate);
    # set via ColQwenModel(attention_precision="int8"), fidelity-gated
    qk_int8: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_input_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size * self.patch_size

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size**2

    @property
    def window_units(self) -> int:
        """Window side length in merged (llm-grid) units."""
        return self.window_size // self.spatial_merge_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 11008
    num_hidden_layers: int = 36
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    mrope_section: Tuple[int, ...] = (16, 24, 24)
    tie_word_embeddings: bool = True
    qk_int8: bool = False  # see VisionConfig.qk_int8

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class ColQwenConfig:
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    embedding_dim: int = 128
    # Special token ids (Qwen2.5 tokenizer defaults).
    image_token_id: int = 151655
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653

    @staticmethod
    def tiny(vocab_size: int = 512) -> "ColQwenConfig":
        """A small config for unit tests / golden parity runs vs torch."""
        return ColQwenConfig(
            vision=VisionConfig(
                depth=4,
                hidden_size=64,
                intermediate_size=128,
                num_heads=4,
                out_hidden_size=48,
                fullatt_block_indexes=(1, 3),
            ),
            text=TextConfig(
                vocab_size=vocab_size,
                hidden_size=48,
                intermediate_size=96,
                num_hidden_layers=3,
                num_attention_heads=4,
                num_key_value_heads=2,
                mrope_section=(2, 2, 2),
            ),
            embedding_dim=16,
            image_token_id=vocab_size - 3,
            vision_start_token_id=vocab_size - 2,
            vision_end_token_id=vocab_size - 1,
        )

    @staticmethod
    def from_hf_config(path: str | Path) -> "ColQwenConfig":
        """Parse an HF `config.json` (Qwen2.5-VL / ColQwen2.5 layout)."""
        with open(Path(path)) as f:
            raw = json.load(f)
        v = raw.get("vision_config", {})
        t = raw.get("text_config", raw)
        vision = VisionConfig(
            depth=v.get("depth", 32),
            hidden_size=v.get("hidden_size", 1280),
            intermediate_size=v.get("intermediate_size", 3420),
            num_heads=v.get("num_heads", 16),
            in_channels=v.get("in_channels", 3),
            patch_size=v.get("patch_size", 14),
            spatial_merge_size=v.get("spatial_merge_size", 2),
            temporal_patch_size=v.get("temporal_patch_size", 2),
            window_size=v.get("window_size", 112),
            out_hidden_size=v.get("out_hidden_size", 2048),
            fullatt_block_indexes=tuple(v.get("fullatt_block_indexes", (7, 15, 23, 31))),
        )
        text = TextConfig(
            vocab_size=t.get("vocab_size", 151936),
            hidden_size=t.get("hidden_size", 2048),
            intermediate_size=t.get("intermediate_size", 11008),
            num_hidden_layers=t.get("num_hidden_layers", 36),
            num_attention_heads=t.get("num_attention_heads", 16),
            num_key_value_heads=t.get("num_key_value_heads", 2),
            rms_norm_eps=t.get("rms_norm_eps", 1e-6),
            rope_theta=t.get("rope_theta", 1000000.0),
            mrope_section=tuple(
                (t.get("rope_scaling") or raw.get("rope_scaling") or {}).get("mrope_section", (16, 24, 24))
            ),
            tie_word_embeddings=raw.get("tie_word_embeddings", True),
        )
        return ColQwenConfig(
            vision=vision,
            text=text,
            embedding_dim=raw.get("embedding_dim", 128),
            image_token_id=raw.get("image_token_id", 151655),
            vision_start_token_id=raw.get("vision_start_token_id", 151652),
            vision_end_token_id=raw.get("vision_end_token_id", 151653),
        )
