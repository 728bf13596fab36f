"""Static activation-scale calibration for the int8 vision tower, PyTorch
port of `morphik_core_tpu/models/colqwen/calibrate.py`.

The W8A8 tower quantizes activations per token on the fly unless a
matmul leaf carries a calibrated static scale. Calibration runs page
batches through the int8 vision tower with dynamic quantization, takes
the max |activation| at each block's four matmul inputs (qkv, attention
proj, gate/up, down) and attaches `margin * max / 127` to the leaves of
that site. Scales transfer across grid buckets (they follow the
layernormed features, not the token count), so one bucket serves all.

The pages: 16 deterministic synthetic text pages rendered with PIL and
preprocessed to their one grid bucket, (24, 20) units. PIL is not
installed beside the card, so the pages are committed as uint8 patches
(`calib_pages_u8.npz`, written by `write_calibration_fixture`) and every
machine calibrates from that file.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
import torch

from morphik_core_tpu_torch.models.colqwen.vision import vision_rotary_cos_sin

#: capture column -> the quantized leaves sharing that activation
_SITE_COLUMNS = (("q_w", "k_w", "v_w"), ("proj_w",), ("gate_w", "up_w"), ("down_w",))

CALIBRATION_PAGES = Path(__file__).with_name("calib_pages_u8.npz")


@torch.no_grad()
def capture_vision_act_maxes(model, u8_batches: Sequence[np.ndarray], h_units: int,
                             w_units: int) -> Tuple[np.ndarray, np.ndarray]:
    """Run (B, S, 588) uint8 batches of one grid through the model's int8
    vision tower; returns the element-wise max over batches of
    (act (depth, 4) f32, columns qkv, proj, gate/up, down; qk (depth, 2)
    f32, max |q| and max |k| after rotary)."""
    from morphik_core_tpu_torch.models.colqwen.model import expand_patches_u8

    if model.matmul_precision != "int8":
        raise ValueError("vision params are not int8-quantized: nothing to calibrate")
    cos, sin = (torch.from_numpy(t).to(model.device)
                for t in vision_rotary_cos_sin(h_units, w_units, model.cfg.vision))
    act = qk = None
    for u8 in u8_batches:
        # the reference expands calibration pages to bf16 whatever the model dtype
        patches = expand_patches_u8(torch.from_numpy(np.ascontiguousarray(u8)).to(model.device),
                                    torch.bfloat16).to(model.dtype)
        a, q = (t.cpu().numpy() for t in model.visual(patches, cos, sin, h_units, w_units, capture=True))
        act = a if act is None else np.maximum(act, a)
        qk = q if qk is None else np.maximum(qk, q)
    if act is None:
        raise ValueError("no calibration batches")
    return act, qk


def attach_vision_act_scales(model, maxes: np.ndarray, margin: float = 1.05) -> None:
    """Attach static scales in place: as[l] = max(margin * max|x|_l / 127,
    1e-8) to every leaf of each capture column of block l."""
    blocks = model.visual.blocks
    if maxes.shape != (len(blocks), len(_SITE_COLUMNS)):
        raise ValueError(f"maxes shape {maxes.shape} != {(len(blocks), len(_SITE_COLUMNS))}")
    for col, names in enumerate(_SITE_COLUMNS):
        scale = np.maximum(maxes[:, col] * margin / 127.0, 1e-8).astype(np.float32)
        for li, blk in enumerate(blocks):
            for name in names:
                getattr(blk, name).set_act_scale(scale[li])


def load_calibration_pages(path=CALIBRATION_PAGES) -> Tuple[np.ndarray, Tuple[int, int]]:
    """The committed calibration pages: ((N, S, 588) uint8, grid)."""
    with np.load(path) as z:
        return z["u8"], tuple(int(g) for g in z["grid"])


def calibration_batches(u8: np.ndarray, batch: int = 8) -> List[np.ndarray]:
    return [u8[s : s + batch] for s in range(0, len(u8), batch)]


def render_calibration_pages(n: int = 16, seed: int = 0, size=(560, 720)) -> list:
    """Deterministic synthetic text pages (PIL images), the reference's
    renderer: dense mixed-case technical text in black on white."""
    from PIL import Image, ImageDraw  # noqa: PLC0415  (not installed beside the card)

    vocab = (
        "alpha bridge casing dynamo ember flux gasket helix ion joule kelvin "
        "lumen motor nacelle orbit piston quartz rotor stator torque valve "
        "winding yoke zenith SPEC-9174 Nm kW rpm 61400-25 IEC"
    ).split()
    pages = []
    for s in range(n):
        r = np.random.default_rng(seed * 1000 + s)
        img = Image.new("RGB", size, "white")
        d = ImageDraw.Draw(img)
        y = 8
        while y < size[1] - 24:
            d.text((int(r.integers(6, 80)), y), " ".join(r.choice(vocab, r.integers(3, 10))), fill="black")
            y += int(r.integers(14, 24))
        pages.append(img)
    return pages


def pages_to_fixture(pages) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Preprocess PIL pages and keep those of the dominant grid bucket."""
    from morphik_core_tpu_torch.models.colqwen.preprocess import preprocess_image_u8

    prepped = [preprocess_image_u8(im) for im in pages]
    grid = Counter(g for _, g in prepped).most_common(1)[0][0]
    return np.stack([p for p, g in prepped if g == grid]), tuple(grid)


def write_calibration_fixture(path=CALIBRATION_PAGES, n_pages: int = 16, seed: int = 0) -> None:
    """Render, preprocess and save the calibration pages (needs PIL):
    `python -c "from morphik_core_tpu_torch.models.colqwen.calibrate import
    write_calibration_fixture as w; w()"`."""
    u8, grid = pages_to_fixture(render_calibration_pages(n_pages, seed))
    np.savez_compressed(path, u8=u8, grid=np.asarray(grid, np.int64))
