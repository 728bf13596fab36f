"""Host-side image preprocessing for the ColQwen tower: a numpy mirror of
`morphik_core_tpu/models/colqwen/preprocess.py` (bit-identical).

Images resize to multiples of 112 px (llm grid multiples of the 4-unit
attention window), so every page lands on a static grid bucket and
window attention is a pure reshape. PIL is imported only inside the
functions that take an image: the card's path ships uint8 patches and
never imports it.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

# CLIP normalization constants (Qwen2VL processor defaults).
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)

PATCH_SIZE = 14
MERGE_SIZE = 2
TEMPORAL_PATCH_SIZE = 2
WINDOW_FACTOR = PATCH_SIZE * MERGE_SIZE * 4  # 112 px: llm grid multiple of window


def smart_resize(
    height: int,
    width: int,
    factor: int = WINDOW_FACTOR,
    min_pixels: int = 1 * WINDOW_FACTOR * WINDOW_FACTOR,
    max_pixels: int = 60 * WINDOW_FACTOR * WINDOW_FACTOR,
) -> Tuple[int, int]:
    """Resize target with both dims divisible by `factor`, total pixels in
    [min_pixels, max_pixels], aspect ratio approximately preserved."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("aspect ratio must be < 200")
    # exact formula of the reference processor's smart_resize
    # (transformers qwen2_vl.image_processing_qwen2_vl), parameterized at
    # our 112-px factor: the initial rounding is NOT clamped to `factor`,
    # so extreme aspect ratios take the min_pixels rescale branch
    h = round(height / factor) * factor
    w = round(width / factor) * factor
    if h * w > max_pixels:
        beta = math.sqrt(height * width / max_pixels)
        h = max(factor, math.floor(height / beta / factor) * factor)
        w = max(factor, math.floor(width / beta / factor) * factor)
    elif h * w < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h = math.ceil(height * beta / factor) * factor
        w = math.ceil(width * beta / factor) * factor
    return h, w


def preprocess_image(
    image: "Image.Image",
    min_pixels: int = 1 * WINDOW_FACTOR * WINDOW_FACTOR,
    max_pixels: int = 60 * WINDOW_FACTOR * WINDOW_FACTOR,
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """PIL image -> (patches (S, 1176), (h_units, w_units)).

    S = h_units * w_units * 4 patches; patch features ordered
    (channel, temporal, patch_h, patch_w) to match the checkpoint's
    patch-embed kernel layout.
    """
    from PIL import Image

    if image.mode != "RGB":
        image = image.convert("RGB")
    h, w = smart_resize(image.height, image.width, min_pixels=min_pixels, max_pixels=max_pixels)
    image = image.resize((w, h), Image.Resampling.BICUBIC)
    arr = np.asarray(image, dtype=np.float32) / 255.0
    arr = (arr - IMAGE_MEAN) / IMAGE_STD  # (H, W, C)
    arr = arr.transpose(2, 0, 1)  # (C, H, W)
    return patchify(arr), (h // (PATCH_SIZE * MERGE_SIZE), w // (PATCH_SIZE * MERGE_SIZE))


def preprocess_image_u8(
    image: "Image.Image",
    min_pixels: int = 1 * WINDOW_FACTOR * WINDOW_FACTOR,
    max_pixels: int = 60 * WINDOW_FACTOR * WINDOW_FACTOR,
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """PIL image -> (uint8 patches (S, 588), (h_units, w_units)): the
    ingest transfer diet. Raw uint8 pixels ship once, in (channel, ph,
    pw) order (588 B/patch); `model.expand_patches_u8` normalizes and
    duplicates the temporal frame on the device (4x fewer host->device
    bytes than bf16 patches of `preprocess_image`)."""
    from PIL import Image

    if image.mode != "RGB":
        image = image.convert("RGB")
    h, w = smart_resize(image.height, image.width, min_pixels=min_pixels, max_pixels=max_pixels)
    image = image.resize((w, h), Image.Resampling.BICUBIC)
    arr = np.asarray(image, dtype=np.uint8).transpose(2, 0, 1)  # (C, H, W)
    return patchify_u8(arr), (h // (PATCH_SIZE * MERGE_SIZE), w // (PATCH_SIZE * MERGE_SIZE))


def patchify_u8(chw: np.ndarray) -> np.ndarray:
    """(C, H, W) uint8 pixels -> (S, C*ph*pw) uint8 patches in the same
    (h_unit, w_unit, merge_h, merge_w) sequence order as `patchify`,
    minus the temporal duplication (done on device)."""
    c, h, w = chw.shape
    gh, gw = h // PATCH_SIZE, w // PATCH_SIZE
    x = chw.reshape(
        c, gh // MERGE_SIZE, MERGE_SIZE, PATCH_SIZE, gw // MERGE_SIZE, MERGE_SIZE, PATCH_SIZE
    )
    # -> (h_unit, w_unit, merge_h, merge_w, C, ph, pw)
    x = x.transpose(1, 4, 2, 5, 0, 3, 6)
    return np.ascontiguousarray(x).reshape(gh * gw, c * PATCH_SIZE * PATCH_SIZE)


def patchify(chw: np.ndarray) -> np.ndarray:
    """(C, H, W) normalized pixels -> (S, C*T*ps*ps) patches in
    (h_unit, w_unit, merge_h, merge_w) sequence order."""
    c, h, w = chw.shape
    gh, gw = h // PATCH_SIZE, w // PATCH_SIZE
    # duplicate the frame for the temporal patch dim (static images)
    x = np.broadcast_to(chw[None], (TEMPORAL_PATCH_SIZE, c, h, w))
    x = x.reshape(
        TEMPORAL_PATCH_SIZE,
        c,
        gh // MERGE_SIZE,
        MERGE_SIZE,
        PATCH_SIZE,
        gw // MERGE_SIZE,
        MERGE_SIZE,
        PATCH_SIZE,
    )
    # -> (h_unit, w_unit, merge_h, merge_w, C, T, ph, pw)
    x = x.transpose(2, 5, 3, 6, 1, 0, 4, 7)
    return np.ascontiguousarray(x).reshape(gh * gw, c * TEMPORAL_PATCH_SIZE * PATCH_SIZE * PATCH_SIZE)


def bucket_images(
    sizes: Sequence[Tuple[int, int]],
    allowed_grids: Sequence[Tuple[int, int]],
) -> List[int]:
    """Assign each (h_units, w_units) to the index of the smallest allowed
    grid that contains it (for batch grouping). -1 if none fits."""
    out = []
    for h, w in sizes:
        best, best_area = -1, None
        for i, (gh, gw) in enumerate(allowed_grids):
            if gh >= h and gw >= w:
                area = gh * gw
                if best_area is None or area < best_area:
                    best, best_area = i, area
        out.append(best)
    return out
