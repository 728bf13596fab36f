"""Host-side image preprocessing for the ColQwen tower: a numpy mirror of
`morphik_core_tpu/models/colqwen/preprocess.py` (bit-identical).

Images resize to multiples of 112 px (llm grid multiples of the 4-unit
attention window), so every page lands on a static grid bucket and
window attention is a pure reshape. PIL is imported only inside the
functions that take an image: the card's path ships uint8 patches and
never imports it. A page decoded to a uint8 array (the service plane's
PNG ingest) goes through `preprocess_array_u8`, whose bicubic resize,
luma and blank-page check mirror Pillow bit for bit.
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


def preprocess_array_u8(
    hwc: np.ndarray,
    min_pixels: int = 1 * WINDOW_FACTOR * WINDOW_FACTOR,
    max_pixels: int = 60 * WINDOW_FACTOR * WINDOW_FACTOR,
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """`preprocess_image_u8` on a decoded (H, W, 3) uint8 page instead of
    a PIL image: the same (patches, grid), with Pillow's bicubic resize
    mirrored by `resize_bicubic_u8`."""
    h, w = smart_resize(hwc.shape[0], hwc.shape[1], min_pixels=min_pixels, max_pixels=max_pixels)
    arr = resize_bicubic_u8(hwc, (h, w)).transpose(2, 0, 1)  # (C, H, W)
    return patchify_u8(arr), (h // (PATCH_SIZE * MERGE_SIZE), w // (PATCH_SIZE * MERGE_SIZE))


# --- Pillow's 8-bit bicubic resize and luma, in numpy ---------------------
# Mirrors src/libImaging/Resample.c: coefficients per output pixel over a
# window of support 2 * max(scale, 1), normalised, then made fixed point
# with 22 bits rounded away from zero; the horizontal pass runs before the
# vertical one, each summing from 1 << 21, shifting by 22 and clipping to
# [0, 255]; a dimension whose size is unchanged gets no pass.

_PRECISION_BITS = 22


def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    """The a = -0.5 cubic, in Resample.c's operation order."""
    x = np.abs(x)
    near = (1.5 * x - 2.5) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * -0.5
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos_filter(x: np.ndarray) -> np.ndarray:
    """Resample.c `lanczos_filter`: the support-3 truncated sinc. `math.sin`
    is the C library's `sin`, as Pillow calls it (numpy's may differ in
    the last bit, which can move a rounded tap)."""
    flat = [_sinc(v) * _sinc(v / 3) if -3.0 <= v < 3.0 else 0.0 for v in x.reshape(-1).tolist()]
    return np.array(flat, np.float64).reshape(x.shape)


_FILTERS = {"bicubic": (_bicubic_filter, 2.0), "lanczos": (_lanczos_filter, 3.0)}


def _resample_weights(in_size: int, out_size: int, kind: str = "bicubic") -> Tuple[np.ndarray, np.ndarray]:
    """Resample.c `precompute_coeffs`: per output pixel its first input
    index and ksize normalized double taps (0 past the clamped window)."""
    filt, filter_support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)  # C (int): toward zero
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = filt(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):  # sequential, as the C loop sums
        ww += w[:, j]
    return xmin, np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)


def _resample_coeffs(in_size: int, out_size: int, kind: str = "bicubic") -> Tuple[np.ndarray, np.ndarray]:
    """`_resample_weights` + Resample.c `normalize_coeffs_8bpc`: the taps
    in fixed point."""
    xmin, w = _resample_weights(in_size, out_size, kind)
    scaled = w * float(1 << _PRECISION_BITS)
    fixed = np.where(w < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled)).astype(np.int64)
    return xmin, fixed


def _resample_axis(img: np.ndarray, out_size: int, axis: int, kind: str = "bicubic") -> np.ndarray:
    in_size = img.shape[axis]
    xmin, fixed = _resample_coeffs(in_size, out_size, kind)
    src = np.ascontiguousarray(np.moveaxis(img, axis, 0))
    # int32 holds the sums: 255 * sum |tap| stays below 1.4 * 2^30 for both filters
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int32)
    bshape = (out_size,) + (1,) * (src.ndim - 1)
    taps = fixed.astype(np.int32)
    for j in range(fixed.shape[1]):
        acc += src[np.minimum(xmin + j, in_size - 1)] * taps[:, j].reshape(bshape)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def _resample_axis_16(img: np.ndarray, out_size: int, axis: int, kind: str) -> np.ndarray:
    """Resample.c `ImagingResampleHorizontal_16bpc` / `Vertical_16bpc` on
    I;16 samples: double taps, rounded half away from zero, then each byte
    of the result clipped to 0..255 on its own (the low byte is the C
    remainder of the sum by 256, the high byte the sum shifted by 8)."""
    in_size = img.shape[axis]
    xmin, w = _resample_weights(in_size, out_size, kind)
    src = np.moveaxis(img, axis, 0).astype(np.float64)
    bshape = (out_size,) + (1,) * (src.ndim - 1)
    acc = np.zeros((out_size,) + src.shape[1:])
    for j in range(w.shape[1]):  # sequential, as the C loop sums
        acc = acc + src[np.minimum(xmin + j, in_size - 1)] * w[:, j].reshape(bshape)
    ss = np.trunc(np.where(acc >= 0.0, acc + 0.5, acc - 0.5)).astype(np.int64)
    out = (np.clip(ss >> 8, 0, 255) << 8 | np.clip(np.fmod(ss, 256), 0, 255)).astype(np.uint16)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def _resample_axis_32(img: np.ndarray, out_size: int, axis: int, kind: str) -> np.ndarray:
    """Resample.c `ImagingResampleHorizontal_32bpc` / `Vertical_32bpc` on
    "I" (int32) and "F" (float32) samples: double taps summed in order over
    each output pixel's own window; "I" rounds half away from zero
    (`ROUND_UP`) into int32, "F" stores the double sum as a float."""
    in_size = img.shape[axis]
    xmin, w = _resample_weights(in_size, out_size, kind)
    src = np.moveaxis(img, axis, 0).astype(np.float64)
    bshape = (out_size,) + (1,) * (src.ndim - 1)
    acc = np.zeros((out_size,) + src.shape[1:])
    inside = np.arange(w.shape[1])[None, :] < (np.minimum(xmin + w.shape[1], in_size) - xmin)[:, None]
    for j in range(w.shape[1]):  # sequential, as the C loop sums; no term past the window
        term = src[np.minimum(xmin + j, in_size - 1)] * w[:, j].reshape(bshape)
        acc = acc + np.where(inside[:, j].reshape(bshape), term, 0.0)
    if img.dtype == np.float32:
        out = acc.astype(np.float32)
    else:
        out = np.where(acc >= 0.0, np.floor(acc + 0.5), -np.floor(np.abs(acc) + 0.5))
        out = np.clip(out, -2 ** 31, 2 ** 31 - 1).astype(np.int32)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def _resize_axes(img: np.ndarray, size: Tuple[int, int], kind: str, resample_axis=_resample_axis) -> np.ndarray:
    """Width first, then height, as Pillow's `ImagingResample`; a new array."""
    h, w = size
    out = img
    if w != out.shape[1]:
        out = resample_axis(out, w, 1, kind)
    if h != out.shape[0]:
        out = resample_axis(out, h, 0, kind)
    return out if out is not img else out.copy()


def _resize_u8(img: np.ndarray, size: Tuple[int, int], kind: str) -> np.ndarray:
    return _resize_axes(np.asarray(img, dtype=np.uint8), size, kind)


def resize_bicubic_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Pillow's `Image.resize((w, h), BICUBIC)` of an 8-bit (H, W) or
    (H, W, C) image, bit-identical; `size` is (h, w)."""
    return _resize_u8(img, size, "bicubic")


def resize_lanczos_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Pillow's `Image.resize((w, h), LANCZOS)` of an 8-bit (H, W) or
    (H, W, C) image, bit-identical; `size` is (h, w)."""
    return _resize_u8(img, size, "lanczos")


def resize_nearest_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Pillow's `Image.resize((w, h), NEAREST)` (Geometry.c
    `ImagingScaleAffine`: the source coordinate starts at scale / 2 and
    adds scale per output pixel in double precision, truncated)."""
    def taps(n_in: int, n_out: int) -> List[int]:
        scale = n_in / n_out
        pos, out = scale * 0.5, []
        for _ in range(n_out):
            out.append(int(pos))
            pos += scale
        return out

    h, w = size
    return np.ascontiguousarray(np.asarray(img)[taps(img.shape[0], h)][:, taps(img.shape[1], w)])


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a.astype(np.int64) * b + 128
    return ((t >> 8) + t) >> 8


def resize_mode_u8(pixels: np.ndarray, mode: str, size: Tuple[int, int], resample: str = "lanczos") -> np.ndarray:
    """`Image.resize((w, h), resample)` with Pillow's mode rules
    (`Image.py` `resize`): modes P (indices) and 1 resize NEAREST; RGBA and LA
    resize premultiplied (RGBa / La, `Convert.c` `rgbA2rgba`, `la2La`)
    and convert back (`rgba2rgbA`: 255 * c / alpha, clipped, where alpha
    is neither 0 nor 255); I;16 resizes in 16 bits (`_resample_axis_16`),
    and I;16B (uint16 values) as Pillow does it: on the byte-swapped values,
    swapped back;
    CMYK resizes each of its four channels, and PA its index and alpha
    bands alike, as plain 8-bit bands; "I" (int32) and "F" (float32)
    in their own precision (`_resample_axis_32`). `pixels` is (H, W) for
    L, P, I;16 (uint16), I and F, (H, W, 2) for LA and PA, (H, W, 3) RGB, (H, W, 4)
    RGBA and CMYK."""
    if mode in ("P", "1"):
        return resize_nearest_u8(pixels, size)
    if mode == "I;16":
        return _resize_axes(pixels, size, resample, _resample_axis_16)
    if mode in ("I", "F"):
        return _resize_axes(pixels, size, resample, _resample_axis_32)
    if mode == "I;16B":
        # Resample.c reads and writes an I;16B buffer in I;16's byte order
        swapped = pixels.byteswap()
        return _resize_axes(swapped, size, resample, _resample_axis_16).byteswap()
    if mode not in ("RGBA", "LA"):
        return _resize_u8(pixels, size, resample)
    alpha = pixels[..., -1:].astype(np.int64)
    pre = np.concatenate([_muldiv255(pixels[..., :-1], alpha), alpha], axis=-1).astype(np.uint8)
    out = _resize_u8(pre, size, resample)
    a = out[..., -1:].astype(np.int64)
    keep = (a == 0) | (a == 255)
    color = np.where(keep, out[..., :-1], np.minimum(255 * out[..., :-1].astype(np.int64) // np.maximum(a, 1), 255))
    return np.concatenate([color, a], axis=-1).astype(np.uint8)


def to_rgb_u8(pixels: np.ndarray, mode: str, palette: "np.ndarray | None" = None) -> np.ndarray:
    """`Image.convert("RGB")` of an image of mode 1 (0 / 255), L, LA, RGB,
    RGBA, P or PA (alpha dropped, not composited; `palette` (256, 3) for P and PA),
    I;16 or I;16B (uint16 values; `I16_RGB`: a sample above 255 clips to
    255), I (int32), F (float32) or CMYK (`Convert.c`
    `cmyk2rgb`: nk - MULDIV255(c, nk) with nk = 255 - k)."""
    if mode == "RGB":
        return pixels
    if mode in ("I;16", "I;16B"):
        return np.repeat(np.minimum(pixels, 255).astype(np.uint8)[..., None], 3, axis=2)
    if mode == "I":   # `i2rgb`: clipped to 0..255
        return np.repeat(np.clip(pixels, 0, 255).astype(np.uint8)[..., None], 3, axis=2)
    if mode == "F":   # no F -> RGB converter: F -> L (`f2l`: clipped, truncated; NaN 0), then L -> RGB
        v = np.nan_to_num(pixels.astype(np.float64), nan=0.0, posinf=255.0, neginf=0.0)
        return np.repeat(np.clip(np.trunc(v), 0, 255).astype(np.uint8)[..., None], 3, axis=2)
    if mode == "RGBA":
        return np.ascontiguousarray(pixels[..., :3])
    if mode in ("L", "LA", "1"):
        gray = pixels if mode != "LA" else pixels[..., 0]
        return np.repeat(gray[..., None], 3, axis=2)
    if mode == "P":
        return palette[pixels]
    if mode == "PA":   # the palette colour of each index, alpha dropped
        return palette[pixels[..., 0]]
    if mode == "CMYK":
        nk = 255 - pixels[..., 3:].astype(np.int64)
        return np.clip(nk - _muldiv255(pixels[..., :3], nk), 0, 255).astype(np.uint8)
    raise ValueError(f"no RGB conversion for mode {mode!r}")


def to_rgba_u8(pixels: np.ndarray, mode: str, palette: "np.ndarray | None" = None) -> np.ndarray:
    """`Image.convert("RGBA")` of an image of mode 1, L, P (a palette
    without alpha), RGB or RGBA: alpha 255 unless the image has its own."""
    if mode == "RGBA":
        return pixels.copy()
    rgb = to_rgb_u8(pixels, mode, palette)
    return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1)


def to_luma_u8(hwc: np.ndarray) -> np.ndarray:
    """Pillow's `convert("L")` of an RGB uint8 image (ITU-R 601-2, 16-bit
    fixed point)."""
    rgb = hwc.astype(np.int32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def is_blank_page(hwc: np.ndarray, dark_fraction: float = 2e-4, std_threshold: float = 1.0) -> bool:
    """`morphik_core_tpu/parser/raster_pool.py:32-41::is_blank_page` on a
    decoded (H, W, 3) uint8 page: luma, bicubic to 128 x 128, then blank
    only if it is both low-variance and has (almost) no ink."""
    arr = resize_bicubic_u8(to_luma_u8(hwc), (128, 128)).astype(np.float32)
    ink = float((arr < 200).mean())
    return ink < dark_fraction and float(arr.std()) < std_threshold


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
