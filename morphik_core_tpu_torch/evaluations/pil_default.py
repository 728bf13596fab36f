"""The two Pillow drawing calls the evals need, in numpy and bit for bit
with Pillow 12.1: `ImageDraw.text` in the default font, and
`ImageFilter.GaussianBlur`. The card's machine has no PIL.

`ImageDraw.text` without a font draws with `ImageFont.load_default()`:
Aileron Regular at 10 px through FreeType, layout engine BASIC (no
shaping: no ligatures, and the font has no kerning pairs among the
atlas's characters). Its glyphs come from a committed atlas,
`glyphs_pil_default.npz`, that `write_default_font_atlas` makes with PIL
(on a machine that has PIL; nothing on the serving path runs it): each character's mask
as `getmask2` draws it alone at the origin, its offset and its advance in
1/64 px. A line is laid out as `parser/text_render.py` lays out its
font's lines (the pen in 26.6, a glyph at `(pen + 32) >> 6`, overlapping
glyphs composited as FreeType's bitmaps are), then blended black over
the page.

`gaussian_blur` is `BoxBlur.c`'s `ImagingGaussianBlur`: three extended
box passes a direction, each of radius `l + a` from
`_gaussian_blur_radius` (C float arithmetic), in 24-bit fixed point with
the two edge pixels weighted by the fraction `a`, the line's ends
extended by their edge pixels, horizontal passes first, then vertical.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

from morphik_core_tpu_torch.parser.text_render import GlyphFont, _blend_black

ATLAS_PATH = Path(__file__).with_name("glyphs_pil_default.npz")
# what the evals draw: the vocabulary's words in both cases, digits, "-" and space
CHARSET = " -0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"


@functools.lru_cache(maxsize=None)
def load_default_font() -> GlyphFont:
    with np.load(ATLAS_PATH) as z:
        tokens = [str(t) for t in z["tokens"]]
        shapes = z["shapes"]
        flat = z["masks"]
        starts = np.concatenate([[0], np.cumsum(shapes[:, 0] * shapes[:, 1])])
        masks = [flat[starts[i]:starts[i + 1]].reshape(shapes[i]).astype(np.int64) for i in range(len(tokens))]
        kern = {(int(a), int(b)): int(v) for a, b, v in z["kern"]}
        return GlyphFont(tokens, masks, z["offsets"], z["advances"], kern, [], np.zeros(0, np.int32))


def draw_text(page: np.ndarray, xy, text: str) -> None:
    """`ImageDraw.Draw(img).text(xy, text, fill="black")` on a gray (H, W)
    uint8 page, in place (an RGB page drawn black is this page in every
    channel)."""
    mask, ox, oy = load_default_font().line_mask(text)
    if mask.size:
        _blend_black(page, mask, int(xy[0]) + ox, int(xy[1]) + oy)


def write_default_font_atlas(path: Path = ATLAS_PATH, charset: str = CHARSET) -> Path:
    """Make the atlas with PIL from `ImageFont.load_default()` (the font
    `ImageDraw.text` takes without one). Needs PIL."""
    from PIL import ImageFont

    font = ImageFont.load_default()
    shapes, offsets, flat = [], [], []
    for ch in charset:
        m, off = font.getmask2(ch, "L", anchor="la")
        arr = np.array(m, dtype=np.uint8).reshape(m.size[1], m.size[0])
        shapes.append(arr.shape)
        offsets.append(off)
        flat.append(arr.reshape(-1))
    adv = [round(font.getlength(ch) * 64) for ch in charset]
    kern = [(a, b, k) for a, ca in enumerate(charset) for b, cb in enumerate(charset)
            if (k := round(font.getlength(ca + cb) * 64) - adv[a] - adv[b])]
    np.savez_compressed(path, tokens=np.array(list(charset)), shapes=np.array(shapes, np.int32).reshape(-1, 2),
                        offsets=np.array(offsets, np.int32).reshape(-1, 2), masks=np.concatenate(flat),
                        advances=np.array(adv, np.int32), kern=np.array(kern, np.int32).reshape(-1, 3))
    load_default_font.cache_clear()
    return Path(path)


# ------------------------------------------------------------------ blur


def _box_radius(radius: float, passes: int = 3) -> np.float32:
    """`_gaussian_blur_radius`: float variables, double temporaries."""
    f = np.float32
    sigma2 = f(f(radius) * f(radius) / f(passes))
    big_l = f(np.sqrt(12.0 * float(sigma2) + 1.0))
    small_l = f(np.floor((float(big_l) - 1.0) / 2.0))
    a = f(f(f(2) * small_l + f(1)) * f(small_l * f(small_l + f(1)) - f(3) * sigma2))
    a = f(a / f(f(6) * f(sigma2 - f(small_l + f(1)) * f(small_l + f(1)))))
    return f(small_l + a)


def _box_pass(lines: np.ndarray, radius: np.float32) -> np.ndarray:
    """One `ImagingHorizontalBoxBlur` pass along axis 1 of (rows, width,
    channels) uint8: each output is the fixed-point mean of the 2r + 1
    pixels around it plus the fraction's share of the two beyond them,
    indices clamped to the line. In uint32, as the C code: the sums stay
    below 255 * 2^24 + 2^23 < 2^32."""
    r = int(radius)
    ww = np.uint32(int(np.float32(1 << 24) / np.float32(radius * np.float32(2) + np.float32(1))))
    fw = np.uint32(((1 << 24) - (2 * r + 1) * int(ww)) // 2)
    w = lines.shape[1]
    padded = np.pad(lines, ((0, 0), (r + 1, r + 1), (0, 0)), mode="edge").astype(np.uint32)
    csum = np.zeros((lines.shape[0], padded.shape[1] + 1, lines.shape[2]), np.uint32)
    np.cumsum(padded, axis=1, out=csum[:, 1:])
    acc = csum[:, 2 * r + 2:2 * r + 2 + w] - csum[:, 1:1 + w]  # pixels x - r .. x + r
    far = padded[:, :w] + padded[:, 2 * r + 2:2 * r + 2 + w]  # pixels x - r - 1 and x + r + 1
    acc *= ww
    far *= fw
    acc += far
    acc += np.uint32(1 << 23)
    acc >>= np.uint32(24)
    return acc.astype(np.uint8)


def gaussian_blur(pixels: np.ndarray, radius: float) -> np.ndarray:
    """`img.filter(ImageFilter.GaussianBlur(radius))` for an "L" (H, W) or
    "RGB" (H, W, 3) uint8 image."""
    a = pixels[..., None] if pixels.ndim == 2 else pixels
    r = _box_radius(radius)
    if r != 0:
        for _ in range(3):
            a = _box_pass(a, r)
        a = np.swapaxes(a, 0, 1)
        for _ in range(3):
            a = _box_pass(a, r)
        a = np.ascontiguousarray(np.swapaxes(a, 0, 1))
    return a[..., 0] if pixels.ndim == 2 else a
