"""WebP in numpy and the stdlib: what Pillow's `WebPImagePlugin` holds
after `Image.open(...).load()`, which decodes through libwebp's
`WebPAnimDecoder` (libwebp 1.6, `src/demux/anim_decode.c`).

The RIFF container: a simple `VP8 ` (lossy, `utils/vp8.py`) or `VP8L`
(lossless, `utils/vp8l.py`) file, or `VP8X` with its canvas size and
flags, an `ALPH` chunk beside a lossy frame, and `ANIM` / `ANMF` frames.
An `ALPH` chunk holds the alpha plane raw or as a VP8L stream (its green
channel), then filtered horizontally, vertically or by gradient
(`src/dsp/filters.c` unfilters; the level-reduction hint only matters
with alpha dithering, which Pillow leaves off). The first frame of an
animation is composed as the animation decoder composes a key frame: a
canvas of transparent black, the frame's pixels written into its
rectangle, no blending. Every other frame is ignored: the reference
ingests an animation as its first frame.

The mode is "RGBA" when libwebp's `WebPGetFeatures` says the file has
alpha, else "RGB": for a still image the VP8X alpha flag, replaced by a
VP8L header's alpha hint, and set by an ALPH chunk; for an animation the
VP8X flag. The demuxer drops the ALPH chunk of a still image whose VP8X
flag is unset (its alpha reads 255). The RGBA is not premultiplied
(Pillow asks for `MODE_RGBA`).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from morphik_core_tpu_torch.utils.vp8 import decode_vp8, vp8_header
from morphik_core_tpu_torch.utils.vp8l import decode_vp8l, decode_vp8l_stream, vp8l_header


def _chunks(data: bytes, pos: int, end: int) -> List[Tuple[bytes, int, int]]:
    """(fourcc, payload start, payload size) of each chunk in [pos, end)."""
    out = []
    while pos + 8 <= end:
        fourcc = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        if pos + 8 + size > len(data):
            raise ValueError(f"truncated WebP chunk {fourcc!r}")
        out.append((fourcc, pos + 8, size))
        pos += 8 + size + (size & 1)
    return out


class _Info:
    __slots__ = ("width", "height", "alpha", "frame", "rect", "use_alph")


def _frame_image(data: bytes, chunks) -> Tuple[Optional[Tuple[int, int]], Dict[bytes, Tuple[int, int]]]:
    """The image chunks of a still image or of one ANMF frame."""
    found = {}
    for fourcc, at, size in chunks:
        if fourcc in (b"ALPH", b"VP8 ", b"VP8L") and fourcc not in found:
            found[fourcc] = (at, size)
        if fourcc in (b"VP8 ", b"VP8L"):
            break
    if b"VP8 " in found:
        at, size = found[b"VP8 "]
        return vp8_header(data[at:at + size]), found
    if b"VP8L" in found:
        at, size = found[b"VP8L"]
        w, h, _ = vp8l_header(data[at:at + size])
        return (w, h), found
    raise ValueError("WebP file has no image data")


def _info(data: bytes) -> _Info:
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file")
    (riff,) = struct.unpack("<I", data[4:8])
    end = min(len(data), 8 + riff)
    chunks = _chunks(data, 12, end)
    if not chunks:
        raise ValueError("WebP file has no chunks")
    info = _Info()
    first = chunks[0][0]
    if first == b"VP8X":
        at = chunks[0][1]
        flags = data[at]
        info.width = int.from_bytes(data[at + 4:at + 7], "little") + 1
        info.height = int.from_bytes(data[at + 7:at + 10], "little") + 1
        info.alpha = bool(flags & 0x10)
        if flags & 0x02:
            anmf = [c for c in chunks if c[0] == b"ANMF"]
            if not anmf:
                raise ValueError("animated WebP has no frames")
            _, at, size = anmf[0]
            x, y = 2 * int.from_bytes(data[at:at + 3], "little"), 2 * int.from_bytes(data[at + 3:at + 6], "little")
            fw = int.from_bytes(data[at + 6:at + 9], "little") + 1
            fh = int.from_bytes(data[at + 9:at + 12], "little") + 1
            sub = _chunks(data, at + 16, at + size)
            dims, found = _frame_image(data, sub)
            if dims != (fw, fh) or x + fw > info.width or y + fh > info.height:
                raise ValueError("WebP frame does not fit its rectangle or canvas")
            info.frame, info.rect, info.use_alph = found, (x, y, fw, fh), True
            return info
        dims, found = _frame_image(data, chunks[1:])
        if dims != (info.width, info.height):
            raise ValueError("WebP image size differs from its canvas")
        # `WebPGetFeatures`: a VP8L header's alpha bit replaces the flag, and
        # an ALPH chunk sets it; the demuxer drops the ALPH chunk of a
        # still image whose flag is unset
        if b"VP8L" in found:
            info.alpha = vp8l_header(data[found[b"VP8L"][0]:found[b"VP8L"][0] + 5])[2]
        info.use_alph = info.alpha
        info.alpha = info.alpha or b"ALPH" in found
        info.frame, info.rect = found, (0, 0) + dims
        return info
    dims, found = _frame_image(data, chunks)
    info.width, info.height = dims
    info.alpha = b"VP8L" in found and vp8l_header(data[found[b"VP8L"][0]:found[b"VP8L"][0] + 5])[2]
    info.frame, info.rect, info.use_alph = found, (0, 0) + dims, False
    return info


def probe_webp(data: bytes) -> Tuple[int, int]:
    info = _info(data)
    return info.width, info.height


def _unfilter(a: np.ndarray, method: int) -> np.ndarray:
    """`filters.c` `HorizontalUnfilter_C` / `VerticalUnfilter_C` /
    `GradientUnfilter_C` over the whole plane."""
    if method == 0:
        return a
    h, w = a.shape
    out = np.empty_like(a)
    out[0] = np.cumsum(a[0].astype(np.int64)) & 0xFF
    if method == 1:
        # each later row starts from the pixel above its first one (the first
        # column accumulates downwards), then runs left to right
        col = np.cumsum(a[:, 0].astype(np.int64)) & 0xFF
        out[1:] = (np.cumsum(a[1:].astype(np.int64), 1) + col[:-1, None]) & 0xFF
        return out
    if method == 2:
        return (np.cumsum(np.concatenate([out[:1].astype(np.int64), a[1:].astype(np.int64)], 0), 0)
                & 0xFF).astype(np.uint8)
    rows = [out[0].tolist()]
    data = a.tolist()
    for y in range(1, h):
        prev, cur = rows[-1], data[y]
        left = top_left = prev[0]
        row = []
        for x in range(w):
            top = prev[x]
            g = left + top - top_left
            left = (cur[x] + (g if 0 <= g <= 255 else 0 if g < 0 else 255)) & 0xFF
            top_left = top
            row.append(left)
        rows.append(row)
    return np.array(rows, np.uint8)


def _alpha(payload: bytes, w: int, h: int) -> np.ndarray:
    """An ALPH chunk's payload -> (h, w) uint8 alpha."""
    if not payload:
        raise ValueError("empty WebP ALPH chunk")
    head = payload[0]
    method, filt = head & 3, (head >> 2) & 3
    if method == 0:
        raw = payload[1:1 + w * h]
        if len(raw) < w * h:
            raise ValueError("truncated WebP alpha plane")
        a = np.frombuffer(raw, np.uint8).reshape(h, w)
    elif method == 1:
        a = decode_vp8l_stream(payload[1:], w, h)[..., 1]
    else:
        raise ValueError(f"unknown WebP alpha compression {method}")
    return _unfilter(a, filt)


def read_webp(data: bytes) -> Tuple[np.ndarray, str, None]:
    """WebP bytes -> (pixels, mode, None): "RGB" (H, W, 3) or "RGBA"
    (H, W, 4) uint8, the first frame of an animation."""
    info = _info(data)
    x, y, fw, fh = info.rect
    found = info.frame
    if b"VP8L" in found:
        at, size = found[b"VP8L"]
        rgba = decode_vp8l(data[at:at + size])
    else:
        at, size = found[b"VP8 "]
        rgb = decode_vp8(data[at:at + size])
        alpha = np.full((fh, fw), 255, np.uint8)
        if b"ALPH" in found and info.use_alph:
            a_at, a_size = found[b"ALPH"]
            alpha = _alpha(data[a_at:a_at + a_size], fw, fh)
        rgba = np.concatenate([rgb, alpha[..., None]], -1)
    if (x, y, fw, fh) != (0, 0, info.width, info.height):
        canvas = np.zeros((info.height, info.width, 4), np.uint8)
        canvas[y:y + fh, x:x + fw] = rgba
        rgba = canvas
    if info.alpha:
        return np.ascontiguousarray(rgba), "RGBA", None
    return np.ascontiguousarray(rgba[..., :3]), "RGB", None

