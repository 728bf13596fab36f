"""GIF in numpy and the stdlib: the first frame as Pillow's
`GifImagePlugin` holds it under its default `LOADING_STRATEGY`
(`RGB_AFTER_FIRST`), which keeps frame 0 as a palette image.

The logical screen sets the canvas, which a first frame reaching past it
enlarges (`GifImagePlugin.py` `_seek`: `x1 > size[0]`). The canvas is
filled with the frame's transparency index, or 0 without one
(`load_prepare`), and the frame's pixels (LZW, `utils/lzw.py`, GIF
setting) are written into its rectangle, interlaced rows put back in
their four passes. The mode is "P" with the local colour table, else the
global one; "L" when there is neither or when the table in use is the
identity (`_is_palette_needed`: entry i is (i, i, i) for every i), the
indices then being the gray levels. Later frames are not read: the
reference ingests a GIF as its first frame.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from morphik_core_tpu_torch.utils.lzw import decode_gif_lzw


def _sub_blocks(data: bytes, pos: int) -> Tuple[bytes, int]:
    parts = []
    while True:
        if pos >= len(data):
            return b"".join(parts), pos
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(parts), pos
        parts.append(data[pos:pos + n])
        pos += n


def _palette_needed(p: bytes) -> bool:
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2]) for i in range(0, len(p) - 2, 3))


class _Frame:
    __slots__ = ("screen", "rect", "interlace", "palette", "transparency", "min_size", "at")


def _first_frame(data: bytes) -> _Frame:
    """Headers up to the first image descriptor; `at` is where its LZW
    sub-blocks start."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError("not a GIF file")
    width, height, flags = struct.unpack("<HHB", data[6:11])
    pos = 13
    global_palette = None
    if flags & 128:
        p = data[pos:pos + (3 << ((flags & 7) + 1))]
        pos += len(p)
        if _palette_needed(p):
            global_palette = p
    f = _Frame()
    f.transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("image not found in GIF frame")
        kind = data[pos]
        pos += 1
        if kind == 0x21:
            label = data[pos]
            pos += 1
            first = data[pos + 1:pos + 1 + data[pos]] if pos < len(data) and data[pos] else None
            if label == 0xF9 and first is not None and first[0] & 1 and len(first) > 3:
                f.transparency = first[3]
            _, pos = _sub_blocks(data, pos)
        elif kind == 0x2C:
            if pos + 9 > len(data):
                raise ValueError("truncated GIF image descriptor")
            x0, y0, w, h, lflags = struct.unpack("<HHHHB", data[pos:pos + 9])
            pos += 9
            palette = global_palette
            if lflags & 128:
                p = data[pos:pos + (3 << ((lflags & 7) + 1))]
                pos += len(p)
                palette = p if _palette_needed(p) else None
            f.screen = (max(width, x0 + w), max(height, y0 + h))
            f.rect = (x0, y0, w, h)
            f.interlace = bool(lflags & 64)
            f.palette = palette
            f.min_size = data[pos] if pos < len(data) else 0
            f.at = pos + 1
            return f
        # any other byte between blocks is skipped, as Pillow reads past it


def probe_gif(data: bytes) -> Tuple[int, int]:
    """(width, height) of the canvas Pillow gives frame 0."""
    return _first_frame(data).screen


def _interlaced_rows(h: int) -> np.ndarray:
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4), np.arange(1, h, 2)])


def read_gif(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """GIF bytes -> (pixels (H, W) uint8, mode "P" or "L", palette) of the
    first frame; `palette` is the (256, 3) lookup of a P image (entries
    past the colour table black), else None."""
    f = _first_frame(data)
    sw, sh = f.screen
    x0, y0, w, h = f.rect
    canvas = np.full((sh, sw), f.transparency or 0, np.uint8)
    if w and h:
        lzw, _ = _sub_blocks(data, f.at)
        idx = np.frombuffer(decode_gif_lzw(lzw, f.min_size, w * h), np.uint8)
        full = np.full(w * h, f.transparency or 0, np.uint8)
        full[:idx.size] = idx[:w * h]
        rows = full.reshape(h, w)
        if f.interlace:
            ordered = np.empty_like(rows)
            ordered[_interlaced_rows(h)] = rows
            rows = ordered
        canvas[y0:y0 + h, x0:x0 + w] = rows
    if f.palette is None:
        return canvas, "L", None
    lut = np.zeros((256, 3), np.uint8)
    n = min(len(f.palette) // 3, 256)
    lut[:n] = np.frombuffer(f.palette[:3 * n], np.uint8).reshape(n, 3)
    return canvas, "P", lut
