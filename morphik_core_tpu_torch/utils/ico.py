"""Windows icons and cursors in numpy: what Pillow's `IcoImagePlugin` and
`CurImagePlugin` hold after `Image.open(...).load()`.

ICO: the directory's entries sorted by colour depth, then (stably) by
width x height, largest first; the first is loaded. A PNG entry goes
through `utils/png.py` as it is; a DIB entry through `utils/bmp.py`, its
first half of rows being the image, then converted to "RGBA" with the
alpha of a 32-bit entry (the fourth byte of each stored pixel) or else of
the AND mask that ends the entry (1 bits transparent, rows bottom-up,
padded to 32 bits).

CUR: the first entry, replaced by each later one larger in both width
and height (a 0 byte is 0 here, not 256); its DIB's first half of rows,
no mask; a 32-bit DIB at offset 22 reads as "RGBA" (`_bitmap`'s
`header == 22`).
"""

from __future__ import annotations

import math
import struct
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from morphik_core_tpu_torch.models.colqwen.preprocess import to_rgba_u8
from morphik_core_tpu_torch.utils.bmp import dib_header, dib_pixels
from morphik_core_tpu_torch.utils.jpeg import NotThisFormat
from morphik_core_tpu_torch.utils.png import MAX_PIXELS, SIGNATURE, read_png

ICO_MAGIC = b"\0\0\1\0"
CUR_MAGIC = b"\0\0\2\0"


class _Entry(NamedTuple):
    width: int
    height: int
    bpp: int
    size: int
    offset: int
    depth: int


def _entries(data: bytes) -> List[_Entry]:
    """`IcoFile.__init__`'s entries in its order; a short entry raises
    IndexError / struct.error, which move `Image.open` on."""
    if data[:4] != ICO_MAGIC:
        raise NotThisFormat("not an ICO file")
    n = struct.unpack("<H", data[4:6])[0]
    out = []
    for i in range(n):
        s = data[6 + 16 * i:22 + 16 * i]
        width, height, nb_color = s[0] or 256, s[1] or 256, s[2]
        bpp = struct.unpack("<H", s[6:8])[0]
        size, offset = struct.unpack("<II", s[8:16])
        depth = bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) or 256
        out.append(_Entry(width, height, bpp, size, offset, depth))
    out.sort(key=lambda e: e.depth)
    out.sort(key=lambda e: e.width * e.height, reverse=True)
    if not out:
        raise IndexError("no icon entries")
    return out


def _bomb(w: int, h: int) -> None:
    if w * h > MAX_PIXELS:
        raise ValueError(f"Image size ({w * h} pixels) exceeds limit of {MAX_PIXELS} pixels, "
                         "could be decompression bomb DOS attack.")


def probe_ico(data: bytes) -> Tuple[int, int]:
    """The size of the entry Pillow loads (its DIB's or PNG's own)."""
    e = _entries(data)[0]
    if data[e.offset:e.offset + 8] == SIGNATURE:
        w, h = struct.unpack(">II", data[e.offset + 16:e.offset + 24])
        return w, h
    hd = dib_header(data, e.offset)
    return hd.width, int(hd.height / 2)


def read_ico(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    e = _entries(data)[0]
    if data[e.offset:e.offset + 8] == SIGNATURE:
        return read_png(data[e.offset:])
    hd = dib_header(data, e.offset)
    _bomb(hd.width, hd.height)
    w, h = hd.width, int(hd.height / 2)
    px = dib_pixels(data, hd, h)
    if e.bpp == 32:
        raw = data[hd.offset:hd.offset + 4 * w * h]
        if len(raw) < 4 * w * h:
            raise ValueError("icon alpha ends early: not enough image data")
        alpha = np.frombuffer(raw, np.uint8)[3::4].reshape(h, w)[::-1]
    else:
        wp = w + (32 - w % 32) % 32
        total = int(wp * h / 8)
        at = e.offset + e.size - total
        raw = data[at:at + total] if at >= 0 else b""   # a seek before the file's start fails in Pillow
        if len(raw) < total:
            raise ValueError("icon AND mask ends early: not enough image data")
        bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(h, wp // 8), axis=1)[:, :w]
        alpha = ((1 - bits) * 255).astype(np.uint8)[::-1]
    rgba = to_rgba_u8(px, hd.mode, hd.palette)
    rgba[..., 3] = alpha
    return rgba, "RGBA", None


def _cursor(data: bytes):
    if data[:4] != CUR_MAGIC:
        raise NotThisFormat("not a CUR file")
    n = struct.unpack("<H", data[4:6])[0]
    m = b""
    for i in range(n):
        s = data[6 + 16 * i:22 + 16 * i]
        if not m:
            m = s
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m:
        raise NotThisFormat("No cursors were found")
    at = struct.unpack("<I", m[12:16])[0]
    hd = dib_header(data, at, cur22=True)
    if hd.width <= 0 or hd.height // 2 <= 0:
        raise NotThisFormat("an image of no pixels")
    return hd


def probe_cur(data: bytes) -> Tuple[int, int]:
    hd = _cursor(data)
    return hd.width, hd.height // 2


def read_cur(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    hd = _cursor(data)
    return dib_pixels(data, hd, hd.height // 2), hd.mode, hd.palette
