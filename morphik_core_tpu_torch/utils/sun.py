"""Sun raster files in numpy: what Pillow's `SunImagePlugin` (with
`SunRleDecode.c`) holds after `Image.open(...).load()`.

Depths: 1 ("1", set bits black), 4 ("L", 4-bit gray scaled by 17), 8
("L"), 24 ("RGB"; BGR order unless the type is 3) and 32 ("RGB" from
BGRX / RGBX). A colour map (type 1, at most 1024 bytes, stored as three
planes) turns a 4- or 8-bit image into "P"; another map type, or a
longer map, is not a Sun file to Pillow. Raw rows are padded to 16 bits.
Type 2 is RLE: 0x80 0x00 is a literal 0x80, 0x80 n v is n + 1 copies of
v, any other byte is itself; the decoded bytes run on across rows, whose
length is the unpadded one (`state->bytes`), as the C decoder has it.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from morphik_core_tpu_torch.utils.jpeg import NotThisFormat

MAGIC = 0x59A66A95


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 4 and struct.unpack(">I", prefix[:4])[0] == MAGIC


def _header(data: bytes):
    s = data[:32]
    if not accept(s):
        raise NotThisFormat("not an SUN raster file")
    w, h, depth, _length, ftype, ptype, plen = struct.unpack(">7I", s[4:32])
    if depth == 1:
        mode, rawmode = "1", "1;I"
    elif depth == 4:
        mode, rawmode = "L", "L;4"
    elif depth == 8:
        mode = rawmode = "L"
    elif depth == 24:
        mode, rawmode = "RGB", "RGB" if ftype == 3 else "BGR"
    elif depth == 32:
        mode, rawmode = "RGB", "RGBX" if ftype == 3 else "BGRX"
    else:
        raise NotThisFormat("Unsupported Mode/Bit Depth")
    offset, palette = 32, None
    if plen:
        if plen > 1024:
            raise NotThisFormat("Unsupported Color Palette Length")
        if ptype != 1:
            raise NotThisFormat("Unsupported Palette Type")
        offset += plen
        table = np.frombuffer(data[32:32 + plen], np.uint8)
        n = len(table) // 3
        palette = np.zeros((256, 3), np.uint8)
        palette[:min(n, 256)] = table[:3 * n].reshape(3, n).T[:256]
        if mode == "L":
            mode, rawmode = "P", rawmode.replace("L", "P")
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise NotThisFormat("Unsupported Sun Raster file type")
    if w <= 0 or h <= 0:
        raise NotThisFormat("an image of no pixels")
    return mode, rawmode, (w, h), depth, ftype, offset, palette if mode == "P" else None


def probe_sun(data: bytes) -> Tuple[int, int]:
    return _header(data)[2]


def _rle(data: bytes, pos: int, need: int) -> bytes:
    out = []
    have = 0
    n = len(data)
    while have < need:
        j = data.find(b"\x80", pos)
        lit = data[pos:j if j >= 0 else n]
        out.append(lit)
        have += len(lit)
        if j < 0 or have >= need:
            break
        if j + 1 >= n:
            break
        count = data[j + 1]
        if count == 0:
            out.append(b"\x80")
            have += 1
            pos = j + 2
        else:
            if j + 2 >= n:
                break
            out.append(data[j + 2:j + 3] * (count + 1))
            have += count + 1
            pos = j + 3
    body = b"".join(out)
    if len(body) < need:
        raise ValueError("Sun RLE data ends early: image file is truncated")
    return body[:need]


def read_sun(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """Sun raster bytes -> (pixels, mode, palette): "1" (0 / 255), "L", "P"
    (H, W), "RGB" (H, W, 3) uint8; `palette` (256, 3) for "P"."""
    mode, rawmode, (w, h), depth, ftype, offset, palette = _header(data)
    row = (w * depth + 7) // 8
    if ftype == 2:
        rows = np.frombuffer(_rle(data, offset, row * h), np.uint8).reshape(h, row)
    else:
        stride = ((w * depth + 15) // 16) * 2
        body = data[offset:offset + stride * h]
        if len(body) < stride * h:
            raise ValueError("Sun raster data ends early: image file is truncated")
        rows = np.frombuffer(body, np.uint8).reshape(h, stride)[:, :row]
    if depth == 1:
        px = ((1 - np.unpackbits(rows, axis=1)[:, :w]) * 255).astype(np.uint8)
    elif depth == 4:
        nib = np.stack([rows >> 4, rows & 15], -1).reshape(h, -1)[:, :w]
        px = nib if mode == "P" else (nib * 17).astype(np.uint8)
    elif depth == 8:
        px = rows
    else:
        pix = rows.reshape(h, w, depth // 8)
        px = pix[..., :3] if rawmode.startswith("RGB") else pix[..., 2::-1]
    return np.ascontiguousarray(px), mode, palette
