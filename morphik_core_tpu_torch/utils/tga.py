"""Targa in numpy: what Pillow's `TgaImagePlugin` (with `TgaRleDecode.c`)
holds after `Image.open(...).load()`.

TGA has no magic number, so `Image.open` reaches it only after every
plugin before it in `Image.ID` passed the bytes by (`utils/image.py::sniff`)
and takes whatever header passes its checks: a colour map type of 0 or
1, a positive size, a depth of 1, 8, 16, 24 or 32, and an image type of
1/9 (colour-mapped: "P"; with no map "L", which Pillow cannot load), 2/10 (true colour: "RGB"
at 24 bits, else "RGBA"; 16 bits read as 5-5-5 with the top bit an
inverted alpha, `BGRA;15Z`) or 3/11 (gray: "L", "1" at 1 bit, "LA" at 16
bits); a colour map of 16, 24 or 32 bits (another depth is not a TGA),
its first `start` entries black. Pillow cannot load a type / depth
pair it has no unpacker for, a 32-bit colour map, or a map on an image
not "P", "L" or "LA"; nor can the port. Rows are
bottom-up unless the descriptor's bit 5 is set; bit 4 mirrors them
left to right after loading. RLE packets: a literal may run on into the
next row, a run past a row's end is an error (`IMAGING_CODEC_OVERRUN`).
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from morphik_core_tpu_torch.utils.jpeg import NotThisFormat

_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z", (2, 24): "BGR",
             (2, 32): "BGRA"}


def _header(data: bytes):
    s = data[:18]
    id_len, cmap_type, image_type = s[0], s[1], s[2]
    depth, flags = s[16], s[17]
    w, h = struct.unpack("<HH", s[12:16])
    if cmap_type not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32):
        raise NotThisFormat("not a TGA file")
    if image_type in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif image_type in (1, 9):
        mode = "P" if cmap_type else "L"
    elif image_type in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise NotThisFormat("unknown TGA mode")
    orientation = flags & 0x30
    if orientation not in (0, 0x10, 0x20, 0x30):
        raise NotThisFormat("unknown TGA orientation")
    pos = 18 + len(data[18:18 + id_len])
    palette = None
    if cmap_type:
        start, size, mapdepth = struct.unpack("<HH", s[3:7]) + (s[7],)
        if mapdepth not in (16, 24, 32):
            raise NotThisFormat("unknown TGA map depth")
        nb = mapdepth // 8
        raw = data[pos:pos + nb * size]
        pos += len(raw)
        ents = np.frombuffer(bytes(nb * start) + raw, np.uint8)
        ents = ents[:len(ents) // nb * nb].reshape(-1, nb)
        if mapdepth == 16:
            rgb = _bgr15(ents[:, 0].astype(np.int32) | ents[:, 1].astype(np.int32) << 8)[:, :3]
        else:
            rgb = ents[:, 2::-1]
        palette = np.zeros((256, 3), np.uint8)
        palette[:min(256, len(rgb))] = rgb[:256]
    rawmode = _RAWMODES.get((image_type & 7, depth))
    return mode, (w, h), rawmode, image_type & 8, depth, orientation, pos, palette


def _bgr15(v: np.ndarray) -> np.ndarray:
    """`BGRA;15Z`: 5-bit channels scaled by 255 / 31, alpha 255 unless the
    top bit is set."""
    ch = [((v >> s) & 31) * 255 // 31 for s in (10, 5, 0)]
    return np.stack(ch + [np.where(v & 0x8000, 0, 255)], -1).astype(np.uint8)


def probe_tga(data: bytes) -> Tuple[int, int]:
    return _header(data)[1]


def _rle(data: bytes, pos: int, px_bytes: int, row: int, h: int) -> bytes:
    out = bytearray()
    need = row * h
    n = len(data)
    while len(out) < need:
        if pos >= n:
            raise ValueError("TGA RLE data ends early: image file is truncated")
        c = data[pos]
        count = px_bytes * ((c & 0x7F) + 1)
        if c & 0x80:
            if pos + 1 + px_bytes > n:
                raise ValueError("TGA RLE data ends early: image file is truncated")
            if len(out) % row + count > row:
                raise ValueError("TGA RLE run past the end of a row: buffer overrun when reading image file")
            out += data[pos + 1:pos + 1 + px_bytes] * (count // px_bytes)
            pos += 1 + px_bytes
        else:
            if pos + 1 + count > n:
                raise ValueError("TGA RLE data ends early: image file is truncated")
            out += data[pos + 1:pos + 1 + count]
            pos += 1 + count
    return bytes(out[:need])


def read_tga(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """TGA bytes -> (pixels, mode, palette): "1" (0 / 255), "L", "P" (H, W),
    "LA" / "RGB" / "RGBA" (H, W, C) uint8; `palette` (256, 3) for "P"."""
    mode, (w, h), rawmode, rle, depth, orientation, pos, palette = _header(data)
    bands = {"1": 1, "L": 1, "P": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    if mode == "L" and rawmode == "P":
        raise ValueError("unknown raw mode for given image mode (a colour-mapped TGA without a colour map)")
    if palette is not None and (data[7] == 32 or mode not in ("P", "L", "LA")):
        raise ValueError("Pillow cannot apply this TGA colour map (a 32-bit map, or a map on a true-colour image)")
    if rawmode is None:
        raise ValueError("cannot load this image (a TGA type and depth Pillow has no unpacker for)")
    row = (w + 7) // 8 if depth == 1 else w * (depth // 8)
    if rle:
        body = _rle(data, pos, (depth + 7) // 8, row, h)
    else:
        body = data[pos:pos + row * h]
        if len(body) < row * h:
            raise ValueError("TGA image data ends early: image file is truncated")
    rows = np.frombuffer(body, np.uint8).reshape(h, row)
    if rawmode == "1":
        px = (np.unpackbits(rows, axis=1)[:, :w] * 255).astype(np.uint8)
    elif rawmode in ("L", "P"):
        px = rows
    elif rawmode == "LA":
        px = rows.reshape(h, w, 2)
    elif rawmode == "BGRA;15Z":
        pair = rows.reshape(h, w, 2).astype(np.int32)
        px = _bgr15(pair[..., 0] | pair[..., 1] << 8)
    else:
        pix = rows.reshape(h, w, depth // 8)
        px = pix[..., [2, 1, 0, 3] if depth == 32 else [2, 1, 0]]
    if orientation in (0, 0x10):
        px = px[::-1]
    if orientation in (0x10, 0x30):
        px = px[:, ::-1]
    return np.ascontiguousarray(px), mode, palette if mode == "P" else None
