"""Photoshop files in numpy: what Pillow's `PsdImagePlugin` holds after
`Image.open(...).load()`: the merged composite at the end of the file
(Pillow sets `frame = 1` when layers exist, but the tile it loads is the
composite's).

The header, colour mode data, image resources and layer section are
walked as the plugin walks them (reads past the end are short, seeks are
not). Modes by (colour mode, depth), as `MODES` lists them: bitmap "1",
gray / duotone / multichannel "L", indexed "P" (its 768-byte planar
colour table), RGB "RGB" (4 channels "RGBA"), CMYK "CMYK" (stored
inverted). Each channel is a raw plane or PackBits rows (`PackBitsDecode.c`: a
packet fills what is left of its row and drops the rest), the byte
counts of the first `channels` channels only being read, as the plugin
reads them. Pillow gives any other compression (ZIP) no tile and cannot
load it; nor can the port. Lab files
are refused: Pillow turns Lab into RGB through LittleCMS's 8-bit
transform (ROADMAP Queue 1 item 3b-ii).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from morphik_core_tpu_torch.utils.jpeg import NotThisFormat, UnsupportedImage

_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1), (3, 8): ("RGB", 3),
          (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


class _File:
    """A BytesIO's read / seek / tell over bytes."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + max(n, 0)]
        self.pos += len(b)
        return b

    def u16(self) -> int:
        return struct.unpack(">H", self.read(2))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.read(4))[0]


def _header(data: bytes):
    f = _File(data)
    s = f.read(26)
    if not s.startswith(b"8BPS") or struct.unpack(">H", s[4:6])[0] != 1:
        raise NotThisFormat("not a PSD file")
    channels_in, bits, psd_mode = (struct.unpack(">H", s[i:i + 2])[0] for i in (12, 22, 24))
    mode, channels = _MODES[(psd_mode, bits)]
    if channels > channels_in:
        raise ValueError("not enough channels")
    if mode == "RGB" and channels_in == 4:
        mode, channels = "RGBA", 4
    w, h = struct.unpack(">I", s[18:22])[0], struct.unpack(">I", s[14:18])[0]
    palette = None
    size = f.u32()
    if size:
        table = f.read(size)
        if mode == "P" and size == 768:
            palette = np.frombuffer(table, np.uint8).reshape(3, 256).T.copy()
    size = f.u32()
    if size:
        end = f.pos + size
        while f.pos < end:
            f.read(4)
            f.u16()
            name = f.read(f.read(1)[0])
            if not len(name) & 1:
                f.read(1)
            body = f.read(f.u32())
            if len(body) & 1:
                f.read(1)
    size = f.u32()
    if size:
        end = f.pos + size
        f.u32()
        f.pos = end
    compression = f.u16()
    offsets: List[int] = []
    if compression == 0:
        offsets = [f.pos + k * w * h for k in range(channels)]
    elif compression == 1:
        counts = f.read(channels * h * 2)
        at = f.pos
        for c in range(channels):
            offsets.append(at)
            at += sum(struct.unpack(f">{h}H", counts[2 * h * c:2 * h * (c + 1)])) if h else 0
    if w <= 0 or h <= 0:
        raise NotThisFormat("an image of no pixels")
    if mode == "LAB":
        raise UnsupportedImage("PSD in Lab colour (Pillow converts it through LittleCMS)")
    if mode == "P" and palette is None:
        raise UnsupportedImage("indexed PSD without a 768-byte colour table")
    return mode, (w, h), compression, offsets, palette


def probe_psd(data: bytes) -> Tuple[int, int]:
    return _header(data)[1]


def packbits(data: bytes, pos: int, row: int, rows: int) -> np.ndarray:
    """`PackBitsDecode.c` from `pos` until `rows` rows of `row` bytes are
    out: a run or literal fills what is left of its row and the rest of it
    is dropped (0x80 is a no-op)."""
    out = bytearray()
    n = len(data)
    need = row * rows
    while len(out) < need:
        if pos >= n:
            raise ValueError("PSD PackBits data ends early: image file is truncated")
        c = data[pos]
        room = row - len(out) % row
        if c & 0x80:
            if c == 0x80:
                pos += 1
                continue
            if pos + 2 > n:
                raise ValueError("PSD PackBits data ends early: image file is truncated")
            out += data[pos + 1:pos + 2] * min(257 - c, room)
            pos += 2
        else:
            if pos + c + 2 > n:
                raise ValueError("PSD PackBits data ends early: image file is truncated")
            out += data[pos + 1:pos + 2 + min(c, room - 1)]
            pos += c + 2
    return np.frombuffer(bytes(out), np.uint8)


def read_psd(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """PSD bytes -> (pixels, mode, palette): "1" (0 / 255), "L", "P" (H, W),
    "RGB" / "RGBA" / "CMYK" (H, W, C) uint8; `palette` (256, 3) for "P"."""
    mode, (w, h), compression, offsets, palette = _header(data)
    row = (w + 7) // 8 if mode == "1" else w
    planes = []
    for at in offsets:
        if compression == 0:
            plane = np.frombuffer(data[at:at + row * h], np.uint8)
            if len(plane) < row * h:
                raise ValueError("PSD image data ends early: image file is truncated")
        else:
            plane = packbits(data, at, row, h)
        plane = plane.reshape(h, row)
        if mode == "1":
            plane = (np.unpackbits(plane, axis=1)[:, :w] * 255).astype(np.uint8)
        planes.append(255 - plane if mode == "CMYK" else plane)
    if not planes:
        raise ValueError(f"cannot load this image (PSD compression {compression}: Pillow gives it no tile)")
    px = np.stack(planes, axis=-1)
    px = np.ascontiguousarray(px[..., 0] if px.shape[-1] == 1 else px)
    return px, mode, palette
