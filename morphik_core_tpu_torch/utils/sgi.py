"""SGI images in numpy: what Pillow's `SgiImagePlugin` (with `SgiRleDecode.c`
and its `SGI16` decoder) holds after `Image.open(...).load()`.

A 512-byte header (magic 474), 1 or 2 bytes a sample, 1-4 channels by
(bytes, dimension, channels) as `MODES` lists them: "L", "RGB", "RGBA";
16-bit samples keep their high byte (`L;16B`). Rows are bottom-up, each
channel a plane. Verbatim files are planes one after another; RLE files
start with a table of row offsets and lengths (row-major within each
channel) and each row is packets (`expandrow` / `expandrow2`): a count
with the top bit set copies that many samples, without it repeats the
next one, a count of 0 ends the row; a packet past the row's width is
an error, and a row whose last byte is not that 0 stops the decode there
(the rows after it stay black). Pillow gives another compression byte no
tile and cannot load it; nor can the port.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from morphik_core_tpu_torch.utils.jpeg import NotThisFormat

_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B", (2, 2, 1): "L;16B", (1, 3, 3): "RGB",
          (2, 3, 3): "RGB;16B", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and struct.unpack(">H", prefix[:2])[0] == 474


def _header(data: bytes):
    s = data[:512]
    if not accept(s):
        raise NotThisFormat("Not an SGI image file")
    compression, bpc = s[2], s[3]
    dimension, w, h, z = struct.unpack(">4H", s[4:12])
    if (bpc, dimension, z) not in _MODES:
        raise ValueError("Unsupported SGI image mode")
    mode = _MODES[(bpc, dimension, z)].split(";")[0]
    if w <= 0 or h <= 0:
        raise NotThisFormat("an image of no pixels")
    return mode, (w, h), compression, bpc


def probe_sgi(data: bytes) -> Tuple[int, int]:
    return _header(data)[1]


def _expand(data: bytes, src: int, n: int, w: int, bpc: int, out: np.ndarray) -> int:
    """`expandrow` / `expandrow2`: one RLE row into `out` (w samples, the
    decoder's row buffer, kept from the row before where this one writes
    nothing) -> 0 (done), 1 (the decode stops: a row not ended by a 0
    count) or -1 (an overrun)."""
    last = len(data) - 1   # `end_of_buffer`
    x = 0
    while n > 0:
        if src + bpc - 1 > last:
            return -1
        pixel = data[src + bpc - 1]
        src += bpc
        if n == 1 and pixel != 0:
            return 1
        count = pixel & 0x7F
        if not count:
            return 0
        if x + count > w:
            return -1
        if pixel & 0x80:
            if src + bpc * count > last:
                return -1
            out[x:x + count] = np.frombuffer(data[src:src + bpc * count], np.uint8 if bpc == 1 else ">u2")
            src += bpc * count
        else:
            if (src if bpc == 1 else src + 2) > last:
                return -1
            out[x:x + count] = data[src] if bpc == 1 else data[src] << 8 | data[src + 1]
            src += bpc
        x += count
        n -= 1
    return 0


def read_sgi(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """SGI bytes -> (pixels, mode, None): "L" (H, W), "RGB" / "RGBA" (H, W, C)
    uint8 (the high byte of 16-bit samples)."""
    mode, (w, h), compression, bpc = _header(data)
    z = len(mode)
    if compression == 0:
        n = w * h * z
        body = np.frombuffer(data[512:512 + n * bpc], np.uint8 if bpc == 1 else ">u2")
        if len(body) < n:
            raise ValueError("SGI image data ends early: not enough image data")
        planes = body.reshape(z, h, w)
    elif compression == 1:
        tab = 8 * h * z
        if len(data) - 512 < tab:
            raise ValueError("SGI RLE offset tables end early: buffer overrun")
        starts = struct.unpack(f">{h * z}I", data[512:512 + 4 * h * z])
        lengths = struct.unpack(f">{h * z}I", data[512 + 4 * h * z:512 + tab])
        planes = np.zeros((z, h, w), np.uint16)
        buf = np.zeros((z, w), np.uint16)
        for y in range(h):
            status = 0
            for c in range(z):
                k = y + c * h
                if starts[k] < 512 or lengths[k] > len(data) - starts[k]:
                    raise ValueError("SGI RLE row outside the file: buffer overrun")
                status = _expand(data, starts[k], lengths[k], w, bpc, buf[c])
                if status == -1:
                    raise ValueError("SGI RLE row past its end: buffer overrun")
                if status == 1:
                    break
            if status == 1:
                break
            planes[:, y] = buf
    else:
        raise ValueError(f"cannot load this image (SGI compression {compression}: Pillow gives it no tile)")
    if bpc == 2:
        planes = planes >> 8
    px = planes.astype(np.uint8)[:, ::-1]
    px = px[0] if z == 1 else px.transpose(1, 2, 0)
    return np.ascontiguousarray(px), mode, None
