"""PNG decode and encode in numpy + zlib: the page-image codec of the
port's service plane (the card's machine has no PIL).

`decode_png` returns what Pillow's `Image.open(...).convert("RGB")`
gives for 8-bit PNGs of modes L, LA, RGB, RGBA and P: gray replicated to
three channels, alpha dropped (not composited), palette indices looked
up. Every row filter (None, Sub, Up, Average, Paeth) is undone exactly.
Other bit depths and Adam7 interlacing raise a `ValueError` that names
the feature. `encode_png` writes filter 0 rows (tests and `chip_smoke.py`
make their inputs with it).
"""

from __future__ import annotations

import struct
import zlib
from typing import List

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> samples per pixel
# Pillow's decompression-bomb limit: it refuses images of more than twice
# `Image.MAX_IMAGE_PIXELS` (1024**3 // 4 // 3) pixels
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        crc = data[pos + 8 + length : pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {ctype!r}")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"broken PNG file (CRC mismatch in {ctype!r})")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError("truncated PNG file (no IEND)")


def _unfilter_avg_paeth(kind: int, cur: bytearray, prior: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4) run left to right byte by byte."""
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    if len(raw) < height * (stride + 1):
        raise ValueError("truncated PNG image data")
    rows = np.frombuffer(raw, np.uint8, count=height * (stride + 1)).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:  # Sub: a running sum per channel, mod 256
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[y] = line + prior
        elif kind in (3, 4):
            cur = bytearray(line.tobytes())
            _unfilter_avg_paeth(kind, cur, prior.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8, as Pillow's `convert("RGB")`."""
    header = None
    palette = b""
    idat: List[bytes] = []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = body
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, color, _compression, _filter, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"unknown PNG color type {color}")
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} is not supported (only 8)")
    if interlace:
        raise ValueError("Adam7-interlaced PNG is not supported")
    if width * height > MAX_PIXELS:
        raise ValueError(f"PNG of {width} x {height} pixels exceeds the decompression-bomb limit {MAX_PIXELS}")
    ch = _CHANNELS[color]
    # decompress no more than the image needs: a small file cannot expand without bound
    raw = zlib.decompressobj().decompress(b"".join(idat), height * (width * ch + 1))
    pix = _unfilter(raw, height, width * ch, ch).reshape(height, width, ch)
    if color == 2:
        return pix
    if color == 6:
        return np.ascontiguousarray(pix[..., :3])
    if color in (0, 4):
        return np.repeat(pix[..., :1], 3, axis=2)
    if not palette:
        raise ValueError("palette PNG has no PLTE chunk")
    # unset entries keep the default palette's gray ramp (i, i, i)
    lut = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    n = min(len(palette) // 3, 256)
    lut[:n] = np.frombuffer(palette[: 3 * n], np.uint8).reshape(n, 3)
    return lut[pix[..., 0]]


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def encode_png(pixels: np.ndarray) -> bytes:
    """(H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 -> PNG bytes
    (filter 0 on every row)."""
    arr = np.ascontiguousarray(pixels, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    color = {1: 0, 3: 2, 4: 6}.get(arr.shape[2]) if arr.ndim == 3 else None
    if color is None:
        raise ValueError(f"cannot encode an array of shape {pixels.shape} as PNG")
    h, w, _ = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
