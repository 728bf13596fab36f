"""PNG decode and encode in numpy + zlib: the page-image codec of the
port's service plane (the card's machine has no PIL).

`read_png` returns the pixels in the mode Pillow's `Image.open` gives
them (L, LA, RGB, RGBA, or P with its palette for 8-bit PNGs; 1, L or P
for 1/2/4-bit gray and palette PNGs), so a page can be resized and
converted under Pillow's mode rules; `decode_png` returns what
`Image.open(...).convert("RGB")` gives: gray replicated to three
channels, alpha dropped (not composited), palette indices looked up
(indices past the palette read as black). Every row filter (None, Sub,
Up, Average, Paeth) is undone exactly.
16-bit samples and Adam7 interlacing raise a `ValueError` that names
the feature. `encode_png` writes filter 0 rows (tests and `chip_smoke.py`
make their inputs with it).
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

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


_MODES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}


def read_png(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """PNG bytes -> (pixels, mode, palette) as Pillow's `Image.open` holds
    them: mode L or P (H, W), LA (H, W, 2), RGB (H, W, 3), RGBA (H, W, 4);
    `palette` is the (256, 3) lookup of a P image, else None."""
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
    if depth != 8 and not (depth in (1, 2, 4) and color in (0, 3)):
        raise ValueError(f"PNG bit depth {depth} is not supported (8, or 1/2/4 for gray and palette images)")
    if interlace:
        raise ValueError("Adam7-interlaced PNG is not supported")
    if width * height > MAX_PIXELS:
        raise ValueError(f"PNG of {width} x {height} pixels exceeds the decompression-bomb limit {MAX_PIXELS}")
    ch = _CHANNELS[color]
    stride = (width * ch * depth + 7) // 8
    # decompress no more than the image needs: a small file cannot expand without bound
    raw = zlib.decompressobj().decompress(b"".join(idat), height * (stride + 1))
    rows = _unfilter(raw, height, stride, max(1, ch * depth // 8))
    mode = _MODES[color]
    if depth < 8:
        # packed samples, most significant bits first; gray scales up as
        # Pillow's "L;2" / "L;4" unpackers do, and 1-bit gray is mode "1"
        bits = np.unpackbits(rows, axis=1)[:, : width * depth].reshape(height, width, depth)
        pix = (bits.astype(np.int64) << np.arange(depth - 1, -1, -1)).sum(axis=-1)
        if color == 0:
            pix = pix * (255 // ((1 << depth) - 1))
            mode = "1" if depth == 1 else "L"
        pix = pix.astype(np.uint8)
    else:
        pix = rows.reshape(height, width, ch)
        if ch == 1:
            pix = pix[..., 0]
    lut = None
    if color == 3:
        if not palette:
            raise ValueError("palette PNG has no PLTE chunk")
        # indices past the PLTE entries read as black, as Pillow gives them
        lut = np.zeros((256, 3), np.uint8)
        n = min(len(palette) // 3, 256)
        lut[:n] = np.frombuffer(palette[: 3 * n], np.uint8).reshape(n, 3)
    return pix, mode, lut


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8, as Pillow's `convert("RGB")`."""
    pix, mode, lut = read_png(data)
    if mode == "RGB":
        return pix
    if mode == "RGBA":
        return np.ascontiguousarray(pix[..., :3])
    if mode == "P":
        return lut[pix]
    gray = pix if mode in ("L", "1") else pix[..., 0]
    return np.repeat(gray[..., None], 3, axis=2)


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
