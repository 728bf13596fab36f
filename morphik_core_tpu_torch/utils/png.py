"""PNG decode and encode in numpy + zlib: the page-image codec of the
port's service plane (the card's machine has no PIL).

`read_png` returns the pixels in the mode Pillow's `Image.open` gives
them (L, LA, RGB, RGBA, or P with its palette for 8-bit PNGs; 1, L or P
for 1/2/4-bit gray and palette PNGs; for 16-bit PNGs, I;16 (uint16) for
gray, and the high byte of each sample for the others: RGB, and RGBA for
both gray + alpha and RGB + alpha), so a page can be resized and
converted under Pillow's mode rules; `decode_png` returns what
`Image.open(...).convert("RGB")` gives: gray replicated to three
channels (I;16 clipped to 255), alpha dropped (not composited), palette
indices looked up (indices past the palette read as black). A tRNS chunk
is ignored, as it stays in Pillow's `info`. Every row filter (None, Sub,
Up, Average, Paeth) is undone exactly, and Adam7-interlaced images are
put together from their seven passes (a pass of no pixels has no rows).
`encode_png` writes filter 0 rows (tests and `chip_smoke.py` make their
inputs with it).

`text_comment` is the `info["comment"]` that Pillow's PNG plugin holds
once the image is loaded: the last `tEXt`, `zTXt` or `iTXt` chunk keyed
`comment`, before or after the image data, with Pillow's text limits.
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
# PngImagePlugin's limits on text: one decompressed chunk, and all text chunks together
MAX_TEXT_CHUNK = 1024 * 1024
MAX_TEXT_MEMORY = 64 * MAX_TEXT_CHUNK


def _chunks(data: bytes, cut_tail: bool = False):
    """(type, body) of each chunk, CRC checked, up to IEND. With
    `cut_tail`, as Pillow's `load` reads them: from the first IDAT on no
    CRC is checked, and data that ends in a chunk's header or CRC ends the
    chunks."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    seen_idat = False
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        seen_idat |= cut_tail and ctype == b"IDAT"
        body = data[pos + 8 : pos + 8 + length]
        crc = data[pos + 8 + length : pos + 12 + length]
        if len(body) != length or (len(crc) != 4 and not seen_idat):
            raise ValueError(f"truncated PNG chunk {ctype!r}")
        if not seen_idat and zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"broken PNG file (CRC mismatch in {ctype!r})")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    if not seen_idat:
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
# Adam7: (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _samples(rows: np.ndarray, width: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered rows -> (h, w, ch) samples: uint8 for depths up to 8
    (packed samples most significant bits first), uint16 for 16."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, width, ch)
    if depth == 8:
        return rows.reshape(h, width, ch)
    bits = np.unpackbits(rows, axis=1)[:, : width * depth].reshape(h, width, depth)
    return (bits.astype(np.int64) << np.arange(depth - 1, -1, -1)).sum(axis=-1).astype(np.uint8)[..., None]


def read_png(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """PNG bytes -> (pixels, mode, palette) as Pillow's `Image.open` holds
    them: mode L, I;16 or P (H, W), LA (H, W, 2), RGB (H, W, 3), RGBA
    (H, W, 4); `palette` is the (256, 3) lookup of a P image, else None."""
    header = None
    palette = b""
    idat: List[bytes] = []
    for ctype, body in _chunks(data, cut_tail=True):
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
    if depth not in (8, 16) and not (depth in (1, 2, 4) and color in (0, 3)) or (depth == 16 and color == 3):
        raise ValueError(f"PNG bit depth {depth} is not valid for color type {color}")
    if interlace not in (0, 1):
        raise ValueError(f"unknown PNG interlace method {interlace}")
    if width * height > MAX_PIXELS:
        raise ValueError(f"PNG of {width} x {height} pixels exceeds the decompression-bomb limit {MAX_PIXELS}")
    ch = _CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    # each pass: (x0, y0, dx, dy, its width, its height); an empty pass has no rows
    sizes = [(x0, y0, dx, dy, -(-(width - x0) // dx), -(-(height - y0) // dy)) for x0, y0, dx, dy in passes]
    sizes = [t for t in sizes if t[4] > 0 and t[5] > 0]
    need = sum(ph * ((pw * ch * depth + 7) // 8 + 1) for *_, pw, ph in sizes)
    # decompress no more than the image needs: a small file cannot expand without bound
    raw = zlib.decompressobj().decompress(b"".join(idat), need)
    pix = np.zeros((height, width, ch), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy, pw, ph in sizes:
        stride = (pw * ch * depth + 7) // 8
        rows = _unfilter(memoryview(raw)[at:], ph, stride, bpp)
        at += ph * (stride + 1)
        pix[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
    mode = _MODES[color]
    if depth == 16:
        if color == 0:
            return pix[..., 0], "I;16", None
        # Pillow keeps the high byte; gray + alpha opens as RGBA
        pix = (pix >> 8).astype(np.uint8)
        if color == 4:
            pix, mode = pix[..., [0, 0, 0, 1]], "RGBA"
        return np.ascontiguousarray(pix), mode, None
    if depth < 8 and color == 0:
        # gray scales up as Pillow's "L;2" / "L;4" unpackers do; 1-bit gray is mode "1"
        pix = (pix * (255 // ((1 << depth) - 1))).astype(np.uint8)
        mode = "1" if depth == 1 else "L"
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
    gray = pix[..., 0] if mode == "LA" else pix
    if mode == "I;16":
        gray = np.minimum(gray, 255).astype(np.uint8)
    return np.repeat(gray[..., None], 3, axis=2)


def _inflate_text(body: bytes) -> bytes:
    """`_safe_zlib_decompress`: at most MAX_TEXT_CHUNK bytes, more is an
    error; a broken stream raises zlib.error."""
    dobj = zlib.decompressobj()
    out = dobj.decompress(body, MAX_TEXT_CHUNK)
    if dobj.unconsumed_tail:
        raise ValueError("Decompressed data too large for PngImagePlugin.MAX_TEXT_CHUNK")
    return out


def _text_chunk(ctype: bytes, body: bytes) -> Optional[Tuple[bytes, str]]:
    """(key, text) as `chunk_tEXt` / `chunk_zTXt` / `chunk_iTXt` store it
    in `im_info`, or None where they store nothing."""
    k, sep, v = body.partition(b"\0")
    if ctype == b"tEXt":
        return (k, v.decode("latin-1")) if k else None
    if ctype == b"zTXt":
        if v[:1] not in (b"", b"\0"):
            raise ValueError(f"Unknown compression method {v[0]} in zTXt chunk")
        try:
            v = _inflate_text(v[1:])
        except zlib.error:
            v = b""
        return (k, v.decode("latin-1")) if k else None
    if not sep or len(v) < 2:   # iTXt
        return None
    cf, cm, rest = v[0], v[1], v[2:]
    parts = rest.split(b"\0", 2)
    if len(parts) < 3:
        return None
    lang, tk, text = parts
    if cf:
        if cm:
            return None
        try:
            text = _inflate_text(text)
        except zlib.error:
            return None
    try:
        lang.decode("utf-8"), tk.decode("utf-8")
        return k, text.decode("utf-8")
    except UnicodeError:
        return None


def open_png(data: bytes) -> None:
    """What `PngImagePlugin`'s `_open` reads: the chunks before the first
    IDAT (whole, CRC checked) and their text, held to MAX_TEXT_CHUNK and
    MAX_TEXT_MEMORY. Raises ValueError where `Image.open` does; what
    follows is `load`'s."""
    memory = 0
    pos = 8
    while True:
        if data[pos + 4:pos + 8] == b"IDAT":   # its header read, its data is load's
            return
        ctype, body = next(_chunks(data[:8] + data[pos:]))
        pos += 12 + len(body)
        if ctype == b"IEND":
            return
        if ctype in (b"tEXt", b"zTXt", b"iTXt"):
            kv = _text_chunk(ctype, body)
            memory += len(kv[1]) if kv else 0
            if memory > MAX_TEXT_MEMORY:
                raise ValueError(f"Too much memory used in text chunks: {memory}>MAX_TEXT_MEMORY")


def text_comment(data: bytes) -> Optional[str]:
    """`Image.open(...)` then `load()`: the `comment` in its `info`, from
    the text chunks in file order (the last wins, an empty one too), or
    None without one. Raises ValueError where Pillow's open or load does
    (an unknown zTXt method, a chunk past MAX_TEXT_CHUNK, text chunks past
    MAX_TEXT_MEMORY)."""
    comment = None
    memory = 0
    for ctype, body in _chunks(data):
        if ctype not in (b"tEXt", b"zTXt", b"iTXt"):
            continue
        kv = _text_chunk(ctype, body)
        if kv is None:
            continue
        memory += len(kv[1])
        if memory > MAX_TEXT_MEMORY:
            raise ValueError(f"Too much memory used in text chunks: {memory}>MAX_TEXT_MEMORY")
        if kv[0] == b"comment":
            comment = kv[1]
    return comment


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
