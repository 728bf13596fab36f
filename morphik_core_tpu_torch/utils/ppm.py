"""Netpbm in numpy: what Pillow's `PpmImagePlugin` holds after
`Image.open(...).load()`.

The header is read as the plugin reads it: a magic of up to six bytes
ended by whitespace (P1-P6, Pf, and Pillow's own P0CMYK / PyRGBA / PyCMYK;
its PyP, a palette image with no palette, is refused), then tokens of at most 10 bytes, each ended by one whitespace
byte, with `#` dropping the rest of its line wherever it stands. Modes:
P1 / P4 "1", P2 / P5 "L", P3 / P6 "RGB", Pf "F" (rows bottom-up, the
sign of the scale giving the byte order); a maxval over 255 makes a gray
image "I" (int32). The three decoders:

- `raw` (P4-P6 at maxval 255, gray at 65535 as I;16B, Pf, the extensions);
- `ppm` (`PpmDecoder`, any other maxval of P5 / P6): one or two bytes a
  sample, `min(out_max, round(v / maxval * out_max))` with out_max 255, or
  65535 for "I";
- `ppm_plain` (`PpmPlainDecoder`, P1-P3): the text read in blocks of
  `ImageFile.SAFEBLOCK` bytes with the plugin's comment and half-token
  handling, every token held to 10 bytes and 0..maxval, then scaled as
  `ppm` does; P1 takes single "0" / "1" bytes with no whitespace needed.

Data that ends before the image is an error, as Pillow's "not enough
image data" / "image file is truncated" are.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np

from morphik_core_tpu_torch.utils.jpeg import NotThisFormat, UnsupportedImage

_WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB", b"P0CMYK": "CMYK",
          b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "F": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
SAFEBLOCK = 1024 * 1024


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix.startswith(b"P") and prefix[1] in b"0123456fy"


class _Header(NamedTuple):
    mode: str
    size: Tuple[int, int]
    decoder: str      # "raw", "ppm" or "ppm_plain"
    rawmode: str
    maxval: int
    offset: int


def _token(data: bytes, pos: int) -> Tuple[bytes, int]:
    """`PpmImageFile._read_token` from `pos` -> (token, position after it)."""
    token = b""
    n = len(data)
    while len(token) <= 10:
        if pos >= n:
            break
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while pos < n and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            pos += 1 if pos < n else 0
            continue
        token += c
    if not token:
        raise ValueError("Reached EOF while reading header")
    if len(token) > 10:
        raise ValueError(f"Token too long in file header: {token!r}")
    return token, pos


def _header(data: bytes) -> _Header:
    magic, pos = b"", 0
    for _ in range(6):
        c = data[pos:pos + 1]
        pos += 1 if c else 0
        if not c or c in _WHITESPACE:
            break
        magic += c
    if magic not in _MODES:
        raise NotThisFormat("not a PPM file")
    mode = _MODES[magic]
    if magic == b"PyP":
        raise UnsupportedImage("PyP Netpbm (Pillow's own test format: a palette image with no palette)")
    w, pos = _token(data, pos)
    h, pos = _token(data, pos)
    size = (int(w), int(h))
    decoder = "ppm_plain" if magic in (b"P1", b"P2", b"P3") else "raw"
    maxval = 255
    if mode == "1":
        rawmode = "1;I"
    elif mode == "F":
        tok, pos = _token(data, pos)
        scale = float(tok)
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("scale must be finite and non-zero")
        rawmode = "F;32F" if scale < 0 else "F;32BF"
    else:
        tok, pos = _token(data, pos)
        maxval = int(tok)
        if not 0 < maxval < 65536:
            raise ValueError("maxval must be greater than 0 and less than 65536")
        if maxval > 255 and mode == "L":
            mode = "I"
        rawmode = mode
        if decoder != "ppm_plain":
            if maxval == 65535 and mode == "I":
                rawmode = "I;16B"
            elif maxval != 255:
                decoder = "ppm"
    if size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat("an image of no pixels")
    return _Header(mode, size, decoder, rawmode, maxval, pos)


def probe_ppm(data: bytes) -> Tuple[int, int]:
    return _header(data).size


def _short() -> ValueError:
    return ValueError("PPM data ends before the image: not enough image data")


def _scale(v: np.ndarray, maxval: int, mode: str) -> np.ndarray:
    out_max = 65535 if mode == "I" else 255
    out = np.minimum(out_max, np.round(v.astype(np.float64) / maxval * out_max))
    return out.astype(np.int32 if mode == "I" else np.uint8)


def _comment_end(block: bytes, start: int = 0) -> int:
    a, b = block.find(b"\n", start), block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


class _Plain:
    """`PpmPlainDecoder`: blocks, comments that span them, half tokens."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos, self.spans = data, pos, False

    def block(self) -> bytes:
        b = self.data[self.pos:self.pos + SAFEBLOCK]
        self.pos += len(b)
        return b

    def strip_comments(self, block: bytes) -> bytes:
        if self.spans:
            while block:
                end = _comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.block()
        self.spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = _comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1:]
            else:
                block = block[:start]
                self.spans = True
                break
        return block

    def bitonal(self, total: int) -> np.ndarray:
        data = bytearray()
        while len(data) != total:
            block = self.block()
            if not block:
                break
            tokens = b"".join(self.strip_comments(block).split())
            if tokens.translate(None, b"01"):
                raise ValueError("Invalid token for this mode")
            data = (data + tokens)[:total]
        if len(data) < total:
            raise _short()
        # "0" is white, "1" black
        return np.where(np.frombuffer(bytes(data), np.uint8) == 0x30, 255, 0).astype(np.uint8)

    def samples(self, total: int, maxval: int) -> np.ndarray:
        parts, have, half = [], 0, b""
        while have != total:
            block = self.block()
            if not block:
                if not half:
                    break
                block = b" "
            block = self.strip_comments(block)
            if half:
                block, half = half + block, b""
            tokens = block.split()
            if block and not block[-1:].isspace():
                half = tokens.pop()
                if len(half) > 10:
                    raise ValueError("Token too long found in data")
            tokens = tokens[:total - have]
            if any(len(t) > 10 for t in tokens):
                raise ValueError("Token too long found in data")
            vals = np.array([int(t) for t in tokens], np.int64)
            if (vals < 0).any() or (vals > maxval).any():
                raise ValueError("Channel value out of range for this mode")
            parts.append(vals)
            have += len(vals)
        if have < total:
            raise _short()
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def read_ppm(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """Netpbm bytes -> (pixels, mode, None): "1" (0 / 255) and "L" uint8,
    "I" int32, "F" float32 (H, W), "RGB" / "RGBA" / "CMYK" uint8 (H, W, C)."""
    hd = _header(data)
    w, h = hd.size
    bands = _BANDS[hd.mode]
    body = data[hd.offset:]
    if hd.decoder == "ppm_plain":
        plain = _Plain(data, hd.offset)
        if hd.mode == "1":
            px = plain.bitonal(w * h)
        else:
            px = _scale(plain.samples(w * h * bands, hd.maxval), hd.maxval, hd.mode)
    elif hd.decoder == "ppm":
        nb = 1 if hd.maxval < 256 else 2
        n = w * h * bands
        raw = np.frombuffer(body[:n * nb], np.uint8 if nb == 1 else ">u2")
        if len(raw) < n:
            raise _short()
        px = _scale(raw, hd.maxval, hd.mode)
    elif hd.rawmode == "1;I":
        stride = (w + 7) // 8
        if len(body) < stride * h:
            raise _short()
        bits = np.unpackbits(np.frombuffer(body[:stride * h], np.uint8).reshape(h, stride), axis=1)[:, :w]
        px = ((1 - bits) * 255).astype(np.uint8)
    elif hd.mode == "F":
        raw = np.frombuffer(body[:4 * w * h], "<f4" if hd.rawmode == "F;32F" else ">f4")
        if len(raw) < w * h:
            raise _short()
        px = raw.astype(np.float32).reshape(h, w)[::-1]
    elif hd.rawmode == "I;16B":
        raw = np.frombuffer(body[:2 * w * h], ">u2")
        if len(raw) < w * h:
            raise _short()
        px = raw.astype(np.int32)
    else:
        px = np.frombuffer(body[:w * h * bands], np.uint8)
        if len(px) < w * h * bands:
            raise _short()
    px = np.ascontiguousarray(px.reshape((h, w) if bands == 1 else (h, w, bands)))
    return px, hd.mode, None
