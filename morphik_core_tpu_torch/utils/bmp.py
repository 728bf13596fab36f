"""Windows BMP in numpy: what Pillow's `BmpImagePlugin` (and its
`BmpRleDecoder`) hold after `Image.open(...).load()`.

Headers: BITMAPCOREHEADER (OS/2 v1, 12 bytes, 3-byte palette entries)
and the INFO family (40, 52, 56, 64, 108 and 124 bytes: V4 and V5
included); rows bottom-up, or top-down when the height is negative.
Depths 1, 4 and 8 read through the palette ("P"), which Pillow drops for
mode "1" when a 2-entry palette is black then white and for mode "L"
when entry i is (i, i, i) for every entry; 16 bits (5-5-5 unless
BI_BITFIELDS says 5-6-5), 24 and 32 bits give "RGB", and a 32-bit
BI_BITFIELDS layout with an alpha mask gives "RGBA" (the layouts of
Pillow's `SUPPORTED` table). Five- and six-bit channels scale as
`Unpack.c` `ImagingUnpackBGR15` / `BGR16` do: `v * 255 / 31` (or 63),
truncated. RLE8 and RLE4 follow `BmpRleDecoder` step by step, its
quirks included: a delta escape reads four bytes and moves by the last
two, skipped pixels are 0, an absolute run is padded to an even file
offset, and data that ends early leaves the image short (an error, as
Pillow's raw decoder raises "not enough image data").
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from morphik_core_tpu_torch.utils.jpeg import UnsupportedImage

_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): "BGRX",
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): "XBGR",
    (0xFF000000, 0xFF00, 0xFF, 0x0): "BGXR",
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR",
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA",
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): "BGAR",
    (0x0, 0x0, 0x0, 0x0): "BGRA",
}
_MASKS24 = {(0xFF0000, 0xFF00, 0xFF): "BGR"}
_MASKS16 = {(0xF800, 0x7E0, 0x1F): "BGR;16", (0x7C00, 0x3E0, 0x1F): "BGR;15"}


class _Header:
    __slots__ = ("width", "height", "bits", "compression", "top_down", "rawmode", "mode", "palette", "offset")


def _refuse(what: str, open_fails: bool = False) -> UnsupportedImage:
    return UnsupportedImage(f"BMP {what}", open_fails)


def _header(data: bytes) -> _Header:
    if data[:2] != b"BM" or len(data) < 18:
        raise ValueError("not a BMP file")
    return _dib_header(data, 14, struct.unpack("<I", data[10:14])[0])


def _dib_header(data: bytes, at: int, offset: int, cur22: bool = False) -> _Header:
    """`BmpImageFile._bitmap(header=at, offset=offset)`: the info header at
    `at`; the pixels at `offset`, or right after the header, its masks and
    its palette when `offset` is 0 (a DIB); `cur22`: a 32-bit raw DIB at
    offset 22 of a cursor file reads as BGRA (the plugin's quirk)."""
    size = struct.unpack("<I", data[at:at + 4])[0]
    hd = data[at + 4:at + size]
    if len(hd) != size - 4:
        raise ValueError("truncated BMP header")
    h = _Header()
    pos = at + size
    masks = None
    if size == 12:
        h.width, h.height, _planes, h.bits = struct.unpack("<HHHH", hd[:8])
        h.compression, pad, h.top_down = 0, 3, False
        colors = 0
    elif size in (40, 52, 56, 64, 108, 124):
        h.top_down = hd[7] == 0xFF
        h.width, height = struct.unpack("<II", hd[0:8])
        h.height = 2 ** 32 - height if h.top_down else height
        _planes, h.bits, h.compression = struct.unpack("<HHI", hd[8:16])
        colors = struct.unpack("<I", hd[28:32])[0]
        pad = 4
        if h.compression == 3:
            if len(hd) >= 48:
                masks = struct.unpack("<4I", hd[36:52]) if len(hd) >= 52 else struct.unpack("<3I", hd[36:48]) + (0,)
            else:
                masks = struct.unpack("<3I", data[pos:pos + 12]) + (0,)
                pos += 12
    else:
        raise _refuse(f"header of {size} bytes", open_fails=True)   # Pillow: "Unsupported BMP header type"
    colors = colors or (1 << h.bits)
    if offset and offset == 14 + size and h.bits <= 8:
        offset += 4 * colors
    modes = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"),
             32: ("RGB", "BGRX")}
    if h.bits not in modes:
        raise ValueError(f"unsupported BMP pixel depth ({h.bits})")
    h.mode, h.rawmode = modes[h.bits]
    if h.compression == 3:
        table = {32: _MASKS32, 24: _MASKS24, 16: _MASKS16}.get(h.bits, {})
        key = masks if h.bits == 32 else masks[:3]
        if key not in table:
            raise ValueError("unsupported BMP bitfields layout")
        h.rawmode = table[key]
        if "A" in h.rawmode:
            h.mode = "RGBA"
    elif h.compression == 0 and h.bits == 32 and cur22 and at == 22:
        h.mode, h.rawmode = "RGBA", "BGRA"
    elif h.compression in (1, 2):
        if h.bits != (8 if h.compression == 1 else 4):
            raise _refuse(f"RLE{8 if h.compression == 1 else 4} at {h.bits} bits")
    elif h.compression != 0:
        raise _refuse(f"compression {h.compression} (JPEG or PNG inside a BMP)", open_fails=True)
    h.palette = None
    if h.mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"unsupported BMP palette size ({colors})")
        raw = data[pos:pos + pad * colors]
        pos += len(raw)
        ents = np.frombuffer(raw[:len(raw) // pad * pad], np.uint8).reshape(-1, pad)[:, 2::-1]
        want = [0, 255] if colors == 2 else list(range(colors))
        gray = len(ents) == colors and all((ents[i] == v).all() for i, v in enumerate(want))
        if gray:
            h.mode = "1" if colors == 2 else "L"
            h.rawmode = h.mode
        else:
            lut = np.zeros((256, 3), np.uint8)
            n = min(len(ents), 256)
            lut[:n] = ents[:n]
            h.palette = lut
    h.offset = offset or pos
    return h


def _check(h: _Header) -> None:
    if h.compression in (1, 2) and h.mode == "1":
        raise _refuse("RLE with a black-and-white palette (Pillow cannot load it)")
    if h.compression == 0 and h.mode in ("1", "L") and h.bits != (1 if h.mode == "1" else 8):
        raise _refuse(f"{h.bits}-bit rows under a {h.mode} palette (Pillow misreads them)")


def probe_bmp(data: bytes) -> Tuple[int, int]:
    h = _header(data)
    _check(h)
    return h.width, h.height


def dib_accept(prefix: bytes) -> bool:
    """`BmpImagePlugin._dib_accept`."""
    return len(prefix) >= 4 and struct.unpack("<I", prefix[:4])[0] in (12, 40, 52, 56, 64, 108, 124)


def dib_header(data: bytes, at: int = 0, cur22: bool = False) -> _Header:
    """The header of a DIB (no file header) at `at`, checked as `probe_bmp`
    checks a BMP's."""
    h = _dib_header(data, at, 0, cur22)
    _check(h)
    return h


def probe_dib(data: bytes) -> Tuple[int, int]:
    h = dib_header(data)
    return h.width, h.height


def _rle(data: bytes, pos: int, width: int, height: int, rle4: bool) -> np.ndarray:
    out = bytearray()
    x = 0
    need = width * height
    n = len(data)
    while len(out) < need:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            if x + count > width:
                count = max(0, width - x)
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:
            if len(out) % width:
                out += bytes(width - len(out) % width)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            if pos + 2 > n:
                break
            pos += 2
            if pos + 2 > n:
                raise ValueError("truncated BMP RLE delta")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * width)
            x = len(out) % width
        else:
            nbytes = byte // 2 if rle4 else byte
            run = data[pos:pos + nbytes]
            pos += len(run)
            if rle4:
                out += bytes(v for b in run for v in (b >> 4, b & 15))
            else:
                out += run
            if len(run) < nbytes:
                break
            x += byte
            if pos % 2:
                pos += 1
    if len(out) < need:
        raise ValueError("BMP RLE data ends before the image: not enough image data")
    return np.frombuffer(bytes(out[:need]), np.uint8).reshape(height, width)


def _scale(v: np.ndarray, bits: int) -> np.ndarray:
    return (v.astype(np.int32) * 255 // ((1 << bits) - 1)).astype(np.uint8)


def read_bmp(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """BMP bytes -> (pixels, mode, palette): "1" / "L" / "P" (H, W), "RGB"
    (H, W, 3), "RGBA" (H, W, 4) uint8; `palette` the (256, 3) lookup of a P
    image (entries past the file's black), else None."""
    h = _header(data)
    _check(h)
    return dib_pixels(data, h, h.height), h.mode, h.palette


def read_dib(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """A DIB file (`DibImageFile`) -> as `read_bmp`."""
    h = dib_header(data)
    return dib_pixels(data, h, h.height), h.mode, h.palette


def dib_pixels(data: bytes, h: _Header, height: int) -> np.ndarray:
    """The pixels of the first `height` stored rows (an icon's or a
    cursor's XOR image is the first half of its DIB's rows)."""
    w, ht = h.width, height
    if h.compression in (1, 2):
        px = _rle(data, h.offset, w, ht, h.compression == 2)
    else:
        stride = ((w * h.bits + 31) >> 3) & ~3
        body = data[h.offset:h.offset + stride * ht]
        if len(body) < stride * ht:
            raise ValueError("truncated BMP image data: not enough image data")
        rows = np.frombuffer(body, np.uint8).reshape(ht, stride)
        if h.bits in (1, 4):
            bits = np.unpackbits(rows, axis=1)[:, :w * h.bits].reshape(ht, w, h.bits)
            px = (bits.astype(np.int32) << np.arange(h.bits - 1, -1, -1)).sum(-1).astype(np.uint8)
            if h.mode == "1":
                px = (px * 255).astype(np.uint8)
        elif h.bits == 8:
            px = rows[:, :w]
        elif h.bits == 16:
            v = rows[:, :2 * w].view("<u2").astype(np.int32)
            if h.rawmode == "BGR;16":
                px = np.stack([_scale(v >> 11 & 31, 5), _scale(v >> 5 & 63, 6), _scale(v & 31, 5)], -1)
            else:
                px = np.stack([_scale(v >> 10 & 31, 5), _scale(v >> 5 & 31, 5), _scale(v & 31, 5)], -1)
        else:
            nb = h.bits // 8
            pix = rows[:, :nb * w].reshape(ht, w, nb)
            order = h.rawmode
            px = np.stack([pix[..., order.index(c)] for c in ("RGBA" if h.mode == "RGBA" else "RGB")], -1)
    if not h.top_down:
        px = px[::-1]
    return np.ascontiguousarray(px)
