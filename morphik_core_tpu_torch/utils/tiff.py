"""TIFF in numpy and the stdlib: the first page as Pillow's
`TiffImagePlugin` holds it after `Image.open(...).load()`, which here
reads every compressed file through libtiff.

- Layout: little- (II) and big-endian (MM) files, the first IFD only (a
  multi-page file is its first page), strips and tiles, PlanarConfig 1.
- Compression: none (1), PackBits (32773), LZW (5, `utils/lzw.py`, TIFF
  setting), Deflate (8 and 32946, `zlib`), CCITT Modified Huffman, T.4
  and T.6 (2, 3, 4, `utils/ccitt.py`), and JPEG (7): each strip or tile
  an abbreviated stream that takes its tables from `JPEGTables` (tag
  347), decoded by `utils/jpeg.py`; YCbCr data comes out as RGB, as
  libtiff's `JPEGCOLORMODE_RGB` gives it, any other photometric
  interpretation as the stored samples. FillOrder 2 reverses the bits of
  each byte before decompression (libtiff's `TIFFReverseBits`), and
  Predictor 2 adds each sample to the one left of it, in 8 or 16 bits.
- Modes, from Pillow's `OPEN_INFO`: WhiteIsZero / BlackIsZero at 1 bit
  ("1"), 2, 4 and 8 bits ("L", inverted for WhiteIsZero), 16 bits
  ("I;16", or "I;16B" for MM, never inverted); gray + unassociated alpha
  ("LA", II only); RGB at 8 bits and the high byte of each 16-bit sample
  ("RGB", "RGBA" with an alpha in ExtraSamples: unassociated as stored,
  associated divided back (`Unpack.c` `unpackRGBa`: c * 255 / a,
  clipped; alpha 0 gives 0), extra samples of kind 0 dropped); palette
  at 1/2/4/8 bits ("P", each 16-bit ColorMap entry divided by 256);
  CMYK at 8 and 16 bits; YCbCr JPEG ("RGB").
- Orientation: Pillow's `load_end` runs `ImageOps.exif_transpose` on a
  TIFF, so the Orientation tag (274) is applied here too.

Refused by name (`UnsupportedImage`, ROADMAP Queue 1 item 3b-ii): BigTIFF,
old-style JPEG (6) and the other compressions, float, signed and 12- or
32-bit samples, planar layouts (PlanarConfig 2), YCbCr without JPEG,
Lab, and any key Pillow's `OPEN_INFO` does not list.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from morphik_core_tpu_torch.utils.ccitt import decode_ccitt
from morphik_core_tpu_torch.utils.jpeg import UnsupportedImage, read_jpeg
from morphik_core_tpu_torch.utils.lzw import decode_tiff_lzw

_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 6: "b", 7: "s", 8: "h", 9: "i", 10: "ii", 11: "f", 12: "d",
          13: "I"}
_COMPRESSIONS = {1: "none", 2: "CCITT Modified Huffman", 3: "CCITT T.4", 4: "CCITT T.6", 5: "LZW",
                 7: "JPEG", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}
_REVERSE = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _refuse(what: str, open_fails: bool = False) -> UnsupportedImage:
    return UnsupportedImage(f"TIFF {what}", open_fails)


CUT = -1   # the key under which `_first_ifd` records the tag whose values run past the data


def _first_ifd(data: bytes) -> Tuple[str, Dict[int, tuple]]:
    """The byte order and the first IFD's tags (tag -> tuple of values;
    ASCII and UNDEFINED values as one bytes object), read as Pillow's
    `ImageFileDirectory_v2.load` reads them: up to a tag whose values run
    past the data, recorded under CUT."""
    head = data[:4]
    if head[:2] == b"II":
        e = "<"
    elif head[:2] == b"MM":
        e = ">"
    else:
        raise ValueError("not a TIFF file")
    (magic,) = struct.unpack(e + "H", data[2:4])
    if magic == 43:
        raise _refuse("in the BigTIFF layout")
    if magic != 42:
        raise ValueError("not a TIFF file")
    (off,) = struct.unpack(e + "I", data[4:8])
    if off + 2 > len(data):
        raise ValueError("truncated TIFF file (no IFD)")
    (n,) = struct.unpack(e + "H", data[off:off + 2])
    tags: Dict[int, tuple] = {}
    for k in range(n):
        at = off + 2 + 12 * k
        if at + 12 > len(data):
            raise ValueError("truncated TIFF IFD")
        tag, typ, count = struct.unpack(e + "HHI", data[at:at + 8])
        if typ not in _TYPES:
            continue
        fmt = _TYPES[typ]
        size = struct.calcsize(e + fmt) * count
        raw = data[at + 8:at + 8 + size] if size <= 4 else None
        if raw is None:
            (vo,) = struct.unpack(e + "I", data[at + 8:at + 12])
            raw = data[vo:vo + size]
            if len(raw) != size:   # Pillow's IFD reader stops here ("Truncated File Read"): this tag and
                tags[CUT] = (tag,)  # the ones after it are not read
                break
        if typ in (2, 7):
            tags[tag] = (raw,)
        elif typ in (5, 10):
            v = struct.unpack(e + fmt[0] * (2 * count), raw)
            tags[tag] = tuple(v[i] / v[i + 1] if v[i + 1] else 0.0 for i in range(0, len(v), 2))
        else:
            tags[tag] = struct.unpack(e + fmt * count, raw)
    return e, tags


class _Layout:
    __slots__ = ("e", "tags", "width", "height", "bps", "spp", "photo", "compression", "extra", "mode", "raw",
                 "fax")


# Pillow's OPEN_INFO rows that the port reads: (byte order or None for
# both, photometric, bits per sample, extra samples) -> (mode, what the
# samples become)
_OPEN = {
    (None, 0, (1,), ()): ("1", "1;I"), (None, 1, (1,), ()): ("1", "1"),
    (None, 0, (2,), ()): ("L", "L;I"), (None, 1, (2,), ()): ("L", "L"),
    (None, 0, (4,), ()): ("L", "L;I"), (None, 1, (4,), ()): ("L", "L"),
    (None, 0, (8,), ()): ("L", "L;I"), (None, 1, (8,), ()): ("L", "L"),
    ("<", 0, (16,), ()): ("I;16", "I;16"), ("<", 1, (16,), ()): ("I;16", "I;16"),
    (">", 1, (16,), ()): ("I;16B", "I;16"),
    ("<", 1, (8, 8), (2,)): ("LA", "LA"),
    (None, 2, (8, 8, 8), ()): ("RGB", "RGB"),
    (None, 2, (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
    (None, 2, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
    (None, 2, (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBX"),
    (None, 2, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBX"),
    (None, 2, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
    (None, 2, (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBa"),
    (None, 2, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBa"),
    (None, 2, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
    (None, 2, (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBA"),
    (None, 2, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBA"),
    (None, 2, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
    (None, 2, (16, 16, 16), ()): ("RGB", "RGB"),
    (None, 2, (16, 16, 16, 16), ()): ("RGBA", "RGBA"),
    (None, 2, (16, 16, 16, 16), (0,)): ("RGB", "RGBX"),
    (None, 2, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa"),
    (None, 2, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA"),
    (None, 3, (1,), ()): ("P", "P"), (None, 3, (2,), ()): ("P", "P"),
    (None, 3, (4,), ()): ("P", "P"), (None, 3, (8,), ()): ("P", "P"),
    (None, 3, (8, 8), (0,)): ("P", "PX"),
    (None, 5, (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
    (None, 5, (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
    (None, 5, (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKX"),
    (None, 5, (16, 16, 16, 16), ()): ("CMYK", "CMYK"),
    (None, 6, (8,), ()): ("L", "L"),
    (None, 6, (8, 8, 8), ()): ("RGB", "RGB"),
}


def _layout(data: bytes) -> _Layout:
    e, tags = _first_ifd(data)
    t = _Layout()
    t.e, t.tags = e, tags
    t.fax = {}   # the CCITT decoder's mode, kept from strip to strip as libtiff keeps it
    if 256 not in tags or 257 not in tags:
        raise ValueError("TIFF has no image dimensions")
    t.width, t.height = tags[256][0], tags[257][0]
    t.compression = tags.get(259, (1,))[0]
    if t.compression not in _COMPRESSIONS:
        name = {6: "old-style JPEG", 32771: "CCITT RLE-word", 34712: "JPEG 2000", 34925: "LZMA",
                50000: "Zstandard", 50001: "WebP"}.get(t.compression, f"compression {t.compression}")
        raise _refuse(f"{name} (compression {t.compression})")
    photo = tags.get(262, (0,))[0]
    if tags.get(284, (1,))[0] != 1:
        raise _refuse("planar layout (PlanarConfiguration 2)")
    fmt = tags.get(339, (1,))
    if any(f != 1 for f in fmt):
        # no mode of Pillow's has them: "unknown pixel mode", no plugin identifies the file
        raise _refuse("float or signed samples (SampleFormat " + "/".join(map(str, fmt)) + ")", open_fails=True)
    extra = tags.get(338, ())
    spp = tags.get(277, (3 if t.compression == 7 and photo in (2, 6) else 1,))[0]
    bps = tags.get(258, (1,))
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError("unknown TIFF data organization")
    if photo == 6 and t.compression != 7:
        raise _refuse("YCbCr without JPEG compression")
    if any(b not in (1, 2, 4, 8, 16) for b in bps):
        raise _refuse(f"{'/'.join(map(str, bps))}-bit samples")
    key = (e, photo, tuple(bps), tuple(extra))
    found = _OPEN.get(key) or _OPEN.get((None,) + key[1:])
    if found is None:
        raise _refuse(f"pixel layout (photometric {photo}, {'/'.join(map(str, bps))} bits, extra samples "
                      f"{'/'.join(map(str, extra)) or 'none'})")
    t.mode, t.raw = found
    if t.compression == 7 and 8 not in bps:
        raise _refuse(f"JPEG at {bps[0]} bits")
    if t.compression in (2, 3, 4) and bps != (1,):
        raise ValueError("CCITT compression of a TIFF that is not bilevel")
    if tags.get(317, (1,))[0] not in (1, 2):
        raise _refuse(f"predictor {tags[317][0]}")
    if tags.get(317, (1,))[0] == 2 and bps[0] not in (8, 16):
        raise ValueError(f"horizontal differencing of {bps[0]}-bit samples")
    if t.mode == "P" and 320 not in tags:
        raise ValueError("palette TIFF has no ColorMap")
    t.bps, t.spp, t.photo, t.extra = bps[0], spp, photo, extra
    return t


def probe_tiff(data: bytes) -> Tuple[int, int]:
    """(width, height) after the orientation, as Pillow reports them."""
    t = _layout(data)
    orientation = t.tags.get(274, (1,))[0]
    return (t.height, t.width) if orientation in (5, 6, 7, 8) else (t.width, t.height)


def _packbits(data: bytes, limit: int) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < limit:
        c = data[i]
        i += 1
        if c < 128:
            out += data[i:i + c + 1]
            i += c + 1
        elif c > 128:
            if i < n:
                out += bytes([data[i]]) * (257 - c)
            i += 1
    return bytes(out)


def _chunk_samples(t: _Layout, chunk: bytes, w: int, h: int, held: Optional[bytes]) -> Tuple[np.ndarray, bytes]:
    """One strip or tile's bytes -> ((h, w, spp) samples (uint8, or uint16
    at 16 bits; sub-byte samples as their values), the decoded bytes that
    the next chunk's decoder finds in the buffer). `held` is what the
    chunk before left there, which a CCITT Group 4 strip that ends early
    leaves in its rows not reached."""
    c = t.compression
    if t.tags.get(266, (1,))[0] == 2:
        chunk = chunk.translate(_REVERSE)
    if c == 7:
        tables = t.tags.get(347, (b"",))[0]
        stream = tables[:-2] + chunk[2:] if tables[:2] == b"\xff\xd8" and chunk[:2] == b"\xff\xd8" else chunk
        px, _ = read_jpeg(stream, color="YCbCr" if t.photo == 6 else "RGB")
        px = px.reshape(px.shape[0], px.shape[1], -1)
        if px.shape[2] != t.spp:
            raise ValueError("TIFF JPEG strip has another number of components than the file")
        out = np.zeros((h, w, t.spp), np.uint8)
        hh, ww = min(h, px.shape[0]), min(w, px.shape[1])
        out[:hh, :ww] = px[:hh, :ww]
        return out, held
    row_bytes = (w * t.spp * t.bps + 7) // 8
    need = row_bytes * h
    if c == 1:
        raw = chunk[:need]
    elif c == 32773:
        raw = _packbits(chunk, need)
    elif c == 5:
        raw = decode_tiff_lzw(chunk, need)
    elif c in (8, 32946):
        raw = zlib.decompressobj().decompress(chunk, need)
    else:
        raw = decode_ccitt(chunk, w, h, c, t.tags.get(292, (0,))[0], held, t.fax)
    # libtiff leaves what a short chunk does not reach as zeros
    raw = raw[:need] + bytes(max(0, need - len(raw)))
    rows = np.frombuffer(raw, np.uint8).reshape(h, row_bytes)
    if t.bps == 16:
        s = rows.view(t.e + "u2").astype(np.uint16).reshape(h, w, t.spp)
    elif t.bps == 8:
        s = rows.reshape(h, w, t.spp)
    else:
        bits = np.unpackbits(rows, axis=1)[:, :w * t.spp * t.bps].reshape(h, w * t.spp, t.bps)
        s = (bits.astype(np.int32) << np.arange(t.bps - 1, -1, -1)).sum(-1).astype(np.uint8).reshape(h, w, t.spp)
    if t.tags.get(317, (1,))[0] == 2:
        # horizontal differencing undone per sample, modulo the sample size
        s = np.cumsum(s.astype(np.uint64), axis=1).astype(s.dtype)
    return s, raw


def _chunks(t: _Layout):
    """(row, column, width, height, bytes) of every strip or tile."""
    tags = t.tags
    if 324 in tags:
        tw, th = tags[322][0], tags[323][0]
        offsets, counts = tags[324], tags.get(325, ())
        across = -(-t.width // tw)
        for k, off in enumerate(offsets):
            r, col = divmod(k, across)
            if r * th >= t.height:
                break
            n = counts[k] if k < len(counts) else 0
            yield r * th, col * tw, tw, th, off, n
    else:
        rps = min(tags.get(278, (t.height,))[0], t.height) or t.height
        offsets, counts = tags.get(273, ()), tags.get(279, ())
        if not offsets:
            raise ValueError("TIFF has no strips")
        for k, off in enumerate(offsets):
            if k * rps >= t.height:
                break
            n = counts[k] if k < len(counts) else 0
            yield k * rps, 0, t.width, min(rps, t.height - k * rps), off, n


_TRANSPOSE = {
    2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
    5: lambda a: a.swapaxes(0, 1), 6: lambda a: np.rot90(a, -1), 7: lambda a: a.swapaxes(0, 1)[::-1, ::-1],
    8: lambda a: np.rot90(a, 1),
}


def read_tiff(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """TIFF bytes -> (pixels, mode, palette) of the first page, as Pillow
    holds it: "1" / "L" / "P" (H, W) uint8, "I;16" / "I;16B" (H, W)
    uint16, "LA" (H, W, 2), "RGB" (H, W, 3), "RGBA" / "CMYK" (H, W, 4)
    uint8; `palette` the (256, 3) lookup of a P image, else None."""
    t = _layout(data)
    if CUT in t.tags and t.compression != 1:   # libtiff, which decodes the compressed ones, reads every tag
        raise ValueError(f"TIFF tag {t.tags[CUT][0]} runs past the end of the file")
    dtype = np.uint16 if t.bps == 16 else np.uint8
    s = np.zeros((t.height, t.width, t.spp), dtype)
    held = None   # Pillow decodes every strip or tile into one buffer, in turn
    for r, col, w, h, off, n in _chunks(t):
        chunk = data[off:off + n]
        block, held = _chunk_samples(t, chunk, w, h, held)
        hh, ww = min(h, t.height - r), min(w, t.width - col)
        s[r:r + hh, col:col + ww] = block[:hh, :ww]
    mode, raw = t.mode, t.raw
    if t.bps == 16 and mode not in ("I;16", "I;16B"):
        s = (s >> 8).astype(np.uint8)   # Pillow's ";16N" unpackers keep the high byte
    palette = None
    if mode == "1":
        px = (s[..., 0] if raw == "1" else 1 - s[..., 0]) * np.uint8(255)
    elif mode == "L":
        px = s[..., 0]
        if t.bps < 8:
            px = (px * (255 // ((1 << t.bps) - 1))).astype(np.uint8)
        if raw == "L;I":
            px = 255 - px
    elif mode in ("I;16", "I;16B"):
        px = s[..., 0]
    elif mode == "P":
        px = s[..., 0]
        cmap = np.asarray(t.tags[320], np.int64)
        n = 1 << t.bps
        if cmap.size < 3 * n:
            raise ValueError("TIFF ColorMap is shorter than its bit depth needs")
        palette = np.zeros((256, 3), np.uint8)
        palette[:min(n, 256)] = (cmap[:3 * n].reshape(3, n).T // 256)[:256].astype(np.uint8)
    elif raw == "RGBa":
        a = s[..., 3:4].astype(np.int64)
        c = np.minimum(s[..., :3].astype(np.int64) * 255 // np.maximum(a, 1), 255)
        c = np.where(a == 255, s[..., :3], c)
        px = np.where(a == 0, 0, np.concatenate([c, a], -1)).astype(np.uint8)
    else:
        px = s[..., :{"LA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4}[mode]]
    orientation = t.tags.get(274, (1,))[0]
    if orientation in _TRANSPOSE:
        px = _TRANSPOSE[orientation](px)
    return np.ascontiguousarray(px), mode, palette
