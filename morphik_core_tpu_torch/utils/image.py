"""Page and query images from their bytes, as Pillow's
`Image.open(...).load()` holds them.

`sniff` walks Pillow 12.1's plugins in the order `Image.open` tries them:
first the ones `preinit()` registers (BMP, DIB, GIF, JPEG, PPM, PNG), then
the rest in `Image.ID` order. A plugin whose `accept` passes the first
16 bytes (or, for the five without one, whose `_open` would pass the
whole file) claims the file unless its `_open` gives up with the
exceptions `Image.open` moves on from (`jpeg.NotThisFormat`, IndexError,
struct.error, KeyError, TypeError); any other error is the file's. The
formats the port decodes: PNG (`utils/png.py`), JPEG (`utils/jpeg.py`),
GIF (`gif.py`), BMP and DIB (`bmp.py`), TIFF (`tiff.py`), WebP (`webp.py`),
Netpbm (`ppm.py`), ICO and CUR (`ico.py`), PSD (`psd.py`), PCX and DCX
(`pcx.py`), TGA (`tga.py`), SGI (`sgi.py`), Sun raster (`sun.py`), QOI
(`qoi.py`), XBM and XPM (`xbm.py`), JPEG 2000 (`jpeg2000.py`: JP2, JPH
and raw codestreams, Part 1, HTJ2K and the Part 2 OpenJPEG reads; its
tier-1 runs on the card, K5, and its HT blocks, K6; a codestream Pillow
opens but OpenJPEG fails fails the decode, never the probe). A file
another plugin claims (AVIF, DDS, ...) raises `UnsupportedImage` naming
it and ROADMAP Queue 1 item 3b-ii; in particular a TGA-shaped file that
an earlier plugin claims is never read as TGA. Bytes no plugin claims raise
`UnidentifiedImage`.

`probe_image` reads headers only and also raises `DecompressionBombError`
above Pillow's limit (twice `Image.MAX_IMAGE_PIXELS`), which
`Image.open` raises for the reference; a header can claim any size.
"""

from __future__ import annotations

import re
import struct
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from morphik_core_tpu_torch.models.colqwen.preprocess import to_rgb_u8
from morphik_core_tpu_torch.utils import ico, jp2_codestream, pcx, ppm, psd, qoi, sgi, sun, tga, xbm
from morphik_core_tpu_torch.utils.bmp import dib_accept, probe_bmp, probe_dib, read_bmp, read_dib
from morphik_core_tpu_torch.utils.gif import probe_gif, read_gif
from morphik_core_tpu_torch.utils.jpeg2000 import probe_jpeg2000, read_jpeg2000
from morphik_core_tpu_torch.utils.jpeg import (NotThisFormat, UnsupportedImage, UnsupportedJpeg, open_jpeg,
                                               probe_jpeg, read_jpeg)
from morphik_core_tpu_torch.utils.png import MAX_PIXELS, SIGNATURE, open_png, read_png, text_comment
from morphik_core_tpu_torch.utils.tiff import probe_tiff, read_tiff
from morphik_core_tpu_torch.utils.webp import probe_webp, read_webp

__all__ = ["DecompressionBombError", "UnidentifiedImage", "UnsupportedImage", "UnsupportedJpeg", "decode_image",
           "open_image", "pillow_comment", "probe_image", "read_image", "sniff"]


class DecompressionBombError(UnsupportedImage):
    """Pillow's `Image.DecompressionBombError`, with its words."""

    def __init__(self, pixels: int):
        ValueError.__init__(self, f"Image size ({pixels} pixels) exceeds limit of {MAX_PIXELS} pixels, "
                                  "could be decompression bomb DOS attack.")
        self.open_fails = True


class UnidentifiedImage(ValueError):
    """Bytes no Pillow plugin claims (Pillow's `UnidentifiedImageError`)."""

    def __init__(self):
        super().__init__("not a PNG, JPEG, GIF, BMP, TIFF, WebP, Netpbm, ICO, CUR, PSD, PCX, TGA, SGI, Sun, QOI, "
                         "XBM, XPM or JPEG 2000 file, nor one any other Pillow plugin identifies "
                         "(ROADMAP Queue 1 item 3b-ii)")


def _png_probe(data: bytes) -> Tuple[int, int]:
    if len(data) < 24 or data[12:16] != b"IHDR":
        raise ValueError("PNG has no IHDR chunk")
    return struct.unpack(">II", data[16:24])




def _jpeg_read(data: bytes):
    pixels, mode = read_jpeg(data)
    return pixels, mode, None


_TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00")


def _tiff_probe(data: bytes) -> Tuple[int, int]:
    if data[:4] in (b"MM\x2a\x00", b"II\x00\x2a"):
        raise UnsupportedImage("TIFF with a byte-swapped magic number")
    return probe_tiff(data)


def _i32le(b: bytes, at: int = 0) -> int:
    return struct.unpack("<I", b[at:at + 4])[0] if len(b) >= at + 4 else -1


def _i32be(b: bytes, at: int = 0) -> int:
    return struct.unpack(">I", b[at:at + 4])[0] if len(b) >= at + 4 else -1


def _i16le(b: bytes, at: int) -> int:
    return struct.unpack("<H", b[at:at + 2])[0] if len(b) >= at + 2 else -1


# the plugins the port decodes: accept on the 16-byte prefix, probe, read
_PORTED: Dict[str, Tuple[Callable, Callable, Callable]] = {
    "BMP": (lambda p: p.startswith(b"BM"), probe_bmp, read_bmp),
    "DIB": (dib_accept, probe_dib, read_dib),
    "GIF": (lambda p: p.startswith((b"GIF87a", b"GIF89a")), probe_gif, read_gif),
    "JPEG": (lambda p: p.startswith(b"\xff\xd8\xff"), open_jpeg, _jpeg_read),
    "JPEG2000": (jp2_codestream.accept, probe_jpeg2000, read_jpeg2000),
    "PPM": (ppm.accept, ppm.probe_ppm, ppm.read_ppm),
    "PNG": (lambda p: p.startswith(SIGNATURE), _png_probe, read_png),
    "CUR": (lambda p: p.startswith(ico.CUR_MAGIC), ico.probe_cur, ico.read_cur),
    "PCX": (pcx.accept, pcx.probe_pcx, pcx.read_pcx),
    "DCX": (pcx.dcx_accept, pcx.probe_dcx, pcx.read_dcx),
    "ICO": (lambda p: p.startswith(ico.ICO_MAGIC), ico.probe_ico, ico.read_ico),
    "TIFF": (lambda p: p.startswith(_TIFF_PREFIXES), _tiff_probe, read_tiff),
    "PSD": (lambda p: p.startswith(b"8BPS"), psd.probe_psd, psd.read_psd),
    "QOI": (qoi.accept, qoi.probe_qoi, qoi.read_qoi),
    "SGI": (sgi.accept, sgi.probe_sgi, sgi.read_sgi),
    "SUN": (sun.accept, sun.probe_sun, sun.read_sun),
    "TGA": (lambda p: True, tga.probe_tga, tga.read_tga),
    "WEBP": (lambda p: p.startswith(b"RIFF") and p[8:12] == b"WEBP" and p[12:16] in (b"VP8 ", b"VP8X", b"VP8L"),
             probe_webp, read_webp),
    "XBM": (xbm.xbm_accept, xbm.probe_xbm, xbm.read_xbm),
    "XPM": (xbm.xpm_accept, xbm.probe_xpm, xbm.read_xpm),
}

def _gbr_claims(data: bytes) -> bool:
    """`GbrImageFile._open` passes: its accept (a header of 20+ bytes,
    version 1 or 2) matches the first bytes of a QOI or Sun file 1 or 2
    pixels wide, and only the rest of its checks let those through."""
    if len(data) < 20:
        return False
    size, version, w, h, depth = struct.unpack(">5I", data[:20])
    return size >= 20 and version in (1, 2) and w and h and depth in (1, 4) and (version == 1 or data[20:24] == b"GIMP")


# the plugins the port refuses: Pillow's accept (on bytes that start with its 16-byte
# prefix; GBR's whole `_open`), and the words of the refusal
_REFUSED: Dict[str, Tuple[Callable, str]] = {
    "AVIF": (lambda p: p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1", b"msf1"), "AVIF"),
    "BLP": (lambda p: p.startswith((b"BLP1", b"BLP2")), "BLP (Blizzard mipmap)"),
    "BUFR": (lambda p: p.startswith((b"BUFR", b"ZCZC")), "BUFR"),
    "DDS": (lambda p: p.startswith(b"DDS "), "DDS"),
    "EPS": (lambda p: p.startswith(b"%!PS") or _i32le(p) == 0xC6D3D0C5, "EPS"),
    "FITS": (lambda p: p.startswith(b"SIMPLE"), "FITS"),
    "FLI": (lambda p: len(p) >= 16 and _i16le(p, 4) in (0xAF11, 0xAF12) and _i16le(p, 14) in (0, 3), "FLI / FLC"),
    "FTEX": (lambda p: p.startswith(b"FTEX"), "FTEX"),
    "GBR": (_gbr_claims, "GIMP brush (GBR)"),
    "GRIB": (lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1, "GRIB"),
    "HDF5": (lambda p: p.startswith(b"\x89HDF\r\n\x1a\n"), "HDF5"),
    "ICNS": (lambda p: p.startswith(b"icns"), "ICNS"),
    "MCIDAS": (lambda p: p.startswith(b"\x00\x00\x00\x00\x00\x00\x00\x04"), "McIdas area"),
    "MPEG": (lambda p: p.startswith(b"\x00\x00\x01\xb3"), "MPEG"),
    "MSP": (lambda p: p.startswith((b"DanM", b"LinS")), "MSP (Windows Paint)"),
    "PIXAR": (lambda p: p.startswith(b"\x80\xe8\x00\x00"), "PIXAR raster"),
    "WMF": (lambda p: p.startswith((b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00")), "WMF / EMF"),
    "XVTHUMB": (lambda p: p.startswith(b"P7 332"), "XV thumbnail"),
}

_IM_LINE = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = {b"Comment", b"Date", b"Digitalization equipment", b"File size (no of images)", b"Lut", b"Name",
            b"Scale (x,y)", b"Image size (x*y)", b"Image type"}
_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _im_claims(data: bytes) -> bool:
    """`ImImageFile._open` up to the point where it has a tag line."""
    if b"\n" not in data[:100]:
        return False
    pos, tags = 0, 0
    while True:
        s = data[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s, pos = s + data[pos:end], end
        if len(s) > 100:
            return False
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _IM_LINE.match(s)
        if not m:
            return False
        tags += m.group(1) in _IM_TAGS
    return tags > 0


def _imt_claims(data: bytes) -> bool:
    """`ImtImageFile._open`: width, height and "pixel n8" before its
    form feed."""
    if b"\n" not in data[:100]:
        return False
    w = h = 0
    mode = False
    pos = 0
    while pos < len(data):
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end
        line, pos = data[pos:end], end + 1
        if line[:1] == b"\x0c" or not line or len(line) > 100:
            break
        if line[:1] == b"*":
            continue
        m = _IMT_FIELD.match(line)
        if not m:
            break
        k, v = m.groups()
        try:
            if k == b"width":
                w = int(v)
            elif k == b"height":
                h = int(v)
        except ValueError:
            return True   # the plugin's own error: it has claimed the file
        mode = mode or (k == b"pixel" and v == b"n8")
    return mode and w > 0 and h > 0


def _iptc_claims(data: bytes) -> bool:
    """`IptcImageFile._open` up to its compression check: records of 0x1C,
    a record number, a dataset and a length, until five zero bytes or
    dataset 8:10; a layers / component record (3:60) and a width and
    height (3:20, 3:30)."""
    info, pos = {}, 0
    while True:
        s = data[pos:pos + 5]
        pos += len(s)
        if not s.strip(b"\x00"):
            break
        if len(s) < 5 or s[0] != 0x1C or s[1] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            return False
        size = s[3]
        if size > 132:
            return True   # the plugin's own OSError: it has claimed the file
        if size == 128:
            size = 0
        elif size > 128:
            size = int.from_bytes(data[pos:pos + size - 128], "big")
            pos += size - 128
        else:
            size = struct.unpack(">H", s[3:5])[0]
        if (s[1], s[2]) == (8, 10):
            break
        info[(s[1], s[2])] = data[pos:pos + size] if size else None
        pos += len(info[(s[1], s[2])] or b"")
    layers = info.get((3, 60))
    return bool(layers) and len(layers) >= 2 and bool(info.get((3, 20))) and bool(info.get((3, 30)))


def _spider_claims(data: bytes) -> bool:
    """`SpiderImageFile._open`'s header check (27 floats, either order)."""
    if len(data) < 108:
        return False

    def is_int(f: float) -> bool:
        try:
            return f - int(f) == 0
        except (ValueError, OverflowError):
            return False

    for order in (">", "<"):
        h = (99,) + struct.unpack(order + "27f", data[:108])
        if not all(is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
            continue
        if int(h[5]) not in (1, 3, -11, -12, -21, -22) or int(h[22]) != int(h[13]) * int(h[23]) or not int(h[22]):
            continue
        return int(h[5]) == 1 and int(h[12]) > 0 and int(h[2]) > 0
    return False


_CLAIMS = {
    "IM": _im_claims,
    "IMT": _imt_claims,
    "IPTC": _iptc_claims,
    "PCD": lambda d: d[2048:2052] == b"PCD_" and len(d) >= 2048 + 1539,
    "SPIDER": _spider_claims,
}
_CLAIMS_WORDS = {"IM": "IM (LabEye)", "IMT": "IM Tools", "IPTC": "IPTC/NAA", "PCD": "Kodak PhotoCD",
                 "SPIDER": "SPIDER"}

_PREINIT = ("BMP", "DIB", "GIF", "JPEG", "PPM", "PNG")
_ID = ("AVIF", "BLP", "BMP", "DIB", "BUFR", "CUR", "PCX", "DCX", "DDS", "EPS", "FITS", "FLI", "FTEX", "GBR", "GIF",
       "GRIB", "HDF5", "PNG", "JPEG2000", "ICNS", "ICO", "IM", "IMT", "IPTC", "JPEG", "MCIDAS", "MPEG", "TIFF",
       "MSP", "PCD", "PIXAR", "PPM", "PSD", "QOI", "SGI", "SPIDER", "SUN", "TGA", "WEBP", "WMF", "XBM", "XPM",
       "XVTHUMB")
ORDER = _PREINIT + tuple(n for n in _ID if n not in _PREINIT)
_MOVE_ON = (NotThisFormat, IndexError, struct.error, KeyError, TypeError)


def sniff(data: bytes) -> str:
    """The name of the Pillow plugin that opens these bytes, among those
    the port decodes; raises `UnsupportedImage` when another plugin
    claims them, `UnidentifiedImage` when none does, or the claiming
    plugin's own error."""
    prefix = data[:16]
    for name in ORDER:
        if name in _PORTED:
            accept, probe, _ = _PORTED[name]
            if not accept(prefix):
                continue
            try:
                probe(data)
            except _MOVE_ON:
                continue
            return name
        if name in _REFUSED:
            accept, words = _REFUSED[name]
            if accept(data):
                raise UnsupportedImage(f"{words} image")
        elif _CLAIMS[name](data):
            raise UnsupportedImage(f"{_CLAIMS_WORDS[name]} image")
    raise UnidentifiedImage()


def open_image(data: bytes) -> str:
    """`Image.open`'s stage, the first of the two where Pillow can fail:
    the sniff, the claiming plugin's `_open` (its headers, the
    decompression-bomb check; for PNG the chunks before IDAT and their
    text limits, for WebP libwebp's check that the container is whole,
    for ICO the whole decode, which its `_open` runs). -> the plugin's
    name; raises as `sniff` does, `DecompressionBombError`, or ValueError.
    What `read_image` raises past it is `load`'s."""
    name = sniff(data)
    size = _PORTED[name][1](data)
    if size[0] * size[1] > MAX_PIXELS:
        raise DecompressionBombError(size[0] * size[1])
    if name == "PNG":
        open_png(data)
    elif name == "WEBP" and 8 + _i32le(data, 4) > len(data):
        raise ValueError("could not create decoder object (the WebP container runs past the data)")
    elif name == "ICO":
        ico.read_ico(data)
    return name


def probe_image(data: bytes) -> Tuple[int, int]:
    """(width, height) from the headers; raises as the module says, and
    `UnsupportedImage` where the port would refuse to decode what Pillow
    opens (a JPEG's scans are read for that)."""
    name = open_image(data)
    if name == "JPEG":
        probe_jpeg(data)
    return _PORTED[name][1](data)


def read_image(data: bytes, device=None) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """-> (pixels, mode, palette) as Pillow's `Image.open(...).load()`
    holds them. `device` is where a JPEG 2000's block decoding and
    reconstruction run (unset: the card, `device.default_device()`); every
    other format decodes on the host."""
    name = open_image(data)
    if name == "JPEG2000":
        return read_jpeg2000(data, device)
    return _PORTED[name][2](data)


def decode_image(data: bytes, device=None) -> np.ndarray:
    """Image bytes -> (H, W, 3) uint8, as Pillow's `convert("RGB")`."""
    return to_rgb_u8(*read_image(data, device))


def _jpeg_comment(data: bytes) -> bytes:
    """`JpegImagePlugin`: the last COM segment before the first SOS."""
    comment, pos = b"", 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        code = data[pos + 1]
        if code == 0xFF or 0xD0 <= code <= 0xD8 or code == 0x01:
            pos += 1 if code == 0xFF else 2
            continue
        if code in (0xDA, 0xD9):
            break
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if code == 0xFE:
            comment = data[pos + 4:pos + 2 + length]
        pos += 2 + length
    return comment


def _gif_comment(data: bytes) -> bytes:
    """`GifImageFile._seek(0)`: the comment extensions before the first
    image descriptor, their sub-blocks joined, several joined by a newline."""
    comments = []
    pos = 13 + (3 << ((data[10] & 7) + 1) if len(data) > 10 and data[10] & 0x80 else 0)
    while pos < len(data):
        s = data[pos]
        if s != 0x21:   # an image descriptor, the trailer or junk ends frame 0's header
            break
        label, pos = data[pos + 1], pos + 2
        blocks = []
        while pos < len(data) and data[pos]:
            blocks.append(data[pos + 1:pos + 1 + data[pos]])
            pos += 1 + data[pos]
        pos += 1
        if label == 0xFE:
            comments.append(b"".join(blocks))
    return b"\n".join(comments)


def pillow_comment(data: bytes) -> bytes:
    """`Image.open(...).info["comment"]` once loaded, for the formats whose
    plugins set it, JPEG, GIF, JPEG 2000 and PNG (b"" for the others and
    where there is none): Pillow's JPEG writer puts it in the page payload,
    a str (PNG's text) encoded as UTF-8."""
    try:
        name = sniff(data)
    except (UnsupportedImage, UnidentifiedImage, ValueError):
        return b""
    if name == "JPEG":
        return _jpeg_comment(data)
    if name == "GIF":
        return _gif_comment(data)
    if name == "JPEG2000":
        return jp2_codestream.pillow_comment(data)
    if name == "PNG":
        return (text_comment(data) or "").encode("utf-8")
    return b""
