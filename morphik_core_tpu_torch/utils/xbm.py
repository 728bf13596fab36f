"""X bitmaps and pixmaps in numpy: what Pillow's `XbmImagePlugin` (with
`XbmDecode.c`) and `XpmImagePlugin` hold after `Image.open(...).load()`.

XBM: the plugin's header expression over the first 512 bytes (width and
height defines, an optional hot spot, up to the last `_bits[]` there);
then each byte is the two characters after the next `x` read as hex (a
character that is not a hex digit counts 0), its bits least significant
first, rows padded to bytes, a set bit 255 in mode "1".

XPM: the header string `"w h ncolors cpp"` on the first line after the
magic that starts with it, then one colour line per entry whose first
`c` key is `#` hex (read as an integer, its low 24 bits taken) or
`None` (kept out of the palette: a pixel naming it is an error, as the
decoder's lookup fails); a colour name is an error. Up to 256 colours
give "P" (the palette in line order), more give "RGB". Pixel lines are
the text between the first and last quote of each line, a first
`/* pixels */` line skipped, keys of `cpp` characters taken in one
stream (a long line runs on into the next row).
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import numpy as np

from morphik_core_tpu_torch.utils.jpeg import NotThisFormat, UnsupportedImage

_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')
_HEX = np.zeros(256, np.uint8)
for _c in b"0123456789":
    _HEX[_c] = _c - 48
for _c in b"abcdef":
    _HEX[_c] = _HEX[_c - 32] = _c - 87


def xbm_accept(prefix: bytes) -> bool:
    return prefix.lstrip().startswith(b"#define")


def xpm_accept(prefix: bytes) -> bool:
    return prefix.startswith(b"/* XPM */")


def _xbm_header(data: bytes):
    m = _XBM_HEAD.match(data[:512])
    if not m:
        raise NotThisFormat("not a XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    if w <= 0 or h <= 0:
        raise NotThisFormat("an image of no pixels")
    return (w, h), m.end()


def probe_xbm(data: bytes) -> Tuple[int, int]:
    return _xbm_header(data)[0]


def read_xbm(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """XBM bytes -> (pixels, "1", None): (H, W) uint8, 0 / 255."""
    (w, h), pos = _xbm_header(data)
    row = (w + 7) // 8
    need = row * h
    body = np.frombuffer(data, np.uint8)[pos:]
    xs = np.flatnonzero(body == ord("x"))
    # the C decoder skips to an `x`, reads the two bytes after it, then
    # looks for the next `x` from the byte after those two
    picked, nxt = [], 0
    for x in xs.tolist():
        if x < nxt:
            continue
        if x + 3 > len(body):
            break
        picked.append(x)
        nxt = x + 3
        if len(picked) == need:
            break
    if len(picked) < need:
        raise ValueError("XBM data ends early: image file is truncated")
    at = np.array(picked, np.int64)
    vals = (_HEX[body[at + 1]] << 4 | _HEX[body[at + 2]]).astype(np.uint8)
    bits = np.unpackbits(vals.reshape(h, row), axis=1, bitorder="little")[:, :w]
    return (bits * 255).astype(np.uint8), "1", None


def _xpm_header(data: bytes):
    if not xpm_accept(data[:9]):
        raise NotThisFormat("not an XPM file")
    parts = data[9:].split(b"\n")   # `readline` ends a line at LF only
    lines = [p + b"\n" for p in parts[:-1]] + ([parts[-1]] if parts[-1] else [])
    i = 0
    while True:
        if i >= len(lines):
            raise NotThisFormat("broken XPM file")
        m = _XPM_HEAD.match(lines[i])
        i += 1
        if m:
            break
    w, h, ncolors, cpp = (int(g) for g in m.groups())
    palette = {}
    for _ in range(ncolors):
        line = lines[i].rstrip() if i < len(lines) else b""
        i += 1
        key = line[1:cpp + 1]
        s = line[cpp + 1:-2].split()
        for j in range(0, len(s), 2):
            if s[j] == b"c":
                rgb = s[j + 1]
                if rgb == b"None":
                    pass
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    palette[key] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                else:
                    raise ValueError("cannot read this XPM file (a colour name)")
                break
        else:
            raise ValueError("cannot read this XPM file (no colour key)")
    mode = "RGB" if ncolors > 256 else "P"
    if w <= 0 or h <= 0:
        raise NotThisFormat("an image of no pixels")
    return (w, h), mode, cpp, palette, lines[i:]


def probe_xpm(data: bytes) -> Tuple[int, int]:
    return _xpm_header(data)[0]


def read_xpm(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """XPM bytes -> (pixels, mode, palette): "P" (H, W) with its (256, 3)
    palette, or "RGB" (H, W, 3) uint8."""
    (w, h), mode, cpp, palette, lines = _xpm_header(data)
    keys = list(palette)
    need = w * h
    texts, have = [], 0
    header_seen = False
    for line in lines:
        if have >= need:
            break
        if line.rstrip() == b"/* pixels */" and not header_seen:
            header_seen = True
            continue
        text = b'"'.join(line.split(b'"')[1:-1])
        if len(text) % cpp:   # a short key at the line's end names no colour
            raise ValueError("XPM pixel line of a partial key")
        texts.append(text)
        have += len(text) // cpp
    if have < need:
        raise ValueError("XPM data ends early: not enough image data")
    if cpp > 7:
        raise UnsupportedImage(f"XPM with {cpp} characters a pixel")
    # each key as one integer; a key not in the palette is an error
    stream = np.frombuffer(b"".join(texts), np.uint8).reshape(-1, cpp).astype(np.int64)
    weights = np.int64(256) ** np.arange(cpp - 1, -1, -1, dtype=np.int64)
    codes = stream @ weights
    known = np.array([int.from_bytes(k, "big") if len(k) == cpp else -1 for k in keys], np.int64)
    order = np.argsort(known, kind="stable")
    at = np.clip(np.searchsorted(known[order], codes), 0, max(len(keys) - 1, 0))
    if not keys or (known[order][at] != codes).any():
        raise ValueError("XPM pixel names no colour of the palette")
    idx = order[at][:need].reshape(h, w)
    lut = np.zeros((max(256, len(keys)), 3), np.uint8)
    if keys:
        lut[:len(keys)] = np.array([palette[k] for k in keys], np.uint8)
    if mode == "RGB":
        return np.ascontiguousarray(lut[idx]), mode, None
    return idx.astype(np.uint8), mode, lut[:256]
