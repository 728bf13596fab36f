"""PCX and DCX in numpy: what Pillow's `PcxImagePlugin` (with `PcxDecode.c`)
and `DcxImagePlugin` hold after `Image.open(...).load()`.

Modes: 1 bit x 1 plane "1"; 1 bit x 2 or 4 planes "P" (the header's
16-entry palette, planes line-interleaved, `P;2L` / `P;4L`); version 5 at 8 bits x 1 plane "L",
or "P" when the file ends with a 0x0C marker and a 768-byte palette that
is not the gray ramp (looked for at the end of the whole file, a DCX's
too); version 5 at 8 bits x 3 planes "RGB". A row is `planes * stride`
bytes, stride ceil(width * bits / 8), made even when the header's own
stride differs. `PcxDecode.c` then moves each row's bands together
before unpacking: a 1-bit plane is read from its share of the row
(`row // planes`), padding included; an 8-bit RGB row is cut into
`bands = row // width` bands read from `i * (row // bands)` and
unpacked `width` bytes apart, so an RGB row 3 pixels wide (stride 4)
has its planes at bytes 0 / 3 / 6 and one 5 wide (stride 6) at 0 / 6 /
12. The RLE (a byte
0xC0 | n repeats the next n times, any other byte is itself) is found
with array operations: a byte after one below 0xC0 always starts a
token, so a run of high bytes pairs up from its start. A run past the
end of a row is an error (`IMAGING_CODEC_OVERRUN`). DCX: its first page.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from morphik_core_tpu_torch.utils.jpeg import NotThisFormat

DCX_MAGIC = 0x3ADE68B1


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[0] == 10 and prefix[1] in (0, 2, 3, 5)


def dcx_accept(prefix: bytes) -> bool:
    return len(prefix) >= 4 and struct.unpack("<I", prefix[:4])[0] == DCX_MAGIC


def _header(data: bytes, at: int, whole: bytes):
    s = data[at:at + 68]
    if not accept(s):
        raise NotThisFormat("not a PCX file")
    x0, y0, x1, y1 = struct.unpack("<4H", s[4:12])
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise NotThisFormat("bad PCX image size")
    version, bits, planes = s[1], s[3], s[65]
    provided = struct.unpack("<H", s[66:68])[0]
    palette = None
    if bits == 1 and planes == 1:
        mode = rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, rawmode = "P", f"P;{planes}L"
        palette = np.zeros((256, 3), np.uint8)
        palette[:16] = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = rawmode = "L"
        tail = whole[-769:] if len(whole) >= 769 else b""
        if len(tail) == 769 and tail[0] == 12:
            lut = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
            if not (lut == np.arange(256, dtype=np.uint8)[:, None]).all():
                mode = rawmode = "P"
                palette = lut.copy()
    elif version == 5 and bits == 8 and planes == 3:
        mode, rawmode = "RGB", "RGB;L"
    else:
        raise ValueError("unknown PCX mode")
    w, h = x1 + 1 - x0, y1 + 1 - y0
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    return mode, rawmode, (w, h), planes * stride, planes, at + 128, palette


def _dcx_first(data: bytes) -> int:
    if not dcx_accept(data[:4]):
        raise NotThisFormat("not a DCX file")
    first = struct.unpack("<I", data[4:8])[0]
    if not first:
        raise IndexError("DCX without pages")
    return first


def probe_pcx(data: bytes) -> Tuple[int, int]:
    return _header(data, 0, data)[2]


def probe_dcx(data: bytes) -> Tuple[int, int]:
    return _header(data, _dcx_first(data), data)[2]


def rle_decode(body: np.ndarray, need: int, row: int) -> np.ndarray:
    """`PcxDecode.c`'s bytes: the first `need` bytes the RLE gives, rows of
    `row` bytes, a run never crossing a row's end."""
    hi = body >= 0xC0
    n = len(body)
    # a token starts at 0 and after any byte below 0xC0; within a run of
    # high bytes from a token start, every other byte is a count
    idx = np.arange(n)
    starts = np.ones(n, bool)
    starts[1:] = ~hi[:-1]
    run_start = np.maximum.accumulate(np.where(starts | ~hi, idx, 0))
    is_count = hi & ((idx - run_start) % 2 == 0)
    is_value = np.zeros(n, bool)
    is_value[1:] = is_count[:-1]
    if n and is_count[-1]:
        is_count[-1] = False   # a count with no value byte: the data ends early
    single = ~is_count & ~is_value
    tok = np.flatnonzero(is_count | single)
    counts = np.where(is_count[tok], body[tok].astype(np.int64) & 0x3F, 1)
    values = body[np.where(is_count[tok], tok + 1, tok)]
    ends = np.cumsum(counts)
    begins = ends - counts
    last = np.searchsorted(ends, need)   # the token that fills the image
    if last >= len(counts):
        raise ValueError("PCX data ends early: image file is truncated")
    counts, begins, values = counts[:last + 1], begins[:last + 1], values[:last + 1]
    crossing = (counts > 0) & (begins // row != (begins + counts - 1) // row)
    if crossing.any():
        raise ValueError("PCX run past the end of a row: buffer overrun when reading image file")
    return np.repeat(values, counts)[:need]


def _pixels(data: bytes, rawmode: str, w: int, h: int, nbytes: int, planes: int, offset: int) -> np.ndarray:
    flat = rle_decode(np.frombuffer(data, np.uint8)[offset:], nbytes * h, nbytes)
    rows = flat.reshape(h, nbytes)
    if rawmode == "RGB;L" and nbytes % w:   # PcxDecode.c's band move, band 0 in place
        bands = nbytes // w
        band = nbytes // bands
        rows = rows.copy()
        for i in range(1, bands):
            rows[:, i * w:(i + 1) * w] = rows[:, i * band:i * band + w]
    if rawmode == "1":
        return (np.unpackbits(rows, axis=1)[:, :w] * 255).astype(np.uint8)
    if rawmode == "L" or rawmode == "P":
        return np.ascontiguousarray(rows[:, :w])
    if rawmode == "RGB;L":
        return np.ascontiguousarray(np.stack([rows[:, k * w:(k + 1) * w] for k in range(3)], -1))
    ps = nbytes // planes
    idx = np.zeros((h, w), np.uint8)
    for p in range(planes):
        idx |= (np.unpackbits(rows[:, p * ps:(p + 1) * ps], axis=1)[:, :w] << p).astype(np.uint8)
    return idx


def _read(data: bytes, at: int) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    mode, rawmode, (w, h), nbytes, planes, offset, palette = _header(data, at, data)
    return _pixels(data, rawmode, w, h, nbytes, planes, offset), mode, palette


def read_pcx(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """PCX bytes -> (pixels, mode, palette): "1" (0 / 255), "L", "P" (H, W),
    "RGB" (H, W, 3) uint8; `palette` (256, 3) for "P"."""
    return _read(data, 0)


def read_dcx(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """DCX bytes -> the first page, as `read_pcx`."""
    return _read(data, _dcx_first(data))
