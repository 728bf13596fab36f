"""QOI in numpy: what Pillow's `QoiImagePlugin` (its Python `QoiDecoder`)
holds after `Image.open(...).load()`: "RGB" for 3 channels, else "RGBA".

The decoder's own rules, which differ from the reference QOI decoder in
two places: a run does not enter its pixel into the index (so a run at
the start leaves the initial (0, 0, 0, 255) out of it), and an index
slot never written reads as (0, 0, 0, 0). Ops are read one at a time;
the ops of a page are mostly runs, so a page's cost is its ops, not its
pixels.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from morphik_core_tpu_torch.utils.jpeg import NotThisFormat


def accept(prefix: bytes) -> bool:
    return prefix.startswith(b"qoif")


def _header(data: bytes):
    if not accept(data[:4]):
        raise NotThisFormat("not a QOI file")
    w, h = struct.unpack(">II", data[4:12])
    mode = "RGB" if data[12] == 3 else "RGBA"
    if w <= 0 or h <= 0:
        raise NotThisFormat("an image of no pixels")
    return mode, (w, h)


def probe_qoi(data: bytes) -> Tuple[int, int]:
    return _header(data)[1]


def read_qoi(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """QOI bytes -> (pixels, mode, None): (H, W, 3) or (H, W, 4) uint8."""
    mode, (w, h) = _header(data)
    total = w * h
    seen = [None] * 64
    prev = (0, 0, 0, 255)
    # each op's pixel and how many times it repeats
    values, counts = [], []
    have = 0
    pos, n = 14, len(data)
    try:
        while have < total:
            b = data[pos]
            pos += 1
            if b == 0xFE:
                r, g, bl = data[pos:pos + 3]
                pos += 3
                px = (r, g, bl, prev[3])
            elif b == 0xFF:
                px = tuple(data[pos:pos + 4])
                pos += 4
                if len(px) < 4:
                    raise IndexError
            else:
                op = b >> 6
                if op == 0:
                    px = seen[b & 63] or (0, 0, 0, 0)
                elif op == 1:
                    px = ((prev[0] + (b >> 4 & 3) - 2) % 256, (prev[1] + (b >> 2 & 3) - 2) % 256,
                          (prev[2] + (b & 3) - 2) % 256, prev[3])
                elif op == 2:
                    b2 = data[pos]
                    pos += 1
                    dg = (b & 63) - 32
                    px = ((prev[0] + dg + (b2 >> 4) - 8) % 256, (prev[1] + dg) % 256,
                          (prev[2] + dg + (b2 & 15) - 8) % 256, prev[3])
                else:
                    run = (b & 63) + 1
                    values.append(prev)
                    counts.append(run)
                    have += run
                    continue
            prev = px
            seen[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64] = px
            values.append(px)
            counts.append(1)
            have += 1
    except (IndexError, ValueError) as e:
        raise ValueError("QOI data ends before the image: image file is truncated") from e
    px = np.repeat(np.array(values, np.uint8).reshape(-1, 4), counts, axis=0)[:total]
    px = px.reshape(h, w, 4)
    return np.ascontiguousarray(px[..., :3] if mode == "RGB" else px), mode, None
