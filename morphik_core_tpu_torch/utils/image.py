"""Page and query images from their bytes, by magic number, as Pillow's
`Image.open(...).load()` holds them: PNG (`utils/png.py`), JPEG
(`utils/jpeg.py`), GIF (`utils/gif.py`), BMP (`utils/bmp.py`), TIFF
(`utils/tiff.py`) and WebP (`utils/webp.py`, `vp8.py`, `vp8l.py`).

`probe_image` reads headers only: it raises `UnsupportedImage` (or
`UnsupportedJpeg`) for a variant the port refuses, naming ROADMAP Queue 1
item 3b-ii, and `DecompressionBombError` above Pillow's limit (twice
`Image.MAX_IMAGE_PIXELS`), which `Image.open` raises for the reference; a
header can claim any size. Anything that is none of the six formats
raises a plain `ValueError`.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from morphik_core_tpu_torch.models.colqwen.preprocess import to_rgb_u8
from morphik_core_tpu_torch.utils.bmp import probe_bmp, read_bmp
from morphik_core_tpu_torch.utils.gif import probe_gif, read_gif
from morphik_core_tpu_torch.utils.jpeg import UnsupportedImage, UnsupportedJpeg, probe_jpeg, read_jpeg
from morphik_core_tpu_torch.utils.png import MAX_PIXELS, SIGNATURE, read_png
from morphik_core_tpu_torch.utils.tiff import probe_tiff, read_tiff
from morphik_core_tpu_torch.utils.webp import probe_webp, read_webp

__all__ = ["DecompressionBombError", "UnsupportedImage", "UnsupportedJpeg", "decode_image", "image_format",
           "probe_image", "read_image"]


class DecompressionBombError(UnsupportedImage):
    """Pillow's `Image.DecompressionBombError`, with its words."""

    def __init__(self, pixels: int):
        ValueError.__init__(self, f"Image size ({pixels} pixels) exceeds limit of {MAX_PIXELS} pixels, "
                                  "could be decompression bomb DOS attack.")


def image_format(data: bytes) -> Optional[str]:
    """"png", "jpeg", "gif", "bmp", "tiff" or "webp" from the magic
    number, else None."""
    if data[:8] == SIGNATURE:
        return "png"
    if data[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    if data[:2] == b"BM":
        return "bmp"
    if data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        return "tiff"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    return None


def _unknown() -> ValueError:
    return ValueError("not a PNG, JPEG, GIF, BMP, TIFF or WebP file: the port decodes only these "
                      "(ROADMAP Queue 1 item 3b-ii)")


def probe_image(data: bytes) -> Tuple[int, int]:
    """(width, height) from the headers; raises as the module says."""
    kind = image_format(data)
    if kind == "png":
        if len(data) < 24 or data[12:16] != b"IHDR":
            raise ValueError("PNG has no IHDR chunk")
        size = struct.unpack(">II", data[16:24])
    elif kind == "jpeg":
        size = probe_jpeg(data)[:2]
    elif kind == "gif":
        size = probe_gif(data)
    elif kind == "bmp":
        size = probe_bmp(data)
    elif kind == "tiff":
        size = probe_tiff(data)
    elif kind == "webp":
        size = probe_webp(data)
    else:
        raise _unknown()
    if size[0] * size[1] > MAX_PIXELS:
        raise DecompressionBombError(size[0] * size[1])
    return size


def read_image(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """-> (pixels, mode, palette) as Pillow's `Image.open` holds them."""
    kind = image_format(data)
    if kind is None:
        raise _unknown()
    if kind != "png":   # read_png checks its own limit
        probe_image(data)
    if kind == "png":
        return read_png(data)
    if kind == "jpeg":
        pixels, mode = read_jpeg(data)
        return pixels, mode, None
    return {"gif": read_gif, "bmp": read_bmp, "tiff": read_tiff, "webp": read_webp}[kind](data)


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes -> (H, W, 3) uint8, as Pillow's `convert("RGB")`."""
    return to_rgb_u8(*read_image(data))
