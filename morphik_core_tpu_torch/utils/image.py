"""Page and query images from their bytes, by magic number: PNG
(`utils/png.py`) and baseline JPEG (`utils/jpeg.py`), the two image
formats the port decodes; anything else raises a `ValueError`."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from morphik_core_tpu_torch.models.colqwen.preprocess import to_rgb_u8
from morphik_core_tpu_torch.utils.jpeg import read_jpeg
from morphik_core_tpu_torch.utils.png import SIGNATURE, read_png


def read_image(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """-> (pixels, mode, palette) as Pillow's `Image.open` holds them."""
    if data[:8] == SIGNATURE:
        return read_png(data)
    if data[:3] == b"\xff\xd8\xff":
        pixels, mode = read_jpeg(data)
        return pixels, mode, None
    raise ValueError("not a PNG or JPEG file: the port decodes only these (ROADMAP Queue 1 item 3b-ii)")


def decode_image(data: bytes) -> np.ndarray:
    """PNG or JPEG bytes -> (H, W, 3) uint8, as Pillow's `convert("RGB")`."""
    return to_rgb_u8(*read_image(data))
