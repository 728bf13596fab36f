"""OCR engines of the deep-parse rung: port of `morphik_core_tpu/parser/ocr.py`.

A page is a decoded (H, W, 3) uint8 array (the reference passes PIL
images):

  - `ApiOCR`: POSTs the page as PNG bytes (`encode_png`, a raw body of
    type image/png) to a remote OCR endpoint and reads `{"text": ...}`
    back; with `tables=True` the URL carries `tables=true` and the answer
    may add `{"tables": ["| markdown | table |", ...]}`.
  - `CallableOCR`: wraps any page -> text callable (tests, local engines).
  - `TesseractOCR`: pytesseract, probed when built (neither machine has it).
  - `get_ocr_engine(settings)`: the engine `parser.ocr_mode` selects, or
    None (OCR off) with the reference's log lines when it is
    misconfigured or its engine is missing.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Callable, List, Optional

import numpy as np

from morphik_core_tpu_torch.completion._http import post_bytes
from morphik_core_tpu_torch.utils.png import encode_png

logger = logging.getLogger(__name__)


class BaseOCR:
    async def image_to_text(self, image: np.ndarray) -> str:
        raise NotImplementedError

    async def images_to_text(self, images: List[np.ndarray]) -> List[str]:
        return [await self.image_to_text(im) for im in images]

    async def image_to_structured(self, image: np.ndarray) -> dict:
        """Text and extracted tables of one page; an engine without table
        structure gives {"text": ..., "tables": []}."""
        return {"text": await self.image_to_text(image), "tables": []}

    async def images_to_structured(self, images: List[np.ndarray]) -> List[dict]:
        return [await self.image_to_structured(im) for im in images]


class CallableOCR(BaseOCR):
    def __init__(self, fn: Callable[[np.ndarray], str]):
        self.fn = fn

    async def image_to_text(self, image: np.ndarray) -> str:
        out = self.fn(image)
        if asyncio.iscoroutine(out):
            out = await out
        return out or ""


class ApiOCR(BaseOCR):
    """POST PNG bytes to `endpoint`; JSON {"text": "..."} back, plus
    {"tables": [...]} when the request carries tables=true."""

    def __init__(self, endpoint: str, api_key: Optional[str] = None, timeout_s: float = 120.0,
                 tables: bool = False):
        self.endpoint = endpoint.rstrip("/")
        self.api_key = api_key
        self.timeout_s = timeout_s
        self.tables = bool(tables)

    def _post_sync(self, png: bytes) -> dict:
        headers = {"Content-Type": "image/png"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        # '&' when the endpoint already carries a query string (a key in the
        # URL): a second '?' would corrupt its first parameter
        sep = "&" if "?" in self.endpoint else "?"
        url = self.endpoint + (f"{sep}tables=true" if self.tables else "")
        payload = json.loads(post_bytes(url, png, headers, self.timeout_s).decode())
        if not isinstance(payload, dict):
            return {"text": "", "tables": []}
        tables = payload.get("tables") or []
        if not isinstance(tables, list):
            tables = []
        return {"text": payload.get("text", "") or "", "tables": [str(t) for t in tables]}

    async def image_to_structured(self, image: np.ndarray) -> dict:
        return await asyncio.to_thread(self._post_sync, encode_png(image))

    async def image_to_text(self, image: np.ndarray) -> str:
        return (await self.image_to_structured(image))["text"]


class TesseractOCR(BaseOCR):
    """Local OCR through pytesseract (and the `tesseract` binary), which
    takes numpy arrays as it takes PIL images."""

    def __init__(self):
        import pytesseract  # noqa: PLC0415 — the availability probe

        self._tess = pytesseract

    async def image_to_text(self, image: np.ndarray) -> str:
        return await asyncio.to_thread(self._tess.image_to_string, image)


def get_ocr_engine(settings) -> Optional[BaseOCR]:
    """The configured OCR engine, or None when OCR is off or unavailable
    (the ladder then records a document without text as unsearchable)."""
    mode = getattr(settings.parser, "ocr_mode", "none")
    if mode == "none":
        return None
    if mode == "api":
        ep = settings.parser.ocr_api_endpoint
        if not ep:
            logger.warning("ocr_mode=api but no ocr_api_endpoint configured — OCR disabled")
            return None
        return ApiOCR(ep, api_key=getattr(settings.parser, "ocr_api_key", None),
                      tables=getattr(settings.parser, "ocr_tables", True))
    if mode in ("auto", "tesseract"):
        try:
            return TesseractOCR()
        except Exception as e:  # noqa: BLE001 — pytesseract missing or broken: OCR off, as in the reference
            if mode == "tesseract":
                logger.warning("ocr_mode=tesseract but the pytesseract probe failed (%s) — OCR disabled", e)
            else:
                logger.info("ocr_mode=auto: pytesseract probe failed (%s) — no local OCR", e)
            return None
    logger.warning("unknown ocr_mode %r — OCR disabled", mode)
    return None
