"""Process-pool PDF rasterization: port of
`morphik_core_tpu/parser/raster_pool.py`.

Page ranges are fanned out across worker processes, each returning per
page the q70 JPEG payload (at most 1024 px wide, LANCZOS) and, in prep
mode, the blank flag and the tower's u8 patches computed from the
decoded payload (`jpeg.decode_own`: the pixels a decode of the stored
JPEG gives, without a Huffman decode). Below `_MIN_PAGES_FOR_POOL`
pages, or with one process, pages run in threads instead. Each page is
its own task (the reference hands each process a page range): the
ingest path takes the pages in order through a `PageStream`, which
bounds how many pages' patches are held at once.

Pages come from the text-render rung (`pdf.rasterize_pdf`'s); a page
that fails is skipped and the others keep their true page indices, as
the reference's per-page skip does. The workers are forkserver children
that import only this package's numpy modules: no torch, and so no
CUDA context, is ever made in them.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import logging
import os
from typing import List, Optional

import numpy as np

from morphik_core_tpu_torch.models.colqwen.preprocess import is_blank_page, preprocess_array_u8, resize_lanczos_u8
from morphik_core_tpu_torch.parser.pdf import extract_pages_text
from morphik_core_tpu_torch.parser.text_render import render_text_page
from morphik_core_tpu_torch.utils.jpeg import decode_own, encode_jpeg

logger = logging.getLogger(__name__)

_JPEG_QUALITY = 70
_MAX_WIDTH = 1024
_MIN_PAGES_FOR_POOL = 4  # pool overhead isn't worth it below this


def _resize(img: np.ndarray, max_width: int) -> np.ndarray:
    h, w = img.shape[:2]
    if w > max_width:
        return resize_lanczos_u8(img, (int(h * max_width / w), max_width))
    return img


def _finish_page(i: int, img: np.ndarray, max_width: int, prep):
    """One page's artifacts from its (H, W, 3) uint8 render.

    prep=None -> (i, jpeg); prep=(min_pixels, max_pixels) -> (i, jpeg,
    patches, grid, blank), the blank check and the patches taken on the
    decoded payload, as the stored embeddings must match what a query of
    the stored page sees."""
    jpeg, coeffs = encode_jpeg(_resize(img, max_width), _JPEG_QUALITY)
    if prep is None:
        return (i, jpeg)
    stored = decode_own(coeffs)
    if is_blank_page(stored):
        return (i, jpeg, None, None, True)
    patches, grid = preprocess_array_u8(stored, min_pixels=prep[0], max_pixels=prep[1])
    return (i, jpeg, patches, grid, False)


def _raster_page(i: int, text: str, dpi: int, max_width: int, prep) -> Optional[tuple]:
    """Worker: one page's `_finish_page` artifacts, or None when the page
    fails (logged; the page is skipped)."""
    try:
        return _finish_page(i, render_text_page(text, dpi), max_width, prep)
    except Exception as e:  # a per-page failure skips the page
        logger.warning("page %d of the PDF failed to rasterize (%s); skipped", i, e)
        return None


class PageStream:
    """A PDF's pages rastered in page order, `_finish_page` tuples of the
    pages that did not fail. With a `window`, at most that many pages are
    rastered and not yet `release`d: the consumer releases a page once its
    artifacts are dropped, which bounds the patches resident at once."""

    def __init__(self, executor, texts: List[str], dpi: int, max_width: int, prep, window: Optional[int]):
        self._sem = asyncio.Semaphore(window) if window else None
        self._queue: asyncio.Queue = asyncio.Queue()
        self.seconds = 0.0
        self._producer = asyncio.ensure_future(self._produce(executor, texts, dpi, max_width, prep))

    async def _produce(self, executor, texts, dpi, max_width, prep) -> None:
        loop = asyncio.get_running_loop()
        t0 = loop.time()

        def done(_fut) -> None:  # `seconds`: from the start to the last page rastered
            self.seconds = loop.time() - t0

        try:
            for i, text in enumerate(texts):
                if self._sem is not None:
                    await self._sem.acquire()
                fut = loop.run_in_executor(executor, _raster_page, i, text, dpi, max_width, prep)
                fut.add_done_callback(done)
                self._queue.put_nowait(fut)
        finally:
            self._queue.put_nowait(None)

    def __aiter__(self):
        return self

    async def __anext__(self) -> tuple:
        while True:
            fut = await self._queue.get()
            if fut is None:
                await self._producer  # its own error, if it failed
                raise StopAsyncIteration
            page = await fut
            if page is not None:
                return page
            self.release(1)

    def release(self, n: int) -> None:
        if self._sem is not None:
            for _ in range(n):
                self._sem.release()

    async def aclose(self) -> None:
        """Stop submitting pages (the ones running finish and are dropped)."""
        self._producer.cancel()
        with contextlib.suppress(BaseException):
            await self._producer


class RasterPool:
    """Shared process pool for PDF page rendering (started lazily)."""

    def __init__(self, processes: int = 0):
        self.processes = processes if processes > 0 else (os.cpu_count() or 4)
        self._pool: Optional[concurrent.futures.ProcessPoolExecutor] = None

    def _ensure(self) -> concurrent.futures.ProcessPoolExecutor:
        if self._pool is None:
            import multiprocessing

            # not fork: the parent holds a CUDA context that a forked child
            # must not inherit; forkserver children do not re-run __main__
            ctx = multiprocessing.get_context("forkserver")
            self._pool = concurrent.futures.ProcessPoolExecutor(max_workers=self.processes, mp_context=ctx)
        return self._pool

    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def stream_pages(self, texts: List[str], dpi: int = 150, max_width: int = _MAX_WIDTH, prep=None,
                     window: Optional[int] = None) -> PageStream:
        """The pages of `texts` (one extracted text per page) as a
        `PageStream`: in the process pool, or below `_MIN_PAGES_FOR_POOL`
        pages (or with one process) in the loop's thread executor."""
        small = len(texts) < _MIN_PAGES_FOR_POOL or self.processes <= 1
        return PageStream(None if small else self._ensure(), texts, dpi, max_width, prep, window)

    async def rasterize_pdf_jpegs(self, data: bytes, dpi: int = 150, max_width: int = _MAX_WIDTH,
                                  prep=None) -> Optional[List[tuple]]:
        """-> `_finish_page` tuples in TRUE page order (a skipped page does
        not shift later pages), or None for a PDF with no pages or none
        that rastered (the caller goes down the ladder)."""
        texts = extract_pages_text(data)
        if not texts:
            return None
        pages = [p async for p in self.stream_pages(texts, dpi, max_width, prep)]
        return pages or None
