"""File-type parse router: port of `morphik_core_tpu/parser/morphik_parser.py`
(`:39-263`, `:288-303`).

Routes by detected content type:
  html              -> `html_to_text` (title in the metadata)
  text/*, json      -> read-through
  pdf, xlsx, docx,
  pptx, image/*     -> with `parser.parser_mode="api"`: the remote parse
                       endpoints, in order; `ParseAPIError` when all fail
  xlsx              -> markdown tables
  docx              -> paragraphs
  pptx              -> per-slide text
  pdf               -> page text + markdown tables of detected grids
  xml               -> read-through (`parse_and_chunk_xml` chunks it)
  everything else   -> best-effort utf-8 decode, as is a failed parse

`parse_file_to_text_deep`, the rung after a parse without text, OCRs
the pages (a PDF rasterized by `parser/pdf.py`, an image decoded) through
the engine of `parser.ocr_mode` (`parser/ocr.py`). `split_text` runs the
recursive splitter, or the ContextualChunker when
`parser.use_contextual_chunking` is set and a completion function is
given. Video is not ported (ROADMAP Queue 1 item 3b-ii). The on-the-fly
document query (`services/on_the_fly.py`) parses its upload with
`parse_file_to_text`.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import uuid
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from morphik_core_tpu_torch.completion._http import post_bytes
from morphik_core_tpu_torch.config import Settings
from morphik_core_tpu_torch.models.schemas import Chunk
from morphik_core_tpu_torch.parser.html_text import html_to_text
from morphik_core_tpu_torch.parser.ocr import BaseOCR, get_ocr_engine
from morphik_core_tpu_torch.parser.office import docx_to_text, pptx_to_slides, xlsx_to_markdown
from morphik_core_tpu_torch.parser.pdf import extract_pages_text_and_blocks, rasterize_pdf
from morphik_core_tpu_torch.parser.table_detect import detect_tables_from_blocks
from morphik_core_tpu_torch.parser.text_splitter import RecursiveCharacterTextSplitter
from morphik_core_tpu_torch.parser.xml_chunker import XMLChunker
from morphik_core_tpu_torch.storage.content_types import DOCX, PPTX, XLSX, detect_content_type
from morphik_core_tpu_torch.utils.fast_ops import clean_control_chars
from morphik_core_tpu_torch.utils.image import decode_image

logger = logging.getLogger(__name__)

CompleteFn = Callable[[str], Awaitable[str]]
PARSE_API_TIMEOUT_S = 300.0


class ParseAPIError(RuntimeError):
    """All remote parse endpoints failed (parser_mode="api")."""


class ContextualChunker:
    """Prefixes each chunk with LLM-written situating context."""

    PROMPT = (
        "<document>\n{document}\n</document>\n"
        "Here is the chunk we want to situate within the whole document\n"
        "<chunk>\n{chunk}\n</chunk>\n"
        "Please give a short succinct context to situate this chunk within "
        "the overall document for the purposes of improving search retrieval "
        "of the chunk. Answer only with the succinct context and nothing else."
    )

    def __init__(self, splitter: RecursiveCharacterTextSplitter, complete_fn: CompleteFn):
        self.splitter = splitter
        self.complete_fn = complete_fn

    async def split_text(self, text: str) -> List[Chunk]:
        out = []
        for c in self.splitter.split_text(text):
            try:
                ctx = await self.complete_fn(self.PROMPT.format(document=text[:40000], chunk=c))
                ctx = (ctx or "").strip()
                # an empty, failed or stub answer must not reach the chunk text
                if ctx and not ctx.startswith("[offline-stub]"):
                    out.append(Chunk(content=f"{ctx}; {c}", metadata={}))
                else:
                    out.append(Chunk(content=c, metadata={}))
            except Exception as e:  # noqa: BLE001
                logger.warning("contextual chunking failed (%s); using raw chunk", e)
                out.append(Chunk(content=c, metadata={}))
        return out


class MorphikParser:
    def __init__(self, settings: Settings, complete_fn: Optional[CompleteFn] = None,
                 ocr_engine: Optional[BaseOCR] = None):
        """`ocr_engine` None: the engine `parser.ocr_mode` selects."""
        self.settings = settings
        p = settings.parser
        self.splitter = RecursiveCharacterTextSplitter(p.chunk_size, p.chunk_overlap)
        self.xml_chunker = XMLChunker(max_tokens=p.xml_max_tokens)
        self.contextual = (
            ContextualChunker(self.splitter, complete_fn) if p.use_contextual_chunking and complete_fn else None
        )
        self.ocr_engine = ocr_engine if ocr_engine is not None else get_ocr_engine(settings)
        self.parser_mode = p.parser_mode
        self.parse_api_endpoints = [e.rstrip("/") for e in p.parse_api_endpoints]
        self.parse_api_key = p.parse_api_key
        # where a JPEG 2000 image's tier-1 runs (the services' device); None: the card
        self.image_device = None

    async def parse_file_to_text(
        self, file: bytes, filename: Optional[str] = None, content_type: Optional[str] = None
    ) -> Tuple[Dict[str, Any], str]:
        """-> (additional_metadata, text)."""
        ctype = content_type or detect_content_type(file, filename)
        try:
            if ctype in ("text/html", "application/xhtml+xml") or (
                ctype.startswith("text/") and file.lstrip()[:100].lower().startswith((b"<!doctype html", b"<html"))
            ):
                title, text = html_to_text(file)
                return ({"title": title} if title else {}), clean_control_chars(text)
            if ctype.startswith("text/") or ctype in ("application/json",):
                return {}, clean_control_chars(file.decode("utf-8", errors="replace"))
            if self.parser_mode == "api" and (
                ctype in ("application/pdf", XLSX, DOCX, PPTX) or ctype.startswith("image/")
            ):
                return {}, clean_control_chars(await self._parse_via_api(file, filename or "file"))
            if ctype == XLSX:
                return {}, xlsx_to_markdown(file)
            if ctype == DOCX:
                return {}, docx_to_text(file)
            if ctype == PPTX:
                slides = pptx_to_slides(file)
                return {"slide_count": len(slides)}, "\n\n".join(
                    f"## Slide {i + 1}\n{s}" for i, s in enumerate(slides)
                )
            if ctype == "application/pdf":
                return self._parse_pdf(file)
            if ctype in ("application/xml", "text/xml") or (filename or "").lower().endswith(".xml"):
                return {}, clean_control_chars(file.decode("utf-8", errors="replace"))
        except ParseAPIError:
            raise  # every remote endpoint failed: the ingestion ladder decides
        except Exception as e:  # noqa: BLE001
            logger.warning("parse of %s (%s) failed: %s — falling back to utf-8 decode", filename, ctype, e)
        return {}, clean_control_chars(file.decode("utf-8", errors="replace"))

    @staticmethod
    def _parse_pdf(file: bytes) -> Tuple[Dict[str, Any], str]:
        """Page text with each page's detected tables merged in as
        markdown, from one parse + inflate pass."""
        pages, page_blocks = extract_pages_text_and_blocks(file)
        per_page_tables = [detect_tables_from_blocks(b) for b in page_blocks]
        n_tables = 0
        parts = []
        for i, pg in enumerate(pages):
            seg = [pg] if pg else []
            if i < len(per_page_tables) and per_page_tables[i]:
                seg.extend(per_page_tables[i])
                n_tables += len(per_page_tables[i])
            if seg:
                parts.append("\n\n".join(seg))
        meta: Dict[str, Any] = {"page_count": len(pages)}
        if n_tables:
            meta["detected_tables"] = n_tables
        return meta, "\n\n".join(parts)

    async def _parse_via_api(self, file: bytes, filename: str) -> str:
        """POST the document as multipart to each parse endpoint in turn
        until one answers {"text": ...}; `ParseAPIError` when all fail."""
        if not self.parse_api_endpoints:
            raise ParseAPIError("parser_mode=api but no parse_api_endpoints configured")
        # the filename is the user's: without CR/LF/quotes it cannot end the
        # Content-Disposition line or inject fields into the body
        filename = re.sub(r'[\r\n"\\]', "_", filename or "file")[:255]

        def post(endpoint: str) -> str:
            # a random boundary per request: document bytes holding a fixed
            # one would cut the part short
            boundary = f"----morphikparse{uuid.uuid4().hex}"
            body = (
                f"--{boundary}\r\n"
                f'Content-Disposition: form-data; name="file"; filename="{filename}"\r\n'
                "Content-Type: application/octet-stream\r\n\r\n"
            ).encode() + file + (
                f"\r\n--{boundary}\r\n"
                'Content-Disposition: form-data; name="filename"\r\n\r\n'
                f"{filename}\r\n--{boundary}--\r\n"
            ).encode()
            headers = {"Content-Type": f"multipart/form-data; boundary={boundary}"}
            if self.parse_api_key:
                headers["Authorization"] = f"Bearer {self.parse_api_key}"
            return json.loads(post_bytes(endpoint, body, headers, PARSE_API_TIMEOUT_S).decode()).get("text", "")

        last: Optional[Exception] = None
        for ep in self.parse_api_endpoints:
            try:
                return await asyncio.to_thread(post, ep)
            except Exception as e:  # noqa: BLE001 — try the next endpoint
                logger.warning("parse API %s failed: %s", ep, e)
                last = e
        raise ParseAPIError(f"all parse API endpoints failed: {last}")

    async def parse_file_to_text_deep(
        self, file: bytes, filename: Optional[str] = None, content_type: Optional[str] = None
    ) -> Tuple[Dict[str, Any], str]:
        """The deep-parse rung after a parse that gave no text: a PDF's
        pages rasterized at `pdf.colpali_pdf_dpi`, or an image decoded,
        OCRed through the engine; each page's tables merged into its text.
        -> ({"ocr_pages", "ocr_tables"}, text), or ({}, "") without an
        engine (the ladder then records the document as unsearchable)."""
        if self.ocr_engine is None:
            return {}, ""
        ctype = content_type or detect_content_type(file, filename)
        images = []
        if ctype == "application/pdf":
            images, _ = await asyncio.to_thread(rasterize_pdf, file, self.settings.pdf.colpali_pdf_dpi)
        elif ctype.startswith("image/"):
            images = [await asyncio.to_thread(decode_image, file, self.image_device)]
        if not images:
            return {}, ""
        pages = await self.ocr_engine.images_to_structured(images)
        parts, n_tables = [], 0
        for pg in pages:
            seg = [pg.get("text", "").strip()]
            tables = [t.strip() for t in pg.get("tables", []) if t and t.strip()]
            n_tables += len(tables)
            # markdown tables join the page text, so the splitter makes
            # searchable table chunks
            seg.extend(tables)
            seg = [s for s in seg if s]
            if seg:
                parts.append("\n\n".join(seg))
        text = "\n\n".join(parts)
        meta: Dict[str, Any] = {}
        if text:
            meta["ocr_pages"] = len(images)
            if n_tables:
                meta["ocr_tables"] = n_tables
        return meta, clean_control_chars(text)

    async def split_text(self, text: str) -> List[Chunk]:
        if self.contextual is not None:
            return await self.contextual.split_text(text)
        return [Chunk(content=c, metadata={}) for c in self.splitter.split_text(text)]

    def parse_and_chunk_xml(self, xml_text: str) -> List[Chunk]:
        return [
            Chunk(content=c["content"], metadata={"xml": {"breadcrumbs": c["breadcrumbs"], "tag": c["tag"]}})
            for c in self.xml_chunker.chunk(xml_text)
        ]

    @staticmethod
    def is_xml_file(filename: Optional[str], content_type: Optional[str]) -> bool:
        if content_type in ("application/xml", "text/xml"):
            return True
        return bool(filename and filename.lower().endswith(".xml"))
