"""File-type parse router: port of `morphik_core_tpu/parser/morphik_parser.py`
(`:39-170`, `:220-229`, `:288-303`).

Routes by detected content type:
  html              -> `html_to_text` (title in the metadata)
  text/*, json      -> read-through
  xlsx              -> markdown tables
  docx              -> paragraphs
  pptx              -> per-slide text
  pdf               -> page text + markdown tables of detected grids
  xml               -> read-through (`parse_and_chunk_xml` chunks it)
  everything else   -> best-effort utf-8 decode, as is a failed parse

`split_text` runs the recursive splitter, or the ContextualChunker when
`parser.use_contextual_chunking` is set and a completion function is
given. Not ported yet: the OCR rung of `parse_file_to_text_deep` (item
3b: it rasterizes), `parser_mode="api"` (item 3h), video (item 3b).
`build_services` refuses the settings that would select them.
"""

from __future__ import annotations

import logging
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from morphik_core_tpu_torch.config import Settings
from morphik_core_tpu_torch.models.schemas import Chunk
from morphik_core_tpu_torch.parser.html_text import html_to_text
from morphik_core_tpu_torch.parser.office import docx_to_text, pptx_to_slides, xlsx_to_markdown
from morphik_core_tpu_torch.parser.pdf import extract_pages_text_and_blocks
from morphik_core_tpu_torch.parser.table_detect import detect_tables_from_blocks
from morphik_core_tpu_torch.parser.text_splitter import RecursiveCharacterTextSplitter
from morphik_core_tpu_torch.parser.xml_chunker import XMLChunker
from morphik_core_tpu_torch.storage.content_types import DOCX, PPTX, XLSX, detect_content_type
from morphik_core_tpu_torch.utils.fast_ops import clean_control_chars

logger = logging.getLogger(__name__)

CompleteFn = Callable[[str], Awaitable[str]]


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
    def __init__(self, settings: Settings, complete_fn: Optional[CompleteFn] = None):
        self.settings = settings
        p = settings.parser
        self.splitter = RecursiveCharacterTextSplitter(p.chunk_size, p.chunk_overlap)
        self.xml_chunker = XMLChunker(max_tokens=p.xml_max_tokens)
        self.contextual = (
            ContextualChunker(self.splitter, complete_fn) if p.use_contextual_chunking and complete_fn else None
        )

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

    async def parse_file_to_text_deep(
        self, file: bytes, filename: Optional[str] = None, content_type: Optional[str] = None
    ) -> Tuple[Dict[str, Any], str]:
        """The deep-parse rung after a parse that gave no text: OCR of the
        rasterized pages. Without an OCR engine (the shipped
        `ocr_mode="none"`, the only mode `build_services` accepts) it
        returns ({}, ""), and the ladder records the document as
        unsearchable."""
        return {}, ""

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
