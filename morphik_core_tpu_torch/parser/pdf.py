"""Dependency-free PDF handling: port of `morphik_core_tpu/parser/pdf.py`.

A brute object scan, FlateDecode streams and the BT/ET text operators,
good enough for born-digital PDFs. Font CMaps are not decoded: PDFs with
subsetted or CID fonts give empty text, and the ingestion ladder goes on
from there. `extract_pages_blocks` also tracks the text cursor, so each
run of text carries a position for table detection.

`rasterize_pdf` is the reference's backend ladder as it runs without
PyMuPDF and pdf2image (neither is installed where the reference or the
port serves, and neither can be ported without its native library:
ROADMAP Queue 1 item 3b-ii): the text-render rung, each page's extracted
text drawn by `text_render.render_text_page`.
"""

from __future__ import annotations

import logging
import re
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from morphik_core_tpu_torch.parser.text_render import render_text_page

logger = logging.getLogger(__name__)

_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b", re.S)
_STREAM_RE = re.compile(rb"stream\r?\n", re.S)


def _parse_objects(data: bytes) -> Dict[int, bytes]:
    """Brute-force scan: object number -> raw object body."""
    objs: Dict[int, bytes] = {}
    for m in _OBJ_RE.finditer(data):
        start = m.end()
        end = data.find(b"endobj", start)
        if end == -1:
            continue
        objs[int(m.group(1))] = data[start:end]
    return objs


def _stream_of(body: bytes) -> Optional[bytes]:
    m = _STREAM_RE.search(body)
    if not m:
        return None
    start = m.end()
    end = body.rfind(b"endstream")
    if end == -1:
        return None
    raw = body[start:end].rstrip(b"\r\n")
    if b"/FlateDecode" in body[: m.start()]:
        try:
            return zlib.decompress(raw)
        except zlib.error:
            try:  # some writers pad; try raw deflate
                return zlib.decompressobj().decompress(raw)
            except zlib.error:
                return None
    return raw


def _refs(body: bytes, key: bytes) -> List[int]:
    """Object refs after /Key (a single ref or an array)."""
    m = re.search(key + rb"\s*\[(.*?)\]", body, re.S)
    if m:
        return [int(x) for x in re.findall(rb"(\d+)\s+\d+\s+R", m.group(1))]
    m = re.search(key + rb"\s*(\d+)\s+\d+\s+R", body)
    return [int(m.group(1))] if m else []


_ESCAPES = {b"n": "\n", b"r": "\r", b"t": "\t", b"b": "\b", b"f": "\f", b"(": "(", b")": ")", b"\\": "\\"}


def _decode_pdf_string(raw: bytes) -> str:
    out = []
    i = 0
    while i < len(raw):
        c = raw[i : i + 1]
        if c == b"\\" and i + 1 < len(raw):
            nxt = raw[i + 1 : i + 2]
            if nxt in _ESCAPES:
                out.append(_ESCAPES[nxt])
                i += 2
                continue
            if nxt.isdigit():  # octal
                m = re.match(rb"[0-7]{1,3}", raw[i + 1 : i + 4])
                if m is None:  # malformed '\8'/'\9': drop the backslash
                    i += 1
                    continue
                oct_digits = m.group(0)
                out.append(chr(int(oct_digits, 8)))
                i += 1 + len(oct_digits)
                continue
            i += 2
            continue
        out.append(c.decode("latin-1"))
        i += 1
    return "".join(out)


_TEXT_OP_RE = re.compile(
    rb"\((?P<lit>(?:[^()\\]|\\.)*)\)\s*(?P<op>Tj|'|\")"  # literal string show
    rb"|<(?P<hex>[0-9A-Fa-f\s]*)>\s*(?P<hop>Tj)"  # hex string show
    rb"|\[(?P<arr>(?:[^\[\]\\]|\\.)*)\]\s*TJ"  # array show
    rb"|(?P<nl>T\*|TD|Td)",
    re.S,
)
_ARR_STR_RE = re.compile(rb"\((?P<lit>(?:[^()\\]|\\.)*)\)|<(?P<hex>[0-9A-Fa-f\s]*)>")


def _hex_to_text(h: bytes) -> str:
    h = re.sub(rb"\s", b"", h)
    if len(h) % 2:
        h += b"0"
    try:
        b = bytes.fromhex(h.decode("ascii"))
    except ValueError:
        return ""
    # UTF-16BE if the first high bytes are zero and it decodes, else latin-1
    if len(b) % 2 == 0 and all(b[i] == 0 for i in range(0, min(len(b), 8), 2)):
        try:
            return b.decode("utf-16-be")
        except UnicodeDecodeError:
            pass
    return b.decode("latin-1")


def _array_strings(arr: bytes) -> List[str]:
    """The strings of a TJ array, in order."""
    out = []
    for sm in _ARR_STR_RE.finditer(arr):
        if sm.group("lit") is not None:
            out.append(_decode_pdf_string(sm.group("lit")))
        elif sm.group("hex") is not None:
            out.append(_hex_to_text(sm.group("hex")))
    return out


def _extract_text_from_content(content: bytes) -> str:
    parts: List[str] = []
    for m in _TEXT_OP_RE.finditer(content):
        if m.group("nl"):
            if parts and not parts[-1].endswith("\n"):
                parts.append("\n")
            continue
        if m.group("lit") is not None:
            parts.append(_decode_pdf_string(m.group("lit")))
        elif m.group("hex") is not None:
            parts.append(_hex_to_text(m.group("hex")))
        elif m.group("arr") is not None:
            parts.extend(_array_strings(m.group("arr")))
    return re.sub(r"\n{3,}", "\n\n", "".join(parts)).strip()


def _page_content_streams(data: bytes) -> List[bytes]:
    """PDF bytes -> per-page decompressed content streams (b"" for a page
    without content). This parse + inflate is the costly part: a caller
    that needs page text and blocks pays it once through
    `extract_pages_text_and_blocks`."""
    objs = _parse_objects(data)
    pages: List[Tuple[int, bytes]] = []
    for num, body in objs.items():
        head = body.split(b"stream", 1)[0]
        if re.search(rb"/Type\s*/Page\b(?!s)", head):
            pages.append((num, body))
    pages.sort(key=lambda t: t[0])
    out: List[bytes] = []
    for _, body in pages:
        content = b""
        for ref in _refs(body, rb"/Contents"):
            if ref in objs:
                s = _stream_of(objs[ref])
                if s:
                    content += s + b"\n"
        out.append(content)
    return out


def extract_pages_text(data: bytes) -> List[str]:
    """PDF bytes -> per-page extracted text (may be empty strings)."""
    return [_extract_text_from_content(c) if c else "" for c in _page_content_streams(data)]


def extract_pages_text_and_blocks(data: bytes):
    """One parse + inflate pass -> (per-page text, per-page positioned blocks)."""
    streams = _page_content_streams(data)
    texts = [_extract_text_from_content(c) if c else "" for c in streams]
    blocks = [_blocks_from_content(c) if c else [] for c in streams]
    return texts, blocks


def page_count(data: bytes) -> int:
    return len(extract_pages_text(data))


# -------------------------------------------------------------------- raster


def rasterize_pdf(data: bytes, dpi: int = 150) -> Tuple[List[np.ndarray], str]:
    """-> ((H, W, 3) uint8 page images, backend name): the text-render
    rung of the reference's ladder (`pdf.py:255-270`), one page drawn
    even when the PDF has none."""
    texts = extract_pages_text(data) or [""]
    logger.warning("No native PDF rasterizer available — using text-render fallback (%d pages)", len(texts))
    return [render_text_page(t, dpi) for t in texts], "textrender"


# ----------------------------------------------------------- positioned text

_POS_OP_RE = re.compile(
    rb"(?P<tx>-?[\d.]+)\s+(?P<ty>-?[\d.]+)\s+(?P<tdop>Td|TD)"
    rb"|(?P<m>(?:-?[\d.]+\s+){5}-?[\d.]+)\s+Tm"
    rb"|/\w+\s+(?P<fs>[\d.]+)\s+Tf"
    rb"|(?P<bt>BT)|(?P<et>ET)|(?P<star>T\*)"
    rb"|\((?P<lit>(?:[^()\\]|\\.)*)\)\s*(?:Tj|'|\")"
    rb"|<(?P<hex>[0-9A-Fa-f\s]+)>\s*Tj"
    rb"|\[(?P<arr>(?:[^\[\]\\]|\\.)*)\]\s*TJ",
    re.S,
)


class TextBlock:
    """A positioned run of text: bbox = (x0, y0, x1, y1) in PDF points,
    origin bottom-left. `size` is the font size (Tf operand) active when
    the block started."""

    __slots__ = ("text", "bbox", "size")

    def __init__(self, text: str, bbox: Tuple[float, float, float, float], size: float = 12.0):
        self.text = text
        self.bbox = bbox
        self.size = size

    def __repr__(self) -> str:  # pragma: no cover
        return f"TextBlock({self.text[:20]!r}, {self.bbox})"


def _blocks_from_content(content: bytes) -> List[TextBlock]:
    """Track the text cursor through Td/TD/Tm/T* and group shows into
    blocks. A glyph is taken as 0.5 * font size wide (font metrics are
    not parsed)."""
    blocks: List[TextBlock] = []
    x = y = 0.0
    font_size = 12.0
    leading = 14.0
    cur_text: List[str] = []
    cur_x0 = cur_y0 = cur_x1 = cur_y1 = 0.0
    cur_size = 12.0

    def flush():
        nonlocal cur_text
        t = "".join(cur_text).strip()
        if t:
            blocks.append(TextBlock(t, (cur_x0, cur_y0, cur_x1, cur_y1), size=cur_size))
        cur_text = []

    def add_text(t: str):
        nonlocal cur_x0, cur_y0, cur_x1, cur_y1, cur_size
        if not cur_text:
            cur_x0, cur_y0 = x, y - 0.2 * font_size
            cur_x1, cur_y1 = x, y + font_size
            cur_size = font_size
        cur_text.append(t)
        cur_x1 += 0.5 * font_size * len(t)

    for m in _POS_OP_RE.finditer(content):
        if m.group("bt"):
            flush()
            x = y = 0.0
        elif m.group("et"):
            flush()
        elif m.group("fs"):
            font_size = float(m.group("fs"))
            leading = 1.2 * font_size
        elif m.group("tdop"):
            tx, ty = float(m.group("tx")), float(m.group("ty"))
            if m.group("tdop") == b"TD":
                leading = -ty if ty else leading
            x, y = x + tx, y + ty
            # a small vertical move continues the block; a big jump starts another
            if abs(ty) > 2.5 * leading or (cur_text and ty == 0 and abs(tx) > 100):
                flush()
            elif cur_text:
                cur_text.append("\n")
                cur_y0 = min(cur_y0, y - 0.2 * font_size)
        elif m.group("m") is not None:
            nums = [float(v) for v in m.group("m").split()]
            flush()
            x, y = nums[4], nums[5]
        elif m.group("star"):
            y -= leading
            if cur_text:
                cur_text.append("\n")
                cur_y0 = min(cur_y0, y - 0.2 * font_size)
        elif m.group("lit") is not None:
            add_text(_decode_pdf_string(m.group("lit")))
        elif m.group("hex") is not None:
            add_text(_hex_to_text(m.group("hex")))
        elif m.group("arr") is not None:
            for s in _array_strings(m.group("arr")):
                add_text(s)
    flush()
    return blocks


def extract_pages_blocks(data: bytes) -> List[List[TextBlock]]:
    """PDF bytes -> per-page positioned text blocks (from the PDF's own
    text-positioning operators)."""
    return [_blocks_from_content(c) if c else [] for c in _page_content_streams(data)]
