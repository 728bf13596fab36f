"""Geometric layout roles of born-digital PDF text blocks: copy of
`morphik_core_tpu/parser/layout.py` (`classify_blocks`).

The reference's v2 pipeline tags each page item with the role a layout
model gave it: SECTION_HEADER -> <h>, TITLE -> <title>, PAGE_HEADER ->
<r>, PAGE_FOOTER -> <f>, LIST_ITEM -> <li>, TEXT -> <t>. Without a layout
model the roles come from the PDF's own geometry: font size (the Tf
operand on `parser.pdf.TextBlock.size`), vertical position and lexical
shape. A scanned PDF has no text blocks and gets no roles.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

from morphik_core_tpu_torch.parser.pdf import TextBlock

# lexical list-item shapes: bullets, "1. ", "a) ", "(i) ", "- "
_LIST_RE = re.compile(r"^\s*(?:[-•‣◦⁃*]|\(?\w{1,3}[.)])\s+\S")
# page-number / running-footer shapes
_FOOTER_RE = re.compile(r"^\s*(?:page\s+)?\d{1,4}(?:\s*(?:/|of)\s*\d{1,4})?\s*$", re.I)

HEADING_SIZE_RATIO = 1.25  # block size vs page median to count as heading
TITLE_SIZE_RATIO = 1.6
EDGE_BAND = 0.07  # top/bottom fraction of the content extent for r/f roles
MIN_EXTENT_PT = 300.0  # below this vertical spread, r/f roles are off
MAX_HEADING_CHARS = 120


def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    return s[len(s) // 2] if s else 12.0


def classify_blocks(
    blocks: Sequence[TextBlock], page_height: Optional[float] = None, first_page: bool = False,
) -> List[Tuple[str, TextBlock]]:
    """-> [(tag, block)] in input order, tags t/h/title/r/f/li.

    Header and footer bands come from the page's content extent (min/max
    block y; `page_height` extends it when the caller knows it); a page
    with too little vertical spread gets no r/f roles."""
    if not blocks:
        return []
    body_sizes = [b.size for b in blocks if len(b.text) >= 40] or [b.size for b in blocks]
    med = max(_median(body_sizes), 1.0)
    y_lo = min(b.bbox[1] for b in blocks)
    y_hi = max(b.bbox[3] for b in blocks)
    if page_height:
        y_lo, y_hi = min(y_lo, 0.0), max(y_hi, page_height)
    extent = y_hi - y_lo
    edges_on = extent >= MIN_EXTENT_PT
    top_y = y_hi - EDGE_BAND * extent
    bot_y = y_lo + EDGE_BAND * extent
    out: List[Tuple[str, TextBlock]] = []
    seen_title = False
    for b in blocks:
        text = b.text.strip()
        yc = (b.bbox[1] + b.bbox[3]) / 2
        short = len(text) <= MAX_HEADING_CHARS and "\n" not in text
        tag = "t"
        if edges_on and yc <= bot_y and (len(text) <= 60 or _FOOTER_RE.match(text)):
            tag = "f"
        elif edges_on and _FOOTER_RE.match(text) and yc >= top_y:
            tag = "r"
        elif short and b.size >= TITLE_SIZE_RATIO * med and first_page and not seen_title:
            tag = "title"
            seen_title = True
        elif short and b.size >= HEADING_SIZE_RATIO * med:
            tag = "h"
        elif edges_on and yc >= top_y and len(text) <= 60 and b.size <= med:
            tag = "r"
        elif _LIST_RE.match(text):
            tag = "li"
        out.append((tag, b))
    return out
