"""HTML -> structured plain text (stdlib `html.parser`): port of
`morphik_core_tpu/parser/html_text.py`.

Headings become markdown-style prefixes, scripts and styles are dropped,
block elements break lines, table cells are joined with " | ".
"""

from __future__ import annotations

from html.parser import HTMLParser
from typing import List

_BLOCK = {
    "p", "div", "section", "article", "li", "tr", "br", "table",
    "ul", "ol", "header", "footer", "main", "blockquote", "pre",
}
_HEADINGS = {"h1": "# ", "h2": "## ", "h3": "### ", "h4": "#### ", "h5": "##### ", "h6": "###### "}
_SKIP = {"script", "style", "noscript", "template", "svg"}


class _Extractor(HTMLParser):
    def __init__(self) -> None:
        super().__init__(convert_charrefs=True)
        self.parts: List[str] = []
        self._skip_depth = 0
        self.title = ""
        self._in_title = False

    def handle_starttag(self, tag, attrs):
        if tag in _SKIP:
            self._skip_depth += 1
        elif tag == "title":
            self._in_title = True
        elif tag in _HEADINGS:
            self.parts.append("\n\n" + _HEADINGS[tag])
        elif tag in _BLOCK:
            self.parts.append("\n")
            if tag == "li":
                self.parts.append("- ")
        elif tag in ("td", "th"):
            self.parts.append(" | ")

    def handle_endtag(self, tag):
        if tag in _SKIP and self._skip_depth:
            self._skip_depth -= 1
        elif tag == "title":
            self._in_title = False
        elif tag in _HEADINGS or tag in _BLOCK:
            self.parts.append("\n")

    def handle_data(self, data):
        if self._skip_depth:
            return
        if self._in_title:
            self.title += data.strip()
            return
        if data.strip():
            self.parts.append(data)


def html_to_text(data: bytes | str) -> tuple[str, str]:
    """-> (title, text)."""
    raw = data.decode("utf-8", errors="replace") if isinstance(data, bytes) else data
    ex = _Extractor()
    ex.feed(raw)
    text = "".join(ex.parts)
    # collapse whitespace runs but keep paragraph breaks
    lines = [" ".join(line.split()) for line in text.splitlines()]
    out: List[str] = []
    for line in lines:
        if line:
            out.append(line)
        elif out and out[-1] != "":
            out.append("")
    return ex.title, "\n".join(out).strip()
