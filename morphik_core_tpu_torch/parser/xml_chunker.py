"""Schema-agnostic hierarchical XML chunking with breadcrumbs: port of
`morphik_core_tpu/parser/xml_chunker.py`.

The chunker profiles the tag frequencies and picks a document "unit" tag
(the preferred list, else a tag seen 2..50 times), walks the element
tree skipping `ignore_tags` subtrees (TOC, INDEX), and emits a chunk at
each unit tag or at any element whose text fits the token budget. Each
chunk is prefixed with its breadcrumb path (attribute ids, else a
first-words id). An oversized leaf is split sentence-first.

Tokens are counted as whitespace-separated words. The reference counts
them with tiktoken's cl100k_base when it can load it, and with the same
whitespace count when it cannot; the card's machine has no tiktoken, so
the port always counts words.
"""

from __future__ import annotations

import logging
import re
import xml.etree.ElementTree as ET
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence

from morphik_core_tpu_torch.parser.text_splitter import RecursiveCharacterTextSplitter

logger = logging.getLogger(__name__)


def _count_tokens(text: str) -> int:
    return max(1, len(text.split()))


def _localname(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


class XMLChunker:
    def __init__(
        self,
        max_tokens: int = 350,
        unit_tags: Optional[Sequence[str]] = None,
        ignore_tags: Sequence[str] = ("toc", "index"),
        breadcrumb_attrs: Sequence[str] = ("id", "name", "title", "label"),
    ):
        self.max_tokens = max_tokens
        self.unit_tags = set(unit_tags or ("section", "article", "chapter", "item", "entry", "record", "clause"))
        self.ignore_tags = {t.lower() for t in ignore_tags}
        self.breadcrumb_attrs = breadcrumb_attrs

    def _auto_unit_tag(self, root: ET.Element) -> Optional[str]:
        """A repeating structural tag to treat as the chunk unit, when the
        document uses none of the preferred names."""
        profile: Counter = Counter()

        def visit(el: ET.Element) -> None:
            name = _localname(el.tag).lower()
            if name in self.ignore_tags:  # skip the whole subtree
                return
            profile[name] += 1
            for child in el:
                visit(child)

        visit(root)
        if any(t in profile for t in self.unit_tags):
            return None
        for tag, count in sorted(profile.items(), key=lambda x: x[1]):
            # reasonable repetition: a structural unit, not a formatting tag
            if 2 <= count <= 50 and tag != _localname(root.tag).lower():
                logger.debug("auto-selected XML unit tag %r (count %d)", tag, count)
                return tag
        return None

    def chunk(self, xml_text: str) -> List[Dict[str, Any]]:
        """-> [{"content", "breadcrumbs", "tag", "attrs"}]"""
        xml_text = re.sub(r"^\s*<\?xml[^>]*\?>", "", xml_text.strip())
        try:
            root = ET.fromstring(xml_text)
        except ET.ParseError:
            try:
                root = ET.fromstring(f"<root>{xml_text}</root>")
            except ET.ParseError as e:
                logger.warning("XML parse failed (%s); falling back to text split", e)
                splitter = RecursiveCharacterTextSplitter(self.max_tokens * 4, 0)
                return [
                    {"content": c, "breadcrumbs": [], "tag": "text", "attrs": {}}
                    for c in splitter.split_text(xml_text)
                ]
        chunks: List[Dict[str, Any]] = []
        auto = self._auto_unit_tag(root)
        units = self.unit_tags | ({auto} if auto else set())
        self._walk(root, [], chunks, units)
        return chunks

    def _crumb(self, el: ET.Element, is_unit: bool = False) -> str:
        label = _localname(el.tag)
        for attr in self.breadcrumb_attrs:
            if attr in el.attrib:
                return f"{label}[{el.attrib[attr]}]"
        # xml:id, then a first-words identifier for unit elements
        for attr in ("{http://www.w3.org/XML/1998/namespace}id", "ID"):
            if attr in el.attrib:
                return f"{label}[{el.attrib[attr]}]"
        if is_unit:
            words = self._text_of(el).split()[:3]
            if words:
                return f"{label}[{'_'.join(words)[:40]}]"
        return label

    def _text_of(self, el: ET.Element) -> str:
        return " ".join(t.strip() for t in el.itertext() if t.strip())

    def _walk(self, el: ET.Element, crumbs: List[str], out: List[Dict[str, Any]], units: set) -> None:
        name = _localname(el.tag).lower()
        if name in self.ignore_tags:
            return
        text = self._text_of(el)
        if not text:
            return
        is_unit = name in units
        fits = _count_tokens(text) <= self.max_tokens
        has_element_children = any(True for _ in el)

        if (is_unit or not has_element_children) and fits:
            out.append(self._emit(el, crumbs, text, is_unit))
            return
        if not has_element_children:  # leaf too big: sentence-first split
            splitter = RecursiveCharacterTextSplitter(self.max_tokens * 4, 40)
            for part in splitter.split_text(text):
                out.append(self._emit(el, crumbs, part, is_unit))
            return
        # descend; the element's own leading text is a chunk of its own
        own = (el.text or "").strip()
        if own:
            out.append(self._emit(el, crumbs, own, is_unit))
        child_crumbs = crumbs + [self._crumb(el, is_unit)]
        for child in el:
            self._walk(child, child_crumbs, out, units)
            # mixed content: text after a child element belongs to this one
            tail = (child.tail or "").strip()
            if tail:
                out.append(self._emit(el, crumbs, tail, is_unit))

    def _emit(self, el: ET.Element, crumbs: List[str], text: str, is_unit: bool = False) -> Dict[str, Any]:
        breadcrumbs = crumbs + [self._crumb(el, is_unit)]
        prefix = " > ".join(breadcrumbs)
        return {
            "content": f"[{prefix}] {text}" if prefix else text,
            "breadcrumbs": breadcrumbs,
            "tag": _localname(el.tag),
            "attrs": dict(el.attrib),
        }
