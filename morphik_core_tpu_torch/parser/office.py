"""Office-format text extraction (stdlib zipfile + ElementTree): port of
`morphik_core_tpu/parser/office.py`. OOXML files (docx, xlsx, pptx) are
zip archives of XML parts and are read directly."""

from __future__ import annotations

import io
import re
import xml.etree.ElementTree as ET
import zipfile
from typing import Dict, List

_W = "{http://schemas.openxmlformats.org/wordprocessingml/2006/main}"
_A = "{http://schemas.openxmlformats.org/drawingml/2006/main}"
_S = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"


def docx_to_text(data: bytes) -> str:
    """Paragraph-preserving text from word/document.xml."""
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        xml = z.read("word/document.xml")
    root = ET.fromstring(xml)
    paras = []
    for p in root.iter(f"{_W}p"):
        text = "".join(t.text or "" for t in p.iter(f"{_W}t")).strip()
        if text:
            paras.append(text)
    return "\n\n".join(paras)


def _numbered(names, pattern: str) -> List[str]:
    """Zip members matching `pattern`, ordered by their number."""
    return sorted((n for n in names if re.fullmatch(pattern, n)), key=lambda n: int(re.search(r"(\d+)", n).group(1)))


def pptx_to_slides(data: bytes) -> List[str]:
    """One text blob per slide (ppt/slides/slideN.xml, ordered)."""
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        out = []
        for n in _numbered(z.namelist(), r"ppt/slides/slide\d+\.xml"):
            root = ET.fromstring(z.read(n))
            texts = [t.text or "" for t in root.iter(f"{_A}t")]
            out.append("\n".join(s for s in (x.strip() for x in texts) if s))
    return out


def _column_index(ref: str) -> int:
    """0-based column of a cell reference ("C3" -> 2), -1 without letters."""
    col = 0
    for ch in "".join(ch for ch in ref if ch.isalpha()).upper():
        col = col * 26 + (ord(ch) - 64)
    return col - 1


def xlsx_to_markdown(data: bytes, max_rows: int = 5000) -> str:
    """Sheets -> markdown tables, one `## <sheet name>` section each."""
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        shared: List[str] = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.iter(f"{_S}si"):
                shared.append("".join(t.text or "" for t in si.iter(f"{_S}t")))
        sheet_names: Dict[int, str] = {}
        if "xl/workbook.xml" in z.namelist():
            wb = ET.fromstring(z.read("xl/workbook.xml"))
            for i, sh in enumerate(wb.iter(f"{_S}sheet")):
                sheet_names[i] = sh.attrib.get("name", f"Sheet{i + 1}")
        parts = []
        for i, name in enumerate(_numbered(z.namelist(), r"xl/worksheets/sheet\d+\.xml")):
            root = ET.fromstring(z.read(name))
            rows_out: List[List[str]] = []
            for row in root.iter(f"{_S}row"):
                cells: List[str] = []
                for c in row.iter(f"{_S}c"):
                    # sheet XML omits empty cells: place each by its reference
                    col = _column_index(c.attrib.get("r", ""))
                    while len(cells) < col:
                        cells.append("")
                    v = c.find(f"{_S}v")
                    if v is None or v.text is None:
                        is_node = c.find(f"{_S}is")
                        cells.append("".join(t.text or "" for t in is_node.iter(f"{_S}t")) if is_node is not None else "")
                    elif c.attrib.get("t") == "s":
                        idx = int(v.text)
                        cells.append(shared[idx] if idx < len(shared) else "")
                    else:
                        cells.append(v.text)
                rows_out.append(cells)
                if len(rows_out) >= max_rows:
                    break
            if not rows_out:
                continue
            width = max(len(r) for r in rows_out)
            rows_out = [r + [""] * (width - len(r)) for r in rows_out]
            md = [f"## {sheet_names.get(i, f'Sheet{i + 1}')}", ""]
            md.append("| " + " | ".join(rows_out[0]) + " |")
            md.append("|" + "---|" * width)
            md.extend("| " + " | ".join(r) + " |" for r in rows_out[1:])
            parts.append("\n".join(md))
    return "\n\n".join(parts)
