"""Heuristic table detection for born-digital PDFs: port of
`morphik_core_tpu/parser/table_detect.py`.

Tables in digital PDFs are drawn as grids of short runs whose x-origins
repeat across consecutive baselines. Runs are clustered into rows (by
baseline) and columns (by x-anchor alignment across consecutive
multi-cell rows), and each grid becomes a markdown table that the
splitter turns into searchable chunks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from morphik_core_tpu_torch.parser.pdf import TextBlock, extract_pages_blocks

# Cells are short labels or numbers, prose lines are long: a run of rows
# whose median cell is longer than this is a multi-column text layout.
MAX_MEDIAN_CELL_CHARS = 40


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2] if s else 0.0


def _cluster_rows(blocks: List[TextBlock]) -> List[List[TextBlock]]:
    """Group single-line runs by baseline proximity: rows top of page
    first, cells left to right."""
    cells = [b for b in blocks if b.text and "\n" not in b.text]
    if not cells:
        return []
    tol = max(2.0, 0.6 * _median([b.bbox[3] - b.bbox[1] for b in cells]))
    cells.sort(key=lambda b: -(b.bbox[1] + b.bbox[3]) / 2)
    rows: List[List[TextBlock]] = []
    cur_y: Optional[float] = None
    for b in cells:
        yc = (b.bbox[1] + b.bbox[3]) / 2
        if cur_y is None or abs(yc - cur_y) > tol:
            rows.append([b])
            cur_y = yc
        else:
            rows[-1].append(b)
            # a running mean keeps slightly staggered baselines in one row
            cur_y = (cur_y * (len(rows[-1]) - 1) + yc) / len(rows[-1])
    for r in rows:
        r.sort(key=lambda b: b.bbox[0])
    return rows


def _column_anchors(rows: List[List[TextBlock]], tol: float) -> List[float]:
    """Cluster the x-origins of every cell of a candidate run into column anchors."""
    anchors: List[List[float]] = []
    for x in sorted(b.bbox[0] for row in rows for b in row):
        if anchors and x - anchors[-1][-1] <= tol:
            anchors[-1].append(x)
        else:
            anchors.append([x])
    return [sum(a) / len(a) for a in anchors]


def _escape_md(text: str) -> str:
    return text.replace("|", "\\|").strip()


def _grid_to_markdown(grid: List[List[str]]) -> str:
    n_cols = max(len(r) for r in grid)
    lines = []
    for i, row in enumerate(grid):
        row = row + [""] * (n_cols - len(row))
        lines.append("| " + " | ".join(row) + " |")
        if i == 0:
            lines.append("|" + "|".join([" --- "] * n_cols) + "|")
    return "\n".join(lines)


def detect_tables_from_blocks(blocks: List[TextBlock], min_rows: int = 3, min_cols: int = 2) -> List[str]:
    """One markdown table string per tabular grid among a page's runs."""
    rows = _cluster_rows(blocks)
    if not rows:
        return []
    row_h = _median([b.bbox[3] - b.bbox[1] for r in rows for b in r]) or 12.0
    col_tol = max(8.0, 1.2 * row_h)

    # maximal runs of vertically adjacent rows with >= min_cols cells
    tables: List[str] = []
    run: List[List[TextBlock]] = []

    def flush_run() -> None:
        nonlocal run
        candidate, run = run, []
        if len(candidate) < min_rows:
            return
        if _median([len(b.text.strip()) for r in candidate for b in r]) > MAX_MEDIAN_CELL_CHARS:
            return  # multi-column prose, not a table
        anchors = _column_anchors(candidate, col_tol)
        if len(anchors) < min_cols:
            return
        grid: List[List[str]] = []
        for r in candidate:
            cells = [""] * len(anchors)
            for b in r:
                j = min(range(len(anchors)), key=lambda i: abs(b.bbox[0] - anchors[i]))
                cells[j] = (cells[j] + " " + _escape_md(b.text)).strip()
            grid.append(cells)
        tables.append(_grid_to_markdown(grid))

    prev_y: Optional[float] = None
    for r in rows:
        yc = (r[0].bbox[1] + r[0].bbox[3]) / 2
        adjacent = prev_y is None or (prev_y - yc) <= 2.5 * max(row_h, 1.0)
        if len(r) >= min_cols:
            # a vertical gap closes the open run; this row starts the next
            if not adjacent:
                flush_run()
            run.append(r)
        else:
            flush_run()
        prev_y = yc
    flush_run()
    return tables


def detect_pdf_tables(data: bytes, min_rows: int = 3, min_cols: int = 2) -> List[List[str]]:
    """PDF bytes -> per page, its markdown tables (an empty list for a
    page without a grid; no pages for a PDF that does not parse)."""
    try:
        pages = extract_pages_blocks(data)
    except Exception:  # noqa: BLE001 — a malformed PDF has no tables
        return []
    return [detect_tables_from_blocks(blocks, min_rows, min_cols) for blocks in pages]
