"""Recursive character text splitting: port of
`morphik_core_tpu/parser/text_splitter.py`.

Separators "\\n\\n", "\\n", ". ", " ", "" in turn until every piece fits
`chunk_size`, then greedy packing with `chunk_overlap` carried between
consecutive chunks. The reference hands ASCII text with the default
separators to its native library, which returns the chunks of this
Python path (`tests/test_parser.py::test_native_split_text_parity`), so
the port runs the Python path for all text.
"""

from __future__ import annotations

from typing import List, Sequence


class RecursiveCharacterTextSplitter:
    def __init__(
        self,
        chunk_size: int = 6000,
        chunk_overlap: int = 300,
        separators: Sequence[str] = ("\n\n", "\n", ". ", " ", ""),
    ):
        if chunk_overlap >= chunk_size:
            raise ValueError("chunk_overlap must be smaller than chunk_size")
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.separators = list(separators)

    def split_text(self, text: str) -> List[str]:
        if not text:
            return []
        if len(text) <= self.chunk_size:
            return [text]
        return self._merge(self._split(text, 0))

    def _split(self, text: str, sep_idx: int) -> List[str]:
        """Recursively split until every piece fits the budget."""
        if len(text) <= self.chunk_size:
            return [text]
        sep = self.separators[sep_idx] if sep_idx < len(self.separators) else ""
        if sep == "":
            return [text[i : i + self.chunk_size] for i in range(0, len(text), self.chunk_size)]
        parts = text.split(sep)
        out: List[str] = []
        for i, p in enumerate(parts):
            keep = p + sep if i < len(parts) - 1 else p
            if not keep:
                continue
            if len(keep) <= self.chunk_size:
                out.append(keep)
            else:
                out.extend(self._split(keep, sep_idx + 1))
        return out

    def _merge(self, pieces: List[str]) -> List[str]:
        """Greedy-pack pieces into chunks; each new chunk starts with the
        previous one's tail, trimmed so that tail + piece fits the budget."""
        chunks: List[str] = []
        cur = ""
        for p in pieces:
            if cur and len(cur) + len(p) > self.chunk_size:
                chunks.append(cur)
                keep = min(self.chunk_overlap, max(0, self.chunk_size - len(p)))
                cur = cur[len(cur) - keep :] if keep else ""
            cur += p
        if cur.strip():
            chunks.append(cur)
        return chunks
