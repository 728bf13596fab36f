"""The Qwen2 byte-level BPE tokenizer of a `tokenizer.json`, read without
the HF `tokenizers` package (the card's machine has neither it nor
`regex`).

It reads one layout, the one Qwen2.5-VL ships, and raises on any other:
- normalizer `NFC`;
- pre-tokenizer `Sequence[Split(QWEN2_PATTERN, Isolated),
  ByteLevel(add_prefix_space=false, use_regex=false)]`;
- model `BPE` with no dropout, no unknown token, no byte fallback, no
  subword prefix or suffix, its vocab, merge ranks and `ignore_merges`;
- `added_tokens` that are not normalized, stripped or single-word: they
  are split out of the text first, leftmost-longest, as the package does.

`encode(text)` returns the ids of `Tokenizer.encode(text,
add_special_tokens=False).ids`. Python's `re` has no `\\p{L}` / `\\p{N}`,
so the Split pattern is a hand-written scanner (`pre_tokenize`) over
`unicodedata.category`, with `\\s` as Oniguruma defines it (Unicode
White_Space, which is not `str.isspace()`), the case-insensitive
contractions, and the `\\s+(?!\\S)` backtrack that gives the last space of
a run to the next word.
"""

from __future__ import annotations

import heapq
import json
import re
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Tuple

#: the Split pattern of Qwen2's tokenizer.json (a raw string: the JSON's)
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
                 r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

# Oniguruma's \s: the Unicode White_Space property (U+001C-U+001F are
# spaces to str.isspace() and not here)
_WHITE_SPACE = frozenset(map(chr, [*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
                                    0x2028, 0x2029, 0x202F, 0x205F, 0x3000]))

# the contractions, in the pattern's order; each letter matches what folds to it
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
_NEWLINES = "\r\n"

_LETTER, _NUMBER, _SPACE, _OTHER = "L", "N", "W", "O"
_CACHE_WORDS = 65536  # BPE results kept per tokenizer (cleared when full)


# letters and numbers of Unicode 16.0 that Python 3.12's tables (Unicode
# 15.0) leave unassigned; the `tokenizers` package's Oniguruma knows them
_UNICODE_16 = (
    (0x1C89, 0x1C8A, "L"), (0xA7CB, 0xA7CD, "L"), (0xA7DA, 0xA7DC, "L"), (0x105C0, 0x105F3, "L"),
    (0x10D40, 0x10D49, "N"), (0x10D4A, 0x10D65, "L"), (0x10D6F, 0x10D85, "L"), (0x10EC2, 0x10EC4, "L"),
    (0x11380, 0x11389, "L"), (0x1138B, 0x1138B, "L"), (0x1138E, 0x1138E, "L"), (0x11390, 0x113B5, "L"),
    (0x113B7, 0x113B7, "L"), (0x113D1, 0x113D1, "L"), (0x113D3, 0x113D3, "L"), (0x116D0, 0x116E3, "N"),
    (0x11BC0, 0x11BE0, "L"), (0x11BF0, 0x11BF9, "N"), (0x13460, 0x143FA, "L"), (0x16100, 0x1611D, "L"),
    (0x16130, 0x16139, "N"), (0x16D40, 0x16D6C, "L"), (0x16D70, 0x16D79, "N"), (0x18CFF, 0x18CFF, "L"),
    (0x1CCF0, 0x1CCF9, "N"), (0x1E5D0, 0x1E5ED, "L"), (0x1E5F0, 0x1E5F0, "L"), (0x1E5F1, 0x1E5FA, "N"),
    (0x2EBF0, 0x2EE5D, "L"),
)


@lru_cache(maxsize=1 << 16)
def _kind(ch: str) -> str:
    if ch in _WHITE_SPACE:
        return _SPACE
    cat = unicodedata.category(ch)
    if cat == "Cn":
        cp = ord(ch)
        return next((kind for lo, hi, kind in _UNICODE_16 if lo <= cp <= hi), _OTHER)
    return cat[0] if cat[0] in (_LETTER, _NUMBER) else _OTHER


def _folds_to(ch: str, letter: str) -> bool:
    """`ch` matches `letter` case-insensitively (simple case folding:
    's' also takes U+017F LONG S)."""
    return ch.casefold() == letter


def _match_end(s: str, kinds: List[str], i: int) -> int:
    """End of the pattern's match at `i` (the alternatives in order, each
    with Oniguruma's backtracking)."""
    n = len(s)
    c = s[i]
    if c == "'":
        for suffix in _CONTRACTIONS:
            end = i + 1 + len(suffix)
            if end <= n and all(_folds_to(s[i + 1 + m], ch) for m, ch in enumerate(suffix)):
                return end
    # [^\r\n\p{L}\p{N}]?\p{L}+
    start = i
    if kinds[i] != _LETTER and kinds[i] != _NUMBER and c not in _NEWLINES and i + 1 < n and kinds[i + 1] == _LETTER:
        start = i + 1
    if kinds[start] == _LETTER:
        j = start
        while j < n and kinds[j] == _LETTER:
            j += 1
        return j
    if kinds[i] == _NUMBER:  # \p{N}
        return i + 1
    # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
    start = i + 1 if c == " " and i + 1 < n and kinds[i + 1] == _OTHER else i
    if kinds[start] == _OTHER:
        j = start
        while j < n and kinds[j] == _OTHER:
            j += 1
        while j < n and s[j] in _NEWLINES:
            j += 1
        return j
    # c is white space from here on
    j = i
    while j < n and kinds[j] == _SPACE:
        j += 1
    for p in range(j - 1, i - 1, -1):  # \s*[\r\n]+: through the run's last newline
        if s[p] in _NEWLINES:
            return p + 1
    if j == n or j - i == 1:  # \s+(?!\S) at the end, else \s+ of one space
        return j
    return j - 1  # \s+(?!\S): the last space goes to the next piece


def pre_tokenize(text: str) -> List[str]:
    """The pieces of the Split pre-tokenizer (`Isolated`: every match is
    its own piece; the pattern leaves no gap between matches)."""
    kinds = [_kind(ch) for ch in text]
    out, i = [], 0
    while i < len(text):
        j = _match_end(text, kinds, i)
        out.append(text[i:j])
        i = j
    return out


def bytes_to_unicode() -> Dict[int, str]:
    """The ByteLevel alphabet: each byte to a printable character."""
    bs = [*range(0x21, 0x7F), *range(0xA1, 0xAD), *range(0xAE, 0x100)]
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_CHARS = bytes_to_unicode()


def _expect(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"tokenizer.json: unsupported layout: {what}")


class QwenTokenizer:
    """Byte-level BPE over the layout the module docstring names."""

    def __init__(self, spec: dict):
        self._check_layout(spec)
        model = spec["model"]
        self.vocab: Dict[str, int] = dict(model["vocab"])
        missing = [ch for ch in _BYTE_CHARS.values() if ch not in self.vocab]
        _expect(not missing, f"{len(missing)} byte symbols missing from the vocab (the package drops such bytes)")
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, merge in enumerate(model["merges"]):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
            _expect(a + b in self.vocab and a in self.vocab and b in self.vocab, f"merge {merge!r} outside the vocab")
            self.merges[self.vocab[a], self.vocab[b]] = (rank, self.vocab[a + b])  # a repeat: the last wins
        self.added: Dict[str, int] = {}
        for tok in spec.get("added_tokens") or []:
            _expect(not (tok.get("normalized") or tok.get("lstrip") or tok.get("rstrip") or tok.get("single_word")),
                    f"added token {tok.get('content')!r} is normalized, stripped or single-word")
            self.added[tok["content"]] = int(tok["id"])
        # leftmost-longest: at the leftmost match, the longest token wins
        self._added_re = re.compile("|".join(map(re.escape, sorted(self.added, key=len, reverse=True)))) \
            if self.added else None
        self._cache: Dict[str, List[int]] = {}

    @staticmethod
    def _check_layout(spec: dict) -> None:
        _expect(spec.get("truncation") is None and spec.get("padding") is None, "truncation or padding set")
        _expect(spec.get("normalizer") == {"type": "NFC"}, f"normalizer {spec.get('normalizer')}")
        pre = spec.get("pre_tokenizer") or {}
        parts = pre.get("pretokenizers") if pre.get("type") == "Sequence" else None
        _expect(isinstance(parts, list) and len(parts) == 2, f"pre_tokenizer {pre}")
        split, byte_level = parts
        _expect(split.get("type") == "Split" and split.get("pattern") == {"Regex": QWEN2_PATTERN}
                and split.get("behavior") == "Isolated" and not split.get("invert"), f"split {split}")
        _expect(byte_level.get("type") == "ByteLevel" and not byte_level.get("add_prefix_space")
                and not byte_level.get("use_regex"), f"byte level {byte_level}")
        post = spec.get("post_processor")
        _expect(post is None or post.get("type") == "ByteLevel", f"post_processor {post}")
        model = spec.get("model") or {}
        _expect(model.get("type") == "BPE" and model.get("dropout") is None and model.get("unk_token") is None
                and not model.get("byte_fallback") and not model.get("continuing_subword_prefix")
                and not model.get("end_of_word_suffix"), "model: " + json.dumps(
                    {k: v for k, v in model.items() if k not in ("vocab", "merges")}))

    @classmethod
    def from_file(cls, path) -> "QwenTokenizer":
        with open(Path(path), encoding="utf-8") as f:
            return cls(json.load(f))

    def _bpe(self, word: str) -> List[int]:
        """The BPE model's merge loop: the lowest-ranked pair first, the
        leftmost among equals, one merge at a time."""
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        ids = [self.vocab[ch] for ch in word]
        n = len(ids)
        nxt = list(range(1, n)) + [-1]
        prev = list(range(-1, n - 1))
        alive = [True] * n
        heap = [(m[0], i, m[1]) for i in range(n - 1) if (m := self.merges.get((ids[i], ids[i + 1])))]
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            right = nxt[pos]
            if not alive[pos] or right == -1:
                continue
            m = self.merges.get((ids[pos], ids[right]))
            if m is None or m[1] != new_id:  # an expired entry
                continue
            ids[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] != -1:
                prev[nxt[pos]] = pos
            if prev[pos] >= 0 and (m := self.merges.get((ids[prev[pos]], ids[pos]))):
                heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] != -1 and (m := self.merges.get((ids[pos], ids[nxt[pos]]))):
                heapq.heappush(heap, (m[0], pos, m[1]))
        return [t for t, a in zip(ids, alive) if a]

    def _encode_segment(self, text: str, out: List[int]) -> None:
        for piece in pre_tokenize(unicodedata.normalize("NFC", text)):
            word = "".join(_BYTE_CHARS[b] for b in piece.encode("utf-8"))
            ids = self._cache.get(word)
            if ids is None:
                if len(self._cache) >= _CACHE_WORDS:
                    self._cache.clear()
                ids = self._cache[word] = self._bpe(word)
            out.extend(ids)

    def encode(self, text: str) -> List[int]:
        """Token ids of `text`, as `encode(text, add_special_tokens=False)`."""
        out: List[int] = []
        start = 0
        if self._added_re is not None:
            for m in self._added_re.finditer(text):
                if m.start() > start:
                    self._encode_segment(text[start : m.start()], out)
                out.append(self.added[m.group()])
                start = m.end()
        if start < len(text):
            self._encode_segment(text[start:], out)
        return out
