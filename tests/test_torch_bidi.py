"""The port's bidi levels and visual order against libfribidi itself, the
library Pillow's raqm draws the reference's text with, on the CPU.
Tolerance: exact (every level, every index of the visual order).

- `bidi.embedding_levels` over the glyph atlas's types and brackets equals
  `fribidi_get_par_embedding_levels_ex(..., FRIBIDI_PAR_ON)` (called
  through ctypes here only) on fixed lines that reach each place where
  FriBiDi 1.0.8 departs from the letter of UAX #9, and on lines fuzzed
  from a numpy seed over L, R, AL, EN, AN, the separators and
  terminators, NSM, the neutrals, brackets, BN, S, B and every explicit
  control; the paragraph level equals the direction FriBiDi returns.
- `bidi.visual_runs`, laid out, equals `fribidi_reorder_line`'s map.
- What `bidi.refusal` names is only an isolate left open at a paragraph
  separator with text after it, or more than 62 initiators; the atlas's
  types and brackets equal libfribidi's.
"""

import ctypes

import numpy as np
import pytest

from morphik_core_tpu_torch.parser import bidi
from morphik_core_tpu_torch.parser.text_render import load_font

try:
    FRIBIDI = ctypes.CDLL("libfribidi.so.0")
except OSError:  # pragma: no cover - where the atlas is written, it is installed
    FRIBIDI = None
pytestmark = pytest.mark.skipif(FRIBIDI is None, reason="libfribidi.so.0 (the reference's bidi) is not installed")

SEED = 20
PAR_ON, PAR_LTR, PAR_RTL = 0x40, 0x110, 0x111
POOLS = {
    "L": "abcxyzAV", "R": "אבגדש", "AL": "سلمب", "EN": "0129", "AN": "٠١٢", "ES": "+-", "ET": "$%#°",
    "CS": ",.:/", "NSM": "ִَ́", "WS": "  ", "ON": "!\"&*=@", "BR": "()[]{}〈〉〈〉",
    "S": "\t", "B": "\r \x1c", "BN": "\xad​", "X": "‪‫‬‭‮",
    "I": "⁦⁧⁨⁩", "M": "‎‏؜",
}
FIXED = [
    "abc", "שלום", "שלום abc", "abc שלום", "١٢٣", "123 שלום", "שלום 123", "(abc) שלום", "שלום (abc)",
    "אב\rcd", "ab\rאב", "אב\r12", "ab\r‫cd", "אב\r(cd)", "אב\r cd ", "‫ab\rאב cd",  # X rules stop at B
    "ב⁦ب!⁩⁦x", "'09ג!y⁧בcب⁦ب&⁩}  ג 9س⁦(س'",  # isolate links
    "⁧1{]&}⁧x⁩01⁦}ג⁦س(2", "⁦y⁨]2]⁩ z0  ⁧ بג9للل]<",  # FSI past PDI
    "z{ل١<[١&ل0]ִ́]", "b١  ٠ג<}>ִ]20 ٠ד)",  # W1 merges an NSM run and its neighbours
    "אב a ( b", "אב (a) (b", "x‮(a)‬ b", "x‮a⁦b⁩c‬ d",  # N0 then N1
    "(" * 70 + "ב" + ")" * 70, "a" + "(" * 64 + "ב)",  # the bracket stack's 63 pairs
    "ב" + "‫" * 62 + "a", "a" + "⁧" * 62 + "a",  # deep, not past 125
]


def _types(cps):
    font = load_font(150)
    types = font.bidi_types(cps)
    return types, [font.bidi_brackets.get(cp, 0) if t == bidi.ON else 0 for cp, t in zip(cps, types)]


def _fribidi(text):
    """-> (levels, paragraph direction, visual map) from libfribidi."""
    n = len(text)
    u = (ctypes.c_uint32 * n)(*map(ord, text))
    types, brackets, levels = (ctypes.c_uint32 * n)(), (ctypes.c_uint32 * n)(), (ctypes.c_int8 * n)()
    FRIBIDI.fribidi_get_bidi_types(u, n, types)
    FRIBIDI.fribidi_get_bracket_types(u, n, types, brackets)
    par = ctypes.c_uint32(PAR_ON)
    assert FRIBIDI.fribidi_get_par_embedding_levels_ex(types, brackets, n, ctypes.byref(par), levels)
    got = list(levels)
    vmap = (ctypes.c_int32 * n)(*range(n))
    FRIBIDI.fribidi_reorder_line(0, types, n, 0, par.value, levels, None, vmap)
    return got, par.value, list(vmap), list(types), list(brackets)


def _fuzzed(n_lines: int):
    rng = np.random.default_rng(SEED)
    names = list(POOLS)
    lines = []
    for _ in range(n_lines):
        k = int(rng.integers(2, len(names) + 1))
        use = rng.choice(len(names), size=k, replace=False)
        lines.append("".join(rng.choice(list(POOLS[names[int(rng.choice(use))]]))
                             for _ in range(int(rng.integers(1, 40)))))
    return lines


def _check(text):
    """-> True where the port refuses the line, else asserts its levels,
    paragraph level and visual order equal libfribidi's."""
    cps = [ord(c) for c in text]
    types, brackets = _types(cps)
    want, par, vmap, _, _ = _fribidi(text)
    if bidi.refusal(types) is not None:
        return True
    got, level = bidi.embedding_levels(types, brackets)
    assert got == want, (text, got, want)
    assert par == PAR_ON or level == (1 if par == PAR_RTL else 0), (text, level, hex(par))
    order = [i for s, e, lv in bidi.visual_runs(got) for i in (range(e - 1, s - 1, -1) if lv % 2 else range(s, e))]
    assert order == vmap, (text, order, vmap)
    return False


@pytest.mark.parametrize("text", FIXED)
def test_levels_and_order_of_fixed_lines_equal_fribidi(text):
    assert not _check(text)


@pytest.mark.parametrize("part", range(4))
def test_levels_and_order_of_fuzzed_lines_equal_fribidi(part):
    """4 x 1000 seeded lines; the refused ones are only the two cases
    `bidi.refusal` names (69-94 of each thousand here)."""
    lines = _fuzzed(4000)[part * 1000:(part + 1) * 1000]
    refused = [t for t in lines if _check(t)]
    for t in refused:
        why = bidi.refusal(_types([ord(c) for c in t])[0])[1]
        assert "isolate was left open" in why or "others in a line" in why
    assert len(refused) < 120, len(refused)


def test_refusals_name_an_open_isolate_at_a_separator_and_too_many_controls():
    types = _types([ord(c) for c in "a⁧b\rc"])[0]
    assert bidi.refusal(types) == (4, "follows a paragraph separator that an isolate was left open at")
    assert bidi.refusal(_types([ord(c) for c in "a⁧b⁩\rc"])[0]) is None
    assert bidi.refusal(_types([ord(c) for c in "a⁧b\r"])[0]) is None   # nothing after the separator
    many = [bidi.RLE] * 63 + [bidi.L]
    assert bidi.refusal(many) == (62, "is the bidi control after 62 others in a line")


def test_atlas_types_and_brackets_equal_fribidi():
    """The atlas's FriBiDi types and bracket types of every line above."""
    for text in FIXED + _fuzzed(300):
        cps = [ord(c) for c in text]
        types, brackets = _types(cps)
        _, _, _, ftypes, fbrackets = _fribidi(text)
        names = [_type_name(t) for t in ftypes]
        assert [bidi.TYPE_NAMES[t] for t in types] == names, text
        assert brackets == [(-(b & 0x7FFFFFFF) if b & 0x80000000 else b) for b in fbrackets], text


def _type_name(t: int) -> str:
    FRIBIDI.fribidi_get_bidi_type_name.restype = ctypes.c_char_p
    name = FRIBIDI.fribidi_get_bidi_type_name(t).decode()
    return {"LTR": "L", "RTL": "R", "BS": "B", "SS": "S"}.get(name, name)
