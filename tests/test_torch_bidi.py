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
- Seeded lines of the two kinds FriBiDi 1.0.8 runs its own way: an
  isolate still open at a paragraph separator with text after it, and
  more than 62 embedding and isolate initiators (pushes past depth 125,
  FriBiDi's overflow counters), each line's levels, paragraph direction
  and visual map equal libfribidi's. libfribidi itself crashes on some
  lines whose isolates overflow (it reads memory it never wrote): those
  run in a child process, and a line it crashes on is one the reference
  never draws, counted and left out.
- The atlas's types and brackets equal libfribidi's.
"""

import ctypes
import json
import subprocess
import sys

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


def _check(text, fribidi=None):
    """Asserts the line's levels, paragraph level and visual order equal
    libfribidi's (`fribidi`: its (levels, direction, map), else called
    here)."""
    cps = [ord(c) for c in text]
    types, brackets = _types(cps)
    want, par, vmap = fribidi or _fribidi(text)[:3]
    got, level = bidi.embedding_levels(types, brackets)
    assert got == want, (text, got, want)
    assert par == PAR_ON or level == (1 if par == PAR_RTL else 0), (text, level, hex(par))
    order = [i for s, e, lv in bidi.visual_runs(got) for i in (range(e - 1, s - 1, -1) if lv % 2 else range(s, e))]
    assert order == vmap, (text, order, vmap)


@pytest.mark.parametrize("text", FIXED)
def test_levels_and_order_of_fixed_lines_equal_fribidi(text):
    _check(text)


@pytest.mark.parametrize("part", range(4))
def test_levels_and_order_of_fuzzed_lines_equal_fribidi(part):
    """4 x 1000 seeded lines, every one equal (69-94 of each thousand were
    refused before `bidi` followed FriBiDi past a paragraph separator and
    62 controls)."""
    for t in _fuzzed(4000)[part * 1000:(part + 1) * 1000]:
        _check(t)


# libfribidi in a child process that forks for each line: a line it crashes on gives None
_CHILD = r"""
import ctypes, json, os, pickle, sys
F = ctypes.CDLL("libfribidi.so.0")
def run(text):
    n = len(text)
    u = (ctypes.c_uint32 * n)(*map(ord, text))
    types, brackets, levels = (ctypes.c_uint32 * n)(), (ctypes.c_uint32 * n)(), (ctypes.c_int8 * n)()
    F.fribidi_get_bidi_types(u, n, types)
    F.fribidi_get_bracket_types(u, n, types, brackets)
    par = ctypes.c_uint32(0x40)
    assert F.fribidi_get_par_embedding_levels_ex(types, brackets, n, ctypes.byref(par), levels)
    vmap = (ctypes.c_int32 * n)(*range(n))
    F.fribidi_reorder_line(0, types, n, 0, par.value, levels, None, vmap)
    return list(levels), par.value, list(vmap)
out = []
for text in json.load(sys.stdin):
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        os.write(w, json.dumps(run(text)).encode())
        os._exit(0)
    os.close(w)
    data = b""
    while chunk := os.read(r, 1 << 16):
        data += chunk
    os.close(r)
    _, status = os.waitpid(pid, 0)
    out.append(json.loads(data) if status == 0 else None)
json.dump(out, sys.stdout)
"""


def _fribidi_apart(lines):
    """libfribidi's (levels, direction, map) of each line, each computed in
    a process of its own; None where libfribidi crashed."""
    done = subprocess.run([sys.executable, "-c", _CHILD], input=json.dumps(lines), capture_output=True, text=True,
                          check=True, timeout=300)
    return json.loads(done.stdout)


OPENS, CLOSES = "‪‫‭‮⁦⁧⁨", "‬⁩"


def _separator_lines(n: int, seed: int):
    """Lines with an isolate still open at a paragraph separator and text
    after it."""
    rng = np.random.default_rng(seed)
    names = list(POOLS)

    def some(k):
        return "".join(rng.choice(list(POOLS[names[int(rng.integers(len(names)))]])) for _ in range(k))

    return [some(int(rng.integers(1, 14))) + str(rng.choice(list("⁦⁧⁨"))) + some(int(rng.integers(0, 10)))
            + str(rng.choice(list(POOLS["B"]))) + some(int(rng.integers(1, 14))) for _ in range(n)]


def _overflow_lines(n: int, seed: int):
    """Lines of more than 62 initiators: mostly embedding and isolate
    controls between a few closers and the other types, so that pushes
    pass depth 125."""
    rng = np.random.default_rng(seed)
    others = "".join(v for k, v in POOLS.items() if k not in ("X", "I"))
    lines = []
    while len(lines) < n:
        p_close, p_open = rng.uniform(0.0, 0.3), rng.uniform(0.3, 0.9)
        parts = []
        for _ in range(int(rng.integers(63, 260))):
            r = rng.random()
            parts.append(str(rng.choice(list(OPENS if r < p_open else CLOSES if r < p_open + p_close else others))))
        if sum(c in OPENS for c in parts) > 62:
            lines.append("".join(parts))
    return lines


@pytest.mark.parametrize("part", range(2))
def test_lines_with_an_isolate_open_at_a_separator_equal_fribidi(part):
    """2 x 1000 seeded lines: FriBiDi stops its explicit rules at the B,
    which keeps the open isolate's depth, and merges the neutrals after it
    into that isolate's sequence."""
    for t in _separator_lines(1000, SEED + 1 + part):
        assert "\r" in t or "\x1c" in t or "\x85" in t or "\u2029" in t
        _check(t)


@pytest.mark.parametrize("part", range(2))
def test_lines_past_62_controls_equal_fribidi(part):
    """2 x 300 seeded lines of 63 or more initiators: every line libfribidi
    returns from has its levels, direction and map (it crashes on a few
    percent of them, where isolates overflow inside overflowed
    embeddings)."""
    lines = _overflow_lines(300, SEED + 3 + part)
    results = _fribidi_apart(lines)
    crashed = 0
    for t, r in zip(lines, results):
        if r is None:
            crashed += 1
            continue
        _check(t, (r[0], r[1], r[2]))
    assert crashed < 30, crashed


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
