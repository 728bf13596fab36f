"""Combining marks placed as the reference places them, on the CPU.
Tolerance: exact (uint8 pixels; glyph ids, advances and offsets in 26.6).

- Seeded lines (numpy) of a base and one to three marks in Latin,
  Cyrillic, Greek, Hebrew and Arabic (harakat, tanween, shadda stacks,
  lam-alef with marks), mixed-direction lines, and marks on digits and
  symbols (runs whose script tag has no GPOS `mark`: HarfBuzz leaves them
  unplaced, the font having a GPOS table), with the odd joiner between
  marks: `render_text_page` equals the reference's `_render_text_page`
  pixel for pixel at dpi 150 and 100, a page of lines at a time.
- Each raqm run of those lines, shaped by `ShapedFont.shape_run`, equals
  what Pillow's own HarfBuzz (hb-ft over Pillow's FreeType, through ctypes
  here only) gives for that run in that line: glyph for glyph, advance
  and x / y offset, at 18 and 12 px.
- The lines' bidi levels equal libfribidi's (marks are NSM, FriBiDi's W1).
"""

import unicodedata

import numpy as np
import pytest

from morphik_core_tpu.parser.pdf import _render_text_page
from morphik_core_tpu_torch.parser import bidi, glyph_atlas, marks, text_render
from morphik_core_tpu_torch.parser.text_render import GLYPH, load_font, render_text_page

from test_torch_bidi import FRIBIDI, _fribidi, _types

SEED = 21
LINES = 40   # a page of them
KINDS = ["latin", "cyrillic", "greek", "hebrew", "arabic", "mixed", "unplaced"]


def _atlas_pools():
    with np.load(text_render.ATLAS_PATH) as z:
        starts, values = z["class_starts"], z["class_values"]
        codes = np.array([str(c) for c in z["scripts"]])
        script = codes[z["script_values"][np.searchsorted(z["script_starts"], np.arange(0x110000), side="right") - 1]]
    cps = np.arange(0x110000)
    drawn = values[np.searchsorted(starts, cps, side="right") - 1] == GLYPH
    is_mark = np.zeros(0x110000, bool)
    is_mark[:0x30000] = [unicodedata.category(chr(c))[0] == "M" for c in range(0x30000)]
    letters = {s: cps[drawn & ~is_mark & (script == s)] for s in ("Latn", "Cyrl", "Grek", "Hebr", "Arab", "Zyyy")}
    mark_pools = {s: cps[drawn & is_mark & (script == s)] for s in ("Zinh", "Cyrl", "Hebr", "Arab")}
    return letters, mark_pools


HARAKAT = [chr(c) for c in range(0x064B, 0x0653)] + ["ٰ"]
JOINERS = "‌‍͏\xad"


def _word(rng, script, letters, mark_pools) -> str:
    """A base of `script` with 0-3 marks (the script's own and Inherited
    ones), now and then a joiner between them; an Arabic lam before an
    alef, with marks on both."""
    base = chr(int(rng.choice(letters[script])))
    own = {"Hebr": "Hebr", "Arab": "Arab", "Cyrl": "Cyrl"}.get(script)
    out = []
    for _ in range(int(rng.integers(0, 4))):
        if script == "Arab" and rng.random() < 0.7:
            out.append(HARAKAT[int(rng.integers(len(HARAKAT)))])
        elif own is not None and rng.random() < 0.6:
            out.append(chr(int(rng.choice(mark_pools[own]))))
        else:
            out.append(chr(int(rng.choice(mark_pools["Zinh"]))))
        if rng.random() < 0.05:
            out.append(JOINERS[int(rng.integers(len(JOINERS)))])
    word = base + "".join(out)
    if script == "Arab" and rng.random() < 0.2:
        word = "ل" + "".join(out) + "ا" + HARAKAT[int(rng.integers(len(HARAKAT)))] * int(rng.integers(2))
    return word


def mark_lines(kind: str, n: int = LINES):
    """`n` seeded lines of `kind`, each short of a page's `max_chars`."""
    letters, mark_pools = _atlas_pools()
    rng = np.random.default_rng([SEED, KINDS.index(kind)])
    scripts = {"latin": ["Latn"], "cyrillic": ["Cyrl"], "greek": ["Grek"], "hebrew": ["Hebr"], "arabic": ["Arab"],
               "mixed": ["Latn", "Cyrl", "Hebr", "Arab", "Grek"], "unplaced": ["Zyyy"]}[kind]
    lines = []
    while len(lines) < n:
        words = []
        for _ in range(int(rng.integers(1, 9))):
            words.append(_word(rng, scripts[int(rng.integers(len(scripts)))], letters, mark_pools))
        line = " ".join(words)
        if len(line) <= 60:
            lines.append(line)
    return lines


@pytest.mark.parametrize("dpi", [150, 100])
@pytest.mark.parametrize("kind", KINDS)
def test_mark_lines_match_reference_pixels(kind, dpi):
    lines = mark_lines(kind)
    got = render_text_page("\n".join(lines), dpi)
    want = np.asarray(_render_text_page("\n".join(lines), dpi))
    if not np.array_equal(got, want):   # name the first line drawn otherwise
        for line in lines:
            assert np.array_equal(render_text_page(line, dpi), np.asarray(_render_text_page(line, dpi))), repr(line)
    assert np.array_equal(got, want)


# Pillow's HarfBuzz over hb-ft on Pillow's FreeType, one run at a time as raqm calls it
_HarfBuzz = glyph_atlas.HarfBuzz


@pytest.fixture(scope="module")
def harfbuzz():
    return _HarfBuzz()


@pytest.mark.parametrize("kind", KINDS)
def test_mark_runs_match_harfbuzz(kind, harfbuzz):
    with np.load(text_render.ATLAS_PATH) as z:
        codes = [str(c) for c in z["scripts"]]
    for dpi in (150, 100):
        font = load_font(dpi)
        for line in mark_lines(kind):
            cps = [ord(c) for c in line]
            for start, end, script, rtl in font.runs(line):
                got = [(font.glyphs[t], a, x, y) for t, a, x, y, _ in font.shape_run(cps, start, end, script, rtl)]
                want = harfbuzz.shape(line, start, end, codes[script], rtl, text_render.font_size(dpi))
                assert got == want, (line, start, end, codes[script], rtl, dpi)


@pytest.mark.skipif(FRIBIDI is None, reason="libfribidi.so.0 (the reference's bidi) is not installed")
def test_mark_lines_bidi_levels_match_fribidi():
    for kind in KINDS:
        for line in mark_lines(kind):
            cps = [ord(c) for c in line]
            types, brackets = _types(cps)
            levels, par = bidi.embedding_levels(types, brackets)
            want, want_par, _, _, _ = _fribidi(line)
            assert levels == want and par == (1 if want_par & 1 else 0), line


def test_anchor_differences_round_halves_upwards():
    """HarfBuzz's own `roundf` is floor(x + 0.5): -4.5 px/64 rounds to -4
    (C's roundf gives -5; an Arabic kasratan on U+0699 at 12 px needs it).
    The anchors are held in 1/32 of a 26.6 unit (exact at odd sizes too)."""
    assert [marks._roundf(v) for v in (-144, -16, -18, 16, 14, 144, -48, -17, 15)] == [-4, 0, -1, 1, 0, 5, -1, -1, 0]
