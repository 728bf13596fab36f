"""N'Ko, the Arabic letters newer than FriBiDi's data, Ahom's medial ra and
the marks of other scripts inside Khmer, Tifinagh and N'Ko runs, shaped as
the reference shapes them, on the CPU. Tolerance: exact (uint8 pixels;
glyph ids, HarfBuzz clusters, advances and offsets in 26.6).

DejaVu Sans serves N'Ko under its own `nko ` tag (GSUB ccmp, init, medi,
fina; GPOS kern, mark), so HarfBuzz 12 shapes it with USE and the Arabic
joining; the newer Arabic letters are `.notdef` boxes that join; U+1171E
is a spacing mark in HarfBuzz's Unicode 17 (nonspacing in Python's 15.0),
so raqm starts an Ahom run at it. Held here:

- probe strings (N'Ko joining across ZWNJ, ZWJ, tatweel, lajanyalan and
  marks, not across a CGJ that keeps two marks apart, tone marks stacked, after a space and at a line's start, the
  dantayalan, digits and punctuation, N'Ko beside Arabic; the newer
  Arabic letters beside behs and before digits, "%" and signs in both
  paragraph directions; Ahom's medial ra) at fixed glyph ids as Pillow's
  HarfBuzz 12.3 gave them, and run for run against Pillow's HarfBuzz
  (`glyph_atlas.HarfBuzz`): ids, clusters, advances and offsets at 18
  and 12 px;
- seeded lines (numpy, `SEED`) that mix N'Ko with Arabic, the newer
  Arabic letters, Latin, digits, tatweel, lajanyalan, ZWJ / ZWNJ and
  every bidi control, in both paragraph directions (`KINDS`): each raqm
  run against HarfBuzz at 18 and 12 px, and the lines, a page at a time,
  pixel-equal to the JAX package's `_render_text_page` at dpi 150 and
  100;
- every N'Ko mark and every nonspacing mark of another script after the
  base of each kind of run (Latin, Arabic, Hebrew, N'Ko, Khmer,
  Tifinagh, Devanagari, a digit), run for run against HarfBuzz; every
  ordered pair of the foreign marks whose USE categories (medial and
  final) are ordered within a cluster, after a Tifinagh and an N'Ko
  base;
- `arabic.use_joining_actions` on the rule the probes showed.
"""

import unicodedata

import numpy as np
import pytest

from morphik_core_tpu.parser.pdf import _render_text_page
from morphik_core_tpu_torch.parser import arabic, glyph_atlas, text_render, use
from morphik_core_tpu_torch.parser.text_render import COMPOSES, GLYPH, NOTDEF, load_font, render_text_page

SEED = 23
LINES = 40   # seeded lines of each kind

# (text, glyph ids at 18 px in visual order as Pillow's HarfBuzz 12.3 gives them)
PROBES = {
    "nko_word": ("ߒߞߏ", [6040, 6086, 6051]),
    "nko_tone_marks": ("ߞ߫߬ ߊ߲", [1563, 1526, 3, 1557, 1556, 1546]),
    "nko_tone_after_space": ("ߞ ߫", [1556, 3, 1546]),
    "nko_tone_line_start": ("߫ߞ", [1546, 1556, 3748]),
    "nko_dantayalan": ("ߞ߽ߞ", [6085, 0, 6087]),
    "nko_lajanyalan": ("ߞߺߞ", [6085, 1569, 6087]),
    "nko_tatweel": ("ߞـߞ", [6085, 1385, 6087]),
    "nko_zwnj_inside": ("ߞ‌ߞ", [6085, 3, 6087]),
    "nko_zwnj_twice": ("ߞ‌‌ߞ", [6085, 3, 3748, 3, 6087]),
    "nko_zwj": ("‍ߞߞ", [6085, 6086, 3]),
    "nko_cgj_held": ("ߑ߱͏߲ߠߞ", [6085, 6093, 1563, 3, 1562, 6048]),
    "nko_digits": ("ߒ ߁߂߃ 12", [20, 21, 3, 1519, 1518, 1517, 3, 1534]),
    "nko_apostrophes": ("ߞߴ ߞߵ ߸ ߹ ߷", [0, 3, 1568, 3, 1567, 3, 1566, 1546, 3, 1565, 1546]),
    "nko_beside_arabic": ("بߞب ߞبߞ", [6085, 5260, 6087, 3, 5258, 6086, 5259]),
    "nko_virama_inside": ("ߞ्ߞ", [6085, 0, 6087]),
    "arabic_newer_beh": ("بࡰ ࢉب بࢾب", [5258, 0, 5259, 3, 5258, 0, 3, 0, 5259]),
    "arabic_newer_digits": ("ࡰ12% ࢾ-3 ࣇ+7", [26, 14, 0, 3, 22, 16, 0, 3, 20, 21, 8, 0]),
    "arabic_newer_ltr_paragraph": ("a ࡰ12% ࢾ-3", [68, 3, 22, 16, 0, 3, 20, 21, 8, 0]),
    "ahom_medial_ra": ("𑜀𑜞𑜁", [0, 0, 0]),
    "ahom_medial_ra_after_latin": ("a𑜞", [68, 0]),
    # two foreign marks whose USE categories are ordered within a cluster (FBLW, then FPST): in order one
    # cluster, out of order a broken cluster at the second, also at a line's start
    "foreign_marks_in_cluster_order": ("ߞ\U00011a93\u17cb", [0, 0, 1546]),
    "foreign_marks_out_of_cluster_order": ("ߞ\u17cb\U00011a93", [0, 3748, 0, 1546]),
    "foreign_marks_out_of_order_at_line_start": ("\u17cb\U00011a93ߞ", [1546, 0, 3748, 0, 3748]),
}


@pytest.fixture(scope="module")
def harfbuzz():
    return glyph_atlas.HarfBuzz()


@pytest.fixture(scope="module")
def codes():
    with np.load(text_render.ATLAS_PATH) as z:
        return [str(c) for c in z["scripts"]]


def _runs_equal(line: str, harfbuzz, codes, dpi: int):
    """Each raqm run of `line` shaped by the mirror and by HarfBuzz (glyph,
    advance, offsets, cluster) -> None where all are equal, else the first
    that differs."""
    font = load_font(dpi)
    cps = [ord(c) for c in line]
    for start, end, script, rtl in font.runs(line):
        got = [(font.glyphs[t], a, x, y, c) for t, a, x, y, c in font.shape_run(cps, start, end, script, rtl, True)]
        want = [tuple(g) for g in harfbuzz.shape(line, start, end, codes[script], rtl, text_render.font_size(dpi),
                                                 clusters=True)]
        if got != want:
            return line, start, end, codes[script], rtl, dpi, got, want
    return None


def _pages_equal(lines, dpi: int) -> None:
    got = render_text_page("\n".join(lines), dpi)
    want = np.asarray(_render_text_page("\n".join(lines), dpi))
    if not np.array_equal(got, want):   # name the first line drawn otherwise
        for line in lines:
            assert np.array_equal(render_text_page(line, dpi), np.asarray(_render_text_page(line, dpi))), repr(line)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_strings_shape_as_harfbuzz(name, harfbuzz, codes):
    text, glyphs = PROBES[name]
    font = load_font(150)
    cps = [ord(c) for c in text]
    assert [font.glyphs[t] for run in font.runs(text) for t, *_ in font.shape_run(cps, *run)] == glyphs
    for dpi in (150, 100):
        assert _runs_equal(text, harfbuzz, codes, dpi) is None
        assert np.array_equal(render_text_page(text, dpi), np.asarray(_render_text_page(text, dpi)))


def test_nko_joins_on_the_runs_own_joining_first():
    """`use_joining_actions`: where the run's own joining (ZWNJ
    transparent, no context) joins two letters, neither joins across the
    run's ends; a letter it leaves isolated takes the ordinary joining
    with the context (ZWNJ non-joining)."""
    U, D, T = arabic.U, arabic.D, arabic.T
    # K ZWNJ K inside one run, a letter on each side in the line
    assert arabic.use_joining_actions([D, U, D], [D, T, D], [D], [D]) == [arabic.INIT, arabic.NONE, arabic.FINA]
    # K alone between letters of the line
    assert arabic.use_joining_actions([D], [D], [D], [D]) == [arabic.MEDI]
    # K ZWNJ at the run's end, a letter after it in the line: isolated
    assert arabic.use_joining_actions([D, U], [D, T], [], [D]) == [arabic.ISOL, arabic.NONE]
    # K tatweel K: tatweel is non-joining in the run's own joining, join-causing in the ordinary one
    assert arabic.use_joining_actions([D, D, D], [D, U, D], [D], [D]) == [arabic.MEDI, arabic.MEDI, arabic.MEDI]


def test_atlas_holds_no_refused_class_and_the_newer_tables():
    """The atlas refuses no script's shaper and finds no code point drawn
    otherwise; HarfBuzz's general category of U+1171E (Mc), the joining of
    the newer Arabic letters (U+0870 R, U+0889 and U+08BE D) and of the
    N'Ko letters, and N'Ko's own joining types are in it."""
    font = load_font(150)
    with np.load(text_render.ATLAS_PATH) as z:
        assert not set(z["class_values"].tolist()) & {text_render.SHAPER, text_render.MISDRAWN}
    assert font.category(0x1171E) == "Mc" and unicodedata.category(chr(0x1171E)) == "Mn"
    assert font.joining([0x0870, 0x0889, 0x08BE, 0x07DE, 0x07FA, 0x07FD]) == [
        arabic.R, arabic.D, arabic.D, arabic.D, arabic.D, arabic.T]
    assert font.use_joining([0x07DE, 0x07FA, 0x200D, 0x200C, 0x0640, 0x07FD, 0x07EB, 0x0628]) == [
        arabic.D, arabic.D, arabic.D, arabic.T, arabic.U, arabic.U, arabic.T, arabic.U]


# ------------------------------------------------------- seeded runs and pages

KINDS = ["nko", "nko_arabic_latin", "controls_ltr", "controls_rtl", "arabic_newer", "ahom"]
NKO = [cp for cp in range(0x07C0, 0x0800) if unicodedata.category(chr(cp)) != "Cn"]
ARABIC_NEWER = [*range(0x0870, 0x0887), *range(0x0889, 0x088F), 0x08B5, *range(0x08BE, 0x08C9)]
AHOM = [cp for cp in range(0x11700, 0x11747) if unicodedata.category(chr(cp)) != "Cn"] + [0x1171E] * 6
CONTROLS = [0x200E, 0x200F, 0x061C, 0x202A, 0x202B, 0x202C, 0x202D, 0x202E, 0x2066, 0x2067, 0x2068, 0x2069]
_EXTRA = [0x20] * 8 + [0x200C, 0x200D, 0x0640, 0x07FA, 0x30, 0x35, 0x39, 0x25, 0x2B, 0x2D, 0x28, 0x29, 0x2E, 0x2C,
                       0x0628, 0x0644, 0x0627, 0x0661, 0x05D0, 0x61, 0x56, 0x0301, 0x064E, 0x034F, 0x25CC]


def nko_lines(kind: str, n: int = LINES) -> list:
    """`n` seeded lines of `kind`, each short of a page's `max_chars`:
    N'Ko (its letters, digits, tone marks, dantayalan, apostrophes,
    lajanyalan and punctuation), Arabic and Latin neighbours, the newer
    Arabic letters, Ahom, joiners, tatweel and digits; the `controls_*`
    kinds add every bidi control and start with a strong character of
    the paragraph's direction."""
    rng = np.random.default_rng([SEED, KINDS.index(kind)])
    pools = {"nko": [NKO * 3, _EXTRA], "nko_arabic_latin": [NKO * 2, ARABIC_NEWER, _EXTRA * 2],
             "controls_ltr": [NKO * 2, _EXTRA, CONTROLS], "controls_rtl": [NKO * 2, _EXTRA, CONTROLS],
             "arabic_newer": [ARABIC_NEWER * 2, _EXTRA], "ahom": [AHOM, _EXTRA, NKO]}[kind]
    pool = [cp for p in pools for cp in p]
    lead = {"controls_ltr": "a ", "controls_rtl": "ߒ "}.get(kind, "")
    return [lead + "".join(chr(pool[int(rng.integers(len(pool)))]) for _ in range(int(rng.integers(1, 45))))
            for _ in range(n)]


@pytest.mark.parametrize("kind", KINDS)
def test_nko_runs_match_harfbuzz(kind, harfbuzz, codes):
    for dpi in (150, 100):
        for line in nko_lines(kind):
            assert _runs_equal(line, harfbuzz, codes, dpi) is None


@pytest.mark.parametrize("dpi", [150, 100])
@pytest.mark.parametrize("kind", KINDS)
def test_nko_lines_match_reference_pixels(kind, dpi):
    _pages_equal(nko_lines(kind), dpi)


# --------------------------------------------------- every mark on every base

BASES = {"latin": "a", "arabic": "ب", "hebrew": "א", "nko": "ߞ", "khmer": "ក", "tifinagh": "ⵜ", "devanagari": "क",
         "digit": "5"}


def _marks() -> list:
    """Every nonspacing mark the atlas draws (N'Ko's and every other
    script's), but the default-ignorable ones."""
    font = load_font(150)
    cps = [cp for cp in range(0x110000) if font.category(cp) == "Mn"]
    return [cp for cp, cls in zip(cps, font.classes(cps)) if cls in (GLYPH, NOTDEF, COMPOSES)]


@pytest.mark.parametrize("base", list(BASES))
def test_every_mark_after_each_kind_of_base_matches_harfbuzz(base, harfbuzz, codes):
    """A base of each kind of run, then each mark (in the base's run: raqm
    treats a nonspacing mark as Inherited), and a second of N'Ko's tone
    marks after it: HarfBuzz's glyphs, clusters and offsets at 18 px, and
    at 12 px for N'Ko's own marks."""
    bad = []
    for cp in _marks():
        line = BASES[base] + chr(cp) + "߫"
        for dpi in ((150, 100) if 0x07C0 <= cp < 0x0800 else (150,)):
            if _runs_equal(line, harfbuzz, codes, dpi) is not None:
                bad.append(hex(cp))
                break
    assert not bad, bad


@pytest.mark.parametrize("dpi", [150, 100])
@pytest.mark.parametrize("base", list(BASES))
def test_nko_marks_on_every_base_match_reference_pixels(base, dpi):
    """Each pair of N'Ko's marks on the base, a page of them."""
    marks = [cp for cp in range(0x07EB, 0x07FE) if unicodedata.category(chr(cp)) == "Mn"]
    _pages_equal([" ".join(BASES[base] + chr(m) + chr(m2) for m2 in marks) for m in marks], dpi)


@pytest.mark.parametrize("base", ["tifinagh", "nko"])
def test_pairs_of_ordered_foreign_marks_match_harfbuzz(base, harfbuzz, codes):
    """Every ordered pair of the other scripts' marks that the atlas holds
    as a medial or final consonant or a final modifier in a USE run: a
    broken cluster (a dotted circle) where HarfBuzz's categories put the
    second before the first. Single lines cannot tell these categories
    apart; the pairs are what the atlas generator settles them by."""
    font = load_font(150)
    ordered = {use.MPRE, use.MABV, use.MBLW, use.MPST, use.FABV, use.FBLW, use.FPST, use.FMABV, use.FMBLW,
               use.FMPST}
    marks = sorted(cp for cp, cat in font.use_categories.items() if cat in ordered)
    assert 0x17CB in marks and 0x11A93 in marks
    bad = [(hex(x), hex(y)) for x in marks for y in marks
           if _runs_equal(BASES[base] + chr(x) + chr(y), harfbuzz, codes, 150) is not None]
    assert not bad, bad
