"""Text pages in the complex scripts, shaped as the reference shapes them,
on the CPU. Tolerance: exact (uint8 pixels; glyph ids, advances and
offsets in 26.6).

DejaVu Sans, the reference's font, has OpenType scripts for Thai, Lao and
Tifinagh only, and glyphs for Lao, Tifinagh and one Thai sign; the other
complex scripts are `.notdef` boxes. HarfBuzz 12 still runs the shaper it
picks for each run (`glyph_atlas.hb_ot_shaper_categorize`), and that sets
how many boxes a page shows and where its dotted circles go. Held here:

- the shaper choice through the probes that decided it (a broken cluster
  after a space and at a line's start, Khmer's Coeng Ro and pre-base
  vowels beside a dotted circle, Thai / Lao SARA AM with tone marks, Lao's
  GPOS marks, Hangul tone marks after a syllable, after jamo and alone):
  fixed glyph ids as Pillow's HarfBuzz 12.3 gave them, and Pillow's own
  HarfBuzz (`glyph_atlas.HarfBuzz`) run for run, clusters too;
- seeded lines (numpy, `SEED`) of every newly drawn script with ZWJ /
  ZWNJ, digits, dandas, spaces, marks and Latin, Arabic, Hebrew, Greek
  and Cyrillic neighbours, `LINES` of each kind: each raqm run equal to
  HarfBuzz's at 18 and 12 px (`KINDS` x `LINES` x 2 sizes runs of lines),
  and the lines, a page at a time, pixel-equal to the JAX package's
  `_render_text_page` at dpi 150 and 100;
- the Khmer syllable machine on every sequence of three of its categories
  (after a Khmer letter and after a sign that ends a syllable), and the
  Khmer and USE categories of every character a Khmer, a Tifinagh or an
  N'Ko run may hold (the nonspacing marks of every script among them),
  each in the contexts that tell its category;
- the shapers' rules where DejaVu Sans does not reach them (a font with
  Hangul syllables, a font with Khmer's split-vowel parts).
"""

import unicodedata

import numpy as np
import pytest

from morphik_core_tpu.parser.pdf import _render_text_page
from morphik_core_tpu_torch.parser import glyph_atlas, hangul, khmer, text_render, thai
from morphik_core_tpu_torch.parser.text_render import (
    ARABIC_SHAPER, DEFAULT_SHAPER, HANGUL_SHAPER, HEBREW_SHAPER, HIDDEN, INDIC_SHAPER, KHMER_SHAPER,
    MYANMAR_SHAPER, THAI_SHAPER, USE_SHAPER, load_font, render_text_page)


SEED = 22
LINES = 60   # seeded lines of each kind
DOTTED, NOTDEF, SPACE = 3748, 0, 3

# (text, glyph ids at 18 px as Pillow's HarfBuzz 12.3 gives them): the probes that decided the shaper choice
PROBES = {
    # the default shaper under DFLT: one box a code point, no dotted circle for a broken cluster mid-line
    "devanagari_broken": ("क ि", [NOTDEF, SPACE, NOTDEF]),
    "bengali_broken": ("ক ো", [NOTDEF, SPACE, NOTDEF]),
    "tamil_broken": ("க ொ", [NOTDEF, SPACE, NOTDEF]),
    "myanmar_broken": ("က ြ", [NOTDEF, SPACE, NOTDEF]),
    "tibetan_broken": ("ཀ ོ", [NOTDEF, SPACE, NOTDEF]),
    "sinhala_broken": ("ක ා", [NOTDEF, SPACE, NOTDEF]),
    "javanese_broken": ("ꦗ ꦶ", [NOTDEF, SPACE, NOTDEF]),
    "bengali_split_matra": ("কো", [NOTDEF, NOTDEF]),
    "tamil_split_matra": ("கொ", [NOTDEF, NOTDEF]),
    "devanagari_zwj": ("क्‍ष", [NOTDEF, NOTDEF, SPACE, NOTDEF]),
    "devanagari_line_start": ("ि", [DOTTED, NOTDEF]),
    "mongolian_fvs": ("ᠮ᠋ᠣ", [NOTDEF, SPACE, NOTDEF]),
    "syriac_mark_after_latin": ("aܰ", [68, NOTDEF]),
    "syriac": ("ܫܠܡܐ", [NOTDEF] * 4),
    # the Thai shaper: SARA AM splits
    "thai_sara_am": ("ำ", [NOTDEF, NOTDEF]),
    "thai_sara_am_broken": ("ก ำ", [NOTDEF, SPACE, NOTDEF, NOTDEF]),
    "thai_baht": ("฿", [1570]),
    "lao_sara_am": ("ກຳ", [1571, 1623, 1601]),
    "lao_nikhahit_before_tone": ("ກ່ຳ", [1571, 1623, 1618, 1601]),
    "lao_marks": ("ເກົ່າ", [1612, 1571, 1609, 1618, 1601]),
    "lao_nikhahit_before_mai_kon": ("ກົຳ", [1571, 1623, 1609, 1601]),
    # the Khmer shaper under DFLT: dotted circles, Coeng Ro and the pre-base vowels in front
    "khmer_broken_above": ("ក ើ", [NOTDEF, SPACE, DOTTED, NOTDEF]),
    "khmer_broken_pre_base": ("ក េ", [NOTDEF, SPACE, NOTDEF, DOTTED]),
    "khmer_broken_coeng_ro": ("ក ្រ", [NOTDEF, SPACE, NOTDEF, NOTDEF, DOTTED]),
    "khmer_line_start": ("ែក", [NOTDEF, DOTTED, NOTDEF]),
    "khmer_pre_base_on_digit": ("ក 5េ", [NOTDEF, SPACE, NOTDEF, 24]),
    "khmer_coeng_ro_on_digit": ("ក 5្រ", [NOTDEF, SPACE, NOTDEF, NOTDEF, 24]),
    "khmer_robatic_broken": ("ក។៉", [NOTDEF, NOTDEF, DOTTED, NOTDEF]),
    # USE under tfng: U+2D7F after a letter or a space is no broken cluster, a second one is
    "tifinagh": ("ⵜⴰⵎⴰⵣⵉⵖⵜ", [4685, 4641, 4671, 4641, 4692, 4666, 4679, 4685]),
    "tifinagh_joiner_after_space": ("ⵜ ⵿", [4685, SPACE, NOTDEF]),
    "tifinagh_joiner_line_start": ("⵿", [DOTTED, NOTDEF]),
    "tifinagh_second_joiner": ("ⵜ⵿⵿", [4685, NOTDEF, DOTTED, NOTDEF]),
    "tifinagh_joiner_after_bracket": ("ⵜ]⵿", [4685, 64, DOTTED, NOTDEF]),
    # the Hangul shaper: nothing composes (no syllables in the font); tone marks
    "jamo_lvt": ("\u1100\u1161\u11a8", [NOTDEF] * 3),
    "syllable_lv_t": ("\uac00\u11a8", [NOTDEF] * 2),
    "tone_mark_after_syllable": ("\ud55c\u302e", [NOTDEF, NOTDEF, DOTTED]),
    "tone_mark_after_jamo": ("\u1100\u1161\u302e", [NOTDEF] * 3),
    "tone_mark_alone": ("\u302e", [DOTTED, NOTDEF, DOTTED]),
    "tone_mark_after_latin": ("a\u302f", [68, NOTDEF, DOTTED]),
    "tone_mark_before_marks": ("\u302f\u1dca\u0301", [DOTTED, NOTDEF, NOTDEF, DOTTED, 690]),
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
    advance, offsets; the cluster too but after the Thai and Hangul
    preprocessing) -> None where all are equal, else the first that
    differs."""
    font = load_font(dpi)
    cps = [ord(c) for c in line]
    for start, end, script, rtl in font.runs(line):
        n = 4 if font.script_shapers[script] in (THAI_SHAPER, HANGUL_SHAPER) else 5
        got = [(font.glyphs[t], a, x, y, c)[:n] for t, a, x, y, c in font.shape_run(cps, start, end, script, rtl,
                                                                                       True)]
        want = [tuple(g)[:n] for g in harfbuzz.shape(line, start, end, codes[script], rtl,
                                                     text_render.font_size(dpi), clusters=True)]
        if got != want:
            return line, start, end, codes[script], rtl, dpi, got, want
    return None


def _glyphs(line: str, dpi: int = 150) -> list:
    font = load_font(dpi)
    cps = [ord(c) for c in line]
    return [font.glyphs[t] for run in font.runs(line) for t, *_ in font.shape_run(cps, *run)]


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_strings_shape_as_harfbuzz(name, harfbuzz, codes):
    text, glyphs = PROBES[name]
    assert _glyphs(text) == glyphs
    for dpi in (150, 100):
        assert _runs_equal(text, harfbuzz, codes, dpi) is None


def test_lao_marks_are_placed_by_gpos():
    """ເກົ່າ: mai kon 5 px down and the tone mark 6 px up (1/64 px: -5 and 6
    at 18 px after rounding as HarfBuzz does), both without advance."""
    font = load_font(150)
    line = "ເກົ່າ"
    out = font.shape_run([ord(c) for c in line], 0, len(line), *font.runs(line)[0][2:])
    assert [(font.glyphs[t], a, y) for t, a, _, y, _ in out] == [
        (1612, 432, 0), (1571, 772, 0), (1609, 0, -5), (1618, 0, 6), (1601, 621, 0)]


# complex runs at odd bidi levels (overrides, embeddings, isolates, right-to-left paragraphs) and beside
# the joining scripts
BIDI_LINES = {
    "khmer_override": "\u202eសួស្តី ពិភពលោក ក ើ\u202c x",
    "thai_lao_override": "\u202eสวัสดี ก่ำ ກ່ຳ ເກົ່າ\u202c",
    "hangul_tone_override": "\u202e\u1100\u1161\u302e \ud55c\u302e\u202c",
    "tifinagh_override": "\u202eⵜ⵿⵿ ⵜⴰⵎⴰ\u202c",
    "khmer_in_hebrew": "שלום ក្រើ עולם",
    "tifinagh_in_hebrew": "שלום ⵜ⵿⵿ עולם",
    "thai_in_arabic": "مرحبا กำ سلام",
    "devanagari_embedding": "\u202bसंस्कृत abc\u202c",
    "syriac_with_latin": "ܫܠܡܐ abc ܥܠܡܐ",
    "adlam_mongolian_beside_arabic": "𞤀𞤣𞤤 ا ᠮᠣᠩ ا ابت ᠮᠣᠩ",
    "khmer_tifinagh_isolates": "\u2067ក ើ\u2069 x \u2067ⵜ ⵿ ⵜ⵿⵿\u2069",
}


@pytest.mark.parametrize("name", list(BIDI_LINES))
def test_complex_runs_in_bidi_contexts_match_harfbuzz_and_pixels(name, harfbuzz, codes):
    line = BIDI_LINES[name]
    for dpi in (150, 100):
        assert _runs_equal(line, harfbuzz, codes, dpi) is None
        assert np.array_equal(render_text_page(line, dpi), np.asarray(_render_text_page(line, dpi)))


# ------------------------------------------------------------ the shaper rule


@pytest.mark.parametrize("script,tag,shaper", [
    ("Deva", "DFLT", DEFAULT_SHAPER), ("Deva", "latn", DEFAULT_SHAPER), ("Deva", "dev2", INDIC_SHAPER),
    ("Deva", "dev3", USE_SHAPER), ("Taml", "taml", INDIC_SHAPER), ("Mymr", "DFLT", DEFAULT_SHAPER),
    ("Mymr", "mymr", DEFAULT_SHAPER), ("Mymr", "mym2", MYANMAR_SHAPER), ("Khmr", "DFLT", KHMER_SHAPER),
    ("Khmr", "khmr", KHMER_SHAPER), ("Thai", "DFLT", THAI_SHAPER), ("Laoo", "lao ", THAI_SHAPER),
    ("Hang", "DFLT", HANGUL_SHAPER), ("Hebr", "hebr", HEBREW_SHAPER), ("Arab", "DFLT", ARABIC_SHAPER),
    ("Syrc", "DFLT", DEFAULT_SHAPER), ("Syrc", "syrc", ARABIC_SHAPER), ("Sinh", "DFLT", DEFAULT_SHAPER),
    ("Sinh", "sinh", USE_SHAPER), ("Tfng", "tfng", USE_SHAPER), ("Nkoo", "nko ", USE_SHAPER),
    ("Mong", "DFLT", DEFAULT_SHAPER), ("Adlm", "latn", DEFAULT_SHAPER), ("Latn", "latn", DEFAULT_SHAPER),
    ("Grek", "grek", DEFAULT_SHAPER)])
def test_shaper_categorize_follows_harfbuzz(script, tag, shaper):
    """`hb_ot_shaper_categorize`: script and chosen tag, with the DFLT /
    latn give-way branches of the Indic, Myanmar and USE shapers."""
    assert glyph_atlas.hb_ot_shaper_categorize(script, tag) == shaper


def test_atlas_shapers_are_the_rule_on_the_fonts_tags():
    """The atlas's shaper of each script is the rule applied to the tag
    HarfBuzz chooses in DejaVu Sans; the port mirrors every one of them
    (N'Ko's USE with joining the last), so no script is refused."""
    with np.load(text_render.ATLAS_PATH) as z:
        codes = [str(c) for c in z["scripts"]]
        tags = [str(t) for t in z["tags"]]
        shapers, script_tags = z["script_shapers"].tolist(), z["script_tags"].tolist()
    font_tags = set(tags)
    assert {"thai", "lao ", "tfng", "DFLT"} <= font_tags and not {"deva", "dev2", "khmr", "mymr"} & font_tags
    for k, c in enumerate(codes):
        assert tags[script_tags[k]] == glyph_atlas.script_tag(c, font_tags), c
        assert shapers[k] == glyph_atlas.hb_ot_shaper_categorize(c, tags[script_tags[k]]), c
    refused = {c for k, c in enumerate(codes) if not glyph_atlas.mirrored(c, shapers[k])}
    assert refused == set()
    assert shapers[codes.index("Nkoo")] == USE_SHAPER and tags[script_tags[codes.index("Nkoo")]] == "nko "
    assert np.array_equal(render_text_page("ߒߞߏ", 150), np.asarray(_render_text_page("ߒߞߏ", 150)))


# ------------------------------------------------------- seeded runs and pages

KINDS = ["indic", "sinhala_tibetan_myanmar", "other_use_scripts", "thai_lao", "khmer", "tifinagh",
         "syriac_adlam_mongolian", "hangul_jamo", "mixed"]
_SCRIPTS = {
    "indic": "Deva Beng Guru Gujr Orya Taml Telu Knda Mlym",
    "sinhala_tibetan_myanmar": "Sinh Tibt Mymr",
    "other_use_scripts": "Java Bali Sund Lana Cham Bugi Tglg Limb Tale Tavt Batk Brah Shrd Takr Tirh Modi Gran Mtei "
                         "Saur Lepc Kali",
    "thai_lao": "Thai Laoo",
    "khmer": "Khmr",
    "tifinagh": "Tfng",
    "syriac_adlam_mongolian": "Syrc Adlm Mong",
    "hangul_jamo": "Hang",
    "mixed": "Deva Beng Taml Sinh Thai Laoo Khmr Mymr Tibt Tfng Syrc Mong Hang Latn Arab Hebr Grek Cyrl",
}
# the neighbours: spaces, joiners, digits, dandas, no-break space, dashes, the dotted circle, Latin, Arabic and
# Inherited marks, Arabic and Hebrew letters, brackets, bidi marks, CGJ, a variation selector
_EXTRA = [0x20] * 6 + [0x200C, 0x200D, 0x30, 0x35, 0x39, 0x0964, 0x0965, 0xA0, 0x2D, 0x2010, 0x25CC, 0x0301, 0x0323,
                       0x0627, 0x0644, 0x0628, 0x05D0, 0x61, 0x56, 0x28, 0x29, 0x5B, 0x5D, 0x2E, 0x2C, 0x200E,
                       0x200F, 0x034F, 0xFE00, 0x200B, 0xAD, 0x2060]


def _pools():
    with np.load(text_render.ATLAS_PATH) as z:
        codes = np.array([str(c) for c in z["scripts"]])
        cps = np.arange(0x110000)
        script = codes[z["script_values"][np.searchsorted(z["script_starts"], cps, side="right") - 1]]
        cls = z["class_values"][np.searchsorted(z["class_starts"], cps, side="right") - 1]
    drawn = np.isin(cls, (text_render.GLYPH, text_render.NOTDEF, text_render.COMPOSES, HIDDEN))
    pools = {s: cps[drawn & (script == s)].tolist() for s in set(" ".join(_SCRIPTS.values()).split())}
    # jamo rather than syllables, and the tone marks
    pools["Hang"] = [c for c in pools["Hang"] if not 0xAC00 <= c <= 0xD7A3] + [0x302E, 0x302F] * 8 + [0xAC00, 0xD55C]
    inherited = cps[drawn & (script == "Zinh")].tolist()
    return pools, inherited


def complex_lines(kind: str, n: int = LINES) -> list:
    """`n` seeded lines of `kind`, each short of a page's `max_chars`: the
    kind's scripts, a quarter of the characters from `_EXTRA` and the
    Inherited marks (a nonspacing mark of another complex script after a
    Khmer or Tifinagh letter joins its run, which reads the mark's
    syllable category)."""
    pools, inherited = _pools()
    scripts = _SCRIPTS[kind].split()
    rng = np.random.default_rng([SEED, KINDS.index(kind)])
    lines = []
    while len(lines) < n:
        out = []
        for _ in range(int(rng.integers(1, 40))):
            r = rng.random()
            if r < 0.75:
                pool = pools[scripts[int(rng.integers(len(scripts)))]]
            elif r < 0.93:
                pool = _EXTRA
            else:
                pool = inherited
            out.append(int(pool[int(rng.integers(len(pool)))]))
        lines.append("".join(map(chr, out)))
    return lines


@pytest.mark.parametrize("kind", KINDS)
def test_complex_runs_match_harfbuzz(kind, harfbuzz, codes):
    for dpi in (150, 100):
        for line in complex_lines(kind):
            assert _runs_equal(line, harfbuzz, codes, dpi) is None


@pytest.mark.parametrize("dpi", [150, 100])
@pytest.mark.parametrize("kind", KINDS)
def test_complex_lines_match_reference_pixels(kind, dpi):
    lines = complex_lines(kind)
    got = render_text_page("\n".join(lines), dpi)
    want = np.asarray(_render_text_page("\n".join(lines), dpi))
    if not np.array_equal(got, want):   # name the first line drawn otherwise
        for line in lines:
            assert np.array_equal(render_text_page(line, dpi), np.asarray(_render_text_page(line, dpi))), repr(line)
    assert np.array_equal(got, want)


# --------------------------------------------------- the syllable categories

_KHMER_CATEGORIES = {"X": 0x17D4, "C": 0x1780, "Ra": 0x179A, "V": 0x17A5, "H": 0x17D2, "ZWNJ": 0x200C,
                     "ZWJ": 0x200D, "PLACEHOLDER": 0x35, "DOTTEDCIRCLE": 0x25CC, "VAbv": 0x17B7, "VBlw": 0x17BB,
                     "VPre": 0x17C1, "VPst": 0x17B6, "Robatic": 0x17C9, "Xgroup": 0x17C6, "Ygroup": 0x17C7}


@pytest.mark.parametrize("first", list(_KHMER_CATEGORIES))
def test_khmer_machine_matches_harfbuzz_on_every_three_categories(first, harfbuzz, codes):
    """Every sequence of three Khmer categories (`first` then any two),
    after a sign that ends a syllable and after a consonant, at 18 px."""
    reps = list(_KHMER_CATEGORIES.values())
    for prefix in ("។", "ក"):
        for b in reps:
            for c in reps:
                line = prefix + chr(_KHMER_CATEGORIES[first]) + chr(b) + chr(c)
                assert _runs_equal(line, harfbuzz, codes, 150) is None


def _run_candidates(own: str) -> list:
    """What a run of `own`'s script can hold: its characters, the Common
    and Inherited ones and the nonspacing marks of every script."""
    with np.load(text_render.ATLAS_PATH) as z:
        codes = np.array([str(c) for c in z["scripts"]])
        cps = np.arange(0x110000)
        script = codes[z["script_values"][np.searchsorted(z["script_starts"], cps, side="right") - 1]]
        cls = z["class_values"][np.searchsorted(z["class_starts"], cps, side="right") - 1]
    drawn = np.isin(cls, (text_render.GLYPH, text_render.NOTDEF, text_render.COMPOSES, HIDDEN))
    return [cp for cp in cps[drawn].tolist()
            if cp != 0x0A and (script[cp] in (own, "Zyyy", "Zinh") or unicodedata.category(chr(cp)) == "Mn")]


@pytest.mark.parametrize("which", ["khmer", "use", "nko"])
def test_syllable_categories_of_every_run_character_match_harfbuzz(which, harfbuzz, codes):
    """Each character a Khmer (Tifinagh, N'Ko) run may hold, the
    nonspacing marks of every script among them, between the contexts
    that tell its category: before an above vowel sign and a Coeng Ro,
    after a Coeng (before and after U+2D7F; around N'Ko's tone marks), at
    18 px."""
    own = {"khmer": "Khmr", "use": "Tfng", "nko": "Nkoo"}[which]
    contexts = {"khmer": [("។", "ិ"), ("ក", "្រ"), ("ក្", "េ")],
                "use": [("ⵜ", "⵿"), ("ⵜ⵿", "⵿"), ("ⵜ ", "⵿")],
                "nko": [("ߞ", "߫"), ("ߞ߫", "ߞ"), ("ߞ ", "߲")]}[which]
    bad = []
    for cp in _run_candidates(own):
        for a, b in contexts:
            if _runs_equal(a + chr(cp) + b, harfbuzz, codes, 150) is not None:
                bad.append(hex(cp))
                break
    assert not bad, bad


@pytest.mark.parametrize("text", ["ក्", "ⵜ्", "ߞ्", "ក\u0bcd", "ⵜ\u0bcd", "ក\u1039", "ⵜ\u1b6b", "ߞ\u0941ߞ"])
def test_foreign_marks_in_khmer_tifinagh_and_nko_runs_match_harfbuzz(text, harfbuzz, codes):
    """A virama, a vowel sign or a symbol mark of another script after a
    Khmer, Tifinagh or N'Ko letter joins its run (raqm), where HarfBuzz
    reads its syllable category (the Devanagari virama is a Coeng to the
    Khmer machine); the atlas holds the category, and the run, its page
    and the same mark after a Latin letter are drawn as the reference
    draws them."""
    for dpi in (150, 100):
        assert _runs_equal(text, harfbuzz, codes, dpi) is None
        for line in (text, "a" + text[1:]):
            assert np.array_equal(render_text_page(line, dpi), np.asarray(_render_text_page(line, dpi)))


# ------------------------------------------------ the rules the font misses


def test_thai_preprocess_moves_nikhahit_over_above_marks():
    assert thai.preprocess([0x0E14, 0x0E4B, 0x0E33]) == [0x0E14, 0x0E4D, 0x0E4B, 0x0E32]
    assert thai.preprocess([0x0E81, 0x0EBB, 0x0EC8, 0x0EB3]) == [0x0E81, 0x0ECD, 0x0EBB, 0x0EC8, 0x0EB2]
    assert thai.preprocess([0x0E01, 0x0E38, 0x0E33]) == [0x0E01, 0x0E38, 0x0E4D, 0x0E32]   # a below mark stays
    assert thai.preprocess([0x0E01, 0x0E4D]) == [0x0E01, 0x0E4D]


def test_hangul_composes_where_a_font_maps_the_syllable():
    """With a font that maps every syllable and jamo: L V T composes, LV T
    composes, an unmapped LV decomposes, and a tone mark after a valid
    syllable moves in front of it (unless zero-width)."""
    every = lambda cp: True   # noqa: E731
    none = lambda cp: False   # noqa: E731
    assert hangul.preprocess([0x1100, 0x1161, 0x11A8], every, none)[0] == [0xAC01]
    assert hangul.preprocess([0xAC00, 0x11A8], every, none)[0] == [0xAC01]
    assert hangul.preprocess([0xAC01], lambda cp: cp != 0xAC01, none)[0] == [0x1100, 0x1161, 0x11A8]
    assert hangul.preprocess([0xAC00, 0x302E], every, none)[0] == [0x302E, 0xAC00]
    assert hangul.preprocess([0xAC00, 0x302E], every, every)[0] == [0xAC00, 0x302E]
    cps, props = hangul.preprocess([0x61, 0x302F], lambda cp: cp in (0x61, 0x25CC), none)
    assert cps == [0x61, 0x302F, 0x25CC] and props == [0x61, 0x302F, 0x302F]


def test_khmer_split_vowels_decompose_where_the_font_maps_the_parts():
    step = text_render.load_font(150).khmer_decomposition
    assert text_render.decompose(0x17BE, False, {0x17C1, 0x17BE}, step) == [0x17C1, 0x17BE]
    assert text_render.decompose(0x17BE, False, {0x17C1}, step) is None


def test_khmer_dotted_circles_skip_a_repeated_serial():
    """HarfBuzz numbers syllables 1..15 and gives no dotted circle to a
    broken cluster whose number equals the last broken one's."""
    from morphik_core_tpu_torch.parser.syllables import dotted_starts
    found = [(k, k + 1, khmer.BROKEN_CLUSTER if k in (4, 19, 21) else khmer.CONSONANT_SYLLABLE) for k in range(23)]
    assert dotted_starts(found, khmer.BROKEN_CLUSTER) == [4, 21]
