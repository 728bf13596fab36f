"""The text pages' last refusals, drawn as the reference draws them, on the
CPU: HarfBuzz's Unicode 17 properties in the glyph atlas, the tone
letters' contour forms, ZWJ emoji in runs shaped against their direction,
code points new in Unicode 15.1-17, and the atlas's six font sizes.
Tolerance: exact (property values; glyph ids, advances and offsets in
26.6; uint8 pixels).

- Every code point's general category, combining class, canonical
  decomposition, script and Extended_Pictographic flag in the atlas, as
  the render path reads them, equal Pillow's HarfBuzz 12 (through ctypes,
  `glyph_atlas.Unicode`); the render path's Python `unicodedata` is not
  read for any of them.
- Tone-letter runs of 2-6 letters in every order (19,525 runs): glyph ids
  and advances equal HarfBuzz's at 12 and 37 px.
- Seeded lines (numpy, `SEED`) of Unicode 15.1-17 code points with marks,
  ZWJ emoji sequences in right-to-left paragraphs, tone contours, lone
  surrogates and noncharacters: each raqm run equal to HarfBuzz's at
  18 px, and the lines, a page at a time, pixel-equal to the JAX
  package's `_render_text_page` at dpi 150 and 100, and a shorter set at
  72, 120, 200 and 300.
- `refusing_atlas` / `raster_page_with_atlas`: what the refused-page tests
  of `test_torch_text_pages.py` draw with (the committed atlas refuses no
  text, so those tests make a copy that refuses a code point; the raster
  pool's forkserver children reach it through the task they run).
"""

import functools
import itertools
from pathlib import Path

import numpy as np
import pytest

from morphik_core_tpu.parser.pdf import _render_text_page
from morphik_core_tpu_torch.parser import glyph_atlas, raster_pool, text_render
from morphik_core_tpu_torch.parser.text_render import CATEGORIES, MISDRAWN, load_font, render_text_page

SEED = 24
TONES = [chr(cp) for cp in range(0x02E5, 0x02EA)]
# Unicode 15.1-17 code points by kind (HarfBuzz's categories: Lo, Lu / Ll, Mn / Mc, Nd, So)
NEW_LETTERS = ("\U0002ebf0\U0002ebf5\U0002ee5d\U00031350\U000323afꟌꟍꟚꟜᲉᲊ"
               "\U00010d4a\U00010d50\U00010d69\U00010d6e\U00011380\U000113a0\U000116d0\U00011be0\U00016100"
               "\U00016d40\U0001e5d0\U0001e6c0\U00010ec2\U00010ec4\U0002ebf1\U0001ccd6")
NEW_MARKS = "\U00010d69\U00010d6d\U000113b8\U000113c2\U000113ce\U0001611e\U00016d41\U0001e5ee᫏ࢗ\U00011f5a"
NEW_SYMBOLS = "\U0001cc00\U0001fbcb\U0001f8b0\U0001fa89\U0001faef\U00011b00\U0001f8c0␧"
ZWJ_EMOJI = ("\U0001f468‍\U0001f469‍\U0001f467", "\U0001f3f3️‍\U0001f308",
             "❤️‍\U0001f525", "\U0001f9d1\U0001f3fd‍\U0001f4bb", "☹‍★")
RTL_WORDS = ("שלום", "עולם", "مرحبا", "بكم", "١٢", "(א)")
OTHER = (" ", " ", "abc", "12", "‍", "‌", "\ud800", "﷐", "\U0010ffff", "́", "‫", "⁩")


def refusing_atlas(path: Path, cps) -> Path:
    """A copy of the committed atlas with `cps` classed MISDRAWN (what a
    probe that found them drawn otherwise would write)."""
    with np.load(text_render.ATLAS_PATH) as z:
        arrays = {k: z[k] for k in z.files}
    starts, values = arrays["class_starts"], arrays["class_values"]
    classes = values[np.searchsorted(starts, np.arange(0x110000), side="right") - 1]
    classes[list(cps)] = MISDRAWN
    arrays["class_starts"], arrays["class_values"] = glyph_atlas._ranges(classes)
    np.savez(path, **arrays)
    return Path(path)


def raster_page_with_atlas(atlas: str, *args):
    """`raster_pool._raster_page(*args)` drawn with the atlas at `atlas`, in
    whichever process runs it (a forkserver child imports this module and
    takes the atlas from the task)."""
    if text_render.ATLAS_PATH != Path(atlas):
        text_render.ATLAS_PATH = Path(atlas)
        text_render._load_size.cache_clear()
    return _RASTER_PAGE(*args)


_RASTER_PAGE = raster_pool._raster_page


def use_atlas(monkeypatch, atlas: Path) -> None:
    """Draw every text page with `atlas`, inline and in the raster pool's
    children, until `monkeypatch` undoes it (then clear
    `text_render._load_size`'s cache)."""
    monkeypatch.setattr(text_render, "ATLAS_PATH", atlas)
    monkeypatch.setattr(raster_pool, "_raster_page", functools.partial(raster_page_with_atlas, str(atlas)))
    text_render._load_size.cache_clear()


# ------------------------------------------------------ Unicode properties


@pytest.fixture(scope="module")
def harfbuzz_unicode():
    return glyph_atlas.Unicode()


def _expand(z, key) -> np.ndarray:
    starts, values = z[f"{key}_starts"], z[f"{key}_values"]
    return values[np.searchsorted(starts, np.arange(0x110000), side="right") - 1]


@pytest.fixture(scope="module")
def atlas():
    with np.load(text_render.ATLAS_PATH) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("prop", ["category", "ccc", "decomposition", "script", "pictographic"])
def test_atlas_unicode_properties_equal_harfbuzz(prop, harfbuzz_unicode, atlas):
    """For all 0x110000 code points, the atlas's value (as the render path
    reads it, through `ShapedFont` on a sample) equals HarfBuzz's."""
    hb, font = harfbuzz_unicode, load_font(150)
    rng = np.random.default_rng(SEED)
    sample = rng.integers(0, 0x110000, 4000).tolist() + list(range(0x0300, 0x0370)) + [0x1C89, 0x2EBF0, 0xD800]
    if prop == "category":
        got = np.array(CATEGORIES)[_expand(atlas, "category")]
        assert got.tolist() == hb.category
        assert all(font.category(cp) == hb.category[cp] for cp in sample)
    elif prop == "ccc":
        assert np.array_equal(_expand(atlas, "ccc"), hb.ccc)
        assert all(font.modified_ccc(cp) == text_render.modified_ccc(cp, int(hb.ccc[cp])) for cp in sample)
    elif prop == "decomposition":
        assert np.array_equal(atlas["decompositions"], hb.decompositions)
        for cp, a, b in hb.decompositions.tolist():
            want = None if cp in text_render.HANGUL_SYLLABLES else ((a, b) if b else (a,))
            assert font.decomposition(cp) == want, hex(cp)
        assert font.decomposition(0x41) is None
    elif prop == "script":
        codes = [str(c) for c in atlas["scripts"]]
        assert [codes[v] for v in _expand(atlas, "script").tolist()] == hb.script
    else:
        got = _expand(atlas, "pictographic").astype(bool)
        assert np.array_equal(got, hb.pictographic)
        assert got[[0xA9, 0x2139, 0x1F600, 0x1FAFF]].all() and not got[[0x31, 0x41, 0x1F1E6, 0x1F3FB]].any()
        assert all(font.pictographic(cp) == bool(got[cp]) for cp in sample)


def test_render_path_reads_no_unicodedata_property():
    """`text_render`, `use` and the other modules of the render path call
    no `unicodedata` category, combining class or decomposition."""
    import inspect

    from morphik_core_tpu_torch.parser import arabic, bidi, hangul, khmer, marks, syllables, thai, use

    for module in (text_render, use, arabic, bidi, hangul, khmer, marks, syllables, thai):
        src = inspect.getsource(module)
        for name in ("unicodedata.category", "unicodedata.combining", "unicodedata.decomposition",
                     "unicodedata.normalize"):
            assert name not in src, (module.__name__, name)


def test_atlas_classes_no_code_point_refused(atlas):
    """No code point is SHAPER or MISDRAWN; a lone surrogate is drawn as
    U+FFFD (COMPOSES), an unassigned code point as a box, and the atlas
    holds the six font sizes."""
    classes = _expand(atlas, "class")
    assert classes.max() < text_render.SHAPER
    assert (classes[0xD800:0xE000] == text_render.COMPOSES).all()
    assert classes[0x0378] == classes[0xFDD0] == classes[0x10FFFF] == text_render.NOTDEF
    assert {int(k.split("_")[1]) for k in atlas if k.startswith("masks_")} == set(text_render.ATLAS_SIZES)


# ------------------------------------------------------------ tone letters


@pytest.fixture(scope="module")
def harfbuzz():
    return glyph_atlas.HarfBuzz()


@pytest.mark.parametrize("size_dpi", [(12, 100), (37, 300)])
def test_tone_letter_runs_match_harfbuzz(size_dpi, harfbuzz):
    """Every sequence of 2-6 tone letters (the ccmp chain lookup's contour
    forms and stems, the kern pairs between them), after a Latin letter:
    glyph ids and advances equal HarfBuzz's."""
    size, dpi = size_dpi
    font = load_font(dpi)
    codes = [str(c) for c in np.load(text_render.ATLAS_PATH)["scripts"]]
    bad = []
    for n in range(2, 7):
        for seq in itertools.product(TONES, repeat=n):
            line = "a" + "".join(seq)
            cps = [ord(c) for c in line]
            (start, end, script, rtl), = font.runs(line)
            mine = [(font.glyphs[t], a, x, y) for t, a, x, y, _ in font.shape_run(cps, start, end, script, rtl)]
            theirs = [g[:4] for g in harfbuzz.shape(line, start, end, codes[script], rtl, size)]
            if mine != theirs:
                bad.append(line)
    assert not bad, (len(bad), bad[:5])


# ------------------------------------------------------------ seeded lines


def new_lines(n: int, seed: int) -> list:
    """Seeded lines of Unicode 15.1-17 letters, marks and symbols, ZWJ
    emoji in right-to-left paragraphs, tone contours, joiners, lone
    surrogates, noncharacters and bidi controls."""
    rng = np.random.default_rng(seed)
    pools = [(NEW_LETTERS, 6), (NEW_MARKS, 3), (NEW_SYMBOLS, 2), (ZWJ_EMOJI, 2), (RTL_WORDS, 4), (TONES, 2),
             (OTHER, 5)]
    weights = np.array([w for _, w in pools], float)
    lines = []
    for _ in range(n):
        parts = []
        for _ in range(int(rng.integers(3, 40))):
            pool = pools[int(rng.choice(len(pools), p=weights / weights.sum()))][0]
            parts.append(pool[int(rng.integers(len(pool)))])
        lines.append("".join(parts))
    return lines


def _runs_equal(line: str, harfbuzz, size: int, dpi: int) -> None:
    font = load_font(dpi)
    codes = [str(c) for c in np.load(text_render.ATLAS_PATH)["scripts"]]
    cps = [ord(c) for c in line]
    for start, end, script, rtl in font.runs(line):
        mine = [(font.glyphs[t], a, x, y) for t, a, x, y, _ in font.shape_run(cps, start, end, script, rtl)]
        theirs = [g[:4] for g in harfbuzz.shape(line, start, end, codes[script], rtl, size)]
        assert mine == theirs, (line, start, end, codes[script], rtl, mine, theirs)


@pytest.mark.parametrize("part", range(2))
def test_new_code_point_runs_match_harfbuzz(part, harfbuzz):
    """2 x 100 seeded lines, run for run, at 18 px."""
    for line in new_lines(100, SEED + part):
        for piece in line.split("\n"):
            _runs_equal(piece, harfbuzz, 18, 150)


@pytest.mark.parametrize("dpi", [150, 100])
@pytest.mark.parametrize("part", range(2))
def test_new_code_point_pages_match_reference(part, dpi):
    text = "\n".join(new_lines(40, SEED + 10 + part))
    assert np.array_equal(render_text_page(text, dpi), np.asarray(_render_text_page(text, dpi)))


@pytest.mark.parametrize("dpi", [72, 120, 200, 300])
def test_new_code_point_pages_match_reference_at_every_held_size(dpi):
    text = "\n".join(new_lines(12, SEED + 20))
    assert np.array_equal(render_text_page(text, dpi), np.asarray(_render_text_page(text, dpi)))


def test_new_scripts_take_the_default_shaper_and_harfbuzz_directions(atlas, harfbuzz_unicode):
    """The scripts of Unicode 16 and 17 have no tag in DejaVu Sans: HarfBuzz
    chooses DFLT and the default shaper for each (the USE ones give way to
    it there), and the atlas holds HarfBuzz's direction (Garay and Sidetic
    right-to-left)."""
    codes, tags = [str(c) for c in atlas["scripts"]], [str(t) for t in atlas["tags"]]
    for code in ("Gara", "Gukh", "Krai", "Onao", "Sunu", "Todr", "Tutg", "Berf", "Sidt", "Tayo", "Tols"):
        k = codes.index(code)
        assert tags[atlas["script_tags"][k]] == "DFLT", code
        assert atlas["script_shapers"][k] == text_render.DEFAULT_SHAPER, code
        assert atlas["script_directions"][k] == harfbuzz_unicode.direction(code), code
    assert [atlas["script_directions"][codes.index(c)] for c in ("Gara", "Sidt", "Tols")] == [
        text_render.RTL_SCRIPT, text_render.RTL_SCRIPT, text_render.LTR_SCRIPT]
