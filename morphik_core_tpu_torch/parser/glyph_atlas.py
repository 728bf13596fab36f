"""Makes `text_render`'s glyph atlas, `glyphs_dejavu_sans.npz`, with PIL
(raqm, FreeType) and fontTools from the DejaVuSans.ttf that
`ImageFont.truetype("DejaVuSans.ttf")` finds: the reference's font, and
with the FriBiDi, HarfBuzz and FreeType that Pillow's raqm draws with
(through ctypes: `libfribidi.so.0` and Pillow's own
`pillow.libs/libharfbuzz*` and `libfreetype*`). It runs where PIL is
installed; nothing on the serving path imports it.

    python -c "from morphik_core_tpu_torch.parser.glyph_atlas import write_glyph_atlas; write_glyph_atlas()"

What it writes (`text_render.ShapedFont` and `marks.MarkTables` read it):

- `chars`: the code points drawn as a token of their own: the cmap's
  (marks too; default-ignorables and refused scripts aside) and the
  spaces the font lacks; then the `ligatures`, the `forms` (the Arabic
  form glyphs outside the cmap, each drawn by PIL as its letter between
  ZWJs), the `extra_glyphs` (the glyphs outside the cmap that the mirrored
  substitutions reach: the capitals' accents, the dotless forms, the
  Arabic mark ligatures), the `.notdef` token and the hidden token.
  `glyphs`: each token's glyph id; `hidden`: 1 for the invisible token.
- per font size s: `shapes_s`, `offsets_s`, `masks_s` (u8, flat) as
  `getmask2(token, "L", anchor="la")` draws the token alone (a mark after
  a ZWSP, where it is drawn alone and unplaced; an extra glyph, and a mark
  with a canonical decomposition, as Pillow's FreeType renders it, placed
  in the same frame), `advances_s`
  (1/64 px, `getlength`; an extra glyph's is hb-ft's), and `kern_s` rows
  (tag, glyph a, glyph b, 1/64 px): each pair of the GPOS `kern` lookups
  of a served OpenType script tag, measured with `getlength` inside a run
  of a script with that tag (`ctx + a + ZWNJ + b`: GPOS skips the ZWNJ, a
  ligature does not form across it); no pair holds a mark.
- `class_starts` / `class_values`: each code point's class
  (`text_render.GLYPH` ...) as ranges. The rules give a class; a probe at
  12 px draws every code point the rules let through but the marks, in
  chunks of consecutive ones, with PIL and with the mirror, and a code
  point the two draw differently is refused (`MISDRAWN`); the marks are
  probed on their bases at both sizes (`_mark_units`).
- `script_starts` / `script_values` / `scripts` / `script_names`
  (ISO 15924, Unicode 17 from fontTools: the card's Python has no Script
  property), `script_tags` (each script's OpenType tag in `tags`, the one
  HarfBuzz chooses: DFLT where the font has none of the script's) and
  `script_shapers` (the shaper HarfBuzz runs for it,
  `hb_ot_shaper_categorize`; a script whose shaper the port does not
  mirror would have its code points refused as SHAPER: none is left).
- `general_cps` / `general_categories`: HarfBuzz's general category where
  it differs from Python's (U+1171E is Mc in Unicode 17).
- `brackets`: the pairs raqm's script resolution matches, found by
  probing; `compose`: (base, mark, composite) for each composite the cmap
  holds; `lig_blockers`: the default-ignorables a ligature does not
  match across (probed); `contextual`: the characters a chain-context
  ccmp lookup of the font substitutes in sequence (its tone letters,
  refused).
- GSUB: `gsub_lookups` rows (tag, stage, lookup), `gsub_flags`,
  `gsub_ligatures` (lookup, ligature glyph, components), the ccmp
  chain-context lookups' `chain_classes` and `chain_rules`, and the
  `single_substs` they call (`_gsub_tables`).
- GPOS marks and GDEF: `glyph_classes` and `mark_attach` per glyph id;
  `mark_lookups`, `mark_subtables`, `mark_marks`, `mark_bases`,
  `mark_lig_counts` and the anchors per size, `mark_marks_xy_s` /
  `mark_bases_xy_s` (`_mark_positioning`).
- bidi: `bidi_starts` / `bidi_values` (FriBiDi's type of every code
  point, in `bidi.TYPE_NAMES`' numbering), `bidi_brackets` (code point,
  FriBiDi's bracket type: minus the id of an opening bracket), `mirror`
  (HarfBuzz's mirror of each code point whose mirror the cmap holds),
  `script_directions` (HarfBuzz's native direction of each script),
  `libraries` (the FriBiDi, HarfBuzz and raqm versions).
- joining: `joining_starts` / `joining_values` (FriBiDi's joining types,
  as `arabic.U` ...; a mark's T, as HarfBuzz has it for the marks
  ArabicShaping.txt does not list; the letters of the other joining
  scripts, N'Ko's among them, and the Arabic letters newer than FriBiDi's
  data as HarfBuzz joins an Arabic run to them, probed; the probe
  confirms them), `use_joining_starts` / `use_joining_values` (the types
  of the own joining HarfBuzz's USE shaper gives an N'Ko run,
  `_probe_use_joining`), `forms_substs` rows (tag, action, glyph in,
  glyph out) of the form features of `arab` and `nko `,
  `rlig_blockers` / `arabic_liga_blockers` (the default-ignorables a
  lam-alef does not form across, probed).
- `use_categories` / `khmer_categories` rows (code point, category): the
  syllable category HarfBuzz reads for a nonspacing mark of another
  script (and an Inherited character) in a USE and a Khmer run, where it
  is not "other": each probed with Pillow's HarfBuzz in the lines that
  tell the categories apart, single and in pairs with marks of known
  category, and the medial and final ones in pairs with each other
  (`_probe_categories`).

The probe draws every code point the rules let through alone in chunks,
the Common ones also inside a Hebrew and a Latin right-to-left run, each
letter an Arabic run may hold alone, between tatweels and beside a beh
(an Arabic letter also before digits, "%" and signs, in both paragraph
directions), each invisible character between two behs, the marks on
their bases (`_mark_units`), and every mark after a Khmer, a Tifinagh and
an N'Ko letter.
"""

from __future__ import annotations

import unicodedata
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from morphik_core_tpu_torch.parser import arabic, bidi, khmer, marks, use
from morphik_core_tpu_torch.parser.text_render import (
    ARABIC_SHAPER, ATLAS_DPIS, ATLAS_PATH, COMPOSES, DOTTED_CIRCLE, DEFAULT_SHAPER, FONT_NAME, GLYPH, HANGUL_SHAPER, HEBREW_SHAPER,
    HIDDEN, INDIC_SHAPER, KHMER_SHAPER, LTR_SCRIPT, MISDRAWN, MYANMAR_SHAPER, NO_DIRECTION, NOTDEF, RTL_SCRIPT,
    SHAPER, THAI_SHAPER, UNASSIGNED, USE_SHAPER, ZWJ, ShapedFont, UnsupportedText, _blend_black,
    _canonical_decomposition, _composite, _is_mark, _modified_ccc, decompose, font_size, load_font)

# `hb_ot_shaper_categorize` (hb-ot-shaper.hh, HarfBuzz 12): the scripts of
# the Indic shaper, and of the Universal Shaping Engine (USE)
INDIC_SCRIPTS = frozenset("Beng Deva Gujr Guru Knda Mlym Orya Taml Telu".split())
USE_SCRIPTS = frozenset("""
Tibt Mong Sinh Buhd Hano Tglg Tagb Limb Tale Bugi Khar Sylo Tfng Bali Nkoo Phag Cham Kali Lepc Rjng Saur Sund
Egyp Java Kthi Mtei Lana Tavt Batk Brah Mand Cakm Plrd Shrd Takr Dupl Gran Khoj Sind Mahj Mani Modi Hmng Phlp
Sidd Tirh Ahom Mult Adlm Bhks Marc Newa Gonm Soyo Zanb Dogr Gong Rohg Maka Medf Sogo Sogd Elym Nand Hmnp Wcho
Chrs Diak Kits Yezi Cpmn Ougr Tnsa Toto Vith Kawi Nagm Gara Gukh Krai Onao Sunu Todr Tutg
""".split())
# the scripts whose OpenType tag has a new-style Indic tag before it (`hb_ot_all_tags_from_script`)
NEW_INDIC_TAGS = {"Beng": "bng", "Deva": "dev", "Gujr": "gjr", "Guru": "gur", "Knda": "knd", "Mlym": "mlm",
                  "Orya": "ory", "Taml": "tml", "Telu": "tel"}
# the spaces HarfBuzz draws with the space glyph where the font lacks them
# (`space_fallback_type`)
FALLBACK_SPACES = (0x20, 0xA0, *range(0x2000, 0x200B), 0x202F, 0x205F, 0x3000)
# `hb_script_get_horizontal_direction`: the right-to-left scripts, and those without a direction
RTL_SCRIPTS = frozenset("""
Arab Hebr Syrc Thaa Cprt Khar Phnx Nkoo Lydi Avst Armi Phli Prti Sarb Orkh Samr Mand Merc Mero Mani Mend Nbat Narb
Palm Phlp Hatr Adlm Rohg Sogo Sogd Elym Chrs Yezi Ougr Gara
""".split())
UNDIRECTED_SCRIPTS = frozenset(("Hung", "Ital", "Runr", "Tfng"))
# the scripts other than Arabic whose letters HarfBuzz's joining table holds (hb-ot-shaper-arabic-table.hh)
JOINING_SCRIPTS = frozenset("Syrc Mong Nkoo Phag Mand Mani Phlp Adlm Rohg Sogd Chrs Ougr Gara".split())
# FriBiDi's joining type names -> the atlas's (HarfBuzz counts C as D; G is FriBiDi's "ignored")
JOINING = {"U": arabic.U, "L": arabic.L, "R": arabic.R, "D": arabic.D, "C": arabic.D, "T": arabic.T, "G": arabic.U}
FRIBIDI_TYPE_NAMES = {"LTR": "L", "RTL": "R", "BS": "B", "SS": "S"}
ALEF, ALEF_HAMZA, LAM, TATWEEL = 0x627, 0x623, 0x644, 0x640
# HarfBuzz's default shaper features that substitute (hb-ot-shape.cc)
DEFAULT_GSUB = ("ccmp", "locl", "rlig", "calt", "clig", "liga", "rclt")
# HarfBuzz's OpenType tags where they are not the ISO code in lower case
OT_TAGS = {"Hira": "kana", "Kana": "kana", "Laoo": "lao ", "Yiii": "yi  ", "Nkoo": "nko ", "Vaii": "vai "}
NOTDEF_PROBE = 0x4E2D   # 中: the font has no CJK
# the machines' categories in the order the probe tries them (the default first, then the marks')
USE_ORDER = (use.O, use.VABV, use.VBLW, use.VPST, use.VPRE, use.VMABV, use.VMBLW, use.VMPST, use.VMPRE, use.H, use.IS,
             use.HVM, use.SK, use.N, use.HN, use.CMABV, use.CMBLW, use.MABV, use.MBLW, use.MPST, use.MPRE, use.FABV,
             use.FBLW, use.FPST, use.FMABV, use.FMBLW, use.FMPST, use.SMABV, use.SMBLW, use.SUB, use.CS, use.R, use.FM,
             use.B, use.GB, use.CGJ, use.WJ, use.ZWNJ, use.G, use.J, use.SB, use.SE)
KHMER_ORDER = (khmer.X, khmer.VABV, khmer.VBLW, khmer.VPST, khmer.VPRE, khmer.H, khmer.ROBATIC, khmer.XGROUP,
               khmer.YGROUP, khmer.C, khmer.V, khmer.RA, khmer.PLACEHOLDER, khmer.DOTTEDCIRCLE, khmer.ZWNJ, khmer.ZWJ)
ZWNJ = 0x200C
PROBE_CHUNK = 128


def hb_default_ignorable(cp: int) -> bool:
    """`hb_unicode_funcs_t::is_default_ignorable` (hb-unicode.hh)."""
    return (cp in (0xAD, 0x34F, 0x61C, 0xFEFF) or 0x17B4 <= cp <= 0x17B5 or 0x180B <= cp <= 0x180E
            or 0x200B <= cp <= 0x200F or 0x202A <= cp <= 0x202E or 0x2060 <= cp <= 0x206F
            or 0xFE00 <= cp <= 0xFE0F or 0xFFF0 <= cp <= 0xFFF8 or 0x1D173 <= cp <= 0x1D17A
            or 0xE0000 <= cp <= 0xE0FFF)


def _default_langsys(table, tag: str):
    rec = next((s for s in table.ScriptList.ScriptRecord if s.ScriptTag == tag), None)
    return rec.Script.DefaultLangSys if rec is not None else None


def _feature_lookups(table, tag: str, features) -> Dict[str, List[int]]:
    ls = _default_langsys(table, tag)
    out: Dict[str, List[int]] = {}
    for fi in ls.FeatureIndex if ls is not None else ():
        rec = table.FeatureList.FeatureRecord[fi]
        if rec.FeatureTag in features:
            out.setdefault(rec.FeatureTag, []).extend(rec.Feature.LookupListIndex)
    return out


def _font_ligatures(gsub, tag: str, char_of: Dict[str, int]) -> List[str]:
    """The `liga` substitutions of the font's default language system for
    `tag` whose components all have tokens, in the order HarfBuzz tries
    them (lookup, then the ligature set's own order) -> [(string, glyph name)]."""
    out = []
    for li in sorted(_feature_lookups(gsub, tag, ("liga",)).get("liga", [])):
        for sub in gsub.LookupList.Lookup[li].SubTable:
            for first, ligs in getattr(sub, "ligatures", {}).items():
                for lig in ligs:
                    names = [first] + list(lig.Component)
                    if all(n in char_of for n in names):
                        out.append(("".join(chr(char_of[n]) for n in names), lig.LigGlyph))
    return out


def _kern_pairs(gpos, lookups) -> List[tuple]:
    """The (first, second) glyph names of the PairPos lookups' nonzero pairs."""
    pairs = []
    for li in lookups:
        for st in gpos.LookupList.Lookup[li].SubTable:
            if st.Format == 1:
                for g, ps in zip(st.Coverage.glyphs, st.PairSet):
                    pairs += [(g, r.SecondGlyph) for r in ps.PairValueRecord if r.Value1 and r.Value1.XAdvance]
            else:
                cd1, cd2 = st.ClassDef1.classDefs, st.ClassDef2.classDefs
                assert not any(r.Class2Record[0].Value1 and r.Class2Record[0].Value1.XAdvance
                               for r in st.Class1Record), "a PairPos class-0 second glyph kerns"
                for g in st.Coverage.glyphs:
                    row = st.Class1Record[cd1.get(g, 0)].Class2Record
                    pairs += [(g, g2) for g2, c2 in cd2.items() if row[c2].Value1 and row[c2].Value1.XAdvance]
    return pairs


class _Pil:
    """PIL measurements at one size, in 1/64 px."""

    def __init__(self, size: int):
        from PIL import ImageFont

        self.font = ImageFont.truetype(FONT_NAME, size=size)
        self.size = size

    def length(self, s: str) -> int:
        return round(self.font.getlength(s) * 64)

    def mask(self, s: str):
        m, off = self.font.getmask2(s, "L", anchor="la")
        return np.array(m, dtype=np.uint8).reshape(m.size[1], m.size[0]), off

    def draws(self, a: str, b: str) -> bool:
        """Whether PIL draws `a` and `b` alike (mask, offset, advance)."""
        (ma, oa), (mb, ob) = self.mask(a), self.mask(b)
        return oa == ob and ma.shape == mb.shape and np.array_equal(ma, mb) and self.length(a) == self.length(b)


def _latin_after(pil: _Pil, prefix: str) -> bool:
    """Whether a “ after `prefix` resolves to Latin (it kerns with A then)."""
    q = "“"
    return pil.length(prefix + q + "A") - pil.length(prefix + q) - pil.length("A") != 0


def _context_joining(pil: _Pil, cp: int) -> int:
    """HarfBuzz's joining type of a letter outside the Arabic script, as the
    context of an Arabic run next to it (HarfBuzz's own table, which FriBiDi
    1.0.8's Unicode 10 data does not hold for the later letters): whether
    a beh before it takes its initial form, as before a ZWJ (it joins on its
    right), and an alef after it its final form (it joins on its left); or
    a beh and an alef around it join (it is transparent)."""
    c = chr(cp)
    right = pil.draws("\u0628" + c, "\u0628\u200d" + c)
    left = pil.draws(c + "\u0627", c + "\u200d\u0627")
    if not right and not left and pil.draws("\u0628" + c + "\u0627", "\u0628\u200d" + c + "\u200d\u0627"):
        return arabic.T   # a beh and an alef join across it
    return {(True, True): arabic.D, (True, False): arabic.R, (False, True): arabic.L, (False, False): arabic.U}[
        (right, left)]


def _probe_brackets(pil: _Pil, script_of) -> List[tuple]:
    """The bracket pairs raqm matches: a close takes its open's script, so a
    “ after "x(Г)" is Latin where it is Cyrillic after "x(Г]". Candidates:
    the Common punctuation that opens or closes (Ps Pe Pi Pf) and < >."""
    cands = [cp for cp in range(0x110000) if not 0xD800 <= cp < 0xE000 and script_of(cp) == "Zyyy"
             and (unicodedata.category(chr(cp)) in ("Ps", "Pe", "Pi", "Pf") or chr(cp) in "<>")]
    opens = [cp for cp in cands if unicodedata.category(chr(cp)) in ("Ps", "Pi") or cp == 0x3C]
    assert _latin_after(pil, "x") and not _latin_after(pil, "Г")
    pairs = []
    for c in cands:
        pool = opens
        if not _latin_after(pil, "x" + "".join(map(chr, pool)) + "Г" + chr(c)):
            continue
        while len(pool) > 1:   # halve the opens until the one c closes
            half = pool[:len(pool) // 2]
            pool = half if _latin_after(pil, "x" + "".join(map(chr, half)) + "Г" + chr(c)) else pool[len(half):]
        pairs.append((pool[0], c))
    return sorted(pairs)


def _ranges(values: np.ndarray):
    starts = np.concatenate([[0], np.flatnonzero(np.diff(values)) + 1]).astype(np.int32)
    return starts, values[starts]


def _probe_chunk(font: ShapedFont, pil: _Pil, text: str, frame: tuple = ("", "")) -> Optional[bool]:
    """Whether PIL and the mirror draw `text` (between the `frame`'s two
    strings) alike, pixels and advance; None where the mirror refuses it."""
    from PIL import Image, ImageDraw

    text = frame[0] + text + frame[1]
    want_len = pil.length(text)
    m = 2 * pil.size
    w, h = (want_len >> 6) + 4 * pil.size + 2 * m, 6 * pil.size
    img = Image.new("L", (w, h), 255)
    ImageDraw.Draw(img).text((m, m), text, fill=0, font=pil.font)
    try:
        places, pen = font.layout(text)
    except UnsupportedText:
        return None
    page = np.full((h, w), 255, np.uint8)
    mask, ox, oy = _composite(places)
    if mask.size:
        _blend_black(page, mask, m + ox, m + oy)
    return pen == want_len and np.array_equal(page, np.asarray(img))


def _probe(font: ShapedFont, pil: _Pil, units: List[tuple], misdrawn: List[int], frame: tuple = ("", "")) -> None:
    """Probe a chunk of units (text, the code point refused where the unit
    alone is drawn otherwise), halving it where it fails: a unit drawn
    otherwise alone (in the frame) makes its code point `misdrawn`; a chunk
    drawn otherwise whose halves are drawn alike is a fault of the mirror.
    A chunk the mirror refuses (a sequence of contextual forms) is fine
    where its halves pass."""
    same = _probe_chunk(font, pil, "".join(t for t, _ in units), frame)
    if same:
        return
    if len(units) == 1:
        assert same is not None, f"the mirror refuses {units[0][0]!r} alone in {frame}"
        misdrawn.append(units[0][1])
        return
    before = len(misdrawn)
    _probe(font, pil, units[:len(units) // 2], misdrawn, frame)
    _probe(font, pil, units[len(units) // 2:], misdrawn, frame)
    if same is False and len(misdrawn) == before:
        raise AssertionError(f"the mirror draws {units[0][0]!r}..{units[-1][0]!r} otherwise than PIL, but each "
                             "half alike: a shaping rule between characters is missing")


def _chars(cps) -> List[tuple]:
    return [(chr(cp), cp) for cp in cps]


def _mark_units(gsub, gpos, cmap_names, drawn, others, script_of, chosen, mark_tags, skipped_chains
                ) -> Dict[str, list]:
    """The probe's mark units (text, the code point refused where it is
    drawn otherwise) per OpenType script tag: in each tag with GPOS `mark`,
    every mark its lookups cover on the first base (ligature, mark) of
    each subtable that covers it, every base on the first mark of each of
    its subtables; the mkmk stacks; every other mark on a letter; the ccmp
    contexts (dotless i and j, the capitals' marks, ayin
    before a point, with a below mark between); the Arabic mark ligatures
    (shadda with a haraka, on a letter and inside lam-alef), a haraka after
    a space and a tatweel, every mark between two behs, Hebrew's yod with
    hiriq; and the `others` (every mark) after a digit, alone and before a
    variation selector (an Inherited one in a DFLT run, where HarfBuzz
    leaves it unplaced: the font has a GPOS table, so no fallback
    positioning)."""
    cp_of: Dict[str, int] = {}
    for cp in sorted(drawn, reverse=True):
        cp_of[cmap_names[cp]] = cp
    tag_of = {cp: chosen[script_of(cp)] for cp in drawn}
    is_mark = {cp: _is_mark(cp) for cp in drawn}
    units: Dict[str, list] = {}

    def fits(cp, t):
        return script_of(cp) in ("Zinh", "Zyyy") or tag_of[cp] == t

    def cps(glyphs, t, marks_wanted):
        return [cp_of[g] for g in glyphs if g in cp_of and is_mark[cp_of[g]] == marks_wanted and fits(cp_of[g], t)]

    for t in mark_tags:
        letter = next(chr(cp) for cp in drawn if tag_of[cp] == t and unicodedata.category(chr(cp)) == "Lo"
                      or (tag_of[cp] == t and unicodedata.category(chr(cp)) == "Ll"))
        out = units.setdefault(t, [])

        def base(cp):   # a Common base takes the tag's script from a letter before it
            return (letter if script_of(cp) == "Zyyy" else "") + chr(cp)

        covered = set()
        for li in sorted(set(sum(_feature_lookups(gpos, t, ("mark", "mkmk")).values(), []))):
            lookup = gpos.LookupList.Lookup[li]
            for st in lookup.SubTable:
                if lookup.LookupType == marks.MARK_MARK:
                    m1, m2 = cps(st.Mark1Coverage.glyphs, t, True), cps(st.Mark2Coverage.glyphs, t, True)
                    if m1 and m2:
                        out += [(letter + chr(m2[0]) + chr(m), m) for m in m1]
                        out += [(letter + chr(m) + chr(m1[0]), m) for m in m2]
                    continue
                ms = cps(st.MarkCoverage.glyphs, t, True)
                cov = st.LigatureCoverage if lookup.LookupType == marks.MARK_LIG else st.BaseCoverage
                bs = cps(cov.glyphs, t, False)
                covered |= set(ms)
                if ms and bs:
                    out += [(base(bs[0]) + chr(m), m) for m in ms]
                    out += [(base(b) + chr(ms[0]), b) for b in bs]
        every = [cp for cp in drawn if is_mark[cp]]   # raqm keeps a nonspacing mark of any script in its base's run
        out += [(letter + chr(m), m) for m in every if m not in covered]
        # the ccmp chain contexts
        for li in _feature_lookups(gsub, t, ("ccmp",)).get("ccmp", []):
            lookup = gsub.LookupList.Lookup[li]
            if lookup.LookupType != 6 or li in skipped_chains:
                continue
            for st in lookup.SubTable:
                groups: Dict[int, list] = {}
                for cd in (st.InputClassDef, st.BacktrackClassDef, st.LookAheadClassDef):
                    for g, c in sorted(cd.classDefs.items()):
                        if g in cp_of and cp_of[g] not in groups.setdefault(c, []) and fits(cp_of[g], t):
                            groups[c].append(cp_of[g])
                bases = [cp for c in groups for cp in groups[c] if not is_mark[cp]]
                tops = [cp for c in groups for cp in groups[c] if is_mark[cp]]
                below = [cp for cp in tops if unicodedata.combining(chr(cp)) == 220][:1]
                if bases and tops:
                    out += [(base(b) + chr(tops[0]), b) for b in bases]
                    out += [(base(b) + chr(m), m) for b in bases[:1] for m in tops]
                    out += [(base(b) + chr(bl) + chr(m), m) for b in bases for bl in below for m in tops[:3]]
        # the mark ligatures, in and beside ligatures that skip marks
        for li in sorted(set(sum(_feature_lookups(gsub, t, DEFAULT_GSUB).values(), []))):
            lookup = gsub.LookupList.Lookup[li]
            if lookup.LookupType != 4:
                continue
            for st in lookup.SubTable:
                for first, group in st.ligatures.items():
                    for lig in group:
                        comps = [first, *lig.Component]
                        if not all(g in cp_of for g in comps):
                            continue
                        text = "".join(chr(cp_of[g]) for g in comps)
                        if any(is_mark[cp_of[g]] for g in comps):
                            lead = letter if is_mark[cp_of[first]] or first == "space" else ""
                            out.append((lead + text, cp_of[comps[-1]]))
                        elif lookup.LookupFlag & marks.IGNORE_MARKS and len(comps) == 2:
                            out += [(chr(cp_of[first]) + chr(m) + chr(cp_of[comps[1]]), m)
                                    for m in every if fits(m, t)][:12]
        if t == "arab":   # every mark between two behs: transparent to the joining
            out += [("\u0628" + chr(m) + "\u0628", m) for m in others]
        units[t] = list(dict.fromkeys(out))
    units["DFLT"] = [("1" + chr(cp), cp) for cp in others]
    units["DFLT"] += [("1" + chr(cp) + "\ufe0e", cp) for cp in others]   # a VS keeps the cluster undecomposed
    return units


def script_tag(code: str, font_tags) -> str:
    """The GSUB script tag HarfBuzz chooses for a script
    (`hb_ot_all_tags_from_script`, then `hb_ot_layout_table_select_script`):
    the script's own tags in order (a new-style Indic tag first), else DFLT,
    dflt or latn, whichever the font has first."""
    old = OT_TAGS.get(code, code.lower())
    own = {"Mymr": ["mym2", "mymr"]}.get(code, [old])
    if code in NEW_INDIC_TAGS:
        own = [NEW_INDIC_TAGS[code] + "3", NEW_INDIC_TAGS[code] + "2", old]
    tag = next((t for t in own + ["DFLT", "dflt", "latn"] if t in font_tags), None)
    assert tag is not None, f"{code}: the font has none of {own}, DFLT, dflt, latn"
    return tag


def hb_ot_shaper_categorize(script: str, tag: str) -> int:
    """The shaper HarfBuzz 12 runs for a horizontal run of `script` whose
    chosen GSUB script tag is `tag` (`hb_ot_shaper_categorize`,
    hb-ot-shaper.hh). The Indic, Myanmar and USE shapers give way to the
    default one where the font was designed for `DFLT` (or HarfBuzz fell
    back to `latn`); Syriac takes the Arabic shaper only under a tag of its
    own; Thai / Lao, Khmer, Hangul and Hebrew always take theirs.

    What the probes of DejaVu Sans (Pillow's HarfBuzz 12.3, hb-ft, raqm's
    BOT / EOT) show, shaper by shaper: DFLT Devanagari ("क ि"), Bengali,
    Tamil, Myanmar ("က ြ"), Tibetan, Sinhala and Javanese draw a broken
    cluster after a space as box, space, box, with no dotted circle: the
    default shaper. Khmer ("ក ើ") gets a dotted circle there, and "ក ្រ"
    moves Coeng Ro in front of it: the Khmer shaper under DFLT. Thai's
    "ก ำ" gains a box (SARA AM splits): the Thai shaper. Tifinagh under
    `tfng` draws "ⵜ⵿⵿" as letter, box, dotted circle, box (a second
    consonant joiner starts a broken cluster) where "ⵜ ⵿" has none (a space
    before a joiner is a symbol cluster): the USE shaper, as the rule says.
    "한〮" ends in a dotted circle: the Hangul shaper."""
    if script in ("Arab", "Syrc"):
        return ARABIC_SHAPER if tag != "DFLT" or script == "Arab" else DEFAULT_SHAPER
    if script in ("Thai", "Laoo"):
        return THAI_SHAPER
    if script == "Hang":
        return HANGUL_SHAPER
    if script == "Hebr":
        return HEBREW_SHAPER
    if script in INDIC_SCRIPTS:
        if tag in ("DFLT", "latn"):
            return DEFAULT_SHAPER
        return USE_SHAPER if tag.endswith("3") else INDIC_SHAPER
    if script == "Khmr":
        return KHMER_SHAPER
    if script == "Mymr":
        return DEFAULT_SHAPER if tag in ("DFLT", "latn", "mymr") else MYANMAR_SHAPER
    if script in USE_SCRIPTS:
        return DEFAULT_SHAPER if tag in ("DFLT", "latn") else USE_SHAPER
    return DEFAULT_SHAPER


def mirrored(script: str, shaper: int) -> bool:
    """Whether the port mirrors `shaper` for `script`: the default, Hebrew,
    Hangul, Thai and Khmer shapers; the Arabic one for Arabic (its joining
    of Syriac is not mirrored: Syriac has no tag in the font); USE for the
    scripts the font has a USE tag for (Tifinagh, N'Ko with its joining)."""
    if shaper == ARABIC_SHAPER:
        return script == "Arab"
    if shaper == USE_SHAPER:
        return script in use.SCRIPTS
    return shaper in (DEFAULT_SHAPER, HEBREW_SHAPER, HANGUL_SHAPER, THAI_SHAPER, KHMER_SHAPER)


def _classify(cmap, script_of, refused) -> tuple:
    """Each code point's class by rule -> (classes, the spaces drawn as the
    space glyph at their own width). The code points of the `refused`
    scripts (their shaper is not mirrored) are SHAPER."""
    classes = np.empty(0x110000, np.int8)
    spaces = []
    for cp in range(0x110000):
        ch = chr(cp)
        cat = unicodedata.category(ch)
        if cat in ("Cn", "Cs"):
            cls = UNASSIGNED
        elif script_of(cp) in refused:
            cls = SHAPER
        elif hb_default_ignorable(cp):
            cls = HIDDEN
        elif cp in cmap:
            cls = GLYPH
        else:
            if decompose(cp, True, cmap):
                cls = COMPOSES
            elif cp in FALLBACK_SPACES:
                cls = COMPOSES
                spaces.append(cp)
            else:
                cls = NOTDEF
        classes[cp] = cls
    return classes, spaces


def _check_substitutions(gsub, served, joining_tags) -> None:
    """Every default substitution of a served tag is a ligature lookup, a
    ccmp chain-context lookup, or (under a tag whose shaper joins: `arab`,
    `nko `) a form feature's single substitution."""
    for t in served:
        feats = _feature_lookups(gsub, t, DEFAULT_GSUB + tuple(arabic.FEATURES))
        assert t in joining_tags or not set(feats) & set(arabic.FEATURES), f"{t}: form features without joining"
        for feat, lookups in feats.items():
            for li in lookups:
                kind = gsub.LookupList.Lookup[li].LookupType
                assert (kind == 4 or (feat, kind) == ("ccmp", 6)
                        or (feat in arabic.FEATURES and kind == 1)), f"{t} {feat} lookup {li} ({kind})"


def _forms(gsub, gid, served, tags) -> list:
    """The served tags' form features' substitutions, rows (tag, action,
    glyph in, glyph out)."""
    forms = []
    for t in served:
        feats = _feature_lookups(gsub, t, tuple(arabic.FEATURES))
        for name, action in arabic.FEATURES.items():
            assert len(feats.get(name, [])) <= 1, f"{t} {name}: the mirror applies one lookup a feature"
            for li in feats.get(name, []):
                for st in gsub.LookupList.Lookup[li].SubTable:
                    forms += [(tags.index(t), action, gid[a], gid[b]) for a, b in st.mapping.items()]
    return sorted(forms)


def _gsub_stages(gsub, served, tags, skipped_chains, joining_tags) -> List[tuple]:
    """Rows (tag, stage, lookup) of the GSUB lookups the mirror applies:
    under a joining shaper's tag (`arab`, `nko `) its ccmp (stage 0; the
    form features follow it), `rlig` (1) and `liga` (2); the other
    shapers' default features in one stage, in lookup order. The chain
    lookups in `skipped_chains` (the tone letters' contour forms) are
    refused instead."""
    rows = []
    for t in served:
        feats = _feature_lookups(gsub, t, DEFAULT_GSUB)
        if t in joining_tags:
            groups = [feats.get("ccmp", []), feats.get("rlig", []), feats.get("liga", [])]
            assert set(feats) <= {"ccmp", "rlig", "liga"}, f"{t} features {sorted(feats)}"
        else:
            groups = [sum(feats.values(), [])]
        for stage, lookups in enumerate(groups):
            rows += [(tags.index(t), stage, li) for li in sorted(set(lookups)) if li not in skipped_chains]
    return rows


def _gsub_tables(gsub, gid, lookups) -> Dict[str, np.ndarray]:
    """The mirrored GSUB lookups as rows: each ligature lookup's
    ligatures (lookup, ligature glyph, components, -1 padded) in the order
    HarfBuzz tries them; each chain-context lookup's classes and coverage
    (lookup, subtable, 0 backtrack / 1 input / 2 lookahead / 3 coverage,
    glyph, class) and rules (lookup, subtable, input class, single
    substitution lookup, 3 backtrack and 3 lookahead classes, -1 padded);
    the single substitutions those call (lookup, in, out); every lookup's
    flag."""
    ligs, classes, rules, singles, flags = [], [], [], [], []
    for li in sorted(set(lookups)):
        lookup = gsub.LookupList.Lookup[li]
        assert not lookup.LookupFlag & 0x10, f"GSUB lookup {li} uses a mark filtering set"
        flags.append((li, lookup.LookupFlag))
        if lookup.LookupType == 4:
            for st in lookup.SubTable:
                for first, group in st.ligatures.items():
                    for lig in group:
                        comps = [gid[g] for g in [first, *lig.Component]]
                        assert len(comps) <= 3, f"GSUB lookup {li}: a ligature of {len(comps)} glyphs"
                        ligs.append((li, gid[lig.LigGlyph], *comps, *[-1] * (3 - len(comps))))
            continue
        assert lookup.LookupType == 6, f"GSUB lookup {li} (type {lookup.LookupType})"
        for sub, st in enumerate(lookup.SubTable):
            assert st.Format == 2, f"GSUB lookup {li}: a chain-context subtable of format {st.Format}"
            classes += [(li, sub, 3, gid[g], 0) for g in st.Coverage.glyphs]
            for which, cd in enumerate((st.BacktrackClassDef, st.InputClassDef, st.LookAheadClassDef)):
                classes += [(li, sub, which, gid[g], c) for g, c in sorted(cd.classDefs.items()) if c]
            for cls, rule_set in enumerate(st.ChainSubClassSet):
                for r in (rule_set.ChainSubClassRule if rule_set is not None else ()):
                    recs = r.SubstLookupRecord
                    assert not r.Input and len(recs) == 1 and recs[0].SequenceIndex == 0, f"GSUB lookup {li}"
                    assert len(r.Backtrack) <= 3 and len(r.LookAhead) <= 3, f"GSUB lookup {li}"
                    nested = recs[0].LookupListIndex
                    rules.append((li, sub, cls, nested, *r.Backtrack, *[-1] * (3 - len(r.Backtrack)),
                                  *r.LookAhead, *[-1] * (3 - len(r.LookAhead))))
                    inner = gsub.LookupList.Lookup[nested]
                    assert inner.LookupType == 1, f"GSUB lookup {li} calls lookup {nested} (type {inner.LookupType})"
                    singles += [(nested, gid[a], gid[b]) for st2 in inner.SubTable for a, b in st2.mapping.items()]
    return {"gsub_ligatures": np.array(ligs, np.int32).reshape(-1, 5),
            "chain_classes": np.array(classes, np.int32).reshape(-1, 5),
            "chain_rules": np.array(rules, np.int32).reshape(-1, 10),
            "single_substs": np.array(sorted(set(singles)), np.int32).reshape(-1, 3),
            "gsub_flags": np.array(flags, np.int32).reshape(-1, 2)}


def _form_strings(forms, cp_of_glyph, joining, known) -> tuple:
    """A token for each form glyph outside `known` (the cmap's and the
    ligatures' glyphs): the string PIL draws it with, its letter between
    ZWJs (join-causing, invisible) -> (strings, glyphs)."""
    strings, glyphs = [], []
    for _, action, a, b in forms:
        cp = cp_of_glyph.get(a)
        if b in known or b in glyphs or cp is None:
            continue
        j, z, c = joining[cp], chr(ZWJ), chr(cp)
        text = {arabic.ISOL: c if j != arabic.U else None,
                arabic.FINA: z + c if j in (arabic.R, arabic.D) else None,
                arabic.MEDI: z + c + z if j == arabic.D else None,
                arabic.INIT: c + z if j in (arabic.L, arabic.D) else None}[action]
        if text is not None:   # else the letter never takes that form
            strings.append(text)
            glyphs.append(b)
    return strings, glyphs


def _scales(size: int, upem: int) -> tuple:
    """(FreeType's 16.16 x scale for `size` px, hb-ft's font scale)."""
    ft = ((size * 64 << 16) + upem // 2) // upem
    return ft, (ft * upem + (1 << 15)) >> 16


def _anchor(anchor, glyph: str, size: int, upem: int) -> tuple:
    """An anchor at `size` px in 1/16 of a 26.6 unit: its coordinates at
    the font's scale (a float in HarfBuzz, exact in these units). Under
    raqm's hb-ft font HarfBuzz reads a format-2 anchor's coordinates too,
    not its contour point (U+A72B's point lies one unit above them; the
    test against Pillow's HarfBuzz holds the offsets)."""
    assert anchor.Format in (1, 2), f"{glyph}: an anchor of format {anchor.Format}"
    hb = _scales(size, upem)[1]
    x, y = anchor.XCoordinate * hb * 16, anchor.YCoordinate * hb * 16
    assert x % upem == 0 and y % upem == 0, f"{glyph}: an anchor off the 1/16 grid at {size} px"
    return x // upem, y // upem


def _mark_positioning(gpos, gid, served, tags, sizes, upem) -> Dict[str, np.ndarray]:
    """The served tags' `mark` and `mkmk` lookups (`marks.MarkTables`
    reads them): rows (tag, lookup); per subtable, in lookup and subtable
    order, (lookup, type, flag); its marks (subtable, glyph, class) and
    their anchors; its base, ligature or mark-2 anchors (subtable, glyph,
    class, ligature component or -1) and their anchors; its ligatures'
    component counts (subtable, glyph, count). Anchors per size, in 1/16
    of a 26.6 unit."""
    lookups = []
    for t in served:
        feats = _feature_lookups(gpos, t, ("mark", "mkmk"))
        lookups += [(tags.index(t), li) for li in sorted(set(sum(feats.values(), [])))]
    subtables, mark_rows, base_rows, counts = [], [], [], []
    mark_xy = {size: [] for size in sizes}
    base_xy = {size: [] for size in sizes}

    def add(rows, xy, key, glyph, anchor):
        rows.append((*key[:1], gid[glyph], *key[1:]))
        for size in sizes:
            xy[size].append(_anchor(anchor, glyph, size, upem))

    for li in sorted({li for _, li in lookups}):
        lookup = gpos.LookupList.Lookup[li]
        kind, flag = lookup.LookupType, lookup.LookupFlag
        assert kind in (marks.MARK_BASE, marks.MARK_LIG, marks.MARK_MARK), f"GPOS mark lookup {li} (type {kind})"
        assert not flag & 0x10, f"GPOS lookup {li} uses a mark filtering set"
        for st in lookup.SubTable:
            sub = len(subtables)
            subtables.append((li, kind, flag))
            cov, arr = ((st.Mark1Coverage, st.Mark1Array) if kind == marks.MARK_MARK
                        else (st.MarkCoverage, st.MarkArray))
            for g, rec in zip(cov.glyphs, arr.MarkRecord):
                add(mark_rows, mark_xy, (sub, rec.Class), g, rec.MarkAnchor)
            if kind == marks.MARK_LIG:
                for g, attach in zip(st.LigatureCoverage.glyphs, st.LigatureArray.LigatureAttach):
                    counts.append((sub, gid[g], attach.ComponentCount))
                    for comp, rec in enumerate(attach.ComponentRecord):
                        for cls, a in enumerate(rec.LigatureAnchor):
                            if a is not None:
                                add(base_rows, base_xy, (sub, cls, comp), g, a)
                continue
            cov2, recs = ((st.Mark2Coverage, [r.Mark2Anchor for r in st.Mark2Array.Mark2Record])
                          if kind == marks.MARK_MARK else
                          (st.BaseCoverage, [r.BaseAnchor for r in st.BaseArray.BaseRecord]))
            for g, anchors in zip(cov2.glyphs, recs):
                for cls, a in enumerate(anchors):
                    if a is not None:
                        add(base_rows, base_xy, (sub, cls, -1), g, a)
    out = {"mark_lookups": np.array(lookups, np.int32).reshape(-1, 2),
           "mark_subtables": np.array(subtables, np.int32).reshape(-1, 3),
           "mark_marks": np.array(mark_rows, np.int32).reshape(-1, 3),
           "mark_bases": np.array(base_rows, np.int32).reshape(-1, 4),
           "mark_lig_counts": np.array(counts, np.int32).reshape(-1, 3)}
    for size in sizes:
        out[f"mark_marks_xy_{size}"] = np.array(mark_xy[size], np.int32).reshape(-1, 2)
        out[f"mark_bases_xy_{size}"] = np.array(base_xy[size], np.int32).reshape(-1, 2)
    return out


class _FreeType:
    """Glyphs by id as Pillow renders them (`FT_Load_Glyph` with
    FT_LOAD_DEFAULT | FT_LOAD_RENDER, through ctypes on the FreeType Pillow
    bundles): the tokens of the glyphs no character string draws alone
    (the ccmp and mark-ligature outputs outside the cmap)."""

    # FT_FaceRec.glyph, FT_GlyphSlotRec.bitmap (rows, width, pitch, buffer), .bitmap_left / _top (64-bit)
    FACE_GLYPH, BITMAP_ROWS, BITMAP_WIDTH, BITMAP_PITCH, BITMAP_BUFFER, BITMAP_LEFT, BITMAP_TOP = (
        152, 152, 156, 160, 168, 192, 196)

    def __init__(self, path: str, size: int):
        import ctypes

        import PIL
        import PIL._imagingft  # noqa: F401  (maps the libraries the bundled FreeType needs)

        self.ct = ctypes
        libs = sorted((Path(PIL.__file__).parent.parent / "pillow.libs").glob("libfreetype*.so*"))
        assert libs, "Pillow's own FreeType (pillow.libs/libfreetype*.so*) draws the reference"
        ft = self.ft = ctypes.CDLL(str(libs[0]))
        vp = ctypes.c_void_p
        ft.FT_Init_FreeType.argtypes = [ctypes.POINTER(vp)]
        ft.FT_New_Face.argtypes = [vp, ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(vp)]
        ft.FT_Set_Pixel_Sizes.argtypes = [vp, ctypes.c_uint, ctypes.c_uint]
        ft.FT_Load_Glyph.argtypes = [vp, ctypes.c_uint, ctypes.c_int32]
        ft.FT_Get_Char_Index.argtypes = [vp, ctypes.c_ulong]
        ft.FT_Get_Char_Index.restype = ctypes.c_uint
        ft.FT_Done_Face.argtypes = [vp]
        ft.FT_Done_FreeType.argtypes = [vp]
        self.lib, self.face = vp(), vp()
        assert ft.FT_Init_FreeType(ctypes.byref(self.lib)) == 0
        assert ft.FT_New_Face(self.lib, str(path).encode(), 0, ctypes.byref(self.face)) == 0
        assert ft.FT_Set_Pixel_Sizes(self.face, 0, size) == 0

    def glyph_of(self, cp: int) -> int:
        return self.ft.FT_Get_Char_Index(self.face, cp)

    def render(self, glyph: int) -> tuple:
        """-> (mask, left, top) of the glyph's bitmap."""
        ct = self.ct
        assert self.ft.FT_Load_Glyph(self.face, glyph, 4) == 0   # FT_LOAD_RENDER
        slot = ct.c_void_p.from_address(self.face.value + self.FACE_GLYPH).value
        rows = ct.c_uint.from_address(slot + self.BITMAP_ROWS).value
        width = ct.c_uint.from_address(slot + self.BITMAP_WIDTH).value
        pitch = ct.c_int.from_address(slot + self.BITMAP_PITCH).value
        mask = np.zeros((rows, width), np.uint8)
        if rows and width:
            buf = ct.c_void_p.from_address(slot + self.BITMAP_BUFFER).value
            raw = bytes((ct.c_ubyte * (pitch * rows)).from_address(buf))
            mask = np.frombuffer(raw, np.uint8).reshape(rows, pitch)[:, :width].copy()
        return (mask, ct.c_int.from_address(slot + self.BITMAP_LEFT).value,
                ct.c_int.from_address(slot + self.BITMAP_TOP).value)

    def close(self) -> None:
        self.ft.FT_Done_Face(self.face)
        self.ft.FT_Done_FreeType(self.lib)


class HarfBuzz:
    """Pillow's HarfBuzz over hb-ft on Pillow's FreeType (through ctypes),
    one run at a time as raqm calls it: the whole line as context, BOT /
    EOT at its ends. The probes of the syllable categories and of N'Ko's
    joining read it; the tests hold the mirror to it."""

    def __init__(self, path: Optional[str] = None):
        import ctypes

        import PIL
        import PIL._imagingft  # noqa: F401  (maps the libraries Pillow's HarfBuzz and FreeType need)
        from PIL import ImageFont

        self.ct = ctypes
        libs = Path(PIL.__file__).parent.parent / "pillow.libs"
        self.ft = ctypes.CDLL(str(sorted(libs.glob("libfreetype*.so*"))[0]))
        self.hb = ctypes.CDLL(str(sorted(libs.glob("libharfbuzz*.so*"))[0]))
        vp, u32 = ctypes.c_void_p, ctypes.c_uint32
        self.ft.FT_Init_FreeType.argtypes = [ctypes.POINTER(vp)]
        self.ft.FT_New_Face.argtypes = [vp, ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(vp)]
        self.ft.FT_Set_Pixel_Sizes.argtypes = [vp, ctypes.c_uint, ctypes.c_uint]
        for name, res, args in [
                ("hb_ft_font_create_referenced", vp, [vp]), ("hb_buffer_create", vp, []),
                ("hb_buffer_destroy", None, [vp]), ("hb_buffer_set_flags", None, [vp, ctypes.c_int]),
                ("hb_buffer_add_utf32", None, [vp, ctypes.POINTER(u32), ctypes.c_int, ctypes.c_uint, ctypes.c_int]),
                ("hb_buffer_set_direction", None, [vp, ctypes.c_int]), ("hb_buffer_set_script", None, [vp, u32]),
                ("hb_script_from_string", u32, [ctypes.c_char_p, ctypes.c_int]),
                ("hb_language_get_default", vp, []), ("hb_buffer_set_language", None, [vp, vp]),
                ("hb_shape", None, [vp, vp, vp, ctypes.c_uint]),
                ("hb_buffer_get_glyph_infos", ctypes.POINTER(u32 * 5), [vp, ctypes.POINTER(ctypes.c_uint)]),
                ("hb_buffer_get_glyph_positions", ctypes.POINTER(ctypes.c_int32 * 5),
                 [vp, ctypes.POINTER(ctypes.c_uint)])]:
            fn = getattr(self.hb, name)
            fn.restype, fn.argtypes = res, args
        self.lib = vp()
        assert self.ft.FT_Init_FreeType(ctypes.byref(self.lib)) == 0
        self.fonts = {}
        self.path = (path or ImageFont.truetype(FONT_NAME, 18).path).encode()

    def font(self, size: int):
        if size not in self.fonts:
            face = self.ct.c_void_p()
            assert self.ft.FT_New_Face(self.lib, self.path, 0, self.ct.byref(face)) == 0
            assert self.ft.FT_Set_Pixel_Sizes(face, 0, size) == 0
            self.fonts[size] = (face, self.hb.hb_ft_font_create_referenced(face))
        return self.fonts[size][1]

    def shape(self, line: str, start: int, end: int, script: str, rtl: bool, size: int, clusters: bool = False):
        """-> [(glyph, x advance, x offset, y offset)] in visual order, each
        with its cluster (the index in `line`) where `clusters`."""
        ct, hb = self.ct, self.hb
        buf = hb.hb_buffer_create()
        text = (ct.c_uint32 * len(line))(*map(ord, line))
        hb.hb_buffer_set_flags(buf, (1 if start == 0 else 0) | (2 if end == len(line) else 0))
        hb.hb_buffer_add_utf32(buf, text, len(line), start, end - start)
        hb.hb_buffer_set_direction(buf, 5 if rtl else 4)
        hb.hb_buffer_set_script(buf, hb.hb_script_from_string(script.encode(), -1))
        hb.hb_buffer_set_language(buf, hb.hb_language_get_default())
        hb.hb_shape(self.font(size), buf, None, 0)
        n = ct.c_uint()
        infos = hb.hb_buffer_get_glyph_infos(buf, ct.byref(n))
        pos = hb.hb_buffer_get_glyph_positions(buf, ct.byref(n))
        out = [(infos[i][0], pos[i][0], pos[i][2], pos[i][3]) + ((infos[i][2],) if clusters else ())
               for i in range(n.value)]
        hb.hb_buffer_destroy(buf)
        return out


# HarfBuzz's general categories (`hb_unicode_general_category_t`, in enum order)
HB_CATEGORIES = "Cc Cf Cn Co Cs Ll Lm Lo Lt Lu Mc Me Mn Nd Nl No Pc Pd Pe Pf Pi Po Ps Sc Sk Sm So Zl Zp Zs".split()


def _unicode_tables() -> Dict[str, np.ndarray]:
    """FriBiDi's bidi types, bracket types and joining types and HarfBuzz's
    mirrors and general categories (where Python's differ) of every code
    point, from the libraries Pillow's raqm draws with (loaded here only)."""
    import ctypes

    import PIL
    from PIL import features

    n = 0x110000
    fribidi = ctypes.CDLL("libfribidi.so.0")
    fribidi.fribidi_get_bidi_type_name.restype = ctypes.c_char_p
    fribidi.fribidi_get_joining_type_name.restype = ctypes.c_char_p
    cps = (ctypes.c_uint32 * n)(*range(n))
    types = (ctypes.c_uint32 * n)()
    brackets = (ctypes.c_uint32 * n)()
    joins = (ctypes.c_uint8 * n)()
    fribidi.fribidi_get_bidi_types(cps, n, types)
    fribidi.fribidi_get_bracket_types(cps, n, types, brackets)
    fribidi.fribidi_get_joining_types(cps, n, joins)
    raw = np.frombuffer(types, np.uint32)
    code = {}
    for v in np.unique(raw).tolist():
        name = fribidi.fribidi_get_bidi_type_name(v).decode()
        code[v] = bidi.TYPE_NAMES.index(FRIBIDI_TYPE_NAMES.get(name, name))
    bidi_types = np.vectorize(code.get)(raw).astype(np.int8)
    braw = np.frombuffer(brackets, np.uint32).astype(np.int64)
    has = np.flatnonzero(braw)
    ids = np.where(braw[has] & 0x80000000, -(braw[has] & 0x7FFFFFFF), braw[has])
    jraw = np.frombuffer(joins, np.uint8)
    jcode = {v: JOINING[fribidi.fribidi_get_joining_type_name(v).decode()] for v in np.unique(jraw).tolist()}
    joining = np.vectorize(jcode.get)(jraw).astype(np.int8)
    hb_path = sorted((Path(PIL.__file__).parent.parent / "pillow.libs").glob("libharfbuzz*.so*"))
    assert hb_path, "Pillow's own HarfBuzz (pillow.libs/libharfbuzz*.so*) draws the reference"
    hb = ctypes.CDLL(str(hb_path[0]))
    hb.hb_unicode_funcs_get_default.restype = ctypes.c_void_p
    hb.hb_unicode_mirroring.restype = ctypes.c_uint32
    hb.hb_unicode_mirroring.argtypes = (ctypes.c_void_p, ctypes.c_uint32)
    hb.hb_unicode_general_category.restype = ctypes.c_int
    hb.hb_unicode_general_category.argtypes = (ctypes.c_void_p, ctypes.c_uint32)
    funcs = hb.hb_unicode_funcs_get_default()
    mirrors = [(cp, m) for cp in range(n) if (m := hb.hb_unicode_mirroring(funcs, cp)) != cp]
    general = [(cp, c) for cp in range(n) if unicodedata.category(chr(cp)) != "Cn"
               and (c := HB_CATEGORIES[hb.hb_unicode_general_category(funcs, cp)]) != unicodedata.category(chr(cp))]
    libraries = [f"fribidi {features.version('fribidi')}", f"harfbuzz {features.version('harfbuzz')}",
                 f"raqm {features.version('raqm')}"]
    return {"bidi": bidi_types, "bidi_brackets": np.stack([has, ids], 1).astype(np.int32), "joining": joining,
            "mirrors": mirrors, "general": general, "libraries": np.array(libraries)}


def _needs_a_mark(st, gdef_class) -> bool:
    """Whether every rule of a class-based chain-context subtable has a
    class of marks only in its context (it is reached only through a
    mark: ayin's form before a Hebrew point, mirrored)."""
    if st.Format != 2:
        return False
    defs = (st.BacktrackClassDef.classDefs, st.InputClassDef.classDefs, st.LookAheadClassDef.classDefs)

    def marks_only(classdef, k):
        members = [g for g, c in classdef.items() if c == k]
        return k and members and all(gdef_class.get(g) == 3 for g in members)

    rules = [r for cs in st.ChainSubClassSet if cs is not None for r in cs.ChainSubClassRule]
    return all(any(marks_only(d, k) for d, seq in zip(defs, (r.Backtrack, r.Input, r.LookAhead)) for k in seq)
               for r in rules)


def _contextual(gsub, served, char_of, gdef_class) -> List[int]:
    """The characters of the ccmp chain-context subtables whose coverage
    holds no mark glyph and that a sequence without marks reaches: they
    change form next to each other."""
    out = set()
    for t in served:
        for li in _feature_lookups(gsub, t, ("ccmp",)).get("ccmp", []):
            if gsub.LookupList.Lookup[li].LookupType != 6:
                continue   # a ligature lookup (`_gsub_tables`)
            for st in gsub.LookupList.Lookup[li].SubTable:
                cov = st.Coverage.glyphs
                if all(g in char_of and gdef_class.get(g) != 3 for g in cov) and not _needs_a_mark(st, gdef_class):
                    out |= {char_of[g] for g in cov}
    return sorted(out)


def _compositions(cmap) -> List[tuple]:
    """(base, mark, composite) for each composite the font maps: HarfBuzz
    composes only into one, never into a composition-excluded one."""
    out = []
    for cp in sorted(cmap):
        d = _canonical_decomposition(cp)
        if d and len(d) == 2 and unicodedata.normalize("NFC", chr(cp)) == chr(cp):
            out.append((*d, cp))
    return out


def _token_arrays(p: _Pil, tokens: list, ft: "_FreeType", hmtx, scale: int) -> Dict[str, np.ndarray]:
    """Each token's mask, offset and advance at one size: a string's as PIL
    draws it ("" is the invisible token; a mark's advance is hb-ft's, which
    the shapers that zero marks by GDEF zero); a glyph id's as FreeType renders
    it for Pillow, placed in the frame of PIL's masks (the offset from the
    anchor "la", calibrated on a few characters), with hb-ft's unhinted
    advance (`FT_Get_Advance`, then 26.6)."""
    frame = set()
    for s in "HxgAj":   # PIL's "la" offset of a glyph is FreeType's (left, ascender - top)
        m, off = p.mask(s)
        fm, left, top = ft.render(ft.glyph_of(ord(s)))
        (r, c), (fr, fc) = (tuple(int(np.flatnonzero(a.any(k))[0]) for k in (1, 0)) for a in (m, fm))
        frame.add((off[0] + c - left - fc, off[1] + r - fr + top))
    assert len(frame) == 1 and next(iter(frame))[0] == 0, f"PIL's glyph frame at {p.size} px: {frame}"
    ascender = frame.pop()[1]
    shapes, offsets, flat, adv = [], [], [], []
    for t in tokens:
        if isinstance(t, str):
            m, off = p.mask(t) if t else (np.zeros((0, 0), np.uint8), (0, 0))
            a = p.length(t) if t else 0
            if t.startswith("\u200b"):   # a mark: its own advance (PIL's is zeroed by GDEF after GPOS)
                a = ((hmtx[ft.glyph_of(ord(t[1]))] * scale + 32) // 64 + 512) >> 10
        else:
            m, left, top = ft.render(t)
            off, a = (left, ascender - top), ((hmtx[t] * scale + 32) // 64 + 512) >> 10
        shapes.append(m.shape)
        offsets.append(off)
        flat.append(m.reshape(-1))
        adv.append(a)
    return {f"shapes_{p.size}": np.array(shapes, np.int32).reshape(-1, 2),
            f"offsets_{p.size}": np.array(offsets, np.int32).reshape(-1, 2),
            f"masks_{p.size}": np.concatenate(flat), f"advances_{p.size}": np.array(adv, np.int32)}


def _kerning(pils, gpos, gid, served, tags, chosen, script_of, token_of_glyph, letter) -> Dict[int, np.ndarray]:
    """Each served tag's GPOS kern pairs, measured in a run of that tag
    where the pair can meet -> per size, rows (tag, glyph a, glyph b, 1/64
    px)."""
    kern: Dict[int, list] = {size: [] for size in pils}
    for t in served:
        for ga, gb in _kern_pairs(gpos, _feature_lookups(gpos, t, ("kern",)).get("kern", [])):
            a, b = token_of_glyph.get(gid[ga]), token_of_glyph.get(gid[gb])
            if a is None or b is None:
                continue
            real = {script_of(ord(ch)) for ch in a + b} - {"Zyyy", "Zinh"}
            if len(real) > 1 or any(chosen[s] != t for s in real) or (not real and t not in letter):
                continue   # never in one run of this tag
            ctx = letter.get(t, "")
            for size, p in pils.items():
                k = p.length(ctx + a + chr(ZWNJ) + b) - p.length(ctx + a) - p.length(b)
                if k:
                    kern[size].append((tags.index(t), gid[ga], gid[gb], k))
    return {size: np.array(sorted(rows), np.int32).reshape(-1, 4) for size, rows in kern.items()}


# the runs that tell a code point X's type in a USE run's own joining: (context before, run, context after), K
# an N'Ko letter
USE_JOINING_CASES = (("", "KXK", ""), ("", "KX", "K"), ("K", "XK", ""), ("K", "KXK", "K"), ("", "XK", ""),
                     ("", "KX", ""), ("K", "X", "K"), ("", "XKK", ""), ("", "KKX", ""))
USE_JOINING_ORDER = (arabic.U, arabic.T, arabic.D, arabic.R, arabic.L)


def _probe_use_joining(hb: HarfBuzz, joining, form_action: Dict[int, int], cps, script: str, letter: str
                       ) -> Dict[int, int]:
    """The type of each code point in the own joining of a run HarfBuzz
    shapes with USE and joining (N'Ko; `arabic.use_joining_actions`): the
    first of `USE_JOINING_ORDER` that gives each letter of every
    `USE_JOINING_CASES` run the form HarfBuzz gives it (`form_action`: the
    action of each form glyph of the script's tag; `joining`: HarfBuzz's
    joining type of every code point)."""
    out = {}
    for cp in cps:
        x = chr(cp)
        runs = []
        for pre, run, post in USE_JOINING_CASES:
            text = (pre + run + post).replace("K", letter).replace("X", x)
            start, end = len(pre), len(pre) + len(run)
            got = {cl: form_action.get(g, arabic.NONE) for g, _, _, _, cl in hb.shape(text, start, end, script, True,
                                                                                     12, clusters=True)}
            lines = [ord(c) for c in text]
            letters = [k for k in range(start, end) if (pre + run + post)[k] == "K"]
            runs.append((lines, start, end, letters, [got.get(k, -1) for k in letters]))
        for cand in USE_JOINING_ORDER:
            fits = True
            for line, start, end, letters, want in runs:
                own = [cand if c == cp else arabic.D for c in line[start:end]]
                acts = arabic.use_joining_actions([joining[c] for c in line[start:end]], own,
                                                  [joining[c] for c in line[max(0, start - 5):start][::-1]],
                                                  [joining[c] for c in line[end:end + 5]])
                if [a if a != arabic.ISOL else arabic.NONE for a in (acts[k - start] for k in letters)] != want:
                    fits = False
                    break
            if fits:
                out[cp] = cand
                break
        else:
            raise AssertionError(f"U+{cp:04X}: no joining type gives HarfBuzz's forms in a USE run")
    return out


# the lines that tell a code point X's syllable category: in a Tifinagh run (USE: a letter B, U+2D7F H, a digit
# B, "-" GB, the Vedic signs CS and VMPst, ZWNJ, "]" SE, "²" FMPst) and in a Khmer run (a letter, Coeng, the
# vowel signs of each position, Robatic, the other signs, a digit as a visible placeholder)
USE_CONTEXTS = ("X", "ⵜX", "ⵜXX", "ⵜ X", "ⵜ⵿X", "ⵜX⵿", "ⵜX⵿ⵜ", "ⵜXⵜ", "5X", "5X⵿", "5⵿X", "5XX", "ⵜ⵿ⵜX", "-X",
                "ⵜ⵿X⵿", "ⵜX\u200c", "ⵜX\u200cⵜ", "ⵜ-X", "\u1cf5X", "ⵜ\u1cf5X", "ⵜX\u1ce1", "ⵜ\u1ce1X", "ⵜ\u200cX",
                "ⵜX\u200c⵿", "ⵜ]X", "ⵜ²X", "ⵜX²", "5X⵿5", "5⵿5X", "5X5")
KHMER_CONTEXTS = ("X", "កX", "កXX", "ក X", "5X", "5XX", "ក្X", "កX្ក", "5X្ក", "កXិ", "កិX", "5Xិ", "5ិX",
                  "កXុ", "កុX", "5Xុ", "កXា", "កាX", "5Xា", "5Xេ", "5េX", "កXេ", "5X៉", "5៉X", "កXំ", "5Xំ",
                  "កXះ", "5Xះ", "។X", "5\u200cX", "5X\u200cិ", "5X្រ", "X5", "5X5", "5X្X", "ក\u200dX")
# marks whose USE category the USE specification gives by their Indic syllabic and positional categories
# (Devanagari's anusvara, nukta, vowel signs U and E, virama and stress sign anudatta; Khmer's vowel sign U; a
# Balinese musical symbol; Sundanese's final -r above): they anchor the pair lines beside the marks `use`
# holds, each checked too
USE_ANCHORS = {0x0902: use.VMABV, 0x093C: use.CMBLW, 0x0941: use.VBLW, 0x0947: use.VABV, 0x094D: use.H,
               0x0952: use.VMBLW, 0x17BB: use.VBLW, 0x1B6B: use.SMABV, 0x1B81: use.FABV}
# the lines with a second code point Y of a known category, both orders
USE_PAIRS = ("ⵜXY", "ⵜYX", "5XY", "ⵜ⵿XY")
KHMER_PAIRS = ("កXY", "កYX", "5XY", "5YX")


def _probe_categories(font: ShapedFont, hb: HarfBuzz, cps, script: int, code: str, contexts, pair_contexts,
                      anchors: Dict[int, int], candidates, table: Dict[int, int]) -> Dict[int, List[int]]:
    """The syllable categories under which the mirror shapes every one of
    `contexts` (X the code point) in a run of `script` (`code`) as
    HarfBuzz does, glyph for glyph, for each code point: `table` is the
    category table the run's shaper reads (set in turn to each of the
    `candidates`). Then, in rounds, each `pair_contexts` line with Y a
    code point whose category is known (the `anchors`, and those with one
    category left) narrows them down. The code points HarfBuzz shapes alike
    in every line (with the same combining class, decomposition and glyph)
    are probed once. Last, the code points still left with several
    categories, none of them the default (the first candidate, outside
    every cluster) and not every one, settle among themselves
    (`settle`)."""
    size = font.size
    dotted = font.glyphs[font.token_of[DOTTED_CIRCLE]]

    def glyphs(line: str, own):
        return tuple(-1 if g == own else g for g, *_ in hb.shape(line, 0, len(line), code, False, size))

    def mirror(line: str, own):
        try:
            return tuple(-1 if font.glyphs[t] == own else font.glyphs[t]
                         for t, *_ in font.shape_run([ord(c) for c in line], 0, len(line), script, False))
        except UnsupportedText:
            return None

    def own_glyph(cp):
        return font.glyphs[font.token_of[cp]] if cp in font.cmap else None

    def narrow(lines_of, fits) -> Dict[int, List[int]]:
        groups: Dict[tuple, List[int]] = {}
        for cp in cps:
            own = own_glyph(cp)
            key = (tuple(fits[cp]), _modified_ccc(cp), _canonical_decomposition(cp), cp in font.cmap,
                   tuple(glyphs(line, own) for line in lines_of(cp)))
            groups.setdefault(key, []).append(cp)
        out: Dict[int, List[int]] = {}
        for (cands, *_, want), members in groups.items():
            cp = members[0]
            own, lines = own_glyph(cp), lines_of(cp)
            left, held = [], table.pop(cp, None)
            for cand in cands:
                table[cp] = cand
                if all(mirror(line, own) == w for line, w in zip(lines, want)):
                    left.append(cand)
            table.pop(cp, None)
            if held is not None:
                table[cp] = held
            out.update({m: left for m in members})
        return out

    def settle(fits) -> Dict[int, List[int]]:
        """The categories left to a code point fit every line with one of
        known category; where two such code points meet, only some choices
        for the pair do (U+17CB then U+11A93 is a broken cluster, the other
        order is not: their categories FBLW, FPST, FMABV and FMBLW are
        ordered within a cluster). Each takes the first of its categories
        under which the pair lines with every one settled before it shape
        as HarfBuzz's; the one that more of the others must precede (a
        dotted circle between them, which a lower category shows) settles
        first. None fitting fails."""
        left = [cp for cp in cps
                if 1 < len(fits[cp]) < len(candidates) and candidates[0] not in fits[cp] and cp not in anchors]

        def lines(x, y):
            return [ctx.replace("X", chr(x)).replace("Y", chr(y)) for ctx in pair_contexts]

        def broken(line):
            return glyphs(line, None).count(dotted) > line.count(chr(DOTTED_CIRCLE))

        below = {x: sum(broken(line) for y in left if y != x for ctx, line in zip(pair_contexts, lines(x, y))
                        if ctx.index("Y") < ctx.index("X")) for x in left}
        settled = []
        for x in sorted(left, key=lambda cp: (-below[cp], cp)):
            for cand in fits[x]:
                table[x] = cand
                if all(mirror(line, None) == glyphs(line, None) for y in settled for line in lines(x, y)):
                    break
            else:
                raise AssertionError(f"U+{x:04X}: no syllable category shapes its pairs as HarfBuzz does in a "
                                     f"{code} run")
            settled.append(x)
        for x in settled:
            fits[x] = [table.pop(x)]
        return fits

    fits = narrow(lambda cp: [ctx.replace("X", chr(cp)) for ctx in contexts], {cp: list(candidates) for cp in cps})
    for _ in range(3):
        # the known categories: the anchors', those with one category left (a code point no category fits
        # in a round keeps what it had)
        known = {cp: f[0] for cp, f in fits.items() if len(f) == 1}
        known.update(anchors)
        reps = {}
        for cp in sorted(known, key=lambda c: (c not in anchors, len(fits.get(c, ())), c)):
            reps.setdefault(known[cp], cp)
        table.update({cp: known[cp] for cp in reps.values()})
        before = sum(map(len, fits.values()))
        new = narrow(lambda cp: [ctx.replace("X", chr(cp)).replace("Y", chr(y)) for ctx in pair_contexts
                                 for y in reps.values() if y != cp], fits)
        fits = {cp: new[cp] or fits[cp] for cp in fits}
        for y in reps.values():
            table.pop(y, None)
        if sum(map(len, fits.values())) == before:
            break
    return settle(fits)


def write_glyph_atlas(path: Path = ATLAS_PATH) -> Path:
    """Make the atlas (see the module docstring) and return its path."""
    from fontTools.ttLib import TTFont
    from fontTools.unicodedata import Scripts, script_name

    pils = {size: _Pil(size) for size in (font_size(d) for d in ATLAS_DPIS)}
    pil = pils[min(pils)]   # the probe's size
    tt = TTFont(pil.font.path)
    assert all(t.format != 14 for t in tt["cmap"].tables), "a cmap 14 (variation sequences) is not mirrored"
    cmap_names = tt.getBestCmap()
    gid = tt.getReverseGlyphMap()
    gsub, gpos, gdef = tt["GSUB"].table, tt["GPOS"].table, tt["GDEF"].table
    cmap = set(cmap_names)
    assert 0x2011 in cmap, "U+2011 would take U+2010's glyph: not mirrored"
    assert getattr(gdef, "MarkGlyphSetsDef", None) is None, "GDEF mark filtering sets are not mirrored"

    # scripts (Unicode 17, as HarfBuzz 12 has them) and their OpenType tags
    codes = sorted(set(Scripts.VALUES) | {"Zyyy", "Zinh"})
    script_starts = np.array(Scripts.RANGES, np.int32)
    script_values = np.array([codes.index(v) for v in Scripts.VALUES], np.int16)
    all_scripts = script_values[np.searchsorted(script_starts, np.arange(0x110000), side="right") - 1]
    script_of = [codes[v] for v in all_scripts.tolist()].__getitem__
    font_tags = {s.ScriptTag for s in gpos.ScriptList.ScriptRecord}
    assert font_tags == {s.ScriptTag for s in gsub.ScriptList.ScriptRecord}
    assert "thai" in font_tags, "without a thai tag HarfBuzz falls back to Thai PUA shaping, which is not mirrored"
    chosen = {c: script_tag(c, font_tags) for c in codes}
    tags = sorted(set(chosen.values()))
    shapers = {c: hb_ot_shaper_categorize(c, chosen[c]) for c in codes}
    refused = {c for c in codes if not mirrored(c, shapers[c])}
    served = sorted({chosen[c] for c in codes if c not in refused})
    # the tags whose shaper joins: the Arabic shaper's, USE's for a joining script (N'Ko)
    joining_tags = {chosen[c] for c in codes if c not in refused and (shapers[c] == ARABIC_SHAPER or (
        shapers[c] == USE_SHAPER and c in JOINING_SCRIPTS))}
    gdef_class = gdef.GlyphClassDef.classDefs
    _check_substitutions(gsub, served, joining_tags)
    uni = _unicode_tables()
    general = dict(uni["general"])   # HarfBuzz's general category where Python's differs (U+1171E: Mc)
    # HarfBuzz's joining type of a mark ArabicShaping.txt does not list is T (`get_joining_type`);
    # FriBiDi's Unicode 10 data leaves the later marks, and the enclosing ones, non-joining
    categories = [general.get(cp) or unicodedata.category(chr(cp)) for cp in range(0x110000)]
    is_mark = np.array([c in ("Mn", "Me") for c in categories])
    uni["joining"][is_mark] = arabic.T
    # and U for a spacing mark that was nonspacing in Unicode 10 (U+1734): HarfBuzz gives T to Mn, Me and Cf only
    spacing = np.array([c == "Mc" for c in categories])
    uni["joining"][spacing & (uni["joining"] == arabic.T)] = arabic.U

    classes, spaces = _classify(cmap, script_of, refused)
    for cp in range(0x110000):   # the letters of the other joining scripts, as HarfBuzz joins to them, and the
        # Arabic letters newer than FriBiDi's data (FriBiDi leaves them non-joining; HarfBuzz's table has them)
        if (classes[cp] in (GLYPH, NOTDEF) and categories[cp][0] == "L"
                and (script_of(cp) in JOINING_SCRIPTS or (script_of(cp) == "Arab" and uni["joining"][cp] == arabic.U))):
            uni["joining"][cp] = _context_joining(pil, cp)
    assert classes[NOTDEF_PROBE] == NOTDEF
    # tokens: the cmap's drawn characters (marks too), the spaces the font
    # lacks, the ligatures, the Arabic forms, the substitutions' glyphs
    # outside the cmap, .notdef and the invisible glyph
    drawn = [cp for cp in sorted(cmap) if classes[cp] == GLYPH]
    ligatures, lig_glyphs = [], []
    for t in served:
        if t != "arab":   # the Arabic shaper's ligatures are glyphs of the cmap
            for s, g in _font_ligatures(gsub, t, {cmap_names[cp]: cp for cp in drawn}):
                ligatures.append(s)
                lig_glyphs.append(gid[g])
    chars = drawn + spaces
    forms = _forms(gsub, gid, served, tags)
    cp_of_glyph = {gid[cmap_names[cp]]: cp for cp in reversed(drawn)}
    known = set(cp_of_glyph) | set(lig_glyphs)
    form_strings, form_glyphs = _form_strings(forms, cp_of_glyph, uni["joining"], known)
    known |= set(form_glyphs)
    char_of = {n: cp for cp, n in sorted(cmap_names.items(), reverse=True)}
    contextual = _contextual(gsub, served, char_of, gdef_class)
    skipped_chains = {li for t in served for li in _feature_lookups(gsub, t, ("ccmp",)).get("ccmp", [])
                      if gsub.LookupList.Lookup[li].LookupType == 6
                      and all(char_of.get(g) in contextual for st in gsub.LookupList.Lookup[li].SubTable
                              for g in st.Coverage.glyphs)}
    stage_rows = _gsub_stages(gsub, served, tags, skipped_chains, joining_tags)
    gsub_arrays = _gsub_tables(gsub, gid, [li for _, _, li in stage_rows])
    # the glyphs the mirrored substitutions reach from the tokens' glyphs;
    # a ligature whose components they never reach is dropped
    reach = set(known)
    ligs = gsub_arrays["gsub_ligatures"]
    while True:
        more = {b for _, a, b in gsub_arrays["single_substs"].tolist() if a in reach}
        more |= {row[1] for row in ligs.tolist() if all(c in reach for c in row[2:] if c >= 0)}
        if more <= reach:
            break
        reach |= more
    gsub_arrays["gsub_ligatures"] = ligs[[all(c in reach for c in row[2:] if c >= 0) for row in ligs.tolist()]]
    extras = sorted(reach - known)
    # a mark alone follows a ZWSP (no dotted circle); one with a canonical decomposition, which PIL would
    # draw decomposed there, is its glyph (a variation selector's cluster keeps it whole)
    strings = [gid[cmap_names[cp]] if _is_mark(cp) and _canonical_decomposition(cp) else
               ("\u200b" if _is_mark(cp) else "") + chr(cp) for cp in chars] + ligatures + form_strings
    tokens = strings + extras + [chr(NOTDEF_PROBE), ""]
    space = gid[cmap_names[0x20]]
    glyphs = ([gid[cmap_names[cp]] for cp in drawn] + [space] * len(spaces) + lig_glyphs + form_glyphs + extras
              + [0, space])
    n_glyphs = len(tt.getGlyphOrder())
    glyph_classes = np.zeros(n_glyphs, np.int8)
    mark_attach = np.zeros(n_glyphs, np.int8)
    for g, c in gdef_class.items():
        glyph_classes[gid[g]] = c
    for g, c in (gdef.MarkAttachClassDef.classDefs if gdef.MarkAttachClassDef else {}).items():
        mark_attach[gid[g]] = c
    n_tokens = len(tokens)
    arrays = {
        "cmap": np.array(sorted(cmap), np.int32),
        "chars": np.array(chars, np.int32),
        "ligatures": np.array(ligatures),
        "extra_glyphs": np.array(extras, np.int32),
        "glyphs": np.array(glyphs, np.int32),
        "hidden": (np.arange(n_tokens) == n_tokens - 1).astype(np.uint8),
        "glyph_classes": glyph_classes,
        "mark_attach": mark_attach,
        "script_starts": script_starts,
        "script_values": script_values,
        "scripts": np.array(codes),
        "script_names": np.array([script_name(c) for c in codes]),
        "tags": np.array(tags),
        "script_tags": np.array([tags.index(chosen[c]) for c in codes], np.int8),
        "script_shapers": np.array([shapers[c] for c in codes], np.int8),
        "compose": np.array(_compositions(cmap), np.int32).reshape(-1, 3),
        "contextual": np.array(contextual, np.int32),
        "brackets": np.array(_probe_brackets(pil, script_of), np.int32).reshape(-1, 2),
        "forms": np.array(form_strings, dtype=str),
        "bidi_brackets": uni["bidi_brackets"],
        "mirror": np.array([(c, m) for c, m in uni["mirrors"] if m in cmap], np.int32).reshape(-1, 2),
        "script_directions": np.array([RTL_SCRIPT if c in RTL_SCRIPTS else NO_DIRECTION if c in UNDIRECTED_SCRIPTS
                                       else LTR_SCRIPT for c in codes], np.int8),
        "forms_substs": np.array(forms, np.int32).reshape(-1, 4),
        "general_cps": np.array(sorted(general), np.int32),
        "general_categories": np.array([general[cp] for cp in sorted(general)]),
        "gsub_lookups": np.array(stage_rows, np.int32).reshape(-1, 3),
        "libraries": uni["libraries"],
        **gsub_arrays,
        **_mark_positioning(gpos, gid, served, tags, sorted(pils), tt["head"].unitsPerEm),
    }
    arrays["bidi_starts"], arrays["bidi_values"] = _ranges(uni["bidi"])
    arrays["joining_starts"], arrays["joining_values"] = _ranges(uni["joining"])
    # the own joining of a run that HarfBuzz shapes with USE and joining (N'Ko), probed for everything such a
    # run may hold (a code point that decomposes is shaped as its parts)
    hb = HarfBuzz(pil.font.path)
    use_joining = np.full(0x110000, arabic.U, np.int8)
    for code in sorted(c for c in codes if shapers[c] == USE_SHAPER and chosen[c] in joining_tags):
        tag = tags.index(chosen[code])
        form_action = {b: action for t, action, _, b in forms if t == tag}
        formed = {a for t, _, a, _ in forms if t == tag}
        letter = next(chr(cp) for cp in drawn if script_of(cp) == code and gid[cmap_names[cp]] in formed)
        cands = [cp for cp in np.flatnonzero(np.isin(classes, (GLYPH, NOTDEF, COMPOSES, HIDDEN))).tolist()
                 if (script_of(cp) in (code, "Zyyy", "Zinh") or categories[cp] == "Mn") and cp != 0x0A
                 and not _canonical_decomposition(cp)]
        for cp, t in _probe_use_joining(hb, uni["joining"], form_action, cands, code, letter).items():
            use_joining[cp] = t
    arrays["use_joining_starts"], arrays["use_joining_values"] = _ranges(use_joining)
    arrays["use_categories"] = np.zeros((0, 2), np.int32)
    arrays["khmer_categories"] = np.zeros((0, 2), np.int32)
    # the default-ignorables that leave "A?V" one run (a bidi control may split it, a Mongolian one
    # starts a run of its script)
    hidden_cps = [cp for cp in np.flatnonzero(classes == HIDDEN).tolist()
                  if not bidi.needs_bidi(uni["bidi"][[0x41, cp, 0x56]].tolist())
                  and (script_of(cp) in ("Zyyy", "Zinh") or unicodedata.category(chr(cp)) == "Mn")]
    arrays["lig_blockers"] = np.array([cp for cp in hidden_cps if not pil.draws(f"f{chr(cp)}i", "fi")], np.int32)
    av = pil.length("AV")
    assert all(pil.length(f"A{chr(cp)}V") == av for cp in hidden_cps), "a default-ignorable stops kerning"
    # and those a lam-alef does not form across (ZWJ keeps the joining but blocks `rlig`); one that puts
    # itself at another bidi level than the letters around it (LRM) splits the run instead, and is
    # passed over where it shares their run (after an LRO)
    for key, alef, ligature in (("rlig_blockers", ALEF, 0xFEFB), ("arabic_liga_blockers", ALEF_HAMZA, 0xFEF7)):
        one_run = [cp for cp in hidden_cps
                   if len(set(bidi.embedding_levels(uni["bidi"][[LAM, cp, alef]].tolist(), [0, 0, 0])[0])) == 1]
        arrays[key] = np.array([cp for cp in one_run
                                if not pil.draws(chr(LAM) + chr(cp) + chr(alef), chr(ligature))], np.int32)
    hmtx = {gid[g]: adv for g, (adv, _) in tt["hmtx"].metrics.items()}
    for size, p in pils.items():
        ft = _FreeType(pil.font.path, size)
        try:
            arrays.update(_token_arrays(p, tokens, ft, hmtx, _scales(size, tt["head"].unitsPerEm)[0]))
        finally:
            ft.close()
    token_of_glyph = {}
    for s, g in zip(strings[:len(drawn)] + ligatures, glyphs[:len(drawn)] + lig_glyphs):
        if isinstance(s, str):
            token_of_glyph.setdefault(g, s)
    letter = {"DFLT": ""}   # a letter that starts a run of each tag (a Common-only line is DFLT)
    for cp in drawn:
        if unicodedata.category(chr(cp))[0] == "L":
            letter.setdefault(chosen[script_of(cp)], chr(cp))
    mark_glyphs = {g for g, c in gdef_class.items() if c == 3} | {cmap_names[cp] for cp in drawn if _is_mark(cp)}
    for t in served:
        lookups = _feature_lookups(gpos, t, ("kern",)).get("kern", [])
        assert not any(a in mark_glyphs or b in mark_glyphs for a, b in _kern_pairs(gpos, lookups)), \
            f"{t}: a kern pair with a mark (the mirror kerns a base with the glyph after it)"
    kern = _kerning(pils, gpos, gid, served, tags, chosen, script_of, token_of_glyph, letter)
    arrays.update({f"kern_{size}": rows for size, rows in kern.items()})

    # the probe: every code point the rules let through, drawn in chunks
    arrays["class_starts"], arrays["class_values"] = _ranges(classes)
    font = ShapedFont(arrays, pil.size)
    todo = np.flatnonzero(np.isin(classes, (GLYPH, NOTDEF, COMPOSES, HIDDEN))).tolist()
    # the syllable categories HarfBuzz reads for the nonspacing marks of the other scripts (and what raqm keeps
    # in a run: the Inherited characters) in a USE and a Khmer run, probed; N'Ko's own, which `use` holds,
    # checked
    foreign = [cp for cp in todo if (categories[cp] == "Mn" or script_of(cp) == "Zinh") and classes[cp] != HIDDEN]
    for module, code, contexts, pairs, order, table, key in (
            (use, "Tfng", USE_CONTEXTS, USE_PAIRS, USE_ORDER, font.use_categories, "use_categories"),
            (khmer, "Khmr", KHMER_CONTEXTS, KHMER_PAIRS, KHMER_ORDER, font.khmer_categories, "khmer_categories")):
        own = [cp for cp in foreign if cp not in module.CATEGORY and script_of(cp) != code]
        checked = [cp for cp in todo if module is use and script_of(cp) == "Nkoo" and cp not in own]
        # the marks `module` holds (Khmer's; Tifinagh's and N'Ko's) and USE's anchors anchor the pairs
        anchors = {cp: c for cp, c in module.CATEGORY.items() if categories[cp] == "Mn"}
        anchors.update(USE_ANCHORS if module is use else {})
        fits = _probe_categories(font, hb, own + checked, codes.index(code), code, contexts, pairs, anchors, order,
                                 table)
        for cp in checked:
            assert module.CATEGORY.get(cp, order[0]) in fits[cp], \
                f"U+{cp:04X}: {module.__name__} holds a category HarfBuzz refutes"
        for cp in own:
            cat = anchors.get(cp, fits[cp][0] if fits[cp] else None)
            assert cat in fits[cp], f"U+{cp:04X}: no syllable category shapes it as HarfBuzz does in a {code} run"
            if cat != order[0]:
                table[cp] = cat
        arrays[key] = np.array(sorted(table.items()), np.int32).reshape(-1, 2)
    marks_todo = [cp for cp in todo if font.is_mark(cp) and classes[cp] != HIDDEN and script_of(cp) != "Hang"]
    todo = [cp for cp in todo if cp != 0x0A and not font.is_mark(cp)]   # marks are probed on bases below
    misdrawn: List[int] = []
    for i in range(0, len(todo), PROBE_CHUNK):
        _probe(font, pil, _chars(todo[i:i + PROBE_CHUNK]), misdrawn)
    # the Common characters in right-to-left runs: mirrored, reversed, a
    # Hebrew run's (between two Hebrew letters) and a Latin one's
    common = [cp for cp in todo if script_of(cp) in ("Zyyy", "Zinh") and cp not in misdrawn]
    for frame in (("\u05d0", "\u05d0"), ("\u05d0a", "\u05d0")):
        for i in range(0, len(common), PROBE_CHUNK):
            _probe(font, pil, _chars(common[i:i + PROBE_CHUNK]), misdrawn, frame)
    # joining: each letter an Arabic run may hold alone and between tatweels
    # (join-causing), each invisible character between two behs
    t = chr(TATWEEL)
    for cp in todo:
        if cp in misdrawn:
            continue
        if classes[cp] == HIDDEN:
            frames = [("\u0628", "\u0628")]
        elif script_of(cp) == "Arab" or uni["joining"][cp] not in (arabic.U, arabic.T):
            frames = [("", ""), (t, t), (t, ""), ("", t), ("\u0628", ""), ("", "\u0628")]
            if script_of(cp) == "Arab":   # FriBiDi's weak rules on the digits and signs after it, both directions
                frames += [("", "12"), ("", "%1"), ("", "+1"), ("", "-1"), ("a ", " 12"), ("a ", "%1"), ("a ", "-1+")]
        else:
            continue
        for frame in frames:
            same = _probe_chunk(font, pil, chr(cp), frame)
            assert same is not None, f"the mirror refuses U+{cp:04X} in {frame}"
            if not same:
                misdrawn.append(cp)
                break
    # the marks, at both sizes: on their bases, stacked, in the ccmp contexts and the ligatures
    mark_tags = sorted({tags[tag] for tag in arrays["mark_lookups"][:, 0].tolist()})
    units = _mark_units(gsub, gpos, cmap_names, drawn, marks_todo, script_of, chosen, mark_tags, skipped_chains)
    # every mark on a letter of each run whose shaper reads its syllable category (Khmer, Tifinagh, N'Ko)
    units["syllabic"] = [(base + chr(m), m) for base in ("\u1780", "\u2d5c", "\u07de") for m in marks_todo
                         if script_of(m) not in ("Khmr", "Tfng", "Nkoo")]
    for size, p in pils.items():
        sized = font if size == pil.size else ShapedFont(arrays, size)
        for group in units.values():
            for i in range(0, len(group), PROBE_CHUNK):
                _probe(sized, p, group[i:i + PROBE_CHUNK], misdrawn)
    classes[misdrawn] = MISDRAWN
    arrays["class_starts"], arrays["class_values"] = _ranges(classes)
    np.savez_compressed(path, **arrays)
    load_font.cache_clear()
    return Path(path)
