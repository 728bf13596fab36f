"""Makes `text_render`'s glyph atlas, `glyphs_dejavu_sans.npz`, with PIL
(raqm, FreeType) and fontTools from the DejaVuSans.ttf that
`ImageFont.truetype("DejaVuSans.ttf")` finds: the reference's font, and
with the FriBiDi and HarfBuzz that Pillow's raqm draws with (through
ctypes: `libfribidi.so.0` and Pillow's own `pillow.libs/libharfbuzz*`).
It runs where PIL is installed; nothing on the serving path imports it.

    python -c "from morphik_core_tpu_torch.parser.glyph_atlas import write_glyph_atlas; write_glyph_atlas()"

What it writes (`text_render.ShapedFont` reads it):

- `chars`: the code points drawn as a token of their own: the cmap's
  (bar marks, default-ignorables and refused scripts) and the spaces the
  font lacks; then the `ligatures` (with `ligature_tags`), the `forms`
  (the Arabic form glyphs outside the cmap, each drawn by PIL as its
  letter between ZWJs), the `.notdef` token and the hidden token.
  `glyphs`: each token's glyph id; `hidden`: 1 for the invisible token.
- per font size s: `shapes_s`, `offsets_s`, `masks_s` (u8, flat) as
  `getmask2(token, "L", anchor="la")` draws the token alone,
  `advances_s` (1/64 px, `getlength`), and `kern_s` rows (tag, glyph a,
  glyph b, 1/64 px): each pair of the GPOS `kern` lookups of a served
  OpenType script tag, measured with `getlength` inside a run of a script
  with that tag (`ctx + a + ZWNJ + b`: GPOS skips the ZWNJ, a ligature
  does not form across it).
- `class_starts` / `class_values`: each code point's class
  (`text_render.GLYPH` ...) as ranges. The rules give a class; a probe at
  12 px draws every code point the rules let through, in chunks of
  consecutive ones, with PIL and with the mirror, and a code point the two
  draw differently is refused (`MISDRAWN`).
- `script_starts` / `script_values` / `scripts` / `script_names`
  (ISO 15924, Unicode 17 from fontTools: the card's Python has no Script
  property), `script_tags` (each script's OpenType tag in `tags`, DFLT
  where the font has none) and `script_composes` (0 for Hangul, whose
  shaper does not recompose).
- `brackets`: the pairs raqm's script resolution matches, found by
  probing; `compose`: (base, mark, composite) for each composite the cmap
  holds; `lig_blockers`: the default-ignorables a ligature does not
  match across (probed); `contextual`: the characters a chain-context
  ccmp lookup of the font substitutes in sequence (its tone letters).
- bidi: `bidi_starts` / `bidi_values` (FriBiDi's type of every code
  point, in `bidi.TYPE_NAMES`' numbering), `bidi_brackets` (code point,
  FriBiDi's bracket type: minus the id of an opening bracket), `mirror`
  (HarfBuzz's mirror of each code point whose mirror the cmap holds),
  `script_directions` (HarfBuzz's native direction of each script),
  `libraries` (the FriBiDi, HarfBuzz and raqm versions).
- Arabic: `joining_starts` / `joining_values` (FriBiDi's joining types,
  as `arabic.U` ...; the probe confirms them), `arabic_forms` rows
  (action, glyph in, glyph out) of the `arab` form features,
  `arabic_ligatures` rows (stage: 0 `rlig`, 1 `liga`; ligature glyph,
  first, second) without marks, `rlig_blockers` / `arabic_liga_blockers`
  (the default-ignorables a lam-alef does not form across, probed).

The probe draws every code point the rules let through alone in chunks,
the Common ones also inside a Hebrew and a Latin right-to-left run, each
letter an Arabic run may hold alone, between tatweels and beside a beh,
and each invisible character between two behs.
"""

from __future__ import annotations

import unicodedata
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from morphik_core_tpu_torch.parser import arabic, bidi
from morphik_core_tpu_torch.parser.text_render import (
    ATLAS_DPIS, ATLAS_PATH, COMPOSES, FONT_NAME, GLYPH, HIDDEN, LTR_SCRIPT, MARK, MARKED, MISDRAWN, NO_DIRECTION,
    NOTDEF, RTL_SCRIPT, SHAPER, UNASSIGNED, ZWJ, ShapedFont, UnsupportedText, _blend_black, _canonical_decomposition,
    _composite, _is_mark, decompose, font_size, load_font)

# the scripts HarfBuzz 12 shapes with a shaper of its own (hb-ot-shaper.hh)
# that the port does not mirror: Indic, Khmer, Myanmar, Thai / Lao, the
# Universal Shaping Engine's, and the Arabic shaper's scripts but Arabic
# (Syriac, N'Ko, Mongolian and the rest). Arabic and Hebrew are mirrored.
SHAPER_SCRIPTS = frozenset("""
Syrc Nkoo Mong Beng Deva Gujr Guru Knda Mlym Orya Taml Telu Sinh Thai Laoo Khmr Mymr Tibt
Bali Batk Brah Bugi Buhd Cakm Cham Dupl Egyp Gran Hano Java Kthi Kali Khar Khoj Sind Lepc Limb Mahj Mtei
Modi Hmng Phag Phlp Rjng Saur Shrd Sidd Sund Tglg Tagb Tale Lana Tavt Takr Tirh Tfng Sylo Mand Mani Ahom
Mult Adlm Bhks Marc Newa Gonm Soyo Zanb Dogr Gong Rohg Maka Medf Sogo Sogd Elym Nand Hmnp Wcho Chrs Diak
Kits Yezi Cpmn Ougr Tnsa Toto Vith Kawi Nagm Gara Gukh Krai Onao Sunu Todr Tutg
""".split())
# the conjoining jamo, which the Hangul shaper composes into syllables
JAMO = (*range(0x1100, 0x1200), *range(0xA960, 0xA980), *range(0xD7B0, 0xD800))
# the spaces HarfBuzz draws with the space glyph where the font lacks them
# (`space_fallback_type`)
FALLBACK_SPACES = (0x20, 0xA0, *range(0x2000, 0x200B), 0x202F, 0x205F, 0x3000)
# `hb_script_get_horizontal_direction`: the right-to-left scripts, and those without a direction
RTL_SCRIPTS = frozenset("""
Arab Hebr Syrc Thaa Cprt Khar Phnx Nkoo Lydi Avst Armi Phli Prti Sarb Orkh Samr Mand Merc Mero Mani Mend Nbat Narb
Palm Phlp Hatr Adlm Rohg Sogo Sogd Elym Chrs Yezi Ougr Gara
""".split())
UNDIRECTED_SCRIPTS = frozenset(("Hung", "Ital", "Runr", "Tfng"))
# FriBiDi's joining type names -> the atlas's (HarfBuzz counts C as D; G is FriBiDi's "ignored")
JOINING = {"U": arabic.U, "L": arabic.L, "R": arabic.R, "D": arabic.D, "C": arabic.D, "T": arabic.T, "G": arabic.U}
FRIBIDI_TYPE_NAMES = {"LTR": "L", "RTL": "R", "BS": "B", "SS": "S"}
ALEF, ALEF_HAMZA, LAM, TATWEEL = 0x627, 0x623, 0x644, 0x640
# HarfBuzz's default shaper features that substitute (hb-ot-shape.cc)
DEFAULT_GSUB = ("ccmp", "locl", "rlig", "calt", "clig", "liga", "rclt")
# HarfBuzz's OpenType tags where they are not the ISO code in lower case
OT_TAGS = {"Hira": "kana", "Kana": "kana", "Laoo": "lao ", "Yiii": "yi  ", "Nkoo": "nko ", "Vaii": "vai "}
NOTDEF_PROBE = 0x4E2D   # 中: the font has no CJK
ZWNJ = 0x200C
PROBE_CHUNK = 128


def hb_default_ignorable(cp: int) -> bool:
    """`hb_unicode_funcs_t::is_default_ignorable` (hb-unicode.hh)."""
    return (cp in (0xAD, 0x34F, 0x61C, 0xFEFF) or 0x17B4 <= cp <= 0x17B5 or 0x180B <= cp <= 0x180F
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


def _probe_chunk(font: ShapedFont, pil: _Pil, cps: List[int], frame: tuple = ("", "")) -> Optional[bool]:
    """Whether PIL and the mirror draw the chunk (between the `frame`'s two
    strings) alike, pixels and advance; None where the mirror refuses it."""
    from PIL import Image, ImageDraw

    text = frame[0] + "".join(map(chr, cps)) + frame[1]
    want_len = pil.length(text)
    m = 2 * pil.size
    w, h = (want_len >> 6) + 4 * pil.size + 2 * m, 4 * pil.size
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


def _probe(font: ShapedFont, pil: _Pil, cps: List[int], misdrawn: List[int], frame: tuple = ("", "")) -> None:
    """Probe a chunk, halving it where it fails: a code point drawn
    otherwise alone (in the frame) is `misdrawn`; a chunk drawn otherwise
    whose halves are drawn alike is a fault of the mirror. A chunk the
    mirror refuses (a sequence of contextual forms) is fine where its
    halves pass."""
    same = _probe_chunk(font, pil, cps, frame)
    if same:
        return
    if len(cps) == 1:
        assert same is not None, f"the mirror refuses U+{cps[0]:04X} alone in {frame}"
        misdrawn.append(cps[0])
        return
    before = len(misdrawn)
    _probe(font, pil, cps[:len(cps) // 2], misdrawn, frame)
    _probe(font, pil, cps[len(cps) // 2:], misdrawn, frame)
    if same is False and len(misdrawn) == before:
        raise AssertionError(f"the mirror draws U+{cps[0]:04X}..U+{cps[-1]:04X} otherwise than PIL, but each "
                             "half alike: a shaping rule between characters is missing")


def _classify(cmap, script_of) -> tuple:
    """Each code point's class by rule -> (classes, the spaces drawn as the
    space glyph at their own width)."""
    classes = np.empty(0x110000, np.int8)
    jamo, spaces = set(JAMO), []
    for cp in range(0x110000):
        ch = chr(cp)
        cat = unicodedata.category(ch)
        if cat in ("Cn", "Cs"):
            cls = UNASSIGNED
        elif script_of(cp) in SHAPER_SCRIPTS or cp in jamo:
            cls = SHAPER
        elif hb_default_ignorable(cp):
            cls = HIDDEN
        elif cat[0] == "M":
            cls = MARK
        elif cp in cmap:
            cls = GLYPH
        else:
            parts = decompose(cp, True, cmap)
            if parts:
                cls = MARKED if any(map(_is_mark, parts)) else COMPOSES
            elif cp in FALLBACK_SPACES:
                cls = COMPOSES
                spaces.append(cp)
            else:
                cls = NOTDEF
        classes[cp] = cls
    return classes, spaces


def _marks_only(lookup, gdef_class) -> bool:
    """Whether every ligature of a ligature lookup takes a mark."""
    return all(any(gdef_class.get(g) == 3 for g in [first, *lig.Component])
               for st in lookup.SubTable for first, ligs in st.ligatures.items() for lig in ligs)


def _check_substitutions(gsub, served, gdef_class) -> None:
    """Every default substitution of a served tag is a `liga` ligature, a
    ccmp chain-context lookup (reached only through marks, refused, or the
    contextual characters, refused in sequence), a ligature of marks, or
    (under `arab`) a form feature's single substitution or an `rlig`
    ligature."""
    for t in served:
        for feat, lookups in _feature_lookups(gsub, t, DEFAULT_GSUB + tuple(arabic.FEATURES)).items():
            for li in lookups:
                lookup = gsub.LookupList.Lookup[li]
                kind = lookup.LookupType
                arab = t == "arab" and ((feat in arabic.FEATURES and kind == 1) or (feat == "rlig" and kind == 4))
                assert ((feat, kind) in (("liga", 4), ("ccmp", 6)) or arab
                        or (kind == 4 and _marks_only(lookup, gdef_class))), f"{t} {feat} lookup {li} (type {kind})"


def _arabic_gsub(gsub, gid, gdef_class) -> tuple:
    """The `arab` form features' substitutions, rows (action, glyph in,
    glyph out), and its `rlig` (stage 0) and `liga` (stage 1) ligatures
    without marks, rows (stage, ligature glyph, first, second)."""
    feats = _feature_lookups(gsub, "arab", tuple(arabic.FEATURES) + ("rlig", "liga"))
    forms = []
    for name, action in arabic.FEATURES.items():
        assert len(feats.get(name, [])) <= 1, f"arab {name}: the mirror applies one lookup a feature"
        for li in feats.get(name, []):
            for st in gsub.LookupList.Lookup[li].SubTable:
                forms += [(action, gid[a], gid[b]) for a, b in st.mapping.items()]
    ligatures = []
    for stage, name in enumerate(("rlig", "liga")):
        lookups = [li for li in sorted(feats.get(name, [])) if not _marks_only(gsub.LookupList.Lookup[li], gdef_class)]
        assert len(lookups) <= 1, f"arab {name}: the mirror applies one lookup a stage"
        for li in lookups:
            for st in gsub.LookupList.Lookup[li].SubTable:
                for first, ligs in st.ligatures.items():
                    for lig in ligs:
                        comps = [first, *lig.Component]
                        if not any(gdef_class.get(g) == 3 for g in comps):
                            assert len(comps) == 2, f"arab {name}: a ligature of {len(comps)} glyphs"
                            ligatures.append((stage, gid[lig.LigGlyph], gid[comps[0]], gid[comps[1]]))
    return sorted(forms), ligatures


def _form_strings(forms, cp_of_glyph, joining, known) -> tuple:
    """A token for each form glyph outside `known` (the cmap's and the
    ligatures' glyphs): the string PIL draws it with, its letter between
    ZWJs (join-causing, invisible) -> (strings, glyphs)."""
    strings, glyphs = [], []
    for action, a, b in forms:
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


def _unicode_tables() -> Dict[str, np.ndarray]:
    """FriBiDi's bidi types, bracket types and joining types and HarfBuzz's
    mirrors of every code point, from the libraries Pillow's raqm draws
    with (loaded here only)."""
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
    funcs = hb.hb_unicode_funcs_get_default()
    mirrors = [(cp, m) for cp in range(n) if (m := hb.hb_unicode_mirroring(funcs, cp)) != cp]
    libraries = [f"fribidi {features.version('fribidi')}", f"harfbuzz {features.version('harfbuzz')}",
                 f"raqm {features.version('raqm')}"]
    return {"bidi": bidi_types, "bidi_brackets": np.stack([has, ids], 1).astype(np.int32), "joining": joining,
            "mirrors": mirrors, "libraries": np.array(libraries)}


def _needs_a_mark(st, gdef_class) -> bool:
    """Whether every rule of a class-based chain-context subtable has a
    class of marks only in its context (it is reached only through a
    mark, which the atlas refuses)."""
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
                continue   # a ligature of marks (`_check_substitutions`)
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


def _token_arrays(p: _Pil, strings: List[str]) -> Dict[str, np.ndarray]:
    """Each token's mask, offset and advance at one size ("" is the
    invisible token)."""
    shapes, offsets, flat, adv = [], [], [], []
    for s in strings:
        m, off = p.mask(s) if s else (np.zeros((0, 0), np.uint8), (0, 0))
        shapes.append(m.shape)
        offsets.append(off)
        flat.append(m.reshape(-1))
        adv.append(p.length(s) if s else 0)
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
    gsub, gpos = tt["GSUB"].table, tt["GPOS"].table
    cmap = set(cmap_names)
    assert 0x2011 in cmap, "U+2011 would take U+2010's glyph: not mirrored"

    # scripts (Unicode 17, as HarfBuzz 12 has them) and their OpenType tags
    codes = sorted(set(Scripts.VALUES) | {"Zyyy", "Zinh"})
    script_starts = np.array(Scripts.RANGES, np.int32)
    script_values = np.array([codes.index(v) for v in Scripts.VALUES], np.int16)
    all_scripts = script_values[np.searchsorted(script_starts, np.arange(0x110000), side="right") - 1]
    script_of = [codes[v] for v in all_scripts.tolist()].__getitem__
    font_tags = {s.ScriptTag for s in gpos.ScriptList.ScriptRecord}
    assert font_tags == {s.ScriptTag for s in gsub.ScriptList.ScriptRecord}
    chosen = {c: OT_TAGS.get(c, c.lower()) if OT_TAGS.get(c, c.lower()) in font_tags else "DFLT" for c in codes}
    tags = sorted(set(chosen.values()))
    served = sorted({chosen[c] for c in codes if c not in SHAPER_SCRIPTS})
    gdef_class = tt["GDEF"].table.GlyphClassDef.classDefs
    _check_substitutions(gsub, served, gdef_class)
    uni = _unicode_tables()

    classes, spaces = _classify(cmap, script_of)
    assert classes[NOTDEF_PROBE] == NOTDEF
    # tokens: the cmap's drawn characters, the spaces the font lacks, the
    # ligatures, .notdef and the invisible glyph
    drawn = [cp for cp in sorted(cmap) if classes[cp] == GLYPH]
    ligatures, ligature_tags, lig_glyphs = [], [], []
    for t in served:
        if t == "arab":
            continue   # the Arabic shaper's ligatures are glyph rows of their own
        for s, g in _font_ligatures(gsub, t, {cmap_names[cp]: cp for cp in drawn}):
            ligatures.append(s)
            ligature_tags.append(tags.index(t))
            lig_glyphs.append(gid[g])
    chars = drawn + spaces
    forms, arabic_ligatures = _arabic_gsub(gsub, gid, gdef_class)
    cp_of_glyph = {gid[cmap_names[cp]]: cp for cp in reversed(drawn)}
    known = set(cp_of_glyph) | set(lig_glyphs)
    assert all(row[1] in known for row in arabic_ligatures), "an Arabic ligature outside the cmap"
    form_strings, form_glyphs = _form_strings(forms, cp_of_glyph, uni["joining"], known)
    strings = [chr(cp) for cp in chars] + ligatures + form_strings + [chr(NOTDEF_PROBE), ""]
    space = gid[cmap_names[0x20]]
    glyphs = ([gid[cmap_names[cp]] for cp in drawn] + [space] * len(spaces) + lig_glyphs + form_glyphs
              + [0, space])
    char_of = {n: cp for cp, n in sorted(cmap_names.items(), reverse=True)}
    arrays = {
        "cmap": np.array(sorted(cmap), np.int32),
        "chars": np.array(chars, np.int32),
        "ligatures": np.array(ligatures),
        "ligature_tags": np.array(ligature_tags, np.int8),
        "glyphs": np.array(glyphs, np.int32),
        "hidden": (np.arange(len(strings)) == len(strings) - 1).astype(np.uint8),
        "script_starts": script_starts,
        "script_values": script_values,
        "scripts": np.array(codes),
        "script_names": np.array([script_name(c) for c in codes]),
        "tags": np.array(tags),
        "script_tags": np.array([tags.index(chosen[c]) for c in codes], np.int8),
        "script_composes": np.array([c != "Hang" for c in codes], np.uint8),
        "compose": np.array(_compositions(cmap), np.int32).reshape(-1, 3),
        "contextual": np.array(_contextual(gsub, served, char_of, tt["GDEF"].table.GlyphClassDef.classDefs),
                               np.int32),
        "brackets": np.array(_probe_brackets(pil, script_of), np.int32).reshape(-1, 2),
        "forms": np.array(form_strings, dtype=str),
        "bidi_brackets": uni["bidi_brackets"],
        "mirror": np.array([(c, m) for c, m in uni["mirrors"] if m in cmap], np.int32).reshape(-1, 2),
        "script_directions": np.array([RTL_SCRIPT if c in RTL_SCRIPTS else NO_DIRECTION if c in UNDIRECTED_SCRIPTS
                                       else LTR_SCRIPT for c in codes], np.int8),
        "arabic_forms": np.array(forms, np.int32).reshape(-1, 3),
        "arabic_ligatures": np.array(arabic_ligatures, np.int32).reshape(-1, 4),
        "libraries": uni["libraries"],
    }
    arrays["bidi_starts"], arrays["bidi_values"] = _ranges(uni["bidi"])
    arrays["joining_starts"], arrays["joining_values"] = _ranges(uni["joining"])
    # the default-ignorables that leave "A?V" one run (a bidi control may split it)
    hidden_cps = [cp for cp in np.flatnonzero(classes == HIDDEN).tolist()
                  if not bidi.needs_bidi(uni["bidi"][[0x41, cp, 0x56]].tolist())]
    arrays["lig_blockers"] = np.array([cp for cp in hidden_cps if not pil.draws(f"f{chr(cp)}i", "fi")], np.int32)
    av = pil.length("AV")
    assert all(pil.length(f"A{chr(cp)}V") == av for cp in hidden_cps), "a default-ignorable stops kerning"
    # and those a lam-alef does not form across (ZWJ keeps the joining but blocks `rlig`)
    for key, alef, ligature in (("rlig_blockers", ALEF, 0xFEFB), ("arabic_liga_blockers", ALEF_HAMZA, 0xFEF7)):
        arrays[key] = np.array([cp for cp in hidden_cps
                                if not pil.draws(chr(LAM) + chr(cp) + chr(alef), chr(ligature))], np.int32)
    for p in pils.values():
        arrays.update(_token_arrays(p, strings))
    token_of_glyph = {}
    for s, g in zip(strings[:len(drawn)] + ligatures, glyphs[:len(drawn)] + lig_glyphs):
        token_of_glyph.setdefault(g, s)
    letter = {"DFLT": ""}   # a letter that starts a run of each tag (a Common-only line is DFLT)
    for cp in drawn:
        if unicodedata.category(chr(cp))[0] == "L":
            letter.setdefault(chosen[script_of(cp)], chr(cp))
    kern = _kerning(pils, gpos, gid, served, tags, chosen, script_of, token_of_glyph, letter)
    arrays.update({f"kern_{size}": rows for size, rows in kern.items()})

    # the probe: every code point the rules let through, drawn in chunks
    arrays["class_starts"], arrays["class_values"] = _ranges(classes)
    font = ShapedFont(arrays, pil.size)
    todo = [cp for cp in np.flatnonzero(np.isin(classes, (GLYPH, NOTDEF, COMPOSES, HIDDEN))).tolist() if cp != 0x0A]
    misdrawn: List[int] = []
    for i in range(0, len(todo), PROBE_CHUNK):
        _probe(font, pil, todo[i:i + PROBE_CHUNK], misdrawn)
    # the Common characters in right-to-left runs: mirrored, reversed, a
    # Hebrew run's (between two Hebrew letters) and a Latin one's
    common = [cp for cp in todo if script_of(cp) in ("Zyyy", "Zinh") and cp not in misdrawn]
    for frame in (("\u05d0", "\u05d0"), ("\u05d0a", "\u05d0")):
        for i in range(0, len(common), PROBE_CHUNK):
            _probe(font, pil, common[i:i + PROBE_CHUNK], misdrawn, frame)
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
        else:
            continue
        for frame in frames:
            same = _probe_chunk(font, pil, [cp], frame)
            assert same is not None, f"the mirror refuses U+{cp:04X} in {frame}"
            if not same:
                misdrawn.append(cp)
                break
    classes[misdrawn] = MISDRAWN
    arrays["class_starts"], arrays["class_values"] = _ranges(classes)
    np.savez_compressed(path, **arrays)
    load_font.cache_clear()
    return Path(path)
