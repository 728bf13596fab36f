"""Makes `text_render`'s glyph atlas, `glyphs_dejavu_sans.npz`, with PIL
(raqm, FreeType) and fontTools from the DejaVuSans.ttf that
`ImageFont.truetype("DejaVuSans.ttf")` finds: the reference's font. It
runs where PIL is installed; nothing on the serving path imports it.

    python -c "from morphik_core_tpu_torch.parser.glyph_atlas import write_glyph_atlas; write_glyph_atlas()"

What it writes (`text_render.ShapedFont` reads it):

- `chars`: the code points drawn as a token of their own: the cmap's
  (bar marks, default-ignorables and refused scripts) and the spaces the
  font lacks; then the `ligatures` (with `ligature_tags`), the `.notdef`
  token and the hidden token. `glyphs`: each token's glyph id; `hidden`:
  1 for the invisible token.
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
"""

from __future__ import annotations

import unicodedata
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from morphik_core_tpu_torch.parser.text_render import (
    ATLAS_DPIS, ATLAS_PATH, BIDI, COMPOSES, FONT_NAME, GLYPH, HIDDEN, MARK, MARKED, MISDRAWN, NOTDEF, SHAPER,
    UNASSIGNED, ShapedFont, UnsupportedText, _blend_black, _canonical_decomposition, _composite, _is_mark, decompose,
    font_size, load_font)

# the scripts HarfBuzz 12 shapes with a shaper of its own (hb-ot-shaper.hh):
# Arabic, Hebrew, Indic, Khmer, Myanmar, Thai / Lao, and the Universal
# Shaping Engine's; Mongolian and N'Ko take the Arabic one
SHAPER_SCRIPTS = frozenset("""
Arab Syrc Nkoo Mong Hebr Beng Deva Gujr Guru Knda Mlym Orya Taml Telu Sinh Thai Laoo Khmr Mymr Tibt
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
REFUSED_BIDI = frozenset("R AL AN LRE RLE LRO RLO PDF LRI RLI FSI PDI".split())
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


def _probe_chunk(font: ShapedFont, pil: _Pil, cps: List[int]) -> Optional[bool]:
    """Whether PIL and the mirror draw the chunk alike (pixels and advance);
    None where the mirror refuses it."""
    from PIL import Image, ImageDraw

    text = "".join(map(chr, cps))
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


def _probe(font: ShapedFont, pil: _Pil, cps: List[int], misdrawn: List[int]) -> None:
    """Probe a chunk, halving it where it fails: a code point drawn
    otherwise alone is `misdrawn`; a chunk drawn otherwise whose halves are
    drawn alike is a fault of the mirror. A chunk the mirror refuses (a
    sequence of contextual forms) is fine where its halves pass."""
    same = _probe_chunk(font, pil, cps)
    if same:
        return
    if len(cps) == 1:
        assert same is not None, f"the mirror refuses U+{cps[0]:04X} alone"
        misdrawn.append(cps[0])
        return
    before = len(misdrawn)
    _probe(font, pil, cps[:len(cps) // 2], misdrawn)
    _probe(font, pil, cps[len(cps) // 2:], misdrawn)
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
        elif unicodedata.bidirectional(ch) in REFUSED_BIDI:
            cls = BIDI
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


def _check_substitutions(gsub, served) -> None:
    """Every default substitution of a served tag is a `liga` ligature or
    a ccmp chain-context lookup (reached only through marks, refused, or
    the contextual characters, refused in sequence)."""
    for t in served:
        for feat, lookups in _feature_lookups(gsub, t, DEFAULT_GSUB).items():
            for li in lookups:
                kind = gsub.LookupList.Lookup[li].LookupType
                assert (feat, kind) in (("liga", 4), ("ccmp", 6)), f"{t} {feat} lookup {li} (type {kind})"


def _contextual(gsub, served, char_of, gdef_class) -> List[int]:
    """The characters of the ccmp chain-context subtables whose coverage
    holds no mark glyph: they change form next to each other."""
    out = set()
    for t in served:
        for li in _feature_lookups(gsub, t, ("ccmp",)).get("ccmp", []):
            for st in gsub.LookupList.Lookup[li].SubTable:
                cov = st.Coverage.glyphs
                if all(g in char_of and gdef_class.get(g) != 3 for g in cov):
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
    _check_substitutions(gsub, served)

    classes, spaces = _classify(cmap, script_of)
    assert classes[NOTDEF_PROBE] == NOTDEF
    # tokens: the cmap's drawn characters, the spaces the font lacks, the
    # ligatures, .notdef and the invisible glyph
    drawn = [cp for cp in sorted(cmap) if classes[cp] == GLYPH]
    ligatures, ligature_tags, lig_glyphs = [], [], []
    for t in served:
        for s, g in _font_ligatures(gsub, t, {cmap_names[cp]: cp for cp in drawn}):
            ligatures.append(s)
            ligature_tags.append(tags.index(t))
            lig_glyphs.append(gid[g])
    chars = drawn + spaces
    strings = [chr(cp) for cp in chars] + ligatures + [chr(NOTDEF_PROBE), ""]
    space = gid[cmap_names[0x20]]
    glyphs = [gid[cmap_names[cp]] for cp in drawn] + [space] * len(spaces) + lig_glyphs + [0, space]
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
    }
    hidden_cps = np.flatnonzero(classes == HIDDEN)
    arrays["lig_blockers"] = np.array([cp for cp in hidden_cps if not pil.draws(f"f{chr(cp)}i", "fi")], np.int32)
    av = pil.length("AV")
    assert all(pil.length(f"A{chr(cp)}V") == av for cp in hidden_cps), "a default-ignorable stops kerning"
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
    classes[misdrawn] = MISDRAWN
    arrays["class_starts"], arrays["class_values"] = _ranges(classes)
    np.savez_compressed(path, **arrays)
    load_font.cache_clear()
    return Path(path)
