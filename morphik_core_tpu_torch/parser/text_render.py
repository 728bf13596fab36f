"""The text-render page of `morphik_core_tpu/parser/pdf.py::_render_text_page`
without PIL or FreeType (the card's machine has neither, and may have no
font): extracted text drawn in DejaVuSans on a white letter-sized page.

The glyphs come from a committed atlas, `glyphs_dejavu_sans.npz`, that
`glyph_atlas.write_glyph_atlas` makes with PIL and fontTools from
DejaVuSans.ttf (on a machine with both and the font; nothing on the
serving path imports it). For
each font size the reference draws (18 px at 150 dpi, 12 px at 100 dpi) it
holds every token's mask as PIL draws it alone at an integer origin (with
its offset from the origin) and its advance in 1/64 px. A token is a
character of the font's cmap (combining marks too), a ligature of its
`liga` feature, an Arabic form glyph outside the cmap, a glyph outside the
cmap that a ccmp or mark-ligature substitution makes (a capital's accent,
a dotless i, shadda with a haraka), the `.notdef` box, the invisible
glyph of a default-ignorable character, or a space the font lacks (drawn
as its space, HarfBuzz's space fallback). Beside them, size for size, the
GPOS `kern` pairs as PIL measures them inside a run of each script that
can hold the pair, and the GPOS mark anchors; the GDEF classes; the GSUB
lookups the mirror applies; and, for every code point, its class (`GLYPH`
... `MISDRAWN` below), its script (ISO 15924), its FriBiDi bidi type and
bracket, its HarfBuzz mirror, its joining type (HarfBuzz's) and the one
HarfBuzz's USE shaper joins N'Ko on, and, for the brackets that raqm
pairs, its partner; HarfBuzz's general category where Unicode 17 differs
from Python's (U+1171E is a spacing mark there); and the syllable
category HarfBuzz reads for a nonspacing mark of another script in a USE
or a Khmer run.

The reference's layout is Pillow's raqm (FriBiDi + HarfBuzz), mirrored
here for every shaper HarfBuzz 12 picks under the font's script tags
(`glyph_atlas.hb_ot_shaper_categorize`): the default shaper (Latin,
Greek, Cyrillic, CJK, and the Indic scripts, Sinhala, Myanmar, Tibetan,
Syriac, Mongolian, Adlam and the other USE scripts, which give way to it
under DFLT), Hebrew, Arabic, Thai / Lao (`thai`), Khmer (`khmer`),
Hangul (`hangul`) and USE for Tifinagh and N'Ko (`use`):

- the bidi levels of `bidi.embedding_levels` (FriBiDi's, the paragraph
  direction from the line itself: each `line[:max_chars]` piece is a
  paragraph of its own) and raqm's runs of one level in visual order;
- raqm's script resolution: a Common character takes the script before
  it, a closing bracket the script of its opening one (a stack), and
  what is still Common or Inherited (a leading run) the script after it;
  a nonspacing mark of any script (HarfBuzz's general category) counts as
  Inherited, so it stays in its base's run; each level run splits into
  runs where the resolved script changes (a right-to-left one from its
  end), and each run is shaped alone under its script's OpenType script
  tag;
- in a right-to-left run, each character with a HarfBuzz mirror the font
  maps becomes its mirror (`(` draws `)`, `<` draws `>`, `«` draws `»`);
- HarfBuzz's native direction: a run whose direction is not its script's
  (Common punctuation of a Hebrew run at an even level, of a Latin run at
  an odd one) is shaped with its graphemes reversed; a run of Arabic
  script with digits and no letters is left-to-right;
- the shaper's text preprocessing: Thai / Lao's SARA AM splits and its
  NIKHAHIT moves before the tone marks; Hangul's tone marks move in
  front of a jamo syllable or get a dotted circle;
- HarfBuzz's normalization against the cmap: a cluster with marks
  decomposes fully, its marks sort by modified combining class (Hebrew
  points in SBL order, shadda first), then the shaper reorders (Arabic:
  the modifier marks to the front; Hebrew: patah or qamats before a
  sheva or hiriq before a meteg), and a base and its marks compose into a
  character the font maps; a character the font lacks decomposes into
  parts it maps, a variation selector leaves its cluster alone, U+3000
  takes the space glyph; a CGJ that kept marks apart stays hidden from
  GSUB;
- the syllable machines, with the category HarfBuzz reads for a mark of
  another script: Khmer's (a dotted circle at each broken cluster, Coeng
  Ro and the pre-base vowels to the front) and USE's for Tifinagh and
  N'Ko (a dotted circle at each broken cluster; no reordering, since the
  atlas holds no repha or pre-base vowel of a USE script), and N'Ko's
  joining (`arabic.use_joining_actions`);
- GSUB: the ccmp chain-context lookups (i and j dotless before a top
  mark, a capital's marks in their case forms, ayin before a point), the
  ligature lookups (Hebrew's yod with hiriq, `liga`), in an Arabic run
  `arabic`'s joining, forms and ligatures (the mark pairs, lam-alef over
  its marks, a haraka on a space or tatweel), and in an N'Ko run its
  joined forms (`nko `'s init, medi, fina); a ligature matches
  across the default-ignorables that do not block it and the marks its
  lookup ignores, which keep their ligature component;
- GPOS: `kern` pairs across every default-ignorable (a mark ends a pair:
  no pair has one), then `marks`: the run's mark, mark-to-ligature and
  mark-to-mark anchors, the marks' advances zeroed (not by the Hangul and
  Khmer shapers), the offsets propagated; a run whose tag has no `mark`
  feature
  leaves its marks unplaced, as HarfBuzz does for a font with a GPOS
  table (it falls back to positioning marks by glyph extents only for a
  font without one);
- a right-to-left run's glyphs laid out from its end: a kern pair's
  adjustment falls on the glyph that comes first in the shaping order;
- default-ignorables hidden (nothing drawn, no advance); the pen advances
  in 26.6 fixed point across the runs; a glyph sits at `(pen + x offset +
  32) >> 6` and its y offset, rounded the same way, moves it up;
  overlapping glyphs of a line composite as `src + dst * (255 - src) / 255`
  (`_imagingft.c`), and each line's mask is blended black over the page
  (`draw_bitmap`).

What the mirror cannot draw raises `UnsupportedText` (ROADMAP Queue 1
item 3b-ii): a code point unassigned in Python's Unicode 15.0 (those of
Unicode 16 and 17 among them), a sequence of the font's contextual tone
letters, the two bidi cases `bidi.refusal` names, a ZWJ before an
Extended_Pictographic character in a run shaped against its direction,
a code point the atlas's probe finds drawn otherwise (none in the
committed atlas), and a dpi whose font size the atlas lacks. The page
layout (margin, line height, `max_chars` wrapping, the half line after an
empty line, "(no extractable text)") is `_render_text_page`'s. The atlas
assumes HarfBuzz's default language system (a C or English locale): a
Romanian or Serbian locale would select other forms.
"""

from __future__ import annotations

import functools
import itertools
import unicodedata
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from morphik_core_tpu_torch.parser import arabic, bidi, hangul, khmer, marks, thai, use
from morphik_core_tpu_torch.parser.marks import Item

ATLAS_PATH = Path(__file__).with_name("glyphs_dejavu_sans.npz")
ATLAS_DPIS = (150, 100)
FONT_NAME = "DejaVuSans.ttf"
ROADMAP_ITEM = "ROADMAP Queue 1 item 3b-ii"

# a code point's class in the atlas; the classes from SHAPER on are refused
GLYPH, NOTDEF, COMPOSES, HIDDEN, SHAPER, UNASSIGNED, MISDRAWN = range(7)
_REFUSAL = {
    SHAPER: "is shaped by a HarfBuzz shaper that the port does not mirror for its script under the font's own "
            "OpenType tag",
    UNASSIGNED: f"is unassigned in Unicode {unicodedata.unidata_version}, a surrogate or a noncharacter",
    MISDRAWN: "is drawn by PIL otherwise than the atlas predicts",
}
DOTTED_CIRCLE = 0x25CC
ZWJ, ZWNJ, CGJ = 0x200D, 0x200C, 0x034F
# the shapers HarfBuzz picks (`hb_ot_shaper_categorize`); the port mirrors those
# before INDIC_SHAPER (USE for the scripts of `use.SCRIPTS`)
(DEFAULT_SHAPER, HEBREW_SHAPER, ARABIC_SHAPER, HANGUL_SHAPER, THAI_SHAPER, KHMER_SHAPER, USE_SHAPER, INDIC_SHAPER,
 MYANMAR_SHAPER) = range(9)
# `_hb_ot_shape_normalize`'s modes: NONE (Hangul), COMPOSED_DIACRITICS,
# COMPOSED_DIACRITICS_NO_SHORT_CIRCUIT (Khmer, USE)
NORMALIZE_NONE, NORMALIZE_COMPOSED, NORMALIZE_NO_SHORT_CIRCUIT = range(3)
_NORMALIZATION = {HANGUL_SHAPER: NORMALIZE_NONE, KHMER_SHAPER: NORMALIZE_NO_SHORT_CIRCUIT,
                  USE_SHAPER: NORMALIZE_NO_SHORT_CIRCUIT}
# the shapers that keep the marks' advances (`HB_OT_SHAPE_ZERO_WIDTH_MARKS_NONE`)
_MARKS_KEEP_ADVANCES = (HANGUL_SHAPER, KHMER_SHAPER)
# `_hb_modified_combining_class` (hb-unicode.cc): Hebrew points in the SBL
# order, shadda before the other harakat; the classes of the refused
# scripts it changes too
_MODIFIED_CCC = {10: 22, 11: 15, 12: 16, 13: 17, 14: 23, 15: 18, 16: 19, 17: 20, 18: 21, 19: 14, 20: 24, 21: 12,
                 22: 25, 23: 13, 24: 10, 25: 11, 27: 28, 28: 29, 29: 30, 30: 31, 31: 32, 32: 33, 33: 27, 84: 4,
                 91: 5, 103: 3, 130: 132, 132: 131}
# `modifier_combining_marks` (hb-ot-shaper-arabic.cc, UTR #53): moved to the
# front of their class-220 / 230 run of marks
_ARABIC_MCM = frozenset((0x0654, 0x0655, 0x0658, 0x06DC, 0x06E3, 0x06E7, 0x06E8, 0x08CA, 0x08CB, 0x08CD, 0x08CE,
                         0x08CF, 0x08D3, 0x08F3))
# HarfBuzz's native direction of a script (`hb_script_get_horizontal_direction`)
LTR_SCRIPT, RTL_SCRIPT, NO_DIRECTION = range(3)


class UnsupportedText(ValueError):
    """A text or dpi the atlas mirror cannot draw as the reference does."""


def font_size(dpi: int) -> int:
    return max(10, dpi // 8)


def _is_mark(cp: int) -> bool:
    """Whether a code point is a mark in Python's Unicode data (the atlas
    generator's test; `ShapedFont.is_mark` reads HarfBuzz's)."""
    return unicodedata.category(chr(cp))[0] == "M"


def _modified_ccc(cp: int) -> int:
    """HarfBuzz's modified combining class of a code point."""
    if cp in (0x1A60, 0x0FC6):
        return 254
    if cp == 0x0F39:
        return 127
    ccc = unicodedata.combining(chr(cp))
    return _MODIFIED_CCC.get(ccc, ccc)


def _reorder_marks(cps: Sequence[int], ccc: List[int], shaper: int) -> List[int]:
    """The shaper's `reorder_marks` over one run of marks sorted by
    modified class -> the new order (indices into the run); `ccc` is
    renumbered in place. Arabic: the modifier combining marks of class 220
    and 230 move to the front (as classes 25 and 26); Hebrew: a patah or
    qamats before a sheva or hiriq before a meteg or a below mark swaps
    the last two."""
    order = list(range(len(cps)))
    if shaper == HEBREW_SHAPER:
        for i in range(2, len(order)):
            if ccc[i - 2] in (20, 21) and ccc[i - 1] in (22, 23) and ccc[i] in (25, 220):
                order[i - 1], order[i] = order[i], order[i - 1]
                ccc[i - 1], ccc[i] = ccc[i], ccc[i - 1]
                break
    elif shaper == ARABIC_SHAPER:
        i = start = 0
        for cc in (220, 230):
            while i < len(order) and ccc[i] < cc:
                i += 1
            if i == len(order):
                break
            if ccc[i] > cc:
                continue
            j = i
            while j < len(order) and ccc[j] == cc and cps[order[j]] in _ARABIC_MCM:
                j += 1
            if i == j:
                continue
            order[start:j] = order[i:j] + order[start:i]
            ccc[start:j] = [25 if cc == 220 else 26] * (j - i) + ccc[start:i]
            start += j - i
            i = j
    return order


class _Memo(dict):
    """A function's value for each argument asked so far."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def __missing__(self, key):
        value = self[key] = self.fn(key)
        return value


def _sort_clusters(cl: List[Optional[int]], ccc: Sequence[int], start: int, end: int) -> None:
    """The clusters of `hb_buffer_t::sort` (an insertion sort by combining
    class) over `start:end`, in place: each mark it moves back merges the
    clusters it passes; the caller reorders the marks themselves."""
    keys = list(ccc[start:end])
    for i in range(1, len(keys)):
        j = i
        while j and keys[j - 1] > keys[i]:
            j -= 1
        if j == i:
            continue
        marks.merge_cluster_values(cl, start + j, start + i + 1)
        keys[j:i + 1] = [keys[i]] + keys[j:i]
        cl[start + j:start + i + 1] = [cl[start + i]] + cl[start + j:start + i]


def _is_variation_selector(cp: int) -> bool:
    """HarfBuzz's `is_variation_selector`: not the Mongolian free variation
    selectors, which it leaves to the Arabic shaper."""
    return 0xFE00 <= cp <= 0xFE0F or 0xE0100 <= cp <= 0xE01EF


def _canonical_decomposition(cp: int) -> Optional[Tuple[int, ...]]:
    """One step of `cp`'s canonical decomposition (1 or 2 code points), or
    None. Hangul syllables are left out: the font has no jamo to decompose
    them into."""
    d = unicodedata.decomposition(chr(cp))
    if not d or d.startswith("<"):
        return None
    return tuple(int(x, 16) for x in d.split())


def _khmer_decomposition(cp: int) -> Optional[Tuple[int, ...]]:
    """`decompose_khmer`: the split vowels, then Unicode's."""
    return khmer.SPLITS.get(cp) or _canonical_decomposition(cp)


def decompose(cp: int, shortest: bool, cmap, step=_canonical_decomposition) -> Optional[List[int]]:
    """HarfBuzz's `decompose`: `cp` as code points of `cmap` (the font's),
    or None; `step` is the shaper's one-step decomposition."""
    d = step(cp)
    if d is None or (len(d) == 2 and d[1] not in cmap):
        return None
    tail = list(d[1:])
    if shortest and d[0] in cmap:
        return [d[0]] + tail
    deeper = decompose(d[0], shortest, cmap, step)
    if deeper:
        return deeper + tail
    return [d[0]] + tail if d[0] in cmap else None


def _composite(places: Sequence[Tuple[int, int, np.ndarray]]) -> Tuple[np.ndarray, int, int]:
    """(x, y, mask) glyphs -> (line mask, x offset, y offset), overlapping
    glyphs composited as FreeType's bitmaps are in `_imagingft.c`."""
    if not places:
        return np.zeros((0, 0), np.uint8), 0, 0
    x0 = min(p[0] for p in places)
    y0 = min(p[1] for p in places)
    x1 = max(p[0] + p[2].shape[1] for p in places)
    y1 = max(p[1] + p[2].shape[0] for p in places)
    out = np.zeros((y1 - y0, x1 - x0), np.int64)
    for x, y, m in places:
        reg = out[y - y0:y - y0 + m.shape[0], x - x0:x - x0 + m.shape[1]]
        t = reg * (255 - m) + 128
        reg[...] = m + (((t >> 8) + t) >> 8)
    return out.astype(np.uint8), x0, y0


def _unpack_masks(shapes: np.ndarray, flat: np.ndarray) -> List[np.ndarray]:
    starts = np.concatenate([[0], np.cumsum(shapes[:, 0] * shapes[:, 1])])
    return [flat[starts[i]:starts[i + 1]].reshape(shapes[i]).astype(np.int64) for i in range(len(shapes))]


class GlyphFont:
    """A font laid out without shaping (Pillow's BASIC layout): one token a
    character, pairwise kerning between neighbours."""

    def __init__(self, tokens: List[str], masks: List[np.ndarray], offsets: np.ndarray, advances: np.ndarray,
                 kern: Dict[Tuple[int, int], int]):
        self.index = {t: i for i, t in enumerate(tokens)}
        self.masks = masks
        self.offsets = offsets.tolist()
        self.advances = advances.tolist()
        self.kern = kern

    def line_mask(self, line: str) -> Tuple[np.ndarray, int, int]:
        """-> (mask, x offset, y offset) of a line drawn at origin (0, 0)
        with anchor "la", as `FreeTypeFont.getmask2` gives it."""
        ids = [self.index[ch] for ch in line]
        places, pen = [], 0
        for k, t in enumerate(ids):
            if self.masks[t].size:
                places.append((((pen + 32) >> 6) + self.offsets[t][0], self.offsets[t][1], self.masks[t]))
            pen += self.advances[t] + (self.kern.get((t, ids[k + 1]), 0) if k + 1 < len(ids) else 0)
        return _composite(places)


class ShapedFont:
    """One font size of the DejaVuSans atlas, laid out as raqm lays it out."""

    def __init__(self, z, size: int):
        chars = z["chars"].tolist()
        self.size = size
        self.token_of = {c: i for i, c in enumerate(chars)}
        self.notdef = len(chars) + len(z["ligatures"]) + len(z["forms"]) + len(z["extra_glyphs"])
        self.hidden = int(np.flatnonzero(z["hidden"])[0])   # the invisible token of every default-ignorable
        self.cmap = set(z["cmap"].tolist())
        self.glyphs = z["glyphs"].tolist()
        self.token_of_glyph = {0: self.notdef}   # the first token of each glyph
        for i, g in enumerate(self.glyphs[:self.notdef]):
            self.token_of_glyph.setdefault(g, i)
        self.masks = _unpack_masks(z[f"shapes_{size}"], z[f"masks_{size}"])
        self.offsets = z[f"offsets_{size}"].tolist()
        self.advances = z[f"advances_{size}"].tolist()
        self.kern = {(int(t), int(a), int(b)): int(v) for t, a, b, v in z[f"kern_{size}"]}
        self.marks = marks.MarkTables(z, size)
        self._gsub_tables(z)
        self.class_starts = z["class_starts"]
        self.class_values = z["class_values"]
        ends = np.append(self.class_starts[1:], 0x110000)
        self.hidden_cps = {cp for a, b in zip(self.class_starts[self.class_values == HIDDEN],
                                              ends[self.class_values == HIDDEN]) for cp in range(a, b)}
        self.script_starts = z["script_starts"]
        self.script_values = z["script_values"]
        self.script_names = [str(s) for s in z["script_names"]]
        self.script_tags = z["script_tags"].tolist()
        self.script_shapers = z["script_shapers"].tolist()
        codes = [str(s) for s in z["scripts"]]
        self.common, self.inherited = codes.index("Zyyy"), codes.index("Zinh")
        self.brackets = {}
        for k, (o, c) in enumerate(z["brackets"].tolist()):
            self.brackets[o], self.brackets[c] = 2 * k, 2 * k + 1
        self.compose = {(int(a), int(b)): int(c) for a, b, c in z["compose"]}
        self.lig_blockers = set(z["lig_blockers"].tolist())
        self.contextual = set(z["contextual"].tolist())
        # bidi: FriBiDi's types and brackets, HarfBuzz's mirrors, the native directions
        self.bidi_starts, self.bidi_values = z["bidi_starts"], z["bidi_values"]
        self.bidi_brackets = dict(z["bidi_brackets"].tolist())
        self.mirror = dict(z["mirror"].tolist())
        self.script_directions = z["script_directions"].tolist()
        # joining types (HarfBuzz's; those of a USE run's own joining), each tag's form features'
        # substitutions; the default-ignorables each ligature stage does not match across
        self.joining_starts, self.joining_values = z["joining_starts"], z["joining_values"]
        self.use_joining_starts, self.use_joining_values = z["use_joining_starts"], z["use_joining_values"]
        self.forms: Dict[int, Dict[int, Dict[int, int]]] = {}
        for tag, action, a, b in z["forms_substs"].tolist():
            self.forms.setdefault(tag, {}).setdefault(action, {})[a] = b
        # HarfBuzz's general categories where Python's differ; the syllable categories of the other
        # scripts' marks in a USE and a Khmer run
        self.general = {int(cp): str(c) for cp, c in zip(z["general_cps"], z["general_categories"])}
        # `category(cp)`: HarfBuzz's general category; `is_mark(cp)`: whether it is a mark
        self.category = _Memo(lambda cp: self.general.get(cp) or unicodedata.category(chr(cp))).__getitem__
        self.is_mark = _Memo(lambda cp: self.category(cp)[0] == "M").__getitem__
        self.use_categories = dict(z["use_categories"].tolist())
        self.khmer_categories = dict(z["khmer_categories"].tolist())
        self.stage_blockers = [self.lig_blockers, set(z["rlig_blockers"].tolist()),
                               set(z["arabic_liga_blockers"].tolist())]

    def _gsub_tables(self, z) -> None:
        """The GSUB lookups the mirror applies: per OpenType script tag its
        stages (0: the default shaper's single stage, or the Arabic
        shaper's ccmp; 1: `rlig`; 2: `liga`), each a list of lookups; the
        ligature lookups' rows in the order HarfBuzz tries them; the ccmp
        chain-context lookups (class-based, one input glyph) and the single
        substitutions they call."""
        self.stages: Dict[int, List[List[int]]] = {}
        for tag, stage, lookup in z["gsub_lookups"].tolist():
            stages = self.stages.setdefault(tag, [[], [], []])
            stages[stage].append(lookup)
        self.gsub_flags = dict(z["gsub_flags"].tolist())
        self.lig_tables: Dict[int, Dict[int, List[Tuple[Tuple[int, ...], int]]]] = {}
        for lookup, out, *comps in z["gsub_ligatures"].tolist():
            comps = [c for c in comps if c >= 0]
            self.lig_tables.setdefault(lookup, {}).setdefault(comps[0], []).append((tuple(comps[1:]), out))
        self.singles: Dict[int, Dict[int, int]] = {}
        for lookup, a, b in z["single_substs"].tolist():
            self.singles.setdefault(lookup, {})[a] = b
        # chains[lookup][subtable] = (coverage, (backtrack, input, lookahead) class defs, rules per input class)
        self.chains: Dict[int, List[tuple]] = {}
        for lookup, sub, which, glyph, cls in z["chain_classes"].tolist():
            subs = self.chains.setdefault(lookup, [])
            while len(subs) <= sub:
                subs.append((set(), ({}, {}, {}), {}))
            if which == 3:
                subs[sub][0].add(glyph)
            else:
                subs[sub][1][which][glyph] = cls
        for lookup, sub, cls, nested, *ctx in z["chain_rules"].tolist():
            back = tuple(c for c in ctx[:3] if c >= 0)
            ahead = tuple(c for c in ctx[3:] if c >= 0)
            self.chains[lookup][sub][2].setdefault(cls, []).append((back, ahead, nested))

    # ------------------------------------------------------------ lookups

    def classes(self, cps: Sequence[int]) -> List[int]:
        idx = np.searchsorted(self.class_starts, np.asarray(cps, np.int64), side="right") - 1
        return self.class_values[idx].tolist()

    def scripts(self, cps: Sequence[int]) -> List[int]:
        idx = np.searchsorted(self.script_starts, np.asarray(cps, np.int64), side="right") - 1
        return self.script_values[idx].tolist()

    def bidi_types(self, cps: Sequence[int]) -> List[int]:
        idx = np.searchsorted(self.bidi_starts, np.asarray(cps, np.int64), side="right") - 1
        return self.bidi_values[idx].tolist()

    def joining(self, cps: Sequence[int]) -> List[int]:
        idx = np.searchsorted(self.joining_starts, np.asarray(cps, np.int64), side="right") - 1
        return self.joining_values[idx].tolist()

    def use_joining(self, cps: Sequence[int]) -> List[int]:
        idx = np.searchsorted(self.use_joining_starts, np.asarray(cps, np.int64), side="right") - 1
        return self.use_joining_values[idx].tolist()

    def refusal(self, cp: int, why: str) -> UnsupportedText:
        name = unicodedata.name(chr(cp), "")
        script = self.script_names[self.scripts([cp])[0]]
        return UnsupportedText(f"U+{cp:04X}{' ' + name if name else ''} (script {script}) {why}; the port "
                               f"cannot draw it as the reference does ({ROADMAP_ITEM})")

    # --------------------------------------------------- script resolution

    def resolve_scripts(self, cps: Sequence[int], scripts: Sequence[int]) -> List[int]:
        """raqm's `_raqm_resolve_scripts`: the script of each character. A
        Common or Inherited character takes the last script (a leading one
        is that script itself), an opening bracket pushes it, a closing one
        takes its opening one's; then each still Common or Inherited takes
        the script after it."""
        out = list(scripts)
        last_script_index = -1
        last_script = self.common
        stack: List[Tuple[int, int]] = []   # (script, bracket pair index) of the open brackets
        for i, s in enumerate(scripts):
            if s == self.common and last_script_index != -1:
                pair = self.brackets.get(cps[i])
                out[i] = last_script
                if pair is not None and pair % 2 == 0:
                    stack.append((last_script, pair))
                elif pair is not None:
                    while stack and stack[-1][1] != pair - 1:
                        stack.pop()
                    if stack:
                        out[i] = last_script = stack[-1][0]
            elif s == self.inherited and last_script_index != -1:
                out[i] = last_script
            else:
                last_script, last_script_index = s, i
        for i in range(len(out) - 2, -1, -1):
            if out[i] in (self.common, self.inherited):
                out[i] = out[i + 1]
        return out

    # ------------------------------------------------------- normalization

    def _token(self, cp: int) -> Optional[int]:
        """The token HarfBuzz draws for a code point the font maps (None: a
        mark, drawn only where it composes)."""
        return self.hidden if cp in self.hidden_cps else self.token_of.get(cp)

    def _glyphs(self, cp: int, shortest: bool, step=_canonical_decomposition) -> List[Tuple[int, Optional[int]]]:
        """HarfBuzz's `decompose_current_character` -> (code point, token)s."""
        if shortest and cp in self.cmap:
            return [(cp, self._token(cp))]
        parts = decompose(cp, shortest, self.cmap, step)
        if parts:
            return [(c, self._token(c)) for c in parts]
        if cp in self.cmap:
            return [(cp, self._token(cp))]
        if cp in self.token_of:   # a space the font lacks: the space glyph at its own width
            return [(cp, self.token_of[cp])]
        return [(cp, self.hidden if cp in self.hidden_cps else self.notdef)]

    def _nominal(self, cp: int) -> Tuple[int, Optional[int]]:
        if cp in self.cmap:
            return cp, self._token(cp)
        return cp, self.hidden if cp in self.hidden_cps else self.notdef

    def normalize(self, cps: Sequence[int], shaper: int, props: Optional[Sequence[int]] = None,
                  clusters: Optional[Sequence[int]] = None):
        """`_hb_ot_shape_normalize` over one run: decompose, reorder marks
        by modified combining class (then the shaper's `reorder_marks`),
        recompose -> (code point, token, whether it is a CGJ that stays
        hidden from GSUB: one that kept marks out of order). The mode is
        the shaper's: COMPOSED_DIACRITICS; the Hangul shaper's NONE neither
        recomposes nor decomposes a cluster fully; the Khmer and USE
        shapers' NO_SHORT_CIRCUIT decomposes a character the font maps
        too, and composes nothing onto a mark (`compose_khmer`,
        `compose_use`); the Khmer one splits its vowels first. `props`:
        the code point whose Unicode properties (mark, combining class)
        each character has (a shaper's dotted circle takes its mark's).
        `clusters`: HarfBuzz's cluster of each character, or None where
        they are not followed -> (the items, their clusters: a composed
        character takes the least of its parts'; None without `clusters`)."""
        props = list(cps) if props is None else list(props)
        out_cl: Optional[List[Optional[int]]] = None if clusters is None else []
        mode = _NORMALIZATION.get(shaper, NORMALIZE_COMPOSED)
        compose = mode != NORMALIZE_NONE
        might_short_circuit = mode != NORMALIZE_NO_SHORT_CIRCUIT
        step = _khmer_decomposition if shaper == KHMER_SHAPER else _canonical_decomposition
        out: List[Tuple[int, Optional[int]]] = []
        out_props: List[int] = []
        all_simple = True
        i = 0
        while i < len(cps):
            j = i + 1
            while j < len(cps) and self.is_mark(props[j]):
                j += 1
            if j > i + 1:
                all_simple = False
            vs = j > i + 1 and any(map(_is_variation_selector, cps[i:j]))
            for k in range(i, j):
                if vs:
                    parts = [self._nominal(cps[k])]   # the font has no cmap 14
                else:
                    parts = self._glyphs(cps[k], might_short_circuit if j == i + 1 else not compose, step)
                out.extend(parts)
                out_props.extend(props[k] if props[k] != cps[k] else c for c, _ in parts)
                if out_cl is not None:
                    out_cl.extend([clusters[k]] * len(parts))
            i = j
        if all_simple:
            return [(c, t, False) for c, t in out], out_cl
        ccc = [_modified_ccc(p) if self.is_mark(p) else 0 for p in out_props]
        i = 0
        while i < len(out):   # canonical order: each run of marks sorted by combining class
            if not ccc[i]:
                i += 1
                continue
            j = i
            while j < len(out) and ccc[j]:
                j += 1
            if j - i <= 32:
                order = sorted(range(i, j), key=lambda k: ccc[k])
                if out_cl is not None:
                    _sort_clusters(out_cl, ccc, i, j)
                out[i:j] = [out[k] for k in order]
                out_props[i:j] = [out_props[k] for k in order]
                ccc[i:j] = [ccc[k] for k in order]
                run_ccc = ccc[i:j]
                order = _reorder_marks([c for c, _ in out[i:j]], run_ccc, shaper)
                out[i:j] = [out[i + k] for k in order]
                out_props[i:j] = [out_props[i + k] for k in order]
                if out_cl is not None:
                    out_cl[i:j] = [out_cl[i + k] for k in order]
                ccc[i:j] = run_ccc
            i = j
        # a CGJ that kept marks out of order stays hidden: GSUB does not pass over it
        out = [(c, t, c == CGJ and not (0 < k < len(out) - 1 and (not ccc[k + 1] or ccc[k - 1] <= ccc[k + 1])))
               for k, (c, t) in enumerate(out)]
        if not compose:
            return out, out_cl
        res: List[Tuple[int, Optional[int], bool]] = [out[0]]
        res_ccc = [ccc[0]]
        res_cl = None if out_cl is None else out_cl[:1]
        starter = 0
        onto_marks = mode != NORMALIZE_NO_SHORT_CIRCUIT
        for k in range(1, len(out)):
            (cp, tok, held), cc, prop = out[k], ccc[k], out_props[k]
            if (self.is_mark(prop) and (starter == len(res) - 1 or res_ccc[-1] < cc)
                    and (onto_marks or not self.is_mark(res[starter][0]))):
                composed = self.compose.get((res[starter][0], cp))
                if composed is not None:
                    res[starter] = (composed, self._token(composed), False)
                    if res_cl is not None:
                        res_cl[starter:] = [min(res_cl[starter], out_cl[k])] * (len(res) - starter)
                    continue
            res.append((cp, tok, held))
            res_ccc.append(cc)
            if res_cl is not None:
                res_cl.append(out_cl[k])
            if not cc:
                starter = len(res) - 1
        return res, res_cl

    # ------------------------------------------------------------- shaping

    def _continues(self, cps: Sequence[int], i: int) -> bool:
        """Whether `cps[i]` continues the grapheme before it (HarfBuzz's
        `hb_set_unicode_props`: marks, ZWJ, emoji modifiers, a second
        regional indicator, TAG characters and the halfwidth sound marks;
        an Extended_Pictographic character after a ZWJ too, which
        `_reverse_graphemes` refuses rather than know)."""
        cp = cps[i]
        if self.is_mark(cp) or cp == ZWJ or 0x1F3FB <= cp <= 0x1F3FF or 0xE0020 <= cp <= 0xE007F or 0xFF9E <= cp <= 0xFF9F:
            return True
        if 0x1F1E6 <= cp <= 0x1F1FF and i and 0x1F1E6 <= cps[i - 1] <= 0x1F1FF:
            k = i - 1   # a regional indicator continues one that starts a pair
            while k and 0x1F1E6 <= cps[k - 1] <= 0x1F1FF:
                k -= 1
            return (i - k) % 2 == 1
        return False

    def _reverse_graphemes(self, cps: Sequence[int]) -> List[int]:
        """The order of `cps` with their graphemes reversed (indices)."""
        for i in range(1, len(cps) - 1):   # no letter, mark or digit but U+2139 is Extended_Pictographic
            nxt = cps[i + 1]
            if (cps[i] == ZWJ and nxt not in self.hidden_cps
                    and (self.category(nxt)[0] not in "LMN" or nxt == 0x2139)):
                raise self.refusal(nxt, "follows a ZWJ in a run shaped against its direction: HarfBuzz keeps an "
                                        "Extended_Pictographic character there in the ZWJ's grapheme, and the atlas "
                                        "has no emoji properties")
        groups: List[List[int]] = []
        for i in range(len(cps)):
            if groups and self._continues(cps, i):
                groups[-1].append(i)
            else:
                groups.append([i])
        return [i for g in reversed(groups) for i in g]

    def _native_rtl(self, cps: Sequence[int], script: int, rtl: bool) -> bool:
        """The direction HarfBuzz shapes a run in (`hb_ensure_native_direction`):
        its script's, a right-to-left script's digits without letters
        left-to-right, the run's own where the script has none."""
        native = self.script_directions[script]
        if native == NO_DIRECTION:
            return rtl
        if native == RTL_SCRIPT and not rtl:
            number = regional = False
            for cp in cps:
                cat = self.category(cp)
                if cat == "Nd":
                    number = True
                elif cat[0] == "L":
                    return True
                elif 0x1F1E6 <= cp <= 0x1F1FF:
                    regional = True
            return not (number or regional)
        return native == RTL_SCRIPT

    def _checked(self, items: List[Tuple[int, Optional[int], bool]]) -> None:
        prev = None
        for cp, tok, _ in items:
            if tok is None:
                cls = self.classes([cp])[0]
                raise self.refusal(cp, _REFUSAL.get(cls, "takes a glyph the atlas does not hold"))
            if tok == self.hidden:
                continue
            if prev is not None and prev in self.contextual and cp in self.contextual:
                raise self.refusal(cp, f"follows U+{prev:04X}: tone letters in sequence take the font's contextual "
                                       "(ccmp) contour forms")
            prev = cp

    def _zero_width(self, cp: int) -> bool:
        """Whether the font maps `cp` to a glyph without advance."""
        return cp in self.cmap and self.advances[self._token(cp)] == 0

    def _glyph_token(self, cp: int, glyph: int) -> int:
        if glyph not in self.token_of_glyph:
            raise self.refusal(cp, f"takes glyph {glyph}, which the atlas lacks")
        return self.token_of_glyph[glyph]

    def _context(self, run: List[Item], i: int, step: int, classes: Tuple[int, ...], class_def,
                 blockers) -> bool:
        """Whether the glyphs before (`step` -1) or after (+1) `run[i]`
        have the chain rule's `classes`, across the default-ignorables a
        context skips (all but the hidden ones GSUB does not skip: the
        `blockers` other than ZWNJ, and a CGJ held hidden)."""
        j = i
        for cls in classes:
            j += step
            while 0 <= j < len(run) and run[j].ignorable and not run[j].held and (run[j].cp not in blockers
                                                                                or run[j].cp == ZWNJ):
                j += step
            if not 0 <= j < len(run) or run[j].ignorable or class_def.get(run[j].glyph, 0) != cls:
                return False
        return True

    def _chain(self, run: List[Item], lookup: int, blockers) -> None:
        """A ccmp chain-context lookup (class-based rules of one input
        glyph), in place: the first rule that matches applies its single
        substitution."""
        for i, item in enumerate(run):
            if item.ignorable:
                continue
            for coverage, (back_def, input_def, ahead_def), rules in self.chains[lookup]:
                if item.glyph not in coverage:
                    continue
                hit = next((nested for back, ahead, nested in rules.get(input_def.get(item.glyph, 0), ())
                            if self._context(run, i, -1, back, back_def, blockers)
                            and self._context(run, i, 1, ahead, ahead_def, blockers)), None)
                if hit is not None:
                    item.glyph = self.singles[hit].get(item.glyph, item.glyph)
                    break

    def _substitute(self, run: List[Item], lookups: Sequence[int], blockers, lig_ids) -> List[Item]:
        """A stage's lookups in order; then each glyph a substitution
        changed takes its token."""
        for lookup in lookups:
            if lookup in self.chains:
                self._chain(run, lookup, blockers)
            elif not self.lig_tables[lookup].keys().isdisjoint([it.glyph for it in run]):
                ignore_marks = bool(self.gsub_flags[lookup] & marks.IGNORE_MARKS)
                run = arabic.ligate(run, self.lig_tables[lookup], self.marks.classes, ignore_marks, blockers,
                                    lig_ids)
        for item in run:
            if not item.ignorable and self.glyphs[item.tok] != item.glyph:
                item.tok = self._glyph_token(item.cp, item.glyph)
        return run

    def _joining(self, items: Sequence[Tuple[int, Optional[int], bool]], line: Sequence[int], start: int, end: int,
                 own: bool) -> List[int]:
        """The joining action of each of a run's normalized items (in
        shaping order); the line around the run is its joining context.
        `own`: the USE shaper's joining (N'Ko), the run's own joining first,
        in which a CGJ held visible to GSUB does not join."""
        cps = [cp for cp, _, _ in items]
        before = self.joining(line[max(0, start - arabic.CONTEXT):start][::-1])
        after = self.joining(line[end:end + arabic.CONTEXT])
        if own:
            types = [arabic.U if held else t for t, (_, _, held) in zip(self.use_joining(cps), items)]
            return arabic.use_joining_actions(self.joining(cps), types, before, after)
        return arabic.joining_actions(self.joining(cps), before, after)

    def _forms(self, run: List[Item], actions: Sequence[int], tag: int) -> None:
        """The tag's form features (`fina`, `medi`, `init`) over one run, in place."""
        forms = self.forms.get(tag, {})
        for item, action in zip(run, actions):
            g = None if item.ignorable else forms.get(action, {}).get(item.glyph)
            if g is not None:
                item.glyph = g

    def shape_run(self, line: Sequence[int], start: int, end: int, script: int, rtl: bool, clusters: bool = False
                  ) -> List[Tuple[int, int, int, int, Optional[int]]]:
        """One raqm run of the line, `line[start:end]` -> (token, advance,
        x offset, y offset, in 1/64 px, cluster) in visual order. The
        cluster is None unless `clusters` asks for HarfBuzz's (the index in
        `line` its grapheme starts at, merged over a composition, the
        marks' sort, a ligature and a Khmer reordering; a dotted circle
        takes its syllable's; not followed through the Thai and Hangul
        preprocessing, which gives None). The run at the line's start,
        when it starts with a mark, gets HarfBuzz's dotted circle in
        front."""
        cps = list(line[start:end])
        lead = bool(not start and cps and self.is_mark(cps[0]) and DOTTED_CIRCLE in self.cmap)
        if lead:
            cps = [DOTTED_CIRCLE, *cps]
        if rtl:
            cps = [self.mirror.get(cp, cp) for cp in cps]
        cl = None
        if clusters:   # `hb_form_clusters`: a grapheme's characters take the cluster of its first
            src = [start] * lead + list(range(start, end))
            cl = []
            for i in range(len(cps)):
                cl.append(cl[-1] if i and self._continues(cps, i) else src[i])
        native_rtl = self._native_rtl(cps, script, rtl)
        if native_rtl != rtl:
            order = self._reverse_graphemes(cps)
            cps = [cps[i] for i in order]
            if cl is not None:
                cl = [cl[i] for i in order]
        shaper = self.script_shapers[script]
        if shaper == THAI_SHAPER:
            cps = thai.preprocess(cps)
        props = None
        if shaper == HANGUL_SHAPER:
            cps, props = hangul.preprocess(cps, self.cmap.__contains__, self._zero_width)
        if cl is not None and len(cl) != len(cps):
            cl = [None] * len(cps)
        items, cl = self.normalize(cps, shaper, props, cl)
        self._checked(items)
        tag = self.script_tags[script]
        item_cps = [cp for cp, _, _ in items]
        # the joining (after normalization, before the syllables' dotted circles)
        actions = self._joining(items, line, start, end, shaper == USE_SHAPER) if tag in self.forms else None
        if shaper in (KHMER_SHAPER, USE_SHAPER):   # the syllables, after normalization
            dotted = (DOTTED_CIRCLE, self._token(DOTTED_CIRCLE), False) if DOTTED_CIRCLE in self.cmap else None
            # the new order (a dotted circle as -1; USE's as -1 - the index of the item it was put
            # before, whose cluster it takes) and the clusters
            if shaper == KHMER_SHAPER:
                order, cl = khmer.shape(list(range(len(items))), item_cps, self.khmer_categories,
                                        -1 if dotted is not None else None, cl)
            else:
                order = use.shape(item_cps, [cp in self.hidden_cps for cp in item_cps],
                                  [self.is_mark(cp) for cp in item_cps], self.use_categories, dotted is not None)
                if cl is not None:
                    cl = [cl[i if i >= 0 else -1 - i] for i in order]
            items = [items[i] if i >= 0 else dotted for i in order]
            if actions is not None:
                actions = [actions[i] if i >= 0 else arabic.NONE for i in order]
        run = [Item(cp, tok, self.glyphs[tok], tok == self.hidden, held) for cp, tok, held in items]
        if cl is not None:
            for it, c in zip(run, cl):
                it.cluster = c
        action_of = None if actions is None else {id(it): a for it, a in zip(run, actions)}
        lig_ids = itertools.count(1)   # HarfBuzz's ligature ids, one a ligature formed
        for stage, lookups in enumerate(self.stages.get(tag, [[], [], []])):
            run = self._substitute(run, lookups, self.stage_blockers[stage], lig_ids)
            if stage == 0 and action_of is not None:   # the form features come between ccmp and rlig
                self._forms(run, [action_of.get(id(it), arabic.NONE) for it in run], tag)
        advances = [self.advances[it.tok] for it in run]
        nxt = None
        for k in range(len(run) - 1, -1, -1):   # kerning with the next glyph GPOS does not skip
            if run[k].ignorable:
                continue
            if nxt is not None:
                advances[k] += self.kern.get((tag, run[k].glyph, run[nxt].glyph), 0)
            nxt = k
        adv, xo, yo = self.marks.position(tag, run, advances, native_rtl, shaper not in _MARKS_KEEP_ADVANCES)
        out = [(it.tok, a, x, y, it.cluster) for it, a, x, y in zip(run, adv, xo, yo)]
        return out[::-1] if native_rtl else out

    def runs(self, line: str) -> List[Tuple[int, int, int, bool]]:
        """The raqm runs of a line in visual order -> (start, end, script,
        right-to-left); raises `UnsupportedText` for what the atlas
        refuses."""
        cps = [ord(c) for c in line]
        for cp, cls in zip(cps, self.classes(cps)):
            if cls >= SHAPER:
                raise self.refusal(cp, _REFUSAL[cls])
        # raqm resolves a nonspacing mark of any script as Inherited: it stays in its base's run
        scripts = [self.inherited if self.category(cp) == "Mn" else s
                   for cp, s in zip(cps, self.scripts(cps))]
        scripts = self.resolve_scripts(cps, scripts)
        types = self.bidi_types(cps)
        if bidi.needs_bidi(types):
            why = bidi.refusal(types)
            if why is not None:
                raise self.refusal(cps[why[0]], why[1])
            levels, _ = bidi.embedding_levels(
                types, [self.bidi_brackets.get(cp, 0) if t == bidi.ON else 0 for cp, t in zip(cps, types)])
            level_runs = bidi.visual_runs(levels)
        else:
            level_runs = [(0, len(cps), 0)]
        out = []
        for start, end, level in level_runs:
            pieces, s = [], start
            for i in range(start + 1, end + 1):
                if i == end or scripts[i] != scripts[s]:
                    pieces.append((s, i, scripts[s], bool(level % 2)))
                    s = i
            out += pieces[::-1] if level % 2 else pieces
        return out

    def layout(self, line: str) -> Tuple[List[Tuple[int, int, np.ndarray]], int]:
        """-> ((x, y, mask) of each drawn glyph, the pen's end in 1/64 px)."""
        places, pen = [], 0
        cps = [ord(c) for c in line]
        for start, end, script, rtl in self.runs(line):
            for t, adv, xo, yo, _ in self.shape_run(cps, start, end, script, rtl):
                m = self.masks[t]
                if m.size:   # Pillow: PIXEL(pen + x offset), the y offset upwards
                    places.append((((pen + xo + 32) >> 6) + self.offsets[t][0],
                                   self.offsets[t][1] - ((yo + 32) >> 6), m))
                pen += adv
        return places, pen

    def line_mask(self, line: str) -> Tuple[np.ndarray, int, int]:
        """-> (mask, x offset, y offset) of a line drawn at origin (0, 0)
        with anchor "la", as `FreeTypeFont.getmask2` gives it."""
        return _composite(self.layout(line)[0])


@functools.lru_cache(maxsize=None)
def load_font(dpi: int) -> ShapedFont:
    """The atlas font for `_render_text_page(..., dpi)`."""
    if dpi not in ATLAS_DPIS:
        raise UnsupportedText(
            f"dpi {dpi} draws DejaVuSans at {font_size(dpi)} px; the glyph atlas {ATLAS_PATH.name} holds dpi "
            f"{ATLAS_DPIS} (sizes {tuple(font_size(d) for d in ATLAS_DPIS)} px): add it to ATLAS_DPIS and "
            f"regenerate with glyph_atlas.write_glyph_atlas() (needs PIL; {ROADMAP_ITEM})")
    with np.load(ATLAS_PATH) as z:
        return ShapedFont(z, font_size(dpi))


def _blend_black(page: np.ndarray, mask: np.ndarray, x: int, y: int) -> None:
    """`draw_bitmap(coord, mask, ink=black)` on a gray page (Paste.c
    `fill_mask_L`: BLEND(mask, out, 0) = DIV255(out * (255 - mask))),
    clipped to the page."""
    h, w = page.shape
    ys, xs = max(0, -y), max(0, -x)
    ye, xe = min(mask.shape[0], h - y), min(mask.shape[1], w - x)
    if ye <= ys or xe <= xs:
        return
    m = mask[ys:ye, xs:xe].astype(np.int64)
    reg = page[y + ys:y + ye, x + xs:x + xe]
    t = reg.astype(np.int64) * (255 - m) + 128
    reg[...] = (((t >> 8) + t) >> 8).astype(np.uint8)


def render_text_page(text: str, dpi: int) -> np.ndarray:
    """`_render_text_page(text, dpi)` -> its (H, W, 3) uint8 RGB pixels;
    `UnsupportedText` for what the atlas cannot draw."""
    font = load_font(dpi)
    w, h = int(8.5 * dpi), int(11 * dpi)
    page = np.full((h, w), 255, np.uint8)
    margin = dpi // 2
    max_chars = max(20, (w - 2 * margin) // max(6, dpi // 14))
    y = margin
    line_h = max(12, dpi // 6)
    for raw_line in (text or "(no extractable text)").split("\n"):
        line = raw_line
        while line and y < h - margin:
            mask, ox, oy = font.line_mask(line[:max_chars])
            if mask.size:
                _blend_black(page, mask, margin + ox, y + oy)
            line = line[max_chars:]
            y += line_h
        if y >= h - margin:
            break
        if not raw_line:
            y += line_h // 2
    return np.repeat(page[..., None], 3, axis=2)
