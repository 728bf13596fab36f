"""HarfBuzz 12's Khmer shaper (`hb-ot-shaper-khmer.cc`) over one run, after
normalization: the syllables of `hb-ot-shaper-khmer-machine.rl`, a dotted
circle in front of each broken cluster (when the font maps U+25CC), and the
reordering of `reorder_consonant_syllable`: Coeng Ro to the front of its
syllable, then each pre-base vowel (U+17C1-U+17C3) to the front.

The categories are HarfBuzz's Indic table for the characters a Khmer run
holds: the Khmer blocks, and the Common ones the table lists (digits, a
few dashes and signs, and five Vedic signs as placeholders, the dotted
circle, the joiners). Each Common character's was checked against
HarfBuzz in a Khmer run: before a vowel sign, a Robatic, a Coeng, after
one.
Everything else is "other" to the machine. The nonspacing marks of the
other scripts in that table (a Devanagari virama is a Coeng to the
machine, a Myanmar vowel sign a Khmer one) are refused by the caller
(`FOREIGN`).

The split vowels U+17BE-U+17C0, U+17C4 and U+17C5 decompose into U+17C1 and
themselves (`decompose_khmer`) only where the font maps both; and nothing
composes onto a mark (`compose_khmer`). Khmer runs keep the marks'
advances (`HB_OT_SHAPE_ZERO_WIDTH_MARKS_NONE`) and leave `liga` off.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, TypeVar

from morphik_core_tpu_torch.parser.syllables import alt, dotted_starts, opt, scan, seq, star, sym

T = TypeVar("T")

# the machine's categories (`khmer_category_t`); X is any other
X, C, V, H, ZWNJ, ZWJ, PLACEHOLDER, DOTTEDCIRCLE, RA, VABV, VBLW, VPRE, VPST, ROBATIC, XGROUP, YGROUP = range(16)
CONSONANT_SYLLABLE, BROKEN_CLUSTER, NON_KHMER_CLUSTER = range(3)
DOTTED_CIRCLE = 0x25CC

_RANGES = (   # (first, last, category)
    (0x1780, 0x17A2, C), (0x179A, 0x179A, RA), (0x17A3, 0x17B3, V),
    (0x17B6, 0x17B6, VPST), (0x17B7, 0x17BA, VABV), (0x17BB, 0x17BD, VBLW), (0x17BE, 0x17BE, VABV),
    (0x17BF, 0x17C0, VPST), (0x17C1, 0x17C3, VPRE), (0x17C4, 0x17C5, VPST),
    (0x17C6, 0x17C6, XGROUP), (0x17C7, 0x17C8, YGROUP), (0x17C9, 0x17CA, ROBATIC), (0x17CB, 0x17CB, XGROUP),
    (0x17CC, 0x17CC, ROBATIC), (0x17CD, 0x17D1, XGROUP), (0x17D2, 0x17D2, H), (0x17D3, 0x17D3, YGROUP),
    (0x17D9, 0x17D9, PLACEHOLDER), (0x17DD, 0x17DD, YGROUP), (0x17E0, 0x17E9, PLACEHOLDER),
    (0x002D, 0x002D, PLACEHOLDER), (0x0030, 0x0039, PLACEHOLDER), (0x00A0, 0x00A0, PLACEHOLDER),
    (0x00D7, 0x00D7, PLACEHOLDER), (0x2010, 0x2015, PLACEHOLDER), (0x2022, 0x2022, PLACEHOLDER),
    (0x25FB, 0x25FE, PLACEHOLDER), (0x25CC, 0x25CC, DOTTEDCIRCLE), (0x200C, 0x200C, ZWNJ), (0x200D, 0x200D, ZWJ),
    (0x1CF2, 0x1CF3, PLACEHOLDER), (0x1CF5, 0x1CF6, PLACEHOLDER), (0x1CFA, 0x1CFA, PLACEHOLDER),
)
CATEGORY: Dict[int, int] = {cp: cat for a, b, cat in _RANGES for cp in range(a, b + 1)}
# the other blocks of HarfBuzz's Indic table, whose marks the port does not categorize
FOREIGN = ((0x0900, 0x0DFF), (0x1000, 0x109F), (0x1CD0, 0x1CFF), (0xA8E0, 0xA8FF), (0xA9E0, 0xA9FF),
           (0xAA60, 0xAA7F), (0x116D0, 0x116FF))
# `decompose_khmer`: the split vowels without a Unicode decomposition
SPLITS = {0x17BE: (0x17C1, 0x17BE), 0x17BF: (0x17C1, 0x17BF), 0x17C0: (0x17C1, 0x17C0),
          0x17C4: (0x17C1, 0x17C4), 0x17C5: (0x17C1, 0x17C5)}


def category(cp: int) -> int:
    return CATEGORY.get(cp, X)


def foreign(cp: int) -> bool:
    """Whether a nonspacing mark in a Khmer run has a category of another
    script's (the Indic table's other blocks)."""
    return any(a <= cp <= b for a, b in FOREIGN)


# hb-ot-shaper-khmer-machine.rl
_c = sym(C, RA, V)
_cn = seq(_c, opt(seq(opt(sym(ZWJ, ZWNJ)), sym(ROBATIC))))
_joiner = sym(ZWJ, ZWNJ)
_xgroup = star(seq(star(_joiner), sym(XGROUP)))
_ygroup = star(sym(YGROUP))
_matra_group = seq(opt(sym(VPRE)), _xgroup, opt(sym(VBLW)), _xgroup, opt(seq(opt(_joiner), sym(VABV))), _xgroup,
                   opt(sym(VPST)))
_syllable_tail = seq(_xgroup, _matra_group, _xgroup, opt(seq(sym(H), _c)), _ygroup)
_broken_cluster = seq(opt(sym(ROBATIC)), star(seq(sym(H), _cn)), alt(sym(H), _syllable_tail))
_consonant_syllable = seq(alt(_cn, sym(PLACEHOLDER, DOTTEDCIRCLE)), _broken_cluster)
_other = sym(*range(16))
RULES = ((CONSONANT_SYLLABLE, _consonant_syllable), (BROKEN_CLUSTER, _broken_cluster), (NON_KHMER_CLUSTER, _other))


def syllables(cats: Sequence[int]) -> List[Tuple[int, int, int]]:
    return scan(cats, RULES)


def _reorder(items: List[T], cats: List[int]) -> None:
    """`reorder_consonant_syllable` over one syllable, in place."""
    coengs = 0
    i = 1
    while i < len(items):
        if cats[i] == H and coengs <= 2 and i + 1 < len(items):
            coengs += 1
            if cats[i + 1] == RA:   # Coeng Ro to the start
                items[:i + 2] = items[i:i + 2] + items[:i]
                cats[:i + 2] = cats[i:i + 2] + cats[:i]
                coengs = 2
        elif cats[i] == VPRE:   # the left matra piece to the start
            items[:i + 1] = items[i:i + 1] + items[:i]
            cats[:i + 1] = cats[i:i + 1] + cats[:i]
        i += 1


def shape(items: Sequence[T], cps: Sequence[int], dotted: Optional[T]) -> List[T]:
    """A normalized Khmer run (`items`, their code points `cps`) -> its
    items with the dotted circles (`dotted`, None where the font lacks
    U+25CC) and reordered."""
    cats = [category(cp) for cp in cps]
    found = syllables(cats)
    circled = set(dotted_starts(found, BROKEN_CLUSTER)) if dotted is not None else set()
    out: List[T] = []
    for start, end, kind in found:
        syl, syl_cats = list(items[start:end]), cats[start:end]
        if start in circled:
            syl, syl_cats = [dotted] + syl, [DOTTEDCIRCLE] + syl_cats
        if kind != NON_KHMER_CLUSTER:
            _reorder(syl, syl_cats)
        out += syl
    return out
