"""HarfBuzz 12's Khmer shaper (`hb-ot-shaper-khmer.cc`) over one run, after
normalization: the syllables of `hb-ot-shaper-khmer-machine.rl`, a dotted
circle in front of each broken cluster (when the font maps U+25CC), and the
reordering of `reorder_consonant_syllable`: Coeng Ro to the front of its
syllable, then each pre-base vowel (U+17C1-U+17C3) to the front.

The categories are HarfBuzz's Indic table for the characters a Khmer run
holds: the Khmer blocks, and the Common ones the table lists (digits, a
few dashes and signs, four Vedic signs as consonants (after a Coeng they
join its syllable) and one as a placeholder, the dotted
circle, the joiners). Each Common character's was checked against
HarfBuzz in a Khmer run: before a vowel sign, a Robatic, a Coeng, after
one. The nonspacing marks of the other scripts in that table take the
category the atlas holds for them, which `glyph_atlas._probe_categories`
finds by probing Pillow's HarfBuzz (a Devanagari virama is a Coeng to
the machine, a Myanmar vowel sign a Khmer one). Everything else is
"other" to the machine.

The split vowels U+17BE-U+17C0, U+17C4 and U+17C5 decompose into U+17C1 and
themselves (`decompose_khmer`) only where the font maps both; and nothing
composes onto a mark (`compose_khmer`). Khmer runs keep the marks'
advances (`HB_OT_SHAPE_ZERO_WIDTH_MARKS_NONE`) and leave `liga` off.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, TypeVar

from morphik_core_tpu_torch.parser.marks import merge_cluster_values
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
    (0x1CF2, 0x1CF3, C), (0x1CF5, 0x1CF6, C), (0x1CFA, 0x1CFA, PLACEHOLDER),
)
CATEGORY: Dict[int, int] = {cp: cat for a, b, cat in _RANGES for cp in range(a, b + 1)}
# `decompose_khmer`: the split vowels without a Unicode decomposition
SPLITS = {0x17BE: (0x17C1, 0x17BE), 0x17BF: (0x17C1, 0x17BF), 0x17C0: (0x17C1, 0x17C0),
          0x17C4: (0x17C1, 0x17C4), 0x17C5: (0x17C1, 0x17C5)}


def category(cp: int, others: Dict[int, int]) -> int:
    """A code point's category (`others`: the atlas's, for the marks of the
    other scripts)."""
    return others.get(cp, CATEGORY.get(cp, X))


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


def _reorder(items: List[T], cats: List[int], clusters: Optional[List[Optional[int]]], start: int, end: int
             ) -> None:
    """`reorder_consonant_syllable` over the syllable `start:end` of the
    run, in place; each move first merges the HarfBuzz clusters (where
    followed) of the span it moves through."""
    seqs = (items, cats) if clusters is None else (items, cats, clusters)
    coengs = 0
    i = start + 1
    while i < end:
        if cats[i] == H and coengs <= 2 and i + 1 < end:
            coengs += 1
            if cats[i + 1] == RA:   # Coeng Ro to the start
                if clusters is not None:
                    merge_cluster_values(clusters, start, i + 2)
                for seq in seqs:
                    seq[start:i + 2] = seq[i:i + 2] + seq[start:i]
                coengs = 2
        elif cats[i] == VPRE:   # the left matra piece to the start
            if clusters is not None:
                merge_cluster_values(clusters, start, i + 1)
            for seq in seqs:
                seq[start:i + 1] = seq[i:i + 1] + seq[start:i]
        i += 1


def shape(items: Sequence[T], cps: Sequence[int], others: Dict[int, int], dotted: Optional[T],
          clusters: Optional[Sequence[Optional[int]]]) -> Tuple[List[T], Optional[List[Optional[int]]]]:
    """A normalized Khmer run (`items`, their code points `cps`, their
    HarfBuzz clusters or None; `others`: the atlas's categories of the
    other scripts' marks) -> its items with the dotted circles (`dotted`,
    None where the font lacks U+25CC; each takes its syllable's cluster)
    and reordered, and their clusters (None without `clusters`)."""
    cats = [category(cp, others) for cp in cps]
    found = syllables(cats)
    circled = set(dotted_starts(found, BROKEN_CLUSTER)) if dotted is not None else set()
    out: List[T] = []
    out_cats: List[int] = []
    out_cl: Optional[List[Optional[int]]] = None if clusters is None else []
    spans = []
    for start, end, kind in found:
        if start in circled:
            out.append(dotted)
            out_cats.append(DOTTEDCIRCLE)
            if out_cl is not None:
                out_cl.append(clusters[start])
        out += items[start:end]
        out_cats += cats[start:end]
        if out_cl is not None:
            out_cl += clusters[start:end]
        if kind != NON_KHMER_CLUSTER:
            spans.append((len(out) - (end - start) - (start in circled), len(out)))
    for start, end in spans:
        _reorder(out, out_cats, out_cl, start, end)
    return out, out_cl
