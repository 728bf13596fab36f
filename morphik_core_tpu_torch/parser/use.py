"""HarfBuzz 12's Universal Shaping Engine (`hb-ot-shaper-use.cc`) for the
scripts whose USE categories the port holds: Tifinagh, which HarfBuzz
shapes with USE under DejaVu Sans's `tfng` script. What the shaper does to
such a run is its syllables (`hb-ot-shaper-use-machine.rl`) and a dotted
circle in front of each broken cluster, where the font maps U+25CC:
Tifinagh has no repha and no pre-base glyphs to reorder, and the font no
USE features under `tfng`.

The categories are those of HarfBuzz's USE table for what a Tifinagh run
holds: its letters (B), the consonant joiner U+2D7F (H), and the Common
characters the table lists: digits (B), placeholders (GB), the joiners
and other default-ignorables (ZWNJ, CGJ, WJ), the superscript digits
(FMPst), the brackets of hieroglyph editing (SB, SE: a consonant
joiner after "]" starts a broken cluster, one after ")" does not) and
four Vedic signs. Everything else is O. Each Common character's was
checked against HarfBuzz in a Tifinagh run, before and after U+2D7F. The nonspacing marks of the other scripts
with USE categories (`FOREIGN`) are refused by the caller. The machine
skips CGJ, and a ZWNJ before a mark; a run starting with U+2D7F also
has HarfBuzz's dotted circle in front, so it is no broken cluster.

USE decomposes every character (no short circuit), composes nothing onto
a mark, and zeroes the marks' advances by GDEF before GPOS, which equals
the default shaper's zeroing after it for a font whose kerning holds no
mark.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional, Sequence, TypeVar

from morphik_core_tpu_torch.parser.syllables import alt, dotted_starts, opt, plus, scan, seq, star, sym

T = TypeVar("T")

SCRIPTS = frozenset(("Tfng",))
# the machine's categories (`use_category_t`)
(O, B, N, GB, CGJ, FM, SUB, H, HN, ZWNJ, WJ, R, CS, IS, SK, G, J, SB, SE, HVM, FABV, FBLW, FPST, MABV, MBLW, MPST,
 MPRE, CMABV, CMBLW, VABV, VBLW, VPST, VPRE, VMABV, VMBLW, VMPST, VMPRE, SMABV, SMBLW, FMABV, FMBLW, FMPST) = range(42)
(VIRAMA_TERMINATED, SAKOT_TERMINATED, STANDARD, NUMBER_JOINER_TERMINATED, NUMERAL, SYMBOL, HIEROGLYPH, BROKEN,
 NON_CLUSTER) = range(9)
DOTTED_CIRCLE = 0x25CC

_RANGES = (
    (0x2D30, 0x2D67, B), (0x2D6F, 0x2D6F, B), (0x2D7F, 0x2D7F, H),
    (0x0030, 0x0039, B), (0x002D, 0x002D, GB), (0x00A0, 0x00A0, GB), (0x00D7, 0x00D7, GB),
    (0x2010, 0x2014, GB), (0x2022, 0x2022, GB), (0x25CC, 0x25CC, GB), (0x25FB, 0x25FE, GB),
    (0x00B2, 0x00B3, FMPST), (0x2074, 0x2074, FMPST), (0x2082, 0x2084, FMPST),
    (0x200C, 0x200C, ZWNJ), (0x200D, 0x200D, CGJ), (0x034F, 0x034F, CGJ),
    # the brackets of Egyptian hieroglyph editing: segment begin and end
    (0x005B, 0x005B, SB), (0x007B, 0x007B, SB), (0x27E6, 0x27E6, SB), (0x27E8, 0x27E8, SB), (0x2E22, 0x2E22, SB),
    (0x2E24, 0x2E24, SB), (0x005D, 0x005D, SE), (0x007D, 0x007D, SE), (0x27E7, 0x27E7, SE), (0x27E9, 0x27E9, SE),
    (0x2E23, 0x2E23, SE), (0x2E25, 0x2E25, SE),
    (0x1CE1, 0x1CE1, VMPST), (0x1CF5, 0x1CF6, CS), (0x1CF7, 0x1CF7, VMPST),
)
CATEGORY: Dict[int, int] = {cp: cat for a, b, cat in _RANGES for cp in range(a, b + 1)}
# the blocks whose marks have USE categories of their own (Indic, South-East Asian and the like)
FOREIGN = ((0x0840, 0x085F), (0x0900, 0x0DFF), (0x0F00, 0x109F), (0x1700, 0x1CFF), (0x1DF8, 0x1DF8),
           (0x20F0, 0x20F0), (0xA800, 0xABFF), (0x10A00, 0x10A5F), (0x10AC0, 0x10AFF), (0x10D00, 0x10D3F),
           (0x10E80, 0x10EBF), (0x10F30, 0x10FFF), (0x11000, 0x11FFF), (0x13430, 0x1345F), (0x16B00, 0x16B8F),
           (0x16F00, 0x16F9F), (0x1BC00, 0x1BCAF), (0x1E100, 0x1E14F), (0x1E2C0, 0x1E2FF), (0x1E4D0, 0x1E4FF),
           (0x1E900, 0x1E95F))


def category(cp: int, ignorable: bool) -> int:
    """A code point's USE category; `ignorable`: it is default-ignorable
    (a mark then is CGJ, anything else WJ)."""
    cat = CATEGORY.get(cp)
    if cat is not None:
        return cat
    if ignorable:
        return CGJ if unicodedata.category(chr(cp))[0] == "M" else WJ
    return O


def foreign(cp: int) -> bool:
    return any(a <= cp <= b for a, b in FOREIGN)


# hb-ot-shaper-use-machine.rl
_h = sym(H, HVM, IS, SK)
_consonant_modifiers = seq(star(sym(CMABV)), star(sym(CMBLW)),
                           star(seq(alt(seq(_h, sym(B)), sym(SUB)), opt(sym(CMABV)), star(sym(CMBLW)))))
_medial_consonants = seq(opt(sym(MPRE)), opt(sym(MABV)), opt(sym(MBLW)), opt(sym(MPST)))
_dependent_vowels = alt(seq(star(sym(VPRE)), star(sym(VABV)), star(sym(VBLW)), star(sym(VPST))), sym(H))
_vowel_modifiers = seq(opt(sym(HVM)), star(sym(VMPRE)), star(sym(VMABV)), star(sym(VMBLW)), star(sym(VMPST)))
_final_consonants = seq(star(sym(FABV)), star(sym(FBLW)), star(sym(FPST)))
_final_modifiers = alt(seq(star(sym(FMABV)), star(sym(FMBLW))), opt(sym(FMPST)))
_complex_syllable_start = seq(opt(sym(R, CS)), sym(B, GB))
_complex_syllable_middle = seq(_consonant_modifiers, _medial_consonants, _dependent_vowels, _vowel_modifiers,
                               star(seq(sym(SK), sym(B))))
_complex_syllable_tail = seq(_complex_syllable_middle, _final_consonants, _final_modifiers)
_number_joiner_terminated_cluster_tail = seq(star(seq(sym(HN), sym(N))), sym(HN))
_numeral_cluster_tail = plus(seq(sym(HN), sym(N)))
_symbol_cluster_tail = alt(seq(plus(sym(SMABV)), star(sym(SMBLW))), plus(sym(SMBLW)))
_virama_terminated_cluster_tail = seq(_consonant_modifiers, sym(IS))
_sakot_terminated_cluster_tail = seq(_complex_syllable_middle, sym(SK))
_tail = alt(_complex_syllable_tail, _sakot_terminated_cluster_tail, _symbol_cluster_tail,
            _virama_terminated_cluster_tail)
_zwnj = opt(sym(ZWNJ))
RULES = (
    (VIRAMA_TERMINATED, seq(_complex_syllable_start, _virama_terminated_cluster_tail, _zwnj)),
    (SAKOT_TERMINATED, seq(_complex_syllable_start, _sakot_terminated_cluster_tail, _zwnj)),
    (STANDARD, seq(_complex_syllable_start, _complex_syllable_tail, _zwnj)),
    (NUMBER_JOINER_TERMINATED, seq(sym(N), _number_joiner_terminated_cluster_tail, _zwnj)),
    (NUMERAL, seq(sym(N), opt(_numeral_cluster_tail), _zwnj)),
    (SYMBOL, seq(sym(O, GB, SB), opt(_tail), _zwnj)),
    (HIEROGLYPH, seq(star(sym(SB)), sym(G), star(sym(SE)),
                     star(seq(sym(J), star(sym(SE)), opt(seq(sym(G), star(sym(SE)))))), _zwnj)),
    (NON_CLUSTER, sym(FMPST)),
    (BROKEN, seq(opt(sym(R)), alt(_tail, _number_joiner_terminated_cluster_tail, _numeral_cluster_tail), _zwnj)),
    (NON_CLUSTER, sym(*range(42))),
)


def shape(items: Sequence[T], cps: Sequence[int], ignorable: Sequence[bool], is_mark: Sequence[bool],
          dotted: Optional[T]) -> List[T]:
    """A normalized run (`items`, their code points, whether each is
    default-ignorable and a mark) -> its items with a dotted circle
    (`dotted`, None where the font lacks U+25CC) in front of each broken
    cluster."""
    cats = [category(cp, ig) for cp, ig in zip(cps, ignorable)]
    seen = []   # the indices the machine reads: CGJ skipped, and a ZWNJ before a mark
    for i, cat in enumerate(cats):
        if cat == CGJ:
            continue
        if cat == ZWNJ:
            nxt = next((k for k in range(i + 1, len(cats)) if cats[k] != CGJ), None)
            if nxt is not None and is_mark[nxt]:
                continue
        seen.append(i)
    broken = {seen[start] for start in dotted_starts(scan([cats[i] for i in seen], RULES), BROKEN)}
    out: List[T] = []
    for i, item in enumerate(items):
        if i in broken and dotted is not None:
            out.append(dotted)
        out.append(item)
    return out
