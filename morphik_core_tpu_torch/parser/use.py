"""HarfBuzz 12's Universal Shaping Engine (`hb-ot-shaper-use.cc`) for the
scripts DejaVu Sans has a USE script tag for: Tifinagh (`tfng`) and N'Ko
(`nko `). What the shaper does to such a run is its syllables
(`hb-ot-shaper-use-machine.rl`) and a dotted circle in front of each
broken cluster, where the font maps U+25CC; N'Ko, a joining script, also
takes the Arabic joining (`arabic.use_joining_actions`), which the caller
applies. The font has no other USE feature under either tag, and no
character the atlas holds is a repha or a pre-base vowel, which USE
would reorder (the probe of the categories would find none fits one
drawn so).

The categories are those of HarfBuzz's USE table: `CATEGORY` holds what a
Tifinagh or an N'Ko run holds of its own script and the Common characters
the table lists; Tifinagh's letters (B) and consonant joiner U+2D7F (H);
N'Ko's letters and lajanyalan (B; its digits, apostrophes and
punctuation are O: a symbol mark may follow them) and its tone marks and
dantayalan (VMAbv: they stack in any number, a Devanagari stress sign
below (VMBlw) breaks them); digits (B), the dotted circle (B: a symbol
mark after it starts a broken cluster, after "-" it does not), other
placeholders (GB), the joiners and other default-ignorables (ZWNJ, CGJ,
WJ), the superscript digits (FMPst), the brackets of hieroglyph editing
(SB, SE: a consonant joiner after "]" starts a broken cluster, one after
")" does not) and four Vedic signs.
The nonspacing marks of every other script take the category the atlas
holds for them (`glyph_atlas._probe_categories` finds it by probing
Pillow's HarfBuzz). Everything else is O. Each category was checked
against HarfBuzz in a Tifinagh run, before and after U+2D7F. The machine
skips CGJ, and a ZWNJ before a mark; a run starting with U+2D7F also has
HarfBuzz's dotted circle in front, so it is no broken cluster.

USE decomposes every character (no short circuit), composes nothing onto
a mark, and zeroes the marks' advances by GDEF before GPOS, which equals
the default shaper's zeroing after it for a font whose kerning holds no
mark.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from morphik_core_tpu_torch.parser.syllables import alt, dotted_starts, opt, plus, scan, seq, star, sym

SCRIPTS = frozenset(("Tfng", "Nkoo"))
# the machine's categories (`use_category_t`)
(O, B, N, GB, CGJ, FM, SUB, H, HN, ZWNJ, WJ, R, CS, IS, SK, G, J, SB, SE, HVM, FABV, FBLW, FPST, MABV, MBLW, MPST,
 MPRE, CMABV, CMBLW, VABV, VBLW, VPST, VPRE, VMABV, VMBLW, VMPST, VMPRE, SMABV, SMBLW, FMABV, FMBLW, FMPST) = range(42)
(VIRAMA_TERMINATED, SAKOT_TERMINATED, STANDARD, NUMBER_JOINER_TERMINATED, NUMERAL, SYMBOL, HIEROGLYPH, BROKEN,
 NON_CLUSTER) = range(9)
DOTTED_CIRCLE = 0x25CC

_RANGES = (
    (0x2D30, 0x2D67, B), (0x2D6F, 0x2D6F, B), (0x2D7F, 0x2D7F, H),
    (0x0030, 0x0039, B), (0x002D, 0x002D, GB), (0x00A0, 0x00A0, GB), (0x00D7, 0x00D7, GB),
    (0x2010, 0x2014, GB), (0x2022, 0x2022, GB), (0x25CC, 0x25CC, B), (0x25FB, 0x25FE, GB),
    (0x00B2, 0x00B3, FMPST), (0x2074, 0x2074, FMPST), (0x2082, 0x2084, FMPST),
    (0x200C, 0x200C, ZWNJ), (0x200D, 0x200D, CGJ), (0x034F, 0x034F, CGJ),
    # the brackets of Egyptian hieroglyph editing: segment begin and end
    (0x005B, 0x005B, SB), (0x007B, 0x007B, SB), (0x27E6, 0x27E6, SB), (0x27E8, 0x27E8, SB), (0x2E22, 0x2E22, SB),
    (0x2E24, 0x2E24, SB), (0x005D, 0x005D, SE), (0x007D, 0x007D, SE), (0x27E7, 0x27E7, SE), (0x27E9, 0x27E9, SE),
    (0x2E23, 0x2E23, SE), (0x2E25, 0x2E25, SE),
    (0x1CE1, 0x1CE1, VMPST), (0x1CF5, 0x1CF6, CS), (0x1CF7, 0x1CF7, VMPST),
    # N'Ko
    (0x07CA, 0x07EA, B), (0x07EB, 0x07F3, VMABV), (0x07FA, 0x07FA, B), (0x07FD, 0x07FD, VMABV),
)
CATEGORY: Dict[int, int] = {cp: cat for a, b, cat in _RANGES for cp in range(a, b + 1)}


def category(cp: int, ignorable: bool, mark: bool, others: Dict[int, int]) -> int:
    """A code point's USE category (`others`: the atlas's, for the marks of
    the other scripts); `ignorable`: it is default-ignorable (a `mark`
    then is CGJ, anything else WJ)."""
    cat = others.get(cp, CATEGORY.get(cp))
    if cat is not None:
        return cat
    if ignorable:
        return CGJ if mark else WJ
    return O


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


def shape(cps: Sequence[int], ignorable: Sequence[bool], is_mark: Sequence[bool], others: Dict[int, int],
          dotted: bool) -> List[int]:
    """A normalized run (its code points, whether each is default-ignorable
    and a mark; `others`: the atlas's categories of the other scripts'
    marks) -> the order of its items (indices; a dotted circle in front of
    each broken cluster, where `dotted`: the font maps U+25CC, as -1 - the
    index of the item it was put before)."""
    cats = [category(cp, ig, m, others) for cp, ig, m in zip(cps, ignorable, is_mark)]
    seen = []   # the indices the machine reads: CGJ skipped, and a ZWNJ before a mark
    for i, cat in enumerate(cats):
        if cat == CGJ:
            continue
        if cat == ZWNJ:
            nxt = next((k for k in range(i + 1, len(cats)) if cats[k] != CGJ), None)
            if nxt is not None and is_mark[nxt]:
                continue
        seen.append(i)
    found = scan([cats[i] for i in seen], RULES)
    broken = {seen[start] for start in dotted_starts(found, BROKEN)} if dotted else set()
    out: List[int] = []
    for i in range(len(cps)):
        if i in broken:
            out.append(-1 - i)
        out.append(i)
    return out
