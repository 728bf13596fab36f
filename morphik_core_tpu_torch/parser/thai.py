"""HarfBuzz 12's Thai shaper (`hb-ot-shaper-thai.cc`), which shapes Thai and
Lao: its `preprocess_text`. SARA AM (U+0E33, Lao U+0EB3) splits into
NIKHAHIT and SARA AA (U+0E4D U+0E32, U+0ECD U+0EB2), and the NIKHAHIT moves
back over the above-base marks before it (the tone marks), so "ก่ำ" is
shaped as U+0E01 U+0E4D U+0E48 U+0E32. This happens whatever the font holds.

The rest of the shaper (positioning by PUA glyphs) runs only for Thai in a
font without a `thai` GSUB script, which the atlas generator asserts
DejaVu Sans has. Marks are then zeroed by GDEF after GPOS, as the default
shaper does.
"""

from __future__ import annotations

from typing import List, Sequence


def _is_sara_am(cp: int) -> bool:
    return cp & ~0x80 == 0x0E33


def _is_above_base_mark(cp: int) -> bool:
    """`IS_ABOVE_BASE_MARK`: Thai U+0E31, U+0E34-U+0E37, U+0E3B,
    U+0E47-U+0E4E, and the Lao characters 0x80 above them."""
    x = cp & ~0x80
    return 0x0E34 <= x <= 0x0E37 or 0x0E47 <= x <= 0x0E4E or x in (0x0E31, 0x0E3B)


def preprocess(cps: Sequence[int]) -> List[int]:
    """`preprocess_text_thai` over one run's code points."""
    out: List[int] = []
    for cp in cps:
        if not _is_sara_am(cp):
            out.append(cp)
            continue
        start = len(out)
        while start > 0 and _is_above_base_mark(out[start - 1]):
            start -= 1
        out.insert(start, cp - 0x0E33 + 0x0E4D)   # NIKHAHIT
        out.append(cp - 1)   # SARA AA
    return out
