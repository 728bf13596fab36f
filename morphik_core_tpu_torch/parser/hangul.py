"""HarfBuzz 12's Hangul shaper (`hb-ot-shaper-hangul.cc`): its
`preprocess_text` over one run's code points.

- A conjoining L V (T) jamo sequence composes into its syllable, and an
  LV syllable followed by a T into the LVT syllable, only where the font
  maps the result; a syllable the font lacks decomposes into jamo only
  where it maps them all. DejaVu Sans maps neither syllables nor jamo, so
  nothing composes or decomposes there: the rule is kept, not the outcome.
- A tone mark (U+302E, U+302F) after a valid syllable (a jamo sequence,
  or a syllable the font maps) moves in front of it unless its glyph has
  no advance; any other tone mark is followed by a dotted circle (preceded
  by one where it has no advance) where the font maps U+25CC. A tone mark
  that starts the line also has HarfBuzz's dotted circle in front, so it
  draws circle, mark, circle. The circle the shaper adds takes the tone
  mark's Unicode properties (`replace_glyphs`): to normalization it is a
  mark of combining class 224, sorted among the marks after it.

The Hangul shaper neither recomposes nor fully decomposes a cluster in
normalization and keeps the marks' advances.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

L_BASE, V_BASE, T_BASE, S_BASE = 0x1100, 0x1161, 0x11A7, 0xAC00
L_COUNT, V_COUNT, T_COUNT = 19, 21, 28
N_COUNT = V_COUNT * T_COUNT
S_COUNT = L_COUNT * N_COUNT
DOTTED_CIRCLE = 0x25CC


def _is_l(u: int) -> bool:
    return 0x1100 <= u <= 0x115F or 0xA960 <= u <= 0xA97C


def _is_v(u: int) -> bool:
    return 0x1160 <= u <= 0x11A7 or 0xD7B0 <= u <= 0xD7C6


def _is_t(u: int) -> bool:
    return 0x11A8 <= u <= 0x11FF or 0xD7CB <= u <= 0xD7FB


def is_tone(u: int) -> bool:
    return 0x302E <= u <= 0x302F


def _combining_l(u: int) -> bool:
    return L_BASE <= u < L_BASE + L_COUNT


def _combining_v(u: int) -> bool:
    return V_BASE <= u < V_BASE + V_COUNT


def _combining_t(u: int) -> bool:
    return T_BASE < u < T_BASE + T_COUNT


def _combined_s(u: int) -> bool:
    return S_BASE <= u < S_BASE + S_COUNT


def preprocess(cps: Sequence[int], has_glyph: Callable[[int], bool], zero_width: Callable[[int], bool]
               ) -> Tuple[List[int], List[int]]:
    """`preprocess_text_hangul`: `has_glyph(cp)` whether the font maps a
    code point, `zero_width(cp)` whether its glyph has no advance -> (the
    code points, the code point whose Unicode properties each has)."""
    out: List[int] = []
    props: Dict[int, int] = {}   # output index -> the code point whose properties it has
    start = end = 0   # the last valid syllable, out[start:end]
    i, n = 0, len(cps)
    while i < n:
        u = cps[i]
        if is_tone(u):
            if start < end and end == len(out):
                out.append(u)
                if not zero_width(u):
                    out[start:end + 1] = [u] + out[start:end]
            elif has_glyph(DOTTED_CIRCLE):
                props[len(out) + (0 if zero_width(u) else 1)] = u
                out += [DOTTED_CIRCLE, u] if zero_width(u) else [u, DOTTED_CIRCLE]
            else:
                out.append(u)
            i += 1
            start = end = len(out)
            continue
        start = len(out)
        if _is_l(u) and i + 1 < n:
            v = cps[i + 1]
            if _is_v(v):
                t = cps[i + 2] if i + 2 < n and _is_t(cps[i + 2]) else 0
                size = 3 if t else 2
                if _combining_l(u) and _combining_v(v) and (not t or _combining_t(t)):
                    s = S_BASE + (u - L_BASE) * N_COUNT + (v - V_BASE) * T_COUNT + (t - T_BASE if t else 0)
                    if has_glyph(s):
                        out.append(s)
                        i += size
                        end = start + 1
                        continue
                out += cps[i:i + size]
                i += size
                end = start + size
                continue
        elif _combined_s(u):
            glyph = has_glyph(u)
            l_index, n_index = divmod(u - S_BASE, N_COUNT)
            v_index, t_index = divmod(n_index, T_COUNT)
            nxt = cps[i + 1] if i + 1 < n else None
            if not t_index and nxt is not None and _combining_t(nxt) and has_glyph(u + nxt - T_BASE):
                out.append(u + nxt - T_BASE)
                i += 2
                end = start + 1
                continue
            if not glyph or (not t_index and nxt is not None and _is_t(nxt)):
                parts = [L_BASE + l_index, V_BASE + v_index] + ([T_BASE + t_index] if t_index else [])
                if all(map(has_glyph, parts)):
                    out += parts
                    i += 1
                    if glyph and not t_index:   # the non-combining T joins the syllable
                        out.append(cps[i])
                        i += 1
                    end = len(out)
                    continue
            if glyph:
                end = start + 1
        out.append(u)
        i += 1
    return out, [props.get(k, cp) for k, cp in enumerate(out)]
