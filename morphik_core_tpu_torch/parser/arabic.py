"""What HarfBuzz 12's Arabic shaper does with the glyph atlas's font
(DejaVuSans): the joining state machine, then the font's form features and
its Arabic ligatures, on glyph ids.

- Joining (`hb-ot-shaper-arabic.cc::arabic_joining`): each character's
  joining type (the atlas's, C counted as D); transparent ones (T: marks,
  format characters) are skipped; the state machine gives each letter an
  action (isolated, final, medial, initial). The characters around the run
  in the line (up to five each side, HarfBuzz's buffer context, which raqm
  fills from the whole line) count: a letter joins across a bidi run
  boundary. ZWJ and tatweel are join-causing (D), ZWNJ non-joining (U).
- Forms: each action's feature (`fina`, `medi`, `init`; the font has no
  `isol`) substitutes the glyph where the font's single substitution
  covers it. HarfBuzz applies them as separate stages, one per feature;
  as each glyph takes at most one, their order does not matter.
- Ligatures: then the `rlig` stage (lam-alef), then the default `liga`
  (lam with the hamza and madda alefs), each a lookup over the whole run,
  matched on glyph ids, so presentation forms typed as such ligate too. A
  ligature matches across the default-ignorables that do not block it
  (the atlas's `lig_blockers`, and ZWJ for `rlig`, which HarfBuzz's
  Arabic shaper enables with F_MANUAL_ZWJ); the skipped ones follow it.

The font's other Arabic lookups (`ccmp`, the mark ligatures of `rlig` and
`liga`) take marks, which the atlas refuses before shaping.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

U, L, R, D, T = range(5)   # joining types, in the atlas's numbering (C is D)
NONE, ISOL, FINA, MEDI, INIT = range(5)   # actions
FEATURES = {"isol": ISOL, "fina": FINA, "medi": MEDI, "init": INIT}
CONTEXT = 5   # HB_BUFFER_CONTEXT_LENGTH

# HarfBuzz's arabic_state_table, columns U, L, R, D (the Syriac groups are
# refused): (action of the previous letter, action of this one, next state)
_STATES = (
    ((NONE, NONE, 0), (NONE, ISOL, 2), (NONE, ISOL, 1), (NONE, ISOL, 2)),   # prev U: not willing to join
    ((NONE, NONE, 0), (NONE, ISOL, 2), (NONE, ISOL, 1), (NONE, ISOL, 2)),   # prev R or isolated: not willing
    ((NONE, NONE, 0), (NONE, ISOL, 2), (INIT, FINA, 1), (INIT, FINA, 3)),   # prev D / L isolated: willing
    ((NONE, NONE, 0), (NONE, ISOL, 2), (MEDI, FINA, 1), (MEDI, FINA, 3)),   # prev D final: willing
)


def joining_actions(types: Sequence[int], before: Sequence[int], after: Sequence[int]) -> List[int]:
    """`arabic_joining`: the action of each item from the joining `types`
    of the run (in shaping order) and of its context (`before`: nearest
    first; `after`: nearest first)."""
    state, prev = 0, -1
    for t in before:
        if t != T:
            state = _STATES[state][t][2]
            break
    actions = [NONE] * len(types)
    for i, t in enumerate(types):
        if t == T:
            continue
        prev_action, actions[i], next_state = _STATES[state][t]
        if prev_action != NONE and prev >= 0:
            actions[prev] = prev_action
        prev, state = i, next_state
    for t in after:
        if t != T:
            prev_action = _STATES[state][t][0]
            if prev_action != NONE and prev >= 0:
                actions[prev] = prev_action
            break
    return actions


def ligate(glyphs: List[int], skippable: Sequence[bool], table: Dict[int, List[Tuple[Tuple[int, ...], int]]]
           ) -> Tuple[List[int], List[int]]:
    """One ligature lookup over a run: at each glyph, the first ligature
    (font order) whose components follow, across the `skippable` items
    -> (glyphs, each output's index in the input: the ligature's first
    component, or the item itself; skipped items follow their ligature)."""
    out, source = [], []
    i = 0
    while i < len(glyphs):
        for rest, lig in table.get(glyphs[i], ()):
            j, skipped = i + 1, []
            for g in rest:
                while j < len(glyphs) and glyphs[j] != g and skippable[j]:
                    skipped.append(j)
                    j += 1
                if j >= len(glyphs) or glyphs[j] != g:
                    break
                j += 1
            else:
                out.append(lig)
                source.append(i)
                out += [glyphs[k] for k in skipped]
                source += skipped
                i = j
                break
        else:
            out.append(glyphs[i])
            source.append(i)
            i += 1
    return out, source
