"""What HarfBuzz 12's Arabic shaper does with the glyph atlas's font
(DejaVuSans): the joining state machine, then the font's form features and
its Arabic ligatures, on glyph ids; and the joining the USE shaper gives
N'Ko (`use_joining_actions`).

- Joining (`hb-ot-shaper-arabic.cc::arabic_joining`): each character's
  joining type (the atlas's, C counted as D); transparent ones (T: marks,
  format characters) are skipped; the state machine gives each letter an
  action (isolated, final, medial, initial). The characters around the run
  in the line (up to five each side, HarfBuzz's buffer context, which raqm
  fills from the whole line) count: a letter joins across a bidi run
  boundary. ZWJ and tatweel are join-causing (D), ZWNJ non-joining (U).
- Forms: each action's feature (`fina`, `medi`, `init`; the font has no
  `isol` under `arab` or `nko `) substitutes the glyph where the tag's
  single substitution covers it. HarfBuzz applies them as separate
  stages, one per feature (USE: in one stage); as each glyph takes at most
  one, their order does not matter.
- N'Ko (USE with joining): two joinings decide, as probing Pillow's
  HarfBuzz shows (the atlas generator, `glyph_atlas._probe_use_joining`,
  and 8,000 seeded runs): the state machine over the run alone, without
  its context, on the types the atlas holds for a USE run (its N'Ko
  letters, lajanyalan and ZWJ joining; ZWNJ, the other default-ignorables
  and the marks the font draws transparent; tatweel, the letters of other
  scripts, the marks without a glyph and a CGJ that normalization left
  visible to GSUB non-joining), and where that
  leaves a letter isolated, the ordinary joining with the line around the
  run as context. So "ߞ‌ߞ" joins where a ZWNJ ends the run, and
  where two letters join inside the run, neither joins across its ends.
- Ligatures: then the `rlig` stage (the font's mark-pair ligatures, shadda
  with a haraka, then lam-alef), then the default `liga` (lam with the
  hamza and madda alefs, then a space, tatweel or letter with a haraka),
  each lookup over the whole run, matched on glyph ids, so presentation
  forms typed as such ligate too. A ligature matches across the
  default-ignorables that do not block it (the atlas's `lig_blockers`, and
  ZWJ for `rlig`, which HarfBuzz's Arabic shaper enables with
  F_MANUAL_ZWJ), and across marks where its lookup ignores them; the
  skipped glyphs follow it, a skipped mark carrying the ligature's id and
  the component it sat on (`ligate_input`), so that the mark lookups put a
  fatha inside "لَا" on the lam. `ligate` serves the other shapers' ligature
  lookups too.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

from morphik_core_tpu_torch.parser.marks import BASE, MARK, Item, merge_clusters

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


def use_joining_actions(types: Sequence[int], own: Sequence[int], before: Sequence[int], after: Sequence[int]
                        ) -> List[int]:
    """The action of each item of a USE run with joining: the run's own
    joining (`own` types, no context) where it joins a letter, else the
    ordinary one (`types` with the context `before` and `after`)."""
    inner = joining_actions(own, (), ())
    outer = joining_actions(types, before, after)
    return [a if a not in (NONE, ISOL) else b for a, b in zip(inner, outer)]


def ligate(run: List[Item], table: Dict[int, List[Tuple[Tuple[int, ...], int]]], classes: Sequence[int],
           ignore_marks: bool, blockers, lig_ids: Iterator[int]) -> List[Item]:
    """One ligature lookup over a run as HarfBuzz's `ligate_input` applies
    it: at each glyph the lookup does not skip, the first ligature (font
    order) whose components follow, across the default-ignorables not in
    `blockers` (and the marks, with `ignore_marks`) -> the new run; the
    skipped glyphs follow their ligature. A base with marks only, or marks
    only, ligate without a ligature id (`is_base_ligature`,
    `is_mark_ligature`); any other ligature takes a new id from `lig_ids`,
    and the marks it skipped take that id and their component. `classes`:
    each glyph's GDEF class."""

    def is_mark(glyph: int) -> bool:
        return classes[glyph] == MARK

    def skip(item: Item) -> bool:
        return (item.ignorable and not item.held and item.cp not in blockers) or (ignore_marks and is_mark(item.glyph))

    out: List[Item] = []
    i = 0
    while i < len(run):
        first = run[i]
        rules = () if first.ignorable or (ignore_marks and is_mark(first.glyph)) else table.get(first.glyph, ())
        for rest, lig in rules:
            pos, j = [i], i + 1
            for g in rest:
                while j < len(run) and skip(run[j]) and not (run[j].glyph == g and not run[j].ignorable):
                    j += 1
                if j >= len(run) or run[j].ignorable or run[j].glyph != g:
                    break
                pos.append(j)
                j += 1
            else:
                merge_clusters(run, i, j)
                comps = [run[k] for k in pos]
                base = classes[first.glyph] in (0, BASE) and all(is_mark(c.glyph) for c in comps[1:])
                mark = all(is_mark(c.glyph) for c in comps)
                lig_id = 0 if base or mark else next(lig_ids)
                skipped = []
                so_far = last = first.comps
                for k in range(1, len(pos)):
                    for m in range(pos[k - 1] + 1, pos[k]):
                        if lig_id:
                            run[m].lig_id = lig_id
                            run[m].lig_comp = so_far - last + min(run[m].lig_comp or last, last)
                        skipped.append(run[m])
                    last = comps[k].comps
                    so_far += last
                first.glyph = lig
                if lig_id:
                    first.lig_id, first.lig_comp, first.comps = lig_id, 0, so_far
                out.append(first)
                out += skipped
                i = j
                break
        else:
            out.append(first)
            i += 1
    return out
