"""HarfBuzz's syllable machines (Ragel scanners, `hb-ot-shaper-*-machine.rl`)
in plain Python: a pattern is matched over a run's categories as the set
of positions it can end at, so a scanner takes the longest match of its
rules at each position (the earlier rule on a tie), as Ragel's `|* ... *|`
does.

A pattern is a function (categories, start positions) -> end positions.
"""

from __future__ import annotations

from typing import Callable, FrozenSet, List, Sequence, Set, Tuple

Pattern = Callable[[Sequence[int], Set[int]], Set[int]]


def sym(*cats: int) -> Pattern:
    """One category of `cats`."""
    allowed: FrozenSet[int] = frozenset(cats)
    return lambda c, s: {p + 1 for p in s if p < len(c) and c[p] in allowed}


def seq(*parts: Pattern) -> Pattern:
    def match(c, s):
        for part in parts:
            s = part(c, s)
            if not s:
                break
        return s
    return match


def alt(*parts: Pattern) -> Pattern:
    return lambda c, s: set().union(*(part(c, s) for part in parts))


def opt(part: Pattern) -> Pattern:
    return lambda c, s: s | part(c, s)


def star(part: Pattern) -> Pattern:
    def match(c, s):
        out, frontier = set(s), set(s)
        while frontier:
            frontier = part(c, frontier) - out
            out |= frontier
        return out
    return match


def plus(part: Pattern) -> Pattern:
    return seq(part, star(part))


def scan(cats: Sequence[int], rules: Sequence[Tuple[int, Pattern]]) -> List[Tuple[int, int, int]]:
    """The scanner over `cats` -> (start, end, syllable type) of each
    syllable. The last rule must match any one category."""
    out, p = [], 0
    while p < len(cats):
        best = None
        for kind, pattern in rules:
            end = max(pattern(cats, {p}), default=p)
            if end > p and (best is None or end > best[1]):
                best = (kind, end)
        out.append((p, best[1], best[0]))
        p = best[1]
    return out


def dotted_starts(syllables: Sequence[Tuple[int, int, int]], broken: int) -> List[int]:
    """`hb_syllabic_insert_dotted_circles`: the starts of the broken
    syllables that get a dotted circle. A syllable's serial number runs
    1..15 and wraps (`found_syllable`), and a broken syllable whose serial
    equals the last broken one's (15 syllables on) gets none."""
    out, last = [], 0
    for k, (start, _, kind) in enumerate(syllables):
        value = (k % 15 + 1) << 4 | kind
        if kind == broken and value != last:
            last = value
            out.append(start)
    return out
