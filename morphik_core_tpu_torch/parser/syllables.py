"""HarfBuzz's syllable machines (Ragel scanners, `hb-ot-shaper-*-machine.rl`)
in plain Python: the rules' patterns are built into one NFA (Thompson's
construction), run as a DFA whose states are made as a scan first meets
them (and kept), so a scanner takes the longest match of its rules at
each position (the earlier rule on a tie), as Ragel's `|* ... *|` does,
in one table lookup a category.

A pattern is a function that adds its states to an `_NFA` and returns
its (start, end) states; a pattern used twice adds them twice.
"""

from __future__ import annotations

from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple


class _NFA:
    """States, each with its epsilon moves and its category moves."""

    def __init__(self):
        self.eps: List[List[int]] = []
        self.moves: List[List[Tuple[FrozenSet[int], int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.moves.append([])
        return len(self.eps) - 1


Pattern = Callable[[_NFA], Tuple[int, int]]


def sym(*cats: int) -> Pattern:
    """One category of `cats`."""
    allowed: FrozenSet[int] = frozenset(cats)

    def build(n: _NFA):
        s, e = n.state(), n.state()
        n.moves[s].append((allowed, e))
        return s, e
    return build


def seq(*parts: Pattern) -> Pattern:
    def build(n: _NFA):
        s = e = n.state()
        for part in parts:
            ps, pe = part(n)
            n.eps[e].append(ps)
            e = pe
        return s, e
    return build


def alt(*parts: Pattern) -> Pattern:
    def build(n: _NFA):
        s, e = n.state(), n.state()
        for part in parts:
            ps, pe = part(n)
            n.eps[s].append(ps)
            n.eps[pe].append(e)
        return s, e
    return build


def opt(part: Pattern) -> Pattern:
    def build(n: _NFA):
        s, e = n.state(), n.state()
        ps, pe = part(n)
        n.eps[s] += [ps, e]
        n.eps[pe].append(e)
        return s, e
    return build


def star(part: Pattern) -> Pattern:
    def build(n: _NFA):
        s, e = n.state(), n.state()
        ps, pe = part(n)
        n.eps[s] += [ps, e]
        n.eps[pe] += [ps, e]
        return s, e
    return build


def plus(part: Pattern) -> Pattern:
    def build(n: _NFA):
        s, e = n.state(), n.state()
        ps, pe = part(n)
        n.eps[s].append(ps)
        n.eps[pe] += [ps, e]
        return s, e
    return build


class _Scanner:
    """The rules of one machine as a lazily made DFA: each state a set of
    NFA states, with the earliest rule it accepts."""

    def __init__(self, rules: Sequence[Tuple[int, Pattern]]):
        self.nfa = n = _NFA()
        self.kinds = [kind for kind, _ in rules]
        self.rule_of: Dict[int, int] = {}
        starts = []
        for k, (_, pattern) in enumerate(rules):
            s, e = pattern(n)
            starts.append(s)
            self.rule_of[e] = k
        self.start = self._closure(starts)
        self.next: Dict[Tuple[FrozenSet[int], int], FrozenSet[int]] = {}
        self.accepts: Dict[FrozenSet[int], Optional[int]] = {}

    def _closure(self, states) -> FrozenSet[int]:
        seen, todo = set(states), list(states)
        while todo:
            for t in self.nfa.eps[todo.pop()]:
                if t not in seen:
                    seen.add(t)
                    todo.append(t)
        return frozenset(seen)

    def step(self, d: FrozenSet[int], cat: int) -> FrozenSet[int]:
        key = (d, cat)
        out = self.next.get(key)
        if out is None:
            out = self.next[key] = self._closure([t for s in d for cats, t in self.nfa.moves[s] if cat in cats])
        return out

    def accept(self, d: FrozenSet[int]) -> Optional[int]:
        if d not in self.accepts:
            self.accepts[d] = min((self.rule_of[s] for s in d if s in self.rule_of), default=None)
        return self.accepts[d]


_SCANNERS: Dict[int, Tuple[Sequence, _Scanner]] = {}


def scan(cats: Sequence[int], rules: Sequence[Tuple[int, Pattern]]) -> List[Tuple[int, int, int]]:
    """The scanner over `cats` -> (start, end, syllable type) of each
    syllable. The last rule must match any one category."""
    held = _SCANNERS.get(id(rules))
    if held is None or held[0] is not rules:
        held = _SCANNERS[id(rules)] = (rules, _Scanner(rules))
    sc = held[1]
    out, p = [], 0
    while p < len(cats):
        d, best, i = sc.start, None, p
        while i < len(cats):
            d = sc.step(d, cats[i])
            if not d:
                break
            i += 1
            rule = sc.accept(d)
            if rule is not None:
                best = (i, rule)
        out.append((p, best[0], sc.kinds[best[1]]))
        p = best[0]
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
