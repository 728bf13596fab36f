"""The Unicode Bidirectional Algorithm as the reference's text drawing runs
it: FriBiDi 1.0.8's `fribidi_get_par_embedding_levels_ex` (what Pillow's
raqm calls, the paragraph direction left to P2 / P3), then raqm's
reordering of the resolved levels into runs in visual order.

Plain Python over the glyph atlas's tables (FriBiDi's bidi types and
bracket ids, written by `glyph_atlas.write_glyph_atlas`); nothing here
loads FriBiDi. The character types are FriBiDi's (Unicode 10 data), never
Python's `unicodedata.bidirectional`.

FriBiDi does not compute UAX #9 literally, and the reference's pictures
follow FriBiDi, so this module follows its implementation: a list of runs
of one type (brackets and isolate controls one character each) that the
rules merge as they go, isolating run sequences found through links
between runs of one isolate depth, and each rule's view of a run's
neighbours. Where that differs from the letter of UAX #9:

- the explicit rules stop at the first paragraph separator (B): what
  follows keeps level 0 and isolate depth 0, and its embedding, override
  and isolate controls and BNs are not removed; they take part in the
  later rules with their own types (the B itself keeps the isolate depth
  open at it);
- past depth 125 (X2-X5a, X6a, X7) it keeps FriBiDi's counters: an
  embedding that cannot push, or any push after one, counts as
  `over_pushed` (a PDF takes one back, a PDI clears them); an isolate
  whose level would pass 125 counts as an overflow isolate (its PDI only
  takes one back); an isolate whose level is valid raises the level even
  where an earlier overflow keeps it off the stack; the isolate depth
  stops at 124;
- an FSI looks for its strong character past its own PDI (up to the end
  of the line, outside later isolates);
- the runs of one isolate depth are linked across isolates that close and
  reopen at that depth, so a rule can see the content of an earlier
  isolate as a neighbour;
- rule W1 merges an NSM into the run before it, and that run with the
  next one where both have one type; rule N0 pairs brackets before the
  neutrals merge, and that merge joins neighbouring neutral runs of one
  level whatever their isolate depths (a B left inside an open isolate
  takes the neutrals after it into that isolate's sequence); rules N1 /
  N2 then see each merged run's immediate neighbours;
- the removed characters (X9) take the level of the character before them
  (the paragraph level at the start); L1 then puts separators, and the
  whitespace, controls and BNs before them and at the end of the line, at
  the paragraph level.

Where libfribidi 1.0.8 itself crashes (some lines whose isolates
overflow depth 125 deep inside embeddings: it reads memory it never
wrote), the reference draws nothing; this module still gives levels.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

# FriBiDi's types, in the atlas's numbering
(L, R, AL, EN, ES, ET, AN, CS, NSM, BN, B, S, WS, ON, LRE, LRO, RLE, RLO, PDF, LRI, RLI, FSI, PDI) = range(23)
TYPE_NAMES = ("L", "R", "AL", "EN", "ES", "ET", "AN", "CS", "NSM", "BN", "B", "S", "WS", "ON", "LRE", "LRO", "RLE",
              "RLO", "PDF", "LRI", "RLI", "FSI", "PDI")
MAX_DEPTH = 125   # FRIBIDI_BIDI_MAX_EXPLICIT_LEVEL
MAX_BRACKET_PAIRS = 63   # FRIBIDI_BIDI_MAX_NESTED_BRACKET_PAIRS
_SENTINEL = -1

_STRONG = frozenset((L, R, AL, LRE, LRO, RLE, RLO))   # FRIBIDI_IS_STRONG
_NEUTRAL = frozenset((B, S, WS, ON, LRI, RLI, FSI, PDI))
_ISOLATE = frozenset((LRI, RLI, FSI, PDI))
_INITIATORS = frozenset((LRE, LRO, RLE, RLO, LRI, RLI, FSI))
_LETTER = frozenset((L, R, AL))
_RTL = frozenset((R, AL, RLE, RLO, RLI))   # the types whose FriBiDi mask has the RTL bit
_RTL_OR_EXPLICIT = frozenset((R, AL, AN, LRE, LRO, RLE, RLO, PDF, LRI, RLI, FSI, PDI))
_L1 = frozenset((WS, BN, LRE, LRO, RLE, RLO, PDF, LRI, RLI, FSI, PDI, B, S))


def needs_bidi(types: Sequence[int]) -> bool:
    """Whether the line can be anything but one run at level 0."""
    return not _RTL_OR_EXPLICIT.isdisjoint(types)


def _dir(level: int) -> int:
    return R if level & 1 else L


def _rtl(t: int) -> int:
    return 1 if t in _RTL else 0


def _as_r(t: int) -> int:
    return R if t in (EN, AN) else t


class _Run:
    __slots__ = ("pos", "len", "type", "level", "iso", "bracket", "prev", "next", "prev_iso", "next_iso")

    def __init__(self, t: int, pos: int, bracket: int = 0, level: int = 0):
        self.pos, self.len, self.type, self.level, self.iso, self.bracket = pos, 0, t, level, 0, bracket
        self.prev = self.next = self.prev_iso = self.next_iso = None


_END = _Run(_SENTINEL, -1, level=-1)   # what a run without an isolate link sees


def _runs(head: _Run):
    p = head.next
    while p is not head:
        yield p
        p = p.next


def _merge_with_prev(second: _Run) -> _Run:
    first = second.prev
    first.next = second.next
    first.next.prev = first
    first.len += second.len
    if second.next_iso is not None:
        second.next_iso.prev_iso = first
    first.next_iso = second.next_iso
    return first


def _adjacent(run: _Run, forward: bool) -> _Run:
    """`get_adjacent_run`: the run's neighbour through the isolate links;
    forward, past a PDI."""
    p = run.next_iso if forward else run.prev_iso
    while p is not None and (p.iso > run.iso or (forward and p.type == PDI)):
        p = p.next_iso if forward else p.prev_iso
    return _END if p is None else p


def _side(run: _Run, other: _Run) -> int:
    """The type a rule sees beside `run`: the neighbour's type in the same
    level, else sos / eos from the higher of the two levels."""
    return other.type if other.level == run.level else _dir(max(other.level, run.level))


def _compact(head: _Run, neutrals: bool) -> None:
    """`compact_list` (same type and isolate depth, no brackets) or
    `compact_neutrals` (also any two neutrals, brackets included, and of
    any isolate depths)."""
    p = head.next
    while p is not head:
        q = p.prev
        if q is not head and q.level == p.level and (neutrals or q.iso == p.iso) and (
                (neutrals and q.type in _NEUTRAL and p.type in _NEUTRAL)
                or (q.type == p.type and (neutrals or (not p.bracket and not q.bracket)))):
            p = _merge_with_prev(p)
        p = p.next


def _encode(types: Sequence[int], brackets: Sequence[int]) -> _Run:
    head = _Run(_SENTINEL, -1, level=-1)
    last = head
    for i, (t, b) in enumerate(zip(types, brackets)):
        if t != last.type or b or last.bracket or t in _ISOLATE:
            run = _Run(t, i, b)
            last.len = i - last.pos
            last.next, run.prev = run, last
            last = run
    last.len = len(types) - last.pos
    last.next, head.prev = head, last
    return head


def _explicit(head: _Run, base: int) -> None:
    """X1-X9 up to the first B: levels, overrides, isolate depths; the
    removed runs are unlinked."""
    level, override, iso_level = base, None, 0
    stack: List[tuple] = []   # (level, override, entered by an isolate, isolate depth) before each push
    over_pushed = first_interval = valid_isolates = isolate_overflow = 0

    def push(new: int, new_override, isolate: bool) -> None:
        nonlocal level, override, over_pushed, first_interval
        if not over_pushed and not isolate_overflow and new <= MAX_DEPTH:
            if level == MAX_DEPTH - 1:
                first_interval = over_pushed
            stack.append((level, override, isolate, iso_level))
            level, override = new, new_override
        elif not isolate_overflow:
            over_pushed += 1

    def pop() -> None:
        nonlocal level, override, over_pushed, first_interval, iso_level
        if stack:
            if over_pushed > first_interval:
                over_pushed -= 1
            else:
                if over_pushed == first_interval:
                    first_interval = 0
                level, override, _, iso_level = stack.pop()

    p = head.next
    while p is not head:
        t, nxt = p.type, p.next
        p.iso = iso_level
        if t in (LRE, LRO, RLE, RLO, PDF, BN):
            if t == PDF:
                for _ in range(p.len):
                    if stack and stack[-1][2]:
                        break
                    pop()
            elif t != BN:
                for _ in range(p.len):
                    push(((level + _rtl(t) + 2) & ~1) - _rtl(t), {LRO: L, RLO: R}.get(t), False)
            p.prev.next, p.next.prev = p.next, p.prev   # X9
        elif t == PDI:
            if isolate_overflow:
                isolate_overflow -= 1
            elif valid_isolates:
                while stack and not stack[-1][2]:
                    pop()
                over_pushed = 0
                pop()
                iso_level -= 1
                valid_isolates -= 1
                p.iso = iso_level
            else:
                p.type = ON
            p.level = level
        elif t in (LRI, RLI, FSI):
            rtl = t == RLI
            if t == FSI:   # the first strong character after it, past its PDI
                depth, q = 0, p.next
                while q is not head:
                    if q.type == PDI:
                        depth -= 1
                    elif q.type in _ISOLATE:
                        depth += 1
                    elif depth == 0 and q.type in _LETTER:
                        rtl = q.type != L
                        break
                    q = q.next
            new = level + 1 + level % 2 if rtl else level + 2 - level % 2
            p.level = level
            if iso_level < MAX_DEPTH - 1:
                iso_level += 1
            if override is not None:
                p.type = override
            if new <= MAX_DEPTH:
                valid_isolates += 1
                push(new, None, True)
                level = new
            else:
                isolate_overflow += 1
        elif t == B:
            return
        else:
            p.level = level
            if override is not None:
                p.type = override
        p = nxt


def _link_isolates(head: _Run) -> None:
    """Each run's previous and next run of the same isolate depth. Going
    down from depth d to c forgets the runs of depths c+1 .. d-1, not d."""
    last = {}
    prev_depth = 0
    for p in _runs(head):
        d = p.iso
        for k in range(d + 1, prev_depth):
            last.pop(k, None)
        prev_depth = d
        q = last.get(d)
        if q is not None:
            q.next_iso, p.prev_iso = p, q
        last[d] = p


def _weak(head: _Run, base: int) -> None:
    """W1-W7, in FriBiDi's two passes."""
    last_strong = {0: _dir(base)}
    p = head.next
    while p is not head:   # W1, W2
        before, after = _adjacent(p, False), _adjacent(p, True)
        prev_t, next_t = _side(p, before), _side(p, after)
        if prev_t in _STRONG:
            last_strong[p.iso] = prev_t
        if p.type == NSM:
            if p.prev.type in _ISOLATE:
                p.type = ON
            if before.level == p.level:
                if before is p.prev:
                    p = _merge_with_prev(p)
            else:
                p.type = prev_t
            if prev_t == next_t and p.level == p.next.level and after is p.next:
                p = _merge_with_prev(p.next)
        elif p.type == EN and last_strong.get(p.iso) == AL:
            p.type = AN
            if next_t == NSM:
                after.type = AN
        p = p.next
    last_strong = {0: _dir(base)}
    w4, prev_orig = True, ON
    for p in _runs(head):   # W3-W7
        t = p.type
        prev_t, next_t = _side(p, _adjacent(p, False)), _side(p, _adjacent(p, True))
        if prev_t in _STRONG:
            last_strong[p.iso] = prev_t
        if t == AL:
            p.type = R
            w4, prev_orig = True, ON
            continue
        if (w4 and p.len == 1 and t in (ES, CS) and prev_orig in (EN, AN) and prev_orig == next_t
                and (prev_orig == EN or t == CS)):
            p.type = t = prev_t
        w4 = True
        if t == ET and EN in (prev_orig, next_t):
            p.type = t = EN
            w4 = False
        if t in (ES, ET, CS):
            p.type = ON
        if t == EN and last_strong.get(p.iso) == L:
            p.type = L
            prev_orig = EN if p.level == p.next.level else ON
        else:
            prev_orig = _side(p.next, p)


def _brackets(head: _Run) -> None:
    """N0: bracket pairs found per isolate depth (the stack empties where
    the level changes within a depth), then each pair in the order of its
    opening bracket."""
    pairs, stacks = [], {}
    last_level, last_depth = head.next.level, 0
    for p in _runs(head):
        if p.level != last_level and last_depth == p.iso:
            stacks[last_depth] = []
        if p.bracket and p.type == ON:
            st = stacks.setdefault(p.iso, [])
            if p.bracket < 0:
                if len(st) == MAX_BRACKET_PAIRS:
                    break
                st.append(p)
            else:
                for k in range(len(st) - 1, -1, -1):
                    if -st[k].bracket == p.bracket:
                        pairs.append((st[k], p))
                        del st[k:]
                        break
        last_level, last_depth = p.level, p.iso
    pairs.sort(key=lambda pair: pair[0].pos)
    for o, c in pairs:
        emb = o.level
        direction = None
        q = o
        while q is not c:   # N0 b: a strong type of the embedding direction inside
            t = _as_r(q.type)
            if t in _STRONG and q.level + ((q.level & 1) ^ _rtl(t)) == emb:
                direction = _dir(emb)
                break
            q = q.next
        if direction is None:   # N0 c: the other direction inside, the context before decides
            context = emb
            q = o.prev
            while q.type != _SENTINEL:
                t = _as_r(q.type)
                if t in _STRONG and q.iso == o.iso:
                    context = q.level + ((q.level & 1) ^ _rtl(t))
                    break
                q = q.prev
            q = o
            while q is not c:
                if _as_r(q.type) in _STRONG and q.iso == o.iso:
                    direction = _dir(context)
                    break
                q = q.next
        if direction is not None:
            o.type = c.type = direction


def embedding_levels(types: Sequence[int], brackets: Sequence[int]) -> Tuple[List[int], int]:
    """`fribidi_get_par_embedding_levels_ex(types, brackets, FRIBIDI_PAR_ON)`
    -> (levels, the paragraph level). `brackets[i]` is FriBiDi's bracket
    type of an ON character: 0, a closing bracket's id, or minus an
    opening one's."""
    n = len(types)
    if not n:
        return [], 0
    head = _encode(types, brackets)
    base, depth = 0, 0
    for p in _runs(head):   # P2, P3 over the whole line
        if p.type == PDI:
            depth = max(0, depth - 1)
        elif p.type in _ISOLATE:
            depth += 1
        elif depth == 0 and p.type in _LETTER:
            base = _rtl(p.type)
            break
    _explicit(head, base)
    _link_isolates(head)
    _compact(head, False)
    _weak(head, base)
    _brackets(head)
    _compact(head, True)
    for p in _runs(head):   # N1, N2
        if p.type in _NEUTRAL:
            before = _adjacent(p, False)
            after = _adjacent(p, True)
            b = _as_r(before.type) if before.level == p.level else _dir(max(before.level, p.level))
            a = _as_r(after.type) if after.level == p.level else _dir(max(after.level, p.level))
            p.type = b if b == a else _dir(p.level)
    levels: List[Optional[int]] = [None] * n
    for p in _runs(head):   # I1, I2
        lv = (p.level + 2) & ~1 if p.type in (EN, AN) else p.level + ((p.level & 1) ^ _rtl(p.type))
        levels[p.pos:p.pos + p.len] = [lv] * p.len
    for i in range(n):   # the removed characters take the level before them
        if levels[i] is None:
            levels[i] = levels[i - 1] if i else base
    at_end = True
    for i in range(n - 1, -1, -1):   # L1
        if types[i] in (B, S):
            levels[i], at_end = base, True
        elif at_end and types[i] in _L1:
            levels[i] = base
        else:
            at_end = False
    return levels, base


def visual_runs(levels: Sequence[int]) -> List[Tuple[int, int, int]]:
    """raqm's `_raqm_reorder_runs` (L2): the runs of one level, (start,
    end, level), in visual order."""
    runs, start = [], 0
    for i in range(1, len(levels) + 1):
        if i == len(levels) or levels[i] != levels[start]:
            runs.append((start, i, levels[start]))
            start = i
    for level in range(max(levels, default=0), 0, -1):
        k = 0
        while k < len(runs):
            if runs[k][2] >= level:
                j = k
                while j < len(runs) and runs[j][2] >= level:
                    j += 1
                runs[k:j] = runs[k:j][::-1]
                k = j
            else:
                k += 1
    return runs
