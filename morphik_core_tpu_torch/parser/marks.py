"""GPOS mark attachment as HarfBuzz 12 applies it (`hb-ot-layout-gpos-table.hh`,
`hb-ot-shape.cc`), in plain Python over the glyph atlas's tables.

- The lookups of a run's OpenType script tag (its `mark` and `mkmk`
  features), in lookup-index order; within a lookup, each glyph the
  lookup's flag lets through tries the subtables whose mark coverage holds
  it, in order, until one attaches it. A subtable without an anchor for the
  found base and the mark's class passes the mark on to the next one.
- MarkBase and MarkLig find the base as the nearest earlier glyph that is
  not a GDEF mark (default-ignorables skipped, but ZWJ, which stops the
  search: the features are F_MANUAL_JOINERS); it must be in the
  subtable's base (ligature) coverage. MarkLig takes the component the
  mark belongs to when the mark carries the ligature's id (a mark a GSUB
  ligature skipped), else the last component.
- MarkMark takes the nearest earlier glyph (skipped alike),
  which must be a GDEF mark of the same base or ligature component.
- The offset is `roundf(base anchor - mark anchor)` in 26.6 units (HarfBuzz's
  own roundf, halves upwards), the anchors' coordinates at the font's
  scale (a format-2 anchor's too: under raqm's hb-ft font HarfBuzz does
  not read its contour point). GDEF marks then lose
  their advance (`BY_GDEF_LATE`: the default, Hebrew, Arabic and Thai
  shapers; USE's `BY_GDEF_EARLY` alike, no kern pair holding a mark; not
  the Hangul and Khmer shapers'),
  and `propagate_attachment_offsets` adds the base's offset and the
  advances between the two, subtracted in a left-to-right run, added in a
  right-to-left one.

The flags' mark-attachment type is honoured; the font has no mark
filtering sets (the atlas generator checks that).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

MARK_BASE, MARK_LIG, MARK_MARK = 4, 5, 6   # GPOS lookup types
IGNORE_BASE, IGNORE_LIGATURES, IGNORE_MARKS, IGNORE_FLAGS = 0x2, 0x4, 0x8, 0xE
BASE, LIGATURE, MARK = 1, 2, 3   # GDEF glyph classes (0, unclassified, is a base)
ZWJ = 0x200D


class Item:
    """One glyph of HarfBuzz's buffer while a run is shaped: the code point
    it came from, its atlas token and glyph, whether it is a
    default-ignorable (and, for a CGJ, whether normalization left it
    hidden from GSUB), its ligature properties (the id of the ligature
    it belongs to, its component there, and the components a ligature
    glyph stands for) and its HarfBuzz cluster."""

    __slots__ = ("cp", "tok", "glyph", "ignorable", "held", "lig_id", "lig_comp", "comps", "cluster")

    def __init__(self, cp: int, tok: int, glyph: int, ignorable: bool, held: bool = False):
        self.cp, self.tok, self.glyph, self.ignorable, self.held = cp, tok, glyph, ignorable, held
        self.lig_id = self.lig_comp = 0
        self.comps = 1
        self.cluster = None


def merge_cluster_values(cl: List[Optional[int]], start: int, end: int) -> None:
    """HarfBuzz's `merge_clusters` over `cl[start:end]` (clusters), in
    place: their least, spread to the neighbours that share a boundary
    one. None (a cluster not followed) leaves them as they are."""
    if end - start < 2 or None in cl[start:end]:
        return
    least = min(cl[start:end])
    while end < len(cl) and cl[end] == cl[end - 1]:
        end += 1
    while start and cl[start - 1] == cl[start]:
        start -= 1
    cl[start:end] = [least] * (end - start)


def merge_clusters(items: Sequence[Item], start: int, end: int) -> None:
    """`merge_cluster_values` over the clusters of `items` (none where
    they are not followed)."""
    if end - start < 2 or items[start].cluster is None:
        return
    cl = [it.cluster for it in items]
    merge_cluster_values(cl, start, end)
    for it, c in zip(items, cl):
        it.cluster = c


class MarkTables:
    """The atlas's GDEF classes and mark positioning lookups at one size."""

    def __init__(self, z, size: int):
        self.classes = z["glyph_classes"].tolist()
        self.attach_types = z["mark_attach"].tolist()
        self.lookups: Dict[int, List[int]] = {}
        for tag, lookup in z["mark_lookups"].tolist():
            self.lookups.setdefault(tag, []).append(lookup)
        # per lookup: its flag and subtables (type, marks, anchors)
        self.subtables: Dict[int, List[tuple]] = {}
        self.flags: Dict[int, int] = {}
        tables = []
        for lookup, kind, flag in z["mark_subtables"].tolist():
            t = (kind, {}, {}, {})   # marks {glyph: (class, x, y)}, anchors {glyph: {(component, class): (x, y)}},
            tables.append(t)         # ligature components {glyph: count}
            self.subtables.setdefault(lookup, []).append(t)
            self.flags[lookup] = flag
        for (sub, glyph, cls), (x, y) in zip(z["mark_marks"].tolist(), z[f"mark_marks_xy_{size}"].tolist()):
            tables[sub][1][glyph] = (cls, x, y)
        for (sub, glyph, cls, comp), (x, y) in zip(z["mark_bases"].tolist(), z[f"mark_bases_xy_{size}"].tolist()):
            tables[sub][2].setdefault(glyph, {})[(comp, cls)] = (x, y)
        for sub, glyph, count in z["mark_lig_counts"].tolist():
            tables[sub][3][glyph] = count
        # per lookup, every glyph one of its subtables can attach
        self.covered = {lookup: set().union(*(t[1] for t in subs)) for lookup, subs in self.subtables.items()}

    def is_mark(self, glyph: int) -> bool:
        return self.classes[glyph] == MARK

    def _skipped(self, item: Item, flag: int) -> bool:
        """HarfBuzz's `check_glyph_property` under a lookup flag."""
        cls = self.classes[item.glyph]
        if cls == MARK:
            if flag & IGNORE_MARKS:
                return True
            kind = flag >> 8
            return bool(kind) and self.attach_types[item.glyph] != kind
        return bool((cls == LIGATURE and flag & IGNORE_LIGATURES) or (cls != LIGATURE and flag & IGNORE_BASE))

    def _attach(self, items: Sequence[Item], i: int, kind: int, marks, anchors, counts, flag: int):
        """One subtable at glyph `i` -> (base index, x, y offset) or None."""
        mark = items[i]
        cls, mx, my = marks[mark.glyph]
        j = i - 1
        if kind == MARK_MARK:
            while j >= 0 and (_skippable(items[j]) or self._skipped(items[j], flag & ~IGNORE_FLAGS)):
                j -= 1
            if j < 0 or not self.is_mark(items[j].glyph):
                return None
            prev = items[j]
            if prev.lig_id == mark.lig_id:
                if prev.lig_id and prev.lig_comp != mark.lig_comp:
                    return None
            elif not ((mark.lig_id and not mark.lig_comp) or (prev.lig_id and not prev.lig_comp)):
                return None
            comp = -1
        else:
            while j >= 0 and (_skippable(items[j]) or self.is_mark(items[j].glyph)):
                j -= 1
            if j < 0:
                return None
            comp = -1
            if kind == MARK_LIG:
                count = counts.get(items[j].glyph)
                if count is None:
                    return None
                base = items[j]
                if base.lig_id and base.lig_id == mark.lig_id and mark.lig_comp > 0:
                    comp = min(count, mark.lig_comp) - 1
                else:
                    comp = count - 1
        anchor = anchors.get(items[j].glyph, {}).get((comp, cls))
        if anchor is None:
            return None
        return j, _roundf(anchor[0] - mx), _roundf(anchor[1] - my)

    def position(self, tag: int, items: Sequence[Item], advances: Sequence[int], rtl: bool, zero_marks: bool = True
                 ) -> Tuple[List[int], List[int], List[int]]:
        """A run's glyphs in shaping order and their advances (kerning
        applied) -> (advances, x offsets, y offsets) in 26.6 units. Without
        `zero_marks` (the Hangul and Khmer shapers' `ZERO_WIDTH_MARKS_NONE`)
        the marks keep their advances."""
        n = len(items)
        parent: List[int] = [-1] * n
        xo, yo = [0] * n, [0] * n
        for lookup in self.lookups.get(tag, ()):
            flag, covered = self.flags[lookup], self.covered[lookup]
            for i, item in enumerate(items):
                if item.glyph not in covered or item.ignorable or self._skipped(item, flag):
                    continue
                for kind, marks, anchors, counts in self.subtables[lookup]:
                    if item.glyph not in marks:
                        continue
                    hit = self._attach(items, i, kind, marks, anchors, counts, flag)
                    if hit is not None:
                        parent[i], xo[i], yo[i] = hit
                        break
        adv = [0 if zero_marks and self.is_mark(it.glyph) else a for it, a in zip(items, advances)]
        done = [p < 0 for p in parent]

        def settle(i: int) -> None:
            if done[i]:
                return
            done[i] = True
            j = parent[i]
            settle(j)
            xo[i] += xo[j]
            yo[i] += yo[j]
            between = sum(adv[j + 1:i + 1]) if rtl else -sum(adv[j:i])
            xo[i] += between

        for i in range(n):
            settle(i)
        return adv, xo, yo


def _skippable(item: Item) -> bool:
    """Whether the mark lookups pass over a glyph: a default-ignorable but
    ZWJ (`mark` and `mkmk` are F_MANUAL_JOINERS features; GPOS passes over
    ZWNJ and the hidden ones anyway)."""
    return item.ignorable and item.cp != ZWJ


def _roundf(v: int) -> int:
    """HarfBuzz's `roundf` (`_hb_roundf`: floor(x + 0.5), halves upwards) of
    an anchor difference held in 1/32 of a 26.6 unit."""
    return (v + 16) >> 5
