"""JPEG 2000 tier-2: a tile's geometry (resolutions, sub-bands,
precincts, code blocks) and its packets, as OpenJPEG 2.5.4's `tcd.c`,
`pi.c` and `t2.c` decode them at full resolution and all layers.

The packet iterator walks the progression of the tile's COD, or its POC
changes in order (each with layers from 0, OpenJPEG's `opj_pi_update_
decode_poc`), and decodes each (layer, resolution, component, precinct)
packet once. A packet header is read with OpenJPEG's bit reader (a byte
after 0xFF gives 7 bits; past the end it reads zeros) from the tile's
data, or from the PPT / PPM headers; SOP and EPH markers are skipped
where present. The tag trees, the code blocks' segments (TERMALL: one a
pass; BYPASS: 10, then 2 and 1 in turn; else one; HT: a pass to the
first segment, the cleanup, and the rest of a contribution to the one
after, both OpenJPEG's rule for later layers too) and their lengths
follow `opj_t2_read_packet_header` / `_data`. A code block whose data
run past the tile's is an error, as in OpenJPEG's strict mode.

`CodeBlock` is tier-1's input: its place in its tile-component's buffer
(the sub-bands side by side, as `opj_t1_clbl_decode_processor` writes
them), its segments and its number of bit planes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from morphik_core_tpu_torch.utils.jp2_codestream import HT, LAZY, TERMALL, Codestream, Tcp


def _ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def _ceildivpow2(a: int, b: int) -> int:
    return -(-a >> b)


@dataclass
class CodeBlock:
    x0: int
    y0: int
    x1: int
    y1: int
    numbps: int = 0
    numlenbits: int = 0
    segs: List[List[int]] = field(default_factory=list)   # [len, numpasses, maxpasses]
    chunks: List[bytes] = field(default_factory=list)
    included: bool = False


class TagTree:
    """`tgt.c`: leaves w x h, each level's parent at (x // 2, y // 2)."""

    def __init__(self, w: int, h: int):
        self.parent: List[int] = []
        sizes = [(w, h)]
        while sizes[-1][0] * sizes[-1][1] > 1:
            sw, sh = sizes[-1]
            sizes.append(((sw + 1) // 2, (sh + 1) // 2))
        base = 0
        for lvl, (sw, sh) in enumerate(sizes[:-1]):
            nxt = base + sw * sh
            pw = sizes[lvl + 1][0]
            for y in range(sh):
                for x in range(sw):
                    self.parent.append(nxt + (y // 2) * pw + x // 2)
            base = nxt
        self.parent.append(-1)
        n = len(self.parent) if w * h else 0
        self.value = [999] * n
        self.low = [0] * n

    def decode(self, bio: "BitReader", leaf: int, threshold: int) -> bool:
        stack = []
        node = leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        value, lows = self.value, self.low
        while True:
            if low > lows[node]:
                lows[node] = low
            else:
                low = lows[node]
            while low < threshold and low < value[node]:
                if bio.bit():
                    value[node] = low
                else:
                    low += 1
            lows[node] = low
            if not stack:
                break
            node = stack.pop()
        return value[node] < threshold


class BitReader:
    """`bio.c`'s decoder over data[pos:end]."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end
        self.buf = 0
        self.ct = 0

    def _bytein(self) -> None:
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.pos < self.end:
            self.buf |= self.data[self.pos]
            self.pos += 1

    def bit(self) -> int:
        if self.ct == 0:
            self._bytein()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def inalign(self) -> None:
        if (self.buf & 0xFF) == 0xFF:
            self._bytein()
        self.ct = 0



@dataclass
class Precinct:
    cw: int
    ch: int
    blocks: List[CodeBlock]
    incl: Optional[TagTree] = None
    imsb: Optional[TagTree] = None


@dataclass
class Band:
    bandno: int
    x0: int
    y0: int
    x1: int
    y1: int
    numbps: int
    stepsize: Tuple[int, int]
    precincts: List[Precinct]

    def empty(self) -> bool:
        return self.x1 - self.x0 == 0 or self.y1 - self.y0 == 0


@dataclass
class Resolution:
    x0: int
    y0: int
    x1: int
    y1: int
    pdx: int
    pdy: int
    pw: int
    ph: int
    bands: List[Band]


@dataclass
class TileComp:
    x0: int
    y0: int
    x1: int
    y1: int
    resolutions: List[Resolution]


def tile_geometry(cs: Codestream, tileno: int) -> List[TileComp]:
    """`opj_tcd_init_tile` for decoding: every component's resolutions,
    bands, precincts and code blocks."""
    tx0, ty0, tx1, ty1 = cs.tile_rect(tileno)
    tcp = cs.tcps[tileno]
    out = []
    for c, comp in enumerate(cs.comps):
        tccp = tcp.tccps[c]
        tcx0, tcy0 = _ceildiv(tx0, comp.dx), _ceildiv(ty0, comp.dy)
        tcx1, tcy1 = _ceildiv(tx1, comp.dx), _ceildiv(ty1, comp.dy)
        res_list = []
        for r in range(tccp.numres):
            level = tccp.numres - 1 - r
            rx0, ry0 = _ceildivpow2(tcx0, level), _ceildivpow2(tcy0, level)
            rx1, ry1 = _ceildivpow2(tcx1, level), _ceildivpow2(tcy1, level)
            pdx, pdy = tccp.prcw[r], tccp.prch[r]
            px0, py0 = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
            px1, py1 = _ceildivpow2(rx1, pdx) << pdx, _ceildivpow2(ry1, pdy) << pdy
            pw = 0 if rx0 == rx1 else (px1 - px0) >> pdx
            ph = 0 if ry0 == ry1 else (py1 - py0) >> pdy
            if r == 0:
                cbgx0, cbgy0, cbgw, cbgh = px0, py0, pdx, pdy
            else:
                cbgx0, cbgy0, cbgw, cbgh = _ceildivpow2(px0, 1), _ceildivpow2(py0, 1), pdx - 1, pdy - 1
            cbw, cbh = min(tccp.cblkw, cbgw), min(tccp.cblkh, cbgh)
            bands = []
            for b in ([0] if r == 0 else [1, 2, 3]):
                if r == 0:
                    bx0, by0, bx1, by1 = rx0, ry0, rx1, ry1
                    sidx = 0
                else:
                    lb = level + 1
                    xob, yob = b & 1, b >> 1
                    bx0 = _ceildivpow2(tcx0 - (xob << level), lb)
                    by0 = _ceildivpow2(tcy0 - (yob << level), lb)
                    bx1 = _ceildivpow2(tcx1 - (xob << level), lb)
                    by1 = _ceildivpow2(tcy1 - (yob << level), lb)
                    sidx = 3 * (r - 1) + b
                expn, mant = tccp.stepsizes[sidx]
                numbps = expn + tccp.numgbits - 1
                precs = []
                for p in range(pw * ph):
                    gx0 = cbgx0 + (p % pw) * (1 << cbgw)
                    gy0 = cbgy0 + (p // pw) * (1 << cbgh)
                    qx0, qy0 = max(gx0, bx0), max(gy0, by0)
                    qx1, qy1 = min(gx0 + (1 << cbgw), bx1), min(gy0 + (1 << cbgh), by1)
                    cx0, cy0 = (qx0 >> cbw) << cbw, (qy0 >> cbh) << cbh
                    cx1, cy1 = _ceildivpow2(qx1, cbw) << cbw, _ceildivpow2(qy1, cbh) << cbh
                    cw, ch = max((cx1 - cx0) >> cbw, 0), max((cy1 - cy0) >> cbh, 0)
                    blocks = []
                    for k in range(cw * ch):
                        bx = cx0 + (k % cw) * (1 << cbw)
                        by = cy0 + (k // cw) * (1 << cbh)
                        blocks.append(CodeBlock(max(bx, qx0), max(by, qy0), min(bx + (1 << cbw), qx1),
                                                min(by + (1 << cbh), qy1)))
                    precs.append(Precinct(cw, ch, blocks))
                bands.append(Band(b, bx0, by0, bx1, by1, numbps, (expn, mant), precs))
            res_list.append(Resolution(rx0, ry0, rx1, ry1, pdx, pdy, pw, ph, bands))
        out.append(TileComp(tcx0, tcy0, tcx1, tcy1, res_list))
    return out


# ------------------------------------------------------------ packet order


def _packets(cs: Codestream, tileno: int, tcs: List[TileComp]):
    """`opj_pi_next_*` over the tile's progressions: (layer, res, comp,
    precinct) of each packet, each once."""
    tcp = cs.tcps[tileno]
    tx0, ty0, tx1, ty1 = cs.tile_rect(tileno)
    ncomps = len(cs.comps)
    max_res = max(len(tc.resolutions) for tc in tcs)
    progs = tcp.pocs or [(0, 0, tcp.numlayers, max_res, ncomps, tcp.prg)]
    seen = set()
    for resno0, compno0, layno1, resno1, compno1, prg in progs:
        if compno0 >= ncomps or compno1 > ncomps:
            raise ValueError("JPEG 2000: POC component out of range")
        if prg > 4:
            raise ValueError("JPEG 2000: unknown progression order in POC")
        for key in _order(prg, cs, tcs, tx0, ty0, tx1, ty1, resno0, compno0, layno1, resno1, compno1):
            if key not in seen:
                seen.add(key)
                yield key


def _order(prg, cs, tcs, tx0, ty0, tx1, ty1, resno0, compno0, layno1, resno1, compno1):
    comps = cs.comps
    if prg in (0, 1):   # LRCP, RLCP
        if prg == 0:
            outer = [(l, r) for l in range(layno1) for r in range(resno0, resno1)]
        else:
            outer = [(l, r) for r in range(resno0, resno1) for l in range(layno1)]
        for l, r in outer:
            for c in range(compno0, compno1):
                res_all = tcs[c].resolutions
                if r >= len(res_all):
                    continue
                res = res_all[r]
                for p in range(res.pw * res.ph):
                    yield l, r, c, p
        return

    def dxdy(clist):
        dx = dy = 0
        for c in clist:
            nres = len(tcs[c].resolutions)
            for r, res in enumerate(tcs[c].resolutions):
                sx = res.pdx + nres - 1 - r
                sy = res.pdy + nres - 1 - r
                if sx < 32:
                    v = comps[c].dx << sx
                    dx = v if not dx else min(dx, v)
                if sy < 32:
                    v = comps[c].dy << sy
                    dy = v if not dy else min(dy, v)
        return dx, dy

    def prec_at(c, r, x, y):
        comp = comps[c]
        nres = len(tcs[c].resolutions)
        if r >= nres:
            return None
        res = tcs[c].resolutions[r]
        level = nres - 1 - r
        trx0, try0 = _ceildiv(tx0, comp.dx << level), _ceildiv(ty0, comp.dy << level)
        trx1, try1 = _ceildiv(tx1, comp.dx << level), _ceildiv(ty1, comp.dy << level)
        rpx, rpy = res.pdx + level, res.pdy + level
        if rpx >= 31 or rpy >= 31:
            return None
        if not (y % (comp.dy << rpy) == 0 or (y == ty0 and (try0 << level) % (1 << rpy))):
            return None
        if not (x % (comp.dx << rpx) == 0 or (x == tx0 and (trx0 << level) % (1 << rpx))):
            return None
        if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
            return None
        prci = (_ceildiv(x, comp.dx << level) >> res.pdx) - (trx0 >> res.pdx)
        prcj = (_ceildiv(y, comp.dy << level) >> res.pdy) - (try0 >> res.pdy)
        return prci + prcj * res.pw

    def positions(dx, dy):
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += dx - (x % dx)
            y += dy - (y % dy)

    if prg == 2:   # RPCL
        dx, dy = dxdy(range(len(comps)))
        if not dx or not dy:
            return
        for r in range(resno0, resno1):
            for x, y in positions(dx, dy):
                for c in range(compno0, compno1):
                    p = prec_at(c, r, x, y)
                    if p is not None:
                        for l in range(layno1):
                            yield l, r, c, p
    elif prg == 3:  # PCRL
        dx, dy = dxdy(range(len(comps)))
        if not dx or not dy:
            return
        for x, y in positions(dx, dy):
            for c in range(compno0, compno1):
                for r in range(resno0, resno1):
                    p = prec_at(c, r, x, y)
                    if p is not None:
                        for l in range(layno1):
                            yield l, r, c, p
    else:           # CPRL
        for c in range(compno0, compno1):
            dx, dy = dxdy([c])
            if not dx or not dy:
                continue
            for x, y in positions(dx, dy):
                for r in range(resno0, resno1):
                    p = prec_at(c, r, x, y)
                    if p is not None:
                        for l in range(layno1):
                            yield l, r, c, p


# ----------------------------------------------------------- packet headers


def _getnumpasses(bio: BitReader) -> int:
    if not bio.bit():
        return 1
    if not bio.bit():
        return 2
    n = bio.read(2)
    if n != 3:
        return 3 + n
    n = bio.read(5)
    if n != 31:
        return 6 + n
    return 37 + bio.read(7)


def _new_seg(cblk: CodeBlock, cblksty: int, first: bool) -> None:
    if cblksty & TERMALL:
        maxp = 1
    elif cblksty & LAZY:
        maxp = 10 if first else (2 if cblk.segs[-1][2] in (1, 10) else 1)
    else:
        maxp = 109
    cblk.segs.append([0, 0, maxp])


class _HeaderSource:
    """Where packet headers are read: the tile's data, or PPT / PPM bytes."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0


def decode_tile_packets(cs: Codestream, tileno: int, tcs: List[TileComp], ppm: Optional[_HeaderSource],
                        spans: Optional[list] = None) -> None:
    """Read every packet of the tile into its code blocks' segments and
    chunks (`opj_t2_decode_packets`). `spans`, where given, gets the
    (start, end) of each packet header in the tile's data, its EPH
    included, when the headers are there."""
    tcp: Tcp = cs.tcps[tileno]
    data = b"".join(tcp.data)
    pos, end = 0, len(data)
    if ppm is not None:
        hdr = ppm
    elif tcp.ppt:
        hdr = _HeaderSource(b"".join(tcp.ppt[z] for z in sorted(tcp.ppt)))
    else:
        hdr = None
    for layno, resno, compno, precno in _packets(cs, tileno, tcs):
        res = tcs[compno].resolutions[resno]
        cblksty = tcp.tccps[compno].cblksty
        bands = [b for b in res.bands if not b.empty()]
        if layno == 0:
            for band in bands:
                prc = band.precincts[precno]
                prc.incl = TagTree(prc.cw, prc.ch)
                prc.imsb = TagTree(prc.cw, prc.ch)
                for cb in prc.blocks:
                    cb.segs, cb.chunks, cb.included = [], [], False
        if tcp.csty & 2 and end - pos >= 6 and data[pos] == 0xFF and data[pos + 1] == 0x91:
            pos += 6
        if hdr is None:
            src, hpos, hend = data, pos, end
        else:
            src, hpos, hend = hdr.data, hdr.pos, len(hdr.data)
        bio = BitReader(src, hpos, hend)
        present = bio.bit()
        news: List[Tuple[CodeBlock, List[int]]] = []
        if present:
            for band in bands:
                prc = band.precincts[precno]
                for k, cb in enumerate(prc.blocks):
                    if not cb.included:
                        inc = prc.incl.decode(bio, k, layno + 1)
                    else:
                        inc = bio.bit()
                    if not inc:
                        continue
                    if not cb.included:
                        i = 0
                        while not prc.imsb.decode(bio, k, i):
                            i += 1
                        cb.numbps = band.numbps + 1 - i
                        cb.numlenbits = 3
                    npasses = _getnumpasses(bio)
                    incr = 0
                    while bio.bit():
                        incr += 1
                    cb.numlenbits += incr
                    if not cb.included:
                        _new_seg(cb, cblksty, True)
                        cb.included = True
                    elif cb.segs[-1][1] == cb.segs[-1][2]:
                        _new_seg(cb, cblksty, False)
                    lens = []
                    n = npasses
                    seg_index = len(cb.segs) - 1
                    while True:
                        seg = cb.segs[seg_index]
                        if cblksty & HT:   # one pass to the first segment (the cleanup), the rest to the next
                            take = 1 if seg_index == 0 else n
                        else:
                            take = min(seg[2] - seg[1], n)
                        bits = cb.numlenbits + (take.bit_length() - 1)
                        if bits > 32:
                            raise ValueError("JPEG 2000: code-block length field too long")
                        lens.append((seg_index, bio.read(bits), take))
                        n -= take
                        if n <= 0:
                            break
                        _new_seg(cb, cblksty, False)
                        seg_index += 1
                    news.append((cb, lens))
        bio.inalign()
        hpos = bio.pos
        if tcp.csty & 4:
            if hend - hpos >= 2 and src[hpos] == 0xFF and src[hpos + 1] == 0x92:
                hpos += 2
            elif hend - hpos >= 2:   # OpenJPEG warns "Expected EPH marker", and its decode of the tile fails
                raise ValueError("JPEG 2000: expected an EPH marker")
        if hdr is None:
            if spans is not None:
                spans.append((pos, hpos))
            pos = hpos
        else:
            hdr.pos = hpos
        for cb, lens in news:
            for seg_index, ln, take in lens:
                if pos + ln > end:
                    raise ValueError("JPEG 2000: code-block data run past the tile (truncated codestream)")
                cb.chunks.append(data[pos:pos + ln])
                pos += ln
                seg = cb.segs[seg_index]
                seg[0] += ln
                seg[1] += take


def tile_codeblocks(cs: Codestream, tileno: int, ppm: Optional[_HeaderSource] = None,
                    spans: Optional[list] = None) -> List[TileComp]:
    tcs = tile_geometry(cs, tileno)
    decode_tile_packets(cs, tileno, tcs, ppm, spans)
    return tcs


def ppm_source(cs: Codestream) -> Optional[_HeaderSource]:
    return _HeaderSource(cs.ppm) if cs.ppm is not None else None
