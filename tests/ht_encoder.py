"""A JPEG 2000 Part 15 (HTJ2K) encoder for the tests: neither Pillow's
`libopenjp2` 2.5.4 nor any other library on either machine writes HT
code blocks, so the tests make their own files and let `opj_decode`
judge each one before it judges the port.

`encode_ht_block` codes one block's magnitudes and signs as an HT
cleanup pass at bit plane `s` (MagSgn, MEL and VLC, the VLC codewords
found by inverting the decoder's tables: any codeword that decodes to the
wanted quad), optionally with its SigProp and MagRef passes at plane
`s - 1`. `rewrite` turns a Part-1 codestream (from `opj_encode` or
Pillow) into an HT one: it decodes each code block with the port's plain
tier-1, codes the components chosen as HT again (their COD / COC style
gets 0x40, SIZ `Rsiz` bit 14 and a CAP marker), and writes every packet
header anew, each block's passes all in one layer of its own.
"""

from __future__ import annotations

import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from morphik_core_tpu_torch.utils import jp2_codestream as jcs
from morphik_core_tpu_torch.utils.jp2_tier2 import TagTree, _packets, tile_codeblocks, tile_geometry
from morphik_core_tpu_torch.utils.jpeg2000_ht import MEL_EXP, VLC_TABLES
from morphik_core_tpu_torch.utils.jpeg2000_t1 import decode_block


def _codewords(table: np.ndarray) -> Dict[Tuple[int, int, int], List[Tuple[int, int, int, int]]]:
    """(context, rho, u_off) -> [(e_k, e_1, codeword, length)] of a
    decoding table."""
    rows: Dict[Tuple[int, int, int], set] = {}
    for c in range(8):
        for idx in range(128):
            e = int(table[c * 128 + idx])
            n = e & 7
            rows.setdefault((c, (e >> 4) & 15, (e >> 3) & 1), set()).add((e >> 12, (e >> 8) & 15, idx & ((1 << n) - 1), n))
    return {k: sorted(v, key=lambda t: (-bin(t[0]).count("1"), t[3])) for k, v in rows.items()}


CODEWORDS = [_codewords(VLC_TABLES[0]), _codewords(VLC_TABLES[1])]


class FwdWriter:
    """LSB first; after 0xFF a byte carries 7 bits (MagSgn, SigProp)."""

    def __init__(self):
        self.out = bytearray()
        self.tmp = self.used = 0
        self.room = 8

    def put(self, v: int, n: int) -> None:
        while n > 0:
            take = min(n, self.room - self.used)
            self.tmp |= (v & ((1 << take) - 1)) << self.used
            self.used += take
            v >>= take
            n -= take
            if self.used == self.room:
                self.out.append(self.tmp)
                self.room = 7 if self.tmp == 0xFF else 8
                self.tmp = self.used = 0

    def magsgn_bytes(self) -> bytes:
        """Padded with ones, a trailing 0xFF dropped: the decoder reads
        0xFF past the segment."""
        if self.used:
            self.tmp |= ((1 << (self.room - self.used)) - 1) << self.used
            if self.tmp != 0xFF:
                self.out.append(self.tmp)
        elif self.room == 7:
            self.out.pop()
        return bytes(self.out)

    def sigprop_bytes(self) -> bytes:
        if self.used:
            self.out.append(self.tmp)
        return bytes(self.out)


class RevWriter:
    """LSB first, bytes in reverse order; after a byte above 0x8F, a byte
    whose low 7 bits would all be set carries 7 (VLC, MagRef). The VLC
    starts in the high nibble of the segment's last byte but one."""

    def __init__(self, vlc: bool):
        self.out = bytearray([0xFF]) if vlc else bytearray()
        self.tmp, self.used = (0xF, 4) if vlc else (0, 0)
        self.above_8f = True

    def put(self, v: int, n: int) -> None:
        for i in range(n):
            self.tmp |= ((v >> i) & 1) << self.used
            self.used += 1
            if self.used == 7 and self.above_8f and self.tmp == 0x7F:
                self._emit()
            elif self.used == 8:
                self._emit()

    def _emit(self) -> None:
        self.out.append(self.tmp)
        self.above_8f = self.tmp > 0x8F
        self.tmp = self.used = 0

    def bytes_in_order(self) -> bytes:
        """The stream as it lies in the segment (first byte written last)."""
        if self.used:
            self._emit()
        return bytes(reversed(self.out))


class MelWriter:
    """The MEL coder: runs of zero events, MSB first, 7 bits after 0xFF."""

    def __init__(self):
        self.out = bytearray()
        self.tmp = self.k = self.run = 0
        self.room = 8

    def _bit(self, b: int) -> None:
        self.tmp = (self.tmp << 1) | b
        self.room -= 1
        if self.room == 0:
            self.out.append(self.tmp)
            self.room = 7 if self.tmp == 0xFF else 8
            self.tmp = 0

    def event(self, e: bool) -> None:
        if not e:
            self.run += 1
            if self.run >= 1 << MEL_EXP[self.k]:
                self._bit(1)
                self.run = 0
                self.k = min(12, self.k + 1)
        else:
            self._bit(0)
            t = MEL_EXP[self.k]
            while t > 0:
                t -= 1
                self._bit((self.run >> t) & 1)
            self.run = 0
            self.k = max(0, self.k - 1)

    def finish(self) -> bytes:
        if self.run > 0:
            self._bit(1)
        if self.room < 8:
            self.out.append((self.tmp << self.room) & 0xFF)
        return bytes(self.out)


def _uvlc_bits(u: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(prefix, suffix) of u >= 1 as (value, length), LSB first."""
    if u == 1:
        return (1, 1), (0, 0)
    if u == 2:
        return (2, 2), (0, 0)
    if u <= 4:
        return (4, 3), (u - 3, 1)
    if u - 5 >= 32:
        raise ValueError(f"u = {u} does not fit the UVLC")
    return (0, 3), (u - 5, 5)


def exponents(mu: np.ndarray) -> np.ndarray:
    """E of each sample: the bit length of 2 (mu - 1) + 1, 0 where mu = 0."""
    v = np.where(mu > 0, 2 * (mu.astype(np.int64) - 1) + 1, 0)
    return np.frexp(v.astype(np.float64))[1].astype(np.int64)


def _quad_fields(mu: np.ndarray):
    """Per quad (row pair, quad): rho, the four exponents, the context bits
    from the row above and kappa's candidate from the exponents above."""
    h, w = mu.shape
    hp, wp = h + (h & 1), -(-w // 2) * 2 + 2
    m = np.zeros((hp + 1, wp + 2), np.int64)    # a row above and a column left of the block
    m[1:h + 1, 1:w + 1] = mu
    E = exponents(m)
    sig = (m > 0).astype(np.int64)
    top, bot = slice(1, hp + 1, 2), slice(2, hp + 2, 2)
    rows_above = slice(0, hp, 2)
    nq = -(-w // 2)
    col = 1 + 2 * np.arange(nq)
    rho = sig[top, col] | (sig[bot, col] << 1) | (sig[top, col + 1] << 2) | (sig[bot, col + 1] << 3)
    eq = np.stack([E[top, col], E[bot, col], E[top, col + 1], E[bot, col + 1]], -1)
    above = ((sig[rows_above, col - 1] | sig[rows_above, col]) | ((sig[rows_above, col + 1] | sig[rows_above, col + 2]) << 2))
    e_above = np.maximum(np.maximum(E[rows_above, col - 1], E[rows_above, col]),
                         np.maximum(E[rows_above, col + 1], E[rows_above, col + 2]))
    return rho, eq, above, e_above


_CHOICE: Dict[tuple, Tuple[int, int, int]] = {}


def _codeword(tbl: int, c: int, rho: int, u_off: int, eps: int) -> Tuple[int, int, int]:
    """(codeword, length, e_k) for a quad whose samples at `eps` have E = U."""
    key = (tbl, c, rho, u_off, eps)
    if key not in _CHOICE:
        for ek, e1, cwd, n in CODEWORDS[tbl][(c, rho, u_off)]:
            if not e1 & ~ek and (e1 & ek) == (eps & ek):
                _CHOICE[key] = (cwd, n, ek)
                break
        else:
            raise ValueError(f"no codeword for context {c}, rho {rho}, u_off {u_off}, exponents at U {eps}")
    return _CHOICE[key]


def encode_cleanup(mu: np.ndarray, neg: np.ndarray) -> bytes:
    """The cleanup segment of magnitudes `mu` (h, w) and signs `neg`."""
    h, w = mu.shape
    rho_a, eq_a, above_a, eabove_a = _quad_fields(np.asarray(mu))
    ms, mel, vlc = FwdWriter(), MelWriter(), RevWriter(True)
    nq = rho_a.shape[1]
    muv = np.zeros((h + 1, 2 * nq), np.int64)
    muv[:h, :w] = mu
    ngv = np.zeros((h + 1, 2 * nq), np.int64)
    ngv[:h, :w] = neg
    for r in range(rho_a.shape[0]):
        y = 2 * r
        initial = y == 0
        tbl = 0 if initial else 1
        rhos, eqs, aboves, eaboves = rho_a[r].tolist(), eq_a[r].tolist(), above_a[r].tolist(), eabove_a[r].tolist()
        carry = 0
        for q0 in range(0, nq, 2):
            quads = []
            for q in range(q0, min(q0 + 2, nq)):
                rho, eq = rhos[q], eqs[q]
                c = carry if initial else carry | aboves[q]
                kappa = 1
                if not initial and rho & (rho - 1):
                    kappa = max(1, eaboves[q] - 1)
                U = max(max(eq), kappa)
                u = U - kappa
                ek = 0
                if c == 0:
                    mel.event(rho != 0)
                if rho or c:
                    eps = sum(1 << n for n in range(4) if (rho >> n) & 1 and eq[n] == U)
                    cwd, n, ek = _codeword(tbl, c, rho, int(u > 0), eps)
                    vlc.put(cwd, n)
                quads.append((q, rho, U, u, ek))
                carry = ((rho & 1) | ((rho >> 1) & 1) | (((rho >> 2) & 1) << 1) | (((rho >> 3) & 1) << 2)) if initial \
                    else int(bool(rho & 0xC)) << 1
            us = [t[3] for t in quads] + [0]
            mode = int(us[0] > 0) | (int(us[1] > 0) << 1)
            if mode == 3:
                u0, u1 = us[0], us[1]
                both = initial and u0 > 2 and u1 > 2
                if initial:
                    mel.event(both)
                if both:
                    (p0, s0), (p1, s1) = _uvlc_bits(u0 - 2), _uvlc_bits(u1 - 2)
                    for v, n in (p0, p1, s0, s1):
                        vlc.put(v, n)
                elif initial and u0 > 2:
                    (p0, s0) = _uvlc_bits(u0)
                    vlc.put(*p0)
                    vlc.put(u1 - 1, 1)
                    vlc.put(*s0)
                else:
                    (p0, s0), (p1, s1) = _uvlc_bits(u0), _uvlc_bits(u1)
                    for v, n in (p0, p1, s0, s1):
                        vlc.put(v, n)
            elif mode:
                (p0, s0) = _uvlc_bits(us[0] if mode == 1 else us[1])
                vlc.put(*p0)
                vlc.put(*s0)
            for q, rho, U, u, ek in quads:
                if not rho:
                    continue
                x = 2 * q
                for n, (yy, xx) in enumerate(((y, x), (y + 1, x), (y, x + 1), (y + 1, x + 1))):
                    if rho & (1 << n):
                        m = U - ((ek >> n) & 1)
                        ms.put((2 * (int(muv[yy, xx]) - 1) + int(ngv[yy, xx])) & ((1 << m) - 1), m)
    magsgn, melb, vlcb = ms.magsgn_bytes(), mel.finish(), vlc.bytes_in_order()
    scup = len(melb) + len(vlcb)
    if scup > 4079:
        raise ValueError("MEL + VLC longer than 4079 bytes")
    seg = bytearray(magsgn + melb + vlcb)
    seg[-1] = scup >> 4
    seg[-2] = (seg[-2] & 0xF0) | (scup & 0xF)
    return bytes(seg)


def encode_refinement(mag: np.ndarray, neg: np.ndarray, s: int, magref: bool, causal: bool) -> bytes:
    """SigProp (and MagRef) at bit plane s - 1 of magnitudes `mag` whose
    cleanup was at plane s, stripe by stripe of four rows."""
    h, w = mag.shape
    sig = (mag >> s) > 0
    bit = (mag >> (s - 1)) & 1
    new = np.zeros_like(sig)
    sp, mr = FwdWriter(), RevWriter(False)
    for y0 in range(0, h, 4):
        rows = range(y0, min(y0 + 4, h))
        if magref:
            for x in range(w):
                for y in rows:
                    if sig[y, x]:
                        mr.put(int(bit[y, x]), 1)
        for g in range(0, w, 4):
            found = []
            for x in range(g, min(g + 4, w)):
                for y in rows:
                    if sig[y, x]:
                        continue
                    near = False
                    for dy in (-1, 0, 1):
                        for dx in (-1, 0, 1):
                            yy, xx = y + dy, x + dx
                            if (dy or dx) and 0 <= yy < h and 0 <= xx < w and not (causal and yy >= y0 + 4):
                                near = near or bool(sig[yy, xx] or new[yy, xx])
                    if near:
                        sp.put(int(bit[y, x]), 1)
                        if bit[y, x]:
                            new[y, x] = True
                            found.append((y, x))
            for y, x in found:
                sp.put(int(neg[y, x]), 1)
    return sp.sigprop_bytes() + (mr.bytes_in_order() if magref else b"")


def encode_ht_block(mag: np.ndarray, neg: np.ndarray, s: int, npasses: int = 1,
                    causal: bool = False) -> Tuple[bytes, bytes]:
    """(cleanup segment, refinement segment) of one block: the cleanup at
    plane s, SigProp with 2 passes, MagRef too with 3 (s >= 1)."""
    cleanup = encode_cleanup(np.asarray(mag) >> s, np.asarray(neg))
    if npasses == 1:
        return cleanup, b""
    return cleanup, encode_refinement(np.asarray(mag, np.int64), np.asarray(neg), s, npasses == 3, causal)


# --------------------------------------------------------------- tier-2


class BitWriter:
    """OpenJPEG's `bio.c` writer: MSB first, after 0xFF 7 bits a byte."""

    def __init__(self):
        self.out = bytearray()
        self.buf = 0
        self.ct = 8

    def _byteout(self) -> None:
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        self.out.append(self.buf >> 8)

    def bit(self, b: int) -> None:
        if self.ct == 0:
            self._byteout()
        self.ct -= 1
        self.buf |= (b & 1) << self.ct

    def bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bit((v >> i) & 1)

    def flush(self) -> bytes:
        self._byteout()
        if self.ct == 7:
            self._byteout()
        return bytes(self.out)


class TagEncoder(TagTree):
    """`tgt.c`'s encoder on `TagTree`'s layout."""

    def __init__(self, w: int, h: int, values: Sequence[int]):
        super().__init__(w, h)
        n = len(self.parent)
        self.value = [1 << 30] * n
        for i, v in enumerate(values):
            node = i
            while node >= 0:
                self.value[node] = min(self.value[node], v)
                node = self.parent[node]
        self.known = [False] * n

    def encode(self, bio: BitWriter, leaf: int, threshold: int) -> None:
        stack = []
        node = leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bio.bit(1)
                        self.known[node] = True
                    break
                bio.bit(0)
                low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()


def _numpasses(bio: BitWriter, n: int) -> None:
    if n == 1:
        bio.bit(0)
    elif n == 2:
        bio.bits(0b10, 2)
    elif n <= 5:
        bio.bits(0b1100 | (n - 3), 4)
    elif n <= 36:
        bio.bits((0b1111 << 5) | (n - 6), 9)
    else:
        bio.bits((0b111111111 << 7) | (n - 37), 16)


def _seg_passes(cblksty: int, npasses: int) -> List[int]:
    """How the passes of a Part-1 block's one contribution split into
    codeword segments: OpenJPEG's `maxpasses`."""
    out, left, first, last_max = [], npasses, True, 0
    while left > 0:
        if cblksty & jcs.TERMALL:
            mx = 1
        elif cblksty & jcs.LAZY:
            mx = 10 if first else (2 if last_max in (1, 10) else 1)
        else:
            mx = 109
        take = min(mx, left)
        out.append(take)
        left -= take
        first, last_max = False, mx
    return out


class Contribution:
    """One code block's coded data: `parts`, each (layer, [(passes,
    bytes) a codeword segment]) in increasing layers, the first one its
    first inclusion."""

    def __init__(self, zero_planes: int, parts: List[Tuple[int, List[Tuple[int, bytes]]]]):
        self.zero_planes, self.parts = zero_planes, parts
        self.layer = parts[0][0]


def _header(bio: BitWriter, blocks, incl: TagEncoder, imsb: TagEncoder, layer: int, state: dict) -> List[bytes]:
    """One band's part of a packet header; -> the included blocks' data.
    `state` keeps each block's length-bit count once it is included."""
    body = []
    for k, con in enumerate(blocks):
        key = (id(incl), k)
        if con is None or con.layer > layer:
            incl.encode(bio, k, layer + 1)
            continue
        part = next((segs for lay, segs in con.parts if lay == layer), None)
        if key not in state:
            incl.encode(bio, k, layer + 1)
            imsb.encode(bio, k, 999)   # the zero bit planes, all of them
            state[key] = 3
        else:
            bio.bit(int(part is not None))
            if part is None:
                continue
        _numpasses(bio, sum(n for n, _ in part))
        need = state[key]
        for n, seg in part:
            while len(seg) >= 1 << (need + n.bit_length() - 1):
                need += 1
        for _ in range(need - state[key]):
            bio.bit(1)
        bio.bit(0)
        state[key] = need
        for n, seg in part:
            bio.bits(len(seg), need + n.bit_length() - 1)
            body.append(seg)
    return body


def _markers(stream: bytes, at: int, end: int):
    """(marker, start, end) of each segment from `at` up to SOD / SOT."""
    out = []
    while at + 2 <= end:
        m = struct.unpack(">H", stream[at:at + 2])[0]
        if m in (0xFF90, 0xFF93):
            out.append((m, at, at))
            return out
        ln = struct.unpack(">H", stream[at + 2:at + 4])[0]
        out.append((m, at, at + 2 + ln))
        at += 2 + ln
    return out


Plan = Callable[[int, int, int, object, object], Optional[Tuple[np.ndarray, np.ndarray, int, int, int]]]


def rewrite(data: bytes, ht_comps: Sequence[int], rng: np.random.Generator, plan: Plan = None,
            cap: bool = True, rsiz: bool = True, extra_sty: int = 0,
            coefficients: Callable[[int, int], np.ndarray] = None) -> bytes:
    """The Part-1 file `data` (raw codestream or JP2, one tile-part a tile,
    no PPM / PPT / PLT / TLM) with the components `ht_comps` coded as HT
    and every packet written again. `plan(tile, comp, band, block, values)`
    gives an HT block's (magnitudes, negatives, s, passes, layer[, the
    later layer of its refinement passes]), or None to leave it out; by default the block's own tier-1 values at a random
    plane, passes and layer. `extra_sty` is OR-ed into the HT style.
    `coefficients(tile, comp)`, where given, is each HT tile-component's
    buffer of integer coefficients (`forward_53`), read instead of the
    blocks' tier-1 (no packet of `data` is read when every component is
    HT). A plan may give a dict instead: `mag`, `neg`, `s`, `passes` (more
    than 3 declares passes the data lacks), `layer` and optionally
    `refine_layer`, `refinement` (bytes) and `zero_planes`."""
    stream, header = jcs.codestream_of(data)
    cs = jcs.parse(stream)
    ncomp = len(cs.comps)
    lsiz = struct.unpack(">H", stream[4:6])[0]
    main = _markers(stream, 4 + lsiz, len(stream))
    sot0 = main[-1][1]
    pieces = [bytearray(stream[:4 + lsiz])]
    if rsiz:
        pieces[0][6:8] = struct.pack(">H", struct.unpack(">H", pieces[0][6:8])[0] | 0x4000)
    if cap:
        pieces.append(b"\xff\x50" + struct.pack(">HIH", 8, 0x00020000, 0))
    base_sty = None
    for m, a, b in main[:-1]:
        seg = bytearray(stream[a:b])
        if m in (0xFF55, 0xFF57):
            continue
        if m == 0xFF52:
            base_sty = seg[12]
            seg[12] = (seg[12] | 0x40 | extra_sty) if 0 in ht_comps else seg[12]
        pieces.append(bytes(seg))
    # a COC for each component whose kind differs from component 0's
    cod = next(stream[a:b] for m, a, b in main if m == 0xFF52)
    for c in range(ncomp):
        if (c in ht_comps) != (0 in ht_comps):
            sp = bytearray(cod[9:14] + (cod[14:] if cod[4] & 1 else b""))
            sp[3] = (base_sty | 0x40 | extra_sty) if c in ht_comps else base_sty
            body = (bytes([c]) if ncomp <= 256 else struct.pack(">H", c)) + bytes([cod[4] & 1]) + bytes(sp)
            pieces.append(b"\xff\x53" + struct.pack(">H", 2 + len(body)) + body)
    out = b"".join(pieces)
    tiles = []
    pos = sot0
    tparts = {}
    while pos + 12 <= len(stream):
        m = struct.unpack(">H", stream[pos:pos + 2])[0]
        if m != 0xFF90:
            break
        isot, psot = struct.unpack(">HI", stream[pos + 4:pos + 10])
        hdr = _markers(stream, pos + 12, pos + psot)
        tparts.setdefault(isot, b"".join(stream[a:b] for mm, a, b in hdr[:-1] if mm not in (0xFF58, 0xFF61)))
        pos += psot
    numlayers = cs.tcps[0].numlayers
    for t in cs.tile_order:
        tcp = cs.tcps[t]
        tcs = tile_geometry(cs, t) if coefficients and len(set(ht_comps)) == ncomp else tile_codeblocks(cs, t)
        cons: Dict[int, Contribution] = {}
        for c, tc in enumerate(tcs):
            tccp = tcp.tccps[c]
            buf = coefficients(t, c) if coefficients and c in ht_comps else None
            for r, res in enumerate(tc.resolutions):
                for band in res.bands:
                    ox = oy = 0
                    if r:
                        prev = tc.resolutions[r - 1]
                        ox = (prev.x1 - prev.x0) if band.bandno & 1 else 0
                        oy = (prev.y1 - prev.y0) if band.bandno & 2 else 0
                    for prc in band.precincts:
                        for cb in prc.blocks:
                            w, h = cb.x1 - cb.x0, cb.y1 - cb.y0
                            if w <= 0 or h <= 0:
                                continue
                            vals = np.zeros((h, w), np.int64)
                            if buf is not None:   # the coefficients in t1's form: 2 |q| + 1 with q's sign
                                q = buf[cb.y0 - band.y0 + oy:cb.y1 - band.y0 + oy, cb.x0 - band.x0 + ox:cb.x1 - band.x0 + ox]
                                vals = np.sign(q) * (2 * np.abs(q) + 1)
                            elif cb.chunks:
                                vals = np.array(decode_block(b"".join(cb.chunks), 0, [(s[0], s[1]) for s in cb.segs],
                                                             w, h, band.bandno, cb.numbps, tccp.roishift,
                                                             tccp.cblksty), np.int64).reshape(h, w)
                            if c in ht_comps:
                                got = (plan or _default_plan(rng, numlayers))(t, c, band, cb, vals)
                                if got is None:
                                    continue
                                if not isinstance(got, dict):
                                    got = dict(zip(("mag", "neg", "s", "passes", "layer", "refine_layer"), got))
                                npasses = got["passes"]
                                cl, rf = encode_ht_block(got["mag"], got["neg"], got["s"],
                                                         1 if "refinement" in got else min(npasses, 3),
                                                         bool(tccp.cblksty & jcs.VSC))
                                rf = got.get("refinement", rf)
                                layer = got["layer"]
                                parts = [(layer, [(1, cl)] + ([(npasses - 1, rf)] if npasses > 1 else []))]
                                if got.get("refine_layer") is not None and npasses > 1:   # refinement in a later layer
                                    parts = [(layer, [(1, cl)]), (got["refine_layer"], [(npasses - 1, rf)])]
                                zero = got.get("zero_planes")
                                cons[id(cb)] = Contribution(band.numbps - 1 - got["s"] if zero is None else zero, parts)
                            elif cb.chunks:
                                joined, at = b"".join(cb.chunks), 0
                                segs = []
                                for ln, _, _ in cb.segs:
                                    segs.append(joined[at:at + ln])
                                    at += ln
                                npasses = sum(s[1] for s in cb.segs)
                                sp = _seg_passes(tccp.cblksty, npasses)
                                assert sp == [s[1] for s in cb.segs], (sp, cb.segs)
                                cons[id(cb)] = Contribution(band.numbps - cb.numbps,
                                                            [(int(rng.integers(0, numlayers)), list(zip(sp, segs)))])
        trees: Dict[Tuple[int, int, int, int], Tuple[TagEncoder, TagEncoder]] = {}
        state: dict = {}
        body = bytearray()
        nsop = 0
        for layer, r, c, p in _packets(cs, t, tcs):
            res = tcs[c].resolutions[r]
            bands = [b for b in res.bands if not b.empty()]
            bio = BitWriter()
            parts = []
            lists = []
            for band in bands:
                prc = band.precincts[p]
                blocks = [cons.get(id(cb)) for cb in prc.blocks]
                key = (c, r, band.bandno, p)
                if key not in trees:
                    trees[key] = (TagEncoder(prc.cw, prc.ch, [b.layer if b else 1 << 20 for b in blocks]),
                                  TagEncoder(prc.cw, prc.ch, [b.zero_planes if b else 0 for b in blocks]))
                lists.append((blocks, trees[key]))
            present = any(b is not None and any(lay == layer for lay, _ in b.parts) for blocks, _ in lists
                          for b in blocks)
            bio.bit(int(present))
            if present:
                for blocks, (incl, imsb) in lists:
                    parts += _header(bio, blocks, incl, imsb, layer, state)
            hdr = bio.flush()
            if tcp.csty & 2:
                body += b"\xff\x91\x00\x04" + struct.pack(">H", nsop & 0xFFFF)
            nsop += 1
            body += hdr
            if tcp.csty & 4:
                body += b"\xff\x92"
            body += b"".join(parts)
        extra = tparts.get(t, b"")
        tile = extra + b"\xff\x93" + bytes(body)
        tiles.append(b"\xff\x90\x00\x0a" + struct.pack(">HIBB", t, 12 + len(tile), 0, 1) + tile)
    out += b"".join(tiles) + b"\xff\xd9"
    if header is None:
        return out
    return data[:header.codestream[0] - 8] + struct.pack(">I", 8 + len(out)) + b"jp2c" + out


def _default_plan(rng: np.random.Generator, numlayers: int) -> Plan:
    def plan(t, c, band, cb, vals):
        if not vals.any() and rng.random() < 0.7:
            return None
        mag = np.abs(vals) >> 1
        neg = vals < 0
        mb = band.numbps
        if mb < 1:
            return None
        s = int(rng.integers(0, mb))   # the cleanup's plane: numbps = s + 1 = Mb - missing MSBs
        npasses = 1 if s == 0 else int(rng.integers(1, 4))
        return mag, neg, s, npasses, int(rng.integers(0, numlayers))
    return plan


def _fwd53_1d(x: np.ndarray) -> np.ndarray:
    """The 5/3 lifting along the last axis from an even origin -> [low |
    high]: the exact inverse of `jpeg2000._idwt53_1d`."""
    n = x.shape[-1]
    if n == 1:
        return x.copy()
    y = x.copy()
    p = np.concatenate([y[..., 1:2], y, y[..., n - 2:n - 1]], -1)
    y[..., 1::2] -= (p[..., 1:n:2] + p[..., 3:n + 2:2]) // 2
    p = np.concatenate([y[..., 1:2], y, y[..., n - 2:n - 1]], -1)
    y[..., 0::2] += (p[..., 0:n:2] + p[..., 2:n + 2:2] + 2) // 4
    return np.concatenate([y[..., 0::2], y[..., 1::2]], -1)


def forward_53(plane: np.ndarray, numres: int) -> np.ndarray:
    """A tile-component at the origin (0, 0) -> its coefficients in
    OpenJPEG's buffer layout: each level columns then rows, the LL
    quarter again."""
    buf = plane.astype(np.int64).copy()
    h, w = buf.shape
    for _ in range(numres - 1):
        region = buf[:h, :w]
        region = _fwd53_1d(region.T).T
        buf[:h, :w] = _fwd53_1d(region)
        h, w = -(-h // 2), -(-w // 2)
    return buf


def forward_rct(rgb: np.ndarray, prec: int = 8) -> List[np.ndarray]:
    """DC-shifted RGB -> the RCT's Y, U (B - G), V (R - G)."""
    r, g, b = (rgb[..., k].astype(np.int64) - (1 << (prec - 1)) for k in range(3))
    return [(r + 2 * g + b) // 4, b - g, r - g]


def jph(data: bytes) -> bytes:
    """A JP2 file as JPH (Part 15's file format): its ftyp brand and
    compatibility list `jph `."""
    out, at = bytearray(data), 12
    while at + 8 <= len(out):
        lbox, tbox = struct.unpack(">I4s", out[at:at + 8])
        if tbox == b"ftyp":
            body = b"jph " + b"\0\0\0\0" + b"jph "
            return bytes(out[:at]) + struct.pack(">I", 8 + len(body)) + b"ftyp" + body + bytes(out[at + lbox:])
        at += lbox
    raise ValueError("no ftyp box")
