"""WebP lossy (VP8 key frame) decoding in the stdlib and numpy, as libwebp
1.6 decodes it (`src/dec/vp8_dec.c`, `tree_dec.c`, `quant_dec.c`,
`frame_dec.c`, `src/dsp/dec.c`, `upsampling.c`, `yuv.h`; RFC 6386).

- The boolean decoder of RFC 6386 section 7, over the first partition
  (frame header, segments, loop-filter header, quantizers, coefficient
  probability updates, per-macroblock segment / skip / intra modes) and
  the token partitions (one per macroblock row, modulo their count).
- Residuals as `ParseResiduals` / `GetCoeffs` read them: four block
  types, the zig-zag order, band and non-zero contexts, the large-value
  categories, dequantized with the segment's tables (`VP8ParseQuant`:
  y2 DC doubled, y2 AC * 155 / 100 at least 8, uv DC capped at index
  117); the Walsh-Hadamard transform of a 16x16 macroblock's DCs; the
  integer IDCT (`TransformOne_C`, 20091 / 35468), run over every block at
  once.
- Intra prediction on the unfiltered reconstruction (libwebp keeps its
  top and left samples from before the loop filter): 16x16 and chroma
  DC / V / H / TM with the DC variants of the frame's edges, the ten 4x4
  modes with the above-right samples of the macroblock repeated for the
  right column's lower sub-blocks; 127 above the frame, 129 left of it.
- The loop filter (`DoFilter`: simple or normal, per segment and 4x4
  mode strength, sharpness, edge / interior limits and high edge
  variance thresholds), macroblock by macroblock in raster order, each
  edge of 16 or 8 samples filtered at once.
- Then `EmitFancyRGB`: the fancy upsampler of `upsampling.c` (9-3-3-1
  weights in two rounding steps, the first and an even last row
  replicated) and the 14-bit fixed-point `VP8YUVToR/G/B` of `yuv.h`.

The constant tables (default coefficient probabilities, their update
probabilities, the 4x4 mode probabilities, the DC and AC quantizer
steps) are RFC 6386's, as libwebp holds them.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_COEFFS_PROBA0 = bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080bd81f2ff"
    "e3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb"
    "80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece680808080800165fbfff1ff8080808080aa"
    "8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3"
    "ab80808080800198fcfff0ff8080808080b187f3ffeae180808080805081d3ffc2e080808080800101ff808080808080"
    "8080f601ff8080808080808080ff80808080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f"
    "92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5"
    "f2c4ffff806379d2fac9c6ffca808080175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080"
    "802c82c9fdcdc0ffff8080800184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9"
    "ffe8eb80808080807c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ff"
    "ff8080802d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fa"
    "d3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba8080808080452ebeefc9daffe4"
    "80808001bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff8080808080800110f8ffff808080808080be"
    "24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080f7c0ff8080808080808080f080ff8080"
    "8080808080800186fcffff808080808080d53efaffff808080808080375dff8080808080808080808080808080808080"
    "808080808080808080808080808080808080808080808080ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e"
    "8adb97b2f0aaffd8800170e6fac7bff79fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7"
    "f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080"
    "801c6caaf2b7c2fedfffff800151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8"
    "ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caff"
    "db8080802a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080")
_COEFFS_UPDATE_PROBA = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffffdff1fcff"
    "fffffffffffffff9fdfdfffffffffffffffffff4fcffffffffffffffffeafefefffffffffffffffffdffffffffffffff"
    "fffffffff6feffffffffffffffffeffdfefffffffffffffffffefffefffffffffffffffffff8fefffffffffffffffffb"
    "fffefffffffffffffffffffffffffffffffffffffffffdfefffffffffffffffffbfefefffffffffffffffffefffeffff"
    "fffffffffffffffefdfffefffffffffffffafffefffefffffffffffffeffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafa"
    "f1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffeefdfefefffffffffffffffff8feffffff"
    "fffffffffff9fefffffffffffffffffffffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffff"
    "fffffffffffffffffffffffffffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefe"
    "fffffffffffffffffdfffffffffffffffffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffff"
    "fffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfeff"
    "fffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffffffffffffffffffffffffffff"
    "fffffffffefffffffffffffffffffefefffffffffffffffffffefffffffffffffffffffffffffffffffffffffffffffe"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffff8fffffffffffffffffffffafefcfefffffffffffffff8fe"
    "f9fdfffffffffffffffffdfdfffffffffffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcffffff"
    "fffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfefffffffffffffffff5fbfeffffffffffffff"
    "fffdfdfefffffffffffffffffffbfdfffffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcff"
    "fffffffffffffffff9fffefffffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff")
_BMODES_PROBA = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150aad791850"
    "c31a3e2c405590470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d102486b759896265"
    "6aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a631179d412669a033341f7380"
    "684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5bd171216585893962a2e2dc4cd2b61b7"
    "75552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab3aa55a6240221674ce17222ba6496b36201a3301"
    "512b1f44196a1640ab24e1722213156684bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f"
    "70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e"
    "10ff8022c5ab29280566d3b70401dd333211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba6"
    "5d499a282815748fd12227af2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd"
    "2803097333c01206df572509733b4d40152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a"
    "8598740a2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd"
    "2d25c03726467c49660122627d622a58685575af525f543559806471652d4b4f7b2f338051ab01391105476639352931"
    "26210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a39120a6666d522142b75140f"
    "24a38044011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113469255373e46252b259a64a3"
    "55a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808118489ff3774803a0f145287391a7928"
    "a4321f899a851923da33672c83837b1f069e5628408794e02db780161a1183f09a0e01d12d10155b40de0701c5381527"
    "9b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab120b073f90ab0404f6231b0a92aeab0c1a80be502363b450"
    "7e362d557e2f57b033291420654b808b769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e"
    "9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc380300418")
_DC_TABLE = bytes.fromhex(
    "0405060708090a0a0b0c0d0e0f101111121314141515161617171819191a1b1c1d1e1f20212223242525262728292a2b"
    "2c2d2e2e2f303132333435363738393a3b3c3d3e3f404142434445464748494a4b4c4c4d4e4f50515253545556575859"
    "5b5d5f6062646566686a6c6e707274767a7c7e80828486888a8c8f9194979a9d")
_AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,)

_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT3456 = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
            (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# kYModesIntra4: the 4x4 mode tree (a leaf is minus the mode)
_YMODES_INTRA4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
# mode numbers (B_DC_PRED ... B_HU_PRED); 16x16 and chroma use DC, TM, V, H
_DC, _TM, _VE, _HE, _RD, _VR, _LD, _VL, _HD, _HU = range(10)
_NORM = [0] + [7 - (i.bit_length() - 1) for i in range(1, 256)]


class _Bool:
    """RFC 6386 section 7: range in [128, 255], the value compared against
    split << cnt (cnt: bits read past the current window)."""
    __slots__ = ("data", "pos", "rng", "value", "cnt")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.rng = 255
        self.value = 0
        self.cnt = -8
        self._load()

    def _load(self):
        while self.cnt < 0:
            b = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.value = (self.value << 8) | b
            self.cnt += 8

    def bit(self, prob: int) -> int:
        split = 1 + (((self.rng - 1) * prob) >> 8)
        big = split << self.cnt
        if self.value >= big:
            self.rng -= split
            self.value -= big
            bit = 1
        else:
            self.rng = split
            bit = 0
        shift = _NORM[self.rng]
        if shift:
            self.rng <<= shift
            self.cnt -= shift
            if self.cnt < 0:
                self._load()
        return bit

    def value_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(128) else v


def vp8_header(data: bytes) -> Tuple[int, int]:
    """(width, height) of a key frame's `VP8 ` chunk payload."""
    if len(data) < 10:
        raise ValueError("truncated WebP lossy frame header")
    bits = data[0] | data[1] << 8 | data[2] << 16
    if bits & 1:
        raise ValueError("WebP lossy data is not a key frame")
    if (bits >> 1) & 7 > 3:
        raise ValueError("unknown WebP lossy profile")
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError("bad WebP lossy start code")
    w = (data[6] | data[7] << 8) & 0x3FFF
    h = (data[8] | data[9] << 8) & 0x3FFF
    if not w or not h:
        raise ValueError("WebP lossy frame of no pixels")
    return w, h


class _Header:
    pass


def _parse_header(data: bytes):
    w, h = vp8_header(data)
    bits = data[0] | data[1] << 8 | data[2] << 16
    if not (bits >> 4) & 1:
        raise ValueError("WebP lossy frame is not shown")
    part0 = bits >> 5
    if 10 + part0 > len(data):
        raise ValueError("truncated WebP lossy first partition")
    br = _Bool(data[10:10 + part0])
    hd = _Header()
    hd.width, hd.height = w, h
    br.bit(128)   # colour space
    br.bit(128)   # clamping type
    hd.use_segment = br.bit(128)
    hd.update_map = 0
    hd.absolute_delta = 1
    hd.quantizer = [0] * 4
    hd.filter_strength = [0] * 4
    hd.segment_probs = [255] * 3
    if hd.use_segment:
        hd.update_map = br.bit(128)
        if br.bit(128):
            hd.absolute_delta = br.bit(128)
            hd.quantizer = [br.signed(7) if br.bit(128) else 0 for _ in range(4)]
            hd.filter_strength = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
        if hd.update_map:
            hd.segment_probs = [br.value_bits(8) if br.bit(128) else 255 for _ in range(3)]
    hd.simple = br.bit(128)
    hd.level = br.value_bits(6)
    hd.sharpness = br.value_bits(3)
    hd.use_lf_delta = br.bit(128)
    hd.ref_lf_delta = [0] * 4
    hd.mode_lf_delta = [0] * 4
    if hd.use_lf_delta and br.bit(128):
        for i in range(4):
            if br.bit(128):
                hd.ref_lf_delta[i] = br.signed(6)
        for i in range(4):
            if br.bit(128):
                hd.mode_lf_delta[i] = br.signed(6)
    hd.filter_type = 0 if hd.level == 0 else 1 if hd.simple else 2
    # token partitions
    nparts = 1 << br.value_bits(2)
    rest = data[10 + part0:]
    if len(rest) < 3 * (nparts - 1):
        raise ValueError("truncated WebP lossy partition table")
    at = 3 * (nparts - 1)
    left = len(rest) - at
    parts = []
    for p in range(nparts - 1):
        size = min(rest[3 * p] | rest[3 * p + 1] << 8 | rest[3 * p + 2] << 16, left)
        parts.append(_Bool(rest[at:at + size]))
        at += size
        left -= size
    parts.append(_Bool(rest[at:]))
    hd.parts = parts
    # quantizers (`VP8ParseQuant`)
    base = br.value_bits(7)
    deltas = [br.signed(4) if br.bit(128) else 0 for _ in range(5)]   # y1dc, y2dc, y2ac, uvdc, uvac
    clip = lambda v, m: 0 if v < 0 else m if v > m else v   # noqa: E731
    hd.dq = []
    for s in range(4):
        if hd.use_segment:
            q = hd.quantizer[s] + (0 if hd.absolute_delta else base)
        else:
            if s > 0:
                hd.dq.append(hd.dq[0])
                continue
            q = base
        y2ac = (_AC_TABLE[clip(q + deltas[2], 127)] * 101581) >> 16
        hd.dq.append((
            (_DC_TABLE[clip(q + deltas[0], 127)], _AC_TABLE[clip(q, 127)]),
            (_DC_TABLE[clip(q + deltas[1], 127)] * 2, max(y2ac, 8)),
            (_DC_TABLE[clip(q + deltas[3], 117)], _AC_TABLE[clip(q + deltas[4], 127)]),
        ))
    br.bit(128)   # refresh entropy probabilities: ignored, as libwebp does
    probs = [[[[0] * 11 for _ in range(3)] for _ in range(8)] for _ in range(4)]
    i = 0
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    probs[t][b][c][p] = br.value_bits(8) if br.bit(_COEFFS_UPDATE_PROBA[i]) else _COEFFS_PROBA0[i]
                    i += 1
    # per coefficient index: the band's three context rows
    hd.bands = [[probs[t][_BANDS[n]] for n in range(17)] for t in range(4)]
    hd.use_skip = br.bit(128)
    hd.skip_p = br.value_bits(8) if hd.use_skip else 0
    hd.br = br
    return hd


def _large_value(br: _Bool, p) -> int:
    if not br.bit(p[3]):
        return 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        v = 7 + 2 * br.bit(165)
        return v + br.bit(145)
    bit1 = br.bit(p[8])
    bit0 = br.bit(p[9 + bit1])
    cat = 2 * bit1 + bit0
    v = 0
    for prob in _CAT3456[cat]:
        v += v + br.bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(br: _Bool, bands, ctx: int, dq, n: int, out: List[int], base: int) -> int:
    """`GetCoeffs`: one block's tokens into out[base:base + 16]; returns
    the index after the last one read (16 after trailing zeros)."""
    p = bands[n][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = bands[n][0]
        nxt = bands[n + 1]
        if not br.bit(p[2]):
            v = 1
            p = nxt[1]
        else:
            v = _large_value(br, p)
            p = nxt[2]
        out[base + _ZIGZAG[n]] = (-v if br.bit(128) else v) * dq[n > 0]
        n += 1
    return 16


def _wht(dc: List[int]) -> List[int]:
    """`TransformWHT_C` -> the 16 DCs, block (row, column) order."""
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[4 * i] + 3
        a0, a1 = d + tmp[4 * i + 3], tmp[4 * i + 1] + tmp[4 * i + 2]
        a2, a3 = tmp[4 * i + 1] - tmp[4 * i + 2], d - tmp[4 * i + 3]
        out[4 * i], out[4 * i + 1], out[4 * i + 2], out[4 * i + 3] = \
            (a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3, (a3 - a2) >> 3
    return out


def _parse_macroblocks(hd):
    """Modes and dequantized coefficients of every macroblock, in raster
    order: (is_i4x4, modes, uv mode, segment, inner-edge filtering, coeffs)."""
    mbw, mbh = (hd.width + 15) >> 4, (hd.height + 15) >> 4
    br = hd.br
    intra_t = [_DC] * (4 * mbw)
    top_nz = [[0] * 9 for _ in range(mbw)]   # 4 y, 2 u, 2 v, dc
    mbs = []
    coeffs = np.zeros((mbh, mbw, 384), np.int32)
    for my in range(mbh):
        intra_l = [_DC] * 4
        left_nz = [0] * 9
        tbr = hd.parts[my & (len(hd.parts) - 1)]
        row = []
        for mx in range(mbw):
            # `ParseIntraMode`
            if hd.update_map:
                sp = hd.segment_probs
                segment = br.bit(sp[1]) if not br.bit(sp[0]) else br.bit(sp[2]) + 2
            else:
                segment = 0
            skip = br.bit(hd.skip_p) if hd.use_skip else 0
            is4 = not br.bit(145)
            top = intra_t[4 * mx:4 * mx + 4]
            if not is4:
                ymode = (_TM if br.bit(128) else _HE) if br.bit(156) else (_VE if br.bit(163) else _DC)
                modes = [ymode]
                top = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                modes = []
                for y in range(4):
                    ymode = intra_l[y]
                    for x in range(4):
                        prob = _BMODES_PROBA[(top[x] * 10 + ymode) * 9:(top[x] * 10 + ymode) * 9 + 9]
                        i = _YMODES_INTRA4[br.bit(prob[0])]
                        while i > 0:
                            i = _YMODES_INTRA4[2 * i + br.bit(prob[i])]
                        ymode = -i
                        top[x] = ymode
                    modes += top
                    intra_l[y] = ymode
            intra_t[4 * mx:4 * mx + 4] = top
            uvmode = _DC if not br.bit(142) else _VE if not br.bit(114) else _TM if br.bit(183) else _HE
            # `ParseResiduals`
            tn, ln = top_nz[mx], left_nz
            dq = hd.dq[segment]
            out = [0] * 384
            codes = []   # NzCodeBits per block: 0 none, else some
            if not skip or not hd.use_skip:
                if not is4:
                    dc = [0] * 16
                    nz = _coeffs(tbr, hd.bands[1], tn[8] + ln[8], dq[1], 0, dc, 0)
                    tn[8] = ln[8] = int(nz > 0)
                    for k, v in enumerate(_wht(dc)):
                        out[16 * k] = v
                    first, bands = 1, hd.bands[0]
                else:
                    first, bands = 0, hd.bands[3]
                for y in range(4):
                    lft = ln[y]
                    for x in range(4):
                        nz = _coeffs(tbr, bands, lft + tn[x], dq[0], first, out, 16 * (4 * y + x))
                        lft = tn[x] = int(nz > first)
                        codes.append(nz > 1 or out[16 * (4 * y + x)] != 0)
                    ln[y] = lft
                for ch in (0, 2):
                    for y in range(2):
                        lft = ln[4 + ch + y]
                        for x in range(2):
                            k = 16 + 2 * ch + 2 * y + x
                            nz = _coeffs(tbr, hd.bands[2], lft + tn[4 + ch + x], dq[2], 0, out, 16 * k)
                            lft = tn[4 + ch + x] = int(nz > 0)
                            codes.append(nz > 1 or out[16 * k] != 0)
                        ln[4 + ch + y] = lft
                inner = any(codes)
            else:
                for k in range(8):
                    tn[k] = ln[k] = 0
                if not is4:
                    tn[8] = ln[8] = 0
                inner = False
            coeffs[my, mx] = out
            row.append((is4, modes, uvmode, segment, inner))
        mbs.append(row)
    return mbs, coeffs


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct(c: np.ndarray) -> np.ndarray:
    """`TransformOne_C` on (..., 16) raster-order coefficients -> the
    (..., 4, 4) residual added to the prediction ((v >> 3), before the clip)."""
    c = c.reshape(c.shape[:-1] + (4, 4)).astype(np.int64)
    v0, v1, v2, v3 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]   # rows; columns vectorized
    a, b = v0 + v2, v0 - v2
    cc, d = _mul2(v1) - _mul1(v3), _mul1(v1) + _mul2(v3)
    t = np.stack([a + d, b + cc, b - cc, a - d], -1)   # (..., column, k)
    u0, u1, u2, u3 = t[..., 0, :], t[..., 1, :], t[..., 2, :], t[..., 3, :]   # per output row k
    dc = u0 + 4
    a, b = dc + u2, dc - u2
    cc, d = _mul2(u1) - _mul1(u3), _mul1(u1) + _mul2(u3)
    return (np.stack([a + d, b + cc, b - cc, a - d], -1) >> 3).astype(np.int32)


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, top: List[int], left: List[int], x: int) -> List[List[int]]:
    """A 4x4 prediction: `top` = 8 samples above (4 above-right), `left`
    = 4 samples, `x` the sample above-left."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    if mode == _DC:
        v = (sum(top[:4]) + sum(left) + 4) >> 3
        return [[v] * 4 for _ in range(4)]
    if mode == _TM:
        return [[min(255, max(0, l + t - x)) for t in top[:4]] for l in left]
    if mode == _VE:
        row = [_avg3(x, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return [row[:] for _ in range(4)]
    if mode == _HE:
        return [[v] * 4 for v in (_avg3(x, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L))]
    d = [[0] * 4 for _ in range(4)]   # d[y][x]
    if mode == _RD:
        vals = [_avg3(J, K, L), _avg3(I, J, K), _avg3(x, I, J), _avg3(A, x, I), _avg3(B, A, x), _avg3(C, B, A),
                _avg3(D, C, B)]
        for y in range(4):
            for xx in range(4):
                d[y][xx] = vals[3 - y + xx]
        return d
    if mode == _LD:
        vals = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F), _avg3(E, F, G), _avg3(F, G, H),
                _avg3(G, H, H)]
        for y in range(4):
            for xx in range(4):
                d[y][xx] = vals[y + xx]
        return d
    if mode == _VR:
        d[0][0] = d[2][1] = _avg2(x, A)
        d[0][1] = d[2][2] = _avg2(A, B)
        d[0][2] = d[2][3] = _avg2(B, C)
        d[0][3] = _avg2(C, D)
        d[3][0] = _avg3(K, J, I)
        d[2][0] = _avg3(J, I, x)
        d[1][0] = d[3][1] = _avg3(I, x, A)
        d[1][1] = d[3][2] = _avg3(x, A, B)
        d[1][2] = d[3][3] = _avg3(A, B, C)
        d[1][3] = _avg3(B, C, D)
        return d
    if mode == _VL:
        d[0][0] = _avg2(A, B)
        d[0][1] = d[2][0] = _avg2(B, C)
        d[0][2] = d[2][1] = _avg2(C, D)
        d[0][3] = d[2][2] = _avg2(D, E)
        d[1][0] = _avg3(A, B, C)
        d[1][1] = d[3][0] = _avg3(B, C, D)
        d[1][2] = d[3][1] = _avg3(C, D, E)
        d[1][3] = d[3][2] = _avg3(D, E, F)
        d[2][3] = _avg3(E, F, G)
        d[3][3] = _avg3(F, G, H)
        return d
    if mode == _HD:
        d[0][0] = d[1][2] = _avg2(I, x)
        d[1][0] = d[2][2] = _avg2(J, I)
        d[2][0] = d[3][2] = _avg2(K, J)
        d[3][0] = _avg2(L, K)
        d[0][3] = _avg3(A, B, C)
        d[0][2] = _avg3(x, A, B)
        d[0][1] = d[1][3] = _avg3(I, x, A)
        d[1][1] = d[2][3] = _avg3(x, I, J)
        d[2][1] = d[3][3] = _avg3(I, J, K)
        d[3][1] = _avg3(J, K, L)
        return d
    # _HU
    d[0][0] = _avg2(I, J)
    d[0][2] = d[1][0] = _avg2(J, K)
    d[1][2] = d[2][0] = _avg2(K, L)
    d[0][1] = _avg3(I, J, K)
    d[0][3] = d[1][1] = _avg3(J, K, L)
    d[1][3] = d[2][1] = _avg3(K, L, L)
    d[2][3] = d[2][2] = d[3][0] = d[3][1] = d[3][2] = d[3][3] = L
    return d


def _pred_block(mode: int, top: np.ndarray, left: np.ndarray, x: int, size: int, mx: int, my: int) -> np.ndarray:
    """16x16 or 8x8 DC (with `CheckMode`'s edge variants), TM, V and H."""
    if mode == _DC:
        shift = 4 if size == 8 else 5
        if mx and my:
            v = (int(top.sum()) + int(left.sum()) + (1 << (shift - 1))) >> shift
        elif my:
            v = (int(top.sum()) + (1 << (shift - 2))) >> (shift - 1)
        elif mx:
            v = (int(left.sum()) + (1 << (shift - 2))) >> (shift - 1)
        else:
            v = 128
        return np.full((size, size), v, np.int32)
    if mode == _TM:
        return np.clip(left[:, None].astype(np.int32) + top[None, :] - x, 0, 255)
    if mode == _VE:
        return np.broadcast_to(top[None, :], (size, size)).astype(np.int32)
    return np.broadcast_to(left[:, None], (size, size)).astype(np.int32)


def _edges(plane: np.ndarray, y0: int, x0: int, size: int, my: int, mx: int):
    top = plane[y0 - 1, x0:x0 + size].astype(np.int32) if my else np.full(size, 127, np.int32)
    left = plane[y0:y0 + size, x0 - 1].astype(np.int32) if mx else np.full(size, 129, np.int32)
    tl = int(plane[y0 - 1, x0 - 1]) if my and mx else (127 if not my else 129)
    return top, left, tl


def _reconstruct(hd, mbs, coeffs):
    mbw, mbh = (hd.width + 15) >> 4, (hd.height + 15) >> 4
    res = _idct(coeffs.reshape(mbh, mbw, 24, 16))   # (mbh, mbw, 24, 4, 4)
    ry = res[:, :, :16].reshape(mbh, mbw, 4, 4, 4, 4).transpose(0, 1, 2, 4, 3, 5).reshape(mbh, mbw, 16, 16)
    ru = res[:, :, 16:20].reshape(mbh, mbw, 2, 2, 4, 4).transpose(0, 1, 2, 4, 3, 5).reshape(mbh, mbw, 8, 8)
    rv = res[:, :, 20:24].reshape(mbh, mbw, 2, 2, 4, 4).transpose(0, 1, 2, 4, 3, 5).reshape(mbh, mbw, 8, 8)
    Y = np.zeros((16 * mbh, 16 * mbw), np.uint8)
    U = np.zeros((8 * mbh, 8 * mbw), np.uint8)
    V = np.zeros((8 * mbh, 8 * mbw), np.uint8)
    for my in range(mbh):
        for mx in range(mbw):
            is4, modes, uvmode, _, _ = mbs[my][mx]
            y0, x0 = 16 * my, 16 * mx
            top, left, tl = _edges(Y, y0, x0, 16, my, mx)
            if is4:
                if my:
                    tr = Y[y0 - 1, x0 + 16:x0 + 20].tolist() if mx < mbw - 1 else [int(Y[y0 - 1, x0 + 15])] * 4
                else:
                    tr = [127] * 4
                # a 17 x 21 working buffer: row 0 above the macroblock, column 0 left of it
                buf = [[0] * 21 for _ in range(17)]
                buf[0] = [tl] + top.tolist() + tr
                for j in range(16):
                    buf[1 + j][0] = int(left[j])
                for r in (4, 8, 12):
                    buf[r][17:21] = tr
                resid = ry[my, mx].tolist()
                for n in range(16):
                    by, bx = n >> 2, n & 3
                    r0, c0 = 4 * by, 4 * bx
                    t8 = buf[r0][c0 + 1:c0 + 9]
                    lf = [buf[r0 + 1 + k][c0] for k in range(4)]
                    p = _pred4(modes[n], t8, lf, buf[r0][c0])
                    for k in range(4):
                        rr = resid[r0 + k]
                        line = buf[r0 + 1 + k]
                        for j in range(4):
                            v = p[k][j] + rr[c0 + j]
                            line[c0 + 1 + j] = 0 if v < 0 else 255 if v > 255 else v
                Y[y0:y0 + 16, x0:x0 + 16] = np.array([line[1:17] for line in buf[1:17]], np.uint8)
            else:
                p = _pred_block(modes[0], top, left, tl, 16, mx, my)
                Y[y0:y0 + 16, x0:x0 + 16] = np.clip(p + ry[my, mx], 0, 255)
            for plane, r in ((U, ru), (V, rv)):
                t, lf, c = _edges(plane, 8 * my, 8 * mx, 8, my, mx)
                p = _pred_block(uvmode, t, lf, c, 8, mx, my)
                plane[8 * my:8 * my + 8, 8 * mx:8 * mx + 8] = np.clip(p + r[my, mx], 0, 255)
    return Y, U, V


def _strengths(hd):
    """`PrecomputeFilterStrengths`: (limit, interior limit, hev threshold)
    per segment and per i4x4 flag; limit 0 means no filtering."""
    out = []
    for s in range(4):
        base = hd.level
        if hd.use_segment:
            base = hd.filter_strength[s] + (0 if hd.absolute_delta else hd.level)
        per = []
        for i4 in (0, 1):
            level = base
            if hd.use_lf_delta:
                level += hd.ref_lf_delta[0]
                if i4:
                    level += hd.mode_lf_delta[0]
            level = 0 if level < 0 else 63 if level > 63 else level
            if level > 0:
                ilevel = level
                if hd.sharpness > 0:
                    ilevel >>= 2 if hd.sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - hd.sharpness)
                ilevel = max(ilevel, 1)
                per.append((2 * level + ilevel, ilevel, 2 if level >= 40 else 1 if level >= 15 else 0))
            else:
                per.append((0, 0, 0))
        out.append(per)
    return out


def _filter_line(P: np.ndarray, thresh: int, ithresh: int, hev_t: int, kind: str) -> None:
    """One edge, in place: P is (8, n) int32, rows p3 p2 p1 p0 q0 q1 q2 q3.
    kind: "simple" (`SimpleVFilter16_C`), "mb" (`FilterLoop26_C`) or
    "inner" (`FilterLoop24_C`)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = P
    t2 = 2 * thresh + 1
    need = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= t2
    if kind != "simple":
        need &= ((np.abs(p3 - p2) <= ithresh) & (np.abs(p2 - p1) <= ithresh) & (np.abs(p1 - p0) <= ithresh)
                 & (np.abs(q3 - q2) <= ithresh) & (np.abs(q2 - q1) <= ithresh) & (np.abs(q1 - q0) <= ithresh))
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    else:
        hev = np.ones_like(need)
    if not need.any():
        return
    # DoFilter2 where hev (always for the simple filter)
    f2 = need & hev
    a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
    a1 = np.clip((a + 4) >> 3, -16, 15)
    a2 = np.clip((a + 3) >> 3, -16, 15)
    np0 = np.where(f2, np.clip(p0 + a2, 0, 255), p0)
    nq0 = np.where(f2, np.clip(q0 - a1, 0, 255), q0)
    np1, nq1, np2, nq2 = p1, q1, p2, q2
    rest = need & ~hev
    if kind == "mb" and rest.any():
        a = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
        b1, b2, b3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        np2 = np.where(rest, np.clip(p2 + b3, 0, 255), p2)
        np1 = np.where(rest, np.clip(p1 + b2, 0, 255), p1)
        np0 = np.where(rest, np.clip(p0 + b1, 0, 255), np0)
        nq0 = np.where(rest, np.clip(q0 - b1, 0, 255), nq0)
        nq1 = np.where(rest, np.clip(q1 - b2, 0, 255), q1)
        nq2 = np.where(rest, np.clip(q2 - b3, 0, 255), q2)
    elif kind == "inner" and rest.any():
        a = 3 * (q0 - p0)
        b1 = np.clip((a + 4) >> 3, -16, 15)
        b2 = np.clip((a + 3) >> 3, -16, 15)
        b3 = (b1 + 1) >> 1
        np1 = np.where(rest, np.clip(p1 + b3, 0, 255), p1)
        np0 = np.where(rest, np.clip(p0 + b2, 0, 255), np0)
        nq0 = np.where(rest, np.clip(q0 - b1, 0, 255), nq0)
        nq1 = np.where(rest, np.clip(q1 - b3, 0, 255), q1)
    P[1], P[2], P[3], P[4], P[5], P[6] = np2, np1, np0, nq0, nq1, nq2


def _filter_edges(plane: np.ndarray, r0: np.ndarray, c0: np.ndarray, across: bool, n: int,
                  params: Tuple[np.ndarray, np.ndarray, np.ndarray], kind: str) -> None:
    """One edge of each macroblock listed (disjoint regions), in place.
    `across` False: a horizontal edge above row r0, columns c0 .. c0 + n
    (`VFilter`); True: a vertical edge left of column c0, rows r0 .. r0 + n
    (`HFilter`)."""
    if not len(r0):
        return
    k = np.arange(n)
    off = np.arange(-4, 4)
    if across:
        rr = (r0[:, None] + k).reshape(-1)[None, :]
        cc = np.repeat(c0, n)[None, :] + off[:, None]
        rr = np.broadcast_to(rr, cc.shape)
    else:
        cc = (c0[:, None] + k).reshape(-1)[None, :]
        rr = np.repeat(r0, n)[None, :] + off[:, None]
        cc = np.broadcast_to(cc, rr.shape)
    P = plane[rr, cc].astype(np.int32)
    _filter_line(P, *(np.repeat(a, n) for a in params), kind)
    plane[rr, cc] = P


def _loop_filter(hd, mbs, Y, U, V) -> None:
    """`DoFilter` on every macroblock as libwebp runs it in raster order.
    A macroblock's filters reach 4 samples past its left and top edges, so
    the macroblocks with the same 2 * row + column touch disjoint samples
    and depend only on lower ones: each such wave is filtered at once, edge
    by edge in `DoFilter`'s order."""
    if hd.filter_type == 0:
        return
    strengths = _strengths(hd)
    mbh, mbw = len(mbs), len(mbs[0])
    lim = np.zeros((mbh, mbw), np.int32)
    ilv = np.zeros((mbh, mbw), np.int32)
    hev = np.zeros((mbh, mbw), np.int32)
    inner = np.zeros((mbh, mbw), bool)
    for my, row in enumerate(mbs):
        for mx, (is4, _, _, segment, nz) in enumerate(row):
            lim[my, mx], ilv[my, mx], hev[my, mx] = strengths[segment][int(is4)]
            inner[my, mx] = nz or is4
    ys, xs = np.nonzero(lim > 0)
    wave = 2 * ys + xs
    order = np.argsort(wave, kind="stable")
    ys, xs, wave = ys[order], xs[order], wave[order]
    cuts = np.flatnonzero(np.diff(wave)) + 1
    simple = hd.filter_type == 1
    # U and V side by side: one call filters both
    UV = np.concatenate([U, V], axis=1)
    half = U.shape[1]
    for y, x in zip(np.split(ys, cuts), np.split(xs, cuts)):
        L, I, H, inn = lim[y, x], ilv[y, x], hev[y, x], inner[y, x]
        left, top = x > 0, y > 0
        kind_mb, kind_in = ("simple", "simple") if simple else ("mb", "inner")
        mb_p = lambda m: (L[m] + 4, I[m], H[m])   # noqa: E731
        in_p = lambda m: (L[m], I[m], H[m])   # noqa: E731
        uvr = lambda m: np.concatenate([8 * y[m], 8 * y[m]])   # noqa: E731
        uvc = lambda m, k: np.concatenate([8 * x[m] + k, half + 8 * x[m] + k])   # noqa: E731
        uvp = lambda ps: tuple(np.concatenate([a, a]) for a in ps)   # noqa: E731
        _filter_edges(Y, 16 * y[left], 16 * x[left], True, 16, mb_p(left), kind_mb)
        if not simple:
            _filter_edges(UV, uvr(left), uvc(left, 0), True, 8, uvp(mb_p(left)), "mb")
        for k in (4, 8, 12):
            _filter_edges(Y, 16 * y[inn], 16 * x[inn] + k, True, 16, in_p(inn), kind_in)
        if not simple:
            _filter_edges(UV, uvr(inn), uvc(inn, 4), True, 8, uvp(in_p(inn)), "inner")
        _filter_edges(Y, 16 * y[top], 16 * x[top], False, 16, mb_p(top), kind_mb)
        if not simple:
            _filter_edges(UV, np.concatenate([8 * y[top]] * 2), uvc(top, 0), False, 8, uvp(mb_p(top)), "mb")
        for k in (4, 8, 12):
            _filter_edges(Y, 16 * y[inn] + k, 16 * x[inn], False, 16, in_p(inn), kind_in)
        if not simple:
            _filter_edges(UV, np.concatenate([8 * y[inn] + 4] * 2), uvc(inn, 0), False, 8, uvp(in_p(inn)), "inner")
    U[:] = UV[:, :half]
    V[:] = UV[:, half:]


def _upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """`UpsampleRgbaLinePair`'s chroma for every output pixel: (h, w)."""
    c = c.astype(np.int32)
    r = np.arange(h)
    k = (r + 1) >> 1
    T = c[np.clip(k - 1, 0, c.shape[0] - 1)]
    C = c[np.clip(k, 0, c.shape[0] - 1)]
    near_top = (r % 2 == 1) | (r == 0)
    Nv = np.where(near_top[:, None], T, C)   # the nearer chroma row
    Fv = np.where(near_top[:, None], C, T)   # the farther one
    x = np.arange(w)
    j = (x + 1) >> 1
    nc = c.shape[1]
    left = np.clip(j - 1, 0, nc - 1)
    right = np.clip(j, 0, nc - 1)
    near_left = (x % 2 == 1)
    ni = np.where(near_left, left, right)
    fi = np.where(near_left, right, left)
    N, A1, A2, O = Nv[:, ni], Nv[:, fi], Fv[:, ni], Fv[:, fi]
    diag = (N + 3 * A1 + 3 * A2 + O + 8) >> 3
    out = (diag + N) >> 1
    # the first column, and the last when w is even: (3 * near + far + 2) >> 2 vertically only
    edge = np.zeros(w, bool)
    edge[0] = True
    if w % 2 == 0:
        edge[-1] = True
    col = np.where(x == 0, 0, (w - 1) >> 1)[edge]
    out[:, edge] = (3 * Nv[:, col] + Fv[:, col] + 2) >> 2
    return out


def _yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """`yuv.h` `VP8YuvToRgb`: 14-bit fixed point, `MultHi(v, c) = v * c >> 8`."""
    y, u, v = y.astype(np.int32), u.astype(np.int32), v.astype(np.int32)
    yy = (y * 19077) >> 8
    r = yy + ((v * 26149) >> 8) - 14234
    g = yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708
    b = yy + ((u * 33050) >> 8) - 17685
    return np.clip(np.stack([r, g, b], -1) >> 6, 0, 255).astype(np.uint8)


def decode_vp8(data: bytes) -> np.ndarray:
    """A `VP8 ` chunk's payload -> (h, w, 3) uint8 RGB, as libwebp's
    fancy-upsampling RGBA output gives it."""
    hd = _parse_header(data)
    mbs, coeffs = _parse_macroblocks(hd)
    Y, U, V = _reconstruct(hd, mbs, coeffs)
    _loop_filter(hd, mbs, Y, U, V)
    w, h = hd.width, hd.height
    uw, uh = (w + 1) >> 1, (h + 1) >> 1
    u = _upsample(U[:uh, :uw], h, w)
    v = _upsample(V[:uh, :uw], h, w)
    return _yuv_to_rgb(Y[:h, :w], u, v)
