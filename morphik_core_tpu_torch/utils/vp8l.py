"""WebP lossless (VP8L) decoding in the stdlib and numpy, to libwebp
1.6's `src/dec/vp8l_dec.c` and `src/dsp/lossless.c`.

The bitstream (RFC 9649): a 5-byte header (signature 0x2f, 14-bit width
and height less one, the alpha hint, a 3-bit version), then the
transforms in the order they were applied by the encoder -- predictor
(14 modes over blocks), cross-colour (green-to-red, green-to-blue and
red-to-blue multipliers per block, `ColorTransformDelta`: signed product
>> 5), subtract-green, and colour indexing (a delta-coded palette of up
to 256 entries, with 2, 4 or 8 pixels bundled in one when it holds at
most 16 colours) -- each at most once and undone in reverse order; then
the entropy-coded image: an optional colour cache (hash 0x1e35a7bd), an
optional meta prefix-code image choosing one of several groups of five
canonical prefix codes per block (green + length + cache, red, blue,
alpha, distance), and LZ77 backward references whose distance codes
below 121 map to 2D offsets (`kCodeToPlane`). Sub-images (transform
data, the meta image, an ALPH chunk's data) are the same stream without
transforms or meta codes.

The entropy decoding is serial Python; the colour transforms, the
palette and subtract-green run over whole images in numpy; the
predictor runs row by row, the modes that do not read the left pixel
over a whole row at once.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_CODE_TO_PLANE = (
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4, 71, 73, 20, 28, 53,
    59, 70, 74, 36, 44, 88, 69, 75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103,
    105, 18, 30, 102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31, 100, 108,
    66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115,
    125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112)
_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_ROOT = 8


class _Bits:
    """LSB-first bit reader over a bytes object."""
    __slots__ = ("data", "pos", "end")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = bytes(data) + bytes(8)
        self.pos = 8 * pos
        self.end = 8 * len(data)

    def read(self, n: int) -> int:
        p = self.pos
        i = p >> 3
        v = int.from_bytes(self.data[i:i + 4], "little") >> (p & 7)
        self.pos = p + n
        if self.pos > self.end:
            raise ValueError("truncated WebP lossless data")
        return v & ((1 << n) - 1)


class _Code:
    """A canonical prefix code as a two-level lookup (8 root bits, then a
    second level per long prefix): entries are symbol << 4 | length, or a
    link (negative: -(offset << 4 | extra bits))."""
    __slots__ = ("table", "single")

    def __init__(self, lengths: List[int]):
        nz = [(s, l) for s, l in enumerate(lengths) if l]
        if not nz:
            raise ValueError("WebP lossless prefix code has no symbols")
        if len(nz) == 1:
            self.single = nz[0][0]
            self.table = None
            return
        self.single = -1
        count = [0] * 16
        for _, l in nz:
            count[l] += 1
        code, next_code = 0, [0] * 16
        for l in range(1, 16):
            code = (code + count[l - 1]) << 1
            next_code[l] = code
        # Kraft: a complete code, as libwebp's `BuildHuffmanTable` demands
        if sum(count[l] << (15 - l) for l in range(1, 16)) != 1 << 15:
            raise ValueError("WebP lossless prefix code is not complete")
        table: List[int] = [0] * (1 << _ROOT)
        long_codes = {}
        for s, l in nz:
            c = next_code[l]
            next_code[l] += 1
            rev = int(f"{c:0{l}b}"[::-1], 2)
            if l <= _ROOT:
                for j in range(rev, 1 << _ROOT, 1 << l):
                    table[j] = s << 4 | l
            else:
                long_codes.setdefault(rev & ((1 << _ROOT) - 1), []).append((rev >> _ROOT, l - _ROOT, s))
        for root, codes in long_codes.items():
            extra = max(l for _, l, _ in codes)
            off = len(table)
            table += [0] * (1 << extra)
            for rest, l, s in codes:
                for j in range(rest, 1 << extra, 1 << l):
                    table[off + j] = s << 4 | l
            table[root] = -(off << 4 | extra)
        self.table = table

    def read(self, br: _Bits) -> int:
        if self.table is None:
            return self.single
        p = br.pos
        i = p >> 3
        v = int.from_bytes(br.data[i:i + 4], "little") >> (p & 7)
        e = self.table[v & 0xFF]
        if e >= 0:
            br.pos = p + (e & 15)
        else:
            e = -e
            e = self.table[(e >> 4) + ((v >> _ROOT) & ((1 << (e & 15)) - 1))]
            br.pos = p + _ROOT + (e & 15)
        if br.pos > br.end:
            raise ValueError("truncated WebP lossless data")
        return e >> 4


def _read_code(br: _Bits, alphabet: int) -> _Code:
    """`ReadHuffmanCode`: a simple code of one or two symbols, or code
    lengths coded with a code-length code."""
    lengths = [0] * alphabet
    if br.read(1):
        n = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        if first >= alphabet:
            raise ValueError("WebP lossless simple code symbol out of range")
        lengths[first] = 1
        if n == 2:
            second = br.read(8)
            if second >= alphabet:
                raise ValueError("WebP lossless simple code symbol out of range")
            lengths[second] = 1
        return _Code(lengths)
    cl = [0] * 19
    for i in range(br.read(4) + 4):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    cl_code = _Code(cl)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise ValueError("WebP lossless code lengths past the alphabet")
    else:
        max_symbol = alphabet
    prev, s = 8, 0
    while s < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = cl_code.read(br)
        if c < 16:
            lengths[s] = c
            s += 1
            if c:
                prev = c
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
            repeat = br.read(extra) + offset
            if s + repeat > alphabet:
                raise ValueError("WebP lossless code lengths past the alphabet")
            lengths[s:s + repeat] = [prev if c == 16 else 0] * repeat
            s += repeat
    return _Code(lengths)


def _prefix_value(sym: int, br: _Bits) -> int:
    """`GetCopyDistance`: a length or distance prefix symbol and its extra bits."""
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _decode_entropy(br: _Bits, w: int, h: int, level0: bool) -> np.ndarray:
    """`DecodeImageStream` after the transforms: (h, w) uint32 ARGB."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError("WebP lossless colour cache size out of range")
    meta_bits, meta, meta_w = 0, None, 0
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        meta_w = -(-w // (1 << meta_bits))
        sub = _decode_entropy(br, meta_w, -(-h // (1 << meta_bits)), False)
        meta = ((sub >> 8) & 0xFFFF).astype(np.int64).reshape(-1).tolist()
    groups = (max(meta) + 1) if meta else 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    codes = []
    for _ in range(groups):
        codes.append([_read_code(br, a) for a in (256 + 24 + cache_size, 256, 256, 256, 40)])
    out = [0] * (w * h)
    cache = [0] * cache_size
    shift = 32 - cache_bits
    mask = (1 << meta_bits) - 1 if meta_bits else -1
    pos, total = 0, w * h
    x = y = 0
    group = codes[0]
    while pos < total:
        if meta is not None and (x & mask) == 0:
            group = codes[meta[(y >> meta_bits) * meta_w + (x >> meta_bits)]]
        g = group[0].read(br)
        if g < 256:
            r = group[1].read(br)
            b = group[2].read(br)
            a = group[3].read(br)
            px = (a << 24) | (r << 16) | (g << 8) | b
            out[pos] = px
            if cache_size:
                cache[((px * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = px
            pos += 1
            x += 1
            if x >= w:
                x = 0
                y += 1
        elif g < 280:
            length = _prefix_value(g - 256, br)
            code = _prefix_value(group[4].read(br), br)
            if code > 120:
                dist = code - 120
            else:
                d = _CODE_TO_PLANE[code - 1]
                dist = max(1, (d >> 4) * w + 8 - (d & 15))
            if dist > pos or length > total - pos:
                raise ValueError("WebP lossless backward reference out of the image")
            src = pos - dist
            if dist >= length:
                seg = out[src:src + length]
            else:   # an overlapping copy repeats the last `dist` pixels
                seg = (out[src:pos] * (length // dist + 1))[:length]
            out[pos:pos + length] = seg
            if cache_size:
                # the cache keeps the last pixel of each hash: in a periodic
                # copy every value recurs within its last period
                for px in seg[-dist:] if dist < length else seg:
                    cache[((px * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = px
            pos += length
            x += length
            while x >= w:
                x -= w
                y += 1
            if meta is not None and x & mask:
                group = codes[meta[(y >> meta_bits) * meta_w + (x >> meta_bits)]]
        else:
            if g - 280 >= cache_size:
                raise ValueError("WebP lossless colour cache index out of range")
            px = cache[g - 280]
            out[pos] = px
            pos += 1
            x += 1
            if x >= w:
                x = 0
                y += 1
    return np.array(out, np.uint32).reshape(h, w)


def _channels(argb: np.ndarray) -> np.ndarray:
    """uint32 ARGB -> (..., 4) int32 in the order A, R, G, B."""
    return np.stack([(argb >> s) & 0xFF for s in (24, 16, 8, 0)], -1).astype(np.int32)


def _pack(ch: np.ndarray) -> np.ndarray:
    ch = ch.astype(np.uint32) & 0xFF
    return (ch[..., 0] << 24) | (ch[..., 1] << 16) | (ch[..., 2] << 8) | ch[..., 3]


def _avg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a + b) >> 1


def _predict_free(mode: int, t, tr, tl):
    """The modes that do not read the left pixel, on (n, 4) channel rows."""
    if mode == 2:
        return t
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 8:
        return _avg(tl, t)
    if mode == 9:
        return _avg(t, tr)
    return np.broadcast_to(np.array([255, 0, 0, 0], np.int32), t.shape)   # 0, and 14 / 15 as libwebp maps them


_LEFT_FREE = (0, 2, 3, 4, 8, 9, 14, 15)


def _avg2(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _clip(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _predict_left(mode: int, l: int, t: int, tr: int, tl: int) -> int:
    """`lossless.c`'s predictors that read the left pixel, on packed ARGB."""
    if mode == 1:
        return l
    if mode == 5:
        return _avg2(_avg2(l, tr), t)
    if mode == 6:
        return _avg2(l, tl)
    if mode == 7:
        return _avg2(l, t)
    if mode == 10:
        return _avg2(_avg2(l, tl), _avg2(t, tr))
    out = 0
    if mode == 11:   # Select: T when the summed |L - TL| - |T - TL| is at most 0
        d = 0
        for sh in (24, 16, 8, 0):
            c = (tl >> sh) & 0xFF
            d += abs(((l >> sh) & 0xFF) - c) - abs(((t >> sh) & 0xFF) - c)
        return t if d <= 0 else l
    if mode == 12:
        for sh in (24, 16, 8, 0):
            out |= _clip(((l >> sh) & 0xFF) + ((t >> sh) & 0xFF) - ((tl >> sh) & 0xFF)) << sh
        return out
    a = _avg2(l, t)   # 13: ClampedAddSubtractHalf, C division toward zero
    for sh in (24, 16, 8, 0):
        c = (a >> sh) & 0xFF
        d = c - ((tl >> sh) & 0xFF)
        out |= _clip(c + (d // 2 if d >= 0 else -((-d) // 2))) << sh
    return out


def _add(a: int, b: int) -> int:
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _unpredict(res: np.ndarray, bits: int, modes: np.ndarray) -> np.ndarray:
    """Undo the predictor transform on (h, w, 4) residuals (A, R, G, B):
    black for the first pixel, L along row 0, T down column 0, and each
    block's mode elsewhere; the TR of a row's last pixel is that row's
    first pixel (the next one in memory)."""
    h, w, _ = res.shape
    out = np.zeros_like(res)
    out[0] = np.cumsum(res[0], axis=0) & 0xFF
    out[0, :, 0] = (np.cumsum(res[0, :, 0]) + 255) & 0xFF
    col_mode = np.repeat(modes, 1 << bits, axis=1)[:, :w]
    for y in range(1, h):
        top = out[y - 1]
        row = out[y]
        row[0] = (res[y, 0] + top[0]) & 0xFF
        m = col_mode[y >> bits]
        free = np.isin(m, _LEFT_FREE)
        free[0] = False
        if free.any():
            tr_all = np.concatenate([top[1:], row[:1]], 0)
            tl_all = np.concatenate([top[:1], top[:-1]], 0)
            for mode in np.unique(m[free]).tolist():
                sel = np.nonzero(free & (m == mode))[0]
                row[sel] = (res[y, sel] + _predict_free(mode, top[sel], tr_all[sel], tl_all[sel])) & 0xFF
        serial = np.nonzero(~free)[0][1:].tolist()
        if serial:
            tp = _pack(top).tolist()
            rp = _pack(row).tolist()
            rs = _pack(res[y]).tolist()
            ms = m.tolist()
            for x in serial:
                tr = rp[0] if x == w - 1 else tp[x + 1]
                rp[x] = _add(rs[x], _predict_left(ms[x], rp[x - 1], tp[x], tr, tp[x - 1]))
            row[serial] = _channels(np.array([rp[x] for x in serial], np.uint32))
    return out


def _color_inverse(px: np.ndarray, bits: int, data: np.ndarray) -> np.ndarray:
    h, w, _ = px.shape
    m = np.repeat(np.repeat(_channels(data), 1 << bits, 0), 1 << bits, 1)[:h, :w]
    s8 = lambda v: ((v.astype(np.int32) + 128) & 0xFF) - 128   # noqa: E731
    g2r, g2b, r2b = s8(m[..., 3]), s8(m[..., 2]), s8(m[..., 1])
    green = s8(px[..., 2])
    red = (px[..., 1] + ((g2r * green) >> 5)) & 0xFF
    blue = (px[..., 3] + ((g2b * green) >> 5) + ((r2b * s8(red)) >> 5)) & 0xFF
    out = px.copy()
    out[..., 1], out[..., 3] = red, blue
    return out


def decode_vp8l_stream(data: bytes, w: int, h: int, pos: int = 0) -> np.ndarray:
    """A VP8L image stream (after the 5-byte header, or an ALPH chunk's
    data) of a `w` x `h` image -> (h, w, 4) uint8 in the order R, G, B, A."""
    br = _Bits(data, pos)
    transforms: List[Tuple] = []
    xsize = w
    seen = set()
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise ValueError("WebP lossless transform used twice")
        seen.add(kind)
        if kind in (0, 1):
            bits = br.read(3) + 2
            sub = _decode_entropy(br, -(-xsize // (1 << bits)), -(-h // (1 << bits)), False)
            transforms.append((kind, bits, sub))
        elif kind == 2:
            transforms.append((2,))
        else:
            n = br.read(8) + 1
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            pal = _decode_entropy(br, n, 1, False)
            transforms.append((3, bits, pal, xsize))
            xsize = -(-xsize // (1 << bits))
    px = _channels(_decode_entropy(br, xsize, h, True))
    for t in reversed(transforms):
        if t[0] == 0:
            _, bits, sub = t
            px = _unpredict(px, bits, ((sub >> 8) & 0xF).astype(np.int64))
        elif t[0] == 1:
            px = _color_inverse(px, t[1], t[2])
        elif t[0] == 2:
            px = px.copy()
            px[..., 1] = (px[..., 1] + px[..., 2]) & 0xFF
            px[..., 3] = (px[..., 3] + px[..., 2]) & 0xFF
        else:
            _, bits, pal, xs = t
            pc = _channels(pal)[0]
            pc = np.cumsum(pc, axis=0) & 0xFF   # delta-coded palette (`ExpandColorMap`)
            size = 1 << (8 >> bits) if bits else 256
            lut = np.zeros((max(size, 256), 4), np.int32)
            lut[:min(len(pc), size)] = pc[:size]
            g = px[..., 2]
            if bits:
                per = 1 << bits
                width = 8 >> bits
                xs_idx = np.arange(xs)
                idx = (g[:, xs_idx >> bits] >> ((xs_idx & (per - 1)) * width)) & ((1 << width) - 1)
            else:
                idx = g[:, :xs]
            px = lut[idx]
    out = np.empty((h, w, 4), np.uint8)
    out[..., 0], out[..., 1], out[..., 2], out[..., 3] = px[..., 1], px[..., 2], px[..., 3], px[..., 0]
    return out


def vp8l_header(data: bytes) -> Tuple[int, int, bool]:
    """(width, height, alpha hint) of a VP8L chunk's payload."""
    if len(data) < 5 or data[0] != 0x2F:
        raise ValueError("not a WebP lossless stream (bad signature)")
    v = int.from_bytes(data[1:5], "little")
    if v >> 29:
        raise ValueError("unknown WebP lossless version")
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, bool((v >> 28) & 1)


def decode_vp8l(data: bytes) -> np.ndarray:
    """A VP8L chunk's payload -> (h, w, 4) uint8 RGBA."""
    w, h, _ = vp8l_header(data)
    return decode_vp8l_stream(data, w, h, 5)
