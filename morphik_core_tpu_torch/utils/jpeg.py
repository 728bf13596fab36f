"""Baseline JPEG in numpy: the page-payload codec of the port's service
plane (the card's machine has no PIL).

Three parts, each bit-identical to Pillow built on libjpeg-turbo:

- `encode_jpeg(pixels, quality)`: the bytes of `Image.save(buf, "JPEG",
  quality=q)` for an RGB or L image. Markers in libjpeg's order (SOI,
  APP0 JFIF, one DQT per table, SOF0, one DHT per table, SOS, EOI);
  `jpeg_quality_scaling` with `force_baseline`; libjpeg-turbo's
  fixed-point RGB->YCbCr tables; 4:2:0 `h2v2_downsample` with its
  alternating 1/2 bias; edge replication and the dummy blocks of
  `jccoefct.c` to whole MCUs; the islow forward DCT (`jfdctint.c`) and
  the reciprocal quantizer of `jcdctmgr.c`; the standard Huffman
  tables, 0xFF stuffing and 1-bit padding. It also returns the
  quantized coefficients.
- `decode_own(coeffs)`: what libjpeg-turbo's default decode gives for
  those coefficients (dequantize, the islow IDCT of `jidctint.c`, fancy
  upsampling of `jdsample.c`, YCbCr->RGB), so an encode followed by a
  decode of the same page costs no Huffman decode.
- `read_jpeg(data)` / `decode_jpeg(data)`: a decoder for uploads and
  query images: SOF0/SOF1 Huffman, 8-bit, 1 or 3 components in one scan,
  sampling factors up to 2x2, DRI with RST markers; APPn and COM are
  skipped. Progressive, arithmetic-coded, lossless, 12-bit, CMYK and
  multi-scan files raise `UnsupportedJpeg`, which names ROADMAP Queue 1
  item 3b-ii.
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Tuple

import numpy as np

ROADMAP_ITEM = "ROADMAP Queue 1 item 3b-ii"


class UnsupportedJpeg(ValueError):
    """A JPEG that uses a feature this decoder does not implement."""

    def __init__(self, feature: str):
        super().__init__(f"{feature} JPEG is not supported by the port's decoder ({ROADMAP_ITEM})")


# jpeg_natural_order: zigzag index -> natural (row-major) index
ZIGZAG = np.array(sorted(range(64), key=lambda i: (i // 8 + i % 8, (i // 8) if (i // 8 + i % 8) % 2 else (i % 8))),
                  dtype=np.int64)

# Annex K tables, natural order (jcparam.c)
STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], dtype=np.int64)
STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, dtype=np.int64)

# jstdhuff.c: (counts of codes of length 1..16, symbols)
DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12)))
AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), tuple(bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")))
AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), tuple(bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")))

# islow DCT constants (jfdctint.c / jidctint.c): FIX(x) = round(x * 2^13)
CONST_BITS, PASS1_BITS = 13, 2
F0298, F0390, F0541, F0765 = 2446, 3196, 4433, 6270
F0899, F1175, F1501, F1847 = 7373, 9633, 12299, 15137
F1961, F2053, F2562, F3072 = 16069, 16819, 20995, 25172

# bit length of |v| for |v| < 2^16
_NBITS = np.zeros(1 << 16, np.int64)
for _b in range(1, 17):
    _NBITS[1 << (_b - 1):1 << _b] = _b


class JpegComponent(NamedTuple):
    blocks: np.ndarray   # (rows, cols, 64) quantized coefficients, natural order
    qtable: np.ndarray   # (64,) int64, natural order
    h: int               # sampling factors
    v: int


class JpegCoefficients(NamedTuple):
    height: int
    width: int
    components: Tuple[JpegComponent, ...]
    color: str           # "YCbCr", "L" or "RGB": how the components map to pixels


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """`jpeg_set_quality(cinfo, quality, force_baseline=TRUE)`: the scaled
    luminance and chrominance tables, natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - q * 2
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (STD_LUMA_Q, STD_CHROMA_Q))


# --------------------------------------------------------------- encoder


def _rgb_to_ycc(rgb: np.ndarray) -> List[np.ndarray]:
    """jccolor.c `rgb_ycc_convert` with its 16-bit fixed-point tables."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))   # sums stay below 2^25
    half, cbcr_off = 1 << 15, 128 << 16
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + cbcr_off + half - 1) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + cbcr_off + half - 1) >> 16
    return [y, cb, cr]


def _pad_edge(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(plane, ((0, rows - plane.shape[0]), (0, cols - plane.shape[1])), mode="edge")


def _h2v2_downsample(plane: np.ndarray, out_rows: int, out_cols: int) -> np.ndarray:
    """jcsample.c `h2v2_downsample` after jcprepct.c's padding: the full-size
    rows are padded to an even count and the columns to 2 * out_cols by
    replication; rows past the image's own downsampled rows repeat the
    last downsampled row."""
    h = plane.shape[0]
    full = _pad_edge(plane, h + (h & 1), 2 * out_cols)
    bias = np.tile(np.array([1, 2], np.int64), out_cols)[:out_cols]
    down = (full[0::2, 0::2] + full[0::2, 1::2] + full[1::2, 0::2] + full[1::2, 1::2] + bias) >> 2
    return _pad_edge(down, out_rows, out_cols)


def _to_blocks(plane: np.ndarray) -> np.ndarray:
    rows, cols = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)


def _fdct_islow(x: np.ndarray) -> np.ndarray:
    """jfdctint.c `jpeg_fdct_islow` on (..., 8, 8) centered samples: rows,
    then columns; the output is 8x the true DCT."""
    def one_pass(d: np.ndarray, first: bool) -> np.ndarray:
        t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
        t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
        t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
        t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
        t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        out = np.empty_like(d)
        shift = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS
        if first:
            out[..., 0] = (t10 + t11) << PASS1_BITS
            out[..., 4] = (t10 - t11) << PASS1_BITS
        else:
            out[..., 0] = _descale(t10 + t11, PASS1_BITS)
            out[..., 4] = _descale(t10 - t11, PASS1_BITS)
        z1 = (t12 + t13) * F0541
        out[..., 2] = _descale(z1 + t13 * F0765, shift)
        out[..., 6] = _descale(z1 - t12 * F1847, shift)
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * F1175
        t4, t5, t6, t7 = t4 * F0298, t5 * F2053, t6 * F3072, t7 * F1501
        z1, z2 = z1 * -F0899, z2 * -F2562
        z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
        out[..., 7] = _descale(t4 + z1 + z3, shift)
        out[..., 5] = _descale(t5 + z2 + z4, shift)
        out[..., 3] = _descale(t6 + z2 + z3, shift)
        out[..., 1] = _descale(t7 + z1 + z4, shift)
        return out

    rows = one_pass(x, True)
    return one_pass(rows.swapaxes(-1, -2), False).swapaxes(-1, -2)


def _quantize(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """jcdctmgr.c `quantize` with `compute_reciprocal`'s divisors for
    16-bit DCTELEMs (the divisor is 8 * q for the islow DCT)."""
    div = qtable.reshape(8, 8) * 8
    b = np.floor(np.log2(div)).astype(np.int64)   # flss(divisor) - 1
    r = 16 + b
    fq, fr = (np.int64(1) << r) // div, (np.int64(1) << r) % div
    c = div // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr <= div // 2, fq, fq + 1))
    r = np.where(pow2, r - 1, r)
    c = np.where(~pow2 & (fr <= div // 2), c + 1, c)
    mag = ((np.abs(coefs) + c) * fq) >> r
    return np.where(coefs < 0, -mag, mag).astype(np.int32)


def _huff_codes(spec) -> Tuple[np.ndarray, np.ndarray]:
    """jchuff.c `jpeg_make_c_derived_tbl`: symbol -> (code, length)."""
    counts, symbols = spec
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


_ENC_TABLES = [(_huff_codes(DC_LUMA), _huff_codes(AC_LUMA)), (_huff_codes(DC_CHROMA), _huff_codes(AC_CHROMA))]


def _extra_bits(v: np.ndarray, n: np.ndarray) -> np.ndarray:
    return (v - (v < 0)) & ((np.int64(1) << n) - 1)


def _entropy_encode(zz: np.ndarray, table_of_block: np.ndarray, comp_of_block: np.ndarray) -> bytes:
    """Huffman-code blocks (N, 64) of zigzag coefficients in scan order:
    every (code, length) item of the scan is built with array operations,
    then the bits are packed, padded with 1s and 0xFF-stuffed."""
    n = zz.shape[0]
    blk_idx = np.arange(n)
    dc_diff = np.empty(n, np.int64)
    for c in np.unique(comp_of_block):
        sel = np.flatnonzero(comp_of_block == c)
        dc_diff[sel] = np.diff(zz[sel, 0].astype(np.int64), prepend=0)
    vals, lens, keys = [], [], []

    def add(v, l, k):
        vals.append(v)
        lens.append(l)
        keys.append(k)

    for t, ((dc_code, dc_len), (ac_code, ac_len)) in enumerate(_ENC_TABLES):
        in_t = table_of_block == t
        if not in_t.any():
            continue
        # DC: category code, then the magnitude bits
        b = blk_idx[in_t]
        d = dc_diff[b]
        s = _NBITS[np.abs(d)]
        add((dc_code[s] << s) | _extra_bits(d, s), dc_len[s] + s, b * 256)
        # AC: run/size symbols, with a ZRL (0xF0) per 16 zeros skipped
        ac = zz[b, 1:].astype(np.int64)
        rows, cols = np.nonzero(ac)
        pos = cols + 1
        bb = b[rows]
        first = np.ones(len(rows), bool)
        first[1:] = rows[1:] != rows[:-1]
        prev = np.where(first, 0, np.concatenate([[0], pos[:-1]]))
        run = pos - prev - 1
        v = ac[rows, cols]
        s = _NBITS[np.abs(v)]
        sym = ((run & 15) << 4) | s
        add((ac_code[sym] << s) | _extra_bits(v, s), ac_len[sym] + s, bb * 256 + 2 * pos + 1)
        nz = run >> 4
        zl = ac_len[0xF0]
        for k in (1, 2, 3):
            m = nz == k
            if m.any():
                rep = 0
                for _ in range(k):
                    rep = (rep << zl) | ac_code[0xF0]
                n_m = int(m.sum())
                add(np.full(n_m, rep, np.int64), np.full(n_m, k * zl, np.int64), bb[m] * 256 + 2 * pos[m])
        # EOB after the last nonzero coefficient, unless it is number 63
        last = np.zeros(len(b), np.int64)
        np.maximum.at(last, rows, pos)
        eob = last < 63
        n_eob = int(eob.sum())
        add(np.full(n_eob, ac_code[0], np.int64), np.full(n_eob, ac_len[0], np.int64), b[eob] * 256 + 255)
    order = np.argsort(np.concatenate(keys), kind="stable")
    val = np.concatenate(vals)[order].astype(np.uint64)
    ln = np.concatenate(lens)[order]
    total = int(ln.sum())
    owner = np.repeat(np.arange(len(ln), dtype=np.int64), ln)
    within = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(ln) - ln, ln)
    bits = ((val[owner] >> (ln[owner] - 1 - within).astype(np.uint64)) & np.uint64(1)).astype(np.uint8)
    bits = np.concatenate([bits, np.ones((-total) % 8, np.uint8)])
    out = np.packbits(bits)
    return np.insert(out, np.flatnonzero(out == 0xFF) + 1, 0).tobytes()


def _marker(code: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, code, len(body) + 2) + body


def _dht(cls: int, tid: int, spec) -> bytes:
    return _marker(0xC4, bytes([cls << 4 | tid]) + bytes(spec[0]) + bytes(spec[1]))


def _mcu_blocks(comps: List[np.ndarray], samp: List[Tuple[int, int]], mcu_rows: int, mcu_cols: int):
    """Interleaved scan order: per MCU, each component's v x h blocks in
    row order -> (blocks (N, 64) natural order, component index per block)."""
    parts, comp_ids = [], []
    for ci, ((h, v), blk) in enumerate(zip(samp, comps)):
        b = blk.reshape(mcu_rows, v, mcu_cols, h, 64).transpose(0, 2, 1, 3, 4).reshape(mcu_rows, mcu_cols, v * h, 64)
        parts.append(b)
        comp_ids.extend([ci] * (v * h))
    allb = np.concatenate(parts, axis=2)
    return allb.reshape(-1, 64), np.tile(np.array(comp_ids), mcu_rows * mcu_cols)


def encode_jpeg(pixels: np.ndarray, quality: int = 75) -> Tuple[bytes, JpegCoefficients]:
    """(H, W) gray or (H, W, 3) RGB uint8 -> (the bytes Pillow writes for
    `save(buf, "JPEG", quality=quality)`, the quantized coefficients)."""
    arr = np.asarray(pixels, dtype=np.uint8)
    gray = arr.ndim == 2
    if not gray and (arr.ndim != 3 or arr.shape[2] != 3):
        raise ValueError(f"cannot encode an array of shape {arr.shape} as JPEG (L or RGB only)")
    height, width = arr.shape[:2]
    if not (0 < height <= 65500 and 0 < width <= 65500):
        raise ValueError(f"JPEG dimensions {width} x {height} out of range")
    luma_q, chroma_q = quality_tables(quality)
    planes = [arr.astype(np.int64)] if gray else _rgb_to_ycc(arr)
    hmax = vmax = 1 if gray else 2
    samp = [(1, 1)] if gray else [(2, 2), (1, 1), (1, 1)]
    mcu_rows, mcu_cols = -(-height // (8 * vmax)), -(-width // (8 * hmax))
    comps: List[JpegComponent] = []
    for ci, (plane, (h, v)) in enumerate(zip(planes, samp)):
        qt = luma_q if ci == 0 else chroma_q
        # blocks the image covers (jcmaster.c width_in_blocks / height_in_blocks)
        bw, bh = -(-width * h // (8 * hmax)), -(-height * v // (8 * vmax))
        if (h, v) == (hmax, vmax):
            full = _pad_edge(plane, bh * 8, bw * 8)
        else:
            full = _h2v2_downsample(plane, bh * 8, bw * 8)
        q = _quantize(_fdct_islow(_to_blocks(full) - 128), qt).astype(np.int16).reshape(bh, bw, 64)
        rows, cols = mcu_rows * v, mcu_cols * h
        if (rows, cols) != (bh, bw):
            # jccoefct.c dummy blocks: AC zero; a right-edge block takes the
            # DC of the block to its left, a bottom-edge block the DC of the
            # last block of the MCU row above it
            padded = np.zeros((rows, cols, 64), np.int16)
            padded[:bh, :bw] = q
            for c in range(bw, cols):
                padded[:bh, c, 0] = padded[:bh, c - 1, 0]
            for r in range(bh, rows):
                above = padded[r - 1].reshape(mcu_cols, h, 64)[:, h - 1, 0]
                padded[r].reshape(mcu_cols, h, 64)[:, :, 0] = above[:, None]
            q = padded
        comps.append(JpegComponent(q, qt, h, v))
    blocks, comp_of = _mcu_blocks([c.blocks for c in comps], samp, mcu_rows, mcu_cols)
    scan = _entropy_encode(blocks[:, ZIGZAG], np.minimum(comp_of, 1), comp_of)
    jfif = _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    dqt = b"".join(_marker(0xDB, bytes([t]) + qt[ZIGZAG].astype(np.uint8).tobytes())
                   for t, qt in enumerate([luma_q] if gray else [luma_q, chroma_q]))
    sof = _marker(0xC0, struct.pack(">BHHB", 8, height, width, len(comps)) + b"".join(
        bytes([ci + 1, h << 4 | v, min(ci, 1)]) for ci, (h, v) in enumerate(samp)))
    dht = _dht(0, 0, DC_LUMA) + _dht(1, 0, AC_LUMA)
    if not gray:
        dht += _dht(0, 1, DC_CHROMA) + _dht(1, 1, AC_CHROMA)
    sos = _marker(0xDA, bytes([len(comps)]) + b"".join(bytes([ci + 1, min(ci, 1) * 0x11]) for ci in range(len(comps)))
                  + b"\x00\x3f\x00")
    data = b"\xff\xd8" + jfif + dqt + sof + dht + sos + scan + b"\xff\xd9"
    return data, JpegCoefficients(height, width, tuple(comps), "L" if gray else "YCbCr")


# --------------------------------------------------------------- decoder


def _idct_islow(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """jidctint.c `jpeg_idct_islow` on (..., 64) natural-order quantized
    coefficients -> (..., 8, 8) uint8 samples, range-limited through
    libjpeg's wrap-around table (`& RANGE_MASK`)."""
    x = coefs.reshape(coefs.shape[:-1] + (8, 8)).astype(np.int64) * qtable.reshape(8, 8)

    def one_pass(d: np.ndarray, first: bool) -> np.ndarray:
        z2, z3 = d[..., 2], d[..., 6]
        z1 = (z2 + z3) * F0541
        t2, t3 = z1 - z3 * F1847, z1 + z2 * F0765
        z2, z3 = d[..., 0], d[..., 4]
        if not first:   # fudge factor for the final descale
            z2 = z2 + (1 << (PASS1_BITS + 2))
        t0, t1 = (z2 + z3) << CONST_BITS, (z2 - z3) << CONST_BITS
        t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        t0, t1, t2, t3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
        z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
        z5 = (z3 + z4) * F1175
        t0, t1, t2, t3 = t0 * F0298, t1 * F2053, t2 * F3072, t3 * F1501
        z1, z2 = z1 * -F0899, z2 * -F2562
        z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
        t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
        outs = [t10 + t3, t11 + t2, t12 + t1, t13 + t0, t13 - t0, t12 - t1, t11 - t2, t10 - t3]
        if first:
            return np.stack([_descale(o, CONST_BITS - PASS1_BITS) for o in outs], axis=-1)
        return np.stack([o >> (CONST_BITS + PASS1_BITS + 3) for o in outs], axis=-1)

    cols = one_pass(x.swapaxes(-1, -2), True).swapaxes(-1, -2)
    return _IDCT_LIMIT[one_pass(cols, False) & 1023]


# jdmaster.c post-IDCT range limit: x & 1023 -> clamp(x + 128) for x in
# [-512, 511], wrapping outside
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384), np.arange(0, 128)]
                             ).astype(np.uint8)


def _fancy_upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """jdsample.c fancy upsampling of a (rows, cols) component to
    (fv * rows, fh * cols): h2v1 and h2v2 (triangle filters, context rows
    and edge columns replicated) and h1v2; h2v1 / h2v2 of a component at
    most 2 samples wide replicate instead, as libjpeg does."""
    p = plane.astype(np.int32)
    if (fh, fv) == (1, 1):
        return plane
    if fh == 2 and p.shape[1] <= 2:
        return np.repeat(np.repeat(plane, fh, axis=1), fv, axis=0)
    if fv == 2:
        above = np.concatenate([p[:1], p[:-1]])
        below = np.concatenate([p[1:], p[-1:]])
        near = np.empty((2 * p.shape[0], p.shape[1]), np.int32)
        near[0::2], near[1::2] = 3 * p + above, 3 * p + below
        if fh == 1:   # h1v2: (colsum + bias) >> 2, bias 1 above / 2 below
            out = near.copy()
            out[0::2] = (near[0::2] + 1) >> 2
            out[1::2] = (near[1::2] + 2) >> 2
            return out.astype(np.uint8)
        left = np.concatenate([near[:, :1], near[:, :-1]], axis=1)
        right = np.concatenate([near[:, 1:], near[:, -1:]], axis=1)
        out = np.empty((near.shape[0], 2 * p.shape[1]), np.int32)
        out[:, 0::2] = (3 * near + left + 8) >> 4
        out[:, 1::2] = (3 * near + right + 7) >> 4
        return out.astype(np.uint8)
    left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int32)
    out[:, 0::2] = (3 * p + left + 1) >> 2
    out[:, 1::2] = (3 * p + right + 2) >> 2
    return out.astype(np.uint8)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c `ycc_rgb_convert` with `build_ycc_rgb_table`'s tables."""
    y = y.astype(np.int32)   # products stay below 2^24
    cb, cr = cb.astype(np.int32) - 128, cr.astype(np.int32) - 128
    half = 1 << 15
    r = y + ((91881 * cr + half) >> 16)
    g = y + ((-22554 * cb + half - 46802 * cr) >> 16)
    b = y + ((116130 * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _reconstruct(coeffs: JpegCoefficients) -> np.ndarray:
    """Coefficients -> (H, W) gray or (H, W, 3) RGB pixels."""
    hmax = max(c.h for c in coeffs.components)
    vmax = max(c.v for c in coeffs.components)
    planes = []
    for comp in coeffs.components:
        rows, cols = comp.blocks.shape[:2]
        plane = _idct_islow(comp.blocks, comp.qtable).transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)
        # the component's own samples (jdmaster.c downsampled_width/height)
        dw = -(-coeffs.width * comp.h // hmax)
        dh = -(-coeffs.height * comp.v // vmax)
        up = _fancy_upsample(plane[:dh, :dw], hmax // comp.h, vmax // comp.v)
        planes.append(up[:coeffs.height, :coeffs.width])
    if coeffs.color == "L":
        return planes[0]
    if coeffs.color == "RGB":
        return np.stack(planes, axis=-1)
    return _ycc_to_rgb(*planes)


def decode_own(coeffs: JpegCoefficients) -> np.ndarray:
    """The (H, W, 3) uint8 pixels of Pillow's `Image.open(jpeg).convert("RGB")`
    for the JPEG `encode_jpeg` wrote with these coefficients."""
    px = _reconstruct(coeffs)
    return np.repeat(px[..., None], 3, axis=2) if px.ndim == 2 else px


class _Frame(NamedTuple):
    height: int
    width: int
    comps: List[Tuple[int, int, int, int]]   # (id, h, v, quant table id)


def _segments(data: bytes):
    """Marker segments up to the first SOS: (marker, body, offset after)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF and pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1   # fill bytes
        if pos + 4 > len(data) or data[pos] != 0xFF:
            raise ValueError("truncated or broken JPEG marker structure")
        marker = data[pos + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker == 0xD9:
            raise ValueError("JPEG ends before its image data")
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        if len(body) != length - 2:
            raise ValueError("truncated JPEG marker segment")
        pos += 2 + length
        yield marker, body, pos


def _check_sof(marker: int, body: bytes) -> _Frame:
    kinds = {0xC2: "progressive", 0xC6: "progressive", 0xCA: "progressive", 0xCE: "progressive",
             0xC3: "lossless", 0xC7: "lossless", 0xCB: "lossless", 0xCF: "lossless",
             0xC9: "arithmetic-coded", 0xCD: "arithmetic-coded", 0xC5: "hierarchical"}
    if marker in kinds:
        raise UnsupportedJpeg(kinds[marker])
    precision, height, width, n = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise UnsupportedJpeg(f"{precision}-bit")
    if n == 4:
        raise UnsupportedJpeg("CMYK (4-component)")
    if n not in (1, 3):
        raise UnsupportedJpeg(f"{n}-component")
    if height == 0:
        raise UnsupportedJpeg("DNL-sized (height 0)")
    comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15, body[8 + 3 * i]) for i in range(n)]
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    for _, h, v, _ in comps:
        if h not in (1, 2) or v not in (1, 2) or hmax // h > 2 or vmax // v > 2 or hmax % h or vmax % v:
            raise UnsupportedJpeg(f"sampling factors {h}x{v} of {hmax}x{vmax}")
    return _Frame(height, width, comps)


def probe_jpeg(data: bytes) -> Tuple[int, int, int]:
    """(width, height, components) from the header; raises
    `UnsupportedJpeg` for a file `read_jpeg` would refuse."""
    for marker, body, _ in _segments(data):
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            f = _check_sof(marker, body)
            return f.width, f.height, len(f.comps)
        if marker == 0xDA:
            break
    raise ValueError("JPEG has no frame header before its scan")


def _huff_lookup(counts, symbols) -> List[int]:
    """16-bit peek -> symbol << 8 | code length (length 0: a bad code)."""
    table = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = symbols[k] << 8 | length
            code += 1
            k += 1
        code <<= 1
    return table.tolist()


def _decode_interval(data: bytes, units, nblocks: int, coefs: List[Tuple[list, list]], tables) -> None:
    """Huffman-decode one restart interval (0xFF00 already unstuffed):
    `units` yields (component, flat offset of the block) in scan order; the
    (flat index, value) of every nonzero coefficient is appended to the
    component's lists. DC predictors start at 0."""
    nbits = len(data) * 8
    b = np.frombuffer(data + b"\xff\xff\xff\xff", np.uint8).astype(np.int64)
    # the 32 bits from each byte on; bits past the end read as 1s
    win = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
    zz = ZIGZAG.tolist()
    pos = 0
    pred = {}
    for _ in range(nblocks):
        ci, base = next(units)
        dc_tab, ac_tab = tables[ci]
        idx, val = coefs[ci]
        e = dc_tab[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
        if not e & 0xFF:
            raise ValueError("corrupt JPEG data: bad Huffman code")
        pos += e & 0xFF
        s = e >> 8
        v = 0
        if s:
            v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
            pos += s
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
        dc = pred.get(ci, 0) + v
        pred[ci] = dc
        idx.append(base)
        val.append(dc)
        k = 1
        while k < 64:
            e = ac_tab[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e & 0xFF:
                raise ValueError("corrupt JPEG data: bad Huffman code")
            pos += e & 0xFF
            rs = e >> 8
            s = rs & 15
            if s:
                k += rs >> 4
                if k > 63:
                    raise ValueError("corrupt JPEG data: coefficient index past 63")
                v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                idx.append(base + zz[k])
                val.append(v)
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break
        if pos > nbits:
            raise ValueError("truncated JPEG image data")


def _read_dht(body: bytes, dc_specs: dict, ac_specs: dict) -> None:
    i = 0
    while i < len(body):
        tc, th = body[i] >> 4, body[i] & 15
        counts = tuple(body[i + 1:i + 17])
        n = sum(counts)
        (ac_specs if tc else dc_specs)[th] = _huff_lookup(counts, tuple(body[i + 17:i + 17 + n]))
        i += 17 + n


def read_jpeg(data: bytes) -> Tuple[np.ndarray, str]:
    """JPEG bytes -> (pixels, mode) as Pillow's `Image.open` decodes them:
    mode "L" gives (H, W), mode "RGB" (H, W, 3) uint8."""
    qtables = {}
    dc_specs, ac_specs = {}, {}
    frame = None
    restart = 0
    jfif = adobe = False
    adobe_transform = None
    for marker, body, pos in _segments(data):
        if marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[i + 1:i + 1 + n], ">u2" if pq else np.uint8).astype(np.int64)
                qt = np.zeros(64, np.int64)
                qt[ZIGZAG] = vals
                qtables[tq] = qt
                i += 1 + n
        elif marker == 0xC4:
            _read_dht(body, dc_specs, ac_specs)
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe":
            adobe, adobe_transform = True, body[11] if len(body) > 11 else None
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            frame = _check_sof(marker, body)
        elif marker == 0xCC:
            raise UnsupportedJpeg("arithmetic-coded")
        elif marker == 0xDA:
            break
    if frame is None:
        raise ValueError("JPEG has no frame header before its scan")
    hmax = max(c[1] for c in frame.comps)
    vmax = max(c[2] for c in frame.comps)
    mcu_rows, mcu_cols = -(-frame.height // (8 * vmax)), -(-frame.width // (8 * hmax))
    blocks = [np.zeros((mcu_rows * v, mcu_cols * h, 64), np.int64) for _, h, v, _ in frame.comps]
    ids = [c[0] for c in frame.comps]
    coefs = [([], []) for _ in frame.comps]
    # the one scan (baseline files here code every component in one
    # interleaved scan, or a gray one alone): `pos` is after its header
    ns = body[0]
    if ns != len(frame.comps):
        raise UnsupportedJpeg("multi-scan baseline")
    scomps = []
    for i in range(ns):
        cid, tsel = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in ids:
            raise ValueError(f"JPEG scan names an unknown component {cid}")
        scomps.append((ids.index(cid), tsel >> 4, tsel & 15))
    if body[1 + 2 * ns:4 + 2 * ns] != b"\x00\x3f\x00":
        raise UnsupportedJpeg("progressive (spectral selection)")
    tables = {}
    for ci, td, ta in scomps:
        if td not in dc_specs or ta not in ac_specs:
            raise ValueError("JPEG scan uses an undefined Huffman table")
        tables[ci] = (dc_specs[td], ac_specs[ta])
    # each block's flat offset, in scan order
    if ns == 1:
        order = [(0, (r * blocks[0].shape[1] + c) * 64)
                 for r in range(-(-frame.height // 8)) for c in range(-(-frame.width // 8))]
    else:
        order = [(ci, ((my * frame.comps[ci][2] + y) * blocks[ci].shape[1] + mx * frame.comps[ci][1] + x) * 64)
                 for my in range(mcu_rows) for mx in range(mcu_cols)
                 for ci, _, _ in scomps for y in range(frame.comps[ci][2]) for x in range(frame.comps[ci][1])]
    per_unit = 1 if ns == 1 else len(order) // (mcu_rows * mcu_cols)   # blocks per MCU
    # entropy-coded data up to the first marker that is not RSTn
    intervals = []
    start = pos
    while True:
        nxt = data.find(b"\xff", pos)
        if nxt < 0 or nxt + 1 >= len(data):
            raise ValueError("truncated JPEG image data (no EOI)")
        m = data[nxt + 1]
        if m == 0x00 or m == 0xFF:
            pos = nxt + (2 if m == 0x00 else 1)
            continue
        intervals.append(data[start:nxt])
        pos = nxt + 2
        if 0xD0 <= m <= 0xD7:
            start = pos
            continue
        break
    units_total = len(order) // per_unit
    interval_units = restart if restart else units_total
    it = iter(order)
    done = 0
    for seg in intervals:
        if done >= units_total:
            break
        n_units = min(interval_units, units_total - done)
        _decode_interval(seg.replace(b"\xff\x00", b"\xff"), it, n_units * per_unit, coefs, tables)
        done += n_units
    if done < units_total:
        raise ValueError("truncated JPEG image data")
    for blk, (idx, val) in zip(blocks, coefs):
        blk.reshape(-1)[np.asarray(idx, np.int64)] = np.asarray(val, np.int64)
    comps = []
    for (cid, h, v, tq), blk in zip(frame.comps, blocks):
        if tq not in qtables:
            raise ValueError(f"JPEG uses an undefined quantization table {tq}")
        comps.append(JpegComponent(blk, qtables[tq], h, v))
    if len(comps) == 1:
        color = "L"
    elif jfif:
        color = "YCbCr"
    elif adobe:
        color = "RGB" if adobe_transform == 0 else "YCbCr"
    else:
        color = "RGB" if ids == [82, 71, 66] else "YCbCr"
    px = _reconstruct(JpegCoefficients(frame.height, frame.width, tuple(comps), color))
    return px, ("L" if color == "L" else "RGB")


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8, as Pillow's `convert("RGB")`."""
    px, mode = read_jpeg(data)
    return np.repeat(px[..., None], 3, axis=2) if mode == "L" else px
