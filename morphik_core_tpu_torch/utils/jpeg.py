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
  query images: 8-bit Huffman files of 1 or 3 components with sampling
  factors up to 2x2, sequential (SOF0/SOF1) in one interleaved scan or in
  several, or progressive (SOF2: DC first and refinement scans, AC first
  and refinement scans with their EOB runs, as jdphuff.c decodes them);
  DHT, DQT and DRI segments between scans, restart markers inside any
  scan; a scan of one component covers only that component's own blocks.
  Four-component files open as Pillow's mode "CMYK" (rawmode "CMYK;I":
  every sample inverted): Adobe transform 0, or no Adobe marker, is CMYK
  as stored; any other transform is YCCK, converted by libjpeg-turbo's
  `ycck_cmyk_convert` first.
  The coefficients land in the `JpegCoefficients` form, so the islow
  IDCT, fancy upsampling and colour conversion serve every kind of file.
  Arithmetic-coded, lossless, hierarchical and 12-bit files, and
  progressive files whose scans leave bits of the first ten coefficients
  unrefined (libjpeg smooths those blocks), raise `UnsupportedJpeg`,
  which names ROADMAP Queue 1 item 3b-ii; `probe_jpeg` finds all of these
  from the headers.
"""

from __future__ import annotations

import re
import struct
from typing import List, NamedTuple, Tuple

import numpy as np

ROADMAP_ITEM = "ROADMAP Queue 1 item 3b-ii"


class UnsupportedImage(ValueError):
    """A page image in a variant the port's decoders do not read. With
    `open_fails`, one Pillow's `Image.open` fails on too: the reference
    stores no page for it (`services/ingestion_service.py::check_upload`
    lets it through, and its job completes without one)."""

    def __init__(self, feature: str, open_fails: bool = False):
        super().__init__(f"{feature} is not supported by the port's decoder ({ROADMAP_ITEM})")
        self.open_fails = open_fails


class NotThisFormat(ValueError):
    """What a Pillow plugin's `_open` signals with SyntaxError, IndexError,
    TypeError, KeyError, EOFError or struct.error, or with a size of no
    pixels: the bytes are not its format, and `Image.open` tries the next
    plugin (`utils/image.py::sniff`)."""


class UnsupportedJpeg(UnsupportedImage):
    """A JPEG that uses a feature this decoder does not implement."""

    def __init__(self, feature: str, detail: str = "", open_fails: bool = False):
        super().__init__(f"{feature} JPEG{detail}", open_fails)


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


def encode_jpeg(pixels: np.ndarray, quality: int = 75, comment: bytes = b"") -> Tuple[bytes, JpegCoefficients]:
    """(H, W) gray or (H, W, 3) RGB uint8 -> (the bytes Pillow writes for
    `save(buf, "JPEG", quality=quality)` of an image whose `info` holds
    `comment` (a COM segment after APP0 when it is not empty), the
    quantized coefficients)."""
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
    com = _marker(0xFE, comment) if comment else b""
    data = b"\xff\xd8" + jfif + com + dqt + sof + dht + sos + scan + b"\xff\xd9"
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
    return _convert(coeffs.color, planes)


def _convert(color: str, planes: List[np.ndarray]) -> np.ndarray:
    """Full-size component planes -> (H, W) gray or (H, W, C) pixels."""
    if color == "L":
        return planes[0]
    if color == "RGB":
        return np.stack(planes, axis=-1)
    if color == "CMYK":
        # Pillow reads every 4-component JPEG as rawmode "CMYK;I" (inverted)
        return 255 - np.stack(planes, axis=-1)
    if color == "YCCK":
        # jdcolor.c `ycck_cmyk_convert` (C, M, Y = 255 - R, G, B; K kept), then inverted
        return np.concatenate([_ycc_to_rgb(*planes[:3]), 255 - planes[3][..., None]], axis=-1)
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
    progressive: bool
    arith: bool = False      # arithmetic-coded (SOF9 / SOF10)
    lossless: bool = False   # lossless (SOF3)


def _segments(data: bytes, pos: int = 2):
    """Marker segments from `pos` (after SOI) up to and including the next
    SOS or EOI: (marker, body, offset after it); EOI has an empty body."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    while True:
        while pos < len(data) and data[pos] == 0xFF and pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1   # fill bytes
        if pos + 2 > len(data) or data[pos] != 0xFF:
            raise ValueError("truncated or broken JPEG marker structure")
        marker = data[pos + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker == 0xD9:
            yield marker, b"", pos + 2
            return
        if pos + 4 > len(data):
            raise ValueError("truncated or broken JPEG marker structure")
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        if len(body) != length - 2:
            raise ValueError("truncated JPEG marker segment")
        pos += 2 + length
        yield marker, body, pos
        if marker == 0xDA:
            return


_SOF_REFUSED = {0xCB: "arithmetic-coded lossless",
                0xC5: "hierarchical", 0xC6: "hierarchical", 0xC7: "hierarchical", 0xCD: "hierarchical",
                0xCE: "hierarchical", 0xCF: "hierarchical"}


def _check_sof(marker: int, body: bytes) -> _Frame:
    if marker in _SOF_REFUSED:
        raise UnsupportedJpeg(_SOF_REFUSED[marker], " (libjpeg-turbo does not decode it)")
    precision, height, width, n = struct.unpack(">BHHB", body[:6])
    # Pillow's SOF handler refuses these three (no plugin then identifies the file)
    if precision != 8:
        raise UnsupportedJpeg(f"{precision}-bit", open_fails=True)
    if n not in (1, 3, 4):
        raise UnsupportedJpeg(f"{n}-component", open_fails=True)
    if height == 0:
        raise UnsupportedJpeg("DNL-sized (height 0)", open_fails=True)
    comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15, body[8 + 3 * i]) for i in range(n)]
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    for _, h, v, _ in comps:
        if h not in (1, 2) or v not in (1, 2) or hmax // h > 2 or vmax // v > 2 or hmax % h or vmax % v:
            raise UnsupportedJpeg(f"sampling factors {h}x{v} of {hmax}x{vmax}")
    return _Frame(height, width, comps, marker in (0xC2, 0xCA), marker in (0xC9, 0xCA), marker == 0xC3)


_PILLOW_BLOCK = 65536   # ImageFile.MAXBLOCK: Pillow feeds its JPEG decoder the file in blocks this size


def _fed(pos: int, fed: int) -> int:
    """The bytes Pillow has fed libjpeg once it has read the headers up to
    `pos`: a marker segment that runs past the blocks fed suspends the
    decoder until the next block comes."""
    while pos > fed:
        fed += _PILLOW_BLOCK
    return fed


def _check_arith_fed(data: bytes, pos: int, fed: int) -> None:
    """jdarith.c reads its bytes with no suspension: an arithmetic-coded
    scan whose data (and the marker after it) run past the blocks fed
    makes libjpeg fail, and Pillow cannot load the file."""
    if _entropy_end(data, pos) + 2 > fed:
        raise UnsupportedJpeg("arithmetic-coded", " whose data run past Pillow's 64 KiB read block (libjpeg's "
                              "arithmetic decoder cannot wait for the next, so Pillow cannot load it)")


def open_jpeg(data: bytes) -> Tuple[int, int]:
    """(width, height) as `JpegImageFile._open` finds them: the marker
    segments up to the first SOS, the frame header among them; raises where
    `Image.open` does (the scans and what follows are `load`'s)."""
    frame = None
    for marker, body, _ in _segments(data):
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            frame = _check_sof(marker, body)
        if marker == 0xDA:
            if frame is None:   # no size: Pillow's ImageFile refuses it and Image.open moves on
                raise NotThisFormat("JPEG has no frame header before its scan")
            return frame.width, frame.height
    raise ValueError("JPEG ends before its first scan")


def probe_jpeg(data: bytes) -> Tuple[int, int, int]:
    """(width, height, components) from the headers of the frame and of
    every scan, the entropy-coded data skipped; raises `UnsupportedJpeg`
    for a file `read_jpeg` would refuse."""
    frame, coef_bits, pos, fed = None, None, 2, _PILLOW_BLOCK
    while True:
        for marker, body, pos in _segments(data, pos):
            fed = _fed(pos, fed)
            if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
                frame = _check_sof(marker, body)
        if marker == 0xD9 or frame is None:
            break
        coef_bits = coef_bits or [[-1] * 64 for _ in frame.comps]
        _track_bits(coef_bits, _parse_sos(body, frame), frame.progressive)
        if frame.arith:
            _check_arith_fed(data, pos, fed)
        pos = _entropy_end(data, pos)
    if frame is None or coef_bits is None:
        raise ValueError("JPEG has no frame header before its scan")
    if frame.progressive:
        _check_refined(coef_bits)
    return frame.width, frame.height, len(frame.comps)


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


def _windows(data: bytes) -> List[int]:
    """The 32 bits from each byte of an unstuffed interval on; bits past
    its end read as 1s."""
    b = np.frombuffer(data + b"\xff\xff\xff\xff", np.uint8).astype(np.int64)
    return ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()


def _decode_interval(data: bytes, units, nblocks: int, coefs: List[Tuple[list, list]], tables) -> None:
    """Huffman-decode one restart interval of a sequential scan (0xFF00
    already unstuffed): `units` yields (component, flat offset of the
    block) in scan order; the (flat index, value) of every nonzero
    coefficient is appended to the component's lists. DC predictors start
    at 0."""
    nbits = len(data) * 8
    win = _windows(data)
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


def _decode_dc_progressive(data: bytes, units, coef: List[list], tables, ah: int, al: int) -> None:
    """One restart interval of a progressive DC scan (jdphuff.c
    `decode_mcu_DC_first` / `decode_mcu_DC_refine`): `units` yields
    (component, flat offset of the block) in scan order."""
    nbits = len(data) * 8
    win = _windows(data)
    pos = 0
    if ah:   # refinement: one bit per block, OR-ed in at bit `al`
        p1 = 1 << al
        for ci, base in units:
            if (win[pos >> 3] >> (31 - (pos & 7))) & 1:
                coef[ci][base] |= p1
            pos += 1
    else:
        pred = {}
        for ci, base in units:
            e = tables[ci][(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
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
            coef[ci][base] = dc << al
    if pos > nbits:
        raise ValueError("truncated JPEG image data")


def _decode_ac_first(data: bytes, bases: list, blk: list, tab: list, ss: int, se: int, al: int) -> None:
    """One restart interval of a progressive AC first scan of one
    component (jdphuff.c `decode_mcu_AC_first`), with its EOB runs."""
    nbits = len(data) * 8
    win = _windows(data)
    zz = ZIGZAG.tolist()
    pos = 0
    eobrun = 0
    for base in bases:
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            e = tab[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e & 0xFF:
                raise ValueError("corrupt JPEG data: bad Huffman code")
            pos += e & 0xFF
            rs = e >> 8
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                if k > 63:
                    raise ValueError("corrupt JPEG data: coefficient index past 63")
                v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                blk[base + zz[k]] = v << al
            elif r == 15:
                k += 15
            else:
                eobrun = 1 << r
                if r:
                    eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r)) & ((1 << r) - 1)
                    pos += r
                eobrun -= 1
                break
            k += 1
    if pos > nbits:
        raise ValueError("truncated JPEG image data")


def _decode_ac_refine(data: bytes, bases: list, blk: list, tab: list, ss: int, se: int, al: int) -> None:
    """One restart interval of a progressive AC refinement scan of one
    component (jdphuff.c `decode_mcu_AC_refine`): a correction bit for
    each coefficient already nonzero that the scan passes, new +-1 << al
    coefficients placed after `r` zero-history ones, EOB runs that span
    blocks."""
    nbits = len(data) * 8
    win = _windows(data)
    nat = ZIGZAG.tolist()
    p1, m1 = 1 << al, -1 << al
    pos = 0
    eobrun = 0
    for base in bases:
        k = ss
        if not eobrun:
            while k <= se:
                e = tab[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if not e & 0xFF:
                    raise ValueError("corrupt JPEG data: bad Huffman code")
                pos += e & 0xFF
                rs = e >> 8
                r, s = rs >> 4, rs & 15
                if s:
                    if s != 1:
                        raise ValueError("corrupt JPEG data: refinement coefficient of size > 1")
                    s = p1 if (win[pos >> 3] >> (31 - (pos & 7))) & 1 else m1
                    pos += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r)) & ((1 << r) - 1)
                        pos += r
                    break
                # skip r zero-history coefficients (16 for ZRL), correcting
                # the nonzero ones passed on the way
                while k <= se:
                    i = base + nat[k]
                    c = blk[i]
                    if c:
                        if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not c & p1:
                            blk[i] = c + p1 if c >= 0 else c + m1
                        pos += 1
                    else:
                        if r == 0:
                            break
                        r -= 1
                    k += 1
                if s:
                    if k > se:
                        raise ValueError("corrupt JPEG data: coefficient index past the scan")
                    blk[base + nat[k]] = s
                k += 1
        if eobrun:
            # the rest of the block: correction bits only (none in a block
            # whose AC coefficients are all still zero)
            if k == ss and not any(blk[base + 1:base + 64]):
                eobrun -= 1
                continue
            while k <= se:
                i = base + nat[k]
                c = blk[i]
                if c:
                    if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not c & p1:
                        blk[i] = c + p1 if c >= 0 else c + m1
                    pos += 1
                k += 1
            eobrun -= 1
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


def _entropy_end(data: bytes, pos: int) -> int:
    """The offset of the first marker after `pos` that is not RSTn (a
    scan's entropy-coded data ends there)."""
    while True:
        nxt = data.find(b"\xff", pos)
        if nxt < 0 or nxt + 1 >= len(data):
            raise ValueError("truncated JPEG image data (no EOI)")
        m = data[nxt + 1]
        if m == 0x00 or m == 0xFF or 0xD0 <= m <= 0xD7:
            pos = nxt + (1 if m == 0xFF else 2)
            continue
        return nxt


def _entropy_segments(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    """A scan's entropy-coded data from `pos`, split at its RSTn markers
    and unstuffed -> (the intervals, the offset of the marker after it)."""
    end = _entropy_end(data, pos)
    return [seg.replace(b"\xff\x00", b"\xff") for seg in re.split(rb"\xff[\xd0-\xd7]", data[pos:end])], end


class _Scan(NamedTuple):
    comps: List[Tuple[int, int, int]]   # (component index, DC table, AC table)
    ss: int
    se: int
    ah: int
    al: int


def _scan_units(frame: _Frame, blocks: List[np.ndarray], scan: _Scan) -> Tuple[list, list, int]:
    """The component and flat offset of every block of a scan, in its
    order, and the blocks per MCU. An interleaved scan walks the MCU grid;
    a scan of one component walks only the blocks its samples cover
    (`ceil(downsampled size / 8)`), not the padding blocks of the MCU
    grid."""
    hmax = max(c[1] for c in frame.comps)
    vmax = max(c[2] for c in frame.comps)
    if len(scan.comps) == 1:
        ci = scan.comps[0][0]
        _, h, v, _ = frame.comps[ci]
        rows = -(-(-(-frame.height * v // vmax)) // 8)
        cols = -(-(-(-frame.width * h // hmax)) // 8)
        bases = (np.arange(rows)[:, None] * blocks[ci].shape[1] + np.arange(cols)[None, :]) * 64
        return [ci] * bases.size, bases.reshape(-1).tolist(), 1
    mcu_rows, mcu_cols = -(-frame.height // (8 * vmax)), -(-frame.width // (8 * hmax))
    my, mx = np.arange(mcu_rows)[:, None], np.arange(mcu_cols)[None, :]
    comp_ids, parts = [], []
    for ci, _, _ in scan.comps:
        _, h, v, _ = frame.comps[ci]
        for y in range(v):
            for x in range(h):
                comp_ids.append(ci)
                parts.append(((my * v + y) * blocks[ci].shape[1] + mx * h + x) * 64)
    bases = np.stack(parts, axis=-1).reshape(-1)   # MCU order, then the blocks of each MCU
    return comp_ids * (mcu_rows * mcu_cols), bases.tolist(), len(parts)


def _parse_sos(body: bytes, frame: _Frame) -> _Scan:
    ns = body[0]
    ids = [c[0] for c in frame.comps]
    comps = []
    for i in range(ns):
        cid, tsel = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in ids:
            raise ValueError(f"JPEG scan names an unknown component {cid}")
        comps.append((ids.index(cid), tsel >> 4, tsel & 15))
    ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
    scan = _Scan(comps, ss, se, a >> 4, a & 15)
    if frame.lossless:
        if not 1 <= ss <= 7 or se != 0 or scan.ah != 0 or scan.al >= 8:
            raise ValueError("JPEG lossless scan with bad parameters")
    elif not frame.progressive:
        if (ss, se, a) != (0, 63, 0):
            raise ValueError("JPEG sequential scan with a spectral selection")
    elif ss > se or se > 63 or (ss == 0) != (se == 0) or (ss and ns != 1) or scan.al > 13:
        raise ValueError("JPEG progressive scan with bad parameters")
    return scan


def _track_bits(coef_bits: List[List[int]], scan: _Scan, progressive: bool) -> None:
    """jdinput.c's `coef_bits`: for each component and coefficient, the
    low bit position still unknown (-1: never coded); a scan out of the
    order the progression allows raises."""
    for ci, _, _ in scan.comps:
        bits = coef_bits[ci]
        if not progressive and bits[0] >= 0:
            raise ValueError("JPEG sequential component coded in two scans")
        if scan.se < scan.ss:   # a lossless scan: its predictor in Ss
            bits[0] = scan.al
            continue
        for k in range(scan.ss, scan.se + 1):
            if (scan.ah == 0) != (bits[k] < 0) or (scan.ah and scan.ah != bits[k]):
                raise ValueError("JPEG progressive scan out of order")
            bits[k] = scan.al


def _check_refined(coef_bits: List[List[int]]) -> None:
    """libjpeg smooths the low AC coefficients of a progressive file
    (jdcoefct.c `do_block_smoothing`) when its scans leave any bit of the
    first 10 coefficients unknown: such a file is refused, not decoded
    differently from it."""
    if any(b != 0 for bits in coef_bits for b in bits[:10]):
        raise UnsupportedJpeg("progressive (scans leave coefficient bits unrefined, block smoothing)")


# jaricom.c `jpeg_aritab` (Table D.2): Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS
_ARITAB = [int(v, 16) for v in (
    "5a1d0181 2586020e 11140310 080b0412 03d80514 01da0617 00e50719 006f081c 0036091e 001a0a21 000d0b23 00060c09 "
    "00030d0a 00010d0c 5a7f0f8f 3f251024 2cf21126 207c1227 17b91328 1182142a 0cef152b 09a1162d 072f172e 055c1830 "
    "04061931 03031a33 02401b34 01b11c36 01441d38 00f51e39 00b71f3b 008a203c 0068213e 004e223f 003b2320 002c0921 "
    "5ae125a5 484c2640 3a0d2741 2ef12843 261f2944 1f332a45 19a82b46 15182c48 11772d49 0e742e4a 0bfb2f4b 09f8304d "
    "0861314e 0706324f 05cd3330 04de3432 040f3532 03633633 02d43734 025c3835 01f83936 01a43a37 01603b38 01253c39 "
    "00f63d3a 00cb3e3b 00ab3f3d 008f203d 5b1241c1 4d044250 412c4351 37d84452 2fe84553 293c4654 23794756 1edf4857 "
    "1aa94957 174e4a48 14244b48 119c4c4a 0f6b4d4a 0d514e4b 0bb64f4d 0a40304d 583251d0 4d1c5258 438e5359 3bdd545a "
    "34ee555b 2eae565c 299a575d 25164756 557059d8 4ca95a5f 44d95b60 3e225c61 38245d63 32b45e63 2e17565d 56a860df "
    "4f466165 47e56266 41cf6367 3c3d6468 375e5d63 52316669 4c0f676a 4639686b 415e6367 56276ae9 50e76b6c 4b85676d "
    "55976d6e 504f6b6f 5a106fee 55226d70 59eb6ff0 5a1d7171").split()]


def _arith_decoder(seg: bytes):
    """jdarith.c `arith_decode` over one restart interval's bytes (0xFF00
    already unstuffed; zeros after its end, as after a marker) -> (decode
    (stats, index) -> bit, the state's `ct` getter, a setter of the error
    state ct = -1)."""
    c = a = 0
    ct = -16
    pos = 0
    n = len(seg)
    tab = _ARITAB

    def decode(st: bytearray, i: int) -> int:
        nonlocal c, a, ct, pos
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                if pos < n:
                    c = (c << 8) | seg[pos]
                    pos += 1
                else:
                    c <<= 8
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = tab[sv & 0x7F]
        nl = qe & 0xFF
        qe >>= 8
        nm = qe & 0xFF
        qe >>= 8
        temp = a - qe
        a = temp
        temp <<= ct
        if c >= temp:
            c -= temp
            if a < qe:
                a = qe
                st[i] = (sv & 0x80) ^ nm
            else:
                a = qe
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        return sv >> 7

    def failed() -> bool:
        return ct == -1

    def fail() -> None:
        nonlocal ct
        ct = -1

    return decode, failed, fail


def _s16(v: int) -> int:
    """A C `(JCOEF)` cast: the low 16 bits as a signed value."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _dc_diff(decode, st: bytearray, ctx: int, dc_l: int, dc_u: int, fail):
    """Figures F.19-F.24 (jdarith.c): one DC difference from the bins
    `st` at conditioning `ctx` -> (difference, next context), or None on a
    magnitude overflow (the decoder then stays in its error state)."""
    if not decode(st, ctx):
        return 0, 0
    sign = decode(st, ctx + 1)
    s = ctx + 2 + sign
    m = decode(st, s)
    if m:
        s = 20
        while decode(st, s):
            m <<= 1
            if m == 0x8000:
                fail()
                return None
            s += 1
    if m < (1 << dc_l) >> 1:
        ctx = 0
    elif m > (1 << dc_u) >> 1:
        ctx = 12 + sign * 4
    else:
        ctx = 4 + sign * 4
    v = m
    s += 14
    while m > 1:
        m >>= 1
        if decode(st, s):
            v |= m
    return (-(v + 1) if sign else v + 1), ctx


def _ac_magnitude(decode, st: bytearray, s: int, k: int, ac_k: int, fail):
    """Figures F.23-F.24 for coefficient `k` from its category bin `s`
    -> the magnitude, or None on an overflow."""
    m = decode(st, s)
    if m and decode(st, s):
        m <<= 1
        s = 189 if k <= ac_k else 217
        while decode(st, s):
            m <<= 1
            if m == 0x8000:
                fail()
                return None
            s += 1
    v = m
    s += 14
    while m > 1:
        m >>= 1
        if decode(st, s):
            v |= m
    return v + 1


_FIXED = 113   # jdarith.c `fixed_bin`: a state whose estimate never moves


def _arith_interval(seg: bytes, units, blk_of, scan: "_Scan", tables, progressive: bool) -> None:
    """One restart interval of an arithmetic-coded scan (jdarith.c
    `decode_mcu`, `decode_mcu_DC_first` / `_refine`, `decode_mcu_AC_first`
    / `_refine`): statistics and DC predictions start from zero; after a
    magnitude or spectral overflow the rest of the interval decodes
    nothing. `units` yields (component, flat offset of the block);
    `tables[ci]` is (DC table, AC table, DC L, DC U, AC K)."""
    decode, failed, fail = _arith_decoder(seg)
    dc_st, ac_st = {}, {}
    for ci, (td, ta, *_rest) in tables.items():
        dc_st.setdefault(td, bytearray(64))
        ac_st.setdefault(ta, bytearray(256))
    fixed = bytearray([_FIXED])
    last = dict.fromkeys(tables, 0)
    ctx = dict.fromkeys(tables, 0)
    zz = ZIGZAG.tolist()
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    p1, m1 = 1 << al, -1 << al
    if progressive and ss == 0 and ah:   # DC refinement: one fixed-probability bit a block
        for ci, base in units:
            if decode(fixed, 0):
                blk_of[ci][base] |= p1
        return
    for ci, base in units:
        if failed():
            return
        blk = blk_of[ci]
        td, ta, dc_l, dc_u, ac_k = tables[ci]
        if not progressive or ss == 0:
            res = _dc_diff(decode, dc_st[td], ctx[ci], dc_l, dc_u, fail)
            if res is None:
                return
            diff, ctx[ci] = res
            last[ci] = (last[ci] + diff) & 0xFFFF
            blk[base] = _s16(last[ci] << al) if progressive else _s16(last[ci])
            if progressive:
                continue
        st = ac_st[ta]
        if progressive and ah:   # AC refinement
            kex = se
            while kex > 0 and not blk[base + zz[kex]]:
                kex -= 1
            k = ss
            while k <= se:
                s = 3 * (k - 1)
                if k > kex and decode(st, s):
                    break
                while True:
                    i = base + zz[k]
                    if blk[i]:
                        if decode(st, s + 2):
                            blk[i] = _s16(blk[i] + (m1 if blk[i] < 0 else p1))
                        break
                    if decode(st, s + 1):
                        blk[i] = _s16(m1 if decode(fixed, 0) else p1)
                        break
                    s += 3
                    k += 1
                    if k > se:
                        fail()
                        return
                k += 1
            continue
        k = ss if progressive else 1
        end = se if progressive else 63
        while k <= end:
            s = 3 * (k - 1)
            if decode(st, s):   # end of block
                break
            while not decode(st, s + 1):
                s += 3
                k += 1
                if k > end:
                    fail()
                    return
            sign = decode(fixed, 0)
            v = _ac_magnitude(decode, st, s + 2, k, ac_k, fail)
            if v is None:
                return
            blk[base + zz[k]] = _s16((-v if sign else v) << al)
            k += 1


# ------------------------------------------------------- lossless (SOF3)


def _huff_steps(seg: bytes, lut: np.ndarray, nbits: int) -> Tuple[np.ndarray, np.ndarray]:
    """For every bit position of an interval (and one past its end, and a
    sink after that): the position after the difference coded there, and
    its value (jdlhuff.c: a category, then that many bits; category 16 is
    32768 with no bits). A bad code, or one running past the data, goes
    to the sink."""
    sink = nbits + 1
    b = np.frombuffer(seg + b"\xff" * 8, np.uint8).astype(np.uint32)
    w32 = (b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]
    p = np.arange(nbits + 2, dtype=np.int32)
    p[sink] = 0
    e = lut[(w32[p >> 3] >> (16 - (p & 7)).astype(np.uint32)) & 0xFFFF]
    length, cat = e & 0xFF, e >> 8
    extra = np.where(cat < 16, cat, 0)
    q = p + length
    # a shift of 32 (no extra bits at a byte boundary) is masked to nothing below
    r = ((w32[q >> 3] >> (32 - (q & 7) - extra).astype(np.uint32)) & ((1 << extra) - 1).astype(np.uint32))
    r = r.astype(np.int32)
    value = np.where(cat == 16, 32768, np.where(r < (1 << np.maximum(extra - 1, 0)), r - (1 << extra) + 1, r))
    value = np.where(cat == 0, 0, value)
    nxt = q + extra
    nxt = np.where((length == 0) | (nxt > nbits), sink, nxt)
    nxt[sink] = sink
    return nxt, value


def _lossless_interval(seg: bytes, luts: List[np.ndarray], n_mcu: int) -> np.ndarray:
    """Huffman-decode `n_mcu` MCUs of one interval, `luts[k]` the table of
    the MCU's k-th sample -> (n_mcu, len(luts)) differences. The codes are
    found without a loop over samples: each position's successor is
    known for every bit, the MCU successor is their composition, and the
    MCU starts come from a power of it (strides of `jump` MCUs walked in
    Python, the MCUs between them by arrays)."""
    nbits = len(seg) * 8
    sink = nbits + 1
    steps = {}
    for lut in luts:
        if id(lut) not in steps:
            steps[id(lut)] = _huff_steps(seg, lut, nbits)
    mcu = steps[id(luts[0])][0]
    for lut in luts[1:]:
        mcu = steps[id(lut)][0][mcu]
    jump = 1
    far = mcu
    while jump * jump < n_mcu:
        far = far[far]
        jump *= 2
    starts = [0]
    for _ in range((n_mcu - 1) // jump):
        starts.append(int(far[starts[-1]]))
    starts = np.array(starts, np.int64)
    pos = np.empty((len(starts), jump), np.int64)
    cur = starts
    for t in range(jump):
        pos[:, t] = cur
        cur = mcu[cur]
    pos = pos.reshape(-1)[:n_mcu]
    out = np.empty((n_mcu, len(luts)), np.int64)
    for k, lut in enumerate(luts):
        nxt, value = steps[id(lut)]
        if (pos >= nbits).any():
            raise ValueError("corrupt or truncated lossless JPEG data")
        out[:, k] = value[pos]
        pos = nxt[pos]
    if (pos == sink).any():
        raise ValueError("corrupt or truncated lossless JPEG data")
    return out


def _undifference(diff: np.ndarray, psv: int, first: np.ndarray, init: int) -> np.ndarray:
    """jdpred.c on one component's (rows, cols) differences: a row that
    starts the scan or a restart interval predicts from `init`, then from
    the sample to its left; any other row's first sample from the one
    above, the rest with predictor `psv` (Ra left, Rb above, Rc above
    left); sums are taken modulo 2^16. Computed one anti-diagonal at a
    time, whose samples depend only on the two before it."""
    rows, cols = diff.shape
    x = np.zeros((rows + 1, cols + 1), np.int64)   # x[i + 1, j + 1] is sample (i, j)
    for d in range(rows + cols - 1):
        i = np.arange(max(0, d - cols + 1), min(rows - 1, d) + 1)
        j = d - i
        ra, rb, rc = x[i + 1, j], x[i, j + 1], x[i, j]
        if psv == 1:
            pred = ra
        elif psv == 2:
            pred = rb
        elif psv == 3:
            pred = rc
        elif psv == 4:
            pred = ra + rb - rc
        elif psv == 5:
            pred = ra + ((rb - rc) >> 1)
        elif psv == 6:
            pred = rb + ((ra - rc) >> 1)
        else:
            pred = (ra + rb) >> 1
        top = first[i]
        pred = np.where(j == 0, np.where(top, init, rb), np.where(top, ra, pred))
        x[i + 1, j + 1] = (pred + diff[i, j]) & 0xFFFF
    return x[1:, 1:]


def _lossless_scan(frame: _Frame, scan: "_Scan", intervals: List[bytes], restart: int, dc_specs: dict,
                   samples: list) -> None:
    """One lossless scan (jddiffct.c, jdlhuff.c, jdpred.c, jdlossls.c):
    the differences of each MCU (an interleaved scan's MCU holds v x h
    samples of each component, a single component's MCU one sample), a
    restart interval being whole MCU rows; then each component
    undifferenced over its own width and scaled up by the point
    transform into 8-bit samples."""
    hmax = max(c[1] for c in frame.comps)
    vmax = max(c[2] for c in frame.comps)
    sizes = [(-(-frame.height * v // vmax), -(-frame.width * h // hmax)) for _, h, v, _ in frame.comps]
    if len(scan.comps) == 1:
        ci = scan.comps[0][0]
        mcu_rows, mcu_cols = sizes[ci]
        layout = [(ci, 0, 0)]
        dims = {ci: (1, 1)}
    else:
        mcu_rows, mcu_cols = -(-frame.height // vmax), -(-frame.width // hmax)
        layout, dims = [], {}
        for ci, _, _ in scan.comps:
            _, h, v, _ = frame.comps[ci]
            dims[ci] = (v, h)
            layout += [(ci, dy, dx) for dy in range(v) for dx in range(h)]
    luts = []
    for ci, td, _ in scan.comps:
        if dc_specs.get(td) is None:
            raise ValueError("JPEG scan uses an undefined Huffman table")
    lut_of = {td: np.asarray(dc_specs[td], np.int32) for _, td, _ in scan.comps}
    table = {ci: td for ci, td, _ in scan.comps}
    luts = [lut_of[table[ci]] for ci, _, _ in layout]
    n = mcu_rows * mcu_cols
    if restart and restart % mcu_cols:
        raise UnsupportedJpeg("lossless with a restart interval of part of an MCU row")
    step = restart or n
    if len(intervals) < -(-n // step):
        raise ValueError("truncated JPEG image data")
    diffs = np.concatenate([_lossless_interval(intervals[i // step], luts,
                                               min(step, n - i)) for i in range(0, n, step)])
    g = np.arange(n)
    my, mx = g // mcu_cols, g % mcu_cols
    planes = {ci: np.zeros((mcu_rows * v, mcu_cols * h), np.int64) for ci, (v, h) in dims.items()}
    for k, (ci, dy, dx) in enumerate(layout):
        v, h = dims[ci]
        planes[ci][my * v + dy, mx * h + dx] = diffs[:, k]
    init = 1 << (8 - scan.al - 1)
    for ci, (v, h) in dims.items():
        rows, cols = sizes[ci]
        first = np.zeros(rows, bool)
        first[::(step // mcu_cols) * v] = True
        undiff = _undifference(planes[ci][:rows, :cols], scan.ss, first, init)
        samples[ci] = ((undiff << scan.al) & 0xFF).astype(np.uint8)


def _lossless_pixels(coeffs: JpegCoefficients, samples: list) -> np.ndarray:
    """A lossless file's samples -> pixels: each component replicated to
    full size (libjpeg does no fancy upsampling at a DCT size of 1), then
    the colour conversion of a DCT file."""
    hmax = max(c.h for c in coeffs.components)
    vmax = max(c.v for c in coeffs.components)
    planes = [np.repeat(np.repeat(sm, vmax // c.v, axis=0), hmax // c.h, axis=1)[:coeffs.height, :coeffs.width]
              for sm, c in zip(samples, coeffs.components)]
    return _convert(coeffs.color, planes)


def read_jpeg_coefficients(data: bytes) -> JpegCoefficients:
    """JPEG bytes -> the quantized coefficients of every component after
    all its scans, with the quantization tables latched at each
    component's first scan (jdinput.c), and how they map to pixels."""
    return _read_frame(data)[0]


def _read_frame(data: bytes, pillow_blocks: bool = True):
    """-> (coefficients; a lossless file's (H, W) uint8 component samples,
    else None). `pillow_blocks=False` decodes an arithmetic-coded file
    Pillow cannot load (`_check_arith_fed`), to time the decoder on it."""
    qtables, dc_specs, ac_specs = {}, {}, {}
    dac_dc, dac_ac = {}, {}   # arithmetic conditioning (DAC): L and U of DC tables, K of AC tables
    samples = None
    latched = {}
    frame = None
    restart = 0
    jfif = adobe = False
    adobe_transform = None
    blocks = coef = None
    coef_bits = None
    pos, fed = 2, _PILLOW_BLOCK
    while True:
        for marker, body, pos in _segments(data, pos):
            fed = _fed(pos, fed)
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
                if frame is not None:
                    raise ValueError("JPEG has a second frame header")
                frame = _check_sof(marker, body)
            elif marker == 0xCC:
                for i in range(0, len(body) - 1, 2):
                    tc, tb, cs = body[i] >> 4, body[i] & 15, body[i + 1]
                    if tc == 0:
                        if cs & 15 > cs >> 4:
                            raise ValueError("JPEG DAC segment with L above U")
                        dac_dc[tb] = (cs & 15, cs >> 4)
                    elif not 1 <= cs <= 63:
                        raise ValueError("JPEG DAC segment with K outside 1..63")
                    else:
                        dac_ac[tb] = cs
        if marker == 0xD9:
            break
        # an SOS: decode its scan
        if frame is None:
            raise ValueError("JPEG has no frame header before its scan")
        if blocks is None:
            hmax = max(c[1] for c in frame.comps)
            vmax = max(c[2] for c in frame.comps)
            mcu_rows, mcu_cols = -(-frame.height // (8 * vmax)), -(-frame.width // (8 * hmax))
            blocks = [np.zeros((0 if frame.lossless else mcu_rows * v, mcu_cols * h, 64), np.int64)
                      for _, h, v, _ in frame.comps]
            coef = [[0] * b.size for b in blocks] if frame.progressive or frame.arith else [([], []) for _ in blocks]
            coef_bits = [[-1] * 64 for _ in blocks]
        scan = _parse_sos(body, frame)
        for ci, td, ta in scan.comps:
            if ci not in latched and frame.lossless:
                latched[ci] = np.ones(64, np.int64)
            elif ci not in latched:
                tq = frame.comps[ci][3]
                if tq not in qtables:
                    raise ValueError(f"JPEG uses an undefined quantization table {tq}")
                latched[ci] = qtables[tq].copy()
        _track_bits(coef_bits, scan, frame.progressive)
        intervals, pos = _entropy_segments(data, pos)
        if frame.lossless:
            samples = samples or [None] * len(frame.comps)
            _lossless_scan(frame, scan, intervals, restart, dc_specs, samples)
            continue
        comp_of, bases, per_mcu = _scan_units(frame, blocks, scan)
        step = (restart or len(bases) // per_mcu) * per_mcu
        if len(intervals) < -(-len(bases) // step):
            raise ValueError("truncated JPEG image data")
        if frame.arith:
            if pillow_blocks:
                _check_arith_fed(data, pos, fed)
            tables = {ci: (td, ta) + dac_dc.get(td, (0, 1)) + (dac_ac.get(ta, 5),) for ci, td, ta in scan.comps}
            for i in range(0, len(bases), step):
                part = slice(i, i + step)
                _arith_interval(intervals[i // step], zip(comp_of[part], bases[part]), coef, scan, tables, frame.progressive)
            continue
        if not frame.progressive or scan.ss == 0:
            dc = {ci: dc_specs.get(td) for ci, td, _ in scan.comps}
            ac = {ci: ac_specs.get(ta) for ci, _, ta in scan.comps}
            if (not scan.ah and None in dc.values()) or (not frame.progressive and None in ac.values()):
                raise ValueError("JPEG scan uses an undefined Huffman table")
        elif ac_specs.get(scan.comps[0][2]) is None:
            raise ValueError("JPEG scan uses an undefined Huffman table")
        for i in range(0, len(bases), step):
            seg, part = intervals[i // step], slice(i, i + step)
            if not frame.progressive:
                _decode_interval(seg, zip(comp_of[part], bases[part]), len(bases[part]), coef,
                                 {ci: (dc[ci], ac[ci]) for ci in dc})
            elif scan.ss == 0:
                _decode_dc_progressive(seg, zip(comp_of[part], bases[part]), coef, dc, scan.ah, scan.al)
            else:
                ci, _, ta = scan.comps[0]
                decode = _decode_ac_refine if scan.ah else _decode_ac_first
                decode(seg, bases[part], coef[ci], ac_specs[ta], scan.ss, scan.se, scan.al)
    if blocks is None:
        raise ValueError("JPEG ends before its image data")
    if len(latched) != len(frame.comps) or (samples is not None and any(sm is None for sm in samples)):
        raise ValueError("JPEG component without a scan")
    if frame.progressive:
        _check_refined(coef_bits)
    if frame.progressive or frame.arith:
        for blk, c in zip(blocks, coef):
            blk.reshape(-1)[:] = c
    else:
        for blk, (idx, val) in zip(blocks, coef):
            blk.reshape(-1)[np.asarray(idx, np.int64)] = np.asarray(val, np.int64)
    ids = [c[0] for c in frame.comps]
    comps = tuple(JpegComponent(blk, latched[ci], h, v) for ci, (blk, (_, h, v, _)) in enumerate(zip(blocks, frame.comps)))
    if len(comps) == 1:
        color = "L"
    elif len(comps) == 4:
        # jdapimin.c `default_decompress_parms`: Adobe transform 0 or no Adobe
        # marker -> CMYK, any other transform -> YCCK
        color = "YCCK" if adobe and adobe_transform != 0 else "CMYK"
    elif jfif:
        color = "YCbCr"
    elif adobe:
        color = "RGB" if adobe_transform == 0 else "YCbCr"
    elif ids == [1, 2, 3]:
        color = "YCbCr"
    else:   # jdapimin.c: unknown ids are RGB in a lossless file, YCbCr otherwise
        color = "RGB" if ids == [82, 71, 66] or frame.lossless else "YCbCr"
    return JpegCoefficients(frame.height, frame.width, comps, color), samples


def read_jpeg(data: bytes, color: "str | None" = None, pillow_blocks: bool = True) -> Tuple[np.ndarray, str]:
    """JPEG bytes -> (pixels, mode) as Pillow's `Image.open` decodes them:
    mode "L" gives (H, W), mode "RGB" (H, W, 3), mode "CMYK" (H, W, 4)
    uint8. `color` ("RGB" or "YCbCr") overrides what the markers say of a
    file of 3 or 4 components ("RGB": the stored samples), as libtiff does
    for a JPEG strip of a TIFF; `pillow_blocks` as `_read_frame` has it."""
    coeffs, samples = _read_frame(data, pillow_blocks)
    if color is not None and len(coeffs.components) > 1:
        coeffs = coeffs._replace(color=color)
    mode = {"L": "L", "CMYK": "CMYK", "YCCK": "CMYK"}.get(coeffs.color, "RGB")
    if samples is not None:
        return _lossless_pixels(coeffs, samples), mode
    return _reconstruct(coeffs), mode


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8, as Pillow's `convert("RGB")`."""
    from morphik_core_tpu_torch.models.colqwen.preprocess import to_rgb_u8

    return to_rgb_u8(*read_jpeg(data), None)
