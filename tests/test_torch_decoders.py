"""The image forms that connector files bring, decoded by the port as
Pillow 12.1 (libjpeg-turbo) decodes them, on the CPU. Tolerance: exact
everywhere (coefficients, uint8 / uint16 pixels, payload bytes).

- Progressive JPEGs (SOF2) as Pillow writes them: 4:2:0, 4:2:2, 4:4:4
  and gray, with and without restart intervals, hypothesis over sizes
  that are not multiples of 16. Each scan type is held on its own: the
  scan list of a Pillow file is cut after every scan and the port's
  coefficients compared with those of a bit-by-bit decoder written here
  (`_RefDecoder`), and a file cut short of its last refinements is
  refused (libjpeg would smooth its blocks).
- Multi-scan sequential JPEGs: one non-interleaved scan per component,
  written here from the port encoder's coefficients (`multiscan_jpeg`),
  with and without restart intervals.
- PNGs written here (`png_bytes`: every filter type, Adam7 or not) at
  every color type and bit depth, images smaller than 8 x 8 (empty Adam7
  passes) among them; 16-bit PNGs of color types 0, 2, 4 and 6 with and
  without tRNS through `read_png`'s mode and palette contract, through
  `_image_to_data_uri` (the q80 payload bytes of the reference's
  function, I;16 wider than 1024 resized in 16 bits) and through the
  image query's pixels.
- The committed connector fixtures (`tests/fixtures/connector_files.npz`,
  `chip_smoke.py` phase 16's files) regenerate byte for byte, and decode
  to the pixels and payloads the reference gives.
"""

import hashlib
import io
import re
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st
from PIL import Image

from morphik_core_tpu_torch.models.colqwen.preprocess import to_rgb_u8
from morphik_core_tpu_torch.parser.text_render import render_text_page
from morphik_core_tpu_torch.services.ingestion_service import _image_to_data_uri
from morphik_core_tpu_torch.utils import jpeg as tjpeg
from morphik_core_tpu_torch.utils.fast_ops import data_uri_to_bytes
from morphik_core_tpu_torch.utils.image import decode_image, read_image
from morphik_core_tpu_torch.utils.jpeg import (
    ZIGZAG,
    UnsupportedJpeg,
    _entropy_encode,
    _marker,
    decode_jpeg,
    encode_jpeg,
    probe_jpeg,
    read_jpeg_coefficients,
)
from morphik_core_tpu_torch.utils.png import read_png

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "connector_files.npz"


def _pil_jpeg(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _smooth(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """A bicubic upsample of coarse noise with a white band (structure
    that leaves coefficients in every scan), uint8."""
    rng = np.random.default_rng(seed)
    shape = (h // 6 + 2, w // 6 + 2) + ((channels,) if channels > 1 else ())
    out = np.array(Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).resize((w, h), Image.BICUBIC))
    out[: h // 5] = 255
    return out


# ----------------------------------------------------------- JPEG writers

SUBSAMPLING = {"420": 2, "422": 1, "444": 0}


def multiscan_jpeg(pixels: np.ndarray, quality: int, restart: int = 0) -> bytes:
    """A sequential JPEG with one non-interleaved scan per component (the
    standard tables, the port encoder's coefficients): each scan codes
    only the blocks its component's samples cover, `restart` blocks to an
    interval."""
    one_scan, coeffs = encode_jpeg(pixels, quality)
    hmax = max(c.h for c in coeffs.components)
    vmax = max(c.v for c in coeffs.components)
    head = one_scan[: one_scan.index(b"\xff\xda")]   # SOI, APP0, DQT, SOF0, DHT
    if restart:
        head += _marker(0xDD, struct.pack(">H", restart))
    scans = b""
    for ci, comp in enumerate(coeffs.components):
        rows = -(-(-(-coeffs.height * comp.v // vmax)) // 8)
        cols = -(-(-(-coeffs.width * comp.h // hmax)) // 8)
        zz = comp.blocks[:rows, :cols].reshape(-1, 64)[:, ZIGZAG]
        step = restart or len(zz)
        parts = [_entropy_encode(zz[i:i + step], np.full(len(zz[i:i + step]), min(ci, 1)),
                                 np.zeros(len(zz[i:i + step]), np.int64)) for i in range(0, len(zz), step)]
        data = b"".join(p + (bytes([0xFF, 0xD0 + n % 8]) if n < len(parts) - 1 else b"") for n, p in enumerate(parts))
        scans += _marker(0xDA, bytes([1, ci + 1, min(ci, 1) * 0x11, 0, 63, 0])) + data
    return head + scans + b"\xff\xd9"


def _n_scans(data: bytes) -> int:
    n, pos = 0, 2
    while True:
        for marker, _, pos in tjpeg._segments(data, pos):
            pass
        if marker == 0xD9:
            return n
        n += 1
        pos = tjpeg._entropy_end(data, pos)


def _cut_after_scan(data: bytes, n: int) -> bytes:
    """The file with its scans after the n-th dropped (the tables before
    the next scan too), then EOI."""
    pos, seen = 2, 0
    while True:
        for marker, _, pos in tjpeg._segments(data, pos):
            pass
        if marker == 0xD9:
            return data
        end = tjpeg._entropy_end(data, pos)
        seen += 1
        if seen == n:
            return data[:end] + b"\xff\xd9"
        pos = end


class _RefDecoder:
    """A progressive and sequential Huffman decoder written from the
    standard (ITU T.81 Annex G), one bit at a time: the coefficients it
    returns are the port's check, scan by scan."""

    def __init__(self, data: bytes):
        self.data = data

    def bits_of(self, seg: bytes):
        for byte in seg:
            for i in range(7, -1, -1):
                yield (byte >> i) & 1

    def run(self):
        d = self.data
        dc_t, ac_t = {}, {}
        frame, restart, coef = None, 0, None
        pos = 2
        while True:
            (m,) = struct.unpack(">H", d[pos:pos + 2])
            if m == 0xFFD9:
                return frame, coef
            (n,) = struct.unpack(">H", d[pos + 2:pos + 4])
            body = d[pos + 4:pos + 2 + n]
            pos += 2 + n
            if m == 0xFFC4:
                i = 0
                while i < len(body):
                    counts, k, code, table = body[i + 1:i + 17], i + 17, 0, {}
                    for length in range(1, 17):
                        for _ in range(counts[length - 1]):
                            table[(length, code)] = body[k]
                            k, code = k + 1, code + 1
                        code <<= 1
                    (ac_t if body[i] >> 4 else dc_t)[body[i] & 15] = table
                    i = k
            elif m == 0xFFDD:
                (restart,) = struct.unpack(">H", body[:2])
            elif m in (0xFFC0, 0xFFC1, 0xFFC2):
                h, w, nc = struct.unpack(">HHB", body[1:6])
                comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15) for i in range(nc)]
                hm, vm = max(c[1] for c in comps), max(c[2] for c in comps)
                mr, mc = -(-h // (8 * vm)), -(-w // (8 * hm))
                frame = dict(h=h, w=w, comps=comps, hm=hm, vm=vm, mr=mr, mc=mc, prog=m == 0xFFC2)
                coef = [np.zeros((mr * c[2], mc * c[1], 64), np.int64) for c in comps]
            elif m == 0xFFDA:
                end = tjpeg._entropy_end(d, pos)
                self.scan(frame, coef, body, d[pos:end], dc_t, ac_t, restart)
                pos = end

    def scan(self, f, coef, body, raw, dc_t, ac_t, restart):
        ns = body[0]
        ids = [c[0] for c in f["comps"]]
        sc = [(ids.index(body[1 + 2 * i]), body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15) for i in range(ns)]
        ss, se, ah, al = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15
        if ns == 1:
            ci = sc[0][0]
            _, h, v = f["comps"][ci]
            rows = -(-(-(-f["h"] * v // f["vm"])) // 8)
            cols = -(-(-(-f["w"] * h // f["hm"])) // 8)
            mcus = [[(ci, r, c)] for r in range(rows) for c in range(cols)]
        else:
            mcus = [[(ci, my * f["comps"][ci][2] + y, mx * f["comps"][ci][1] + x) for ci, _, _ in sc
                     for y in range(f["comps"][ci][2]) for x in range(f["comps"][ci][1])]
                    for my in range(f["mr"]) for mx in range(f["mc"])]
        segs = [s.replace(b"\xff\x00", b"\xff") for s in re.split(rb"\xff[\xd0-\xd7]", raw)]
        per = restart or len(mcus)
        tabs = {ci: (dc_t.get(td), ac_t.get(ta)) for ci, td, ta in sc}
        for n in range(0, len(mcus), per):
            bits = self.bits_of(segs[n // per])

            def get(k):
                v = 0
                for _ in range(k):
                    v = (v << 1) | next(bits)
                return v

            def huff(table):
                code, length = 0, 0
                while True:
                    code, length = (code << 1) | next(bits), length + 1
                    if (length, code) in table:
                        return table[(length, code)]

            def extend(v, s):
                return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v

            pred = {ci: 0 for ci, _, _ in sc}
            eobrun = 0
            for mcu in mcus[n:n + per]:
                for ci, r, c in mcu:
                    blk = coef[ci][r, c]
                    dct, act = tabs[ci]
                    if not f["prog"]:
                        s = huff(dct)
                        pred[ci] += extend(get(s), s)
                        blk[0] = pred[ci]
                        k = 1
                        while k < 64:
                            rs = huff(act)
                            r_, s = rs >> 4, rs & 15
                            if s:
                                k += r_
                                blk[ZIGZAG[k]] = extend(get(s), s)
                                k += 1
                            elif r_ == 15:
                                k += 16
                            else:
                                break
                    elif ss == 0 and ah == 0:
                        s = huff(dct)
                        pred[ci] += extend(get(s), s)
                        blk[0] = pred[ci] * (1 << al)
                    elif ss == 0:
                        if get(1):
                            blk[0] |= 1 << al
                    elif ah == 0:
                        if eobrun:
                            eobrun -= 1
                            continue
                        k = ss
                        while k <= se:
                            rs = huff(act)
                            r_, s = rs >> 4, rs & 15
                            if s:
                                k += r_
                                blk[ZIGZAG[k]] = extend(get(s), s) * (1 << al)
                                k += 1
                            elif r_ == 15:
                                k += 16
                            else:
                                eobrun = (1 << r_) + get(r_) - 1
                                break
                    else:
                        eobrun = self.refine(blk, ss, se, al, act, get, huff, eobrun)

    @staticmethod
    def refine(blk, ss, se, al, act, get, huff, eobrun) -> int:
        """G.1.2.3: correction bits for nonzero history, new coefficients
        of magnitude 1 << al, EOB runs."""
        p = 1 << al

        def correct(z):
            if get(1) and (abs(blk[z]) & p) == 0:
                blk[z] += p if blk[z] > 0 else -p

        k = ss
        if eobrun == 0:
            while k <= se:
                rs = huff(act)
                r_, s = rs >> 4, rs & 15
                new = 0
                if s:
                    new = p if get(1) else -p
                elif r_ != 15:
                    eobrun = (1 << r_) + get(r_)
                    break
                while k <= se:
                    z = ZIGZAG[k]
                    if blk[z]:
                        correct(z)
                    elif r_ == 0:
                        if new:
                            blk[z] = new
                        k += 1
                        break
                    else:
                        r_ -= 1
                    k += 1
        if eobrun:
            while k <= se:
                z = ZIGZAG[k]
                if blk[z]:
                    correct(z)
                k += 1
            eobrun -= 1
        return eobrun


def _ref_coefficients(data: bytes):
    frame, coef = _RefDecoder(data).run()
    return coef


def _port_coefficients(data: bytes, monkeypatch):
    """The port's coefficients of a file whose scans may stop short (the
    refusal of unrefined files lifted for the comparison)."""
    monkeypatch.setattr(tjpeg, "_check_refined", lambda bits: None)
    try:
        return [c.blocks for c in read_jpeg_coefficients(data).components]
    finally:
        monkeypatch.undo()


# ----------------------------------------------------------- JPEG tests


@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 90), w=st.integers(1, 90), kind=st.sampled_from(["420", "422", "444", "gray"]),
       quality=st.sampled_from([40, 75, 80, 95]), restart=st.sampled_from([0, 1, 3]),
       seed=st.integers(0, 2**16))
def test_progressive_jpeg_matches_pillow(h, w, kind, quality, restart, seed):
    if (h % 16 == 0 and w % 16 == 0) and h > 1:
        h -= 1   # sizes off the MCU grid
    gray = kind == "gray"
    img = Image.fromarray(_smooth(h, w, 1 if gray else 3, seed))
    kw = dict(quality=quality, progressive=True)
    if not gray:
        kw["subsampling"] = SUBSAMPLING[kind]
    if restart:
        kw["restart_marker_blocks"] = restart
    data = _pil_jpeg(img, **kw)
    assert data[data.index(b"\xff\xc2"):][:2] == b"\xff\xc2"
    assert np.array_equal(decode_jpeg(data), _pil_rgb(data))
    assert probe_jpeg(data) == (w, h, 1 if gray else 3)


@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 90), w=st.integers(1, 90), gray=st.booleans(), quality=st.sampled_from([50, 80, 95]),
       restart=st.sampled_from([0, 1, 5]), seed=st.integers(0, 2**16))
def test_multiscan_jpeg_matches_pillow(h, w, gray, quality, restart, seed):
    px = _smooth(h, w, 1 if gray else 3, seed)
    data = multiscan_jpeg(px, quality, restart)
    want = _pil_rgb(data)
    assert np.array_equal(decode_jpeg(data), want)
    # the same coefficients as the one-scan file of the same pixels
    one_scan, _ = encode_jpeg(px, quality)
    assert np.array_equal(_pil_rgb(one_scan), want)


@pytest.mark.parametrize("kind,restart", [("420", 0), ("444", 2), ("gray", 0), ("422", 1)])
def test_progressive_scans_one_by_one(kind, restart, monkeypatch):
    """The scan list of a Pillow file cut after each scan: DC first, AC
    first (spectral bands, EOB runs), DC and AC refinement, each against
    the bit-by-bit decoder; the cut files leave bits unrefined, so the
    port refuses to decode them (libjpeg smooths such blocks)."""
    gray = kind == "gray"
    img = Image.fromarray(_smooth(45, 61, 1 if gray else 3, 7))
    kw = dict(quality=85, progressive=True)
    if not gray:
        kw["subsampling"] = SUBSAMPLING[kind]
    if restart:
        kw["restart_marker_blocks"] = restart
    data = _pil_jpeg(img, **kw)
    n_scans = _n_scans(data)
    assert n_scans >= 6
    for n in range(1, n_scans + 1):
        cut = _cut_after_scan(data, n)
        got, want = _port_coefficients(cut, monkeypatch), _ref_coefficients(cut)
        for g, r in zip(got, want):
            assert np.array_equal(g, r), (n, n_scans)
        if n < n_scans:
            with pytest.raises(UnsupportedJpeg, match="unrefined.*ROADMAP Queue 1 item 3b-ii"):
                decode_jpeg(cut)
            with pytest.raises(UnsupportedJpeg, match="unrefined"):
                probe_jpeg(cut)
    assert np.array_equal(decode_jpeg(data), _pil_rgb(data))


def test_multiscan_coefficients_match_the_reference_decoder(monkeypatch):
    px = _smooth(37, 50, 3, 3)
    data = multiscan_jpeg(px, 80, restart=2)
    for g, r in zip(_port_coefficients(data, monkeypatch), _ref_coefficients(data)):
        assert np.array_equal(g, r)


# ------------------------------------------------------------- PNG writer

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _filter_row(line: np.ndarray, prior: np.ndarray, kind: int, bpp: int) -> bytes:
    """PNG filter `kind` of one row of bytes (int64 arrays)."""
    left = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(line)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prior
    elif kind == 3:
        pred = (left + prior) >> 1
    else:
        ul = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        p = left + prior - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - ul)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, ul))
    return ((line - pred) & 0xFF).astype(np.uint8).tobytes()


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, ch) samples -> (h, stride) bytes."""
    h, w, ch = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    bits = ((samples[..., 0, None].astype(np.int64) >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, w * depth)
    return np.packbits(bits.astype(np.uint8), axis=1)


def png_bytes(samples: np.ndarray, depth: int, color: int, interlace: bool = False, seed: int = 0,
              palette: bytes = None, trns: bytes = None, filters=(0, 1, 2, 3, 4)) -> bytes:
    """A PNG of these samples (any color type and bit depth, Adam7 or
    not), each row filtered with a type drawn from `filters`."""
    samples = np.asarray(samples, np.int64)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    rng = np.random.default_rng(seed)
    raw = []
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue   # an empty pass has no rows
        rows = _pack_rows(sub, depth).astype(np.int64)
        prior = np.zeros(rows.shape[1], np.int64)
        for line in rows:
            kind = int(rng.choice(filters))
            raw.append(bytes([kind]) + _filter_row(line, prior, kind, bpp))
            prior = line

    def chunk(t: bytes, b: bytes) -> bytes:
        return struct.pack(">I", len(b)) + t + b + struct.pack(">I", zlib.crc32(t + b))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", palette)
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(b"".join(raw), 6)) + chunk(b"IEND", b"")


def _pil_pixels(data: bytes):
    im = Image.open(io.BytesIO(data))
    im.load()
    px = np.asarray(im)
    return im, (px.astype(np.uint8) * 255 if im.mode == "1" else px)


DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 21), w=st.integers(1, 21), color=st.sampled_from([0, 2, 3, 4, 6]),
       depth_i=st.integers(0, 4), seed=st.integers(0, 2**16))
def test_adam7_png_matches_pillow(h, w, color, depth_i, seed):
    """Adam7 at every color type and bit depth, sizes below 8 x 8 (whole
    passes empty) among them: the mode, the pixels and the RGB."""
    depth = DEPTHS[color][depth_i % len(DEPTHS[color])]
    rng = np.random.default_rng(seed)
    samples = rng.integers(0, 1 << depth, (h, w, CHANNELS[color]))
    palette = rng.integers(0, 256, 3 * int(rng.integers(1, (1 << depth) + 1)), dtype=np.uint8).tobytes() \
        if color == 3 else None
    data = png_bytes(samples, depth, color, interlace=True, seed=seed, palette=palette)
    im, want = _pil_pixels(data)
    px, mode, lut = read_png(data)
    assert mode == im.mode and px.dtype == want.dtype and np.array_equal(px, want)
    assert np.array_equal(decode_image(data), np.asarray(im.convert("RGB")))
    # the same image without interlacing reads the same
    flat = png_bytes(samples, depth, color, seed=seed + 1, palette=palette)
    assert np.array_equal(read_png(flat)[0], px)


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 40), w=st.integers(1, 40), color=st.sampled_from([0, 2, 4, 6]), trns=st.booleans(),
       interlace=st.booleans(), low=st.booleans(), seed=st.integers(0, 2**16))
def test_16bit_png_matches_pillow(h, w, color, trns, interlace, low, seed):
    """16-bit samples in Pillow's modes: gray I;16, RGB / RGBA of the high
    bytes, gray + alpha as RGBA; tRNS left to `info`; RGB as
    `convert("RGB")` gives it (I;16 clipped)."""
    rng = np.random.default_rng(seed)
    samples = rng.integers(0, 400 if low else 65536, (h, w, CHANNELS[color]))
    t = struct.pack(">" + "H" * CHANNELS[color], *rng.integers(0, 65536, CHANNELS[color])) \
        if trns and color in (0, 2) else None
    data = png_bytes(samples, 16, color, interlace=interlace, seed=seed, trns=t)
    im, want = _pil_pixels(data)
    px, mode, lut = read_png(data)
    assert (mode, lut) == (im.mode, None) and px.dtype == want.dtype and np.array_equal(px, want)
    assert np.array_equal(to_rgb_u8(px, mode, lut), np.asarray(im.convert("RGB")))
    assert np.array_equal(decode_image(data), np.asarray(im.convert("RGB")))


@pytest.mark.parametrize("color,width", [(0, 1300), (0, 700), (2, 1100), (4, 1030), (6, 900)])
def test_16bit_png_payload_matches_reference(color, width):
    """`_image_to_data_uri` of a 16-bit PNG: the q80 payload bytes of the
    reference's function on Pillow's image (an I;16 page wider than 1024
    resizes in 16 bits, then clips)."""
    from morphik_core_tpu.services.ingestion_service import _image_to_data_uri as j_image_to_data_uri

    rng = np.random.default_rng(width + color)
    h = 150
    ink = _smooth(h, width, 1, width)[..., None].astype(np.int64)
    if color == 0:
        samples = np.where(ink > 150, 6000, ink)   # background above 255: clips to white
    else:
        samples = np.repeat(ink * 257, CHANNELS[color], axis=2)
        samples[..., -1] = rng.integers(0, 65536, (h, width)) if color in (4, 6) else samples[..., -1]
    data = png_bytes(samples, 16, color, interlace=color == 0, seed=color, filters=(0, 1, 2))
    pixels, mode, palette = read_image(data)
    uri, _ = _image_to_data_uri(pixels, mode, palette, max_width=1024)
    want = j_image_to_data_uri(Image.open(io.BytesIO(data)), max_width=1024)
    assert uri == want


# ------------------------------------------------------ committed fixtures

_PAGE_TEXT = ("Connector file {n}: quarterly revenue by region, supplier invoice renewal clause, "
              "AV office affluent growth, Tyo WAVE fi ffl.\n\n")


def _page(n: int, dpi: int = 100) -> np.ndarray:
    """A colour text page: rendered text with coloured blocks."""
    page = render_text_page((_PAGE_TEXT.format(n=n)) * 12, dpi).copy()
    rng = np.random.default_rng(n)
    h, w = page.shape[:2]
    for _ in range(5):
        y, x = int(rng.integers(0, h - 120)), int(rng.integers(0, w - 160))
        page[y:y + int(rng.integers(30, 120)), x:x + int(rng.integers(40, 160))] = rng.integers(0, 220, 3)
    return page


def connector_files() -> dict:
    """The files of `chip_smoke.py` phase 16's local connector directory
    that need PIL or a writer of this module: name -> bytes."""
    from tests.test_torch_more_image_formats import arith_past_a_block

    gray16 = _page(4)[:300, :, 0].astype(np.int64)
    gray16 = np.concatenate([gray16, gray16[:, :250]], axis=1)   # 1100 wide: I;16 resizes to 1024
    gray16 = np.where(gray16 > 200, 6000 + gray16, gray16)      # the background clips to white
    rgb16 = _page(3)[::2, ::2].astype(np.int64) * 257
    rgb16[..., 0] += np.arange(rgb16.shape[1]) % 200            # low bytes Pillow drops
    return {
        "progressive.jpg": _pil_jpeg(Image.fromarray(_page(0)), quality=80, progressive=True),
        "multiscan.jpg": multiscan_jpeg(_page(1), 80, restart=64),
        "adam7.png": png_bytes(_page(2)[::2, ::2], 8, 2, interlace=True, seed=2, filters=(0, 1, 2)),
        "rgb16.png": png_bytes(rgb16, 16, 2, seed=3, filters=(0, 1, 2)),
        "gray16.png": png_bytes(gray16, 16, 0, interlace=True, seed=4, filters=(0, 2),
                                trns=struct.pack(">H", 6255)),
        "cmyk.jpg": _pil_jpeg(Image.fromarray(_page(5)[:200, :200]).convert("CMYK"), quality=80),
        "arith.jpg": arith_past_a_block(_page(6)),
    }


# an arithmetic-coded JPEG whose data run past Pillow's first 64 KiB block:
# Pillow cannot load it, and the port refuses it (ROADMAP item 3b-ii)
REFUSED = ("arith.jpg",)


def write_connector_fixtures(path: Path = FIXTURE) -> Path:
    """The connector fixtures (needs PIL and the JAX package): each file's
    bytes, the sha256 of Pillow's `convert("RGB")` pixels, and the sha256
    of the q80 payload the reference stores for it (`_image_to_data_uri`,
    1024 px); the refused file has neither."""
    from morphik_core_tpu.services.ingestion_service import _image_to_data_uri as j_image_to_data_uri

    arrays = {}
    for name, data in connector_files().items():
        key = name.replace(".", "_")
        arrays[key] = np.frombuffer(data, np.uint8)
        if name not in REFUSED:   # Pillow cannot load the refused file
            arrays[f"{key}_rgb_sha256"] = np.array(hashlib.sha256(_pil_rgb(data).tobytes()).hexdigest())
            payload = data_uri_to_bytes(j_image_to_data_uri(Image.open(io.BytesIO(data)), max_width=1024))
            arrays[f"{key}_payload_sha256"] = np.array(hashlib.sha256(payload).hexdigest())
    np.savez_compressed(path, **arrays)
    return Path(path)


def test_connector_fixtures_are_current(tmp_path):
    """Regenerated now, the committed fixtures are byte-equal."""
    fresh = np.load(write_connector_fixtures(tmp_path / "files.npz"))
    committed = np.load(FIXTURE)
    assert sorted(fresh.files) == sorted(committed.files)
    for k in committed.files:
        assert np.array_equal(fresh[k], committed[k]), k
    assert FIXTURE.stat().st_size < 2_000_000


@pytest.mark.parametrize("name", ["progressive.jpg", "multiscan.jpg", "adam7.png", "rgb16.png", "gray16.png"])
def test_connector_fixtures_decode_as_the_reference(name):
    _decodes_as_the_reference(name)


def _decodes_as_the_reference(name):
    """Pillow's pixels (as their hash) and the reference's q80 payload."""
    z = np.load(FIXTURE)
    key = name.replace(".", "_")
    data = z[key].tobytes()
    pixels, mode, palette = read_image(data)
    rgb = to_rgb_u8(pixels, mode, palette)
    assert hashlib.sha256(rgb.tobytes()).hexdigest() == str(z[f"{key}_rgb_sha256"])
    assert np.array_equal(rgb, _pil_rgb(data))
    uri, _ = _image_to_data_uri(pixels, mode, palette, max_width=1024)
    assert hashlib.sha256(data_uri_to_bytes(uri)).hexdigest() == str(z[f"{key}_payload_sha256"])


def test_cmyk_fixture_decodes_as_the_reference():
    """The CMYK connector file, refused until the decoder read 4-component
    frames, decodes to Pillow's pixels and the reference's payload."""
    assert read_image(np.load(FIXTURE)["cmyk_jpg"].tobytes())[1] == "CMYK"
    _decodes_as_the_reference("cmyk.jpg")


def test_refused_fixture_is_refused():
    """The connector file the port still refuses: an arithmetic-coded
    JPEG Pillow cannot load (its data run past Pillow's 64 KiB block)."""
    data = np.load(FIXTURE)["arith_jpg"].tobytes()
    with pytest.raises(UnsupportedJpeg, match="arithmetic-coded.*ROADMAP Queue 1 item 3b-ii"):
        probe_jpeg(data)
