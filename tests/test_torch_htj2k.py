"""HTJ2K (JPEG 2000 Part 15) and the Part-2 codestreams that OpenJPEG
2.5.4 reads, decoded by the port (`utils/jpeg2000_ht.py`: the HT block
decoder in its plain Python version on the CPU; `jp2_codestream.py`,
`jp2_tier2.py`, `jpeg2000.py`) as Pillow 12.1 decodes them; and a PNG's
text `comment`, which Pillow's JPEG writer puts in the page payload.
Tolerance: exact everywhere (component planes, mode, pixels, payload
bytes, the tables).

No library here writes HT code blocks, so the files come from the test
encoder `tests/ht_encoder.py`, which codes the blocks of a Part-1 file
(from `opj_encode` or Pillow) again as HT; each file's planes are held to
`opj_decode`'s (`tests/openjp2_ref.py`) before its pixels are held to
Pillow's (`test_torch_jpeg2000.assert_as_pillow`). The committed fixture
(`tests/fixtures/image_formats_htj2k.npz`, `chip_smoke.py` phase 22's HT
files) regenerates equal.
"""

import glob
import hashlib
import io
import os
import struct
import zlib
from pathlib import Path

import numpy as np
import PIL
import pytest
import torch
from hypothesis import HealthCheck, example, given, settings, strategies as st
from PIL import Image, PngImagePlugin

from morphik_core_tpu_torch.services.ingestion_service import MAX_PAYLOAD_COMMENT, check_upload
from morphik_core_tpu_torch.utils import jp2_codestream as jcs
from morphik_core_tpu_torch.utils import png as tpng
from morphik_core_tpu_torch.utils.image import pillow_comment, probe_image, read_image
from morphik_core_tpu_torch.utils.jpeg2000 import code_blocks
from morphik_core_tpu_torch.utils.jpeg2000_ht import (MEL_EXP, VLC_TABLES, decode_ht_block, j2k_ht_decode,
                                                      pack_ht_blocks)
from tests.ht_encoder import forward_53, forward_rct, jph, rewrite
from tests.openjp2_ref import opj_encode
from tests.test_torch_decoders import _page
from tests.test_torch_jpeg2000 import _jax_payload, _letter, _port_payload, _save, _smooth, assert_as_pillow

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "image_formats_htj2k.npz"
EXAMPLES = settings(max_examples=10, deadline=None, suppress_health_check=[HealthCheck.too_slow])


def _libopenjp2() -> bytes:
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    return open(sorted(glob.glob(os.path.join(libs, "libopenjp2*.so*")))[0], "rb").read()


def _table_like(words: np.ndarray) -> np.ndarray:
    """For each start in `words` (uint16), whether the next 1024 words are a
    VLC decoding table: every entry has a codeword length, and every index
    with the same low `length` bits holds the same entry."""
    n = len(words) - 1024
    ok = np.ones(n, bool)
    idx = np.arange(1024)
    for k in range(1024):
        e = words[k:k + n]
        length = e & 7
        canon = (idx[k] & 0x380) | (idx[k] & 0x7F & ((1 << length) - 1))   # same context, the prefix alone
        ok &= (length > 0) & (words[canon + np.arange(n)] == e)
        if not ok.any():
            break
    return ok


def test_vlc_tables_are_openjpegs():
    """`ht_dec.c`'s vlc_tbl0 and vlc_tbl1, found in Pillow's libopenjp2 by
    their structure (two tables side by side, nothing table-like around
    them), equal the port's copy; and so do the MEL exponents."""
    so = _libopenjp2()
    mel = np.asarray(MEL_EXP, "<i4").tobytes()
    assert so.count(mel) == 1
    near = so.find(mel)
    lo = max(0, near - (1 << 16)) & ~1
    words = np.frombuffer(so[lo:near + (1 << 16)], "<u2")
    starts = np.flatnonzero(_table_like(words))
    assert len(starts), "no VLC table near the MEL exponents"
    first = int(starts[0])
    assert first + 1024 in set(starts.tolist())    # the second follows the first
    assert not _table_like(words[max(first - 1024, 0):first + 1])[:-1].any()   # no third before ...
    assert first + 2048 not in set(starts.tolist())   # ... or after them
    found = words[first:first + 2048].reshape(2, 1024)
    assert np.array_equal(found, VLC_TABLES)


# ------------------------------------------------------------ single blocks


def _block_file(w, h, passes, high, irreversible, seed, sty=0):
    """One code block of w x h (a one-resolution image of that size), coded
    as HT with `passes` passes, the cleanup's plane at its lowest (0, or 1
    with refinement passes) or highest possible."""
    rng = np.random.default_rng(seed)
    prec = 12
    plane = _smooth(rng, h, w, 1, 0, (1 << prec) - 1)[..., 0].astype(np.int32)
    cw, ch = max(4, 1 << (w - 1).bit_length()), max(4, 1 << (h - 1).bit_length())
    src = opj_encode([plane], [prec], numres=1, cblk=(cw, ch), irreversible=irreversible, mode=sty)

    def plan(t, c, band, cb, vals):
        s = band.numbps - 1 if high else int(passes > 1)
        return dict(mag=np.abs(vals) >> 1, neg=vals < 0, s=s, passes=passes, layer=0)

    return rewrite(src, [0], rng, plan)


SIZES = [(1, 1), (2, 1), (1, 2), (3, 5), (4, 4), (5, 3), (8, 8), (13, 21), (33, 9), (64, 64), (1024, 4), (4, 1024)]


@pytest.mark.parametrize("irreversible", [False, True])
@pytest.mark.parametrize("high", [False, True])
@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("w,h", SIZES)
def test_single_blocks_decode_as_opj(w, h, passes, high, irreversible):
    """Every block size up to 64 x 64 and 1024 x 4, cleanup alone and with
    SigProp and MagRef, 5/3 and 9/7, the cleanup's plane at both ends."""
    data = _block_file(w, h, passes, high, irreversible, seed=w * 7 + h)
    assert assert_as_pillow(data) == "I;16"
    assert len(code_blocks(data, ht=True)[0]) == 1 and not len(code_blocks(data)[0])


def test_vsc_blocks_decode_as_opj():
    """Stripe-causal SigProp: the next stripe's significance not counted."""
    for seed, (w, h) in enumerate([(17, 13), (64, 64), (9, 30)]):
        assert assert_as_pillow(_block_file(w, h, 3, False, False, seed, sty=jcs.VSC)) == "I;16"


# ----------------------------------------------------------- OpenJPEG's limits


def _limit_file(case: str) -> bytes:
    rng = np.random.default_rng(7)
    planes = [_smooth(rng, 24, 30, 1)[..., 0].astype(np.int32) for _ in range(3)]
    kw = dict(numres=2, cblk=(16, 16))
    if case == "roi":
        kw["roi"] = (1, 4)
    layers = 3 if case == "split" else 1
    src = opj_encode(planes, [8] * 3, layers=[30, 15, 4][:layers] if layers > 1 else (0,), **kw)

    def plan(t, c, band, cb, vals):
        mag, neg = np.abs(vals) >> 1, vals < 0
        got = dict(mag=mag, neg=neg, s=0, passes=1, layer=0)
        mb = band.numbps
        if case == "four passes" and mb >= 3:
            got.update(s=1, passes=4)
        elif case == "empty refinement" and mb >= 3:
            got.update(s=1, passes=3, refinement=b"")
        elif case == "planes equal" and mb >= 2:
            got.update(passes=3, refinement=b"\x12\x34\x56")
        elif case == "planes above":
            got.update(zero_planes=mb)
        elif case == "u_q first rows" and cb.x0 == band.x0 and cb.y0 == band.y0:
            got.update(s=mb - 1)
            got["mag"] = mag.copy()
            got["mag"].flat[0] = 1 << (mb + 2)
        elif case == "u_q later rows" and cb.y1 - cb.y0 > 2 and cb.x0 == band.x0 and cb.y0 == band.y0:
            got.update(s=mb - 1)
            got["mag"] = mag.copy()
            got["mag"][2:4, 0:2] = 1 << (mb + 2)
        elif case == "vlc outside" and cb.x0 == band.x0 and cb.y0 == band.y0:
            wide = np.zeros((mag.shape[0], mag.shape[1] + 2), np.int64)   # the LL block is 15 wide:
            wide[:, :mag.shape[1]] = mag                                    # column 15 is in its last quad pair
            wide[0, mag.shape[1]] = 5
            got.update(mag=wide, neg=np.zeros_like(wide, bool))
        elif case == "split" and mb >= 3:
            got.update(s=1, passes=3, refine_layer=1)
        return got

    data = rewrite(src, [0, 1, 2], rng, plan)
    if case == "scup":   # the first block's Scup below 2
        at = code_blocks(data, ht=True)[0]
        blob = bytearray(data)
        seg = bytes(at.data[:at.desc[0, 1]])
        pos = blob.index(seg) + len(seg)
        blob[pos - 1] = 0
        blob[pos - 2] &= 0xF0
        data = bytes(blob)
    if case == "30 planes":   # QCD: 7 guard bits and exponent 30 in every band, Mb = 36
        blob = bytearray(data)
        q = blob.index(b"\xff\x5c")
        ln = struct.unpack(">H", blob[q + 2:q + 4])[0]
        blob[q + 4] = (7 << 5) | (blob[q + 4] & 0x1F)
        for k in range(q + 5, q + 2 + ln):
            blob[k] = 30 << 3
        data = bytes(blob)
    return data


LIMITS = {"four passes": None, "empty refinement": "RGB", "planes equal": "RGB", "planes above": None,
          "u_q first rows": None, "u_q later rows": None, "vlc outside": None, "roi": None, "scup": None,
          "30 planes": None, "split": None}


@pytest.mark.parametrize("case", sorted(LIMITS))
def test_openjpegs_limits_are_the_ports(case):
    """More than 3 passes, refinement dropped (an empty segment, or the
    missing MSBs equal to the bit planes), more missing MSBs than planes,
    U_q above them + 1 in the first and later row pairs, a VLC codeword
    significant past the block, an ROI shift, Scup below 2, more than 30
    bit planes, refinement passes in a later layer than the cleanup: where
    OpenJPEG fails the port fails, where it decodes the port decodes."""
    assert assert_as_pillow(_limit_file(case)) == LIMITS[case]


def test_error_codes_of_the_plain_version():
    """The plain version's refusals, one a limit, on hand-made blocks."""
    with pytest.raises(ValueError, match="ROI"):
        decode_ht_block(b"\0" * 8, 0, 4, 0, 4, 1, 4, 4, 3, 5, 2, 0)
    with pytest.raises(ValueError, match="at most 3"):
        decode_ht_block(b"\0" * 8, 0, 4, 2, 6, 4, 4, 4, 3, 5, 0, 0)
    with pytest.raises(ValueError, match="at most 30"):
        decode_ht_block(b"\0" * 8, 0, 4, 0, 4, 1, 4, 4, 3, 31, 0, 0)
    with pytest.raises(ValueError, match="lengths"):
        decode_ht_block(b"\0" * 8, 0, 1, 0, 1, 1, 4, 4, 3, 5, 0, 0)
    with pytest.raises(ValueError, match="Scup"):
        decode_ht_block(b"\0\0\0\x50", 0, 4, 0, 4, 1, 4, 4, 3, 5, 0, 0)
    with pytest.raises(ValueError, match="MEL"):   # 0xFF then a byte above 0x8F opening the MEL
        decode_ht_block(b"\xff\x90\x00\x05\x00", 0, 5, 0, 5, 1, 4, 4, 3, 5, 0, 0)
    assert decode_ht_block(b"", 0, 0, 0, 0, 1, 4, 4, 3, 0, 0, 0) == [0] * 16   # no bit planes: zeros


# -------------------------------------------------------------- whole files


@st.composite
def ht_files(draw):
    seed = draw(st.integers(0, 10 ** 6))
    rng = np.random.default_rng(seed)
    n = draw(st.sampled_from([1, 2, 3, 4]))
    h, w = draw(st.integers(1, 40)), draw(st.integers(1, 40))
    prec = draw(st.integers(1, 16))
    sgnd = draw(st.booleans())
    sub = (1, 1)
    if n >= 3 and draw(st.booleans()):
        sub = (draw(st.integers(1, 2)), draw(st.integers(1, 2)))
    lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sgnd else (0, (1 << prec) - 1)
    planes = []
    for c in range(n):
        dx, dy = (1, 1) if c == 0 else sub
        planes.append(_smooth(rng, -(-h // dy), -(-w // dx), 1, lo, hi)[..., 0].astype(np.int32))
    kw = dict(numres=draw(st.integers(1, 5)), mode=draw(st.sampled_from([0, 8])),
              csty=draw(st.sampled_from([0, 2, 4, 6])), prog=draw(st.integers(0, 4)),
              cblk=(2 ** draw(st.integers(2, 6)), 2 ** draw(st.integers(2, 6))))
    if kw["cblk"][0] * kw["cblk"][1] > 4096:
        kw["cblk"] = (64, 64)
    if draw(st.booleans()):
        kw["layers"] = draw(st.sampled_from([[30, 8], [30, 15, 4]]))
    if n >= 3 and sub == (1, 1) and prec >= 2:
        kw["mct"] = draw(st.sampled_from([0, 1]))
    if draw(st.booleans()):
        p = (2 ** draw(st.integers(1, 7)), 2 ** draw(st.integers(1, 7)))
        kw["precincts"] = [p, p]
    if sub == (1, 1) and draw(st.booleans()):
        kw["tiles"] = (draw(st.integers(8, 40)), draw(st.integers(8, 40)))
    mind = min(min(p.shape) for p in planes)
    kw["irreversible"] = draw(st.booleans()) and "tiles" not in kw and mind >= 2 ** kw["numres"]
    jp2 = draw(st.booleans())
    comps = [c for c in range(n) if draw(st.booleans())] or [n - 1]   # the others stay Part 1: COC-mixed
    return seed, planes, prec, sgnd, [(1, 1)] + [sub] * (n - 1), jp2, kw, comps


def _ht_case(case, payload=True):
    seed, planes, prec, sgnd, sub, jp2, kw, comps = case
    try:
        src = opj_encode(planes, [prec] * len(planes), [sgnd] * len(planes), sub, jp2=jp2, **kw)
    except AssertionError:
        return   # a combination libopenjp2's encoder refuses
    data = rewrite(src, comps, np.random.default_rng(seed))
    if jp2:
        data = jph(data)
    mode = assert_as_pillow(data)
    if mode is not None and payload:
        assert _port_payload(data) == _jax_payload(data)


def _hc(n, h, w, prec=8, sgnd=False, sub=(1, 1), jp2=False, comps=None, seed=0, **kw):
    rng = np.random.default_rng(seed)
    lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sgnd else (0, (1 << prec) - 1)
    planes = [_smooth(rng, -(-h // (1 if c == 0 else sub[1])), -(-w // (1 if c == 0 else sub[0])), 1, lo, hi)[..., 0]
              .astype(np.int32) for c in range(n)]
    return seed, planes, prec, sgnd, [(1, 1)] + [sub] * (n - 1), jp2, kw, comps or list(range(n))


@EXAMPLES
@given(ht_files())
@example(_hc(3, 37, 29, numres=4, layers=[30, 15, 4], jp2=True))                 # JPH, layers
@example(_hc(3, 30, 22, numres=3, mct=1, irreversible=True, comps=[0, 2]))      # COC-mixed, ICT
@example(_hc(3, 26, 35, sub=(2, 2), numres=3))                                   # subsampled: Pillow's sYCC
@example(_hc(4, 20, 20, prec=10, numres=3, tiles=(9, 12), precincts=[(4, 4), (8, 8)], comps=[1, 3]))
@example(_hc(1, 19, 21, prec=1, numres=2))
@example(_hc(1, 19, 21, prec=16, sgnd=True, numres=3, irreversible=True))
@example(_hc(2, 17, 30, prec=5, sgnd=True, numres=2, csty=6, prog=3))
@example(_hc(3, 40, 33, numres=5, mode=8, prog=2, cblk=(8, 16), jp2=True, seed=5))
def test_ht_files_decode_as_opj_and_pillow(case):
    """Tiles, precincts, layers, the five progressions, subsampling,
    precisions 1-16 signed or not, COC-mixed Part-1 / HT components, JPH
    boxes: planes as `opj_decode`'s, pixels as Pillow's, the payload as
    the JAX package's."""
    _ht_case(case)


@pytest.mark.parametrize("irreversible", [False, True])
def test_pillow_written_pages_as_ht(irreversible):
    """A page as Pillow saves it (layers by rate), every block coded again
    as HT: as Pillow decodes it, and the payload the reference's."""
    src = _save(Image.fromarray(_page(70)[::4, ::4].copy()), irreversible=irreversible, quality_mode="rates",
                quality_layers=[40, 10])
    data = jph(rewrite(src, [0, 1, 2], np.random.default_rng(1)))
    assert assert_as_pillow(data) == "RGB"
    assert _port_payload(data) == _jax_payload(data)


# ------------------------------------------------------------------ Part 2


def _p2_base() -> bytes:
    rng = np.random.default_rng(2)
    return opj_encode([_smooth(rng, 12, 14, 1)[..., 0].astype(np.int32) for _ in range(3)], [8] * 3, numres=2)


def _mct(idx, arr, et, vals):
    fmt = {0: ">h", 1: ">i", 2: ">f", 3: ">d"}[et]
    body = b"".join(struct.pack(fmt, v) for v in vals)
    return b"\xff\x74" + struct.pack(">HHHH", 8 + len(body), 0, idx | (arr << 8) | (et << 10), 0) + body


def _mcc(idx, deco, off, n=3):
    body = struct.pack(">HBHH", 0, idx, 0, 1) + bytes([1]) + struct.pack(">H", n) + bytes(range(n)) + \
        struct.pack(">H", n) + bytes(range(n)) + bytes([0, off, deco])
    return b"\xff\x75" + struct.pack(">H", 2 + len(body)) + body


def _mco(*idx):
    return b"\xff\x77" + struct.pack(">H", 3 + len(idx)) + bytes([len(idx)]) + bytes(idx)


def part2_variant(name: str) -> bytes:
    """The base file with Part-2 (or misplaced) markers: in the main header
    after SIZ, or in the tile-part header."""
    data = _p2_base()
    siz_end = 4 + struct.unpack(">H", data[4:6])[0]
    sot = data.index(b"\xff\x90")

    def main(extra):
        return data[:siz_end] + extra + data[siz_end:]

    def tile(extra):
        psot = struct.unpack(">I", data[sot + 6:sot + 10])[0]
        out = bytearray(data[:sot + 12] + extra + data[sot + 12:])
        out[sot + 6:sot + 10] = struct.pack(">I", psot + len(extra))
        return bytes(out)

    def rsiz(d, v):
        return d[:6] + struct.pack(">H", v) + d[8:]

    offsets = _mct(2, 2, 1, [1, 2, 3]) + _mcc(3, 0, 2)
    return {
        "rsiz 0x8000": lambda: rsiz(data, 0x8000),
        "rsiz 0x4000": lambda: rsiz(data, 0x4000),
        "cbd prec 12": lambda: main(b"\xff\x78\x00\x07\x00\x03\x0b\x07\x07"),
        "cbd signed": lambda: main(b"\xff\x78\x00\x07\x00\x03\x87\x07\x07"),
        "cbd prec 32": lambda: main(b"\xff\x78\x00\x07\x00\x03\x1f\x07\x07"),
        "cbd 2 of 3": lambda: main(b"\xff\x78\x00\x06\x00\x02\x07\x07"),
        "offsets int16": lambda: main(_mct(2, 2, 0, [10, -20, 5]) + _mcc(3, 0, 2) + _mco(3)),
        "offsets int32": lambda: main(_mct(2, 2, 1, [10, -20, 5]) + _mcc(3, 0, 2) + _mco(3)),
        "offsets float32": lambda: main(_mct(2, 2, 2, [10.7, -20.7, 5.5]) + _mcc(3, 0, 2) + _mco(3)),
        "offsets float64": lambda: main(_mct(2, 2, 3, [10.7, -20.7, 5.5]) + _mcc(3, 0, 2) + _mco(3)),
        "offsets and matrix": lambda: main(_mct(1, 1, 2, [1] * 9) + offsets + _mco(3)),
        "matrix of the wrong size": lambda: main(_mct(1, 1, 2, [1] * 8) + _mct(2, 2, 1, [1, 2, 3]) + _mcc(3, 1, 2)
                                                  + _mco(3)),
        "the second mcc": lambda: main(offsets + _mcc(4, 0, 2) + _mco(4)),
        "mco of 2 stages": lambda: main(offsets + _mco(3, 3)),
        "mco of no stage": lambda: main(_mco()),
        "mco before mcc": lambda: main(_mco(3) + offsets),
        "mcc of a missing mct": lambda: main(_mcc(3, 0, 2) + _mco(3)),
        "mcc of 2 components": lambda: main(_mct(2, 2, 1, [1, 2]) + _mcc(3, 0, 2, n=2) + _mco(3)),
        "mct zmct 1": lambda: main(b"\xff\x74\x00\x0a\x00\x01\x06\x02\x00\x00\x00\x00"),
        "mct cut short": lambda: main(b"\xff\x74\x00\x06\x00\x00\x06\x02"),
        "mco in a tile-part": lambda: tile(offsets + _mco(3)),
        "cap": lambda: main(b"\xff\x50\x00\x08\x00\x02\x00\x00\x00\x00"),
        "cap in a tile-part": lambda: tile(b"\xff\x50\x00\x08\x00\x02\x00\x00\x00\x00"),
        "cbd in a tile-part": lambda: tile(b"\xff\x78\x00\x07\x00\x03\x0b\x07\x07"),
        "unknown marker in the main header": lambda: main(b"\xff\x70\x00\x04\x00\x00"),
        "unknown marker in a tile-part": lambda: tile(b"\xff\x70\x00\x04\x00\x00"),
        "plt in the main header": lambda: main(b"\xff\x58\x00\x04\x00\x00"),
        "cod mct 2": lambda: (lambda d, at: d[:at + 8] + b"\x02" + d[at + 9:])(data, data.index(b"\xff\x52")),
        "wavelet 2": lambda: (lambda d, at: d[:at + 13] + b"\x02" + d[at + 14:])(data, data.index(b"\xff\x52")),
        "style 0x80": lambda: (lambda d, at: d[:at + 12] + b"\x80" + d[at + 13:])(data, data.index(b"\xff\x52")),
    }[name]()


PART2 = {"rsiz 0x8000": "RGB", "rsiz 0x4000": "RGB", "cbd prec 12": "RGB", "cbd signed": "RGB", "cbd prec 32": None,
         "cbd 2 of 3": None, "offsets int16": "RGB", "offsets int32": "RGB", "offsets float32": "RGB",
         "offsets float64": "RGB", "offsets and matrix": "RGB", "matrix of the wrong size": None,
         "the second mcc": "RGB", "mco of 2 stages": "RGB", "mco of no stage": "RGB", "mco before mcc": "RGB",
         "mcc of a missing mct": None, "mcc of 2 components": "RGB", "mct zmct 1": "RGB", "mct cut short": None,
         "mco in a tile-part": "RGB", "cap": "RGB", "cap in a tile-part": None, "cbd in a tile-part": None,
         "unknown marker in the main header": "RGB", "unknown marker in a tile-part": None,
         "plt in the main header": None, "cod mct 2": None, "wavelet 2": None, "style 0x80": None}


@pytest.mark.parametrize("name", sorted(PART2))
def test_part2_codestreams_decode_where_pillow_decodes(name):
    """Each marker rule of OpenJPEG 2.5.4's Part-2 reading (CBD, MCT, MCC,
    MCO: the DC shift they set) and of where a marker may stand: decoded
    as Pillow decodes it, or failing where Pillow fails; never refused."""
    data = part2_variant(name)
    assert assert_as_pillow(data) == PART2[name]
    probe_image(data)
    check_upload("image/jp2", data)


def part2_file(mct: int = 0) -> bytes:
    """A JP2 as `opj_set_MCT` writes Part 2 (Rsiz 0x8100; CBD, MCT, MCC
    and MCO; an identity matrix and offsets of 128; 9/7, as it forces),
    COD `mct` set to `mct`: 0 decodes to the page, its offsets the DC
    shifts."""
    rgb = _page(90)[::2, ::2][:120, :160]
    data = opj_encode([rgb[..., k].astype(np.int32) for k in range(3)], [8] * 3, jp2=True, color_space=1, numres=3,
                      custom_mct=(np.eye(3, dtype=np.float32), [128, 128, 128]))
    at = data.index(b"\xff\x52")
    return data[:at + 8] + bytes([mct]) + data[at + 9:]


@pytest.mark.parametrize("mct", [0, 1, 2])
def test_opj_set_mct_files(mct):
    """COD mct 0 or 1 with the custom transform's markers loads (the MCO's
    offsets as DC shifts), mct 2 fails, in Pillow and in the port."""
    data = part2_file(mct)
    assert assert_as_pillow(data) == (None if mct == 2 else "RGB")
    if mct == 0:
        page = _page(90)[::2, ::2][:120, :160].astype(np.int64)
        assert np.abs(read_image(data, "cpu")[0].astype(np.int64) - page).mean() < 2   # 9/7 rounding only
        assert _port_payload(data) == _jax_payload(data)


# --------------------------------------------------------------- PNG text


def _chunk(t: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body))


def png_with_text(before=(), after=(), seed=0) -> bytes:
    """A 40 x 30 RGB PNG with text chunks before and after its IDAT."""
    px = _smooth(np.random.default_rng(seed), 30, 40, 3).astype(np.uint8)
    raw = b"".join(b"\0" + row.tobytes() for row in px)
    return (tpng.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 40, 30, 8, 2, 0, 0, 0))
            + b"".join(_chunk(t, b) for t, b in before) + _chunk(b"IDAT", zlib.compress(raw))
            + b"".join(_chunk(t, b) for t, b in after) + _chunk(b"IEND", b""))


def _itxt(text: str, lang=b"fr", compressed=False, key=b"comment") -> bytes:
    v = text.encode("utf-8")
    return key + b"\0" + bytes([int(compressed), 0]) + lang + b"\0" + "Kommentar".encode() + b"\0" + \
        (zlib.compress(v) if compressed else v)


PNG_TEXT = {
    "tEXt before": dict(before=[(b"tEXt", b"comment\0a scanned page")]),
    "tEXt after": dict(after=[(b"tEXt", b"comment\0written after the data")]),
    "latin-1": dict(before=[(b"tEXt", b"comment\0caf\xe9 \xa9 \xff")]),
    "zTXt": dict(before=[(b"zTXt", b"comment\0\0" + zlib.compress(b"compressed words " * 40))]),
    "zTXt broken": dict(before=[(b"zTXt", b"comment\0\0not zlib")]),
    "zTXt method 1": dict(after=[(b"zTXt", b"comment\0\1" + zlib.compress(b"x"))]),
    "iTXt": dict(before=[(b"iTXt", _itxt("été, grüße, 漢字"))]),
    "iTXt compressed": dict(after=[(b"iTXt", _itxt("été " * 30, compressed=True))]),
    "iTXt bad utf-8": dict(before=[(b"iTXt", b"comment\0\0\0fr\0k\0\xff\xfe")]),
    "iTXt method 1": dict(before=[(b"iTXt", b"comment\0\1\1fr\0k\0xx")]),
    "two, the last wins": dict(before=[(b"tEXt", b"comment\0first")], after=[(b"iTXt", _itxt("second"))]),
    "an empty one last": dict(before=[(b"tEXt", b"comment\0first")], after=[(b"tEXt", b"comment\0")]),
    "another key": dict(before=[(b"tEXt", b"Comment\0not this"), (b"tEXt", b"Title\0nor this")]),
    "no separator": dict(before=[(b"tEXt", b"comment")]),
    "longest comment": dict(before=[(b"tEXt", b"comment\0" + b"y" * MAX_PAYLOAD_COMMENT)]),
    "comment too long": dict(before=[(b"tEXt", b"comment\0" + b"y" * (MAX_PAYLOAD_COMMENT + 1))]),
    "zTXt past its limit": dict(after=[(b"zTXt", b"comment\0\0" + zlib.compress(b"z" * (tpng.MAX_TEXT_CHUNK + 1)))]),
}


def _reference_payload(data: bytes):
    try:
        return _jax_payload(data)
    except (OSError, ValueError, SyntaxError):
        return None


def _port(data: bytes):
    try:
        return _port_payload(data)
    except (OSError, ValueError):
        return None


@pytest.mark.parametrize("name", sorted(PNG_TEXT))
def test_png_comment_reaches_the_payload_as_the_reference(name):
    """Pillow's PNG plugin keeps a text chunk keyed `comment` in `info`,
    and its JPEG writer puts it in the payload's COM, UTF-8: the port's
    payload is the reference's byte for byte (or both fail: a comment past
    the writer's buffer, a chunk past MAX_TEXT_CHUNK)."""
    data = png_with_text(**PNG_TEXT[name])
    im = Image.open(io.BytesIO(data)) if name not in ("zTXt method 1",) else None
    want = _reference_payload(data)
    assert _port(data) == want
    if want is not None and im is not None:
        im.load()
        c = im.info.get("comment", "")
        assert pillow_comment(data) == (c.encode("utf-8") if isinstance(c, str) else c)


def test_png_text_memory_limit(monkeypatch):
    """Past MAX_TEXT_MEMORY of text chunks, Pillow's open fails and so does
    the port's comment (both limits lowered to keep the file small)."""
    monkeypatch.setattr(PngImagePlugin, "MAX_TEXT_MEMORY", 1000)
    monkeypatch.setattr(tpng, "MAX_TEXT_MEMORY", 1000)
    data = png_with_text(before=[(b"tEXt", b"Title\0" + b"t" * 600), (b"tEXt", b"comment\0" + b"c" * 600)])
    with pytest.raises(ValueError):
        Image.open(io.BytesIO(data))
    with pytest.raises(ValueError):
        pillow_comment(data)
    ok = png_with_text(before=[(b"tEXt", b"comment\0" + b"c" * 900)])
    assert pillow_comment(ok) == b"c" * 900


# ---------------------------------------------------------------- the launch


def test_ht_blocks_decode_on_the_cpu_only_when_asked(monkeypatch):
    """j2k_ht_decode on the CPU is `decode_ht_block` block by block; on a
    CUDA device it launches K6 or raises, and never reaches the plain
    version."""
    data = _block_file(20, 12, 3, False, False, seed=3)
    blocks, n = code_blocks(data, ht=True)
    got = j2k_ht_decode(blocks, n, "cpu").numpy()
    d = blocks.desc[0]
    want = decode_ht_block(blocks.data.tobytes(), int(d[0]), int(d[1]), int(d[2]), int(d[3]), int(d[4]), int(d[5]),
                           int(d[6]), int(d[7]), int(d[8]), 0, int(d[9]))
    assert np.array_equal(got[:20 * 12], np.asarray(want, np.int32))
    if torch.cuda.is_available():
        pytest.skip("a card is present: K6 runs there (tests/test_torch_cuda.py)")
    from morphik_core_tpu_torch.utils import jpeg2000_ht

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA device")

    monkeypatch.setattr(jpeg2000_ht, "decode_ht_block", no_plain)
    with pytest.raises((RuntimeError, AssertionError)) as e:
        j2k_ht_decode(blocks, n, "cuda")
    assert "plain version" not in str(e.value)
    assert pack_ht_blocks([]).desc.shape == (0, 13)


# --------------------------------------------------------------- fixture


def _ht_pages():
    return [_page(80 + k)[::2, ::2].copy() for k in range(3)]   # 550 x 425 colour text pages of their own


def fixture_files() -> dict:
    """`chip_smoke.py` phase 22's HTJ2K and Part-2 files: name -> bytes."""
    pages = _ht_pages()
    rng = np.random.default_rng(27)

    def plan(t, c, band, cb, vals):   # the cleanup at one of the two lowest planes, refinement passes below it
        s = int(rng.integers(0, min(2, band.numbps - 1) + 1))
        return np.abs(vals) >> 1, vals < 0, s, 1 if s == 0 else int(rng.integers(1, 4)), 0

    page97 = _save(Image.fromarray(pages[0]), irreversible=True, num_resolutions=5)
    j2c = _save(Image.fromarray(pages[1]), no_jp2=True, num_resolutions=5)
    j2c_bufs = [forward_53(pages[1][..., k].astype(np.int64) - 128, 5) for k in range(3)]
    mixed = opj_encode([pages[2][..., k].astype(np.int32) for k in range(3)], [8] * 3, mct=1, numres=4,
                       cblk=(32, 32), prog=2, precincts=[(64, 64), (64, 64)], layers=[30, 10])
    mixed_bufs = forward_rct(pages[2])
    letter = _letter()
    letter_src = opj_encode([letter[..., k].astype(np.int32) for k in range(3)], [8] * 3, jp2=True, color_space=1,
                            mct=1, numres=6)
    letter_bufs = [forward_53(c, 6) for c in forward_rct(letter)]
    lossless = lambda t, c, band, cb, vals: (np.abs(vals) >> 1, vals < 0, 0, 1, 0)   # noqa: E731
    return {
        "page.jph": jph(rewrite(page97, [0, 1, 2], rng, plan)),
        "page.j2c": rewrite(j2c, [0, 1, 2], rng, lossless, coefficients=lambda t, c: j2c_bufs[c]),
        "mixed.j2k": rewrite(mixed, [0, 2], rng, lossless, coefficients=lambda t, c: forward_53(mixed_bufs[c], 4)),
        "part2.jp2": part2_file(0),
        "letter_ht.jph": jph(rewrite(letter_src, [0, 1, 2], rng, lossless, coefficients=lambda t, c: letter_bufs[c])),
    }


SOURCE_PAGE = {"page.jph": 0, "page.j2c": 1, "mixed.j2k": 2, "part2.jp2": 3}
TIMED = ("letter_ht.jph",)
QUERIES = ("page.jph",)


def write_fixture(path: Path = FIXTURE) -> Path:
    """Each file's bytes, Pillow's mode, the sha256 of its pixels and of
    their `convert("RGB")`, the sha256 of the reference's q80 payload
    (`_image_to_data_uri`, 1024 px) and the page an ingested file was made
    from. Needs PIL and the JAX package."""
    arrays = {}
    for name, data in fixture_files().items():
        key = name.replace(".", "_")
        arrays[key] = np.frombuffer(data, np.uint8)
        im = Image.open(io.BytesIO(data))
        arrays[f"{key}_mode"] = np.array(im.mode)
        arrays[f"{key}_sha256"] = np.array(hashlib.sha256(np.asarray(im).tobytes()).hexdigest())
        arrays[f"{key}_rgb_sha256"] = np.array(hashlib.sha256(np.asarray(im.convert("RGB")).tobytes()).hexdigest())
        if name not in TIMED:
            arrays[f"{key}_payload_sha256"] = np.array(hashlib.sha256(_jax_payload(data)).hexdigest())
            arrays[f"{key}_page"] = np.array(SOURCE_PAGE[name])
    np.savez_compressed(path, **arrays)
    return Path(path)


def test_fixture_is_current(tmp_path):
    """Regenerated now, the committed fixture is equal; it names the same
    files as `chip_smoke.py` phase 22; the HT letter page is the letter
    page, lossless."""
    import chip_smoke

    assert chip_smoke.HT_FILES == tuple(SOURCE_PAGE) and chip_smoke.HT_TIMED == TIMED
    assert chip_smoke.HT_QUERIES == QUERIES
    fresh = np.load(write_fixture(tmp_path / "ht.npz"))
    committed = np.load(FIXTURE)
    assert sorted(fresh.files) == sorted(committed.files)
    for k in committed.files:
        assert np.array_equal(fresh[k], committed[k]), k
    assert str(committed["letter_ht_jph_sha256"]) == hashlib.sha256(_letter().tobytes()).hexdigest()
    assert FIXTURE.stat().st_size < 3_000_000


@pytest.mark.parametrize("name", ["page.jph", "page.j2c", "mixed.j2k", "part2.jp2"])
def test_fixture_files_decode_as_the_reference(name):
    """The fixture's ingested files at their 550 x 425 (and 160 x 120), on
    the CPU: Pillow's mode, pixels and payload (the letter page decodes on
    the card in `chip_smoke.py`)."""
    z = np.load(FIXTURE)
    key = name.replace(".", "_")
    data = z[key].tobytes()
    px, mode, _ = read_image(data, "cpu")
    assert mode == str(z[f"{key}_mode"])
    assert hashlib.sha256(px.tobytes()).hexdigest() == str(z[f"{key}_sha256"])
    assert hashlib.sha256(_port_payload(data)).hexdigest() == str(z[f"{key}_payload_sha256"])
    check_upload("image/jph" if name.endswith(".jph") else "image/jp2", data)
