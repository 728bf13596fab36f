"""K5 and K6, the JPEG 2000 block decoders' CUDA sources (`csrc/j2k_t1.cu`,
`csrc/j2k_ht.cu`), compiled as host C++ with their warp emulated (one
host thread stands for the 32 lanes: ballots, shuffles and scans loop
over them, see `csrc/warp.cuh`), held bit for bit to the plain Python
versions on the fixtures' code blocks, on files of every code-block
style and shape, on blocks whose bytes do not fit the shared segment
buffer, and on corrupted blocks. The card itself holds the kernels to
the same plain versions (`tests/test_torch_cuda.py`); this is the CPU's
check of their logic. Also: the heaviest-first order of `pack_blocks` /
`pack_ht_blocks` leaves the plain decode's output as it was.

Tolerance: exact (integer decisions only).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from morphik_core_tpu_torch.utils import jp2_codestream as jcs
from morphik_core_tpu_torch.utils import jpeg2000_ht, jpeg2000_t1
from morphik_core_tpu_torch.utils.jpeg2000 import _collect, code_blocks
from morphik_core_tpu_torch.utils.jpeg2000_ht import (HT_ERRORS, VLC_TABLES, decode_ht_block, j2k_ht_decode,
                                                      k6_buffers, pack_ht_blocks)
from morphik_core_tpu_torch.utils.jpeg2000_t1 import decode_block, j2k_t1_decode, k5_buffers, pack_blocks
from tests.openjp2_ref import opj_encode
from tests.test_torch_htj2k import _block_file

CSRC = Path(__file__).resolve().parent.parent / "morphik_core_tpu_torch" / "csrc"
FIXTURES = Path(__file__).resolve().parent / "fixtures"
# the styles and shapes below as files, for the card's tests (tests/test_torch_cuda.py), whose machine has no
# Pillow and no libopenjp2; `write_block_cases` regenerates it
BLOCK_CASES = FIXTURES / "j2k_block_cases.npz"


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The kernels' sources built as one host library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' sources as host C++")
    lib = tmp_path_factory.mktemp("warp") / "libj2k_emu.so"
    srcs = [str(CSRC / "j2k_t1.cu"), str(CSRC / "j2k_ht.cu")]
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(lib), *srcs], check=True)
    out = ctypes.CDLL(str(lib))
    out.j2k_ht_init(ctypes.c_char_p(VLC_TABLES.astype("<u2").tobytes()))
    return out


def _p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def k5_emulated(lib, blocks, n) -> np.ndarray:
    out = np.zeros(max(n, 1), np.int32)
    desc = np.ascontiguousarray(blocks.desc)
    lib.j2k_t1_emulate(_p(blocks.data), _p(blocks.segs), _p(desc), len(blocks), _p(out), *k5_buffers(blocks))
    return out[:n]


def k6_emulated(lib, blocks, n):
    """-> (the coefficients, each live block's error code) as K6 leaves them."""
    out = np.zeros(max(n, 1), np.int32)
    desc = np.ascontiguousarray(blocks.desc[blocks.desc[:, 4] > 0])
    errors = np.zeros(max(len(desc), 1), np.int32)
    lib.j2k_ht_emulate(_p(blocks.data), _p(desc), len(desc), _p(out), _p(errors), *k6_buffers(blocks))
    return out[:n], errors[:len(desc)]


def k6_matches_plain(lib, blocks, n) -> None:
    """K6 emulated equals the plain version: the same coefficients, or the
    same error on the first block that fails."""
    got, errors = k6_emulated(lib, blocks, n)
    try:
        want = j2k_ht_decode(blocks, n, "cpu").numpy()
    except ValueError as e:
        assert errors.any(), e
        assert HT_ERRORS[int(errors[errors != 0][0])] in str(e)
        return
    assert not errors.any()
    assert np.array_equal(got, want)


def _noise(h, w, prec, seed):
    rng = np.random.default_rng(seed)
    smooth = np.cumsum(rng.integers(-3, 4, (h, w)), axis=1) + 40 * np.sin(np.arange(h) / 5.0)[:, None]
    spikes = rng.integers(0, 1 << prec, (h, w)) * (rng.random((h, w)) < 0.2)
    return np.clip(smooth + spikes + (1 << (prec - 1)), 0, (1 << prec) - 1).astype(np.int32)


# ------------------------------------------------------------------- K5


@pytest.mark.parametrize("name", ["page.j2k", "page.jp2", "styles.j2k", "ycc.j2k", "tiled.jp2", "gray16.jp2"])
def test_k5_emulated_matches_plain_on_fixture(emu, name, monkeypatch):
    data = np.load(FIXTURES / "image_formats_jp2.npz")[name.replace(".", "_")].tobytes()
    blocks, n = code_blocks(data, 96)
    want = j2k_t1_decode(blocks, n, "cpu").numpy()
    assert np.array_equal(k5_emulated(emu, blocks, n), want)
    monkeypatch.setattr(jpeg2000_t1, "SEG_CAP", 0)   # every block from global memory
    assert np.array_equal(k5_emulated(emu, blocks, n), want)


# (cblk w, h, mode, roi shift): every style bit (LAZY 1, RESET 2, TERMALL 4, VSC 8, PTERM 16, SEGSYM 32), the
# extreme shapes a 4096-sample block allows, an ROI shift, and 1 x 64 blocks (an image one sample wide)
K5_STYLES = [(64, 64, 0x00, 0), (64, 64, 0x01, 0), (64, 64, 0x02, 0), (64, 64, 0x04, 0), (64, 64, 0x08, 0),
             (64, 64, 0x10, 0), (64, 64, 0x20, 0), (64, 64, 0x3F, 0), (32, 16, 0x3F, 5), (1024, 4, 0x09, 0),
             (4, 1024, 0x2B, 0), (16, 64, 0x00, 9), (4, 64, 0x3F, 0)]


def k5_style_file(cw, ch, mode, roi) -> bytes:
    h, w = (24, 1030) if cw == 1024 else (1030, 12) if ch == 1024 else (64, 1) if cw == 4 else (70, 75)
    planes = [_noise(h, w, 12, seed=cw * ch + mode + k) for k in range(2)]
    kw = dict(roi=(0, roi)) if roi else {}
    return opj_encode(planes, [12, 12], numres=1 if w == 1 else 2, mode=mode, cblk=(cw, ch), layers=[40, 10, 2],
                      **kw)


@pytest.mark.parametrize("cw,ch,mode,roi", K5_STYLES)
def test_k5_emulated_matches_plain_on_styles(emu, cw, ch, mode, roi, monkeypatch):
    blocks, n = code_blocks(k5_style_file(cw, ch, mode, roi))
    assert (mode & 4 == 0) or int(blocks.desc[:, 2].max()) > 1   # TERMALL: a segment a pass
    want = j2k_t1_decode(blocks, n, "cpu").numpy()
    assert np.array_equal(k5_emulated(emu, blocks, n), want)
    monkeypatch.setattr(jpeg2000_t1, "SEG_CAP", 16)   # the larger blocks from global memory
    assert np.array_equal(k5_emulated(emu, blocks, n), want)


@pytest.mark.parametrize("seed", range(4))
def test_k5_emulated_matches_plain_on_corrupted_blocks(emu, seed):
    data = np.load(FIXTURES / "image_formats_jp2.npz")["styles_j2k"].tobytes()
    blocks, n = code_blocks(data, 64)
    rng = np.random.default_rng(seed)
    hit = rng.choice(len(blocks.data) - 16, size=max(1, len(blocks.data) // 40), replace=False)
    blocks.data[hit] = rng.integers(0, 256, len(hit), dtype=np.uint8)
    want = j2k_t1_decode(blocks, n, "cpu").numpy()
    assert np.array_equal(k5_emulated(emu, blocks, n), want)


def test_k5_heaviest_first_leaves_plain_output_unchanged():
    """pack_blocks sorts by segment bytes x passes; each block keeps its
    place in the output, so the decode equals block-by-block decoding of
    the image's blocks in their own order."""
    stream, _ = jcs.codestream_of(np.load(FIXTURES / "image_formats_jp2.npz")["styles_j2k"].tobytes())
    _, blocks, _, n = _collect(jcs.parse(stream, need_eoc=True))
    packed = pack_blocks(blocks)
    work = packed.desc[:, 11].astype(np.int64) * [packed.segs[2 * s + 1:2 * (s + c):2].sum()
                                                  for s, c in packed.desc[:, 1:3]]
    assert (np.diff(work) <= 0).all() and not (packed.desc[:, 9] == [b[8] for b in blocks]).all()
    assert (packed.desc[:, 0] % 16 == 0).all() and pack_blocks([]).desc.shape == (0, 12)
    want = np.zeros(n, np.int32)
    for chunks, segs, w, h, orient, numbps, roishift, sty, out_off, stride in blocks:
        vals = np.asarray(decode_block(b"".join(chunks), 0, segs, w, h, orient, numbps, roishift, sty), np.int32)
        for y in range(h if segs else 0):
            want[out_off + y * stride:out_off + y * stride + w] = vals[y * w:(y + 1) * w]
    assert np.array_equal(j2k_t1_decode(packed, n, "cpu").numpy(), want)


# ------------------------------------------------------------------- K6


@pytest.mark.parametrize("name", ["page.jph", "page.j2c", "mixed.j2k", "letter_ht.jph"])
def test_k6_emulated_matches_plain_on_fixture(emu, name, monkeypatch):
    data = np.load(FIXTURES / "image_formats_htj2k.npz")[name.replace(".", "_")].tobytes()
    blocks, n = code_blocks(data, None if name.startswith("letter") else 96, ht=True)
    assert len(blocks)
    k6_matches_plain(emu, blocks, n)
    monkeypatch.setattr(jpeg2000_ht, "HT_SEG_CAP", 0)   # every block from global memory
    k6_matches_plain(emu, blocks, n)


# (w, h, passes, high, irreversible, cblksty): non-square and one-row blocks, cleanup alone and with SigProp /
# MagRef, VSC (causal SigProp)
K6_BLOCKS = [(64, 64, 3, False, True, 0), (64, 64, 3, False, False, 0x08), (1024, 4, 3, False, False, 0),
             (4, 1024, 2, False, True, 0), (1, 64, 3, False, False, 0), (13, 21, 3, True, True, 0x08),
             (33, 9, 2, False, False, 0), (64, 64, 1, True, False, 0), (5, 3, 3, False, True, 0)]


def k6_block_file(w, h, passes, high, irreversible, sty) -> bytes:
    return _block_file(w, h, passes, high, irreversible, seed=w * 7 + h + passes, sty=sty)


@pytest.mark.parametrize("w,h,passes,high,irreversible,sty", K6_BLOCKS)
def test_k6_emulated_matches_plain_on_shapes(emu, w, h, passes, high, irreversible, sty, monkeypatch):
    blocks, n = code_blocks(k6_block_file(w, h, passes, high, irreversible, sty), ht=True)
    assert len(blocks) == 1 and blocks.desc[0, 5:7].tolist() == [w, h]
    k6_matches_plain(emu, blocks, n)
    monkeypatch.setattr(jpeg2000_ht, "HT_SEG_CAP", 0)
    k6_matches_plain(emu, blocks, n)


@pytest.mark.parametrize("seed", range(6))
def test_k6_emulated_matches_plain_on_corrupted_blocks(emu, seed):
    """Bytes changed in a block's segments: the same coefficients as the
    plain readers give, or the same error (OpenJPEG's four checks). Even
    seeds change bytes anywhere (most such blocks fail a check), odd ones
    only MagSgn's and the refinement segment's (which no check reads)."""
    data = np.load(FIXTURES / "image_formats_htj2k.npz")["page_jph"].tobytes()
    blocks, n = code_blocks(data, 64, ht=True)
    rng = np.random.default_rng(seed)
    for d in blocks.desc[:len(blocks) // 2]:   # one corrupted block a time, each against the plain version
        blob = blocks.data[d[0]:d[0] + d[3]]
        lcup, len2 = int(d[1]), int(d[2])
        scup = (int(blob[lcup - 1]) << 4) + (int(blob[lcup - 2]) & 0xF)
        where = np.arange(int(d[3])) if seed % 2 == 0 else np.r_[0:lcup - scup, lcup:lcup + len2]
        one = pack_ht_blocks([([blob.tobytes()], [(lcup, 1), (len2, 2)], int(d[5]), int(d[6]), int(d[7]),
                               int(d[8]), 0, int(d[9]), 0, int(d[5]))])
        hit = rng.choice(where, size=1 + len(where) // 30, replace=False)
        one.data[hit] = rng.integers(0, 256, len(hit), dtype=np.uint8)
        k6_matches_plain(emu, one, int(d[5]) * int(d[6]))


def test_k6_heaviest_first_leaves_plain_output_unchanged():
    """pack_ht_blocks sorts by segment bytes x passes (its `work` field);
    each block keeps its place in the output, so the decode equals
    block-by-block decoding of the image's blocks in their own order."""
    stream, _ = jcs.codestream_of(np.load(FIXTURES / "image_formats_htj2k.npz")["page_jph"].tobytes())
    _, _, blocks, n = _collect(jcs.parse(stream, need_eoc=True))
    packed = pack_ht_blocks(blocks)
    assert (np.diff(packed.desc[:, 12]) <= 0).all() and not (packed.desc[:, 10] == [b[8] for b in blocks]).all()
    assert (packed.desc[:, 0] % 16 == 0).all() and pack_ht_blocks([]).desc.shape == (0, 13)
    want = np.zeros(n, np.int32)
    for chunks, segs, w, h, numbps, mb, roishift, sty, out_off, stride in blocks:
        blob = b"".join(chunks)
        len1, len2 = segs[0][0], segs[1][0] if len(segs) > 1 else 0
        passes = sum(p for _, p in segs[:2])
        vals = decode_ht_block(blob, 0, len1, len2, len(blob), passes, w, h, numbps, mb, roishift, sty)
        for y in range(h):
            want[out_off + y * stride:out_off + y * stride + w] = np.asarray(vals[y * w:(y + 1) * w], np.int64)
    assert np.array_equal(j2k_ht_decode(packed, n, "cpu").numpy(), want)


# ------------------------------------------------------- the card's cases


def write_block_cases(path=BLOCK_CASES) -> Path:
    """Each K5 style file (key `k5_<cw>x<ch>_<mode>_<roi>`) and K6 block
    file (`k6_<w>x<h>_<passes>_<high>_<irreversible>_<sty>`)."""
    arrays = {"k5_" + "_".join(map(str, (f"{cw}x{ch}", mode, roi))): k5_style_file(cw, ch, mode, roi)
              for cw, ch, mode, roi in K5_STYLES}
    arrays.update({"k6_" + "_".join(map(str, (f"{w}x{h}", p, int(hi), int(irr), sty))):
                   k6_block_file(w, h, p, hi, irr, sty) for w, h, p, hi, irr, sty in K6_BLOCKS})
    np.savez_compressed(path, **{k: np.frombuffer(v, np.uint8) for k, v in arrays.items()})
    return Path(path)


def test_block_cases_fixture_is_current(tmp_path):
    want = np.load(write_block_cases(tmp_path / "cases.npz"))
    got = np.load(BLOCK_CASES)
    assert sorted(got.files) == sorted(want.files) and len(got.files) == len(K5_STYLES) + len(K6_BLOCKS)
    for k in want.files:
        assert np.array_equal(got[k], want[k]), k
