"""The page images the reference opens through Pillow's own plugins
beyond the six formats of `test_torch_image_formats.py`: Netpbm (P1-P6,
Pf), ICO / CUR, PSD, PCX / DCX, TGA, SGI, Sun raster, QOI, XBM, XPM,
and arithmetic-coded (SOF9 / SOF10) and lossless (SOF3) JPEGs, decoded
by the port's decoders (`morphik_core_tpu_torch/utils/`) as Pillow 12.1
holds them after `Image.open(...).load()`, on the CPU. Tolerance: exact
everywhere (mode, palette, pixels, payload bytes).

Pillow writes PPM, ICO, TGA, PCX, SGI (verbatim), QOI and XBM; this
module writes PSD, XPM, Sun raster, DCX, CUR, icons with DIB entries,
plain and odd-maxval Netpbm, colour-mapped and mirrored TGAs, planar PCX
and SGI RLE itself. Arithmetic-coded and lossless JPEGs are written by
Pillow's own libjpeg-turbo through ctypes (`libjpeg_write`: its
`jpeg_enable_lossless` and the `arith_code` field). libjpeg's arithmetic
decoder cannot suspend, so Pillow, which feeds it 64 KiB blocks, fails
to load an arithmetic-coded file whose data run past a block; the port
refuses exactly those (`test_arithmetic_files_past_a_pillow_block_are_
refused`). The sniffing order of `Image.open` (`utils/image.py::sniff`)
is held on files several plugins could claim. The committed fixture
(`tests/fixtures/image_formats_more.npz`, `chip_smoke.py` phase 22's new
files) regenerates equal.
"""

import ctypes
import glob
import hashlib
import io
import os
import struct
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, example, given, settings, strategies as st
from PIL import Image

from morphik_core_tpu_torch.models.colqwen.preprocess import resize_mode_u8, to_rgb_u8
from morphik_core_tpu_torch.services.ingestion_service import (UnsupportedContentType, _image_to_data_uri,
                                                               check_upload)
from morphik_core_tpu_torch.utils import jpeg as tjpeg
from morphik_core_tpu_torch.utils.fast_ops import data_uri_to_bytes
from morphik_core_tpu_torch.utils.image import (UnidentifiedImage, UnsupportedImage, decode_image, open_image,
                                                probe_image, read_image, sniff)
from tests.test_torch_decoders import _page
from tests.test_torch_jpeg2000 import htj2k_file, part2_file

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "image_formats_more.npz"
ROADMAP = "ROADMAP Queue 1 item 3b-ii"
EXAMPLES = settings(max_examples=10, deadline=None, suppress_health_check=[HealthCheck.too_slow])


# ------------------------------------------------------------ comparison


def _pil(data: bytes):
    im = Image.open(io.BytesIO(data))
    im.load()
    px = np.asarray(im)
    if im.mode == "1":
        px = px.astype(np.uint8) * 255
    return im, px


def assert_as_pillow(data: bytes, fmt: str = None) -> str:
    """read_image == Pillow: mode, pixels, palette; decode_image ==
    convert("RGB"); the plugin sniffed is Pillow's. -> the mode."""
    im, want = _pil(data)
    px, mode, palette = read_image(data)
    assert sniff(data) == im.format
    if fmt is not None:
        assert im.format == fmt
    assert mode == im.mode
    assert px.dtype == want.dtype and px.shape == want.shape
    assert np.array_equal(px, want, equal_nan=px.dtype.kind == "f")
    if im.mode == "P":
        pal = np.array(im.getpalette(), np.uint8).reshape(-1, 3)
        assert np.array_equal(palette[:len(pal)], pal) and not palette[len(pal):].any()
    else:
        assert palette is None
    assert np.array_equal(decode_image(data), np.asarray(im.convert("RGB")))
    return mode


def as_pillow_or_both_fail(data: bytes) -> None:
    """`assert_as_pillow`, or, where Pillow cannot load the file (its own
    writers make a few such), the port fails on it too."""
    try:
        _pil(data)
    except (OSError, ValueError, SyntaxError):
        with pytest.raises(ValueError):
            read_image(data)
        return
    assert_as_pillow(data)


def _img(h, w, c, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * (3 + k) + y * (2 + k) + 60 * k) % 256 for k in range(c)], -1)
    out = np.clip(base + rng.integers(-25, 25, base.shape), 0, 255).astype(np.uint8)
    return out[..., 0] if c == 1 else out


def _save(img, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(buf, fmt, **kw)
    return buf.getvalue()


sizes = st.tuples(st.integers(1, 41), st.integers(1, 53))


# ------------------------------------------------- libjpeg through ctypes

# jpeglib.h (JPEG_LIB_VERSION 62, x86_64): offsets in jpeg_compress_struct
_C_SIZE, _ERR_SIZE, _COMP_SIZE = 520, 168, 96
_WIDTH, _HEIGHT, _COMPONENTS, _IN_SPACE, _COMP_INFO = 48, 52, 56, 60, 88
_ARITH, _RESTART, _RESTART_ROWS = 260, 280, 284
_LIB = None


def _libjpeg():
    """Pillow's own libjpeg-turbo (`pillow.libs`), with the lossless and
    arithmetic encoder."""
    global _LIB
    if _LIB is None:
        import PIL

        path = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs", "libjpeg-*.so*"))[0]
        _LIB = ctypes.CDLL(path)
        _LIB.jpeg_std_error.restype = ctypes.c_void_p
        _LIB.jpeg_std_error.argtypes = [ctypes.c_void_p]
    return _LIB


def libjpeg_write(px: np.ndarray, arith=False, progressive=False, lossless=None, restart=0, restart_rows=0,
                  colorspace=None, samp=None, quality=75) -> bytes:
    """A JPEG of (H, W) gray or (H, W, 3) RGB pixels written by Pillow's
    libjpeg-turbo: `arith` arithmetic coding (with `progressive`, SOF10),
    `lossless` (predictor, point transform) SOF3, `colorspace` a J_COLOR_SPACE
    for `jpeg_set_colorspace`, `samp` each component's (h, v)."""
    lib = _libjpeg()
    px = np.ascontiguousarray(px, np.uint8)
    h, w = px.shape[:2]
    comps = 1 if px.ndim == 2 else px.shape[2]
    cinfo = ctypes.create_string_buffer(_C_SIZE)
    err = ctypes.create_string_buffer(_ERR_SIZE)
    ctypes.c_void_p.from_buffer(cinfo, 0).value = lib.jpeg_std_error(ctypes.addressof(err))
    lib.jpeg_CreateCompress(cinfo, 62, _C_SIZE)
    out, size = ctypes.c_void_p(), ctypes.c_ulong(0)
    lib.jpeg_mem_dest(cinfo, ctypes.byref(out), ctypes.byref(size))
    ctypes.c_uint.from_buffer(cinfo, _WIDTH).value = w
    ctypes.c_uint.from_buffer(cinfo, _HEIGHT).value = h
    ctypes.c_int.from_buffer(cinfo, _COMPONENTS).value = comps
    ctypes.c_int.from_buffer(cinfo, _IN_SPACE).value = {1: 1, 3: 2}[comps]
    lib.jpeg_set_defaults(cinfo)
    if colorspace is not None:
        lib.jpeg_set_colorspace(cinfo, colorspace)
    lib.jpeg_set_quality(cinfo, quality, 1)
    if samp is not None:
        info = ctypes.c_void_p.from_buffer(cinfo, _COMP_INFO).value
        for k, (hs, vs) in enumerate(samp):
            ctypes.c_int.from_address(info + _COMP_SIZE * k + 8).value = hs
            ctypes.c_int.from_address(info + _COMP_SIZE * k + 12).value = vs
    ctypes.c_int.from_buffer(cinfo, _ARITH).value = int(arith)
    if progressive:
        lib.jpeg_simple_progression(cinfo)
    if lossless is not None:
        lib.jpeg_enable_lossless(cinfo, lossless[0], lossless[1])
    ctypes.c_uint.from_buffer(cinfo, _RESTART).value = restart
    ctypes.c_int.from_buffer(cinfo, _RESTART_ROWS).value = restart_rows
    lib.jpeg_start_compress(cinfo, 1)
    rows = (ctypes.c_void_p * h)(*[px.ctypes.data + r * w * comps for r in range(h)])
    lib.jpeg_write_scanlines(cinfo, rows, h)
    lib.jpeg_finish_compress(cinfo)
    data = ctypes.string_at(out.value, size.value)
    lib.jpeg_destroy_compress(cinfo)
    ctypes.CDLL(None).free(out)
    return data


def arith_past_a_block(pixels: np.ndarray) -> bytes:
    """An arithmetic-coded JPEG (SOF9) of `pixels` whose data run past
    Pillow's first 64 KiB block: one Pillow cannot load and the port
    refuses."""
    data = libjpeg_write(pixels, arith=True, quality=95)
    assert len(data) > 80_000
    return data


def _sof(data: bytes) -> int:
    return next(data[i + 1] for i in range(2, len(data) - 1)
                if data[i] == 0xFF and 0xC0 <= data[i + 1] <= 0xCF and data[i + 1] not in (0xC4, 0xC8, 0xCC))


def test_aritab_is_libjpegs():
    table = (ctypes.c_long * 114).in_dll(_libjpeg(), "jpeg_aritab")
    assert list(table) == tjpeg._ARITAB


# ----------------------------------------------------------------- JPEG


@EXAMPLES
@given(sizes, st.sampled_from([1, 3]), st.sampled_from(["420", "444", "422"]), st.booleans(),
       st.sampled_from([0, 1, 3]), st.integers(0, 99))
def test_arithmetic_jpegs_match_pillow(hw, c, sub, progressive, restart, seed):
    """Real SOF9 / SOF10 files: every sampling, restarts, quality."""
    h, w = hw
    samp = None if c == 1 else {"420": None, "444": [(1, 1)] * 3, "422": [(2, 1), (1, 1), (1, 1)]}[sub]
    data = libjpeg_write(_img(h, w, c, seed), arith=True, progressive=progressive, restart=restart, samp=samp,
                         quality=40 + seed % 60)
    assert _sof(data) == (0xCA if progressive else 0xC9)
    assert_as_pillow(data, "JPEG")


def test_arithmetic_conditioning_and_large_values():
    """A DAC segment's conditioning (L, U, K) and coefficients of every
    magnitude: the file's DAC bytes changed before the scan, and noise at
    quality 100."""
    noise = np.random.default_rng(1).integers(0, 256, (40, 56, 3)).astype(np.uint8)
    for data in (libjpeg_write(noise, arith=True, quality=100, samp=[(1, 1)] * 3),
                 libjpeg_write(noise[..., 0], arith=True, progressive=True, quality=100)):
        assert_as_pillow(data)
        at = data.index(b"\xff\xda")
        for body in (bytes([0x00, 0x52, 0x10, 0x02]), bytes([0x00, 0x30, 0x11, 0x3f, 0x01, 0x00])):
            dac = b"\xff\xcc" + struct.pack(">H", len(body) + 2) + body
            assert_as_pillow(data[:at] + dac + data[at:])


@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("pt", [0, 1, 3])
def test_lossless_jpegs_every_predictor_and_point_transform(psv, pt):
    for c, kw in ((1, {}), (3, {}), (3, dict(colorspace=3)), (3, dict(colorspace=3, samp=[(2, 1), (1, 1), (1, 1)]))):
        data = libjpeg_write(_img(23 + psv, 31 + pt, c, psv), lossless=(psv, pt), **kw)
        assert _sof(data) == 0xC3
        assert_as_pillow(data, "JPEG")


@EXAMPLES
@given(sizes, st.sampled_from([1, 3]), st.integers(1, 7), st.sampled_from([0, 1, 2]), st.integers(0, 99))
def test_lossless_jpegs_match_pillow(hw, c, psv, restart_rows, seed):
    h, w = hw
    kw = dict(colorspace=3, samp=[(2, 2), (1, 1), (1, 1)]) if c == 3 and seed % 2 else {}
    data = libjpeg_write(_img(h, w, c, seed), lossless=(psv, seed % 3), restart_rows=restart_rows, **kw)
    assert_as_pillow(data, "JPEG")


def test_lossless_component_ids_decide_the_colour_space():
    """Unknown component ids make a lossless file RGB (jdapimin.c), a DCT
    file YCbCr; ids 1, 2, 3 are YCbCr in both."""
    img = _img(20, 24, 3, 5)
    for data in (libjpeg_write(img, lossless=(1, 0), colorspace=3), libjpeg_write(img, quality=90)):
        at = data.index(b"\xff\xc0" if _sof(data) == 0xC0 else b"\xff\xc3")
        for ids in ((1, 2, 3), (7, 8, 9)):
            out = bytearray(data)
            for k, cid in enumerate(ids):
                out[at + 10 + 3 * k] = cid
            sos = out.index(b"\xff\xda")
            for k, cid in enumerate(ids):
                out[sos + 5 + 2 * k] = cid
            body = bytes(out)
            app = body.find(b"\xff\xe0")
            if app >= 0:   # drop JFIF so the ids decide
                body = body[:app] + body[app + 2 + struct.unpack(">H", body[app + 2:app + 4])[0]:]
            assert_as_pillow(body)


def test_arithmetic_files_past_a_pillow_block_are_refused():
    """Pillow feeds libjpeg 64 KiB blocks and libjpeg's arithmetic decoder
    cannot wait for the next one: a file whose arithmetic-coded data run
    past a block fails to load; the port refuses exactly those, and
    decodes the rest as Pillow does."""
    noise = np.random.default_rng(0).integers(0, 256, (440, 400, 3)).astype(np.uint8)
    seen = set()
    for rows in range(396, 436, 3):
        for progressive in (False, True):
            data = libjpeg_write(noise[:rows], arith=True, quality=60 + rows % 3, progressive=progressive)
            try:
                want = _pil(data)[1]
            except OSError:
                want = None
            if want is None:
                with pytest.raises(UnsupportedImage, match=f"arithmetic-coded JPEG whose data.*{ROADMAP}"):
                    probe_image(data)
                with pytest.raises(UnsupportedContentType):
                    check_upload("image/jpeg", data)
            else:
                assert np.array_equal(read_image(data)[0], want)
            seen.add(want is None)
    assert seen == {True, False}


# --------------------------------------------------------------- Netpbm


def _pnm(magic: bytes, w, h, maxval, body: bytes, comment=b"") -> bytes:
    head = magic + b"\n" + comment + b"%d %d\n" % (w, h)
    return head + (b"%d\n" % maxval if maxval is not None else b"") + body


@EXAMPLES
@given(sizes, st.integers(0, 99))
def test_netpbm_raw_and_plain_match_pillow(hw, seed):
    h, w = hw
    rgb = _img(h, w, 3, seed)
    rng = np.random.default_rng(seed)
    for mode in ("1", "L", "RGB", "F"):
        img = Image.fromarray(rgb).convert(mode)
        if mode == "F":
            img = Image.fromarray((rgb[..., 0].astype(np.float32) - 100.5) * 3.25)
        assert_as_pillow(_save(img, "PPM"), "PPM")
    assert_as_pillow(_save(Image.fromarray(rgb[..., 0].astype(np.uint16) * 257), "PPM"))   # I from P5 65535
    for maxval in (1, 7, 100, 255, 256, 1000, 65534):
        for magic, c in ((b"P5", 1), (b"P6", 3)):
            v = rng.integers(0, maxval + 1, (h, w, c))
            body = v.astype(">u2" if maxval > 255 else np.uint8).tobytes()
            assert_as_pillow(_pnm(magic, w, h, maxval, body, b"# a comment\n"))
        for magic, c in ((b"P2", 1), (b"P3", 3)):
            v = rng.integers(0, maxval + 1, (h, w * c))
            text = b"\n".join(b" ".join(b"%d" % x for x in row) + b" # row\r" for row in v)
            assert_as_pillow(_pnm(magic, w, h, maxval, text + b"\n"))
    bits = rng.integers(0, 2, (h, w))
    assert_as_pillow(_pnm(b"P1", w, h, None, b"".join(b"%d" % x for x in bits.reshape(-1)) + b"\n"))
    assert_as_pillow(_pnm(b"P1", w, h, None, b"\n".join(b" ".join(b"%d" % x for x in r) for r in bits) + b"\n"))
    le = (rgb[..., 1].astype("<f4") / 7)[::-1].tobytes()
    assert_as_pillow(b"Pf\n%d %d\n-1.0\n" % (w, h) + le)


def test_netpbm_extensions_and_errors():
    """Pillow's own P0CMYK / PyRGBA / PyCMYK (its PyP, a palette image
    with no palette, refused), a token split across the plain decoder's
    1 MiB blocks, and the header errors that fail the file as they fail
    Pillow."""
    rng = np.random.default_rng(3)
    with pytest.raises(UnsupportedImage, match="PyP"):
        probe_image(_pnm(b"PyP", 2, 2, 255, bytes(4)))
    for magic, c in ((b"P0CMYK", 4), (b"PyRGBA", 4), (b"PyCMYK", 4)):
        v = rng.integers(0, 256, (5, 7, c)).astype(np.uint8)
        for maxval in (255, 300):
            body = v.astype(">u2" if maxval > 255 else np.uint8).tobytes()
            assert_as_pillow(_pnm(magic, 7, 5, maxval, body))
    w = 700
    v = rng.integers(0, 65536, (260, w))
    text = b"\n".join(b" ".join(b"%d" % x for x in row) for row in v)
    assert len(text) > 1 << 20
    assert_as_pillow(_pnm(b"P2", w, 260, 65535, text + b"\n"))
    for bad in (_pnm(b"P5", 3, 2, 0, bytes(6)), _pnm(b"P5", 3, 2, 70000, bytes(6)), b"P5\n3 2\n255\n" + bytes(3),
                b"P6\n12345678901 2\n255\n", _pnm(b"P2", 2, 1, 9, b"3 12\n"), b"Pf\n2 2\n0\n" + bytes(16)):
        with pytest.raises((OSError, ValueError, SyntaxError)):
            _pil(bad)
        with pytest.raises(ValueError):
            read_image(bad)


# -------------------------------------------------------------- ICO, CUR


def _dib(px_rows: bytes, w, h2, bits, palette=None, compression=0) -> bytes:
    head = struct.pack("<IiiHHIIiiII", 40, w, h2, 1, bits, compression, len(px_rows), 0, 0,
                       0 if palette is None else len(palette), 0)
    pal = b"".join(bytes([b, g, r, 0]) for r, g, b in palette) if palette is not None else b""
    return head + pal + px_rows


def _rows(vals: np.ndarray, bits: int) -> bytes:
    """Bottom-up rows padded to 32 bits (BMP)."""
    h, w = vals.shape[:2]
    if bits < 8:
        packed = np.packbits(np.unpackbits(vals.astype(np.uint8)[..., None], axis=-1)[..., 8 - bits:]
                             .reshape(h, -1), axis=1)
    else:
        packed = vals.reshape(h, -1).astype(np.uint8)
    stride = (w * bits + 31) // 32 * 4
    out = np.zeros((h, stride), np.uint8)
    out[:, :packed.shape[1]] = packed
    return out[::-1].tobytes()


def icon(entries, magic=b"\0\0\1\0") -> bytes:
    """An ICO / CUR of (width byte, height byte, bpp, body) entries."""
    head = magic + struct.pack("<H", len(entries))
    offset = 6 + 16 * len(entries)
    dirs, bodies = b"", b""
    for wb, hb, bpp, body in entries:
        dirs += struct.pack("<BBBBHHII", wb, hb, 0, 0, 1, bpp, len(body), offset + len(bodies))
        bodies += body
    return head + dirs + bodies


def _dib_entry(h, w, bits, seed, palette_gray=False):
    rng = np.random.default_rng(seed)
    mask = rng.integers(0, 2, (h, w))
    if bits <= 8:
        n = 1 << bits
        pal = [(i, i, i) for i in range(n)] if palette_gray else [tuple(rng.integers(0, 256, 3)) for _ in range(n)]
        xor = _rows(rng.integers(0, n, (h, w)), bits)
    else:
        pal = None
        xor = _rows(rng.integers(0, 256, (h, w, bits // 8)), bits)
    return _dib(xor + _rows(mask, 1), w, 2 * h, bits, pal)


@EXAMPLES
@given(st.integers(1, 40), st.integers(1, 40), st.sampled_from([1, 4, 8, 24, 32]), st.booleans(), st.integers(0, 99))
def test_icons_and_cursors_match_pillow(h, w, bits, gray, seed):
    """DIB entries of every depth with their AND masks, a PNG entry, the
    entry Pillow picks (largest, then lowest depth); cursors as their
    first DIB's rows, the 32-bit one at offset 22 as RGBA."""
    body = _dib_entry(h, w, bits, seed, gray and bits != 4)
    small = _dib_entry(3, 3, 8, seed + 1)
    png = _save(_img(h, w, 3, seed), "PNG")
    for data in (icon([(w % 256, h % 256, bits, body)]),
                 icon([(3, 3, 8, small), (w % 256, h % 256, 32, png), (w % 256, h % 256, bits, body)]),
                 icon([(w % 256, h % 256, bits, body)], b"\0\0\2\0"),
                 icon([(3, 3, 8, small), (w % 256, h % 256, bits, body)], b"\0\0\2\0")):
        as_pillow_or_both_fail(data)


def test_icon_with_4_bit_rows_under_a_gray_palette_is_refused_as_a_bmp_is():
    """Pillow reads such a DIB as 8-bit "L" rows (it misreads them, or fails
    on wider ones); the port refuses it, as it refuses the BMP."""
    for w in (1, 9):
        with pytest.raises(UnsupportedImage, match="4-bit rows under a L palette"):
            read_image(icon([(w, 3, 4, _dib_entry(3, w, 4, 0, True))]))


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_dib_files_match_pillow(mode):
    """A BMP without its 14-byte file header (Pillow's DIB plugin, in
    `Image.open`'s first pass): the pixels follow the header, masks and
    palette."""
    img = Image.fromarray(_img(13, 19, 4, 3)).convert(mode) if mode != "P" else \
        Image.fromarray(_img(13, 19, 3, 3)).quantize(20)
    assert_as_pillow(_save(img, "BMP")[14:], "DIB")


def test_icons_pillow_writes():
    rgba = np.concatenate([_img(40, 48, 3, 1), _img(40, 48, 1, 2)[..., None]], -1)
    for kw in (dict(sizes=[(16, 16), (32, 32), (48, 48)]), dict(sizes=[(24, 24)], bitmap_format="bmp")):
        assert_as_pillow(_save(Image.fromarray(rgba), "ICO", **kw), "ICO")


# ------------------------------------------------------------------- PSD


def psd_bytes(planes: np.ndarray, psd_mode: int, bits=8, compression=0, palette=None, layers=False,
              extra_channels=0) -> bytes:
    """A PSD of (channels, H, W) planes (bits 1: packed rows), raw or
    PackBits, an optional colour table and a layer section the composite
    follows."""
    c, h, w = planes.shape[0], planes.shape[1], planes.shape[2]
    if bits == 1:
        rows = [np.packbits(p.astype(np.uint8), axis=1) for p in planes]
    else:
        rows = list(planes.astype(np.uint8))
    rows += [np.full_like(rows[0], 7)] * extra_channels
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, len(rows), h, w, bits, psd_mode)
    cmd = b"" if palette is None else palette.T.astype(np.uint8).tobytes()
    res = b"8BIM" + struct.pack(">H", 1005) + b"\x00\x00" + struct.pack(">I", 3) + b"abc\x00"
    lay = b""
    if layers:
        info = struct.pack(">h", 1) + struct.pack(">iiiiH", 0, 0, 1, 1, 1) + struct.pack(">hI", 0, 1) + \
            b"8BIMnorm" + b"\xff\x00\x00\x00" + struct.pack(">I", 0) + struct.pack(">H", 0) + b"\x05"
        info += b"\x00" * (len(info) % 2)
        lay = struct.pack(">I", len(info)) + info
    out = head + struct.pack(">I", len(cmd)) + cmd + struct.pack(">I", len(res)) + res + \
        struct.pack(">I", len(lay)) + lay + struct.pack(">H", compression)
    if compression == 0:
        return out + b"".join(r.tobytes() for r in rows)
    packed = [[packbits_row(r.tobytes()) for r in plane] for plane in rows]
    counts = b"".join(struct.pack(">H", len(p)) for plane in packed for p in plane)
    return out + counts + b"".join(p for plane in packed for p in plane)


def packbits_row(data: bytes) -> bytes:
    """PackBits: runs of 3+ equal bytes as runs, the rest as literals."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


@EXAMPLES
@given(sizes, st.sampled_from([0, 1]), st.booleans(), st.integers(0, 99))
def test_psd_every_mode_matches_pillow(hw, compression, layers, seed):
    h, w = hw
    rng = np.random.default_rng(seed)
    for psd_mode, c, bits in ((0, 1, 1), (1, 1, 8), (0, 1, 8), (8, 1, 8), (3, 3, 8), (3, 4, 8), (4, 4, 8)):
        planes = rng.integers(0, 2, (c, h, w)) if bits == 1 else _img(h, w, c, seed).reshape(h, w, c).transpose(2, 0, 1)
        assert_as_pillow(psd_bytes(planes, psd_mode, bits, compression, layers=layers), "PSD")
    pal = rng.integers(0, 256, (256, 3))
    assert_as_pillow(psd_bytes(rng.integers(0, 256, (1, h, w)), 2, 8, compression, palette=pal))
    # five channels: RGB with spare ones (the byte counts of only three are read)
    as_pillow_or_both_fail(psd_bytes(_img(h, w, 3, seed).transpose(2, 0, 1), 3, 8, compression, extra_channels=2))


def test_psd_refusals_and_zip_compression():
    """Lab is refused; ZIP compression gives Pillow no tile, and both fail."""
    planes = _img(6, 7, 3, 1).transpose(2, 0, 1)
    with pytest.raises(UnsupportedImage, match="Lab"):
        probe_image(psd_bytes(planes, 9))
    zip_psd = psd_bytes(planes, 3, compression=2)
    with pytest.raises(OSError, match="cannot load this image"):
        _pil(zip_psd)
    with pytest.raises(ValueError, match="cannot load this image"):
        read_image(zip_psd)


# ------------------------------------------------------------- PCX, DCX


def pcx_planar(idx: np.ndarray, planes: int, palette: np.ndarray, stride=None) -> bytes:
    """A 1-bit x `planes` PCX (RLE) of palette indices."""
    h, w = idx.shape
    s = (w + 7) // 8
    stride = stride or s + s % 2
    head = struct.pack("<BBBBHHHHHH", 10, 5, 1, 1, 0, 0, w - 1, h - 1, 72, 72)
    head += palette[:16].astype(np.uint8).tobytes().ljust(48, b"\0") + b"\0" + bytes([planes])
    head += struct.pack("<HH", stride, 1) + bytes(58)
    body = bytearray()
    for row in idx:
        for p in range(planes):
            bits = np.packbits((row >> p) & 1)
            line = bits.tobytes().ljust(stride, b"\0")
            for b in line:
                body += bytes([0xC1, b]) if b >= 0xC0 else bytes([b])
    return head + bytes(body)


def dcx_bytes(pages) -> bytes:
    head = struct.pack("<I", 0x3ADE68B1)
    offsets, at = [], 4 + 4 * (len(pages) + 1)
    for p in pages:
        offsets.append(at)
        at += len(p)
    return head + b"".join(struct.pack("<I", o) for o in offsets) + b"\0\0\0\0" + b"".join(pages)


@EXAMPLES
@given(sizes, st.integers(0, 99))
@example(hw=(1, 3), seed=0)    # RGB planes at 0 / 3 / 6 of a 12-byte row (PcxDecode.c's band rule)
@example(hw=(5, 3), seed=7)
@example(hw=(2, 1), seed=1)    # a row a multiple of the width, bands one byte apart
@example(hw=(3, 5), seed=2)    # planes at their share of the row, 0 / 6 / 12
def test_pcx_and_dcx_match_pillow(hw, seed):
    h, w = hw
    rgb = _img(h, w, 3, seed)
    rng = np.random.default_rng(seed)
    files = [_save(Image.fromarray(rgb).convert(m), "PCX") for m in ("1", "L", "RGB")]
    files.append(_save(Image.fromarray(rgb).quantize(1 + seed % 200), "PCX"))
    pal = rng.integers(0, 256, (16, 3))
    for planes in (2, 4):
        idx = rng.integers(0, 1 << planes, (h, w))
        files.append(pcx_planar(idx, planes, pal))
        files.append(pcx_planar(idx, planes, pal, stride=(w + 7) // 8 + 2))
    for data in files:
        as_pillow_or_both_fail(data)   # Pillow cannot read its own RGB PCX one pixel wide
    as_pillow_or_both_fail(dcx_bytes(files[:3]))
    assert_as_pillow(dcx_bytes([files[1], files[0]]), "DCX")   # an L first page and a PCX after it


def test_pcx_run_past_a_row_fails_as_pillow_fails():
    data = bytearray(_save(Image.fromarray(_img(3, 8, 1, 1)), "PCX"))
    data[128:130] = bytes([0xC9, 0x11])   # a run of 9 in an 8-byte row
    for fn in (_pil, read_image):
        with pytest.raises((OSError, ValueError)):
            fn(bytes(data))


# ------------------------------------------------------------------- TGA


def tga_bytes(pixels: bytes, w, h, image_type, depth, cmap=None, cmap_depth=0, cmap_start=0, flags=0,
              id_field=b"") -> bytes:
    head = struct.pack("<BBBHHBHHHHBB", len(id_field), 1 if cmap is not None else 0, image_type, cmap_start,
                       0 if cmap is None else len(cmap) // (cmap_depth // 8), cmap_depth, 0, 0, w, h, depth, flags)
    return head + id_field + (cmap or b"") + pixels


def tga_rle(rows: np.ndarray, px_bytes: int, seed: int) -> bytes:
    """Row by row packets: runs where pixels repeat, literals elsewhere,
    a literal sometimes running on into the next row."""
    rng = np.random.default_rng(seed)
    flat = rows.reshape(-1, px_bytes)
    out, i, n, w = bytearray(), 0, len(flat), rows.shape[1] // px_bytes
    while i < n:
        j = i
        while j + 1 < n and j - i < 127 and (flat[j + 1] == flat[i]).all() and (j + 1) % w:
            j += 1
        if j > i:
            out += bytes([0x80 | (j - i)]) + flat[i].tobytes()
            i = j + 1
            continue
        k = min(n, i + int(rng.integers(1, 20)), i + 128)
        out += bytes([k - i - 1]) + flat[i:k].tobytes()
        i = k
    return bytes(out)


@EXAMPLES
@given(sizes, st.sampled_from([0x00, 0x10, 0x20, 0x30]), st.booleans(), st.integers(0, 99))
def test_tga_types_depths_maps_and_orientations_match_pillow(hw, flags, rle, seed):
    h, w = hw
    rng = np.random.default_rng(seed)
    cases = []
    for depth in (8, 16, 24, 32):
        gray = depth in (8, 16)
        if depth == 16:
            px = rng.integers(0, 256, (h, w * 2)).astype(np.uint8)
            cases += [(px, 3, 16, {}), (px, 2, 16, {})]
        else:
            px = rng.integers(0, 256, (h, w * depth // 8)).astype(np.uint8)
            cases.append((px, 3 if gray else 2, depth, {}))
    idx = rng.integers(0, 40, (h, w)).astype(np.uint8)
    for cmap_depth in (16, 24, 32):
        cmap = rng.integers(0, 256, 37 * cmap_depth // 8).astype(np.uint8).tobytes()
        cases.append((idx, 1, 8, dict(cmap=cmap, cmap_depth=cmap_depth, cmap_start=3)))
    cases.append((idx, 1, 8, {}))   # colour-mapped type with no map: Pillow reads it as L
    bits = np.packbits(rng.integers(0, 2, (h, w)).astype(np.uint8), axis=1)
    for px, itype, depth, kw in cases:
        body = tga_rle(px, (depth + 7) // 8, seed) if rle else px.tobytes()
        data = tga_bytes(body, w, h, itype | (8 if rle else 0), depth, flags=flags, id_field=b"id" * (seed % 3),
                         **kw)
        as_pillow_or_both_fail(data)   # a mapped type without a map opens as "L" and fails to load
    assert_as_pillow(tga_bytes(bits.tobytes(), w, h, 3, 1, flags=flags), "TGA")


def test_tga_pillow_writes_and_refusals():
    rgba = np.concatenate([_img(21, 33, 3, 1), _img(21, 33, 1, 2)[..., None]], -1)
    for mode in ("1", "L", "LA", "P", "RGB", "RGBA"):
        img = Image.fromarray(rgba).convert(mode) if mode != "P" else Image.fromarray(rgba[..., :3]).quantize(30)
        for rle in (False, True):
            if mode == "1" and rle:
                continue   # Pillow cannot read its own 1-bit RLE file
            for orientation in (-1, 1):
                assert_as_pillow(_save(img, "TGA", rle=rle, orientation=orientation), "TGA")
    # a 15-bit colour map is no TGA to Pillow, and nothing else claims it
    bad = tga_bytes(bytes(6), 3, 2, 1, 8, cmap=bytes(8), cmap_depth=15)
    with pytest.raises(UnidentifiedImage):
        probe_image(bad)


def tga_shaped_claims():
    """TGA headers whose first bytes an earlier plugin accepts: -> (name,
    bytes, the format Pillow loads them as, or None where it fails)."""
    px = bytes(range(256)) * 4
    out = []
    # a 10-byte ID field and no colour map: PCX's accept, a valid box (the origin) and no PCX mode
    out.append(("pcx_claims", tga_bytes(px[:72], 6, 4, 2, 24, id_field=b"\x07" * 10), None))
    # the same with a colour map start of 0x1000 (ignored without a map): a bad box, so TGA reads it
    out.append(("pcx_bad_box", tga_bytes(px[:72], 6, 4, 2, 24, cmap_start=0x1000, id_field=b"\x07" * 10), "TGA"))
    # type 2, map start 0: CUR's accept; no entries, then TGA
    out.append(("cur_no_entries", tga_bytes(px[:72], 6, 4, 2, 24), "TGA"))
    # one cursor entry (a map length of 256): its DIB offset is past the file, then TGA
    cur = bytearray(tga_bytes(px[:72], 6, 4, 2, 24))
    cur[5] = 1
    out.append(("cur_entry", bytes(cur), "TGA"))
    # type 1, map type 0, an entry count: ICO's accept and entries, then TGA, which cannot load "L" from "P"
    ico = bytearray(tga_bytes(px[:24], 6, 4, 1, 8, cmap=bytes(30), cmap_depth=24))
    ico[1], ico[5] = 0, 1
    out.append(("ico_entry", bytes(ico), None))
    return out


@pytest.mark.parametrize("name,data,fmt", tga_shaped_claims(), ids=[c[0] for c in tga_shaped_claims()])
def test_tga_shaped_files_go_to_the_plugin_pillow_picks(name, data, fmt):
    """A TGA-shaped file an earlier plugin claims is never read as TGA:
    where that plugin fails the file, the port fails it too."""
    try:
        got = _pil(data)[0].format
    except (OSError, ValueError):
        got = None
    assert got == fmt
    if fmt == "TGA":
        assert_as_pillow(data, "TGA")
    else:
        with pytest.raises(ValueError):
            read_image(data)


# ------------------------------------------------------------------- SGI


def sgi_rle(planes: np.ndarray, bpc: int) -> bytes:
    """An SGI RLE file of (z, H, W) planes (rows stored bottom-up)."""
    z, h, w = planes.shape
    head = struct.pack(">HBBHHHH", 474, 1, bpc, 3 if z > 1 else 2, w, h, z) + bytes(500)
    rows, starts, lengths = [], [], []
    at = 512 + 8 * h * z
    dt = ">u2" if bpc == 2 else np.uint8
    for c in range(z):
        for y in range(h):
            row = planes[c, h - 1 - y]
            out, i = [], 0
            while i < w:
                j = i
                while j < w and j - i < 127 and row[j] == row[i]:
                    j += 1
                if j - i >= 3:
                    out.append(np.array([j - i, row[i]], dt).tobytes())
                    i = j
                else:
                    j = min(w, i + 5)
                    out.append(np.array([0x80 | (j - i)], dt).tobytes() + row[i:j].astype(dt).tobytes())
                    i = j
            out.append(np.array([0], dt).tobytes())
            body = b"".join(out)
            rows.append(body)
            starts.append(at)
            lengths.append(len(body))
            at += len(body)
    return head + struct.pack(f">{h * z}I", *starts) + struct.pack(f">{h * z}I", *lengths) + b"".join(rows)


@EXAMPLES
@given(sizes, st.integers(0, 99))
def test_sgi_verbatim_and_rle_match_pillow(hw, seed):
    h, w = hw
    img = _img(h, w, 4, seed)
    for mode in ("L", "RGB", "RGBA"):
        for bpc in (1, 2):
            assert_as_pillow(_save(Image.fromarray(img).convert(mode), "SGI", bpc=bpc), "SGI")
        planes = np.asarray(Image.fromarray(img).convert(mode)).reshape(h, w, -1).transpose(2, 0, 1)
        planes = (planes // 16) * 16   # runs
        assert_as_pillow(sgi_rle(planes, 1), "SGI")
        assert_as_pillow(sgi_rle(planes.astype(np.int64) * 257 + 3, 2), "SGI")


# ------------------------------------------------------------------- Sun


def sun_bytes(rows: np.ndarray, w, h, depth, ftype=1, cmap=None) -> bytes:
    stride = (w * depth + 15) // 16 * 2
    if ftype == 2:
        body = sun_rle(rows.reshape(h, -1)[:, :(w * depth + 7) // 8].tobytes())
    else:
        out = np.zeros((h, stride), np.uint8)
        r = rows.reshape(h, -1)
        out[:, :r.shape[1]] = r
        body = out.tobytes()
    cm = b"" if cmap is None else cmap.T.astype(np.uint8).tobytes()
    head = struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), ftype, 1 if cmap is not None else 0, len(cm))
    return head + cm + body


def sun_rle(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 256 and data[j] == data[i]:
            j += 1
        if j - i >= 3 or data[i] == 0x80:
            out += bytes([0x80, j - i - 1, data[i]]) if j - i > 1 else b"\x80\x00"
            i = j
        else:
            out.append(data[i])
            i += 1
    return bytes(out)


@EXAMPLES
@given(sizes, st.integers(0, 99))
def test_sun_raster_matches_pillow(hw, seed):
    """Every depth, type, colour map and RLE; a file 1 or 2 pixels wide can
    pass for a GIMP brush header, which Pillow then fails to load and the
    port refuses."""
    h, w = hw
    rng = np.random.default_rng(seed)
    rgb = (_img(h, w, 3, seed) // 32 * 32).astype(np.uint8)
    rgb[0, 0] = 0x80
    for ftype in (1, 2, 3):
        for depth in (24, 32):
            px = rgb if depth == 24 else np.concatenate([rgb, np.full((h, w, 1), 9, np.uint8)], -1)
            as_pillow_or_both_fail(sun_bytes(px, w, h, depth, ftype))
        gray = rgb[..., 0]
        as_pillow_or_both_fail(sun_bytes(gray, w, h, 8, ftype))
        as_pillow_or_both_fail(sun_bytes(gray, w, h, 8, ftype, cmap=rng.integers(0, 256, (256, 3))))
        nib = (gray >> 4).astype(np.uint8)
        packed = np.pad(nib, ((0, 0), (0, w % 2)))
        packed = (packed[:, 0::2] << 4 | packed[:, 1::2]).astype(np.uint8)
        as_pillow_or_both_fail(sun_bytes(packed, w, h, 4, ftype))
        as_pillow_or_both_fail(sun_bytes(packed, w, h, 4, ftype, cmap=rng.integers(0, 256, (16, 3))))
        as_pillow_or_both_fail(sun_bytes(np.packbits(gray > 100, axis=1), w, h, 1, ftype))


# ------------------------------------------------------------- QOI, X11


@EXAMPLES
@given(sizes, st.integers(0, 99))
def test_qoi_and_xbm_match_pillow(hw, seed):
    h, w = hw
    rgba = np.concatenate([_img(h, w, 3, seed) // 8 * 8, _img(h, w, 1, seed + 1)[..., None] // 64 * 64], -1)
    for mode in ("RGB", "RGBA"):
        assert_as_pillow(_save(Image.fromarray(rgba).convert(mode), "QOI"), "QOI")
    bits = Image.fromarray(_img(h, w, 1, seed) > 128)
    assert_as_pillow(_save(bits, "XBM"), "XBM")
    assert_as_pillow(_save(bits, "XBM", hotspot=(1, 2)), "XBM")


def test_qoi_index_and_run_rules():
    """A run before any pixel leaves (0, 0, 0, 255) out of the index, and
    an index op into an empty slot reads (0, 0, 0, 0), as Pillow's decoder
    has it."""
    ops = bytes([0xC1, 53, 0, 0xFE, 1, 2, 3, 0xFF, 9, 8, 7, 6, 0x40 | 0x1B, 0x80 | 40, 0x88, 0xC0, 5])
    data = b"qoif" + struct.pack(">II", 4, 3) + bytes([4, 0]) + ops + bytes(7) + b"\x01"
    assert_as_pillow(data, "QOI")


def xpm_bytes(idx: np.ndarray, colours, cpp=1, none_key=None, per_line=None) -> bytes:
    h, w = idx.shape
    keys = [bytes([33 + (i // 90) % 90, 35 + i % 90])[-cpp:] if cpp <= 2 else b"%03d" % i for i in
            range(len(colours))]
    lines = [b"/* XPM */", b"static char *x[] = {", b'"%d %d %d %d",' % (w, h, len(colours) + bool(none_key), cpp)]
    lines += [b'"' + k + b" c #%06X" % c + b'",' for k, c in zip(keys, colours)]
    if none_key:
        lines.append(b'"' + none_key + b' c None",')
    lines.append(b"/* pixels */")
    flat = b"".join(keys[i] for i in idx.reshape(-1))
    per_line = per_line or w * cpp
    lines += [b'"' + flat[i:i + per_line] + b'",' for i in range(0, len(flat), per_line)]
    return b"\n".join(lines) + b"\n};\n"


@EXAMPLES
@given(sizes, st.sampled_from([1, 2, 3]), st.integers(0, 99))
def test_xpm_matches_pillow(hw, cpp, seed):
    h, w = hw
    rng = np.random.default_rng(seed)
    n = 300 if cpp == 3 else 1 + seed % 60
    colours = [int(v) for v in rng.integers(0, 1 << 24, n)]
    idx = rng.integers(0, n, (h, w))
    assert_as_pillow(xpm_bytes(idx, colours, cpp), "XPM")
    assert_as_pillow(xpm_bytes(idx, colours, cpp, none_key=b"~" * cpp, per_line=cpp * max(1, w // 2 + 1)))


def test_xpm_colour_syntax_as_pillow_takes_it():
    """Only `c` keys with `#` hex: long hex keeps its low 24 bits, a colour
    name fails, a pixel naming the None colour fails."""
    base = b'/* XPM */\nstatic char *x[] = {\n"2 1 2 1",\n"a c #123456789ABC",\n"b m #000 c #FFF",\n"ab"};\n'
    assert_as_pillow(base)
    for bad in (base.replace(b"#FFF", b"white"), base.replace(b"c #FFF", b"c None")):
        with pytest.raises(ValueError):
            _pil(bad)
        with pytest.raises(ValueError):
            read_image(bad)


# ------------------------------------------------------ modes, payloads


def test_i_f_and_la_resize_and_convert_as_pillow():
    rng = np.random.default_rng(0)
    for mode, arr in (("I", rng.integers(-70000, 70000, (37, 53)).astype(np.int32)),
                      ("F", (rng.standard_normal((37, 53)) * 300).astype(np.float32))):
        im = Image.fromarray(arr, mode)
        for size in ((17, 23), (37, 20), (50, 80)):
            assert np.array_equal(resize_mode_u8(arr, mode, size), np.asarray(im.resize(size[::-1], Image.LANCZOS)))
        assert np.array_equal(to_rgb_u8(arr, mode), np.asarray(im.convert("RGB")))
    f = np.array([[-5.5, 0.4, 0.6, 1.5, 254.6, 255.2, 300, np.nan, np.inf, -np.inf]], np.float32)
    assert np.array_equal(to_rgb_u8(f, "F"), np.asarray(Image.fromarray(f, "F").convert("RGB")))


def _jax_payload(data: bytes) -> bytes:
    from morphik_core_tpu.services.ingestion_service import _image_to_data_uri as j_image_to_data_uri

    return data_uri_to_bytes(j_image_to_data_uri(Image.open(io.BytesIO(data)), max_width=1024))


def _port_payload(data: bytes) -> bytes:
    return data_uri_to_bytes(_image_to_data_uri(*read_image(data), max_width=1024)[0])


def _wide(h, w, seed):
    return np.asarray(Image.fromarray(_page(seed)).resize((w, h)))


@pytest.mark.parametrize("kind", ["pgm16", "pfm", "ppm", "ico", "psd_cmyk", "pcx_p", "tga_la", "sgi", "sun",
                                  "qoi", "xbm", "xpm", "jpeg_arith", "jpeg_lossless"])
def test_payload_matches_the_reference(kind):
    """The q80 payload of the reference's `_image_to_data_uri` byte for
    byte, wider than 1024 (LANCZOS under Pillow's mode rules: I and F in
    their own precision, LA premultiplied) and not."""
    for w in (1030, 300):
        h = 90
        page = _wide(h, w, 1)
        if kind == "pgm16":
            data = _pnm(b"P5", w, h, 4000, (page[..., 0].astype(np.int64) * 15).astype(">u2").tobytes())
        elif kind == "pfm":
            data = _save(Image.fromarray(page[..., 1].astype(np.float32) * 1.5 - 20), "PPM")
        elif kind == "ppm":
            data = _save(Image.fromarray(page), "PPM")
        elif kind == "ico":
            data = icon([(0, 0, 24, _dib(_rows(page[:40, :w % 256 or 1, ::-1], 24) + bytes(8 * 40), w % 256 or 1,
                                         80, 24))])
        elif kind == "psd_cmyk":
            data = psd_bytes(np.asarray(Image.fromarray(page).convert("CMYK")).transpose(2, 0, 1), 4, 8, 1)
        elif kind == "pcx_p":
            data = _save(Image.fromarray(page).quantize(64), "PCX")
        elif kind == "tga_la":
            data = _save(Image.fromarray(np.stack([page[..., 0], page[..., 2]], -1), "LA"), "TGA", rle=True)
        elif kind == "sgi":
            data = _save(Image.fromarray(page), "SGI", bpc=2)
        elif kind == "sun":
            data = sun_bytes(page, w, h, 24, 2)
        elif kind == "qoi":
            data = _save(Image.fromarray(page), "QOI")
        elif kind == "xbm":
            data = _save(Image.fromarray(page[..., 0] > 128), "XBM")
        elif kind == "xpm":
            q = Image.fromarray(page).quantize(50)
            pal = np.array(q.getpalette()[:150]).reshape(50, 3)
            data = xpm_bytes(np.asarray(q), [int(r) << 16 | int(g) << 8 | int(b) for r, g, b in pal], 2)
        elif kind == "jpeg_arith":
            data = libjpeg_write(page, arith=True, quality=80, progressive=w > 1000)
        else:
            data = libjpeg_write(page[..., 0], lossless=(4, 1))
        assert_as_pillow(data)
        assert _port_payload(data) == _jax_payload(data)


# ------------------------------------------------------------- refusals


def refused_files() -> dict:
    """Files the port still refuses, each with the words of its refusal:
    name -> (bytes, words). AVIF as Pillow writes it."""
    img = Image.fromarray(_img(24, 32, 3, 7))
    base = _save(img, "JPEG", quality=80)
    at = base.index(b"\xff\xc0")
    sof3 = libjpeg_write(_img(24, 32, 1, 7), lossless=(1, 0))
    at3 = sof3.index(b"\xff\xc3")
    return {
        "jpeg12.jpg": (base[:at + 4] + bytes([12]) + base[at + 5:], "12-bit JPEG"),
        "hierarchical.jpg": (base[:at] + b"\xff\xc5" + base[at + 2:], "hierarchical JPEG"),
        "arith_lossless.jpg": (sof3[:at3] + b"\xff\xcb" + sof3[at3 + 2:], "arithmetic-coded lossless JPEG"),
        "page.avif": (_save(img, "AVIF"), "AVIF"),
        "page.dds": (_save(img.convert("RGBA"), "DDS"), "DDS"),
        "lab.psd": (psd_bytes(_img(6, 7, 3, 1).transpose(2, 0, 1), 9), "Lab"),
    }


def failing_files() -> dict:
    """JPEG 2000 files refused before (Part-1 data flagged HTJ2K, a
    malformed Part-2 MCT marker): Pillow's load fails on them, and so does
    the port's decode; neither refuses them from the headers."""
    return {"page_ht.j2k": htj2k_file(), "part2.jp2": part2_file()}


@pytest.mark.parametrize("name", sorted(failing_files()))
def test_formerly_refused_jpeg2000_fails_where_pillow_fails(name):
    data = failing_files()[name]
    check_upload("image/jp2", data)
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(ValueError):
        read_image(data, "cpu")


@pytest.mark.parametrize("name", sorted(refused_files()))
def test_still_refused_files_answer_415_before_decoding(name):
    """Refused from the headers; a 415 where Pillow opens the file, none
    where `Image.open` fails too (the reference stores no page)."""
    data, words = refused_files()[name]
    with pytest.raises(UnsupportedImage, match=f"{words}.*{ROADMAP}") as err:
        probe_image(data)
    if _pillow_opens(data):
        with pytest.raises(UnsupportedContentType, match=ROADMAP):
            check_upload("image/" + name.rsplit(".", 1)[1], data)
    else:
        assert err.value.open_fails
        check_upload("image/" + name.rsplit(".", 1)[1], data)


def _pillow_opens(data: bytes) -> bool:
    try:
        Image.open(io.BytesIO(data))
    except Exception:  # noqa: BLE001
        return False
    return True


def test_svg_heic_and_video_keep_their_415_and_broken_files_pass():
    """Video keeps its 415; SVG and HEIC bytes, which no Pillow plugin
    here identifies, pass: the reference stores no page for them and
    completes the job (`tests/test_torch_broken_images.py`)."""
    svg = b'<?xml version="1.0"?><svg xmlns="http://www.w3.org/2000/svg" width="4" height="4"></svg>'
    heic = b"\x00\x00\x00\x18ftypheic\x00\x00\x00\x00mif1heic" + bytes(32)
    with pytest.raises(UnsupportedContentType, match=ROADMAP):
        check_upload("video/mp4", b"\x00\x00\x00\x18ftypmp42")
    for ctype, data in (("image/svg+xml", svg), ("image/heic", heic)):
        check_upload(ctype, data)
        with pytest.raises(UnidentifiedImage):
            open_image(data)
    check_upload("image/x-portable-pixmap", b"P6\n4 4\n255\n" + bytes(5))   # broken: its job fails
    check_upload("image/x-icon", icon([(2, 2, 8, _dib_entry(2, 2, 8, 1))]))
    check_upload("image/png", _save(_img(3, 3, 3, 1), "QOI"))   # the bytes decide, not the type


# -------------------------------------------------------------- fixture


def _letter() -> np.ndarray:
    """A 200 dpi letter page (1700 x 2200), the timing page."""
    return np.asarray(Image.fromarray(_page(30)).resize((1700, 2200), Image.NEAREST))


def fixture_files() -> dict:
    """`chip_smoke.py` phase 22's new files: name -> bytes."""
    pages = [_page(40 + k)[::2, ::2].copy() for k in range(6)]   # 550 x 425 colour text pages
    h, w = pages[0].shape[:2]
    q = Image.fromarray(pages[2]).quantize(120)
    pal = np.array((q.getpalette() + [0] * 768)[:768]).reshape(256, 3)
    rgba = np.concatenate([pages[3], np.full((h, w, 1), 255, np.uint8)], -1)
    rgba[50:150, 40:300, 3] = 120
    files = {
        "page.ppm": _save(Image.fromarray(pages[0]), "PPM"),
        "page16.pgm": _pnm(b"P5", w, h, 65535, (pages[1][..., 1].astype(np.int64) * 257).astype(">u2").tobytes()),
        "plain.pbm": _pnm(b"P1", w, h, None, b"\n".join(b" ".join(b"%d" % v for v in row)
                                                      for row in (pages[4][..., 0] < 128).astype(int)) + b"\n"),
        "page.pfm": _save(Image.fromarray(pages[5][..., 2].astype(np.float32)), "PPM"),
        "icon.ico": _save(Image.fromarray(rgba[:256, :256]), "ICO", sizes=[(256, 256), (64, 64)]),
        "cursor.cur": icon([(0, 0, 24, _dib(_rows(pages[1][:200, :200, ::-1], 24) + bytes(200 * 28), 200, 400, 24))],
                           b"\0\0\2\0"),
        "page.psd": psd_bytes(pages[2].transpose(2, 0, 1), 3, 8, 1, layers=True),
        "cmyk.psd": psd_bytes(np.asarray(Image.fromarray(pages[3]).convert("CMYK")).transpose(2, 0, 1), 4, 8, 0),
        "page.pcx": _save(Image.fromarray(pages[4]), "PCX"),
        "indexed.pcx": _save(q, "PCX"),
        "pages.dcx": dcx_bytes([_save(Image.fromarray(pages[5]), "PCX"), _save(q, "PCX")]),
        "page.tga": _save(Image.fromarray(pages[0]), "TGA", rle=True),
        "mapped.tga": tga_bytes(np.asarray(q)[::-1].tobytes(), w, h, 1, 8,
                                cmap=pal[:120, ::-1].astype(np.uint8).tobytes(), cmap_depth=24),
        "flipped.tga": tga_bytes(rgba[:, ::-1, [2, 1, 0, 3]].tobytes(), w, h, 2, 32, flags=0x30),
        "page.sgi": sgi_rle(pages[1].transpose(2, 0, 1), 1),
        "page.ras": sun_bytes(pages[2], w, h, 24, 2),
        "page.qoi": _save(Image.fromarray(rgba), "QOI"),
        "page.xbm": _save(Image.fromarray(pages[4][..., 0] > 140), "XBM"),
        "page.xpm": xpm_bytes(np.asarray(q), [int(r) << 16 | int(g) << 8 | int(b) for r, g, b in pal[:120]], 2),
        "arith.jpg": libjpeg_write(pages[5], arith=True, quality=70),
        "arith_progressive.jpg": libjpeg_write(pages[0][:, :, 1], arith=True, progressive=True, quality=75),
        "lossless.jpg": libjpeg_write(pages[3][..., 0], lossless=(1, 0)),
        "lossless_rgb.jpg": libjpeg_write(pages[4], lossless=(7, 0), restart_rows=20),
    }
    letter = _letter()
    gray = np.ascontiguousarray(letter[..., 0])
    files.update({
        "letter.ppm": _save(Image.fromarray(letter), "PPM"),
        "letter.psd": psd_bytes(letter.transpose(2, 0, 1), 3, 8, 1),
        "letter.pcx": _save(Image.fromarray(letter), "PCX"),
        "letter.tga": _save(Image.fromarray(letter), "TGA", rle=True),
        "letter.sgi": sgi_rle(letter.transpose(2, 0, 1), 1),
        "letter.ras": sun_bytes(letter, 1700, 2200, 24, 2),
        "letter.qoi": _save(Image.fromarray(letter), "QOI"),
        "letter.xbm": _save(Image.fromarray(gray > 140), "XBM"),
        "letter.xpm": xpm_bytes((gray > 140).astype(np.int64), [0, 0xFFFFFF]),
        "letter_arith.jpg": libjpeg_write(letter, arith=True, quality=80),
        "letter_lossless.jpg": libjpeg_write(gray, lossless=(1, 0)),
        "letter_baseline.jpg": _save(Image.fromarray(letter), "JPEG", quality=80),
    })
    files.update({name: data for name, (data, _) in refused_files().items()
                  if name in ("jpeg12.jpg", "hierarchical.jpg", "page.avif")})
    files["page_ht.j2k"] = failing_files()["page_ht.j2k"]
    return files


REFUSED = ("jpeg12.jpg", "hierarchical.jpg", "page.avif")
REFUSED_WORDS = ("12-bit JPEG", "hierarchical JPEG", "AVIF")
FAILING = ("page_ht.j2k",)   # refused before; now its decode fails, as Pillow's load does
TIMED = ("letter.ppm", "letter.psd", "letter.pcx", "letter.tga", "letter.sgi", "letter.ras", "letter.qoi",
         "letter.xbm", "letter.xpm", "letter_arith.jpg", "letter_lossless.jpg", "letter_baseline.jpg")
# the letter page Pillow cannot load (its arithmetic-coded data run past 64 KiB): timed with the
# port's check off, refused otherwise
TIMED_PAST_PILLOW = ("letter_arith.jpg",)
SOURCE_PAGE = {"page.ppm": 0, "page16.pgm": 1, "plain.pbm": 4, "page.pfm": 5, "icon.ico": 3, "cursor.cur": 1,
               "page.psd": 2, "cmyk.psd": 3, "page.pcx": 4, "indexed.pcx": 2, "pages.dcx": 5, "page.tga": 0,
               "mapped.tga": 2, "flipped.tga": 3, "page.sgi": 1, "page.ras": 2, "page.qoi": 3, "page.xbm": 4,
               "page.xpm": 2, "arith.jpg": 5, "arith_progressive.jpg": 0, "lossless.jpg": 3, "lossless_rgb.jpg": 4}
# the image queries of phase 22: a file whose own page it must find first
QUERIES = ("page.ppm", "page.psd", "arith.jpg")


def write_fixture(path: Path = FIXTURE) -> Path:
    """Each file's bytes, Pillow's mode and the sha256 of its
    `convert("RGB")` pixels, the sha256 of the reference's q80 payload
    (`_image_to_data_uri`, 1024 px) and the page an ingested file was
    made from. Needs PIL and the JAX package."""
    arrays = {}
    for name, data in fixture_files().items():
        key = name.replace(".", "_")
        arrays[key] = np.frombuffer(data, np.uint8)
        if name in REFUSED or name in FAILING or name in TIMED_PAST_PILLOW:
            continue
        im = Image.open(io.BytesIO(data))
        arrays[f"{key}_mode"] = np.array(im.mode)
        arrays[f"{key}_rgb_sha256"] = np.array(hashlib.sha256(np.asarray(im.convert("RGB")).tobytes()).hexdigest())
        if name not in TIMED:
            arrays[f"{key}_payload_sha256"] = np.array(hashlib.sha256(_jax_payload(data)).hexdigest())
            arrays[f"{key}_page"] = np.array(SOURCE_PAGE[name])
    np.savez_compressed(path, **arrays)
    return Path(path)


def test_fixture_is_current(tmp_path):
    """Regenerated now, the committed fixture is equal; it names the same
    files as `chip_smoke.py` phase 22."""
    import chip_smoke

    assert chip_smoke.MORE_FORMAT_FILES == tuple(SOURCE_PAGE)
    assert chip_smoke.MORE_FORMAT_TIMED == TIMED and chip_smoke.MORE_FORMAT_QUERIES == QUERIES
    assert ((chip_smoke.MORE_FORMAT_UNOPENED, "12-bit JPEG"),) + chip_smoke.MORE_FORMAT_REFUSED == \
        tuple(zip(REFUSED, REFUSED_WORDS))
    assert chip_smoke.MORE_FORMAT_FAILING == FAILING
    assert chip_smoke.MORE_FORMAT_PAST_PILLOW == TIMED_PAST_PILLOW
    fresh = np.load(write_fixture(tmp_path / "more.npz"))
    committed = np.load(FIXTURE)
    assert sorted(fresh.files) == sorted(committed.files)
    for k in committed.files:
        assert np.array_equal(fresh[k], committed[k]), k
    assert FIXTURE.stat().st_size < 4_000_000


@pytest.mark.parametrize("name", tuple(SOURCE_PAGE) + tuple(n for n in TIMED if n not in TIMED_PAST_PILLOW))
def test_fixture_files_decode_as_the_reference(name):
    z = np.load(FIXTURE)
    key = name.replace(".", "_")
    data = z[key].tobytes()
    assert assert_as_pillow(data) == str(z[f"{key}_mode"])
    assert hashlib.sha256(decode_image(data).tobytes()).hexdigest() == str(z[f"{key}_rgb_sha256"])
    if f"{key}_payload_sha256" in z.files:
        assert hashlib.sha256(_port_payload(data)).hexdigest() == str(z[f"{key}_payload_sha256"])


def test_fixture_refused_files_answer_415():
    """Those Pillow opens answer 415; the 12-bit JPEG, which `Image.open`
    fails on, passes (the reference stores no page) and fails the port's
    first stage."""
    z = np.load(FIXTURE)
    for name, words in zip(REFUSED + TIMED_PAST_PILLOW, REFUSED_WORDS + ("arithmetic-coded JPEG whose data",)):
        data = z[name.replace(".", "_")].tobytes()
        if not _pillow_opens(data):
            assert name == "jpeg12.jpg"
            check_upload("image/jpeg", data)
            with pytest.raises(UnsupportedImage, match=f"{words}.*{ROADMAP}"):
                open_image(data)
            continue
        with pytest.raises(UnsupportedContentType, match=f"{words}.*{ROADMAP}"):
            check_upload("image/" + name.rsplit(".", 1)[1], data)
    with pytest.raises(OSError):
        _pil(z["letter_arith_jpg"].tobytes())
    for name in FAILING:   # refused before: accepted, its decode fails as Pillow's load does
        data = z[name.replace(".", "_")].tobytes()
        check_upload("image/jp2", data)
        with pytest.raises(ValueError):
            read_image(data, "cpu")


# ------------------------------------------------------- the query paths


class _Seen(Exception):
    """Raised by a spy once it has the decoded page."""


def test_query_paths_decode_the_new_formats():
    """The three paths that decode an image beside ingest take the new
    formats with no change of theirs: an image query
    (`DocumentService.retrieve_chunks`), a stored image chunk embedded
    from its bytes (`ColpaliEmbeddingModel.embed_for_ingestion_sync`) and
    the deep parse's OCR (`MorphikParser.parse_file_to_text_deep`), each
    handed the RGB pixels Pillow's `convert("RGB")` gives."""
    import asyncio

    from morphik_core_tpu_torch.embedding import colpali_embedding_model as cem
    from morphik_core_tpu_torch.models.schemas import Chunk
    from morphik_core_tpu_torch.parser.morphik_parser import MorphikParser
    from morphik_core_tpu_torch.services.document_service import DocumentService
    from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri

    z = np.load(FIXTURE)
    for name in ("page.psd", "mapped.tga", "arith.jpg"):
        data = z[name.replace(".", "_")].tobytes()
        want = np.asarray(_pil(data)[0].convert("RGB"))
        seen = []

        def spy(page, *a, **k):
            seen.append(np.asarray(page[0] if isinstance(page, list) else page))   # the OCR engine takes a list
            raise _Seen

        service = object.__new__(DocumentService)
        service.settings = type("S", (), {"morphik": type("M", (), {"enable_colpali": True})()})()
        service.colpali_vector_store = service.embedding_model = object()
        service.colpali_embedding_model = type("E", (), {"embed_for_query": staticmethod(spy)})()
        service.reranker = None
        with pytest.raises(_Seen):
            asyncio.run(service.retrieve_chunks("", None, query_image=bytes_to_data_uri(data, "image/x-any")))
        model = object.__new__(cem.ColpaliEmbeddingModel)
        model.min_pixels = model.max_pixels = 0
        model.model = type("T", (), {"device": "cpu"})()   # where a JPEG 2000's tier-1 would run
        original = cem.preprocess_array_u8
        cem.preprocess_array_u8 = spy
        try:
            with pytest.raises(_Seen):
                model.embed_for_ingestion_sync([Chunk(content=bytes_to_data_uri(data, "image/x-any"),
                                                      metadata={"is_image": True})])
        finally:
            cem.preprocess_array_u8 = original
        parser = object.__new__(MorphikParser)
        parser.ocr_engine = type("O", (), {"images_to_structured": staticmethod(spy)})()
        parser.image_device = "cpu"
        with pytest.raises(_Seen):
            asyncio.run(parser.parse_file_to_text_deep(data, name, "image/x-any"))
        assert len(seen) == 3 and all(np.array_equal(s, want) for s in seen), name
