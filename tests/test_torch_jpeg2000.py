"""JPEG 2000 page images (JP2 and raw J2K, Part 1) decoded by the port
(`morphik_core_tpu_torch/utils/jpeg2000.py`, tier-1 in the plain version
on the CPU) as Pillow 12.1 / OpenJPEG 2.5.4 hold them, on the CPU.
Tolerance: exact everywhere (mode, palette, pixels, component planes,
payload bytes).

Files come from Pillow's encoder (every option `Image.save` exposes) and
from the `libopenjp2` 2.5.4 that Pillow bundles, through ctypes
(`tests/openjp2_ref.py`), for what `save` does not expose: the six
code-block styles, SOP / EPH, POC, an RGN shift, subsampling and
precisions 1-16, signed or not. PPT and PPM files are made by moving a
file's EPH-delimited packet headers out of its bitstream. Each file's
component planes are held to `opj_decode`'s before Pillow's pixels.
The HTJ2K- and Part-2-flagged files of earlier slices fail where Pillow
fails (`tests/test_torch_htj2k.py` holds the real ones). The committed fixture
(`tests/fixtures/image_formats_jp2.npz`, `chip_smoke.py` phase 22's
JPEG 2000 files) regenerates equal.
"""

import hashlib
import io
import struct
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, example, given, settings, strategies as st
from PIL import Image

from morphik_core_tpu_torch.services.ingestion_service import (UnsupportedContentType, _image_to_data_uri,
                                                               check_upload)
from morphik_core_tpu_torch.utils import jp2_codestream as jcs
from morphik_core_tpu_torch.utils.fast_ops import data_uri_to_bytes
from morphik_core_tpu_torch.utils.image import (UnsupportedImage, decode_image, pillow_comment, probe_image,
                                                read_image, sniff)
from morphik_core_tpu_torch.utils.jp2_tier2 import tile_codeblocks
from morphik_core_tpu_torch.utils.jpeg2000 import _ycbcr_to_rgb, component_planes
from morphik_core_tpu_torch.utils.jpeg2000_t1 import decode_block, j2k_t1_decode, pack_blocks
from tests.openjp2_ref import opj_encode, opj_planes
from tests.test_torch_decoders import _page

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "image_formats_jp2.npz"
ROADMAP = "ROADMAP Queue 1 item 3b-ii"
EXAMPLES = settings(max_examples=12, deadline=None, suppress_health_check=[HealthCheck.too_slow])
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def _save(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def _pil(data: bytes):
    im = Image.open(io.BytesIO(data))
    im.load()
    return im


def assert_as_pillow(data: bytes) -> str:
    """read_image (on the CPU) == Pillow: mode, pixels, palette;
    decode_image == convert("RGB"); where Pillow fails, the port fails.
    The component planes == `opj_decode`'s. -> the mode, or None."""
    stream, header = jcs.codestream_of(data)
    ref = opj_planes(stream)
    try:
        planes = component_planes(data, "cpu")
    except (ValueError, OSError):
        planes = None
    assert (ref is None) == (planes is None)
    if ref is not None:
        assert len(ref) == len(planes) and all(np.array_equal(a, b) for a, b in zip(ref, planes))
    try:
        im = _pil(data)
    except OSError:
        with pytest.raises((ValueError, OSError)):
            read_image(data, "cpu")
        return None
    assert sniff(data) == "JPEG2000" == im.format
    px, mode, palette = read_image(data, "cpu")
    want = np.asarray(im)
    assert mode == im.mode and px.dtype == want.dtype and px.shape == want.shape
    assert np.array_equal(px, want)
    if im.mode in ("P", "PA"):
        pal = np.array(im.getpalette(), np.uint8).reshape(-1, 3)
        assert np.array_equal(palette[:len(pal)], pal) and not palette[len(pal):].any()
    else:
        assert palette is None
    assert np.array_equal(decode_image(data, "cpu"), np.asarray(im.convert("RGB")))
    return mode


def _smooth(rng, h, w, c, lo=0, hi=255):
    """Random samples with some spatial structure (so every pass codes)."""
    a = rng.integers(lo, hi + 1, (h, w, c))
    if rng.random() < 0.5:
        a = np.clip(np.cumsum(a, 1) // (np.arange(w)[None, :, None] + 1), lo, hi)
    return a


# ------------------------------------------------------------ Pillow's save


@st.composite
def pillow_files(draw):
    seed = draw(st.integers(0, 10 ** 6))
    rng = np.random.default_rng(seed)
    h, w = draw(st.integers(1, 48)), draw(st.integers(1, 48))
    mode = draw(st.sampled_from(["L", "LA", "RGB", "RGBA", "I;16"]))
    if mode == "I;16":
        img = Image.frombytes("I;16", (w, h), _smooth(rng, h, w, 1, 0, 65535).astype("<u2").tobytes())
    else:
        img = Image.fromarray(_smooth(rng, h, w, 4).astype(np.uint8), "RGBA").convert(mode)
    kw = {"num_resolutions": draw(st.integers(1, 6)), "progression": draw(st.sampled_from(PROGRESSIONS)),
          "irreversible": draw(st.booleans()), "no_jp2": draw(st.booleans()), "plt": draw(st.booleans())}
    layers = draw(st.sampled_from([None, "rates", "dB"]))
    if layers == "rates":
        kw.update(quality_mode="rates", quality_layers=draw(st.sampled_from([[20], [40, 10], [60, 20, 5]])))
    elif layers == "dB":
        kw.update(quality_mode="dB", quality_layers=draw(st.sampled_from([[30], [25, 45]])))
    if draw(st.booleans()):
        kw["codeblock_size"] = (2 ** draw(st.integers(2, 6)), 2 ** draw(st.integers(2, 6)))
    if draw(st.booleans()):
        kw["precinct_size"] = (2 ** draw(st.integers(2, 7)), 2 ** draw(st.integers(2, 7)))
    # Pillow's 9/7 encoder aborts on a tile-component level of one sample (libopenjp2's
    # `dn + sn > 1` assertion), which offsets and tiles make; and on offsets past the image
    ox, oy = draw(st.integers(0, min(8, w - 1))), draw(st.integers(0, min(8, h - 1)))
    if kw["irreversible"]:
        ox = oy = 0
    if ox or oy:
        kw["offset"] = (ox, oy)
    if not kw["irreversible"] and draw(st.booleans()):
        kw["tile_size"] = (draw(st.integers(8, 40)), draw(st.integers(8, 40)))
        kw["tile_offset"] = (draw(st.integers(0, ox)), draw(st.integers(0, oy)))
    if mode in ("RGB", "RGBA"):
        kw["mct"] = draw(st.sampled_from([0, 1]))
    if mode != "I;16" and draw(st.integers(0, 4)) == 0:
        kw["signed"] = True
    return img, kw


def _pillow_case(case):
    img, kw = case
    try:
        data = _save(img, **kw)
    except (ValueError, OSError):
        return   # a combination Pillow's encoder refuses
    assert_as_pillow(data)


def _rgb(h, w, seed, mode="RGB"):
    return Image.fromarray(_smooth(np.random.default_rng(seed), h, w, 4).astype(np.uint8), "RGBA").convert(mode)


@EXAMPLES
@given(pillow_files())
@example((_rgb(33, 47, 1), {"irreversible": True, "quality_mode": "rates", "quality_layers": [40, 20, 10]}))
@example((_rgb(40, 31, 2), {"progression": "RPCL", "precinct_size": (16, 16), "codeblock_size": (8, 8)}))
@example((_rgb(29, 44, 3, "RGBA"), {"tile_size": (16, 20), "tile_offset": (2, 3), "offset": (5, 4),
                                    "progression": "PCRL", "mct": 1}))
@example((_rgb(17, 23, 4, "LA"), {"progression": "CPRL", "no_jp2": True, "plt": True, "signed": True}))
@example((_rgb(24, 24, 5, "L"), {"progression": "RLCP", "quality_mode": "dB", "quality_layers": [25, 45]}))
@example((Image.frombytes("I;16", (13, 9), np.arange(117, dtype="<u2").tobytes() * 500), {"irreversible": True}))
@example((_rgb(1, 1, 6), {"num_resolutions": 1}))
@example((_rgb(2, 37, 7), {"num_resolutions": 6, "irreversible": True}))
def test_pillow_written_files_decode_as_pillow(case):
    _pillow_case(case)


# ------------------------------------------------------ libopenjp2's encoder


@st.composite
def openjpeg_files(draw):
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
    kw = dict(numres=draw(st.integers(1, 5)), mode=draw(st.integers(0, 63)), csty=draw(st.sampled_from([0, 2, 4, 6])),
              prog=draw(st.integers(0, 4)), cblk=(2 ** draw(st.integers(2, 6)), 2 ** draw(st.integers(2, 6))))
    if kw["cblk"][0] * kw["cblk"][1] > 4096:
        kw["cblk"] = (64, 64)
    if draw(st.booleans()):
        kw["layers"] = draw(st.sampled_from([[30, 8], [30, 15, 4]]))
    if n >= 3 and sub == (1, 1) and prec >= 2:
        kw["mct"] = draw(st.sampled_from([0, 1]))
    if draw(st.booleans()):
        kw["roi"] = (draw(st.integers(0, n - 1)), draw(st.integers(1, 12)))
    if draw(st.booleans()):   # POC (without EPH: OpenJPEG's encoder drops EPH markers under POC)
        nl = len(kw.get("layers", [0]))
        kw["pocs"] = [(0, 0, nl, 1, n, draw(st.integers(0, 4))), (0, 0, nl, kw["numres"], n, draw(st.integers(0, 4)))]
        kw["csty"] &= 2
    if draw(st.booleans()):
        p = (2 ** draw(st.integers(1, 7)), 2 ** draw(st.integers(1, 7)))
        kw["precincts"] = [p, p]
    if sub == (1, 1) and draw(st.booleans()):
        kw["tiles"] = (draw(st.integers(8, 40)), draw(st.integers(8, 40)))
    mind = min(min(p.shape) for p in planes)
    # OpenJPEG's 9/7 encoder asserts on a resolution of one sample
    kw["irreversible"] = draw(st.booleans()) and "tiles" not in kw and mind >= 2 ** kw["numres"]
    jp2 = draw(st.booleans())
    return planes, [prec] * n, [sgnd] * n, [(1, 1)] + [sub] * (n - 1), jp2, kw


def _openjpeg_case(case):
    planes, prec, sgnd, sub, jp2, kw = case
    try:
        data = opj_encode(planes, prec, sgnd, sub, jp2=jp2, **kw)
    except AssertionError:
        return   # a combination libopenjp2's encoder refuses
    assert_as_pillow(data)


def _planes(n, h, w, prec=8, seed=0, sub=(1, 1), sgnd=False):
    rng = np.random.default_rng(seed)
    lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sgnd else (0, (1 << prec) - 1)
    out = []
    for c in range(n):
        dx, dy = (1, 1) if c == 0 else sub
        out.append(_smooth(rng, -(-h // dy), -(-w // dx), 1, lo, hi)[..., 0].astype(np.int32))
    return out


def _oj(n, h, w, prec=8, sgnd=False, sub=(1, 1), jp2=False, seed=0, **kw):
    return (_planes(n, h, w, prec, seed, sub, sgnd), [prec] * n, [sgnd] * n, [(1, 1)] + [sub] * (n - 1), jp2, kw)


@EXAMPLES
@given(openjpeg_files())
@example(_oj(3, 37, 29, mode=0x01, numres=4, layers=[30, 15, 4]))            # BYPASS
@example(_oj(1, 33, 40, mode=0x02, numres=3))                                 # RESET
@example(_oj(3, 20, 30, mode=0x04, numres=2, mct=1))                          # TERMALL
@example(_oj(1, 41, 27, mode=0x08, numres=3, cblk=(16, 16)))                  # VSC
@example(_oj(1, 25, 25, mode=0x10, numres=2))                                 # PTERM
@example(_oj(3, 30, 22, mode=0x20, numres=3, mct=1, irreversible=True))       # SEGSYM
@example(_oj(3, 32, 32, mode=0x3F, numres=4, csty=6, layers=[30, 8], roi=(0, 7)))
@example(_oj(3, 30, 30, mode=0, numres=3, csty=2, layers=[30, 8], pocs=[(0, 0, 2, 1, 3, 1), (0, 0, 2, 3, 3, 4)]))
@example(_oj(3, 26, 35, sub=(2, 2), numres=3))                                # subsampled: Pillow's sYCC
@example(_oj(3, 26, 35, sub=(2, 1), jp2=True, numres=2))
@example(_oj(1, 19, 21, prec=1, numres=2))
@example(_oj(1, 19, 21, prec=12, sgnd=True, numres=3, irreversible=True))
@example(_oj(1, 19, 21, prec=16, numres=3))
@example(_oj(2, 17, 30, prec=5, sgnd=True, numres=2))
@example(_oj(4, 20, 20, prec=10, numres=3, tiles=(9, 12), precincts=[(4, 4), (8, 8)]))
def test_openjpeg_written_files_decode_as_opj_and_pillow(case):
    _openjpeg_case(case)


# ------------------------------------------------------------ PPT and PPM


def _markers(stream: bytes):
    """(marker, start, end) of the main header's segments, then the SOT."""
    pos = 2
    out = []
    while True:
        m, ln = struct.unpack(">HH", stream[pos:pos + 4])
        out.append((m, pos, pos + 2 + ln))
        if m == 0xFF90:
            return out
        pos += 2 + ln


def _with_packed_headers(stream: bytes, where: str) -> bytes:
    """One tile, one tile-part: its packet headers (EPH included) moved
    out of the bitstream into a PPT (tile-part header) or a PPM (main
    header), split over two marker segments."""
    cs = jcs.parse(stream)
    assert cs.tw * cs.th == 1 and len(cs.tcps[0].data) == 1
    spans = []
    tile_codeblocks(cs, 0, spans=spans)
    body = cs.tcps[0].data[0]
    headers = b"".join(body[a:b] for a, b in spans)
    keep, at = [], 0
    for a, b in spans:
        keep.append(body[at:a])
        at = b
    data = b"".join(keep) + body[at:]
    sot_at = _markers(stream)[-1][1]
    main = stream[:sot_at]
    half = len(headers) // 2
    if where == "ppt":
        segs = b"".join(b"\xff\x61" + struct.pack(">HB", 3 + len(p), z) + p
                        for z, p in enumerate((headers[:half], headers[half:])))
        main_extra = b""
    else:
        stream_bytes = struct.pack(">I", len(headers)) + headers
        h2 = len(stream_bytes) // 2
        main_extra = b"".join(b"\xff\x60" + struct.pack(">HB", 3 + len(p), z) + p
                              for z, p in enumerate((stream_bytes[:h2], stream_bytes[h2:])))
        segs = b""
    isot, _, tpsot, tnsot = struct.unpack(">HIBB", stream[sot_at + 4:sot_at + 12])
    tile = segs + b"\xff\x93" + data
    sot = b"\xff\x90\x00\x0a" + struct.pack(">HIBB", isot, 12 + len(tile), tpsot, tnsot)
    return main + main_extra + sot + tile + b"\xff\xd9"


@pytest.mark.parametrize("where", ["ppt", "ppm"])
@pytest.mark.parametrize("kw", [dict(numres=3, layers=[30, 8], prog=0), dict(numres=4, prog=2, mode=0x3F, mct=1),
                                dict(numres=2, layers=[30, 15, 4], prog=4, precincts=[(8, 8), (16, 16)])])
def test_packed_packet_headers_decode_as_opj_and_pillow(where, kw):
    plain = opj_encode(_planes(3, 30, 37, seed=3), [8] * 3, csty=4, **kw)
    packed = _with_packed_headers(plain, where)
    assert len(packed) > len(plain) and (b"\xff\x61" if where == "ppt" else b"\xff\x60") in packed
    assert assert_as_pillow(packed) == "RGB"
    assert all(np.array_equal(a, b) for a, b in zip(component_planes(packed, "cpu"), component_planes(plain, "cpu")))


# --------------------------------------------------------- tier-1 alone


def _one_block(w, h, mode=0, prec=8, seed=0):
    """A one-block, one-resolution lossless file: its tier-1 values are
    twice the shifted samples."""
    plane = _planes(1, h, w, prec, seed)[0]
    data = opj_encode([plane], [prec], numres=1, mode=mode, cblk=(64, 64))
    cs = jcs.parse(data)
    (tc,) = tile_codeblocks(cs, 0)
    (cb,) = tc.resolutions[0].bands[0].precincts[0].blocks
    return plane, cb, cs.tcps[0].tccps[0]


@pytest.mark.parametrize("w,h,mode", [(1, 1, 0), (7, 5, 0), (64, 64, 0), (64, 64, 0x3F), (33, 9, 0x01),
                                      (13, 21, 0x08), (40, 40, 0x04)])
def test_plain_tier1_on_single_blocks(w, h, mode):
    plane, cb, tccp = _one_block(w, h, mode, seed=w * h)
    segs = [(s[0], s[1]) for s in cb.segs]
    blob = b"".join(cb.chunks)
    vals = np.array(decode_block(blob, 0, segs, w, h, 0, cb.numbps, 0, tccp.cblksty)).reshape(h, w)
    assert np.array_equal(np.trunc(vals / 2).astype(np.int64), plane.astype(np.int64) - 128)
    # the same blocks through the launch layout, on the CPU
    packed = pack_blocks([(cb.chunks, segs, w, h, 0, cb.numbps, 0, tccp.cblksty, 0, w)])
    assert np.array_equal(j2k_t1_decode(packed, w * h, "cpu").numpy().reshape(h, w), vals)


def test_plain_tier1_edge_blocks():
    # passes over an empty segment still run the MQ decoder on 0xFF 0xFF
    assert decode_block(b"", 0, [(0, 1)], 4, 4, 0, 3, 0, 0) == decode_block(b"\xff\xff", 0, [(0, 1)], 4, 4, 0, 3, 0, 0)
    assert decode_block(b"", 0, [], 4, 4, 0, 3, 0, 0) == [0] * 16
    with pytest.raises(ValueError, match="31"):   # OpenJPEG refuses 31 bit planes and more
        decode_block(b"\x00", 0, [(1, 1)], 2, 2, 0, 20, 11, 0)


# -------------------------------------------------------- colour and modes


def _box(t: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + t + payload


def with_jp2_boxes(data: bytes, extra: bytes = b"", enumcs=None) -> bytes:
    """A JP2 with `extra` boxes after its colr box, and its colr
    enumeration set to `enumcs`."""
    out = bytearray(data[:12])
    for t, s, e in jcs._boxes(data, 12, len(data)):
        if t != b"jp2h":
            out += data[s - 8:e]
            continue
        inner = b""
        for t2, s2, e2 in jcs._boxes(data, s, e):
            p = data[s2:e2]
            if t2 == b"colr" and enumcs is not None:
                p = p[:3] + struct.pack(">I", enumcs)
            inner += _box(t2, p) + (extra if t2 == b"colr" else b"")
        out += _box(b"jp2h", inner)
    return bytes(out)


def palette_jp2(indices: np.ndarray, palette: np.ndarray, alpha: np.ndarray = None) -> bytes:
    """A P (or PA) JP2: the indices (and alpha) saved by Pillow, a pclr of
    `palette` (NE x 3 or 4, 8 bits) and its cmap."""
    img = Image.fromarray(indices.astype(np.uint8)) if alpha is None else \
        Image.fromarray(np.stack([indices, alpha], -1).astype(np.uint8), "LA")
    ne, npc = palette.shape
    pclr = _box(b"pclr", struct.pack(">HB", ne, npc) + bytes([7] * npc) + palette.astype(np.uint8).tobytes())
    cmap = _box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, k) for k in range(npc)))
    return with_jp2_boxes(_save(img), pclr + cmap, enumcs=16)


@pytest.mark.parametrize("enumcs", [0, 12, 14, 16, 17, 18, 20, 24, 99])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_colour_specifications_pick_pillows_unpacker(mode, enumcs):
    data = with_jp2_boxes(_save(_rgb(9, 11, enumcs, mode)), enumcs=enumcs)
    assert_as_pillow(data)


@pytest.mark.parametrize("npc", [3, 4])
@pytest.mark.parametrize("alpha", [False, True])
def test_palette_files_open_as_p_and_pa(npc, alpha):
    rng = np.random.default_rng(npc)
    idx = rng.integers(0, 6, (9, 13))
    pal = rng.integers(0, 256, (7, npc))
    pal[4] = pal[2]   # Pillow's palette keeps a repeated colour once
    data = palette_jp2(idx, pal, rng.integers(0, 256, (9, 13)) if alpha else None)
    assert assert_as_pillow(data) == ("PA" if alpha else "P")
    assert assert_as_pillow(with_jp2_boxes(data, enumcs=17)) is None   # gray indices: Pillow's unpacker fails


def test_ycbcr_tables_are_pillows():
    v = np.arange(256)
    cb, cr = np.meshgrid(v, v, indexing="ij")
    for y in (0, 1, 37, 128, 200, 254, 255):
        ycc = np.stack([np.full_like(cb, y), cb, cr], -1).astype(np.uint8)
        assert np.array_equal(_ycbcr_to_rgb(ycc), np.asarray(Image.fromarray(ycc, "YCbCr").convert("RGB"))), y


# ------------------------------------------------------------- payloads


def _jax_payload(data: bytes) -> bytes:
    from morphik_core_tpu.services.ingestion_service import _image_to_data_uri as j_image_to_data_uri

    return data_uri_to_bytes(j_image_to_data_uri(Image.open(io.BytesIO(data)), max_width=1024))


def _port_payload(data: bytes) -> bytes:
    return data_uri_to_bytes(_image_to_data_uri(*read_image(data, "cpu"), max_width=1024,
                                                comment=pillow_comment(data))[0])


def _wide(h, w, seed):
    return np.asarray(Image.fromarray(_page(seed)).resize((w, h)))


def payload_files() -> dict:
    """One small file of each mode, 1030 px wide where a resize is
    Pillow's (LANCZOS in the mode's own rules)."""
    wide = _wide(12, 1030, 3)
    rng = np.random.default_rng(0)
    return {
        "rgb": _save(Image.fromarray(wide), irreversible=True),
        "l": _save(Image.fromarray(wide[..., 1])),
        "la": _save(Image.fromarray(np.stack([wide[..., 0], wide[..., 2]], -1), "LA")),
        "rgba": _save(Image.fromarray(np.concatenate([wide, wide[..., :1]], -1), "RGBA")),
        "i16": _save(Image.frombytes("I;16", (1030, 12), (wide[..., 1].astype("<u2") * 257).tobytes())),
        "cmyk": with_jp2_boxes(_save(Image.fromarray(np.concatenate([wide, wide[..., 1:2]], -1), "RGBA")),
                               enumcs=12),
        "p": palette_jp2(rng.integers(0, 5, (12, 1030)), rng.integers(0, 256, (5, 3))),
        "pa": palette_jp2(rng.integers(0, 5, (9, 1030)), rng.integers(0, 256, (5, 3)),
                          rng.integers(0, 256, (9, 1030))),
        "ycc": opj_encode(_planes(3, 20, 1030, seed=4, sub=(2, 2)), [8] * 3, dxdy=[(1, 1), (2, 2), (2, 2)],
                          numres=3),
    }


@pytest.mark.parametrize("kind", sorted(payload_files()))
def test_payload_matches_the_reference(kind):
    data = payload_files()[kind]
    assert _port_payload(data) == _jax_payload(data)


# ------------------------------------------------ truncated and refused


@pytest.mark.parametrize("no_jp2", [False, True])
def test_truncated_files_fail_where_pillow_fails(no_jp2):
    data = _save(_rgb(20, 24, 8), quality_mode="rates", quality_layers=[20, 10, 5], no_jp2=no_jp2)
    for cut in sorted({len(data) - 1, len(data) - 2, len(data) - 3, len(data) - 40, len(data) // 2, 150, 90}):
        assert_as_pillow(data[:cut])


def test_zero_psot_runs_to_the_end():
    data = _save(_rgb(16, 18, 9), no_jp2=True)
    at = data.index(b"\xff\x90")
    zero = data[:at + 6] + b"\0\0\0\0" + data[at + 10:]
    assert assert_as_pillow(zero) == "RGB"
    assert np.array_equal(read_image(zero, "cpu")[0], read_image(data, "cpu")[0])


def htj2k_file() -> bytes:
    """A raw codestream flagged HTJ2K (Part 15): SIZ Rsiz bit 14, a CAP
    marker and COD code-block style 0x40."""
    data = bytearray(_save(_rgb(24, 32, 7), no_jp2=True))
    data[6:8] = struct.pack(">H", struct.unpack(">H", data[6:8])[0] | 0x4000)
    cod = data.index(b"\xff\x52")
    data[cod + 12] |= 0x40
    siz_end = 4 + struct.unpack(">H", data[4:6])[0]
    cap = b"\xff\x50" + struct.pack(">HIH", 8, 0x00020000, 0)
    return bytes(data[:siz_end] + cap + data[siz_end:])


def part2_file() -> bytes:
    """A JP2 whose codestream says Part 2 (SIZ Rsiz bit 15) and carries an
    MCT marker."""
    data = bytearray(_save(_rgb(24, 32, 7)))
    at = data.index(b"\xff\x4f\xff\x51")
    data[at + 6:at + 8] = struct.pack(">H", 0x8000)
    siz_end = at + 4 + struct.unpack(">H", data[at + 4:at + 6])[0]
    mct = b"\xff\x74" + struct.pack(">HHH", 6, 0, 0)
    return bytes(data[:siz_end] + mct + data[siz_end:])


@pytest.mark.parametrize("name,words", [("page_ht.j2k", "HTJ2K"), ("part2.jp2", "Part-2")])
def test_htj2k_and_part2_are_refused_by_name(name, words):
    """Part-1 data flagged HTJ2K (its blocks read as HT) or Part 2 with a
    malformed MCT marker: no longer refused (no 415), they fail where
    Pillow fails, as the truncated files do."""
    data = htj2k_file() if name == "page_ht.j2k" else part2_file()
    assert assert_as_pillow(data) is None
    probe_image(data)
    check_upload("image/jp2", data)


def test_a_jpeg2000_decode_runs_on_the_card_unless_asked():
    data = _save(_rgb(8, 8, 1))
    assert read_image(data, "cpu")[1] == "RGB"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card (tests/test_torch_cuda.py)")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        read_image(data)
    probe_image(data)   # the headers need no device


# --------------------------------------------------------------- fixture


def _pages():
    return [_page(60 + k)[::2, ::2].copy() for k in range(6)]   # 550 x 425 colour text pages of their own


def _letter() -> np.ndarray:
    """A 200 dpi letter page (1700 x 2200), the timing page."""
    return np.asarray(Image.fromarray(_page(30)).resize((1700, 2200), Image.NEAREST))


def fixture_files() -> dict:
    """`chip_smoke.py` phase 22's JPEG 2000 files: name -> bytes."""
    pages = _pages()
    h, w = pages[0].shape[:2]
    q = Image.fromarray(pages[1]).quantize(120)
    pal = np.array(q.getpalette()[:360]).reshape(120, 3)
    rgba = np.concatenate([pages[4], np.full((h, w, 1), 255, np.uint8)], -1)
    rgba[50:150, 40:300, 3] = 120
    ycc = np.asarray(Image.fromarray(pages[5]).convert("YCbCr")).astype(np.int32)
    letter = _letter()
    return {
        "page.jp2": _save(Image.fromarray(pages[0]), irreversible=True, quality_mode="rates",
                          quality_layers=[40, 20, 10]),
        "page.j2k": _save(Image.fromarray(pages[1]), no_jp2=True),
        "tiled.jp2": opj_encode([pages[2][..., k].astype(np.int32) for k in range(3)], [8] * 3, jp2=True,
                                color_space=1, mct=1, numres=4, tiles=(160, 128), tile_offset=(3, 2),
                                offset=(7, 5), precincts=[(64, 64), (32, 32)], prog=2, csty=6, layers=[30, 10]),
        # one layer: under POC, libopenjp2 writes TERMALL files with several layers it cannot read back
        "styles.j2k": opj_encode([pages[3][..., k].astype(np.int32) for k in range(3)], [8] * 3, mct=1,
                                 numres=5, mode=0x3F, cblk=(32, 32), roi=(0, 6),
                                 pocs=[(0, 0, 1, 2, 3, 1), (0, 0, 1, 5, 3, 4)]),
        "gray16.jp2": _save(Image.frombytes("I;16", (w, h), (pages[4][..., 1].astype("<u2") * 257).tobytes())),
        "ycc.j2k": opj_encode([ycc[..., 0], ycc[::2, ::2, 1], ycc[::2, ::2, 2]], [8] * 3,
                              dxdy=[(1, 1), (2, 2), (2, 2)], numres=4, irreversible=True),
        "palette.jp2": palette_jp2(np.asarray(q), pal),
        "rgba.jp2": _save(Image.fromarray(rgba, "RGBA")),
        "letter.jp2": _save(Image.fromarray(letter)),
        "letter_97.jp2": _save(Image.fromarray(letter), irreversible=True, quality_mode="rates",
                               quality_layers=[20]),
        "page_ht.j2k": htj2k_file(),
        "part2.jp2": part2_file(),
    }


SOURCE_PAGE = {"page.jp2": 0, "page.j2k": 1, "tiled.jp2": 2, "styles.j2k": 3, "gray16.jp2": 4, "ycc.j2k": 5,
               "palette.jp2": 1, "rgba.jp2": 4}
TIMED = ("letter.jp2", "letter_97.jp2")
REFUSED = (("page_ht.j2k", "HTJ2K"), ("part2.jp2", "Part-2"))
QUERIES = ("page.jp2",)


def write_fixture(path: Path = FIXTURE) -> Path:
    """Each file's bytes, Pillow's mode, the sha256 of its pixels and of
    their `convert("RGB")`, the sha256 of the reference's q80 payload
    (`_image_to_data_uri`, 1024 px) and the page an ingested file was made
    from. Needs PIL and the JAX package."""
    arrays = {}
    refused = dict(REFUSED)
    for name, data in fixture_files().items():
        key = name.replace(".", "_")
        arrays[key] = np.frombuffer(data, np.uint8)
        if name in refused:
            continue
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
    files as `chip_smoke.py` phase 22."""
    import chip_smoke

    assert chip_smoke.JP2_FILES == tuple(SOURCE_PAGE) and chip_smoke.JP2_TIMED == TIMED
    assert chip_smoke.JP2_REFUSED == REFUSED and chip_smoke.JP2_QUERIES == QUERIES
    fresh = np.load(write_fixture(tmp_path / "jp2.npz"))
    committed = np.load(FIXTURE)
    assert sorted(fresh.files) == sorted(committed.files)
    for k in committed.files:
        assert np.array_equal(fresh[k], committed[k]), k
    assert FIXTURE.stat().st_size < 4_000_000


@pytest.mark.parametrize("name", ["styles.j2k", "ycc.j2k", "palette.jp2"])
def test_fixture_files_decode_as_the_reference(name):
    """The code-block styles, subsampled chroma and palette files of the
    fixture, at their 550 x 425, on the CPU (the others decode on the card
    in `chip_smoke.py`)."""
    z = np.load(FIXTURE)
    key = name.replace(".", "_")
    data = z[key].tobytes()
    px, mode, palette = read_image(data, "cpu")
    assert mode == str(z[f"{key}_mode"])
    assert hashlib.sha256(px.tobytes()).hexdigest() == str(z[f"{key}_sha256"])
    from morphik_core_tpu_torch.models.colqwen.preprocess import to_rgb_u8

    assert hashlib.sha256(to_rgb_u8(px, mode, palette).tobytes()).hexdigest() == str(z[f"{key}_rgb_sha256"])


def test_fixture_refused_files_answer_415():
    """The fixture's formerly refused files now pass the upload check and
    fail in the decode, as in Pillow (`chip_smoke.py` phase 22: their jobs
    fail)."""
    z = np.load(FIXTURE)
    for name, words in REFUSED:
        data = z[name.replace(".", "_")].tobytes()
        check_upload("image/jp2", data)
        with pytest.raises(ValueError):
            read_image(data, "cpu")
        with pytest.raises(OSError):
            _pil(data)


class _Seen(Exception):
    """Raised by a spy once it has the decoded page."""


def test_query_paths_decode_jpeg2000_on_the_model_device():
    """The paths that decode an image beside ingest hand Pillow's RGB
    pixels of a JP2 on to the tower: an image query (its tier-1 on the
    ColPali model's device), a stored image chunk embedded from its
    bytes and the deep parse's OCR (on the services' device)."""
    import asyncio

    from morphik_core_tpu_torch.embedding import colpali_embedding_model as cem
    from morphik_core_tpu_torch.models.schemas import Chunk
    from morphik_core_tpu_torch.parser.morphik_parser import MorphikParser
    from morphik_core_tpu_torch.services.document_service import DocumentService
    from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri

    data = _save(_rgb(21, 26, 11), irreversible=True)
    want = np.asarray(_pil(data).convert("RGB"))
    seen = []

    def spy(page, *a, **k):
        seen.append(np.asarray(page[0] if isinstance(page, list) else page))
        raise _Seen

    service = object.__new__(DocumentService)
    service.settings = type("S", (), {"morphik": type("M", (), {"enable_colpali": True})()})()
    service.colpali_vector_store = service.embedding_model = object()
    service.colpali_embedding_model = type("E", (), {"embed_for_query": staticmethod(spy), "device": "cpu"})()
    service.reranker = None
    with pytest.raises(_Seen):
        asyncio.run(service.retrieve_chunks("", None, query_image=bytes_to_data_uri(data, "image/jp2")))
    model = object.__new__(cem.ColpaliEmbeddingModel)
    model.min_pixels = model.max_pixels = 0
    model.model = type("T", (), {"device": torch.device("cpu")})()
    original = cem.preprocess_array_u8
    cem.preprocess_array_u8 = spy
    try:
        with pytest.raises(_Seen):
            model.embed_for_ingestion_sync([Chunk(content=bytes_to_data_uri(data, "image/jp2"),
                                                  metadata={"is_image": True})])
    finally:
        cem.preprocess_array_u8 = original
    parser = object.__new__(MorphikParser)
    parser.ocr_engine = type("O", (), {"images_to_structured": staticmethod(spy)})()
    parser.image_device = "cpu"
    with pytest.raises(_Seen):
        asyncio.run(parser.parse_file_to_text_deep(data, "page.jp2", "image/jp2"))
    assert len(seen) == 3 and all(np.array_equal(s, want) for s in seen)


@pytest.mark.parametrize("fmt", ["JPEG", "GIF", "GIF2", "JPEG2000", "PNG"])
def test_an_uploads_comment_reaches_the_payload_as_the_reference(fmt):
    """Pillow keeps a JPEG's COM, a GIF's comment extensions and a JPEG
    2000's COM in `info["comment"]`, and its JPEG writer puts that in the
    page payload: so does the port."""
    img = _rgb(30, 40, 12)
    if fmt == "GIF2":   # two comment extensions: joined by a newline
        data = bytearray(_save_as(img, "GIF", comment=b"first"))
        at = data.index(b"\x21\xfe")
        data[at:at] = b"\x21\xfe\x03two\x00"
        data = bytes(data)
    elif fmt == "JPEG2000":
        data = _save(img)
    else:
        data = _save_as(img, fmt, **({} if fmt == "PNG" else {"comment": b"a page, scanned"}))
    assert pillow_comment(data) == _pil(data).info.get("comment", b"")
    assert _port_payload(data) == _jax_payload(data)


def _save_as(img, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()
