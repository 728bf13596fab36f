"""The page images the reference opens through Pillow beyond PNG and
JPEG: GIF, BMP, TIFF and WebP, and CMYK / YCCK JPEGs, decoded by the
port's own decoders (`morphik_core_tpu_torch/utils/`) as Pillow 12.1
(libtiff 4.7, libwebp 1.6, libjpeg-turbo) holds them after
`Image.open(...).load()`, on the CPU. Tolerance: exact everywhere (modes,
palettes, uint8 / uint16 pixels, payload bytes).

Files Pillow cannot write are written here: BMPs (every header, depth,
bitfields layout, RLE8 / RLE4 with their escapes), GIFs (interlaced,
offset and enlarging first frames, local tables, an LZW encoder),
TIFFs (byte orders, strips and tiles, every compression the port reads
through the encoders written here or Pillow's own strips, FillOrder 2,
predictor 2, photometrics, 1-16 bits, alpha, ColorMap, orientation),
WebPs (ALPH chunks raw and filtered, animations of Pillow-encoded
frames, and lossy frames re-encoded here with the simple loop filter,
sharpness, loop-filter deltas, relative segment quantizers and several
token partitions, through a recording of the port's boolean decoder and
an RFC 6386 boolean encoder). Every refused variant raises
`UnsupportedImage` from `probe_image` before decoding, decompression
bombs too. The committed fixture (`tests/fixtures/image_formats.npz`,
`chip_smoke.py` phase 22's files and hashes) regenerates byte for byte.
"""

import hashlib
import io
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, example, given, settings, strategies as st
from PIL import Image, TiffImagePlugin

from morphik_core_tpu_torch.models.colqwen.preprocess import resize_mode_u8, to_rgb_u8
from morphik_core_tpu_torch.services.ingestion_service import _image_to_data_uri, check_upload, \
    UnsupportedContentType
from morphik_core_tpu_torch.utils import vp8 as tvp8
from morphik_core_tpu_torch.utils.fast_ops import data_uri_to_bytes
from morphik_core_tpu_torch.utils.image import (
    DecompressionBombError,
    UnidentifiedImage,
    UnsupportedImage,
    UnsupportedJpeg,
    decode_image,
    open_image,
    probe_image,
    read_image,
)
from morphik_core_tpu_torch.utils.lzw import decode_gif_lzw, decode_tiff_lzw
from tests.test_torch_decoders import _page

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "image_formats.npz"
ROADMAP = "ROADMAP Queue 1 item 3b-ii"
EXAMPLES = settings(max_examples=12, deadline=None, suppress_health_check=[HealthCheck.too_slow])


# ------------------------------------------------------------ comparison


def _pil(data: bytes):
    im = Image.open(io.BytesIO(data))
    im.load()
    px = np.asarray(im)
    if im.mode == "1":
        px = px.astype(np.uint8) * 255
    if im.mode == "I;16B":
        px = px.astype(np.uint16)
    pal = im.getpalette() if im.mode == "P" else None
    return im, px, pal


def assert_as_pillow(data: bytes) -> str:
    """read_image == Pillow: mode, pixels, palette; decode_image ==
    convert("RGB"). -> the mode."""
    im, want, pal = _pil(data)
    px, mode, palette = read_image(data)
    assert mode == im.mode
    assert px.dtype == want.dtype and px.shape == want.shape
    assert np.array_equal(px, want)
    if pal is not None:
        n = len(pal) // 3
        assert np.array_equal(palette[:n], np.array(pal, np.uint8).reshape(n, 3))
        assert not palette[n:].any()
    else:
        assert palette is None
    assert np.array_equal(decode_image(data), np.asarray(im.convert("RGB")))
    return mode


def _rng_image(h, w, c, seed, smooth=True):
    rng = np.random.default_rng(seed)
    if not smooth:
        return rng.integers(0, 256, (h, w, c)).astype(np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * (3 + k) + y * (2 + k) + 60 * k) % 256 for k in range(c)], -1)
    return np.clip(base + rng.integers(-25, 25, base.shape), 0, 255).astype(np.uint8)


def _off_grid(n: int) -> int:
    return n - 1 if n > 1 and n % 8 == 0 else n


# ------------------------------------------------------------ LZW writers


def lzw_encode(data: bytes, min_size: int, tiff: bool, defer: bool = False) -> bytes:
    """GIF (LSB first) or TIFF (MSB first, early change) LZW, a clear code
    first and whenever the table fills, or (GIF, `defer`) never again: a
    full table is kept and later codes add no entry."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    early = 1 if tiff else 0
    out, acc, nacc = bytearray(), 0, 0
    width = min_size + 1

    def put(code):
        nonlocal acc, nacc
        if tiff:
            acc = (acc << width) | code
            nacc += width
            while nacc >= 8:
                nacc -= 8
                out.append((acc >> nacc) & 0xFF)
            acc &= (1 << nacc) - 1
        else:
            acc |= code << nacc
            nacc += width
            while nacc >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8

    table = {bytes([i]): i for i in range(clear)}
    nxt = end + 1
    put(clear)
    cur = b""
    for b in data:
        cand = cur + bytes([b])
        if cand in table:
            cur = cand
            continue
        put(table[cur])
        if nxt < (4094 if tiff else 4096):
            table[cand] = nxt
            nxt += 1
            if nxt + early > (1 << width) and width < 12:
                width += 1
        elif defer:
            pass
        else:
            put(clear)
            table = {bytes([i]): i for i in range(clear)}
            nxt, width = end + 1, min_size + 1
        cur = bytes([b])
    if cur:
        put(table[cur])
        if nxt < 4096:
            nxt += 1
            if nxt + early > (1 << width) and width < 12:
                width += 1
    put(end)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF if tiff else acc & 0xFF)
    return bytes(out)


@EXAMPLES
@given(n=st.integers(0, 20000), alphabet=st.sampled_from([2, 4, 16, 256]), seed=st.integers(0, 2**16))
def test_lzw_round_trips_both_settings(n, alphabet, seed):
    rng = np.random.default_rng(seed)
    data = (rng.integers(0, alphabet, n) // max(1, int(rng.integers(1, 4)))).astype(np.uint8).tobytes()
    size = max(2, (alphabet - 1).bit_length())
    assert decode_gif_lzw(lzw_encode(data, size, False), size, n) == data
    assert decode_gif_lzw(lzw_encode(data, size, False, defer=True), size, n) == data
    assert decode_tiff_lzw(lzw_encode(data, 8, True), n) == data


def test_gif_deferred_clear_matches_pillow():
    """A GIF whose encoder keeps its full 4096-code table (no clear code):
    Pillow's decoder and the port's add no entry and keep 12-bit codes."""
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 256, (90, 120))
    pal = rng.integers(0, 256, (256, 3))
    assert assert_as_pillow(gif_bytes([{"idx": idx, "defer": True}], (120, 90), pal)) == "P"
    assert assert_as_pillow(gif_bytes([{"idx": idx // 64, "min_size": 2, "defer": True}], (120, 90), pal[:4])) == "P"


# ------------------------------------------------------------------- BMP


def bmp_bytes(rows: bytes, width, height, bits, header=40, compression=0, palette=None, masks=None,
              top_down=False, colors=0) -> bytes:
    if header == 12:
        hd = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        hd = struct.pack("<IiiHHIIiiII", header, width, -height if top_down else height, 1, bits, compression,
                         len(rows), 2835, 2835, colors, 0)
        if header >= 52 and masks:
            hd += struct.pack("<4I", *(list(masks) + [0] * 4)[:4])
        hd += bytes(header - len(hd))
    extra = struct.pack("<3I", *masks[:3]) if header == 40 and compression == 3 else b""
    pal = b""
    if palette is not None:
        pal = b"".join(bytes([b, g, r]) + (b"" if header == 12 else b"\0") for r, g, b in palette)
    off = 14 + len(hd) + len(extra) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(rows), 0, 0, off) + hd + extra + pal + rows


def bmp_rows(vals: np.ndarray, bits: int, bottom_up: bool = True) -> bytes:
    """(H, W) indices (bits < 8) or (H, W, nbytes) bytes -> padded rows."""
    out = []
    for v in (vals[::-1] if bottom_up else vals):
        if v.ndim == 1 and bits < 8:
            row = np.packbits(((v[:, None] >> np.arange(bits - 1, -1, -1)) & 1).astype(np.uint8).reshape(-1))
        else:
            row = np.ascontiguousarray(v, np.uint8)
        row = row.tobytes()
        out.append(row + bytes(-len(row) % 4))
    return b"".join(out)


def bmp_rle(idx: np.ndarray, rle4: bool, seed: int, delta: bool) -> bytes:
    """Bottom-up RLE8 / RLE4: encoded and absolute runs, end-of-line and
    end-of-bitmap escapes, and a delta escape (which Pillow reads as four
    bytes, moving by the last two)."""
    rng = np.random.default_rng(seed)
    h, w = idx.shape
    out = bytearray()
    for r, row in enumerate(idx[::-1]):
        if delta and r == 1 and h > 3:
            out += bytes([0, 2, 9, 9, 3, 1])
        x = 0
        while x < w:
            n = min(int(rng.integers(1, 9)), w - x)
            if rng.random() < 0.5 or n < 3 or (rle4 and n < 4):
                v = int(row[x]) if not rle4 else (int(row[x]) << 4) | int(row[min(x + 1, w - 1)])
                out += bytes([n, v])
            else:
                if rle4:
                    n -= n % 2
                    body = bytes((int(row[x + i]) << 4) | int(row[x + i + 1]) for i in range(0, n, 2))
                else:
                    body = bytes(int(v) for v in row[x:x + n])
                out += bytes([0, n]) + body + bytes(len(body) % 2)
            x += n
        out += b"\0\0" if r < h - 1 else b"\0\1"
    return bytes(out)


@EXAMPLES
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 2**16))
def test_bmp_every_depth_and_layout_matches_pillow(h, w, seed):
    h, w = _off_grid(h), _off_grid(w)
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    # Pillow's own writer: 1, L, P, RGB, RGBA
    for mode in ("1", "L", "P", "RGB"):
        if mode == "P":
            im = Image.fromarray(c[..., 0], "P")
            im.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tobytes())
        elif mode == "1":
            im = Image.fromarray(c[..., 0] > 127)
        else:
            im = Image.fromarray(c[..., 0] if mode == "L" else c[..., :3])
        buf = io.BytesIO()
        im.save(buf, "BMP")
        assert assert_as_pillow(buf.getvalue()) == mode
    v = rng.integers(0, 65536, (h, w)).astype("<u2").view(np.uint8).reshape(h, w, 2)
    assert assert_as_pillow(bmp_bytes(bmp_rows(v, 16), w, h, 16)) == "RGB"
    assert assert_as_pillow(bmp_bytes(bmp_rows(v, 16), w, h, 16, compression=3,
                                      masks=(0xF800, 0x7E0, 0x1F))) == "RGB"
    for bits, n in ((1, 2), (4, 16), (8, 256)):
        idx = rng.integers(0, n, (h, w))
        pal = rng.integers(0, 256, (n, 3))
        assert assert_as_pillow(bmp_bytes(bmp_rows(idx, bits), w, h, bits, palette=pal)) == "P"
        assert assert_as_pillow(bmp_bytes(bmp_rows(idx, bits), w, h, bits, header=12, palette=pal)) == "P"
        assert assert_as_pillow(bmp_bytes(bmp_rows(idx, bits, False), w, h, bits, header=124, palette=pal,
                                          top_down=True)) == "P"
    gray = np.array([[i, i, i] for i in range(256)])
    assert assert_as_pillow(bmp_bytes(bmp_rows(c[..., 0], 8), w, h, 8, palette=gray)) == "L"
    for masks in ((0xFF0000, 0xFF00, 0xFF, 0xFF000000), (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                  (0xFF000000, 0xFF0000, 0xFF00, 0xFF), (0xFF0000, 0xFF00, 0xFF, 0)):
        mode = assert_as_pillow(bmp_bytes(bmp_rows(c, 32), w, h, 32, header=108, compression=3, masks=masks))
        assert mode == ("RGBA" if masks[3] else "RGB")
    assert assert_as_pillow(bmp_bytes(bmp_rows(c[..., :3], 24), w, h, 24, header=56)) == "RGB"
    assert assert_as_pillow(bmp_bytes(bmp_rows(c, 32), w, h, 32, header=52)) == "RGB"


@EXAMPLES
@given(h=st.integers(1, 30), w=st.integers(2, 45), rle4=st.booleans(), delta=st.booleans(),
       seed=st.integers(0, 2**16))
def test_bmp_rle_matches_pillow(h, w, rle4, delta, seed):
    rng = np.random.default_rng(seed)
    n = 16 if rle4 else 256
    idx = rng.integers(0, n, (h, w))
    data = bmp_bytes(bmp_rle(idx, rle4, seed, delta), w, h, 4 if rle4 else 8, compression=2 if rle4 else 1,
                     palette=rng.integers(0, 256, (n, 3)))
    assert assert_as_pillow(data) == "P"


def test_bmp_rle_short_data_fails_as_pillow_does():
    data = bmp_bytes(bytes([4, 1, 0, 1]), 10, 6, 8, compression=1, palette=[(0, 0, 9)] * 256)
    with pytest.raises(ValueError):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(ValueError, match="not enough image data"):
        read_image(data)


# ------------------------------------------------------------------- GIF


def gif_bytes(frames, screen, global_palette=None, loop=False) -> bytes:
    """frames: dicts of indices (h, w), x, y, palette (local), interlace,
    transparency, min_size."""
    sw, sh = screen
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", sw, sh, 0, 0, 0))
    if global_palette is not None:
        bits = max(1, (len(global_palette) - 1).bit_length())
        out[10] = 0x80 | (bits - 1)
        out += bytes(np.asarray(global_palette, np.uint8).reshape(-1)) + bytes(3 * ((1 << bits) - len(global_palette)))
    if loop:
        out += b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    for f in frames:
        idx = f["idx"]
        h, w = idx.shape
        if f.get("transparency") is not None:
            out += b"!\xf9\x04" + bytes([1]) + b"\x05\x00" + bytes([f["transparency"]]) + b"\x00"
        flags = 0x40 if f.get("interlace") else 0
        pal = f.get("palette")
        body = b""
        if pal is not None:
            bits = max(1, (len(pal) - 1).bit_length())
            flags |= 0x80 | (bits - 1)
            body = bytes(np.asarray(pal, np.uint8).reshape(-1)) + bytes(3 * ((1 << bits) - len(pal)))
        out += b"," + struct.pack("<HHHHB", f.get("x", 0), f.get("y", 0), w, h, flags) + body
        rows = idx
        if f.get("interlace"):
            order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4), np.arange(1, h, 2)])
            rows = idx[order]
        size = f.get("min_size", 8)
        lzw = lzw_encode(rows.astype(np.uint8).tobytes(), size, False, f.get("defer", False))
        out += bytes([size]) + b"".join(bytes([len(lzw[i:i + 255])]) + lzw[i:i + 255]
                                        for i in range(0, len(lzw), 255)) + b"\x00"
    return bytes(out + b";")


@EXAMPLES
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 2**16))
def test_gif_first_frame_matches_pillow(h, w, seed):
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (16, 3))
    idx = rng.integers(0, 16, (h, w))
    # Pillow's writer: P, L, RGB, an animation
    img = Image.fromarray(idx.astype(np.uint8), "P")
    img.putpalette(pal.astype(np.uint8).tobytes())
    for kw in ({}, {"transparency": 3}, {"interlace": False}):
        buf = io.BytesIO()
        img.save(buf, "GIF", **kw)
        assert assert_as_pillow(buf.getvalue()) == "P"
    buf = io.BytesIO()
    Image.fromarray(_rng_image(h, w, 1, seed)[..., 0], "L").save(buf, "GIF")
    assert_as_pillow(buf.getvalue())
    frames = [Image.fromarray(_rng_image(h, w, 3, seed + k, smooth=False)) for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], duration=50, loop=0)
    assert assert_as_pillow(buf.getvalue()) == "P"
    # written here: interlaced, offset inside the screen, a local table,
    # a frame past the screen (Pillow enlarges the canvas), the identity
    # table ("L"), no table at all ("L"), transparency fill
    big = rng.integers(0, 16, (h + 3, w + 2))
    cases = [
        gif_bytes([{"idx": idx, "interlace": True}], (w, h), pal),
        gif_bytes([{"idx": idx, "x": 2, "y": 1, "transparency": 5}], (w + 5, h + 4), pal),
        gif_bytes([{"idx": idx, "palette": pal[::-1]}, {"idx": idx}], (w, h), pal, loop=True),
        gif_bytes([{"idx": big, "x": 1, "y": 2, "interlace": True}], (w, h), pal),
        gif_bytes([{"idx": idx, "min_size": 4}], (w, h), [(i, i, i) for i in range(16)]),
        gif_bytes([{"idx": idx, "x": 3, "transparency": 2}], (w + 3, h)),
        gif_bytes([{"idx": idx % 4, "min_size": 2, "palette": pal[:2]}], (w, h), pal),
    ]
    modes = [assert_as_pillow(d) for d in cases]
    assert modes == ["P", "P", "P", "P", "L", "L", "P"]


# ------------------------------------------------------------------ TIFF


def _packbits(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
        else:
            k = i
            while k + 1 < len(data) and data[k + 1] != data[k] and k - i < 127:
                k += 1
            out += bytes([k - i]) + data[i:k + 1]
            i = k + 1
    return bytes(out)


_REV = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def tiff_bytes(samples: np.ndarray, bps: int, photometric: int, order="<", compression=1, tile=None,
               rows_per_strip=None, predictor=1, fillorder=1, extra=(), colormap=None, tags=None,
               pages=1) -> bytes:
    """A TIFF of (H, W, C) samples, written here: strips or tiles, raw,
    PackBits, LZW or Deflate, predictor 2, FillOrder 2 (each chunk's bytes
    bit-reversed), any byte order; `pages` repeats the IFD as later pages."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, c = s.shape
    tw, th = tile if tile else (w, rows_per_strip or h)

    def rows_of(block):
        bh, bw, _ = block.shape
        if predictor == 2:
            dt = np.uint16 if bps == 16 else np.uint8
            block = np.concatenate([block[:, :1], np.diff(block.astype(np.int64), axis=1)], 1).astype(dt)
        if bps == 16:
            return block.astype(order + "u2").tobytes()
        if bps == 8:
            return block.astype(np.uint8).tobytes()
        bits = ((block.reshape(bh, bw * c)[..., None].astype(np.int64) >> np.arange(bps - 1, -1, -1)) & 1)
        return np.packbits(bits.reshape(bh, -1).astype(np.uint8), axis=1).tobytes()

    chunks = []
    for r in range(0, h, th):
        for x0 in range(0, w, tw):
            if tile:
                block = np.zeros((th, tw, c), s.dtype)
                part = s[r:r + th, x0:x0 + tw]
                block[:part.shape[0], :part.shape[1]] = part
            else:
                block = s[r:r + th]
            raw = rows_of(block)
            comp = {1: lambda b: b, 8: lambda b: zlib.compress(b, 6), 32946: lambda b: zlib.compress(b, 9),
                    32773: _packbits, 5: lambda b: lzw_encode(b, 8, True)}[compression](raw)
            chunks.append(comp.translate(_REV) if fillorder == 2 else comp)
    e = order
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * c), 259: (3, [compression]), 262: (3, [photometric]),
               277: (3, [c]), 284: (3, [1])}
    if fillorder != 1:
        entries[266] = (3, [fillorder])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra:
        entries[338] = (3, list(extra))
    if colormap is not None:
        entries[320] = (3, list(colormap))
    for tag, val in (tags or {}).items():
        entries[tag] = val
    body = bytearray(b"II*\x00" if e == "<" else b"MM\x00*")
    body += struct.pack(e + "I", 0)
    offsets = []
    for ch in chunks:
        offsets.append(len(body))
        body += ch + bytes(len(ch) % 2)
    counts = [len(ch) for ch in chunks]
    if tile:
        entries.update({322: (3, [tw]), 323: (3, [th]), 324: (4, offsets), 325: (4, counts)})
    else:
        entries.update({273: (4, offsets), 278: (4, [th]), 279: (4, counts)})
    ifd_at = []
    fmt = {3: "H", 4: "I"}
    for p in range(pages):
        ifd_at.append(len(body))
        payload = bytearray()
        ents = []
        base = len(body) + 2 + 12 * len(entries) + 4
        for tag in sorted(entries):
            typ, vals = entries[tag]
            raw = struct.pack(e + fmt[typ] * len(vals), *vals)
            if len(raw) <= 4:
                ents.append(struct.pack(e + "HHI", tag, typ, len(vals)) + raw + bytes(4 - len(raw)))
            else:
                ents.append(struct.pack(e + "HHII", tag, typ, len(vals), base + len(payload)))
                payload += raw + bytes(len(raw) % 2)
        body += struct.pack(e + "H", len(entries)) + b"".join(ents) + struct.pack(e + "I", 0) + payload
        if p:   # the previous IFD's next-IFD offset
            at = ifd_at[p - 1] + 2 + 12 * len(entries)
            body[at:at + 4] = struct.pack(e + "I", ifd_at[p])
    body[4:8] = struct.pack(e + "I", ifd_at[0])
    return bytes(body)


def _pil_tiff(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


@EXAMPLES
@given(h=st.integers(1, 40), w=st.integers(1, 40), order=st.sampled_from(["<", ">"]),
       compression=st.sampled_from([1, 5, 8, 32946, 32773]), seed=st.integers(0, 2**16))
def test_tiff_layouts_and_compressions_match_pillow(h, w, order, compression, seed):
    h, w = _off_grid(h), _off_grid(w)
    rng = np.random.default_rng(seed)
    rgb = _rng_image(h, w, 4, seed)
    for tile in (None, (16, 16)):
        for pred in ((1, 2) if compression in (5, 8, 32946) else (1,)):
            kw = dict(order=order, compression=compression, tile=tile, rows_per_strip=5, predictor=pred)
            assert assert_as_pillow(tiff_bytes(rgb[..., :3], 8, 2, **kw)) == "RGB"
            assert assert_as_pillow(tiff_bytes(rgb, 8, 2, extra=(2,), **kw)) == "RGBA"
            assert assert_as_pillow(tiff_bytes(rgb, 8, 2, extra=(1,), **kw)) == "RGBA"
            assert assert_as_pillow(tiff_bytes(rgb, 8, 2, extra=(0,), **kw)) == "RGB"
            assert assert_as_pillow(tiff_bytes(rgb, 8, 5, **kw)) == "CMYK"
            v16 = rng.integers(0, 65536, (h, w, 3)).astype(np.uint16)
            assert assert_as_pillow(tiff_bytes(v16, 16, 2, **kw)) == "RGB"
            assert assert_as_pillow(tiff_bytes(v16[..., 0], 16, 1, **kw)) == ("I;16" if order == "<" else "I;16B")
            for photo in (0, 1):
                assert assert_as_pillow(tiff_bytes(rgb[..., 0], 8, photo, **kw)) == "L"
        for bps in (1, 2, 4):
            v = rng.integers(0, 1 << bps, (h, w))
            kw = dict(order=order, compression=compression, tile=tile, rows_per_strip=3)
            for photo in (0, 1):
                assert assert_as_pillow(tiff_bytes(v, bps, photo, **kw)) == ("1" if bps == 1 else "L")
            cmap = rng.integers(0, 65536, 3 << bps)
            assert assert_as_pillow(tiff_bytes(v, bps, 3, colormap=cmap, **kw)) == "P"
        if order == "<":
            la = rgb[..., :2]
            assert assert_as_pillow(tiff_bytes(la, 8, 1, extra=(2,), compression=compression, tile=tile)) == "LA"
        v8 = rng.integers(0, 256, (h, w))
        assert assert_as_pillow(tiff_bytes(v8, 8, 3, colormap=rng.integers(0, 65536, 768), order=order,
                                           compression=compression, tile=tile)) == "P"


@EXAMPLES
@given(h=st.integers(1, 60), w=st.integers(1, 70), seed=st.integers(0, 2**16))
@example(h=25, w=5, seed=13827)   # a Modified Huffman strip whose last codes libtiff pads
def test_tiff_ccitt_and_fill_order_match_pillow(h, w, seed):
    h, w = _off_grid(h), _off_grid(w)
    rng = np.random.default_rng(seed)
    a = np.ones((h, w), bool)
    for _ in range(8):
        y, x = rng.integers(0, h), rng.integers(0, w)
        a[y:y + rng.integers(1, 6), x:x + rng.integers(1, 30)] = False
    a ^= rng.random((h, w)) < 0.03
    img = Image.fromarray(a)
    for comp in ("group4", "group3", "tiff_ccitt"):
        for info in ({}, {278: 7}, {292: 1} if comp == "group3" else {}, {292: 4} if comp == "group3" else {}):
            data = _pil_tiff(img, compression=comp, tiffinfo=info)
            assert assert_as_pillow(data) == "1"
            # FillOrder 2: every strip's bytes bit-reversed, the tag set
            im = Image.open(io.BytesIO(data))
            offs, counts = im.tag_v2[273], im.tag_v2[279]
            flipped = bytearray(data)
            for o, n in zip(offs, counts):
                flipped[o:o + n] = bytes(data[o:o + n]).translate(_REV)
            ifd = struct.unpack("<I", data[4:8])[0]
            n_ent = struct.unpack("<H", data[ifd:ifd + 2])[0]
            tags = [struct.unpack("<H", data[ifd + 2 + 12 * i:ifd + 4 + 12 * i])[0] for i in range(n_ent)]
            if 266 in tags:
                k = tags.index(266)
                flipped[ifd + 10 + 12 * k:ifd + 12 + 12 * k] = struct.pack("<H", 2)
                assert assert_as_pillow(bytes(flipped)) == "1"
    # raw 1-bit with FillOrder 2, both photometrics, tiles
    v = rng.integers(0, 2, (h, w))
    for photo in (0, 1):
        assert assert_as_pillow(tiff_bytes(v, 1, photo, fillorder=2)) == "1"
        assert assert_as_pillow(tiff_bytes(v, 1, photo, fillorder=2, compression=5, tile=(16, 16))) == "1"


def _fax_tiff(strips, w: int, h: int, rows_per_strip: int, compression: int, t4options=None) -> bytes:
    """A WhiteIsZero 1-bit TIFF whose strips are the given CCITT bytes."""
    body = b"".join(strips) + b"\0" * (sum(map(len, strips)) & 1)
    offsets = [8 + sum(map(len, strips[:k])) for k in range(len(strips))]
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [1]), (259, 3, [compression]), (262, 3, [0]),
               (273, 4, offsets), (277, 3, [1]), (278, 4, [rows_per_strip]), (279, 4, [len(x) for x in strips])]
    if t4options is not None:
        entries.append((292, 4, [t4options]))
    ifd = 8 + len(body)
    extra_at = ifd + 2 + 12 * len(entries) + 4
    out, extra = b"", b""
    for tag, typ, vals in entries:
        if len(vals) == 1:
            value = struct.pack("<HH", vals[0], 0) if typ == 3 else struct.pack("<I", vals[0])
        else:
            value = struct.pack("<I", extra_at + len(extra))
            extra += struct.pack(f"<{len(vals)}I", *vals)
        out += struct.pack("<HHI", tag, typ, len(vals)) + value
    return b"II*\0" + struct.pack("<I", ifd) + body + struct.pack("<H", len(entries)) + out + b"\0" * 4 + extra


def _fax_bits(codes: str) -> bytes:
    """Code bits, most significant first, zero-filled to whole bytes."""
    codes = codes.replace(" ", "")
    codes += "0" * (-len(codes) % 8)
    return bytes(int(codes[i:i + 8], 2) for i in range(0, len(codes), 8))


# T.4 codes: white 0 / 3 / 4, black 5 / 8, EOL, horizontal and pass modes
_W0, _W3, _W4, _B5, _B8, _EOL, _HM, _PM = ("00110101", "1000", "1011", "0011", "000101", "000000000001", "001",
                                           "0001")
# (compression, width, height, rows per strip, strips' codes, T4Options): damaged
# or unusual strips that libtiff decodes its own way (reporting and going on
# past bad codes, padding its last lookups with zeros) or refuses
_FAX_CASES = {
    "mh_eol_then_a_row": (2, 5, 2, 2, [_EOL[:-1] + "0001" + _W0 + _B5], None),
    "mh_row_of_zeros": (2, 5, 1, 1, ["000000000000 1011 010"], None),
    "mh_bad_white_code": (2, 5, 2, 1, ["000000001000 0000", _W0 + _B5], None),
    "mh_bad_code_mid_row": (2, 5, 2, 1, ["1000 000000001000 0000", _W0 + _B5], None),
    "mh_bad_black_code": (2, 5, 2, 1, ["0111 000000000100 0000", _W0 + _B5], None),
    "mh_padding_shifts_the_byte_grid": (2, 5, 3, 3, [(_W4 + "010 0") * 3], None),
    "mh_rows_run_past_the_data": (2, 5, 3, 3, [(_W4 + "010") * 3], None),
    "g4_ends_after_the_first_row": (4, 5, 3, 3, [_HM + _W0 + _B5], None),
    "g4_empty_strip": (4, 5, 3, 3, [""], None),
    "g4_eol_after_the_first_row": (4, 5, 3, 3, [_HM + _W0 + _B5 + _EOL + _EOL + "1 1"], None),
    "g4_extension_code": (4, 5, 3, 3, [_HM + _W0 + _B5 + "0000001111" + "1"], None),
    "g4_eol_with_a_bad_tail": (4, 5, 3, 3, [_HM + _W0 + _B5 + "00000001000" + "1 1"], None),
    "g4_eol_in_a_horizontal_mode": (4, 8, 3, 3, [_HM + _W3 + _B5 + _HM + _W3 + _EOL + "1" + "1"], None),
    "g4_eol_on_the_first_row": (4, 8, 3, 3, [_EOL + _EOL], None),
    "g4_second_strip_ends_early": (4, 8, 6, 3, [(_HM + _W0 + _B8) * 3, _HM + _W3 + _B5], None),
    "g4_second_strip_eol": (4, 8, 6, 3, [(_HM + _W0 + _B8) * 3, _HM + _W3 + _B5 + _EOL + _EOL], None),
    "t4_1d_eol_mid_row": (3, 5, 2, 2, [_EOL + "0111" + _EOL + _EOL + _W0 + _B5], 0),
    "t4_2d_eol_mid_row": (3, 5, 2, 2, [_EOL + "1" + "0111" + _EOL + "1" + _W0 + _B5], 1),
    "t4_2d_pass_ends_a_row": (3, 5, 3, 3, [_EOL + "1" + _W0 + _B5 + _EOL + "0" + _PM + _EOL + "1" + _W0 + _B5], 1),
    # no EOL where SYNC_EOL looks for one: libtiff 4.6+ decodes the strip again from its start without EOLs
    # (FAXMODE_NOEOL, kept for the image's later strips), into the row it was on
    "t4_1d_no_eols": (3, 5, 3, 3, [_W3 + "010" + _W0 + _B5 + _W4 + "010"], 0),
    "t4_1d_no_eols_makeup": (3, 70, 2, 2, ["11011" + _W3 + _B5 + "11011" + _W4 + "010"], 0),
    "t4_2d_no_eols": (3, 5, 2, 2, ["1" + _W0 + _B5 + "1" + _W3 + "010"], 1),
    "t4_2d_no_eols_then_v0": (3, 5, 2, 2, ["1" + _W0 + _B5 + "0" + "1"], 1),
    "t4_1d_eols_lost_after_row_1": (3, 5, 2, 2, [_EOL + _W0 + _B5 + _W3 + "010"], 0),
    "t4_1d_eols_lost_after_row_2": (3, 5, 3, 3, [_EOL + _W0 + _B5 + _EOL + _W3 + "010" + _W0 + _B5], 0),
    "t4_1d_eols_lost_at_a_byte_end": (3, 5, 2, 2, [_EOL + _W0 + _B5], 0),
    "t4_1d_first_eol_after_row_1": (3, 5, 3, 3, [_W0 + _B5 + _EOL + _W3 + "010" + _W0 + _B5], 0),
    "t4_2d_eols_lost_after_row_1": (3, 5, 3, 3, [_EOL + "1" + _W0 + _B5 + "0" + "1" + "1" + _W3 + "010"], 1),
    "t4_2d_pass_then_no_eol": (3, 5, 3, 3, [_EOL + "1" + _W0 + _B5 + _EOL + "0" + _PM + "1" + _W0 + _B5], 1),
    "t4_noeol_kept_for_the_next_strip": (3, 5, 2, 1, [_W0 + _B5, _EOL + _W3 + "010"], 0),
    "t4_noeol_in_the_second_strip": (3, 5, 2, 1, [_EOL + _W3 + "010", _W0 + _B5], 0),
}


@pytest.mark.parametrize("case", sorted(_FAX_CASES))
def test_tiff_ccitt_damaged_strips_match_pillow(case):
    """Decoded as Pillow's libtiff decodes them, or refused where it
    refuses them."""
    compression, w, h, rps, codes, t4 = _FAX_CASES[case]
    data = _fax_tiff([_fax_bits(c) for c in codes], w, h, rps, compression, t4)
    try:
        _pil(data)
    except OSError:
        with pytest.raises(ValueError):
            read_image(data)
        return
    assert assert_as_pillow(data) == "1"


@EXAMPLES
@given(h=st.integers(1, 70), w=st.integers(1, 70), seed=st.integers(0, 2**16),
       sub=st.sampled_from([None, "YCbCr"]))
def test_tiff_jpeg_orientation_and_pages_match_pillow(h, w, seed, sub):
    rgb = _rng_image(h, w, 3, seed)
    img = Image.fromarray(rgb)
    if h % 8 == 0 or h > 16:
        src = img.convert("YCbCr") if sub else img
        assert assert_as_pillow(_pil_tiff(src, compression="jpeg", quality=80, tiffinfo={278: 16})) == "RGB"
        assert assert_as_pillow(_pil_tiff(img.convert("L"), compression="jpeg")) == "L"
    for o in range(1, 9):
        ifd = TiffImagePlugin.ImageFileDirectory_v2()
        ifd[274] = o
        assert assert_as_pillow(_pil_tiff(img, tiffinfo=ifd, compression="tiff_lzw")) == "RGB"
    two = _pil_tiff(img, save_all=True, append_images=[Image.fromarray(rgb[::-1].copy())], compression="packbits")
    assert assert_as_pillow(two) == "RGB"
    assert assert_as_pillow(tiff_bytes(rgb, 8, 2, compression=8, pages=3)) == "RGB"


def test_tiff_cmyk_jpeg_strips_are_the_stored_samples():
    cmyk = _rng_image(40, 33, 4, 3)
    assert assert_as_pillow(_pil_tiff(Image.fromarray(cmyk, "CMYK"), compression="jpeg")) == "CMYK"


# ----------------------------------------------------------- CMYK JPEGs


@EXAMPLES
@given(h=st.integers(1, 60), w=st.integers(1, 60), seed=st.integers(0, 2**16),
       transform=st.sampled_from([None, 0, 1, 2]), sub=st.sampled_from([0, 2]))
def test_cmyk_and_ycck_jpegs_match_pillow(h, w, seed, transform, sub):
    """Adobe transform 0 (or no Adobe marker) is CMYK as stored, any other
    transform YCCK; Pillow inverts every sample (rawmode CMYK;I)."""
    buf = io.BytesIO()
    Image.fromarray(_rng_image(h, w, 4, seed), "CMYK").save(buf, "JPEG", quality=85, subsampling=sub)
    data = buf.getvalue()
    at = data.index(b"Adobe")
    if transform is None:
        start = at - 4
        data = data[:start] + data[start + 2 + struct.unpack(">H", data[start + 2:start + 4])[0]:]
    else:
        data = data[:at + 11] + bytes([transform]) + data[at + 12:]
    assert assert_as_pillow(data) == "CMYK"
    assert probe_image(data) == (w, h)


# ------------------------------------------------------------------ WebP


def _pil_webp(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "WEBP", **kw)
    return buf.getvalue()


def _chunk(fourcc: bytes, body: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(body)) + body + bytes(len(body) & 1)


def _riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _webp_chunks(data: bytes):
    out, pos = [], 12
    while pos + 8 <= len(data):
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _vp8x(w, h, flags) -> bytes:
    return _chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little"))


def _alpha_filtered(a: np.ndarray, method: int) -> np.ndarray:
    """libwebp's forward filters (`filters.c`): the residual the
    unfilters undo."""
    a = a.astype(np.int64)
    h, w = a.shape
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    if method == 1:
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = a[1:, :-1]
    elif method == 2:
        pred[1:] = a[:-1]
    elif method == 3:
        pred[1:, 0] = a[:-1, 0]
        g = a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1]
        pred[1:, 1:] = np.clip(g, 0, 255)
    return ((a - pred) & 0xFF).astype(np.uint8)


@EXAMPLES
@given(h=st.integers(1, 50), w=st.integers(1, 50), seed=st.integers(0, 2**16),
       quality=st.sampled_from([5, 50, 80, 100]))
def test_webp_lossy_lossless_and_alpha_match_pillow(h, w, seed, quality):
    h, w = _off_grid(h), _off_grid(w)
    rgba = _rng_image(h, w, 4, seed)
    for c, mode in ((3, "RGB"), (4, "RGBA")):
        img = Image.fromarray(rgba[..., :c])
        assert assert_as_pillow(_pil_webp(img, quality=quality)) == mode
        assert assert_as_pillow(_pil_webp(img, quality=quality, method=0)) == mode
        assert assert_as_pillow(_pil_webp(img, lossless=True, quality=quality)) == mode
        assert assert_as_pillow(_pil_webp(img, lossless=True, quality=quality, exact=True)) == mode
    pal = Image.fromarray(np.random.default_rng(seed).integers(0, 6, (h, w)).astype(np.uint8), "P")
    pal.putpalette(np.random.default_rng(seed).integers(0, 256, 18).astype(np.uint8).tobytes())
    assert assert_as_pillow(_pil_webp(pal.convert("RGB"), lossless=True)) == "RGB"
    # an ALPH chunk written here: raw, each filter
    vp8 = dict(_webp_chunks(_pil_webp(Image.fromarray(rgba[..., :3]), quality=quality)))[b"VP8 "]
    for method in range(4):
        alph = bytes([method << 2]) + _alpha_filtered(rgba[..., 3], method).tobytes()
        data = _riff(_vp8x(w, h, 0x10) + _chunk(b"ALPH", alph) + _chunk(b"VP8 ", vp8))
        assert assert_as_pillow(data) == "RGBA"
        # the VP8X alpha flag unset: RGBA (WebPGetFeatures sees the ALPH
        # chunk), the plane dropped by the demuxer (alpha 255)
        unflagged = _riff(_vp8x(w, h, 0) + _chunk(b"ALPH", alph) + _chunk(b"VP8 ", vp8))
        assert assert_as_pillow(unflagged) == "RGBA" and (read_image(unflagged)[0][..., 3] == 255).all()
        # the flag set without an ALPH chunk: RGBA, alpha 255
        assert assert_as_pillow(_riff(_vp8x(w, h, 0x10) + _chunk(b"VP8 ", vp8))) == "RGBA"
    lossless = dict(_webp_chunks(_pil_webp(Image.fromarray(rgba[..., :3]), lossless=True)))[b"VP8L"]
    # a VP8L header's alpha hint replaces the VP8X flag
    assert assert_as_pillow(_riff(_vp8x(w, h, 0x10) + _chunk(b"VP8L", lossless))) == "RGB"


def test_webp_unpremultiplied_alpha():
    data = _pil_webp(Image.new("RGBA", (5, 3), (200, 100, 50, 128)), lossless=True)
    px, mode, _ = read_image(data)
    assert mode == "RGBA" and (px == (200, 100, 50, 128)).all()
    assert_as_pillow(data)


@EXAMPLES
@given(seed=st.integers(0, 2**16), lossless=st.booleans(), alpha=st.booleans())
def test_animated_webp_first_frame_matches_pillow(seed, lossless, alpha):
    """An animation written here from Pillow-encoded frames: the first
    frame offset inside a larger canvas, later frames ignored."""
    rng = np.random.default_rng(seed)
    cw, ch = int(rng.integers(20, 60)), int(rng.integers(20, 60))
    fw, fh = int(rng.integers(1, cw - 4)), int(rng.integers(1, ch - 4))
    fx, fy = 2 * int(rng.integers(0, (cw - fw) // 2 + 1)), 2 * int(rng.integers(0, (ch - fh) // 2 + 1))
    body = _vp8x(cw, ch, 0x02 | (0x10 if alpha else 0)) + _chunk(b"ANIM", bytes(4) + struct.pack("<H", 0))
    for k, (x, y, w, h) in enumerate(((fx, fy, fw, fh), (0, 0, cw, ch))):
        img = Image.fromarray(_rng_image(h, w, 4 if alpha else 3, seed + k))
        frame = b"".join(_chunk(f, b) for f, b in _webp_chunks(_pil_webp(img, lossless=lossless, quality=70))
                         if f in (b"ALPH", b"VP8 ", b"VP8L"))
        head = (x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little") + (w - 1).to_bytes(3, "little") \
            + (h - 1).to_bytes(3, "little") + (100).to_bytes(3, "little") + bytes([2 if k else 0])
        body += _chunk(b"ANMF", head + frame)
    assert assert_as_pillow(_riff(body)) == ("RGBA" if alpha else "RGB")
    frames = [Image.fromarray(_rng_image(16, 24, 3, seed + k)) for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], lossless=lossless)
    assert_as_pillow(buf.getvalue())


class _BoolWriter:
    """RFC 6386 section 7.3's boolean encoder."""

    def __init__(self):
        self.out = bytearray()
        self.rng, self.bottom, self.bit_count = 255, 0, 24

    def _add_one(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit: int, prob: int) -> None:
        split = 1 + (((self.rng - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.rng -= split
        else:
            self.rng = split
        while self.rng < 128:
            self.rng <<= 1
            if self.bottom & (1 << 31):
                self._add_one()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._add_one()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _recorded(vp8: bytes, monkeypatch):
    """Every (bit, probability) the port's decoder reads from a frame's
    first partition and from its token partitions, with the index where
    each macroblock row's tokens start."""
    logs = []

    class Rec(tvp8._Bool):
        def __init__(self, data):
            self.log = []
            logs.append(self.log)
            super().__init__(data)

        def bit(self, prob):
            b = super().bit(prob)
            self.log.append((b, prob))
            return b

    class Parts(list):
        starts = []

        def __getitem__(self, i):
            Parts.starts.append(len(list.__getitem__(self, i).log))
            return list.__getitem__(self, i)

    monkeypatch.setattr(tvp8, "_Bool", Rec)
    hd = tvp8._parse_header(vp8)
    assert len(hd.parts) == 1
    Parts.starts = []
    hd.parts = Parts(hd.parts)
    tvp8._parse_macroblocks(hd)
    monkeypatch.undo()
    return logs[0], hd.parts[0].log, Parts.starts


def _value(v, n):
    return [((v >> (n - 1 - i)) & 1, 128) for i in range(n)]


def _signed(v, n):
    return _value(abs(v), n) + [(int(v < 0), 128)]


def _reencode(vp8: bytes, monkeypatch, simple=None, sharpness=None, level=None, lf_delta=None, parts=1,
              relative=False) -> bytes:
    """The frame with its header changed and its token data spread over
    `parts` partitions, every other decision as it was."""
    head, tokens, starts = _recorded(vp8, monkeypatch)
    bits = [d[0] for d in head]
    i = 3

    def take(n):
        nonlocal i
        v = 0
        for _ in range(n):
            v = (v << 1) | bits[i]
            i += 1
        return v

    segment = head[:3]
    if bits[2]:   # use_segment
        update_map, update_data = take(1), take(1)
        quant, strength, absolute = [], [], 1
        if update_data:
            absolute = take(1)
            for values, n in ((quant, 7), (strength, 6)):
                for _ in range(4):
                    v = take(n) if take(1) else 0
                    values.append(-v if v and take(1) else v)
        data_end = i
        if update_map:
            for _ in range(3):
                if take(1):
                    take(8)
        segment = head[:i]
        if relative and update_data and absolute:
            base_q = int("".join(map(str, bits[i + 12:i + 19])), 2)   # after the filter header and partitions
            new = head[:3] + [(update_map, 128), (1, 128), (0, 128)]
            for values, n, base in ((quant, 7, base_q), (strength, 6, None)):
                for v in values:
                    d = v - (base if base is not None else int("".join(map(str, bits[i + 1:i + 7])), 2))
                    new += ([(1, 128)] + _signed(d, n)) if d else [(0, 128)]
            segment = new + head[data_end:i]
    f_simple, f_level, f_sharp, f_delta = take(1), take(6), take(3), take(1)
    assert not f_delta and take(2) == 0   # Pillow's frames: no deltas, one partition
    out = segment + [(f_simple if simple is None else simple, 128)]
    out += _value(f_level if level is None else level, 6) + _value(f_sharp if sharpness is None else sharpness, 3)
    if lf_delta is None:
        out += [(0, 128)]
    else:
        out += [(1, 128), (1, 128)]
        for d in lf_delta:
            out += ([(1, 128)] + _signed(d, 6)) if d else [(0, 128)]
    out += _value((parts - 1).bit_length(), 2) + head[i:]
    bw = _BoolWriter()
    for b, p in out:
        bw.put(b, p)
    part0 = bw.flush()
    rows = [tokens[a:b] for a, b in zip(starts, starts[1:] + [len(tokens)])]
    blobs = []
    for p in range(parts):
        w = _BoolWriter()
        for r in rows[p::parts]:
            for b, pr in r:
                w.put(b, pr)
        blobs.append(w.flush())
    tag = (len(part0) << 5) | (vp8[0] & 0x1F)
    sizes = b"".join(len(b).to_bytes(3, "little") for b in blobs[:-1])
    return tag.to_bytes(3, "little") + vp8[3:10] + part0 + sizes + b"".join(blobs)


@pytest.mark.parametrize("variant", [
    dict(), dict(simple=1), dict(sharpness=5), dict(sharpness=2, level=40), dict(simple=1, sharpness=7, level=63),
    dict(lf_delta=(3, -2, 5, 1, -4, 2, 6, -1)), dict(parts=2), dict(parts=4, simple=1), dict(parts=8),
    dict(relative=True), dict(level=0),
])
def test_vp8_header_variants_match_pillow(variant, monkeypatch):
    """Lossy frames re-encoded from Pillow's: the simple loop filter,
    sharpness, filter levels, loop-filter deltas, several token
    partitions, relative segment quantizers."""
    for seed, (h, w) in enumerate(((45, 61), (96, 130), (17, 9))):
        img = Image.fromarray(np.asarray(Image.fromarray(_page(seed)).resize((w * 3, h * 3)))[::3, ::3].copy())
        vp8 = dict(_webp_chunks(_pil_webp(img, quality=60)))[b"VP8 "]
        data = _riff(_chunk(b"VP8 ", _reencode(vp8, monkeypatch, **variant)))
        assert assert_as_pillow(data) == "RGB"


# ---------------------------------------------------- payloads, refusals


def _jax_payload(data: bytes) -> bytes:
    from morphik_core_tpu.services.ingestion_service import _image_to_data_uri as j_image_to_data_uri

    return data_uri_to_bytes(j_image_to_data_uri(Image.open(io.BytesIO(data)), max_width=1024))


def _port_payload(data: bytes) -> bytes:
    return data_uri_to_bytes(_image_to_data_uri(*read_image(data), max_width=1024)[0])


def _wide(h, w, c, seed):
    return np.asarray(Image.fromarray(_page(seed)).resize((w, h)))[..., :c] if c != 4 else \
        np.concatenate([np.asarray(Image.fromarray(_page(seed)).resize((w, h))), _rng_image(h, w, 1, seed)], -1)


@pytest.mark.parametrize("kind", ["bmp_p", "bmp_rgba", "gif", "tiff_g4", "tiff_i16b", "tiff_la", "tiff_cmyk",
                                  "webp_lossy", "webp_alpha", "cmyk_jpeg", "ycck_jpeg"])
def test_payload_matches_the_reference(kind):
    """The q80 payload of the reference's `_image_to_data_uri` byte for
    byte, wider than 1024 (LANCZOS under Pillow's mode rules) and not."""
    for w in (1030, 300):
        h = 140
        page = _wide(h, w, 3, 1)
        if kind == "bmp_p":
            img = Image.fromarray(page).quantize(37)
            buf = io.BytesIO()
            img.save(buf, "BMP")
            data = buf.getvalue()
        elif kind == "bmp_rgba":
            data = bmp_bytes(bmp_rows(_wide(h, w, 4, 2)[..., [2, 1, 0, 3]], 32), w, h, 32, header=124, compression=3,
                             masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
        elif kind == "gif":
            buf = io.BytesIO()
            Image.fromarray(page).save(buf, "GIF")
            data = buf.getvalue()
        elif kind == "tiff_g4":
            data = _pil_tiff(Image.fromarray(page[..., 0] > 128), compression="group4")
        elif kind == "tiff_i16b":
            data = tiff_bytes(page[..., 0].astype(np.uint16) * 200 + 7, 16, 1, order=">", compression=5)
        elif kind == "tiff_la":
            data = tiff_bytes(_wide(h, w, 4, 3)[..., 2:], 8, 1, extra=(2,), compression=8)
        elif kind == "tiff_cmyk":
            data = _pil_tiff(Image.fromarray(page).convert("CMYK"), compression="tiff_lzw")
        elif kind == "webp_lossy":
            data = _pil_webp(Image.fromarray(page), quality=80)
        elif kind == "webp_alpha":
            data = _pil_webp(Image.fromarray(_wide(h, w, 4, 4)), quality=80)
        else:
            buf = io.BytesIO()
            Image.fromarray(page).convert("CMYK").save(buf, "JPEG", quality=90)
            data = buf.getvalue()
            if kind == "ycck_jpeg":
                at = data.index(b"Adobe")
                data = data[:at + 11] + b"\x02" + data[at + 12:]
        assert_as_pillow(data)
        assert _port_payload(data) == _jax_payload(data)


def test_i16b_and_cmyk_resize_as_pillow():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 65536, (50, 60)).astype(np.uint16)
    im = Image.frombytes("I;16B", (60, 50), v.astype(">u2").tobytes())
    assert np.array_equal(resize_mode_u8(v, "I;16B", (17, 23)),
                          np.asarray(im.resize((23, 17), Image.LANCZOS)).astype(np.uint16))
    c = rng.integers(0, 256, (50, 60, 4)).astype(np.uint8)
    im = Image.fromarray(c, "CMYK")
    assert np.array_equal(resize_mode_u8(c, "CMYK", (17, 23)), np.asarray(im.resize((23, 17), Image.LANCZOS)))
    assert np.array_equal(to_rgb_u8(c, "CMYK"), np.asarray(im.convert("RGB")))
    assert to_rgb_u8(np.array([[[10, 20, 30, 40]]], np.uint8), "CMYK").tolist() == [[[207, 198, 190]]]


def _sof(data: bytes, marker: int = None, precision: int = None) -> bytes:
    at = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[at + 1] = marker
    if precision is not None:
        out[at + 4] = precision
    return bytes(out)


def _refused_cases():
    """(name, bytes, words in the refusal) of every variant the port
    refuses by name."""
    img = Image.fromarray(_rng_image(20, 24, 3, 0))
    jpg = io.BytesIO()
    img.save(jpg, "JPEG")
    jpg = jpg.getvalue()
    rgb = _rng_image(20, 24, 3, 1)
    from tests.test_torch_more_image_formats import arith_past_a_block, libjpeg_write

    lossless = libjpeg_write(_rng_image(20, 24, 3, 0), lossless=(1, 0))
    at = lossless.index(b"\xff\xc3")
    cases = [
        # arithmetic coding past Pillow's 64 KiB block (a small file decodes: test_torch_more_image_formats.py)
        ("jpeg_arith", arith_past_a_block(_page(3)), "arithmetic-coded JPEG"),
        ("jpeg_12bit", _sof(jpg, precision=12), "12-bit JPEG"),
        # arithmetic-coded lossless (SOF11), which libjpeg-turbo does not decode (SOF3 decodes)
        ("jpeg_lossless", lossless[:at] + b"\xff\xcb" + lossless[at + 2:], "lossless JPEG"),
        ("jpeg_hierarchical", _sof(jpg, 0xC5), "hierarchical JPEG"),
        ("tiff_bigtiff", b"II+\x00\x08\x00\x00\x00" + bytes(16), "BigTIFF"),
        ("tiff_old_jpeg", tiff_bytes(rgb, 8, 2, tags={259: (3, [6])}), "old-style JPEG"),
        ("tiff_lzma", tiff_bytes(rgb, 8, 2, tags={259: (3, [34925])}), "LZMA"),
        ("tiff_float", tiff_bytes(rgb[..., 0], 8, 1, tags={339: (3, [3])}), "float or signed"),
        ("tiff_32bit", tiff_bytes(rgb[..., 0], 8, 1, tags={258: (3, [32])}), "32-bit"),
        ("tiff_planar", tiff_bytes(rgb, 8, 2, tags={284: (3, [2])}), "planar"),
        ("tiff_ycbcr_raw", tiff_bytes(rgb, 8, 6), "YCbCr without JPEG"),
        ("tiff_lab", tiff_bytes(rgb, 8, 8), "pixel layout"),
        ("tiff_pa", tiff_bytes(rgb[..., :2], 8, 3, extra=(2,), colormap=[0] * 768), "pixel layout"),
        ("tiff_predictor3", tiff_bytes(rgb, 8, 2, tags={317: (3, [3])}), "predictor 3"),
        ("bmp_header", b"BM" + struct.pack("<IHHI", 2050, 0, 0, 34) + struct.pack("<I", 20) + bytes(2016),
         "header of 20 bytes"),
        ("bmp_png_inside", bmp_bytes(bytes(100), 8, 8, 24, compression=5), "compression 5"),
        ("bmp_rle_bilevel", bmp_bytes(bytes([2, 1, 0, 1]), 2, 1, 8, compression=1,
                                      palette=[(0, 0, 0), (255, 255, 255)], colors=2), "RLE with a black-and-white"),
    ]
    return cases


@pytest.mark.parametrize("name,data,words", _refused_cases(), ids=[c[0] for c in _refused_cases()])
def test_refused_variants_raise_before_decoding(name, data, words):
    with pytest.raises(UnsupportedImage, match=f"{words}.*{ROADMAP}") as err:
        probe_image(data)
    with pytest.raises(UnsupportedImage):
        read_image(data)
    if name.startswith("jpeg"):
        assert isinstance(err.value, UnsupportedJpeg)
    ctype = {"jpeg": "image/jpeg", "tiff": "image/tiff", "bmp": "image/bmp"}[name.split("_")[0]]
    try:
        Image.open(io.BytesIO(data))
    except Exception:  # noqa: BLE001 — Image.open fails: the reference stores no page, so no 415
        if name != "tiff_bigtiff":   # the port reads no BigTIFF header, so a broken one keeps the 415 a
            assert err.value.open_fails   # whole one gets (ROADMAP Queue 3)
            check_upload(ctype, data)
            return
    assert not err.value.open_fails
    with pytest.raises(UnsupportedContentType, match=ROADMAP):
        check_upload(ctype, data)


def _bombs():
    big = 1 << 14   # 16384 x 16384 > 2 * 89478485
    gif = bytearray(gif_bytes([{"idx": np.zeros((2, 2), np.int64)}], (2, 2), [(0, 0, 0), (9, 9, 9)]))
    gif[6:10] = struct.pack("<HH", 65535, 65535)
    bmp = bmp_bytes(bytes(8), 1, 1, 24)
    bmp = bmp[:18] + struct.pack("<ii", big, big) + bmp[26:]
    tif = tiff_bytes(np.zeros((1, 1), np.uint8), 8, 1, tags={256: (4, [big]), 257: (4, [big])})
    webp = _riff(_vp8x(big, big, 0) + _chunk(b"VP8L", bytes([0x2F]) + (((big - 1) | (big - 1) << 14)
                                                                        ).to_bytes(4, "little")))
    def png_chunk(t, b):
        return struct.pack(">I", len(b)) + t + b + struct.pack(">I", zlib.crc32(t + b))

    png = b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", struct.pack(">IIBBBBB", big, big, 8, 2, 0, 0, 0)) \
        + png_chunk(b"IDAT", zlib.compress(b"\x00")) + png_chunk(b"IEND", b"")
    jpg = io.BytesIO()
    Image.new("L", (8, 8)).save(jpg, "JPEG")
    jpg = bytearray(jpg.getvalue())
    at = jpg.index(b"\xff\xc0")
    jpg[at + 5:at + 9] = struct.pack(">HH", 65000, 65000)
    return [("gif", bytes(gif)), ("bmp", bmp), ("tiff", tif), ("webp", webp), ("png", png), ("jpeg", bytes(jpg))]


@pytest.mark.parametrize("kind,data", _bombs(), ids=[k for k, _ in _bombs()])
def test_decompression_bombs_are_refused_as_pillow_refuses_them(kind, data):
    """`Image.open` refuses them: the reference stores no page and
    completes the job, so the upload passes and the port's first stage
    refuses them (`tests/test_torch_broken_images.py`)."""
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    with pytest.raises(DecompressionBombError, match="could be decompression bomb DOS attack"):
        probe_image(data)
    with pytest.raises(DecompressionBombError):
        open_image(data)
    check_upload(f"image/{kind}", data)


def test_other_image_types_and_video_still_answer_415():
    """Video answers 415 whatever the type says; bytes no Pillow plugin
    recognizes pass (the reference stores no page for them and completes
    the job: `tests/test_torch_broken_images.py`); an icon, refused by
    type before the port read ICO, is now sniffed and ingested."""
    with pytest.raises(UnsupportedContentType, match=ROADMAP):
        check_upload("video/mp4", b"\x00" * 32)
    for ctype in ("image/svg+xml", "image/avif"):
        check_upload(ctype, b"\x00" * 32)
        with pytest.raises(UnidentifiedImage):
            open_image(b"\x00" * 32)
    buf = io.BytesIO()
    Image.fromarray(_rng_image(20, 24, 4, 1)).save(buf, "ICO", sizes=[(16, 16)])
    check_upload("image/x-icon", buf.getvalue())
    assert_as_pillow(buf.getvalue())
    check_upload("image/gif", b"GIF89a broken")   # a broken file passes: its job fails


# -------------------------------------------------------------- fixture


def fixture_files() -> dict:
    """`chip_smoke.py` phase 22's files: name -> bytes (Pillow writes the
    ones it can, this module the rest)."""
    pages = [_page(20 + k)[::2, ::2].copy() for k in range(8)]   # 550 x 425 colour text pages
    rng = np.random.default_rng(22)
    p0 = Image.fromarray(pages[0])
    files = {}
    quant = p0.quantize(200)
    q16 = p0.quantize(16)
    for name, img in (("bmp1.bmp", Image.fromarray(pages[1][..., 0] > 140)), ("bmp8.bmp", quant),
                      ("bmp24.bmp", Image.fromarray(pages[2]))):
        buf = io.BytesIO()
        img.save(buf, "BMP")
        files[name] = buf.getvalue()
    h, w = pages[3].shape[:2]
    idx4 = np.asarray(q16)
    pal4 = np.array(q16.getpalette()[:48]).reshape(16, 3)
    files["bmp4.bmp"] = bmp_bytes(bmp_rows(idx4, 4), idx4.shape[1], idx4.shape[0], 4, palette=pal4)
    v16 = pages[3].astype(np.int64)
    v565 = ((v16[..., 0] >> 3) << 11 | (v16[..., 1] >> 2) << 5 | v16[..., 2] >> 3).astype("<u2")
    files["bmp16.bmp"] = bmp_bytes(bmp_rows(v565.view(np.uint8).reshape(h, w, 2), 16), w, h, 16, compression=3,
                                   masks=(0xF800, 0x7E0, 0x1F))
    bgra = np.concatenate([pages[4][..., ::-1], np.full((h, w, 1), 255, np.uint8)], -1)
    bgra[:40, :, 3] = 90
    files["bmp32.bmp"] = bmp_bytes(bmp_rows(bgra, 32), w, h, 32, header=124, compression=3,
                                   masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    pal8 = np.array((quant.getpalette() + [0] * 768)[:768]).reshape(256, 3)
    files["bmp_rle8.bmp"] = bmp_bytes(bmp_rle(np.asarray(quant), False, 1, True), w, h, 8, compression=1,
                                      palette=pal8)
    files["bmp_rle4.bmp"] = bmp_bytes(bmp_rle(idx4, True, 2, False), w, h, 4, compression=2, palette=pal4)
    buf = io.BytesIO()
    Image.fromarray(pages[5]).save(buf, "GIF")
    files["page.gif"] = buf.getvalue()
    anim = [Image.fromarray(pages[6])] + [Image.fromarray(p) for p in pages[:2]]
    buf = io.BytesIO()
    anim[0].save(buf, "GIF", save_all=True, append_images=anim[1:], duration=200, loop=0)
    files["anim.gif"] = buf.getvalue()
    files["interlaced.gif"] = gif_bytes([{"idx": np.asarray(quant), "interlace": True, "x": 3, "y": 2}],
                                        (w + 6, h + 4), pal8)
    ink = pages[7][..., 0] > 150
    for comp, name in (("group4", "g4.tif"), ("group3", "g3.tif"), ("tiff_ccitt", "mh.tif")):
        files[name] = _pil_tiff(Image.fromarray(ink), compression=comp, tiffinfo={278: 64})
    files["g3_2d.tif"] = _pil_tiff(Image.fromarray(ink), compression="group3", tiffinfo={292: 5})
    files["lzw.tif"] = tiff_bytes(pages[1], 8, 2, compression=5, predictor=2, rows_per_strip=32)
    files["deflate_tiles.tif"] = tiff_bytes(pages[2], 8, 2, compression=8, tile=(128, 128), order=">")
    files["packbits.tif"] = _pil_tiff(Image.fromarray(pages[3]), compression="packbits")
    files["raw_gray.tif"] = tiff_bytes(pages[4][..., 1], 8, 0, rows_per_strip=50)
    files["jpeg.tif"] = _pil_tiff(Image.fromarray(pages[5]).convert("YCbCr"), compression="jpeg", quality=85)
    files["multipage.tif"] = _pil_tiff(Image.fromarray(pages[6]), save_all=True, compression="tiff_lzw",
                                       append_images=[Image.fromarray(p) for p in pages[:3]])
    files["lossy.webp"] = _pil_webp(Image.fromarray(pages[0]), quality=80)
    files["lossless.webp"] = _pil_webp(Image.fromarray(pages[1]), lossless=True)
    rgba = np.concatenate([pages[2], np.full((h, w, 1), 255, np.uint8)], -1)
    rgba[100:200, 50:300, 3] = rng.integers(0, 256, (100, 250))
    files["alpha.webp"] = _pil_webp(Image.fromarray(rgba), quality=80)
    frames = [Image.fromarray(pages[3])] + [Image.fromarray(p) for p in pages[4:6]]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], quality=80)
    files["anim.webp"] = buf.getvalue()
    for name, transform in (("cmyk.jpg", None), ("ycck.jpg", 2)):
        buf = io.BytesIO()
        Image.fromarray(pages[7 if transform else 6]).convert("CMYK").save(buf, "JPEG", quality=90)
        data = buf.getvalue()
        if transform:
            at = data.index(b"Adobe")
            data = data[:at + 11] + bytes([transform]) + data[at + 12:]
        files[name] = data
    # still refused: an arithmetic-coded file whose data run past Pillow's 64 KiB block
    from tests.test_torch_more_image_formats import arith_past_a_block

    files["arith.jpg"] = arith_past_a_block(_page(20))
    # the timed pages: a letter page at 200 dpi as Group 4, a lossy WebP 1024 wide
    letter = np.asarray(Image.fromarray(_page(30)).resize((1700, 2200), Image.NEAREST))[..., 0] > 150
    files["letter_g4.tif"] = _pil_tiff(Image.fromarray(letter), compression="group4")
    wide = np.asarray(Image.fromarray(_page(31)).resize((1024, 1325)))
    files["wide_lossy.webp"] = _pil_webp(Image.fromarray(wide), quality=80)
    buf = io.BytesIO()
    Image.fromarray(wide).save(buf, "JPEG", quality=80)
    files["wide_baseline.jpg"] = buf.getvalue()
    return files


REFUSED = ("arith.jpg",)
TIMED = ("letter_g4.tif", "wide_lossy.webp", "wide_baseline.jpg")
# the page each ingested file was made from (phase 22's image queries find
# a file of their own page first)
SOURCE_PAGE = {"bmp1.bmp": 1, "bmp8.bmp": 0, "bmp24.bmp": 2, "bmp4.bmp": 3, "bmp16.bmp": 3, "bmp32.bmp": 4,
               "bmp_rle8.bmp": 0, "bmp_rle4.bmp": 3, "page.gif": 5, "anim.gif": 6, "interlaced.gif": 0,
               "g4.tif": 7, "g3.tif": 7, "mh.tif": 7, "g3_2d.tif": 7, "lzw.tif": 1, "deflate_tiles.tif": 2,
               "packbits.tif": 3, "raw_gray.tif": 4, "jpeg.tif": 5, "multipage.tif": 6, "lossy.webp": 0,
               "lossless.webp": 1, "alpha.webp": 2, "anim.webp": 3, "cmyk.jpg": 6, "ycck.jpg": 7}


def write_fixture(path: Path = FIXTURE) -> Path:
    """Each file's bytes, Pillow's mode and the sha256 of its
    `convert("RGB")` pixels, and the sha256 of the reference's q80 payload
    (`_image_to_data_uri`, 1024 px; none for a refused file), and the page
    an ingested file was made from. Needs PIL and the JAX package."""
    arrays = {}
    for name, data in fixture_files().items():
        key = name.replace(".", "_")
        arrays[key] = np.frombuffer(data, np.uint8)
        if name in REFUSED:
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
    """Regenerated now, the committed fixture is byte-equal; it names the
    same files as `chip_smoke.py` phase 22."""
    import chip_smoke

    assert chip_smoke.FORMAT_FILES == tuple(SOURCE_PAGE) and chip_smoke.FORMAT_TIMED == TIMED
    assert (chip_smoke.FORMAT_REFUSED,) == REFUSED
    fresh = np.load(write_fixture(tmp_path / "formats.npz"))
    committed = np.load(FIXTURE)
    assert sorted(fresh.files) == sorted(committed.files)
    for k in committed.files:
        assert np.array_equal(fresh[k], committed[k]), k
    assert FIXTURE.stat().st_size < 3_000_000


NAMES = tuple(SOURCE_PAGE) + TIMED


@pytest.mark.parametrize("name", NAMES)
def test_fixture_files_decode_as_the_reference(name):
    z = np.load(FIXTURE)
    key = name.replace(".", "_")
    data = z[key].tobytes()
    assert assert_as_pillow(data) == str(z[f"{key}_mode"])
    assert hashlib.sha256(decode_image(data).tobytes()).hexdigest() == str(z[f"{key}_rgb_sha256"])
    if f"{key}_payload_sha256" in z.files:
        assert hashlib.sha256(_port_payload(data)).hexdigest() == str(z[f"{key}_payload_sha256"])


def test_fixture_refused_file_answers_415():
    data = np.load(FIXTURE)["arith_jpg"].tobytes()
    with pytest.raises(UnsupportedContentType, match="arithmetic-coded.*" + ROADMAP):
        check_upload("image/jpeg", data)
