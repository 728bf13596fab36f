"""The port's JPEG codec (`utils/jpeg.py`), LANCZOS resize and Pillow's
mode rules (`models/colqwen/preprocess.py`) against Pillow 12 with
libjpeg-turbo, on the CPU. Tolerance: exact everywhere (bytes, uint8
pixels).

- `encode_jpeg` writes Pillow's bytes for RGB and L, odd sizes, q70, q80
  and q95, text pages and seeded noise (hypothesis over sizes).
- `decode_own` of the encoder's coefficients equals Pillow's decode of
  its bytes.
- The upload decoder equals Pillow on committed fixtures (4:2:0, 4:2:2,
  4:4:4, gray, restart intervals, odd sizes): their decoded pixels are
  held as hashes, which `chip_smoke.py` checks on the card's machine;
  it refuses progressive and CMYK files with ROADMAP item 3b-ii.
- LANCZOS with the mode rules equals `Image.resize(..., LANCZOS)` then
  `convert("RGB")` for RGB, L, RGBA with alpha, P and LA wider than 1024.
"""

import hashlib
import io
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st
from PIL import Image

from morphik_core_tpu_torch.models.colqwen.preprocess import resize_mode_u8, to_rgb_u8
from morphik_core_tpu_torch.parser.text_render import render_text_page
from morphik_core_tpu_torch.utils.jpeg import UnsupportedJpeg, decode_jpeg, decode_own, encode_jpeg, read_jpeg
from morphik_core_tpu_torch.utils.png import read_png

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "jpeg_decode_cases.npz"


def _pil_jpeg(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _pixels(kind: str, h: int, w: int, gray: bool, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (h, w) if gray else (h, w, 3)
    if kind == "noise":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    # smooth structure: a bicubic upsample of coarse noise, with white margins
    coarse = Image.fromarray(rng.integers(0, 256, (h // 8 + 2, w // 8 + 2) + shape[2:], dtype=np.uint8))
    out = np.array(coarse.resize((w, h), Image.Resampling.BICUBIC))
    out[: h // 4] = 255
    return out


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 70), w=st.integers(1, 70), gray=st.booleans(), quality=st.sampled_from([70, 80, 95]),
       kind=st.sampled_from(["noise", "smooth"]), seed=st.integers(0, 2**16))
def test_encoder_and_decode_own_match_pil(h, w, gray, quality, kind, seed):
    px = _pixels(kind, h, w, gray, seed)
    data, coeffs = encode_jpeg(px, quality)
    assert data == _pil_jpeg(Image.fromarray(px), quality=quality)
    assert np.array_equal(decode_own(coeffs), _pil_rgb(data))


@pytest.mark.parametrize("dpi,quality", [(150, 70), (100, 80)])
def test_encoder_matches_pil_on_a_text_page(dpi, quality):
    page = render_text_page("Quarterly revenue, AV office affluent\n\n" + "supplier invoice " * 40, dpi)
    data, coeffs = encode_jpeg(page, quality)
    assert data == _pil_jpeg(Image.fromarray(page), quality=quality)
    assert np.array_equal(decode_own(coeffs), _pil_rgb(data))


# --------------------------------------------------------- upload decoder

_CASES = {
    "420": dict(size=(61, 45), mode="RGB", kw=dict(quality=85, subsampling=2)),
    "422": dict(size=(40, 37), mode="RGB", kw=dict(quality=90, subsampling=1)),
    "444": dict(size=(33, 50), mode="RGB", kw=dict(quality=75, subsampling=0)),
    "gray": dict(size=(47, 29), mode="L", kw=dict(quality=80)),
    "restart": dict(size=(64, 71), mode="RGB", kw=dict(quality=80, restart_marker_blocks=3)),
    "restart_gray": dict(size=(50, 41), mode="L", kw=dict(quality=70, restart_marker_rows=1)),
    "optimized": dict(size=(35, 66), mode="RGB", kw=dict(quality=95, optimize=True)),
    "tiny": dict(size=(3, 2), mode="RGB", kw=dict(quality=80)),
}


PAGE_TEXT = "Quarterly revenue AV office affluent\n\nsupplier invoice renewal clause, Tyo WAVE fi ffl " * 6


def write_decoder_fixtures(path: Path = FIXTURE) -> Path:
    """The decoder cases (needs PIL): seeded images saved by Pillow, with
    the sha256 of Pillow's decode (`convert("RGB")` bytes); and the sha256
    of the reference's q70 payload of a 150 dpi text page (render,
    LANCZOS to 1024 wide, encode), which `chip_smoke.py` recomputes with
    the port on the card's machine."""
    from morphik_core_tpu.parser.pdf import _render_text_page
    from morphik_core_tpu.parser.raster_pool import _finish_page

    arrays = {}
    for i, (name, case) in enumerate(_CASES.items()):
        h, w = case["size"]
        px = _pixels("smooth", h, w, case["mode"] == "L", 100 + i)
        data = _pil_jpeg(Image.fromarray(px), **case["kw"])
        arrays[f"{name}_jpeg"] = np.frombuffer(data, np.uint8)
        arrays[f"{name}_sha256"] = np.array(hashlib.sha256(_pil_rgb(data).tobytes()).hexdigest())
    payload = _finish_page(0, _render_text_page(PAGE_TEXT, 150), 1024, None)[1]
    arrays["page_text"] = np.array(PAGE_TEXT)
    arrays["page_q70_sha256"] = np.array(hashlib.sha256(payload).hexdigest())
    np.savez_compressed(path, **arrays)
    return Path(path)


def test_page_payload_matches_the_committed_hash():
    """The port's q70 payload of the fixture's text page (render, LANCZOS,
    encode) hashes as the reference's did when the fixture was made."""
    from morphik_core_tpu_torch.parser import raster_pool

    z = np.load(FIXTURE)
    page = render_text_page(str(z["page_text"]), 150)
    payload = raster_pool._finish_page(0, page, 1024, None)[1]
    assert hashlib.sha256(payload).hexdigest() == str(z["page_q70_sha256"])


def test_decoder_fixtures_are_current(tmp_path):
    """Regenerated now, the committed cases are byte-equal."""
    fresh = np.load(write_decoder_fixtures(tmp_path / "cases.npz"))
    committed = np.load(FIXTURE)
    assert sorted(fresh.files) == sorted(committed.files)
    for k in committed.files:
        assert np.array_equal(fresh[k], committed[k]), k


@pytest.mark.parametrize("name", list(_CASES))
def test_decoder_matches_pil_on_committed_fixtures(name):
    z = np.load(FIXTURE)
    data = z[f"{name}_jpeg"].tobytes()
    got = decode_jpeg(data)
    assert hashlib.sha256(got.tobytes()).hexdigest() == str(z[f"{name}_sha256"])
    assert np.array_equal(got, _pil_rgb(data))
    px, mode = read_jpeg(data)
    assert mode == Image.open(io.BytesIO(data)).mode


@pytest.mark.parametrize("kind,feature", [("progressive", "progressive"), ("cmyk", "CMYK")])
def test_decoder_refuses_what_it_does_not_read(kind, feature):
    img = Image.fromarray(_pixels("smooth", 40, 40, False, 7))
    data = _pil_jpeg(img, progressive=True) if kind == "progressive" else _pil_jpeg(img.convert("CMYK"))
    with pytest.raises(UnsupportedJpeg, match=f"{feature}.*ROADMAP Queue 1 item 3b-ii"):
        decode_jpeg(data)


# ----------------------------------------------------- LANCZOS and modes


def _png(img: Image.Image) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA", "P"])
def test_lanczos_and_mode_rules_match_pil(mode):
    """`Image.resize` to 1024 wide (LANCZOS; NEAREST for P; RGBA and LA
    premultiplied) then `convert("RGB")`, on the pixels `read_png` holds."""
    rng = np.random.default_rng(len(mode))
    rgb = _pixels("smooth", 233, 1311, False, len(mode))
    img = Image.fromarray(rgb)
    if mode == "P":
        img = img.quantize(colors=120)
    elif mode in ("RGBA", "LA"):
        alpha = rng.choice(np.array([0, 1, 17, 128, 254, 255], np.uint8), size=rgb.shape[:2])
        img = img.convert(mode[:-1]).convert(mode)
        img.putalpha(Image.fromarray(alpha))
    else:
        img = img.convert(mode)
    pixels, got_mode, palette = read_png(_png(img))
    assert got_mode == img.mode
    for size in [(int(233 * 1024 / 1311), 1024), (97, 500)]:
        want = np.asarray(img.resize(size[::-1], Image.Resampling.LANCZOS).convert("RGB"))
        assert np.array_equal(to_rgb_u8(resize_mode_u8(pixels, got_mode, size), got_mode, palette), want), size
