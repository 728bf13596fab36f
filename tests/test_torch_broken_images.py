"""Broken image uploads split as the reference splits them: Pillow fails
either in `Image.open` (the sniff, the plugin's `_open`; for PNG its
chunks up to IDAT, so the text limits there) or in `load`. Where
`Image.open` fails, the reference's `_create_chunks_multivector` logs
and stores no page and its job completes (unsearchable without text);
where `load` fails, the job fails. The port's `utils/image.py::
open_image` is the first stage and `read_image` the whole; its
`_create_chunks_multivector` follows the reference.

Each case asks Pillow which stage raises, then runs the reference's and
the port's `_create_chunks_multivector` on the same bytes: both give no
chunk, or both raise. The files: every decoded format truncated at
seeded offsets within its headers, a PNG zTXt chunk past
`MAX_TEXT_CHUNK` before IDAT (open) and after it (load), JPEG 2000 files
that fail only at load, a decompression bomb, and bytes no plugin
identifies. Then the port's service on the CPU: the job's status and
rows for an open failure, unidentified bytes and a load failure.
"""

import asyncio
import io
import struct
import types
import warnings
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from morphik_core_tpu.services.ingestion_service import IngestionService as JIngestionService
from morphik_core_tpu_torch.config import Settings
from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel as TModel
from morphik_core_tpu_torch.models.schemas import AuthContext
from morphik_core_tpu_torch.services.ingestion_service import IngestionService, check_upload
from morphik_core_tpu_torch.services_init import build_services
from morphik_core_tpu_torch.utils.image import open_image, read_image

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
MODEL = FIXTURES / "tiny_colqwen.npz"
# one file of each decoded format: (fixture, key)
FORMATS = [("image_formats", "bmp8_bmp"), ("image_formats", "bmp24_bmp"), ("image_formats", "page_gif"),
           ("image_formats", "g4_tif"), ("image_formats", "lzw_tif"), ("image_formats", "lossy_webp"),
           ("image_formats", "lossless_webp"), ("image_formats", "cmyk_jpg"), ("image_formats_more", "page_ppm"),
           ("image_formats_more", "page16_pgm"), ("image_formats_more", "icon_ico"),
           ("image_formats_more", "cursor_cur"), ("image_formats_more", "page_psd"),
           ("image_formats_more", "page_pcx"), ("image_formats_more", "pages_dcx"),
           ("image_formats_more", "page_tga"), ("image_formats_more", "page_sgi"),
           ("image_formats_more", "page_ras"), ("image_formats_more", "page_qoi"),
           ("image_formats_more", "page_xbm"), ("image_formats_more", "page_xpm"),
           ("image_formats_jp2", "page_jp2"), ("image_formats_jp2", "page_j2k"), ("image_formats_htj2k", "page_jph")]
CUTS = 4   # header offsets a file, seeded, beside a cut in the signature


def _pil_bytes(fmt: str, mode: str) -> bytes:
    rng = np.random.default_rng(len(fmt) + len(mode))
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)).convert(mode).save(buf, fmt)
    return buf.getvalue()


def _png_chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def _ztxt_past_limit(before_idat: bool) -> bytes:
    png = _pil_bytes("PNG", "L")
    ztxt = _png_chunk(b"zTXt", b"comment\0\0" + zlib.compress(b"a" * (1024 * 1024 + 10)))
    at = png.index(b"IDAT" if before_idat else b"IEND") - 4
    return png[:at] + ztxt + png[at:]


def _bomb() -> bytes:
    big = 1 << 14   # 16384 x 16384 > 2 * Image.MAX_IMAGE_PIXELS
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", big, big, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(b"\x00")) + _png_chunk(b"IEND", b""))


def _cases():
    cases = {}
    files = {key: np.load(FIXTURES / f"{fix}.npz")[key].tobytes() for fix, key in FORMATS}
    files["png"], files["jpeg"] = _pil_bytes("PNG", "RGB"), _pil_bytes("JPEG", "RGB")
    for k, (name, data) in enumerate(sorted(files.items())):
        rng = np.random.default_rng(k)
        cuts = rng.choice(np.arange(3, min(len(data) - 1, 256)), CUTS, replace=False).tolist()
        for cut in sorted(cuts) + [2]:   # and within the signature
            cases[f"{name}_cut_{cut}"] = ("image/" + name.rsplit("_", 1)[-1], data[:cut])
    z = np.load(FIXTURES / "image_formats_jp2.npz")
    cases["jp2_codestream_ends_in_its_tiles"] = ("image/jp2", z["page_jp2"].tobytes()[:30000])
    cases["ht_j2k_openjpeg_fails"] = ("image/jp2", z["page_ht_j2k"].tobytes())
    cases["png_ztxt_past_limit_before_idat"] = ("image/png", _ztxt_past_limit(True))
    cases["png_ztxt_past_limit_after_idat"] = ("image/png", _ztxt_past_limit(False))
    cases["png_decompression_bomb"] = ("image/png", _bomb())
    cases["unidentified_bytes"] = ("image/png", b"\x00" * 64)
    cases["svg"] = ("image/svg+xml", b'<?xml version="1.0"?><svg xmlns="http://www.w3.org/2000/svg"></svg>')
    return cases


CASES = _cases()


def pillow_stage(data: bytes):
    """Where Pillow fails on these bytes: "open", "load" or None."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            im = Image.open(io.BytesIO(data))
        except Exception:  # noqa: BLE001
            return "open"
        try:
            im.load()
        except Exception:  # noqa: BLE001
            return "load"
    return None


def _chunks(cls, ctype: str, data: bytes):
    """-> the chunks, or the exception `_create_chunks_multivector` raised."""
    this = types.SimpleNamespace(settings=Settings())
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return cls._create_chunks_multivector(this, ctype, data, "")
    except Exception as e:  # noqa: BLE001
        return e


@pytest.mark.parametrize("case", sorted(CASES))
def test_broken_upload_takes_the_references_stage(case):
    ctype, data = CASES[case]
    stage = pillow_stage(data)
    want = _chunks(JIngestionService, ctype, data)
    got = _chunks(IngestionService, ctype, data)
    if stage == "open":   # the reference logs and stores no page
        assert want == [] and got == [], (want, got)
        with pytest.raises(Exception):
            open_image(data)
    elif stage == "load":   # the reference's job fails
        assert isinstance(want, Exception) and isinstance(got, Exception), (want, got)
        open_image(data)
    else:
        assert not isinstance(want, Exception) and not isinstance(got, Exception)
        assert [c.content for c in got] == [c.content for c in want]
    check_upload(ctype, data)   # no 415: the job decides


def test_cases_cover_both_stages():
    stages = {case: pillow_stage(data) for case, (_, data) in CASES.items()}
    assert stages["png_ztxt_past_limit_before_idat"] == "open" and stages["png_ztxt_past_limit_after_idat"] == "load"
    assert stages["ht_j2k_openjpeg_fails"] == "load" and stages["jp2_codestream_ends_in_its_tiles"] == "load"
    assert stages["unidentified_bytes"] == stages["png_decompression_bomb"] == stages["svg"] == "open"
    for fmt in {c.rsplit("_cut_", 1)[0] for c in CASES if "_cut_" in c}:
        assert any(stages[c] == "open" for c in CASES if c.startswith(fmt + "_cut_")), fmt
    assert sum(s == "load" for s in stages.values()) >= 10


def test_broken_uploads_through_the_service(tmp_path):
    """An upload `Image.open` fails on completes with no page and no
    chunk (unsearchable: no text either), unidentified bytes too; one only
    `load` fails fails its job. The reference's job ends the same way on
    the same bytes (`test_broken_upload_takes_the_references_stage`)."""
    raw = {"storage": {"storage_path": str(tmp_path / "storage")}, "database": {"path": str(tmp_path / "db.sqlite")},
           "vector_store": {"fde_num_repetitions": 4, "fde_num_simhash_projections": 3, "fde_projection_dimension": 8,
                            "index_path": str(tmp_path / "index")},
           "telemetry": {"telemetry_dir": str(tmp_path / "logs" / "telemetry")}, "model": {"matmul_precision": "bf16"}}
    services = build_services(Settings.from_dict(raw), colqwen_model=TModel.from_fixture(MODEL, device="cpu"),
                              device="cpu")
    svc = services.ingestion_service
    auth = AuthContext(entity_id="dev", permissions={"read", "write"})
    uploads = {"cut": ("p.png", CASES["png_ztxt_past_limit_before_idat"][1]),
               "unidentified": ("u.png", CASES["unidentified_bytes"][1]),
               "load": ("l.jp2", CASES["ht_j2k_openjpeg_fails"][1])}

    async def go():
        await services.initialize()
        out = {}
        for kind, (name, data) in uploads.items():
            doc = await svc.ingest_file_content(data, name, {}, auth, use_colpali=True)
            try:
                await svc.process_ingestion_job(doc.external_id, auth, use_colpali=True)
            except Exception:  # noqa: BLE001 — a failed job is read from the stored document
                pass
            out[kind] = await services.database.get_document(doc.external_id, auth)
        await services.shutdown()
        return out

    loop = asyncio.new_event_loop()
    try:
        docs = loop.run_until_complete(go())
    finally:
        loop.close()
    for kind in ("cut", "unidentified"):
        meta = docs[kind].system_metadata
        assert meta["status"] == "completed" and meta.get("unsearchable") is True, meta
        assert docs[kind].chunk_ids == [] and not meta.get("page_count")
    assert docs["load"].system_metadata["status"] == "failed", docs["load"].system_metadata
    assert docs["load"].chunk_ids == []
