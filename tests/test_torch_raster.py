"""The port's page rasters against the JAX package (its PIL code is the
oracle), on the CPU. Tolerance: exact (bytes and uint8 pixels), except
where stated.

- `render_text_page` equals the reference's `_render_text_page` pixel for
  pixel at dpi 150 and 100: kerning pairs, ligatures (across a soft
  hyphen too), wrapping, blank lines, the empty page and seeded Latin-1
  text; the committed glyph atlas is what the generator makes now.
- `rasterize_pdf` and `RasterPool.rasterize_pdf_jpegs(prep=...)` equal
  the reference's pages and tuples, inline and with a two-process pool,
  whose children never import torch.
- `_create_chunks_multivector` equals the reference's chunks for PNG (each
  mode), JPEG, PPTX and DOCX: the same q80 payload bytes and metadata.
- A 40-page PDF ingest holds at most `ingest_embed_prefetch + 1` store
  batches of rastered pages, and stores what an unbounded run stores.
"""

import asyncio
import io
import types
import uuid
import zipfile
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from morphik_core_tpu.parser.pdf import _render_text_page, rasterize_pdf as j_rasterize_pdf
from morphik_core_tpu.parser.raster_pool import RasterPool as JRasterPool
from morphik_core_tpu.services.ingestion_service import IngestionService as JIngestionService
from morphik_core_tpu_torch.config import Settings
from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel as TModel
from morphik_core_tpu_torch.models.schemas import AuthContext
from morphik_core_tpu_torch.parser import raster_pool, text_render
from morphik_core_tpu_torch.parser.pdf import rasterize_pdf
from morphik_core_tpu_torch.parser.raster_pool import RasterPool
from morphik_core_tpu_torch.parser.text_render import CHARSET, render_text_page, write_glyph_atlas
from morphik_core_tpu_torch.services.ingestion_service import IngestionService
from morphik_core_tpu_torch.services_init import build_services

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "tiny_colqwen.npz"
PREP = (3136, 602112)


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _text_pdf(pages) -> bytes:
    """A born-digital PDF, one FlateDecode content stream per page."""
    objs = [b"1 0 obj<</Type/Catalog/Pages 2 0 R>>endobj\n",
            f"2 0 obj<</Type/Pages/Kids[{' '.join(f'{3 + 2 * i} 0 R' for i in range(len(pages)))}]"
            f"/Count {len(pages)}>>endobj\n".encode()]
    for i, text in enumerate(pages):
        objs.append(f"{3 + 2 * i} 0 obj<</Type/Page/Parent 2 0 R/Contents {4 + 2 * i} 0 R>>endobj\n".encode())
        esc = text.encode("latin-1").replace(b"\\", b"\\\\").replace(b"(", b"\\(").replace(b")", b"\\)")
        comp = zlib.compress(b"BT /F1 12 Tf 72 720 Td (" + esc + b") Tj ET")
        objs.append(f"{4 + 2 * i} 0 obj<</Length {len(comp)}/Filter/FlateDecode>>stream\n".encode() + comp
                    + b"\nendstream endobj\n")
    return b"%PDF-1.4\n" + b"".join(objs) + b"trailer<</Root 1 0 R>>\n%%EOF"


_WORDS = ["office", "affluent", "shuffle", "fi", "ffl", "f\xadi", "AV", "A\xadV", "WAVE", "Tyo", "To", "LT",
          "P.O.", "Yo,", "quarterly", "revenue", "naïve", "Œuvre", "façade", "§3", "«déjà»", "½"]


def _seeded_text(seed: int) -> str:
    rng = np.random.default_rng(seed)
    latin1 = [chr(c) for c in range(0x20, 0x100) if c != 0x7F]
    lines = []
    for _ in range(int(rng.integers(5, 60))):
        if rng.random() < 0.15:
            lines.append("")
            continue
        words = [str(rng.choice(_WORDS)) if rng.random() < 0.4 else "".join(rng.choice(latin1, int(rng.integers(1, 9))))
                 for _ in range(int(rng.integers(1, 40)))]
        lines.append(" ".join(words))
    return "\n".join(lines)


RENDER_CASES = {
    "kerning_ligatures": "AV WAVE Tyo To LT Yo, P.O.\noffice affluent shuffle fi ffl ff fl f\xadi",
    "wrapping": "supplier invoice renewal clause " * 30,
    "blank_lines": "first\n\n\nsecond after blank lines\n\nthird",
    "empty": "",
    "controls": "tab\there\rcarriage\x0cfeed \x85 end",
    "zero_width": "f\u200ci f\u200di f\u200b\u2060l \u200bAV\u2060V W\u206aA \ufffd office",
    "seeded_latin1_a": _seeded_text(1),
    "seeded_latin1_b": _seeded_text(2),
    "full_page": "\n".join(f"line {i} AV office" for i in range(80)),
}


@pytest.mark.parametrize("dpi", [150, 100])
@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_render_text_page_matches_reference(case, dpi):
    text = RENDER_CASES[case]
    got = render_text_page(text, dpi)
    want = np.asarray(_render_text_page(text, dpi))
    assert got.dtype == np.uint8 and got.shape == want.shape and np.array_equal(got, want)


def test_render_text_page_refuses_what_the_atlas_lacks():
    with pytest.raises(ValueError, match="write_glyph_atlas"):
        render_text_page("x", 300)
    with pytest.raises(ValueError, match="U\\+4E2D.*write_glyph_atlas"):
        render_text_page("中", 150)
    with pytest.raises(ValueError, match="U\\+200F"):  # a bidi mark: raqm would reorder the line
        render_text_page("abc\u200f", 150)
    assert "\n" not in CHARSET


def test_glyph_atlas_is_current(tmp_path):
    """Regenerated now (PIL + fontTools), the committed atlas is equal."""
    fresh = np.load(write_glyph_atlas(tmp_path / "atlas.npz"))
    committed = np.load(text_render.ATLAS_PATH)
    assert sorted(fresh.files) == sorted(committed.files)
    for k in committed.files:
        assert np.array_equal(fresh[k], committed[k]), k


# ------------------------------------------------------------ PDF rasters

PDF_PAGES = ["Quarterly revenue AV office", ".", "", "supplier invoice " * 20, "Tyo WAVE affluent fi"]


@pytest.mark.parametrize("pages", [PDF_PAGES[:3], []])
def test_rasterize_pdf_matches_reference(pages):
    data = _text_pdf(pages)
    got, backend = rasterize_pdf(data, dpi=150)
    want, j_backend = j_rasterize_pdf(data, dpi=150)
    assert backend == j_backend == "textrender" and len(got) == len(want) == max(1, len(pages))
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))


def _same_tuples(got, want):
    assert [t[0] for t in got] == [t[0] for t in want]
    for g, w in zip(got, want):
        assert g[1] == w[1]  # the q70 JPEG bytes
        if len(w) == 5:
            assert g[4] == w[4] and (g[3] is None) == (w[3] is None)
            if w[3] is not None:
                assert tuple(g[3]) == tuple(w[3]) and np.array_equal(g[2], w[2])


@pytest.mark.parametrize("processes,prep", [(1, PREP), (2, PREP), (1, None)])
def test_rasterize_pdf_jpegs_matches_reference(processes, prep):
    data = _text_pdf(PDF_PAGES)
    pool, jpool = RasterPool(processes), JRasterPool(processes)
    try:
        got = _run(pool.rasterize_pdf_jpegs(data, dpi=150, prep=prep))
        want = _run(jpool.rasterize_pdf_jpegs(data, dpi=150, prep=prep))
        _same_tuples(got, want)
        if prep is not None:
            assert [t[4] for t in got] == [False, True, False, False, False]
        if processes > 1:  # the raster children never imported torch (so never made a CUDA context)
            assert pool._pool.submit(eval, "'torch' in __import__('sys').modules").result() is False
    finally:
        pool.shutdown()
        jpool.shutdown()
    assert _run(RasterPool(1).rasterize_pdf_jpegs(b"%PDF-1.4\n%%EOF", prep=PREP)) is None


# ------------------------------------------------- _create_chunks_multivector


def _png(img: Image.Image) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _jpeg(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _upload(kind: str):
    rng = np.random.default_rng(len(kind))
    rgb = np.full((260, 1150, 3), 255, np.uint8)
    for _ in range(8):
        y, x = int(rng.integers(0, 240)), int(rng.integers(0, 1100))
        rgb[y:y + int(rng.integers(5, 60)), x:x + int(rng.integers(5, 300))] = rng.integers(0, 220, 3)
    img = Image.fromarray(rgb)
    if kind.startswith("png_"):
        mode = kind[4:]
        if mode == "P":
            img = img.quantize(colors=60)
        elif mode in ("RGBA", "LA"):
            img = img.convert(mode[:-1]).convert(mode)
            img.putalpha(Image.fromarray(rng.choice(np.array([0, 90, 255], np.uint8), size=rgb.shape[:2])))
        else:
            img = img.convert(mode)
        return "image/png", _png(img), ""
    if kind == "jpeg":
        return "image/jpeg", _jpeg(img, quality=88), ""
    if kind == "jpeg_small_gray":
        return "image/jpeg", _jpeg(img.convert("L").resize((300, 80)), quality=60), ""
    if kind == "pptx":
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as z:
            for i, text in enumerate(["Quarterly revenue", "", "AV office\nsupplier invoice"], start=1):
                runs = "".join(f"<a:p><a:r><a:t>{t}</a:t></a:r></a:p>" for t in text.split("\n"))
                z.writestr(f"ppt/slides/slide{i}.xml", '<p:sld xmlns:a="http://schemas.openxmlformats.org/'
                           f'drawingml/2006/main" xmlns:p="p"><a:txBody>{runs}</a:txBody></p:sld>')
        return "application/vnd.openxmlformats-officedocument.presentationml.presentation", buf.getvalue(), ""
    text = "\n\n".join(f"Paragraph {i}: office affluent revenue, AV WAVE." * 3 for i in range(40))
    return "application/vnd.openxmlformats-officedocument.wordprocessingml.document", b"", text


@pytest.mark.parametrize("kind", ["png_RGB", "png_L", "png_RGBA", "png_LA", "png_P", "jpeg", "jpeg_small_gray",
                                  "pptx", "docx"])
def test_create_chunks_multivector_matches_reference(kind):
    ctype, data, text = _upload(kind)
    settings = types.SimpleNamespace(settings=Settings())
    got = IngestionService._create_chunks_multivector(settings, ctype, data, text)
    want = JIngestionService._create_chunks_multivector(settings, ctype, data, text)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.content == w.content
        assert {k: v for k, v in g.metadata.items() if k != "_jpeg"} == w.metadata


# ------------------------------------------------------- bounded patches


class _SpyEmbedder:
    """Embeds a page from its patches (deterministic, model-free) and
    records how many pages the stream holds at each call."""

    def __init__(self, dim: int):
        self.dim, self.held, self.calls = dim, [], 0
        self.stream = None

    def embed_for_ingestion_sync(self, chunks):
        self.calls += 1
        if self.stream is not None and self.stream._sem is not None:
            self.held.append(self.stream._sem_size - self.stream._sem._value)
        out = []
        for c in chunks:
            patches, _ = c.metadata.pop("_patches")
            x = patches.reshape(-1, 4, patches.shape[1])[:, :, : self.dim].mean(axis=1).astype(np.float32) - 100.0
            out.append(x / np.linalg.norm(x, axis=1, keepdims=True))
        return out, []


def _ingest_long_pdf(tmp_path: Path, name: str, prefetch: int, monkeypatch):
    raw = {
        "storage": {"storage_path": str(tmp_path / name / "storage")},
        "database": {"path": str(tmp_path / name / "db.sqlite")},
        "vector_store": {"fde_num_repetitions": 4, "fde_num_simhash_projections": 3, "fde_projection_dimension": 8},
        "telemetry": {"telemetry_dir": str(tmp_path / name / "logs" / "telemetry")},
        "model": {"matmul_precision": "bf16"},
        "pdf": {"colpali_pdf_dpi": 100},
        "worker": {"raster_processes": 4, "colpali_store_batch_size": 4, "ingest_embed_prefetch": prefetch},
    }
    services = build_services(Settings.from_dict(raw), colqwen_model=TModel.from_fixture(FIXTURE, device="cpu"),
                              device="cpu")
    svc = services.ingestion_service
    spy = _SpyEmbedder(services.colpali_embedding_model.embedding_dim)
    svc.colpali_embedding_model = spy
    real_init = raster_pool.PageStream.__init__

    def spy_init(stream, executor, texts, dpi, max_width, prep, window):
        real_init(stream, executor, texts, dpi, max_width, prep, window)
        stream._sem_size = window
        spy.stream = stream

    monkeypatch.setattr(raster_pool.PageStream, "__init__", spy_init)
    texts = [f"page {i} quarterly revenue AV office" if i % 9 else "." for i in range(40)]
    ids = iter(range(1, 100))
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(ids)))
    auth = AuthContext(entity_id="dev", permissions={"read", "write"})

    async def go():
        await services.initialize()
        doc = await svc.ingest_file_content(_text_pdf(texts), "long.pdf", {}, auth)
        doc = await svc.process_ingestion_job(doc.external_id, auth)
        chunks = await services.colpali_vector_store.get_chunks_by_id(
            [(doc.external_id, n) for n in range(40)], app_id=auth.app_id)
        await services.shutdown()
        return doc, chunks

    doc, chunks = _run(go())
    monkeypatch.undo()
    return doc, chunks, spy


def test_long_pdf_holds_a_bounded_number_of_pages(tmp_path, monkeypatch):
    """40 pages (5 blank), store batches of 4, prefetch 1: at most 8 pages
    rastered and not yet embedded at any embed call; the stored chunks,
    ids and embeddings equal an unbounded run's (prefetch 20: 84 pages)."""
    doc, chunks, spy = _ingest_long_pdf(tmp_path, "bounded", 1, monkeypatch)
    assert spy.calls == 9 and max(spy.held) <= 8 and len(spy.held) == 9
    assert doc.system_metadata["page_count"] == 35 and len(chunks) == 35
    assert [c.metadata["page"] for c in chunks] == [i for i in range(40) if i % 9]
    doc2, chunks2, spy2 = _ingest_long_pdf(tmp_path, "unbounded", 20, monkeypatch)
    assert doc2.chunk_ids == doc.chunk_ids and max(spy2.held) > 8
    for a, b in zip(chunks, chunks2):
        assert (a.document_id, a.chunk_number, a.content, a.metadata) == (b.document_id, b.chunk_number,
                                                                           b.content, b.metadata)
        assert np.array_equal(np.asarray(a.embedding), np.asarray(b.embedding))
