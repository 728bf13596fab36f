"""The port's remote parser (`parser.parser_mode="api"`), its OCR engines
(`parser.ocr_mode`) and the deep-parse rung against the JAX package's,
on the CPU, through the local fake parse and OCR endpoints of
`morphik_core_tpu_torch/scripts/fake_providers.py`.

- Parse API: with `uuid4` fixed, both packages send byte-identical
  multipart bodies (the filename stripped of CR/LF/quotes/backslashes and
  cut to 255 characters, the bearer key) after the closed endpoint
  fails; text files bypass the endpoints; `ParseAPIError` when all fail.
- `ApiOCR`: the same URL (`?` or `&` before `tables=true`), PNG pixels and
  answer in both.
- The deep rung: a blank scanned PDF (and a PNG) OCRed page by page gives
  the same text and metadata in both; without an engine ({}, "").
- The ingestion ladder on a port server: a scanned PDF becomes
  searchable through `CallableOCR`, `ApiOCR` with tables and a fake
  `pytesseract`, and stays unsearchable without OCR; on `ParseAPIError` a
  PDF with ColPali on goes on image-only with `parse_error`, and an XLSX
  (or a PDF with `use_colpali=false`) fails.
- `get_ocr_engine`: each mode, and the probe's log lines, as the reference.
"""

import asyncio
import io
import logging
import socket
import sys
import types
import uuid
import zipfile
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from morphik_core_tpu.config import Settings as JSettings
from morphik_core_tpu.models.schemas import AuthContext as JAuthContext, EntityType as JEntityType
from morphik_core_tpu.parser import morphik_parser as j_parser
from morphik_core_tpu.parser import ocr as j_ocr
from morphik_core_tpu.services_init import build_services as j_build_services
from morphik_core_tpu_torch.config import Settings
from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel
from morphik_core_tpu_torch.models.schemas import AuthContext, EntityType
from morphik_core_tpu_torch.parser import morphik_parser as t_parser
from morphik_core_tpu_torch.parser import ocr as t_ocr
from morphik_core_tpu_torch.parser.pdf import rasterize_pdf
from morphik_core_tpu_torch.scripts.fake_providers import FakeProviders, ocr_answer, parse_answer
from morphik_core_tpu_torch.services_init import build_services
from morphik_core_tpu_torch.utils.image import decode_image
from morphik_core_tpu_torch.utils.png import encode_png

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "tiny_colqwen.npz"
SMALL_FDE = {"fde_num_repetitions": 8, "fde_num_simhash_projections": 4, "fde_projection_dimension": 8}
AUTH = AuthContext(entity_type=EntityType.DEVELOPER, entity_id="dev", permissions={"read", "write", "admin"},
                   user_id="dev")


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def closed_port_url() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return f"http://127.0.0.1:{port}"


def text_pdf(pages) -> bytes:
    objs = [b"1 0 obj<</Type/Catalog/Pages 2 0 R>>endobj\n",
            f"2 0 obj<</Type/Pages/Kids[{' '.join(f'{3 + 2 * i} 0 R' for i in range(len(pages)))}]"
            f"/Count {len(pages)}>>endobj\n".encode()]
    for i, text in enumerate(pages):
        comp = zlib.compress(b"BT /F1 12 Tf 72 720 Td (" + text.encode() + b") Tj ET")
        objs.append(f"{3 + 2 * i} 0 obj<</Type/Page/Parent 2 0 R/MediaBox[0 0 612 792]/Contents {4 + 2 * i} 0 R>>"
                    "endobj\n".encode())
        objs.append(f"{4 + 2 * i} 0 obj<</Length {len(comp)}/Filter/FlateDecode>>stream\n".encode() + comp
                    + b"\nendstream endobj\n")
    return b"%PDF-1.4\n" + b"".join(objs) + b"trailer<</Root 1 0 R>>\n%%EOF"


def blank_pdf(n_pages: int) -> bytes:
    """A scanned PDF: pages without text operators."""
    kids = " ".join(f"{3 + i} 0 R" for i in range(n_pages))
    objs = [b"1 0 obj<</Type/Catalog/Pages 2 0 R>>endobj\n",
            f"2 0 obj<</Type/Pages/Kids[{kids}]/Count {n_pages}>>endobj\n".encode()]
    objs += [f"{3 + i} 0 obj<</Type/Page/Parent 2 0 R/MediaBox[0 0 612 792]>>endobj\n".encode()
             for i in range(n_pages)]
    return b"%PDF-1.4\n" + b"".join(objs) + b"trailer<</Root 1 0 R>>\n%%EOF"


def xlsx() -> bytes:
    ns = 'xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"'
    files = {"xl/workbook.xml": f'<?xml version="1.0"?><workbook {ns}><sheets><sheet name="S" sheetId="1"/>'
                                "</sheets></workbook>",
             "xl/worksheets/sheet1.xml": f'<?xml version="1.0"?><worksheet {ns}><sheetData><row r="1"><c><v>42</v>'
                                         "</c></row></sheetData></worksheet>"}
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for name, text in files.items():
            z.writestr(name, text)
    return buf.getvalue()


@pytest.fixture(scope="module")
def fake():
    with FakeProviders() as f:
        yield f


def _parsers(parser: dict, **kw):
    """Both packages' parsers on the same `[parser]` settings."""
    return {"torch": t_parser.MorphikParser(Settings.from_dict({"parser": parser}), **kw),
            "jax": j_parser.MorphikParser(JSettings.model_validate({"parser": parser}), **kw)}


FILENAMES = {"plain": "doc.pdf", "hostile": 'we"ird\r\nContent-Type: x\\y.pdf', "long": "n" * 300 + ".pdf"}


@pytest.mark.parametrize("name", sorted(FILENAMES))
def test_parse_api_request_matches_reference(fake, monkeypatch, name):
    """The closed endpoint fails, the fake answers; both packages send the
    same bytes (uuid4 fixed) and get the fake's text back."""
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=0x1234))
    parsers = _parsers({"parser_mode": "api", "parse_api_key": "parse-key-1",
                        "parse_api_endpoints": [closed_port_url(), fake.url + "/parse/"]})
    pdf = text_pdf(["Local text that must not be used in api mode."])
    filename = FILENAMES[name]
    sent = {}
    for pkg, parser in parsers.items():
        n = len(fake.requests)
        meta, text = _run(parser.parse_file_to_text(pdf, filename))
        reqs = fake.requests[n:]
        assert len(reqs) == 1 and reqs[0]["path"] == "/parse", reqs
        sent[pkg] = (meta, text, reqs[0]["body"]["raw"], reqs[0]["headers"]["content-type"],
                     reqs[0]["headers"]["authorization"], reqs[0]["body"]["filename"], reqs[0]["body"]["fields"])
    assert sent["torch"] == sent["jax"]
    meta, text, _, ctype, bearer, seen_name, fields = sent["torch"]
    want_name = {"plain": "doc.pdf", "hostile": "we_ird__Content-Type: x_y.pdf", "long": "n" * 255}[name]
    assert seen_name == fields["filename"] == want_name
    assert meta == {} and text == parse_answer(want_name, pdf)
    assert ctype == f"multipart/form-data; boundary=----morphikparse{uuid.UUID(int=0x1234).hex}"
    assert bearer == "Bearer parse-key-1"


def test_parse_api_routes_as_reference(fake):
    """PDF, XLSX and image uploads go to the endpoints; text does not."""
    parsers = _parsers({"parser_mode": "api", "parse_api_endpoints": [fake.url + "/parse"]})
    png, book = encode_png(np.full((8, 8, 3), 200, np.uint8)), xlsx()
    for pkg, parser in parsers.items():
        n = len(fake.requests)
        got = [_run(parser.parse_file_to_text(data, fname)) for data, fname in (
            (b"plain text", "a.txt"), (png, "p.png"), (book, "t.xlsx"), (b"<html><title>T</title>x</html>", "h.html"))]
        assert got == [({}, "plain text"), ({}, parse_answer("p.png", png)), ({}, parse_answer("t.xlsx", book)),
                       ({"title": "T"}, "x")], pkg
        assert [r["body"]["filename"] for r in fake.requests[n:]] == ["p.png", "t.xlsx"]


@pytest.mark.parametrize("endpoints", [["closed"], []])
def test_parse_api_all_down_raises_as_reference(endpoints):
    eps = [closed_port_url() for _ in endpoints]
    errors = {}
    for pkg, parser in _parsers({"parser_mode": "api", "parse_api_endpoints": eps}).items():
        mod = t_parser if pkg == "torch" else j_parser
        with pytest.raises(mod.ParseAPIError) as e:
            _run(parser.parse_file_to_text(text_pdf(["x"]), "doc.pdf"))
        errors[pkg] = str(e.value).split(":")[0]
    assert errors["torch"] == errors["jax"]


@pytest.mark.parametrize("query,tables", [("", True), ("?key=abc", True), ("?key=abc", False), ("", False)])
def test_api_ocr_matches_reference(fake, query, tables):
    rng = np.random.default_rng(7)
    page = rng.integers(0, 256, (23, 31, 3), dtype=np.uint8)
    got = {}
    for pkg, mod in (("torch", t_ocr), ("jax", j_ocr)):
        engine = mod.ApiOCR(f"{fake.url}/ocr{query}", api_key="ocr-key", tables=tables)
        image = page if pkg == "torch" else Image.fromarray(page)
        n = len(fake.requests)
        out = _run(engine.image_to_structured(image))
        text = _run(engine.image_to_text(image))
        reqs = fake.requests[n:]
        got[pkg] = (out, text, [(r["path"], r["body"], r["headers"]["authorization"]) for r in reqs])
    assert got["torch"] == got["jax"]
    out, text, reqs = got["torch"]
    sep = "&" if query else "?"
    assert reqs[0][0] == f"/ocr{query}" + (f"{sep}tables=true" if tables else "")
    assert out == {"text": ocr_answer(page, tables)["text"], "tables": ocr_answer(page, tables).get("tables", [])}
    assert text == out["text"] and reqs[0][2] == "Bearer ocr-key"


def test_deep_parse_matches_reference(fake):
    """A blank two-page scan and a PNG through the fake OCR endpoint: the
    same pages (pixels), text and metadata in both packages."""
    parsers = _parsers({"ocr_mode": "api", "ocr_api_endpoint": fake.url + "/ocr"})
    assert isinstance(parsers["torch"].ocr_engine, t_ocr.ApiOCR) and parsers["torch"].ocr_engine.tables
    png = encode_png(np.random.default_rng(2).integers(0, 256, (40, 30, 3), dtype=np.uint8))
    got = {}
    for pkg, parser in parsers.items():
        n = len(fake.requests)
        out = [_run(parser.parse_file_to_text_deep(blank_pdf(2), "scan.pdf")),
               _run(parser.parse_file_to_text_deep(png, "scan.png")),
               _run(parser.parse_file_to_text_deep(b"plain", "a.txt"))]
        got[pkg] = (out, [r["body"] for r in fake.requests[n:]])
    assert got["torch"] == got["jax"]
    out, bodies = got["torch"]
    assert len(bodies) == 3 and bodies[0] == bodies[1] and bodies[2]["shape"] == [40, 30, 3]
    assert out[0][0] == {"ocr_pages": 2, "ocr_tables": 2} and out[1][0] == {"ocr_pages": 1, "ocr_tables": 1}
    assert out[2] == ({}, "")
    assert out[1][1] == "\n\n".join([ocr_answer(decode_image(png), True)["text"]] + ocr_answer(decode_image(png),
                                                                                               True)["tables"])


def test_deep_parse_without_ocr_returns_empty():
    for parser in _parsers({"ocr_mode": "none"}).values():
        assert parser.ocr_engine is None
        assert _run(parser.parse_file_to_text_deep(blank_pdf(1), "scan.pdf")) == ({}, "")


class _Stub:
    def __init__(self, mode, endpoint=None):
        self.parser = types.SimpleNamespace(ocr_mode=mode, ocr_api_endpoint=endpoint, ocr_api_key="k",
                                            ocr_tables=False)


@pytest.mark.parametrize("mode,endpoint", [("none", None), ("api", None), ("api", "http://ocr/x"),
                                           ("auto", None), ("tesseract", None), ("easyocr", None)])
def test_get_ocr_engine_matches_reference(mode, endpoint, caplog, monkeypatch):
    monkeypatch.setitem(sys.modules, "pytesseract", None)  # absent: the probe fails
    got = {}
    for pkg, mod in (("torch", t_ocr), ("jax", j_ocr)):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=mod.__name__):
            engine = mod.get_ocr_engine(_Stub(mode, endpoint))
        got[pkg] = (type(engine).__name__, getattr(engine, "endpoint", None), getattr(engine, "api_key", None),
                    getattr(engine, "tables", None), [(r.levelname, r.getMessage()) for r in caplog.records])
    assert got["torch"] == got["jax"]
    if mode != "none" and mode != "api" or endpoint is None:
        assert got["torch"][0] == "NoneType"
    if mode in ("api", "tesseract", "easyocr") and got["torch"][0] == "NoneType":
        assert got["torch"][4] and got["torch"][4][0][0] == "WARNING", got


# ------------------------------------------------------------------ ladder


def _raw(root: Path, **sections) -> dict:
    raw = {"storage": {"storage_path": str(root / "storage")}, "database": {"path": str(root / "db.sqlite")},
           "vector_store": {"index_path": str(root / "index"), **SMALL_FDE},
           "telemetry": {"telemetry_dir": str(root / "logs" / "telemetry")},
           "model": {"matmul_precision": "bf16", "embedding_dim": 32}, "morphik": {"enable_colpali": False}}
    for k, v in sections.items():
        raw[k] = {**raw.get(k, {}), **v}
    return raw


class _Node:
    """One package's services on the CPU, on an event loop of their own."""

    def __init__(self, pkg, raw, model=None):
        self.pkg = pkg
        self.loop = asyncio.new_event_loop()
        if pkg == "torch":
            self.services = build_services(Settings.from_dict(raw), colqwen_model=model, device="cpu")
            self.auth = AUTH
        else:
            self.services = j_build_services(JSettings.model_validate(raw))
            self.auth = JAuthContext(entity_type=JEntityType.DEVELOPER, entity_id="dev",
                                     permissions={"read", "write", "admin"}, user_id="dev")
        self.run(self.services.initialize())

    def run(self, coro):
        return self.loop.run_until_complete(coro)

    def ingest(self, data, filename, use_colpali=False):
        """-> the document as stored after its job (which may have failed)."""
        ing = self.services.ingestion_service
        doc = self.run(ing.ingest_file_content(data, filename, {}, self.auth, use_colpali=use_colpali))
        try:
            self.run(ing.process_ingestion_job(doc.external_id, self.auth, use_colpali=use_colpali))
        except Exception:  # noqa: BLE001 — a failed job is an outcome the tests read from the stored document
            pass
        return self.run(self.services.database.get_document(doc.external_id, self.auth))

    def retrieve(self, query, k=1):
        return self.run(self.services.document_service.retrieve_chunks(query, self.auth, k=k, use_colpali=False))

    def close(self):
        self.run(self.services.shutdown())
        self.loop.close()


def _wh(image):
    """(width, height) of a page: an array in the port, a PIL image in the reference."""
    return (image.shape[1], image.shape[0]) if isinstance(image, np.ndarray) else image.size


def _ladder(node, ocr_mod, fake, monkeypatch):
    """Scans through no engine, CallableOCR, ApiOCR with tables and a fake
    pytesseract -> per document (status, unsearchable, additional
    metadata, the top text retrieve's content and whether it is the document)."""
    parser = node.services.ingestion_service.parser
    fake_tess = types.ModuleType("pytesseract")
    fake_tess.image_to_string = lambda image: "TESS {}x{} turbine".format(*_wh(image))
    monkeypatch.setitem(sys.modules, "pytesseract", fake_tess)
    engines = [(None, None),
               (ocr_mod.CallableOCR(lambda img: "dilithium crystal maintenance {}x{}".format(*_wh(img))),
                "dilithium maintenance"),
               (ocr_mod.ApiOCR(fake.url + "/ocr", tables=True), "page digest"),
               (ocr_mod.get_ocr_engine(types.SimpleNamespace(parser=types.SimpleNamespace(ocr_mode="tesseract"))),
                "TESS turbine")]
    log = []
    for i, (engine, query) in enumerate(engines):
        parser.ocr_engine = engine
        doc = node.ingest(blank_pdf(1), f"scan{i}.pdf")
        top = node.retrieve(query)[0] if query else None
        log.append((type(engine).__name__, doc.system_metadata["status"], doc.system_metadata.get("unsearchable"),
                    "deep_parse" in doc.system_metadata["phase_times"], doc.additional_metadata,
                    top and (top.content, top.document_id == doc.external_id)))
    return log


def test_ladder_ocr_engines_make_a_scan_searchable_as_reference(fake, monkeypatch, tmp_path):
    logs = {}
    for pkg, ocr_mod in (("torch", t_ocr), ("jax", j_ocr)):
        node = _Node(pkg, _raw(tmp_path / pkg))
        try:
            assert node.services.ingestion_service.parser.ocr_engine is None
            logs[pkg] = _ladder(node, ocr_mod, fake, monkeypatch)
        finally:
            node.close()
    assert logs["torch"] == logs["jax"]
    table = ocr_answer(rasterize_pdf(blank_pdf(1), 150)[0][0], True)  # the page as the deep rung renders it
    assert logs["torch"] == [
        ("NoneType", "completed", True, True, {"page_count": 1}, None),
        ("CallableOCR", "completed", None, True, {"page_count": 1, "ocr_pages": 1},
         ("dilithium crystal maintenance 1275x1650", True)),
        ("ApiOCR", "completed", None, True, {"page_count": 1, "ocr_pages": 1, "ocr_tables": 1},
         (table["text"] + "\n\n" + table["tables"][0], True)),
        ("TesseractOCR", "completed", None, True, {"page_count": 1, "ocr_pages": 1}, ("TESS 1275x1650 turbine", True)),
    ]


def test_ladder_on_parse_api_error(tmp_path):
    """Every parse endpoint down: a PDF with ColPali on is stored
    image-only with the reference's `parse_error`; an XLSX, and a PDF with
    use_colpali=false, fail."""
    dead = closed_port_url()
    n = _Node("torch", _raw(tmp_path, parser={"parser_mode": "api", "parse_api_endpoints": [dead]},
                            morphik={"enable_colpali": True}), ColQwenModel.from_fixture(FIXTURE, device="cpu"))
    try:
        pdf = text_pdf(["quarterly revenue grew", "signature page"])
        with pytest.raises(j_parser.ParseAPIError) as ref_err:
            _run(j_parser.MorphikParser(JSettings.model_validate(
                {"parser": {"parser_mode": "api", "parse_api_endpoints": [dead]}})).parse_file_to_text(pdf, "r.pdf"))
        doc = n.ingest(pdf, "r.pdf", use_colpali=True)
        assert doc.system_metadata["status"] == "completed" and doc.system_metadata["page_count"] == 2
        assert doc.additional_metadata == {"parse_error": str(ref_err.value)}
        for data, fname, colpali in ((xlsx(), "t.xlsx", True), (pdf, "r2.pdf", False)):
            doc = n.ingest(data, fname, use_colpali=colpali)
            assert doc.system_metadata["status"] == "failed", doc.system_metadata
            assert doc.system_metadata["error"].startswith("all parse API endpoints failed")
    finally:
        n.close()
