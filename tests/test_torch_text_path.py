"""The port's text path against the JAX package's, on the CPU.

- Parsers: the same chunks from the recursive splitter (ASCII text, which
  the JAX package hands to its native library when it loads, and
  non-ASCII text), `clean_control_chars`, `html_to_text`, `XMLChunker`
  (the JAX side with tiktoken off, as the card's machine has none),
  docx/xlsx/pptx text, PDF text and tables, and
  `MorphikParser.parse_file_to_text` for each content type.
- `HashingEmbeddingModel`: bit-identical vectors.
- The text store: the same store / upsert / delete / query calls give
  the same ids, scores within 1e-6 on the host path and 1e-5 on the
  device branch (`DEVICE_SCAN_MIN_ROWS` patched to 1 in both modules);
  only the appended tail is uploaded; `save` writes byte-identical files
  and each package opens the other's. Also the JAX package's own store
  tests (`tests/test_text_vector_store.py`), run against the port.
- Rerankers: identical `OverlapReranker` scores; `ColQwenReranker` on
  the fixture model (the same params in both) gives the same order,
  scores within 5e-4, with `use_kernel` either way (on the CPU both run
  K2's plain version).
"""

import asyncio
import io
import json
import random
import zipfile
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import morphik_core_tpu.vector_store.text_vector_store as j_tvs
import morphik_core_tpu_torch.vector_store.text_vector_store as t_tvs
from morphik_core_tpu.config import Settings as JSettings
from morphik_core_tpu.embedding.colpali_embedding_model import ColpaliEmbeddingModel as JEmbedder
from morphik_core_tpu.embedding.text_embedding import HashingEmbeddingModel as JHashing
from morphik_core_tpu.models import schemas as js
from morphik_core_tpu.models.colqwen import ColQwenModel as JModel
from morphik_core_tpu.parser import html_text as j_html, office as j_office, pdf as j_pdf, table_detect as j_tables
from morphik_core_tpu.parser import xml_chunker as j_xml
from morphik_core_tpu.parser.morphik_parser import MorphikParser as JParser
from morphik_core_tpu.parser.text_splitter import RecursiveCharacterTextSplitter as JSplitter
from morphik_core_tpu.reranker.rerankers import ColQwenReranker as JColQwenReranker, OverlapReranker as JOverlap
from morphik_core_tpu.utils import fast_ops as j_fast
from morphik_core_tpu_torch.config import Settings
from morphik_core_tpu_torch.embedding.colpali_embedding_model import ColpaliEmbeddingModel
from morphik_core_tpu_torch.embedding.text_embedding import HashingEmbeddingModel
from morphik_core_tpu_torch.models import schemas as ts
from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel as TModel
from morphik_core_tpu_torch.parser import html_text as t_html, office as t_office, pdf as t_pdf, table_detect as t_tables
from morphik_core_tpu_torch.parser import xml_chunker as t_xml
from morphik_core_tpu_torch.parser.morphik_parser import MorphikParser
from morphik_core_tpu_torch.parser.text_splitter import RecursiveCharacterTextSplitter
from morphik_core_tpu_torch.reranker.rerankers import ColQwenReranker, OverlapReranker, build_reranker
from morphik_core_tpu_torch.utils.fast_ops import clean_control_chars

torch.set_num_threads(2)

FIXTURE = Path(__file__).parent / "fixtures" / "tiny_colqwen.npz"


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# ------------------------------------------------------------- splitter

# the edge cases of tests/test_parser.py:30-67 (text, chunk_size, chunk_overlap)
SPLIT_CASES = {
    "budget": ("para one.\n\n" + ("word " * 500) + "\n\nlast para.", 200, 20),
    "short": ("hello", 100, 10),
    "empty": ("", 100, 10),
    "sentences": ("s1. s2. s3. " * 100, 64, 0),
    "long_pieces": (("a" * 90 + " ") * 10, 100, 20),
    "small_pieces": (("word " * 6) * 30, 100, 20),
    "char_slices": ("Z" * 950 + " tail", 120, 30),
    "default_budget": ("one two three. " * 1200, 6000, 300),
}


def _non_ascii(text: str) -> str:
    return text.replace("o", "ö").replace("a", "å").replace("Z", "Ж")


@pytest.mark.parametrize("alphabet", ["ascii", "non_ascii"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_splitter_matches_jax(case, alphabet):
    text, size, overlap = SPLIT_CASES[case]
    if alphabet == "non_ascii":
        text = _non_ascii(text)
    want = JSplitter(size, overlap).split_text(text)
    assert RecursiveCharacterTextSplitter(size, overlap).split_text(text) == want
    assert all(len(c) <= size for c in want)


@pytest.mark.parametrize("alphabet", ["ascii", "non_ascii"])
def test_splitter_matches_jax_on_random_corpora(alphabet):
    """The randomized corpora of tests/test_parser.py::test_native_split_text_parity."""
    rng = random.Random(0)
    words = ["alpha", "beta", "gamma", "delta", "x", "longtoken" * 4]
    seps = [" ", " ", " ", ". ", "\n", "\n\n"]
    for trial in range(24):
        text = "".join(rng.choice(words) + rng.choice(seps) for _ in range(rng.randint(50, 1200)))
        if trial % 5 == 0:
            text += "Z" * rng.randint(300, 900)
        if trial % 7 == 0:
            text = "\n\n".join([text[:200]] * 6) + "   "
        if alphabet == "non_ascii":
            text = _non_ascii(text)
        size, overlap = rng.choice([120, 256, 400]), rng.choice([0, 20, 60])
        assert RecursiveCharacterTextSplitter(size, overlap).split_text(text) == JSplitter(size, overlap).split_text(
            text), (trial, size, overlap)


def test_splitter_jax_takes_native_on_ascii():
    """The ASCII cases above compare against the native library's output
    when it is built (held equal to the Python path by the JAX tests)."""
    text = "one two three. " * 1200
    native = j_fast.native_split_text(text, 6000, 300)
    if not j_fast.native_available():
        pytest.skip("the JAX package's native library is not built here")
    assert native == RecursiveCharacterTextSplitter(6000, 300).split_text(text)


# --------------------------------------------------------- text helpers


def test_clean_control_chars_matches_jax():
    text = "ok\x00 tab\tnl\nret\r bell\x07 esc\x1b del\x7f \x0b\x0c\x1f — ünïcödé \U0001f600 end"
    assert clean_control_chars(text) == j_fast.clean_control_chars(text) == j_fast._CTRL_RE.sub("", text)


@pytest.mark.parametrize("dim", [768, 32])
def test_hashing_embedding_bit_identical(dim):
    texts = ["Quarterly revenue grew 12% year over year.", "", "!!!", "the the the the",
             "Unicode: naïve café déjà vu", "x" * 5000 + " tail words here"]
    jm, tm = JHashing(dim), HashingEmbeddingModel(dim)
    for text in texts:
        a, b = jm._embed(text), tm._embed(text)
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes(), text
    jc = [js.Chunk(content=t, metadata={}) for t in texts]
    tc = [ts.Chunk(content=t, metadata={}) for t in texts]
    for a, b in zip(_run(jm.embed_for_ingestion(jc)), _run(tm.embed_for_ingestion(tc))):
        assert a.tobytes() == b.tobytes()
    assert _run(jm.embed_for_query("revenue")).tobytes() == _run(tm.embed_for_query("revenue")).tobytes()


HTML = (b"<!doctype html><html><head><title> Annual  Report </title><style>p{}</style>"
        b"<script>var x=1;</script></head><body><h1>Results</h1><p>Revenue  grew\n by 12%.</p>"
        b"<ul><li>EMEA</li><li>APAC &amp; more</li></ul><table><tr><td>a</td><th>b</th></tr></table>"
        b"<div>caf\xc3\xa9<br>line two</div><noscript>hidden</noscript><svg><text>no</text></svg></body></html>")


def test_html_to_text_matches_jax():
    for data in (HTML, HTML.decode(), b"<p>bad \xff bytes</p>", b"plain text, no tags"):
        assert t_html.html_to_text(data) == j_html.html_to_text(data)
    assert t_html.html_to_text(HTML)[0] == "Annual  Report"


XMLS = {
    "breadcrumbs": """<doc><section id="intro"><p>Hello world.</p></section>
    <section id="body"><item name="a">Content A here.</item>
    <item name="b">Content B here.</item></section></doc>""",
    "big_leaf": f"<doc><p>{'token ' * 1000}</p></doc>",
    "invalid": "not <valid <xml at all",
    "toc_auto_unit": """<filing><toc><line>1. Overview .... 3</line><line>2. Risk .... 9</line></toc>
      <block num="1">Overview text body one.</block><block num="2">Risk factors body two.</block>
      <block num="3">Financials body three.</block></filing>""",
    "first_words": "<doc><section>Quarterly revenue summary for 2024.</section></doc>",
    "mixed_tails": ("<doc><chapter><p>" + "alpha " * 40 + "</p> important tail text here <p>" + "beta " * 40
                    + "</p> closing remark text</chapter></doc>"),
    "fragments": '<?xml version="1.0"?><a x:id="1" xmlns:x="urn:x">one</a><a>two</a>',
}


@pytest.mark.parametrize("max_tokens", [5, 30, 350])
def test_xml_chunker_matches_jax(monkeypatch, max_tokens):
    monkeypatch.setattr(j_xml, "_ENC", None)  # the card's machine has no tiktoken
    for name, xml in XMLS.items():
        try:
            want = j_xml.XMLChunker(max_tokens=max_tokens).chunk(xml)
        except ValueError as e:  # a leaf past a budget of < 11 tokens: overlap 40 >= 4 * max_tokens
            with pytest.raises(ValueError, match=str(e)):
                t_xml.XMLChunker(max_tokens=max_tokens).chunk(xml)
            continue
        assert t_xml.XMLChunker(max_tokens=max_tokens).chunk(xml) == want, name
        assert want


W = 'xmlns:w="http://schemas.openxmlformats.org/wordprocessingml/2006/main"'
A = 'xmlns:a="http://schemas.openxmlformats.org/drawingml/2006/main"'
S = 'xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"'


def _zipbytes(files: dict) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for name, data in files.items():
            z.writestr(name, data)
    return buf.getvalue()


def _office_files():
    """The hand-built OOXML files of tests/test_parser.py:115-146 and :465-485."""
    docx = _zipbytes({"word/document.xml": f"""<?xml version="1.0"?><w:document {W}><w:body>
      <w:p><w:r><w:t>First paragraph.</w:t></w:r></w:p><w:p></w:p>
      <w:p><w:r><w:t>Second </w:t></w:r><w:r><w:t>paragraph.</w:t></w:r></w:p></w:body></w:document>"""})
    slide = f'<?xml version="1.0"?><p:sld xmlns:p="x" {A}><a:t>Title here</a:t><a:t> </a:t><a:t>Bullet</a:t></p:sld>'
    pptx = _zipbytes({"ppt/slides/slide10.xml": slide.replace("Title here", "Slide ten"),
                      "ppt/slides/slide2.xml": slide.replace("Title here", "Slide two"),
                      "ppt/slides/slide1.xml": slide})
    xlsx = _zipbytes({
        "xl/sharedStrings.xml": f'<?xml version="1.0"?><sst {S}><si><t>name</t></si><si><t>alice</t></si></sst>',
        "xl/worksheets/sheet1.xml": f"""<?xml version="1.0"?><worksheet {S}><sheetData>
          <row r="1"><c t="s"><v>0</v></c><c><v>42</v></c></row>
          <row r="2"><c t="s"><v>1</v></c><c><v>7</v></c><c t="s"><v>9</v></c></row></sheetData></worksheet>""",
        "xl/worksheets/sheet2.xml": (
            f'<worksheet {S}><sheetData><row r="1"><c r="A1" t="inlineStr"><is><t>Name</t></is></c>'
            '<c r="C1" t="inlineStr"><is><t>Price</t></is></c></row><row r="2"><c r="AB2"><v>9.5</v></c></row>'
            "</sheetData></worksheet>"),
        "xl/workbook.xml": f'<?xml version="1.0"?><workbook {S}><sheets><sheet name="People" sheetId="1"/></sheets></workbook>',
    })
    return docx, pptx, xlsx


def test_office_text_matches_jax():
    docx, pptx, xlsx = _office_files()
    assert t_office.docx_to_text(docx) == j_office.docx_to_text(docx) == "First paragraph.\n\nSecond paragraph."
    assert t_office.pptx_to_slides(pptx) == j_office.pptx_to_slides(pptx)
    assert t_office.xlsx_to_markdown(xlsx) == j_office.xlsx_to_markdown(xlsx)
    assert t_office.xlsx_to_markdown(xlsx, max_rows=1) == j_office.xlsx_to_markdown(xlsx, max_rows=1)


def make_pdf(pages_text, extra_ops=b""):
    """A minimal PDF with FlateDecode content streams (tests/test_parser.py:152-180)."""
    objs = [b"1 0 obj<</Type/Catalog/Pages 2 0 R>>endobj\n",
            f"2 0 obj<</Type/Pages/Kids[{' '.join(f'{3 + 2 * i} 0 R' for i in range(len(pages_text)))}]"
            f"/Count {len(pages_text)}>>endobj\n".encode()]
    for i, text in enumerate(pages_text):
        objs.append(f"{3 + 2 * i} 0 obj<</Type/Page/Parent 2 0 R/MediaBox[0 0 612 792]/Contents {4 + 2 * i} 0 R>>"
                    "endobj\n".encode())
        ops = b"BT /F1 12 Tf 72 720 Td "
        for j, line in enumerate(text.split("\n")):
            esc = line.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")
            ops += (b"0 -14 Td " if j else b"") + b"(" + esc.encode("latin-1") + b") Tj "
        comp = zlib.compress(ops + b"ET\n" + (extra_ops if i == 0 else b""))
        objs.append(f"{4 + 2 * i} 0 obj<</Length {len(comp)}/Filter/FlateDecode>>stream\n".encode() + comp
                    + b"\nendstream endobj\n")
    return b"%PDF-1.4\n" + b"".join(objs) + b"trailer<</Root 1 0 R>>\n%%EOF"


TABLE_OPS = b"".join(  # tests/test_table_detect.py's grid, one BT..ET run per cell
    f"BT /F1 12 Tf {x} {y} Td ({t}) Tj ET\n".encode()
    for x, y, t in [(72, 600, "Region"), (200, 600, "Revenue"), (320, 600, "Margin"),
                    (72, 584, "EMEA"), (200, 584, "1,204"), (320, 584, "31%"),
                    (72, 568, "APAC"), (200, 568, "987"), (320, 568, "27|%"),
                    (72, 552, "Americas"), (200, 552, "2,441"), (320, 552, "35%")]
) + b"BT /F2 10 Tf 1 0 0 1 50 100 Tm [(arr) -20 (ay) <0041>] TJ T* <feff0041> Tj (oct\\101\\8) ' ET\n"

PDFS = {
    "two_pages": make_pdf(["Hello page one.\nWith a second line.", "Page two content (parens) here."]),
    "table": make_pdf(["Sales by region"], TABLE_OPS),
    "empty_page": make_pdf([""]),
    "not_a_pdf": b"%PDF-1.4\ngarbage without objects",
}


@pytest.mark.parametrize("name", sorted(PDFS))
def test_pdf_text_and_tables_match_jax(name):
    data = PDFS[name]
    assert t_pdf.extract_pages_text(data) == j_pdf.extract_pages_text(data)
    tt, tb = t_pdf.extract_pages_text_and_blocks(data)
    jt, jb = j_pdf.extract_pages_text_and_blocks(data)
    assert tt == jt and [[(b.text, b.bbox, b.size) for b in p] for p in tb] == [
        [(b.text, b.bbox, b.size) for b in p] for p in jb]
    assert t_tables.detect_pdf_tables(data) == j_tables.detect_pdf_tables(data)
    assert t_pdf.page_count(data) == j_pdf.page_count(data)
    if name == "table":
        assert t_tables.detect_pdf_tables(data)[0] and "\\|" in t_tables.detect_pdf_tables(data)[0][0]


def _files():
    docx, pptx, xlsx = _office_files()
    return {
        "a.txt": (b"plain words\r\nwith \x00control\x07 chars", None),
        "notes.md": (b"# Title\n\nSome *markdown* text.\n", "text/markdown"),
        "page.html": (HTML, None),
        "page.htm.txt": (b"  <!DOCTYPE html><html><body><p>sniffed html</p></body></html>", "text/plain"),
        "data.json": (b'{"k": [1, 2, "tr\xc3\xa8s"]}', None),
        "doc.docx": (docx, None),
        "deck.pptx": (pptx, None),
        "book.xlsx": (xlsx, None),
        "broken.xlsx": (b"PK\x03\x04 not really a zip", None),
        "report.pdf": (PDFS["two_pages"], None),
        "table.pdf": (PDFS["table"], None),
        "feed.xml": (XMLS["breadcrumbs"].encode(), None),
        "blob.bin": (bytes(range(256)) * 4, None),
    }


def test_parse_file_to_text_matches_jax():
    jp, tp = JParser(JSettings()), MorphikParser(Settings())
    for name, (data, ctype) in _files().items():
        want = _run(jp.parse_file_to_text(data, name, ctype))
        assert _run(tp.parse_file_to_text(data, name, ctype)) == want, name
        assert jp.is_xml_file(name, ctype) == tp.is_xml_file(name, ctype)
    assert _run(tp.parse_file_to_text_deep(PDFS["empty_page"], "e.pdf")) == _run(
        jp.parse_file_to_text_deep(PDFS["empty_page"], "e.pdf")) == ({}, "")


def test_parser_chunks_match_jax(monkeypatch):
    monkeypatch.setattr(j_xml, "_ENC", None)
    raw = {"parser": {"chunk_size": 300, "chunk_overlap": 30, "xml_max_tokens": 20}}
    jp, tp = JParser(JSettings.model_validate(raw)), MorphikParser(Settings.from_dict(raw))
    text = "Quarterly revenue grew. " * 60 + "\n\nNew paragraph with ünïcode. " * 10
    assert [c.model_dump() for c in _run(tp.split_text(text))] == [c.model_dump() for c in _run(jp.split_text(text))]
    for xml in XMLS.values():
        assert [c.model_dump() for c in tp.parse_and_chunk_xml(xml)] == [
            c.model_dump() for c in jp.parse_and_chunk_xml(xml)]


def test_contextual_chunker_matches_jax():
    async def complete(prompt):
        return "[offline-stub] nothing" if "gamma" in prompt.split("<chunk>")[1] else " situates it "

    raw = {"parser": {"chunk_size": 40, "chunk_overlap": 0, "use_contextual_chunking": True}}
    jp = JParser(JSettings.model_validate(raw), complete_fn=complete)
    tp = MorphikParser(Settings.from_dict(raw), complete_fn=complete)
    text = "alpha words here. beta words there. gamma last words."
    got = [c.content for c in _run(tp.split_text(text))]
    assert got == [c.content for c in _run(jp.split_text(text))] and got[0].startswith("situates it; ")


# ----------------------------------------------------------- text store


def _corpus(n=64, dim=16, seed=0, words=("alpha", "bravo", "charlie", "delta", "echo", "foxtrot")):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    texts = [" ".join(rng.choice(list(words), size=5)) + f" w{i}" for i in range(n)]
    return vecs, texts


def _chunks(pkg, vecs, texts, doc="d"):
    return [pkg.DocumentChunk(document_id=f"{doc}{i // 4}", chunk_number=i % 4, content=texts[i],
                              embedding=list(map(float, v)), metadata={"i": i, "tags": ["x", i]})
            for i, v in enumerate(vecs)]


def _stores(tmp_path=None):
    j = j_tvs.TextVectorStore(path=tmp_path / "j" if tmp_path else None)
    t = t_tvs.TextVectorStore(path=tmp_path / "t" if tmp_path else None, device="cpu")
    return j, t


def _query_both(j, t, q, **kw):
    a = _run(j.query_similar(q, **kw))
    b = _run(t.query_similar(q, **kw))
    return a, b


def _same(a, b, atol):
    assert [(c.document_id, c.chunk_number) for c in a] == [(c.document_id, c.chunk_number) for c in b]
    np.testing.assert_allclose([c.score for c in b], [c.score for c in a], rtol=0, atol=atol)
    assert [c.content for c in a] == [c.content for c in b] and [c.metadata for c in a] == [c.metadata for c in b]


def _sequence(j, t, atol, app_id=None):
    """store / upsert / delete / query, the same calls on both stores."""
    vecs, texts = _corpus()
    vecs2, texts2 = _corpus(n=24, seed=9)
    for store, pkg in ((j, js), (t, ts)):
        ok, ids, _ = _run(store.store_embeddings(_chunks(pkg, vecs, texts), app_id=app_id))
        assert ok and len(ids) == 64
    queries = [(vecs[7] + 0.1, "alpha charlie"), (vecs[40], None), (-vecs[3], "foxtrot w12 zulu"), (vecs[0], "")]
    for q, text in queries:
        for doc_ids in (None, ["d1", "d3", "d9", "nope"]):
            for k in (1, 5, 70):
                _same(*_query_both(j, t, q, k=k, doc_ids=doc_ids, query_text=text, app_id=app_id), atol)
    for store, pkg in ((j, js), (t, ts)):
        _run(store.store_embeddings(_chunks(pkg, vecs2, texts2, doc="x"), app_id=app_id))  # the tail
        upsert = pkg.DocumentChunk(document_id="d0", chunk_number=0, content="zulu yankee",
                                   embedding=list(map(float, -vecs[0])), metadata={})
        _run(store.store_embeddings([upsert], app_id=app_id))
        _run(store.delete_chunks_by_document_id("d2", app_id=app_id))
        _run(store.delete_chunks_by_document_id("x1", app_id=app_id))
    for q, text in queries + [(vecs2[5], "zulu"), (-vecs[0], None)]:
        for doc_ids in (None, ["d2", "x1", "x2", "d0"]):
            a, b = _query_both(j, t, q, k=6, doc_ids=doc_ids, query_text=text, app_id=app_id)
            _same(a, b, atol)
            assert not {c.document_id for c in b} & {"d2", "x1"}
    want = [("d0", 0), ("d2", 1), ("x2", 3), ("x1", 0), ("zz", 0)]
    a = _run(j.get_chunks_by_id(want, app_id=app_id))
    b = _run(t.get_chunks_by_id(want, app_id=app_id))
    assert [c.model_dump() for c in a] == [c.model_dump() for c in b] and [c.document_id for c in b] == ["d0", "x2"]
    return vecs, vecs2


@pytest.mark.parametrize("branch", ["host", "device"])
def test_text_store_matches_jax(monkeypatch, branch):
    """Host path: scores within 1e-6. Device branch (both modules patched
    to scan from one row on): scores within 1e-5."""
    if branch == "device":
        monkeypatch.setattr(j_tvs, "DEVICE_SCAN_MIN_ROWS", 1)
        monkeypatch.setattr(t_tvs, "DEVICE_SCAN_MIN_ROWS", 1)
    j, t = _stores()
    _sequence(j, t, 1e-6 if branch == "host" else 1e-5, app_id="app")
    ns = t._ns_map["app"]
    if branch == "device":
        assert ns.full_uploads == 1 and ns.tail_uploads == 1 and ns.dev_rows == ns.count == 64 + 24 + 1
        assert torch.equal(ns.dev_buf[: ns.count], torch.from_numpy(ns.vectors[: ns.count]))
    else:
        assert ns.dev_buf is None


def test_device_scan_uploads_only_the_tail(monkeypatch):
    monkeypatch.setattr(t_tvs, "DEVICE_SCAN_MIN_ROWS", 1)
    store = t_tvs.TextVectorStore(device="cpu")
    vecs, texts = _corpus(n=40)
    _run(store.store_embeddings(_chunks(ts, vecs, texts)))
    ns = store._ns_map["default"]
    uploads = []
    real = ns._upload
    ns._upload = lambda x: uploads.append(x.shape) or real(x)
    _run(store.query_similar(vecs[3], k=3))
    assert uploads[0] == (1024, 16) and ns.full_uploads == 1  # the whole capacity, once
    vecs2, texts2 = _corpus(n=7, seed=3)
    _run(store.store_embeddings(_chunks(ts, vecs2, texts2, doc="y")))
    uploads.clear()
    top = _run(store.query_similar(vecs2[2], k=1))
    assert top[0].document_id == "y0" and top[0].chunk_number == 2
    assert uploads == [(7, 16), (1024,), (16,)] and ns.full_uploads == 1 and ns.tail_uploads == 1  # tail, mask, q
    uploads.clear()
    _run(store.query_similar(vecs2[2], k=1))
    assert uploads == [(16,)]  # nothing new: the query alone
    _run(store.query_similar(vecs2[2], k=1, doc_ids=["d0"]))
    assert uploads[1:] == [(1024,), (16,)]  # a filter uploads its own mask


@pytest.mark.parametrize("branch", ["host", "device"])
def test_text_store_files_match_jax(tmp_path, monkeypatch, branch):
    """The same calls write byte-identical files; each package opens the
    other's and answers the same."""
    if branch == "device":
        monkeypatch.setattr(j_tvs, "DEVICE_SCAN_MIN_ROWS", 1)
        monkeypatch.setattr(t_tvs, "DEVICE_SCAN_MIN_ROWS", 1)
    j, t = _stores(tmp_path)
    vecs, vecs2 = _sequence(j, t, 1e-5)
    j.save()
    t.save()
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir()) == ["default.rows.json", "default.vectors.npy"]
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    rows = json.loads((tmp_path / "t" / "default.rows.json").read_text())
    assert list(rows["rows"][0]) == ["document_id", "content", "chunk_number", "metadata", "score"]
    t_on_j = t_tvs.TextVectorStore(path=tmp_path / "j", device="cpu")
    j_on_t = j_tvs.TextVectorStore(path=tmp_path / "t")
    for q, text in ((vecs[7], "alpha"), (vecs2[3], None), (-vecs[0], "zulu yankee")):
        for a_store, b_store in ((j, t_on_j), (t, j_on_t)):
            a = _run(a_store.query_similar(q, k=5, query_text=text))
            b = _run(b_store.query_similar(q, k=5, query_text=text))
            _same(a, b, 1e-5)
    assert t_on_j._ns_map["default"].n_alive() == j._ns_map["default"].n_alive() == 64 + 24 + 1 - 1 - 4 - 4


# the JAX package's own store tests (tests/test_text_vector_store.py), run against the port


def _oracle(store, q, query_text, k, hybrid):
    """Brute-force reimplementation of the scoring contract."""
    ns = store._ns_map["default"]
    qn = q / np.linalg.norm(q)
    cos = np.array([ns.vectors[i] @ qn if ns.alive[i] else -np.inf for i in range(ns.count)], dtype=np.float32)
    if hybrid and query_text:
        lex = ns.bm25_candidates(query_text, np.array(ns.alive, bool))
        if lex:
            peak = max(lex.values())
            comb = np.where(np.isfinite(cos), 0.5 * cos, -np.inf)
            for i, s in lex.items():
                comb[i] = 0.5 * cos[i] + 0.5 * s / peak
            cos = comb
    order = np.argsort(-cos)[:k]
    return [(int(i), float(cos[i])) for i in order if np.isfinite(cos[i])]


@pytest.mark.parametrize("force_device", [False, True])
def test_port_query_matches_oracle(monkeypatch, force_device):
    if force_device:
        monkeypatch.setattr(t_tvs, "DEVICE_SCAN_MIN_ROWS", 1)
    store = t_tvs.TextVectorStore(device="cpu")
    vecs, texts = _corpus()
    _run(store.store_embeddings(_chunks(ts, vecs, texts)))
    q = vecs[7] + 0.1
    res = _run(store.query_similar(q, k=5, query_text="alpha charlie"))
    expect = _oracle(store, q.astype(np.float32), "alpha charlie", 5, True)
    got = [(store._ns_map["default"]._id_to_row[f"{c.document_id}-{c.chunk_number}"], c.score) for c in res]
    assert [i for i, _ in got] == [i for i, _ in expect]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in expect], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["tail_update_and_delete", "doc_filter_and_upsert"])
def test_port_device_scan_cases(monkeypatch, case):
    monkeypatch.setattr(t_tvs, "DEVICE_SCAN_MIN_ROWS", 1)
    store = t_tvs.TextVectorStore(device="cpu")
    if case == "tail_update_and_delete":
        vecs, texts = _corpus(n=32)
        _run(store.store_embeddings(_chunks(ts, vecs, texts)))
        assert _run(store.query_similar(vecs[3], k=3))  # warm device buffer
        vecs2, texts2 = _corpus(n=16, seed=9)
        _run(store.store_embeddings(_chunks(ts, vecs2, texts2, doc="x")))
        r2 = _run(store.query_similar(vecs2[0], k=1))
        assert r2[0].document_id == "x0" and r2[0].chunk_number == 0
        _run(store.delete_chunks_by_document_id("x0"))  # invalidates the cached alive mask
        r3 = _run(store.query_similar(vecs2[0], k=4))
        assert all(not (c.document_id == "x0" and c.chunk_number == 0) for c in r3)
    else:
        vecs, texts = _corpus(n=16)
        _run(store.store_embeddings(_chunks(ts, vecs, texts)))
        res = _run(store.query_similar(vecs[0], k=8, doc_ids=["d1"]))
        assert res and all(c.document_id == "d1" for c in res)
        new = ts.DocumentChunk(document_id="d0", chunk_number=0, content="zulu yankee",
                               embedding=list(map(float, -vecs[0])))
        _run(store.store_embeddings([new]))
        top = _run(store.query_similar(-vecs[0], k=1))
        assert top[0].document_id == "d0" and top[0].content == "zulu yankee"


def test_port_bm25_inverted_index_consistency():
    store = t_tvs.TextVectorStore(device="cpu")
    vecs, _ = _corpus(n=8)
    texts = ["apple pie", "apple tart", "banana split", "cherry pie", "apple", "grape", "pie pie pie", "nothing"]
    _run(store.store_embeddings(_chunks(ts, vecs, texts)))
    scores = store._ns_map["default"].bm25_candidates("apple pie", np.ones(8, bool))
    assert set(scores) == {0, 1, 3, 4, 6}
    assert scores[0] > scores[4]  # both terms beat one term


def test_port_persistence_roundtrip(tmp_path):
    store = t_tvs.TextVectorStore(path=tmp_path / "ts", device="cpu")
    vecs, texts = _corpus(n=12)
    _run(store.store_embeddings(_chunks(ts, vecs, texts)))
    _run(store.delete_chunks_by_document_id("d1"))
    store.save()
    re_ = t_tvs.TextVectorStore(path=tmp_path / "ts", device="cpu")
    r = _run(re_.query_similar(vecs[0], k=3, query_text=texts[0]))
    assert r and all(c.document_id != "d1" for c in r)
    ns = re_._ns_map["default"]
    assert ns.count == 12 and ns.n_alive() == 8


def test_text_store_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_tvs.TextVectorStore()


# ------------------------------------------------------------ rerankers


RERANK_TEXTS = ["Quarterly revenue grew 12% in EMEA.", "The signature page of the contract.",
                "Table of contents: 1. Overview 2. Risk", "revenue revenue revenue", "", "Ünïcode résumé text."]


def test_overlap_reranker_matches_jax():
    for query in ("quarterly revenue", "contract signature", "", "zzz"):
        assert _run(OverlapReranker().compute_score(query, RERANK_TEXTS)) == _run(
            JOverlap().compute_score(query, RERANK_TEXTS))
        assert _run(OverlapReranker().compute_score(query, "revenue report")) == _run(
            JOverlap().compute_score(query, "revenue report"))
    chunks = [ts.DocumentChunk(document_id=f"d{i}", chunk_number=0, content=t, embedding=[])
              for i, t in enumerate(RERANK_TEXTS)]
    jchunks = [js.DocumentChunk(document_id=f"d{i}", chunk_number=0, content=t, embedding=[])
               for i, t in enumerate(RERANK_TEXTS)]
    a = _run(JOverlap().rerank("revenue contract", jchunks))
    b = _run(build_reranker(None).rerank("revenue contract", chunks))
    assert [(c.document_id, c.score) for c in a] == [(c.document_id, c.score) for c in b]
    with pytest.raises(NotImplementedError, match="needs sentence-transformers"):
        build_reranker("BAAI/bge-reranker-v2-m3")


@pytest.fixture(scope="module")
def colqwen_rerankers():
    jm = JModel.from_fixture(FIXTURE)
    tm = TModel.from_fixture(FIXTURE, device="cpu")
    jemb = JEmbedder(JSettings.model_validate({"model": {"matmul_precision": "bf16"}}), model=jm)
    return JColQwenReranker(jemb), ColpaliEmbeddingModel(tm, static_act_scales=False)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_colqwen_reranker_matches_jax(colqwen_rerankers, use_kernel):
    """The same order and scores within 5e-4 (each package embeds with its
    own tower: the end-to-end tolerance of the slice tests)."""
    j_rr, t_emb = colqwen_rerankers
    t_rr = ColQwenReranker(t_emb, batch_size=4, use_kernel=use_kernel)
    texts = RERANK_TEXTS[:4] + ["A longer chunk about quarterly revenue and margins. " * 12]
    for query in ("quarterly revenue", "signature page"):
        want = _run(j_rr.compute_score(query, texts))
        got = _run(t_rr.compute_score(query, texts))
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
        assert np.argsort(-np.asarray(got), kind="stable").tolist() == np.argsort(
            -np.asarray(want), kind="stable").tolist()
    assert _run(t_rr.compute_score("q", [])) == [] and isinstance(_run(t_rr.compute_score("q", texts[0])), float)
    chunks = [ts.DocumentChunk(document_id=f"d{i}", chunk_number=0, content=t, embedding=[])
              for i, t in enumerate(texts)]
    ranked = _run(t_rr.rerank("quarterly revenue", chunks))
    assert [c.score for c in ranked] == sorted((c.score for c in ranked), reverse=True)
    assert _run(t_rr.rerank("q", [])) == []
