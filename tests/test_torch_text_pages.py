"""Text pages in every left-to-right script the reference draws, through
the port's ingest paths, on the CPU. Tolerance: exact (payload bytes).

- The committed fixture `tests/fixtures/text_pages.npz` (a DOCX, a PPTX
  and a 6-page PDF whose text mixes Greek, Cyrillic, Vietnamese,
  Romanian, symbols, box drawing, the font's emoji and CJK, one page with
  the `Г“A` script-boundary kerning case; a 5-page PDF with a sequence
  of contextual tone letters on page 3; four timing pages of one length)
  is what
  `write_text_pages_fixture` makes now with the JAX package's
  `_render_text_page` and `_finish_page` under PIL.
- The port's `_create_chunks_multivector` (DOCX, PPTX) and its pooled
  `PageStream` (PDF, 1 and 2 processes) store the fixture's reference
  payloads byte for byte; the inline PDF rung equals the reference's.
- The committed fixture `tests/fixtures/mark_pages.npz` (a DOCX of
  Russian stress marks, IPA and decomposed Vietnamese with stacks that do
  not compose, a PPTX of vocalized Arabic, a 3-page PDF of pointed Hebrew,
  polytonic Greek and mixed right-to-left lines, the same PDF with a
  page 4 of code points Unicode 15.0 leaves unassigned, three timing pages;
  the reference's payloads) is what
  `write_mark_pages_fixture` makes now; the port stores its payloads byte
  for byte through the same paths.
- What the renderer refuses fails the job: the pooled PDF with a page of
  tone letters, and the mark fixture's with a page 4 of Unicode 16's
  U+1C89, end
  `failed`, naming ROADMAP item 3b-ii, with none of their rows left in
  either store and `/health`'s row counts as before, at the default
  batching and at batches of one (the reference draws every page); `rasterize_pdf_jpegs`, DOCX and
  PPTX raise `UnsupportedText`; a `pdf.colpali_pdf_dpi` the atlas lacks
  is refused by `build_services`.
"""

import asyncio
import base64
import io
import json
import types
import unicodedata
import uuid
import zipfile
import zlib
from pathlib import Path
from xml.sax.saxutils import escape

import numpy as np
import pytest

from morphik_core_tpu.parser.office import docx_to_text as j_docx_to_text
from morphik_core_tpu.parser.pdf import _render_text_page
from morphik_core_tpu.parser.pdf import extract_pages_text as j_extract_pages_text
from morphik_core_tpu.parser.raster_pool import RasterPool as JRasterPool
from morphik_core_tpu.parser.raster_pool import _finish_page as j_finish_page
from morphik_core_tpu.services.ingestion_service import IngestionService as JIngestionService
from morphik_core_tpu_torch.api.app import build_app
from morphik_core_tpu_torch.api.http import Request
from morphik_core_tpu_torch.config import Settings
from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel as TModel
from morphik_core_tpu_torch.models.schemas import AuthContext
from morphik_core_tpu_torch.parser.office import docx_to_text
from morphik_core_tpu_torch.parser.raster_pool import RasterPool
from morphik_core_tpu_torch.parser.text_render import UnsupportedText, render_text_page
from morphik_core_tpu_torch.services.ingestion_service import IngestionService
from morphik_core_tpu_torch.services_init import build_services
from morphik_core_tpu_torch.storage.content_types import DOCX, PPTX

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "text_pages.npz"
MODEL_FIXTURE = ROOT / "tests" / "fixtures" / "tiny_colqwen.npz"
PREP = (3136, 602112)
SEED = 19
PDF_DPI = 150  # morphik_tpu.toml's pdf.colpali_pdf_dpi; DOCX and PPTX pages are drawn at 100
REFUSED_PAGE = 2  # the tone letters' page of the refused PDF

SENTENCES = {
    "greek": ["Η ετήσια έκθεση δείχνει αύξηση των εσόδων κατά 12% στην Αττική.",
              "Ο πίνακας περιεχομένων βρίσκεται στη σελίδα 3· η υπογραφή στη σελίδα 9.",
              "Ψηφιακή αρχειοθέτηση: «ΑΒΓΔ» — όλα τα έγγραφα, ΰ ΐ ώ."],
    "cyrillic": ["Годовой отчёт показывает рост выручки на 12% в северном регионе.",
                 "Щорічний звіт: ґанок, їжак, єнот; Ђурђевдан, Љубљана, Њујорк, Џон.",
                 "Содержание договора — подпись на странице 3 («Приложение А»)."],
    "latin": ["Báo cáo thường niên cho thấy doanh thu tăng trưởng ở khu vực phía Bắc.",
              "Raportul anual arată creșterea veniturilor; țara și Ștefan semnează.",
              "Zażółć gęślą jaźń; Příliš žluťoučký kůň; Ağaç işleri şöyle; Œuvre naïve.",
              "The ﬁnancial ﬂow: office affluent shuffle, AV WAVE Tyo P.O."],
    "symbols": ["∑ xᵢ ≤ ∫ f(x) dx − 1 ≠ ∞; a → b ⇒ c ≥ 0; ±√2 ≈ 1.414.",
                "∀x ∃y: x ∈ A ∪ B ⊆ C; ‰ € ₴ ₹ ™ № ℃ ½ ¾ ⅓.",
                "╔══════╗ ║ OK ║ ╚══════╝ ├──┤ ■ □ ▲ ● ◆ ☺ ☀ ★ ♥ ✓ ✈ ☎ ⚠"],
    "cjk": ["中文文本：年度报告显示收入增长。", "日本語のテキスト、契約書の署名ページ。",
            "한국어 텍스트 (인용) “中”「引用」　全角スペース。"],
}
BOUNDARY = "Kerning stops at a script boundary: x“A” against Г“A”, α (“A) and “Привет”."
# still refused (ROADMAP Queue 1 item 3b-ii): the font's contextual tone letters in sequence
TONES = "Tones: ˥˩ ˧˥ ˩˧˥"


def _prose(rng, langs, n_chars: int) -> list:
    """Sentences of `langs`, in lines of at most 90 characters, about
    `n_chars` long."""
    lines, size = [], 0
    while size < n_chars:
        lang = langs[int(rng.integers(len(langs)))]
        s = SENTENCES[lang][int(rng.integers(len(SENTENCES[lang])))]
        lines.append(s)
        size += len(s) + 1
    return lines


def _member(name: str) -> zipfile.ZipInfo:
    return zipfile.ZipInfo(name, date_time=(2026, 1, 1, 0, 0, 0))  # the same bytes at every run


def docx_bytes(paras) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        body = "".join(f"<w:p><w:r><w:t>{escape(p)}</w:t></w:r></w:p>" for p in paras)
        z.writestr(_member("word/document.xml"), '<w:document xmlns:w="http://schemas.openxmlformats.org/'
                   f'wordprocessingml/2006/main"><w:body>{body}</w:body></w:document>')
    return buf.getvalue()


def pptx_bytes(slides) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for i, lines in enumerate(slides, start=1):
            runs = "".join(f"<a:p><a:r><a:t>{escape(t)}</a:t></a:r></a:p>" for t in lines)
            z.writestr(_member(f"ppt/slides/slide{i}.xml"), '<p:sld xmlns:a="http://schemas.openxmlformats.org/'
                       f'drawingml/2006/main" xmlns:p="p"><a:txBody>{runs}</a:txBody></p:sld>')
    return buf.getvalue()


def utf16_pdf(pages) -> bytes:
    """A born-digital PDF whose lines are UTF-16BE hex strings. Each line
    starts with four characters below U+0100: the extractor reads a hex
    string as UTF-16BE when their high bytes are zero."""
    objs = [b"1 0 obj<</Type/Catalog/Pages 2 0 R>>endobj\n",
            f"2 0 obj<</Type/Pages/Kids[{' '.join(f'{3 + 2 * i} 0 R' for i in range(len(pages)))}]"
            f"/Count {len(pages)}>>endobj\n".encode()]
    for i, lines in enumerate(pages):
        ops = b"BT /F1 11 Tf 72 720 Td " + b"".join(
            (b"0 -14 Td " if j else b"") + b"<" + line.encode("utf-16-be").hex().upper().encode() + b"> Tj "
            for j, line in enumerate(lines))
        comp = zlib.compress(ops + b"ET")
        objs.append(f"{3 + 2 * i} 0 obj<</Type/Page/Parent 2 0 R/MediaBox[0 0 612 792]/Contents {4 + 2 * i} 0 R>>"
                    "endobj\n".encode())
        objs.append(f"{4 + 2 * i} 0 obj<</Length {len(comp)}/Filter/FlateDecode>>stream\n".encode() + comp
                    + b"\nendstream endobj\n")
    return b"%PDF-1.4\n" + b"".join(objs) + b"trailer<</Root 1 0 R>>\n%%EOF"


def fixture_texts():
    """The fixture's documents as text: DOCX paragraphs, PPTX slides, PDF
    pages (lists of lines), the refused PDF's pages and the timing pages."""
    rng = np.random.default_rng(SEED)
    every = list(SENTENCES)
    paras = [" ".join(_prose(rng, every, 400)) for _ in range(12)]
    slides = [[f"Slide {i + 1}: {title}"] + _prose(rng, every, 300)
              for i, title in enumerate(("Αποτελέσματα", "Итоги года", "总结"))]
    pdf = [[f"p{i + 1:02d} {line}" for line in lines] for i, lines in enumerate([
        ["Quarterly revenue: AV office affluent (Latin-1: déjà vu, Œuvre, «ça»)."] + _prose(rng, ["latin"], 600),
        _prose(rng, ["greek"], 900),
        [BOUNDARY] + _prose(rng, ["cyrillic"], 900),
        _prose(rng, ["cjk"], 500),
        _prose(rng, ["symbols"], 700),
        _prose(rng, every, 1200),
    ])]
    refused = [[f"p{i + 1:02d} quarterly revenue, page {i + 1}"] + (
        [f"p{i + 1:02d} {TONES}"] if i == REFUSED_PAGE else []) for i in range(5)]
    n = 2400
    timing = {"latin1": ("Quarterly revenue, déjà vu: « ça » AV office. " * 80)[:n],
              "latin": " ".join(_prose(rng, ["latin"], n))[:n],
              "cyrillic": " ".join(_prose(rng, ["cyrillic"], n))[:n],
              "cjk": " ".join(_prose(rng, ["cjk"], n))[:n]}
    timing = {k: "\n".join(v[j:j + 90] for j in range(0, n, 90)) for k, v in timing.items()}
    return paras, slides, pdf, refused, timing


def _payloads(chunks) -> list:
    return [base64.b64decode(c.content.split(",", 1)[1]) for c in chunks]


def _pack(blobs):
    return np.frombuffer(b"".join(blobs), np.uint8), np.array([len(b) for b in blobs], np.int64)


def unpack(z, key) -> list:
    flat, sizes = z[key].tobytes(), z[f"{key}_sizes"]
    starts = np.concatenate([[0], np.cumsum(sizes)])
    return [flat[a:b] for a, b in zip(starts, starts[1:])]


def _write_fixture(path: Path, paras, slides, pdf_pages, timing, refused=None) -> Path:
    """The files and the reference's payloads (needs PIL and the JAX
    package): DOCX pages and PPTX slides as the reference's
    `_create_chunks_multivector` stores them (q80, drawn at 100 dpi), PDF
    pages as its raster pool's `_finish_page` makes them (q70, drawn at
    150 dpi)."""
    files = {"docx": docx_bytes(paras), "pptx": pptx_bytes(slides), "pdf": utf16_pdf(pdf_pages)}
    if refused is not None:
        files["refused_pdf"] = utf16_pdf(refused)
    settings = types.SimpleNamespace(settings=Settings())
    out = {k: np.frombuffer(v, np.uint8) for k, v in files.items()}
    docx = JIngestionService._create_chunks_multivector(settings, DOCX, files["docx"], j_docx_to_text(files["docx"]))
    pptx = JIngestionService._create_chunks_multivector(settings, PPTX, files["pptx"], "")
    texts = j_extract_pages_text(files["pdf"])
    pdf = [j_finish_page(i, _render_text_page(t, PDF_DPI), 1024, None)[1] for i, t in enumerate(texts)]
    for key, blobs in (("docx_payloads", _payloads(docx)), ("pptx_payloads", _payloads(pptx)),
                       ("pdf_payloads", pdf)):
        out[key], out[f"{key}_sizes"] = _pack(blobs)
    out["pdf_texts"] = np.array(texts)
    out["timing_names"] = np.array(list(timing))
    out["timing_texts"] = np.array(list(timing.values()))
    np.savez_compressed(path, **out)
    return Path(path)


def write_text_pages_fixture(path: Path = FIXTURE) -> Path:
    """`text_pages.npz` (see `_write_fixture`)."""
    paras, slides, pdf_pages, refused, timing = fixture_texts()
    return _write_fixture(path, paras, slides, pdf_pages, timing, refused)


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


@pytest.fixture(scope="module")
def z():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def test_text_pages_fixture_is_current(tmp_path):
    """Regenerated now (PIL and the JAX package), the committed fixture is
    equal, and its PDFs extract to the texts it was drawn from."""
    fresh = np.load(write_text_pages_fixture(tmp_path / "text_pages.npz"))
    committed = np.load(FIXTURE)
    assert sorted(fresh.files) == sorted(committed.files)
    for k in committed.files:
        assert np.array_equal(fresh[k], committed[k]), k
    paras, slides, pdf_pages, _, _ = fixture_texts()
    assert [t for t in committed["pdf_texts"]] == ["\n".join(p) for p in pdf_pages]
    assert len(unpack(committed, "docx_payloads")) == 2 and len(unpack(committed, "pptx_payloads")) == len(slides)


def _office_payloads_equal(z, kind) -> None:
    data = z[kind].tobytes()
    ctype, text = (DOCX, docx_to_text(data)) if kind == "docx" else (PPTX, "")
    settings = types.SimpleNamespace(settings=Settings())
    chunks = IngestionService._create_chunks_multivector(settings, ctype, data, text)
    assert _payloads(chunks) == unpack(z, f"{kind}_payloads")
    assert [c.metadata["page"] for c in chunks] == list(range(len(chunks)))


def _pooled_payloads_equal(z, processes: int) -> None:
    pool = RasterPool(processes)
    try:
        pages = _run(pool.rasterize_pdf_jpegs(z["pdf"].tobytes(), dpi=PDF_DPI, prep=PREP))
    finally:
        pool.shutdown()
    want = unpack(z, "pdf_payloads")
    assert [p[0] for p in pages] == list(range(len(want))) and not any(p[4] for p in pages)
    assert [p[1] for p in pages] == want


def _inline_pages_equal(z) -> None:
    settings = types.SimpleNamespace(settings=Settings())
    data = z["pdf"].tobytes()
    got = IngestionService._create_chunks_multivector(settings, "application/pdf", data, "")
    want = JIngestionService._create_chunks_multivector(settings, "application/pdf", data, "")
    assert len(got) == len(want) == len(unpack(z, "pdf_payloads"))
    assert [g.content for g in got] == [w.content for w in want]


@pytest.mark.parametrize("kind", ["docx", "pptx"])
def test_office_pages_store_the_reference_payloads(z, kind):
    """DOCX pages and PPTX slides in every script: the port's
    `_create_chunks_multivector` stores the reference's q80 payloads."""
    _office_payloads_equal(z, kind)


@pytest.mark.parametrize("processes", [1, 2])
def test_pooled_pdf_pages_store_the_reference_payloads(z, processes):
    """The PDF through the raster pool's `PageStream` (prep mode, as the
    ingest path takes it): the reference's q70 payloads, page for page."""
    _pooled_payloads_equal(z, processes)


def test_inline_pdf_pages_equal_the_reference(z):
    """The inline PDF rung (`_create_chunks_multivector`: q80 of each
    page) equals the reference's."""
    _inline_pages_equal(z)


# ------------------------------------------------------ right-to-left pages

RTL_FIXTURE = ROOT / "tests" / "fixtures" / "rtl_pages.npz"
RTL_SEED = 20
RTL_SENTENCES = {
    "hebrew": ["הדוח השנתי מראה עלייה של 12% בהכנסות במחוז הצפון.",
               "תוכן העניינים נמצא בעמוד 3; החתימה בעמוד 9 (נספח א).",
               "החוזה נחתם ב-15/03/2024 בין הצדדים “הספק” ו“הלקוח”.",
               "סכום החשבונית: 1,234.50 ש״ח [כולל מע״מ] – לתשלום עד סוף החודש.",
               "פרויקט Morphik (גרסה 2.1) עבר את כל הבדיקות <בהצלחה>!"],
    "arabic": ["يظهر التقرير السنوي ارتفاع الإيرادات بنسبة ١٢٪ في المنطقة الشمالية.",
               "جدول المحتويات في الصفحة ٣؛ والتوقيع في الصفحة ٩ (الملحق أ).",
               "تم توقيع العقد في ١٥/٠٣/٢٠٢٤ بين الطرفين «المورد» و«العميل».",
               "مبلغ الفاتورة: ١٬٢٣٤٫٥٠ ريال [شامل الضريبة] — يستحق الدفع قبل نهاية الشهر.",
               "لا يوجد تأخير في التسليم، والأسعار ثابتة للعام القادم؟ نعم، بلا شك.",
               "اجتاز مشروع Morphik (الإصدار 2.1) جميع الاختبارات بنجاح!"],
    "mixed": ["Quarterly report: הכנסות 12% / الإيرادات ١٢٪ (Q3 2024).",
              "Contract no. 4521 — חוזה מס׳ 4521 — عقد رقم ٤٥٢١.",
              "See \u200fנספח ב\u200f and \u200fالملحق ب\u200f for the details.",
              "\u202bשלום, this is an embedded paragraph\u202c and back to Latin.",
              "מילה \u2066(isolated, Latin)\u2069 ثم \u2067كلمة معزولة\u2069 end.",
              "كـتـاب مـــمـــتـــد، لا لأ لإ لآ، و\ufefb \ufdf2 \ufe91\ufe90."],
}


def rtl_fixture_texts():
    """The right-to-left fixture's documents as text: Hebrew DOCX
    paragraphs, Arabic PPTX slides, PDF pages of Hebrew, Arabic and mixed
    lines (each line's prefix "NN. " holds no strong character, so a line
    takes the direction of its first letter after it), and the timing
    pages (Latin-1, Hebrew, Arabic)."""
    rng = np.random.default_rng(RTL_SEED)

    def prose(langs, n_chars):
        lines, size = [], 0
        while size < n_chars:
            lang = langs[int(rng.integers(len(langs)))]
            lines.append(RTL_SENTENCES[lang][int(rng.integers(len(RTL_SENTENCES[lang])))])
            size += len(lines[-1]) + 1
        return lines

    paras = [" ".join(prose(["hebrew"], 400)) for _ in range(12)]
    slides = [[f"שקף {i + 1}: {title}"] + prose(["arabic"], 300)
              for i, title in enumerate(("النتائج", "ملخص العام", "الخطة القادمة"))]
    pdf = [[f"{i + 1:02d}. {line}" for line in lines] for i, lines in enumerate([
        prose(["hebrew"], 900), prose(["arabic"], 900), prose(["mixed"], 900),
        prose(["hebrew", "arabic", "mixed"], 1400)])]
    n = 2400
    timing = {"latin1": ("Quarterly revenue, déjà vu: « ça » AV office. " * 80)[:n],
              "hebrew": " ".join(prose(["hebrew"], n))[:n],
              "arabic": " ".join(prose(["arabic"], n))[:n]}
    timing = {k: "\n".join(v[j:j + 90] for j in range(0, n, 90)) for k, v in timing.items()}
    return paras, slides, pdf, timing


def write_rtl_pages_fixture(path: Path = RTL_FIXTURE) -> Path:
    """`rtl_pages.npz` (see `_write_fixture`)."""
    paras, slides, pdf_pages, timing = rtl_fixture_texts()
    return _write_fixture(path, paras, slides, pdf_pages, timing)


@pytest.fixture(scope="module")
def rtl():
    with np.load(RTL_FIXTURE) as f:
        return {k: f[k] for k in f.files}


def test_rtl_pages_fixture_is_current(tmp_path):
    """Regenerated now (PIL and the JAX package), the committed
    right-to-left fixture is equal, and its PDF extracts to its texts."""
    fresh = np.load(write_rtl_pages_fixture(tmp_path / "rtl_pages.npz"))
    committed = np.load(RTL_FIXTURE)
    assert sorted(fresh.files) == sorted(committed.files)
    for k in committed.files:
        assert np.array_equal(fresh[k], committed[k]), k
    paras, slides, pdf_pages, _ = rtl_fixture_texts()
    assert [t for t in committed["pdf_texts"]] == ["\n".join(p) for p in pdf_pages]
    assert len(unpack(committed, "pptx_payloads")) == len(slides) and len(unpack(committed, "docx_payloads")) >= 2


@pytest.mark.parametrize("kind", ["docx", "pptx"])
def test_rtl_office_pages_store_the_reference_payloads(rtl, kind):
    """A Hebrew DOCX and an Arabic PPTX: the reference's q80 payloads."""
    _office_payloads_equal(rtl, kind)


@pytest.mark.parametrize("processes", [1, 2])
def test_rtl_pooled_pdf_pages_store_the_reference_payloads(rtl, processes):
    """The Hebrew, Arabic and mixed PDF through the pooled `PageStream`:
    the reference's q70 payloads, page for page."""
    _pooled_payloads_equal(rtl, processes)


def test_rtl_inline_pdf_pages_equal_the_reference(rtl):
    _inline_pages_equal(rtl)


# ------------------------------------------------------------ marks placed

MARK_FIXTURE = ROOT / "tests" / "fixtures" / "mark_pages.npz"
MARK_SEED = 21
MARK_SENTENCES = {
    "russian": ["Приве́т! Э́то сло́во с ударе́нием: за́мок и замо́к, му́ка и мука́.",
                "Слова́рь: большо́й, хорошо́, молоко́; Ё́лка — не ёлка́.",
                "Уче́бник ру́сского языка́ для иностра́нцев, уро́к 12 (с. 45)."],
    "ipa": ["IPA: [ə̃] [x̂] [ij̇] [t͡ʃ] [d͡ʒ] [ŋ̊] [ʊ̯] [ɛ̃ː] [ɔ̃] [ʁ̞] [æ̃].",
            "Transcription: /ˈfoʊ̯.nə.tɪk/ [ˈkʰæ̃t̚] [ɾ̃] [l̩] [n̩] [ɫ̪].",
            "Latin marks: q́ ṽ ẋ̂ ǵ̇ m̃ ỹ̄ ẘ y̆ z̧ ǰ́."],
    "vietnamese": [unicodedata.normalize("NFD", "Tiếng Việt: Nguyễn Thị Minh Khai, đường phố, người dân.")
                   + " Chồng chất: ẫ́ ậ̃ ệ̀ ờ̃.",
                   "Báo cáo thường niên cho thấy doanh thu tăng trưởng ở khu vực phía Bắc.",
                   unicodedata.normalize("NFD", "Hợp đồng được ký kết vào ngày 15 tháng 3 năm 2024.")],
    "arabic": ["بِسْمِ اللَّهِ الرَّحْمَٰنِ الرَّحِيمِ. شُكْرًا جَزِيلًا جداً، وأيضاً.",
               "مُحَمَّدٌ طَالِبٌ مُجْتَهِدٌ؛ لَا يُؤَخِّرُ عَمَلَهُ إِلَى الْغَدِ.",
               "كِتَابٌ جَدِيدٌ فِي الْمَكْتَبَةِ (الصَّفْحَةُ ٣) — لَّا، بَلْ لِلَّهِ.",
               "اَلْعَرَبِيَّةُ لُغَةٌ جَمِيلَةٌ؛ تُكْتَبُ مِنَ الْيَمِينِ إِلَى الْيَسَارِ."],
    "hebrew": ["בְּרֵאשִׁית בָּרָא אֱלֹהִים אֵת הַשָּׁמַיִם וְאֵת הָאָרֶץ.",
               "שָׁלוֹם עֲלֵיכֶם; יִשְׂרָאֵל, יִצְחָק וְיַעֲקֹב (עַמּוּד 3).",
               "הַדּוּחַ הַשְּׁנָתִי מַרְאֶה עֲלִיָּה שֶׁל 12% בַּהַכְנָסוֹת.",
               "מִשְׁפָּט אֶחָד: עֲבוֹדָה, יִרְאָה וּשְׂמָחָה; ײַ."],
    "greek": ["Ἀθῆναι, ὁ λόγος, ἡ ἀρετή· ἀ̈ ᾶ̈ ὦ̈ ἐν ἀρχῇ ἦν ὁ λόγος.",
              "Πολυτονικό: Ἑλλάς, ὅτι, ᾠδή, Ῥόδος, αὐτῷ; ΐ ῢ ε̃.",
              "Η ετήσια έκθεση δείχνει αύξηση των εσόδων κατά 12% στην Αττική."],
    "mixed": ["Report: דּוּחַ שְׁנָתִי / التَّقْرِيرُ السَّنَوِيُّ (Q3 2024), stress: приве́т.",
              "Contract no. 4521 — חוֹזֶה מס׳ 4521 — عَقْدٌ رَقْمُ ٤٥٢١ — ə̃ x̂.",
              "‫שָׁלוֹם, embedded‬ and مَرْحَبًا بِكُمْ in one line; 1̃ 2̂."],
}
# still refused (ROADMAP Queue 1 item 3b-ii): code points Unicode 15.0 leaves unassigned (Unicode 16's Tje)
UNICODE_16 = "Unicode 16: \u1c89\u1c8a Tje"


def mark_fixture_texts():
    """The mark fixture's documents as text: DOCX paragraphs (Russian with
    stress marks, IPA, decomposed Vietnamese with stacks that do not
    compose), PPTX slides of vocalized Arabic (tanween, shadda with a
    haraka, a haraka inside lam-alef), PDF pages of pointed Hebrew (yod
    with hiriq, U+FB1D's sequence), polytonic Greek and mixed
    right-to-left lines; the same PDF with a page of code points newer
    than Python's Unicode 15.0 after them (the refused PDF); the timing pages
    (Latin-1, vocalized Arabic, pointed Hebrew)."""
    rng = np.random.default_rng(MARK_SEED)

    def prose(langs, n_chars):
        lines, size = [], 0
        while size < n_chars:
            lang = langs[int(rng.integers(len(langs)))]
            lines.append(MARK_SENTENCES[lang][int(rng.integers(len(MARK_SENTENCES[lang])))])
            size += len(lines[-1]) + 1
        return lines

    paras = [" ".join(prose(["russian", "ipa", "vietnamese"], 400)) for _ in range(10)]
    slides = [[f"الشريحة {i + 1}: {title}"] + prose(["arabic"], 300)
              for i, title in enumerate(("النَّتَائِجُ", "مُلَخَّصُ الْعَامِ", "الْخُطَّةُ الْقَادِمَةُ"))]
    pdf = [[f"{i + 1:02d}. {line}" for line in lines] for i, lines in enumerate([
        prose(["hebrew"], 900), prose(["greek"], 900), prose(["mixed"], 900)])]
    refused = pdf + [["04. " + UNICODE_16]]
    n = 2400
    timing = {"latin1": ("Quarterly revenue, déjà vu: « ça » AV office. " * 80)[:n],
              "arabic_vocalized": " ".join(prose(["arabic"], n))[:n],
              "hebrew_pointed": " ".join(prose(["hebrew"], n))[:n]}
    timing = {k: "\n".join(v[j:j + 90] for j in range(0, n, 90)) for k, v in timing.items()}
    return paras, slides, pdf, refused, timing


def write_mark_pages_fixture(path: Path = MARK_FIXTURE) -> Path:
    """`mark_pages.npz` (see `_write_fixture`)."""
    paras, slides, pdf_pages, refused, timing = mark_fixture_texts()
    return _write_fixture(path, paras, slides, pdf_pages, timing, refused)


@pytest.fixture(scope="module")
def marked():
    with np.load(MARK_FIXTURE) as f:
        return {k: f[k] for k in f.files}


def test_mark_pages_fixture_is_current(tmp_path):
    """Regenerated now (PIL and the JAX package), the committed mark
    fixture is equal, and its PDF extracts to its texts."""
    fresh = np.load(write_mark_pages_fixture(tmp_path / "mark_pages.npz"))
    committed = np.load(MARK_FIXTURE)
    assert sorted(fresh.files) == sorted(committed.files)
    for k in committed.files:
        assert np.array_equal(fresh[k], committed[k]), k
    paras, slides, pdf_pages, refused, _ = mark_fixture_texts()
    assert [t for t in committed["pdf_texts"]] == ["\n".join(p) for p in pdf_pages]
    assert j_extract_pages_text(committed["refused_pdf"].tobytes())[:len(pdf_pages)] == [
        "\n".join(p) for p in pdf_pages]
    assert len(unpack(committed, "pptx_payloads")) == len(slides) and len(unpack(committed, "docx_payloads")) >= 2


@pytest.mark.parametrize("kind", ["docx", "pptx"])
def test_mark_office_pages_store_the_reference_payloads(marked, kind):
    """A DOCX of Russian stress marks, IPA and Vietnamese stacks, a PPTX of
    vocalized Arabic: the reference's q80 payloads."""
    _office_payloads_equal(marked, kind)


@pytest.mark.parametrize("processes", [1, 2])
def test_mark_pooled_pdf_pages_store_the_reference_payloads(marked, processes):
    """Pointed Hebrew, polytonic Greek and mixed right-to-left pages
    through the pooled `PageStream`: the reference's q70 payloads."""
    _pooled_payloads_equal(marked, processes)


def test_mark_inline_pdf_pages_equal_the_reference(marked):
    _inline_pages_equal(marked)


# ----------------------------------------------------- refusals fail the job


@pytest.mark.parametrize("processes", [1, 2])
def test_rasterize_pdf_jpegs_raises_on_a_refused_page(z, processes):
    """The reference draws all five pages; the port raises for the page of
    tone letters instead of skipping it."""
    data = z["refused_pdf"].tobytes()
    pool, jpool = RasterPool(processes), JRasterPool(processes)
    try:
        with pytest.raises(UnsupportedText, match=r"U\+02E9 MODIFIER LETTER EXTRA-LOW TONE BAR \(script Common\) "
                                                  r"follows U\+02E5.*item 3b-ii"):
            _run(pool.rasterize_pdf_jpegs(data, dpi=PDF_DPI, prep=PREP))
        assert [p[0] for p in _run(jpool.rasterize_pdf_jpegs(data, dpi=PDF_DPI))] == list(range(5))
    finally:
        pool.shutdown()
        jpool.shutdown()


@pytest.mark.parametrize("kind", ["docx", "pptx"])
def test_office_pages_with_refused_text_raise(kind):
    settings = types.SimpleNamespace(settings=Settings())
    lines = ["Quarterly revenue", TONES]
    data = docx_bytes(lines) if kind == "docx" else pptx_bytes([lines])
    ctype, text = (DOCX, docx_to_text(data)) if kind == "docx" else (PPTX, "")
    with pytest.raises(UnsupportedText, match=r"U\+02E9 .*item 3b-ii"):
        IngestionService._create_chunks_multivector(settings, ctype, data, text)
    assert len(JIngestionService._create_chunks_multivector(settings, ctype, data, text)) == 1


def _services(tmp_path: Path, **over):
    raw = {
        "storage": {"storage_path": str(tmp_path / "storage")},
        "database": {"path": str(tmp_path / "db.sqlite")},
        "vector_store": {"fde_num_repetitions": 4, "fde_num_simhash_projections": 3, "fde_projection_dimension": 8,
                         "index_path": str(tmp_path / "index")},
        "telemetry": {"telemetry_dir": str(tmp_path / "logs" / "telemetry")},
        "model": {"matmul_precision": "bf16"},
        "worker": {"raster_processes": 2},
        **over,
    }
    return build_services(Settings.from_dict(raw), colqwen_model=TModel.from_fixture(MODEL_FIXTURE, device="cpu"),
                          device="cpu")


@pytest.mark.parametrize("worker", [{}, {"colpali_store_batch_size": 1, "ingest_embed_prefetch": 1}],
                         ids=["default_batches", "batch_1_prefetch_1"])
@pytest.mark.parametrize("fixture,letter", [("z", "U+02E9 MODIFIER LETTER EXTRA-LOW TONE BAR"),
                                            ("marked", "U+1C89 (script Cyrillic) is unassigned in Unicode 15.0")],
                         ids=["tone_letters", "unassigned_in_unicode_15"])
def test_pooled_pdf_job_with_a_refused_page_fails(request, fixture, letter, tmp_path, monkeypatch, worker):
    """A 5-page PDF with a sequence of tone letters on page 3, and the mark
    fixture's PDF with a page 4 of Unicode 16's U+1C89, through the pooled
    PageStream: the job ends
    `failed`, its error naming the character and item 3b-ii, and none of
    its rows stays in the text store or the ColPali store (before, its text
    chunks stayed, and with batches of 1 so did the pages before the
    refused one), so `/health`'s row counts are those before the job. A
    text document ingested before keeps its rows."""
    z = request.getfixturevalue(fixture)
    services = _services(tmp_path, worker={"raster_processes": 2, **worker})
    svc = services.ingestion_service
    ids = iter(range(1, 100))
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(ids)))
    auth = AuthContext(entity_id="dev", permissions={"read", "write"})
    app = build_app(services)

    async def rows():
        resp = await app.dispatch(Request("GET", "/health", {}, {}, b""))
        c = json.loads(resp.body)["components"]
        return c["colpali"]["index_rows"], c["text_index_rows"]

    async def go():
        await services.initialize()
        try:
            kept = await svc.ingest_text("supplier invoice renewal clause. " * 40, "kept.txt", {}, auth)
            before = await rows()
            doc = await svc.ingest_file_content(z["refused_pdf"].tobytes(), "refused.pdf", {}, auth)
            with pytest.raises(UnsupportedText, match="3b-ii"):
                await svc.process_ingestion_job(doc.external_id, auth)
            stored = await services.database.get_document(doc.external_id, auth)
            pages = await services.colpali_vector_store.get_chunks_by_id(
                [(doc.external_id, n) for n in range(8)], app_id=auth.app_id)
            texts = await services.vector_store.get_chunks_by_id(
                [(doc.external_id, n) for n in range(8)], app_id=auth.app_id)
            kept_rows = await services.vector_store.get_chunks_by_id([(kept.external_id, 0)], app_id=auth.app_id)
            return stored, pages, texts, kept_rows, before, await rows()
        finally:
            await services.shutdown()

    stored, pages, texts, kept_rows, before, after = _run(go())
    assert stored.system_metadata["status"] == "failed"
    assert letter in stored.system_metadata["error"]
    assert "ROADMAP Queue 1 item 3b-ii" in stored.system_metadata["error"]
    assert pages == [] and texts == [] and len(kept_rows) == 1
    assert after == before and before[0]["default"] > 0 and before[1]["default"] > 0, (before, after)


def test_build_services_refuses_a_dpi_the_atlas_lacks(tmp_path):
    """A `pdf.colpali_pdf_dpi` whose font size the atlas lacks is refused
    when the services are built (before, the server booted and dropped
    every PDF page); without ColPali and OCR nothing draws pages, and the
    server boots."""
    with pytest.raises(UnsupportedText, match=r"dpi 300 .*holds dpi \(150, 100\) \(sizes \(18, 12\) px\).*3b-ii"):
        _services(tmp_path / "a", pdf={"colpali_pdf_dpi": 300})
    services = _services(tmp_path / "b", pdf={"colpali_pdf_dpi": 300}, morphik={"enable_colpali": False})
    assert services.colpali_vector_store is None


# ------------------------------------------------------------ complex scripts

COMPLEX_FIXTURE = ROOT / "tests" / "fixtures" / "complex_pages.npz"
COMPLEX_SEED = 22
COMPLEX_SENTENCES = {
    "hindi": ["वार्षिक रिपोर्ट में उत्तरी क्षेत्र में राजस्व में 12% की वृद्धि दिखाई गई है।",
              "अनुबंध पर 15 मार्च 2024 को हस्ताक्षर किए गए (पृष्ठ ३ देखें)।",
              "नमस्ते दुनिया! क्षत्रिय, श्री, द्वार, ज़्यादा, क़लम और प्रधानमंत्री — हिन्दी पाठ॥"],
    "bengali": ["বার্ষিক প্রতিবেদনে উত্তরাঞ্চলে রাজস্ব ১২% বৃদ্ধি দেখানো হয়েছে।",
                "কোম্পানির চুক্তি স্বাক্ষরিত হয়েছে; বিস্তারিত পৃষ্ঠা ৩-এ দেখুন।",
                "শুভ নববর্ষ! ক্ষমা, জ্ঞান, রাষ্ট্র, কৌশল।"],
    "tamil": ["ஆண்டு அறிக்கை வடக்கு பிராந்தியத்தில் வருவாய் 12% உயர்ந்ததைக் காட்டுகிறது.",
              "வணக்கம்! ஒப்பந்தம் கையெழுத்தானது; கொள்கை, கௌரவம், ஸ்ரீ.",
              "தமிழ் மொழி பழமையான மொழிகளில் ஒன்று (பக்கம் ௩)."],
    "thai": ["รายงานประจำปีแสดงให้เห็นว่ารายได้เพิ่มขึ้น 12% ในภาคเหนือ",
             "สวัสดีครับ น้ำ ค่ำ ทำ กำไร ฿1,234.50 (หน้า ๓)",
             "สัญญาได้รับการลงนามเมื่อวันที่ 15 มีนาคม 2567 ที่กรุงเทพฯ"],
    "lao": ["ບົດລາຍງານປະຈຳປີສະແດງໃຫ້ເຫັນລາຍຮັບເພີ່ມຂຶ້ນ 12% ໃນພາກເໜືອ.",
            "ສະບາຍດີ! ນ້ຳ ຄ່ຳ ກຳ ເກົ່າ ໂຮງຮຽນ ແລະ ມະຫາວິທະຍາໄລ.",
            "ສັນຍາໄດ້ລົງນາມໃນວັນທີ 15 ມີນາ 2024 ທີ່ວຽງຈັນ."],
    "khmer": ["របាយការណ៍ប្រចាំឆ្នាំបង្ហាញពីការកើនឡើងនៃប្រាក់ចំណូល ១២% នៅភាគខាងជើង។",
              "សួស្តី ពិភពលោក! ស្ត្រី ក្រុម ព្រះ កើត ខ្មែរ និង ប្រទេសកម្ពុជា។",
              "កិច្ចសន្យាត្រូវបានចុះហត្ថលេខានៅថ្ងៃទី ១៥ ខែមីនា ឆ្នាំ២០២៤។"],
    "myanmar": ["နှစ်ပတ်လည် အစီရင်ခံစာတွင် ဝင်ငွေ ၁၂% တိုးလာကြောင်း ပြသသည်။",
                "မင်္ဂလာပါ ကမ္ဘာ! စာချုပ်ကို ၂၀၂၄ ခုနှစ်တွင် လက်မှတ်ရေးထိုးခဲ့သည်။"],
    "sinhala": ["වාර්ෂික වාර්තාව උතුරු කලාපයේ ආදායම 12% කින් වැඩි වූ බව පෙන්වයි.",
                "ආයුබෝවන්! ශ්‍රී ලංකාව, ක්‍රීඩාව, ප්‍රශ්නය."],
    "tibetan": ["ལོ་འཁོར་སྙན་ཞུ་ནང་ཡོང་འབབ་ 12% ཡར་རྒྱས་བྱུང་ཡོད།",
                "བཀྲ་ཤིས་བདེ་ལེགས། བོད་ཡིག་དང་སྐད་ཡིག"],
    "tifinagh": ["ⵜⴰⵎⴰⵣⵉⵖⵜ ⴷ ⵜⵓⵜⵍⴰⵢⵜ ⵜⴰⵏⴰⵎⵓⵔⵜ ⴳ ⵍⵎⵖⵔⵉⴱ 2024.",
                 "ⴰⵣⵓⵍ ⴼⵍⵍⴰⵡⵏ! ⵜⵉⴼⵉⵏⴰⵖ, ⴰⵎⴰⵣⵉⵖ, ⵜⴰⵙⴽⵯⵍⴰ."],
    "syriac": ["ܫܠܳܡܳܐ ܥܰܠܡܳܐ! ܟܬܳܒܳܐ ܕܣܘܪܝܝܐ (2024).", "ܡܫܝܚܐ ܩܡ ܡܢ ܒܝܬ ܡܝ̈ܬܐ."],
    "jamo": ["옛한글: \u1112\u119e\u11ab\u1100\u1173\u11af \u1100\u119e\u302e\u1105\u119e\u11b7 "
             "\u1106\u119e\u11af\u302f \ud55c\uae00 \uac01.",
             "Jamo and tone marks: \u1100\u1161\u302e \ud55c\u302e \u302f."],
    "mongolian_adlam": ["ᠮᠣᠩᠭᠣᠯ ᠪᠢᠴᠢᠭ᠌ ᠤᠯᠤᠰ 2024.", "𞤀𞤣𞤤𞤢𞤥 𞤆𞤵𞤤𞤢𞤪 (Fulani)."],
    "mixed": ["Report 2024: नमस्ते / สวัสดี / សួស្តី / ສະບາຍດີ / مرحبا بكم (page 3).",
              "Contract no. 4521 — अनुबंध ४५२१ — عقد رقم ٤٥٢١ — ⵜⴰⵎⴰⵣⵉⵖⵜ — ܫܠܡܐ.",
              "שָׁלוֹם / ආයුබෝවන් / မင်္ဂလာပါ / བཀྲ་ཤིས / Ελληνικά / Привет."],
}


def complex_fixture_texts():
    """The complex fixture's documents as text: DOCX paragraphs of Hindi,
    Bengali and Tamil; PPTX slides of Thai, Lao and Khmer (one script a
    slide); PDF pages of Myanmar, Sinhala, Tibetan, Tifinagh, Syriac,
    conjoining jamo with tone marks, Mongolian and Adlam, and lines that
    mix them with Latin, Arabic, Hebrew, Greek and Cyrillic (each line's
    prefix "NN. " holds no strong character); the timing pages (Latin-1,
    Devanagari, Thai, Lao, Khmer)."""
    rng = np.random.default_rng(COMPLEX_SEED)

    def prose(langs, n_chars):
        lines, size = [], 0
        while size < n_chars:
            lang = langs[int(rng.integers(len(langs)))]
            lines.append(COMPLEX_SENTENCES[lang][int(rng.integers(len(COMPLEX_SENTENCES[lang])))])
            size += len(lines[-1]) + 1
        return lines

    paras = [" ".join(prose([lang], 400)) for lang in ("hindi", "bengali", "tamil") for _ in range(4)]
    slides = [[f"{i + 1}. {title}"] + prose([lang], 300)
              for i, (lang, title) in enumerate((("thai", "ผลประกอบการ"), ("lao", "ສະຫຼຸບ"), ("khmer", "ផែនការ")))]
    pdf = [[f"{i + 1:02d}. {line}" for line in lines] for i, lines in enumerate([
        prose(["myanmar", "sinhala", "tibetan"], 700), prose(["tifinagh", "syriac", "mongolian_adlam"], 700),
        prose(["jamo"], 400), prose(["mixed"], 900)])]
    n = 2400
    timing = {"latin1": ("Quarterly revenue, déjà vu: « ça » AV office. " * 80)[:n]}
    for lang in ("hindi", "thai", "lao", "khmer"):
        timing[lang] = " ".join(prose([lang], n))[:n]
    timing = {k: "\n".join(v[j:j + 90] for j in range(0, n, 90)) for k, v in timing.items()}
    return paras, slides, pdf, timing


def write_complex_pages_fixture(path: Path = COMPLEX_FIXTURE) -> Path:
    """`complex_pages.npz` (see `_write_fixture`)."""
    paras, slides, pdf_pages, timing = complex_fixture_texts()
    return _write_fixture(path, paras, slides, pdf_pages, timing)


@pytest.fixture(scope="module")
def complex_pages():
    with np.load(COMPLEX_FIXTURE) as f:
        return {k: f[k] for k in f.files}


def test_complex_pages_fixture_is_current(tmp_path):
    """Regenerated now (PIL and the JAX package), the committed complex
    fixture is equal, and its PDF extracts to its texts."""
    fresh = np.load(write_complex_pages_fixture(tmp_path / "complex_pages.npz"))
    committed = np.load(COMPLEX_FIXTURE)
    assert sorted(fresh.files) == sorted(committed.files)
    for k in committed.files:
        assert np.array_equal(fresh[k], committed[k]), k
    paras, slides, pdf_pages, _ = complex_fixture_texts()
    assert [t for t in committed["pdf_texts"]] == ["\n".join(p) for p in pdf_pages]
    assert len(unpack(committed, "pptx_payloads")) == len(slides) and len(unpack(committed, "docx_payloads")) >= 2


@pytest.mark.parametrize("kind", ["docx", "pptx"])
def test_complex_office_pages_store_the_reference_payloads(complex_pages, kind):
    """A DOCX of Hindi, Bengali and Tamil, a PPTX of Thai, Lao and Khmer
    slides: the reference's q80 payloads."""
    _office_payloads_equal(complex_pages, kind)


@pytest.mark.parametrize("processes", [1, 2])
def test_complex_pooled_pdf_pages_store_the_reference_payloads(complex_pages, processes):
    """Myanmar, Sinhala, Tibetan, Tifinagh, Syriac, jamo and mixed pages
    through the pooled `PageStream`: the reference's q70 payloads."""
    _pooled_payloads_equal(complex_pages, processes)


def test_complex_inline_pdf_pages_equal_the_reference(complex_pages):
    _inline_pages_equal(complex_pages)


# ------------------------------------- N'Ko, the newer Arabic letters, Ahom

NKO_FIXTURE = ROOT / "tests" / "fixtures" / "nko_pages.npz"
NKO_SEED = 23
NKO_SENTENCES = {
    "nko": ["ߒߞߏ ߦߋ߫ ߡߊ߲߬ߘߋ߲߫ ߞߊ߲ ߠߎ߬ ߛߓߍߟߌ ߟߊ߫ ߛߓߍߘߋ߲ ߘߌ߫.",
            "ߛߊ߲߭ ߂߀߂߄ ߟߊ߬ߓߊ߰ߙߊ ߞߍ߫ ߘߊ߫ ߞߊ߬ߣߌ߲߬ ߁߂% ߟߊ߫ ߞߐ߬ߘߎ߮ ߘߐ߫߹",
            "ߞߊ߬ߙߊ߲ߘߋ߲ ߠߎ߬ ߸ ߞߊߺߞߊ ߣߊߺߣߊ ߊ߬ ߣߌ߫ ߒ ߓߊߘߋߺߘߋ߲ ߞߵߊ߬ ߝߐ߫ ߷",
            "ߓߊ߯ߙߊ ߞߍߟߊ ߟߎ߬ ߦߋ߫ ߞߏ߬ߣߌ߲߫ ߃ ߞߊ߲߬ ߸ ߛߓߍߕߊ ߴߊ߬ ߣߌ߫ ߒ ߞߵߏ߬ ߝߐ߫.",
            "ߖߊ߬ߡߊ߬ߣߊ ߞߎ߲߬ߠߊ߬ߛߌ߰ߟߊ ߟߊ߫ ߖߌ߬ߦߊ߬ߓߍ߫ (ߘߐ߬ߛߌ߬ߟߌ ߄) ߝߊ߲߬ߘߌ ߂߃ ߕߊ.",
            "ߊߟߎ߫ ߣߌ߫ ߖߋ߬ ߞߊ߬ ߝߙߊߺߝߙߊ ߞߊ߲ߞߊ߲ ߽ ߞߊ߲ߘߐ߫ ߞߊ߲߬ ߾߁߀ ߿߅"],
    "arabic_newer": ["Saraiki و Urdu: ࢾب ࣀب ࢿ12 ࡰ45% ࢉب-3 ࣇ+7 ࣈب ࢽࢾ.",
                     "Pakistani letters: ࡱࡲ ࡳࡴ ࡵࡶ 2024 ࡷࡸ ࡹࡺ ࡻࡼ ࡽࡾ ࡿࢀ ࢁࢂ ࢃ ࢄ ࢅ ࢆ.",
                     "ࢊب ࢋب ࢌب ࢍب ࢎب ࢵب ࣁ٣ ࣂ٤ ࣃ ࣄ ࣅ ࣆ ࣇ ࣈ — 12% +5 -6."],
    "ahom": ["Ahom 𑜀𑜁𑜂𑜞𑜃 𑜄𑜅𑜞 𑜆𑜝𑜇 𑜈𑜠𑜡 𑜉𑜞𑜢 𑜰𑜱𑜲 (2024).",
             "𑜊𑜋𑜞𑜌 𑜍𑜎𑜏 𑜐𑜑𑜞𑜒 𑜓𑜔𑜕 𑜖𑜗 𑜘𑜙𑜚 𑜞𑜟."],
    "mixed": ["Report 2024: ߒߞߏ ߛߓߍߟߌ / مرحبا بكم / ࢾب 12 / 𑜀𑜞 (page ߃).",
              "ߞߊ߲߬ ‌ߞ ߞ‍ߞ ߞـߞ ߞߺߞ — ‫ߒߞߏ 12‬ and ‪abc ߞߊ‬ ⁧ߞߊ⁩ x.",
              "Marks on bases: ߞ߫߬ a߫ ب߫ ߞ्ߞ ⵜ߫ ក߫ ߞ́ ߞِ 5߲."],
}


def nko_fixture_texts():
    """The N'Ko fixture's documents as text: DOCX paragraphs of N'Ko with
    its tone marks, digits, apostrophes, lajanyalan and punctuation; PPTX
    slides of N'Ko; PDF pages of N'Ko, of the Arabic letters newer than
    FriBiDi's data (Unicode 13-14, digits, "%" and signs after them), of
    Ahom (U+1171E among it), and of lines that mix them with Arabic,
    Latin, joiners, tatweel and bidi controls (each line's prefix "NN. "
    holds no strong character); the timing pages (Latin-1, N'Ko, the
    newer Arabic letters)."""
    rng = np.random.default_rng(NKO_SEED)

    def prose(langs, n_chars):
        lines, size = [], 0
        while size < n_chars:
            lang = langs[int(rng.integers(len(langs)))]
            lines.append(NKO_SENTENCES[lang][int(rng.integers(len(NKO_SENTENCES[lang])))])
            size += len(lines[-1]) + 1
        return lines

    paras = [" ".join(prose(["nko"], 400)) for _ in range(8)]
    slides = [[f"{i + 1}. {title}"] + prose(["nko"], 300)
              for i, title in enumerate(("ߞߐߝߟߌ", "ߛߊ߲߭ ߂߀߂߄", "ߢߍߛߌ߰ߣߍ߲"))]
    pdf = [[f"{i + 1:02d}. {line}" for line in lines] for i, lines in enumerate([
        prose(["nko"], 700), prose(["arabic_newer"], 500), prose(["ahom", "nko"], 300), prose(["mixed"], 700)])]
    n = 2400
    timing = {"latin1": ("Quarterly revenue, déjà vu: « ça » AV office. " * 80)[:n]}
    for lang in ("nko", "arabic_newer"):
        timing[lang] = " ".join(prose([lang], n))[:n]
    timing = {k: "\n".join(v[j:j + 90] for j in range(0, n, 90)) for k, v in timing.items()}
    return paras, slides, pdf, timing


def write_nko_pages_fixture(path: Path = NKO_FIXTURE) -> Path:
    """`nko_pages.npz` (see `_write_fixture`)."""
    paras, slides, pdf_pages, timing = nko_fixture_texts()
    return _write_fixture(path, paras, slides, pdf_pages, timing)


@pytest.fixture(scope="module")
def nko_pages():
    with np.load(NKO_FIXTURE) as f:
        return {k: f[k] for k in f.files}


def test_nko_pages_fixture_is_current(tmp_path):
    """Regenerated now (PIL and the JAX package), the committed N'Ko
    fixture is equal, and its PDF extracts to its texts."""
    fresh = np.load(write_nko_pages_fixture(tmp_path / "nko_pages.npz"))
    committed = np.load(NKO_FIXTURE)
    assert sorted(fresh.files) == sorted(committed.files)
    for k in committed.files:
        assert np.array_equal(fresh[k], committed[k]), k
    paras, slides, pdf_pages, _ = nko_fixture_texts()
    assert [t for t in committed["pdf_texts"]] == ["\n".join(p) for p in pdf_pages]
    assert len(unpack(committed, "pptx_payloads")) == len(slides) and len(unpack(committed, "docx_payloads")) >= 2


@pytest.mark.parametrize("kind", ["docx", "pptx"])
def test_nko_office_pages_store_the_reference_payloads(nko_pages, kind):
    """An N'Ko DOCX and an N'Ko PPTX: the reference's q80 payloads."""
    _office_payloads_equal(nko_pages, kind)


@pytest.mark.parametrize("processes", [1, 2])
def test_nko_pooled_pdf_pages_store_the_reference_payloads(nko_pages, processes):
    """N'Ko, the newer Arabic letters with digits after them, Ahom and
    mixed pages through the pooled `PageStream`: the reference's q70
    payloads."""
    _pooled_payloads_equal(nko_pages, processes)


def test_nko_inline_pdf_pages_equal_the_reference(nko_pages):
    _inline_pages_equal(nko_pages)


@pytest.mark.parametrize("name", ["nko", "arabic_newer"])
def test_nko_timing_pages_equal_the_reference(nko_pages, name):
    """The timing pages chip_smoke renders beside the Latin-1 one, at 150
    dpi, pixel for pixel."""
    text = str(nko_pages["timing_texts"][[str(n) for n in nko_pages["timing_names"]].index(name)])
    assert np.array_equal(render_text_page(text, PDF_DPI), np.asarray(_render_text_page(text, PDF_DPI)))


def test_render_ms_times_the_timing_pages_it_can_draw():
    """`scripts.render_ms`: every fixture's timing pages, each a positive
    median; a page the parser refuses is left out of the report."""
    from morphik_core_tpu_torch.scripts import render_ms

    texts = render_ms.pages()
    assert {"latin1", "khmer", "nko", "arabic_newer"} <= set(texts)
    got = render_ms.render_ms({"latin1": texts["latin1"][:200], "refused": "˥˩"}, repeats=1)
    assert set(got) == {"latin1"} and got["latin1"] > 0
