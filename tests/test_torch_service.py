"""The port's service plane against the JAX package's, on the CPU.

- Settings, schemas: equal dumps for the same TOML / field values.
- Images: the PNG decoder, bicubic resize, luma and blank check are
  bit-identical to PIL (and to the reference's `is_blank_page`);
  `preprocess_array_u8` equals JAX `preprocess_image_u8`.
- Store: `TorchMultiVectorStore` against `TPUMultiVectorStore` on
  identical chunks in the shipped int8 knobs: same ids, scores within
  f32 rounding (rtol 1e-5, atol 1e-4, as tests/test_torch_slice.py).
- Shared files: a sqlite database, a local-storage tree and a `jobs.db`
  written by one package read back the same in the other.
- HTTP: the port server and the JAX server, both on sockets, answer the
  same requests with the same status codes and JSON keys; the port
  server's top-k over ingested PNGs equals the JAX library stack fed the
  same pixels (each package embeds for itself: scores atol 5e-3, ids
  equal wherever the score gap exceeds that, as tests/test_torch_slice.py).
- Refusals: what the page decoders still refuse (a progressive JPEG,
  GIF, video) answers 415, unported options 501, and unported settings
  and a missing card raise at `build_services`.
- Documents as pages: the port server and the JAX server given the same
  PDF, JPEG (color and gray), PPTX and DOCX uploads under the same ids
  store byte-identical JPEG page payloads with the same page metadata,
  and answer text and JPEG image retrieves with the same ids; a PNG's
  stored payload is the q80 JPEG PIL writes of it.
- The text path: the port server and the JAX server given the same
  `/ingest/text` documents (the same ids) answer `use_colpali=false`
  retrieves with the same ids and scores (with `use_reranking`: the same
  order, scores within 5e-3), `/batch/chunks` and `/query` alike, and save
  byte-identical `text_index` files that each package opens; a CPU round
  trip with markdown, HTML and PDF uploads, a DELETE from both stores and
  a restart; a text-only server.
"""

import asyncio
import io
import json
import struct
import threading
import time
import urllib.error
import urllib.request
import zipfile
import zlib
from datetime import UTC, datetime
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from morphik_core_tpu.api.app import build_app as j_build_app
from morphik_core_tpu.api.http import HTTPServer as JHTTPServer
from morphik_core_tpu.config import Settings as JSettings, load_settings as j_load_settings
from morphik_core_tpu.database.sqlite_database import SQLiteDatabase as JDatabase
from morphik_core_tpu.embedding.colpali_embedding_model import ColpaliEmbeddingModel as JEmbedder
from morphik_core_tpu.models import schemas as js
from morphik_core_tpu.models.colqwen import ColQwenModel as JModel
from morphik_core_tpu.models.colqwen.preprocess import preprocess_image_u8
from morphik_core_tpu.ops.fde import FDEConfig as JFDE
from morphik_core_tpu.parser.raster_pool import is_blank_page as j_is_blank_page
from morphik_core_tpu.services.document_service import DocumentService as JDocumentService
from morphik_core_tpu.services_init import build_services as j_build_services
from morphik_core_tpu.storage.local_storage import LocalStorage as JStorage
from morphik_core_tpu.vector_store.tpu_multivector_store import TPUMultiVectorStore
from morphik_core_tpu.workers.job_queue import JobQueue as JJobQueue
from morphik_core_tpu_torch.api.app import build_app
from morphik_core_tpu_torch.api.http import HTTPServer, Request
from morphik_core_tpu_torch.config import Settings, load_settings
from morphik_core_tpu_torch.database.sqlite_database import SQLiteDatabase
from morphik_core_tpu_torch.index.multivector_index import IndexRecord as TRecord, MultiVectorIndex as TIndex
from morphik_core_tpu_torch.models import schemas as ts
from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel as TModel
from morphik_core_tpu_torch.models.colqwen.preprocess import (
    is_blank_page,
    preprocess_array_u8,
    resize_bicubic_u8,
    to_luma_u8,
)
from morphik_core_tpu_torch.ops.fde import FDEConfig as TFDE
from morphik_core_tpu_torch.parser.text_splitter import RecursiveCharacterTextSplitter as RecursiveCharacterTextSplitterT
from morphik_core_tpu_torch.reranker.rerankers import ColQwenReranker, OverlapReranker as OverlapRerankerT
from morphik_core_tpu_torch.services.document_service import DocumentService
from morphik_core_tpu_torch.services_init import build_services
from morphik_core_tpu_torch.storage.local_storage import LocalStorage
from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri
from morphik_core_tpu_torch.utils.png import decode_png, encode_png
from morphik_core_tpu_torch.vector_store.torch_multivector_store import TorchMultiVectorStore
from morphik_core_tpu_torch.workers.job_queue import JobQueue

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "tiny_colqwen.npz"
DIM = 32  # the fixture's embedding width
SMALL_FDE = {"fde_num_repetitions": 8, "fde_num_simhash_projections": 4, "fde_projection_dimension": 8}
SHIPPED = dict(
    prefilter_multiplier=30, prefilter_cap=300, ann_dtype="int8", device_cache_slots=2048,
    device_cache_token_bucket=1024, rerank_dtype="int8", rerank_prefilter_pooling=4,
    pooled_tier_factor=32, pooled_tier_budget_mb=6144, query_token_dedup=0.98,
)
QUERIES = ["quarterly revenue", "table of contents", "signature page"]


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# ------------------------------------------------------------- settings


@pytest.mark.parametrize("source", ["morphik_tpu.toml", "defaults"])
def test_settings_match_jax(source, tmp_path, monkeypatch):
    monkeypatch.setenv("JWT_SECRET_KEY", "from-env")
    path = ROOT / source if source.endswith(".toml") else tmp_path / "absent.toml"
    got, want = load_settings(path).model_dump(), j_load_settings(path).model_dump()
    assert got == want
    assert got["auth"]["jwt_secret_key"] == "from-env"


def test_settings_ignore_unknown_keys_as_jax():
    raw = {"api": {"port": 0, "bogus": 1}, "bogus_section": {"x": 1}, "vector_store": {"rerank_dtype": "bf16"}}
    assert Settings.from_dict(raw).model_dump() == JSettings.model_validate(raw).model_dump()


@pytest.mark.parametrize("section,key,value", [
    ("service", "environment", "prod"), ("vector_store", "rerank_dtype", "fp8"),
    ("model", "matmul_precision", "fp4"), ("morphik", "mode", "saas"),
])
def test_settings_refuse_bad_literal_as_jax(section, key, value):
    raw = {section: {key: value}}
    with pytest.raises(ValueError):
        JSettings.model_validate(raw)
    with pytest.raises(ValueError, match=key):
        Settings.from_dict(raw)


# -------------------------------------------------------------- schemas

_T0 = datetime(2026, 1, 2, 3, 4, 5, 678000, tzinfo=UTC)


def _schema_pair(case, pkg):
    if case == "document":
        return pkg.Document(
            external_id="d1", content_type="image/png", filename="p.png", metadata={"k": [1, 2]},
            storage_info={"bucket": "", "key": "ingest/d1/p.png", "size": 3, "none": None},
            system_metadata={"created_at": _T0, "updated_at": _T0, "status": "processing", "ratio": float("inf")},
            chunk_ids=["d1-0"],
        )
    if case == "auth":
        return pkg.AuthContext(entity_type=pkg.EntityType.DEVELOPER, entity_id="u", permissions={"read"},
                               user_id="u", token_version=3)
    chunk = pkg.ChunkResult(content="data:image/png;base64,AA==", score=1.5, document_id="d1", chunk_number=0,
                            metadata={"is_image": True, "page": 0}, content_type="image/png", filename="p.png")
    pad = pkg.ChunkResult(content="x", score=0.0, document_id="d1", chunk_number=1, metadata={},
                          content_type="image/png", is_padding=True)
    if case == "chunk_result":
        return chunk
    if case == "grouped":
        return pkg.GroupedChunkResponse(
            chunks=[chunk, pad], groups=[pkg.ChunkGroup(main_chunk=chunk, padding_chunks=[pad], total_chunks=2)],
            total_results=2, has_padding=True,
        )
    if case == "document_result":
        return pkg.DocumentResult(score=2.0, document_id="d1", metadata={},
                                  content=pkg.DocumentContent(type="url", value="file:///x", filename="p.png"),
                                  additional_metadata={"a": 1})
    return pkg.CompletionResponse(completion={"answer": "x"}, usage={"total_tokens": 3}, finish_reason="stop",
                                  sources=[{"document_id": "d1", "chunk_number": 0}], metadata={"model": "stub"})


@pytest.mark.parametrize("case", ["document", "auth", "chunk_result", "grouped", "document_result", "completion"])
def test_schema_json_matches_jax(case):
    got, want = _schema_pair(case, ts).model_dump(mode="json"), _schema_pair(case, js).model_dump(mode="json")
    assert list(got) == list(want)
    assert json.dumps(got) == json.dumps(want)


def test_auth_context_round_trips_its_json():
    a = ts.AuthContext(entity_id="u", permissions={"read", "write"}, user_id="u")
    j = js.AuthContext(entity_id="u", permissions={"read", "write"}, user_id="u")
    b = ts.AuthContext(**a.model_dump(mode="json"))
    assert b == a and isinstance(b.permissions, set) and b.entity_type is ts.EntityType.DEVELOPER
    assert sorted(a.model_dump(mode="json")["permissions"]) == sorted(j.model_dump(mode="json")["permissions"])
    assert ts.Document(content_type="x").system_metadata["created_at"].tzinfo is not None


# --------------------------------------------------------------- images


def _page(rng, h, w, n_blocks=6):
    """A white page with coloured blocks and bars (structure, not noise)."""
    page = np.full((h, w, 3), 255, np.uint8)
    for _ in range(n_blocks):
        y, x = int(rng.integers(0, h - 8)), int(rng.integers(0, w - 8))
        page[y : y + int(rng.integers(4, h // 3)), x : x + int(rng.integers(4, w // 3))] = rng.integers(0, 200, 3)
    for y in range(int(rng.integers(4, 20)), h, int(rng.integers(12, 30))):
        page[y : y + 2, w // 10 : w - w // 10] = rng.integers(0, 120)
    return page


def _pil_png(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_decode_png_matches_pil(mode):
    rng = np.random.default_rng(0)
    for h, w in [(112, 224), (37, 53), (250, 333)]:
        rgb = _page(rng, h, w)
        rgb[::7] = rng.integers(0, 256, (len(range(0, h, 7)), w, 3))  # rows every filter type sees
        img = Image.fromarray(rgb)
        if mode == "P":
            data = _pil_png(img.quantize(colors=200), bits=8)
        else:
            data = _pil_png(img.convert(mode) if mode != "LA" else img.convert("L").convert("LA"))
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        got = decode_png(data)
        assert got.dtype == np.uint8 and np.array_equal(got, want), (h, w)
    assert np.array_equal(decode_png(encode_png(rgb)), rgb)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(encode_png(rgb)))), rgb)


def _with_ihdr(data: bytes, depth: int, interlace: int) -> bytes:
    w, h, _, color, comp, filt, _ = struct.unpack(">IIBBBBB", data[16:29])
    body = struct.pack(">IIBBBBB", w, h, depth, color, comp, filt, interlace)
    return data[:16] + body + struct.pack(">I", zlib.crc32(b"IHDR" + body)) + data[33:]


@pytest.mark.parametrize("depth,interlace,match", [(16, 0, "bit depth 16"), (8, 1, "Adam7")])
def test_decode_png_refuses_what_it_does_not_decode(depth, interlace, match):
    data = _with_ihdr(encode_png(np.zeros((4, 5, 3), np.uint8)), depth, interlace)
    with pytest.raises(ValueError, match=match):
        decode_png(data)
    with pytest.raises(ValueError, match="CRC"):
        decode_png(data[:20] + bytes([data[20] ^ 0xFF]) + data[21:])


def test_decode_png_refuses_a_decompression_bomb():
    """Pillow's limit (twice `Image.MAX_IMAGE_PIXELS`), checked before any
    pixel is inflated; a body shorter than its header claims is refused."""
    from morphik_core_tpu_torch.utils.png import MAX_PIXELS, SIGNATURE, _chunk

    assert MAX_PIXELS == 2 * Image.MAX_IMAGE_PIXELS

    def png(w, h):
        ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
        return SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(bytes(1000))) + _chunk(b"IEND", b"")

    with pytest.raises(ValueError, match="decompression-bomb"):
        decode_png(png(100_000, 100_000))
    with pytest.raises(ValueError, match="truncated"):
        decode_png(png(5000, 5000))


@pytest.mark.parametrize("src,dst", [
    ((600, 830), (560, 784)), ((560, 784), (560, 784)), ((37, 53), (112, 112)), ((250, 333), (224, 336)),
    ((1000, 700), (128, 128)), ((9, 400), (3, 401)), ((129, 128), (128, 128)), ((1, 1), (5, 3)),
])
def test_resize_bicubic_and_luma_match_pil(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    rgb = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    img = Image.fromarray(rgb)
    want = np.asarray(img.resize(dst[::-1], Image.Resampling.BICUBIC))
    assert np.array_equal(resize_bicubic_u8(rgb, dst), want)
    luma = to_luma_u8(rgb)
    assert np.array_equal(luma, np.asarray(img.convert("L")))
    assert np.array_equal(resize_bicubic_u8(luma, dst), np.asarray(img.convert("L").resize(dst[::-1])))


@pytest.mark.parametrize("kind", ["white", "one_dot", "light_gray", "page", "noise_l"])
def test_is_blank_page_matches_reference(kind):
    rng = np.random.default_rng(3)
    rgb = np.full((600, 830, 3), 255, np.uint8)
    if kind == "one_dot":
        rgb[300:306, 400:406] = 0
    elif kind == "light_gray":
        rgb[:] = 230
    elif kind == "page":
        rgb = _page(rng, 600, 830)
    img = Image.fromarray(rgb)
    if kind == "noise_l":
        img = Image.fromarray(rng.integers(240, 256, (500, 300), dtype=np.uint8), "L")
    got = is_blank_page(decode_png(_pil_png(img)))
    assert got == j_is_blank_page(img)
    assert got == (kind in ("white", "light_gray"))


@pytest.mark.parametrize("size", [(224, 224), (250, 333), (600, 830), (90, 1300), (40, 40)])
def test_preprocess_array_matches_jax(size):
    rgb = _page(np.random.default_rng(size[0]), *size)
    want_p, want_g = preprocess_image_u8(Image.fromarray(rgb), min_pixels=3136, max_pixels=602112)
    got_p, got_g = preprocess_array_u8(decode_png(encode_png(rgb)), 3136, 602112)
    assert tuple(got_g) == tuple(want_g) and np.array_equal(got_p, want_p)


# ---------------------------------------------------------------- store


def _store_chunks(pkg, rows, pages):
    """Image chunks (PNG payloads) then text chunks with the same
    multivectors, in both packages' DocumentChunk."""
    out = []
    for i, mv in enumerate(rows):
        if i < len(pages):
            out.append(pkg.DocumentChunk(document_id=f"doc{i // 2}", chunk_number=i % 2, embedding=mv,
                                         content=bytes_to_data_uri(pages[i], "image/png"),
                                         metadata={"is_image": True, "page": i % 2}))
        else:
            out.append(pkg.DocumentChunk(document_id=f"txt{i}", chunk_number=0, embedding=mv,
                                         content=f"text {i}", metadata={}))
    return out


def _store_parity(tmp_path, persist: bool):
    """Both stores take the same chunks, queries, padding fetches and a
    delete. With `persist`, both get an `index_path` and the same
    precomputed document FDE rows."""
    rng = np.random.default_rng(5)
    concepts = rng.standard_normal((40, DIM)).astype(np.float32)
    rows = []
    for _ in range(48):
        x = concepts[rng.choice(40, int(rng.integers(30, 120)))] + 0.1 * rng.standard_normal((1, DIM))
        rows.append((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32))
    pages = [encode_png(_page(rng, 40, 60)) for _ in range(8)]
    kw = dict(SHIPPED, device_block_rows=32)
    paths = {"j": tmp_path / "j" / "index", "t": tmp_path / "t" / "index"} if persist else {"j": None, "t": None}
    jstore = TPUMultiVectorStore(storage=JStorage(tmp_path / "j"), fde_config=JFDE(dimension=DIM),
                                 index_path=paths["j"], **kw)
    tstore = TorchMultiVectorStore(storage=LocalStorage(tmp_path / "t"), fde_config=TFDE(dimension=DIM),
                                   index_path=paths["t"], device="cpu", **kw)
    fdes = list(TIndex(TFDE(dimension=DIM), device="cpu").encode_documents(rows)) if persist else None

    async def go():
        for store, pkg in ((jstore, js), (tstore, ts)):
            chunks = _store_chunks(pkg, rows, pages)
            ok1, ids1, _ = await store.store_embeddings(chunks[:20], app_id="app",
                                                        fde_vectors=fdes and fdes[:20])
            ok2, ids2, _ = await store.store_embeddings(chunks[20:], app_id="app",
                                                        fde_vectors=fdes and fdes[20:])
            assert ok1 and ok2 and ids1 + ids2 == [f"{c.document_id}-{c.chunk_number}" for c in chunks]
        queries = [rows[3], rows[30], concepts[:3] / np.linalg.norm(concepts[:3], axis=1, keepdims=True)]
        for q in queries:
            for doc_ids in (None, ["doc1", "doc2", "txt30", "txt31"]):
                a = await jstore.query_similar(q, k=5, doc_ids=doc_ids, app_id="app")
                b = await tstore.query_similar(q, k=5, doc_ids=doc_ids, app_id="app")
                assert [(c.document_id, c.chunk_number) for c in a] == [(c.document_id, c.chunk_number) for c in b]
                np.testing.assert_allclose([c.score for c in b], [c.score for c in a], rtol=1e-5, atol=1e-4)
                assert [c.content for c in a] == [c.content for c in b]
                assert [c.metadata for c in a] == [c.metadata for c in b]
        assert (await tstore.query_similar(rows[3], k=1, app_id="app"))[0].document_id == "doc1"
        want = [(d, n) for d in ("doc0", "doc3", "nope") for n in (0, 1, 2)]
        a = await jstore.get_chunks_by_id(want, app_id="app")
        b = await tstore.get_chunks_by_id(want, app_id="app", skip_image_content=False)
        assert [c.model_dump(mode="json") for c in a] == [c.model_dump(mode="json") for c in b]
        keys = await tstore.get_chunks_by_id(want, app_id="app", skip_image_content=True)
        assert [c.content for c in keys] == [c.content for c in await jstore.get_chunks_by_id(
            want, app_id="app", skip_image_content=True)]
        # ColPali padding: neighbour pages fetched through get_chunks_by_id
        jsvc = JDocumentService(None, None, None, None, colpali_vector_store=jstore, settings=JSettings())
        tsvc = DocumentService(None, None, None, tstore, None, Settings())
        for q in (rows[2], rows[5]):
            a = await jsvc._apply_padding(await jstore.query_similar(q, k=3, app_id="app"), 1,
                                          js.AuthContext(app_id="app"))
            b = await tsvc._apply_padding(await tstore.query_similar(q, k=3, app_id="app"), 1,
                                          ts.AuthContext(app_id="app"))
            assert [(c.document_id, c.chunk_number, c.metadata.get("is_padding")) for c in a] == [
                (c.document_id, c.chunk_number, c.metadata.get("is_padding")) for c in b]
            assert any(c.metadata.get("is_padding") for c in b)
        for store in (jstore, tstore):
            assert await store.delete_chunks_by_document_id("doc1", app_id="app")
        a = await jstore.query_similar(rows[3], k=5, app_id="app")
        b = await tstore.query_similar(rows[3], k=5, app_id="app")
        assert [c.document_id for c in a] == [c.document_id for c in b] and "doc1" not in [c.document_id for c in b]
        assert await tstore.get_chunks_by_id([("doc1", 1)], app_id="app") == []
        assert len(tstore._indexes["app"]) == len(jstore._indexes["app"]) == 46
        return rows, concepts

    return jstore, tstore, *_run(go())


def test_store_matches_jax(tmp_path):
    _, tstore, _, _ = _store_parity(tmp_path, persist=False)
    tstore.save()
    assert not (tmp_path / "t" / "index").exists()


def test_store_files_match_jax(tmp_path):
    """With `index_path`, the per-namespace files are byte-identical, and
    each store reopens the other's files and answers the same ids."""
    jstore, tstore, rows, concepts = _store_parity(tmp_path, persist=True)
    jstore.save()
    tstore.save()
    jdir, tdir = tmp_path / "j" / "index" / "app", tmp_path / "t" / "index" / "app"
    names = sorted(p.name for p in tdir.iterdir())
    assert names == sorted(p.name for p in jdir.iterdir()) == sorted(
        ["header.json", "records.jsonl", "fde.bin", "mv.bin", "pooled.bin"])
    for name in names:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
    assert b"_patches" not in (tdir / "records.jsonl").read_bytes()
    kw = dict(SHIPPED, device_block_rows=32)
    t_on_j = TorchMultiVectorStore(storage=LocalStorage(tmp_path / "j"), fde_config=TFDE(dimension=DIM),
                                   index_path=tmp_path / "j" / "index", device="cpu", **kw)
    j_on_t = TPUMultiVectorStore(storage=JStorage(tmp_path / "t"), fde_config=JFDE(dimension=DIM),
                                 index_path=tmp_path / "t" / "index", **kw)

    async def go():
        queries = [rows[3], rows[30], concepts[:3] / np.linalg.norm(concepts[:3], axis=1, keepdims=True)]
        for q in queries:
            for a_store, b_store in ((jstore, t_on_j), (tstore, j_on_t)):
                a = await a_store.query_similar(q, k=5, app_id="app")
                b = await b_store.query_similar(q, k=5, app_id="app")
                assert [(c.document_id, c.chunk_number) for c in a] == [(c.document_id, c.chunk_number) for c in b]
                np.testing.assert_allclose([c.score for c in b], [c.score for c in a], rtol=1e-5, atol=1e-4)
                assert [c.content for c in a] == [c.content for c in b]
        assert "doc1" not in [c.document_id for c in await t_on_j.query_similar(rows[3], k=5, app_id="app")]

    _run(go())


def test_store_refuses_binary_and_needs_a_device(monkeypatch):
    with pytest.raises(NotImplementedError, match="item 6"):
        TorchMultiVectorStore(provider="binary", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchMultiVectorStore()


# --------------------------------------------------------- shared files


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sqlite_database_shared(writer, tmp_path):
    path = tmp_path / "morphik.db"
    wdb, rdb = (JDatabase(path), SQLiteDatabase(path)) if writer == "jax" else (SQLiteDatabase(path), JDatabase(path))
    wpkg, rpkg = (js, ts) if writer == "jax" else (ts, js)
    wauth = wpkg.AuthContext(entity_id="u1", permissions={"read", "write"}, user_id="u1")
    rauth = rpkg.AuthContext(entity_id="u1", permissions={"read", "write"}, user_id="u1")

    async def go():
        await wdb.initialize()
        await rdb.initialize()
        doc = _schema_pair("document", wpkg)
        doc.system_metadata["status"] = "processing"
        await wdb.store_document(doc, wauth)
        await wdb.add_storage_bytes(wauth, 123)
        await wdb.update_document("d1", {"system_metadata": {"status": "completed", "page_count": 1},
                                         "chunk_ids": ["d1-0"]}, wauth)
        await wdb.upsert_chat_history("c1", "u1", None, [{"role": "user", "content": "hi"}])
        got = await rdb.get_document("d1", rauth)
        want = await wdb.get_document("d1", wauth)
        assert got.model_dump(mode="json") == want.model_dump(mode="json")
        assert got.system_metadata["status"] == "completed"
        assert await rdb.find_authorized_and_filtered_documents(rauth, {"k": 1}) == ["d1"]
        assert await rdb.find_authorized_and_filtered_documents(
            rpkg.AuthContext(entity_id="u2", permissions={"read"}), None) == []
        assert [d.external_id for d in await rdb.get_documents_by_id(["d1", "zz"], rauth)] == ["d1"]
        assert await rdb.get_chat_history("c1", "u1", None) == [{"role": "user", "content": "hi"}]
        assert await rdb.add_storage_bytes(rauth, 1) == 124

    _run(go())


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_local_storage_shared(writer, tmp_path):
    w, r = (JStorage(tmp_path), LocalStorage(tmp_path)) if writer == "jax" else (LocalStorage(tmp_path), JStorage(tmp_path))
    data = encode_png(_page(np.random.default_rng(1), 30, 40))

    async def go():
        assert await w.upload_file(data, "app/d1/0.png", bucket="multivector-chunks") == ("multivector-chunks", "app/d1/0.png")
        assert await r.download_file("multivector-chunks", "app/d1/0.png") == data
        assert await r.get_object_size("multivector-chunks", "app/d1/0.png") == len(data)
        assert await r.list_objects("multivector-chunks") == await w.list_objects("multivector-chunks")
        assert await r.get_download_url("multivector-chunks", "app/d1/0.png") == await w.get_download_url(
            "multivector-chunks", "app/d1/0.png")

    _run(go())


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_jobs_db_shared(writer, tmp_path):
    path = tmp_path / "jobs.db"
    w, r = (JJobQueue(path), JobQueue(path)) if writer == "jax" else (JobQueue(path), JJobQueue(path))
    job_id = _run(w.enqueue_job("process_ingestion_job", document_id="d1", auth={"entity_id": "u"}, use_colpali=True))
    job = r.get_job(job_id)
    assert (job.function, job.kwargs, job.status) == (
        "process_ingestion_job", {"document_id": "d1", "auth": {"entity_id": "u"}, "use_colpali": True}, "queued")
    assert r.pending_count() == w.pending_count() == 1


# ----------------------------------------------------------------- HTTP


def _raw_settings(root: Path, name: str) -> dict:
    return {
        "api": {"port": 0},
        "storage": {"storage_path": str(root / name / "storage")},
        "database": {"path": str(root / name / "db.sqlite")},
        "vector_store": {"index_path": str(root / name / "index"), **SMALL_FDE},
        "telemetry": {"telemetry_dir": str(root / name / "logs" / "telemetry")},
        "model": {"matmul_precision": "bf16"},
        "worker": {"max_jobs": 2},
    }


def _multipart(field, filename, data, ctype, fields=None):
    boundary = "----morphik-test-boundary"
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in (fields or {}).items()]
    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{field}"; filename="{filename}"\r\n'
                 f"Content-Type: {ctype}\r\n\r\n".encode() + data + b"\r\n")
    return b"".join(parts) + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def _call(base, method, path, body=None, headers=None):
    """(status, parsed JSON or raw text) over a real socket."""
    headers = dict(headers or {})
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
        headers.setdefault("Content-Type", "application/json")
    req = urllib.request.Request(base + path, data=body, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, raw, ctype = resp.status, resp.read(), resp.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        status, raw, ctype = e.code, e.read(), e.headers.get("Content-Type", "")
    return status, (json.loads(raw) if "json" in ctype else raw.decode())


def _upload(base, filename, data, ctype="image/png", field="file", fields=None):
    body, mp = _multipart(field, filename, data, ctype, fields)
    return _call(base, "POST", "/ingest/" + ("files" if field == "files" else "file"), body, {"Content-Type": mp})


def _wait_completed(base, doc_ids, timeout_s=60.0):
    deadline = time.time() + timeout_s
    while True:
        states = [_call(base, "GET", f"/documents/{d}/status")[1]["status"] for d in doc_ids]
        if all(s == "completed" for s in states):
            return
        assert "failed" not in states and time.time() < deadline, states
        time.sleep(0.05)


class _LoopThread:
    """An event loop in a background thread, serving the servers."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=120)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)
        self.loop.close()


PAGE_SIZES = [(224, 224), (224, 336), (250, 333), (336, 224), (224, 224), (280, 230)]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The port server and the JAX server, both with the fixture model,
    each with the same PNG pages ingested over HTTP."""
    root = tmp_path_factory.mktemp("service")
    rng = np.random.default_rng(11)
    pages = [_page(rng, h, w, n_blocks=4 + i) for i, (h, w) in enumerate(PAGE_SIZES)]
    lt = _LoopThread()
    t_services = build_services(Settings.from_dict(_raw_settings(root, "torch")),
                                colqwen_model=TModel.from_fixture(FIXTURE, device="cpu"), device="cpu")
    jm = JModel.from_fixture(FIXTURE)
    j_services = j_build_services(JSettings.model_validate(_raw_settings(root, "jax")), colqwen_model=jm)
    out = {"pages": pages, "jm": jm, "services": {"torch": t_services, "jax": j_services}, "base": {}, "docs": {}}
    srvs = []
    for name, services, make_app, server_cls in (("torch", t_services, build_app, HTTPServer),
                                                  ("jax", j_services, j_build_app, JHTTPServer)):
        lt.run(services.initialize())
        srv = server_cls(make_app(services), "127.0.0.1", 0)
        lt.run(srv.start())
        srvs.append((srv, services))
        base = out["base"][name] = f"http://127.0.0.1:{srv.port}"
        docs = []
        for i, page in enumerate(pages if name == "torch" else pages[:1]):
            status, doc = _upload(base, f"page{i}.png", encode_png(page), fields={"metadata": json.dumps({"i": i})})
            assert status == 200, doc
            docs.append(doc)
        out["docs"][name] = docs
    for name in ("torch", "jax"):
        _wait_completed(out["base"][name], [d["external_id"] for d in out["docs"][name]])
    yield out
    for srv, services in srvs:
        lt.run(srv.stop())
        lt.run(services.shutdown())
    lt.close()


def _both(servers, method, path, body=None, headers=None):
    return [_call(servers["base"][name], method, path.format(doc=servers["docs"][name][0]["external_id"]),
                  body, headers) for name in ("torch", "jax")]


def _keys(x):
    """The JSON key structure of a response (lists: their first item).
    `phase_times` names each package's own ingest phases (the port has no
    text parse), so only its presence is compared."""
    if isinstance(x, dict):
        return {k: None if k == "phase_times" else _keys(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_keys(x[0])] if x else []
    return None


@pytest.mark.parametrize("method,path,body", [
    ("GET", "/ping", None),
    ("GET", "/health", None),
    ("GET", "/documents/{doc}", None),
    ("GET", "/documents/{doc}/status", None),
    ("GET", "/documents/nope/status", None),
    ("POST", "/retrieve/chunks", {"query": "quarterly revenue", "k": 2}),
    ("POST", "/retrieve/chunks", {"query": "quarterly revenue", "k": 2, "output_format": "url"}),
    ("POST", "/retrieve/chunks/grouped", {"query": "table of contents", "k": 1, "padding": 1}),
    ("POST", "/query", {"query": "signature page", "k": 1}),
])
def test_http_matches_jax_server(servers, method, path, body):
    (ts_, tj), (js_, jj) = _both(servers, method, path, body)
    assert ts_ == js_, (tj, jj)
    if path == "/health":
        assert tj["components"]["colpali"]["backend"] == "cpu" and jj["components"]["colpali"]["backend"] == "cpu"
        tj["components"]["colpali"].pop("device_cache", None)
        jj["components"]["colpali"].pop("device_cache", None)
        assert tj["components"].pop("text_index_rows") == {}  # a key of the port: no text ingested here
    assert _keys(tj) == _keys(jj)


def test_http_ingest_and_batch_match_jax_server(servers):
    tdoc, jdoc = servers["docs"]["torch"][0], servers["docs"]["jax"][0]
    assert list(tdoc) == list(jdoc) and tdoc["content_type"] == jdoc["content_type"] == "image/png"
    assert tdoc["metadata"] == jdoc["metadata"] == {"i": 0}
    sources = {"sources": [{"document_id": "{doc}", "chunk_number": 0}], "use_colpali": True}
    res = []
    for name in ("torch", "jax"):
        body = json.loads(json.dumps(sources).replace("{doc}", servers["docs"][name][0]["external_id"]))
        res.append(_call(servers["base"][name], "POST", "/batch/chunks", body))
    assert res[0][0] == res[1][0] == 200 and len(res[0][1]) == len(res[1][1]) == 1
    assert _keys(res[0][1]) == _keys(res[1][1])
    (ts_, tj), (js_, jj) = _both(servers, "POST", "/ingest/file", b"", {"Content-Type": "multipart/form-data; boundary=x"})
    assert ts_ == js_ == 422
    body, mp = _multipart("files", "a.png", encode_png(servers["pages"][0]), "image/png")
    (ts_, tj), (js_, jj) = _both(servers, "POST", "/ingest/files", body, {"Content-Type": mp})
    assert ts_ == js_ == 200 and _keys(tj) == _keys(jj) and len(tj["documents"]) == 1


def test_http_auth_matches_jax_server(servers):
    from morphik_core_tpu.api.auth import create_token

    services = servers["services"]
    for s in services.values():
        s.settings.auth.bypass_auth_mode = False
    try:
        (ts_, _), (js_, _) = _both(servers, "POST", "/retrieve/chunks", {"query": "x"})
        assert ts_ == js_ == 401
        token = create_token(services["jax"].settings, "dev_user")
        (ts_, tj), (js_, jj) = _both(servers, "POST", "/retrieve/chunks", {"query": "x", "k": 1},
                                     {"Authorization": f"Bearer {token}"})
        assert ts_ == js_ == 200 and len(tj) == len(jj) == 1
        (ts_, _), (js_, _) = _both(servers, "GET", "/documents/{doc}", None, {"Authorization": "Bearer bad.token.x"})
        assert ts_ == js_ == 401
    finally:
        for s in services.values():
            s.settings.auth.bypass_auth_mode = True


def test_http_stream_matches_jax_server(servers):
    (ts_, tj), (js_, jj) = _both(servers, "POST", "/query", {"query": "signature page", "k": 1, "stream_response": True})
    assert ts_ == js_ == 200
    for text in (tj, jj):
        events = [json.loads(e[6:]) for e in text.split("\n\n") if e.startswith("data: {")]
        assert events[-1]["type"] == "sources" and text.rstrip().endswith("[DONE]")
    assert _keys(json.loads(tj.split("\n\n")[-3][6:])) == _keys(json.loads(jj.split("\n\n")[-3][6:]))


def _same_ranking(ids_a, sa, ids_b, sb, atol):
    sa, sb = np.asarray(sa), np.asarray(sb)
    np.testing.assert_allclose(sb, sa, rtol=0, atol=atol)
    assert len(ids_a) == len(ids_b)
    cut = [i for i in range(len(sa)) if sa[i] - sa[-1] > 2 * atol]
    assert {ids_a[i] for i in cut} == {ids_b[i] for i in cut}
    for i in range(len(sa) - 1):
        if sa[i] - sa[i + 1] > 2 * atol and (i == 0 or sa[i - 1] - sa[i] > 2 * atol):
            assert ids_a[i] == ids_b[i]


def test_http_topk_matches_jax_library(servers):
    """JAX: `_embed_prepped` on `preprocess_image_u8` of each page's stored
    payload (the q80 JPEG PIL writes, decoded by PIL), then
    `TPUMultiVectorStore.query_similar`, with the port's FDE geometry."""
    jm, pages, docs = servers["jm"], servers["pages"], servers["docs"]["torch"]
    jsettings = JSettings.model_validate({"model": {"matmul_precision": "bf16"}})
    jemb = JEmbedder(jsettings, model=jm)
    payloads = [_pil_jpeg(Image.fromarray(p), quality=80) for p in pages]
    prepped = [preprocess_image_u8(Image.open(io.BytesIO(j)), min_pixels=3136, max_pixels=602112) for j in payloads]
    embs = jemb._embed_prepped(prepped)
    fde = JFDE(dimension=DIM, num_repetitions=8, num_simhash_projections=4, projection_dimension=8)
    store = TPUMultiVectorStore(fde_config=fde, **SHIPPED)
    chunks = [js.DocumentChunk(document_id=d["external_id"], chunk_number=0, content="", embedding=e,
                               metadata={"is_image": True, "page": 0}) for d, e in zip(docs, embs)]
    _run(store.store_embeddings(chunks))
    base = servers["base"]["torch"]
    pages_only = {"i": {"$in": list(range(len(pages)))}}  # other tests ingest more documents
    for text in QUERIES:
        want = _run(store.query_similar(jm.embed_queries([text])[0], k=4))
        status, got = _call(base, "POST", "/retrieve/chunks", {"query": text, "k": 4, "filters": pages_only})
        assert status == 200
        _same_ranking([c.document_id for c in want], [c.score for c in want],
                      [r["document_id"] for r in got], [r["score"] for r in got], atol=5e-3)
    # an image query: page 3's own PNG comes back first in both, with its stored JPEG payload
    q_img = bytes_to_data_uri(encode_png(pages[3]), "image/png")
    status, got = _call(base, "POST", "/retrieve/chunks", {"query_image": q_img, "k": 4, "filters": pages_only})
    q_emb = jemb._embed_prepped([preprocess_image_u8(Image.fromarray(pages[3]), min_pixels=3136,
                                                     max_pixels=602112)])[0]
    want = _run(store.query_similar(q_emb, k=4))
    assert status == 200 and got[0]["document_id"] == want[0].document_id == docs[3]["external_id"]
    _same_ranking([c.document_id for c in want], [c.score for c in want],
                  [r["document_id"] for r in got], [r["score"] for r in got], atol=5e-3)
    assert got[0]["content"] == bytes_to_data_uri(payloads[3], "image/jpeg")
    assert got[0]["metadata"] == {"is_image": True, "page": 0}


@pytest.mark.parametrize("kind", ["progressive_jpeg", "gif", "video"])
def test_http_refuses_other_content_types(servers, kind):
    """What the port still does not ingest answers 415 with either
    `use_colpali`, naming ROADMAP item 3b-ii: a progressive JPEG (the
    decoder reads baseline only), GIF (no decoder) and video."""
    img = Image.fromarray(servers["pages"][0])
    if kind == "progressive_jpeg":
        data, name, ctype = _pil_jpeg(img, progressive=True), "p.jpg", "image/jpeg"
    elif kind == "gif":
        buf = io.BytesIO()
        img.save(buf, format="GIF")
        data, name, ctype = buf.getvalue(), "p.gif", "image/gif"
    else:
        data, name, ctype = b"\x00\x00\x00\x18ftypmp42" + bytes(64), "v.mp4", "video/mp4"
    for fields in (None, {"use_colpali": "false"}):
        status, body = _upload(servers["base"]["torch"], name, data, ctype, fields=fields)
        assert status == 415 and "ROADMAP Queue 1 item 3b-ii" in body["detail"], body
    if kind == "progressive_jpeg":
        assert "progressive" in body["detail"]


def test_http_undecodable_query_image_answers_400(servers):
    status, out = _call(servers["base"]["torch"], "POST", "/retrieve/chunks",
                        {"query": "x", "query_image": "data:image/png;base64,AAAA"})
    assert status == 400 and "not a PNG" in out["detail"]


@pytest.mark.parametrize("body", [
    {"query": "x", "use_colpali": False, "output_format": "text"}, {"query": "x", "output_format": "text"},
])
def test_http_unported_options_answer_501(servers, body):
    status, out = _call(servers["base"]["torch"], "POST", "/retrieve/chunks", body)
    assert status == 501 and "ROADMAP Queue 1 item 3" in out["detail"]


def test_http_failed_ingest_marks_document_failed(servers):
    base = servers["base"]["torch"]
    broken = encode_png(servers["pages"][0])[:60] + b"\x00" * 40  # a PNG signature, a torn body
    status, doc = _upload(base, "broken.png", broken)
    assert status == 200
    deadline = time.time() + 30
    while (st := _call(base, "GET", f"/documents/{doc['external_id']}/status")[1])["status"] == "processing":
        assert time.time() < deadline
        time.sleep(0.05)
    assert st["status"] == "failed" and st["error"]


def test_multipart_keeps_binary_crlf():
    data = encode_png(np.zeros((3, 3, 3), np.uint8)) + b"\r\n--\r\n\r\n"  # the signature holds CRLF too
    body, ctype = _multipart("file", "p.png", data, "image/png", {"metadata": "{}"})
    fields, files = Request("POST", "/ingest/file", {}, {"content-type": ctype}, body).form()
    assert fields == {"metadata": "{}"} and files["file"][0].data == data
    assert files["file"][0].content_type == "image/png" and files["file"][0].filename == "p.png"


@pytest.mark.parametrize("section,key,value,item", [
    ("model", "checkpoint_path", "/models/x", "item 5"),
    ("model", "attention_precision", "int8", "item 4"),
    ("morphik", "colpali_mode", "api", "item 3h"),
    ("storage", "provider", "aws-s3", "item 3h"),
    ("tpu", "auto_mesh", True, "item 6"),
    ("morphik", "mode", "cloud", "item 3e"),
    ("completion", "model", "openai_gpt4", "item 3g"),
    ("embedding", "model", "openai_gpt4", "item 3g"),
    ("parser", "ocr_mode", "api", "item 3b"),
    ("parser", "parser_mode", "api", "item 3h"),
])
def test_build_services_refuses_unported_settings(tmp_path, section, key, value, item):
    raw = _raw_settings(tmp_path, "x")
    raw.setdefault(section, {})[key] = value
    raw["registered_models"] = {"openai_gpt4": {"model_name": "gpt-4"}}
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        build_services(Settings.from_dict(raw), device="cpu")


def test_build_services_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_services(Settings.from_dict(_raw_settings(tmp_path, "x")))
    raw = _raw_settings(tmp_path, "y")
    raw["service"] = {"environment": "production"}
    with pytest.raises(RuntimeError, match="random-weight"):
        build_services(Settings.from_dict(raw), device="cpu")


def _boot(lt, raw):
    """The port server on `raw` settings with the fixture model, on the CPU."""
    services = build_services(Settings.from_dict(raw), colqwen_model=TModel.from_fixture(FIXTURE, device="cpu"),
                              device="cpu")
    lt.run(services.initialize())
    srv = HTTPServer(build_app(services), "127.0.0.1", 0)
    lt.run(srv.start())
    return services, srv, f"http://127.0.0.1:{srv.port}"


def _retrieve_all(base, k=3):
    out = {}
    for text in QUERIES:
        status, res = _call(base, "POST", "/retrieve/chunks", {"query": text, "k": k})
        assert status == 200 and len(res) == k, res
        out[text] = ([r["document_id"] for r in res], [r["score"] for r in res])
    return out


def test_restart_keeps_rows_and_the_jax_server_reads_them(tmp_path):
    """Ingest PNGs over HTTP, shut down (the shutdown saves the index),
    boot again on the same directories: the same top-k, each document
    `completed` with its chunk. Then the JAX server boots on the port's
    directories and answers the same ids (its own query embeddings: atol
    5e-3; the port's embeddings through its store: the same ids, scores
    within f32 rounding)."""
    raw = _raw_settings(tmp_path, "r")
    rng = np.random.default_rng(21)
    pages = [_page(rng, h, w, n_blocks=5 + i) for i, (h, w) in enumerate(PAGE_SIZES[:4])]
    lt = _LoopThread()
    try:
        services, srv, base = _boot(lt, raw)
        docs = [_upload(base, f"p{i}.png", encode_png(p))[1]["external_id"] for i, p in enumerate(pages)]
        _wait_completed(base, docs)
        before = _retrieve_all(base)
        lt.run(srv.stop())
        lt.run(services.shutdown())
        wal = (tmp_path / "r" / "index" / "default" / "records.jsonl").read_text().splitlines()
        assert len(wal) == len(pages) and "_patches" not in "".join(wal)

        services, srv, base = _boot(lt, raw)
        assert _call(base, "GET", "/health")[1]["components"]["colpali"]["index_rows"] == {}  # opened at first use
        after = _retrieve_all(base)
        for text in QUERIES:
            assert after[text][0] == before[text][0]
            np.testing.assert_allclose(after[text][1], before[text][1], rtol=0, atol=1e-5)
        assert _call(base, "GET", "/health")[1]["components"]["colpali"]["index_rows"] == {"default": len(pages)}
        for d, page in zip(docs, pages):
            status, doc = _call(base, "GET", f"/documents/{d}")
            assert status == 200 and doc["system_metadata"]["status"] == "completed"
            status, chunks = _call(base, "POST", "/batch/chunks",
                                   {"sources": [{"document_id": d, "chunk_number": 0}], "use_colpali": True})
            assert status == 200 and [c["document_id"] for c in chunks] == [d]
            # the reference's page payload: the q80 JPEG PIL writes of the page
            assert chunks[0]["content"] == bytes_to_data_uri(_pil_jpeg(Image.fromarray(page), quality=80), "image/jpeg")
        port_queries = {text: services.colpali_embedding_model.embed_query(text) for text in QUERIES}
        lt.run(srv.stop())
        lt.run(services.shutdown())

        j_services = j_build_services(JSettings.model_validate(raw), colqwen_model=JModel.from_fixture(FIXTURE))
        lt.run(j_services.initialize())
        jsrv = JHTTPServer(j_build_app(j_services), "127.0.0.1", 0)
        lt.run(jsrv.start())
        try:
            got = _retrieve_all(f"http://127.0.0.1:{jsrv.port}")
            for text in QUERIES:
                _same_ranking(after[text][0], after[text][1], got[text][0], got[text][1], atol=5e-3)
                lib = lt.run(j_services.colpali_vector_store.query_similar(port_queries[text], k=3))
                assert [c.document_id for c in lib] == after[text][0]
                np.testing.assert_allclose([c.score for c in lib], after[text][1], rtol=1e-5, atol=1e-4)
        finally:
            lt.run(jsrv.stop())
            lt.run(j_services.shutdown())
    finally:
        lt.close()


@pytest.mark.parametrize("use_pallas", [True, False])
def test_use_pallas_reaches_every_maxsim_call(tmp_path, monkeypatch, use_pallas):
    """`tpu.use_pallas` reaches the index as the reference passes it (None
    or False), and from there every MaxSim call: the pooled stage, the
    pooled prefilter, the cache rerank and the cold rerank, int8 and bf16.
    With false each runs the kernels' plain versions (`use_kernel=False`),
    on the card as here."""
    from morphik_core_tpu_torch.index import device_cache
    from morphik_core_tpu_torch.ops import maxsim as tmax

    raw = _raw_settings(tmp_path, "p")
    raw["tpu"] = {"use_pallas": use_pallas}
    store = build_services(Settings.from_dict(raw), colqwen_model=TModel.from_fixture(FIXTURE, device="cpu"),
                           device="cpu").colpali_vector_store
    assert store.index_kwargs["use_pallas"] is (None if use_pallas else False)
    assert store._ns("default")._use_kernel is use_pallas
    seen = []
    orig = {name: getattr(tmax, name) for name in ("maxsim", "maxsim_q8")}

    def spy(where, name):
        def wrapped(*a, use_kernel=True, **kw):
            seen.append((where, name, use_kernel))
            return orig[name](*a, use_kernel=use_kernel, **kw)
        return wrapped

    for mod, where in ((tmax, "ops"), (device_cache, "cache")):
        for name in orig:
            monkeypatch.setattr(mod, name, spy(where, name))
    rng = np.random.default_rng(2)
    rows = []
    for _ in range(64):
        x = rng.standard_normal((int(rng.integers(20, 60)), DIM)).astype(np.float32)
        rows.append(x / np.linalg.norm(x, axis=1, keepdims=True))
    fde = TFDE(dimension=DIM, num_repetitions=8, num_simhash_projections=4, projection_dimension=8)
    paths = {
        "pooled stage + cache rerank q8": ({}, {("ops", "maxsim_q8"), ("cache", "maxsim_q8")}),
        "pooled prefilter (cache) + cache rerank q8": ({"pooled_tier_factor": 0}, {("cache", "maxsim_q8")}),
        "pooled prefilter (upload) + cold rerank q8": ({"pooled_tier_factor": 0, "device_cache_slots": 0},
                                                       {("ops", "maxsim_q8")}),
        "cache rerank bf16": ({"rerank_dtype": "bf16"}, {("ops", "maxsim_q8"), ("cache", "maxsim")}),
        "cold rerank bf16": ({"rerank_dtype": "bf16", "pooled_tier_factor": 0, "rerank_prefilter_pooling": 0,
                              "device_cache_slots": 0}, {("ops", "maxsim")}),
    }
    for label, (over, want) in paths.items():
        kw = dict(store.index_kwargs, **over)
        index = TIndex(fde, device="cpu", **kw)
        index.store(rows, [TRecord(f"d{i}", 0) for i in range(64)])
        seen.clear()
        res = index.query(rows[5], k=3)
        assert res[0][0].document_id == "d5", label
        assert {(w, n) for w, n, _ in seen} == want, (label, seen)
        assert all(k is use_pallas for _, _, k in seen), (label, seen)


def test_log_uploader_keeps_telemetry_within_budget(tmp_path):
    """`enforce_local_budget` drops the oldest files first; an uploader
    with no URL uploads nothing but trims; and `Services.initialize`
    starts it, so a running server trims `telemetry_dir` to
    `local_budget_bytes` (`shutdown` stops and joins the thread, which the
    reference's cannot: its `_stop` event shadows `Thread._stop`)."""
    import os

    from morphik_core_tpu_torch.services.log_uploader import Heartbeat, LogUploader, enforce_local_budget

    d = tmp_path / "tel"
    d.mkdir()
    old, new = d / "spans_old.jsonl", d / "spans_new.jsonl"
    old.write_text("x" * 600)
    new.write_text("y" * 600)
    os.utime(old, (time.time() - 1000, time.time() - 1000))
    assert enforce_local_budget(d, budget_bytes=1000) == 600
    assert not old.exists() and new.exists()
    assert LogUploader(d, upload_url=None, budget_bytes=100).upload_once() is False
    assert not new.exists()
    beat = Heartbeat(None, tmp_path / "state", "0.1.0")  # no URL: no ping; the installation id persists
    assert beat.ping_once() is False and Heartbeat(None, tmp_path / "state", "0.1.0").installation_id == beat.installation_id

    raw = _raw_settings(tmp_path, "u")
    raw["telemetry"].update(local_budget_bytes=1000, upload_interval_s=0.05)
    tel = Path(raw["telemetry"]["telemetry_dir"])
    tel.mkdir(parents=True)
    for age, name in enumerate(["spans_c.jsonl", "spans_b.jsonl", "spans_a.jsonl"]):
        (tel / name).write_text("z" * 600)
        os.utime(tel / name, (time.time() - 100 * age, time.time() - 100 * age))
    services = build_services(Settings.from_dict(raw), colqwen_model=TModel.from_fixture(FIXTURE, device="cpu"),
                              device="cpu")
    lt = _LoopThread()
    try:
        lt.run(services.initialize())
        deadline = time.time() + 30
        while sorted(p.name for p in tel.glob("*.jsonl")) != ["spans_c.jsonl"]:
            assert time.time() < deadline, sorted(p.name for p in tel.glob("*.jsonl"))
            time.sleep(0.02)
        assert services.log_uploader.is_alive()
    finally:
        lt.run(services.shutdown())
        lt.close()
    assert not services.log_uploader.is_alive()


def test_launch_counts_survive_concurrent_launches():
    """The server counts kernel launches from its event loop and from
    ingest worker threads at once: no update may be lost."""
    import sys

    from morphik_core_tpu_torch.ops import _kernels

    _kernels.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_kernels.count_launch("maxsim_q8") for _ in range(5000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert _kernels.launch_counts["maxsim_q8"] == 16 * 5000
    finally:
        sys.setswitchinterval(interval)
        _kernels.reset_launch_counts()


def test_server_entry_point_refuses_to_start_without_a_card(tmp_path):
    """Without a card, `python -m morphik_core_tpu_torch.api.server`
    exits with `default_device()`'s error: it never serves on the CPU."""
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py boots the server there")
    toml = tmp_path / "morphik_tpu.toml"
    toml.write_text(f'[storage]\nstorage_path = "{tmp_path / "storage"}"\n'
                    f'[database]\npath = "{tmp_path / "db.sqlite"}"\n')
    proc = subprocess.run([sys.executable, "-m", "morphik_core_tpu_torch.api.server", str(toml)], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and 'no CUDA device found; pass device="cpu"' in proc.stderr, proc.stderr


# ------------------------------------------------------------ text path


def _docx(text: str) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("word/document.xml", '<w:document xmlns:w="http://schemas.openxmlformats.org/wordprocessingml/'
                   f'2006/main"><w:body><w:p><w:r><w:t>{text}</w:t></w:r></w:p></w:body></w:document>')
    return buf.getvalue()


def _text_pdf(pages):
    """A born-digital PDF, one FlateDecode content stream per page."""
    objs = [b"1 0 obj<</Type/Catalog/Pages 2 0 R>>endobj\n",
            f"2 0 obj<</Type/Pages/Kids[{' '.join(f'{3 + 2 * i} 0 R' for i in range(len(pages)))}]"
            f"/Count {len(pages)}>>endobj\n".encode()]
    for i, text in enumerate(pages):
        objs.append(f"{3 + 2 * i} 0 obj<</Type/Page/Parent 2 0 R/Contents {4 + 2 * i} 0 R>>endobj\n".encode())
        comp = zlib.compress(b"BT /F1 12 Tf 72 720 Td (" + text.encode("latin-1") + b") Tj ET")
        objs.append(f"{4 + 2 * i} 0 obj<</Length {len(comp)}/Filter/FlateDecode>>stream\n".encode() + comp
                    + b"\nendstream endobj\n")
    return b"%PDF-1.4\n" + b"".join(objs) + b"trailer<</Root 1 0 R>>\n%%EOF"


_WORDS = ("revenue growth margin contract signature audit region quarterly table figure latency budget risk "
          "supplier invoice policy renewal clause schedule").split()


def _prose(rng, n_words):
    return " ".join(rng.choice(_WORDS) + ("." if rng.random() < 0.1 else "") for _ in range(n_words))


def _text_settings(root: Path, name: str) -> dict:
    raw = _raw_settings(root, name)
    raw["parser"] = {"chunk_size": 400, "chunk_overlap": 40}
    return raw


class _SeqIds:
    """Deterministic `uuid.uuid4`, so that two servers give their documents the same ids."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        import uuid

        self.n += 1
        return uuid.UUID(int=self.n)


TEXT_DOCS = [(0, False), (1, True), (2, False)]  # (i, use_colpali)
TEXT_QUERIES = ["quarterly revenue growth", "contract signature clause", "supplier invoice"]


@pytest.fixture(scope="module")
def text_servers(tmp_path_factory):
    """The port server and the JAX server (fixture model, 400-character
    chunks), each given the same three `/ingest/text` documents under the
    same document ids, one of them with `use_colpali=true`."""
    import uuid

    root = tmp_path_factory.mktemp("text")
    rng = np.random.default_rng(31)
    contents = [_prose(rng, 180) for _ in TEXT_DOCS]
    lt = _LoopThread()
    t_services = build_services(Settings.from_dict(_text_settings(root, "torch")),
                                colqwen_model=TModel.from_fixture(FIXTURE, device="cpu"), device="cpu")
    j_services = j_build_services(JSettings.model_validate(_text_settings(root, "jax")),
                                  colqwen_model=JModel.from_fixture(FIXTURE))
    out = {"root": root, "lt": lt, "contents": contents, "base": {}, "docs": {}, "services": {}}
    srvs = []
    mp = pytest.MonkeyPatch()
    try:
        for name, services, make_app, server_cls in (("torch", t_services, build_app, HTTPServer),
                                                      ("jax", j_services, j_build_app, JHTTPServer)):
            lt.run(services.initialize())
            srv = server_cls(make_app(services), "127.0.0.1", 0)
            lt.run(srv.start())
            srvs.append((srv, services))
            base = out["base"][name] = f"http://127.0.0.1:{srv.port}"
            out["services"][name] = services
            mp.setattr(uuid, "uuid4", _SeqIds())
            out["docs"][name] = []
            for (i, colpali), text in zip(TEXT_DOCS, contents):
                status, doc = _call(base, "POST", "/ingest/text", {
                    "content": text, "filename": f"t{i}.txt", "metadata": {"i": i}, "use_colpali": colpali})
                assert status == 200 and doc["system_metadata"]["status"] == "completed", doc
                out["docs"][name].append(doc)
            mp.undo()
        yield out
    finally:
        mp.undo()
        for srv, services in srvs:
            lt.run(srv.stop())
            lt.run(services.shutdown())
        lt.close()


def _ids_scores(res):
    return [(r["document_id"], r["chunk_number"]) for r in res], [r["score"] for r in res]


def test_http_text_ingest_matches_jax_server(text_servers):
    tdocs, jdocs = text_servers["docs"]["torch"], text_servers["docs"]["jax"]
    assert [d["external_id"] for d in tdocs] == [d["external_id"] for d in jdocs]
    assert [d["chunk_ids"] for d in tdocs] == [d["chunk_ids"] for d in jdocs]
    assert [_keys(d) for d in tdocs] == [_keys(d) for d in jdocs]
    n_text = sum(len(RecursiveCharacterTextSplitterT(400, 40).split_text(c)) for c in text_servers["contents"])
    status, health = _call(text_servers["base"]["torch"], "GET", "/health")
    assert health["components"]["text_index_rows"] == {"default": n_text}
    # use_colpali=true also put its text chunks in the ColPali store, through the text tower
    d1 = tdocs[1]["external_id"]
    status, chunks = _call(text_servers["base"]["torch"], "POST", "/batch/chunks", {
        "sources": [{"document_id": d1, "chunk_number": n} for n in range(3)], "use_colpali": True})
    assert status == 200 and [c["chunk_number"] for c in chunks] == [0, 1, 2]
    assert all(not c["metadata"]["is_image"] for c in chunks)
    assert health["components"]["colpali"]["index_rows"] == {"default": len(tdocs[1]["chunk_ids"]) // 2}


@pytest.mark.parametrize("rerank", [False, True])
def test_http_text_retrieve_matches_jax_server(text_servers, rerank):
    """`use_colpali=false`, hybrid: the same ids and scores (within 1e-6)
    from both servers; with `use_reranking`, the ColQwen reranker of each
    package over the same oversampled chunks: the same order, scores
    within the slice tests' 5e-3 (each package embeds for itself)."""
    for text in TEXT_QUERIES:
        for k in (1, 3):
            body = {"query": text, "k": k, "use_colpali": False, "use_reranking": rerank}
            (ts_, tres), (js_, jres) = [_call(text_servers["base"][n], "POST", "/retrieve/chunks", body)
                                        for n in ("torch", "jax")]
            assert ts_ == js_ == 200 and len(tres) == k
            (ti, tsc), (ji, jsc) = _ids_scores(tres), _ids_scores(jres)
            if rerank:
                _same_ranking(ji, jsc, ti, tsc, atol=5e-3)
            else:
                assert ti == ji
                np.testing.assert_allclose(tsc, jsc, rtol=0, atol=1e-6)
            assert [r["content"] for r in tres if (r["document_id"], r["chunk_number"]) in ji] == [
                r["content"] for r in jres if (r["document_id"], r["chunk_number"]) in ti]
            assert _keys(tres) == _keys(jres) and not any(r["metadata"]["is_image"] for r in tres)
    # the grouped route and /query on text chunks
    for path, body in (("/retrieve/chunks/grouped", {"query": TEXT_QUERIES[0], "k": 2, "use_colpali": False}),
                       ("/query", {"query": TEXT_QUERIES[1], "k": 2, "use_colpali": False, "use_reranking": rerank})):
        (ts_, tj), (js_, jj) = [_call(text_servers["base"][n], "POST", path, body) for n in ("torch", "jax")]
        assert ts_ == js_ == 200 and _keys(tj) == _keys(jj)
        if path == "/query":
            assert tj["completion"] and [s["document_id"] for s in tj["sources"]] == [
                s["document_id"] for s in jj["sources"]]


def test_http_text_batch_chunks_match_jax_server(text_servers):
    docs = text_servers["docs"]["torch"]
    sources = [{"document_id": d["external_id"], "chunk_number": n} for d in docs for n in (0, 2, 99)]
    (ts_, tj), (js_, jj) = [_call(text_servers["base"][n], "POST", "/batch/chunks",
                                  {"sources": sources, "use_colpali": False}) for n in ("torch", "jax")]
    assert ts_ == js_ == 200 and len(tj) == 6
    assert [(c["document_id"], c["chunk_number"], c["content"]) for c in tj] == [
        (c["document_id"], c["chunk_number"], c["content"]) for c in jj]


def test_http_text_index_files_match_jax_server(text_servers):
    """Saved by each server's `/ingest/text`: byte-identical `text_index`
    files, and each package's store opens the other's."""
    from morphik_core_tpu.vector_store.text_vector_store import TextVectorStore as JTextStore
    from morphik_core_tpu_torch.vector_store.text_vector_store import TextVectorStore as TTextStore

    root = text_servers["root"]
    tdir, jdir = root / "torch" / "storage" / "text_index", root / "jax" / "storage" / "text_index"
    names = sorted(p.name for p in tdir.iterdir())
    assert names == sorted(p.name for p in jdir.iterdir()) == ["default.rows.json", "default.vectors.npy"]
    for name in names:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
    t_on_j, j_on_t = TTextStore(jdir, device="cpu"), JTextStore(tdir)
    q = text_servers["services"]["torch"].embedding_model._embed(TEXT_QUERIES[0])
    a = _run(t_on_j.query_similar(q, k=4, query_text=TEXT_QUERIES[0]))
    b = _run(j_on_t.query_similar(q, k=4, query_text=TEXT_QUERIES[0]))
    assert [(c.document_id, c.chunk_number, c.score) for c in a] == [(c.document_id, c.chunk_number, c.score)
                                                                     for c in b]


def test_text_round_trip_and_restart(tmp_path):
    """The port alone on the CPU: `/ingest/text` with both `use_colpali`,
    a markdown, an HTML and a two-page PDF upload with `use_colpali=false`,
    retrieves with and without reranking (equal to the in-process store
    and reranker), `/batch/chunks`, a DELETE that leaves both stores, then
    a restart that keeps the text rows."""
    raw = _text_settings(tmp_path, "rt")
    rng = np.random.default_rng(41)
    lt = _LoopThread()
    try:
        services, srv, base = _boot(lt, raw)
        docs = {}
        for i, colpali in ((0, True), (1, False)):
            status, doc = _call(base, "POST", "/ingest/text", {"content": _prose(rng, 150), "metadata": {"i": i},
                                                              "use_colpali": colpali})
            assert status == 200 and doc["system_metadata"]["status"] == "completed"
            docs[i] = doc["external_id"]
        uploads = {
            "notes.md": (("# Notes\n\n" + _prose(rng, 60)).encode(), "text/markdown"),
            "page.html": (f"<html><title>T</title><body><h2>Head</h2><p>{_prose(rng, 40)}</p></body></html>".encode(),
                          "text/html"),
            "report.pdf": (_text_pdf([_prose(rng, 30), "second page about supplier invoice"]), "application/pdf"),
        }
        for i, (name, (data, ctype)) in enumerate(uploads.items(), start=2):
            status, doc = _upload(base, name, data, ctype, fields={"use_colpali": "false", "metadata": json.dumps({"i": i})})
            assert status == 200, doc
            docs[i] = doc["external_id"]
        _wait_completed(base, list(docs.values()))
        status, pdf_doc = _call(base, "GET", f"/documents/{docs[4]}")
        assert pdf_doc["additional_metadata"] == {"page_count": 2} and "page_count" in pdf_doc["system_metadata"]
        store, reranker = services.vector_store, services.document_service.reranker
        assert isinstance(reranker, ColQwenReranker)
        for text in TEXT_QUERIES:
            status, res = _call(base, "POST", "/retrieve/chunks", {"query": text, "k": 3, "use_colpali": False})
            q = services.embedding_model._embed(text)
            lib = _run(store.query_similar(q, k=3, doc_ids=list(docs.values()), query_text=text))
            assert status == 200 and _ids_scores(res) == ([(c.document_id, c.chunk_number) for c in lib],
                                                          [c.score for c in lib])
            status, rr = _call(base, "POST", "/retrieve/chunks", {"query": text, "k": 3, "use_colpali": False,
                                                                  "use_reranking": True})
            want = _run(reranker.rerank(text, _run(store.query_similar(q, k=9, doc_ids=list(docs.values()),
                                                                        query_text=text))))[:3]
            assert status == 200 and [(r["document_id"], r["chunk_number"]) for r in rr] == [
                (c.document_id, c.chunk_number) for c in want]
        sources = [{"document_id": docs[4], "chunk_number": 0}, {"document_id": docs[2], "chunk_number": 0}]
        status, chunks = _call(base, "POST", "/batch/chunks", {"sources": sources, "use_colpali": False})
        assert status == 200 and "supplier invoice" in chunks[0]["content"] and chunks[1]["content"].startswith("# Notes")
        # a DELETE leaves both stores
        n_colpali = len(services.colpali_vector_store._indexes["default"])
        assert n_colpali > 0
        status, _ = _call(base, "DELETE", f"/documents/{docs[0]}")
        assert status == 200 and len(services.colpali_vector_store._indexes["default"]) == 0
        assert _run(store.get_chunks_by_id([(docs[0], 0)])) == []
        rows = store._ns_map["default"].n_alive()
        before = {}  # the delete changed the corpus statistics of the BM25 half
        for text in TEXT_QUERIES:
            status, res = _call(base, "POST", "/retrieve/chunks", {"query": text, "k": 3, "use_colpali": False})
            before[text] = _ids_scores(res)
            assert status == 200 and docs[0] not in {d for d, _ in before[text][0]}
        lt.run(srv.stop())
        lt.run(services.shutdown())

        services, srv, base = _boot(lt, raw)
        status, health = _call(base, "GET", "/health")
        assert health["components"]["text_index_rows"] == {"default": rows}
        for text in TEXT_QUERIES:
            status, res = _call(base, "POST", "/retrieve/chunks", {"query": text, "k": 3, "use_colpali": False})
            assert status == 200 and _ids_scores(res) == before[text]
        lt.run(srv.stop())
        lt.run(services.shutdown())
    finally:
        lt.close()


def test_text_only_server_and_png_without_colpali(tmp_path):
    """`morphik.enable_colpali=false` boots a text-only server (the
    lexical reranker); a PNG with `use_colpali=false` has no text and
    completes as unsearchable."""
    raw = _text_settings(tmp_path, "to")
    raw["morphik"] = {"enable_colpali": False}
    lt = _LoopThread()
    try:
        services, srv, base = _boot(lt, raw)
        assert services.colpali_vector_store is None and services.colpali_embedding_model is None
        assert isinstance(services.document_service.reranker, OverlapRerankerT)
        status, doc = _call(base, "POST", "/ingest/text", {"content": "supplier invoice renewal clause"})
        assert status == 200 and doc["chunk_ids"] == [f"{doc['external_id']}-0"]
        status, res = _call(base, "POST", "/retrieve/chunks", {"query": "invoice", "k": 2, "use_reranking": True})
        assert status == 200 and [r["document_id"] for r in res] == [doc["external_id"]] and res[0]["score"] > 0
        status, health = _call(base, "GET", "/health")
        assert health["colpali"] is False and health["components"]["colpali"] == {"enabled": False}
        page = np.full((64, 64, 3), 255, np.uint8)
        page[10:40, 10:50] = 30
        status, png = _upload(base, "p.png", encode_png(page), fields={"use_colpali": "false"})
        assert status == 200
        _wait_completed(base, [png["external_id"]])
        status, got = _call(base, "GET", f"/documents/{png['external_id']}")
        assert got["system_metadata"]["unsearchable"] is True and got["chunk_ids"] == []
        lt.run(srv.stop())
        lt.run(services.shutdown())
    finally:
        lt.close()


# ------------------------------------------------------- documents as pages


def _pptx(slides) -> bytes:
    buf = io.BytesIO()
    ns = "http://schemas.openxmlformats.org/drawingml/2006/main"
    with zipfile.ZipFile(buf, "w") as z:
        for i, lines in enumerate(slides, start=1):
            runs = "".join(f"<a:p><a:r><a:t>{t}</a:t></a:r></a:p>" for t in lines)
            z.writestr(f"ppt/slides/slide{i}.xml",
                       f'<p:sld xmlns:a="{ns}" xmlns:p="p"><a:txBody>{runs}</a:txBody></p:sld>')
    return buf.getvalue()


def _doc_uploads(rng):
    """(name, bytes, content type) of each page-image upload kind: a PDF
    (a blank "." page among text pages, one page without text), a color
    JPEG wider than 1024 px, a gray JPEG, a PPTX, a DOCX of two pages."""
    pdf_pages = [_prose(rng, 60) + " office affluent AV WAVE" for _ in range(5)]
    pdf_pages[2] = "."
    pdf_pages[4] = ""
    wide = _page(rng, 300, 1100, n_blocks=8)
    gray = Image.fromarray(_page(rng, 200, 150)).convert("L")
    return [
        ("report.pdf", _text_pdf(pdf_pages), "application/pdf"),
        ("wide.jpg", _pil_jpeg(Image.fromarray(wide), quality=90), "image/jpeg"),
        ("gray.jpg", _pil_jpeg(gray, quality=75), "image/jpeg"),
        ("deck.pptx", _pptx([["Quarterly revenue", "AV office"], ["Supplier invoice", _prose(rng, 20)]]),
         "application/octet-stream"),
        ("memo.docx", _docx(_prose(rng, 520)), "application/octet-stream"),
    ]


def _doc_settings(root: Path, name: str) -> dict:
    raw = _raw_settings(root, name)
    raw["worker"] = {"max_jobs": 1, "raster_processes": 2, "colpali_store_batch_size": 2, "ingest_embed_prefetch": 1}
    return raw


@pytest.fixture(scope="module")
def doc_servers(tmp_path_factory):
    """The port server and the JAX server (fixture model; a 2-process
    raster pool, store batches of 2), each given the same document
    uploads under the same document ids."""
    import uuid

    root = tmp_path_factory.mktemp("docs")
    uploads = _doc_uploads(np.random.default_rng(51))
    lt = _LoopThread()
    out = {"uploads": uploads, "base": {}, "docs": {}, "services": {}}
    srvs = []
    mp = pytest.MonkeyPatch()
    try:
        for name in ("torch", "jax"):
            if name == "torch":
                services = build_services(Settings.from_dict(_doc_settings(root, name)),
                                          colqwen_model=TModel.from_fixture(FIXTURE, device="cpu"), device="cpu")
                srv = HTTPServer(build_app(services), "127.0.0.1", 0)
            else:
                services = j_build_services(JSettings.model_validate(_doc_settings(root, name)),
                                            colqwen_model=JModel.from_fixture(FIXTURE))
                srv = JHTTPServer(j_build_app(services), "127.0.0.1", 0)
            lt.run(services.initialize())
            lt.run(srv.start())
            srvs.append((srv, services))
            base = out["base"][name] = f"http://127.0.0.1:{srv.port}"
            out["services"][name] = services
            mp.setattr(uuid, "uuid4", _SeqIds())
            docs = []
            for fname, data, ctype in uploads:
                status, doc = _upload(base, fname, data, ctype)
                assert status == 200, doc
                docs.append(doc["external_id"])
                _wait_completed(base, docs[-1:], timeout_s=120)
            mp.undo()
            out["docs"][name] = docs
        yield out
    finally:
        mp.undo()
        for srv, services in srvs:
            lt.run(srv.stop())
            lt.run(services.shutdown())
        lt.close()


def _page_chunks(base, doc_id, n=12):
    status, chunks = _call(base, "POST", "/batch/chunks", {
        "sources": [{"document_id": doc_id, "chunk_number": k} for k in range(n)], "use_colpali": True})
    assert status == 200
    return [(c["chunk_number"], c["content"], c["metadata"]) for c in chunks]


@pytest.mark.parametrize("kind", ["pdf", "jpeg", "gray_jpeg", "pptx", "docx"])
def test_http_document_pages_match_jax_server(doc_servers, kind):
    """The same upload under the same id: byte-identical page payloads
    (q70 JPEGs of the raster pool for the PDF, q80 `_image_to_data_uri`
    JPEGs for the rest), the same page metadata and page count."""
    i = ["pdf", "jpeg", "gray_jpeg", "pptx", "docx"].index(kind)
    tid, jid = doc_servers["docs"]["torch"][i], doc_servers["docs"]["jax"][i]
    assert tid == jid
    got, want = _page_chunks(doc_servers["base"]["torch"], tid), _page_chunks(doc_servers["base"]["jax"], jid)
    assert [(n, m) for n, _, m in got] == [(n, m) for n, _, m in want]
    assert all(c.startswith("data:image/jpeg;base64,") for _, c, _ in got)
    assert [c for _, c, _ in got] == [c for _, c, _ in want]
    tdoc = _call(doc_servers["base"]["torch"], "GET", f"/documents/{tid}")[1]
    jdoc = _call(doc_servers["base"]["jax"], "GET", f"/documents/{jid}")[1]
    assert tdoc["system_metadata"]["page_count"] == jdoc["system_metadata"]["page_count"] == len(got)
    if kind.endswith("jpeg"):  # the reference also indexes an image's bytes as text (ROADMAP Queue 3)
        assert tdoc["chunk_ids"] == [f"{tid}-0"]
    else:
        assert tdoc["chunk_ids"] == jdoc["chunk_ids"]
    if kind == "pdf":  # page 2 ("." alone) is blank and skipped; the others keep their true index
        assert [m["page"] for _, _, m in got] == [0, 1, 3, 4]


def test_http_document_retrieve_matches_jax_server(doc_servers):
    """Text queries and a JPEG image query of a stored PDF page: the same
    tiny-model ids from both servers (each package embeds its own stored
    payload's pixels: scores within the slice tests' 5e-3)."""
    tbase, jbase = doc_servers["base"]["torch"], doc_servers["base"]["jax"]
    pdf_page = _page_chunks(tbase, doc_servers["docs"]["torch"][0])[1][1]
    bodies = [{"query": q, "k": 5} for q in QUERIES + ["supplier invoice renewal"]]
    bodies.append({"query_image": pdf_page, "k": 5})
    for body in bodies:
        (ts_, tres), (js_, jres) = [_call(b, "POST", "/retrieve/chunks", body) for b in (tbase, jbase)]
        assert ts_ == js_ == 200 and len(tres) == len(jres) == 5
        _same_ranking([(r["document_id"], r["chunk_number"]) for r in jres], [r["score"] for r in jres],
                      [(r["document_id"], r["chunk_number"]) for r in tres], [r["score"] for r in tres], atol=5e-3)
    assert (tres[0]["document_id"], tres[0]["chunk_number"]) == (doc_servers["docs"]["torch"][0], 1)
