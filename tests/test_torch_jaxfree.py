"""The port's main path imports neither jax, PIL, pydantic nor httpx
(none is installed beside the card), nor anything of the JAX package:
the shipped int8 embedder calibrates its static scales from the
committed pages and serves ingest and queries, the bf16 embedder still
runs, and the port's HTTP server boots on the CPU and answers an
ingest -> retrieve -> query round trip over a socket, then ingests a
PDF as page images and answers a JPEG image query, then creates a
folder, ingests a page into it, answers a folder-scoped retrieve and an
`/embeddings` call; nor safetensors, tokenizers, ml_dtypes, regex or
transformers: a checkpoint the port writes boots a server through
`model.checkpoint_path` with its tokenizer and answers a retrieve. A
server in cloud mode whose completion and embedding models are a fake
local OpenAI-compatible provider answers `/query`, the on-the-fly query
and `/usage/limits` (the stdlib transport, no httpx). Nor boto3 or
pytesseract (imported only where S3 storage and the tesseract engine are
built): an API node (`colpali_mode="api"`) on an embedding server, with
remote parse and OCR endpoints, ingests, retrieves and relays
`/embeddings`. The connectors and the console run with the same
packages blocked: a local-connector ingest of a progressive JPEG and an
Adam7 16-bit PNG, a GitHub connector against the fake API, `/console`,
and both images decoded to Pillow's pixels. Every committed GIF, BMP,
TIFF, WebP and CMYK / YCCK JPEG fixture decodes to Pillow's mode and
pixels with the same packages blocked, one of each new format ingests
over HTTP, and a WebP and a TIFF image query each find their page. Text
pages in Greek, Cyrillic, Vietnamese, symbols and CJK boxes render to the
reference's payloads with fontTools blocked too. The
evaluation harnesses run
small with the same packages blocked: the fidelity gate (both parts), the
ColPali ladder on the trained fixture, the offline RAG run and the int8
profile. The package data lists every file the package opens at run
time."""

import re
import subprocess
import sys
import textwrap
import tomllib
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

BLOCKED = ("jax", "jaxlib", "PIL", "pydantic", "httpx", "safetensors", "tokenizers", "ml_dtypes", "regex",
           "transformers", "boto3", "pytesseract")

_PRELUDE = textwrap.dedent(
    f"""
    import importlib, pkgutil, sys
    for name in {BLOCKED!r}:
        sys.modules[name] = None  # any import of them now raises
    sys.path.insert(0, sys.argv[1])
    import numpy as np, torch
    torch.set_num_threads(2)
    import morphik_core_tpu_torch
    for m in pkgutil.walk_packages(morphik_core_tpu_torch.__path__, "morphik_core_tpu_torch."):
        importlib.import_module(m.name)
    import chip_smoke  # noqa: F401  (imports only; main() is not run)
    """
)

_LEAKS = textwrap.dedent(
    f"""
    blocked = {BLOCKED + ("morphik_core_tpu",)!r}
    leaked = sorted(k for k in sys.modules if k.split(".")[0] in blocked and sys.modules[k] is not None)
    assert not leaked, leaked
    print("JAXFREE_OK")
    """
)

_GUARD = _PRELUDE + textwrap.dedent(
    """

    from morphik_core_tpu_torch.embedding.colpali_embedding_model import ColpaliEmbeddingModel
    from morphik_core_tpu_torch.index.multivector_index import IndexRecord, MultiVectorIndex
    from morphik_core_tpu_torch.models.colqwen.config import ColQwenConfig
    from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel, quantize_colqwen_params
    from morphik_core_tpu_torch.ops.fde import FDEConfig

    cfg = ColQwenConfig.tiny()
    fde = FDEConfig(dimension=cfg.embedding_dim)
    rng = np.random.default_rng(0)
    pages = [(rng.integers(0, 256, (64, 588), dtype=np.uint8), (4, 4)) for _ in range(3)]
    bf16 = ColpaliEmbeddingModel(ColQwenModel.init_random(cfg, seed=0, device="cpu"))
    assert bf16._embed_prepped(pages[:1])[0].shape == (len(bf16.model.image_sequence_ids(16)), cfg.embedding_dim)
    assert "calibration_s" not in bf16.last_metrics
    model = quantize_colqwen_params(ColQwenModel.init_random(cfg, seed=0, device="cpu"))
    emb = ColpaliEmbeddingModel(model, fde_config=fde)  # the shipped config: int8 + static scales
    assert emb.last_metrics["calibration_s"] > 0
    assert all(blk.q_w.a_scale is not None and blk.down_w.a_scale is not None for blk in model.visual.blocks)
    embs, fdes = emb._embed_prepped(pages, with_fde=True)
    index = MultiVectorIndex(fde, device="cpu", pooled_tier_factor=32, device_cache_slots=64,
                             rerank_dtype="int8", device_block_rows=16)
    extra = [rng.standard_normal((40, cfg.embedding_dim)).astype(np.float32) for _ in range(20)]
    index.store(embs, [IndexRecord(f"page{i}", 0) for i in range(3)], fde_vectors=np.stack(fdes))
    index.store(extra, [IndexRecord(f"x{i}", 0) for i in range(20)])
    res = index.query(emb.embed_query("quarterly revenue"), k=5, return_timing=True)
    assert len(res) == 5 and index.last_timing["pooled_tier"], res
    assert index.query(extra[7], k=3)[0][0].document_id == "x7"
    # the mesh paths: a (2, 2) mesh of one repeated CPU device
    from morphik_core_tpu_torch.parallel import collectives
    from morphik_core_tpu_torch.parallel.mesh import make_mesh, shard_colqwen_params
    mesh = make_mesh((2, 2), devices=["cpu"] * 4)
    assert collectives.gather([torch.ones(2), torch.zeros(2)]).tolist() == [1.0, 1.0, 0.0, 0.0]
    mesh_index = MultiVectorIndex(fde, mesh=mesh, pooled_tier_factor=32, rerank_dtype="int8", device_block_rows=16)
    mesh_index.store(embs, [IndexRecord(f"page{i}", 0) for i in range(3)], fde_vectors=np.stack(fdes))
    mesh_index.store(extra, [IndexRecord(f"x{i}", 0) for i in range(20)])
    q = emb.embed_query("quarterly revenue")
    got = mesh_index.query(q, k=5, return_timing=True)
    assert mesh_index.last_timing["pooled_tier"] and mesh_index.last_mesh_upload_rows == 23
    assert [r.document_id for r, _ in got] == [r.document_id for r, _ in index.query(q, k=5)]
    mesh_model = shard_colqwen_params(quantize_colqwen_params(ColQwenModel.init_random(cfg, seed=0, device="cpu")),
                                      mesh)
    assert ColpaliEmbeddingModel(mesh_model)._embed_prepped(pages[:1])[0].shape == embs[0].shape

    # the HTTP service plane on the CPU: ingest a PNG, retrieve, query
    import asyncio, json, tempfile, threading, time, urllib.request
    from morphik_core_tpu_torch.api.app import build_app
    from morphik_core_tpu_torch.api.http import HTTPServer
    from morphik_core_tpu_torch.config import Settings
    from morphik_core_tpu_torch.services_init import build_services
    from morphik_core_tpu_torch.utils.png import encode_png

    root = tempfile.mkdtemp()
    raw = {
        "storage": {"storage_path": root + "/storage"}, "database": {"path": root + "/db.sqlite"},
        "vector_store": {"index_path": root + "/index"}, "telemetry": {"telemetry_dir": root + "/logs/telemetry"},
        "model": {"static_act_scales": True},
    }
    loop = asyncio.new_event_loop()
    threading.Thread(target=loop.run_forever, daemon=True).start()
    def on_loop(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout=120)
    def boot():
        services = build_services(Settings.from_dict(raw), device="cpu")
        on_loop(services.initialize())
        server = HTTPServer(build_app(services), "127.0.0.1", 0)
        on_loop(server.start())
        return services, server, f"http://127.0.0.1:{server.port}"
    services, server, base = boot()
    def call(path, body=None, ctype="application/json"):
        req = urllib.request.Request(base + path, data=body, headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())
    page = np.full((224, 224, 3), 255, np.uint8)
    page[40:90, 30:180] = (200, 30, 30)
    b = "jaxfree-boundary"
    body = (f'--{b}\\r\\nContent-Disposition: form-data; name="file"; filename="p.png"\\r\\n'
            'Content-Type: image/png\\r\\n\\r\\n').encode() + encode_png(page) + f"\\r\\n--{b}--\\r\\n".encode()
    doc = call("/ingest/file", body, f"multipart/form-data; boundary={b}")
    for _ in range(600):
        status = call(f"/documents/{doc['external_id']}/status")["status"]
        if status != "processing":
            break
        time.sleep(0.05)
    assert status == "completed", status
    hits = call("/retrieve/chunks", json.dumps({"query": "quarterly revenue", "k": 1}).encode())
    assert [h["document_id"] for h in hits] == [doc["external_id"]], hits
    answer = call("/query", json.dumps({"query": "quarterly revenue", "k": 1}).encode())
    assert answer["completion"] and answer["sources"][0]["document_id"] == doc["external_id"], answer
    # the text path: /ingest/text, then use_colpali=false retrieves, plain and reranked by the ColQwen tower
    tdoc = call("/ingest/text", json.dumps({"content": "supplier invoice renewal clause. " * 40,
                                            "use_colpali": False}).encode())
    assert tdoc["system_metadata"]["status"] == "completed", tdoc
    text_hits = {}
    for rerank in (False, True):
        text_hits[rerank] = call("/retrieve/chunks", json.dumps({"query": "supplier invoice", "k": 1, "use_colpali": False,
                                                                 "use_reranking": rerank}).encode())
        assert [h["document_id"] for h in text_hits[rerank]] == [tdoc["external_id"]], text_hits
    on_loop(server.stop())
    on_loop(services.shutdown())  # saves the index
    # a restart on the same directories keeps the row
    services, server, base = boot()
    again = call("/retrieve/chunks", json.dumps({"query": "quarterly revenue", "k": 1}).encode())
    assert [(h["document_id"], h["score"]) for h in again] == [(h["document_id"], h["score"]) for h in hits], again
    assert call("/health")["components"]["colpali"]["index_rows"] == {"default": 1}
    assert call("/health")["components"]["text_index_rows"] == {"default": 1}
    again = call("/retrieve/chunks", json.dumps({"query": "supplier invoice", "k": 1, "use_colpali": False}).encode())
    assert again == text_hits[False], again
    # documents as pages: a two-page PDF ingest, then a JPEG image query of the PNG page
    import base64, zlib
    from morphik_core_tpu_torch.utils.jpeg import encode_jpeg
    objs = [b"1 0 obj<</Type/Catalog/Pages 2 0 R>>endobj\\n",
            b"2 0 obj<</Type/Pages/Kids[3 0 R 5 0 R]/Count 2>>endobj\\n"]
    for i, text in enumerate([b"quarterly revenue AV office", b"supplier invoice"]):
        comp = zlib.compress(b"BT /F1 12 Tf 72 720 Td (" + text + b") Tj ET")
        objs.append(f"{3 + 2 * i} 0 obj<</Type/Page/Parent 2 0 R/Contents {4 + 2 * i} 0 R>>endobj\\n".encode())
        objs.append(f"{4 + 2 * i} 0 obj<</Length {len(comp)}/Filter/FlateDecode>>stream\\n".encode() + comp
                    + b"\\nendstream endobj\\n")
    pdf = b"%PDF-1.4\\n" + b"".join(objs) + b"trailer<</Root 1 0 R>>\\n%%EOF"
    body = (f'--{b}\\r\\nContent-Disposition: form-data; name="file"; filename="r.pdf"\\r\\n'
            'Content-Type: application/pdf\\r\\n\\r\\n').encode() + pdf + f"\\r\\n--{b}--\\r\\n".encode()
    pdoc = call("/ingest/file", body, f"multipart/form-data; boundary={b}")
    for _ in range(1200):
        pstatus = call(f"/documents/{pdoc['external_id']}/status")["status"]
        if pstatus != "processing":
            break
        time.sleep(0.05)
    assert pstatus == "completed", pstatus
    assert call(f"/documents/{pdoc['external_id']}")["system_metadata"]["page_count"] == 2
    q_img = "data:image/jpeg;base64," + base64.b64encode(encode_jpeg(page, 90)[0]).decode()
    img_hits = call("/retrieve/chunks", json.dumps({"query_image": q_img, "k": 3}).encode())
    assert img_hits[0]["document_id"] == doc["external_id"], img_hits
    assert {h["document_id"] for h in img_hits} == {doc["external_id"], pdoc["external_id"]}, img_hits
    # the corpus routes: a folder, an ingest into it, a scoped retrieve, /embeddings
    import io
    folder = call("/folders", json.dumps({"name": "Scoped"}).encode())
    body = (f'--{b}\\r\\nContent-Disposition: form-data; name="folder_name"\\r\\n\\r\\nScoped\\r\\n'
            f'--{b}\\r\\nContent-Disposition: form-data; name="file"; filename="s.png"\\r\\n'
            'Content-Type: image/png\\r\\n\\r\\n').encode() + encode_png(page[::-1].copy()) + f"\\r\\n--{b}--\\r\\n".encode()
    sdoc = call("/ingest/file", body, f"multipart/form-data; boundary={b}")
    assert sdoc["folder_path"] == folder["path"] == "/Scoped", sdoc
    for _ in range(600):
        if call(f"/documents/{sdoc['external_id']}/status")["status"] != "processing":
            break
        time.sleep(0.05)
    scoped = call("/retrieve/chunks", json.dumps({"query": "quarterly revenue", "k": 3, "folder_name": "/Scoped",
                                                  "folder_depth": -1}).encode())
    assert [h["document_id"] for h in scoped] == [sdoc["external_id"]], scoped
    req = urllib.request.Request(base + "/embeddings", data=json.dumps({"input_type": "image", "inputs": [q_img]}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        npz = np.load(io.BytesIO(resp.read()))
    assert npz.files == ["emb_0"] and npz["emb_0"].shape[1] == cfg.embedding_dim, npz["emb_0"].shape
    on_loop(server.stop())
    on_loop(services.shutdown())

    # /query through an LLM: a fake OpenAI-compatible provider and embedder, in cloud mode
    from morphik_core_tpu_torch.scripts.fake_providers import ANSWER, FakeProviders
    fake = FakeProviders(embed_dim=64).start()
    llm_raw = dict(raw, storage={"storage_path": root + "/llm_storage"}, database={"path": root + "/llm.sqlite"},
                   vector_store={"index_path": root + "/llm_index"}, morphik={"enable_colpali": False, "mode": "cloud"},
                   registered_models={"llm": {"model_name": "gpt-fake", "api_base": fake.url + "/v1"},
                                      "emb": {"model_name": "emb-fake", "api_base": fake.url + "/v1"}},
                   completion={"model": "llm"}, embedding={"model": "emb", "dimensions": 64})
    saved, raw = raw, llm_raw
    services, server, base = boot()
    raw = saved
    ldoc = call("/ingest/text", json.dumps({"content": "the turbine audit found a cracked blade. " * 20,
                                            "use_colpali": False}).encode())
    answer = call("/query", json.dumps({"query": "turbine audit", "k": 1, "use_colpali": False}).encode())
    assert answer["completion"] == ANSWER and answer["sources"][0]["document_id"] == ldoc["external_id"], answer
    assert fake.last("/v1/chat/completions")["body"]["messages"][-1]["content"].count("cracked blade") > 0
    b2 = "otf-boundary"
    body = (f'--{b2}\\r\\nContent-Disposition: form-data; name="prompt"\\r\\n\\r\\nWhat cracked?\\r\\n'
            f'--{b2}\\r\\nContent-Disposition: form-data; name="file"; filename="n.txt"\\r\\n'
            'Content-Type: text/plain\\r\\n\\r\\n').encode() + b"The blade cracked." + f"\\r\\n--{b2}--\\r\\n".encode()
    otf = call("/ingest/document/query", body, f"multipart/form-data; boundary={b2}")
    assert otf["completion"] == ANSWER and otf["metadata"]["parsed_chars"] == 18, otf
    assert call("/usage/limits")["usage"]["queries_used"] == 2
    on_loop(server.stop())
    on_loop(services.shutdown())
    fake.stop()

    # a checkpoint directory: written by the port, served through model.checkpoint_path
    import dataclasses, pathlib
    from morphik_core_tpu_torch.models.colqwen.convert import write_hf_checkpoint
    qcfg = dataclasses.replace(ColQwenConfig.tiny(151936), image_token_id=151655, vision_start_token_id=151652,
                               vision_end_token_id=151653)
    ckpt = pathlib.Path(root) / "ckpt"
    write_hf_checkpoint(ColQwenModel.init_random(qcfg, seed=1, device="cpu", dtype=torch.bfloat16), ckpt,
                        shard_bytes=4 << 20, tokenizer_file=pathlib.Path(sys.argv[1]) / "tests/fixtures/tokenizer_bpe.json")
    loaded = ColQwenModel.from_checkpoint(ckpt, device="cpu")
    assert loaded.tokenizer is not None and loaded.query_token_ids("x")[-1] == 151643
    assert loaded.image_sequence_ids(16)[0] == 151644
    raw = dict(raw, model={"static_act_scales": True, "checkpoint_path": str(ckpt)},
               storage={"storage_path": root + "/ck_storage"}, database={"path": root + "/ck.sqlite"},
               vector_store={"index_path": root + "/ck_index"})
    services, server, base = boot()
    assert services.colpali_embedding_model.model.tokenizer is not None
    body = (f'--{b}\\r\\nContent-Disposition: form-data; name="file"; filename="p.png"\\r\\n'
            'Content-Type: image/png\\r\\n\\r\\n').encode() + encode_png(page) + f"\\r\\n--{b}--\\r\\n".encode()
    cdoc = call("/ingest/file", body, f"multipart/form-data; boundary={b}")
    for _ in range(600):
        if call(f"/documents/{cdoc['external_id']}/status")["status"] != "processing":
            break
        time.sleep(0.05)
    hits = call("/retrieve/chunks", json.dumps({"query": "quarterly revenue", "k": 1}).encode())
    assert [h["document_id"] for h in hits] == [cdoc["external_id"]], hits
    on_loop(server.stop())
    on_loop(services.shutdown())
    loop.call_soon_threadsafe(loop.stop)
    """
) + _LEAKS

# an API node: server E (local mode, the development tiny model, a keyed
# /embeddings) and server A (colpali_mode="api" on E, parse and OCR through
# the fake endpoints), the ingest -> retrieve -> relay round trip
_API_NODE = _PRELUDE + textwrap.dedent(
    """
    import asyncio, base64, io, json, tempfile, threading, time, urllib.request
    from morphik_core_tpu_torch.api.app import build_app
    from morphik_core_tpu_torch.api.http import HTTPServer
    from morphik_core_tpu_torch.config import Settings
    from morphik_core_tpu_torch.scripts.fake_providers import FakeProviders, parse_answer
    from morphik_core_tpu_torch.services_init import build_services
    from morphik_core_tpu_torch.utils.png import encode_png

    root = tempfile.mkdtemp()
    loop = asyncio.new_event_loop()
    threading.Thread(target=loop.run_forever, daemon=True).start()
    def on_loop(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout=120)
    def boot(name, **sections):
        raw = {"storage": {"storage_path": f"{root}/{name}/storage"}, "database": {"path": f"{root}/{name}/db.sqlite"},
               "vector_store": {"index_path": f"{root}/{name}/index"},
               "telemetry": {"telemetry_dir": f"{root}/{name}/logs/telemetry"}, **sections}
        services = build_services(Settings.from_dict(raw), device="cpu")
        on_loop(services.initialize())
        server = HTTPServer(build_app(services), "127.0.0.1", 0)
        on_loop(server.start())
        return services, server, f"http://127.0.0.1:{server.port}"
    def call(base, path, body=None, ctype="application/json", key=None):
        headers = {"Content-Type": ctype, **({"Authorization": f"Bearer {key}"} if key else {})}
        with urllib.request.urlopen(urllib.request.Request(base + path, data=body, headers=headers), timeout=120) as r:
            raw = r.read()
            return json.loads(raw) if "json" in r.headers.get("Content-Type", "") else raw
    def upload(base, name, data, ctype, **fields):
        b = "api-node-boundary"
        body = b"".join(f'--{b}\\r\\nContent-Disposition: form-data; name="{k}"\\r\\n\\r\\n{v}\\r\\n'.encode()
                        for k, v in fields.items())
        body += (f'--{b}\\r\\nContent-Disposition: form-data; name="file"; filename="{name}"\\r\\n'
                 f'Content-Type: {ctype}\\r\\n\\r\\n').encode() + data + f"\\r\\n--{b}--\\r\\n".encode()
        doc = call(base, "/ingest/file", body, f"multipart/form-data; boundary={b}")
        for _ in range(600):
            st = call(base, f"/documents/{doc['external_id']}/status")["status"]
            if st != "processing":
                break
            time.sleep(0.05)
        assert st == "completed", st
        return doc["external_id"]

    fake = FakeProviders().start()
    e_services, e_server, e_base = boot("e", morphik={"morphik_embedding_api_key": "k1"})
    a_services, a_server, a_base = boot("a", morphik={"colpali_mode": "api", "morphik_embedding_api_key": "k1",
                                                      "morphik_embedding_api_endpoints": [e_base]},
                                        model={"embedding_dim": e_services.colpali_embedding_model.embedding_dim},
                                        parser={"parser_mode": "api", "parse_api_endpoints": [fake.url + "/parse"],
                                                "ocr_mode": "api", "ocr_api_endpoint": fake.url + "/ocr"})
    assert not hasattr(a_services.colpali_embedding_model, "model")
    page = np.full((224, 224, 3), 255, np.uint8)
    page[40:90, 30:180] = (200, 30, 30)
    png = encode_png(page)
    doc = upload(a_base, "p.png", png, "image/png")
    assert fake.last("/parse")["body"]["filename"] == "p.png"
    hits = call(a_base, "/retrieve/chunks", json.dumps({"query": "quarterly revenue", "k": 1}).encode())
    assert [h["document_id"] for h in hits] == [doc], hits
    uri = "data:image/png;base64," + base64.b64encode(png).decode()
    img_hits = call(a_base, "/retrieve/chunks", json.dumps({"query_image": uri, "k": 1}).encode())
    assert img_hits[0]["document_id"] == doc, img_hits
    text = call(a_base, "/retrieve/chunks", json.dumps({"query": parse_answer("p.png", png), "k": 1,
                                                        "use_colpali": False}).encode())
    assert text[0]["document_id"] == doc, text
    body = json.dumps({"input_type": "image", "inputs": [uri]}).encode()
    relayed, direct = (np.load(io.BytesIO(call(b, "/embeddings", body, key="k1")))["emb_0"] for b in (a_base, e_base))
    assert np.array_equal(relayed, direct)
    scan = (b"%PDF-1.4\\n1 0 obj<</Type/Catalog/Pages 2 0 R>>endobj\\n2 0 obj<</Type/Pages/Kids[3 0 R]/Count 1>>"
            b"endobj\\n3 0 obj<</Type/Page/Parent 2 0 R/MediaBox[0 0 612 792]>>endobj\\ntrailer<</Root 1 0 R>>\\n%%EOF")
    sdoc = upload(a_base, "scan.pdf", scan, "application/pdf", use_colpali="false")
    meta = call(a_base, f"/documents/{sdoc}")["additional_metadata"]
    assert meta.get("ocr_pages") == 1, meta
    assert call(a_base, "/health")["components"]["colpali"]["backend"] == "api"
    for server, services in ((a_server, a_services), (e_server, e_services)):
        on_loop(server.stop())
        on_loop(services.shutdown())
    fake.stop()
    loop.call_soon_threadsafe(loop.stop)
    """
) + _LEAKS


# the connectors: a local directory and the fake GitHub API, the console,
# the progressive and 16-bit Adam7 decodes against Pillow's hashes
_CONNECTORS = _PRELUDE + textwrap.dedent(
    """
    import asyncio, hashlib, json, tempfile, threading, time, urllib.request
    from pathlib import Path
    import morphik_core_tpu_torch.ee.connectors.github as gh
    from morphik_core_tpu_torch.api.app import build_app
    from morphik_core_tpu_torch.api.http import HTTPServer
    from morphik_core_tpu_torch.config import Settings
    from morphik_core_tpu_torch.models.colqwen.preprocess import to_rgb_u8
    from morphik_core_tpu_torch.scripts.fake_providers import GITHUB_TOKEN, FakeProviders
    from morphik_core_tpu_torch.services_init import build_services
    from morphik_core_tpu_torch.utils.image import read_image

    z = np.load(Path(sys.argv[1]) / "tests" / "fixtures" / "connector_files.npz")
    for key in ("progressive_jpg", "gray16_png"):
        rgb = to_rgb_u8(*read_image(z[key].tobytes()))
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == str(z[key + "_rgb_sha256"]), key
    root = Path(tempfile.mkdtemp())
    src = root / "src"
    src.mkdir()
    (src / "page.jpg").write_bytes(z["progressive_jpg"].tobytes())
    (src / "gray16.png").write_bytes(z["gray16_png"].tobytes())
    fake = FakeProviders().start()
    fake.add_github_file("acme/docs", "README.md", b"# warp core alignment 7 degrees")
    gh.API = fake.url + "/github"
    loop = asyncio.new_event_loop()
    threading.Thread(target=loop.run_forever, daemon=True).start()
    def on_loop(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout=120)
    raw = {"storage": {"storage_path": str(root / "storage")}, "database": {"path": str(root / "db.sqlite")},
           "vector_store": {"index_path": str(root / "index")},
           "telemetry": {"telemetry_dir": str(root / "logs" / "telemetry")}}
    services = build_services(Settings.from_dict(raw), device="cpu")
    on_loop(services.initialize())
    server = HTTPServer(build_app(services), "127.0.0.1", 0)
    on_loop(server.start())
    base = f"http://127.0.0.1:{server.port}"
    def call(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(base + path, data=data, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            raw = r.read()
            return json.loads(raw) if "json" in r.headers.get("Content-Type", "") else raw
    def ingest(kind, file_id):
        doc = call(f"/ee/connectors/{kind}/ingest", {"file_id": file_id})["document"]
        for _ in range(1200):
            st = call(f"/documents/{doc['external_id']}/status")["status"]
            if st != "processing":
                break
            time.sleep(0.05)
        assert st == "completed", st
        return doc["external_id"]
    assert call("/ee/connectors/local/auth/finalize", {"root": str(src)}) == {"status": "authenticated"}
    assert [f["name"] for f in call("/ee/connectors/local/files")["files"]] == ["gray16.png", "page.jpg"]
    docs = [ingest("local", "page.jpg"), ingest("local", "gray16.png")]
    hits = call("/retrieve/chunks", {"query": "quarterly revenue", "k": 2})
    assert sorted(h["document_id"] for h in hits) == sorted(docs), hits
    assert call("/ee/connectors/github/auth/finalize", {"token": GITHUB_TOKEN, "repo": "acme/docs"})
    assert [f["name"] for f in call("/ee/connectors/github/files")["files"]] == ["README.md"]
    ingest("github", "README.md")
    console = call("/console")
    assert console == (Path(sys.argv[1]) / "morphik_core_tpu_torch" / "api" / "console.html").read_bytes()
    on_loop(server.stop())
    on_loop(services.shutdown())
    fake.stop()
    loop.call_soon_threadsafe(loop.stop)
    """
) + _LEAKS


# the page image formats: every committed fixture file decoded to Pillow's
# mode and pixel hash, then one upload of each new format over HTTP and an
# image query in WebP and in TIFF, each finding its own page first
_FORMATS = _PRELUDE + textwrap.dedent(
    """
    import asyncio, base64, hashlib, json, tempfile, threading, time, urllib.request
    from pathlib import Path
    from morphik_core_tpu_torch.api.app import build_app
    from morphik_core_tpu_torch.api.http import HTTPServer
    from morphik_core_tpu_torch.config import Settings
    from morphik_core_tpu_torch.services_init import build_services
    from morphik_core_tpu_torch.utils.image import decode_image, read_image

    z = np.load(Path(sys.argv[1]) / "tests" / "fixtures" / "image_formats.npz")
    names = [k for k in z.files if k + "_rgb_sha256" in z.files]
    assert len(names) >= 30, names
    for key in names:
        data = z[key].tobytes()
        assert read_image(data)[1] == str(z[key + "_mode"]), key
        assert hashlib.sha256(decode_image(data).tobytes()).hexdigest() == str(z[key + "_rgb_sha256"]), key
    root = Path(tempfile.mkdtemp())
    loop = asyncio.new_event_loop()
    threading.Thread(target=loop.run_forever, daemon=True).start()
    def on_loop(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout=120)
    raw = {"storage": {"storage_path": str(root / "storage")}, "database": {"path": str(root / "db.sqlite")},
           "vector_store": {"index_path": str(root / "index")},
           "telemetry": {"telemetry_dir": str(root / "logs" / "telemetry")}}
    services = build_services(Settings.from_dict(raw), device="cpu")
    on_loop(services.initialize())
    server = HTTPServer(build_app(services), "127.0.0.1", 0)
    on_loop(server.start())
    base = f"http://127.0.0.1:{server.port}"
    def call(path, body, ctype="application/json"):
        req = urllib.request.Request(base + path, data=body, headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())
    uploads = [("page_gif", "image/gif"), ("bmp24_bmp", "image/bmp"), ("g4_tif", "image/tiff"),
               ("lzw_tif", "image/tiff"), ("lossy_webp", "image/webp"), ("cmyk_jpg", "image/jpeg")]
    docs = {}
    for key, ctype in uploads:
        b = "XyZ"
        body = (f'--{b}\\r\\nContent-Disposition: form-data; name="file"; filename="{key}"\\r\\n'
                f'Content-Type: {ctype}\\r\\n\\r\\n').encode() + z[key].tobytes() + f"\\r\\n--{b}--\\r\\n".encode()
        doc = call("/ingest/file", body, f"multipart/form-data; boundary={b}")
        for _ in range(1200):
            req = urllib.request.Request(base + f"/documents/{doc['external_id']}/status")
            with urllib.request.urlopen(req, timeout=60) as r:
                st = json.loads(r.read())["status"]
            if st != "processing":
                break
            time.sleep(0.05)
        assert st == "completed", (key, st)
        docs[key] = doc["external_id"]
    for key, ctype in (("lossy_webp", "image/webp"), ("g4_tif", "image/tiff")):
        uri = f"data:{ctype};base64," + base64.b64encode(z[key].tobytes()).decode()
        hits = call("/retrieve/chunks", json.dumps({"query_image": uri, "k": 3}).encode())
        assert hits[0]["document_id"] == docs[key], (key, hits)
    on_loop(server.stop())
    on_loop(services.shutdown())
    loop.call_soon_threadsafe(loop.stop)
    """
) + _LEAKS


# the binary store, the dual store, and three operator scripts on a seeded
# deployment (a database, local storage with payloads, an fde index)
_BINARY_AND_SCRIPTS = _PRELUDE + textwrap.dedent(
    """
    import asyncio, contextlib, io, json, sqlite3, tempfile
    from pathlib import Path
    from morphik_core_tpu_torch.database.sqlite_database import SQLiteDatabase
    from morphik_core_tpu_torch.models.schemas import DocumentChunk
    from morphik_core_tpu_torch.ops.fde import FDEConfig
    from morphik_core_tpu_torch.scripts import check_completeness, export_chunks_resumable, migrate_store_provider
    from morphik_core_tpu_torch.storage.local_storage import LocalStorage
    from morphik_core_tpu_torch.vector_store.dual_multivector_store import DualMultiVectorStore
    from morphik_core_tpu_torch.vector_store.torch_multivector_store import TorchMultiVectorStore

    root = Path(tempfile.mkdtemp())
    rng = np.random.default_rng(0)
    fde = FDEConfig(dimension=16, num_repetitions=4, num_simhash_projections=3, projection_dimension=8)
    storage = LocalStorage(root / "store")
    mvs = [rng.standard_normal((int(rng.integers(3, 9)), 16)).astype(np.float32) for _ in range(6)]
    chunks = [DocumentChunk(document_id=f"d{i // 2}", chunk_number=i % 2, content=f"text {i}", embedding=mv,
                            metadata={"i": i}) for i, mv in enumerate(mvs)]
    fde_store = TorchMultiVectorStore(storage=storage, fde_config=fde, index_path=root / "index", device="cpu")
    binary = TorchMultiVectorStore(storage=storage, fde_config=fde, device="cpu", provider="binary")
    dual = DualMultiVectorStore(fde_store, binary)
    async def go():
        await dual.initialize()
        ok, ids, _ = await dual.store_embeddings(chunks)
        assert ok and ids[0] == "d0-0"
        top = await binary.query_similar(mvs[3], k=2)
        assert (top[0].document_id, top[0].chunk_number, top[0].score) == ("d1", 1, float(len(mvs[3])))
        a = await dual.query_similar(mvs[4], k=3)
        b = await fde_store.query_similar(mvs[4], k=3)
        assert [(c.document_id, c.chunk_number) for c in a] == [(c.document_id, c.chunk_number) for c in b]
        assert await dual.delete_chunks_by_document_id("d2")
        assert "d2" not in [c.document_id for c in await binary.query_similar(mvs[4], k=6)]
    asyncio.run(go())
    fde_store.save()
    binary.save()
    db = SQLiteDatabase(root / "db.sqlite")
    asyncio.run(db.initialize())
    db.close()
    conn = sqlite3.connect(root / "db.sqlite")
    for d in ("d0", "d1"):
        conn.execute("INSERT INTO documents (external_id, owner_id, status, chunk_ids) VALUES (?,?,?,?)",
                     (d, "migration", "completed", json.dumps([f"{d}-0", f"{d}-1"])))
    conn.commit()
    conn.close()
    cfg = root / "cfg.toml"
    cfg.write_text(f'[model]\\nembedding_dim = 16\\n[database]\\npath = "{root / "db.sqlite"}"\\n'
                   f'[storage]\\nstorage_path = "{root / "store"}"\\n[vector_store]\\nindex_path = "{root / "index"}"\\n'
                   'fde_num_repetitions = 4\\nfde_num_simhash_projections = 3\\nfde_projection_dimension = 8\\n')
    def run(main, *argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            rc = main([*argv, "--config", str(cfg), "--device", "cpu"])
        return rc, buf.getvalue()
    rc, out = run(check_completeness.main)
    assert rc == 0 and json.loads(out)["namespaces"] == {"default": {"index_rows": 4, "index_docs": 2}}, out
    rc, out = run(export_chunks_resumable.main, "--out", str(root / "export"), "--batch", "3")
    assert rc == 0 and json.loads(out)["exported"] == 4, out
    (root / "index" / "provider_fde").mkdir()
    (root / "index" / "default").rename(root / "index" / "provider_fde" / "default")
    ckpt = str(root / "ckpt.json")
    rc, out = run(migrate_store_provider.main, "--from", "fde", "--to", "fde", "--checkpoint", ckpt)
    assert rc == 0 and "migrated=2" in out, out
    rc, out = run(migrate_store_provider.main, "--from", "fde", "--to", "binary", "--checkpoint", ckpt + ".b")
    assert rc == 2 and "refusing --to binary" in out and not Path(ckpt + ".b").exists(), out
    """
) + _LEAKS


_EVALS = _PRELUDE + textwrap.dedent(
    """
    import asyncio, contextlib, io, json
    from morphik_core_tpu_torch.evaluations import colpali_eval, fidelity_eval, run_offline_eval
    from morphik_core_tpu_torch.scripts import profile_int8

    def run(main, *argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main([*argv, "--cpu"])
        return rc, json.loads(buf.getvalue().strip().splitlines()[-1])

    rc, rep = run(fidelity_eval.main, "--small")
    assert rc in (0, 1) and rep["gate"]["int8_default_approved"] == (rc == 0), rep
    assert rep["part_a_ranking_agreement"]["n_pages"] == 24 and rep["part_b_fde_recall_at_scale"]["n_docs"] == 2000
    args = colpali_eval.parse_args(["--docs", "2", "--pages", "4", "--queries", "3", "--templates", "0", "--cpu"])
    args.small = True
    rep = asyncio.run(colpali_eval.run_eval(args, device="cpu"))
    assert rep["visual_ladder"]["identity"]["recall_at_1"] == 1.0 and rep["serving_precision"] == "f32", rep
    rc, rep = run(run_offline_eval.main)
    assert rc == 0 and rep["recall_at_4"] == 1.0 and rep["n_questions"] == 3, rep
    rc, rep = run(profile_int8.main, "--small")
    assert rc == 0 and len(rep["matmul_families"]) == 7, rep
    """
) + _LEAKS



_TEXT_PAGES = "import sys\nsys.modules['fontTools'] = None\n" + _PRELUDE + textwrap.dedent(
    """
    import asyncio, base64, types
    from morphik_core_tpu_torch.config import Settings
    from morphik_core_tpu_torch.parser.office import docx_to_text
    from morphik_core_tpu_torch.parser.raster_pool import RasterPool
    from morphik_core_tpu_torch.services.ingestion_service import IngestionService
    from morphik_core_tpu_torch.storage.content_types import DOCX, PPTX

    z = np.load(sys.argv[1] + "/tests/fixtures/text_pages.npz")

    def unpack(key):
        flat, sizes = z[key].tobytes(), z[key + "_sizes"]
        starts = np.concatenate([[0], np.cumsum(sizes)])
        return [flat[a:b] for a, b in zip(starts, starts[1:])]

    settings = types.SimpleNamespace(settings=Settings())
    for kind, ctype in (("docx", DOCX), ("pptx", PPTX)):
        data = z[kind].tobytes()
        chunks = IngestionService._create_chunks_multivector(settings, ctype, data,
                                                             docx_to_text(data) if kind == "docx" else "")
        assert [base64.b64decode(c.content.split(",", 1)[1]) for c in chunks] == unpack(kind + "_payloads"), kind
    pool = RasterPool(1)
    assert [p[1] for p in asyncio.run(pool.rasterize_pdf_jpegs(z["pdf"].tobytes(), dpi=150))] == unpack(
        "pdf_payloads")
    u = np.load(sys.argv[1] + "/tests/fixtures/unicode17_pages.npz")
    flat, sizes = u["tone_pdf_payloads"].tobytes(), u["tone_pdf_payloads_sizes"]
    starts = np.concatenate([[0], np.cumsum(sizes)])
    assert [p[1] for p in asyncio.run(pool.rasterize_pdf_jpegs(z["refused_pdf"].tobytes(), dpi=150))] == [
        flat[a:b] for a, b in zip(starts, starts[1:])], "the page of tone letters"
    assert sys.modules["fontTools"] is None
    """
) + _LEAKS

_RTL_PAGES = "import sys\nsys.modules['fontTools'] = None\n" + _PRELUDE + textwrap.dedent(
    """
    import asyncio, base64, types
    from morphik_core_tpu_torch.config import Settings
    from morphik_core_tpu_torch.parser.office import docx_to_text
    from morphik_core_tpu_torch.parser.raster_pool import RasterPool
    from morphik_core_tpu_torch.services.ingestion_service import IngestionService
    from morphik_core_tpu_torch.storage.content_types import DOCX, PPTX

    z = np.load(sys.argv[1] + "/tests/fixtures/rtl_pages.npz")

    def unpack(key):
        flat, sizes = z[key].tobytes(), z[key + "_sizes"]
        starts = np.concatenate([[0], np.cumsum(sizes)])
        return [flat[a:b] for a, b in zip(starts, starts[1:])]

    def bidi_libraries(maps):
        return [line for line in maps.splitlines() if "fribidi" in line or "harfbuzz" in line]

    settings = types.SimpleNamespace(settings=Settings())
    for kind, ctype in (("docx", DOCX), ("pptx", PPTX)):
        data = z[kind].tobytes()
        chunks = IngestionService._create_chunks_multivector(settings, ctype, data,
                                                             docx_to_text(data) if kind == "docx" else "")
        assert [base64.b64decode(c.content.split(",", 1)[1]) for c in chunks] == unpack(kind + "_payloads"), kind
    pool = RasterPool(2)
    try:
        pages = asyncio.run(pool.rasterize_pdf_jpegs(z["pdf"].tobytes(), dpi=150))
        assert [p[1] for p in pages] == unpack("pdf_payloads")
        child = pool._pool.submit(eval, "open('/proc/self/maps').read()").result()
    finally:
        pool.shutdown()
    assert not bidi_libraries(open("/proc/self/maps").read()) and not bidi_libraries(child)
    assert sys.modules["fontTools"] is None
    """
) + _LEAKS

_MARK_PAGES = "import sys\nsys.modules['fontTools'] = None\n" + _PRELUDE + textwrap.dedent(
    """
    import asyncio, base64, types
    from morphik_core_tpu_torch.config import Settings
    from morphik_core_tpu_torch.parser.office import docx_to_text
    from morphik_core_tpu_torch.parser.raster_pool import RasterPool
    from morphik_core_tpu_torch.services.ingestion_service import IngestionService
    from morphik_core_tpu_torch.storage.content_types import DOCX, PPTX

    z = np.load(sys.argv[1] + "/tests/fixtures/mark_pages.npz")
    u = np.load(sys.argv[1] + "/tests/fixtures/unicode17_pages.npz")

    def unpack(key, f=z):
        flat, sizes = f[key].tobytes(), f[key + "_sizes"]
        starts = np.concatenate([[0], np.cumsum(sizes)])
        return [flat[a:b] for a, b in zip(starts, starts[1:])]

    def font_libraries(maps):
        return [line for line in maps.splitlines() if any(n in line for n in ("fribidi", "harfbuzz", "freetype"))]

    settings = types.SimpleNamespace(settings=Settings())
    for kind, ctype in (("docx", DOCX), ("pptx", PPTX)):
        data = z[kind].tobytes()
        chunks = IngestionService._create_chunks_multivector(settings, ctype, data,
                                                             docx_to_text(data) if kind == "docx" else "")
        assert [base64.b64decode(c.content.split(",", 1)[1]) for c in chunks] == unpack(kind + "_payloads"), kind
    pool = RasterPool(2)
    try:
        pages = asyncio.run(pool.rasterize_pdf_jpegs(z["pdf"].tobytes(), dpi=150))
        assert [p[1] for p in pages] == unpack("pdf_payloads")
        pages = asyncio.run(pool.rasterize_pdf_jpegs(z["refused_pdf"].tobytes(), dpi=150))
        assert [p[1] for p in pages] == unpack("unicode16_pdf_payloads", u), "the page of U+1C89"
        child = pool._pool.submit(eval, "open('/proc/self/maps').read()").result()
    finally:
        pool.shutdown()
    assert "morphik_core_tpu_torch.parser.marks" in sys.modules
    assert not font_libraries(open("/proc/self/maps").read()) and not font_libraries(child)
    assert sys.modules["fontTools"] is None
    """
) + _LEAKS


_PAYLOADS_LINE = '    assert [p[1] for p in pages] == unpack("pdf_payloads")\n'
_COMPLEX_PAGES = "import sys\nsys.modules['fontTools'] = None\n" + _PRELUDE + textwrap.dedent(
    """
    import asyncio, base64, types
    from morphik_core_tpu_torch.config import Settings
    from morphik_core_tpu_torch.parser.office import docx_to_text
    from morphik_core_tpu_torch.parser.raster_pool import RasterPool
    from morphik_core_tpu_torch.parser.text_render import render_text_page
    from morphik_core_tpu_torch.services.ingestion_service import IngestionService
    from morphik_core_tpu_torch.storage.content_types import DOCX, PPTX

    z = np.load(sys.argv[1] + "/tests/fixtures/complex_pages.npz")

    def unpack(key):
        flat, sizes = z[key].tobytes(), z[key + "_sizes"]
        starts = np.concatenate([[0], np.cumsum(sizes)])
        return [flat[a:b] for a, b in zip(starts, starts[1:])]

    def font_libraries(maps):
        return [line for line in maps.splitlines() if any(n in line for n in ("fribidi", "harfbuzz", "freetype"))]

    settings = types.SimpleNamespace(settings=Settings())
    for kind, ctype in (("docx", DOCX), ("pptx", PPTX)):
        data = z[kind].tobytes()
        chunks = IngestionService._create_chunks_multivector(settings, ctype, data,
                                                             docx_to_text(data) if kind == "docx" else "")
        assert [base64.b64decode(c.content.split(",", 1)[1]) for c in chunks] == unpack(kind + "_payloads"), kind
    names = [str(n) for n in z["timing_names"]]
    for name in ("hindi", "khmer"):
        page = render_text_page(str(z["timing_texts"][names.index(name)]), 150)
        assert page.shape == (1650, 1275, 3) and int((page < 128).sum()) > 10000, name
    pool = RasterPool(2)
    try:
        pages = asyncio.run(pool.rasterize_pdf_jpegs(z["pdf"].tobytes(), dpi=150))
        assert [p[1] for p in pages] == unpack("pdf_payloads")
        child = pool._pool.submit(eval, "open('/proc/self/maps').read()").result()
    finally:
        pool.shutdown()
    for name in ("khmer", "thai", "hangul", "use"):
        assert "morphik_core_tpu_torch.parser." + name in sys.modules, name
    assert not font_libraries(open("/proc/self/maps").read()) and not font_libraries(child)
    assert sys.modules["fontTools"] is None
    """
) + _LEAKS


# the N'Ko fixture through the same paths: N'Ko's USE shaper and joining, the newer Arabic letters, Ahom
_NKO_PAGES = _COMPLEX_PAGES.replace("complex_pages.npz", "nko_pages.npz").replace(
    '("hindi", "khmer")', '("nko", "arabic_newer")').replace('("khmer", "thai", "hangul", "use")', '("use", "arabic")')
# the Unicode 17 fixture through the same paths, its PDF at 72 and 300 dpi too
_UNICODE17_PAGES = _COMPLEX_PAGES.replace("complex_pages.npz", "unicode17_pages.npz").replace(
    '("hindi", "khmer")', '("unicode17", "tone_contours")').replace(
    '("khmer", "thai", "hangul", "use")', '("bidi", "arabic")').replace(
    _PAYLOADS_LINE, _PAYLOADS_LINE + "".join(
        f"    assert [p[1] for p in asyncio.run(pool.rasterize_pdf_jpegs(z['pdf'].tobytes(), dpi={dpi}))] == "
        f"unpack('pdf_payloads_{dpi}')\n" for dpi in (72, 300)))


def test_evals_run_with_jax_pil_pydantic_httpx_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _EVALS, str(ROOT)], capture_output=True, text=True, timeout=400,
    )
    assert proc.returncode == 0 and "JAXFREE_OK" in proc.stdout, proc.stdout + proc.stderr


def test_binary_store_and_scripts_run_with_jax_pil_pydantic_httpx_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BINARY_AND_SCRIPTS, str(ROOT)], capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and "JAXFREE_OK" in proc.stdout, proc.stdout + proc.stderr


def test_slice_runs_with_jax_pil_pydantic_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _GUARD, str(ROOT)], capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and "JAXFREE_OK" in proc.stdout, proc.stdout + proc.stderr


def test_api_node_runs_with_jax_pil_pydantic_httpx_boto3_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _API_NODE, str(ROOT)], capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and "JAXFREE_OK" in proc.stdout, proc.stdout + proc.stderr


def test_connectors_and_decoders_run_with_jax_pil_pydantic_httpx_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _CONNECTORS, str(ROOT)], capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and "JAXFREE_OK" in proc.stdout, proc.stdout + proc.stderr


def test_image_formats_ingest_with_jax_pil_pydantic_httpx_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _FORMATS, str(ROOT)], capture_output=True, text=True, timeout=400,
    )
    assert proc.returncode == 0 and "JAXFREE_OK" in proc.stdout, proc.stdout + proc.stderr



def test_text_pages_render_with_jax_pil_fonttools_blocked():
    """The render path of every script (the DOCX, PPTX and PDF of
    `tests/fixtures/text_pages.npz`, and its PDF with a page of tone
    letters) stores the reference's payloads with jax, PIL and fontTools
    unimportable."""
    proc = subprocess.run(
        [sys.executable, "-c", _TEXT_PAGES, str(ROOT)], capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and "JAXFREE_OK" in proc.stdout, proc.stdout + proc.stderr

def test_rtl_pages_render_with_jax_pil_fonttools_blocked():
    """The Hebrew DOCX, Arabic PPTX and mixed PDF of
    `tests/fixtures/rtl_pages.npz` store the reference's payloads (the PDF
    through a 2-process raster pool) with jax, PIL and fontTools
    unimportable, and neither the serving process nor a raster child maps
    libfribidi or libharfbuzz."""
    proc = subprocess.run(
        [sys.executable, "-c", _RTL_PAGES, str(ROOT)], capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and "JAXFREE_OK" in proc.stdout, proc.stdout + proc.stderr


def test_mark_pages_render_with_jax_pil_fonttools_blocked():
    """The marks placed by `parser/marks.py` (the DOCX, PPTX and PDF of
    `tests/fixtures/mark_pages.npz`, and its PDF with a page of U+1C89)
    store the reference's payloads with jax, PIL and fontTools
    unimportable; no process maps libfribidi, libharfbuzz or FreeType."""
    proc = subprocess.run(
        [sys.executable, "-c", _MARK_PAGES, str(ROOT)], capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and "JAXFREE_OK" in proc.stdout, proc.stdout + proc.stderr


def test_complex_pages_render_with_jax_pil_fonttools_blocked():
    """The complex scripts (the Hindi, Bengali and Tamil DOCX, the Thai,
    Lao and Khmer PPTX and the Myanmar ... jamo PDF of
    `tests/fixtures/complex_pages.npz`) store the reference's payloads,
    and a Hindi and a Khmer page draw, with jax, PIL and fontTools
    unimportable; no process maps libfribidi, libharfbuzz or FreeType."""
    proc = subprocess.run(
        [sys.executable, "-c", _COMPLEX_PAGES, str(ROOT)], capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and "JAXFREE_OK" in proc.stdout, proc.stdout + proc.stderr


def test_package_data_lists_every_file_the_port_opens():
    """An installed (non-editable) port has every non-Python file of its
    package: each is matched by `pyproject.toml`'s package-data, and each
    data file the sources name exists."""
    patterns = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]["setuptools"]["package-data"][
        "morphik_core_tpu_torch"]
    pkg = ROOT / "morphik_core_tpu_torch"
    listed = {p for pattern in patterns for p in pkg.glob(pattern)}
    data = {p for p in pkg.rglob("*") if p.is_file() and p.suffix not in (".py", ".pyc")
            and "__pycache__" not in p.parts and "_build" not in p.relative_to(pkg).parts}
    assert data and data <= listed, sorted(str(p.relative_to(pkg)) for p in data - listed)
    # files found beside a module: `Path(__file__).with_name(...)` / `.parent / "..."`
    beside = re.compile(r"__file__\)\.(?:with_name\(|parent / )\"([\w.-]+\.\w+)\"")
    named = {n for f in pkg.rglob("*.py") for n in beside.findall(f.read_text())}
    assert {"glyphs_dejavu_sans.npz", "calib_pages_u8.npz", "console.html", "glyphs_pil_default.npz"} <= named
    assert named <= {p.name for p in listed}, named - {p.name for p in listed}
    # the kernel sources the build compiles (`ops/_kernels.py` globs csrc/*.cu)
    assert {"maxsim.cu", "window_attention.cu", "binary_maxsim.cu"} <= {p.name for p in listed if p.suffix == ".cu"}


def test_no_module_level_import_of_optional_packages():
    """boto3 and pytesseract are imported where S3 storage and the
    tesseract engine are built, never when a module is imported."""
    pattern = re.compile(r"^(import|from) (boto3|pytesseract)\b", re.M)
    files = sorted((ROOT / "morphik_core_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert not [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    lazy = re.compile(r"^\s+import (boto3|pytesseract)\b", re.M)
    assert sorted(str(f.relative_to(ROOT)) for f in files if lazy.search(f.read_text())) == [
        "morphik_core_tpu_torch/parser/ocr.py", "morphik_core_tpu_torch/storage/s3_storage.py"]


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import (jax|pydantic|httpx|safetensors|tokenizers|ml_dtypes|regex|transformers)\b"
                         r"|from (jax|pydantic|httpx|safetensors|tokenizers|ml_dtypes|regex|transformers)\b"
                         r"|import morphik_core_tpu\b(?!_)|from morphik_core_tpu\b(?!_))", re.M)
    files = sorted((ROOT / "morphik_core_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_nko_pages_render_with_jax_pil_fonttools_blocked():
    """The N'Ko DOCX and PPTX and the PDF of N'Ko, the newer Arabic letters
    and Ahom (`tests/fixtures/nko_pages.npz`) store the reference's payloads
    with jax, PIL and fontTools unimportable; no process maps libfribidi,
    libharfbuzz or FreeType."""
    proc = subprocess.run(
        [sys.executable, "-c", _NKO_PAGES, str(ROOT)], capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and "JAXFREE_OK" in proc.stdout, proc.stdout + proc.stderr


def test_unicode17_pages_render_with_jax_pil_fonttools_blocked():
    """Tone contours, ZWJ emoji in Hebrew and Arabic, CJK Extensions I and
    J, Garay, Unicode 16-17 letters, isolates open at paragraph separators
    and more than 62 bidi controls (`tests/fixtures/unicode17_pages.npz`)
    store the reference's payloads, the PDF at 150, 72 and 300 dpi, with
    jax, PIL and fontTools unimportable; no process maps libfribidi,
    libharfbuzz or FreeType."""
    assert "pdf_payloads_300" in _UNICODE17_PAGES
    proc = subprocess.run(
        [sys.executable, "-c", _UNICODE17_PAGES, str(ROOT)], capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and "JAXFREE_OK" in proc.stdout, proc.stdout + proc.stderr
