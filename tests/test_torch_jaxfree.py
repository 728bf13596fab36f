"""The port's main path imports neither jax, PIL, pydantic nor httpx
(none is installed beside the card), nor anything of the JAX package:
the shipped int8 embedder calibrates its static scales from the
committed pages and serves ingest and queries, the bf16 embedder still
runs, and the port's HTTP server boots on the CPU and answers an
ingest -> retrieve -> query round trip over a socket, then ingests a
PDF as page images and answers a JPEG image query, then creates a
folder, ingests a page into it, answers a folder-scoped retrieve and an
`/embeddings` call."""

import re
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_GUARD = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    for name in ("jax", "jaxlib", "PIL", "pydantic", "httpx"):
        sys.modules[name] = None  # any import of them now raises
    sys.path.insert(0, sys.argv[1])
    import numpy as np, torch
    torch.set_num_threads(2)
    import morphik_core_tpu_torch
    for m in pkgutil.walk_packages(morphik_core_tpu_torch.__path__, "morphik_core_tpu_torch."):
        importlib.import_module(m.name)
    import chip_smoke  # noqa: F401  (imports only; main() is not run)

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
    loop.call_soon_threadsafe(loop.stop)

    leaked = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "PIL", "pydantic", "httpx", "morphik_core_tpu")
                    and sys.modules[k] is not None)
    assert not leaked, leaked
    print("JAXFREE_OK")
    """
)


def test_slice_runs_with_jax_pil_pydantic_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _GUARD, str(ROOT)], capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and "JAXFREE_OK" in proc.stdout, proc.stdout + proc.stderr


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import (jax|pydantic|httpx)|from (jax|pydantic|httpx)"
                         r"|import morphik_core_tpu\b(?!_)|from morphik_core_tpu\b(?!_))", re.M)
    files = sorted((ROOT / "morphik_core_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
