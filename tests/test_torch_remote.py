"""The remote ColPali embedder (`morphik.colpali_mode="api"`) of the port
against the JAX package's, on the CPU.

- Scheduling: the same fake endpoints (answers made from a numpy seed of
  each input) given to both packages' `ColpaliApiEmbeddingModel` see the
  same calls and give the same embeddings: interleaved shards, a failed
  shard retried on the survivor, the all-down reset, 413 halving, a
  batch-1 413 that leaves health alone, the image / text stream split,
  the health cooldown with the clock patched.
- Query images: the PNG the port sends decodes to the pixels of the PNG
  the reference sends for the same RGB, RGBA or palette upload.
- A keyed endpoint: the reference's API node (built without the key)
  gets 401 and `AllEndpointsDown`; the port's sends the key and gets the
  endpoint's embeddings.
- An API node on the CPU: server E (local mode, the fixture model) and
  server A (api mode: a closed port, then E): A's retrieves equal E's
  own over the same PNG uploads, A stores E's embeddings bit for bit with
  their document FDE, `/embeddings` relays bit for bit, `/health` reports
  the "api" backend.
"""

import asyncio
import base64
import io
import json
import socket
import threading
import time
import urllib.error
import urllib.request
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from morphik_core_tpu.config import Settings as JSettings
from morphik_core_tpu.embedding import colpali_api_embedding_model as jmod
from morphik_core_tpu.models.schemas import Chunk as JChunk
from morphik_core_tpu.services_init import build_services as j_build_services
from morphik_core_tpu_torch.api.app import build_app
from morphik_core_tpu_torch.api.http import HTTPServer
from morphik_core_tpu_torch.config import Settings
from morphik_core_tpu_torch.embedding import colpali_api_embedding_model as tmod
from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel
from morphik_core_tpu_torch.models.schemas import Chunk as TChunk
from morphik_core_tpu_torch.ops.fde import fde_document_batch
from morphik_core_tpu_torch.services_init import build_services
from morphik_core_tpu_torch.utils.fast_ops import data_uri_to_bytes
from morphik_core_tpu_torch.utils.image import decode_image
from morphik_core_tpu_torch.utils.png import encode_png

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "tiny_colqwen.npz"
SMALL_FDE = {"fde_num_repetitions": 8, "fde_num_simhash_projections": 4, "fde_projection_dimension": 8}
PKGS = {"torch": (tmod, TChunk), "jax": (jmod, JChunk)}
KEY = "embedding-key-7"


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _emb(value: str) -> np.ndarray:
    """A fake endpoint's multivector of one input, made from a seed of it."""
    rng = np.random.default_rng(zlib.crc32(value.encode()))
    return rng.standard_normal((3, 8)).astype(np.float32)


def _model(mod, endpoints, post):
    m = mod.ColpaliApiEmbeddingModel(endpoints, embedding_dim=8)
    m._post_sync = post
    return m


def _outcome(coro):
    """-> ("ok", the embeddings as lists) or ("raised", exception type name)."""
    try:
        return "ok", [np.asarray(e).tolist() for e in _run(coro)]
    except Exception as e:  # noqa: BLE001 — the exception type is the outcome compared
        return "raised", type(e).__name__


def _health(m):
    return {ep: h.healthy for ep, h in m._health.items()}


def _case_shards(mod, Chunk, calls):
    def post(ep, input_type, inputs):
        calls.append((ep, input_type, list(inputs)))
        return [_emb(v) for v in inputs]

    m = _model(mod, ["http://a", "http://b/", "http://c"], post)
    return [_outcome(m._embed_batch("text", [f"t{i}" for i in range(7)])), m.endpoints]


def _case_failover(mod, Chunk, calls):
    def post(ep, input_type, inputs):
        calls.append((ep, input_type, list(inputs)))
        if ep == "http://bad":
            raise ConnectionError("down")
        return [_emb(v) for v in inputs]

    m = _model(mod, ["http://bad", "http://good"], post)
    first = _outcome(m._embed_batch("text", ["x", "y", "z"]))
    health = _health(m)
    second = _outcome(m._embed_batch("text", ["p", "q"]))  # the survivor alone, within the cooldown
    return [first, health, second, _health(m)]


def _case_all_down(mod, Chunk, calls):
    def post(ep, input_type, inputs):
        calls.append((ep, input_type, list(inputs)))
        raise ConnectionError("down")

    m = _model(mod, ["http://a", "http://b"], post)
    return [_outcome(m._embed_batch("text", ["x", "y", "z"])), _health(m)]  # every health reset


def _case_halving(mod, Chunk, calls):
    def post(ep, input_type, inputs):
        calls.append((ep, input_type, list(inputs)))
        if len(inputs) > 2:
            raise mod.PayloadTooLarge(ep)
        return [_emb(v) for v in inputs]

    m = _model(mod, ["http://a"], post)
    return [_outcome(m._embed_batch("image", [f"i{i}" for i in range(7)])), _health(m)]


def _case_batch1_413(mod, Chunk, calls):
    def post(ep, input_type, inputs):
        calls.append((ep, input_type, list(inputs)))
        if "huge" in inputs:
            raise mod.PayloadTooLarge(ep)
        return [_emb(v) for v in inputs]

    m = _model(mod, ["http://a", "http://b"], post)
    return [_outcome(m._embed_batch("image", ["huge", "s1", "s2"])), _health(m)]  # health untouched


def _case_streams(mod, Chunk, calls):
    def post(ep, input_type, inputs):
        calls.append((ep, input_type, list(inputs)))
        return [_emb(input_type + v) for v in inputs]

    m = _model(mod, ["http://a"], post)
    chunks = [Chunk(content="plain text", metadata={}),
              Chunk(content="data:image/png;base64,AAAA", metadata={"is_image": True}),
              Chunk(content="more text", metadata={}),
              Chunk(content="data:image/jpeg;base64,BBBB", metadata={"is_image": True})]
    return [_outcome(m.embed_for_ingestion(chunks)), _outcome(m.embed_for_ingestion([])),
            ("query", np.asarray(_run(m.embed_for_query("a query"))).tolist())]


def _case_cooldown(mod, Chunk, calls, clock):
    def post(ep, input_type, inputs):
        calls.append((clock[0], ep, list(inputs)))
        if ep == "http://a" and clock[0] < 1100:
            raise ConnectionError("down")
        return [_emb(v) for v in inputs]

    m = _model(mod, ["http://a", "http://b"], post)
    out = []
    cool = mod.HEALTH_COOLDOWN_S
    for t in (1000.0, 1000.0 + cool - 1, 1000.0 + cool + 1, 1000.0 + 2 * cool + 2):
        clock[0] = t
        out.append((t, _outcome(m._embed_batch("text", ["u", "v"])), _health(m)))
    return out


CASES = {"shards": _case_shards, "failover": _case_failover, "all_down": _case_all_down,
         "halving": _case_halving, "batch1_413": _case_batch1_413, "streams": _case_streams,
         "cooldown": _case_cooldown}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scheduling_matches_reference(case, monkeypatch):
    """Both packages' clients, given the same fake endpoints, make the same
    calls (sorted: shards run concurrently) and give the same results."""
    logs = {}
    for name, (mod, Chunk) in PKGS.items():
        calls = []
        if case == "cooldown":
            clock = [0.0]
            monkeypatch.setattr(mod.time, "time", lambda: clock[0])
            result = CASES[case](mod, Chunk, calls, clock)
        else:
            result = CASES[case](mod, Chunk, calls)
        logs[name] = (json.loads(json.dumps(result)), sorted(json.loads(json.dumps(calls))))
    assert logs["torch"] == logs["jax"]
    result, calls = logs["torch"]
    if case == "shards":  # input i to endpoint i % 3; the trailing slash dropped
        assert calls == [["http://a", "text", ["t0", "t3", "t6"]], ["http://b", "text", ["t1", "t4"]],
                         ["http://c", "text", ["t2", "t5"]]]
        assert result[0] == ["ok", [_emb(f"t{i}").tolist() for i in range(7)]]
    elif case == "failover":
        assert result[0][0] == "ok" and result[1] == {"http://bad": False, "http://good": True}
        assert [c for c in calls if c[2] == ["p", "q"]] == [["http://good", "text", ["p", "q"]]]
    elif case == "all_down":
        assert result == [["raised", "AllEndpointsDown"], {"http://a": True, "http://b": True}]
    elif case == "halving":
        assert sorted(len(c[2]) for c in calls) == [1, 2, 2, 2, 3, 4, 7]  # 7 -> 3 + 4 -> 1 + 2, 2 + 2
        assert result[0] == ["ok", [_emb(f"i{i}").tolist() for i in range(7)]]
    elif case == "batch1_413":
        assert result == [["raised", "PayloadTooLarge"], {"http://a": True, "http://b": True}]
    elif case == "streams":
        assert calls == [["http://a", "image", ["data:image/png;base64,AAAA", "data:image/jpeg;base64,BBBB"]],
                         ["http://a", "text", ["a query"]], ["http://a", "text", ["plain text", "more text"]]]
        assert result[0][1][1] == _emb("imagedata:image/png;base64,AAAA").tolist()
    else:  # cooldown: a stays skipped until the cooldown has passed, then is probed again
        cool = tmod.HEALTH_COOLDOWN_S
        assert [c[1:] for c in calls if c[0] == 1000.0 + cool - 1] == [["http://b", ["u", "v"]]]
        assert [c[1:] for c in calls if c[0] == 1000.0 + cool + 1] == [  # probed, down again, retried on b
            ["http://a", ["u"]], ["http://b", ["u"]], ["http://b", ["v"]]]
        assert [c[1:] for c in calls if c[0] == 1000.0 + 2 * cool + 2] == [["http://a", ["u"]], ["http://b", ["v"]]]
        assert result[-1][2] == {"http://a": True, "http://b": True}


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P"])
def test_query_image_pixels_match_reference(mode):
    """An image query: the port decodes the upload and sends `encode_png`
    of the RGB pixels; the reference sends PIL's PNG of `Image.open(...)`
    in the upload's own mode. The endpoint decodes both to the same RGB."""
    rng = np.random.default_rng(5)
    rgba = rng.integers(0, 256, (37, 53, 4), dtype=np.uint8)
    img = Image.fromarray(rgba, "RGBA")
    img = img.convert(mode) if mode != "P" else img.convert("RGB").quantize(colors=40)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    upload = buf.getvalue()
    sent = {}
    for name, (mod, _) in PKGS.items():
        def post(ep, input_type, inputs, name=name):
            sent[name] = (input_type, inputs[0])
            return [_emb("q")]

        m = _model(mod, ["http://a"], post)
        query = decode_image(upload) if name == "torch" else Image.open(io.BytesIO(upload))
        _run(m.embed_for_query(query))
    assert sent["torch"][0] == sent["jax"][0] == "image"
    assert all(uri.startswith("data:image/png;base64,") for _, uri in sent.values())
    t_png, j_png = (data_uri_to_bytes(sent[k][1]) for k in ("torch", "jax"))
    want = np.asarray(Image.open(io.BytesIO(j_png)).convert("RGB"))
    assert np.array_equal(decode_image(t_png), want)
    assert np.array_equal(decode_image(j_png), want)
    assert np.array_equal(want, np.asarray(Image.open(io.BytesIO(upload)).convert("RGB")))


# ------------------------------------------------------------ servers


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


def closed_port_url() -> str:
    """A 127.0.0.1 URL whose port nothing listens on (connections are refused)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return f"http://127.0.0.1:{port}"


def raw_settings(root: Path, name: str, **sections) -> dict:
    raw = {
        "api": {"port": 0},
        "storage": {"storage_path": str(root / name / "storage")},
        "database": {"path": str(root / name / "db.sqlite")},
        "vector_store": {"index_path": str(root / name / "index"), **SMALL_FDE},
        "telemetry": {"telemetry_dir": str(root / name / "logs" / "telemetry")},
        "model": {"matmul_precision": "bf16", "embedding_dim": 32},
        "worker": {"max_jobs": 2},
    }
    for k, v in sections.items():
        raw[k] = {**raw.get(k, {}), **v}
    return raw


def boot(lt, raw, model=None):
    """A port server on `raw` settings on the CPU (-> services, server, base URL)."""
    services = build_services(Settings.from_dict(raw), colqwen_model=model, device="cpu")
    lt.run(services.initialize())
    srv = HTTPServer(build_app(services), "127.0.0.1", 0)
    lt.run(srv.start())
    return services, srv, f"http://127.0.0.1:{srv.port}"


def call(base, method, path, body=None, headers=None):
    """(status, parsed JSON or raw bytes) over a real socket."""
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
    return status, (json.loads(raw) if "json" in ctype else raw)


def upload(base, filename, data, ctype="image/png", fields=None):
    boundary = "----morphik-remote-test"
    body = b"".join(f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
                    for k, v in (fields or {}).items())
    body += (f'--{boundary}\r\nContent-Disposition: form-data; name="file"; filename="{filename}"\r\n'
             f"Content-Type: {ctype}\r\n\r\n").encode() + data + f"\r\n--{boundary}--\r\n".encode()
    status, doc = call(base, "POST", "/ingest/file", body, {"Content-Type": f"multipart/form-data; boundary={boundary}"})
    assert status == 200, doc
    return doc["external_id"]


def wait_completed(base, doc_ids, timeout_s=60.0):
    deadline = time.time() + timeout_s
    while True:
        states = [call(base, "GET", f"/documents/{d}/status")[1] for d in doc_ids]
        if all(s["status"] == "completed" for s in states):
            return
        assert all(s["status"] != "failed" for s in states) and time.time() < deadline, states
        time.sleep(0.05)


def _page(rng, h, w):
    page = np.full((h, w, 3), 255, np.uint8)
    for _ in range(5):
        y, x = rng.integers(0, h - 20), rng.integers(0, w - 40)
        page[y : y + 20, x : x + 40] = rng.integers(0, 200, 3)
    return page


QUERIES = ["quarterly revenue", "table of contents", "signature page"]


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """Server E (local mode, the fixture model, keyed `/embeddings`) and
    server A (api mode: a closed port, then E), the same PNG pages
    uploaded to both."""
    root = tmp_path_factory.mktemp("remote")
    lt = _LoopThread()
    e_services, e_srv, e_base = boot(lt, raw_settings(root, "e", morphik={"morphik_embedding_api_key": KEY}),
                                     ColQwenModel.from_fixture(FIXTURE, device="cpu"))
    dead = closed_port_url()
    a_services, a_srv, a_base = boot(lt, raw_settings(root, "a", morphik={
        "colpali_mode": "api", "morphik_embedding_api_endpoints": [dead, e_base], "morphik_embedding_api_key": KEY}))
    rng = np.random.default_rng(3)
    pages = [_page(rng, h, w) for h, w in ((224, 224), (224, 336), (336, 224), (250, 333))]
    docs = {}
    for name, base in (("e", e_base), ("a", a_base)):
        docs[name] = [upload(base, f"page{i}.png", encode_png(p)) for i, p in enumerate(pages)]
        wait_completed(base, docs[name])
    yield {"e": (e_services, e_base), "a": (a_services, a_base), "dead": dead, "docs": docs, "pages": pages}
    for srv, services in ((a_srv, a_services), (e_srv, e_services)):
        lt.run(srv.stop())
        lt.run(services.shutdown())
    lt.close()


def test_api_node_loads_no_tower_and_marks_the_dead_endpoint(nodes):
    a_services, a_base = nodes["a"]
    emb = a_services.colpali_embedding_model
    assert isinstance(emb, tmod.ColpaliApiEmbeddingModel) and not hasattr(emb, "model")
    assert emb.auth_token == KEY and emb.endpoints == [nodes["dead"], nodes["e"][1]]
    assert not hasattr(emb, "fde_config")  # no fused ingest FDE: A's store computes it
    assert not emb._health[nodes["dead"]].healthy and emb._health[nodes["e"][1]].healthy
    assert type(a_services.document_service.reranker).__name__ != "ColQwenReranker"
    status, health = call(a_base, "GET", "/health")
    assert status == 200 and health["components"]["colpali"]["backend"] == "api", health
    assert health["components"]["colpali"]["index_rows"] == {"default": 4}
    assert call(nodes["e"][1], "GET", "/health")[1]["components"]["colpali"]["backend"] == "cpu"


def test_api_node_retrieves_equal_a_local_node(nodes):
    """The same uploads: A (remote embedding) and E (its own tower) give
    the same ids, in the same order, with the same scores."""
    (_, a_base), (_, e_base) = nodes["a"], nodes["e"]
    by_file = {name: dict(zip(nodes["docs"][name], range(4))) for name in ("a", "e")}
    for text in QUERIES:
        got = {}
        for name, base in (("a", a_base), ("e", e_base)):
            status, res = call(base, "POST", "/retrieve/chunks", {"query": text, "k": 3})
            assert status == 200 and len(res) == 3, res
            got[name] = ([by_file[name][r["document_id"]] for r in res], [r["score"] for r in res])
        assert got["a"][0] == got["e"][0], (text, got)
        np.testing.assert_array_equal(got["a"][1], got["e"][1])
    q_img = "data:image/png;base64," + base64.b64encode(encode_png(nodes["pages"][2])).decode()
    for name, base in (("a", a_base), ("e", e_base)):
        status, res = call(base, "POST", "/retrieve/chunks", {"query_image": q_img, "k": 1})
        assert status == 200 and by_file[name][res[0]["document_id"]] == 2, res


def test_api_node_stores_the_endpoint_rows_with_their_fde(nodes):
    """Each row A stores is E's in-process embedding of the stored payload
    (the store's f16 cast), and its FDE row is `fde_document_batch` of it."""
    (a_services, _), (e_services, _) = nodes["a"], nodes["e"]
    index = a_services.colpali_vector_store._indexes["default"]
    e_emb = e_services.colpali_embedding_model
    for doc_id in nodes["docs"]["a"]:
        rec = index.get_chunks_by_id([(doc_id, 0)])[0]
        payload = _run(a_services.colpali_vector_store._restore_payload(rec, False))
        want = e_emb.embed_for_ingestion_sync([TChunk(content=payload, metadata={"is_image": True})])[0][0]
        got = index.get_multivector(doc_id, 0)
        np.testing.assert_array_equal(got, want.astype(index.store_dtype).astype(np.float32))
        row = index._id_to_row[f"{doc_id}-0"]
        fde = fde_document_batch(torch.from_numpy(want[None]), torch.ones(1, len(want)), index.fde_config)
        np.testing.assert_array_equal(index._fde_rows(row, row + 1)[0], fde[0].numpy())


def test_embeddings_relay_is_bit_identical(nodes):
    (_, a_base), (_, e_base) = nodes["a"], nodes["e"]
    png = "data:image/png;base64," + base64.b64encode(encode_png(nodes["pages"][1])).decode()
    for body in ({"input_type": "text", "inputs": ["alpha beta", "gamma"]}, {"input_type": "image", "inputs": [png]}):
        got = {}
        for name, base in (("a", a_base), ("e", e_base)):  # A holds the key too: it sends it to E
            status, raw = call(base, "POST", "/embeddings", body, {"Authorization": f"Bearer {KEY}"})
            assert status == 200, raw
            npz = np.load(io.BytesIO(raw))
            got[name] = [npz[f"emb_{i}"] for i in range(len(body["inputs"]))]
        for x, y in zip(got["a"], got["e"]):
            assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y)


def test_keyed_endpoint_refuses_the_reference_node_and_serves_the_port(nodes, tmp_path):
    """The reference builds its API node's client without
    `morphik_embedding_api_key`, so a keyed endpoint answers 401 to every
    call and the client raises AllEndpointsDown; the port's sends the key."""
    (e_services, e_base) = nodes["e"]
    api = {"colpali_mode": "api", "morphik_embedding_api_endpoints": [e_base], "morphik_embedding_api_key": KEY}
    j_services = j_build_services(JSettings.model_validate(raw_settings(tmp_path, "jax", morphik=api)))
    j_emb = j_services.colpali_embedding_model
    assert isinstance(j_emb, jmod.ColpaliApiEmbeddingModel) and j_emb.auth_token is None
    with pytest.raises(jmod.AllEndpointsDown):
        _run(j_emb.embed_for_query("quarterly revenue"))
    t_services = build_services(Settings.from_dict(raw_settings(tmp_path, "torch", morphik=api)), device="cpu")
    got = _run(t_services.colpali_embedding_model.embed_for_query("quarterly revenue"))
    want = e_services.colpali_embedding_model.embed_query("quarterly revenue")
    assert got.dtype == np.float32 and np.array_equal(got, want)
    with pytest.raises(urllib.error.HTTPError, match="401"):
        urllib.request.urlopen(urllib.request.Request(e_base + "/embeddings", data=b'{"inputs": ["x"]}',
                                                      headers={"Content-Type": "application/json"}), timeout=30)
