"""`/query` through an LLM, the on-the-fly document query and
`output_format="text"`: the port's server against the JAX server on the
CPU. Both serve the fixture model with `completion.model` a registered
OpenAI-compatible key and `embedding.model` a registered embedding key,
both pointing at one local fake provider
(`morphik_core_tpu_torch/scripts/fake_providers.py`); `uuid.uuid4` is
patched so both servers give their documents the same ids.

- `/query` on the text path and on the ColPali path (image_url data URIs
  of the stored q80 JPEG payloads): the requests the provider records
  are equal, and so are the answers; the SSE stream joins to the
  provider's text;
- `output_format="text"`: image chunks come back as the provider's
  transcription, or the placeholder under the stub, in both;
- the on-the-fly query: the completion, the structured output and the
  `ingestion_options.ingest` document (its metadata merged), the 400s of
  an empty file and of a file with no text, the 422s;
- a client that leaves an SSE `/query` closes the provider's stream (the
  port's own point);
- a provider error answers 500 in both. Only the status is compared: the
  detail is the exception's text, httpx's in one and urllib's in the
  other.
"""

import json
import re
import time
import urllib.request
import uuid

import numpy as np
import pytest
import torch

from morphik_core_tpu.api.app import build_app as j_build_app
from morphik_core_tpu.api.http import HTTPServer as JHTTPServer
from morphik_core_tpu.completion.models import StubCompletionModel as JStub
from morphik_core_tpu.config import Settings as JSettings
from morphik_core_tpu.models.colqwen import ColQwenModel as JModel
from morphik_core_tpu.services_init import build_services as j_build_services
from morphik_core_tpu_torch.api.app import build_app
from morphik_core_tpu_torch.api.http import HTTPServer
from morphik_core_tpu_torch.completion.models import StubCompletionModel as TStub
from morphik_core_tpu_torch.config import Settings
from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel as TModel
from morphik_core_tpu_torch.scripts.fake_providers import ANSWER, LINGER_S, TRANSCRIPTION, FakeProviders
from morphik_core_tpu_torch.utils.png import encode_png
from test_torch_service import (
    FIXTURE,
    _LoopThread,
    _call,
    _multipart,
    _page,
    _raw_settings,
    _SeqIds,
    _text_pdf,
    _wait_completed,
)

torch.set_num_threads(2)

NAMES = ("torch", "jax")
EMBED_DIM = 96
TEXTS = ["quarterly revenue growth margin report " * 30, "supplier invoice renewal clause schedule " * 30]


def _settings(root, name, fake_url):
    raw = _raw_settings(root, name)
    raw["worker"] = {"max_jobs": 1, "raster_processes": 1}
    raw["parser"] = {"chunk_size": 400, "chunk_overlap": 40}
    raw["registered_models"] = {
        "fake_llm": {"model_name": "fake-gpt", "api_base": fake_url + "/v1", "api_key": "sk-fake"},
        "fake_embed": {"model_name": "fake-embedding", "api_base": fake_url + "/v1", "api_key": "sk-fake"},
    }
    raw["completion"] = {"model": "fake_llm"}
    raw["embedding"] = {"model": "fake_embed", "dimensions": EMBED_DIM}
    return raw


class _Ids(_SeqIds):
    """Sequential ids from `start`, for documents minted after the fixture's."""

    def __init__(self, start):
        super().__init__()
        self.n = start


@pytest.fixture(scope="module")
def llm_servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("query")
    rng = np.random.default_rng(23)
    pages = [encode_png(_page(rng, 224, 224 + 56 * i, n_blocks=5 + i)) for i in range(3)]
    fake = FakeProviders(embed_dim=EMBED_DIM).start()
    lt = _LoopThread()
    out = {"fake": fake, "base": {}, "docs": {}, "services": {}, "root": root}
    srvs = []
    mp = pytest.MonkeyPatch()
    try:
        for name in NAMES:
            raw = _settings(root, name, fake.url)
            if name == "torch":
                services = build_services_torch(raw)
                srv = HTTPServer(build_app(services), "127.0.0.1", 0)
            else:
                services = j_build_services(JSettings.model_validate(raw), colqwen_model=JModel.from_fixture(FIXTURE))
                srv = JHTTPServer(j_build_app(services), "127.0.0.1", 0)
            lt.run(services.initialize())
            lt.run(srv.start())
            srvs.append((srv, services))
            base = out["base"][name] = f"http://127.0.0.1:{srv.port}"
            out["services"][name] = services
            mp.setattr(uuid, "uuid4", _SeqIds())
            docs = []
            for i, png in enumerate(pages):
                body, ctype = _multipart("file", f"page{i}.png", png, "image/png", {"metadata": json.dumps({"i": i})})
                status, doc = _call(base, "POST", "/ingest/file", body, {"Content-Type": ctype})
                assert status == 200, doc
                docs.append(doc["external_id"])
            for i, text in enumerate(TEXTS):
                status, doc = _call(base, "POST", "/ingest/text", {"content": text, "filename": f"t{i}.txt",
                                                                   "use_colpali": False})
                assert status == 200, doc
                docs.append(doc["external_id"])
            mp.undo()
            _wait_completed(base, docs)
            out["docs"][name] = docs
        assert out["docs"]["torch"] == out["docs"]["jax"]
        yield out
    finally:
        mp.undo()
        for srv, services in srvs:
            lt.run(srv.stop())
            lt.run(services.shutdown())
        lt.close()
        fake.stop()


def build_services_torch(raw):
    from morphik_core_tpu_torch.services_init import build_services

    return build_services(Settings.from_dict(raw), colqwen_model=TModel.from_fixture(FIXTURE, device="cpu"),
                          device="cpu")


def _both(llm_servers, method, path, body=None, headers=None):
    """{name: (status, answer, the provider requests it made)}."""
    fake, out = llm_servers["fake"], {}
    for name in NAMES:
        n = len(fake.requests)
        status, answer = _call(llm_servers["base"][name], method, path, body, headers)
        out[name] = (status, answer, fake.requests[n:])
    return out


def _same_provider_requests(res, chat_only=False):
    """Equal provider requests (`chat_only`: the completions alone, where
    an ingest job's embedding calls may fall inside the window)."""
    (_, _, treqs), (_, _, jreqs) = res["torch"], res["jax"]
    if chat_only:
        treqs, jreqs = _chat_requests(treqs), _chat_requests(jreqs)
    assert [r["path"] for r in treqs] == [r["path"] for r in jreqs]
    assert [r["body"] for r in treqs] == [r["body"] for r in jreqs]
    assert [r["headers"].get("authorization") for r in treqs] == [r["headers"].get("authorization") for r in jreqs]


def _chat_requests(reqs):
    return [r for r in reqs if r["path"].endswith("/chat/completions")]


def test_query_text_path_matches_jax(llm_servers):
    res = _both(llm_servers, "POST", "/query", {"query": "supplier invoice renewal", "k": 2, "use_colpali": False,
                                                "max_tokens": 50, "temperature": 0.2})
    (ts_, tj, treqs), (js_, jj, _) = res["torch"], res["jax"]
    assert ts_ == js_ == 200, (tj, jj)
    _same_provider_requests(res)
    assert [r["path"] for r in treqs] == ["/v1/embeddings", "/v1/chat/completions"]  # the routed query embedding
    assert tj["completion"] == jj["completion"] == ANSWER and tj["usage"] == jj["usage"]
    _same_sources(tj["sources"], jj["sources"])
    assert tj["sources"][0]["document_id"] == llm_servers["docs"]["torch"][4]


def _same_sources(t, j):
    """The same chunks; scores within 5e-3. The reference's text store also
    holds each PNG's bytes decoded as UTF-8 (ROADMAP Queue 3: the port
    keeps images out of it), which moves its BM25 statistics."""
    assert [(s["document_id"], s["chunk_number"], s["filename"]) for s in t] == [
        (s["document_id"], s["chunk_number"], s["filename"]) for s in j]
    assert [s["score"] for s in t] == pytest.approx([s["score"] for s in j], abs=5e-3)


def test_query_colpali_path_matches_jax(llm_servers):
    """The retrieved pages go to the provider as image_url data URIs of
    their stored q80 JPEG payloads, in the order /retrieve/chunks gives."""
    body = {"query": "coloured blocks page", "k": 2}
    res = _both(llm_servers, "POST", "/query", body)
    (ts_, tj, treqs), (js_, jj, _) = res["torch"], res["jax"]
    assert ts_ == js_ == 200, (tj, jj)
    _same_provider_requests(res)
    content = _chat_requests(treqs)[0]["body"]["messages"][-1]["content"]
    urls = [b["image_url"]["url"] for b in content if b["type"] == "image_url"]
    status, chunks = _call(llm_servers["base"]["torch"], "POST", "/retrieve/chunks", body)
    assert status == 200 and urls == [c["content"] for c in chunks] and len(urls) == 2
    assert all(u.startswith("data:image/jpeg;base64,") for u in urls)
    assert tj["completion"] == jj["completion"] == ANSWER
    _same_sources(tj["sources"], jj["sources"])  # each package embeds the pages with its own tower


def test_query_stream_matches_jax(llm_servers):
    res = _both(llm_servers, "POST", "/query", {"query": "quarterly revenue", "k": 1, "use_colpali": False,
                                                "stream_response": True})
    (ts_, tj, _), (js_, jj, _) = res["torch"], res["jax"]
    assert ts_ == js_ == 200
    _same_provider_requests(res)
    for text in (tj, jj):
        events = [json.loads(e[6:]) for e in text.split("\n\n") if e.startswith("data: {")]
        assert "".join(e["content"] for e in events if e["type"] == "assistant") == ANSWER
        assert events[-1]["type"] == "sources" and text.rstrip().endswith("[DONE]")
    assert tj == jj


def test_client_leaving_an_sse_query_closes_the_provider_stream(llm_servers):
    """The provider keeps sending deltas; the client reads the first and
    leaves. The server's next write fails, which closes the events, the
    provider's stream and its connection: the fake sees it closed."""
    fake = llm_servers["fake"]
    n = len(fake.lingered)
    body = {"query": "quarterly revenue", "k": 1, "use_colpali": False, "stream_response": True,
            "llm_config": {"model": "drip"}}
    req = urllib.request.Request(llm_servers["base"]["torch"] + "/query", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        for raw in resp:
            if raw.startswith(b"data: {") and b'"assistant"' in raw:
                break  # and the connection closes
    deadline = time.monotonic() + LINGER_S + 5
    while len(fake.lingered) == n and time.monotonic() < deadline:
        time.sleep(0.02)
    assert fake.lingered[n:] == [True]


@pytest.mark.parametrize("route", ["/retrieve/chunks", "/batch/chunks"])
def test_output_format_text_matches_jax(llm_servers, route):
    """Image chunks come back as the provider's transcription."""
    if route == "/retrieve/chunks":
        body = {"query": "coloured blocks page", "k": 2, "output_format": "text"}
    else:
        body = {"sources": [{"document_id": llm_servers["docs"]["torch"][i], "chunk_number": 0} for i in (0, 2)],
                "use_colpali": True, "output_format": "text"}
    res = _both(llm_servers, "POST", route, body)
    (ts_, tj, treqs), (js_, jj, _) = res["torch"], res["jax"]
    assert ts_ == js_ == 200, (tj, jj)
    _same_provider_requests(res)
    assert len(_chat_requests(treqs)) == 2
    assert [c["content"] for c in tj] == [c["content"] for c in jj] == [TRANSCRIPTION] * 2
    assert [c["document_id"] for c in tj] == [c["document_id"] for c in jj]


def test_output_format_text_placeholder_under_the_stub_matches_jax(llm_servers):
    services = llm_servers["services"]
    models = {name: services[name].document_service.completion_model for name in NAMES}
    services["torch"].document_service.completion_model = TStub()
    services["jax"].document_service.completion_model = JStub()
    try:
        res = _both(llm_servers, "POST", "/retrieve/chunks", {"query": "coloured blocks page", "k": 3,
                                                              "output_format": "text"})
    finally:
        for name in NAMES:
            services[name].document_service.completion_model = models[name]
    (ts_, tj, treqs), (js_, jj, _) = res["torch"], res["jax"]
    assert ts_ == js_ == 200 and not _chat_requests(treqs)
    assert [c["content"] for c in tj] == [c["content"] for c in jj]
    assert all(re.fullmatch(r"\[image page \d+ of page\d\.png\]", c["content"]) for c in tj), tj


def _document_query(llm_servers, data, filename, fields, start_id):
    body, ctype = _multipart("file", filename, data, "text/plain" if filename.endswith(".txt") else
                             "application/pdf", fields)
    mp = pytest.MonkeyPatch()
    try:
        out = {}
        for name in NAMES:
            mp.setattr(uuid, "uuid4", _Ids(start_id))
            n = len(llm_servers["fake"].requests)
            status, answer = _call(llm_servers["base"][name], "POST", "/ingest/document/query", body,
                                   {"Content-Type": ctype})
            out[name] = (status, answer, llm_servers["fake"].requests[n:])
            mp.undo()
        return out
    finally:
        mp.undo()


def test_document_query_matches_jax(llm_servers):
    res = _document_query(llm_servers, b"The relay closes at 7 volts.", "spec.txt",
                          {"prompt": "What voltage closes the relay?"}, 100)
    (ts_, tj, _), (js_, jj, _) = res["torch"], res["jax"]
    assert ts_ == js_ == 200, (tj, jj)
    _same_provider_requests(res)
    assert tj == jj and tj["completion"] == ANSWER and tj["document"] is None and tj["structured_output"] is None
    assert tj["metadata"] == {"filename": "spec.txt", "parsed_chars": 28}


def test_document_query_structured_and_ingested_matches_jax(llm_servers):
    """A PDF with a schema and `ingestion_options.ingest`: the structured
    answer, merged into the stored document's metadata."""
    pdf = _text_pdf(["quarterly revenue grew 12 percent", "supplier invoice renewal clause"])
    schema = {"type": "object", "properties": {"growth": {"type": "string"}, "quarter": {"type": "string"}}}
    res = _document_query(llm_servers, pdf, "report.pdf", {
        "prompt": "Extract the growth.", "schema": json.dumps(schema),
        "ingestion_options": json.dumps({"ingest": True, "use_colpali": False, "metadata": {"source": "otf"}})}, 200)
    (ts_, tj, _), (js_, jj, _) = res["torch"], res["jax"]
    assert ts_ == js_ == 200, (tj, jj)
    _same_provider_requests(res, chat_only=True)
    want = {"growth": "growth from the fake provider", "quarter": "quarter from the fake provider"}
    assert tj["structured_output"] == jj["structured_output"] == tj["completion"] == want
    assert tj["usage"] == jj["usage"] and tj["metadata"] == jj["metadata"]
    doc_id = tj["document"]["external_id"]
    assert doc_id == jj["document"]["external_id"]
    assert tj["document"]["metadata"] == jj["document"]["metadata"] == {"source": "otf", **want}
    for name in NAMES:
        _wait_completed(llm_servers["base"][name], [doc_id])
    res = _both(llm_servers, "POST", "/retrieve/chunks", {"query": "supplier invoice", "k": 1, "use_colpali": False,
                                                          "filters": {"source": "otf"}})
    (ts_, tj, _), (js_, jj, _) = res["torch"], res["jax"]
    assert ts_ == js_ == 200 and [c["document_id"] for c in tj] == [c["document_id"] for c in jj] == [doc_id]


@pytest.mark.parametrize("data,filename,fields,status", [
    (b"", "empty.txt", {"prompt": "?"}, 400),
    (b" \n\t \n", "blank.txt", {"prompt": "?"}, 400),
    (b"text", "a.txt", {}, 422),
], ids=["empty", "no_text", "no_prompt"])
def test_document_query_refusals_match_jax(llm_servers, data, filename, fields, status):
    res = _document_query(llm_servers, data, filename, fields, 300)
    (ts_, tj, treqs), (js_, jj, _) = res["torch"], res["jax"]
    assert ts_ == js_ == status and tj == jj and not treqs, (tj, jj)


@pytest.mark.parametrize("path,body", [
    ("/query", {"query": "quarterly revenue", "k": 1, "use_colpali": False, "llm_config": {"model": "status-500"}}),
    ("/query", {"query": "quarterly revenue", "k": 1, "use_colpali": False, "llm_config": {"model": "status-429"}}),
])
def test_provider_error_answers_500_in_both(llm_servers, path, body):
    res = _both(llm_servers, "POST", path, body)
    assert res["torch"][0] == res["jax"][0] == 500
    _same_provider_requests(res)
    assert "429" in res["torch"][1]["detail"] or "500" in res["torch"][1]["detail"]


def test_query_retrieve_equals_retrieve_chunks(llm_servers):
    """The sources of a /query are /retrieve/chunks' answer for the same body."""
    base = llm_servers["base"]["torch"]
    body = {"query": "quarterly revenue growth", "k": 2, "use_colpali": False}
    status, answer = _call(base, "POST", "/query", body)
    status2, chunks = _call(base, "POST", "/retrieve/chunks", body)
    assert status == status2 == 200
    assert [(s["document_id"], s["chunk_number"]) for s in answer["sources"]] == [
        (c["document_id"], c["chunk_number"]) for c in chunks]
