"""The port's completion providers and routed text embedders against the
JAX package's, on the CPU: both packages' clients (the reference's over
httpx, the port's over urllib) talk to one local fake server
(`morphik_core_tpu_torch/scripts/fake_providers.py`) that speaks the
OpenAI, Ollama and Anthropic wire formats and the embedding endpoints.

- The recorded requests are equal (JSON decoded: httpx and json encode
  with other separators), with the same path and the headers that carry
  meaning (`Authorization`, `x-api-key`, `anthropic-version`, `api-key`);
  the parsed `CompletionResponse`s are equal, structured output and its
  fallback to text included; the joined streams are equal with `\\n`,
  `\\r\\n` and `\\r` line ends.
- A 500 and a 429 raise in both packages, for a completion and a stream.
- `build_completion_model` routes the same `registered_models` entries to
  the same class with the same fields, and refuses outside development
  with the same text.
- The port's own points: its line decoder splits as httpx's does; a
  stream's connection closes as soon as its consumer stops; a slow
  provider leaves the event loop free.
- The routed embedders of `tests/test_api_embedding.py`, and the same
  endpoints over the wire: the same requests, bit-identical vectors.
"""

import asyncio
import time

import httpx
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import run_once
from morphik_core_tpu.completion import models as jm
from morphik_core_tpu.config import Settings as JSettings
from morphik_core_tpu.embedding import text_embedding as jte
from morphik_core_tpu.models import schemas as js
from morphik_core_tpu_torch.completion import _http
from morphik_core_tpu_torch.completion import models as tm
from morphik_core_tpu_torch.config import Settings
from morphik_core_tpu_torch.embedding import text_embedding as tte
from morphik_core_tpu_torch.models import schemas as ts
from morphik_core_tpu_torch.scripts.fake_providers import ANSWER, LINGER_S, FakeProviders

PNG_URI = "data:image/png;base64,iVBORw0KGgoAAAANSUhEUg=="
JPEG_URI = "data:image/jpeg;base64,/9j/4AAQSkZJRgABAQ=="
MEANINGFUL_HEADERS = ("authorization", "x-api-key", "anthropic-version", "api-key")  # as the fake records them
PROVIDERS = ("openai", "ollama", "anthropic")


@pytest.fixture(scope="module")
def fake():
    with FakeProviders(embed_dim=96) as server:
        yield server


def _clients(provider: str, base: str, model: str = "fake-model"):
    """(JAX client, port client) of one wire format."""
    if provider == "openai":
        return (jm.OpenAICompatCompletionModel(base + "/v1", model, api_key="sk-test"),
                tm.OpenAICompatCompletionModel(base + "/v1", model, api_key="sk-test"))
    if provider == "ollama":
        return (jm.OllamaNativeCompletionModel(base, model, extra_options={"num_ctx": 4096}),
                tm.OllamaNativeCompletionModel(base, model, extra_options={"num_ctx": 4096}))
    return (jm.AnthropicCompletionModel(model, api_key="sk-ant-test", base_url=base),
            tm.AnthropicCompletionModel(model, api_key="sk-ant-test", base_url=base))


REQUESTS = {
    "plain": dict(query="what grew?", context_chunks=["Revenue grew 12%.", "Costs fell."], max_tokens=64,
                  temperature=0.1),
    "images": dict(query="what is on the pages?", context_chunks=["a caption", PNG_URI, JPEG_URI,
                                                                  "data:text/plain;base64,eA=="]),
    "schema": dict(query="extract", context_chunks=["Revenue grew 12%."],
                   response_schema={"type": "object", "properties": {"growth": {"type": "string"},
                                                                     "quarter": {"type": "string"}}}),
    "history": dict(query="and then?", context_chunks=["x {braces} y"], prompt_template="C={context} Q={question} {}",
                    chat_history=[("user", "hi"), ("assistant", "hello")], llm_config={"model": "other-model",
                                                                                     "top_p": 0.5}),
}


def _request(pkg, case: str):
    kw = dict(REQUESTS[case])
    if "chat_history" in kw:
        kw["chat_history"] = [pkg.ChatMessage(role=r, content=c) for r, c in kw["chat_history"]]
    return pkg.CompletionRequest(**kw)


def _exchange(fake, call):
    """Run `call` (a coroutine) and return (its result, the request it made)."""
    n = len(fake.requests)
    out = run_once(call)
    assert len(fake.requests) == n + 1
    return out, fake.requests[-1]


def _same_request(a, b):
    assert a["path"] == b["path"]
    assert a["body"] == b["body"]
    for h in MEANINGFUL_HEADERS:
        assert a["headers"].get(h) == b["headers"].get(h), h
    assert b["headers"]["content-type"] == "application/json"


@pytest.mark.parametrize("case", [*REQUESTS, "schema_fallback"])
@pytest.mark.parametrize("provider", PROVIDERS)
def test_complete_matches_jax(fake, provider, case):
    model = "no-json" if case == "schema_fallback" else "fake-model"
    j, t = _clients(provider, fake.url, model)
    case = "schema" if case == "schema_fallback" else case
    jout, jreq = _exchange(fake, j.complete(_request(js, case)))
    tout, treq = _exchange(fake, t.complete(_request(ts, case)))
    _same_request(jreq, treq)
    assert tout.model_dump() == jout.model_dump()
    if case == "schema":
        assert (tout.completion == ANSWER) == (model == "no-json")


@pytest.mark.parametrize("line_end", ["\n", "\r\n", "\r"], ids=["lf", "crlf", "cr"])
@pytest.mark.parametrize("provider", PROVIDERS)
def test_stream_matches_jax(fake, provider, line_end):
    j, t = _clients(provider, fake.url)

    async def collect(client, pkg):
        return [tok async for tok in client.complete_stream(_request(pkg, "images"))]

    fake.line_end = line_end
    try:
        jtoks, jreq = _exchange(fake, collect(j, js))
        ttoks, treq = _exchange(fake, collect(t, ts))
    finally:
        fake.line_end = "\n"
    _same_request(jreq, treq)
    assert treq["body"]["stream"] is True
    assert ttoks == jtoks and "".join(ttoks) == ANSWER and len(ttoks) > 1


@pytest.mark.parametrize("stream", [False, True], ids=["complete", "stream"])
@pytest.mark.parametrize("status", [500, 429])
@pytest.mark.parametrize("provider", PROVIDERS)
def test_error_status_raises_in_both(fake, provider, status, stream):
    j, t = _clients(provider, fake.url, f"status-{status}")

    async def call(client, pkg):
        if stream:
            return [tok async for tok in client.complete_stream(_request(pkg, "plain"))]
        return await client.complete(_request(pkg, "plain"))

    with pytest.raises(httpx.HTTPStatusError) as je:
        run_once(call(j, js))
    with pytest.raises(_http.HTTPStatusError) as te:
        run_once(call(t, ts))
    assert je.value.response.status_code == te.value.status == status
    assert f"HTTP {status}" in str(te.value)


REGISTERED = {
    "ollama_vis": {"model_name": "ollama_chat/llama3.2-vision"},
    "ollama_plain": {"model_name": "ollama/llava"},
    "claude": {"model_name": "claude-test-1", "api_key": "k"},
    "anthropic_prefixed": {"model_name": "anthropic/claude-3.5"},
    "explicit_ollama": {"model_name": "custom", "provider": "ollama", "api_base": "http://gpu-1:11434"},
    "explicit_claude": {"model_name": "claude-x", "provider": "anthropic", "api_base": "http://proxy:9"},
    "openai": {"model_name": "gpt-x", "api_base": "https://api.example/v1", "api_key": "sk"},
    "proxy_claude": {"model_name": "anthropic/claude-3.5", "api_base": "https://openrouter.example/api/v1"},
    "ollama_shim": {"model_name": "ollama/llama3", "api_base": "http://localhost:11434/v1"},
    "no_base": {"model_name": "gpt-4"},
}


@pytest.mark.parametrize("key", [*REGISTERED, "unregistered", "stub"])
def test_build_completion_model_matches_jax(key):
    j = jm.build_completion_model(REGISTERED, key)
    t = tm.build_completion_model(REGISTERED, key)
    assert type(t).__name__ == type(j).__name__
    assert vars(t) == vars(j)


@pytest.mark.parametrize("key", ["no_base", "unregistered"])
def test_refusal_outside_development_matches_jax(key):
    with pytest.raises(RuntimeError) as je:
        jm.build_completion_model(REGISTERED, key, environment="production")
    with pytest.raises(RuntimeError) as te:
        tm.build_completion_model(REGISTERED, key, environment="production")
    assert str(te.value) == str(je.value)
    assert isinstance(tm.build_completion_model(REGISTERED, "stub", environment="production"),
                      tm.StubCompletionModel)


@pytest.mark.parametrize("case", ["plain", "schema"])
def test_stub_matches_jax(case):
    j = run_once(jm.StubCompletionModel().complete(_request(js, case)))
    t = run_once(tm.StubCompletionModel().complete(_request(ts, case)))
    assert t.model_dump() == j.model_dump()


# ----------------------------------------------------------- the transport


@settings(max_examples=200, deadline=None)
@given(st.text(alphabet="ab\n\r\x0b\x85  ", max_size=40), st.lists(st.integers(0, 40), max_size=6))
def test_line_decoder_matches_httpx(text, cuts):
    """The port's incremental splitter against httpx's, on any cut of the text."""
    from httpx._decoders import LineDecoder

    cuts = sorted({min(c, len(text)) for c in cuts} | {0, len(text)})
    pieces = [text[a:b] for a, b in zip(cuts, cuts[1:]) if b > a]
    ours, theirs = _http._LineDecoder(), LineDecoder()
    got = [x for p in pieces for x in ours.decode(p)] + ours.flush()
    want = [x for p in pieces for x in theirs.decode(p)] + theirs.flush()
    assert got == want


@pytest.mark.parametrize("provider", PROVIDERS)
def test_stream_closes_its_connection_when_the_consumer_stops(fake, provider):
    """After the last event the fake keeps writing for LINGER_S; the port's
    stream returns at once and its connection is shut, which the fake sees."""
    _, t = _clients(provider, fake.url, "linger")

    async def go():
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        toks = [tok async for tok in t.complete_stream(_request(ts, "plain"))]
        return toks, loop.time() - t0

    n = len(fake.lingered)
    toks, seconds = run_once(go())
    assert "".join(toks) == ANSWER and seconds < LINGER_S / 2
    deadline = time.monotonic() + LINGER_S + 5
    while len(fake.lingered) == n and time.monotonic() < deadline:
        time.sleep(0.02)
    assert fake.lingered[n:] == [True]


@pytest.mark.parametrize("stream", [False, True], ids=["complete", "stream"])
def test_slow_provider_leaves_the_loop_free(fake, stream):
    """While a provider takes 0.6 s, other coroutines on the loop run."""
    _, t = _clients("openai", fake.url, "slow-0.6")

    async def go():
        ticks = 0
        done = asyncio.Event()

        async def ticker():
            nonlocal ticks
            while not done.is_set():
                ticks += 1
                await asyncio.sleep(0.01)

        task = asyncio.create_task(ticker())
        try:
            if stream:
                out = "".join([tok async for tok in t.complete_stream(_request(ts, "plain"))])
            else:
                out = (await t.complete(_request(ts, "plain"))).completion
        finally:
            done.set()
            await task
        return out, ticks

    out, ticks = run_once(go())
    assert out == ANSWER and ticks >= 20, ticks


# --------------------------------------------------------------- embedders


def _settings(pkg, models, dims=64):
    raw = {"registered_models": models, "embedding": {"model": list(models)[0], "dimensions": dims}}
    return JSettings.model_validate(raw) if pkg == "jax" else Settings.from_dict(raw)


def _capture(model, response_fn):
    calls = []

    async def fake_request(url, payload, headers):
        calls.append((url, payload, headers))
        return response_fn(payload)

    model._request = fake_request
    return calls


def _vectors(rng_seed, n, width):
    return np.random.default_rng(rng_seed).standard_normal((n, width)).astype(np.float32).tolist()


ROUTED = {
    "openai": ({"emb": {"model_name": "text-embedding-3-small", "api_key": "sk-x"}}, "data", 128, 2),
    "ollama": ({"emb": {"model_name": "ollama/nomic-embed-text", "api_base": "http://localhost:11434"}},
               "embeddings", 32, 7),
    "azure": ({"emb": {"model_name": "azure/embed-deploy", "api_base": "https://corp.azure.example/v1",
                       "api_key": "az-1"}}, "data", 8, 1),
    "openai_prefixed": ({"emb": {"model_name": "openai/text-embedding-3-large", "api_base": "http://127.0.0.1:9/v1",
                                 "timeout": 5}}, "data", 80, 6),
}


@pytest.mark.parametrize("case", list(ROUTED))
def test_routed_embedding_matches_jax(case):
    """`tests/test_api_embedding.py`'s routed cases through the `_request`
    seam: the same routing, batches, URLs, payloads and headers in both
    packages, and bit-identical vectors."""
    models, key, width, n = ROUTED[case]
    out = {}
    for pkg, cls in (("jax", jte.RoutedEmbeddingModel), ("torch", tte.RoutedEmbeddingModel)):
        m = cls("emb", _settings(pkg, models))
        vecs = iter(_vectors(3, n + 1, width))  # the documents, then the query

        def answer(payload):
            rows = [next(vecs) for _ in payload["input"]]
            return {"embeddings": rows} if key == "embeddings" else {"data": [{"embedding": r} for r in rows]}

        calls = _capture(m, answer)
        got = run_once(m.embed_documents([f"text {i}" for i in range(n)]))
        q = run_once(m.embed_for_query("a query"))
        out[pkg] = (m.provider, m.model_name, m.batch_size, m.dimensions, m.api_base, calls, got, q)
    j, t = out["jax"], out["torch"]
    assert t[:6] == j[:6]
    assert all(a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes() for a, b in zip(t[6], j[6]))
    assert t[7].tobytes() == j[7].tobytes() and t[7].shape == (min(width, 64),)
    if case == "ollama":
        assert [len(c[1]["input"]) for c in t[5]] == [5, 2, 1]


def test_routed_unknown_key_raises_in_both():
    for pkg, cls in (("jax", jte.RoutedEmbeddingModel), ("torch", tte.RoutedEmbeddingModel)):
        with pytest.raises(ValueError, match="'nope' not found"):
            cls("nope", _settings(pkg, {"emb": {"model_name": "x"}}))
        with pytest.raises(ValueError, match="requires api_base"):
            cls("emb", _settings(pkg, {"emb": {"model_name": "azure/d"}}))


@pytest.mark.parametrize("name", ["text-embedding-3-small", "ollama/nomic-embed-text", "azure/embed-deploy"])
def test_routed_embedding_over_the_wire_matches_jax(fake, name):
    """The same endpoints over the network: the fake answers each input
    with its hashing vector; both packages get them bit for bit."""
    models = {"emb": {"model_name": name, "api_base": fake.url + ("/v1" if name.startswith("text") else ""),
                      "api_key": "key-1"}}
    texts = [f"invoice number {i} renewal" for i in range(7)]
    got, reqs = {}, {}
    for pkg, cls in (("jax", jte.RoutedEmbeddingModel), ("torch", tte.RoutedEmbeddingModel)):
        m = cls("emb", _settings(pkg, models, dims=96))
        n = len(fake.requests)
        got[pkg] = run_once(m.embed_documents(texts))
        reqs[pkg] = fake.requests[n:]
    assert len(reqs["torch"]) == len(reqs["jax"]) == 2  # a local host: batches of 5
    for a, b in zip(reqs["jax"], reqs["torch"]):
        _same_request(a, b)
    want = [fake.embedder._embed(x) for x in texts]
    for a, b, w in zip(got["torch"], got["jax"], want):
        assert a.tobytes() == b.tobytes() == w.tobytes()


def test_openai_compat_embedding_matches_jax(fake):
    texts = ["alpha beta", "gamma", "delta epsilon zeta"]
    out = {}
    for pkg, cls in (("jax", jte.OpenAICompatEmbeddingModel), ("torch", tte.OpenAICompatEmbeddingModel)):
        m = cls(fake.url + "/v1/", "emb-model", api_key="sk-e", batch_size=2, max_dims=50)
        n = len(fake.requests)
        chunks = [(js if pkg == "jax" else ts).Chunk(content=x, metadata={}) for x in texts]
        vecs = run_once(m.embed_for_ingestion(chunks)) + [run_once(m.embed_for_query("alpha"))]
        out[pkg] = (vecs, fake.requests[n:])
    (jv, jr), (tv, tr) = out["jax"], out["torch"]
    assert len(tr) == len(jr) == 3
    for a, b in zip(jr, tr):
        _same_request(a, b)
    assert all(a.tobytes() == b.tobytes() and a.shape == (50,) for a, b in zip(tv, jv))


def test_embedding_error_status_raises_in_both(fake):
    models = {"emb": {"model_name": "status-503", "api_base": fake.url}}
    with pytest.raises(httpx.HTTPStatusError):
        run_once(jte.RoutedEmbeddingModel("emb", _settings("jax", models)).embed_for_query("x"))
    with pytest.raises(_http.HTTPStatusError) as e:
        run_once(tte.RoutedEmbeddingModel("emb", _settings("torch", models)).embed_for_query("x"))
    assert e.value.status == 503
