"""The port's corpus routes against the JAX package's, on the CPU.

- HTTP parity: the port server and the JAX server (the fixture model,
  `uuid.uuid4` patched so both mint the same ids) get the same request
  sequence over every route of folders, document reads and updates,
  `/retrieve/docs`, `/search/documents`, `/batch/documents`, chats,
  models and API keys, apps, `/migrate/document`, `/usage/app-storage`,
  `/logs` and v2. They answer the same status codes and the same bodies,
  modulo timestamps, storage roots and the tokens minted (each embeds its
  own page payloads: ColPali scores within the slice tests' 5e-3, the
  same ids).
- `/embeddings`: the same npz keys, shapes and dtype; values within 5e-4
  (the end-to-end tolerance of `tests/test_colqwen_parity.py`).
- Index files: the same `update_text` / `update_file` sequence in both
  packages (embedders replaced by one deterministic function of the
  chunk, so both stores get the same rows) saves byte-identical ColPali
  index and text-index files.
- The database: each package opens the other's after folder moves and
  renames; the reference's folder and chat cases of
  `tests/test_tenant_isolation.py` run against the port.
- The two repairs: a token that the JAX server revoked (rotated) answers
  401 on a port server of the same `storage_path`; `enable_profiling`
  writes a `.prof` for each request.
- The connectors and the console, once refused here with 501, are held
  to the JAX server's answers in `tests/test_torch_connectors.py`.
"""

import io
import json
import re
import time
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

from morphik_core_tpu.api.app import build_app as j_build_app
from morphik_core_tpu.api.http import HTTPServer as JHTTPServer
from morphik_core_tpu.config import Settings as JSettings
from morphik_core_tpu.database.sqlite_database import SQLiteDatabase as JDatabase
from morphik_core_tpu.models import schemas as js
from morphik_core_tpu.models.colqwen import ColQwenModel as JModel
from morphik_core_tpu.services.telemetry import TelemetryService as JTelemetry
from morphik_core_tpu.services_init import build_services as j_build_services
from morphik_core_tpu_torch.api.app import build_app
from morphik_core_tpu_torch.api.http import HTTPServer
from morphik_core_tpu_torch.config import Settings
from morphik_core_tpu_torch.database.sqlite_database import SQLiteDatabase
from morphik_core_tpu_torch.models import schemas as ts
from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel as TModel
from morphik_core_tpu_torch.services.telemetry import TelemetryService as TTelemetry
from morphik_core_tpu_torch.services_init import build_services
from morphik_core_tpu_torch.utils.fast_ops import bytes_to_data_uri
from morphik_core_tpu_torch.utils.png import encode_png
from test_torch_service import (
    FIXTURE,
    _LoopThread,
    _call,
    _multipart,
    _page,
    _prose,
    _raw_settings,
    _run,
    _SeqIds,
    _text_pdf,
)

torch.set_num_threads(2)

SCORE_ATOL = 5e-3  # each package embeds for itself (tests/test_torch_service.py)
EMBED_ATOL = 5e-4  # tests/test_colqwen_parity.py, end to end
# values that differ by when or where a server ran, not by what it answered
VOLATILE = {"created_at", "updated_at", "summary_updated_at", "timestamp", "start", "duration_s", "phase_times",
            "span_id"}


def _settings(root: Path, name: str) -> dict:
    raw = _raw_settings(root, name)
    raw["worker"] = {"max_jobs": 1, "raster_processes": 1, "colpali_store_batch_size": 2}
    raw["parser"] = {"chunk_size": 400, "chunk_overlap": 40}
    return raw


def _norm(x, root: str):
    """`x` with VOLATILE keys dropped, the server's storage root and the
    tokens of minted URIs replaced by placeholders."""
    if isinstance(x, dict):
        return {k: _norm(v, root) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, list):
        return [_norm(v, root) for v in x]
    if isinstance(x, str):
        x = x.replace(root, "<root>")
        return re.sub(r"(morphik://[^:]*:)[^@]+@", r"\1<token>@", x)
    return x


def _assert_same(t, j, where="", atol=1e-6):
    """Equal JSON, floats within `atol`."""
    if isinstance(t, dict) and isinstance(j, dict):
        assert list(t) == list(j), (where, list(t), list(j))
        for k in t:
            _assert_same(t[k], j[k], f"{where}.{k}", atol)
    elif isinstance(t, list) and isinstance(j, list):
        assert len(t) == len(j), (where, t, j)
        for i, (a, b) in enumerate(zip(t, j)):
            _assert_same(a, b, f"{where}[{i}]", atol)
    elif isinstance(t, float) or isinstance(j, float):
        assert abs(t - j) <= atol, (where, t, j)
    else:
        assert t == j, (where, t, j)


def _upload_body(filename, data, ctype, fields=None):
    return _multipart("file", filename, data, ctype, fields)


# ------------------------------------------------ the request sequence

PDF_PAGES = {
    "a.pdf": ["quarterly revenue AV office growth", "supplier invoice renewal clause"],
    "b.pdf": ["signature page of the contract"],
    "c.pdf": ["table of contents and figure latency"],
}
RETRIEVES = ["quarterly revenue", "supplier invoice", "signature page"]


def _steps(rng):
    """(name, method, path, body, options) of the sequence; a path or body
    may be a function of the results so far (by name), a body a
    (multipart bytes, content type) pair. options: `wait` (the document
    of the result's `external_id` is ingested first), `atol` (ColPali
    scores), `binary`."""
    notes = [_prose(rng, 150) for _ in range(3)]
    pdfs = {n: _text_pdf(p) for n, p in PDF_PAGES.items()}
    page = _page(rng, 224, 224, n_blocks=6)
    steps = [
        ("f1", "POST", "/folders", {"name": "Reports", "description": "quarterly"}),
        ("f2", "POST", "/folders", {"name": "2026", "parent_path": "/Reports"}),
        ("f3", "POST", "/folders", {"name": "Other"}),
        ("f_again", "POST", "/folders", {"name": "Reports"}),
        ("f_bad", "POST", "/folders", {}),
        ("folders", "GET", "/folders", None),
        ("folders_under", "GET", "/folders?parent_path=/Reports", None),
        ("f2_get", "GET", lambda r: f"/folders/{r['f2']['id']}", None),
        ("f_missing", "GET", "/folders/nope", None),
        ("t0", "POST", "/ingest/text", {"content": notes[0], "filename": "n0.txt", "metadata": {"i": 0},
                                        "folder_name": "Reports/2026", "use_colpali": False}),
        ("t1", "POST", "/ingest/text", {"content": notes[1], "filename": "n1.txt", "metadata": {"i": 1},
                                        "folder_name": "/Reports", "use_colpali": False}),
        ("t2", "POST", "/ingest/text", {"content": notes[2], "filename": "n2.txt", "metadata": {"i": 2},
                                        "use_colpali": False}),
        ("a", "POST", "/ingest/file", _upload_body("a.pdf", pdfs["a.pdf"], "application/pdf",
                                                   {"folder_name": "Reports/2026", "metadata": '{"kind": "pdf"}'}),
         {"wait": True}),
        ("b", "POST", "/ingest/file", _upload_body("b.pdf", pdfs["b.pdf"], "application/pdf",
                                                   {"folder_name": "Reports", "metadata": '{"kind": "pdf"}'}),
         {"wait": True}),
        ("c", "POST", "/ingest/file", _upload_body("c.pdf", pdfs["c.pdf"], "application/pdf",
                                                   {"metadata": '{"kind": "pdf"}'}), {"wait": True}),
        ("list", "POST", "/documents", None),
        ("list_alias", "POST", "/documents/list_docs", {"skip": 1, "limit": 3}),
        ("list_tree", "POST", "/documents", {"folder_name": "/Reports", "folder_depth": -1}),
        ("list_exact", "POST", "/documents", {"folder_name": "/Reports"}),
        ("list_leaf", "POST", "/documents", {"folder_name": "2026"}),
        ("list_depth1", "POST", "/documents?folder_depth=1", {"folder_name": "/Reports"}),
        ("by_name", "GET", "/documents/filename/n1.txt", None),
        ("by_name_missing", "GET", "/documents/filename/none.txt", None),
        ("search", "POST", "/search/documents", {"query": ".pdf"}),
        ("batch_docs", "POST", "/batch/documents",
         lambda r: {"document_ids": [r[n]["external_id"] for n in ("a", "b", "c", "t0")], "folder_name": "/Reports/2026"}),
    ]
    for i, q in enumerate(RETRIEVES):
        steps += [
            (f"scoped{i}", "POST", "/retrieve/chunks", {"query": q, "k": 3, "folder_name": "/Reports",
                                                        "folder_depth": -1}, {"atol": SCORE_ATOL}),
            (f"docs{i}", "POST", "/retrieve/docs", {"query": q, "k": 3, "folder_name": "/Reports",
                                                    "folder_depth": -1}, {"atol": SCORE_ATOL}),
            (f"text_docs{i}", "POST", "/retrieve/docs", {"query": q, "k": 3, "use_colpali": False}),
        ]
    steps += [
        ("rename", "POST", lambda r: f"/folders/{r['f1']['id']}/rename", {"new_name": "Archive"}),
        ("rename_taken", "POST", lambda r: f"/folders/{r['f1']['id']}/rename", {"new_name": "Other"}),
        ("rename_bad", "POST", lambda r: f"/folders/{r['f2']['id']}/rename", {"new_name": "a/b"}),
        ("list_renamed", "POST", "/documents", {"folder_name": "/Archive", "folder_depth": -1}),
        ("scoped_renamed", "POST", "/retrieve/chunks", {"query": RETRIEVES[0], "k": 3, "folder_name": "/Archive",
                                                         "folder_depth": -1}, {"atol": SCORE_ATOL}),
        ("move_into_self", "POST", lambda r: f"/folders/{r['f1']['id']}/move", {"new_parent_path": "/Archive/2026"}),
        ("move", "POST", lambda r: f"/folders/{r['f2']['id']}/move", {"new_parent_path": None}),
        ("list_moved", "POST", "/documents", {"folder_name": "/2026"}),
        ("summaries", "GET", "/folders/summary", None),
        ("details", "POST", "/folders/details", {}),
        ("details_ids", "POST", "/folders/details", lambda r: {"identifiers": [r["f2"]["id"], "/Archive", "nope"]}),
        ("add_doc", "POST", lambda r: f"/folders/{r['f1']['id']}/documents/{r['c']['external_id']}", None),
        ("c_in_folder", "GET", lambda r: f"/documents/{r['c']['external_id']}", None),
        ("remove_doc", "DELETE", lambda r: f"/folders/{r['f1']['id']}/documents/{r['c']['external_id']}", None),
        ("add_missing", "POST", lambda r: f"/folders/{r['f1']['id']}/documents/nope", None),
        ("doc_summary_none", "GET", lambda r: f"/documents/{r['a']['external_id']}/summary", None),
        ("doc_summary", "PUT", lambda r: f"/documents/{r['a']['external_id']}/summary", {"content": "two pages"}),
        ("doc_summary2", "PUT", lambda r: f"/documents/{r['a']['external_id']}/summary", {"content": "v2 ü"}),
        ("doc_summary_get", "GET", lambda r: f"/documents/{r['a']['external_id']}/summary", None),
        ("doc_summary_big", "PUT", lambda r: f"/documents/{r['a']['external_id']}/summary",
         {"content": "x" * (256 * 1024 + 1)}),
        ("folder_summary", "PUT", lambda r: f"/folders/{r['f1']['id']}/summary", {"content": "the archive"}),
        ("folder_summary_get", "GET", lambda r: f"/folders/{r['f1']['id']}/summary", None),
        ("download_url", "GET", lambda r: f"/documents/{r['b']['external_id']}/download_url", None),
        ("file", "GET", lambda r: f"/documents/{r['b']['external_id']}/file", None, {"binary": True}),
        ("file_missing", "GET", lambda r: f"/documents/{r['t0']['external_id']}/file", None),
        ("pages", "POST", "/documents/pages", lambda r: {"document_id": r["a"]["external_id"], "end_page": 3}),
        ("pages_bad", "POST", "/documents/pages", lambda r: {"document_id": r["a"]["external_id"], "start_page": 2,
                                                             "end_page": 1}),
        ("update_metadata", "POST", lambda r: f"/documents/{r['b']['external_id']}/update_metadata", {"extra": 1}),
        ("update_text", "POST", lambda r: f"/documents/{r['t2']['external_id']}/update_text",
         {"content": "renewal clause of the supplier invoice " * 20, "metadata": {"v": 2}, "use_colpali": True}),
        ("update_file", "POST", lambda r: f"/documents/{r['c']['external_id']}/update_file",
         _upload_body("c2.pdf", _text_pdf(["budget risk schedule", "audit committee minutes"]), "application/pdf",
                      {"metadata": '{"v": 3}'})),
        ("update_missing", "POST", "/documents/nope/update_metadata", {"x": 1}),
        ("pages_updated", "POST", "/documents/pages", lambda r: {"document_id": r["c"]["external_id"]}),
        ("after_update", "POST", "/retrieve/chunks", {"query": "audit committee minutes", "k": 4,
                                                      "filters": {"v": 3}}, {"atol": SCORE_ATOL}),
        ("requeue", "POST", "/ingest/requeue", lambda r: {"document_ids": [r["b"]["external_id"], "nope"]}),
        ("b_requeued", "GET", lambda r: f"/documents/{r['b']['external_id']}/status", None, {"wait_doc": "b"}),
        ("query_chat", "POST", "/query", {"query": RETRIEVES[1], "k": 1, "chat_id": "chat-1", "use_colpali": False}),
        ("chat", "GET", "/chat/chat-1", None),
        ("chats", "GET", "/chats", None),
        ("chat_title", "PATCH", "/chats/chat-1/title", {"title": "invoices"}),
        ("chats_titled", "GET", "/chats", None),
        ("chat_title_missing", "PATCH", "/chats/nope/title", {"title": "x"}),
        ("models_available", "GET", "/models/available", None),
        ("custom_model", "POST", "/models/custom", {"provider": "openai", "model_name": "m1", "apiKey": "sk-1"}),
        ("custom_model2", "POST", "/models", {"provider": "ollama", "model_name": "m2"}),
        ("custom_models", "GET", "/models/custom", None),
        ("custom_delete", "DELETE", lambda r: f"/models/custom/{r['custom_model2']['id']}", None),
        ("custom_delete_again", "DELETE", lambda r: f"/models/{r['custom_model2']['id']}", None),
        ("api_key", "POST", "/api-keys", {"provider": "openai", "api_key": "sk-2", "base_url": "http://x"}),
        ("api_key2", "POST", "/api-keys", {"provider": "openai", "api_key": "sk-3"}),
        ("api_key_bad", "POST", "/api-keys", {"provider": "openai"}),
        ("api_keys", "GET", "/api-keys", None),
        ("local_uri", "POST", "/local/generate_uri", {"name": "Dev User"}),
        ("app", "POST", "/cloud/generate_uri", {"name": "app1"}),
        ("apps", "GET", "/apps", None),
        ("app_rename", "POST", "/apps/rename", lambda r: {"app_id": r["app"]["app_id"], "new_name": "app2"}),
        ("app_rotate", "POST", "/apps/rotate_token", lambda r: {"app_id": r["app"]["app_id"]}),
        ("apps_after", "GET", "/apps", None),
        ("app_delete", "DELETE", lambda r: f"/apps?app_id={r['app']['app_id']}", None),
        ("app_delete_again", "DELETE", lambda r: f"/apps?app_id={r['app']['app_id']}", None),
        ("migrate", "POST", "/migrate/document",
         _upload_body("m.txt", b"migrated body about renewal", "text/plain",
                      {"source_document_id": "legacy-1", "use_colpali": "false", "folder_name": "Archive"}),
         {"wait": True}),
        ("migrate_skip", "POST", "/migrate/document",
         _upload_body("m.txt", b"x", "text/plain", {"source_document_id": "legacy-1"})),
        ("migrate_conflict", "POST", "/migrate/document",
         _upload_body("m.txt", b"x", "text/plain", {"source_document_id": "legacy-1", "on_conflict": "error"})),
        ("migrate_no_id", "POST", "/migrate/document", _upload_body("m.txt", b"x", "text/plain")),
        ("storage", "GET", "/usage/app-storage", None),
        ("v2", "POST", "/v2/documents", _upload_body("v.pdf", _text_pdf(["Quarterly Report", "renewal clause"]),
                                                     "application/pdf", {"folder_path": "/v2"})),
        ("v2_txt", "POST", "/v2/documents", _upload_body("v.txt", b"turbines\n\nwind farms", "text/plain")),
        ("v2_retrieve", "POST", "/v2/retrieve/chunks", {"query": "renewal clause", "k": 3}),
        ("v2_retrieve_folder", "POST", "/v2/retrieve/chunks", {"query": "turbines", "k": 3, "folder_path": "/v2"}),
        ("v2_delete", "DELETE", lambda r: f"/v2/documents/{r['v2']['external_id']}", None),
        ("v2_delete_missing", "DELETE", "/v2/documents/nope", None),
        ("v2_after", "POST", "/v2/retrieve/chunks", {"query": "renewal clause", "k": 3}),
        ("delete_folder", "DELETE", lambda r: f"/folders/{r['f2']['id']}", None),
        ("delete_folder_again", "DELETE", lambda r: f"/folders/{r['f2']['id']}", None),
        ("folders_end", "GET", "/folders", None),
    ]
    return [s if len(s) == 5 else s + ({},) for s in steps], page


def _wait(base, doc_id, timeout_s=120.0):
    deadline = time.time() + timeout_s
    while (st := _call(base, "GET", f"/documents/{doc_id}/status")[1])["status"] != "completed":
        assert st["status"] != "failed" and time.time() < deadline, st
        time.sleep(0.05)


def _drive(base, steps):
    """Run `steps` against one server -> {name: (status, body)}."""
    out, results = {}, {}
    for name, method, path, body, opts in steps:
        path = path(results) if callable(path) else path
        body = body(results) if callable(body) else body
        headers = None
        if isinstance(body, tuple):
            body, ctype = body
            headers = {"Content-Type": ctype}
        if opts.get("binary"):
            import urllib.request

            with urllib.request.urlopen(base + path, timeout=60) as resp:
                out[name] = (resp.status, resp.read())
            continue
        status, got = _call(base, method, path, body, headers)
        if opts.get("wait") and status == 200:
            _wait(base, (got.get("document") or got)["external_id"])
        if "wait_doc" in opts:
            _wait(base, results[opts["wait_doc"]]["external_id"])
            status, got = _call(base, method, path, body, headers)
        out[name] = (status, got)
        results[name] = got
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The port server and the JAX server given the same sequence under
    the same ids; both stay up for the tests."""
    root = tmp_path_factory.mktemp("corpus")
    steps, page = _steps(np.random.default_rng(61))
    lt = _LoopThread()
    out = {"root": root, "lt": lt, "steps": steps, "page": page, "base": {}, "answers": {}, "services": {}}
    srvs = []
    mp = pytest.MonkeyPatch()
    try:
        for name in ("torch", "jax"):
            # each package keeps one TelemetryService a process, made by its
            # first build: this server's spans and profiles go under its root
            JTelemetry.reset()
            TTelemetry.reset()
            if name == "torch":
                services = build_services(Settings.from_dict(_settings(root, name)),
                                          colqwen_model=TModel.from_fixture(FIXTURE, device="cpu"), device="cpu")
                srv = HTTPServer(build_app(services), "127.0.0.1", 0)
            else:
                services = j_build_services(JSettings.model_validate(_settings(root, name)),
                                            colqwen_model=JModel.from_fixture(FIXTURE))
                srv = JHTTPServer(j_build_app(services), "127.0.0.1", 0)
            lt.run(services.initialize())
            lt.run(srv.start())
            srvs.append((srv, services))
            base = out["base"][name] = f"http://127.0.0.1:{srv.port}"
            out["services"][name] = services
            mp.setattr(uuid, "uuid4", _SeqIds())
            out["answers"][name] = _drive(base, steps)
            mp.undo()
        yield out
    finally:
        mp.undo()
        for srv, services in srvs:
            lt.run(srv.stop())
            lt.run(services.shutdown())
        lt.close()


def _pair(corpus, name):
    roots = {n: str(corpus["root"] / n) for n in ("torch", "jax")}
    (ts_, tb), (js_, jb) = corpus["answers"]["torch"][name], corpus["answers"]["jax"][name]
    if isinstance(tb, (dict, list)):
        tb, jb = _norm(tb, roots["torch"]), _norm(jb, roots["jax"])
    return ts_, tb, js_, jb


def _step_names():
    steps, _ = _steps(np.random.default_rng(61))
    return [(s[0], s[4].get("atol", 1e-6)) for s in steps]


@pytest.mark.parametrize("name,atol", _step_names())
def test_corpus_routes_match_jax_server(corpus, name, atol):
    ts_, tb, js_, jb = _pair(corpus, name)
    assert ts_ == js_, (name, tb, jb)
    _assert_same(tb, jb, name, atol)


def test_corpus_sequence_answers_what_it_should(corpus):
    """What the shared answers say, on the port's side: the folder scope
    reaches the index, a rename or move keeps it, an update replaces the
    document's rows, a revoked app token is refused."""
    a = {k: v[1] for k, v in corpus["answers"]["torch"].items()}
    st = {k: v[0] for k, v in corpus["answers"]["torch"].items()}
    ids = {n: a[n]["external_id"] for n in ("t0", "t1", "t2", "a", "b", "c")}
    assert a["t0"]["folder_path"] == "/Reports/2026" and a["t1"]["folder_name"] == "Reports"
    assert st["f_bad"] == 422 and st["f_missing"] == 404 and a["f_again"]["id"] == a["f1"]["id"]
    tree = {d["external_id"] for d in a["list_tree"]}
    assert tree == {ids[n] for n in ("t0", "t1", "a", "b")}
    assert {d["external_id"] for d in a["list_exact"]} == {ids["t1"], ids["b"]}
    assert {d["external_id"] for d in a["list_leaf"]} == {ids["t0"], ids["a"]}
    for i in range(len(RETRIEVES)):
        hits = a[f"scoped{i}"]
        assert hits and {h["document_id"] for h in hits} <= {ids["a"], ids["b"]}, hits
        best = {}
        for h in hits:  # /retrieve/docs is the grouping of the same chunks
            best[h["document_id"]] = max(best.get(h["document_id"], -1e9), h["score"])
        assert {d["document_id"]: d["score"] for d in a[f"docs{i}"]} == best
    assert {d["external_id"] for d in a["list_renamed"]} == tree
    assert [(h["document_id"], h["score"]) for h in a["scoped_renamed"]] == [
        (h["document_id"], h["score"]) for h in a["scoped0"]]
    assert st["rename_taken"] == st["rename_bad"] == st["move_into_self"] == 404
    assert {d["external_id"] for d in a["list_moved"]} == {ids["t0"], ids["a"]}
    assert a["c_in_folder"]["folder_path"] == "/Archive" and st["add_missing"] == 404
    assert a["doc_summary_get"]["content"] == "v2 ü" and a["doc_summary_get"]["version"] == 2
    assert st["doc_summary_big"] == 400 and st["doc_summary_none"] == 404
    assert a["file"] == _text_pdf(PDF_PAGES["b.pdf"]) and st["file_missing"] == 404
    assert [p["page"] for p in a["pages"]["pages"]] == [0, 1] and st["pages_bad"] == 422
    assert a["update_metadata"]["metadata"] == {"kind": "pdf", "extra": 1}
    up = a["update_file"]
    assert up["filename"] == "c2.pdf" and up["system_metadata"]["page_count"] == 2 and up["metadata"]["v"] == 3
    assert len(a["pages_updated"]["pages"]) == 2
    # the old page's row is gone: the new two pages alone
    assert sorted((h["document_id"], h["chunk_number"]) for h in a["after_update"]) == [(ids["c"], 0), (ids["c"], 1)]
    assert a["update_text"]["chunk_ids"] and a["update_text"]["metadata"]["v"] == 2
    assert a["requeue"] == {"requeued": [ids["b"]]} and a["b_requeued"]["status"] == "completed"
    assert a["app_rotate"]["token_version"] == 2 and st["app_delete_again"] == 404
    assert a["migrate"]["document"]["external_id"] == "legacy-1" and a["migrate_skip"]["status"] == "skipped"
    assert st["migrate_conflict"] == 409 and st["migrate_no_id"] == 400
    assert a["storage"]["storage_bytes"] > 0
    assert a["v2_retrieve"] and a["v2_retrieve"][0]["content"].startswith('<page n="1">')
    assert all(c["document_id"] != a["v2"]["external_id"] for c in a["v2_after"])
    assert a["api_keys"] == {"openai": {"apiKey": "***", "baseUrl": None, "configured": True}}


def test_corpus_models_report_the_device(corpus):
    """`/models` as the reference's, with the torch device as the backend
    (the reference says "tpu"; ROADMAP Queue 3)."""
    (ts_, tb), (js_, jb) = [_call(corpus["base"][n], "GET", "/models") for n in ("torch", "jax")]
    assert ts_ == js_ == 200 and tb[-1].pop("backend") == "cpu" and jb[-1].pop("backend") == "tpu"
    assert tb == jb


def test_corpus_logs_match_jax_server(corpus):
    """`/logs`: the same operations recorded, newest first."""
    got = {}
    for n in ("torch", "jax"):
        status, body = _call(corpus["base"][n], "GET", "/logs?limit=1000")
        assert status == 200 and body["count"] == len(body["events"])
        got[n] = [(e["operation"], e["status"]) for e in body["events"]]
    assert got["torch"] == got["jax"] and ("retrieve_docs", "ok") in got["torch"]
    status, body = _call(corpus["base"]["torch"], "GET", "/logs?op_type=migrate_document")
    assert [e["operation"] for e in body["events"]] == ["migrate_document"]


def test_corpus_databases_open_each_other(corpus):
    """After the renames and moves, each package reads the other's
    sqlite file the same: folders, documents and their folder paths."""
    root = corpus["root"]
    jauth = js.AuthContext(entity_id="dev_user", permissions={"read", "write"})
    tauth = ts.AuthContext(entity_id="dev_user", permissions={"read", "write"})

    def dump(db, auth):
        folders = _run(db.list_folders(auth))
        docs = _run(db.get_documents(auth, system_filters={"folder_name": "/Archive", "folder_depth": -1}))
        return ([(f["name"], f["path"], f["parent_id"] is None) for f in folders],
                sorted((d.external_id, d.folder_path) for d in docs), _run(db.list_folders_summary(auth)))

    for name in ("torch", "jax"):
        path = root / name / "db.sqlite"
        jdb, tdb = JDatabase(path), SQLiteDatabase(path)
        try:
            a, b = dump(jdb, jauth), dump(tdb, tauth)
            assert a[0] == b[0] and a[1] == b[1] and len(a[1]) >= 3
            assert [_norm(x, "<none>") for x in a[2]] == [_norm(x, "<none>") for x in b[2]]
        finally:
            jdb.close()
            tdb.close()


# ---------------------------------------------------------- /embeddings


def test_embeddings_npz_matches_jax_server(corpus):
    page = corpus["page"]
    images = [bytes_to_data_uri(encode_png(page), "image/png"),
              bytes_to_data_uri(encode_png(np.ascontiguousarray(page[:, ::-1])), "image/png")]
    got = {}
    for body in ({"input_type": "image", "inputs": images}, {"input_type": "text", "inputs": ["supplier", "audit"]}):
        for n in ("torch", "jax"):
            import urllib.request

            req = urllib.request.Request(corpus["base"][n] + "/embeddings", data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                got[n] = np.load(io.BytesIO(resp.read()))
        assert sorted(got["torch"].files) == sorted(got["jax"].files) == ["emb_0", "emb_1"]
        for k in got["torch"].files:
            t, j = got["torch"][k], got["jax"][k]
            assert t.shape == j.shape and t.dtype == j.dtype == np.float32, (k, t.shape, j.shape, t.dtype, j.dtype)
            np.testing.assert_allclose(t, j, rtol=0, atol=EMBED_ATOL)
    # the npz is the in-process embed_for_ingestion of the same chunks
    emb = corpus["services"]["torch"].colpali_embedding_model
    want = _run(emb.embed_for_ingestion([ts.Chunk(content="supplier"), ts.Chunk(content="audit")]))
    assert all(np.array_equal(got["torch"][f"emb_{i}"], w) for i, w in enumerate(want))


def test_embeddings_api_key(corpus, monkeypatch):
    """With `morphik_embedding_api_key` set, only that bearer key passes."""
    settings = corpus["services"]["torch"].settings
    monkeypatch.setattr(settings.morphik, "morphik_embedding_api_key", "k-123")
    base = corpus["base"]["torch"]
    body = {"input_type": "text", "inputs": ["x"]}
    assert _call(base, "POST", "/embeddings", body)[0] == 401
    assert _call(base, "POST", "/embeddings", body, {"Authorization": "Bearer k-124"})[0] == 401
    import urllib.request

    req = urllib.request.Request(base + "/embeddings", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", "Authorization": "Bearer k-123"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.status == 200 and np.load(io.BytesIO(resp.read())).files == ["emb_0"]


# ---------------------------------------------------- the index files


def _fake_embed(fde_dim, dim):
    """One deterministic function of a chunk's content, for both packages:
    (multivector, FDE row) from a seed of its bytes."""
    import hashlib

    def embed_sync(chunks):
        if not isinstance(chunks, list):
            chunks = [chunks]
        embs, fdes = [], []
        for c in chunks:
            c.metadata.pop("_patches", None)
            c.metadata.pop("_jpeg", None)
            seed = int.from_bytes(hashlib.sha256(c.content.encode()).digest()[:8], "little")
            rng = np.random.default_rng(seed)
            x = rng.standard_normal((int(rng.integers(8, 24)), dim)).astype(np.float32)
            embs.append(x / np.linalg.norm(x, axis=1, keepdims=True))
            fdes.append(rng.standard_normal(fde_dim).astype(np.float32))
        return embs, fdes

    return embed_sync


def test_update_index_files_match_jax(tmp_path, monkeypatch):
    """`update_text` and `update_file` (delete the old rows from both
    stores, ingest again) in both packages, with the embedders replaced by
    one deterministic function of the chunk: byte-identical ColPali index
    files and text-index files after `save()`."""
    rng = np.random.default_rng(71)
    texts = [_prose(rng, 120) for _ in range(3)]
    pdf1, pdf2 = _text_pdf(["revenue growth", "supplier invoice"]), _text_pdf(["audit", "risk budget", "policy"])
    lt = _LoopThread()
    got = {}
    try:
        for name in ("torch", "jax"):
            mp = pytest.MonkeyPatch()
            mp.setattr(uuid, "uuid4", _SeqIds())
            if name == "torch":
                services = build_services(Settings.from_dict(_settings(tmp_path, name)),
                                          colqwen_model=TModel.from_fixture(FIXTURE, device="cpu"), device="cpu")
                auth = ts.AuthContext(entity_id="u", permissions={"read", "write"})
            else:
                services = j_build_services(JSettings.model_validate(_settings(tmp_path, name)),
                                            colqwen_model=JModel.from_fixture(FIXTURE))
                auth = js.AuthContext(entity_id="u", permissions={"read", "write"})
            emb = services.colpali_embedding_model
            fake = _fake_embed(1024, emb.embedding_dim)
            mp.setattr(emb, "embed_for_ingestion_sync", fake)
            lt.run(services.initialize())
            try:
                ing = services.ingestion_service

                async def go():
                    t = await ing.ingest_text(texts[0], "t.txt", {}, auth, use_colpali=True)
                    await ing.update_document(t.external_id, auth, content=texts[1], use_colpali=True)
                    d = await ing.ingest_file_content(pdf1, "p.pdf", {}, auth)
                    await ing.process_ingestion_job(d.external_id, auth)
                    services.persist_indexes()
                    await ing.update_document(d.external_id, auth, file_bytes=pdf2, filename="p2.pdf")
                    await ing.update_document(t.external_id, auth, content=texts[2], use_colpali=True,
                                              metadata={"v": 2})
                    return await services.database.get_document(d.external_id, auth)

                doc = lt.run(go())
                got[name] = doc.chunk_ids
            finally:
                lt.run(services.shutdown())
                mp.undo()
    finally:
        lt.close()
    assert got["torch"] == got["jax"] and len(got["torch"]) >= 3
    for sub in ("index", "storage/text_index"):
        tdir, jdir = tmp_path / "torch" / sub, tmp_path / "jax" / sub
        tfiles = sorted(p.relative_to(tdir) for p in tdir.rglob("*") if p.is_file())
        jfiles = sorted(p.relative_to(jdir) for p in jdir.rglob("*") if p.is_file())
        assert tfiles == jfiles and tfiles, (sub, tfiles, jfiles)
        for rel in tfiles:
            assert (tdir / rel).read_bytes() == (jdir / rel).read_bytes(), rel


# ------------------------------------------- the database, the reference's cases

A = ts.AuthContext(entity_id="userA", permissions={"read", "write", "admin"}, app_id="appA")
B = ts.AuthContext(entity_id="userB", permissions={"read", "write", "admin"}, app_id="appB")


@pytest.fixture()
def db(tmp_path):
    d = SQLiteDatabase(str(tmp_path / "db.sqlite"))
    _run(d.initialize())
    yield d
    d.close()


def test_folder_path_collisions_are_tenant_scoped(db):
    fa = _run(db.create_folder("reports", A))
    fb = _run(db.create_folder("reports", B))
    assert fa["id"] != fb["id"]
    assert _run(db.delete_folder(fb["id"], B))
    assert _run(db.get_folder_by_path("/reports", A)) is not None
    assert _run(db.get_folder_by_path("/reports", B)) is None


def test_folder_rename_does_not_touch_other_tenant_subtrees(db):
    _run(db.create_folder("x", A))
    _run(db.create_folder("sub", A, parent_path="/x"))
    xb = _run(db.create_folder("x", B))
    _run(db.create_folder("sub", B, parent_path="/x"))
    assert _run(db.rename_folder(xb["id"], "y", B))
    assert _run(db.get_folder_by_path("/y/sub", B)) is not None
    assert _run(db.get_folder_by_path("/x/sub", A)) is not None
    assert _run(db.get_folder_by_path("/x/sub", B)) is None


def test_move_folder_guards(db):
    a = _run(db.create_folder("a", A))
    _run(db.create_folder("b", A, parent_path="/a"))
    assert not _run(db.move_folder(a["id"], "/a/b", A))
    assert _run(db.get_folder_by_path("/a/b", A)) is not None
    _run(db.create_folder("c", A))
    _run(db.create_folder("a", A, parent_path="/c"))
    assert not _run(db.move_folder(a["id"], "/c", A))
    assert _run(db.get_folder_by_path("/a", A)) is not None


def test_move_rewrites_documents_prefix_safely(db):
    """A move re-roots the subtree's documents, not a sibling whose path
    shares the prefix ('/a' vs '/ab'), nor another tenant's."""
    for name in ("a", "ab"):
        _run(db.create_folder(name, A))
    _run(db.create_folder("s", A, parent_path="/a"))
    _run(db.create_folder("a", B))
    for i, (fp, auth) in enumerate((("/a", A), ("/a/s", A), ("/ab", A), ("/a", B))):
        _run(db.store_document(ts.Document(external_id=f"m{i}", content_type="text/plain", folder_path=fp), auth))
    _run(db.create_folder("z", A))
    assert _run(db.move_folder(_run(db.get_folder_by_path("/a", A))["id"], "/z", A))
    paths = {f"m{i}": _run(db.get_document(f"m{i}", auth)).folder_path for i, auth in enumerate((A, A, A, B))}
    assert paths == {"m0": "/z/a", "m1": "/z/a/s", "m2": "/ab", "m3": "/a"}
    assert _run(db.get_folder_by_path("/z/a/s", A)) is not None


def test_chat_ownership_enforced(db):
    assert _run(db.upsert_chat_history("chat1", "userA", "appA", [{"role": "user", "content": "hi"}]))
    assert _run(db.get_chat_history("chat1", "userB", "appB")) is None
    assert not _run(db.upsert_chat_history("chat1", "userB", "appB", [{"role": "user", "content": "pwn"}]))
    assert not _run(db.update_chat_title("chat1", "pwned", "userB", "appB"))
    assert _run(db.get_chat_history("chat1", "userA", "appA")) == [{"role": "user", "content": "hi"}]
    assert _run(db.update_chat_title("chat1", "mine", "userA", "appA"))
    assert [c["title"] for c in _run(db.list_chats("userA", "appA"))] == ["mine"]
    assert _run(db.list_chats("userB", "appB")) == []


def test_folder_depth_levels(db):
    for path, name in ((None, "top"), ("/top", "mid"), ("/top/mid", "deep")):
        _run(db.create_folder(name, A, parent_path=path))
    for i, fp in enumerate(("/top", "/top/mid", "/top/mid/deep")):
        _run(db.store_document(ts.Document(external_id=f"fd{i}", content_type="text/plain", folder_path=fp,
                                           system_metadata={"status": "completed"}), A))

    def ids(depth):
        docs = _run(db.get_documents(A, filters={}, system_filters={"folder_path": "/top", "folder_depth": depth}))
        return sorted(d.external_id for d in docs)

    assert ids(0) == ["fd0"]
    assert ids(1) == ["fd0", "fd1"]
    assert ids(2) == ["fd0", "fd1", "fd2"]
    assert ids(-1) == ["fd0", "fd1", "fd2"]


@pytest.mark.parametrize("depth,name", [(None, "/top/mid"), (0, "mid"), (1, "top"), (-1, "/top"), (2, "top")])
def test_folder_filters_match_jax(tmp_path, depth, name):
    """`folder_name` as a leaf name or a full path, at each `folder_depth`:
    the same document set (the `doc_ids` a scoped retrieve hands the
    index) from both packages on the same file."""
    tdb = SQLiteDatabase(str(tmp_path / "db.sqlite"))
    _run(tdb.initialize())
    for path, leaf in ((None, "top"), ("/top", "mid"), ("/top/mid", "deep"), (None, "mid")):
        _run(tdb.create_folder(leaf, A, parent_path=path))
    for i, (fp, fn) in enumerate((("/top", "top"), ("/top/mid", "mid"), ("/top/mid/deep", "deep"), ("/mid", "mid"),
                                  (None, None))):
        _run(tdb.store_document(ts.Document(external_id=f"d{i}", content_type="text/plain", folder_path=fp,
                                            folder_name=fn, system_metadata={"status": "completed"}), A))
    jdb = JDatabase(str(tmp_path / "db.sqlite"))
    sf = {"folder_name": name, "folder_depth": depth}
    ja = js.AuthContext(entity_id="userA", permissions={"read"}, app_id="appA")
    got = sorted(_run(tdb.find_authorized_and_filtered_documents(A, None, sf)))
    assert got == sorted(_run(jdb.find_authorized_and_filtered_documents(ja, None, sf))) and got
    tdb.close()
    jdb.close()


# ------------------------------------------------------- the two repairs


def test_token_revoked_by_the_jax_server_answers_401(tmp_path):
    """The JAX server mints an app token, then rotates it; a port server on
    the same `storage_path` (the same `user_limits.db`) refuses the old
    token and takes the new one."""
    raw = _settings(tmp_path, "shared")
    lt = _LoopThread()
    try:
        j_services = j_build_services(JSettings.model_validate(raw), colqwen_model=JModel.from_fixture(FIXTURE))
        lt.run(j_services.initialize())
        jsrv = JHTTPServer(j_build_app(j_services), "127.0.0.1", 0)
        lt.run(jsrv.start())
        jbase = f"http://127.0.0.1:{jsrv.port}"
        try:
            status, app = _call(jbase, "POST", "/cloud/generate_uri", {"name": "shared-app"})
            assert status == 200
            old = app["uri"].split(":", 2)[2].rsplit("@", 1)[0]
            status, rot = _call(jbase, "POST", "/apps/rotate_token", {"app_id": app["app_id"]})
            assert status == 200 and rot["token_version"] == 2
            new = rot["uri"].split(":", 2)[2].rsplit("@", 1)[0]
            assert _call(jbase, "GET", "/chats", headers={"Authorization": f"Bearer {old}"})[0] == 401
        finally:
            lt.run(jsrv.stop())
            lt.run(j_services.shutdown())
        services = build_services(Settings.from_dict(raw), colqwen_model=TModel.from_fixture(FIXTURE, device="cpu"),
                                  device="cpu")
        lt.run(services.initialize())
        srv = HTTPServer(build_app(services), "127.0.0.1", 0)
        lt.run(srv.start())
        base = f"http://127.0.0.1:{srv.port}"
        try:
            for path in ("/chats", "/folders"):
                status, body = _call(base, "GET", path, headers={"Authorization": f"Bearer {old}"})
                assert status == 401 and "revoked" in body["detail"], body
                assert _call(base, "GET", path, headers={"Authorization": f"Bearer {new}"})[0] == 200
            # and the other way round: a rotation on the port revokes on both
            status, rot = _call(base, "POST", "/apps/rotate_token", {"app_id": app["app_id"]})
            assert status == 200 and rot["token_version"] == 3
            assert _call(base, "GET", "/chats", headers={"Authorization": f"Bearer {new}"})[0] == 401
        finally:
            lt.run(srv.stop())
            lt.run(services.shutdown())
    finally:
        lt.close()


def test_enable_profiling_writes_a_profile_per_request(tmp_path):
    """`service.enable_profiling` serves the reference's per-request
    cProfile wrapper: one `profile_{METHOD}_{path}_{ms}.prof` a request,
    beside the telemetry directory."""
    import pstats

    raw = _settings(tmp_path, "prof")
    raw["service"] = {"enable_profiling": True}
    raw["morphik"] = {"enable_colpali": False}
    lt = _LoopThread()
    try:
        services = build_services(Settings.from_dict(raw), device="cpu")
        lt.run(services.initialize())
        srv = HTTPServer(build_app(services), "127.0.0.1", 0)
        lt.run(srv.start())
        base = f"http://127.0.0.1:{srv.port}"
        try:
            for method, path in (("GET", "/ping"), ("GET", "/folders"), ("POST", "/folders")):
                _call(base, method, path, {"name": "p"} if method == "POST" else None)
                time.sleep(0.002)
        finally:
            lt.run(srv.stop())
            lt.run(services.shutdown())
    finally:
        lt.close()
    profiles = sorted((tmp_path / "prof" / "logs").glob("profile_*.prof"))
    names = sorted(re.sub(r"_\d+\.prof$", "", p.name) for p in profiles)
    assert names == ["profile_GET_folders", "profile_GET_ping", "profile_POST_folders"], names
    assert pstats.Stats(str(profiles[0])).total_calls > 0


def test_device_profile_route(corpus):
    """`/logs/profile/device` on the CPU: a Chrome trace of the window
    (CPU activity here; the card test checks the kernels' names), 422 on
    a bad window, 409 while another capture runs."""
    import threading

    base = corpus["base"]["torch"]
    for bad in ({"seconds": 0}, {"seconds": 31}, {"seconds": "x"}, {"seconds": float("nan")}):
        assert _call(base, "POST", "/logs/profile/device", json.dumps(bad).encode(),
                     {"Content-Type": "application/json"})[0] == 422
    second = {}

    def late():
        time.sleep(0.3)
        second["answer"] = _call(base, "POST", "/logs/profile/device", {"seconds": 0.1})

    t = threading.Thread(target=late)
    t.start()
    status, out = _call(base, "POST", "/logs/profile/device", {"seconds": 1.0})
    t.join()
    assert status == 200 and out["files"] == ["trace.json"] and out["seconds"] == 1.0, out
    assert second["answer"][0] == 409, second
    trace = json.loads((Path(out["trace_dir"]) / "trace.json").read_text())
    assert "traceEvents" in trace
    assert Path(out["trace_dir"]).parent == corpus["root"] / "torch" / "logs" / "profiles"
