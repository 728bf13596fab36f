"""The port's connectors and admin console against the JAX package's, on
the CPU.

- Routes: the port server and the JAX server get one request sequence
  over the seven `/ee/connectors/{type}/...` routes for the local,
  GitHub, Google Drive and Zotero connectors, and `/console`. The remote
  APIs are `scripts/fake_providers.py` (both packages' `API` / `TOKEN_URL`
  constants pointed at it); `uuid.uuid4`, the OAuth state
  (`secrets.token_urlsafe`) and the Drive modules' clock are patched
  alike. Every answer is the same, modulo timestamps and storage roots.
  The credential files are byte-identical; the connector ingests (the
  files of `tests/fixtures/connector_files.npz`: progressive and
  multi-scan JPEGs, Adam7 and 16-bit PNGs, a PDF, text) store
  byte-identical page payloads and, with both embedders replaced by one
  deterministic function of the page, byte-identical index files. A
  remote's 404 / 401 / 403 / 500 maps to 404 / 403 / 403 / 502 in both.
- The connector objects: `sanitize_user_id` under hypothesis, the OAuth
  state's single use, GitHub's pagination at 100 entries, against the
  JAX package's.
- The reference's `tests/test_connectors.py` cases, against the port.
- Where the port differs on purpose (ROADMAP Queue 3), each beside the
  reference's behaviour: the local connector refuses a root over the
  storage directory (400), the Drive OAuth state file stays inside the
  credentials directory, the registry takes the serving app's `ee`
  settings; a CMYK JPEG from a connector ingests as the reference ingests
  it, and an arithmetic-coded JPEG answers 415.
"""

import asyncio
import base64
import hashlib
import json
import types
import uuid
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings as hsettings, strategies as st

import morphik_core_tpu.config as j_cfg
import morphik_core_tpu.ee.connectors.github as j_github
import morphik_core_tpu.ee.connectors.google_drive as j_gdrive
import morphik_core_tpu.ee.connectors.zotero as j_zotero
from morphik_core_tpu.api.app import build_app as j_build_app
from morphik_core_tpu.api.http import HTTPServer as JHTTPServer
from morphik_core_tpu.config import Settings as JSettings
from morphik_core_tpu.ee.connectors import get_connector as j_get_connector
from morphik_core_tpu.ee.connectors.base import sanitize_user_id as j_sanitize
from morphik_core_tpu.models.colqwen import ColQwenModel as JModel
from morphik_core_tpu.services_init import build_services as j_build_services
import morphik_core_tpu_torch.ee.connectors.github as t_github
import morphik_core_tpu_torch.ee.connectors.google_drive as t_gdrive
import morphik_core_tpu_torch.ee.connectors.zotero as t_zotero
from morphik_core_tpu_torch.api.app import build_app
from morphik_core_tpu_torch.api.http import HTTPServer
from morphik_core_tpu_torch.config import EEConfig, Settings
from morphik_core_tpu_torch.ee.connectors import get_connector
from morphik_core_tpu_torch.ee.connectors.base import sanitize_user_id
from morphik_core_tpu_torch.ee.connectors.github import GitHubConnector
from morphik_core_tpu_torch.ee.connectors.google_drive import GoogleDriveConnector
from morphik_core_tpu_torch.models.colqwen.model import ColQwenModel as TModel
from morphik_core_tpu_torch.scripts.fake_providers import GITHUB_TOKEN, GOOGLE_CODE, ZOTERO_KEY, FakeProviders
from morphik_core_tpu_torch.services_init import build_services
from test_torch_corpus import _assert_same, _fake_embed, _norm
from test_torch_service import FIXTURE, _LoopThread, _call, _prose, _raw_settings, _SeqIds, _text_pdf

ROOT = Path(__file__).resolve().parent.parent
FILES = ROOT / "tests" / "fixtures" / "connector_files.npz"
CONSOLE = ROOT / "morphik_core_tpu" / "api" / "console.html"
T0 = 1_750_000_000.0   # the Drive modules' clock
EE = {"google_client_id": "cid-fake", "google_client_secret": "cs-fake",
      "google_redirect_uri": "http://localhost:8000/ee/connectors/google_drive/oauth2callback"}
LOCAL_FILES = ["progressive.jpg", "multiscan.jpg", "adam7.png", "rgb16.png", "gray16.png", "report.pdf",
               "notes.txt"]
C = "/ee/connectors"


def _run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _source_dir(root: Path) -> Path:
    """The local connector's directory: the committed connector files, a
    PDF, text, and a sub-directory."""
    z = np.load(FILES)
    src = root / "src"
    (src / "sub").mkdir(parents=True)
    for name in LOCAL_FILES[:5] + ["cmyk.jpg", "arith.jpg"]:
        (src / name).write_bytes(z[name.replace(".", "_")].tobytes())
    (src / "report.pdf").write_bytes(_text_pdf(["quarterly revenue by region", "supplier invoice renewal"]))
    (src / "notes.txt").write_text(_prose(np.random.default_rng(5), 120))
    (src / "sub" / "inner.txt").write_text("connector-sourced knowledge: flux capacitors need 1.21 GW")
    return src


def _remote_content(fake: FakeProviders) -> None:
    z = np.load(FILES)
    pdf = _text_pdf(["drive report page one", "drive report page two"])
    for i in range(103):   # the root listing spans two pages of 100
        fake.add_github_file("acme/docs", f"n{i:03}.md", f"# note {i}\n".encode())
    fake.add_github_file("acme/docs", "sub/notes.md", b"# sub notes\nwarp core alignment 7 degrees")
    fake.add_github_file("acme/docs", "photo.jpg", z["progressive_jpg"].tobytes())   # past the inline limit
    for code in (401, 403, 404, 500):
        fake.add_github_file("acme/docs", f"status-{code}.txt", b"x")
    for i in range(102):
        fake.add_drive_file(f"d{i:03}", f"file {i:03}.txt", "text/plain", f"drive text {i}".encode())
    fake.add_drive_file("fold1", "Folder", "application/vnd.google-apps.folder")
    fake.add_drive_file("d-report", "report.pdf", "application/pdf", pdf, parent="fold1")
    fake.add_drive_file("g-doc", "Design doc", "application/vnd.google-apps.document", pdf, parent="fold1")
    fake.add_zotero_item("4242", "ITEM1", {"itemType": "journalArticle", "title": "On flux capacitors",
                                           "dateModified": "2026-01-01T00:00:00Z"})
    fake.add_zotero_item("4242", "ATT1", {"itemType": "attachment", "filename": "figure.png",
                                          "contentType": "image/png"}, file=z["adam7_png"].tobytes(), parent="ITEM1")


def _steps(src: Path):
    """(route, method, path, body) of the sequence; a body or path may be
    a function of the answers so far."""
    return [
        # the local connector
        ("auth_status", "GET", f"{C}/local/auth_status", None),
        ("auth/initiate_url", "GET", f"{C}/local/auth/initiate_url", None),
        ("files", "GET", f"{C}/local/files", None),
        ("oauth2callback", "GET", f"{C}/local/oauth2callback?code=x", None),
        ("oauth2callback", "GET", f"{C}/local/oauth2callback", None),
        ("auth/finalize", "POST", f"{C}/local/auth/finalize", {"root": str(src / "missing")}),
        ("auth/finalize", "POST", f"{C}/local/auth/finalize", {"root": str(src)}),
        ("auth_status", "GET", f"{C}/local/auth_status", None),
        ("files", "GET", f"{C}/local/files", None),
        ("files", "GET", f"{C}/local/files?path=sub", None),
        *[("ingest", "POST", f"{C}/local/ingest", {"file_id": n, "metadata": {"n": i}})
          for i, n in enumerate(LOCAL_FILES)],
        ("ingest", "POST", f"{C}/local/ingest", {"file_id": "sub/inner.txt", "use_colpali": False,
                                                 "folder_name": "connected"}),
        ("ingest", "POST", f"{C}/local/ingest", {"file_id": "missing.txt"}),
        ("ingest", "POST", f"{C}/local/ingest", {}),
        # GitHub
        ("auth_status", "GET", f"{C}/github/auth_status", None),
        ("auth/initiate_url", "GET", f"{C}/github/auth/initiate_url", None),
        ("files", "GET", f"{C}/github/files", None),
        ("auth/finalize", "POST", f"{C}/github/auth/finalize", {"token": "ghp_wrong", "repo": "acme/docs"}),
        ("files", "GET", f"{C}/github/files", None),
        ("auth/finalize", "POST", f"{C}/github/auth/finalize", {"token": "x"}),
        ("auth/finalize", "POST", f"{C}/github/auth/finalize", {"token": GITHUB_TOKEN, "repo": "acme/docs"}),
        ("auth_status", "GET", f"{C}/github/auth_status", None),
        ("files", "GET", f"{C}/github/files", None),
        ("files", "GET", f"{C}/github/files?page_token=2", None),
        ("files", "GET", f"{C}/github/files?path=sub", None),
        ("ingest", "POST", f"{C}/github/ingest", {"file_id": "sub/notes.md", "use_colpali": False}),
        ("ingest", "POST", f"{C}/github/ingest", {"file_id": "photo.jpg"}),
        ("ingest", "POST", f"{C}/github/ingest", {"file_id": "status-404.txt"}),
        # Google Drive
        ("auth_status", "GET", f"{C}/google_drive/auth_status", None),
        ("files", "GET", f"{C}/google_drive/files", None),
        ("auth/initiate_url", "GET", f"{C}/google_drive/auth/initiate_url", None),
        ("oauth2callback", "GET", f"{C}/google_drive/oauth2callback?code={GOOGLE_CODE}&state=forged", None),
        ("oauth2callback", "GET", lambda prev: f"{C}/google_drive/oauth2callback?code={GOOGLE_CODE}&state="
                                               f"{prev['initiate1']['state']}", None),
        ("auth/initiate_url", "GET", f"{C}/google_drive/auth/initiate_url", None),
        ("oauth2callback", "GET", lambda prev: f"{C}/google_drive/oauth2callback?code={GOOGLE_CODE}&state="
                                               f"{prev['initiate2']['state']}", None),
        ("oauth2callback", "GET", lambda prev: f"{C}/google_drive/oauth2callback?code={GOOGLE_CODE}&state="
                                               f"{prev['initiate2']['state']}", None),
        ("auth_status", "GET", f"{C}/google_drive/auth_status", None),
        ("files", "GET", f"{C}/google_drive/files", None),
        ("files", "GET", f"{C}/google_drive/files?page_token=100", None),
        ("files", "GET", f"{C}/google_drive/files?path=fold1", None),
        ("ingest", "POST", f"{C}/google_drive/ingest", {"file_id": "d-report"}),
        ("ingest", "POST", f"{C}/google_drive/ingest", {"file_id": "g-doc", "use_colpali": False}),
        ("ingest", "POST", f"{C}/google_drive/ingest", {"file_id": "nope"}),
        ("auth/initiate_url", "GET", f"{C}/google_drive/auth/initiate_url", None),
        ("auth/finalize", "POST", f"{C}/google_drive/auth/finalize",
         lambda prev: {"code": "expired-grant", "state": prev["initiate3"]["state"]}),
        ("files", "GET", f"{C}/google_drive/files?path=fold1", None),   # refreshes the expired token
        # Zotero
        ("auth_status", "GET", f"{C}/zotero/auth_status", None),
        ("auth/initiate_url", "GET", f"{C}/zotero/auth/initiate_url", None),
        ("files", "GET", f"{C}/zotero/files", None),
        ("auth/finalize", "POST", f"{C}/zotero/auth/finalize", {"api_key": "wrong", "user_library_id": 4242}),
        ("files", "GET", f"{C}/zotero/files", None),
        ("auth/finalize", "POST", f"{C}/zotero/auth/finalize", {"api_key": ZOTERO_KEY, "user_library_id": 4242}),
        ("files", "GET", f"{C}/zotero/files", None),
        ("files", "GET", f"{C}/zotero/files?path=ITEM1", None),
        ("ingest", "POST", f"{C}/zotero/ingest", {"file_id": "ATT1"}),
        ("ingest", "POST", f"{C}/zotero/ingest", {"file_id": "status-500"}),
        # the rest
        ("files", "GET", f"{C}/dropbox/files", None),
        ("auth_status", "GET", f"{C}/dropbox/auth_status", None),
        ("console", "GET", "/console", None),
    ]


DISCONNECTS = [("disconnect", "POST", f"{C}/{t}/disconnect", {}) for t in ("local", "github", "google_drive", "zotero")
               for _ in range(2)] + [("disconnect", "POST", f"{C}/dropbox/disconnect", {})]


def _wait(base: str, doc_id: str, timeout_s: float = 120.0) -> str:
    import time

    deadline = time.time() + timeout_s
    while True:
        st_ = _call(base, "GET", f"/documents/{doc_id}/status")[1]["status"]
        if st_ in ("completed", "failed") or time.time() > deadline:
            return st_
        time.sleep(0.05)


def _cred_files(storage: Path) -> dict:
    d = storage / "connector_credentials"
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())} if d.exists() else {}


@pytest.fixture(scope="module")
def conn(tmp_path_factory):
    """Both servers, each given the whole sequence (the JAX server second,
    with the same patched ids, state and clock)."""
    root = tmp_path_factory.mktemp("connectors")
    src = _source_dir(root)
    fake = FakeProviders().start()
    _remote_content(fake)
    lt = _LoopThread()
    out = {"root": root, "src": src, "answers": {}, "docs": {}, "creds": {}, "base": {}, "fake": fake,
           "lt": lt, "services": {}}
    mp = pytest.MonkeyPatch()
    servers = []
    try:
        for mod_gh, mod_gd, mod_z in ((j_github, j_gdrive, j_zotero), (t_github, t_gdrive, t_zotero)):
            mp.setattr(mod_gh, "API", fake.url + "/github")
            mp.setattr(mod_gd, "TOKEN_URL", fake.url + "/google/token")
            mp.setattr(mod_gd, "API", fake.url + "/google/drive/v3")
            mp.setattr(mod_z, "API", fake.url + "/zotero")
            mp.setattr(mod_gd, "time", types.SimpleNamespace(time=lambda: T0))
        for name in ("torch", "jax"):
            raw = _raw_settings(root, name)
            raw["worker"] = {"max_jobs": 1, "raster_processes": 1, "colpali_store_batch_size": 2}
            raw["parser"] = {"chunk_size": 400, "chunk_overlap": 40}
            raw["ee"] = dict(EE)
            if name == "torch":
                services = build_services(Settings.from_dict(raw),
                                          colqwen_model=TModel.from_fixture(FIXTURE, device="cpu"), device="cpu")
                srv = HTTPServer(build_app(services), "127.0.0.1", 0)
            else:
                js_ = JSettings.model_validate(raw)
                mp.setattr(j_cfg, "_settings", js_)   # the reference's registry reads the global settings
                services = j_build_services(js_, colqwen_model=JModel.from_fixture(FIXTURE))
                srv = JHTTPServer(j_build_app(services), "127.0.0.1", 0)
            emb = services.colpali_embedding_model
            mp.setattr(emb, "embed_for_ingestion_sync", _fake_embed(1024, emb.embedding_dim))
            lt.run(services.initialize())
            lt.run(srv.start())
            servers.append((srv, services))
            base = out["base"][name] = f"http://127.0.0.1:{srv.port}"
            out["services"][name] = services
            mp.setattr(uuid, "uuid4", _SeqIds())
            states = iter(f"state-{i}" for i in range(1, 100))
            for mod in (j_gdrive, t_gdrive):
                mp.setattr(mod, "secrets", types.SimpleNamespace(token_urlsafe=lambda n: next(states)))
            answers, prev, docs, n_init = [], {}, [], 0
            for route, method, path, body in _steps(src):
                path = path(prev) if callable(path) else path
                body = body(prev) if callable(body) else body
                status, res = _call(base, method, path, body)
                if route == "auth/initiate_url" and "google_drive" in path:
                    n_init += 1
                    prev[f"initiate{n_init}"] = res
                if route == "ingest" and status == 202:
                    docs.append((path.split("/")[3], body["file_id"], res["document"]["external_id"]))
                    assert _wait(base, docs[-1][2]) == "completed", (name, body)
                answers.append((route, method, path, body, status, res))
            out["creds"][name] = _cred_files(root / name / "storage")
            for route, method, path, body in DISCONNECTS:
                answers.append((route, method, path, body, *_call(base, method, path, body)))
            out["answers"][name], out["docs"][name] = answers, docs
        yield out
    finally:
        mp.undo()
        for srv, services in servers:
            lt.run(srv.stop())
            lt.run(services.shutdown())
        lt.close()
        fake.stop()


ROUTES = ["auth_status", "auth/initiate_url", "oauth2callback", "auth/finalize", "files", "ingest", "disconnect",
          "console"]


@pytest.mark.parametrize("route", ROUTES)
def test_connector_routes_match_jax_server(conn, route):
    """Each route answers every request of the sequence as the JAX
    server does: status and body (modulo timestamps and storage roots);
    none answers 501."""
    t_ans, j_ans = conn["answers"]["torch"], conn["answers"]["jax"]
    assert len(t_ans) == len(j_ans)
    n = 0
    for (r, method, path, body, ts_, tres), (_, _, jpath, _, js_, jres) in zip(t_ans, j_ans):
        if r != route:
            continue
        n += 1
        assert path == jpath and ts_ == js_ and ts_ != 501, (path, body, ts_, tres, js_, jres)
        _assert_same(_norm(tres, str(conn["root"] / "torch")), _norm(jres, str(conn["root"] / "jax")),
                     f"{method} {path}")
    assert n >= 2 if route != "console" else n == 1
    if route == "console":
        got = [a for a in t_ans if a[0] == "console"][0][5]
        assert hashlib.sha256(got.encode()).hexdigest() == hashlib.sha256(CONSOLE.read_bytes()).hexdigest()


def test_connector_sequence_reaches_every_answer(conn):
    """The sequence exercises what it claims: pagination, the remote
    errors, the state's single use, the token refresh."""
    gh = [a for a in conn["answers"]["torch"] if a[2].startswith(f"{C}/github/files")]
    assert [a[4] for a in gh] == [401, 403, 200, 200, 200]
    assert gh[2][5]["next_page_token"] == "2" and len(gh[2][5]["files"]) == 100 and gh[3][5]["next_page_token"] is None
    gd = [a for a in conn["answers"]["torch"] if a[2].startswith(f"{C}/google_drive/oauth2callback")]
    assert [a[4] for a in gd] == [400, 400, 200, 400]   # forged; consumed; issued; used twice
    refresh = [r for r in conn["fake"].requests if r["path"] == "/google/token"
               and r["body"].get("grant_type") == "refresh_token"]
    assert len(refresh) == 2   # one a server
    ingests = [a[4] for a in conn["answers"]["torch"] if a[0] == "ingest"]
    assert ingests.count(202) == len(conn["docs"]["torch"]) == 13 and 404 in ingests and 422 in ingests


def test_connector_credential_files_match_jax(conn):
    """Byte-identical credential files, in the same names; no OAuth state
    file is left once each state is consumed."""
    t, j = conn["creds"]["torch"], conn["creds"]["jax"]
    assert list(t) == list(j) and len(t) == 4, (list(t), list(j))
    for name in t:
        assert t[name] == j[name], name
    drive = json.loads(t[[n for n in t if n.startswith("google_drive_")][0]])
    assert drive["expires_at"] == T0 + 3600 and drive["refresh_token"].startswith("1//fake-refresh-")


def _pages(base, doc_id):
    status, chunks = _call(base, "POST", "/batch/chunks", {
        "sources": [{"document_id": doc_id, "chunk_number": k} for k in range(8)], "use_colpali": True})
    assert status == 200
    return [(c["chunk_number"], c["content"], c["metadata"]) for c in chunks]


@pytest.mark.parametrize("key", ["local:progressive.jpg", "local:multiscan.jpg", "local:adam7.png",
                                 "local:rgb16.png", "local:gray16.png", "local:report.pdf", "github:photo.jpg",
                                 "google_drive:d-report", "zotero:ATT1"])
def test_connector_ingest_pages_match_jax(conn, key):
    """The same connector file under the same id: byte-identical page
    payloads (q80 JPEGs of the decoded image, q70 of a PDF's pages)."""
    ctype, file_id = key.split(":")
    (tid,) = [d for c, f, d in conn["docs"]["torch"] if (c, f) == (ctype, file_id)]
    (jid,) = [d for c, f, d in conn["docs"]["jax"] if (c, f) == (ctype, file_id)]
    assert tid == jid
    got, want = _pages(conn["base"]["torch"], tid), _pages(conn["base"]["jax"], jid)
    assert got and got == want
    assert all(c.startswith("data:image/jpeg;base64,") for _, c, _ in got)
    if ctype == "local" and not file_id.endswith(".pdf"):
        z = np.load(FILES)
        payload = base64.b64decode(got[0][1].split(",", 1)[1])
        assert hashlib.sha256(payload).hexdigest() == str(z[file_id.replace(".", "_") + "_payload_sha256"])


def test_connector_index_files_match_jax(conn):
    """With both embedders one deterministic function of the page, the
    ColPali index files saved after the connector ingests are
    byte-identical."""
    for name in ("torch", "jax"):
        conn["lt"].run(asyncio.to_thread(conn["services"][name].colpali_vector_store.save))
    tdir, jdir = conn["root"] / "torch" / "index", conn["root"] / "jax" / "index"
    tfiles = sorted(p.relative_to(tdir) for p in tdir.rglob("*") if p.is_file())
    jfiles = sorted(p.relative_to(jdir) for p in jdir.rglob("*") if p.is_file())
    assert tfiles == jfiles and tfiles
    for rel in tfiles:
        assert (tdir / rel).read_bytes() == (jdir / rel).read_bytes(), rel


@pytest.mark.parametrize("code,want", [(404, 404), (401, 403), (403, 403), (500, 502)])
def test_connector_http_error_mapping_matches_jax(conn, code, want):
    """A remote HTTP error on `ingest` and on `files`: 404 stays 404, 401
    and 403 answer 403, anything else 502, in both servers."""
    got = []
    for name in ("torch", "jax"):
        base = conn["base"][name]
        assert _call(base, "POST", f"{C}/github/auth/finalize", {"token": GITHUB_TOKEN, "repo": "acme/docs"})[0] == 200
        got.append(_call(base, "POST", f"{C}/github/ingest", {"file_id": f"status-{code}.txt"}))
        got.append(_call(base, "GET", f"{C}/github/files?path=status-{code}"))
        assert _call(base, "POST", f"{C}/github/disconnect", {})[0] == 200
    assert [s for s, _ in got] == [want] * 4
    assert got[0] == got[2] and got[1] == got[3]


def test_cmyk_from_a_connector_ingests_as_the_reference(conn):
    """A CMYK JPEG from a connector, refused until the decoder read
    4-component frames, ingests on both servers under the same id to
    byte-identical payloads: the reference's q80 payload (the committed
    fixture's hash)."""
    import uuid

    got = {}
    mp = pytest.MonkeyPatch()
    try:
        for name in ("torch", "jax"):
            base = conn["base"][name]
            assert _call(base, "POST", f"{C}/local/auth/finalize", {"root": str(conn["src"])})[0] == 200
            ids = iter(range(10**6, 10**6 + 100))
            mp.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(ids)))
            status, body = _call(base, "POST", f"{C}/local/ingest", {"file_id": "cmyk.jpg"})
            mp.undo()
            assert status == 202, body
            doc = body["document"]["external_id"]
            assert _wait(base, doc) == "completed"
            got[name] = (doc, _pages(base, doc))
            assert _call(base, "POST", f"{C}/local/disconnect", {})[1] == {"status": "disconnected"}
    finally:
        mp.undo()
    assert got["torch"][0] == got["jax"][0]
    assert len(got["torch"][1]) == 1 and got["torch"][1] == got["jax"][1]
    payload = base64.b64decode(got["torch"][1][0][1].split(",", 1)[1])
    assert hashlib.sha256(payload).hexdigest() == str(np.load(FILES)["cmyk_jpg_payload_sha256"])


def test_refused_jpeg_from_a_connector_answers_415(conn):
    """`check_upload` runs before the document exists: a JPEG the port
    still refuses (arithmetic-coded) from a connector answers 415 naming
    ROADMAP item 3b-ii, and no document is made."""
    base = conn["base"]["torch"]
    assert _call(base, "POST", f"{C}/local/auth/finalize", {"root": str(conn["src"])})[0] == 200
    n_docs = len(_call(base, "POST", "/documents", {})[1])
    status, body = _call(base, "POST", f"{C}/local/ingest", {"file_id": "arith.jpg"})
    assert status == 415 and "arithmetic-coded" in body["detail"] and "ROADMAP Queue 1 item 3b-ii" in body["detail"]
    assert len(_call(base, "POST", "/documents", {})[1]) == n_docs
    assert _call(base, "POST", f"{C}/local/disconnect", {})[1] == {"status": "disconnected"}


def test_local_root_over_the_storage_directory_is_refused(conn, tmp_path):
    """ROADMAP Queue 3: the reference's local connector takes any server
    directory, the storage directory too, so a user can list and ingest
    the other users' credential files; the port's refuses a root equal
    to, above or inside the credentials directory's parent (the route
    answers 400)."""
    for name, ok in (("torch", False), ("jax", True)):
        storage = conn["root"] / name / "storage"
        base = conn["base"][name]
        for root in (storage, storage / "connector_credentials", storage.parent):
            status, _ = _call(base, "POST", f"{C}/local/auth/finalize", {"root": str(root)})
            assert (status == 200) == ok, (name, root, status)
        if ok:   # the reference then serves the credential files
            files = _call(base, "GET", f"{C}/local/files?path=storage/connector_credentials")[1]["files"]
            assert files and all(f["name"].endswith(".json") for f in files)
            _call(base, "POST", f"{C}/local/disconnect", {})
    creds = tmp_path / "store" / "connector_credentials"
    outside = tmp_path / "elsewhere"
    outside.mkdir()
    t = get_connector("local", "u", creds)
    assert not _run(t.finalize_auth({"root": str(tmp_path / "store")}))
    assert not _run(t.finalize_auth({"root": str(tmp_path)}))
    assert _run(t.finalize_auth({"root": str(outside)}))
    j = j_get_connector("local", "u", creds)
    assert _run(j.finalize_auth({"root": str(tmp_path / "store")}))
    # credentials naming a forbidden root (written by the reference) are not honoured
    assert not _run(t.get_auth_status()).is_authenticated and _run(t.list_files())["files"] == []


def test_drive_oauth_state_file_is_confined(tmp_path):
    """ROADMAP Queue 3: the reference names the OAuth state file with the
    raw user id, so an id with path separators writes it outside the
    credentials directory; the port uses the sanitized, confined name."""
    creds = tmp_path / "a" / "creds"
    user = "../../escaped"
    j = j_gdrive.GoogleDriveConnector(user, creds, client_id="cid")
    t = GoogleDriveConnector(user, creds, client_id="cid")
    _run(j.initiate_auth())
    assert (tmp_path / "escaped.google_drive.oauth_state").exists()
    out = _run(t.initiate_auth())
    inside = [p for p in creds.iterdir() if p.name.endswith(".oauth_state")]
    assert len(inside) == 1 and inside[0].name == f"{sanitize_user_id(user)}.google_drive.oauth_state"
    assert inside[0].read_text() == out["state"]


def test_registry_takes_the_serving_apps_ee_settings(tmp_path, monkeypatch):
    """ROADMAP Queue 3: the reference's registry reads the process-wide
    settings for Drive's OAuth client; the port's takes the `ee` settings
    it is given (the app passes its own), and falls back to the global."""
    monkeypatch.setattr(j_cfg, "_settings", JSettings())
    import morphik_core_tpu_torch.config as t_cfg

    monkeypatch.setattr(t_cfg, "_settings", Settings())
    j = j_get_connector("google_drive", "u", tmp_path)
    t = get_connector("google_drive", "u", tmp_path, ee=EEConfig(**EE))
    assert j.client_id is None and "credentials_required" in _run(j.initiate_auth())
    assert t.client_id == "cid-fake" and "cid-fake" in _run(t.initiate_auth())["auth_url"]
    assert get_connector("google_drive", "u", tmp_path).client_id is None


# ------------------------------------------------ the connector objects


@hsettings(max_examples=200, deadline=None)
@given(st.text(max_size=60))
def test_sanitize_user_id_matches_jax(user_id):
    assert sanitize_user_id(user_id) == j_sanitize(user_id)


def test_oauth_state_single_use_matches_jax(tmp_path, monkeypatch):
    """initiate -> a forged state is refused and consumes the issued one;
    the next issued state is accepted once; both packages alike, with
    byte-identical credential files."""
    for mod in (j_gdrive, t_gdrive):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=lambda: T0))
    got = {}
    for name, cls in (("jax", j_gdrive.GoogleDriveConnector), ("torch", GoogleDriveConnector)):
        c = cls("u1", tmp_path / name, client_id="cid", client_secret="cs")
        c._post_form = lambda url, data: {"access_token": "at", "refresh_token": "rt", "expires_in": 3600}
        s1 = _run(c.initiate_auth())["state"]
        steps = [_run(c.finalize_auth({"code": "C", "state": "forged"})),
                 _run(c.finalize_auth({"code": "C", "state": s1}))]
        s2 = _run(c.initiate_auth())["state"]
        steps += [_run(c.finalize_auth({"code": "C", "state": s2})), _run(c.finalize_auth({"code": "C", "state": s2}))]
        got[name] = (steps, c._cred_path().read_bytes(), c._cred_path().name)
    assert got["torch"] == got["jax"] and got["torch"][0] == [False, False, True, False]


def test_github_pagination_matches_jax(tmp_path, monkeypatch):
    """The contents API 100 entries a page against the fake: page 1 of a
    103-entry directory, then page 2; a single file; the tree."""
    fake = FakeProviders().start()
    try:
        _remote_content(fake)
        got = {}
        for name, mod in (("jax", j_github), ("torch", t_github)):
            monkeypatch.setattr(mod, "API", fake.url + "/github")
            c = mod.GitHubConnector("u", tmp_path / name)
            assert _run(c.finalize_auth({"token": GITHUB_TOKEN, "repo": "acme/docs"}))
            p1 = _run(c.list_files())
            p2 = _run(c.list_files(page_token=p1["next_page_token"]))
            one = _run(c.list_files(path="sub/notes.md"))
            tree = _run(c.list_repository_tree())
            got[name] = [[f.model_dump(mode="json") for f in p["files"]] + [p["next_page_token"]]
                         for p in (p1, p2, one)] + [[f.model_dump(mode="json") for f in tree["files"]]]
        assert got["torch"] == got["jax"]
        assert len(got["torch"][0]) == 101 and got["torch"][0][-1] == "2" and got["torch"][1][-1] is None
        pages = [r["path"] for r in fake.requests if "/contents/?" in r["path"]]
        assert all("per_page=100" in p for p in pages)
        assert {r["headers"]["authorization"] for r in fake.requests} == {f"Bearer {GITHUB_TOKEN}"}
    finally:
        fake.stop()


# ------------------------------ the reference's tests/test_connectors.py


def test_sanitize_user_id():
    a = sanitize_user_id("user@example.com")
    b = sanitize_user_id("user@example!com")
    assert a != b and "/" not in a and "@" not in a
    c = sanitize_user_id("../../etc")
    assert "/" not in c and ".." not in c


def test_local_connector_lifecycle(tmp_path):
    """As the reference's, with the credentials directory apart from the
    watched tree (the port refuses a root inside the credentials'
    parent)."""
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_text("alpha")
    (src / "sub" / "b.txt").write_text("beta")
    conn = get_connector("local", "u1", tmp_path / "server" / "creds")
    assert not _run(conn.get_auth_status()).is_authenticated
    assert _run(conn.initiate_auth())["credentials_required"] == ["root"]
    assert _run(conn.finalize_auth({"root": str(src)}))
    assert _run(conn.get_auth_status()).is_authenticated
    assert [f.name for f in _run(conn.list_files())["files"]] == ["sub", "a.txt"]
    assert [f.id for f in _run(conn.list_files(path="sub"))["files"]] == ["sub/b.txt"]
    assert _run(conn.download_file_by_id("sub/b.txt")).read() == b"beta"
    meta = _run(conn.get_file_metadata_by_id("a.txt"))
    assert meta.size == 5 and not meta.is_folder
    with pytest.raises(ValueError):
        _run(conn.download_file_by_id("../outside"))
    assert _run(conn.disconnect())
    assert not _run(conn.get_auth_status()).is_authenticated


def test_unknown_connector_type(tmp_path):
    with pytest.raises(KeyError):
        get_connector("dropbox", "u", tmp_path)


def _gh_entry(path, type_="file", content=None):
    e = {"path": path, "name": path.rsplit("/", 1)[-1], "type": type_, "size": 10}
    if content is not None:
        e["encoding"] = "base64"
        e["content"] = base64.b64encode(content).decode()
    return e


def test_github_connector_faked_transport(tmp_path):
    conn = GitHubConnector("u2", tmp_path / "creds")
    assert not _run(conn.get_auth_status()).is_authenticated
    assert _run(conn.finalize_auth({"token": "ghp_x", "repo": "acme/docs"}))

    def fake_json(url):
        assert "acme/docs" in url
        if url.split("?")[0].endswith("/contents/"):
            return [_gh_entry("README.md"), _gh_entry("src", "dir")]
        if url.endswith("/contents/README.md"):
            return _gh_entry("README.md", content=b"# hello")
        if "/git/trees/" in url:
            return {"tree": [{"path": "README.md", "type": "blob", "size": 7}, {"path": "src", "type": "tree"}]}
        raise AssertionError(url)

    conn._request_json = fake_json
    out = _run(conn.list_files())
    assert {f.name for f in out["files"]} == {"README.md", "src"}
    assert [f.is_folder for f in out["files"] if f.name == "src"] == [True]
    assert _run(conn.download_file_by_id("README.md")).read() == b"# hello"
    tree = _run(conn.list_repository_tree())
    assert len(tree["files"]) == 2 and not tree["truncated"]
    assert not _run(conn.finalize_auth({"token": "x"}))
    assert not _run(conn.finalize_auth({"repo": "no-slash", "token": "x"}))


def test_connector_routes_end_to_end(conn, tmp_path):
    """The reference's route test against the port server: a text file
    through the local connector, retrieved; unknown types 404."""
    base = conn["base"]["torch"]
    src = tmp_path / "watched"
    src.mkdir()
    (src / "doc.txt").write_text("Connector-sourced knowledge: flux capacitors need 1.21 GW.")
    assert not _call(base, "GET", f"{C}/local/auth_status")[1]["is_authenticated"]
    assert _call(base, "GET", f"{C}/local/files") == (200, {"files": [], "next_page_token": None})
    assert _call(base, "POST", f"{C}/local/auth/finalize", {"root": str(src)})[0] == 200
    assert [f["name"] for f in _call(base, "GET", f"{C}/local/files")[1]["files"]] == ["doc.txt"]
    status, res = _call(base, "POST", f"{C}/local/ingest", {"file_id": "doc.txt", "use_colpali": False})
    assert status == 202, res
    doc_id = res["document"]["external_id"]
    assert _wait(base, doc_id) == "completed"
    hits = _call(base, "POST", "/retrieve/chunks", {"query": "flux capacitor power", "k": 1, "use_colpali": False})[1]
    assert hits and "1.21 GW" in hits[0]["content"]
    assert _call(base, "GET", f"/documents/{doc_id}")[1]["metadata"]["connector"]["type"] == "local"
    assert _call(base, "POST", f"{C}/local/disconnect", {})[1]["status"] == "disconnected"
    assert _call(base, "GET", f"{C}/unknown/files")[0] == 404


def test_oauth_callback_route(conn):
    base = conn["base"]["torch"]
    assert _call(base, "GET", f"{C}/local/oauth2callback?code=x")[0] == 400
    assert _call(base, "GET", f"{C}/local/oauth2callback")[0] == 400
    assert _call(base, "GET", f"{C}/nope/oauth2callback?code=x")[0] == 404


def test_google_drive_token_injection(tmp_path):
    conn = GoogleDriveConnector("u3", tmp_path / "creds")
    assert not _run(conn.get_auth_status()).is_authenticated
    assert _run(conn.finalize_auth({"access_token": "tok123"}))
    assert _run(conn.get_auth_status()).is_authenticated

    def fake_json(url, token):
        assert token == "tok123"
        if "/files?" in url:
            return {"files": [{"id": "f1", "name": "Doc", "mimeType": "application/pdf", "size": "9",
                               "modifiedTime": "2026-01-01T00:00:00Z"}]}
        return {"id": "f1", "name": "Doc", "mimeType": "application/pdf", "size": "9"}

    conn._request_json = fake_json
    out = _run(conn.list_files())
    assert out["files"][0].name == "Doc" and out["files"][0].size == 9
    assert _run(conn.get_file_metadata_by_id("f1")).mime_type == "application/pdf"
    conn._request_bytes = lambda url, token: b"%PDF-bytes"
    assert _run(conn.download_file_by_id("f1")).read() == b"%PDF-bytes"


def test_google_drive_oauth_state_validated(tmp_path):
    conn = GoogleDriveConnector("u1", tmp_path, client_id="cid", client_secret="cs")
    out = _run(conn.initiate_auth())
    assert "auth_url" in out and out["state"]
    conn._post_form = lambda url, data: {"access_token": "at", "refresh_token": "rt", "expires_in": 3600}
    assert not _run(conn.finalize_auth({"code": "C", "state": "forged"}))
    out2 = _run(conn.initiate_auth())
    assert _run(conn.finalize_auth({"code": "C", "state": out2["state"]}))
    assert _run(conn.get_auth_status()).is_authenticated


def test_google_drive_config_wired(tmp_path, monkeypatch):
    """The registry passes the OAuth client: from the process-wide
    settings when given none, as the reference."""
    import morphik_core_tpu_torch.config as t_cfg

    s = Settings.from_dict({"ee": {"google_client_id": "cid-x", "google_client_secret": "cs-x"}})
    monkeypatch.setattr(t_cfg, "_settings", s)
    conn = get_connector("google_drive", "u2", tmp_path)
    assert conn.client_id == "cid-x"
    out = _run(conn.initiate_auth())
    assert "auth_url" in out and "cid-x" in out["auth_url"]


def test_github_list_files_paginates(tmp_path):
    conn = GitHubConnector("u3", tmp_path)
    _run(conn.finalize_auth({"token": "t", "repo": "acme/big"}))

    def fake_json(url):
        page = int(url.split("page=")[-1])
        return [{"path": f"f{page}_{i}", "name": f"f{page}_{i}", "type": "file", "size": 1}
                for i in range(100 if page == 1 else 7)]

    conn._request_json = fake_json
    p1 = _run(conn.list_files())
    assert len(p1["files"]) == 100 and p1["next_page_token"] == "2"
    p2 = _run(conn.list_files(page_token=p1["next_page_token"]))
    assert len(p2["files"]) == 7 and p2["next_page_token"] is None
