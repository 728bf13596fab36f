"""A local stand-in for the completion and embedding providers, the
remote parse and OCR endpoints and the connectors' remote APIs, to drive
`/query`, `output_format="text"`, the on-the-fly query, routed text
embeddings, `parser_mode="api"`, `ocr_mode="api"` and the GitHub, Google
Drive and Zotero connectors with no network: one `ThreadingHTTPServer` on
127.0.0.1 that speaks

  - OpenAI `/chat/completions` (JSON, or SSE `data:` lines up to `[DONE]`)
    and `/embeddings` (also at an Azure deployment's
    `/openai/deployments/{name}/embeddings`);
  - Ollama `/api/chat` (JSON, or NDJSON up to `"done": true`) and
    `/api/embed`;
  - Anthropic `/v1/messages` (JSON, or SSE `event:` / `data:` pairs up to
    `message_stop`);
  - a remote parse endpoint, `/parse` (`parser.parser_mode="api"`): a
    multipart body in, `{"text": parse_answer(filename, file bytes)}` out
    ("" for a scanned PDF);
  - a remote OCR endpoint, `/ocr` (`parser.ocr_mode="api"`): a PNG body
    in, `ocr_answer(pixels, tables)` out, `tables` true when the URL
    carries `tables=true`;
  - GitHub under `/github` (`github.API = url + "/github"`): the contents
    API, `/repos/{owner}/{repo}/contents/{path}` with `?per_page=` and
    `?page=` (a file as base64 `content`, or by `download_url` past
    `GITHUB_INLINE_MAX` bytes), and `/repos/{o}/{r}/git/trees/{branch}`;
    a bearer token other than `GITHUB_TOKEN` answers 401;
  - Google under `/google` (`google_drive.TOKEN_URL = url +
    "/google/token"`, `google_drive.API = url + "/google/drive/v3"`): the
    OAuth token endpoint (an authorization code, or a refresh token; a
    code starting with `expired` gives a token that has already expired;
    tokens are a function of the grant)
    and Drive v3 `files` (list by parent with `pageSize` / `pageToken`,
    get, `alt=media`, `export`); an unknown bearer token answers 401;
  - Zotero under `/zotero` (`zotero.API = url + "/zotero"`):
    `/users/{id}/items/top`, `/items/{key}`, `/items/{key}/children` and
    `/items/{key}/file`, with `?start=` / `?limit=`; a `Zotero-API-Key`
    other than `ZOTERO_KEY` answers 403.

  A connector file or item named `status-NNN` answers HTTP NNN; add files
  with `add_github_file`, `add_drive_file` and `add_zotero_item`.

Every request is recorded (path with its query string, body, headers
with lower-case names): a JSON body decoded; a parse request's body as
{"raw": the bytes, "filename", "file_bytes", "file_sha256", "fields"};
an OCR request's as {"shape", "pixels_sha256"}. A chat answer
is a function of the request: with a JSON schema in the prompt, an
object with a string for each of its properties; for the page
transcription prompt of `output_format="text"`, `TRANSCRIPTION`; else
`ANSWER`. A stream sends the answer in `STREAM_PIECES` pieces. An
embedding is the port's `HashingEmbeddingModel` vector of the input, so
routed text retrieval has a known answer. A model named `status-NNN`
answers HTTP NNN; `slow-S` answers after S seconds; `no-json` answers
`ANSWER` whatever the prompt (a schema's parse fails); `linger` keeps
writing comment lines for `HOLD_S` (60 s) after a stream's last event,
and `drip` keeps repeating its last delta for `HOLD_S` before that event;
both record in `lingered` whether the client closed the connection
before then (the tests wait `LINGER_S` + 5 s for that record).
`line_end` sets the streams' line ends.
"""

from __future__ import annotations

import base64
import hashlib
import json
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from morphik_core_tpu_torch.embedding.text_embedding import HashingEmbeddingModel
from morphik_core_tpu_torch.parser.pdf import extract_pages_text
from morphik_core_tpu_torch.utils.image import decode_image

ANSWER = "The fake provider read the retrieved pages and answers: revenue grew 12% in Q3."
TRANSCRIPTION = "# Transcribed page\n\n| quarter | revenue |\n|---|---|\n| Q3 | 12% |"
TRANSCRIBE_PROMPT = "Transcribe this page to markdown"
STREAM_PIECES = 5
LINGER_S = 5.0
# how long `drip` and `linger` keep writing while the client stays: far past the
# LINGER_S the tests give the port to close, so a slow host runs out of the
# tests' time, never of the fake's
HOLD_S = 60.0
GITHUB_TOKEN = "ghp_fake_token"
GITHUB_INLINE_MAX = 64 * 1024  # larger files come by download_url, as GitHub's past 1 MB
GOOGLE_CODE = "fake-authorization-code"
ZOTERO_KEY = "fake-zotero-key"
DRIVE_FOLDER = "application/vnd.google-apps.folder"


def _pieces(text: str, n: int = STREAM_PIECES) -> List[str]:
    step = max(1, -(-len(text) // n))
    return [text[i : i + step] for i in range(0, len(text), step)]


def _text_of(content: Any) -> str:
    """The text of an OpenAI / Anthropic message content (a string or blocks)."""
    if isinstance(content, str):
        return content
    return "".join(b.get("text", "") for b in content if isinstance(b, dict) and b.get("type") == "text")


def parse_answer(filename: str, data: bytes) -> str:
    """The parse endpoint's text for a file: its name, size and digest; ""
    for a PDF without a text layer (a scan), as a parser without OCR
    answers, so the client's deep rung OCRs it."""
    if data[:5] == b"%PDF-" and not any(t.strip() for t in extract_pages_text(data)):
        return ""
    return f"remote parse of {filename}: {len(data)} bytes, sha256 {hashlib.sha256(data).hexdigest()}"


def ocr_answer(pixels: np.ndarray, tables: bool) -> Dict[str, Any]:
    """The OCR endpoint's answer for a decoded page: its size and the
    digest of its pixels in words; one markdown table with `tables`."""
    h, w = pixels.shape[:2]
    digest = hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()
    out: Dict[str, Any] = {"text": f"scanned page of {w} by {h} pixels, digest {digest[:16]}"}
    if tables:
        out["tables"] = [f"| page | digest |\n|---|---|\n| {w}x{h} | {digest[16:24]} |"]
    return out


def _multipart(body: bytes, content_type: str) -> Dict[str, Any]:
    """A parse request's multipart body -> its file part and fields."""
    boundary = re.search(r"boundary=([^;]+)", content_type).group(1).encode()
    out: Dict[str, Any] = {"fields": {}}
    for part in body.split(b"--" + boundary)[1:-1]:
        head, _, data = part[2:].partition(b"\r\n\r\n")
        data = data[:-2]  # the CRLF before the next boundary
        name = re.search(rb'name="([^"]*)"', head).group(1).decode()
        file_m = re.search(rb'filename="([^"]*)"', head)
        if file_m:
            out.update(filename=file_m.group(1).decode(), file_bytes=len(data),
                       file_sha256=hashlib.sha256(data).hexdigest(), file=data)
        else:
            out["fields"][name] = data.decode()
    return out


def answer_for(body: Dict[str, Any]) -> str:
    """The answer to a chat request of any of the three wire formats."""
    messages = body.get("messages") or []
    system = str(body.get("system") or "") + "".join(
        _text_of(m.get("content", "")) for m in messages if m.get("role") == "system")
    prompt = _text_of(messages[-1].get("content", "")) if messages else ""
    if "Respond ONLY with JSON matching this schema:" in system:
        schema = json.loads(system.split("schema:\n", 1)[1])
        return json.dumps({k: f"{k} from the fake provider" for k in (schema.get("properties") or {})})
    if TRANSCRIBE_PROMPT in prompt:
        return TRANSCRIPTION
    return ANSWER


class FakeProviders:
    """The fake providers' server; `url` is its base, `requests` what it got."""

    def __init__(self, embed_dim: int = 768, line_end: str = "\n"):
        self.embedder = HashingEmbeddingModel(dim=embed_dim)
        self.line_end = line_end
        self.requests: List[Dict[str, Any]] = []
        self.lingered: List[bool] = []
        self._lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.github: Dict[str, Dict[str, bytes]] = {}        # "owner/repo" -> path -> bytes
        self.drive: Dict[str, Dict[str, Any]] = {}           # file id -> its metadata and "data"
        self.zotero: Dict[str, List[Dict[str, Any]]] = {}    # library id -> items (with "file", "parent")
        self.google_tokens: Dict[str, str] = {}              # token -> "access" | "refresh"

    # ------------------------------------------------ connector content

    def add_github_file(self, repo: str, path: str, data: bytes) -> None:
        self.github.setdefault(repo, {})[path] = data

    def add_drive_file(self, file_id: str, name: str, mime: str, data: bytes = b"", parent: str = "root",
                       modified: str = "2026-01-02T03:04:05.000Z") -> None:
        self.drive[file_id] = {"id": file_id, "name": name, "mimeType": mime, "parent": parent,
                               "modifiedTime": modified, "data": data}

    def add_zotero_item(self, library: str, key: str, data: Dict[str, Any], file: Optional[bytes] = None,
                        parent: Optional[str] = None) -> None:
        self.zotero.setdefault(library, []).append({"key": key, "data": dict(data, key=key), "file": file,
                                                    "parent": parent})

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def start(self) -> "FakeProviders":
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def do_GET(self):
                with fake._lock:
                    fake.requests.append({"path": self.path, "body": None,
                                          "headers": {k.lower(): v for k, v in self.headers.items()}})
                fake._connector_get(self)

            def do_POST(self):
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                path = self.path.split("?", 1)[0]
                if path == "/google/token":
                    body = dict(urllib.parse.parse_qsl(raw.decode()))
                    with fake._lock:
                        fake.requests.append({"path": self.path, "body": body,
                                              "headers": {k.lower(): v for k, v in self.headers.items()}})
                    return fake._google_token(self, body)
                if path == "/parse":
                    form = _multipart(raw, self.headers.get("Content-Type", ""))
                    body = {k: v for k, v in form.items() if k != "file"}
                    body["raw"] = raw
                    answer = {"text": parse_answer(form["filename"], form["file"])}
                elif path == "/ocr":
                    pixels = decode_image(raw)
                    body = {"shape": list(pixels.shape),
                            "pixels_sha256": hashlib.sha256(pixels.tobytes()).hexdigest()}
                    answer = ocr_answer(pixels, "tables=true" in self.path)
                else:
                    body, answer = json.loads(raw), None
                with fake._lock:
                    fake.requests.append({"path": self.path, "body": body,
                                          "headers": {k.lower(): v for k, v in self.headers.items()}})
                if answer is not None:
                    return fake._json(self, answer)
                fake._answer(self, body)

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever, name="fake-providers", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread.join(timeout=30)
            self._server = None

    def __enter__(self) -> "FakeProviders":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def last(self, path_prefix: str) -> Dict[str, Any]:
        """The last recorded request to a path starting with `path_prefix`."""
        with self._lock:
            return [r for r in self.requests if r["path"].startswith(path_prefix)][-1]

    # ------------------------------------------------- connector answers

    def _connector_get(self, h: BaseHTTPRequestHandler) -> None:
        url = urllib.parse.urlsplit(h.path)
        query = dict(urllib.parse.parse_qsl(url.query))
        parts = url.path.split("/")[1:]
        m = re.search(r"status-(\d{3})", url.path)
        if m:
            return self._json(h, {"message": f"fake {m.group(0)}"}, int(m.group(1)))
        if parts[0] == "github":
            if h.headers.get("Authorization") != f"Bearer {GITHUB_TOKEN}":
                return self._json(h, {"message": "Bad credentials"}, 401)
            return self._github(h, parts[1:], query)
        if parts[0] == "google":
            token = (h.headers.get("Authorization") or "").removeprefix("Bearer ")
            if self.google_tokens.get(token) != "access":
                return self._json(h, {"error": {"code": 401, "message": "Invalid Credentials"}}, 401)
            return self._drive(h, parts[3:], query)
        if parts[0] == "zotero":
            if h.headers.get("Zotero-API-Key") != ZOTERO_KEY:
                return self._json(h, {"message": "Forbidden"}, 403)
            return self._zotero(h, parts[1:], query)
        return self._json(h, {"error": "not found"}, 404)

    def _github(self, h: BaseHTTPRequestHandler, parts: List[str], query: Dict[str, str]) -> None:
        if parts[0] == "raw":  # a download_url
            files = self.github.get("/".join(parts[1:3]), {})
            path = "/".join(parts[3:])
            return self._bytes(h, files[path]) if path in files else self._json(h, {"message": "Not Found"}, 404)
        repo, files = "/".join(parts[1:3]), self.github.get("/".join(parts[1:3]))
        if files is None:
            return self._json(h, {"message": "Not Found"}, 404)
        if parts[3] == "git":  # git/trees/{branch}
            dirs = sorted({"/".join(p.split("/")[:i]) for p in files for i in range(1, p.count("/") + 1)})
            tree = [{"path": d, "type": "tree"} for d in dirs]
            tree += [{"path": p, "type": "blob", "size": len(d)} for p, d in sorted(files.items())]
            return self._json(h, {"sha": "HEAD", "tree": sorted(tree, key=lambda e: e["path"]), "truncated": False})
        path = "/".join(parts[4:]).strip("/")

        def entry(p: str, is_dir: bool) -> Dict[str, Any]:
            e = {"name": p.rsplit("/", 1)[-1], "path": p, "type": "dir" if is_dir else "file",
                 "size": 0 if is_dir else len(files[p])}
            if not is_dir:
                e["download_url"] = f"{self.url}/github/raw/{repo}/{p}"
            return e

        if path in files:
            e = entry(path, False)
            data = files[path]
            if len(data) <= GITHUB_INLINE_MAX:
                e.update(encoding="base64", content=base64.encodebytes(data).decode())
            else:
                e.update(encoding="none", content="")
            return self._json(h, e)
        prefix = path + "/" if path else ""
        children = {p[len(prefix):].split("/", 1)[0]: "/" in p[len(prefix):] for p in files if p.startswith(prefix)}
        if not children:
            return self._json(h, {"message": "Not Found"}, 404)
        listing = [entry(prefix + n, is_dir) for n, is_dir in sorted(children.items())]
        per_page, page = int(query.get("per_page", 30)), int(query.get("page", 1))
        return self._json(h, listing[(page - 1) * per_page : page * per_page])

    def _google_token(self, h: BaseHTTPRequestHandler, form: Dict[str, str]) -> None:
        grant, code = form.get("grant_type"), form.get("code", "")
        if grant == "authorization_code" and (code == GOOGLE_CODE or code.startswith("expired")):
            expires_in = -60 if code.startswith("expired") else 3600
        elif grant == "refresh_token" and self.google_tokens.get(form.get("refresh_token", "")) == "refresh":
            expires_in = 3600
        else:
            return self._json(h, {"error": "invalid_grant"}, 400)
        # tokens are a function of the grant, so two clients given the same
        # grants hold the same tokens
        seed = hashlib.sha256(json.dumps(form, sort_keys=True).encode()).hexdigest()
        access, refresh = f"ya29.fake-{seed[:16]}", f"1//fake-refresh-{seed[16:32]}"
        with self._lock:
            self.google_tokens[access] = "access"
            self.google_tokens[refresh] = "refresh"
        answer = {"access_token": access, "expires_in": expires_in, "token_type": "Bearer"}
        if grant == "authorization_code":
            answer["refresh_token"] = refresh
        return self._json(h, answer)

    def _drive(self, h: BaseHTTPRequestHandler, parts: List[str], query: Dict[str, str]) -> None:
        def meta(f: Dict[str, Any]) -> Dict[str, Any]:
            out = {k: f[k] for k in ("id", "name", "mimeType", "modifiedTime")}
            if f["mimeType"] != DRIVE_FOLDER:
                out["size"] = str(len(f["data"]))
            return out

        if len(parts) == 1:  # files?q='parent' in parents ...
            parent = re.match(r"'([^']*)' in parents", query.get("q", "")).group(1)
            listing = sorted((f for f in self.drive.values() if f["parent"] == parent), key=lambda f: f["name"])
            size, start = int(query.get("pageSize", 100)), int(query.get("pageToken", 0))
            out: Dict[str, Any] = {"files": [meta(f) for f in listing[start : start + size]]}
            if start + size < len(listing):
                out["nextPageToken"] = str(start + size)
            return self._json(h, out)
        f = self.drive.get(parts[1])
        if f is None:
            return self._json(h, {"error": {"code": 404, "message": "File not found"}}, 404)
        if len(parts) == 3 and parts[2] == "export":
            return self._bytes(h, f["data"])
        return self._bytes(h, f["data"]) if query.get("alt") == "media" else self._json(h, meta(f))

    def _zotero(self, h: BaseHTTPRequestHandler, parts: List[str], query: Dict[str, str]) -> None:
        items = self.zotero.get(parts[1])
        if items is None:
            return self._json(h, {"message": "Not Found"}, 404)

        def item(i: Dict[str, Any]) -> Dict[str, Any]:
            return {"key": i["key"], "version": 1, "data": i["data"]}

        start, limit = int(query.get("start", 0)), int(query.get("limit", 25))
        if parts[3] == "top":
            return self._json(h, [item(i) for i in items if i["parent"] is None][start : start + limit])
        found = [i for i in items if i["key"] == parts[3]]
        if not found:
            return self._json(h, {"message": "Not Found"}, 404)
        if len(parts) == 4:
            return self._json(h, item(found[0]))
        if parts[4] == "children":
            return self._json(h, [item(i) for i in items if i["parent"] == parts[3]][start : start + limit])
        if found[0]["file"] is None:
            return self._json(h, {"message": "Not Found"}, 404)
        return self._bytes(h, found[0]["file"])

    @staticmethod
    def _bytes(h: BaseHTTPRequestHandler, data: bytes) -> None:
        h.send_response(200)
        h.send_header("Content-Type", "application/octet-stream")
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)

    # ------------------------------------------------------------ answers

    def _answer(self, h: BaseHTTPRequestHandler, body: Dict[str, Any]) -> None:
        model = str(body.get("model", ""))
        if model.startswith("status-"):
            return self._json(h, {"error": {"message": f"fake {model}"}}, int(model[7:]))
        if model.startswith("slow-"):
            time.sleep(float(model[5:]))
        path = h.path.split("?", 1)[0]
        if path.endswith("/embeddings"):
            inputs = body["input"] if isinstance(body["input"], list) else [body["input"]]
            return self._json(h, {"object": "list", "model": model, "data": [
                {"object": "embedding", "index": i, "embedding": self._vector(t)} for i, t in enumerate(inputs)]})
        if path == "/api/embed":
            return self._json(h, {"model": model, "embeddings": [self._vector(t) for t in body["input"]]})
        text = ANSWER if model == "no-json" else answer_for(body)
        stream = bool(body.get("stream"))
        if path.endswith("/chat/completions"):
            if not stream:
                return self._json(h, {"id": "chatcmpl-fake", "model": model, "choices": [{
                    "index": 0, "message": {"role": "assistant", "content": text}, "finish_reason": "stop"}],
                    "usage": {"prompt_tokens": 11, "completion_tokens": 7, "total_tokens": 18}})
            lines = [f"data: {json.dumps({'choices': [{'index': 0, 'delta': {'content': p}}]})}"
                     for p in _pieces(text)]
            return self._stream(h, "text/event-stream", [x for ln in lines for x in (ln, "")], ["data: [DONE]", ""],
                                model, lines[-1])
        if path == "/api/chat":
            if not stream:
                return self._json(h, {"model": model, "message": {"role": "assistant", "content": text},
                                      "done": True, "done_reason": "stop", "prompt_eval_count": 13, "eval_count": 5})
            lines = [json.dumps({"model": model, "message": {"role": "assistant", "content": p}, "done": False})
                     for p in _pieces(text)]
            return self._stream(h, "application/x-ndjson", lines, [json.dumps({"model": model, "done": True})],
                                model, lines[-1])
        if path == "/v1/messages":
            if not stream:
                return self._json(h, {"id": "msg_fake", "type": "message", "model": model,
                                      "content": [{"type": "text", "text": text}], "stop_reason": "end_turn",
                                      "usage": {"input_tokens": 17, "output_tokens": 9}})
            events = [{"type": "message_start"}, {"type": "content_block_start", "index": 0}]
            events += [{"type": "content_block_delta", "index": 0, "delta": {"type": "text_delta", "text": p}}
                       for p in _pieces(text)]
            lines = [x for e in events for x in (f"event: {e['type']}", f"data: {json.dumps(e)}", "")]
            end = [{"type": "content_block_stop", "index": 0}, {"type": "message_stop"}]
            return self._stream(h, "text/event-stream", lines, [
                x for e in end for x in (f"event: {e['type']}", f"data: {json.dumps(e)}", "")], model, lines[-2])
        return self._json(h, {"error": "not found"}, 404)

    def _vector(self, text: str) -> List[float]:
        return self.embedder._embed(text).tolist()

    @staticmethod
    def _json(h: BaseHTTPRequestHandler, data: Any, status: int = 200) -> None:
        raw = json.dumps(data).encode()
        h.send_response(status)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(raw)))
        h.end_headers()
        h.wfile.write(raw)

    def _stream(self, h: BaseHTTPRequestHandler, ctype: str, body: List[str], end: List[str], model: str,
                filler: str = ": keep-alive") -> None:
        """Write the `body` lines, then the `end` lines; `drip` repeats
        `filler` (the last delta) before the end, `linger` writes comment
        lines after it."""
        h.send_response(200)
        h.send_header("Content-Type", ctype)
        h.end_headers()  # HTTP/1.0: the body ends when the connection closes
        if model == "drip":
            # a client that leaves after the first delta may do so while the
            # body is still being written
            if self._hold(h, filler, lead=body):
                return
        else:
            self._write(h, body)
        self._write(h, end)
        if model == "linger":
            self._hold(h, ": keep-alive")

    def _write(self, h: BaseHTTPRequestHandler, lines: List[str]) -> None:
        for line in lines:
            h.wfile.write((line + self.line_end).encode())
            h.wfile.flush()

    def _hold(self, h: BaseHTTPRequestHandler, line: str, lead: Sequence[str] = ()) -> bool:
        """Write the `lead` lines, then `line` every 20 ms for HOLD_S or
        until the client closes; -> whether it closed."""
        closed, deadline = False, time.monotonic() + HOLD_S
        try:
            self._write(h, lead)
            while time.monotonic() < deadline:
                self._write(h, [line])
                time.sleep(0.02)
        except (BrokenPipeError, ConnectionResetError):
            closed = True
        with self._lock:
            self.lingered.append(closed)
        return closed
