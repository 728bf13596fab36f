"""A local stand-in for the completion and embedding providers and the
remote parse and OCR endpoints, to drive `/query`, `output_format="text"`,
the on-the-fly query, routed text embeddings, `parser_mode="api"` and
`ocr_mode="api"` with no network: one `ThreadingHTTPServer` on 127.0.0.1
that speaks

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
    carries `tables=true`.

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
writing comment lines for 5 s after a stream's last event, and `drip`
keeps repeating its last delta for 5 s before that event; both record
in `lingered` whether the client closed the connection within the 5 s.
`line_end` sets the streams' line ends.
"""

from __future__ import annotations

import hashlib
import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from morphik_core_tpu_torch.embedding.text_embedding import HashingEmbeddingModel
from morphik_core_tpu_torch.parser.pdf import extract_pages_text
from morphik_core_tpu_torch.utils.image import decode_image

ANSWER = "The fake provider read the retrieved pages and answers: revenue grew 12% in Q3."
TRANSCRIPTION = "# Transcribed page\n\n| quarter | revenue |\n|---|---|\n| Q3 | 12% |"
TRANSCRIBE_PROMPT = "Transcribe this page to markdown"
STREAM_PIECES = 5
LINGER_S = 5.0


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

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def start(self) -> "FakeProviders":
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def do_POST(self):
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                path = self.path.split("?", 1)[0]
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
        self._write(h, body)
        if model == "drip" and self._hold(h, filler):
            return
        self._write(h, end)
        if model == "linger":
            self._hold(h, ": keep-alive")

    def _write(self, h: BaseHTTPRequestHandler, lines: List[str]) -> None:
        for line in lines:
            h.wfile.write((line + self.line_end).encode())
            h.wfile.flush()

    def _hold(self, h: BaseHTTPRequestHandler, line: str) -> bool:
        """Write `line` every 20 ms for LINGER_S or until the client
        closes; -> whether it closed."""
        closed, deadline = False, time.monotonic() + LINGER_S
        while time.monotonic() < deadline:
            try:
                self._write(h, [line])
            except (BrokenPipeError, ConnectionResetError):
                closed = True
                break
            time.sleep(0.02)
        with self._lock:
            self.lingered.append(closed)
        return closed
