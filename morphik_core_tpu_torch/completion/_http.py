"""The stdlib transport of the port's network providers (completion and
text embedding): the wire calls the reference makes with `httpx`
(`morphik_core_tpu/completion/models.py`, `embedding/text_embedding.py`),
made with `urllib.request`, which the card's machine has. The remote
endpoints (ColPali embedding servers, parse and OCR endpoints), which the
reference calls with urllib, POST their bodies through `post_bytes`.

- `post_json`: one JSON POST -> the decoded JSON answer, as
  `client.post(url, json=..., headers=...)`, `raise_for_status()`,
  `r.json()`.
- `stream_lines`: a JSON POST whose answer is read line by line, as
  `client.stream(...)` + `aiter_lines()`: lines split where
  `str.splitlines` splits them (`\\n`, `\\r\\n`, `\\r`, ...), as httpx's
  line decoder does, decoded with the answer's charset (UTF-8 by default).

The blocking reads run off the event loop (`asyncio.to_thread` for a
POST, one worker thread per stream that hands its lines to the loop
through a queue), so a slow provider does not stall the other requests
of the single-loop server. A stream's connection is shut down as soon as
its consumer stops (a `[DONE]` line, a `message_stop` event, a client
that leaves an SSE `/query`). A 4xx or 5xx answer raises `HTTPStatusError`
with the status. Proxies come from the environment, as urllib's default
opener (and httpx's `trust_env=True`) takes them.
"""

from __future__ import annotations

import asyncio
import codecs
import json
import socket
import threading
import urllib.error
import urllib.request
from typing import Any, AsyncIterator, Dict, List

_END = object()
_READ_BYTES = 64 * 1024
_NEWLINES = "\n\r\x0b\x0c\x1c\x1d\x1e\x85\u2028\u2029"  # where str.splitlines splits


class _LineDecoder:
    """Incremental `str.splitlines`: text arrives in pieces, complete lines
    come out; a `\r` at a piece's end waits for a possible `\n`."""

    def __init__(self) -> None:
        self.buffer = ""
        self.trailing_cr = False

    def decode(self, text: str) -> List[str]:
        if self.trailing_cr:
            text, self.trailing_cr = "\r" + text, False
        if text.endswith("\r"):
            text, self.trailing_cr = text[:-1], True
        if not text:
            return []
        lines = (self.buffer + text).splitlines()
        self.buffer = "" if text[-1] in _NEWLINES else lines.pop()
        return lines

    def flush(self) -> List[str]:
        if not self.buffer and not self.trailing_cr:
            return []
        line, self.buffer, self.trailing_cr = self.buffer, "", False
        return [line]


class HTTPStatusError(RuntimeError):
    """A provider answered 4xx or 5xx (`raise_for_status` in the reference)."""

    def __init__(self, status: int, url: str, body: bytes = b""):
        self.status = status
        detail = body[:500].decode("utf-8", errors="replace")
        super().__init__(f"HTTP {status} from {url}: {detail}")


def _open_raw(url: str, data: bytes, headers: Dict[str, str], timeout: float):
    """urlopen of a POST of `data`; an error status raises HTTPStatusError."""
    req = urllib.request.Request(url, data=data, headers=headers, method="POST")
    try:
        return urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        with e:
            body = e.read()
        raise HTTPStatusError(e.code, url, body) from None


def _open(url: str, payload: Any, headers: Dict[str, str], timeout: float):
    """urlopen of a JSON POST; an error status raises HTTPStatusError."""
    return _open_raw(url, json.dumps(payload).encode(), {"Content-Type": "application/json", **headers}, timeout)


def post_bytes(url: str, data: bytes, headers: Dict[str, str], timeout: float) -> bytes:
    """Blocking: POST `data` (its content type in `headers`) -> the
    answer's bytes. The remote endpoints' clients run it in worker threads."""
    with _open_raw(url, data, headers, timeout) as resp:
        return resp.read()


def _post_json_blocking(url: str, payload: Any, headers: Dict[str, str], timeout: float) -> Any:
    with _open(url, payload, headers, timeout) as resp:
        return json.loads(resp.read())


async def post_json(url: str, payload: Any, headers: Dict[str, str], timeout: float) -> Any:
    """POST `payload` as JSON -> the decoded JSON answer."""
    return await asyncio.to_thread(_post_json_blocking, url, payload, headers, timeout)


def _shutdown(resp) -> None:
    """Shut the answer's connection down, waking a read blocked on it."""
    try:
        with socket.socket(fileno=socket.dup(resp.fileno())) as sock:
            sock.shutdown(socket.SHUT_RDWR)
    except (OSError, ValueError, AttributeError):  # already closed by the worker
        pass


async def stream_lines(url: str, payload: Any, headers: Dict[str, str], timeout: float) -> AsyncIterator[str]:
    """POST `payload` as JSON and yield the answer's lines (without their
    line ends) as they arrive."""
    loop = asyncio.get_running_loop()
    queue: asyncio.Queue = asyncio.Queue()
    stop = threading.Event()
    opened: Dict[str, Any] = {}

    def post(item) -> None:
        try:
            loop.call_soon_threadsafe(queue.put_nowait, item)
        except RuntimeError:  # the loop has closed: nobody is reading
            pass

    def pump() -> None:
        try:
            with _open(url, payload, headers, timeout) as resp:
                opened["resp"] = resp
                text = codecs.getincrementaldecoder(resp.headers.get_content_charset() or "utf-8")(errors="replace")
                lines = _LineDecoder()
                while not stop.is_set():
                    raw = resp.read1(_READ_BYTES)  # what has arrived, as soon as it has
                    for line in lines.decode(text.decode(raw, final=not raw)):
                        post(line)
                    if not raw:
                        break
                for line in lines.flush():
                    post(line)
            post(_END)
        except Exception as e:  # noqa: BLE001 — handed to the consumer, which raises it
            post(e if not stop.is_set() else _END)

    worker = threading.Thread(target=pump, name="provider-stream", daemon=True)
    worker.start()
    try:
        while True:
            item = await queue.get()
            if item is _END:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        resp = opened.get("resp")
        if resp is not None:
            _shutdown(resp)
