"""Minimal asyncio HTTP/1.1 framework: copy of `morphik_core_tpu/api/http.py`
(no FastAPI/uvicorn — the reference's FastAPI surface is re-exposed on
a stdlib-native server).

Features used by the API: path-parameter routing, JSON bodies,
query strings, multipart/form-data (file upload), SSE streaming
responses, keep-alive. One addition to the reference: a handler that
raises `NotImplementedError` (a part of the service plane the port does
not serve yet) answers 501 with the message."""

from __future__ import annotations

import asyncio
import json
import logging
import re
import traceback
import urllib.parse
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Awaitable, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

MAX_BODY = 512 * 1024 * 1024  # 512 MiB uploads


@dataclass
class UploadFile:
    filename: str
    content_type: str
    data: bytes


@dataclass
class Request:
    method: str
    path: str
    query: Dict[str, Any]
    headers: Dict[str, str]
    body: bytes
    path_params: Dict[str, str] = field(default_factory=dict)

    def json(self) -> Any:
        if not self.body:
            return {}
        return json.loads(self.body)

    @property
    def content_type(self) -> str:
        return self.headers.get("content-type", "")

    def form(self) -> Tuple[Dict[str, str], Dict[str, List[UploadFile]]]:
        """Parse multipart/form-data or urlencoded bodies.
        Returns (fields, files)."""
        ctype = self.content_type
        if ctype.startswith("application/x-www-form-urlencoded"):
            fields = {k: v[0] for k, v in urllib.parse.parse_qs(self.body.decode()).items()}
            return fields, {}
        m = re.search(r"boundary=([^;]+)", ctype)
        if not m:
            raise HTTPError(400, "missing multipart boundary")
        boundary = m.group(1).strip('"').encode()
        fields: Dict[str, str] = {}
        files: Dict[str, List[UploadFile]] = {}
        for part in self.body.split(b"--" + boundary):
            # exactly ONE leading and ONE trailing CRLF belong to the
            # multipart framing — .strip(b"\r\n") would also eat newline
            # bytes that are part of the uploaded content
            if part.startswith(b"\r\n"):
                part = part[2:]
            if part.endswith(b"\r\n"):
                part = part[:-2]
            if not part or part == b"--":
                continue
            if b"\r\n\r\n" not in part:
                continue
            head_raw, content = part.split(b"\r\n\r\n", 1)
            headers = {}
            for line in head_raw.split(b"\r\n"):
                if b":" in line:
                    k, v = line.split(b":", 1)
                    headers[k.decode().strip().lower()] = v.decode().strip()
            disp = headers.get("content-disposition", "")
            name_m = re.search(r'name="([^"]*)"', disp)
            if not name_m:
                continue
            name = name_m.group(1)
            file_m = re.search(r'filename="([^"]*)"', disp)
            if file_m:
                files.setdefault(name, []).append(
                    UploadFile(
                        filename=file_m.group(1),
                        content_type=headers.get("content-type", "application/octet-stream"),
                        data=content,
                    )
                )
            else:
                fields[name] = content.decode("utf-8", errors="replace")
        return fields, files


class HTTPError(Exception):
    def __init__(self, status: int, detail: str = ""):
        self.status = status
        self.detail = detail
        super().__init__(detail)


@dataclass
class Response:
    status: int = 200
    headers: Dict[str, str] = field(default_factory=dict)
    body: bytes = b""
    stream: Optional[AsyncIterator[bytes]] = None  # chunked/SSE when set

    @staticmethod
    def json(data: Any, status: int = 200) -> "Response":
        body = json.dumps(data, default=str).encode()
        return Response(status=status, headers={"Content-Type": "application/json"}, body=body)

    @staticmethod
    def sse(events: AsyncIterator[str]) -> "Response":
        async def gen() -> AsyncIterator[bytes]:
            try:
                async for e in events:
                    yield e.encode()
            finally:  # a client that leaves closes the events' source too (a provider's stream)
                aclose = getattr(events, "aclose", None)
                if aclose is not None:
                    await aclose()

        return Response(
            status=200,
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "Connection": "keep-alive",
            },
            stream=gen(),
        )

    @staticmethod
    def binary(data: bytes, content_type: str = "application/octet-stream") -> "Response":
        return Response(status=200, headers={"Content-Type": content_type}, body=data)


Handler = Callable[[Request], Awaitable[Response]]

_STATUS_TEXT = {
    200: "OK", 201: "Created", 204: "No Content", 400: "Bad Request",
    401: "Unauthorized", 402: "Payment Required", 403: "Forbidden", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    415: "Unsupported Media Type", 422: "Unprocessable Entity",
    500: "Internal Server Error", 501: "Not Implemented",
}


class Router:
    def __init__(self):
        self.routes: List[Tuple[str, re.Pattern, List[str], Handler]] = []
        self.middleware: List[Callable[[Request], Awaitable[Optional[Response]]]] = []
        # Around-middleware: async (req, call_next) -> Response, outermost first
        # (reference middleware/profiling.py wraps the whole request).
        self.wrappers: List[Callable[..., Awaitable[Response]]] = []

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        names = re.findall(r"\{(\w+)\}", pattern)
        regex = re.compile("^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$")
        self.routes.append((method.upper(), regex, names, handler))

    def route(self, method: str, pattern: str):
        def deco(fn: Handler) -> Handler:
            self.add(method, pattern, fn)
            return fn

        return deco

    def get(self, p):  # noqa: D102
        return self.route("GET", p)

    def post(self, p):  # noqa: D102
        return self.route("POST", p)

    def delete(self, p):  # noqa: D102
        return self.route("DELETE", p)

    def patch(self, p):  # noqa: D102
        return self.route("PATCH", p)

    def put(self, p):  # noqa: D102
        return self.route("PUT", p)

    async def dispatch(self, req: Request) -> Response:
        call = self._dispatch_inner
        for w in reversed(self.wrappers):
            call = (lambda wr, nxt: lambda r: wr(r, nxt))(w, call)
        return await call(req)

    async def _dispatch_inner(self, req: Request) -> Response:
        for mw in self.middleware:
            early = await mw(req)
            if early is not None:
                return early
        path_matched = False
        for method, regex, names, handler in self.routes:
            m = regex.match(req.path)
            if m:
                path_matched = True
                if method != req.method:
                    continue
                req.path_params = m.groupdict()
                try:
                    return await handler(req)
                except HTTPError as e:
                    return Response.json({"detail": e.detail}, status=e.status)
                except NotImplementedError as e:
                    # a route, option or setting the port does not serve yet
                    return Response.json({"detail": str(e)}, status=501)
                except PermissionError as e:
                    # service/DB layers raise this for tenant violations
                    # (e.g. store_document id takeover) — a 403, not a 500
                    return Response.json({"detail": str(e)}, status=403)
                except json.JSONDecodeError as e:
                    return Response.json({"detail": f"invalid JSON: {e}"}, status=400)
                except Exception as e:  # noqa: BLE001
                    logger.error("handler error on %s %s:\n%s", req.method, req.path, traceback.format_exc())
                    return Response.json({"detail": str(e)}, status=500)
        if path_matched:
            return Response.json({"detail": "method not allowed"}, status=405)
        return Response.json({"detail": "not found"}, status=404)


class HTTPServer:
    def __init__(self, router: Router, host: str = "0.0.0.0", port: int = 8000):
        self.router = router
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn_tasks: "set[asyncio.Task]" = set()
        self._busy: "set[asyncio.Task]" = set()  # handlers mid-request

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        if self.port == 0 and self._server.sockets:
            self.port = self._server.sockets[0].getsockname()[1]
        logger.info("listening on %s:%d", self.host, self.port)

    async def stop(self, grace_s: float = 10.0) -> None:
        """Drain: stop accepting, let handlers that are MID-REQUEST
        finish (up to `grace_s`), then cancel and AWAIT everything left.
        Idle keep-alive handlers park in _read_request indefinitely, so
        they are cancelled immediately — without awaiting them their
        tasks outlive the server and surface as 'Task was destroyed but
        it is pending' at loop GC. This is the same path a SIGTERM drain
        takes (api/server.py)."""
        if self._server:
            self._server.close()
        # idle connections (waiting for the next request) cancel now;
        # busy ones (dispatching a request / writing a response) get the
        # grace window — aborting a mid-flight /ingest or /query during
        # a drain would reset clients that used to complete
        for t in list(self._conn_tasks - self._busy):
            t.cancel()
        if self._busy:
            done, pending = await asyncio.wait(set(self._busy), timeout=grace_s)
            for t in pending:
                logger.warning("request still in flight after %.0fs drain; cancelling", grace_s)
                t.cancel()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        self._conn_tasks.clear()
        self._busy.clear()
        # cancellations precede wait_closed(): since 3.12 it also waits
        # for connection handlers
        if self._server:
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def _read_request(self, reader: asyncio.StreamReader) -> Optional[Request]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            return None
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, _ = lines[0].split(" ", 2)
        except ValueError:
            return None
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", "0") or 0)
        if length > MAX_BODY:
            return Request(method, "/__too_large__", {}, headers, b"")
        body = await reader.readexactly(length) if length else b""
        parsed = urllib.parse.urlsplit(target)
        query = {k: (v[0] if len(v) == 1 else v) for k, v in urllib.parse.parse_qs(parsed.query).items()}
        # percent-decode the path so routes match resources whose names
        # contain spaces/unicode (clients always %-encode those)
        path = urllib.parse.unquote(parsed.path)
        return Request(method.upper(), path, query, headers, body)

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
            task.add_done_callback(self._conn_tasks.discard)
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                if req.path == "/__too_large__":
                    # the oversized body was never read off the socket:
                    # answer 413 and CLOSE, or the keep-alive loop would
                    # parse the pending body bytes as the next request
                    resp = Response.json({"detail": "payload too large"}, status=413)
                    resp.headers["Connection"] = "close"
                    await self._write_response(writer, resp)
                    break
                if task is not None:
                    self._busy.add(task)
                try:
                    resp = await self.router.dispatch(req)
                    await self._write_response(writer, resp)
                finally:
                    if task is not None:
                        self._busy.discard(task)
                if req.headers.get("connection", "").lower() == "close" or resp.stream is not None:
                    break
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    async def _write_response(self, writer: asyncio.StreamWriter, resp: Response) -> None:
        status_line = f"HTTP/1.1 {resp.status} {_STATUS_TEXT.get(resp.status, '')}\r\n"
        headers = dict(resp.headers)
        if resp.stream is None:
            headers.setdefault("Content-Length", str(len(resp.body)))
            head = status_line + "".join(f"{k}: {v}\r\n" for k, v in headers.items()) + "\r\n"
            writer.write(head.encode() + resp.body)
            await writer.drain()
        else:
            headers.setdefault("Transfer-Encoding", "chunked")
            head = status_line + "".join(f"{k}: {v}\r\n" for k, v in headers.items()) + "\r\n"
            writer.write(head.encode())
            await writer.drain()
            try:
                async for chunk in resp.stream:
                    writer.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                    await writer.drain()
                writer.write(b"0\r\n\r\n")
                await writer.drain()
            finally:
                # a client disconnect mid-stream abandons the generator;
                # without an explicit aclose, GC schedules athrow on a
                # possibly-dead loop ("Task was destroyed" at exit)
                aclose = getattr(resp.stream, "aclose", None)
                if aclose is not None:
                    try:
                        await aclose()
                    except Exception:  # noqa: BLE001
                        pass
