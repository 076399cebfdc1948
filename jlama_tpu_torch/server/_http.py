"""A minimal HTTP/1.1 server on `asyncio` streams, enough for the
OpenAI-compatible API (the JAX package serves it with aiohttp).

It reads the request line and headers, a body of `Content-Length` bytes (to
its end, across packets; `Expect: 100-continue` is answered), keeps the
connection alive unless the client asks to close it (HTTP/1.0 closes unless
asked to keep it), and writes responses with a `Content-Length`, or a stream
of server-sent events with `Transfer-Encoding: chunked`, as aiohttp writes a
`StreamResponse`. A path without a route gets 404, a method the route does
not take 405, a request it cannot parse 400; chunked request bodies are not
taken (411), nor bodies over aiohttp's default limit of 1 MiB (413).
"""

from __future__ import annotations

import asyncio
import json
import traceback
from dataclasses import dataclass, field
from http import HTTPStatus
from typing import Awaitable, Callable
from urllib.parse import urlsplit

JSON_TYPE = "application/json; charset=utf-8"
TEXT_TYPE = "text/plain; charset=utf-8"
HTML_TYPE = "text/html; charset=utf-8"
MAX_LINE = 64 * 1024  # request line or one header
MAX_HEADERS = 128
MAX_BODY = 1024 ** 2


class HTTPError(Exception):
    """Raised by a handler (or the parser) to answer with `status`."""

    def __init__(self, status: int, text: str | None = None, content_type: str = TEXT_TYPE):
        super().__init__(status)
        self.status = status
        self.text = f"{status}: {HTTPStatus(status).phrase}" if text is None else text
        self.content_type = content_type


@dataclass
class Response:
    body: bytes
    status: int = 200
    content_type: str = JSON_TYPE
    headers: dict[str, str] = field(default_factory=dict)


def json_response(obj, status: int = 200) -> Response:
    return Response(json.dumps(obj).encode(), status)


class EventStream:
    """A streamed response body: each `write` is one chunk."""

    def __init__(self, writer: asyncio.StreamWriter):
        self._writer = writer
        self.closed = False

    async def write(self, data: bytes) -> None:
        if data:
            self._writer.write(b"%x\r\n%b\r\n" % (len(data), data))
            await self._writer.drain()

    async def close(self) -> None:
        if not self.closed:
            self.closed = True
            self._writer.write(b"0\r\n\r\n")
            await self._writer.drain()


class Request:
    def __init__(self, method: str, target: str, headers: dict[str, str], body: bytes,
                 keep_alive: bool, writer: asyncio.StreamWriter):
        self.method = method
        self.path = urlsplit(target).path
        self.headers = headers  # names in lower case
        self.body = body
        self.keep_alive = keep_alive
        self._writer = writer
        self.stream_response: EventStream | None = None

    def header(self, name: str, default: str | None = None) -> str | None:
        return self.headers.get(name.lower(), default)

    def json(self):
        """The body parsed as JSON; raises ValueError if it is not JSON."""
        return json.loads(self.body)

    async def stream(self, headers: dict[str, str]) -> EventStream:
        """Send a 200 status line and `headers`, and return the chunked body."""
        head = ["HTTP/1.1 200 OK", "Transfer-Encoding: chunked"]
        head += [f"{k}: {v}" for k, v in headers.items()]
        self._writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
        await self._writer.drain()
        self.stream_response = EventStream(self._writer)
        return self.stream_response


Handler = Callable[[Request], Awaitable["Response | EventStream"]]


def _head(status: int, headers: dict[str, str]) -> bytes:
    lines = [f"HTTP/1.1 {status} {HTTPStatus(status).phrase}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class HTTPServer:
    def __init__(self, routes: dict[str, dict[str, Handler]]):
        """routes: path -> {method: handler}."""
        self.routes = routes
        self._server: asyncio.base_events.Server | None = None

    async def start(self, host: str, port: int) -> int:
        """Listen on (host, port); returns the bound port (port 0 picks one)."""
        self._server = await asyncio.start_server(self._connection, host, port, limit=MAX_LINE)
        return self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        await self._server.serve_forever()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            while await self._exchange(reader, writer):
                pass
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass

    async def _read_request(self, reader, writer) -> Request | None:
        try:
            line = await reader.readline()
            if not line:
                return None
            parts = line.decode("latin-1").split()
            if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
                raise HTTPError(400, "400: Bad Request (request line)")
            method, target, version = parts
            headers: dict[str, str] = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n"):
                    break
                if not h or len(headers) >= MAX_HEADERS or b":" not in h:
                    raise HTTPError(400, "400: Bad Request (headers)")
                name, _, value = h.decode("latin-1").partition(":")
                headers[name.strip().lower()] = value.strip()
        except ValueError:  # a line over MAX_LINE
            raise HTTPError(400, "400: Bad Request (line too long)") from None
        if "transfer-encoding" in headers:
            raise HTTPError(411, "411: chunked request bodies are not supported")
        try:
            n = int(headers.get("content-length", "0"))
        except ValueError:
            raise HTTPError(400, "400: Bad Request (Content-Length)") from None
        if n < 0:
            raise HTTPError(400, "400: Bad Request (Content-Length)")
        if n > MAX_BODY:
            raise HTTPError(413)
        if n and headers.get("expect", "").lower() == "100-continue":
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await writer.drain()
        body = await reader.readexactly(n)
        conn = headers.get("connection", "").lower()
        keep = conn != "close" if version == "HTTP/1.1" else conn == "keep-alive"
        return Request(method.upper(), target, headers, body, keep, writer)

    async def _exchange(self, reader, writer) -> bool:
        """Serve one request; False once the connection is to close."""
        try:
            req = await self._read_request(reader, writer)
        except HTTPError as e:
            await self._send(writer, Response(e.text.encode(), e.status, e.content_type), False)
            return False
        if req is None:
            return False
        methods = self.routes.get(req.path)
        try:
            if methods is None:
                raise HTTPError(404)
            if req.method not in methods:
                raise HTTPError(405)
            resp = await methods[req.method](req)
        except HTTPError as e:
            resp = Response(e.text.encode(), e.status, e.content_type)
        except Exception:  # noqa: BLE001 — answer 500, keep serving
            traceback.print_exc()
            if req.stream_response is not None:  # the status line is out: drop the connection
                return False
            resp = Response(b"500 Internal Server Error\n\nServer got itself in trouble", 500,
                            TEXT_TYPE)
        if isinstance(resp, EventStream):
            await resp.close()
            return req.keep_alive
        if methods is not None and req.method not in methods:
            resp.headers.setdefault("Allow", ", ".join(sorted(methods)))
        await self._send(writer, resp, req.keep_alive)
        return req.keep_alive

    async def _send(self, writer, resp: Response, keep_alive: bool) -> None:
        headers = {"Content-Type": resp.content_type, "Content-Length": str(len(resp.body)),
                   "Connection": "keep-alive" if keep_alive else "close", **resp.headers}
        writer.write(_head(resp.status, headers) + resp.body)
        await writer.drain()
