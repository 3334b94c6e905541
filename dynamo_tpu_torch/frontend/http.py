"""A small HTTP/1.1 server over ``asyncio.start_server`` — where the JAX
frontend stands on ``aiohttp.web``, which the card's machine lacks.

What the OpenAI surface needs of it, with aiohttp's behaviour where a
client can see it:

* routing by method and path (404 for an unknown path, 405 with ``Allow``
  for a known path and another method); ``add_get`` also routes HEAD to
  the GET handler, whose answer goes out with its head only (its
  ``Content-Length`` kept, no body), as aiohttp's ``allow_head=True`` does;
  no answer to a HEAD request carries a body;
* keep-alive (HTTP/1.1 by default, ``Connection: close`` or HTTP/1.0 end
  it; an idle connection closes after ``KEEPALIVE_TIMEOUT`` seconds);
* request bodies by ``Content-Length`` or ``Transfer-Encoding: chunked``,
  with ``Expect: 100-continue`` answered, up to ``CLIENT_MAX_SIZE`` bytes
  (1 MiB, aiohttp's default: a larger body is read past and makes
  ``read()`` / ``json()`` raise a 413 ``HTTPException``);
* ``Response`` (a whole body; text bodies carry ``charset=utf-8``),
  ``json_response`` and ``StreamResponse`` (``prepare`` sends the head,
  each ``write`` one chunk of ``Transfer-Encoding: chunked``, the end is
  written when the handler returns; a handler that raises after
  ``prepare`` leaves the stream cut where it was: the connection closes
  with no further bytes, no terminating chunk and no 500, as aiohttp
  does);
* TLS through an ``ssl.SSLContext``.

Disconnects: on asyncio streams a peer's FIN leaves the transport
half-open, so ``transport.is_closing()`` stays False after the client has
gone. ``Request.transport`` is a handle whose ``is_closing()`` also reads
the reader's EOF, so a streaming handler that polls it between deltas (as
``HttpService`` does) stops decoding for a client that left.
"""

from __future__ import annotations

import asyncio
import email.utils
import json
import ssl
from typing import Any, Awaitable, Callable, Mapping
from urllib.parse import parse_qsl, urlsplit

from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("frontend.http")

_REASONS = {
    100: "Continue", 200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout", 413: "Request Entity Too Large",
    429: "Too Many Requests", 431: "Request Header Fields Too Large",
    499: "Client Closed Request", 500: "Internal Server Error", 501: "Not Implemented",
    502: "Bad Gateway", 503: "Service Unavailable", 504: "Gateway Timeout",
}
_MAX_HEAD = 64 * 1024
#: aiohttp's defaults: the largest request body, idle keep-alive seconds
CLIENT_MAX_SIZE = 1024 ** 2
KEEPALIVE_TIMEOUT = 75.0


def reason(status: int) -> str:
    return _REASONS.get(status, "Unknown")


class Headers(dict):
    """Case-insensitive header map (keys stored lower-cased)."""

    def __init__(self, items: Mapping[str, str] | None = None):
        super().__init__()
        for k, v in (items or {}).items():
            self[k] = v

    def __setitem__(self, key: str, value: str) -> None:
        super().__setitem__(key.lower(), value)

    def __getitem__(self, key: str) -> str:
        return super().__getitem__(key.lower())

    def __contains__(self, key: object) -> bool:
        return isinstance(key, str) and super().__contains__(key.lower())

    def get(self, key: str, default: Any = None) -> Any:
        return super().get(key.lower(), default)


class HTTPException(Exception):
    """Raised by a handler (or the body reader) to answer ``status`` with a
    plain-text body."""

    def __init__(self, status: int, text: str | None = None):
        super().__init__(text or f"{status}: {reason(status)}")
        self.status = status
        self.text = text or f"{status}: {reason(status)}"


class _Transport:
    """What a handler may ask of the connection: is the peer gone?"""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._reader, self._writer = reader, writer

    def is_closing(self) -> bool:
        return self._writer.is_closing() or self._reader.at_eof()


class Request:
    def __init__(self, method: str, target: str, version: str, headers: Headers,
                 body: bytes | None, too_large: int, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, max_size: int):
        self.method = method
        parts = urlsplit(target)
        self.path = parts.path or "/"
        self.query = dict(parse_qsl(parts.query, keep_blank_values=True))
        self.version = version
        self.headers = headers
        self._body = body
        self._too_large = too_large
        self._max_size = max_size
        self._reader, self._writer = reader, writer
        # set when a StreamResponse sent its head on this request
        self._prepared = False
        peer = writer.get_extra_info("peername")
        self.remote = peer[0] if isinstance(peer, tuple) and peer else None
        self.keep_alive = (version == "HTTP/1.1"
                           and headers.get("connection", "").lower() != "close") or (
            version == "HTTP/1.0" and headers.get("connection", "").lower() == "keep-alive")

    @property
    def transport(self) -> _Transport | None:
        if self._writer.is_closing():
            return None
        return _Transport(self._reader, self._writer)

    async def read(self) -> bytes:
        if self._too_large:
            raise HTTPException(413, f"Maximum request body size {self._max_size} exceeded, "
                                     f"actual body size {self._too_large}")
        return self._body or b""

    async def text(self) -> str:
        return (await self.read()).decode("utf-8")

    async def json(self) -> Any:
        return json.loads(await self.text())


class Response:
    """A whole response: ``text``, sent as UTF-8 with its charset named."""

    prepared = False

    def __init__(self, *, status: int = 200, text: str = "",
                 content_type: str = "text/plain",
                 headers: Mapping[str, str] | None = None):
        self.status = status
        self.headers = Headers(headers)
        self.body = text.encode("utf-8")
        self.headers.setdefault("content-type", f"{content_type}; charset=utf-8")


def json_response(data: Any, *, status: int = 200,
                  headers: Mapping[str, str] | None = None) -> Response:
    return Response(status=status, text=json.dumps(data), content_type="application/json",
                    headers=headers)


def _head(version: str, status: int, headers: Mapping[str, str]) -> bytes:
    lines = [f"{version} {status} {reason(status)}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class StreamResponse:
    """A response written piece by piece: ``prepare`` sends the head, each
    ``write`` one chunk; the server writes the end when the handler
    returns."""

    def __init__(self, *, status: int = 200, headers: Mapping[str, str] | None = None):
        self.status = status
        self.headers = Headers(headers)
        self._writer: asyncio.StreamWriter | None = None
        self._chunked = True
        self._ended = False
        self._head_only = False

    @property
    def prepared(self) -> bool:
        return self._writer is not None

    async def prepare(self, request: Request) -> None:
        if self._writer is not None:
            return
        self._writer = request._writer
        request._prepared = True
        # A HEAD request gets the head: no chunked body follows, and the
        # connection closes after it (aiohttp's head for a HEAD stream).
        self._head_only = request.method == "HEAD"
        self._chunked = request.version == "HTTP/1.1" and not self._head_only
        hdrs = dict(self.headers)
        hdrs.setdefault("content-type", "application/octet-stream")
        hdrs["date"] = email.utils.formatdate(usegmt=True)
        if self._chunked:
            hdrs["transfer-encoding"] = "chunked"
        if not request.keep_alive or not self._chunked:
            hdrs["connection"] = "close"
        await self._send(_head(request.version, self.status, hdrs))

    async def _send(self, data: bytes) -> None:
        w = self._writer
        if w is None or w.is_closing():
            raise ConnectionResetError("Cannot write to closing transport")
        w.write(data)
        await w.drain()

    async def write(self, data: bytes) -> None:
        if not data or self._head_only:
            return
        if self._chunked:
            data = b"%x\r\n%b\r\n" % (len(data), data)
        await self._send(data)

    async def write_eof(self) -> None:
        if self._ended or self._writer is None:
            return
        self._ended = True
        if self._chunked:
            await self._send(b"0\r\n\r\n")


Handler = Callable[[Request], Awaitable["Response | StreamResponse"]]


async def _discard(reader: asyncio.StreamReader, n: int) -> None:
    """Read and drop ``n`` body bytes (a body past the size limit)."""
    while n > 0:
        n -= len(await reader.readexactly(min(n, 1 << 16)))


class HttpServer:
    """Routes and serves; ``start`` returns the bound port."""

    def __init__(self):
        self._routes: dict[str, dict[str, Handler]] = {}
        self._server: asyncio.base_events.Server | None = None
        self._conns: set[asyncio.Task] = set()

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self._routes.setdefault(path, {})[method.upper()] = handler

    def add_get(self, path: str, handler: Handler) -> None:
        """GET ``path``, and HEAD of it through the same handler."""
        self.add_route("GET", path, handler)
        self.add_route("HEAD", path, handler)

    def add_post(self, path: str, handler: Handler) -> None:
        self.add_route("POST", path, handler)

    async def start(self, host: str = "127.0.0.1", port: int = 0,
                    ssl_context: ssl.SSLContext | None = None) -> int:
        self._server = await asyncio.start_server(self._connection, host, port,
                                                  ssl=ssl_context, limit=_MAX_HEAD)
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for t in list(self._conns):
            t.cancel()
        if self._conns:
            await asyncio.gather(*self._conns, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    # ------------------------------------------------------------------
    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            first = True
            while True:
                try:
                    head = await asyncio.wait_for(
                        reader.readuntil(b"\r\n\r\n"),
                        None if first else KEEPALIVE_TIMEOUT)
                except (asyncio.IncompleteReadError, asyncio.TimeoutError):
                    return  # peer closed (or idled out) between requests
                except asyncio.LimitOverrunError:
                    await self._write_error(writer, 431, "HTTP/1.1")
                    return
                first = False
                try:
                    req = await self._parse(head, reader, writer)
                except HTTPException as exc:
                    await self._write_error(writer, exc.status, "HTTP/1.1", exc.text)
                    return
                if not await self._respond(req):
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # the peer went away mid-request
        finally:
            self._conns.discard(task)
            writer.close()

    async def _parse(self, head: bytes, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> Request:
        lines = head[:-4].decode("latin-1").split("\r\n")
        try:
            method, target, version = lines[0].split(" ")
        except ValueError:
            raise HTTPException(400, "Bad status line") from None
        if version not in ("HTTP/1.1", "HTTP/1.0"):
            raise HTTPException(400, f"Unsupported version {version}")
        headers = Headers()
        for ln in lines[1:]:
            name, sep, value = ln.partition(":")
            if not sep or not name or name != name.strip():
                raise HTTPException(400, "Bad header line")
            headers[name] = value.strip()
        if headers.get("expect", "").lower() == "100-continue":
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        body, too_large = b"", 0
        limit = CLIENT_MAX_SIZE
        if "chunked" in headers.get("transfer-encoding", "").lower():
            parts, size = [], 0
            while True:
                line = await reader.readuntil(b"\r\n")
                try:
                    n = int(line.split(b";", 1)[0].strip(), 16)
                except ValueError:
                    raise HTTPException(400, "Bad chunk size") from None
                if n == 0:
                    while await reader.readuntil(b"\r\n") != b"\r\n":
                        pass  # trailers
                    break
                size += n
                if size > limit:
                    await _discard(reader, n)  # read past: the connection stays usable
                else:
                    parts.append(await reader.readexactly(n))
                if await reader.readexactly(2) != b"\r\n":
                    raise HTTPException(400, "Bad chunk end")
            body, too_large = b"".join(parts), (size if size > limit else 0)
        elif "content-length" in headers:
            try:
                n = int(headers["content-length"])
            except ValueError:
                raise HTTPException(400, "Bad Content-Length") from None
            if n > limit:
                too_large = n
                await _discard(reader, n)
            elif n:
                body = await reader.readexactly(n)
        return Request(method.upper(), target, version, headers, body, too_large,
                       reader, writer, limit)

    async def _respond(self, req: Request) -> bool:
        """Run the handler and send its answer; True keeps the connection."""
        methods = self._routes.get(req.path)
        if methods is None:
            resp: Response | StreamResponse = Response(status=404, text="404: Not Found")
        elif req.method not in methods:
            resp = Response(status=405, text="405: Method Not Allowed",
                            headers={"Allow": ",".join(sorted(methods))})
        else:
            try:
                resp = await methods[req.method](req)
            except ConnectionError:
                raise
            except Exception as exc:  # noqa: BLE001 - answered as a 500
                if req._prepared:
                    # The head and maybe some chunks are out: an answer now
                    # would land inside the chunked body. Cut the stream.
                    log.exception("handler of %s %s failed after its response "
                                  "was sent; closing the connection", req.method, req.path)
                    return False
                if isinstance(exc, HTTPException):
                    resp = Response(status=exc.status, text=exc.text)
                else:
                    log.exception("handler of %s %s failed", req.method, req.path)
                    resp = Response(status=500, text="500 Internal Server Error\n\n"
                                                     "Server got itself in trouble")
        if isinstance(resp, StreamResponse):
            if not resp.prepared:
                await resp.prepare(req)
            if req._writer.is_closing():
                return False
            await resp.write_eof()
            return req.keep_alive and resp._chunked
        hdrs = dict(resp.headers)
        hdrs["content-length"] = str(len(resp.body))
        hdrs["date"] = email.utils.formatdate(usegmt=True)
        if not req.keep_alive:
            hdrs["connection"] = "close"
        body = b"" if req.method == "HEAD" else resp.body
        req._writer.write(_head(req.version, resp.status, hdrs) + body)
        await req._writer.drain()
        return req.keep_alive

    @staticmethod
    async def _write_error(writer: asyncio.StreamWriter, status: int, version: str,
                           text: str | None = None) -> None:
        body = (text or f"{status}: {reason(status)}").encode()
        writer.write(_head(version, status, {
            "content-type": "text/plain; charset=utf-8",
            "content-length": str(len(body)), "connection": "close"}) + body)
        try:
            await writer.drain()
        except ConnectionError:
            pass
