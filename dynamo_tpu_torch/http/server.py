"""Minimal asyncio HTTP/1.1 server: the transport under the OpenAI service.

The reference rides axum/hyper (lib/llm/src/http/service/service_v2.rs);
here the service speaks HTTP directly over asyncio streams -- no web
framework is available in the image, and the surface is small: JSON request
bodies, JSON responses, and SSE streaming with chunked transfer encoding.

Supports keep-alive, Content-Length bodies, and per-route async handlers
returning either a full :class:`Response` or a streaming one (async
iterator body -> ``Transfer-Encoding: chunked``).
"""

from __future__ import annotations

import asyncio
import json
import logging
from dataclasses import dataclass, field
from typing import AsyncIterator, Awaitable, Callable, Dict, Optional, Tuple, Union

logger = logging.getLogger("dynamo.http")

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 64 * 1024 * 1024

_STATUS_TEXT = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    413: "Payload Too Large",
    422: "Unprocessable Entity",
    429: "Too Many Requests",
    500: "Internal Server Error",
    501: "Not Implemented",
    503: "Service Unavailable",
    504: "Gateway Timeout",
}


@dataclass
class Request:
    method: str
    path: str
    headers: Dict[str, str]
    body: bytes

    def json(self):
        try:
            return json.loads(self.body) if self.body else None
        except json.JSONDecodeError as e:
            raise BadRequest(f"invalid JSON body: {e}") from e


@dataclass
class Response:
    status: int = 200
    headers: Dict[str, str] = field(default_factory=dict)
    body: Union[bytes, AsyncIterator[bytes]] = b""
    # invoked exactly once when the connection is done with this response,
    # even when a streaming body was NEVER started (header write failed
    # because the client vanished): finalizing a never-started async
    # generator does not run its body (PEP 525), so cleanup that lives in
    # the generator needs this out-of-band hook
    on_close: Optional[Callable[[], None]] = None

    @classmethod
    def json(cls, obj, status: int = 200) -> "Response":
        return cls(
            status=status,
            headers={"Content-Type": "application/json"},
            body=json.dumps(obj).encode(),
        )

    @classmethod
    def sse(cls, gen: AsyncIterator[bytes]) -> "Response":
        return cls(
            status=200,
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
            },
            body=gen,
        )


class BadRequest(ValueError):
    pass


Handler = Callable[[Request], Awaitable[Response]]


class HttpServer:
    """Route-table HTTP server.  Routes are ``(METHOD, path) -> handler``;
    a fallback handler (if set) sees everything unmatched."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self.port = port
        self.routes: Dict[Tuple[str, str], Handler] = {}
        # (METHOD, path_prefix, handler): matched after exact routes, for
        # path-parameter endpoints like /trace/{request_id}
        self.prefix_routes: list = []
        self.fallback: Optional[Handler] = None
        self._server: Optional[asyncio.base_events.Server] = None
        # live connections; stop() force-closes them -- Python 3.12+
        # wait_closed() otherwise blocks until every handler returns
        self._writers: set = set()

    def route(self, method: str, path: str, handler: Handler) -> None:
        self.routes[(method.upper(), path)] = handler

    def route_prefix(self, method: str, prefix: str, handler: Handler) -> None:
        """Route every path under ``prefix`` (the trailing path segment is
        the handler's to parse from ``Request.path``)."""
        self.prefix_routes.append((method.upper(), prefix, handler))

    @property
    def address(self) -> Tuple[str, int]:
        assert self._server is not None, "server not started"
        sock = self._server.sockets[0]
        host, port = sock.getsockname()[:2]
        return host, port

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port, limit=MAX_HEADER_BYTES
        )
        self.port = self.address[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for w in list(self._writers):
                try:
                    w.close()
                except Exception:
                    logger.debug("closing live connection failed", exc_info=True)
            await self._server.wait_closed()
            self._server = None

    # -- connection handling -------------------------------------------------

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._writers.add(writer)
        try:
            while True:
                try:
                    req = await self._read_request(reader)
                except BadRequest as e:
                    # malformed framing: answer 400 and drop the connection
                    # (the stream position is no longer trustworthy)
                    await self._write_response(
                        writer,
                        Response.json({"error": {"message": str(e)}}, 400),
                        keep_alive=False,
                    )
                    break
                if req is None:
                    break
                keep_alive = (
                    req.headers.get("connection", "keep-alive").lower()
                    != "close"
                )
                try:
                    resp = await self._dispatch(req)
                except BadRequest as e:
                    resp = Response.json({"error": {"message": str(e)}}, 400)
                except Exception:
                    logger.exception("handler failed for %s %s", req.method, req.path)
                    resp = Response.json(
                        {"error": {"message": "internal server error"}}, 500
                    )
                await self._write_response(writer, resp, keep_alive)
                if not keep_alive:
                    break
        except (
            asyncio.IncompleteReadError,
            ConnectionResetError,
            BrokenPipeError,
            asyncio.LimitOverrunError,
        ):
            pass
        except Exception:
            logger.exception("connection handler error")
        finally:
            self._writers.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                # peer vanished mid-teardown: routine, but keep a trace
                logger.debug("connection teardown failed", exc_info=True)

    async def _read_request(
        self, reader: asyncio.StreamReader
    ) -> Optional[Request]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError:
            return None
        except asyncio.LimitOverrunError:
            # the StreamReader limit (== MAX_HEADER_BYTES) tripped first
            raise BadRequest("headers too large") from None
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3:
            raise BadRequest(f"malformed request line: {lines[0]!r}")
        method, target, _version = parts
        path = target.split("?", 1)[0]
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        try:
            length = int(headers.get("content-length", "0") or 0)
        except ValueError:
            raise BadRequest("invalid Content-Length") from None
        if length > MAX_BODY_BYTES:
            raise BadRequest("body too large")
        body = await reader.readexactly(length) if length else b""
        return Request(method=method.upper(), path=path, headers=headers, body=body)

    async def _dispatch(self, req: Request) -> Response:
        handler = self.routes.get((req.method, req.path))
        if handler is None:
            for method, prefix, h in self.prefix_routes:
                if method == req.method and req.path.startswith(prefix):
                    handler = h
                    break
        if handler is None and self.fallback is not None:
            handler = self.fallback
        if handler is None:
            if any(p == req.path for (_m, p) in self.routes):
                return Response.json(
                    {"error": {"message": "method not allowed"}}, 405
                )
            return Response.json({"error": {"message": "not found"}}, 404)
        return await handler(req)

    async def _write_response(
        self, writer: asyncio.StreamWriter, resp: Response, keep_alive: bool
    ) -> None:
        try:
            await self._write_response_inner(writer, resp, keep_alive)
        finally:
            if resp.on_close is not None:
                try:
                    resp.on_close()
                except Exception:
                    logger.debug("response on_close failed", exc_info=True)

    async def _write_response_inner(
        self, writer: asyncio.StreamWriter, resp: Response, keep_alive: bool
    ) -> None:
        status_line = (
            f"HTTP/1.1 {resp.status} {_STATUS_TEXT.get(resp.status, 'Unknown')}\r\n"
        )
        headers = dict(resp.headers)
        headers.setdefault("Connection", "keep-alive" if keep_alive else "close")
        if isinstance(resp.body, bytes):
            headers["Content-Length"] = str(len(resp.body))
            head = status_line + "".join(
                f"{k}: {v}\r\n" for k, v in headers.items()
            )
            writer.write(head.encode("latin-1") + b"\r\n" + resp.body)
            await writer.drain()
            return
        # streaming body -> chunked transfer encoding
        headers["Transfer-Encoding"] = "chunked"
        head = status_line + "".join(f"{k}: {v}\r\n" for k, v in headers.items())
        writer.write(head.encode("latin-1") + b"\r\n")
        await writer.drain()
        try:
            async for chunk in resp.body:
                if not chunk:
                    continue
                writer.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                await writer.drain()
        finally:
            aclose = getattr(resp.body, "aclose", None)
            if aclose is not None:
                try:
                    await aclose()
                except Exception:
                    # the stream generator's cleanup failed AFTER its last
                    # chunk; the response is intact but leaks deserve a trace
                    logger.debug("stream body aclose() failed", exc_info=True)
        writer.write(b"0\r\n\r\n")
        await writer.drain()
