"""Peer-to-peer streaming RPC: the request/response data plane.

The reference splits one logical RPC across two transports: the request rides
a NATS message to the worker's subject (addressed_router.rs:152) and the
response stream comes back over a *reverse* raw-TCP connection that the worker
dials into the caller (push_handler.rs:65, network/tcp/*).  That split exists
because NATS cannot stream.  With a first-party transport we use a single
duplex TCP connection per peer pair and multiplex many concurrent request
streams over it -- which preserves every property the split design bought
(streaming, per-request cancellation, backpressure, prologue errors) with one
fewer connection handshake on the hot path.

Frames (two-part codec, see codec.py):
  client -> server:  {t:"req",  sid, subject, id, meta}  + request payload
                     {t:"part", sid}  + chunk   -- upload continuation (up:true)
                     {t:"upend", sid}           -- upload complete
                     {t:"cancel", sid, kill}
  server -> client:  {t:"ack",  sid}            -- prologue: handler accepted
                     {t:"err",  sid, msg}       -- prologue or mid-stream error
                     {t:"data", sid}            + response item payload
                     {t:"end",  sid}            -- stream complete

``sid`` is a client-chosen stream id unique per connection.

Bulk uploads (the disagg KV delivery path): a ``req`` frame carrying
``up: true`` opens a client->server chunk stream for the request payload --
the frame's own payload is the first chunk, ``part`` frames append, ``upend``
closes.  The receiving handler must be registered raw (``register_raw``) and
consumes chunks as they arrive, so a multi-hundred-MB KV blockset never
materializes as one frame (frames cap at codec.MAX_FRAME) and the receive
side can overlap assembly with the sender's socket writes.  This replaces
the reference's NIXL one-sided RDMA leg (block_manager/storage/nixl.rs:173):
same role -- bulk KV moves peer-to-peer, off the control plane.
"""

from __future__ import annotations

import asyncio
import contextlib
import itertools
import logging
import os
from typing import Any, AsyncIterator, Awaitable, Callable, Dict, Optional, Tuple

from .. import faults
from ..engine import (
    DEADLINE_EXCEEDED_MSG,
    AsyncEngineContext,
    DeadlineExceededError,
    ensure_response_stream,
)
from .codec import (
    decode_deadline_context,
    encode_deadline_context,
    encode_trace_context,
    read_frame,
    write_frame,
)

logger = logging.getLogger("dynamo.dataplane")

# How long a stalled consumer may block its (bounded) stream queue before the
# stream is considered abandoned and dropped (env: DYN_ABANDONED_STREAM_S).
ABANDONED_STREAM_TIMEOUT = float(os.environ.get("DYN_ABANDONED_STREAM_S", "60"))

_DEADLINE_MSG = DEADLINE_EXCEEDED_MSG


def _count_abandoned(side: str) -> None:
    """abandoned_streams counter (lazy: transports must import without
    dragging prometheus in)."""
    from .. import metrics as rtm

    rtm.default_registry().counter(
        "dynamo_abandoned_streams",
        "Streams dropped by the request plane after a consumer stalled "
        "past the abandoned-stream timeout",
        ["side"],  # response (client pump) | upload (server chunk queue)
    ).labels(side).inc()

# A raw byte-level handler: receives (header, payload, ctx) and returns an
# async iterator of payload byte strings.  Serde lives one layer up (ingress).
ByteHandler = Callable[
    [Dict[str, Any], bytes, AsyncEngineContext], Awaitable[AsyncIterator[bytes]]
]

# A raw streaming handler: receives the request payload as an async iterator
# of chunks (one for plain requests, many for up:true uploads).
RawHandler = Callable[
    [Dict[str, Any], AsyncIterator[bytes], AsyncEngineContext],
    Awaitable[AsyncIterator[bytes]],
]

# Bound on buffered upload chunks per stream: past this the connection read
# loop stalls and TCP flow control pushes back on the sender.
UPLOAD_QUEUE_DEPTH = 8

_UPLOAD_END = None  # sentinel closing an upload queue


class StreamEnd(Exception):
    pass


class RemoteError(Exception):
    """Error raised by the remote handler, propagated through the stream."""


class WorkerLostError(RemoteError):
    """The stream died for transport-shaped reasons -- connection lost, or
    the worker no longer serves the subject (drain/restart).  Distinct from
    a handler error so failover can tell "the worker vanished" (retryable
    on another instance when nothing was delivered yet) from "the request
    itself failed" (never retryable)."""


class DataPlaneServer:
    """Worker-side listener: dispatches request frames to subject handlers.

    One server per process; endpoints register their subject here and their
    address in the hub's ``instances/`` keyspace (component/endpoint.py).
    """

    def __init__(self, host: str = "0.0.0.0", port: int = 0) -> None:
        self.host = host
        self.port = port
        self.advertise_host: Optional[str] = None
        self._handlers: Dict[str, ByteHandler] = {}
        self._raw_handlers: Dict[str, RawHandler] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn_writers: set = set()

    def register(self, subject: str, handler: ByteHandler) -> None:
        self._handlers[subject] = handler

    def register_raw(self, subject: str, handler: RawHandler) -> None:
        """Register a streaming byte handler (upload-capable subjects)."""
        self._raw_handlers[subject] = handler

    def unregister(self, subject: str) -> None:
        self._handlers.pop(subject, None)
        self._raw_handlers.pop(subject, None)

    @property
    def address(self) -> Tuple[str, int]:
        host = self.advertise_host or (
            "127.0.0.1" if self.host in ("0.0.0.0", "::") else self.host
        )
        return host, self.port

    async def start(self) -> Tuple[str, int]:
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.address

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            # 3.12+ wait_closed() blocks until handlers return; unblock them.
            for w in list(self._conn_writers):
                with contextlib.suppress(Exception):
                    w.close()
            await self._server.wait_closed()

    async def _on_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._conn_writers.add(writer)
        send_lock = asyncio.Lock()
        live: Dict[int, AsyncEngineContext] = {}
        uploads: Dict[int, asyncio.Queue] = {}
        tasks: set = set()  # strong refs: loop holds only weak task refs

        async def send(hdr: Dict[str, Any], payload: bytes = b"") -> None:
            async with send_lock:
                try:
                    write_frame(writer, hdr, payload)
                    await writer.drain()
                except (ConnectionError, RuntimeError):
                    pass

        async def run_stream(
            sid: int,
            hdr: Dict[str, Any],
            payload: bytes,
            ctx: AsyncEngineContext,
            uq: Optional[asyncio.Queue],
        ) -> None:
            subject = hdr.get("subject", "")
            raw = self._raw_handlers.get(subject)
            handler = self._handlers.get(subject) if raw is None else None
            if raw is None and handler is None:
                live.pop(sid, None)
                uploads.pop(sid, None)
                # "retry" marks a transport-shaped failure: the worker is
                # not serving this subject (drained / restarting), so the
                # caller's failover may safely try another instance
                await send(
                    {"t": "err", "sid": sid, "retry": True,
                     "msg": f"no handler for subject {subject!r}"}
                )
                return
            if ctx.deadline_expired():
                # fast 504: the budget died in flight or on the queue --
                # answer immediately, never touch the engine
                live.pop(sid, None)
                uploads.pop(sid, None)
                await send(
                    {"t": "err", "sid": sid, "deadline": True,
                     "msg": _DEADLINE_MSG}
                )
                return
            try:
                if raw is not None:
                    # uq is captured at req time by the read loop: the upend
                    # frame may be processed (and the uploads entry popped)
                    # before this task first runs
                    async def chunk_iter() -> AsyncIterator[bytes]:
                        if uq is None:
                            yield payload
                            return
                        while True:
                            chunk = await uq.get()
                            if chunk is _UPLOAD_END:
                                return
                            yield chunk

                    stream = await raw(hdr, chunk_iter(), ctx)
                elif hdr.get("up"):
                    raise RuntimeError(
                        f"subject {subject!r} does not accept uploads"
                    )
                else:
                    stream = await handler(hdr, payload, ctx)
            except Exception as exc:  # noqa: BLE001 - prologue error to caller
                logger.exception("handler prologue failed for %s", subject)
                await send({"t": "err", "sid": sid, "msg": str(exc)})
                live.pop(sid, None)
                uploads.pop(sid, None)
                return
            await send({"t": "ack", "sid": sid})
            if faults.injector.enabled and faults.injector.should_fire(
                "engine.crash_before_first_token", subject
            ):
                # simulated worker death at the transport level, after the
                # engine accepted but before any item: the connection drops
                # with nothing delivered -- the failover-retryable window.
                # Kill the context so the engine side cleans up (pages
                # freed), as a real process death's connection loss would.
                ctx.kill()
                writer.close()
                return
            # Deadline watchdog: expiry kills the context, which wins the
            # ResponseStream race below even when the engine is blocked
            # mid-item; the stream then closes with a deadline error frame
            # (fast 504 at the frontend) and the kill propagates into the
            # engine's cancellation path, freeing the request's KV pages.
            wd = None
            rem = ctx.deadline_remaining()
            if rem is not None:
                wd = asyncio.get_running_loop().call_later(
                    max(rem, 0.0), ctx.kill
                )
            _F = faults.injector
            n_sent = 0
            try:
                # ResponseStream races the handler against kill, so a killed
                # request terminates even when the engine is blocked mid-item.
                async for item in ensure_response_stream(ctx, stream):
                    if ctx.is_killed():
                        break
                    if _F.enabled and _F.should_fire(
                        "req.stream_abort", subject
                    ):
                        await send(
                            {"t": "err", "sid": sid,
                             "msg": "injected stream abort"}
                        )
                        return
                    await send({"t": "data", "sid": sid}, item)
                    n_sent += 1
                    if n_sent == 1 and _F.enabled and _F.should_fire(
                        "engine.crash_after_first_token", subject
                    ):
                        ctx.kill()
                        writer.close()  # simulated worker death mid-stream
                        return
                if ctx.is_killed() and ctx.deadline_expired():
                    await send(
                        {"t": "err", "sid": sid, "deadline": True,
                         "msg": _DEADLINE_MSG}
                    )
                else:
                    await send({"t": "end", "sid": sid})
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 - mid-stream error
                logger.exception("handler stream failed for %s", hdr.get("subject"))
                await send({"t": "err", "sid": sid, "msg": str(exc)})
            finally:
                if wd is not None:
                    wd.cancel()
                ctx.set_complete()
                live.pop(sid, None)
                uq_dead = uploads.pop(sid, None)
                if uq_dead is not None:
                    # the read loop may be parked in put() on this queue; a
                    # dead consumer must not head-of-line-block every other
                    # stream for ABANDONED_STREAM_TIMEOUT -- drain so the
                    # parked put completes immediately (later parts find the
                    # sid deregistered and are dropped)
                    while True:
                        try:
                            uq_dead.get_nowait()
                        except asyncio.QueueEmpty:
                            break

        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                hdr, payload = frame
                t = hdr.get("t")
                if t == "req":
                    sid = int(hdr["sid"])
                    # Register the context *before* yielding to the loop so a
                    # cancel frame already sitting in the TCP buffer can't
                    # race past the stream it targets.
                    ctx = AsyncEngineContext(hdr.get("id"))
                    rem = decode_deadline_context(hdr)
                    if rem is not None:
                        # re-anchor the caller's remaining budget on this
                        # host's monotonic clock (the hop's transit time has
                        # already decremented it)
                        ctx.set_deadline(rem)
                    live[sid] = ctx
                    uq = None
                    if hdr.get("up"):
                        uq = asyncio.Queue(maxsize=UPLOAD_QUEUE_DEPTH)
                        uploads[sid] = uq
                        if payload:
                            uq.put_nowait(payload)  # fresh queue: has room
                    task = asyncio.create_task(
                        run_stream(sid, hdr, payload, ctx, uq)
                    )
                    tasks.add(task)
                    task.add_done_callback(tasks.discard)
                elif t in ("part", "upend"):
                    usid0 = int(hdr["sid"])
                    uq = (
                        uploads.get(usid0) if t == "part"
                        else uploads.pop(usid0, None)
                    )
                    if uq is not None:
                        item = payload if t == "part" else _UPLOAD_END
                        # Bounded queue: a slow consumer stalls this read
                        # loop and TCP flow control reaches the uploader
                        # (accepted HOL cost, as on the response path).  A
                        # consumer stalled past the deadline is abandoned.
                        try:
                            await asyncio.wait_for(
                                uq.put(item), ABANDONED_STREAM_TIMEOUT
                            )
                        except asyncio.TimeoutError:
                            usid = int(hdr["sid"])
                            logger.warning(
                                "upload %s abandoned (consumer stalled "
                                "%.0fs); dropping", usid,
                                ABANDONED_STREAM_TIMEOUT,
                            )
                            _count_abandoned("upload")
                            uploads.pop(usid, None)
                            uctx = live.get(usid)
                            if uctx is not None:
                                uctx.kill()
                elif t == "cancel":
                    sid = int(hdr["sid"])
                    ctx = live.get(sid)
                    if ctx is not None:
                        if hdr.get("kill"):
                            ctx.kill()
                        else:
                            ctx.stop_generating()
                    # unblock a handler draining this stream's upload; make
                    # room first -- the sentinel must land even on a full
                    # queue or the handler blocks on get() forever
                    uq = uploads.pop(sid, None)
                    if uq is not None:
                        if uq.full():
                            with contextlib.suppress(asyncio.QueueEmpty):
                                uq.get_nowait()
                        with contextlib.suppress(asyncio.QueueFull):
                            uq.put_nowait(_UPLOAD_END)
        except ConnectionError as exc:
            logger.warning("data-plane connection failed mid-frame: %s", exc)
        finally:
            # Peer went away: kill all of its in-flight streams and unblock
            # handlers mid-upload (their chunk iterator must terminate).
            for ctx in list(live.values()):
                ctx.kill()
            for uq in list(uploads.values()):
                if uq.full():
                    with contextlib.suppress(asyncio.QueueEmpty):
                        uq.get_nowait()
                with contextlib.suppress(asyncio.QueueFull):
                    uq.put_nowait(_UPLOAD_END)
            uploads.clear()
            self._conn_writers.discard(writer)
            with contextlib.suppress(Exception):
                writer.close()


def _remote_error(hdr: Dict[str, Any]) -> Exception:
    """Typed exception for an err frame: deadline expiries and transport-
    shaped losses (conn drop, drained subject) get their own classes so the
    frontend can map them to 504 / failover without string matching."""
    msg = hdr.get("msg", "remote error")
    if hdr.get("deadline"):
        return DeadlineExceededError(msg)
    if hdr.get("lost") or hdr.get("retry"):
        return WorkerLostError(msg)
    return RemoteError(msg)


class _Connection:
    """One multiplexed client connection to a worker's data-plane server."""

    def __init__(self, host: str, port: int) -> None:
        self.host, self.port = host, port
        self._sid = itertools.count(1)
        self._streams: Dict[int, asyncio.Queue] = {}
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pump: Optional[asyncio.Task] = None
        self._send_lock = asyncio.Lock()
        self.closed = False

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port
        )
        self._pump = asyncio.create_task(self._pump_loop())

    async def _pump_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                frame = await read_frame(self._reader)
                if frame is None:
                    break
                hdr, payload = frame
                sid = hdr.get("sid")
                q = self._streams.get(sid)
                if q is not None:
                    # Bounded queue: a stalled consumer stops the pump, TCP
                    # flow control kicks in, and backpressure reaches the
                    # producer (head-of-line blocking across the multiplexed
                    # connection is the accepted cost, as in HTTP/2 w/o
                    # per-stream flow control).  A consumer that stays stalled
                    # past the deadline is treated as abandoned: its stream is
                    # dropped and the server told to kill the request, so one
                    # dead consumer can't wedge the shared connection forever.
                    try:
                        await asyncio.wait_for(
                            q.put((hdr, payload)), ABANDONED_STREAM_TIMEOUT
                        )
                    except asyncio.TimeoutError:
                        logger.warning(
                            "stream %s abandoned (queue full %.0fs); dropping",
                            sid, ABANDONED_STREAM_TIMEOUT,
                        )
                        _count_abandoned("response")
                        self._streams.pop(sid, None)
                        with contextlib.suppress(ConnectionError):
                            await self.send(
                                {"t": "cancel", "sid": sid, "kill": True}
                            )
        except Exception as exc:  # noqa: BLE001
            logger.warning("data-plane connection %s:%d lost: %s",
                           self.host, self.port, exc)
        finally:
            self.closed = True
            for q in self._streams.values():
                # Make room if the bounded queue is full: the error must land.
                if q.full():
                    with contextlib.suppress(asyncio.QueueEmpty):
                        q.get_nowait()
                with contextlib.suppress(asyncio.QueueFull):
                    q.put_nowait(
                        ({"t": "err", "lost": True, "msg": "connection lost"},
                         b"")
                    )

    async def send(self, hdr: Dict[str, Any], payload: bytes = b"") -> None:
        assert self._writer is not None
        async with self._send_lock:
            write_frame(self._writer, hdr, payload)
            await self._writer.drain()

    async def close(self) -> None:
        self.closed = True
        if self._pump:
            self._pump.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._pump
        if self._writer:
            self._writer.close()
            with contextlib.suppress(Exception):
                await self._writer.wait_closed()

    async def request(
        self,
        subject: str,
        request_id: str,
        meta: Dict[str, Any],
        payload: bytes,
        ctx: AsyncEngineContext,
        trace: Optional[Dict[str, str]] = None,
        deadline: Optional[float] = None,
    ) -> AsyncIterator[bytes]:
        """Issue a request; await the prologue; yield response payloads.
        ``trace`` is an optional trace-context wire dict carried in the req
        frame header (absent = untraced, byte-identical wire format);
        ``deadline`` is the remaining budget in seconds, stamped next to
        it."""
        sid = next(self._sid)
        q: asyncio.Queue = asyncio.Queue(maxsize=512)
        self._streams[sid] = q
        await self.send(
            encode_deadline_context(
                encode_trace_context(
                    {"t": "req", "sid": sid, "subject": subject,
                     "id": request_id, "meta": meta},
                    trace,
                ),
                deadline,
            ),
            payload,
        )

        # Prologue: ack or err (reference: TCP prologue, network.rs:64-73).
        hdr, _ = await q.get()
        if hdr.get("t") == "err":
            self._streams.pop(sid, None)
            raise _remote_error(hdr)
        assert hdr.get("t") == "ack", f"bad prologue {hdr}"

        async def gen() -> AsyncIterator[bytes]:
            cancel_sent = [False]
            watcher = asyncio.create_task(
                self._cancel_watch(sid, ctx, cancel_sent)
            )
            ended = False
            try:
                while True:
                    hdr, payload = await q.get()
                    t = hdr.get("t")
                    if t == "data":
                        yield payload
                    elif t == "end":
                        ended = True
                        return
                    elif t == "err":
                        ended = True
                        raise _remote_error(hdr)
            finally:
                watcher.cancel()
                # The consumer may stop iterating (kill / early aclose) before
                # the watcher got scheduled: make sure the worker hears about
                # it, or it would keep generating into the void.
                if not ended and ctx.is_stopped() and not cancel_sent[0]:
                    cancel_sent[0] = True
                    with contextlib.suppress(ConnectionError, RuntimeError):
                        await self.send(
                            {"t": "cancel", "sid": sid, "kill": ctx.is_killed()}
                        )
                self._streams.pop(sid, None)

        return gen()

    async def _cancel_watch(
        self, sid: int, ctx: AsyncEngineContext, cancel_sent: list
    ) -> None:
        """Forward local stop/kill onto the wire as cancel frames."""
        with contextlib.suppress(asyncio.CancelledError, ConnectionError):
            await ctx.stopped()
            cancel_sent[0] = True
            await self.send(
                {"t": "cancel", "sid": sid, "kill": ctx.is_killed()}
            )

    async def request_upload(
        self,
        subject: str,
        request_id: str,
        meta: Dict[str, Any],
        chunks: Any,
        ctx: AsyncEngineContext,
        trace: Optional[Dict[str, str]] = None,
    ) -> AsyncIterator[bytes]:
        """Issue an upload-stream request: send every chunk, then read the
        response stream.  ``chunks`` is an iterable or async iterable of
        bytes-like objects, each < codec.MAX_FRAME.

        Chunks are sent eagerly (TCP flow control is the backpressure); the
        prologue is read only after ``upend``, so a handler that assembles
        the full payload before opening its response stream cannot deadlock
        against a client waiting for the ack.
        """
        sid = next(self._sid)
        q: asyncio.Queue = asyncio.Queue(maxsize=512)
        self._streams[sid] = q
        req_sent = False
        try:
            await self.send(
                encode_trace_context(
                    {"t": "req", "sid": sid, "subject": subject,
                     "id": request_id, "meta": meta, "up": True},
                    trace,
                )
            )
            req_sent = True
            if hasattr(chunks, "__aiter__"):
                async for chunk in chunks:
                    await self.send({"t": "part", "sid": sid}, chunk)
            else:
                for chunk in chunks:
                    await self.send({"t": "part", "sid": sid}, chunk)
            await self.send({"t": "upend", "sid": sid})
        except Exception:
            self._streams.pop(sid, None)
            if req_sent:
                # a chunk-source failure with a healthy connection (e.g. the
                # blob iterator raised) must not leave the server's raw
                # handler blocked on its chunk queue forever: kill the
                # half-sent stream so its byte-count check fails fast
                with contextlib.suppress(Exception):
                    await self.send({"t": "cancel", "sid": sid, "kill": True})
                    await self.send({"t": "upend", "sid": sid})
            raise

        # Prologue: ack or err (may arrive mid-upload; the queue holds it).
        hdr, _ = await q.get()
        if hdr.get("t") == "err":
            self._streams.pop(sid, None)
            raise _remote_error(hdr)
        assert hdr.get("t") == "ack", f"bad prologue {hdr}"

        async def gen() -> AsyncIterator[bytes]:
            cancel_sent = [False]
            watcher = asyncio.create_task(
                self._cancel_watch(sid, ctx, cancel_sent)
            )
            ended = False
            try:
                while True:
                    hdr, payload = await q.get()
                    t = hdr.get("t")
                    if t == "data":
                        yield payload
                    elif t == "end":
                        ended = True
                        return
                    elif t == "err":
                        ended = True
                        raise _remote_error(hdr)
            finally:
                watcher.cancel()
                if not ended and ctx.is_stopped() and not cancel_sent[0]:
                    cancel_sent[0] = True
                    with contextlib.suppress(ConnectionError, RuntimeError):
                        await self.send(
                            {"t": "cancel", "sid": sid, "kill": ctx.is_killed()}
                        )
                self._streams.pop(sid, None)
        return gen()


class DataPlaneClient:
    """Connection pool: one multiplexed connection per (host, port)."""

    def __init__(self) -> None:
        self._conns: Dict[Tuple[str, int], _Connection] = {}
        self._locks: Dict[Tuple[str, int], asyncio.Lock] = {}

    async def _get(self, host: str, port: int) -> _Connection:
        key = (host, port)
        lock = self._locks.setdefault(key, asyncio.Lock())
        async with lock:
            conn = self._conns.get(key)
            if conn is None or conn.closed:
                conn = _Connection(host, port)
                await conn.connect()
                self._conns[key] = conn
            return conn

    async def request(
        self,
        host: str,
        port: int,
        subject: str,
        request_id: str,
        meta: Dict[str, Any],
        payload: bytes,
        ctx: AsyncEngineContext,
        trace: Optional[Dict[str, str]] = None,
        deadline: Optional[float] = None,
    ) -> AsyncIterator[bytes]:
        conn = await self._get(host, port)
        return await conn.request(
            subject, request_id, meta, payload, ctx, trace=trace,
            deadline=deadline,
        )

    async def request_upload(
        self,
        host: str,
        port: int,
        subject: str,
        request_id: str,
        meta: Dict[str, Any],
        chunks: Any,
        ctx: AsyncEngineContext,
        trace: Optional[Dict[str, str]] = None,
    ) -> AsyncIterator[bytes]:
        conn = await self._get(host, port)
        return await conn.request_upload(
            subject, request_id, meta, chunks, ctx, trace=trace
        )

    async def close(self) -> None:
        for conn in self._conns.values():
            await conn.close()
        self._conns.clear()
