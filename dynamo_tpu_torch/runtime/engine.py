"""Async engine core: the universal compute abstraction of the runtime.

Every unit of work in the framework -- an HTTP handler, a preprocessor, a
router, a remote worker, the engine itself -- implements the same shape:

    engine.generate(Context[Req]) -> AsyncIterator[Resp]   (a ResponseStream)

with cooperative cancellation carried by the ``AsyncEngineContext`` attached to
the request's :class:`Context` wrapper.

Reference parity: mirrors the semantics of ``AsyncEngine`` /
``AsyncEngineContext`` / ``ResponseStream`` in the reference runtime
(lib/runtime/src/engine.rs:22-168) and ``Context<T>``
(lib/runtime/src/pipeline/context.rs), re-designed for Python asyncio: engines
are objects with an async ``generate`` method returning an async iterator, and
cancellation is an ``asyncio.Event`` pair (graceful stop vs. hard kill) instead
of tokio CancellationTokens.
"""

from __future__ import annotations

import asyncio
import contextlib
import uuid
from dataclasses import dataclass, field
from typing import (
    Any,
    AsyncIterator,
    Dict,
    Generic,
    Optional,
    Protocol,
    TypeVar,
    runtime_checkable,
)

T = TypeVar("T")
U = TypeVar("U")


class AsyncEngineContext:
    """Per-request control surface: id, stop/kill signals, completion.

    ``stop_generating`` asks the producer to finish gracefully (emit what it
    has, then end the stream).  ``kill`` demands immediate termination (no
    further items).  Reference: engine.rs:47-85.
    """

    __slots__ = ("_id", "_stopped", "_killed", "_complete")

    def __init__(self, request_id: Optional[str] = None) -> None:
        self._id = request_id or uuid.uuid4().hex
        self._stopped = asyncio.Event()
        self._killed = asyncio.Event()
        self._complete = asyncio.Event()

    @property
    def id(self) -> str:
        return self._id

    def is_stopped(self) -> bool:
        return self._stopped.is_set()

    def is_killed(self) -> bool:
        return self._killed.is_set()

    def stop_generating(self) -> None:
        self._stopped.set()

    def kill(self) -> None:
        self._killed.set()
        self._stopped.set()

    def set_complete(self) -> None:
        self._complete.set()

    async def stopped(self) -> None:
        await self._stopped.wait()

    async def killed(self) -> None:
        await self._killed.wait()


@dataclass
class Context(Generic[T]):
    """Request envelope: payload + id + metadata + cancellation context.

    Reference: ``Context<T>`` (pipeline/context.rs) — the id travels across
    process boundaries inside the request-plane control header so that remote
    cancellation and tracing work end to end.
    """

    data: T
    ctx: AsyncEngineContext = field(default_factory=AsyncEngineContext)
    metadata: Dict[str, Any] = field(default_factory=dict)

    @property
    def id(self) -> str:
        return self.ctx.id

    @classmethod
    def new(cls, data: T, request_id: Optional[str] = None) -> "Context[T]":
        return cls(data=data, ctx=AsyncEngineContext(request_id))


class ResponseStream(Generic[U]):
    """An async iterator of responses bound to an AsyncEngineContext.

    Wraps a raw async generator so consumers can reach the context (for
    cancellation) without plumbing it separately.  Iteration stops early when
    the context is killed.
    """

    def __init__(self, ctx: AsyncEngineContext, gen: AsyncIterator[U]) -> None:
        self._ctx = ctx
        self._gen = gen
        self._kill_waiter: Optional[asyncio.Task] = None

    @property
    def ctx(self) -> AsyncEngineContext:
        return self._ctx

    def __aiter__(self) -> "ResponseStream[U]":
        return self

    async def __anext__(self) -> U:
        ctx = self._ctx
        if ctx.is_killed():
            await self._shutdown_killed()
            raise StopAsyncIteration
        # Race the producer against kill: "immediate termination" must hold
        # even when the producer is blocked awaiting a stalled backend.
        if self._kill_waiter is None or self._kill_waiter.done():
            self._kill_waiter = asyncio.ensure_future(ctx.killed())
        nxt = asyncio.ensure_future(self._gen.__anext__())
        try:
            await asyncio.wait(
                {nxt, self._kill_waiter}, return_when=asyncio.FIRST_COMPLETED
            )
        except asyncio.CancelledError:
            nxt.cancel()
            raise
        if nxt.done():
            try:
                # dynalint: disable=DT001 -- guarded by nxt.done(): non-blocking
                return nxt.result()
            except StopAsyncIteration:
                ctx.set_complete()
                self._cleanup_waiter()
                raise
        # kill fired while the producer was still pending
        nxt.cancel()
        with contextlib.suppress(asyncio.CancelledError, Exception):
            await nxt
        await self._shutdown_killed()
        raise StopAsyncIteration

    def _cleanup_waiter(self) -> None:
        if self._kill_waiter is not None and not self._kill_waiter.done():
            self._kill_waiter.cancel()
        self._kill_waiter = None

    def __del__(self) -> None:
        # a consumer that breaks out of iteration without aclose() must not
        # leak the kill-race task ("Task was destroyed but it is pending")
        w = self._kill_waiter
        if w is not None and not w.done():
            w.cancel()

    async def _shutdown_killed(self) -> None:
        self._cleanup_waiter()
        await self._dispose()

    async def _dispose(self) -> None:
        aclose = getattr(self._gen, "aclose", None)
        if aclose is not None:
            with contextlib.suppress(Exception):
                await aclose()

    async def aclose(self) -> None:
        self._cleanup_waiter()
        await self._dispose()


@runtime_checkable
class AsyncEngine(Protocol[T, U]):
    """The universal compute interface (reference engine.rs:104-109).

    ``generate`` accepts a :class:`Context`-wrapped request and returns an
    async iterator of responses.  Implementations may return a plain async
    generator; pipeline glue wraps it into a :class:`ResponseStream`.
    """

    async def generate(self, request: Context[T]) -> AsyncIterator[U]:
        ...


@dataclass
class Annotated(Generic[U]):
    """SSE-style envelope: payload plus optional event/comment annotations.

    Reference: protocols/annotated.rs.  Used on every response hop so that
    out-of-band signals (errors, ``formatted_prompt`` / ``token_ids``
    annotations, completion sentinels) ride the same stream as data.
    """

    data: Optional[U] = None
    event: Optional[str] = None
    comment: Optional[list] = None
    id: Optional[str] = None

    @classmethod
    def from_data(cls, data: U) -> "Annotated[U]":
        return cls(data=data)

    @classmethod
    def from_error(cls, message: str) -> "Annotated[U]":
        return cls(event="error", comment=[message])

    def is_error(self) -> bool:
        return self.event == "error"

    def error_message(self) -> Optional[str]:
        if self.is_error():
            return "; ".join(self.comment or ["unknown error"])
        return None

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.data is not None:
            out["data"] = self.data
        if self.event is not None:
            out["event"] = self.event
        if self.comment is not None:
            out["comment"] = self.comment
        if self.id is not None:
            out["id"] = self.id
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Annotated[Any]":
        return cls(
            data=d.get("data"),
            event=d.get("event"),
            comment=d.get("comment"),
            id=d.get("id"),
        )
