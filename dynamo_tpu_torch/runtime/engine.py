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
import time
import uuid
from dataclasses import dataclass, field
from typing import (
    Any,
    AsyncIterator,
    Awaitable,
    Callable,
    Dict,
    Generic,
    Optional,
    Protocol,
    TypeVar,
    runtime_checkable,
)

T = TypeVar("T")
U = TypeVar("U")


# The canonical deadline-expiry message: error frames carry it, and the
# HTTP frontend classifies error frames bearing it as 504.  One constant,
# shared by every producer and the classifier, so they cannot drift.
DEADLINE_EXCEEDED_MSG = "deadline exceeded"


class DeadlineExceededError(RuntimeError):
    """A request's deadline budget expired before it completed.  Maps to
    HTTP 504 at the frontend; transports answer it with a fast error frame
    instead of computing for a caller that stopped waiting."""

    def __init__(self, message: str = DEADLINE_EXCEEDED_MSG) -> None:
        super().__init__(message)


class AsyncEngineContext:
    """Per-request control surface: id, stop/kill signals, completion.

    ``stop_generating`` asks the producer to finish gracefully (emit what it
    has, then end the stream).  ``kill`` demands immediate termination (no
    further items).  Reference: engine.rs:47-85.

    An optional *deadline budget* (seconds remaining) rides along: it is
    re-anchored on the local monotonic clock at every hop (the wire carries
    relative seconds, ``codec.encode_deadline_context``), checked before
    work is admitted, and enforced mid-stream by transport watchdogs that
    ``kill`` the context at expiry.
    """

    __slots__ = (
        "_id", "_stopped", "_killed", "_complete", "_children", "_deadline",
    )

    def __init__(self, request_id: Optional[str] = None) -> None:
        self._id = request_id or uuid.uuid4().hex
        self._stopped = asyncio.Event()
        self._killed = asyncio.Event()
        self._complete = asyncio.Event()
        self._children: list["AsyncEngineContext"] = []
        self._deadline: Optional[float] = None  # absolute time.monotonic()

    @property
    def id(self) -> str:
        return self._id

    def is_stopped(self) -> bool:
        return self._stopped.is_set()

    def is_killed(self) -> bool:
        return self._killed.is_set()

    def is_complete(self) -> bool:
        return self._complete.is_set()

    def stop_generating(self) -> None:
        self._stopped.set()
        for child in self._children:
            child.stop_generating()

    def kill(self) -> None:
        self._killed.set()
        self._stopped.set()
        for child in self._children:
            child.kill()

    def set_complete(self) -> None:
        self._complete.set()

    async def stopped(self) -> None:
        await self._stopped.wait()

    async def killed(self) -> None:
        await self._killed.wait()

    def link_child(self, child: "AsyncEngineContext") -> None:
        """Propagate stop/kill to a downstream context (cross-process hops
        re-create the context; linking keeps the cancellation chain intact)."""
        self._children.append(child)
        if self.is_killed():
            child.kill()
        elif self.is_stopped():
            child.stop_generating()

    # -- deadline budget ---------------------------------------------------

    def set_deadline(self, remaining_s: float) -> None:
        """Arm (or re-anchor, on a hop) the deadline budget: ``remaining_s``
        seconds from now on this host's monotonic clock."""
        self._deadline = time.monotonic() + remaining_s

    def deadline_remaining(self) -> Optional[float]:
        """Seconds left in the budget (may be negative), or None when no
        deadline is armed -- the value the next hop's header carries."""
        if self._deadline is None:
            return None
        return self._deadline - time.monotonic()

    def deadline_expired(self) -> bool:
        return self._deadline is not None and time.monotonic() >= self._deadline


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

    def map(self, fn: Callable[[T], U]) -> "Context[U]":
        """Transform the payload while preserving id/context/metadata."""
        return Context(data=fn(self.data), ctx=self.ctx, metadata=self.metadata)

    def replace(self, data: U) -> "Context[U]":
        return Context(data=data, ctx=self.ctx, metadata=self.metadata)

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


class EngineFn(Generic[T, U]):
    """Adapt a plain ``async def fn(request) -> async iterator`` into an engine."""

    def __init__(
        self, fn: Callable[[Context[T]], Awaitable[AsyncIterator[U]]]
    ) -> None:
        self._fn = fn

    async def generate(self, request: Context[T]) -> AsyncIterator[U]:
        return await self._fn(request)


def ensure_response_stream(
    ctx: AsyncEngineContext, out: AsyncIterator[U]
) -> ResponseStream[U]:
    """Normalize an engine's output into a ResponseStream (idempotent)."""
    if isinstance(out, ResponseStream):
        return out
    return ResponseStream(ctx, out)


async def as_response_stream(
    engine: AsyncEngine[T, U], request: Context[T]
) -> ResponseStream[U]:
    """Invoke an engine and normalize its output into a ResponseStream."""
    return ensure_response_stream(request.ctx, await engine.generate(request))


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

    @classmethod
    def from_annotation(cls, name: str, value: Any) -> "Annotated[Any]":
        import json

        return cls(event=name, comment=[json.dumps(value)])

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
