"""Pipeline graph: composable request/response processing stages.

The reference models pipelines as doubly-linked node graphs
(lib/runtime/src/pipeline/nodes.rs: Source/Sink/Operator/ServiceFrontend/
ServiceBackend with ``link()`` chaining).  In asyncio the same dataflow is
expressed directly: an :class:`Operator` transforms the request on the way
*forward* and the response stream on the way *backward*, and ``link`` folds a
chain of operators onto a terminal engine, producing one composed
:class:`~.engine.AsyncEngine`.

    frontend = link(OpenAIPreprocessor(...), Backend(...), push_router)
    stream = await frontend.generate(Context.new(request))

This keeps the reference's bidirectional-operator shape (preprocessor maps
OpenAI -> tokens forward and token deltas -> OpenAI chunks backward) without
the node/edge bookkeeping that tokio's ownership model required.
"""

from __future__ import annotations

from typing import AsyncIterator, Generic, TypeVar

from .engine import AsyncEngine, Context, as_response_stream, ensure_response_stream

In = TypeVar("In")
Out = TypeVar("Out")
RespIn = TypeVar("RespIn")
RespOut = TypeVar("RespOut")


class Operator(Generic[In, Out, RespIn, RespOut]):
    """A bidirectional pipeline stage.

    Subclasses implement :meth:`generate`, receiving the inbound request and
    the downstream engine (``next``), and returning the outbound response
    stream.  Reference: the Operator trait in pipeline/nodes.rs; e.g.
    OpenAIPreprocessor (preprocessor.rs:64) is an operator from OpenAI requests
    to token requests.
    """

    async def generate(
        self, request: Context[In], next: AsyncEngine[Out, RespIn]
    ) -> AsyncIterator[RespOut]:
        raise NotImplementedError


class _Linked(Generic[In, RespOut]):
    """An Operator bound to its downstream engine: itself an AsyncEngine."""

    def __init__(self, op: Operator, next: AsyncEngine) -> None:
        self._op = op
        self._next = next

    async def generate(self, request: Context) -> AsyncIterator:
        return ensure_response_stream(
            request.ctx, await self._op.generate(request, self._next)
        )


def link(*stages) -> AsyncEngine:
    """Fold ``(op1, op2, ..., terminal_engine)`` into one engine.

    The last element must be an AsyncEngine (has ``generate(request)``); all
    preceding elements must be Operators.
    """
    if not stages:
        raise ValueError("link() requires at least a terminal engine")
    engine = stages[-1]
    if isinstance(engine, Operator):
        raise TypeError("last stage of link() must be a terminal AsyncEngine")
    for op in reversed(stages[:-1]):
        if not isinstance(op, Operator):
            raise TypeError(f"intermediate stage {op!r} must be an Operator")
        engine = _Linked(op, engine)
    return engine


class MapOperator(Operator[In, Out, RespIn, RespOut]):
    """Operator from two plain functions: request map + response map."""

    def __init__(self, fwd, bwd) -> None:
        self._fwd = fwd
        self._bwd = bwd

    async def generate(self, request: Context, next: AsyncEngine):
        mapped = request.map(self._fwd)
        stream = await as_response_stream(next, mapped)

        async def gen():
            async for item in stream:
                yield self._bwd(item)

        return gen()
