"""Distributed request tracing: linked spans keyed by request id.

Parity target (SURVEY.md 5.1): the reference threads request ids through
every hop and hangs tracing/profiling off them (distributed_runtime
tracing features).  The request id already crosses the request plane in
every frame; this module adds the span layer on top of it:

* every span carries a ``trace_id`` / ``span_id`` / ``parent_span_id``
  triple, so the spans of one request form a tree even when they were
  recorded by different processes;
* the *trace context* (trace id + the currently-open span's id) propagates
  across hops inside request-plane frame headers
  (``transports/codec.encode_trace_context``) and is re-opened as the
  parent of the remote ingress span (``component._IngressHandler``);
* a per-process :class:`TraceCollector` keeps completed spans in a ring
  buffer with a per-request-id index (``get(request_id)`` is O(spans of
  that request), not O(ring)) and exports Chrome-trace/Perfetto JSON
  (``export`` / :func:`chrome_trace`).

Enable with ``DYN_TRACE=1`` (or ``collector.enable()``); a disabled span
costs one attribute check and adds **nothing** to wire frames.  Spans log
at DEBUG as they close; ``get(request_id)`` / ``dump()`` / ``export()``
feed tests, the ``GET /trace/{request_id}`` route, the per-component
``_trace`` scrape endpoint, and the ``trace`` CLI.
"""

from __future__ import annotations

import collections
import contextvars
import logging
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

logger = logging.getLogger("dynamo.trace")

# Monotonic->wall offset captured once at import: spans time themselves on
# the monotonic clock (durations immune to wall-clock steps) and exported
# dicts shift to wall-clock seconds so spans recorded by different
# processes land on one shared timeline.
_MONO_TO_WALL = time.time() - time.monotonic()


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass(frozen=True)
class TraceContext:
    """What propagates across a hop: the trace, and the parent span."""

    trace_id: str
    span_id: str

    def to_wire(self) -> Dict[str, str]:
        return {"tid": self.trace_id, "sid": self.span_id}

    @classmethod
    def from_wire(cls, d: Any) -> Optional["TraceContext"]:
        if not isinstance(d, dict) or not d.get("tid"):
            return None
        return cls(trace_id=str(d["tid"]), span_id=str(d.get("sid") or ""))


@dataclass
class Span:
    name: str
    request_id: str
    start_s: float  # time.monotonic()
    end_s: float = 0.0
    trace_id: str = ""
    span_id: str = ""
    parent_span_id: str = ""
    component: str = ""
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration_ms(self) -> float:
        return (self.end_s - self.start_s) * 1e3

    def to_dict(self) -> Dict[str, Any]:
        """Portable form: ``start_s`` is wall-clock so dicts from several
        processes assemble onto one timeline (the ``_trace`` scrape)."""
        out: Dict[str, Any] = {
            "name": self.name,
            "request_id": self.request_id,
            "start_s": round(self.start_s + _MONO_TO_WALL, 6),
            "duration_ms": round(self.duration_ms, 3),
        }
        if self.trace_id:
            out["trace_id"] = self.trace_id
            out["span_id"] = self.span_id
        if self.parent_span_id:
            out["parent_span_id"] = self.parent_span_id
        if self.component:
            out["component"] = self.component
        if self.attrs:
            out["attrs"] = self.attrs
        return out


class TraceCollector:
    """Ring buffer of completed spans plus a per-request-id index
    (thread-safe).  The index evicts in lockstep with the ring, so a
    ``/trace/{request_id}`` hit never scans all ``capacity`` spans."""

    def __init__(self, capacity: int = 4096, binding_capacity: int = 4096) -> None:
        self._spans: "collections.deque[Span]" = collections.deque()
        self._capacity = capacity
        # request_id -> that request's spans, in record order (FIFO like the
        # ring, so eviction always removes the list head)
        self._index: Dict[str, List[Span]] = {}
        # request_id -> the trace context engine-side spans should attach to
        # (executor threads have no ambient contextvar)
        self._bindings: "collections.OrderedDict[str, TraceContext]" = (
            collections.OrderedDict()
        )
        self._binding_capacity = binding_capacity
        self._lock = threading.Lock()
        self.enabled = os.environ.get("DYN_TRACE", "") not in ("", "0", "false")
        # default component tag stamped onto spans opened in this process
        # (set once at serve time, e.g. "dynamo/backend")
        self.component = ""

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def record(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) >= self._capacity:
                old = self._spans.popleft()
                lst = self._index.get(old.request_id)
                if lst:
                    lst.pop(0)
                    if not lst:
                        del self._index[old.request_id]
            self._spans.append(span)
            self._index.setdefault(span.request_id, []).append(span)
        logger.debug(
            "span %s [%s] %.2fms", span.name, span.request_id, span.duration_ms
        )

    def get(self, request_id: str) -> List[Span]:
        with self._lock:
            return list(self._index.get(request_id, ()))

    def dump(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [s.to_dict() for s in self._spans]

    def export(self, request_id: Optional[str] = None) -> Dict[str, Any]:
        """Chrome-trace/Perfetto JSON for one request (or everything)."""
        spans = self.get(request_id) if request_id else None
        if spans is not None:
            dicts = [s.to_dict() for s in spans]
        else:
            dicts = self.dump()
        return chrome_trace(dicts)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._index.clear()
            self._bindings.clear()

    # -- request-id -> trace-context bindings ------------------------------

    def bind(self, request_id: str, ctx: TraceContext) -> None:
        with self._lock:
            self._bindings[request_id] = ctx
            self._bindings.move_to_end(request_id)
            while len(self._bindings) > self._binding_capacity:
                self._bindings.popitem(last=False)

    def binding(self, request_id: str) -> Optional[TraceContext]:
        with self._lock:
            return self._bindings.get(request_id)


collector = TraceCollector()

# The currently-open span's context in this task tree; spans opened on
# executor threads fall back to the collector's request-id binding.
_current: "contextvars.ContextVar[Optional[TraceContext]]" = (
    contextvars.ContextVar("dyn_trace_ctx", default=None)
)


def current_context() -> Optional[TraceContext]:
    return _current.get()


def wire_context(request_id: str = "") -> Optional[Dict[str, str]]:
    """Header payload for an outgoing hop, or None (tracing disabled, or no
    active trace to continue).  The single call egress sites make -- one
    attribute check when tracing is off."""
    if not collector.enabled:
        return None
    ctx = _current.get()
    if ctx is None and request_id:
        ctx = collector.binding(request_id)
    return ctx.to_wire() if ctx is not None else None


class span:
    """``with span("prefill", request_id, tokens=128): ...`` -- no-op when
    tracing is disabled.  Also usable around ``async`` sections (the timing
    covers wall time, which is what serving spans want).

    Parent resolution, in order: the explicit ``parent`` TraceContext (a
    hop's decoded wire context), the task-local current span, the
    collector's request-id binding.  No parent at all roots a new trace.
    ``bind=True`` additionally binds the request id to this span's context,
    so spans opened later on other threads (the engine executor) link under
    it."""

    __slots__ = (
        "name", "request_id", "parent", "component", "bind", "attrs",
        "_span", "_token",
    )

    def __init__(
        self,
        name: str,
        request_id: str = "",
        parent: Optional[TraceContext] = None,
        component: Optional[str] = None,
        bind: bool = False,
        **attrs: Any,
    ) -> None:
        self.name = name
        self.request_id = request_id
        self.parent = parent
        self.component = component
        self.bind = bind
        self.attrs = attrs
        self._span: Optional[Span] = None
        self._token: Optional[contextvars.Token] = None

    def __enter__(self) -> "span":
        if not collector.enabled:
            return self
        parent = self.parent or _current.get()
        if parent is None and self.request_id:
            parent = collector.binding(self.request_id)
        trace_id = parent.trace_id if parent is not None else _new_id()
        span_id = _new_id()
        self._span = Span(
            name=self.name,
            request_id=self.request_id,
            start_s=time.monotonic(),
            trace_id=trace_id,
            span_id=span_id,
            parent_span_id=parent.span_id if parent is not None else "",
            component=(
                self.component if self.component is not None
                else collector.component
            ),
            attrs=self.attrs,
        )
        ctx = TraceContext(trace_id, span_id)
        self._token = _current.set(ctx)
        if self.bind and self.request_id:
            collector.bind(self.request_id, ctx)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            try:
                _current.reset(self._token)
            except ValueError:
                # manual enter/exit pairs may straddle task contexts (the
                # ingress span exits inside the response generator's task);
                # the var is task-local, so a failed reset leaks nothing
                pass
            self._token = None
        if self._span is not None:
            self._span.end_s = time.monotonic()
            if exc is not None:
                self._span.attrs["error"] = repr(exc)
            collector.record(self._span)
            self._span = None
        return False

    @property
    def context(self) -> Optional[TraceContext]:
        """The open span's context (None when tracing is disabled)."""
        if self._span is None:
            return None
        return TraceContext(self._span.trace_id, self._span.span_id)

    def set(self, **attrs: Any) -> None:
        if self._span is not None:
            self._span.attrs.update(attrs)


def chrome_trace(span_dicts: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Chrome-trace ("Trace Event Format") JSON object from span dicts
    (``Span.to_dict`` output, possibly merged from several processes).
    Loads in chrome://tracing and ui.perfetto.dev: one pid per component,
    complete ("X") events in wall-clock microseconds, span/parent ids in
    ``args`` so the tree survives the export."""
    pids: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    for d in span_dicts:
        comp = str(d.get("component") or "process")
        pid = pids.setdefault(comp, len(pids) + 1)
        args: Dict[str, Any] = {
            "request_id": d.get("request_id", ""),
            "trace_id": d.get("trace_id", ""),
            "span_id": d.get("span_id", ""),
            "parent_span_id": d.get("parent_span_id", ""),
        }
        args.update(d.get("attrs") or {})
        events.append(
            {
                "name": d.get("name", ""),
                "cat": "dynamo",
                "ph": "X",
                "ts": round(float(d.get("start_s", 0.0)) * 1e6, 3),
                "dur": round(
                    max(float(d.get("duration_ms", 0.0)), 0.0) * 1e3, 3
                ),
                "pid": pid,
                "tid": 1,
                "args": args,
            }
        )
    for comp, pid in pids.items():
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 1,
                "args": {"name": comp},
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}
