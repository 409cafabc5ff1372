"""Compile-event sentry: every CUDA graph capture, counted per entry.

The counterpart of the JAX package's ``runtime/compile_sentry.py``, which
counts XLA backend compilations per engine entry point.  This package has
no compiler in its serving path; what it mints per new shape is a CUDA
graph (``engine/graphs.py``), so the event here is **each CUDA graph
capture** (``StepGraphs._capture``), attributed to the graph's kind
(``packed``, ``step``) and counted against a per-kind budget declared
beside the graphs (``graphs.GRAPH_BUDGET``).  The kernel extensions'
``nvcc`` builds (``ops/build.py``) count under an entry of their own,
``kernel_build``, with no budget.  Armed with ``DYN_COMPILE_SENTRY=1``, an
entry that captures more graphs than its budget raises
``CompileBudgetError`` at the moment of the overrun, so a shape that
escaped the key space fails a test instead of silently filling the card
with graphs.

The module API is the JAX module's: ``entry``/``set_entry``/
``current_entry`` label the events of a thread, ``register_budgets``,
``counts``/``total``/``reset``, ``note_compilation``, ``armed``/``arm``;
every event also feeds the ``dynamo_compile_events_total{entry}`` counter
and :meth:`TickProfiler.note_compile_event`.  There is no listener to
install: the event sources call :func:`note_compilation` themselves.

Overhead discipline: disarmed, the budget check is one module-global bool;
counting and the counter stay live either way.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
from typing import Dict, Iterator, Mapping, Optional

logger = logging.getLogger("dynamo.compile_sentry")

ENV_VAR = "DYN_COMPILE_SENTRY"

_ARMED = os.environ.get(ENV_VAR, "").strip().lower() not in (
    "", "0", "false", "no", "off",
)

#: label used when an event fires outside any ``entry(...)`` scope
UNATTRIBUTED = "unattributed"

#: the entry the kernel extensions' nvcc builds count under (no budget)
KERNEL_BUILD = "kernel_build"


class CompileBudgetError(AssertionError):
    """An entry captured more graphs than its declared budget."""


def armed() -> bool:
    return _ARMED


def arm(on: bool = True) -> bool:
    """Flip the sentry (tests).  Returns the previous state."""
    global _ARMED
    prev = _ARMED
    _ARMED = bool(on)
    return prev


# ---------------------------------------------------------------------------
# entry attribution + counts

_tls = threading.local()

_lock = threading.Lock()
_counts: Dict[str, int] = {}
_budgets: Dict[str, int] = {}

# lazy per-registry counter
_counter = None
_counter_reg = None


def _metric():
    global _counter, _counter_reg
    from . import metrics as rtm

    reg = rtm.default_registry()
    if _counter is None or _counter_reg is not reg:
        _counter = reg.counter(
            "dynamo_compile_events_total",
            "CUDA graph captures (and kernel builds) attributed to the "
            "entry whose dispatch triggered them",
            ("entry",),
        )
        _counter_reg = reg
    return _counter


@contextlib.contextmanager
def entry(name: str) -> Iterator[None]:
    """Attribute events on THIS thread to ``name`` for the scope.
    Nestable; the innermost label wins."""
    prev = getattr(_tls, "entry", None)
    _tls.entry = name
    try:
        yield
    finally:
        _tls.entry = prev


def set_entry(name: Optional[str]) -> None:
    """Sticky thread-local label: holds until the next set on the same
    thread."""
    _tls.entry = name


def current_entry() -> Optional[str]:
    return getattr(_tls, "entry", None)


def register_budgets(budgets: Mapping[str, int]) -> None:
    """Merge per-entry budgets (``engine/graphs.py`` registers its
    ``GRAPH_BUDGET`` at import).  Budgets are ceilings on TOTAL events per
    entry within this process; only registered entries are enforced, so
    ad-hoc entries count and export but never raise."""
    with _lock:
        for name, limit in budgets.items():
            _budgets[name] = int(limit)


def budgets() -> Dict[str, int]:
    with _lock:
        return dict(_budgets)


def counts() -> Dict[str, int]:
    """Snapshot of per-entry event counts."""
    with _lock:
        return dict(_counts)


def total() -> int:
    with _lock:
        return sum(_counts.values())


def reset() -> None:
    """Zero the per-entry counts (the prometheus counter, monotonic by
    contract, is left alone)."""
    with _lock:
        _counts.clear()


def note_compilation(entry_name: Optional[str] = None) -> None:
    """Record one event.  When armed and the entry has a registered
    budget, an overrun raises immediately, on the thread that did it."""
    name = entry_name or current_entry() or UNATTRIBUTED
    with _lock:
        _counts[name] = _counts.get(name, 0) + 1
        count = _counts[name]
        limit = _budgets.get(name)
    try:
        _metric().labels(name).inc()
    except Exception:  # metrics must never break the capture path
        logger.debug("compile-event metric emit failed", exc_info=True)
    try:
        from . import profiling

        profiling.profiler.note_compile_event(name)
    except Exception:
        logger.debug("compile-event profiler note failed", exc_info=True)
    if _ARMED and limit is not None and count > limit:
        raise CompileBudgetError(
            f"compile budget overrun: entry {name!r} captured {count} "
            f"graphs, budget {limit} (set {ENV_VAR}=0 to disarm; if the key "
            f"space legitimately grew, raise GRAPH_BUDGET in engine/graphs.py)"
        )
