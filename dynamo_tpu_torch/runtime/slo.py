"""Live SLO attainment plane: production TTFT/ITL/E2E against declared
targets.

The JAX package's ``runtime/slo.py``, on this package's registry:

* targets come from one env grammar::

      DYN_SLO=ttft=300ms,itl=40ms,e2e=30s[,window=60s]

  (kinds: ``ttft``, ``itl``, ``e2e``; units ``us``/``ms``/``s``, bare
  numbers are seconds; ``window`` sets the rolling attainment window);

* the HTTP frontend's :class:`~..http.metrics.InflightGuard` records each
  request's TTFT / per-token ITL / E2E against the targets, maintaining
  rolling-window attainment gauges ``dynamo_slo_attainment{kind}`` and
  violation counters ``dynamo_slo_violations{kind,cause}`` (causes:
  ``queue``, ``service``, ``deadline``, ``shed``);

* the engine decomposes each request's first token into queue-wait
  (arrival -> admission) vs service time (admission -> first commit) via
  :meth:`SloTracker.note_first_token`, so a TTFT miss is attributed to
  the *queue* (scale out / shed earlier) or to *service* (the engine is
  too slow) -- the distinction an autoscaler acts on;

* the flight recorder snapshots :meth:`recent_violations` at failure
  edges.

Overhead discipline: with no targets armed the tracker is disabled and
every site pays one attribute check (``if slo.tracker.enabled:``).
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

KINDS = ("ttft", "itl", "e2e")
CAUSES = ("queue", "service", "deadline", "shed")

_UNITS = {"us": 1e-6, "ms": 1e-3, "s": 1.0}


class SloSpecError(ValueError):
    """Malformed ``DYN_SLO`` spec (unknown kind, bad duration)."""


def _parse_duration(raw: str, key: str) -> float:
    raw = raw.strip()
    for suffix, scale in _UNITS.items():
        if raw.endswith(suffix) and raw != suffix:
            num = raw[: -len(suffix)]
            break
    else:
        num, scale = raw, 1.0
    try:
        val = float(num) * scale
    except ValueError as e:
        raise SloSpecError(f"bad duration {raw!r} for {key}") from e
    if val <= 0:
        raise SloSpecError(f"duration for {key} must be > 0, got {raw!r}")
    return val


def parse_slo_spec(spec: str) -> Tuple[Dict[str, float], Optional[float]]:
    """``"ttft=300ms,itl=40ms,e2e=30s,window=60s"`` ->
    ``({"ttft": 0.3, "itl": 0.04, "e2e": 30.0}, 60.0)``."""
    targets: Dict[str, float] = {}
    window: Optional[float] = None
    for clause in filter(None, (c.strip() for c in spec.split(","))):
        key, sep, raw = clause.partition("=")
        key = key.strip().lower()
        if not sep:
            raise SloSpecError(f"malformed clause {clause!r}")
        if key == "window":
            window = _parse_duration(raw, key)
        elif key in KINDS:
            targets[key] = _parse_duration(raw, key)
        else:
            raise SloSpecError(
                f"unknown SLO kind {key!r} (known: {', '.join(KINDS)})"
            )
    return targets, window


def attainment_of(values_s, target_s: float) -> Optional[float]:
    """Fraction of ``values_s`` meeting ``target_s`` (None when empty);
    the pure helper bench scenarios stamp per-bucket attainment with."""
    vals = list(values_s)
    if not vals:
        return None
    return sum(1 for v in vals if v <= target_s) / len(vals)


class SloTracker:
    """Rolling-window SLO attainment over declared targets.

    Thread model: recorded from frontend tasks and the engine loop; one
    lock guards the windows/splits (sub-microsecond critical sections,
    called per request / per stream chunk, never per device step)."""

    def __init__(
        self,
        targets: Optional[Dict[str, float]] = None,
        window_s: float = 60.0,
        split_capacity: int = 4096,
        violation_capacity: int = 256,
    ) -> None:
        self.targets: Dict[str, float] = dict(targets or {})
        self.window_s = window_s
        self.enabled = bool(self.targets)
        self._windows: Dict[str, "collections.deque"] = {
            k: collections.deque() for k in KINDS
        }
        # request_id -> (queue_s, service_s): the engine's first-token
        # decomposition, consumed when the frontend classifies a TTFT miss
        self._splits: "collections.OrderedDict[str, Tuple[float, float]]" = (
            collections.OrderedDict()
        )
        self._split_capacity = split_capacity
        self._violations: "collections.deque" = collections.deque(
            maxlen=violation_capacity
        )
        # cumulative (kind, cause) violation counts since arm time: the
        # in-process twin of the dynamo_slo_violations counter family,
        # readable without walking the prometheus exposition -- metric
        # sources (planner, telemetry snapshots) diff consecutive reads
        # to attribute fresh misses to queue vs service
        self._counts: Dict[Tuple[str, str], int] = {}
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls) -> "SloTracker":
        spec = os.environ.get("DYN_SLO", "")
        if not spec.strip():
            return cls()
        targets, window = parse_slo_spec(spec)
        return cls(targets, window_s=window or 60.0)

    def configure(
        self, spec: str, *, window_s: Optional[float] = None
    ) -> None:
        """Arm (or re-arm) from a ``DYN_SLO`` grammar string."""
        targets, window = parse_slo_spec(spec)
        with self._lock:
            self.targets = targets
            if window is not None:
                self.window_s = window
            elif window_s is not None:
                self.window_s = window_s
            for q in self._windows.values():
                q.clear()
            self._violations.clear()
            self._counts.clear()
        self.enabled = bool(targets)
        if self.enabled:
            reg = self._reg()
            gauge = reg.gauge(
                "dynamo_slo_target_seconds",
                "Declared SLO target per kind (DYN_SLO grammar)",
                ["kind"],
            )
            for kind, target in targets.items():
                gauge.labels(kind).set(target)

    def disable(self) -> None:
        self.enabled = False
        with self._lock:
            self.targets = {}
            for q in self._windows.values():
                q.clear()
            self._splits.clear()
            self._violations.clear()
            self._counts.clear()

    # -- engine-side decomposition -----------------------------------------

    def note_first_token(
        self, request_id: str, queue_s: float, service_s: float
    ) -> None:
        """The engine's first-token stamp decomposition for one request:
        queue-wait (arrival -> admission) vs service (admission -> first
        token commit).  Consulted when the frontend classifies a TTFT
        miss; evicted FIFO past capacity."""
        with self._lock:
            self._splits[request_id] = (max(queue_s, 0.0), max(service_s, 0.0))
            while len(self._splits) > self._split_capacity:
                self._splits.popitem(last=False)

    def split(self, request_id: str) -> Optional[Tuple[float, float]]:
        with self._lock:
            return self._splits.get(request_id)

    # -- frontend recording -------------------------------------------------

    def record_ttft(self, request_id: str, seconds: float) -> None:
        target = self.targets.get("ttft")
        if target is None:
            return
        ok = seconds <= target
        self._push("ttft", ok)
        if not ok:
            split = self.split(request_id)
            cause = (
                "queue"
                if split is not None and split[0] >= split[1]
                else "service"
            )
            self._violation("ttft", cause, request_id, seconds)

    def record_itl(self, seconds: float) -> None:
        target = self.targets.get("itl")
        if target is None:
            return
        ok = seconds <= target
        self._push("itl", ok)
        if not ok:
            self._violation("itl", "service", "", seconds)

    def record_e2e(self, request_id: str, seconds: float) -> None:
        target = self.targets.get("e2e")
        if target is None:
            return
        ok = seconds <= target
        self._push("e2e", ok)
        if not ok:
            self._violation("e2e", "service", request_id, seconds)

    def record_deadline(self, request_id: str, seconds: float = 0.0) -> None:
        """A request's deadline budget expired (HTTP 504): an E2E miss
        with an unambiguous cause, counted even with no e2e target set."""
        if "e2e" in self.targets:
            self._push("e2e", False)
        self._violation("e2e", "deadline", request_id, seconds)

    def record_shed(self, request_id: str = "") -> None:
        """Admission control rejected the request before any work: the
        request's SLO is missed by definition of never running."""
        if "e2e" in self.targets:
            self._push("e2e", False)
        self._violation("e2e", "shed", request_id, 0.0)

    # -- read side ----------------------------------------------------------

    def attainment(self, kind: str) -> Optional[float]:
        """Rolling-window attainment for ``kind`` (None = no samples)."""
        with self._lock:
            q = self._windows[kind]
            self._evict(q)
            if not q:
                return None
            return sum(1 for _, ok in q if ok) / len(q)

    def refresh_gauges(self) -> None:
        """Re-derive every attainment gauge from the current window.

        ``_push`` only updates a gauge on new samples, so after traffic
        drains the last value would otherwise export forever -- an idle
        instance stuck reporting an incident-era 0.2 keeps phantom SLO
        pressure on the planner.  Read paths (``/metrics``,
        ``registry_metrics_source``) call this; an aged-out window reads
        as fully attained, matching the no-samples default consumers
        apply."""
        if not self.enabled:
            return
        gauge = self._reg().gauge(
            "dynamo_slo_attainment",
            "Rolling-window SLO attainment (fraction of requests meeting "
            "the DYN_SLO target) per kind",
            ["kind"],
        )
        for kind in self.targets:
            with self._lock:
                q = self._windows[kind]
                self._evict(q)
                att = (
                    sum(1 for _, ok in q if ok) / len(q) if q else 1.0
                )
            gauge.labels(kind).set(att)

    def recent_violations(self, last: int = 64) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._violations)[-last:]

    def violation_count(self, kind: str, cause: str) -> int:
        """Cumulative violations of ``kind`` attributed to ``cause`` since
        arm time (the readable twin of ``dynamo_slo_violations``)."""
        with self._lock:
            return self._counts.get((kind, cause), 0)

    # -- internals ----------------------------------------------------------

    def _evict(self, q: "collections.deque") -> None:
        horizon = time.monotonic() - self.window_s
        while q and q[0][0] < horizon:
            q.popleft()

    def _push(self, kind: str, ok: bool) -> None:
        with self._lock:
            q = self._windows[kind]
            q.append((time.monotonic(), ok))
            self._evict(q)
            att = sum(1 for _, o in q if o) / len(q)
        self._reg().gauge(
            "dynamo_slo_attainment",
            "Rolling-window SLO attainment (fraction of requests meeting "
            "the DYN_SLO target) per kind",
            ["kind"],
        ).labels(kind).set(att)

    def _violation(
        self, kind: str, cause: str, request_id: str, seconds: float
    ) -> None:
        with self._lock:
            self._violations.append(
                {
                    "ts": time.time(),
                    "kind": kind,
                    "cause": cause,
                    "request_id": request_id,
                    # the request id IS the trace id -- carried explicitly
                    # so a violation row is one hop from GET /trace/{id}
                    "trace_id": request_id or None,
                    "trace": f"/trace/{request_id}" if request_id else None,
                    "value_s": round(seconds, 6),
                }
            )
            self._counts[(kind, cause)] = (
                self._counts.get((kind, cause), 0) + 1
            )
        self._reg().counter(
            "dynamo_slo_violations",
            "SLO violations by kind and cause (queue = waited too long "
            "for admission, service = the engine was too slow, deadline = "
            "budget expired, shed = rejected by admission control)",
            ["kind", "cause"],
        ).labels(kind, cause).inc()

    @staticmethod
    def _reg():
        # lazy: respects metrics.set_default (test registries)
        from . import metrics as rtm

        return rtm.default_registry()


tracker = SloTracker.from_env()
