"""Worker-side fleet telemetry: compact periodic snapshots over the hub.

A copy of the JAX package's ``runtime/telemetry.py`` (which loads no JAX),
over the port's package-free metrics registry.  Each worker periodically
publishes a :class:`TelemetrySnapshot` -- worker id, role, the registry's
cumulative counters (the receiver computes deltas), KV pressure, queue
depth, SLO attainment, and recent KV-transfer observations -- on the hub
event subject ``{ns}.events.fleet_telemetry``.  The wire bytes equal the
JAX package's, so a fleet observatory of either package reads the
snapshots of both packages' workers.

Design points:

* **Cumulative, not delta, counters on the wire.**  A lost snapshot then
  costs one sampling interval of resolution, never silent drift: the
  observatory diffs consecutive cumulative values and a gap simply
  stretches the interval.
* **The publisher never blocks the hot loop.**  It samples the registry on
  its own timer task (the ``KvEventPublisher`` queue+pump discipline);
  registry reads are lock-cheap gauge walks.
* **Transfer observations ride the snapshot.**  Delivery paths (the disagg
  prefill worker, the G4 tier, the mocker's synthetic link) note each
  transfer into a :class:`TransferLog` (src/dst worker ids, bytes,
  seconds); the publisher drains the log into the next snapshot, so the
  observatory's per-(src, dst) link model sees real samples without a
  second event stream.
* **Restart detection is first-class.**  ``started_ts`` stamps the
  publisher's birth; a changed value under the same worker id tells the
  observatory to reset that worker's rings and link-model edges instead
  of diffing counters across a process boundary.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import json
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("dynamo.telemetry")

TELEMETRY_TOPIC = "fleet_telemetry"

# snapshot schema version: the observatory ignores majors it does not speak
SCHEMA = 1


class TransferLog:
    """Bounded ring of KV-transfer observations awaiting publication.

    ``note()`` is called from delivery paths (disagg upload completion,
    the mocker's synthetic link); ``drain()`` is called by the telemetry
    publisher.  Thread-safe: deliveries may complete on executor threads.
    """

    def __init__(self, capacity: int = 1024) -> None:
        self._ring: "collections.deque" = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def note(
        self, src: int, dst: int, nbytes: int, seconds: float
    ) -> None:
        if nbytes <= 0 or seconds < 0:
            return
        with self._lock:
            self._ring.append(
                {
                    "src": int(src),
                    "dst": int(dst),
                    "bytes": int(nbytes),
                    "seconds": round(float(seconds), 9),
                }
            )

    def drain(self) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


# Process-wide log: production topology runs one worker per process, so
# delivery sites (disagg) note here without plumbing a handle.  In-process
# fleets (mocker tests) give each engine its own TransferLog instead.
transfers = TransferLog()


def note_transfer(src: int, dst: int, nbytes: int, seconds: float) -> None:
    transfers.note(src, dst, nbytes, seconds)


@dataclass
class TelemetrySnapshot:
    """One worker's periodic state report (wire form: compact JSON)."""

    worker_id: int
    role: str  # "prefill" | "decode" | "frontend" | ...
    seq: int
    ts: float
    started_ts: float
    # cumulative counters (receiver diffs consecutive snapshots)
    tokens_generated: float = 0.0
    step_count: float = 0.0
    step_seconds: float = 0.0
    prefix_hit_tokens: float = 0.0
    prefix_lookup_tokens: float = 0.0
    # instantaneous gauges
    kv_pages_used: int = 0
    kv_pages_total: int = 0
    kv_utilization: float = 0.0
    queue_depth: int = 0
    batch_occupancy: int = 0
    batch_slots: int = 0
    # SLO attainment by kind (absent kind = tracker disarmed / no samples)
    slo: Dict[str, float] = field(default_factory=dict)
    # cumulative SLO violation counts keyed "kind/cause" (the in-process
    # SloTracker.violation_count values) -- the observatory forwards the
    # TTFT queue/service pair into ForwardPassMetrics so an off-worker
    # planner can attribute misses exactly like a colocated one
    slo_violations: Dict[str, float] = field(default_factory=dict)
    # KV-transfer observations since the previous snapshot
    transfers: List[Dict[str, Any]] = field(default_factory=list)
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "v": SCHEMA,
            "worker_id": self.worker_id,
            "role": self.role,
            "seq": self.seq,
            "ts": round(self.ts, 6),
            "started_ts": round(self.started_ts, 6),
            "tokens_generated": self.tokens_generated,
            "step_count": self.step_count,
            "step_seconds": round(self.step_seconds, 9),
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_lookup_tokens": self.prefix_lookup_tokens,
            "kv_pages_used": self.kv_pages_used,
            "kv_pages_total": self.kv_pages_total,
            "kv_utilization": round(self.kv_utilization, 6),
            "queue_depth": self.queue_depth,
            "batch_occupancy": self.batch_occupancy,
            "batch_slots": self.batch_slots,
            "slo": {k: round(v, 6) for k, v in self.slo.items()},
            "slo_violations": dict(self.slo_violations),
            "transfers": list(self.transfers),
            "extra": dict(self.extra),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TelemetrySnapshot":
        known = {
            "worker_id": int(d["worker_id"]),
            "role": str(d.get("role", "")),
            "seq": int(d.get("seq", 0)),
            "ts": float(d.get("ts", 0.0)),
            "started_ts": float(d.get("started_ts", 0.0)),
            "tokens_generated": float(d.get("tokens_generated", 0.0)),
            "step_count": float(d.get("step_count", 0.0)),
            "step_seconds": float(d.get("step_seconds", 0.0)),
            "prefix_hit_tokens": float(d.get("prefix_hit_tokens", 0.0)),
            "prefix_lookup_tokens": float(
                d.get("prefix_lookup_tokens", 0.0)
            ),
            "kv_pages_used": int(d.get("kv_pages_used", 0)),
            "kv_pages_total": int(d.get("kv_pages_total", 0)),
            "kv_utilization": float(d.get("kv_utilization", 0.0)),
            "queue_depth": int(d.get("queue_depth", 0)),
            "batch_occupancy": int(d.get("batch_occupancy", 0)),
            "batch_slots": int(d.get("batch_slots", 0)),
            "slo": {
                str(k): float(v) for k, v in (d.get("slo") or {}).items()
            },
            "slo_violations": {
                str(k): float(v)
                for k, v in (d.get("slo_violations") or {}).items()
            },
            "transfers": list(d.get("transfers") or []),
            "extra": dict(d.get("extra") or {}),
        }
        return cls(**known)

    def encode(self) -> bytes:
        return json.dumps(self.to_dict(), separators=(",", ":")).encode()

    @classmethod
    def decode(cls, blob: bytes) -> "TelemetrySnapshot":
        return cls.from_dict(json.loads(blob))


def snapshot_from_registry(
    registry=None,
    *,
    worker_id: int,
    role: str,
    seq: int = 0,
    started_ts: float = 0.0,
    transfer_log: Optional[TransferLog] = None,
    refresh_slo: bool = True,
) -> TelemetrySnapshot:
    """Build a snapshot from the exact series ``/metrics`` exports
    (``dynamo_engine_*`` + ``dynamo_slo_attainment``) -- the fleet plane
    and local dashboards can never disagree about what the load was."""
    from . import metrics as rtm
    from . import slo as _slo

    reg = registry or rtm.default_registry()

    def val(name: str) -> float:
        return reg.sample(name) or 0.0

    if refresh_slo:
        _slo.tracker.refresh_gauges()
    slo_att: Dict[str, float] = {}
    for kind in _slo.KINDS:
        got = reg.sample("dynamo_slo_attainment", {"kind": kind})
        if got is not None:
            slo_att[kind] = got
    slo_viol: Dict[str, float] = {}
    if _slo.tracker.enabled:
        for kind in _slo.KINDS:
            for cause in _slo.CAUSES:
                n = _slo.tracker.violation_count(kind, cause)
                if n:
                    slo_viol[f"{kind}/{cause}"] = float(n)

    step_count, step_seconds = reg.histogram_totals(
        "dynamo_engine_step_latency_seconds"
    )
    log = transfer_log if transfer_log is not None else transfers
    return TelemetrySnapshot(
        worker_id=worker_id,
        role=role,
        seq=seq,
        ts=time.time(),
        started_ts=started_ts,
        tokens_generated=val("dynamo_engine_tokens_generated"),
        step_count=step_count,
        step_seconds=step_seconds,
        prefix_hit_tokens=val("dynamo_engine_prefix_hit_tokens"),
        prefix_lookup_tokens=val("dynamo_engine_prefix_lookup_tokens"),
        kv_pages_used=int(val("dynamo_engine_kv_pages_used")),
        kv_pages_total=int(val("dynamo_engine_kv_pages_total")),
        kv_utilization=val("dynamo_engine_kv_utilization"),
        queue_depth=int(val("dynamo_engine_prefill_queue_depth")),
        batch_occupancy=int(val("dynamo_engine_batch_occupancy")),
        batch_slots=int(val("dynamo_engine_batch_slots")),
        slo=slo_att,
        slo_violations=slo_viol,
        transfers=log.drain(),
    )


class TelemetryPublisher:
    """Periodic snapshot publisher: samples the registry on its own timer
    and ships each snapshot to the hub topic and/or an in-process sink.

    ``namespace`` is a :class:`~dynamo_tpu_torch.runtime.component.Namespace`
    (hub pub/sub); ``sink`` is a plain callable receiving the snapshot
    dict (colocated observatory, tests).  Either may be None; with both
    None :meth:`publish_once` still returns the snapshot, which is how
    pull-style integrations (bench probes) use it.
    """

    def __init__(
        self,
        namespace=None,
        *,
        worker_id: int,
        role: str,
        registry=None,
        interval_s: float = 1.0,
        transfer_log: Optional[TransferLog] = None,
        sink: Optional[Callable[[Dict[str, Any]], None]] = None,
    ) -> None:
        self.namespace = namespace
        self.worker_id = int(worker_id)
        self.role = role
        self.registry = registry
        self.interval_s = max(float(interval_s), 0.01)
        self.transfer_log = transfer_log
        self.sink = sink
        self.started_ts = time.time()
        self.seq = 0
        self._task: Optional[asyncio.Task] = None

    def collect(self) -> TelemetrySnapshot:
        self.seq += 1
        return snapshot_from_registry(
            self.registry,
            worker_id=self.worker_id,
            role=self.role,
            seq=self.seq,
            started_ts=self.started_ts,
            transfer_log=self.transfer_log,
        )

    async def publish_once(self) -> TelemetrySnapshot:
        snap = self.collect()
        payload = snap.to_dict()
        if self.sink is not None:
            try:
                self.sink(payload)
            except Exception:
                logger.exception("telemetry sink failed")
        if self.namespace is not None:
            await self.namespace.publish(TELEMETRY_TOPIC, payload)
        return snap

    async def _loop(self) -> None:
        while True:
            try:
                await self.publish_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                # a hub hiccup must not kill the worker's telemetry forever
                logger.exception("telemetry publish failed")
            await asyncio.sleep(self.interval_s)

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(
                self._loop(), name=f"telemetry-pub-{self.worker_id}"
            )

    async def stop(self, final: bool = True) -> None:
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._task
            self._task = None
        if final:
            # parting snapshot: the observatory sees the final counters
            # (and drained transfer log) instead of a truncated series
            with contextlib.suppress(Exception):
                await self.publish_once()
