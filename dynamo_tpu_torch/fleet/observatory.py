"""Front-end fleet observatory.

A copy of the JAX package's ``fleet/observatory.py`` over the port's
package-free metrics registry.  The inbound half of the fleet telemetry
plane (the outbound half is ``runtime/telemetry.py``): ingest every
worker's periodic
:class:`~dynamo_tpu_torch.runtime.telemetry.TelemetrySnapshot` into
per-worker time-series rings with downsampled retention, and derive from
them

* **cluster gauges** -- ``dynamo_fleet_*``: aggregate tok/s, KV pressure,
  queue depth, and SLO attainment, broken down by worker role;
* **a learned KV-transfer cost model** -- per-(src, dst) link fit of
  ``seconds = setup + nbytes / bandwidth`` over the observed transfer
  samples (disagg deliveries, G4 puts and fetches, the mocker's synthetic
  link), exposed as :meth:`FleetObservatory.predict_transfer_ms`: the KV
  router's fetch-versus-recompute gate prices a donor with it;
* **straggler detection** -- per-worker step-latency robust z-score
  against the fleet median; detected stragglers raise the
  ``dynamo_fleet_stragglers`` gauge, enter a quarantine the KV router
  places no new request into, and trigger a flight-recorder snapshot so
  the incident window is captured at detection time.

The observatory is transport-agnostic: :meth:`FleetObservatory.ingest`
takes a snapshot dict from anywhere (hub subscription via
:meth:`start`, an in-process publisher ``sink``, tests).  All analysis
is recomputed from the rings on ingest, so a worker that restarts
(``started_ts`` changes) or leaves (goes stale) resets cleanly instead
of poisoning deltas and link fits with cross-incarnation data.  The
snapshots are the JAX package's wire form, so it reads both packages'
workers; :meth:`FleetObservatory.render` gives the bytes the JAX
observatory's ``prometheus_client`` exposition gives for the same state.
"""

from __future__ import annotations

import collections
import logging
import statistics
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..protocols.common import ForwardPassMetrics
from ..runtime import metrics as rtm
from ..runtime.telemetry import TELEMETRY_TOPIC, TelemetrySnapshot

logger = logging.getLogger("dynamo.fleet")


class SeriesRing:
    """Two-resolution time series: a raw ring of recent ``(ts, value)``
    points plus a coarse ring of bucket-averaged history.

    Appends past ``raw_capacity`` fold the oldest ``bucket`` raw points
    into one averaged coarse point, so retention degrades gracefully --
    recent data stays sample-accurate, old data survives downsampled
    instead of vanishing, and memory stays bounded at
    ``raw_capacity + coarse_capacity`` points per series.
    """

    def __init__(
        self,
        raw_capacity: int = 256,
        coarse_capacity: int = 256,
        bucket: int = 8,
    ) -> None:
        if raw_capacity < 1 or bucket < 1:
            raise ValueError("raw_capacity and bucket must be >= 1")
        self.raw_capacity = raw_capacity
        self.bucket = bucket
        self._raw: "collections.deque" = collections.deque()
        self._coarse: "collections.deque" = collections.deque(
            maxlen=coarse_capacity
        )

    def append(self, ts: float, value: float) -> None:
        self._raw.append((float(ts), float(value)))
        while len(self._raw) > self.raw_capacity:
            n = min(self.bucket, len(self._raw) - 1)
            chunk = [self._raw.popleft() for _ in range(n)]
            self._coarse.append(
                (
                    sum(t for t, _ in chunk) / n,
                    sum(v for _, v in chunk) / n,
                )
            )

    def recent(self, n: int) -> List[float]:
        """Latest ``n`` raw values, oldest first."""
        if n <= 0:
            return []
        return [v for _, v in list(self._raw)[-n:]]

    def last(self) -> Optional[float]:
        return self._raw[-1][1] if self._raw else None

    def points(self) -> List[Tuple[float, float]]:
        """Full retained series, coarse history first, oldest first."""
        return list(self._coarse) + list(self._raw)

    @property
    def raw_len(self) -> int:
        return len(self._raw)

    @property
    def coarse_len(self) -> int:
        return len(self._coarse)

    def __len__(self) -> int:
        return len(self._raw) + len(self._coarse)

    def clear(self) -> None:
        self._raw.clear()
        self._coarse.clear()

    def carry_average(self) -> Optional[float]:
        """Average of the freshest bucket's worth of raw points (falling
        back to the newest coarse point) -- the value a consumer should
        assume while a just-reset ring refills (satellite: a restarting
        worker must not read as idle)."""
        vals = self.recent(self.bucket)
        if vals:
            return sum(vals) / len(vals)
        if self._coarse:
            return self._coarse[-1][1]
        return None


class LinkModel:
    """Online fit of one (src, dst) KV-transfer link:
    ``seconds = setup + nbytes / bandwidth``.

    Exponentially-decayed least squares over (nbytes, seconds) samples --
    the decayed sufficient statistics make it an EWMA that still separates
    the per-byte slope (1/bandwidth) from the per-transfer intercept
    (setup), which a plain seconds/byte EWMA cannot do.  With no size
    spread yet (all transfers equal), the slope degenerates; we fall back
    to a through-origin fit so early predictions are usable immediately.
    """

    def __init__(self, decay: float = 0.97) -> None:
        if not 0.0 < decay <= 1.0:
            raise ValueError("decay must be in (0, 1]")
        self.decay = decay
        self.samples = 0
        # decayed sufficient statistics for least squares on (n, t)
        self._w = 0.0  # sum of weights
        self._sn = 0.0  # sum n
        self._st = 0.0  # sum t
        self._snn = 0.0  # sum n*n
        self._snt = 0.0  # sum n*t

    def observe(self, nbytes: int, seconds: float) -> None:
        if nbytes <= 0 or seconds <= 0:
            return
        n = float(nbytes)
        t = float(seconds)
        d = self.decay
        self._w = self._w * d + 1.0
        self._sn = self._sn * d + n
        self._st = self._st * d + t
        self._snn = self._snn * d + n * n
        self._snt = self._snt * d + n * t
        self.samples += 1

    def _fit(self) -> Optional[Tuple[float, float]]:
        """(slope s/byte, setup s), or None before any sample."""
        if self._w <= 0.0:
            return None
        var = self._snn - self._sn * self._sn / self._w
        if var > 1e-9 * max(self._snn, 1.0):
            slope = (self._snt - self._sn * self._st / self._w) / var
            setup = (self._st - slope * self._sn) / self._w
            if slope > 0.0:
                return slope, max(setup, 0.0)
        # degenerate size spread (or negative slope from noise):
        # through-origin fit, all latency attributed to bandwidth
        if self._snn > 0.0:
            return self._snt / self._snn, 0.0
        return None

    @property
    def bandwidth_bytes_per_s(self) -> Optional[float]:
        fit = self._fit()
        if fit is None or fit[0] <= 0.0:
            return None
        return 1.0 / fit[0]

    @property
    def setup_s(self) -> Optional[float]:
        fit = self._fit()
        return None if fit is None else fit[1]

    def predict_s(self, nbytes: int) -> Optional[float]:
        fit = self._fit()
        if fit is None:
            return None
        slope, setup = fit
        return setup + slope * max(int(nbytes), 0)


class FleetMetrics:
    """The ``dynamo_fleet_*`` family set (minted via the registry facade).
    Refreshed by the observatory on every read path, not on
    ingest, so gauge churn scales with scrape rate rather than fleet
    size x publish rate."""

    def __init__(self, registry: Optional[rtm.MetricsRegistry] = None) -> None:
        reg = registry or rtm.default_registry()
        self.registry = reg
        self.workers = reg.gauge(
            "dynamo_fleet_workers",
            "Live (non-stale) workers known to the fleet observatory",
            ["role"],
        )
        self.tokens_per_s = reg.gauge(
            "dynamo_fleet_tokens_per_s",
            "Aggregate output token throughput across live workers",
            ["role"],
        )
        self.kv_pressure = reg.gauge(
            "dynamo_fleet_kv_pressure",
            "Fleet KV pressure: total pages used / total pages (0..1)",
        )
        self.queue_depth = reg.gauge(
            "dynamo_fleet_queue_depth",
            "Requests waiting for admission, summed across live workers",
        )
        self.slo_attainment = reg.gauge(
            "dynamo_fleet_slo_attainment",
            "Worst per-worker SLO attainment across the live fleet",
            ["kind"],
        )
        self.stragglers = reg.gauge(
            "dynamo_fleet_stragglers",
            "Workers currently flagged as step-latency stragglers",
        )
        self.quarantined = reg.gauge(
            "dynamo_fleet_quarantined",
            "Workers quarantined from new placements until their step "
            "series recovers K consecutive windows",
        )
        self.link_bandwidth = reg.gauge(
            "dynamo_fleet_link_bandwidth_bytes_per_s",
            "Learned KV-transfer link bandwidth per (src, dst) worker pair",
            ["src", "dst"],
        )
        self.link_setup_ms = reg.gauge(
            "dynamo_fleet_link_setup_ms",
            "Learned KV-transfer per-transfer setup latency per link",
            ["src", "dst"],
        )
        self.snapshots = reg.counter(
            "dynamo_fleet_snapshots",
            "Telemetry snapshots ingested by the observatory",
        )


class _WorkerState:
    __slots__ = (
        "worker_id", "role", "started_ts", "seq", "first_ts", "last_ts",
        "prev", "latest", "tok_s", "step_ms", "kv_util", "queue",
        "restarts", "carry",
    )

    def __init__(self, snap: TelemetrySnapshot, ring_kw: Dict[str, int]):
        self.worker_id = snap.worker_id
        self.restarts = 0
        self.carry: Dict[str, float] = {}
        self._reset(snap, ring_kw)

    def _reset(self, snap: TelemetrySnapshot, ring_kw: Dict[str, int]) -> None:
        # restart: stash the dying incarnation's last coarse-bucket
        # averages before dropping the rings, so planner-facing reads can
        # keep reporting the last known load until the fresh rings hold
        # enough samples to trust -- a just-reset ring otherwise reads as
        # "idle" and triggers a spurious scale-down
        old = getattr(self, "kv_util", None)
        if old is not None:
            prev_snap = self.latest
            kv_carry = self.kv_util.carry_average()
            q_carry = self.queue.carry_average()
            self.carry = {
                "kv_utilization": (
                    prev_snap.kv_utilization if kv_carry is None else kv_carry
                ),
                "queue_depth": (
                    float(prev_snap.queue_depth)
                    if q_carry is None else q_carry
                ),
                "kv_pages_used": float(prev_snap.kv_pages_used),
                "kv_pages_total": float(prev_snap.kv_pages_total),
                "batch_occupancy": float(prev_snap.batch_occupancy),
                "batch_slots": float(prev_snap.batch_slots),
            }
        self.role = snap.role
        self.started_ts = snap.started_ts
        self.seq = snap.seq
        self.first_ts = snap.ts
        self.last_ts = snap.ts
        self.prev: Optional[TelemetrySnapshot] = None
        self.latest = snap
        self.tok_s = SeriesRing(**ring_kw)
        self.step_ms = SeriesRing(**ring_kw)
        self.kv_util = SeriesRing(**ring_kw)
        self.queue = SeriesRing(**ring_kw)


class FleetObservatory:
    """Cluster-global telemetry: per-worker rings, fleet gauges, the
    learned link model, and straggler detection.

    Thread-safe on ingest/read (hub pump task vs HTTP handlers vs planner
    polls).  ``registry`` defaults to the process registry so the fleet
    gauges ride the frontend's normal ``/metrics`` exposition too.
    """

    def __init__(
        self,
        registry: Optional[rtm.MetricsRegistry] = None,
        *,
        stale_after_s: float = 10.0,
        straggler_z: float = 4.0,
        straggler_min_ratio: float = 1.5,
        straggler_min_workers: int = 3,
        straggler_window: int = 8,
        quarantine_recovery_windows: int = 5,
        link_decay: float = 0.97,
        ring_raw_capacity: int = 256,
        ring_coarse_capacity: int = 256,
        ring_bucket: int = 8,
    ) -> None:
        self.metrics = FleetMetrics(registry)
        self.stale_after_s = float(stale_after_s)
        self.straggler_z = float(straggler_z)
        self.straggler_min_ratio = float(straggler_min_ratio)
        self.straggler_min_workers = int(straggler_min_workers)
        self.straggler_window = int(straggler_window)
        self.quarantine_recovery_windows = int(quarantine_recovery_windows)
        self.link_decay = float(link_decay)
        self._ring_kw = {
            "raw_capacity": ring_raw_capacity,
            "coarse_capacity": ring_coarse_capacity,
            "bucket": ring_bucket,
        }
        self._workers: Dict[int, _WorkerState] = {}
        self._links: Dict[Tuple[int, int], LinkModel] = {}
        self._stragglers: set = set()
        # quarantine ledger: wid -> {"streak": healthy windows in a row,
        # "seq": last snapshot seq that advanced the streak}.  Entered on
        # straggler detection; exits after quarantine_recovery_windows
        # consecutive non-flagged snapshots.  Survives the worker's own
        # restart (a kill-restart loop must re-earn trust), cleared only
        # by recovery or the worker leaving the fleet entirely.
        self._quarantined: Dict[int, Dict[str, int]] = {}
        # planner's last adjustment per pool kind (note_adjustment /
        # snapshots' extra["plan"]) -- the `dynamo-tpu fleet --plan` column
        self._plan: Dict[str, Dict[str, Any]] = {}
        # label values written to each labeled fleet gauge, so rows whose
        # label vanished (last worker of a role leaving) get zeroed on the
        # next refresh instead of exposing their final value forever
        self._seen_roles: set = set()
        self._seen_tok_roles: set = set()
        self._seen_slo_kinds: set = set()
        self._seen_links: set = set()
        self._lock = threading.Lock()
        self._task = None
        self._sub = None

    # -- ingest ---------------------------------------------------------------

    def ingest(self, snapshot: Any) -> None:
        """Feed one worker snapshot (dict or TelemetrySnapshot)."""
        snap = (
            snapshot
            if isinstance(snapshot, TelemetrySnapshot)
            else TelemetrySnapshot.from_dict(snapshot)
        )
        with self._lock:
            self.metrics.snapshots.inc()
            ws = self._workers.get(snap.worker_id)
            if ws is None:
                ws = _WorkerState(snap, self._ring_kw)
                self._workers[snap.worker_id] = ws
            elif (
                abs(snap.started_ts - ws.started_ts) > 1e-6
                or snap.seq < ws.seq
            ):
                # restart: same id, new incarnation.  Counters reset to
                # zero on the other side, so deltas across the boundary
                # are garbage -- drop the rings and the link edges this
                # worker participated in (satellite 4 churn contract).
                ws.restarts += 1
                ws._reset(snap, self._ring_kw)
                self._reset_links_locked(snap.worker_id)
                self._stragglers.discard(snap.worker_id)
                if snap.worker_id in self._quarantined:
                    # new incarnation starts its recovery clock over --
                    # quarantine itself persists (a crash-restart loop
                    # must re-earn K healthy windows, not skip them)
                    self._quarantined[snap.worker_id] = {
                        "streak": 0, "seq": snap.seq,
                    }
                logger.info(
                    "fleet: worker %d restarted (incarnation reset)",
                    snap.worker_id,
                )
            else:
                self._advance_locked(ws, snap)
            for rec in snap.transfers:
                self._observe_transfer_locked(rec)
            plan = snap.extra.get("plan")
            if isinstance(plan, dict):
                # an off-process planner publishes its last adjustments in
                # snapshot extra; merge so `fleet --plan` sees them
                for kind, rec in plan.items():
                    if isinstance(rec, dict):
                        self._plan[str(kind)] = dict(rec)
            new_stragglers, recovered = self._detect_stragglers_locked()
        for wid, step_ms, median_ms in new_stragglers:
            self._trip_straggler(wid, step_ms, median_ms)
        for wid in recovered:
            self._note_recovery(wid)

    def _advance_locked(
        self, ws: _WorkerState, snap: TelemetrySnapshot
    ) -> None:
        prev = ws.latest
        dt = snap.ts - prev.ts
        ws.prev = prev
        ws.latest = snap
        ws.seq = snap.seq
        ws.role = snap.role or ws.role
        ws.last_ts = snap.ts
        ws.kv_util.append(snap.ts, snap.kv_utilization)
        ws.queue.append(snap.ts, snap.queue_depth)
        if dt <= 0:
            return
        dtok = snap.tokens_generated - prev.tokens_generated
        if dtok >= 0:
            ws.tok_s.append(snap.ts, dtok / dt)
        dcount = snap.step_count - prev.step_count
        dsec = snap.step_seconds - prev.step_seconds
        if dcount > 0 and dsec >= 0:
            ws.step_ms.append(snap.ts, 1000.0 * dsec / dcount)

    def _observe_transfer_locked(self, rec: Dict[str, Any]) -> None:
        try:
            src = int(rec["src"])
            dst = int(rec["dst"])
            nbytes = int(rec["bytes"])
            seconds = float(rec["seconds"])
        except (KeyError, TypeError, ValueError):
            return
        link = self._links.get((src, dst))
        if link is None:
            link = self._links[(src, dst)] = LinkModel(self.link_decay)
        link.observe(nbytes, seconds)

    def _reset_links_locked(self, worker_id: int) -> None:
        for key in [
            k for k in self._links if worker_id in k
        ]:
            del self._links[key]

    # -- staleness / churn ----------------------------------------------------

    def expire_stale(self, now: Optional[float] = None) -> List[int]:
        """Drop workers that stopped publishing (leave / crash).  Called
        on every read path; returns the ids removed."""
        now = time.time() if now is None else now
        with self._lock:
            gone = [
                wid
                for wid, ws in self._workers.items()
                if now - ws.last_ts > self.stale_after_s
            ]
            for wid in gone:
                del self._workers[wid]
                self._reset_links_locked(wid)
                self._stragglers.discard(wid)
                self._quarantined.pop(wid, None)
        for wid in gone:
            logger.info("fleet: worker %d went stale, removed", wid)
        return gone

    # -- straggler detection --------------------------------------------------

    def _detect_stragglers_locked(
        self,
    ) -> Tuple[List[Tuple[int, float, float]], List[int]]:
        """Robust z-score of each worker's recent mean step latency vs the
        fleet median (MAD-scaled).  A worker is a straggler only when it is
        BOTH statistically extreme (z > straggler_z) and materially slow
        (> straggler_min_ratio x median) -- the ratio floor keeps a
        near-identical healthy fleet silent even when its MAD is tiny.

        Also advances the quarantine ledger: a newly-flagged worker enters
        quarantine; a quarantined worker exits after
        ``quarantine_recovery_windows`` consecutive snapshots without a
        flag (counted per-snapshot via its publisher seq, so one slow
        peer's ingest cadence cannot fast-forward another's recovery).
        Returns (newly-flagged (worker_id, step_ms, median_ms) rows,
        recovered worker ids)."""
        means: Dict[int, float] = {}
        for wid, ws in self._workers.items():
            window = ws.step_ms.recent(self.straggler_window)
            if window:
                means[wid] = sum(window) / len(window)
        flagged: set = set()
        if len(means) >= self.straggler_min_workers:
            median = statistics.median(means.values())
            mad = statistics.median(abs(v - median) for v in means.values())
            for wid, mean_ms in means.items():
                if median <= 0:
                    continue
                if mean_ms <= self.straggler_min_ratio * median:
                    continue
                # 0.6745 * MAD ~= sigma for normal data; guard tiny MAD
                # with a floor proportional to the median so z stays finite
                sigma = max(mad / 0.6745, 0.02 * median, 1e-9)
                if (mean_ms - median) / sigma > self.straggler_z:
                    flagged.add(wid)
        else:
            median = 0.0
        fresh = [
            (wid, means[wid], median)
            for wid in sorted(flagged - self._stragglers)
        ]
        self._stragglers = flagged
        # quarantine ledger: enters ...
        for wid, _, _ in fresh:
            entry = self._quarantined.get(wid)
            ws = self._workers.get(wid)
            seq = ws.seq if ws is not None else 0
            if entry is None:
                self._quarantined[wid] = {"streak": 0, "seq": seq}
            else:
                entry["streak"] = 0
                entry["seq"] = seq
        # ... and recoveries (one streak tick per new snapshot of that
        # worker; a re-flag resets the streak)
        recovered: List[int] = []
        for wid in list(self._quarantined):
            ws = self._workers.get(wid)
            if ws is None:
                continue  # expire_stale owns removal of vanished workers
            entry = self._quarantined[wid]
            if ws.seq <= entry["seq"]:
                continue  # no new evidence since the last ledger tick
            entry["seq"] = ws.seq
            if wid in flagged:
                entry["streak"] = 0
                continue
            entry["streak"] += 1
            if entry["streak"] >= self.quarantine_recovery_windows:
                del self._quarantined[wid]
                recovered.append(wid)
        return fresh, recovered

    def _trip_straggler(
        self, worker_id: int, step_ms: float, median_ms: float
    ) -> None:
        logger.warning(
            "fleet: straggler detected: worker %d step %.2fms vs fleet "
            "median %.2fms",
            worker_id, step_ms, median_ms,
        )
        from ..runtime.profiling import flight_recorder

        flight_recorder.snapshot(
            "straggler_detected",
            worker_id=worker_id,
            step_ms=round(step_ms, 3),
            fleet_median_ms=round(median_ms, 3),
            quarantined=True,
        )

    def _note_recovery(self, worker_id: int) -> None:
        logger.info(
            "fleet: worker %d recovered (%d healthy windows); quarantine "
            "lifted",
            worker_id, self.quarantine_recovery_windows,
        )
        from ..runtime.profiling import flight_recorder

        flight_recorder.snapshot(
            "straggler_recovered",
            worker_id=worker_id,
            healthy_windows=self.quarantine_recovery_windows,
        )

    @property
    def stragglers(self) -> List[int]:
        with self._lock:
            return sorted(self._stragglers)

    @property
    def quarantined(self) -> List[int]:
        """Workers currently excluded from new placements."""
        with self._lock:
            return sorted(self._quarantined)

    def quarantine_source(self) -> Callable[[], List[int]]:
        """Adapter for the KV router's placement exclusion
        (``KvRouter(quarantine=...)``) and the planner's
        victim selection: a zero-arg callable returning the currently
        quarantined worker ids."""
        return lambda: self.quarantined

    def victim_source(
        self,
        worker_id_of: Callable[[Any], Optional[int]] = (
            lambda h: getattr(h, "worker_id", None)
        ),
    ) -> Callable[[str, List[Any]], Any]:
        """Adapter for ``LocalConnector(victim_source=...)``: pick the
        scale-down victim by observatory state -- least-loaded (batch
        occupancy + queue depth from the last snapshot), and never the
        last *healthy* worker while peers sit in straggler quarantine
        (retiring it would leave the pool serving from known-bad boxes).
        When quarantined workers exist and at most one healthy peer
        remains, the victim comes from the quarantined set instead: a
        quarantined worker receives no new placements anyway, so it is
        the cheapest capacity to give back."""

        def load_of(handle: Any) -> float:
            wid = worker_id_of(handle)
            with self._lock:
                ws = self._workers.get(wid) if wid is not None else None
                if ws is None:
                    # never-published (coldest cache): prefer as victim
                    return -1.0
                return float(
                    ws.latest.batch_occupancy + ws.latest.queue_depth
                )

        def pick(kind: str, handles: List[Any]) -> Any:
            if not handles:
                return None
            with self._lock:
                bad = set(self._quarantined)
            healthy = [h for h in handles if worker_id_of(h) not in bad]
            quarantined = [h for h in handles if worker_id_of(h) in bad]
            if len(healthy) >= 2 or not quarantined:
                pool = healthy or handles
            else:
                pool = quarantined
            return min(pool, key=load_of)

        return pick

    # -- planner plan surface -------------------------------------------------

    def note_adjustment(
        self,
        kind: str,
        action: str,
        reason: str,
        count_before: int,
        *,
        ts: Optional[float] = None,
    ) -> None:
        """Record the planner's latest adjustment for one pool kind (the
        colocated wiring of ``Planner.on_adjustment``); surfaces in
        ``summary()["plan"]`` and the ``fleet --plan`` column."""
        rec = {
            "kind": str(kind),
            "action": str(action),
            "reason": str(reason),
            "count_before": int(count_before),
            "ts": time.time() if ts is None else float(ts),
        }
        with self._lock:
            self._plan[str(kind)] = rec

    # -- link model -----------------------------------------------------------

    def predict_transfer_ms(
        self, nbytes: int, src: int, dst: int
    ) -> Optional[float]:
        """Predicted KV-transfer wall time over the (src, dst) link, in
        milliseconds, or None while the link has no observations."""
        with self._lock:
            link = self._links.get((int(src), int(dst)))
            if link is None:
                return None
            pred = link.predict_s(nbytes)
        return None if pred is None else 1000.0 * pred

    def transfer_cost_source(
        self, src: int, bytes_per_token: int
    ) -> Callable[[int, int], Optional[float]]:
        """Adapter for the KV router's NetKV-style cost term
        (a ``transfer_cost=`` callable): returns a
        ``(worker_id, uncached_tokens) -> predicted ms`` callable over the
        learned (``src`` -> worker) links.  ``src`` is the worker holding
        the KV to move (the prefill/donor side); ``bytes_per_token`` maps
        the router's token counts onto the byte-denominated link model."""

        def cost(worker_id: int, uncached_tokens: int) -> Optional[float]:
            if uncached_tokens <= 0:
                return 0.0
            return self.predict_transfer_ms(
                uncached_tokens * bytes_per_token, src, worker_id
            )

        return cost

    def link_table(self) -> List[Dict[str, Any]]:
        with self._lock:
            links = list(self._links.items())
        rows = []
        for (src, dst), model in links:
            bw = model.bandwidth_bytes_per_s
            setup = model.setup_s
            rows.append(
                {
                    "src": src,
                    "dst": dst,
                    "samples": model.samples,
                    "bandwidth_bytes_per_s": bw,
                    "setup_ms": None if setup is None else 1000.0 * setup,
                }
            )
        return sorted(rows, key=lambda r: (r["src"], r["dst"]))

    # -- aggregation / export -------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """The ``GET /fleet`` document: per-worker rows, cluster totals,
        link table, stragglers."""
        self.expire_stale()
        now = time.time()
        with self._lock:
            workers = []
            by_role_tok: Dict[str, float] = {}
            by_role_count: Dict[str, int] = {}
            kv_used = kv_total = 0
            queue_total = 0
            slo_worst: Dict[str, float] = {}
            for wid in sorted(self._workers):
                ws = self._workers[wid]
                snap = ws.latest
                tok_s = ws.tok_s.last() or 0.0
                by_role_tok[ws.role] = by_role_tok.get(ws.role, 0.0) + tok_s
                by_role_count[ws.role] = by_role_count.get(ws.role, 0) + 1
                kv_used += snap.kv_pages_used
                kv_total += snap.kv_pages_total
                queue_total += snap.queue_depth
                for kind, att in snap.slo.items():
                    slo_worst[kind] = min(
                        slo_worst.get(kind, 1.0), att
                    )
                workers.append(
                    {
                        "worker_id": wid,
                        "role": ws.role,
                        "age_s": round(now - ws.first_ts, 3),
                        "last_seen_s": round(now - ws.last_ts, 3),
                        "restarts": ws.restarts,
                        "tokens_per_s": round(tok_s, 3),
                        "step_ms": (
                            None
                            if ws.step_ms.last() is None
                            else round(ws.step_ms.last(), 3)
                        ),
                        "kv_pages_used": snap.kv_pages_used,
                        "kv_pages_total": snap.kv_pages_total,
                        "kv_utilization": round(snap.kv_utilization, 4),
                        "queue_depth": snap.queue_depth,
                        "batch_occupancy": snap.batch_occupancy,
                        "batch_slots": snap.batch_slots,
                        "slo": dict(snap.slo),
                        "straggler": wid in self._stragglers,
                        "quarantined": wid in self._quarantined,
                    }
                )
            stragglers = sorted(self._stragglers)
            quarantined = sorted(self._quarantined)
            plan = {k: dict(v) for k, v in self._plan.items()}
        doc = {
            "ts": now,
            "workers": workers,
            "totals": {
                "workers_by_role": by_role_count,
                "tokens_per_s_by_role": {
                    k: round(v, 3) for k, v in by_role_tok.items()
                },
                "kv_pages_used": kv_used,
                "kv_pages_total": kv_total,
                "kv_pressure": round(
                    kv_used / kv_total if kv_total else 0.0, 4
                ),
                "queue_depth": queue_total,
                "slo_attainment": {
                    k: round(v, 4) for k, v in slo_worst.items()
                },
            },
            "links": self.link_table(),
            "stragglers": stragglers,
            "quarantined": quarantined,
            "plan": plan,
        }
        self._refresh_gauges(doc)
        return doc

    def _refresh_gauges(self, doc: Dict[str, Any]) -> None:
        m = self.metrics
        totals = doc["totals"]
        # labeled rows persist in the exposition after their label value
        # vanishes from the fleet (a role's last worker leaving), so zero
        # every previously-written row the current doc no longer covers
        self._sweep_gauge(
            m.workers, self._seen_roles, totals["workers_by_role"]
        )
        self._sweep_gauge(
            m.tokens_per_s,
            self._seen_tok_roles,
            totals["tokens_per_s_by_role"],
        )
        m.kv_pressure.set(totals["kv_pressure"])
        m.queue_depth.set(totals["queue_depth"])
        self._sweep_gauge(
            m.slo_attainment, self._seen_slo_kinds, totals["slo_attainment"]
        )
        m.stragglers.set(len(doc["stragglers"]))
        m.quarantined.set(len(doc["quarantined"]))
        live_links = set()
        for row in doc["links"]:
            key = (str(row["src"]), str(row["dst"]))
            if row["bandwidth_bytes_per_s"] is not None:
                live_links.add(key)
                m.link_bandwidth.labels(*key).set(row["bandwidth_bytes_per_s"])
            if row["setup_ms"] is not None:
                m.link_setup_ms.labels(*key).set(row["setup_ms"])
        for key in self._seen_links - live_links:
            m.link_bandwidth.labels(*key).set(0.0)
            m.link_setup_ms.labels(*key).set(0.0)
        self._seen_links = live_links

    @staticmethod
    def _sweep_gauge(gauge, seen: set, current: Dict[str, float]) -> None:
        for label in seen - set(current):
            gauge.labels(label).set(0.0)
        seen.clear()
        seen.update(current)
        for label, value in current.items():
            gauge.labels(label).set(value)

    def forward_pass_metrics(self) -> Dict[int, ForwardPassMetrics]:
        """Planner-compatible view: one ForwardPassMetrics per live
        worker, built field-for-field the way ``registry_metrics_source``
        builds its single-worker dict (the JAX package's planner), so a planner
        pointed at the observatory makes the same decisions a colocated
        planner would."""
        self.expire_stale()
        out: Dict[int, ForwardPassMetrics] = {}
        with self._lock:
            for wid, ws in self._workers.items():
                snap = ws.latest
                carry = ws.carry if ws.kv_util.raw_len < 2 else {}
                if carry:
                    # just-restarted worker: its fresh rings (and freshly
                    # zeroed counters) read as idle, which is a lie for
                    # scaling purposes -- report the stashed pre-restart
                    # coarse-bucket averages until the new incarnation has
                    # >= 2 real samples behind it
                    kv_total = int(carry["kv_pages_total"])
                    batch_slots = int(carry["batch_slots"])
                    if kv_total <= 0 and batch_slots <= 0:
                        continue
                    out[wid] = ForwardPassMetrics(
                        kv_active_blocks=int(carry["kv_pages_used"]),
                        kv_total_blocks=kv_total,
                        num_requests_waiting=int(
                            round(carry["queue_depth"])
                        ),
                        gpu_cache_usage_perc=carry["kv_utilization"],
                        request_active_slots=int(carry["batch_occupancy"]),
                        request_total_slots=batch_slots,
                        slo_ttft_attainment=snap.slo.get("ttft", 1.0),
                        slo_itl_attainment=snap.slo.get("itl", 1.0),
                        slo_e2e_attainment=snap.slo.get("e2e", 1.0),
                    )
                    continue
                if snap.kv_pages_total <= 0 and snap.batch_slots <= 0:
                    # mirrors the local source's "no engine sample yet"
                    # guard: a worker that has published nothing but its
                    # heartbeat contributes no scaling signal
                    continue
                lookups = snap.prefix_lookup_tokens
                out[wid] = ForwardPassMetrics(
                    kv_active_blocks=snap.kv_pages_used,
                    kv_total_blocks=snap.kv_pages_total,
                    num_requests_waiting=snap.queue_depth,
                    gpu_cache_usage_perc=snap.kv_utilization,
                    gpu_prefix_cache_hit_rate=(
                        snap.prefix_hit_tokens / lookups if lookups else 0.0
                    ),
                    request_active_slots=snap.batch_occupancy,
                    request_total_slots=snap.batch_slots,
                    slo_ttft_attainment=snap.slo.get("ttft", 1.0),
                    slo_itl_attainment=snap.slo.get("itl", 1.0),
                    slo_e2e_attainment=snap.slo.get("e2e", 1.0),
                    slo_ttft_queue_violations=snap.slo_violations.get(
                        "ttft/queue", 0.0
                    ),
                    slo_ttft_service_violations=snap.slo_violations.get(
                        "ttft/service", 0.0
                    ),
                )
        return out

    def render(self) -> Tuple[bytes, str]:
        """Prometheus exposition of only the ``dynamo_fleet_*`` families
        (``GET /fleet/metrics``)."""
        self.summary()  # refresh gauges from current state
        return self.metrics.registry.render_prefix("dynamo_fleet_")

    def worker_series(self, worker_id: int) -> Optional[Dict[str, Any]]:
        """Retained time series for one worker (debug endpoint / CLI)."""
        with self._lock:
            ws = self._workers.get(int(worker_id))
            if ws is None:
                return None
            return {
                "worker_id": ws.worker_id,
                "role": ws.role,
                "restarts": ws.restarts,
                "tokens_per_s": ws.tok_s.points(),
                "step_ms": ws.step_ms.points(),
                "kv_utilization": ws.kv_util.points(),
                "queue_depth": ws.queue.points(),
            }

    @property
    def worker_count(self) -> int:
        with self._lock:
            return len(self._workers)

    # -- hub wiring -----------------------------------------------------------

    async def start(self, namespace) -> None:
        """Subscribe to the fleet telemetry topic and pump snapshots in."""
        import asyncio

        self._sub = await namespace.subscribe(TELEMETRY_TOPIC)

        async def _pump() -> None:
            import json

            async for _subject, payload in self._sub:
                try:
                    self.ingest(json.loads(payload))
                except Exception:
                    logger.exception("fleet: bad telemetry payload")

        self._task = asyncio.create_task(_pump(), name="fleet-observatory")

    async def stop(self) -> None:
        import asyncio
        import contextlib

        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._task
            self._task = None
        if self._sub is not None:
            with contextlib.suppress(Exception):
                await self._sub.close()
            self._sub = None
