"""Planner: SLO-driven autoscaling of decode / prefill workers.

A copy of the JAX package's ``planner/planner.py`` (which loads no JAX)
over the port's metrics registry, SLO tracker and thread sentry: the same
decisions, reasons, evidence and JSONL log lines on the same metrics.

The control loop closes here: the deployment's promise is SLO
*attainment* (``runtime/slo.py``), so attainment drives the pool sizes and
the classic load thresholds survive as the coarse fallback signal.

Per adjustment round, in priority order:

  * **SLO pass** -- the rolling TTFT / ITL attainment each worker reports
    (``ForwardPassMetrics.slo_*_attainment``) is compared against
    ``slo_attainment_floor``:

      - ITL below the floor for ``slo_breach_rounds`` consecutive rounds
        scales the **decode** pool up (decode is what paces tokens);
      - TTFT below the floor scales the **prefill** pool up, but only when
        the violation-cause evidence attributes the misses to *queueing*
        (``slo_ttft_queue_violations`` deltas / backlog) -- a
        service-caused TTFT miss means the engine is slow, and adding
        prefill replicas would not help, so the planner records a hold
        with the evidence instead of thrashing;

    every SLO-driven actuation opens a ``slo_cooldown_rounds`` cooldown
    for its pool, and hysteresis (the consecutive-rounds requirement)
    keeps one noisy window from scaling anything: together they make the
    controller stable under square-wave load.

  * **load pass** (the reference thresholds,
    examples/llm/components/planner.py:40-49, :214-340): decode scales on
    average KV load (``kv_load_scale_up`` / ``kv_load_scale_down``),
    prefill on queue depth per worker.  Scale-*down* is SLO-gated: a pool
    below its attainment floor never shrinks, whatever the load says.

Quarantined workers (fleet observatory straggler quarantine, wired via
``quarantine_source``) are excluded from the aggregates: their latency is
known-bad and being handled by placement exclusion, so it must not be
read as pool-wide SLO pressure.

Every :class:`Adjustment` is stamped with the attainment/cause evidence
that triggered it and appended to the JSONL log -- the decision history
is replayable from the file alone.  A freshly added worker warms up
(engine start, weight load, cache fill), so each scale-up opens a grace
period during which further changes of that kind are suppressed
(reference NEW_DECODE_WORKER_GRACE_PERIOD = 3 intervals).

The planner is deliberately sans-IO: ``metrics_source`` yields the current
per-worker ``ForwardPassMetrics`` (wire it to a KvMetricsAggregator's shared
``ProcessedEndpoints`` in production, the fleet observatory via
``fleet_metrics_source``, or in-process engines in tests) and
``queue_depth_source`` yields the prefill queue depth (hub ``queue_depth``).
Scaling goes through a :class:`~.connector.Connector`; ``on_adjustment``
(wire it to ``FleetObservatory.note_adjustment``) surfaces the last
decision per pool in ``GET /fleet`` and ``dynamo-tpu fleet --plan``.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import logging
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Dict, List, Optional

from ..protocols.common import ForwardPassMetrics
from .connector import Connector

logger = logging.getLogger("dynamo.planner")

DECODE = "decode"
PREFILL = "prefill"


def registry_metrics_source(
    registry=None, worker_id: int = 0
) -> Callable[[], Dict[int, ForwardPassMetrics]]:
    """Metrics source reading the runtime metrics registry's engine gauges
    (``dynamo_engine_*``, runtime/metrics.py) in place of ad-hoc plumbing:
    a colocated deployment -- planner in the worker process, the common dev
    topology -- points the planner at exactly the series ``/metrics``
    exports, so scaling decisions and dashboards can never disagree about
    what the load was.  Returns ``{}`` until an engine has published its
    first sample (the planner treats that as "no fleet data yet")."""
    from ..runtime import metrics as rtm

    def source() -> Dict[int, ForwardPassMetrics]:
        reg = registry or rtm.default_registry()
        total = reg.sample("dynamo_engine_kv_pages_total")
        if total is None:
            return {}

        def val(name: str) -> float:
            return reg.sample(name) or 0.0

        hits = val("dynamo_engine_prefix_hit_tokens")
        lookups = val("dynamo_engine_prefix_lookup_tokens")

        # colocated tracker: age stale windows out of the gauges first,
        # so a drained instance stops reporting incident-era attainment
        from ..runtime import slo as _slo

        _slo.tracker.refresh_gauges()

        def attainment(kind: str) -> float:
            # live SLO plane (runtime/slo.py): absent series (tracker
            # disarmed / no samples) reads as fully attained, so
            # load-only deployments see no phantom SLO pressure
            got = reg.sample("dynamo_slo_attainment", {"kind": kind})
            return 1.0 if got is None else got

        return {
            worker_id: ForwardPassMetrics(
                kv_active_blocks=int(val("dynamo_engine_kv_pages_used")),
                kv_total_blocks=int(total),
                num_requests_waiting=int(
                    val("dynamo_engine_prefill_queue_depth")
                ),
                gpu_cache_usage_perc=val("dynamo_engine_kv_utilization"),
                gpu_prefix_cache_hit_rate=hits / lookups if lookups else 0.0,
                request_active_slots=int(
                    val("dynamo_engine_batch_occupancy")
                ),
                request_total_slots=int(val("dynamo_engine_batch_slots")),
                slo_ttft_attainment=attainment("ttft"),
                slo_itl_attainment=attainment("itl"),
                slo_e2e_attainment=attainment("e2e"),
                slo_ttft_queue_violations=float(
                    _slo.tracker.violation_count("ttft", "queue")
                ),
                slo_ttft_service_violations=float(
                    _slo.tracker.violation_count("ttft", "service")
                ),
            )
        }

    return source


def fleet_metrics_source(
    observatory,
) -> Callable[[], Dict[int, ForwardPassMetrics]]:
    """Metrics source reading a
    :class:`~dynamo_tpu_torch.fleet.observatory.FleetObservatory` -- the
    fleet-plane twin of :func:`registry_metrics_source`: same
    ``ForwardPassMetrics`` construction, but one entry per live telemetry
    publisher instead of one colocated registry, so the planner scales on
    cluster-wide state.  On a single-worker fleet the two sources are
    decision-equivalent (tests/test_torch_planner.py holds them so)."""

    def source() -> Dict[int, ForwardPassMetrics]:
        return observatory.forward_pass_metrics()

    return source


@dataclass
class PlannerConfig:
    adjustment_interval_s: float = 10.0
    # decode scaling on average KV-cache usage (reference planner.py:220-260)
    kv_load_scale_up: float = 0.8
    kv_load_scale_down: float = 0.3
    min_decode_workers: int = 1
    max_decode_workers: int = 8
    # prefill scaling on queue depth per prefill worker (planner.py:262-320)
    queue_scale_up_per_worker: float = 2.0
    queue_scale_down: float = 0.2
    min_prefill_workers: int = 0
    max_prefill_workers: int = 4
    # intervals to wait after a scale-up before acting again on that kind
    decode_grace_periods: int = 3
    prefill_grace_periods: int = 3
    # -- SLO loop ---------------------------------------------------------------
    # minimum acceptable rolling attainment; a pool whose worst
    # (non-quarantined) worker reports less is under SLO pressure
    slo_attainment_floor: float = 0.9
    # hysteresis: consecutive under-floor rounds required before an
    # SLO-driven scale-up fires (one noisy window scales nothing)
    slo_breach_rounds: int = 2
    # rounds after an SLO-driven actuation during which further SLO-driven
    # actions on that pool are suppressed (the load pass still runs)
    slo_cooldown_rounds: int = 2
    # observe and log decisions without acting (reference no-operation mode)
    no_op: bool = False
    # machine-readable adjustment history: one JSON line per decision,
    # appended here (the reference planner writes each adjustment to a
    # tensorboard sink, examples/llm/components/planner.py; JSONL serves
    # the same threshold-tuning loop without a TB dependency)
    adjustment_log_path: Optional[str] = None


@dataclass
class Adjustment:
    """One decision, kept for observability/tests."""

    t: float
    kind: str
    action: str  # "up" | "down" | "hold"
    reason: str
    count_before: int
    # the attainment / violation-cause numbers the decision was made on
    # (None for pure load-pass decisions) -- serialized into the JSONL log
    # so the decision history replays from the file alone
    evidence: Optional[Dict[str, object]] = None


class Planner:
    def __init__(
        self,
        connector: Connector,
        metrics_source: Callable[[], Dict[int, ForwardPassMetrics]],
        queue_depth_source: Optional[Callable[[], Awaitable[int]]] = None,
        cfg: Optional[PlannerConfig] = None,
        quarantine_source: Optional[Callable[[], object]] = None,
        on_adjustment: Optional[Callable[[Adjustment], None]] = None,
    ) -> None:
        self.connector = connector
        self.metrics_source = metrics_source
        self.queue_depth_source = queue_depth_source
        self.cfg = cfg or PlannerConfig()
        # worker ids currently quarantined by the fleet observatory: their
        # latency is being handled by placement exclusion, so they are
        # dropped from the SLO/load aggregates (FleetObservatory
        # .quarantine_source() returns the matching callable)
        self.quarantine_source = quarantine_source
        # decision hook (non-hold only): FleetObservatory.note_adjustment
        # surfaces the last plan per pool in /fleet and the CLI --plan view
        self.on_adjustment = on_adjustment
        self.adjustments: List[Adjustment] = []
        self._decode_grace = 0
        self._prefill_grace = 0
        self._prev_queue_depth: Optional[int] = None
        # SLO hysteresis / cooldown state, per pool
        self._itl_breach = 0
        self._ttft_breach = 0
        self._decode_cooldown = 0
        self._prefill_cooldown = 0
        # last-seen cumulative TTFT violation counts per worker, diffed
        # round-over-round to attribute fresh misses to queue vs service
        self._prev_ttft_causes: Dict[int, tuple] = {}
        self._task: Optional[asyncio.Task] = None
        # single-thread writer for the JSONL adjustment log: _record runs
        # on the event loop (called from the async adjust passes), so the
        # append must not touch disk there; one worker preserves line order
        self._log_io: Optional[concurrent.futures.ThreadPoolExecutor] = (
            concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="planner-log"
            )
            if self.cfg.adjustment_log_path else None
        )

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        self._task = asyncio.create_task(self._loop(), name="planner-loop")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._task
            self._task = None
        if self._log_io is not None:
            # drain queued log lines off-loop, then stop the writer
            await asyncio.to_thread(self._log_io.shutdown, True)

    async def _loop(self) -> None:
        while True:
            try:
                await self.step()
            except Exception:
                logger.exception("planner step failed")
            await asyncio.sleep(self.cfg.adjustment_interval_s)

    # -- one adjustment round (reference make_adjustments) --------------------

    async def step(self) -> None:
        # connectors that actuate an external system (k8s) pull one fresh
        # replica snapshot per round so decisions and actuation agree
        refresh = getattr(self.connector, "refresh", None)
        if refresh is not None:
            await refresh()
        metrics = self.metrics_source()
        queue_depth = 0
        if self.queue_depth_source is not None:
            queue_depth = await self.queue_depth_source()
        await self._adjust_decode(metrics)
        await self._adjust_prefill(queue_depth, metrics)
        self._prev_queue_depth = queue_depth
        self._refresh_pool_gauges()
        # barrier: when the round completes, its decisions are on disk
        # (threshold-tuning tools tail the file between rounds) -- the
        # waiting happens here, off the per-decision path, not per line
        await self._drain_log()

    async def _drain_log(self) -> None:
        if self._log_io is None:
            return
        try:
            fut = self._log_io.submit(lambda: None)
        except RuntimeError:  # stopped planner
            return
        await asyncio.wrap_future(fut)

    def _healthy(
        self, metrics: Dict[int, ForwardPassMetrics]
    ) -> Dict[int, ForwardPassMetrics]:
        """Drop quarantined workers from the aggregates: a known straggler
        is handled by placement exclusion, and reading its latency as
        pool-wide SLO pressure would double-actuate."""
        if self.quarantine_source is None:
            return metrics
        try:
            quarantined = set(self.quarantine_source())
        except Exception:
            logger.exception("quarantine source failed; using all workers")
            return metrics
        healthy = {
            wid: m for wid, m in metrics.items() if wid not in quarantined
        }
        # an all-quarantined fleet still needs *some* signal; degrade to
        # the full view rather than flying blind
        return healthy or metrics

    async def _adjust_decode(self, metrics: Dict[int, ForwardPassMetrics]) -> None:
        cfg = self.cfg
        n = self.connector.worker_count(DECODE)
        if self._decode_cooldown > 0:
            self._decode_cooldown -= 1
        if self._decode_grace > 0:
            self._decode_grace -= 1
            self._record(DECODE, "hold", f"grace ({self._decode_grace} left)", n)
            return
        if not metrics:
            return
        healthy = self._healthy(metrics)
        loads = [m.gpu_cache_usage_perc for m in healthy.values()]
        waiting = sum(m.num_requests_waiting for m in healthy.values())
        avg_load = sum(loads) / len(loads)
        # -- SLO pass: ITL attainment paces the decode pool ------------------
        itl_att = min(m.slo_itl_attainment for m in healthy.values())
        if itl_att < cfg.slo_attainment_floor:
            self._itl_breach += 1
        else:
            self._itl_breach = 0
        slo_pressure = itl_att < cfg.slo_attainment_floor
        if (
            self._itl_breach >= cfg.slo_breach_rounds
            and self._decode_cooldown == 0
            and n < cfg.max_decode_workers
        ):
            evidence = {
                "itl_attainment": round(itl_att, 4),
                "floor": cfg.slo_attainment_floor,
                "breach_rounds": self._itl_breach,
                "cause": "service",
            }
            self._record(
                DECODE, "up",
                f"itl attainment {itl_att:.2f} < floor "
                f"{cfg.slo_attainment_floor:.2f}", n, evidence,
            )
            if not cfg.no_op:
                await self.connector.add_worker(DECODE)
                self._decode_grace = cfg.decode_grace_periods
                self._decode_cooldown = cfg.slo_cooldown_rounds
                self._itl_breach = 0
            return
        if slo_pressure and self._itl_breach < cfg.slo_breach_rounds:
            # under the floor but hysteresis not yet satisfied: explicitly
            # a hold, so the JSONL log shows the breach building
            self._record(
                DECODE, "hold",
                f"itl attainment {itl_att:.2f} < floor (breach "
                f"{self._itl_breach}/{cfg.slo_breach_rounds})", n,
                {"itl_attainment": round(itl_att, 4),
                 "breach_rounds": self._itl_breach},
            )
        # -- load pass (reference thresholds) --------------------------------
        if avg_load > cfg.kv_load_scale_up and n < cfg.max_decode_workers:
            self._record(DECODE, "up", f"avg kv load {avg_load:.2f}", n)
            if not cfg.no_op:
                await self.connector.add_worker(DECODE)
                self._decode_grace = cfg.decode_grace_periods
        elif (
            avg_load < cfg.kv_load_scale_down
            and waiting == 0
            and n > cfg.min_decode_workers
            and not slo_pressure  # SLO gate: a pool under its floor never shrinks
        ):
            self._record(DECODE, "down", f"avg kv load {avg_load:.2f}", n)
            if not cfg.no_op:
                await self.connector.remove_worker(DECODE)

    def _ttft_cause_deltas(
        self, healthy: Dict[int, ForwardPassMetrics]
    ) -> tuple:
        """Round-over-round delta of cumulative TTFT violation counts,
        summed over the healthy fleet: (fresh queue-caused misses, fresh
        service-caused misses).  Restarted workers report counters that
        regressed; clamp at zero so an incarnation flip cannot read as
        negative evidence."""
        dq = ds = 0.0
        for wid, m in healthy.items():
            cur = (m.slo_ttft_queue_violations, m.slo_ttft_service_violations)
            prev = self._prev_ttft_causes.get(wid, cur)
            dq += max(cur[0] - prev[0], 0.0)
            ds += max(cur[1] - prev[1], 0.0)
            self._prev_ttft_causes[wid] = cur
        return dq, ds

    async def _adjust_prefill(
        self,
        queue_depth: int,
        metrics: Optional[Dict[int, ForwardPassMetrics]] = None,
    ) -> None:
        cfg = self.cfg
        healthy = self._healthy(metrics) if metrics else {}
        if self.queue_depth_source is None and not healthy:
            return
        n = self.connector.worker_count(PREFILL)
        if self._prefill_cooldown > 0:
            self._prefill_cooldown -= 1
        if self._prefill_grace > 0:
            self._prefill_grace -= 1
            self._record(PREFILL, "hold", f"grace ({self._prefill_grace} left)", n)
            return
        # -- SLO pass: TTFT attainment with cause attribution -----------------
        ttft_att = 1.0
        if healthy:
            ttft_att = min(m.slo_ttft_attainment for m in healthy.values())
            dq, ds = self._ttft_cause_deltas(healthy)
            if ttft_att < cfg.slo_attainment_floor:
                self._ttft_breach += 1
            else:
                self._ttft_breach = 0
            if (
                self._ttft_breach >= cfg.slo_breach_rounds
                and self._prefill_cooldown == 0
            ):
                waiting = sum(
                    m.num_requests_waiting for m in healthy.values()
                )
                # cause attribution: fresh queue-caused misses dominate, or
                # (no fresh counter evidence) there is a visible backlog
                queue_caused = (dq > 0 and dq >= ds) or (
                    dq == ds == 0 and (queue_depth > 0 or waiting > 0)
                )
                evidence = {
                    "ttft_attainment": round(ttft_att, 4),
                    "floor": cfg.slo_attainment_floor,
                    "breach_rounds": self._ttft_breach,
                    "queue_violations_delta": dq,
                    "service_violations_delta": ds,
                    "cause": "queue" if queue_caused else "service",
                }
                if queue_caused and n < cfg.max_prefill_workers:
                    self._record(
                        PREFILL, "up",
                        f"ttft attainment {ttft_att:.2f} < floor, "
                        f"cause=queue", n, evidence,
                    )
                    if not cfg.no_op:
                        await self.connector.add_worker(PREFILL)
                        self._prefill_grace = cfg.prefill_grace_periods
                        self._prefill_cooldown = cfg.slo_cooldown_rounds
                        self._ttft_breach = 0
                    return
                if not queue_caused:
                    # service-caused TTFT miss: more prefill replicas would
                    # not help (the engine itself is slow -- the ITL/decode
                    # pass owns that); hold with the evidence on record
                    self._record(
                        PREFILL, "hold",
                        f"ttft attainment {ttft_att:.2f} < floor but "
                        f"cause=service (decode-side)", n, evidence,
                    )
        if self.queue_depth_source is None:
            return
        per_worker = queue_depth / max(n, 1)
        if per_worker > cfg.queue_scale_up_per_worker and n < cfg.max_prefill_workers:
            # trend suppression (reference planner.py:281-291): a new prefill
            # worker takes ~the buffer period to start, so project the queue
            # forward by the observed per-interval change and skip the
            # scale-up when the backlog is predicted to drain on its own
            # before the worker would help
            change = (
                queue_depth - self._prev_queue_depth
                if self._prev_queue_depth is not None
                else 0
            )
            predicted = queue_depth + change * cfg.prefill_grace_periods
            if predicted / max(n, 1) <= cfg.queue_scale_up_per_worker:
                self._record(
                    PREFILL, "hold",
                    f"trend predicts drain (now {queue_depth}, "
                    f"predicted {predicted})", n,
                )
                return
            self._record(PREFILL, "up", f"queue/worker {per_worker:.1f}", n)
            if not cfg.no_op:
                await self.connector.add_worker(PREFILL)
                self._prefill_grace = cfg.prefill_grace_periods
        elif (
            per_worker < cfg.queue_scale_down
            and n > cfg.min_prefill_workers
            and ttft_att >= cfg.slo_attainment_floor  # SLO gate on shrink
        ):
            self._record(PREFILL, "down", f"queue/worker {per_worker:.1f}", n)
            if not cfg.no_op:
                await self.connector.remove_worker(PREFILL)

    def _refresh_pool_gauges(self) -> None:
        from ..runtime import metrics as rtm

        gauge = rtm.default_registry().gauge(
            "dynamo_planner_pool_size",
            "Planner's view of the worker pool size per kind",
            ["kind"],
        )
        for kind in (DECODE, PREFILL):
            try:
                gauge.labels(kind).set(self.connector.worker_count(kind))
            except Exception:
                # connector without that pool: gauge row simply stays unset
                logger.debug(
                    "pool gauge refresh skipped for %s", kind, exc_info=True
                )

    def _record(
        self,
        kind: str,
        action: str,
        reason: str,
        count: int,
        evidence: Optional[Dict[str, object]] = None,
    ) -> None:
        adj = Adjustment(
            t=time.monotonic(),
            kind=kind,
            action=action,
            reason=reason,
            count_before=count,
            evidence=evidence,
        )
        self.adjustments.append(adj)
        if action != "hold":
            logger.info("planner: %s %s (%s), count was %d", kind, action, reason, count)
            from ..runtime import metrics as rtm

            rtm.default_registry().counter(
                "dynamo_planner_adjustments",
                "Planner scale decisions actuated (or logged in no-op "
                "mode), by pool kind and direction",
                ["kind", "action"],
            ).labels(kind, action).inc()
            if self.on_adjustment is not None:
                try:
                    self.on_adjustment(adj)
                except Exception:
                    logger.exception("planner on_adjustment hook failed")
        if self._log_io is not None:
            import json

            doc = {
                    "ts": time.time(),
                    "kind": kind,
                    "action": action,
                    "reason": reason,
                    "count_before": count,
                    "no_op": self.cfg.no_op,
            }
            if evidence is not None:
                doc["evidence"] = evidence
            line = json.dumps(doc)
            # append off the event loop (_record is called mid-adjustment);
            # the single worker keeps decision order in the file
            try:
                self._log_io.submit(self._append_log_line, line)
            except RuntimeError:
                pass  # stopped planner (shutdown race): drop the line
        if len(self.adjustments) > 4096:
            del self.adjustments[:2048]

    def _append_log_line(self, line: str) -> None:
        """Log-writer thread only."""
        from ..runtime import thread_sentry

        thread_sentry.assert_role(
            "planner-log", what="Planner._append_log_line"
        )
        try:
            with open(self.cfg.adjustment_log_path, "a") as f:
                f.write(line + "\n")
        except OSError:
            logger.warning(
                "planner adjustment log write failed", exc_info=True
            )
