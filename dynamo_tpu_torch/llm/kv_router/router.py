"""KvRouter + KvPushRouter: KV-overlap-aware request dispatch.

Rebuild of the reference (lib/llm/src/kv_router.rs:104-255): the KvRouter
owns the indexer (fed by ``{ns}.events.kv_events`` subscriptions), the
metrics aggregator, and the scheduler; ``find_best_match(tokens)`` returns
the worker with the best cost.  KvPushRouter wraps a PushRouter: pick the
best worker, stamp ``estimated_prefix_hit_num_blocks`` into the request,
and dispatch with ``direct()``.

Worker death is handled on both feeds: the aggregator drops workers whose
``load_metrics`` instance disappeared (lease loss), and the indexer drops
their whole subtree (reference indexer.rs:382 semantics).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import time
from typing import Any, Dict, Optional, Sequence, Tuple

from ...protocols.common import PreprocessedRequest
from ...runtime import metrics as rtm
from ...runtime import tracing
from ...runtime.component import (
    Component,
    InstanceNotFoundError,
    Namespace,
    PushRouter,
)
from ...runtime.transports.request_plane import WorkerLostError
from ...runtime.engine import Annotated, Context, ResponseStream
from ...tokens.hashing import hash_blocks
from .indexer import KvIndexer, KvIndexerSharded, REMOTE_SOURCE_ID
from .metrics_aggregator import KvMetricsAggregator
from .scheduler import DefaultWorkerSelector, KvRouterConfig, KvScheduler

logger = logging.getLogger("dynamo.kv_router")

KV_EVENT_SUBJECT = "kv_events"  # rides {ns}.events.kv_events
KV_HIT_RATE_SUBJECT = "kv-hit-rate"  # reference kv_router.rs:44


class KvRouter:
    """Chooses a worker; does not dispatch (reference kv_router.rs:104)."""

    def __init__(
        self,
        namespace: Namespace,
        component: Component,
        block_size: int = 16,
        config: Optional[KvRouterConfig] = None,
        scrape_interval_s: float = 0.2,
        index_shards: int = 1,
        quarantine=None,
    ) -> None:
        self.namespace = namespace
        self.component = component
        self.block_size = block_size
        if index_shards < 1:
            raise ValueError("index_shards must be >= 1")
        # index_shards > 1 switches to the worker-sharded index (reference
        # KvIndexerSharded) for large fleets
        if index_shards > 1:
            self.indexer = KvIndexerSharded(
                block_size=block_size, num_shards=index_shards
            )
        else:
            self.indexer = KvIndexer(block_size=block_size)
        # quarantine: FleetObservatory.quarantine_source() -- stragglers
        # flagged by the fleet plane stop winning selections until their
        # series recovers (scheduler.py weight-zeroing); kept here too so
        # donor selection never nominates a quarantined worker as a source
        self._quarantine = quarantine
        self.scheduler = KvScheduler(
            block_size, DefaultWorkerSelector(config, quarantine=quarantine)
        )
        # one shared ProcessedEndpoints: the aggregator writes scrapes into
        # the same snapshot the scheduler reads/predictively bumps
        self.aggregator = KvMetricsAggregator(
            component,
            interval_s=scrape_interval_s,
            endpoints=self.scheduler.workers,
            on_remove=self._on_worker_removed,
        )
        self._sub = None
        self._sub_task: Optional[asyncio.Task] = None
        self._publish_tasks: set = set()

    async def start(self) -> None:
        self._sub = await self.namespace.subscribe(KV_EVENT_SUBJECT)
        self._sub_task = asyncio.create_task(
            self._consume_events(), name="kv-router-events"
        )
        # per-selection hit-rate telemetry -> {ns}.events.kv-hit-rate
        # (reference scheduler.rs:104); consumed by the metrics component
        self.scheduler.on_hit_rate = self._publish_hit_rate
        await self.aggregator.start()

    async def stop(self) -> None:
        if self._sub_task is not None:
            self._sub_task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._sub_task
            self._sub_task = None
        if self._sub is not None:
            await self._sub.close()
        await self.aggregator.stop()
        # release the sharded index's matching pool (flat index: no-op)
        close = getattr(self.indexer, "close", None)
        if close is not None:
            close()

    def _publish_hit_rate(self, ev) -> None:
        payload = {
            "worker_id": ev.worker_id,
            "isl_blocks": ev.isl_blocks,
            "overlap_blocks": ev.overlap_blocks,
        }

        async def _send() -> None:
            try:
                await self.namespace.publish(KV_HIT_RATE_SUBJECT, payload)
            except Exception:
                logger.debug("kv-hit-rate publish failed", exc_info=True)

        # hold a strong reference until done: a bare ensure_future() task
        # can be garbage-collected mid-await, silently dropping the event
        task = asyncio.ensure_future(_send())
        self._publish_tasks.add(task)
        task.add_done_callback(self._publish_tasks.discard)

    def _on_worker_removed(self, worker_id: int) -> None:
        # the aggregator already dropped it from the shared endpoint
        # snapshot; the index subtree is ours to clean up
        logger.info("worker %x removed; dropping its KV index entries", worker_id)
        self.indexer.remove_worker(worker_id)

    async def _consume_events(self) -> None:
        assert self._sub is not None
        async for _subject, payload in self._sub:
            try:
                msg = json.loads(payload)
                self.indexer.apply_event(int(msg["worker_id"]), msg["event"])
            except Exception:
                logger.exception("bad kv event payload")

    # -- selection -----------------------------------------------------------

    async def find_best_match(self, tokens: Sequence[int]) -> Tuple[int, int]:
        """Returns (worker_id, overlap_blocks) (reference kv_router.rs:
        176-196)."""
        worker_id, overlap, _donor = await self.find_best_match_with_donor(
            tokens
        )
        return worker_id, overlap

    async def find_best_match_with_donor(
        self, tokens: Sequence[int]
    ) -> Tuple[int, int, Optional[Dict[str, Any]]]:
        """Best-cost worker plus the best prefix *donor* when they differ.

        The cost function may send a request to a lightly-loaded worker even
        though another worker holds a longer cached prefix; that other
        worker is the onboarding donor (cross-worker block import,
        reference block_manager.rs:119-146).  Donor candidates come from
        two planes: the G1 overlap index (live device blocks on peers) and
        the cluster-global holdings index (offload-tier copies -- peer
        host/disk and the shared G4 store).  Quarantined workers never
        donate; the G4 store cannot be quarantined away (it is a passive
        object store, not a straggler candidate).

        Returns ``(worker_id, overlap_blocks, donor)`` with ``donor`` a
        dict ``{"instance", "blocks", "source": "peer"|"remote",
        "nbytes"}`` (``nbytes`` None when only the G1 index knows the
        prefix; ``instance`` is ``REMOTE_SOURCE_ID`` for the G4 store) or
        None when nobody beats the chosen worker's own cache."""
        _, seq_hashes = hash_blocks(tokens, self.block_size)
        overlap = self.indexer.find_matches(seq_hashes)
        worker_id = self.scheduler.schedule(overlap, len(tokens))
        own = overlap.scores.get(worker_id, 0)
        quarantined: set = set()
        q = getattr(self, "_quarantine", None)
        if q is not None:
            try:
                quarantined = set(q())
            except Exception:
                logger.debug("quarantine source failed", exc_info=True)
        donor: Optional[Dict[str, Any]] = None
        for w, blocks in overlap.scores.items():
            if w == worker_id or w in quarantined or blocks <= own:
                continue
            if donor is None or blocks > donor["blocks"]:
                donor = {
                    "instance": w,
                    "blocks": blocks,
                    "source": "peer",
                    "nbytes": None,
                }
        holdings = getattr(self.indexer, "holdings", None)
        if holdings is not None and holdings.num_blocks:
            sources = holdings.prefix_sources(
                seq_hashes, exclude={worker_id} | quarantined
            )
            for src, info in sources.items():
                # strict improvement only: at equal coverage the G1 peer
                # donor wins (its blocks are already device-resident)
                if info["blocks"] <= own or (
                    donor is not None and info["blocks"] <= donor["blocks"]
                ):
                    continue
                donor = {
                    "instance": src,
                    "blocks": info["blocks"],
                    "source": "remote" if src == REMOTE_SOURCE_ID else "peer",
                    "nbytes": info["nbytes"],
                    "tier": info["tier"],
                }
        return worker_id, own, donor


class KvPushRouter:
    """PushRouter wrapper: best-match then ``direct()`` (reference
    kv_router.rs:220-255)."""

    # evidence ring: every gate evaluation appends a JSONL-able dict here
    # (bench.py dumps it); bounded so long-lived routers don't grow forever
    DECISION_LOG_CAP = 4096

    def __init__(
        self,
        inner: PushRouter,
        chooser: KvRouter,
        *,
        transfer_ms=None,
        remote_spec: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.inner = inner
        self.chooser = chooser
        # routing decisions by cause: kv (best-match direct), kv_donor
        # (best-match plus a cross-worker onboarding donor), kv_remote
        # (donor is the G4 store), and the two fallbacks -- the series
        # smarter-routing work tunes against
        reg = rtm.default_registry()
        self._decisions = reg.counter(
            "dynamo_kv_router_decisions",
            "KV-router dispatch decisions by cause",
            ["cause"],
        )
        # NetKV-style fetch-vs-recompute gate evidence: every donor
        # candidate is adjudicated on predicted transfer ms vs predicted
        # prefill ms, and both estimates are recorded whichever way the
        # decision goes
        self._gate_decisions = reg.counter(
            "dynamo_kv_prefix_fetch_decisions",
            "Fetch-vs-recompute gate outcomes by decision and donor source",
            ["decision", "source"],
        )
        self._gate_pred = reg.histogram(
            "dynamo_kv_prefix_fetch_pred_seconds",
            "Fetch-vs-recompute gate cost predictions",
            ["kind"],
            buckets=rtm.TRANSFER_LATENCY_BUCKETS,
        )
        # transfer_ms: (nbytes, src_id, dst_id) -> predicted ms or None --
        # normally FleetObservatory.predict_transfer_ms, which also fits
        # the G4 store link (src/dst G4_STORE_ID) from TransferLog rows
        self._transfer_ms = transfer_ms
        spec = dict(remote_spec or {})
        self._prefill_tok_s = float(spec.get("prefill_tok_s", 4000.0))
        self._gbps = float(spec.get("gbps", 1.0))
        self.decisions_log: list = []

    def _gate_donor(
        self,
        request_id: str,
        instance_id: int,
        own: int,
        donor: Dict[str, Any],
    ) -> Dict[str, Any]:
        """Adjudicate fetch-vs-recompute for one donor candidate.

        Predicted fetch cost: the observatory's fitted link model when it
        can price the (donor -> chosen worker) link, else the configured
        flat ``gbps``.  Predicted recompute cost: the saved tokens at the
        configured per-worker prefill rate.  Both estimates land as span
        attrs, metric observations, and a decisions-log row regardless of
        which way the decision goes -- the acceptance surface."""
        blocks = int(donor["blocks"])
        saved_blocks = max(blocks - own, 0)
        tokens_saved = saved_blocks * self.chooser.block_size
        pred_prefill_ms = tokens_saved / max(self._prefill_tok_s, 1e-9) * 1e3
        nbytes = donor.get("nbytes")
        pred_fetch_ms: Optional[float] = None
        ship_bytes: Optional[int] = None
        if nbytes:
            # pro-rate the advertised bytes to the blocks actually shipped:
            # the onboarder only imports blocks past the chosen worker's
            # own coverage
            ship_bytes = int(int(nbytes) * saved_blocks / max(blocks, 1))
            if self._transfer_ms is not None:
                try:
                    pred_fetch_ms = self._transfer_ms(
                        ship_bytes, donor["instance"], instance_id
                    )
                except Exception:
                    logger.debug("transfer predictor failed", exc_info=True)
            if pred_fetch_ms is None:
                pred_fetch_ms = ship_bytes / (self._gbps * 1e9) * 1e3
        # unknown bytes (a pure-G1 peer donor) cannot be priced: keep the
        # pre-gate behaviour and fetch -- the onboarder's own fallback
        # still recomputes on any failure
        decision = "fetch"
        if pred_fetch_ms is not None and pred_fetch_ms >= pred_prefill_ms:
            decision = "recompute"
        source = str(donor["source"])
        self._gate_decisions.labels(decision, source).inc()
        if pred_fetch_ms is not None:
            self._gate_pred.labels("fetch").observe(pred_fetch_ms / 1e3)
        self._gate_pred.labels("prefill").observe(pred_prefill_ms / 1e3)
        row = {
            "ts": time.time(),
            "request_id": request_id,
            "instance": instance_id,
            "donor": donor["instance"],
            "source": source,
            "decision": decision,
            "own_blocks": own,
            "donor_blocks": blocks,
            "ship_bytes": ship_bytes,
            "pred_fetch_ms": pred_fetch_ms,
            "pred_prefill_ms": pred_prefill_ms,
        }
        self.decisions_log.append(row)
        if len(self.decisions_log) > self.DECISION_LOG_CAP:
            del self.decisions_log[: -self.DECISION_LOG_CAP]
        with tracing.span(
            "router.prefill_dispatch",
            request_id,
            instance=f"{instance_id:x}",
        ) as sp:
            sp.set(
                gate_decision=decision,
                donor_source=source,
                donor_blocks=blocks,
                own_blocks=own,
                pred_fetch_ms=pred_fetch_ms,
                pred_prefill_ms=pred_prefill_ms,
            )
        return row

    async def generate(self, request: Context[Any]) -> ResponseStream[Annotated]:
        data = request.data
        if isinstance(data, PreprocessedRequest):
            token_ids = data.token_ids
        else:
            token_ids = list((data or {}).get("token_ids") or [])
        def stamp(overlap_blocks: int) -> Context[Any]:
            if isinstance(data, PreprocessedRequest):
                data.estimated_prefix_hit_num_blocks = overlap_blocks
                return request
            return request.replace(
                dict(data or {}, estimated_prefix_hit_num_blocks=overlap_blocks)
            )

        try:
            (
                instance_id,
                overlap,
                donor,
            ) = await self.chooser.find_best_match_with_donor(token_ids)
        except Exception:
            # no metrics yet / no workers known to the scheduler: degrade to
            # plain load balancing over the live instances rather than failing
            logger.debug("kv selection failed; falling back", exc_info=True)
            self._decisions.labels("fallback_no_selection").inc()
            return await self.inner.generate(request)
        if donor is not None:
            # fetch-vs-recompute gate: only stamp the donor when importing
            # its blocks is predicted cheaper than recomputing them
            gate = self._gate_donor(request.id, instance_id, overlap, donor)
            if gate["decision"] != "fetch":
                donor = None
        if donor is not None:
            # a donor holds a longer prefix and fetching won the gate:
            # tell the chosen worker where to import it from
            # (llm/prefix_onboard.py consumes this)
            from ..prefix_onboard import DONOR_META_KEY

            request.metadata[DONOR_META_KEY] = {
                "instance": donor["instance"],
                "blocks": donor["blocks"],
                "source": donor["source"],
            }
        try:
            stream = await self.inner.direct(stamp(overlap), instance_id)
            if donor is None:
                cause = "kv"
            elif donor["source"] == "remote":
                cause = "kv_remote"
            else:
                cause = "kv_donor"
            self._decisions.labels(cause).inc()
            return stream
        except (InstanceNotFoundError, ConnectionRefusedError, WorkerLostError):
            # retryable dispatch failures are exactly those where the
            # request provably never started: a stale selection (instance
            # gone from the live set), a refused connect (the worker died
            # before the lease expired), or a prologue-stage loss (the
            # worker drained its subject / the connection dropped before
            # the handler acked).  Anything later must propagate --
            # re-dispatching after the worker may have started executing
            # would run the request twice.  Clear the overlap estimate: it
            # described the dead worker's cache, not whoever the fallback
            # picks.
            logger.debug(
                "selected instance %x vanished; falling back", instance_id
            )
            self._decisions.labels("fallback_dead_instance").inc()
            return await self.inner.generate(stamp(0))
