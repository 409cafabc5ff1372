"""KvScheduler: pick the best worker from overlap scores + load metrics.

Rebuild of the reference scheduler (lib/llm/src/kv_router/scheduler.rs:
88-227 select loop + predictive load update, :248-330 DefaultWorkerSelector)
with the identical cost function:

    score  = overlap_blocks * block_size / isl_tokens
    logit  = w_overlap * score
           - w_usage   * gpu_cache_usage_perc
           - w_wait    * num_requests_waiting / max_waiting

argmax wins; ties break randomly.  After a selection the chosen worker's
load is updated predictively (waiting += 1, kv_active_blocks += uncached
blocks) so back-to-back requests spread out before the next metrics scrape
overwrites the estimates.
"""

from __future__ import annotations

import logging
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ...protocols.common import ForwardPassMetrics
from .indexer import OverlapScores


@dataclass
class KvRouterConfig:
    """Cost-function weights (reference kv_router.rs:59-100).

    ``tier_hit_weight`` extends the reference function with the offload
    plane's warmth signal: a worker whose G2/G3 tiers keep serving prefix
    hits onboards a repeat prefix from host RAM (no re-prefill), so it
    beats an otherwise-equal cold worker.  Deliberately smaller than the
    G1 overlap weight -- an HBM-resident prefix still wins outright.

    ``transfer_ms_weight`` is the NetKV-style link-cost term: when a
    selector is built with a ``transfer_cost`` source (the fleet
    observatory's learned per-link model), each candidate's logit is
    charged ``weight * predicted_seconds`` for moving the request's
    uncached KV to it.  0.0 (default) keeps the reference function
    bit-identical."""

    overlap_score_weight: float = 2.0
    gpu_cache_usage_weight: float = 1.0
    waiting_requests_weight: float = 1.0
    tier_hit_weight: float = 0.25
    transfer_ms_weight: float = 0.0


@dataclass
class KVHitRateEvent:
    """Emitted per selection (reference scheduler.rs:31-36)."""

    worker_id: int
    isl_blocks: int
    overlap_blocks: int


class NoEndpointsError(RuntimeError):
    pass


@dataclass
class ProcessedEndpoints:
    """Live per-worker load snapshot (reference scoring.rs:24)."""

    endpoints: Dict[int, ForwardPassMetrics] = field(default_factory=dict)

    def update(self, worker_id: int, metrics: ForwardPassMetrics) -> None:
        self.endpoints[worker_id] = metrics

    def remove(self, worker_id: int) -> None:
        self.endpoints.pop(worker_id, None)


class DefaultWorkerSelector:
    """The reference cost function (scheduler.rs:248-330)."""

    def __init__(
        self,
        config: Optional[KvRouterConfig] = None,
        transfer_cost: Optional[Callable[[int, int], Optional[float]]] = None,
        quarantine: Optional[Callable[[], object]] = None,
    ) -> None:
        self.config = config or KvRouterConfig()
        # (worker_id, uncached_tokens) -> predicted transfer ms, or None
        # while the link has no observations (no penalty applied) -- see
        # FleetObservatory.transfer_cost_source
        self.transfer_cost = transfer_cost
        # worker ids excluded from new placements (fleet straggler
        # quarantine: FleetObservatory.quarantine_source()); a quarantined
        # worker keeps serving what it already has, it just stops winning
        # selections until its step series recovers
        self.quarantine = quarantine

    def select_worker(
        self,
        workers: ProcessedEndpoints,
        overlap: OverlapScores,
        isl_tokens: int,
        block_size: int,
    ) -> Tuple[int, float]:
        """Returns (worker_id, best_logit).  Raises NoEndpointsError when no
        workers are known."""
        if not workers.endpoints:
            raise NoEndpointsError("no endpoints")
        isl_tokens = max(isl_tokens, 1)
        cfg = self.config

        candidates = workers.endpoints
        if self.quarantine is not None:
            try:
                bad = set(self.quarantine())
            except Exception:
                # a broken quarantine feed must not break placement
                from ...runtime.utils import log_throttled

                log_throttled(
                    logging.getLogger("dynamo.kv_router"),
                    "quarantine_source_failed",
                    "quarantine source failed; selecting from all workers",
                    exc_info=True,
                )
                bad = set()
            filtered = {
                wid: m for wid, m in candidates.items() if wid not in bad
            }
            # weight-zero, not hard-fail: if quarantine covers the whole
            # fleet, serving degraded on a known straggler beats serving
            # nothing at all
            if filtered:
                candidates = filtered

        max_waiting = max(
            (m.num_requests_waiting for m in candidates.values()),
            default=0.0,
        )
        best_logit = float("-inf")
        best: List[int] = []
        for worker_id, m in candidates.items():
            score = (
                overlap.scores.get(worker_id, 0) * block_size / isl_tokens
            )
            normalized_waiting = (
                m.num_requests_waiting / max_waiting if max_waiting > 0 else 0.0
            )
            # offload-tier warmth: only workers actually holding parked
            # blocks get the bonus, scaled by how often their tiers hit
            tier_warmth = (
                m.tier_hit_rate if getattr(m, "host_tier_blocks", 0) > 0
                or getattr(m, "disk_tier_blocks", 0) > 0 else 0.0
            )
            logit = (
                cfg.overlap_score_weight * score
                - cfg.gpu_cache_usage_weight * m.gpu_cache_usage_perc
                - cfg.waiting_requests_weight * normalized_waiting
                + cfg.tier_hit_weight * tier_warmth
            )
            if cfg.transfer_ms_weight > 0.0 and self.transfer_cost is not None:
                uncached_tokens = max(
                    isl_tokens
                    - overlap.scores.get(worker_id, 0) * block_size,
                    0,
                )
                pred_ms = self.transfer_cost(worker_id, uncached_tokens)
                if pred_ms is not None:
                    logit -= cfg.transfer_ms_weight * pred_ms / 1000.0
            if logit > best_logit:
                best_logit = logit
                best = [worker_id]
            elif logit == best_logit:
                best.append(worker_id)
        if not best:
            raise NoEndpointsError("no valid workers")
        return (best[0] if len(best) == 1 else random.choice(best)), best_logit


class KvScheduler:
    """Selection + predictive load update (reference scheduler.rs:88-232)."""

    def __init__(
        self,
        block_size: int,
        selector: Optional[DefaultWorkerSelector] = None,
    ) -> None:
        self.block_size = block_size
        self.selector = selector or DefaultWorkerSelector()
        self.workers = ProcessedEndpoints()
        self.hit_rate_events: List[KVHitRateEvent] = []
        # per-selection sink; the KvRouter wires this to publish on the
        # {ns}.events.kv-hit-rate subject (reference scheduler.rs:31-36,104)
        self.on_hit_rate: Optional[Callable[[KVHitRateEvent], None]] = None

    def update_metrics(self, worker_id: int, metrics: ForwardPassMetrics) -> None:
        self.workers.update(worker_id, metrics)

    def remove_worker(self, worker_id: int) -> None:
        self.workers.remove(worker_id)

    def schedule(self, overlap: OverlapScores, isl_tokens: int) -> int:
        worker_id, _ = self.selector.select_worker(
            self.workers, overlap, isl_tokens, self.block_size
        )
        self._process_selection(worker_id, overlap, isl_tokens)
        return worker_id

    def _process_selection(
        self, worker_id: int, overlap: OverlapScores, isl_tokens: int
    ) -> None:
        """Predictive update, overwritten by the next metrics scrape
        (reference scheduler.rs:201-232)."""
        m = self.workers.endpoints.get(worker_id)
        required_blocks = -(-isl_tokens // self.block_size)
        overlap_blocks = overlap.scores.get(worker_id, 0)
        if m is not None:
            m.num_requests_waiting += 1
            m.kv_active_blocks += max(required_blocks - overlap_blocks, 0)
            if m.kv_total_blocks:
                m.gpu_cache_usage_perc = min(
                    m.kv_active_blocks / m.kv_total_blocks, 1.0
                )
        ev = KVHitRateEvent(
            worker_id=worker_id,
            isl_blocks=required_blocks,
            overlap_blocks=overlap_blocks,
        )
        if self.on_hit_rate is not None:
            self.on_hit_rate(ev)
        else:
            # no publisher wired (standalone scheduler): keep a bounded
            # in-memory tail for introspection/tests
            self.hit_rate_events.append(ev)
            if len(self.hit_rate_events) > 1024:
                del self.hit_rate_events[:512]
