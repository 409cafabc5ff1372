"""KV-aware request routing.

Rebuild of the reference KV router (lib/llm/src/kv_router.rs, kv_router/
{indexer,scheduler,publisher,metrics_aggregator}.rs): a global index of
which worker holds which KV blocks, fed by worker events over the hub, a
cost-function scheduler over live worker metrics, and a PushRouter wrapper
that sends each request to the worker with the best prefix overlap.
"""

from .indexer import KvIndexer, KvIndexerSharded, OverlapScores
from .scheduler import KvRouterConfig, KvScheduler, DefaultWorkerSelector
from .publisher import KvEventPublisher, WorkerMetricsPublisher
from .metrics_aggregator import KvMetricsAggregator
from .router import KV_EVENT_SUBJECT, KvRouter, KvPushRouter

__all__ = [
    "DefaultWorkerSelector",
    "KV_EVENT_SUBJECT",
    "KvEventPublisher",
    "KvIndexer",
    "KvIndexerSharded",
    "KvMetricsAggregator",
    "KvPushRouter",
    "KvRouter",
    "KvRouterConfig",
    "KvScheduler",
    "OverlapScores",
    "WorkerMetricsPublisher",
]
