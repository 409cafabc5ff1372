"""Router-side metrics scraping: poll every worker's load_metrics endpoint.

Rebuild of the reference aggregator (lib/llm/src/kv_router/
metrics_aggregator.rs:31-60): periodically collect ``ForwardPassMetrics``
from each live instance of the component's ``load_metrics`` endpoint into a
``ProcessedEndpoints`` snapshot.  The snapshot object is shared with the
scheduler (passed in by the KvRouter) so there is exactly one copy of
worker-load truth; the scheduler's predictive bumps land on it and the next
scrape overwrites them.  The reference scrapes NATS ``$SRV.STATS``; here
the workers serve a first-class endpoint the aggregator calls directly.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from typing import Callable, Optional

from ...protocols.common import ForwardPassMetrics
from ...runtime import metrics as rtm
from ...runtime.component import Client, Component, PushRouter
from ...runtime.engine import Context
from .publisher import LOAD_METRICS_ENDPOINT
from .scheduler import ProcessedEndpoints

logger = logging.getLogger("dynamo.kv_router")


class KvMetricsAggregator:
    """Background scrape loop feeding a shared ProcessedEndpoints snapshot."""

    def __init__(
        self,
        component: Component,
        interval_s: float = 0.2,
        endpoints: Optional[ProcessedEndpoints] = None,
        on_remove: Optional[Callable[[int], None]] = None,
    ) -> None:
        self.component = component
        self.interval_s = interval_s
        self.endpoints = endpoints if endpoints is not None else ProcessedEndpoints()
        self.on_remove = on_remove
        # a wedged worker must not stall the whole control loop
        self.scrape_timeout_s = max(interval_s * 5, 1.0)
        self._client: Optional[Client] = None
        self._router: Optional[PushRouter] = None
        self._task: Optional[asyncio.Task] = None
        # per-worker KV load, exported from the router's vantage point (the
        # planner and dashboards read the same snapshot routing runs on)
        self._kv_load = rtm.default_registry().gauge(
            "dynamo_kv_router_worker_kv_load",
            "Per-worker KV cache usage as last scraped by the router",
            ["worker"],
        )

    async def start(self) -> None:
        ep = self.component.endpoint(LOAD_METRICS_ENDPOINT)
        self._client = await ep.client()
        self._router = PushRouter(self._client)
        self._task = asyncio.create_task(self._loop(), name="kv-metrics-scrape")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._task
            self._task = None
        if self._client is not None:
            await self._client.close()

    async def _scrape_instance(self, instance_id: int) -> None:
        assert self._router is not None
        stream = await self._router.direct(Context.new({}), instance_id)
        async for item in stream:
            if item.data is not None:
                m = ForwardPassMetrics.from_dict(item.data)
                self.endpoints.update(instance_id, m)
                self._kv_load.labels(f"{instance_id:x}").set(
                    m.gpu_cache_usage_perc
                )

    async def scrape_once(self) -> ProcessedEndpoints:
        assert self._client is not None
        live = {i.instance_id for i in self._client.instances}
        for worker_id in list(self.endpoints.endpoints):
            if worker_id not in live:
                self.endpoints.remove(worker_id)
                with contextlib.suppress(KeyError):
                    self._kv_load.remove(f"{worker_id:x}")
                if self.on_remove is not None:
                    self.on_remove(worker_id)
        # scrape concurrently: one wedged worker costs scrape_timeout_s in
        # total, not per instance, and cycle latency stays flat in fleet size
        async def one(instance_id: int) -> None:
            try:
                await asyncio.wait_for(
                    self._scrape_instance(instance_id),
                    timeout=self.scrape_timeout_s,
                )
            except Exception:
                logger.debug("metrics scrape failed for %x", instance_id,
                             exc_info=True)

        await asyncio.gather(
            *(one(inst.instance_id) for inst in list(self._client.instances))
        )
        return self.endpoints

    async def _loop(self) -> None:
        while True:
            await self.scrape_once()
            await asyncio.sleep(self.interval_s)
