"""Standalone cluster components: router service and metrics service.

A copy of the JAX package's ``llm/components.py`` over the port's KV
router and package-free metrics registry.  Reference parity:

- ``components/router`` (src/main.rs:28-120): a KV-router behind its own
  endpoint -- callers send ``{"token_ids": [...]}`` and get back
  ``{"worker_id": ..., "overlap_blocks": ...}``, letting non-Python
  frontends (or remote processes) use KV-aware placement without
  embedding the index.
- ``components/metrics`` (src/lib.rs:145-340, main.rs:115-258): scrapes
  worker ``ForwardPassMetrics``, subscribes to ``kv-hit-rate`` events,
  and serves cluster-level Prometheus gauges with the same family names
  (``llm_kv_blocks_active`` etc.), so reference dashboards translate.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
from typing import Any, AsyncIterator, Optional

from ..runtime.metrics import MetricsRegistry
from ..runtime.component import Component, DistributedRuntime, Namespace
from ..runtime.engine import Annotated, Context, EngineFn, ResponseStream
from .kv_router.router import KV_HIT_RATE_SUBJECT, KvRouter
from .kv_router.scheduler import KvRouterConfig

logger = logging.getLogger("dynamo.components")

ROUTER_COMPONENT = "router"


class RouterService:
    """Serve KV-aware worker selection as its own endpoint."""

    def __init__(
        self,
        runtime: DistributedRuntime,
        namespace: str,
        worker_component: str = "backend",
        block_size: int = 16,
        config: Optional[KvRouterConfig] = None,
        index_shards: int = 1,
    ) -> None:
        self.runtime = runtime
        self.ns = runtime.namespace(namespace)
        self.router = KvRouter(
            self.ns,
            self.ns.component(worker_component),
            block_size=block_size,
            config=config,
            index_shards=index_shards,
        )

    async def start(self) -> None:
        await self.router.start()
        await (
            self.ns.component(ROUTER_COMPONENT)
            .endpoint("generate")
            .serve(EngineFn(self._handle))
        )

    async def stop(self) -> None:
        await self.router.stop()

    async def _handle(self, request: Context[Any]) -> AsyncIterator[Annotated]:
        data = request.data or {}
        tokens = data.get("token_ids") or []

        async def gen() -> AsyncIterator[Annotated]:
            try:
                worker_id, overlap = await self.router.find_best_match(tokens)
                yield Annotated.from_data(
                    {"worker_id": worker_id, "overlap_blocks": overlap}
                )
            except Exception as e:
                yield Annotated.from_error(f"router: {e}")

        return ResponseStream(request.ctx, gen())


class MetricsService:
    """Cluster metrics component: aggregate worker load, expose Prometheus.

    Gauges (reference components/metrics naming): ``llm_kv_blocks_active``,
    ``llm_kv_blocks_total``, ``llm_requests_active_slots``,
    ``llm_requests_total_slots``, ``llm_load_avg``, ``llm_load_std``,
    ``llm_kv_hit_rate`` (cumulative average of per-selection events).
    """

    def __init__(
        self,
        runtime: DistributedRuntime,
        namespace: str,
        worker_component: str = "backend",
        scrape_interval_s: float = 0.5,
    ) -> None:
        from .kv_router.metrics_aggregator import KvMetricsAggregator

        self.runtime = runtime
        self.ns = runtime.namespace(namespace)
        self.aggregator = KvMetricsAggregator(
            self.ns.component(worker_component), interval_s=scrape_interval_s
        )
        self._metrics = MetricsRegistry()
        self.registry = self._metrics

        def g(name: str, doc: str):
            return self._metrics.gauge(name, doc, ["component"])

        self.kv_active = g("llm_kv_blocks_active", "active KV blocks")
        self.kv_total = g("llm_kv_blocks_total", "total KV blocks")
        self.slots_active = g("llm_requests_active_slots", "active request slots")
        self.slots_total = g("llm_requests_total_slots", "total request slots")
        self.load_avg = g("llm_load_avg", "average worker load (kv usage)")
        self.load_std = g("llm_load_std", "stddev of worker load")
        self.hit_rate = g("llm_kv_hit_rate", "avg overlap/isl across selections")
        self._hit_events = 0
        self._hit_sum = 0.0
        self._sub = None
        self._sub_task: Optional[asyncio.Task] = None
        self._http: Optional[asyncio.AbstractServer] = None
        self._component_label = worker_component

    async def start(self) -> None:
        await self.aggregator.start()
        self._sub = await self.ns.subscribe(KV_HIT_RATE_SUBJECT)
        self._sub_task = asyncio.create_task(
            self._consume_hit_rate(), name="metrics-hit-rate"
        )

    async def stop(self) -> None:
        if self._sub_task is not None:
            self._sub_task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._sub_task
        if self._sub is not None:
            await self._sub.close()
        if self._http is not None:
            self._http.close()
            with contextlib.suppress(Exception):
                await asyncio.wait_for(self._http.wait_closed(), 5.0)
            self._http = None
        await self.aggregator.stop()

    async def _consume_hit_rate(self) -> None:
        assert self._sub is not None
        async for _subject, payload in self._sub:
            try:
                ev = json.loads(payload)
                isl = max(int(ev.get("isl_blocks", 0)), 1)
                self._hit_events += 1
                self._hit_sum += int(ev.get("overlap_blocks", 0)) / isl
            except Exception:
                logger.debug("bad kv-hit-rate payload", exc_info=True)

    def render(self) -> tuple:
        """(payload, content_type) -- refresh gauges from the latest scrape
        and render the Prometheus text exposition."""
        eps = self.aggregator.endpoints
        label = self._component_label
        kv_active = kv_total = sa = st = 0
        loads = []
        for m in eps.endpoints.values():
            kv_active += m.kv_active_blocks
            kv_total += m.kv_total_blocks
            sa += m.request_active_slots
            st += m.request_total_slots
            loads.append(m.gpu_cache_usage_perc)
        self.kv_active.labels(label).set(kv_active)
        self.kv_total.labels(label).set(kv_total)
        self.slots_active.labels(label).set(sa)
        self.slots_total.labels(label).set(st)
        if loads:
            avg = sum(loads) / len(loads)
            var = sum((l - avg) ** 2 for l in loads) / len(loads)
            self.load_avg.labels(label).set(avg)
            self.load_std.labels(label).set(var ** 0.5)
        if self._hit_events:
            self.hit_rate.labels(label).set(self._hit_sum / self._hit_events)
        return self._metrics.render()

    async def serve_http(self, host: str = "127.0.0.1", port: int = 9091):
        """Serve ``GET /metrics`` (reference :9091); returns (host, port)."""

        async def handle(reader, writer):
            try:
                await reader.readuntil(b"\r\n\r\n")
                payload, ctype = self.render()
                head = (
                    "HTTP/1.1 200 OK\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(payload)}\r\n"
                    "Connection: close\r\n\r\n"
                )
                writer.write(head.encode() + payload)
                await writer.drain()
            except Exception:
                logger.debug("metrics scrape reply failed", exc_info=True)
            finally:
                with contextlib.suppress(Exception):
                    writer.close()
                    await writer.wait_closed()

        self._http = await asyncio.start_server(handle, host, port)
        addr = self._http.sockets[0].getsockname()
        return addr[0], addr[1]
