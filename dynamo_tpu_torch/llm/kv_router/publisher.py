"""Worker-side publishers: KV events to the hub + load-metrics endpoint.

Rebuild of the reference publisher (lib/llm/src/kv_router/publisher.rs:
50-99 KvEventPublisher -> NATS ``{ns}.events.kv_events``; :463-520
WorkerMetricsPublisher serving ``ForwardPassMetrics`` on a ``load_metrics``
endpoint).  No ZMQ leg: the engine is first-party, so its ``kv_event_sink``
hook feeds the publisher directly in-process.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, AsyncIterator, Callable, Dict, Optional

from ...runtime.component import Component, Instance, Namespace
from ...runtime.engine import Annotated, Context, EngineFn, ResponseStream

logger = logging.getLogger("dynamo.kv_router")

KV_EVENT_TOPIC = "kv_events"
LOAD_METRICS_ENDPOINT = "load_metrics"


class KvEventPublisher:
    """Forwards engine KV events to the hub event plane.

    Wire shape on ``{ns}.events.kv_events``::

        {"worker_id": <instance id>, "event": {"type": "stored"|...}}

    Attach with ``publisher.hook(engine)`` -- it installs itself as the
    engine's ``kv_event_sink``.  Events are queued and drained by a
    background task so the engine's hot loop never blocks on the hub.
    """

    def __init__(self, namespace: Namespace, worker_id: int) -> None:
        self.namespace = namespace
        self.worker_id = worker_id
        self._queue: "asyncio.Queue[Dict[str, Any]]" = asyncio.Queue(maxsize=4096)
        self._task: Optional[asyncio.Task] = None

    def hook(self, engine: Any) -> None:
        engine.kv_event_sink = self.emit
        if self._task is None:
            self._task = asyncio.create_task(self._pump(), name="kv-event-pub")

    def emit(self, event: Dict[str, Any]) -> None:
        try:
            self._queue.put_nowait(event)
        except asyncio.QueueFull:
            if event.get("type") == "stored":
                # dropping a stored event only under-states this worker's
                # cache -- safe (the router just misses a hit opportunity)
                logger.warning("kv event queue full; dropping stored event")
                return
            # dropping a removed/cleared event would permanently over-state
            # the index; collapse the backlog into one full resync signal
            # (the router forgets this worker and rebuilds from later events)
            logger.warning(
                "kv event queue full on %s; collapsing to cleared",
                event.get("type"),
            )
            while not self._queue.empty():
                try:
                    self._queue.get_nowait()
                except asyncio.QueueEmpty:
                    break
            self._queue.put_nowait({"type": "cleared"})

    async def _pump(self) -> None:
        while True:
            event = await self._queue.get()
            try:
                await self.namespace.publish(
                    KV_EVENT_TOPIC,
                    {"worker_id": self.worker_id, "event": event},
                )
            except Exception:
                logger.exception("kv event publish failed")

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            except Exception:
                logger.debug("publisher loop raised during close", exc_info=True)
            self._task = None


class KvHoldingsPublisher:
    """Forwards offload-tier holdings deltas to the event plane.

    Rides the same ``{ns}.events.kv_events`` subject as the G1 publisher
    -- the indexer dispatches on ``event["type"]`` (``holdings`` /
    ``holdings_cleared``), so no extra subscription is needed router-side.
    Attach with ``publisher.hook(engine)``: it installs itself as the
    engine's ``kv_holdings_sink`` (fed from the offload thread via the
    engine's loop hop).

    Overflow policy differs from the G1 publisher: a dropped ``tier=None``
    row would leave the cluster-global index advertising a tier the worker
    already dropped (a fetch that can only miss), so a full queue
    collapses the backlog into one ``holdings_cleared`` resync -- the
    index forgets this worker's tiers until fresh deltas rebuild them.
    """

    def __init__(self, namespace: Namespace, worker_id: int) -> None:
        self.namespace = namespace
        self.worker_id = worker_id
        self._queue: "asyncio.Queue[Dict[str, Any]]" = asyncio.Queue(maxsize=4096)
        self._task: Optional[asyncio.Task] = None

    def hook(self, engine: Any) -> None:
        engine.kv_holdings_sink = self.emit
        if self._task is None:
            self._task = asyncio.create_task(
                self._pump(), name="kv-holdings-pub"
            )

    def emit(self, event: Dict[str, Any]) -> None:
        try:
            self._queue.put_nowait(event)
        except asyncio.QueueFull:
            logger.warning(
                "kv holdings queue full; collapsing to holdings_cleared"
            )
            while not self._queue.empty():
                try:
                    self._queue.get_nowait()
                except asyncio.QueueEmpty:
                    break
            self._queue.put_nowait({"type": "holdings_cleared"})

    async def _pump(self) -> None:
        while True:
            event = await self._queue.get()
            try:
                await self.namespace.publish(
                    KV_EVENT_TOPIC,
                    {"worker_id": self.worker_id, "event": event},
                )
            except Exception:
                logger.exception("kv holdings publish failed")

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            except Exception:
                logger.debug("publisher loop raised during close", exc_info=True)
            self._task = None


class WorkerMetricsPublisher:
    """Serves the engine's ``ForwardPassMetrics`` on a ``load_metrics``
    endpoint (single-item stream per request)."""

    def __init__(self, metrics_fn: Callable[[], Any]) -> None:
        self._metrics_fn = metrics_fn
        self.instance: Optional[Instance] = None

    async def attach(self, component: Component) -> Instance:
        ep = component.endpoint(LOAD_METRICS_ENDPOINT)
        self.instance = await ep.serve(EngineFn(self._generate))
        return self.instance

    async def _generate(self, request: Context[Any]) -> AsyncIterator[Annotated]:
        metrics = self._metrics_fn()
        payload = metrics.to_dict() if hasattr(metrics, "to_dict") else dict(metrics)

        async def one() -> AsyncIterator[Annotated]:
            yield Annotated.from_data(payload)

        return ResponseStream(request.ctx, one())
