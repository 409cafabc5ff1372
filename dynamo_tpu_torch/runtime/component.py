"""Component model: DistributedRuntime -> Namespace -> Component -> Endpoint.

Reference parity: lib/runtime/src/component.rs (naming hierarchy, instance
registration under ``instances/{ns}/{comp}/{ep}:{lease_hex}``), endpoint.rs
(serving = register subject handler + etcd instance key under the primary
lease), client.rs (prefix watch -> live instance list).  The keyspace and subject
naming are the reference's, so operational tooling translates 1:1, but
both planes ride the first-party hub / data plane instead of etcd + NATS.
The JAX package's component model; its failover takes a flight-recorder
snapshot when a worker is lost.

Serving an endpoint:

    rt = await DistributedRuntime.detached(hub_addr)        # or .static()
    ep = rt.namespace("dynamo").component("backend").endpoint("generate")
    await ep.serve(my_engine)          # my_engine: AsyncEngine[dict, Annotated]

Calling it:

    client = await ep.client()
    router = PushRouter(client, RouterMode.ROUND_ROBIN)
    stream = await router.generate(Context.new({"prompt": ...}))
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import os
import random
import socket
import time
from dataclasses import dataclass
from enum import Enum
from functools import partial
from typing import Any, AsyncIterator, Dict, List, Optional, Set

from .engine import (
    DEADLINE_EXCEEDED_MSG,
    Annotated,
    AsyncEngine,
    AsyncEngineContext,
    Context,
    DeadlineExceededError,
    EngineFn,
    ResponseStream,
    ensure_response_stream,
)
from . import tracing
from .transports.client import HubClient, StaticHub, WatchHandle
from .transports.codec import decode_trace_context
from .transports.request_plane import (
    DataPlaneClient,
    DataPlaneServer,
    WorkerLostError,
)

logger = logging.getLogger("dynamo.runtime")

INSTANCE_ROOT_PATH = "instances"  # reference: component.rs:64


@dataclass(frozen=True)
class Instance:
    """A live serving instance of an endpoint (reference component.rs:84-96)."""

    namespace: str
    component: str
    endpoint: str
    instance_id: int  # lease id; unique per process lifetime
    host: str
    port: int
    subject: str

    @property
    def etcd_key(self) -> str:
        return (
            f"{INSTANCE_ROOT_PATH}/{self.namespace}/{self.component}/"
            f"{self.endpoint}:{self.instance_id:x}"
        )

    def to_json(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @classmethod
    def from_json(cls, blob: bytes) -> "Instance":
        return cls(**json.loads(blob))


def _advertise_host() -> str:
    host = os.environ.get("DYN_ADVERTISE_HOST")
    if host:
        return host
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


class DistributedRuntime:
    """Cluster handle: hub client + shared data plane + primary lease.

    Reference: lib/runtime/src/distributed.rs.  ``static_mode`` (no hub
    server, in-process state) mirrors distributed.rs:85.
    """

    def __init__(self, hub, static_mode: bool) -> None:
        self.hub = hub
        self.static_mode = static_mode
        self.primary_lease: int = 0
        self.data_server = DataPlaneServer(host=os.environ.get("DYN_BIND_HOST", "0.0.0.0"))
        self.data_client = DataPlaneClient()
        self._data_server_started = False
        # Local engine registry: subject -> engine, for zero-copy in-process
        # dispatch when caller and worker share an event loop.
        self.local_engines: Dict[str, AsyncEngine] = {}
        # Per-endpoint service stats ("{ns}/{comp}/{ep}" -> EndpointStats);
        # served by the auto-registered per-component ``_stats`` endpoint
        # (the NATS $SRV.STATS equivalent, SURVEY.md 2.1 row 15)
        self.endpoint_stats: Dict[str, "EndpointStats"] = {}
        self._stats_served: set = set()
        self._shutdown = asyncio.Event()
        # every instance this process registered (drain deregisters them)
        self.served: List[Instance] = []
        self.draining = False

    # -- constructors ------------------------------------------------------

    @classmethod
    async def detached(
        cls,
        hub_addr: Optional[str] = None,
        lease_ttl: float = 5.0,
        reconnect_window: Optional[float] = None,
    ) -> "DistributedRuntime":
        """Connect to a hub (``host:port``; env ``DYN_HUB_ADDRESS``).

        ``reconnect_window`` > 0 lets the client ride out a hub restart
        (durable hub: leases + keys are restored, the client reconnects and
        resumes keepalives/watches).  None reads ``DYN_HUB_RECONNECT``
        seconds (default 0 = loss is fatal, the pre-durability behavior)."""
        addr = hub_addr or os.environ.get("DYN_HUB_ADDRESS", "127.0.0.1:6650")
        host, _, port = addr.rpartition(":")
        if reconnect_window is None:
            reconnect_window = float(os.environ.get("DYN_HUB_RECONNECT", "0"))
        hub = await HubClient(
            host or "127.0.0.1", int(port), reconnect_window=reconnect_window
        ).connect()
        rt = cls(hub, static_mode=False)
        rt.primary_lease = await hub.lease_grant(ttl=lease_ttl)
        return rt

    @classmethod
    async def static(cls, hub: Optional[StaticHub] = None) -> "DistributedRuntime":
        rt = cls(hub or StaticHub(), static_mode=True)
        rt.primary_lease = await rt.hub.lease_grant()
        return rt

    # -- lifecycle ---------------------------------------------------------

    async def ensure_data_server(self) -> None:
        if not self._data_server_started:
            self.data_server.advertise_host = (
                "127.0.0.1" if self.static_mode else _advertise_host()
            )
            await self.data_server.start()
            self._data_server_started = True

    async def shutdown(self) -> None:
        self._shutdown.set()
        with contextlib.suppress(Exception):
            if self.primary_lease and not self.static_mode:
                await self.hub.lease_revoke(self.primary_lease)
        await self.data_client.close()
        if self._data_server_started:
            await self.data_server.stop()
        await self.hub.close()

    async def wait_for_shutdown(self) -> None:
        """Block until shutdown is requested (signal handler, hub loss, or
        an explicit ``shutdown()``) -- the app-harness idle state."""
        await self._shutdown.wait()

    def request_shutdown(self) -> None:
        self._shutdown.set()

    def inflight_requests(self) -> int:
        """Requests currently being served by this process's endpoints."""
        return sum(s.in_flight for s in self.endpoint_stats.values())

    async def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful worker drain: deregister every served instance from
        discovery (watching routers drop it from selection), stop accepting
        new dispatches (a stale client's request gets a retryable
        no-handler error, which its failover sends elsewhere), then wait
        for in-flight requests to finish.  Returns True when the drain
        completed cleanly within ``timeout_s``.

        SIGTERM (supervisor scale-down, kubernetes preStop) is the
        intended trigger: drain, then exit -- no request is dropped by a
        planned shutdown."""
        if self.draining:
            return True
        self.draining = True
        logger.info(
            "draining: deregistering %d instances, %d requests in flight",
            len(self.served), self.inflight_requests(),
        )
        for inst in self.served:
            with contextlib.suppress(Exception):
                await self.hub.kv_delete(inst.etcd_key)
            self.data_server.unregister(inst.subject)
            self.local_engines.pop(inst.subject, None)
        deadline = asyncio.get_running_loop().time() + timeout_s
        while self.inflight_requests() > 0:
            if asyncio.get_running_loop().time() >= deadline:
                logger.warning(
                    "drain timed out with %d requests still in flight",
                    self.inflight_requests(),
                )
                self._count_drain(clean=False)
                return False
            await asyncio.sleep(0.02)
        self._count_drain(clean=True)
        logger.info("drain complete")
        return True

    @staticmethod
    def _count_drain(clean: bool) -> None:
        from . import metrics as rtm

        rtm.default_registry().counter(
            "dynamo_worker_drains",
            "Graceful worker drains by outcome",
            ["outcome"],
        ).labels("clean" if clean else "timeout").inc()

    async def drain_and_shutdown(self, timeout_s: float = 30.0) -> None:
        await self.drain(timeout_s)
        self.request_shutdown()

    def namespace(self, name: str) -> "Namespace":
        return Namespace(self, name)


@dataclass
class Namespace:
    runtime: DistributedRuntime
    name: str

    def component(self, name: str) -> "Component":
        return Component(self.runtime, self.name, name)

    def event_subject(self, topic: str) -> str:
        """Events ride ``{ns}.events.{topic}`` (reference traits/events.rs)."""
        return f"{self.name}.events.{topic}"

    async def publish(self, topic: str, payload: Dict[str, Any]) -> None:
        await self.runtime.hub.publish(
            self.event_subject(topic), json.dumps(payload).encode()
        )

    async def subscribe(self, topic: str):
        return await self.runtime.hub.subscribe(self.event_subject(topic))


@dataclass
class Component:
    runtime: DistributedRuntime
    namespace: str
    name: str

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self.runtime, self.namespace, self.name, name)

    @property
    def path(self) -> str:
        return f"{self.namespace}/{self.name}"

    async def scrape_trace(
        self, request_id: Optional[str] = None, timeout_s: float = 2.0
    ) -> List[Dict[str, Any]]:
        """Collect trace spans from every live instance of this component
        (the trace analog of :meth:`scrape_stats`, consumed by the
        JAX package's ``trace`` CLI): each instance's ``_trace`` endpoint
        returns its collector's spans for ``request_id`` (or its whole
        ring); the merged span dicts assemble into one cross-process
        timeline (``tracing.chrome_trace``)."""
        ep = self.endpoint(TRACE_ENDPOINT)
        client = await ep.client()
        try:
            with contextlib.suppress(TimeoutError):
                await client.wait_for_instances(timeout_s)
            spans: List[Dict[str, Any]] = []

            async def one(instance_id: int):
                router = PushRouter(client)
                stream = await router.direct(
                    Context.new({"request_id": request_id}), instance_id
                )
                async for item in stream:
                    if isinstance(item, Annotated) and item.data is not None:
                        return item.data
                return None

            ids = [i.instance_id for i in client.instances]
            results = await asyncio.gather(
                *(asyncio.wait_for(one(i), timeout_s) for i in ids),
                return_exceptions=True,
            )
            for r in results:
                if isinstance(r, dict):
                    spans.extend(r.get("spans") or [])
            return spans
        finally:
            await client.close()

    async def scrape_stats(self, timeout_s: float = 2.0) -> List[Dict[str, Any]]:
        """Request service stats from every live instance of this component
        (the ``$SRV.STATS`` scatter-gather, reference component.rs:284).

        Returns one dict per responding instance:
        ``{"instance": id, "endpoints": {path: {requests, errors, ...}}}``;
        wedged instances are skipped after ``timeout_s``."""
        ep = self.endpoint(STATS_ENDPOINT)
        client = await ep.client()
        try:
            out: List[Dict[str, Any]] = []

            async def one(instance_id: int):
                router = PushRouter(client)
                stream = await router.direct(
                    Context.new(None), instance_id
                )
                async for item in stream:
                    if isinstance(item, Annotated) and item.data is not None:
                        return {"instance": instance_id, **item.data}
                return None

            ids = [i.instance_id for i in client.instances]
            results = await asyncio.gather(
                *(asyncio.wait_for(one(i), timeout_s) for i in ids),
                return_exceptions=True,
            )
            for r in results:
                if isinstance(r, dict):
                    out.append(r)
            return out
        finally:
            await client.close()


@dataclass
class Endpoint:
    runtime: DistributedRuntime
    namespace: str
    component: str
    name: str

    @property
    def path(self) -> str:
        return f"{self.namespace}/{self.component}/{self.name}"

    @property
    def instance_prefix(self) -> str:
        return (
            f"{INSTANCE_ROOT_PATH}/{self.namespace}/{self.component}/{self.name}:"
        )

    def subject_for(self, instance_id: int) -> str:
        # Reference subject shape: "{ns}_{comp}.{ep}-{lease_hex}"
        return f"{self.namespace}_{self.component}.{self.name}-{instance_id:x}"

    async def _register(self, register_subject) -> Instance:
        """Shared registration: bind the subject on the data-plane server
        (via ``register_subject(subject)``) and write the instance key under
        the runtime's primary lease: lease loss removes the key, and every
        watching client drops the instance — identical liveness semantics to
        reference endpoint.rs:115-134."""
        rt = self.runtime
        await rt.ensure_data_server()
        instance_id = rt.primary_lease
        subject = self.subject_for(instance_id)
        host, port = rt.data_server.address
        instance = Instance(
            namespace=self.namespace,
            component=self.component,
            endpoint=self.name,
            instance_id=instance_id,
            host=host,
            port=port,
            subject=subject,
        )
        register_subject(subject)
        created = await rt.hub.kv_create(
            instance.etcd_key, instance.to_json(), lease=rt.primary_lease
        )
        if not created:
            await rt.hub.kv_put(
                instance.etcd_key, instance.to_json(), lease=rt.primary_lease
            )
        rt.served.append(instance)
        logger.info("serving %s as instance %x at %s:%d",
                    self.path, instance_id, host, port)
        return instance

    async def serve(
        self,
        engine: AsyncEngine,
        *,
        metrics_handler=None,
    ) -> Instance:
        """Serve ``engine`` on this endpoint."""
        rt = self.runtime
        comp_path = f"{self.namespace}/{self.component}"
        stats = rt.endpoint_stats.setdefault(self.path, EndpointStats())
        handler = _IngressHandler(
            engine,
            stats,
            component=comp_path,
            # the reserved scrape endpoints must not trace themselves: a
            # dashboard polling _trace/_stats would churn the very span
            # ring it is reading
            traced=self.name not in (STATS_ENDPOINT, TRACE_ENDPOINT),
        )

        def register(subject: str) -> None:
            rt.data_server.register(subject, handler)
            rt.local_engines[subject] = engine

        instance = await self._register(register)
        # process-level component tag for spans opened off the ingress task
        # (engine executor threads); first-served component names the process
        if not tracing.collector.component:
            tracing.collector.component = comp_path
        # auto-serve the component's $SRV.STATS equivalent + trace scrape once
        if (
            self.name not in (STATS_ENDPOINT, TRACE_ENDPOINT)
            and comp_path not in rt._stats_served
        ):
            rt._stats_served.add(comp_path)
            await Endpoint(
                rt, self.namespace, self.component, STATS_ENDPOINT
            ).serve(EngineFn(partial(_stats_handler, rt, self.namespace)))
            await Endpoint(
                rt, self.namespace, self.component, TRACE_ENDPOINT
            ).serve(EngineFn(_trace_handler))
        return instance

    async def serve_raw(self, handler) -> Instance:
        """Serve a raw streaming byte handler (upload-capable) on this
        endpoint.  Same discovery/lease semantics as :meth:`serve`, but the
        handler receives ``(hdr, chunks: AsyncIterator[bytes], ctx)`` and
        yields raw response payloads -- no JSON envelope.  This is the bulk
        data path (disagg KV delivery); the reference's equivalent capability
        is the NIXL transfer plane (block_manager/storage/nixl.rs)."""
        rt = self.runtime
        return await self._register(
            lambda subject: rt.data_server.register_raw(subject, handler)
        )

    async def client(self) -> "Client":
        c = Client(self)
        await c.start()
        return c


STATS_ENDPOINT = "_stats"  # reserved; the $SRV.STATS-equivalent endpoint
TRACE_ENDPOINT = "_trace"  # reserved; per-component trace-span scrape


@dataclass
class EndpointStats:
    """Per-endpoint service counters (reference: NATS micro endpoint stats
    surfaced via $SRV.STATS; service.rs stats handler)."""

    requests: int = 0
    errors: int = 0
    in_flight: int = 0
    processing_ms_total: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        avg = self.processing_ms_total / self.requests if self.requests else 0.0
        return {
            "num_requests": self.requests,
            "num_errors": self.errors,
            "in_flight": self.in_flight,
            "processing_ms_total": round(self.processing_ms_total, 3),
            "average_processing_ms": round(avg, 3),
        }


async def _stats_handler(rt, namespace, request):
    """One-item stream with every endpoint's counters in this process."""
    del namespace, request

    async def gen():
        yield Annotated.from_data(
            {
                "endpoints": {
                    path: s.to_dict() for path, s in rt.endpoint_stats.items()
                }
            }
        )

    return gen()


async def _trace_handler(request):
    """One-item stream with this process's spans for a request id (request
    data ``{"request_id": ...}``; no id returns the whole ring) -- the
    per-component scrape behind ``Component.scrape_trace`` and the
    JAX package's ``trace`` CLI."""
    data = request.data if isinstance(request.data, dict) else None
    rid = (data or {}).get("request_id")
    if rid:
        spans = [s.to_dict() for s in tracing.collector.get(rid)]
    else:
        spans = tracing.collector.dump()

    async def gen():
        yield Annotated.from_data(
            {"component": tracing.collector.component, "spans": spans}
        )

    return gen()


class _NullSpan:
    """Stateless stand-in for untraced ingress paths (shared instance)."""

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _IngressHandler:
    """Byte-level ingress: JSON payload -> Context -> engine -> JSON items.

    Reference: Ingress::handle_payload (network/ingress/push_handler.rs:25) —
    rebuild the Context with the caller's request id so cancellation and
    tracing stay end-to-end.
    """

    def __init__(
        self,
        engine: AsyncEngine,
        stats: Optional[EndpointStats] = None,
        component: str = "",
        traced: bool = True,
    ) -> None:
        self.engine = engine
        self.stats = stats
        self.component = component
        self.traced = traced

    async def __call__(
        self, hdr: Dict[str, Any], payload: bytes, ctx: AsyncEngineContext
    ) -> AsyncIterator[bytes]:
        data = json.loads(payload) if payload else None
        request = Context(data=data, ctx=ctx, metadata=hdr.get("meta") or {})
        stats = self.stats
        t0 = time.monotonic()
        # Ingress span: child of the caller's egress span (trace context
        # decoded from the frame header), opened BEFORE the engine runs so
        # everything the engine dispatches downstream -- nested egress hops,
        # executor-thread engine spans (via the request-id binding) -- links
        # under it.  Manually paired: it closes when the stream ends.
        if self.traced:
            parent = None
            if tracing.collector.enabled:
                parent = tracing.TraceContext.from_wire(
                    decode_trace_context(hdr)
                )
            sp = tracing.span(
                "ingress",
                request.id,
                parent=parent,
                component=self.component or None,
                bind=True,
                subject=hdr.get("subject", ""),
            )
        else:
            sp = _NULL_SPAN
        sp.__enter__()
        if stats is not None:
            stats.requests += 1
            stats.in_flight += 1
        try:
            stream = await self.engine.generate(request)
        except BaseException as exc:
            if stats is not None:
                stats.errors += 1
                stats.in_flight -= 1
                stats.processing_ms_total += (time.monotonic() - t0) * 1e3
            sp.__exit__(type(exc), exc, exc.__traceback__)
            raise

        async def gen() -> AsyncIterator[bytes]:
            # Wire contract: every item is an Annotated envelope.  Engines may
            # yield Annotated (signals/errors) or raw payloads (wrapped here).
            failed = False
            n_items = 0
            try:
                async for item in stream:
                    if not isinstance(item, Annotated):
                        item = Annotated.from_data(item)
                    if item.is_error():
                        failed = True
                    n_items += 1
                    yield json.dumps(item.to_dict()).encode()
            except BaseException:
                failed = True
                raise
            finally:
                sp.set(items=n_items, error=failed)
                if ctx.deadline_expired():
                    sp.set(deadline_expired=True)
                sp.__exit__(None, None, None)
                if stats is not None:
                    stats.in_flight -= 1
                    stats.errors += 1 if failed else 0
                    stats.processing_ms_total += (
                        time.monotonic() - t0
                    ) * 1e3

        return gen()


class Client:
    """Endpoint client: live instance list via hub prefix watch.

    Reference: component/client.rs (etcd prefix watcher -> watch channel of
    ``Vec<Instance>``).
    """

    def __init__(self, endpoint: Endpoint) -> None:
        self.endpoint = endpoint
        self.instances: List[Instance] = []
        self._by_key: Dict[str, Instance] = {}
        self._watch: Optional[WatchHandle] = None
        self._task: Optional[asyncio.Task] = None
        self._changed = asyncio.Event()

    async def start(self) -> None:
        self._watch = await self.endpoint.runtime.hub.watch_prefix(
            self.endpoint.instance_prefix
        )
        for key, value in self._watch.snapshot:
            self._by_key[key] = Instance.from_json(value)
        self._rebuild()
        self._task = asyncio.create_task(self._pump())

    def _rebuild(self) -> None:
        self.instances = sorted(
            self._by_key.values(), key=lambda i: i.instance_id
        )
        self._changed.set()

    async def _pump(self) -> None:
        assert self._watch is not None
        with contextlib.suppress(asyncio.CancelledError):
            while True:
                ev = await self._watch.events.get()
                if ev.type == "put":
                    self._by_key[ev.key] = Instance.from_json(ev.value)
                else:
                    self._by_key.pop(ev.key, None)
                self._rebuild()

    async def wait_for_instances(self, timeout: float = 10.0) -> List[Instance]:
        deadline = asyncio.get_running_loop().time() + timeout
        while not self.instances:
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                raise TimeoutError(
                    f"no instances for {self.endpoint.path} after {timeout}s"
                )
            self._changed.clear()
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._changed.wait(), remaining)
        return self.instances

    def instance_ids(self) -> List[int]:
        return [i.instance_id for i in self.instances]

    async def close(self) -> None:
        if self._task:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
        if self._watch:
            await self._watch.close()


class InstanceNotFoundError(RuntimeError):
    """direct() addressed an instance no longer in the live set (stale
    selection -- the worker died between the choice and the dispatch)."""


class NoInstancesError(RuntimeError):
    """No (non-excluded) live instance to dispatch to."""


class RouterMode(str, Enum):
    ROUND_ROBIN = "round_robin"
    RANDOM = "random"
    DIRECT = "direct"


@dataclass
class FailoverPolicy:
    """Bounded request-level failover: a worker lost before it delivered
    any response item is retried on a *different* instance (the failed one
    is excluded from selection) after a full-jitter backoff.  A worker
    lost after output reached the caller is never retried -- redispatching
    could duplicate delivered tokens -- so mid-stream death degrades to an
    immediate error frame instead.

    Env defaults: ``DYN_FAILOVER_ATTEMPTS`` (redispatch budget),
    ``DYN_FAILOVER_BACKOFF_S`` (backoff base)."""

    max_redispatches: int = 2
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 1.0

    @classmethod
    def from_env(cls) -> "FailoverPolicy":
        return cls(
            max_redispatches=int(os.environ.get("DYN_FAILOVER_ATTEMPTS", "2")),
            backoff_base_s=float(
                os.environ.get("DYN_FAILOVER_BACKOFF_S", "0.05")
            ),
        )

    def backoff_s(self, redispatch_index: int) -> float:
        """Full jitter over an exponentially-growing window: concurrent
        failovers off one dead worker spread out instead of stampeding the
        survivors in lockstep."""
        window = min(
            self.backoff_cap_s, self.backoff_base_s * (2 ** redispatch_index)
        )
        return random.uniform(0.0, window)


# Transport-shaped dispatch failures: the request provably delivered
# nothing, so redispatch to another instance cannot duplicate output.
# (WorkerLostError covers conn loss + drained subjects; OSError covers
# refused/failed dials; InstanceNotFoundError covers stale selections.)
_RETRYABLE = (WorkerLostError, InstanceNotFoundError, OSError)


class PushRouter:
    """Instance selection + remote dispatch (reference push_router.rs:35-203).

    ``generate`` picks an instance (round-robin / random), ``direct`` targets
    a specific instance id (the KV router uses this after best-match).
    Yields :class:`Annotated` items.  With a :class:`FailoverPolicy`
    attached, ``generate`` additionally survives worker death before the
    first response item by redispatching to a surviving instance.
    """

    def __init__(
        self,
        client: Client,
        mode: RouterMode = RouterMode.ROUND_ROBIN,
        failover: Optional[FailoverPolicy] = None,
    ) -> None:
        self.client = client
        self.mode = mode
        self.failover = failover
        self._rr = 0

    def _pick(self, exclude: Optional[Set[int]] = None) -> Instance:
        instances = self.client.instances
        if exclude:
            instances = [
                i for i in instances if i.instance_id not in exclude
            ]
        if not instances:
            raise NoInstancesError(
                f"no instances available for {self.client.endpoint.path}"
            )
        if self.mode == RouterMode.RANDOM:
            return random.choice(instances)
        inst = instances[self._rr % len(instances)]
        self._rr += 1
        return inst

    async def generate(
        self, request: Context[Any]
    ) -> ResponseStream[Annotated]:
        if self.failover is not None:
            return ResponseStream(request.ctx, self._failover_gen(request))
        return await self._dispatch(self._pick(), request)

    @staticmethod
    def _count_redispatch(stage: str) -> None:
        from . import metrics as rtm

        rtm.default_registry().counter(
            "dynamo_router_redispatches",
            "Failover redispatches by stage "
            "(dispatch = connect/prologue failed, "
            "before_first_token = stream died with nothing delivered)",
            ["stage"],
        ).labels(stage).inc()

    @staticmethod
    def _flightrec_worker_lost(
        stage: str, instance_id: int, request_id: str
    ) -> None:
        """Worker-loss failover edge: snapshot the flight recorder so the
        postmortem has the tick ring and queue state from the moment of
        loss."""
        from . import profiling

        profiling.flight_recorder.snapshot(
            "worker_lost",
            stage=stage,
            instance_id=f"{instance_id:x}",
            request_id=request_id,
        )

    async def _failover_gen(
        self, request: Context[Any]
    ) -> AsyncIterator[Annotated]:
        """The failover dispatch loop.  Worker loss *before* any response
        item: exclude the instance, back off with full jitter, redispatch.
        Worker loss *after* output was delivered: immediate error frame
        (never a hang, never a duplicate).  Budget exhausted: error frame
        naming the last failure."""
        policy = self.failover
        assert policy is not None
        excluded: Set[int] = set()
        last_exc: Optional[BaseException] = None
        attempts = policy.max_redispatches + 1
        for attempt in range(attempts):
            if attempt:
                await asyncio.sleep(policy.backoff_s(attempt - 1))
            if request.ctx.is_stopped():
                return
            try:
                inst = self._pick(exclude=excluded)
            except NoInstancesError as e:
                # everyone is dead or excluded; the backoff window also
                # gives the instance watch time to deliver replacements
                last_exc = e
                continue
            try:
                stream = await self._dispatch(inst, request)
            except DeadlineExceededError as e:
                yield Annotated.from_error(str(e) or DEADLINE_EXCEEDED_MSG)
                return
            except _RETRYABLE as e:
                excluded.add(inst.instance_id)
                last_exc = e
                self._count_redispatch("dispatch")
                self._flightrec_worker_lost(
                    "dispatch", inst.instance_id, request.id
                )
                logger.warning(
                    "dispatch to %x failed (%s); redispatching",
                    inst.instance_id, e,
                )
                continue
            delivered = False
            try:
                async for item in stream:
                    delivered = True
                    yield item
                return
            except DeadlineExceededError as e:
                yield Annotated.from_error(str(e) or DEADLINE_EXCEEDED_MSG)
                return
            except _RETRYABLE as e:
                if delivered:
                    # output already reached the caller: a redispatch could
                    # duplicate it -- fail fast with an error frame instead
                    self._flightrec_worker_lost(
                        "mid_stream", inst.instance_id, request.id
                    )
                    yield Annotated.from_error(
                        f"worker {inst.instance_id:x} lost mid-stream: {e}"
                    )
                    return
                excluded.add(inst.instance_id)
                last_exc = e
                self._count_redispatch("before_first_token")
                self._flightrec_worker_lost(
                    "before_first_token", inst.instance_id, request.id
                )
                logger.warning(
                    "worker %x lost before first token (%s); redispatching",
                    inst.instance_id, e,
                )
                continue
        yield Annotated.from_error(
            f"dispatch failed after {attempts} attempts: {last_exc}"
        )

    def _find_instance(self, instance_id: int) -> Instance:
        for inst in self.client.instances:
            if inst.instance_id == instance_id:
                return inst
        raise InstanceNotFoundError(f"instance {instance_id:x} not found")

    async def direct(
        self, request: Context[Any], instance_id: int
    ) -> ResponseStream[Annotated]:
        return await self._dispatch(self._find_instance(instance_id), request)

    async def direct_upload(
        self,
        instance_id: int,
        request_id: str,
        meta: Dict[str, Any],
        chunks: Any,
        ctx,
    ) -> AsyncIterator[bytes]:
        """Stream a bulk upload to a specific instance's raw endpoint and
        return its raw response iterator (the P2P KV delivery path)."""
        inst = self._find_instance(instance_id)
        rt = self.client.endpoint.runtime
        return await rt.data_client.request_upload(
            inst.host, inst.port, inst.subject, request_id, meta, chunks, ctx,
            trace=tracing.wire_context(request_id),
        )

    async def direct_raw(
        self,
        instance_id: int,
        request_id: str,
        meta: Dict[str, Any],
        payload: bytes,
        ctx,
    ) -> AsyncIterator[bytes]:
        """Plain request to a raw endpoint, yielding raw response payloads
        (no Annotated/JSON envelope) -- the bulk download path (cross-worker
        block export)."""
        inst = self._find_instance(instance_id)
        rt = self.client.endpoint.runtime
        return await rt.data_client.request(
            inst.host, inst.port, inst.subject, request_id, meta, payload, ctx,
            trace=tracing.wire_context(request_id),
        )

    async def random(self, request: Context[Any]) -> ResponseStream[Annotated]:
        self.mode = RouterMode.RANDOM
        return await self.generate(request)

    async def round_robin(self, request: Context[Any]) -> ResponseStream[Annotated]:
        self.mode = RouterMode.ROUND_ROBIN
        return await self.generate(request)

    async def _dispatch(
        self, inst: Instance, request: Context[Any]
    ) -> ResponseStream[Annotated]:
        rt = self.client.endpoint.runtime
        # Deadline check at the hop: an expired budget never dispatches --
        # the caller gets its fast 504 without spending a worker on it.
        dl = request.ctx.deadline_remaining()
        if dl is not None and dl <= 0:
            raise DeadlineExceededError()
        # In-process fast path: skip serialization when the instance lives in
        # this very process (static mode pipelines).  Items are wrapped into
        # the same Annotated envelope the remote path produces, so the stream
        # type does not depend on deployment mode.
        local = rt.local_engines.get(inst.subject)
        if local is not None:
            stream = ensure_response_stream(
                request.ctx, await local.generate(request)
            )

            async def local_gen() -> AsyncIterator[Annotated]:
                async for item in stream:
                    if not isinstance(item, Annotated):
                        item = Annotated.from_data(item)
                    yield item

            return ResponseStream(request.ctx, local_gen())

        payload = json.dumps(request.data).encode()
        # Egress span: covers send + prologue; its context rides the frame
        # header so the remote ingress span links under it.  Disabled
        # tracing: span.__enter__ is one attribute check, esp.context is
        # None, and the frame carries no trace field.
        with tracing.span(
            "egress",
            request.id,
            target=self.client.endpoint.path,
            instance=f"{inst.instance_id:x}",
        ) as esp:
            c = esp.context
            byte_stream = await rt.data_client.request(
                inst.host,
                inst.port,
                inst.subject,
                request.id,
                request.metadata,
                payload,
                request.ctx,
                trace=c.to_wire() if c is not None else None,
                # remaining budget rides the frame header next to the trace
                # context; the hop's transit time decrements it naturally
                deadline=dl,
            )

        async def gen() -> AsyncIterator[Annotated]:
            async for raw in byte_stream:
                yield Annotated.from_dict(json.loads(raw))

        return ResponseStream(request.ctx, gen())
