"""The port's component model (``runtime/component.py``) and the runtime
pieces around it, against the JAX package where they meet.

* ``runtime/engine.py``: ``EngineFn``, ``AsyncEngineContext.link_child`` and
  ``is_complete`` behave as the JAX package's.
* ``dyn://`` endpoint ids parse as the JAX package parses them.
* Namespaces, components and endpoints: a port worker registers the JAX
  keyspace and subject, so a JAX client finds and calls it, and a port
  client calls a JAX worker.
* ``PushRouter``: round robin cycles the workers in order, random stays on
  live workers, direct reaches each instance, and a missing instance is an
  error.
* Failover: a worker lost before its first item (the injected crash, and a
  worker whose data plane is gone) is redispatched to a survivor, counted in
  ``dynamo_router_redispatches``; a loss after output reached the caller is
  an error frame.
* Drain: the drained instance leaves discovery, its in-flight request
  finishes, later requests go to the survivor.
* Tracing: a JAX caller's trace context reaches the port worker's ingress
  span; with tracing off no header is sent.
* ``RuntimeConfig``, the ``Worker`` harness and the runtime utilities.

Every wait is bounded; every runtime shuts down in ``finally``.
"""

from __future__ import annotations

import asyncio
import time

import pytest

from dynamo_tpu.protocols import endpoint as jax_endpoint
from dynamo_tpu.runtime import component as jax_component
from dynamo_tpu.runtime import engine as jax_engine
from dynamo_tpu.runtime import tracing as jax_tracing
from dynamo_tpu_torch.protocols import endpoint as port_endpoint
from dynamo_tpu_torch.runtime import component as port_component
from dynamo_tpu_torch.runtime import engine as port_engine
from dynamo_tpu_torch.runtime import config as port_config
from dynamo_tpu_torch.runtime import faults
from dynamo_tpu_torch.runtime import metrics as rtm
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime import utils
from dynamo_tpu_torch.runtime.component import (
    DistributedRuntime,
    FailoverPolicy,
    InstanceNotFoundError,
    PushRouter,
    RouterMode,
)
from dynamo_tpu_torch.runtime.engine import (
    Annotated,
    Context,
    EngineFn,
    ResponseStream,
)
from dynamo_tpu_torch.runtime.transports.hub import HubServer

WAIT_S = 10


class CountEngine:
    """``{"n": N, "sleep": s}`` -> N items ``{"i": k, "worker": name}``."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.calls = 0

    async def generate(self, request):
        self.calls += 1
        data = request.data
        ctx = request.ctx

        async def gen():
            for i in range(data["n"]):
                if ctx.is_stopped():
                    return
                yield {"i": i, "worker": self.name}
                await asyncio.sleep(data.get("sleep", 0))

        return ResponseStream(ctx, gen())


def sample(name: str, labels: dict) -> float:
    """One series of the process-wide registry, 0 when absent."""
    body, _ = rtm.default_registry().render()
    want = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    for line in body.decode().splitlines():
        if line.startswith(f"{name}{{{want}}} "):
            return float(line.split()[-1])
    return 0.0


async def wait_for(cond, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        await asyncio.sleep(0.02)


class Cluster:
    """A hub, N port workers serving CountEngines on t.backend.generate and
    a port caller with a client of that endpoint."""

    async def start(self, n: int, worker_pkg=None):
        self.hub = HubServer()
        host, port = await self.hub.start()
        self.addr = f"{host}:{port}"
        self.workers, self.engines = [], []
        rt_cls = (worker_pkg or DistributedRuntime)
        for k in range(n):
            rt = await rt_cls.detached(self.addr)
            eng = CountEngine(f"w{k}")
            await rt.namespace("t").component("backend").endpoint("generate").serve(eng)
            self.workers.append(rt)
            self.engines.append(eng)
        self.caller = await DistributedRuntime.detached(self.addr)
        self.client = await (
            self.caller.namespace("t").component("backend").endpoint("generate").client()
        )
        await wait_for(lambda: len(self.client.instances) == n, "workers never registered")
        return self

    async def stop(self):
        await self.client.close()
        await self.caller.shutdown()
        for rt in self.workers:
            await rt.shutdown()
        await self.hub.stop()


def cluster_test(run, n, fn, worker_pkg=None):
    async def body():
        cluster = await Cluster().start(n, worker_pkg)
        try:
            await asyncio.wait_for(fn(cluster), 60)
        finally:
            await cluster.stop()

    run(body())


async def collect(stream):
    items, errors = [], []
    async for item in stream:
        if not isinstance(item, Annotated):
            item = Annotated.from_data(item)
        if item.is_error():
            errors.append(item.error_message())
        else:
            items.append(item.data)
    return items, errors


# -- the engine interface ---------------------------------------------------------


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_context_link_child_and_complete(pkg):
    eng = {"port": port_engine, "jax": jax_engine}[pkg]
    parent, child, late = (eng.AsyncEngineContext(f"r{i}") for i in range(3))
    parent.link_child(child)
    assert not parent.is_complete()
    parent.stop_generating()
    assert child.is_stopped() and not child.is_killed()
    parent.kill()
    assert child.is_killed()
    parent.link_child(late)  # linked after the kill: killed at once
    assert late.is_killed()
    parent.set_complete()
    assert parent.is_complete() and not child.is_complete()


def test_engine_fn_adapts_a_coroutine(run):
    async def fn(request):
        async def gen():
            for x in request.data:
                yield x * 2

        return ResponseStream(request.ctx, gen())

    async def body():
        stream = await EngineFn(fn).generate(Context.new([1, 2, 3]))
        return [x async for x in stream]

    assert run(body()) == [2, 4, 6]


IDS = ["dyn://dynamo.backend.generate", "dyn://ns-1.comp_2.ep:1a2B",
       "dyn://a.b.c:", "dynamo.backend.generate", "dyn://a.b", "dyn://a.b.c.d",
       "dyn://a b.c.d", "dyn://a.b.c:xyz", ""]


@pytest.mark.parametrize("text", IDS)
def test_endpoint_ids_parse_as_jax(text):
    def parse(mod):
        try:
            eid = mod.EndpointId.parse(text)
        except ValueError as e:
            return ("error", str(e))
        return (eid.namespace, eid.component, eid.endpoint, eid.instance, str(eid))

    assert parse(port_endpoint) == parse(jax_endpoint)


# -- components across packages ---------------------------------------------------


@pytest.mark.parametrize("caller_pkg", ["jax", "port"])
def test_port_worker_found_by_either_caller(run, caller_pkg):
    """A port worker's registration (instance key, subject, address) is
    what a JAX client reads: both packages' routers reach it."""
    comp = {"jax": jax_component, "port": port_component}[caller_pkg]
    ctx_mod = {"jax": jax_engine, "port": port_engine}[caller_pkg]

    async def fn(cluster):
        caller = await comp.DistributedRuntime.detached(cluster.addr)
        try:
            client = await caller.namespace("t").component("backend").endpoint("generate").client()
            await asyncio.wait_for(client.wait_for_instances(WAIT_S), WAIT_S)
            assert sorted(client.instance_ids()) == sorted(cluster.client.instance_ids())
            stream = await comp.PushRouter(client).generate(ctx_mod.Context.new({"n": 3}))
            items = [x async for x in stream]
            assert [it.data["i"] for it in items] == [0, 1, 2]
            await client.close()
        finally:
            await caller.shutdown()
        keys = sorted(k for k, _ in await cluster.caller.hub.kv_get_prefix("instances/t/backend/generate:"))
        assert keys == sorted(f"instances/t/backend/generate:{i:x}" for i in cluster.client.instance_ids())

    cluster_test(run, 1, fn)


def test_port_caller_reaches_jax_worker(run):
    async def fn(cluster):
        stream = await PushRouter(cluster.client).generate(Context.new({"n": 4}))
        items, errors = await collect(stream)
        assert errors == [] and [it["i"] for it in items] == [0, 1, 2, 3]

    cluster_test(run, 1, fn, worker_pkg=jax_component.DistributedRuntime)


# -- PushRouter ------------------------------------------------------------------------


def test_push_router_round_robin_direct(run):
    async def fn(cluster):
        router = PushRouter(cluster.client, RouterMode.ROUND_ROBIN)
        seen = []
        for _ in range(6):
            items, errors = await collect(await router.generate(Context.new({"n": 1})))
            assert errors == []
            seen.append(items[0]["worker"])
        # the same cycle twice: every worker once per round
        assert seen[:3] == seen[3:] and sorted(seen[:3]) == ["w0", "w1", "w2"]
        for iid in cluster.client.instance_ids():
            items, _ = await collect(await router.direct(Context.new({"n": 2}), iid))
            assert len(items) == 2
        with pytest.raises(InstanceNotFoundError):
            await router.direct(Context.new({"n": 1}), 0xDEAD)

    cluster_test(run, 3, fn)


def test_push_router_random_stays_on_live_workers(run):
    async def fn(cluster):
        router = PushRouter(cluster.client, RouterMode.RANDOM)
        await cluster.workers[2].shutdown()
        await wait_for(lambda: len(cluster.client.instances) == 2, "instance not removed")
        seen = set()
        for _ in range(24):
            items, errors = await collect(await router.generate(Context.new({"n": 1})))
            assert errors == []
            seen.add(items[0]["worker"])
        assert seen == {"w0", "w1"}

    cluster_test(run, 3, fn)


@pytest.fixture
def injector():
    faults.injector.disable()
    yield faults.injector
    faults.injector.disable()


@pytest.mark.parametrize("how", ["crash", "dead"])
def test_failover_when_a_worker_dies(run, injector, how):
    async def fn(cluster):
        router = PushRouter(
            cluster.client, failover=FailoverPolicy(max_redispatches=2, backoff_base_s=0.01)
        )
        before = sample("dynamo_router_redispatches_total",
                        {"stage": "before_first_token" if how == "crash" else "dispatch"})
        if how == "crash":
            injector.configure("seed=3;engine.crash_before_first_token=1:max=1")
        else:
            # the worker's data plane is gone while its lease still lists it
            await cluster.workers[0].data_server.stop()
        for _ in range(2):  # round robin reaches the lost worker in two tries
            items, errors = await collect(await router.generate(Context.new({"n": 3})))
            assert errors == [] and [it["i"] for it in items] == [0, 1, 2]
        after = sample("dynamo_router_redispatches_total",
                       {"stage": "before_first_token" if how == "crash" else "dispatch"})
        # the injected crash fires once; the dead worker stays listed, so
        # every pick of it is redispatched
        assert after - before == 1 if how == "crash" else after - before >= 1

    cluster_test(run, 2, fn)


def test_loss_after_output_is_an_error_frame(run, injector):
    async def fn(cluster):
        router = PushRouter(
            cluster.client, failover=FailoverPolicy(max_redispatches=2, backoff_base_s=0.01)
        )
        injector.configure("seed=3;engine.crash_after_first_token=1:max=1")
        items, errors = await collect(await router.generate(Context.new({"n": 5})))
        assert len(items) == 1 and len(errors) == 1 and "mid-stream" in errors[0]

    cluster_test(run, 2, fn)


def test_drain_finishes_inflight_and_leaves_discovery(run):
    async def fn(cluster):
        router = PushRouter(
            cluster.client, failover=FailoverPolicy(max_redispatches=2, backoff_base_s=0.01)
        )
        before = sample("dynamo_worker_drains_total", {"outcome": "clean"})
        stream = await router.generate(Context.new({"n": 20, "sleep": 0.01}))
        consume = asyncio.ensure_future(collect(stream))
        await asyncio.sleep(0.05)
        target = next(w for w, e in zip(cluster.workers, cluster.engines) if e.calls)
        assert await target.drain(timeout_s=WAIT_S)
        assert target.inflight_requests() == 0
        items, errors = await asyncio.wait_for(consume, WAIT_S)
        assert errors == [] and len(items) == 20
        await wait_for(lambda: len(cluster.client.instances) == 1, "drained instance listed")
        survivor = next(e.name for w, e in zip(cluster.workers, cluster.engines)
                        if w is not target)
        for _ in range(3):
            items, errors = await collect(await router.generate(Context.new({"n": 1})))
            assert errors == [] and items[0]["worker"] == survivor
        assert sample("dynamo_worker_drains_total", {"outcome": "clean"}) - before == 1

    cluster_test(run, 2, fn)


# -- tracing --------------------------------------------------------------------------


@pytest.fixture
def traced():
    """Both packages' process-wide collectors on for one test, restored
    after."""
    components = [mod.collector.component for mod in (tracing, jax_tracing)]
    for mod in (tracing, jax_tracing):
        mod.collector.clear()
        mod.collector.enable()
    yield
    for mod, component in zip((tracing, jax_tracing), components):
        mod.collector.disable()
        mod.collector.clear()
        mod.collector.component = component


def test_jax_trace_context_reaches_port_worker(run, traced):
    async def fn(cluster):
        caller = await jax_component.DistributedRuntime.detached(cluster.addr)
        try:
            client = await caller.namespace("t").component("backend").endpoint("generate").client()
            await asyncio.wait_for(client.wait_for_instances(WAIT_S), WAIT_S)
            request = jax_engine.Context.new({"n": 2})
            stream = await jax_component.PushRouter(client).generate(request)
            assert len([x async for x in stream]) == 2
            await client.close()
            return request.id
        finally:
            await caller.shutdown()

    rid = []

    async def wrapped(cluster):
        rid.append(await fn(cluster))

    cluster_test(run, 1, wrapped)
    egress = [s for s in jax_tracing.collector.get(rid[0]) if s.name == "egress"]
    ingress = [s for s in tracing.collector.get(rid[0]) if s.name == "ingress"]
    assert len(egress) == 1 and len(ingress) == 1
    assert ingress[0].trace_id == egress[0].trace_id != ""
    assert ingress[0].parent_span_id == egress[0].span_id
    assert ingress[0].component == "t/backend"


def test_untraced_requests_carry_no_trace_header(run):
    seen = []

    async def fn(cluster):
        server = cluster.workers[0].data_server
        subject = next(iter(server._handlers))
        inner = server._handlers[subject]

        async def spy(hdr, payload, ctx):
            seen.append(dict(hdr))
            return await inner(hdr, payload, ctx)

        server._handlers[subject] = spy
        items, _ = await collect(await PushRouter(cluster.client).generate(Context.new({"n": 1})))
        assert items

    cluster_test(run, 1, fn)
    assert seen and "trace" not in seen[0]


# -- config and utilities ----------------------------------------------------------


def test_runtime_config_from_env(monkeypatch):
    monkeypatch.setenv("DYN_HUB_ADDRESS", "10.0.0.1:7000")
    monkeypatch.setenv("DYN_LEASE_TTL", "2.5")
    monkeypatch.setenv("DYN_TRACE", "1")
    cfg = port_config.RuntimeConfig.from_env()
    assert (cfg.hub_address, cfg.lease_ttl_s, cfg.trace) == ("10.0.0.1:7000", 2.5, True)


def test_worker_harness_runs_app_and_shuts_down(run, monkeypatch):
    async def body():
        hub = HubServer()
        host, port = await hub.start()
        try:
            cfg = port_config.RuntimeConfig(hub_address=f"{host}:{port}")
            seen = {}

            async def app(rt):
                seen["lease"] = rt.primary_lease
                await rt.namespace("t").component("c").endpoint("e").serve(CountEngine("h"))
                return 7

            assert await port_config.Worker(cfg).execute_async(app) == 7
            assert seen["lease"]
            watcher = await DistributedRuntime.detached(f"{host}:{port}")
            try:
                assert await watcher.hub.kv_get_prefix("instances/t/") == []
            finally:
                await watcher.shutdown()
        finally:
            await hub.stop()

    run(body())


def test_critical_task_and_pool(run):
    async def body():
        seen = []

        async def boom():
            await asyncio.sleep(0.01)
            raise RuntimeError("keepalive died")

        handle = utils.CriticalTaskExecutionHandle(boom(), seen.append)
        with pytest.raises(RuntimeError):
            await asyncio.wait_for(handle, WAIT_S)
        assert len(seen) == 1 and str(seen[0]) == "keepalive died"
        made = []

        def factory():
            made.append(object())
            return made[-1]

        pool = utils.Pool(factory, max_size=2)
        a = await pool.acquire()
        b = await pool.acquire()
        waiter = asyncio.ensure_future(pool.acquire())
        await asyncio.sleep(0.01)
        assert not waiter.done() and len(made) == 2
        pool.release(a)
        assert await asyncio.wait_for(waiter, WAIT_S) is a
        pool.release(b)

    run(body())
