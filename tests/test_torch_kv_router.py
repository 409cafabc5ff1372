"""The port's KV router (``llm/kv_router/``) against the JAX package's.

* Indexer: the port's ``KvIndexer`` (native and pure-Python) and
  ``KvIndexerSharded`` take the same seeded event streams as the JAX
  package's -- stored chains, removals, ``cleared``, holdings deltas and
  dead workers -- and answer every query with equal ``OverlapScores``,
  block counts and holdings sources.
* Selector: ``DefaultWorkerSelector`` picks the JAX selector's worker with
  its logit on tie-free inputs, and ``KvScheduler``'s predictive updates
  give the JAX scheduler's choices over a run of requests (ties broken by
  ``random`` seeded alike in both).
* End to end, two tiny ``TorchEngine`` workers on the CPU publish their KV
  events and load metrics over a live hub: a repeated prefix goes to the
  worker that holds it with the overlap stamped into the request, that
  worker's engine counts the cached prompt tokens, every selection
  publishes its hit-rate event, and a dead worker's entries vanish from the
  index and the scheduler.  Flat and sharded index alike.
* ``KvHoldingsPublisher`` on an engine with the offload plane armed: the
  host tier's holdings reach the router's holdings index.

Every wait is bounded; every runtime shuts down in ``finally``.
"""

from __future__ import annotations

import asyncio
import json
import random
import time

import numpy as np
import pytest
import torch

from dynamo_tpu.llm.kv_router import indexer as jax_indexer
from dynamo_tpu.llm.kv_router import scheduler as jax_scheduler
from dynamo_tpu.protocols.common import ForwardPassMetrics as JaxMetrics
from dynamo_tpu_torch.engine import engine as engine_mod
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.model import init_params
from dynamo_tpu_torch.llm.kv_router import indexer as port_indexer
from dynamo_tpu_torch.llm.kv_router import scheduler as port_scheduler
from dynamo_tpu_torch.llm.kv_router.publisher import (
    KvEventPublisher,
    KvHoldingsPublisher,
    WorkerMetricsPublisher,
)
from dynamo_tpu_torch.llm.kv_router.router import KvPushRouter, KvRouter
from dynamo_tpu_torch.protocols.common import ForwardPassMetrics
from dynamo_tpu_torch.runtime.component import DistributedRuntime, PushRouter
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports.hub import HubServer
from dynamo_tpu_torch.tokens.hashing import NATIVE, hash_blocks

WAIT_S = 15
BLOCK = 4


# -- indexer --------------------------------------------------------------------


def event_stream(seed: int, n_workers: int = 5, steps: int = 120):
    """(worker, event) pairs over chains that share prefixes: stored runs
    of a chain's blocks, removals of some of them, an occasional
    ``cleared``, and holdings deltas over the offload tiers."""
    rng = np.random.default_rng(seed)
    roots = [rng.integers(0, 1000, size=40).tolist() for _ in range(4)]
    chains = []
    for r in roots:
        for cut in (8, 16, 24):
            tail = rng.integers(0, 1000, size=16).tolist()
            chains.append(hash_blocks(r[:cut] + tail, BLOCK)[1])
    out = []
    for _ in range(steps):
        w = int(rng.integers(1, n_workers + 1))
        chain = chains[int(rng.integers(len(chains)))]
        kind = rng.random()
        if kind < 0.6:
            n = int(rng.integers(1, len(chain) + 1))
            out.append((w, {"type": "stored", "blocks": [
                {"sequence_hash": h, "block_hash": i, "parent_sequence_hash": 0,
                 "position": i} for i, h in enumerate(chain[:n])]}))
        elif kind < 0.85:
            picks = rng.choice(len(chain), size=int(rng.integers(1, 4)), replace=False)
            out.append((w, {"type": "removed",
                            "sequence_hashes": [chain[int(i)] for i in picks]}))
        elif kind < 0.9:
            out.append((w, {"type": "cleared"}))
        else:
            tier = ["host", "disk", None][int(rng.integers(3))]
            n = int(rng.integers(1, len(chain) + 1))
            out.append((w, {"type": "holdings", "delta": [
                {"sequence_hash": h, "tier": tier, "nbytes": 4096} for h in chain[:n]]}))
    queries = [c for c in chains] + [chains[0][:3], []]
    return out, queries


def make_index(mod, kind: str):
    if kind == "sharded":
        return mod.KvIndexerSharded(block_size=BLOCK, num_shards=3)
    return mod.KvIndexer(block_size=BLOCK, use_native=(kind == "native"))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["native", "python", "sharded"])
def test_indexer_scores_equal_jax(kind, seed):
    if kind == "native" and NATIVE is None:
        pytest.skip("native/build/libdynnative.so is not built")
    events, queries = event_stream(seed)
    port, jax = make_index(port_indexer, kind), make_index(jax_indexer, kind)
    try:
        for step, (w, ev) in enumerate(events):
            port.apply_event(w, ev)
            jax.apply_event(w, ev)
            if step % 10 == 9:
                for q in queries:
                    assert port.find_matches(q).scores == jax.find_matches(q).scores
                assert port.num_blocks == jax.num_blocks
        holdings = port.holdings if kind != "sharded" else None
        for q in queries:
            if holdings is not None:
                assert holdings.prefix_sources(q) == jax.holdings.prefix_sources(q)
        for w in (1, 3):
            port.remove_worker(w)
            jax.remove_worker(w)
            for q in queries:
                assert port.find_matches(q).scores == jax.find_matches(q).scores
    finally:
        for ix in (port, jax):
            close = getattr(ix, "close", None)
            if close is not None:
                close()


# -- selector and scheduler ---------------------------------------------------------


def metrics_pair(rng):
    kw = dict(
        kv_active_blocks=int(rng.integers(0, 100)),
        kv_total_blocks=128,
        num_requests_waiting=int(rng.integers(0, 8)),
        gpu_cache_usage_perc=float(rng.random()),
        request_active_slots=int(rng.integers(0, 8)),
        request_total_slots=8,
        host_tier_blocks=int(rng.integers(0, 3)),
        tier_hit_rate=float(rng.random()),
    )
    return ForwardPassMetrics(**kw), JaxMetrics(**kw)


@pytest.mark.parametrize("seed", range(6))
def test_selector_choice_equals_jax(seed):
    rng = np.random.default_rng(seed)
    workers = [0x1000 + k for k in range(int(rng.integers(2, 6)))]
    port_eps, jax_eps = port_scheduler.ProcessedEndpoints(), jax_scheduler.ProcessedEndpoints()
    for w in workers:
        pm, jm = metrics_pair(rng)
        port_eps.update(w, pm)
        jax_eps.update(w, jm)
    for _ in range(20):
        scores = {w: int(rng.integers(0, 9)) for w in workers if rng.random() < 0.6}
        isl = int(rng.integers(1, 64))
        got = port_scheduler.DefaultWorkerSelector().select_worker(
            port_eps, port_indexer.OverlapScores(scores=dict(scores)), isl, BLOCK)
        want = jax_scheduler.DefaultWorkerSelector().select_worker(
            jax_eps, jax_indexer.OverlapScores(scores=dict(scores)), isl, BLOCK)
        assert got == want


def test_scheduler_predictive_run_equals_jax(monkeypatch):
    """A run of 40 selections on two schedulers fed the same metrics: the
    predictive bump after each pick steers the next one the same way, ties
    broken by a ``random.Random`` seeded alike in both modules (the
    process's own ``random`` is left alone)."""
    rng = np.random.default_rng(7)
    port = port_scheduler.KvScheduler(BLOCK)
    jax = jax_scheduler.KvScheduler(BLOCK)
    for w in range(1, 5):
        pm, jm = metrics_pair(rng)
        port.update_metrics(w, pm)
        jax.update_metrics(w, jm)
    for k in range(40):
        scores = {int(w): int(rng.integers(0, 6)) for w in rng.choice(4, 2) + 1}
        isl = int(rng.integers(4, 80))
        monkeypatch.setattr(port_scheduler, "random", random.Random(k))
        got = port.schedule(port_indexer.OverlapScores(scores=dict(scores)), isl)
        monkeypatch.setattr(jax_scheduler, "random", random.Random(k))
        want = jax.schedule(jax_indexer.OverlapScores(scores=dict(scores)), isl)
        assert got == want
    assert [(e.worker_id, e.isl_blocks, e.overlap_blocks) for e in port.hit_rate_events] == [
        (e.worker_id, e.isl_blocks, e.overlap_blocks) for e in jax.hit_rate_events]


# -- end to end over the hub -----------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    cfg = ModelConfig.tiny()
    return cfg, init_params(cfg, 0, torch.device("cpu"), torch.float32)


ENGINE = dict(max_batch_size=4, max_seq_len=128, page_size=BLOCK, num_pages=96)


async def spawn_worker(addr, params, ns_name="kvr", **engine_kw):
    cfg, p = params
    engine = TorchEngine(cfg, p, EngineConfig(**{**ENGINE, **engine_kw}), device="cpu")
    rt = await DistributedRuntime.detached(addr)
    ns = rt.namespace(ns_name)
    comp = ns.component("backend")
    pub = KvEventPublisher(ns, worker_id=rt.primary_lease)
    pub.hook(engine)
    await comp.endpoint("generate").serve(engine)
    await WorkerMetricsPublisher(engine.metrics).attach(comp)
    return rt, engine, pub


def req(tokens, max_tokens=4):
    return {"token_ids": list(tokens), "stop_conditions": {"max_tokens": max_tokens},
            "sampling_options": {}, "eos_token_ids": []}


async def drain(stream):
    toks, errors = [], []
    async for item in stream:
        if item.is_error():
            errors.append(item.error_message())
        toks.extend((item.data or {}).get("token_ids") or [])
    assert errors == []
    return toks


async def wait_for(cond, what: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, what
        await asyncio.sleep(0.02)


@pytest.mark.parametrize("index_shards", [1, 2])
def test_kv_router_routes_to_the_prefix_holder(run, params, index_shards):
    async def body():
        hub = HubServer()
        host, port = await hub.start()
        addr = f"{host}:{port}"
        workers = [await spawn_worker(addr, params) for _ in range(2)]
        router_rt = await DistributedRuntime.detached(addr)
        ns = router_rt.namespace("kvr")
        comp = ns.component("backend")
        chooser = KvRouter(ns, comp, block_size=BLOCK, index_shards=index_shards)
        await chooser.start()
        sub = await ns.subscribe("kv-hit-rate")
        try:
            client = await comp.endpoint("generate").client()
            await asyncio.wait_for(client.wait_for_instances(), WAIT_S)
            await wait_for(lambda: len(client.instances) == 2, "workers never registered")
            await chooser.aggregator.scrape_once()
            kv = KvPushRouter(PushRouter(client), chooser)
            captured = []
            direct = kv.inner.direct

            async def spy(request, instance_id):
                captured.append((instance_id, request.data["estimated_prefix_hit_num_blocks"]))
                return await direct(request, instance_id)

            kv.inner.direct = spy
            prefix = list(range(10, 34))  # 6 full blocks
            assert len(await drain(await kv.generate(Context.new(req(prefix))))) == 4
            first, overlap0 = captured[0]
            assert overlap0 == 0
            # the condition the routing assertion reads: the index matches
            # the whole prefix on its holder
            await wait_for(
                lambda: chooser.indexer.find_matches_for_tokens(prefix).scores.get(first) == 6,
                "stored events never indexed")
            hits = {w[0].primary_lease: w[1] for w in workers}
            before = hits[first]._prefix_hits
            for k in range(3):
                await chooser.aggregator.scrape_once()
                await drain(await kv.generate(Context.new(req(prefix + [40 + k, 50 + k]))))
                assert captured[-1] == (first, 6)
            # each repeat reused the 6 cached blocks of the prefix
            assert hits[first]._prefix_hits - before == 3 * 6 * BLOCK
            events = [json.loads((await asyncio.wait_for(sub.next(), WAIT_S))[1])
                      for _ in range(4)]
            assert [(e["worker_id"], e["overlap_blocks"]) for e in events] == (
                [(first, 0)] + [(first, 6)] * 3)
            assert [e["isl_blocks"] for e in events] == [6, 7, 7, 7]  # ceil(26 / 4)
            # the holder dies: its index entries and load row go with it
            dead = next(w for w in workers if w[0].primary_lease == first)
            await dead[2].close()
            await dead[1].stop()
            await dead[0].shutdown()
            await wait_for(lambda: first not in client.instance_ids(), "dead instance listed")
            # the scrape drops a worker its own load_metrics client no longer
            # lists: that client's watch pumps apart from the generate one's
            await wait_for(lambda: first not in chooser.aggregator._client.instance_ids(),
                           "dead instance listed to the scraper")
            await chooser.aggregator.scrape_once()
            assert first not in chooser.indexer.find_matches_for_tokens(prefix).scores
            assert first not in chooser.scheduler.workers.endpoints
            assert len(await drain(await kv.generate(Context.new(req(prefix))))) == 4
            assert captured[-1][0] != first
            await client.close()
        finally:
            await sub.close()
            await chooser.stop()
            for rt, engine, pub in workers:
                await pub.close()
                await engine.stop()
                await rt.shutdown()
            await router_rt.shutdown()
            await hub.stop()

    run(asyncio.wait_for(body(), 120))


def test_holdings_publisher_feeds_the_holdings_index(run, params):
    """An engine with a host tier evicts a prompt's blocks under churn;
    ``KvHoldingsPublisher`` carries the tier deltas to the router, whose
    holdings index then names the worker as a host-tier source."""

    async def body():
        hub = HubServer()
        host, port = await hub.start()
        addr = f"{host}:{port}"
        rt, engine, pub = await spawn_worker(
            addr, params, max_batch_size=2, max_seq_len=64, num_pages=17,
            host_offload_blocks=32, async_dispatch=False,
        )
        holdings = KvHoldingsPublisher(rt.namespace("kvr"), worker_id=rt.primary_lease)
        holdings.hook(engine)
        router_rt = await DistributedRuntime.detached(addr)
        ns = router_rt.namespace("kvr")
        chooser = KvRouter(ns, ns.component("backend"), block_size=BLOCK)
        await chooser.start()
        try:
            prompt = list(range(100, 124))
            await drain(await engine.generate(Context.new(req(prompt))))
            for k in range(3):  # churn: evicts the prompt's pages to the host ring
                await drain(await engine.generate(Context.new(req(list(range(k * 40, k * 40 + 36))))))
            engine.offload_engine.drain()
            _, hashes = hash_blocks(prompt, BLOCK)

            def sourced():
                src = chooser.indexer.holdings.prefix_sources(hashes)
                return src.get(rt.primary_lease, {}).get("tier") == "host"

            await wait_for(sourced, "holdings never reached the index")
            assert chooser.indexer.holdings.prefix_sources(hashes)[rt.primary_lease]["blocks"] >= 1
        finally:
            await chooser.stop()
            await holdings.close()
            await pub.close()
            await engine.stop()
            await rt.shutdown()
            await router_rt.shutdown()
            await hub.stop()

    run(asyncio.wait_for(body(), 120))


def test_engines_in_one_process_take_turns(run, params, monkeypatch):
    """Two workers' engines in one process serve concurrently, and no two
    of their executor calls overlap: each runs holding the process-wide
    ``DEVICE_TURN`` (on the card a graph capture must not overlap the other
    engine's launches)."""
    active, seen = [0], []
    dispatch = TorchEngine._dispatch_unified

    def spy(self, *args):
        active[0] += 1
        seen.append((active[0], engine_mod.DEVICE_TURN.locked()))
        try:
            return dispatch(self, *args)
        finally:
            active[0] -= 1

    monkeypatch.setattr(TorchEngine, "_dispatch_unified", spy)
    cfg, p = params

    async def body():
        engines = [TorchEngine(cfg, p, EngineConfig(**ENGINE), device="cpu") for _ in range(2)]

        async def serve(eng, seed):
            prompts = np.random.default_rng(seed).integers(1, 200, (3, 30)).tolist()
            try:
                return await asyncio.gather(*[
                    drain(await eng.generate(Context.new(req(t, 12)))) for t in prompts])
            finally:
                await eng.stop()

        return await asyncio.gather(serve(engines[0], 1), serve(engines[1], 2))

    out = run(asyncio.wait_for(body(), 120))
    assert [len(t) for s in out for t in s] == [12] * 6
    assert seen and all(n == 1 and locked for n, locked in seen)
