"""The JAX package's ``EngineConfig`` on the port: router blocks of several
pages, prefix caching off, and the engine constants as fields.

* **Routing at a block of 4 pages**: two port workers at page size 4 and
  block size 16, set up as ``run in=dyn`` sets them up
  (``cli.serve_worker``), behind the KV router built from their card: the
  card names the engine's block size, and a repeat of a held prefix goes
  to its holder with the prefix's whole 16-token blocks as its overlap.
* **The config**: ``EngineConfig(**asdict(jax_cfg))`` constructs on the
  port, for JAX's default config and for one with every field the port
  took from it set to a value the port serves; each refused value names
  its field.
* **KV events**: ``TorchEngine`` and ``JaxEngine`` on the same tiny f32
  weights (``params_from_numpy``) and the same requests publish equal
  events at a block of 4 pages, at a block that is not whole pages (the
  warning, prefix caching off) and with ``enable_prefix_caching=False``.
* **The constants as fields**: ``grow_chunk_pages=1`` and
  ``device_stop_width=4`` give JAX's streams; ``seed`` starts the nonce
  stream of unseeded lanes, as ``EngineConfig``'s docstring says.
* **The KV planes at 4 pages a block**: G2 offload and onboard, swap
  preemption, prefix onboarding from a peer's exported blobs and a
  disaggregated delivery, each package's blobs read by the other's
  engine: onboarded pages bit-exact, streams equal.
* ``profile-sla`` builds its engine through the CLI's shared flags.

Each engine scenario runs once per module; every ``asyncio.run`` is bounded
by ``asyncio.wait_for``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import subprocess
import sys

import jax
import numpy as np
import pytest

import torch

from dynamo_tpu import offload as joff
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.metrics import MetricsRegistry as JaxRegistry
from dynamo_tpu_torch import cli
from dynamo_tpu_torch import offload as toff
from dynamo_tpu_torch.block_manager import PagePool
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.kv_cache import PageAllocator
from dynamo_tpu_torch.engine.model import init_params
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.kv_router.router import KvPushRouter, KvRouter
from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime.component import DistributedRuntime, PushRouter
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.transports.hub import HubServer
from dynamo_tpu_torch.tokens.hashing import hash_blocks
from tests.test_torch_ops import _free_compiled_programs  # noqa: F401 (autouse)

WAIT_S = 30  # bound on any one served request or wait
RUN_S = 180  # bound on any one asyncio.run
PAGE, BLOCK = 4, 16  # 4 pages a router block
ENGINE = dict(max_batch_size=2, max_seq_len=128, page_size=PAGE, block_size=BLOCK,
              num_pages=41, async_dispatch=False)
rng = np.random.default_rng(21)
PROMPT = rng.integers(1, 256, 48).tolist()  # 3 blocks of 16
OTHER = rng.integers(1, 256, 40).tolist()


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = ModelConfig.tiny()
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                                 device="cpu")


def make_engine(pkg, weights, **kw):
    jcfg, jparams, cfg, tparams = weights
    if pkg == "jax":
        return JaxEngine(jcfg, jparams, JaxEngineConfig(**kw), metrics_registry=JaxRegistry())
    return TorchEngine(cfg, tparams, EngineConfig(**kw), device="cpu",
                       metrics_registry=MetricsRegistry())


def request(tokens, max_tokens=4, **sampling) -> dict:
    return {
        "token_ids": list(tokens),
        "stop_conditions": {"max_tokens": max_tokens},
        "sampling_options": {"temperature": 0.0, **sampling},
        "eos_token_ids": [],
    }


async def read(stream) -> list:
    async def body():
        tokens = []
        async for item in stream:
            assert not item.is_error(), item.error_message()
            tokens += (item.data or {}).get("token_ids") or []
        return tokens

    return await asyncio.wait_for(body(), WAIT_S)


async def collect(engine, req: dict) -> list:
    if isinstance(engine, JaxEngine):
        return await read(await engine.generate(JaxContext.new(JaxRequest.from_dict(req))))
    return await read(await engine.generate(Context.new(PreprocessedRequest.from_dict(req))))


def pages_of(engine, hashes) -> dict:
    """Host bytes of the pool pages registered under ``hashes``."""
    pool, kv = engine.sched.pool, np.asarray(engine.kv.pages)
    return {h: kv[:, :, list(pool._registered[h].pages)].tobytes()
            for h in hashes if h in pool._registered}


async def settle(n: int = 3) -> None:
    for _ in range(n):
        await asyncio.sleep(0)  # deliver the events hopped to the loop


# ---------------------------------------------------------------------------
# routing at a block of 4 pages, through the CLI's worker wiring
# ---------------------------------------------------------------------------


async def _wait(cond, what: str) -> None:
    deadline = asyncio.get_running_loop().time() + WAIT_S
    while not cond():
        assert asyncio.get_running_loop().time() < deadline, what
        await asyncio.sleep(0.02)


def test_router_matches_held_blocks_of_several_pages(weights, model_dir):
    """Page size 4, block size 16: the worker's card names 16, its KV
    events hash 16-token blocks, so a prompt repeating a held 3-block
    prefix is routed to the holder with 3 overlap blocks, and the holder
    reuses the prefix's 48 tokens."""

    async def body():
        hub = HubServer()
        host, port = await hub.start()
        addr = f"{host}:{port}"
        workers, cards = [], []
        router_rt = chooser = None
        try:
            for _ in range(2):
                engine = make_engine("torch", weights, **(ENGINE | dict(num_pages=96)))
                rt = await DistributedRuntime.detached(addr)
                card, served = await cli.serve_worker(
                    rt, engine, "dyn://kvb.backend.generate", str(model_dir), "m")
                workers.append((rt, engine, served))
                cards.append(card)
            assert [c.kv_block_size for c in cards] == [BLOCK, BLOCK]
            router_rt = await DistributedRuntime.detached(addr)
            ns = router_rt.namespace("kvb")
            comp = ns.component("backend")
            chooser = KvRouter(ns, comp, block_size=cards[0].kv_block_size)
            await chooser.start()
            client = await comp.endpoint("generate").client()
            await asyncio.wait_for(client.wait_for_instances(), WAIT_S)
            await _wait(lambda: len(client.instances) == 2, "workers never registered")
            await chooser.aggregator.scrape_once()
            kv = KvPushRouter(PushRouter(client), chooser)
            captured = []
            direct = kv.inner.direct

            async def spy(req, instance_id):
                captured.append((instance_id, req.data["estimated_prefix_hit_num_blocks"]))
                return await direct(req, instance_id)

            kv.inner.direct = spy
            assert len(await read(await kv.generate(Context.new(request(PROMPT))))) == 4
            first, overlap0 = captured[0]
            assert overlap0 == 0
            await _wait(
                lambda: chooser.indexer.find_matches_for_tokens(PROMPT).scores.get(first) == 3,
                "the 16-token blocks never reached the router's index")
            holder = {rt.primary_lease: eng for rt, eng, _ in workers}[first]
            before = holder._prefix_hits
            for k in range(2):
                await chooser.aggregator.scrape_once()
                await read(await kv.generate(Context.new(request(PROMPT + [40 + k, 50 + k]))))
                assert captured[-1] == (first, 3)
            assert holder._prefix_hits - before == 2 * 3 * BLOCK
            await client.close()
        finally:
            if chooser is not None:
                await chooser.stop()
            for rt, engine, served in workers:
                await served.close()
                await engine.stop()
                await rt.shutdown()
            if router_rt is not None:
                await router_rt.shutdown()
            await hub.stop()

    asyncio.run(asyncio.wait_for(body(), RUN_S))


def test_engine_block_size_names_the_card():
    """The card's block size is the engine's: the torch engine's router
    blocks, the mocker's blocks; the fallback only for neither."""
    cfg = ModelConfig.tiny()
    params = init_params(cfg, 0, torch.device("cpu"), torch.float32)
    eng = TorchEngine(cfg, params, EngineConfig(page_size=4, block_size=16, num_pages=32),
                      device="cpu", metrics_registry=MetricsRegistry())
    assert cli.engine_block_size(eng, 4) == 16
    eng = TorchEngine(cfg, params, EngineConfig(page_size=8, num_pages=32), device="cpu",
                      metrics_registry=MetricsRegistry())
    assert cli.engine_block_size(eng, 64) == 8
    assert cli.engine_block_size(MockerEngine(MockerConfig(block_size=32)), 16) == 32
    assert cli.engine_block_size(object(), 24) == 24


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------


JAX_SERVED = dict(
    block_size=16, enable_prefix_caching=False, kv_admit_budget="util=0.8,skips=2",
    grow_chunk_pages=1, device_stop_width=4, seed=7, dtype="float32", tp=1, dp=1,
    multistep_decode=False, page_size=4, num_pages=32,
)


@pytest.mark.parametrize("fields", [{}, JAX_SERVED], ids=["default", "every-field"])
def test_jax_config_constructs_on_the_port(weights, fields):
    jax_cfg = JaxEngineConfig(**fields)
    cfg = EngineConfig(**dataclasses.asdict(jax_cfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg)
    engine = make_engine("torch", weights, **dataclasses.asdict(jax_cfg))
    want_pool = PagePool if cfg.enable_prefix_caching else PageAllocator
    assert type(engine.kv.allocator) is want_pool
    assert engine.sched.block_size == (cfg.block_size or cfg.page_size)
    assert (engine.sched.kv_admit is None) == (cfg.kv_admit_budget is None)
    asyncio.run(asyncio.wait_for(engine.stop(), RUN_S))


@pytest.mark.parametrize("field, value", [
    ("tp", 2), ("dp", 2), ("dtype", "bfloat16"), ("kv_admit_budget", "util=0.8,bogus=1"),
])
def test_refused_values_name_their_field(weights, field, value):
    kw = {field: value, "num_pages": 16}
    if field == "tp":
        # tp is served; under it the offload plane is refused, by name,
        # before any rank starts
        kw["host_offload_blocks"] = 8
    with pytest.raises(ValueError, match=f"EngineConfig.{field}"):
        make_engine("torch", weights, **kw)


# ---------------------------------------------------------------------------
# KV events against the JAX engine's
# ---------------------------------------------------------------------------


EVENT_CONFIGS = {
    "block-of-4-pages": dict(ENGINE),
    "block-not-whole-pages": dict(ENGINE, block_size=6),
    "prefix-caching-off": dict(ENGINE, enable_prefix_caching=False),
}


async def _events(engine) -> dict:
    events = []
    engine.kv_event_sink = events.append
    try:
        streams = [await collect(engine, request(PROMPT, 12)),
                   await collect(engine, request(PROMPT + [9, 9], 6)),
                   await collect(engine, request(OTHER, 20))]
        hits = engine._prefix_hits
        used = engine.kv.allocator.used_pages
    finally:
        await engine.stop()
    await settle()
    return dict(streams=streams, events=events, hits=hits, used=used)


@pytest.fixture(scope="module")
def event_runs(weights):
    return {
        name: {pkg: asyncio.run(asyncio.wait_for(_events(make_engine(pkg, weights, **kw)), RUN_S))
               for pkg in ("jax", "torch")}
        for name, kw in EVENT_CONFIGS.items()
    }


@pytest.mark.parametrize("name", list(EVENT_CONFIGS))
def test_kv_events_equal_jax(event_runs, name):
    t, j = event_runs[name]["torch"], event_runs[name]["jax"]
    assert t["streams"] == j["streams"]
    assert t["events"] == j["events"]
    assert t["hits"] == j["hits"]
    assert t["used"] == 0


def test_events_hash_whole_router_blocks(event_runs):
    """At a block of 4 pages the stored events carry the prompt's 16-token
    block hashes, and the repeat reuses the whole blocks; without prefix
    caching nothing is reused and each request's blocks are removed at its
    end."""
    t = event_runs["block-of-4-pages"]["torch"]
    stored = [b for e in t["events"] if e["type"] == "stored" for b in e["blocks"]]
    bh, sh = hash_blocks(PROMPT, BLOCK)
    assert [(b["block_hash"], b["sequence_hash"]) for b in stored[:3]] == list(zip(bh, sh))
    assert t["hits"] == 3 * BLOCK  # the repeat reuses the prompt's 3 whole blocks
    off = event_runs["prefix-caching-off"]["torch"]
    assert off["hits"] == 0
    assert [e["type"] for e in off["events"]].count("removed") == 3


def test_block_not_whole_pages_warns(weights, caplog):
    with caplog.at_level(logging.WARNING, logger="dynamo.torch_engine"):
        engine = make_engine("torch", weights, **EVENT_CONFIGS["block-not-whole-pages"])
    assert "prefix caching disabled: block_size 6 is not a multiple of page_size 4" in caplog.text
    assert engine.sched.pool is None and engine.sched.block_size == 6
    asyncio.run(asyncio.wait_for(engine.stop(), RUN_S))


# ---------------------------------------------------------------------------
# the engine constants as fields, and the seed
# ---------------------------------------------------------------------------


async def _constants(engine, stop_at) -> list:
    try:
        tight = [await collect(engine, request(p, 40)) for p in (PROMPT[:10], OTHER[:7])]
        # a stop id past the device's width: the host replay stops the lane
        stopped = await collect(engine, dict(request(PROMPT[:10], 40),
                                             eos_token_ids=[251, 252, 253, 254, 255, stop_at]))
        return tight + [stopped]
    finally:
        await engine.stop()


def test_grow_chunk_and_stop_width_give_jax_streams(weights, event_runs):
    plain = asyncio.run(asyncio.wait_for(_constants(
        make_engine("torch", weights, **ENGINE), -1), RUN_S))
    stop_at = plain[0][12]
    assert stop_at not in plain[0][:12] and stop_at < 251
    kw = dict(ENGINE, grow_chunk_pages=1, device_stop_width=4, async_dispatch=True)
    got = {pkg: asyncio.run(asyncio.wait_for(
        _constants(make_engine(pkg, weights, **kw), stop_at), RUN_S)) for pkg in ("jax", "torch")}
    assert got["torch"] == got["jax"]
    assert got["torch"][:2] == plain[:2]
    assert got["torch"][2] == plain[0][:12]


async def _unseeded(engine) -> list:
    try:
        return [await collect(engine, request(p, 16, temperature=1.0))
                for p in (PROMPT[:8], PROMPT[:8], OTHER[:8])]
    finally:
        await engine.stop()


def test_seed_starts_the_nonce_stream(weights):
    """Two engines of one seed serving the same requests in the same order
    give the same unseeded streams; another seed gives others; within an
    engine each request draws its own noise."""

    def streams(seed):
        return asyncio.run(asyncio.wait_for(
            _unseeded(make_engine("torch", weights, **ENGINE, seed=seed)), RUN_S))

    a, b, c, zero = streams(5), streams(5), streams(6), streams(0)
    assert a == b
    assert a != c
    assert a[0] != a[1]  # the same prompt, the next nonce
    # seed 0 is the stream of the n-th request keyed by nonce n
    assert zero[1] == streams(1)[0]


# ---------------------------------------------------------------------------
# the KV planes at 4 pages a block, both packages
# ---------------------------------------------------------------------------


OFFLOAD = dict(ENGINE, num_pages=33, host_offload_blocks=16)


async def _roundtrip(engine) -> dict:
    """PROMPT, churn until its blocks leave the pool, PROMPT again: its
    blocks come back from the host tier."""
    events = []
    engine.kv_event_sink = events.append
    out = {"events": events}
    try:
        out["first"] = await collect(engine, request(PROMPT))
        _, hashes = hash_blocks(PROMPT, BLOCK)
        reusable = hashes[: (len(PROMPT) - 1) // BLOCK]
        out["before"] = pages_of(engine, reusable)
        pool = engine.sched.pool
        churn = []
        for i in range(8):
            if not any(pool.is_registered(h) for h in hashes):
                break
            churn.append(await collect(engine, request([(t + i) % 250 + 1 for t in OTHER])))
        engine.offload_engine.drain()
        out["churn"] = churn
        out["offloaded"] = len(engine.offload)
        out["second"] = await collect(engine, request(PROMPT))
        out["after"] = pages_of(engine, reusable)
        engine.offload_engine.drain()
        out["tier_hits"] = dict(engine.offload_engine.tier_hits)
        out["onboard_bytes"] = engine.offload_engine.onboard_detail.get("prefix", [0])[0]
        out["used"] = engine.kv.allocator.used_pages
    finally:
        await engine.stop()
    await settle()
    return out


async def _swap(engine) -> dict:
    try:
        streams = await asyncio.gather(*[collect(engine, request(p, 40))
                                         for p in (PROMPT[:16], OTHER[:16])])
        return dict(streams=streams, swaps=engine.sched.preempt_swap,
                    swap_ins=engine.offload_engine.swap_ins if engine.offload_engine else 0,
                    used=engine.kv.allocator.used_pages)
    finally:
        await engine.stop()


async def _export(engine) -> dict:
    """A donor's G1 export of PROMPT's blocks and a disaggregated export
    of OTHER."""
    try:
        await collect(engine, request(PROMPT))
        _, hashes = hash_blocks(PROMPT, BLOCK)
        found = await asyncio.wait_for(engine.export_blocks(list(hashes)), WAIT_S)
        req = (JaxRequest if isinstance(engine, JaxEngine) else PreprocessedRequest).from_dict(
            request(OTHER, 6))
        blob, row = await engine.prefill_export(req)
        return dict(found=[(int(h), np.asarray(b), dict(m)) for h, b, m in found],
                    export=(np.asarray(blob), np.asarray(row)))
    finally:
        await engine.stop()


async def _import(engine, pkg, found, export) -> dict:
    """The other package's blobs read here: PROMPT's exported blocks put
    into this engine's host tier and onboarded by a prefix match, and
    OTHER's disaggregated prefill delivered into a parked lane."""
    off = joff if pkg == "jax" else toff
    try:
        for h, blob, meta in found:
            engine.offload_engine.submit_put(h, blob, off.BlockMeta.from_dict(meta))
        await asyncio.to_thread(engine.offload_engine.drain)
        onboarded = await collect(engine, request(PROMPT))
        pages = pages_of(engine, [h for h, _b, _m in found])
        blob, row = export
        if pkg == "jax":
            ctx = JaxContext.new(JaxRequest.from_dict(request(OTHER, 6)))
        else:
            ctx = Context.new(PreprocessedRequest.from_dict(request(OTHER, 6)))
        stream = await engine.generate_external(ctx)
        assert engine.deliver_external(ctx.id, blob, row)
        delivered = await read(stream)
        return dict(onboarded=onboarded, pages=pages, delivered=delivered,
                    used=engine.kv.allocator.used_pages)
    finally:
        await engine.stop()


@pytest.fixture(scope="module")
def planes(weights):
    out = {}
    for pkg in ("jax", "torch"):
        run = {}
        run["roundtrip"] = asyncio.run(asyncio.wait_for(
            _roundtrip(make_engine(pkg, weights, **OFFLOAD)), RUN_S))
        run["roomy"] = asyncio.run(asyncio.wait_for(
            _swap(make_engine(pkg, weights, **(ENGINE | dict(num_pages=64)))), RUN_S))
        run["swap"] = asyncio.run(asyncio.wait_for(
            _swap(make_engine(pkg, weights, **(OFFLOAD | dict(num_pages=21)))), RUN_S))
        run["export"] = asyncio.run(asyncio.wait_for(
            _export(make_engine(pkg, weights, **OFFLOAD)), RUN_S))
        out[pkg] = run
    for pkg, donor in (("jax", "torch"), ("torch", "jax")):
        exp = out[donor]["export"]
        out[pkg]["import"] = asyncio.run(asyncio.wait_for(_import(
            make_engine(pkg, weights, **OFFLOAD), pkg, exp["found"], exp["export"]), RUN_S))
    return out


def test_offload_roundtrip_at_4_pages_a_block_matches_jax(planes):
    t, j = planes["torch"]["roundtrip"], planes["jax"]["roundtrip"]
    assert t["first"] == t["second"] == j["first"] == j["second"]
    assert t["churn"] == j["churn"]
    assert t["offloaded"] > 0 and t["tier_hits"]["host"] > 0
    for key in ("offloaded", "tier_hits", "onboard_bytes"):
        assert t[key] == j[key], key
    assert t["events"] == j["events"]
    assert t["used"] == 0
    # onboarded pages are the evicted ones, bit for bit, 4 pages a block
    for run in (t, j):
        assert run["before"] and run["after"] == run["before"]


def test_swap_at_4_pages_a_block_matches_jax(planes):
    t, j = planes["torch"], planes["jax"]
    assert t["swap"]["swaps"] >= 1 and t["swap"]["swap_ins"] >= 1
    assert t["swap"]["streams"] == t["roomy"]["streams"] == j["swap"]["streams"]
    assert (t["swap"]["swaps"], t["swap"]["swap_ins"]) == (j["swap"]["swaps"],
                                                          j["swap"]["swap_ins"])
    assert t["swap"]["used"] == 0


def test_exported_blocks_of_4_pages_match_jax(planes):
    t, j = planes["torch"]["export"], planes["jax"]["export"]
    _, hashes = hash_blocks(PROMPT, BLOCK)
    assert [h for h, _b, _m in t["found"]] == [h for h, _b, _m in j["found"]] == hashes
    assert [m for _h, _b, m in t["found"]] == [m for _h, _b, m in j["found"]]
    cfg = ModelConfig.tiny()
    for (_h, tb, _m), (_h2, jb, _m2) in zip(t["found"], j["found"]):
        assert tb.shape == jb.shape == (cfg.num_layers, 2, BLOCK // PAGE, PAGE,
                                        cfg.num_kv_heads, cfg.head_dim)
        np.testing.assert_allclose(tb, jb, atol=1e-5)


@pytest.mark.parametrize("pkg, donor", [("torch", "jax"), ("jax", "torch")])
def test_blobs_cross_packages_at_4_pages_a_block(planes, pkg, donor):
    """Each engine reads the other package's blobs: the onboarded pages
    hold the donor's bytes exactly, and the streams equal a plain serve."""
    imp, exp = planes[pkg]["import"], planes[donor]["export"]
    want = {h: np.ascontiguousarray(b).tobytes() for h, b, _m in exp["found"]}
    reusable = list(want)[: (len(PROMPT) - 1) // BLOCK]
    assert {h: imp["pages"][h] for h in reusable} == {h: want[h] for h in reusable}
    assert imp["onboarded"] == planes[pkg]["roundtrip"]["first"]
    assert len(imp["delivered"]) == 6
    assert imp["used"] == 0


def test_disagg_delivery_at_4_pages_a_block_equals_aggregated(planes, weights):
    async def body():
        engine = make_engine("torch", weights, **ENGINE)
        try:
            return await collect(engine, request(OTHER, 6))
        finally:
            await engine.stop()

    agg = asyncio.run(asyncio.wait_for(body(), RUN_S))
    assert planes["torch"]["import"]["delivered"] == agg
    assert planes["jax"]["import"]["delivered"] == agg


# ---------------------------------------------------------------------------
# a stopped engine leaves nothing behind
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(ENGINE), dict(OFFLOAD, async_dispatch=True),
                                dict(ENGINE, enable_prefix_caching=False)],
                         ids=["serial", "offload-async", "no-prefix-cache"])
def test_stopped_engine_and_pool_are_collected(weights, kw, monkeypatch):
    """After ``stop()`` and a collection nothing holds the engine or its
    KV pool, and ``stop()`` has released the matmul workspaces of the
    engine's device once (a no-op off the card)."""
    import gc
    import weakref

    from dynamo_tpu_torch import device as device_mod
    from dynamo_tpu_torch.engine import engine as engine_mod

    released = []
    monkeypatch.setattr(engine_mod, "release_blas_workspaces",
                        lambda dev: released.append(dev) or device_mod.release_blas_workspaces(dev))

    async def body():
        engine = make_engine("torch", weights, **kw)
        engine.kv_event_sink = [].append
        await asyncio.gather(collect(engine, request(PROMPT, 8)),
                             collect(engine, request(OTHER, 8, logprobs=2)))
        await engine.stop()
        await engine.stop()  # a second stop releases nothing more
        return weakref.ref(engine), weakref.ref(engine.kv.pages)

    refs = asyncio.run(asyncio.wait_for(body(), RUN_S))
    gc.collect()
    assert [r() for r in refs] == [None, None]
    assert released == [torch.device("cpu")]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_profile_sla_takes_the_new_flags(tmp_path, model_dir):
    """``profile-sla`` builds its engine through ``_make_engine``: the new
    flags reach it (a block of 4 pages, KV-budget admission)."""
    import os

    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_isolation import _checkpoint  # noqa: E402

    path = _checkpoint(str(model_dir), str(tmp_path / "ckpt"))
    out = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch", "profile-sla", "--out", "torch",
         "--model-path", str(path), "--device", "cpu", "--isl", "16", "--batch", "1",
         "--osl", "32", "--page-size", "4", "--block-size", "16",
         "--kv-admit-budget", "util=0.9,skips=2"],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    doc = json.loads(out.stdout)
    assert doc["profile"]
