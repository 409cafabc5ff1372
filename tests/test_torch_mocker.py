"""The port's model-free engines against the JAX package's.

``dynamo_tpu_torch.mocker`` (``MockKvManager``, ``MockerEngine``),
``llm/echo.py`` (``EchoEngineCore``) and ``llm/embedding.fake_embedder``
are copies of the JAX modules over the port's runtime.  Every case of the
JAX package's ``tests/test_mocker.py`` runs here on both packages -- the
same configs, the same requests -- and the port must give the JAX
engine's token streams, finish reasons, error frames, KV event sequences
(stored and removed hashes, in order) and ``ForwardPassMetrics``, beside
the JAX test's own invariants.  A mixed workload (prefix sharing,
preemption under a tight pool, concurrent lanes) runs with the pipelined
tick on and off and ``multistep_k`` 1, 4 and 0 (adaptive).  The chaos
sites: ``worker.slow`` slows only the matching worker's ticks by its armed
delay (as the JAX package's ``tests/test_chaos.py`` checks), firing as
often as in the JAX mocker; ``crash()`` (``worker.kill``) sends each
in-flight and queued lane the JAX error frame.  The echo engine and
``fake_embedder`` answer output for output.  Every wait is bounded.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from types import SimpleNamespace

import pytest

import dynamo_tpu.llm.echo as jax_echo
import dynamo_tpu.llm.embedding as jax_embedding
import dynamo_tpu.mocker as jax_mocker
import dynamo_tpu.protocols.common as jax_common
import dynamo_tpu.runtime.engine as jax_engine
import dynamo_tpu.runtime.faults as jax_faults
import dynamo_tpu.runtime.metrics as jax_metrics
import dynamo_tpu_torch.llm.echo as echo
import dynamo_tpu_torch.llm.embedding as embedding
import dynamo_tpu_torch.mocker as mocker
import dynamo_tpu_torch.protocols.common as common
import dynamo_tpu_torch.runtime.engine as rt_engine
import dynamo_tpu_torch.runtime.faults as faults
import dynamo_tpu_torch.runtime.metrics as metrics

WAIT_S = 30
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run
PKGS = {
    "jax": SimpleNamespace(m=jax_mocker, c=jax_common, e=jax_engine, f=jax_faults,
                           metrics=jax_metrics, echo=jax_echo, emb=jax_embedding),
    "torch": SimpleNamespace(m=mocker, c=common, e=rt_engine, f=faults,
                             metrics=metrics, echo=echo, emb=embedding),
}


def req(pkg, tokens, max_tokens=8, **kw):
    c = pkg.c
    return c.PreprocessedRequest(
        token_ids=list(tokens),
        stop_conditions=c.StopConditions(max_tokens=max_tokens, **kw),
        sampling_options=c.SamplingOptions(temperature=0.0),
    )


async def collect(pkg, engine, request):
    """(tokens, finish reason, error messages) of one stream."""
    stream = await engine.generate(pkg.e.Context.new(request))
    tokens, finish, errors = [], None, []

    async def read():
        nonlocal finish
        async for item in stream:
            if item.is_error():
                errors.append(item.error_message())
                continue
            data = item.data or {}
            tokens.extend(data.get("token_ids") or [])
            finish = data.get("finish_reason") or finish

    await asyncio.wait_for(read(), WAIT_S)
    return tokens, finish, errors


def engine_of(pkg, events=None, **cfg):
    eng = pkg.m.MockerEngine(pkg.m.MockerConfig(**cfg), registry=pkg.metrics.MetricsRegistry())
    if events is not None:
        eng.kv_event_sink = events.append
    return eng


def fpm(engine) -> dict:
    return dataclasses.asdict(engine.metrics())


def both(scenario):
    """``scenario(pkg)`` run on each package, each on a fresh event loop."""
    return {name: asyncio.run(asyncio.wait_for(scenario(pkg), RUN_S)) for name, pkg in PKGS.items()}


# -- the KV manager ---------------------------------------------------------------


def _kv_use_deref_reuse(pkg):
    kv = pkg.m.MockKvManager(max_capacity=4, block_size=4)
    out = [kv.use([101, 102]), kv.num_active_blocks]
    kv.deref([101, 102])
    out += [kv.num_active_blocks, kv.current_capacity, kv.probe_cached_blocks([101, 102])]
    out += [kv.use([101, 102]), kv.num_active_blocks]
    assert out == [True, 2, 0, 2, 2, True, 2]
    return out


def _kv_lru_eviction_and_events(pkg):
    events = []
    kv = pkg.m.MockKvManager(max_capacity=2, block_size=4, event_sink=events.append)
    kv.use([1])
    kv.deref([1])
    kv.use([2])
    kv.deref([2])
    assert kv.use([3])  # full of inactive blocks: evicts the LRU one (1)
    assert kv.probe_cached_blocks([1]) == 0 and kv.probe_cached_blocks([2]) == 1
    stored = [e["blocks"][0]["sequence_hash"] for e in events if e["type"] == "stored"]
    removed = [e["sequence_hashes"] for e in events if e["type"] == "removed"]
    assert stored == [1, 2, 3] and removed == [[1]]
    return events


def _kv_use_fails_when_all_active(pkg):
    kv = pkg.m.MockKvManager(max_capacity=2, block_size=4)
    out = [kv.use([1, 2]), kv.use([3])]
    assert out == [True, False]  # nothing evictable: the preemption signal
    return out


def _kv_try_schedule_watermark(pkg):
    kv = pkg.m.MockKvManager(max_capacity=10, block_size=4)
    cost = kv.try_schedule([11, 12], prompt_len=8, watermark=0.01)
    assert (cost.new_blocks, cost.new_tokens, cost.cached_tokens) == (3, 8, 0)
    kv.use([11, 12])
    kv.deref([11, 12])
    cost2 = kv.try_schedule([11, 12, 13], prompt_len=12, watermark=0.01)
    assert (cost2.cached_tokens, cost2.new_tokens) == (8, 4)
    kv2 = pkg.m.MockKvManager(max_capacity=3, block_size=4)
    kv2.use([1, 2, 3])
    assert kv2.try_schedule([4], prompt_len=4, watermark=0.01) is None
    return [dataclasses.asdict(cost), dataclasses.asdict(cost2), cost2.prefill_compute]


@pytest.mark.parametrize("case", [_kv_use_deref_reuse, _kv_lru_eviction_and_events,
                                  _kv_use_fails_when_all_active, _kv_try_schedule_watermark],
                         ids=lambda f: f.__name__[4:])
def test_kv_manager_matches_jax(case):
    assert case(PKGS["torch"]) == case(PKGS["jax"])


def test_lru_evictor_matches_jax():
    def run(pkg):
        ev = pkg.m.LRUEvictor()
        for k in (5, 3, 9, 3):
            ev.insert(k)
        out = [ev.keys(), len(ev), 9 in ev, ev.remove(9), ev.remove(9), ev.evict()]
        return out + [ev.evict(), ev.evict()]

    assert run(PKGS["torch"]) == run(PKGS["jax"]) == [[5, 9, 3], 3, True, True, False, 5, 3, None]


# -- the engine: the JAX mocker tests' cases ----------------------------------------


async def _deterministic_stream(pkg):
    engine = engine_of(pkg, block_size=4)
    try:
        t1 = await collect(pkg, engine, req(pkg, [1, 2, 3], max_tokens=10))
        t2 = await collect(pkg, engine, req(pkg, [1, 2, 3], max_tokens=10))
        t3 = await collect(pkg, engine, req(pkg, [9, 9, 9], max_tokens=10))
        assert t1 == t2 and len(t1[0]) == 10 and t1[1] == "length" and t3 != t1
        return [t1, t2, t3, fpm(engine)]
    finally:
        await engine.stop()


async def _concurrent_requests(pkg):
    engine = engine_of(pkg, block_size=4)
    try:
        prompts = [[i + 1] * 5 for i in range(8)]
        solo = [await collect(pkg, engine, req(pkg, p, max_tokens=6)) for p in prompts]
        together = await asyncio.gather(
            *[collect(pkg, engine, req(pkg, p, max_tokens=6)) for p in prompts])
        assert list(together) == solo
        return [solo, fpm(engine)]
    finally:
        await engine.stop()


async def _prefix_reuse_is_honest(pkg):
    engine = engine_of(pkg, block_size=4)
    try:
        await collect(pkg, engine, req(pkg, [7] * 12, max_tokens=4))
        m1 = fpm(engine)
        await collect(pkg, engine, req(pkg, [7] * 12 + [1, 2], max_tokens=4))
        m2 = fpm(engine)
        assert m1["gpu_prefix_cache_hit_rate"] == 0.0
        assert m2["gpu_prefix_cache_hit_rate"] == pytest.approx(0.5)
        return [m1, m2]
    finally:
        await engine.stop()


async def _kv_events_published(pkg):
    events = []
    engine = engine_of(pkg, events, block_size=4)
    try:
        out = await collect(pkg, engine, req(pkg, [5] * 8, max_tokens=6))
        hashes = [b["sequence_hash"] for e in events if e["type"] == "stored"
                  for b in e["blocks"]]
        assert len(hashes) == len(set(hashes)) == 3
        return [out, events]
    finally:
        await engine.stop()


async def _preemption_under_pressure(pkg):
    events = []
    engine = engine_of(pkg, events, block_size=4, kv_capacity_blocks=12, watermark=0.0)
    try:
        prompts = [[i + 1] * 8 for i in range(6)]
        results = await asyncio.gather(
            *[collect(pkg, engine, req(pkg, p, max_tokens=12)) for p in prompts])
        assert all(f == "length" and len(t) == 12 for t, f, _ in results)
        assert engine.kv.num_active_blocks == 0
        assert any(e["type"] == "removed" for e in events)
        return [results, events, fpm(engine)]
    finally:
        await engine.stop()


async def _cancellation(pkg):
    engine = engine_of(pkg, block_size=4, decode_s_per_step=0.001)
    try:
        ctx = pkg.e.Context.new(req(pkg, [1, 2, 3], max_tokens=100000))
        stream = await engine.generate(ctx)
        got, last = 0, None

        async def read():
            nonlocal got, last
            async for item in stream:
                got += 1
                last = item.data
                if got == 3:
                    ctx.ctx.stop_generating()

        await asyncio.wait_for(read(), WAIT_S)
        for _ in range(200):
            if not engine.running:
                break
            await asyncio.sleep(0.01)
        assert not engine.running and engine.kv.num_active_blocks == 0
        return [last.get("finish_reason"), fpm(engine)]
    finally:
        await engine.stop()


async def _oversized_prompt_fails_cleanly(pkg):
    engine = engine_of(pkg, block_size=4, kv_capacity_blocks=4)
    try:
        bad = await collect(pkg, engine, req(pkg, [1] * 64, max_tokens=4))
        good = await collect(pkg, engine, req(pkg, [1, 2], max_tokens=3))
        assert bad[2] and len(good[0]) == 3
        return [bad, good]
    finally:
        await engine.stop()


async def _prompt_over_token_budget_fails_not_spins(pkg):
    engine = engine_of(pkg, block_size=4, kv_capacity_blocks=64, token_capacity=16)
    try:
        bad = await collect(pkg, engine, req(pkg, [1] * 32, max_tokens=4))
        good = await collect(pkg, engine, req(pkg, [1] * 8, max_tokens=3))
        assert bad[2] and len(good[0]) == 3
        return [bad, good]
    finally:
        await engine.stop()


async def _simulated_latency_scales(pkg):
    engine = engine_of(pkg, block_size=4, decode_s_per_step=0.0005)
    try:
        t0 = time.monotonic()
        out = await collect(pkg, engine, req(pkg, [1] * 4, max_tokens=20))
        assert time.monotonic() - t0 > 0.005  # 20 steps x >= 1 block x 0.5 ms
        return [out]
    finally:
        await engine.stop()


ENGINE_CASES = [_deterministic_stream, _concurrent_requests, _prefix_reuse_is_honest,
                _kv_events_published, _preemption_under_pressure, _cancellation,
                _oversized_prompt_fails_cleanly, _prompt_over_token_budget_fails_not_spins,
                _simulated_latency_scales]


@pytest.mark.parametrize("case", ENGINE_CASES, ids=lambda f: f.__name__[1:])
def test_mocker_engine_matches_jax(case):
    got = both(case)
    assert got["torch"] == got["jax"]


# -- the pipelined tick and multistep K ---------------------------------------------


async def _mixed_workload(pkg, async_dispatch, multistep_k):
    """Prefix sharers, a preempting tight pool and a late arrival, under a
    simulated device time (the pipelined tick engages only with one)."""
    events = []
    engine = engine_of(pkg, events, block_size=4, kv_capacity_blocks=20, watermark=0.0,
                       max_batch_size=4, decode_s_per_step=0.0001,
                       async_dispatch=async_dispatch, multistep_k=multistep_k)
    try:
        shared = list(range(1, 13))
        prompts = [shared + [20 + i] for i in range(3)] + [[40 + i] * 6 for i in range(3)]
        first = await asyncio.gather(
            *[collect(pkg, engine, req(pkg, p, max_tokens=10)) for p in prompts])
        again = await collect(pkg, engine, req(pkg, shared + [99], max_tokens=6))
        assert all(f == "length" for _, f, _ in first)
        assert engine.kv.num_active_blocks == 0
        return dict(streams=list(first) + [again], events=events, fpm=fpm(engine),
                    tokens=engine.tokens_generated)
    finally:
        await engine.stop()


@pytest.mark.parametrize("multistep_k", [1, 4, 0])
@pytest.mark.parametrize("async_dispatch", [True, False])
def test_mocker_tick_modes_match_jax(async_dispatch, multistep_k):
    got = both(lambda pkg: _mixed_workload(pkg, async_dispatch, multistep_k))
    assert got["torch"] == got["jax"]
    assert any(e["type"] == "removed" for e in got["torch"]["events"])


def test_mocker_streams_do_not_depend_on_the_tick_mode():
    """Token identity is K- and pipeline-invariant in both packages."""
    runs = [asyncio.run(
        asyncio.wait_for(_mixed_workload(PKGS["torch"], a, k), RUN_S)
    ) for a, k in ((False, 1), (True, 0))]
    assert [t for t, _, _ in runs[0]["streams"]] == [t for t, _, _ in runs[1]["streams"]]


# -- chaos: worker.slow and worker.kill ------------------------------------------------


def test_worker_slow_slows_only_the_matching_worker_like_jax():
    """``worker.slow`` keyed ``worker-<id>``: the matching worker's ticks
    take the armed delay, another worker's none (``match=`` filters it
    without a draw), in as many firings as the JAX mocker's."""
    spec = "seed=5;worker.slow=1:delay=0.004:match=worker-3"

    async def timed(pkg, worker_id):
        engine = engine_of(pkg, block_size=4, worker_id=worker_id, decode_s_per_step=0.0)
        t0 = time.monotonic()
        try:
            out = await collect(pkg, engine, req(pkg, [1, 2, 3], max_tokens=8))
        finally:
            await engine.stop()
        return time.monotonic() - t0, out

    def run(pkg):
        inj = pkg.f.injector
        inj.configure(spec)
        try:
            (slow, a), (fast, b) = asyncio.run(
                asyncio.wait_for(timed(pkg, 3), RUN_S)
            ), asyncio.run(asyncio.wait_for(timed(pkg, 1), RUN_S))
            return slow, fast, a, b, inj.fire_count("worker.slow")
        finally:
            inj.disable()

    t, j = run(PKGS["torch"]), run(PKGS["jax"])
    slow, fast = t[0], t[1]
    assert slow > fast + 0.01
    assert t[4] >= 8  # at least one firing per decode tick of the 8 tokens
    assert t[2:] == j[2:]  # the same streams, the same number of firings


async def _crash(pkg):
    """Two lanes in flight (a slow simulated tick) and one queued behind
    ``max_batch_size=2``; ``crash()`` answers each with the error frame."""
    engine = engine_of(pkg, block_size=4, max_batch_size=2, decode_s_per_step=0.002)
    tasks = [asyncio.ensure_future(collect(pkg, engine, req(pkg, [i + 1] * 4, max_tokens=10000)))
             for i in range(3)]
    for _ in range(500):
        if len(engine.running) == 2 and engine.tokens_generated >= 2:
            break
        await asyncio.sleep(0.005)
    assert len(engine.running) == 2 and len(engine._waiting_list) == 1
    await engine.crash()
    outs = await asyncio.gather(*tasks)
    assert not engine.running and not engine._waiting_list
    assert engine.kv.num_active_blocks == 0
    return [(finish, errors) for _, finish, errors in outs]


def test_crash_sends_the_kill_frame_to_every_lane_like_jax():
    got = both(_crash)
    assert got["torch"] == got["jax"]
    assert got["torch"] == [(None, ["mocker crashed (injected worker.kill)"])] * 3


# -- the echo engine and fake_embedder ---------------------------------------------------


async def _echo(pkg):
    engine = pkg.echo.EchoEngineCore(delay_ms=1.0)
    out = [await collect(pkg, engine, req(pkg, [5, 6, 7, 8], max_tokens=n)) for n in (2, 10)]
    ctx = pkg.e.Context.new(req(pkg, list(range(50)), max_tokens=50))
    stream = await engine.generate(ctx)
    items = []
    async for item in stream:
        items.append(item.data)
        if len(items) == 2:
            ctx.ctx.stop_generating()
    await engine.stop()
    return out + [items]


def test_echo_engine_matches_jax():
    got = both(_echo)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ([5, 6], "stop", []) and got["torch"][1][0] == [5, 6, 7, 8]
    assert got["torch"][2][-1]["finish_reason"] == "cancelled"


@pytest.mark.parametrize("dim", [8, 32, 100])
def test_fake_embedder_matches_jax(dim):
    batches = [[1, 2, 3], [], [7] * 40, [123456789]]
    got = asyncio.run(asyncio.wait_for(embedding.fake_embedder(dim)(batches), RUN_S))
    want = asyncio.run(asyncio.wait_for(jax_embedding.fake_embedder(dim)(batches), RUN_S))
    assert got == want
    for v in got:
        assert len(v) == dim and abs(sum(x * x for x in v) - 1.0) < 1e-9


def test_mocker_embed_is_the_fake_embedder():
    async def run(pkg):
        engine = engine_of(pkg)
        return await engine.embed([[1, 2], [3]])

    assert both(run)["torch"] == both(run)["jax"]
