"""The port's pipelined tick loop (``EngineConfig.async_dispatch``).

Token identity is the contract, as for the JAX engine's loop
(``tests/test_async_dispatch.py``): the pipelined loop (commits when a
generation has landed, off-tick fanout, two generations in flight) gives
byte for byte the token streams of the serial loop, greedy and seeded,
under chunked prefill, the classic path with penalized lanes, the
rectangle layout, the int8 pool and recompute preemption.  On the CPU every
result is ready as soon as it is computed, so each workload also runs with
the readiness probe pinned to "not ready": only that forces the
one-generation lag, with stale lanes and dirty-row scatters queued behind
an in-flight generation.  Then cancellation and stops landing between
enqueue and commit, the fanout worker draining on stop, the port's async
greedy streams against the JAX engine's on the same weights, the packed
shape budget against the JAX class, and the in-place device-state helpers
against their JAX functions.  Every wait is bounded (``asyncio.wait_for``).
"""

from __future__ import annotations

import asyncio
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import step as jax_step
from dynamo_tpu.engine.bucketing import PackedShapeBudget as JaxPackedShapeBudget
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.block_manager import PagePool
from dynamo_tpu_torch.engine import engine as engine_mod
from dynamo_tpu_torch.engine import step
from dynamo_tpu_torch.engine.bucketing import PackedShapeBudget, pow2_bucket
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.sampling import PROMPT_FLAG
from dynamo_tpu_torch.engine.scheduler import Scheduler, SchedulerConfig, SeqState
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime.engine import Context

ENGINE = dict(max_batch_size=4, max_seq_len=64, page_size=4, num_pages=64)
WAIT_S = 60  # bound on any one served batch
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def torch_engine(np_params, **kw) -> TorchEngine:
    cfg = ModelConfig.tiny()
    params = params_from_numpy(np_params, cfg, device="cpu")
    return TorchEngine(cfg, params, EngineConfig(**{**ENGINE, **kw}), device="cpu")


def request(tokens, max_tokens=8, **sampling) -> dict:
    return {
        "token_ids": list(tokens),
        "stop_conditions": {"max_tokens": max_tokens},
        "sampling_options": {"temperature": 0.0, **sampling},
        "eos_token_ids": [],
    }


async def collect(engine, req: dict, request_id=None):
    if isinstance(engine, JaxEngine):
        ctx = JaxContext.new(JaxRequest.from_dict(req), request_id)
    else:
        ctx = Context.new(PreprocessedRequest.from_dict(req), request_id)
    stream = await engine.generate(ctx)
    tokens, finish = [], None
    async for item in stream:
        assert not item.is_error(), item.error_message()
        data = item.data or {}
        tokens += data.get("token_ids") or []
        finish = data.get("finish_reason") or finish
    return tokens, str(finish) if finish is not None else None


async def serve(engine, reqs, timeout=WAIT_S):
    try:
        return await asyncio.wait_for(
            asyncio.gather(*[collect(engine, r, f"r{i}") for i, r in enumerate(reqs)]),
            timeout,
        )
    finally:
        await engine.stop()


def mixed_workload():
    """Greedy and seeded lanes of different prompt lengths in one batch."""
    return [
        request(
            list(range(1 + i, 18 + i)),
            8,
            **({"temperature": 0.8, "seed": 7 + i} if i % 2 else {}),
        )
        for i in range(6)
    ]


def penalized_workload():
    return mixed_workload() + [
        request(list(range(30, 41)), 10, frequency_penalty=0.7),
        request([5, 9, 5, 9, 5, 9], 10, repetition_penalty=1.3, presence_penalty=0.4),
    ]


# each workload: (engine config, its requests)
WORKLOADS = {
    "chunked": (dict(prefill_chunk_tokens=8), mixed_workload),
    "classic-penalized": (
        dict(mixed_batching=False, prefill_chunk_tokens=8), penalized_workload
    ),
    "rectangle": (dict(packed_ragged=False), mixed_workload),
    "int8": (dict(kv_dtype="int8"), mixed_workload),
    "preemption": (
        dict(num_pages=16),
        lambda: [request(list(range(1 + i, 10 + i)), 16) for i in range(4)],
    ),
}


@pytest.fixture(scope="module")
def served(weights):
    """Each workload served once per loop mode: serial, pipelined, and
    pipelined with the readiness probe pinned to "not ready"."""
    np_params = weights[2]
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, (kw, make) in WORKLOADS.items():
            runs = {}
            for mode in ("serial", "async", "not-ready"):
                eng = torch_engine(np_params, async_dispatch=mode != "serial", **kw)
                if mode == "not-ready":
                    mp.setattr(engine_mod, "_handles_ready", lambda res: False)
                try:
                    streams = asyncio.run(asyncio.wait_for(serve(eng, make()), RUN_S))
                finally:
                    mp.undo()
                runs[mode] = (streams, eng)
            out[name] = runs
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("mode", ["async", "not-ready"])
@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_pipelined_streams_equal_serial(served, workload, mode):
    serial, serial_eng = served[workload]["serial"]
    streams, eng = served[workload][mode]
    assert eng._pipe_depth == 2 and serial_eng._pipe_depth == 1
    assert streams == serial
    for e in (eng, serial_eng):
        assert e.kv.allocator.used_pages == 0, "leaked pages"
        assert e.sched.num_active == 0 and not e._pending_injects
    reqs = WORKLOADS[workload][1]()
    assert [len(t) for t, _ in streams] == [
        r["stop_conditions"]["max_tokens"] for r in reqs
    ]
    assert all(f == "length" for _, f in streams)
    kinds = eng.dispatches
    if workload == "classic-penalized":
        assert kinds.get("chunk") and kinds.get("prefill") and kinds.get("decode_block")
    elif workload == "rectangle":
        assert kinds.get("unified") and kinds.get("decode_block")
    elif workload == "preemption":
        assert eng.sched.preempt_recompute > 0 and serial_eng.sched.preempt_recompute > 0
    else:
        assert kinds.get("unified") and "decode_block" not in kinds
    # no graphs on the CPU: the same dispatches run eagerly
    assert eng.graph_captures == 0 and eng.graph_replays == {}


def test_pipeline_depth_follows_the_config(weights):
    assert torch_engine(weights[2])._pipe_depth == 2
    assert torch_engine(weights[2], async_dispatch=False)._pipe_depth == 1
    assert EngineConfig().async_dispatch is True


def test_cancellation_between_enqueue_and_commit(weights, monkeypatch):
    """A cancel landing while a dispatch generation is still uncommitted
    (the probe pinned "not ready" keeps one in flight): the stale
    generation's lane is dropped at commit, no page leaks, and the next
    request runs cleanly."""
    monkeypatch.setattr(engine_mod, "_handles_ready", lambda res: False)

    async def body():
        engine = torch_engine(weights[2])
        try:
            stream = await engine.generate(
                Context.new(PreprocessedRequest.from_dict(request(range(1, 9), 60)), "victim")
            )
            got = []
            async for item in stream:
                got.append(item)
                if len(got) >= 2:
                    stream.ctx.stop_generating()
            assert len(got) >= 2
            toks, fin = await collect(engine, request(range(2, 10), 4), "after")
            assert len(toks) == 4 and fin == "length"
            for _ in range(200):
                if engine.kv.allocator.used_pages == 0:
                    break
                await asyncio.sleep(0.01)
            assert engine.kv.allocator.used_pages == 0, "cancel leaked pages"
        finally:
            await engine.stop()

    asyncio.run(asyncio.wait_for(body(), WAIT_S))


def test_stop_between_enqueue_and_commit(weights, monkeypatch):
    """Finishes (max_tokens) landing while a later generation is already
    enqueued: the replay discards the overshoot and frees every page."""
    monkeypatch.setattr(engine_mod, "_handles_ready", lambda res: False)

    async def body():
        engine = torch_engine(weights[2])
        try:
            for i in range(4):
                toks, fin = await collect(engine, request(range(1 + i, 8 + i), 2), f"s{i}")
                assert len(toks) == 2 and fin == "length"
            assert engine.kv.allocator.used_pages == 0
        finally:
            await engine.stop()

    asyncio.run(asyncio.wait_for(body(), WAIT_S))


@pytest.mark.parametrize("lanes,prompt,new,pages", [(8, 300, 160, 180), (6, 300, 200, 150)])
def test_lanes_paused_at_their_pages_revive(weights, monkeypatch, lanes, prompt, new, pages):
    """A pool too small for every lane's whole stream (page 16: lanes
    pause at their pages, the youngest is preempted): with the probe
    pinned, a lane stops at its limit on the device while a growth-only
    refresh has already raised the host's view of that limit.  Each such
    lane must still revive and finish, with the serial loop's streams
    (before ``_at_limit``, the first case hung with one lane stopped for
    good, the second gave other streams)."""
    rng = np.random.default_rng(19)
    reqs = [request(rng.integers(1, 256, prompt).tolist(), new) for _ in range(lanes)]
    kw = dict(max_batch_size=8, max_seq_len=1024, page_size=16, num_pages=pages)
    serial = asyncio.run(
        asyncio.wait_for(serve(torch_engine(weights[2], async_dispatch=False, **kw), reqs), RUN_S)
    )
    monkeypatch.setattr(engine_mod, "_handles_ready", lambda res: False)
    engine = torch_engine(weights[2], **kw)
    piped = asyncio.run(asyncio.wait_for(serve(engine, reqs), RUN_S))
    assert [len(t) for t, _ in piped] == [new] * lanes
    assert piped == serial
    assert engine.obs.preemptions._only().value > 0


def test_fanout_worker_drains_on_stop(weights):
    """Events committed before stop() reach their streams, and the worker
    task is torn down; the serial loop runs no worker."""

    async def body():
        engine = torch_engine(weights[2])
        try:
            toks, _ = await collect(engine, request([1, 2, 3], 3))
            assert len(toks) == 3
            assert engine._fanout_task is not None
        finally:
            await engine.stop()
        assert engine._fanout_task is None and engine._fanout_q is None
        serial = torch_engine(weights[2], async_dispatch=False)
        try:
            toks, _ = await collect(serial, request([1, 2, 3], 3))
            assert len(toks) == 3 and serial._fanout_task is None
        finally:
            await serial.stop()

    asyncio.run(asyncio.wait_for(body(), WAIT_S))


@pytest.mark.parametrize("async_dispatch", [True, False], ids=["async", "serial"])
def test_first_tokens_stream_before_the_decode_block(weights, async_dispatch):
    """Classic ticks dispatch a prefill group and then a decode block that
    already steps the new lanes.  The group's first tokens commit and
    stream once the group has landed, in a fanout batch of their own,
    never in the batch of that block's tokens."""
    batches = []

    async def body():
        engine = torch_engine(
            weights[2], async_dispatch=async_dispatch, mixed_batching=False,
            decode_block_size=4,
        )
        emit = engine._emit_events

        async def spy(events):
            batches.append([(ev.seq.request_id, len(ev.tokens)) for ev in events])
            await emit(events)

        engine._emit_events = spy
        return await serve(engine, [request(range(1 + i, 7 + i), 8) for i in range(3)])

    streams = asyncio.run(asyncio.wait_for(body(), WAIT_S))
    assert all(len(t) == 8 for t, _ in streams)
    for rid in ("r0", "r1", "r2"):
        first = next(b for b in batches if any(r == rid for r, _ in b))
        assert [n for r, n in first if r == rid] == [1], batches
        later = [n for b in batches if b is not first for r, n in b if r == rid]
        assert later and later[0] == 4, batches


def test_async_greedy_streams_match_jax(weights):
    """The port's pipelined loop against the JAX engine's (both at their
    default ``async_dispatch=True``) on the same weights: greedy streams
    equal token for token.  The unified dispatches by fused steps K are
    the same in the port's two loops and in the JAX engine's serial loop:
    the port reads its multistep pressure from the dispatches, so it fuses
    the same steps whenever its generations land (the JAX pipelined loop
    reads it from the commits, and its K depend on when results land)."""
    jcfg, jparams, np_params = weights
    kw = dict(prefill_chunk_tokens=8)
    reqs = [request(r["token_ids"], 12) for r in mixed_workload()]

    def jax_run(**extra):
        jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE, **kw, **extra))
        by_k: dict = {}
        unified = jeng._dispatch_unified

        def spy(chunks, fold_spec=False, num_steps=0):
            rec = unified(chunks, fold_spec, num_steps)
            if rec is not None:
                by_k[rec.n_steps] = by_k.get(rec.n_steps, 0) + 1
            return rec

        jeng._dispatch_unified = spy
        return asyncio.run(asyncio.wait_for(serve(jeng, reqs), RUN_S)), by_k

    eng = torch_engine(np_params, **kw)
    port = asyncio.run(asyncio.wait_for(serve(eng, reqs), RUN_S))
    ref, _ = jax_run()
    assert port == ref
    assert all(len(t) == 12 for t, _ in port)
    serial = torch_engine(np_params, async_dispatch=False, **kw)
    assert asyncio.run(asyncio.wait_for(serve(serial, reqs), RUN_S)) == port
    ref_serial, jax_by_k = jax_run(async_dispatch=False)
    assert ref_serial == ref
    assert eng.dispatches_by_k == serial.dispatches_by_k == jax_by_k
    assert any(k > 1 for k in jax_by_k)


# ---------------------------------------------------------------------------
# the packed shape budget: the JAX class's decisions
# ---------------------------------------------------------------------------


def _budget_reuse_and_merge():
    return 2, [(4, 10, 14, 0), (8, 8, 16, 0), (2, 6, 8, 0), (4, 10, 14, 0)]


def _budget_eviction_on_new_widest():
    return 1, [(2, 2, 4, 0), (16, 0, 16, 0), (2, 2, 4, 0)]


def _budget_spec_columns():
    return 2, [(8, 0, 8, 5), (8, 0, 8, 0), (8, 0, 8, 3)]


def _budget_random():
    rng = random.Random(0)
    seq = []
    for _ in range(200):
        s = pow2_bucket(rng.randint(1, 64))
        off = rng.randint(0, 256)
        seq.append((s, off, off + rng.randint(1, s), rng.choice((0, 0, 2, 3, 5, 9))))
    return 4, seq


@pytest.mark.parametrize(
    "case",
    [_budget_reuse_and_merge, _budget_eviction_on_new_widest, _budget_spec_columns,
     _budget_random],
    ids=["reuse-and-merge", "eviction-on-new-widest", "spec-columns", "random"],
)
def test_packed_shape_budget_decides_as_the_jax_class(case):
    budget, fits = case()
    port, ref = PackedShapeBudget(budget), JaxPackedShapeBudget(budget)
    for s, off, total, sp in fits:
        got = port.fit(s, off, total, s_spec=sp)
        assert got == ref.fit(s, off, total, s_spec=sp)
        np_got, s_got, sp_got = got
        assert s_got >= s and sp_got >= sp and off + s_got <= np_got and total <= np_got
        assert (port.merges, port.evictions, port.pairs) == (ref.merges, ref.evictions, ref.pairs)
    assert len(port) <= budget and port.spec_shapes == ref.spec_shapes


# ---------------------------------------------------------------------------
# the device-state helpers against their JAX functions
# ---------------------------------------------------------------------------

B, E, P, V = 6, 4, 5, 32


def _state(rng):
    """Random decode state [B] per tensor (numpy)."""
    return {
        "tokens": rng.integers(0, V, B),
        "seq_lens": rng.integers(0, 40, B),
        "limit_lens": rng.integers(0, 40, B),
        "active": rng.random(B) < 0.5,
        "stop_ids": rng.integers(-1, V, (B, E)),
        "page_table": rng.integers(0, 50, (B, P)).astype(np.int32),
        "temperature": rng.random(B).astype(np.float32),
        "top_p": rng.random(B).astype(np.float32),
        "top_k": rng.integers(0, 9, B),
        "freq": rng.random(B).astype(np.float32),
        "pres": rng.random(B).astype(np.float32),
        "rep": rng.random(B).astype(np.float32) + 1,
    }


def _spare(a: np.ndarray) -> torch.Tensor:
    """A [B] array as a persistent [B + 1] tensor (spare row zeroed)."""
    t = torch.from_numpy(np.concatenate([a, np.zeros_like(a[:1])]))
    return t.long() if t.dtype in (torch.int32, torch.int64) and a.ndim == 1 else t


@pytest.mark.parametrize("n_dirty", [0, 1, 4, B])
def test_update_lanes_matches_jax(n_dirty):
    rng = np.random.default_rng(n_dirty)
    st = _state(rng)
    seed = rng.integers(1, 2**31, B).astype(np.uint32)
    slots = np.full((B,), B, np.int64)  # pad rows carry slot B
    slots[:n_dirty] = rng.permutation(B)[:n_dirty]
    new = _state(rng)
    rows = {
        "token": new["tokens"], "seq_len": new["seq_lens"], "limit": new["limit_lens"],
        "active": new["active"], "stop": new["stop_ids"], "pages": new["page_table"],
        "temp": new["temperature"], "top_p": new["top_p"], "top_k": new["top_k"],
        "freq": new["freq"], "pres": new["pres"], "rep": new["rep"],
    }
    key = rng.integers(1, 2**31, B)
    seeded = rng.random(B) < 0.5
    ref = jax_step._update_lanes(
        *(jnp.asarray(st[k]) for k in (
            "tokens", "seq_lens", "limit_lens", "active", "stop_ids", "page_table",
            "temperature", "top_p", "top_k")),
        jnp.asarray(seed),
        *(jnp.asarray(st[k]) for k in ("freq", "pres", "rep")),
        jnp.asarray(slots.astype(np.int32)),
        {**{k: jnp.asarray(v) for k, v in rows.items()}, "seed": jnp.asarray(seed)},
    )
    names = [n for n, _ in step.LANE_ROWS]
    port = {n: _spare(st[n]) for n in st}
    port["key"] = torch.zeros(B + 1, dtype=torch.int64)
    port["seeded"] = torch.zeros(B + 1, dtype=torch.bool)
    step.update_lanes(
        *(port[n] for n in names), torch.from_numpy(slots),
        {**{k: torch.from_numpy(np.asarray(v)) for k, v in rows.items()},
         "key": torch.from_numpy(key), "seeded": torch.from_numpy(seeded)},
    )
    jax_names = names[:9] + ["seed"] + names[11:]
    for name, want in zip(jax_names, ref):
        if name == "seed":
            continue
        got = port[name][:B].numpy()
        np.testing.assert_array_equal(got, np.asarray(want).astype(got.dtype), err_msg=name)
    # key and seeded (the JAX state's one seed) follow the same rows
    for name, new_rows in (("key", key), ("seeded", seeded)):
        want = np.zeros(B, new_rows.dtype)
        want[slots[:n_dirty]] = new_rows[:n_dirty]
        np.testing.assert_array_equal(port[name][:B].numpy(), want)


def test_inject_tokens_match_jax():
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, V, B)
    # one lane
    ref = jax_step._inject_token(jnp.asarray(tokens), 3, jnp.asarray([17]))
    port = _spare(tokens)
    step.inject_token(port, 3, torch.tensor([17]))
    np.testing.assert_array_equal(port[:B].numpy(), np.asarray(ref))
    # a padded group: pad rows carry slot B
    slots = np.array([4, 0, B, B], np.int64)
    toks = np.array([9, 11, 5, 6])
    ref = jax_step._inject_tokens(
        jnp.asarray(tokens), jnp.asarray(slots.astype(np.int32)), jnp.asarray(toks)
    )
    port = _spare(tokens)
    step.inject_tokens(port, torch.from_numpy(slots), torch.from_numpy(toks))
    np.testing.assert_array_equal(port[:B].numpy(), np.asarray(ref))


def test_count_row_helpers_match_jax():
    rng = np.random.default_rng(2)
    counts = rng.integers(0, 3, (B, V)).astype(np.int32)
    slots = np.array([1, 4, B, B], np.int64)
    # zero
    ref = jax_step._zero_count_rows(jnp.asarray(counts), jnp.asarray(slots.astype(np.int32)))
    port = torch.from_numpy(np.concatenate([counts, np.zeros((1, V), np.int32)]))
    step.zero_count_rows(port, torch.from_numpy(slots))
    np.testing.assert_array_equal(port[:B].numpy(), np.asarray(ref))
    # bump, with a repeated (slot, token) pair
    bslots = np.array([2, 2, 5, B], np.int64)
    toks = np.array([7, 7, 30, 3])
    ref = jax_step._bump_counts(
        jnp.asarray(counts), jnp.asarray(bslots.astype(np.int32)), jnp.asarray(toks)
    )
    port = torch.from_numpy(np.concatenate([counts, np.zeros((1, V), np.int32)]))
    step.bump_counts(port, torch.from_numpy(bslots), torch.from_numpy(toks))
    np.testing.assert_array_equal(port[:B].numpy(), np.asarray(ref))
    # seed one row from a padded history (pads: token 0, amount 0)
    hist = np.array([3, 3, 9, 12, 0, 0, 0, 0])
    amounts = np.array([1, 1, PROMPT_FLAG, PROMPT_FLAG, 0, 0, 0, 0], np.int32)
    ref = jax_step._seed_count_rows(
        jnp.asarray(counts), jnp.int32(4), jnp.asarray(hist), jnp.asarray(amounts)
    )
    port = torch.from_numpy(np.concatenate([counts, np.zeros((1, V), np.int32)]))
    step.seed_count_rows(port, 4, torch.from_numpy(hist), torch.from_numpy(amounts))
    np.testing.assert_array_equal(port[:B].numpy(), np.asarray(ref))


def test_scheduler_versions_and_dirty_lanes():
    """Admission and release dirty the lane; growth bumps
    ``growth_version``; release ends the request's slot life."""
    sched = Scheduler(
        SchedulerConfig(max_batch_size=2, max_seq_len=64, page_size=4), PagePool(32)
    )
    seq = SeqState.from_request(
        "a", PreprocessedRequest.from_dict(request(range(1, 6), 20)), 4
    )
    sched.enqueue(seq)
    plan = sched.plan()
    assert plan.prefills and sched.dirty_slots == {0}
    sched.dirty_slots.clear()
    sched.ensure_decode_capacity(lookahead=9)
    assert sched.growth_version > 0 and len(seq.pages) > 2
    life = seq.life
    sched.cancel(seq)
    assert sched.dirty_slots == {0} and seq.life == life + 1
