"""KV-budget admission on the port against the JAX package's.

* **The JAX cases** (``tests/test_long_context.py``'s budget-admission
  block) on the port's scheduler and engine: the spec grammar, starvation
  freedom in both directions, an empty batch always admitting its head,
  and token identity with admission on and off, greedy and seeded.
* **Plan by plan**: one seeded workload -- arrivals, a clock, decode
  progress, releases -- drives the JAX ``Scheduler`` and the port's side by
  side: the same ids admitted on the same ticks, the same ``admit_skips``,
  ``admit_blocked`` and ``predicted_pages``, with decode lanes charged
  ``decode_inflight_tokens`` of in-flight growth.
* **Engines**: ``JaxEngine`` and ``TorchEngine`` on the same weights
  (``params_from_numpy``) with ``kv_admit_budget="on"`` on a tight pool
  give the same greedy streams; the port's pipelined loop equals its
  serial loop.
* **Knobs**: ``DYN_KV_ADMIT_BUDGET`` overrides the config (``off``
  disarms it), a malformed value warns and keeps the config, and the CLI
  parses ``--kv-admit-budget`` (with ``--block-size`` and
  ``--no-multistep-decode``) into the engine's config.

Every ``asyncio.run`` is bounded by ``asyncio.wait_for``.
"""

from __future__ import annotations

import asyncio
import logging
import time
import types

import jax
import numpy as np
import pytest

from dynamo_tpu.block_manager import PagePool as JaxPagePool
from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.protocols import common as jcommon
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.metrics import MetricsRegistry as JaxRegistry
from dynamo_tpu_torch import cli
from dynamo_tpu_torch.block_manager import PagePool
from dynamo_tpu_torch.engine import engine as engine_mod
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.scheduler import (
    KVAdmitConfig,
    Scheduler,
    SchedulerConfig,
    SeqState,
    parse_kv_admit_spec,
)
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.protocols import common as tcommon
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from tests.test_torch_ops import _free_compiled_programs  # noqa: F401 (autouse)

WAIT_S = 60  # bound on any one served request
RUN_S = 180  # bound on any one asyncio.run
TIGHT = dict(max_batch_size=4, max_seq_len=64, page_size=4, num_pages=32)
PROMPTS = [[7] * 24, [1, 2, 3, 4, 5], list(range(1, 17)), [9, 8] * 6]


# ---------------------------------------------------------------------------
# the JAX package's scheduler cases on the port's scheduler
# ---------------------------------------------------------------------------


SPECS = ["off", "0", "", "on", "1", "util=0.8,headroom=64,reserve=4,floor_s=1.5,skips=2",
         "util=0.5", " skips=7 , floor_s=0.25 "]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_parsing_equals_jax(spec):
    got, want = parse_kv_admit_spec(spec), jsched.parse_kv_admit_spec(spec)
    assert (got is None) == (want is None)
    if got is not None:
        assert vars(got) == vars(want)


@pytest.mark.parametrize("spec", ["util=0.8,bogus=1", "headroom", "util=x"])
def test_malformed_spec_raises_like_jax(spec):
    with pytest.raises(ValueError):
        jsched.parse_kv_admit_spec(spec)
    with pytest.raises(ValueError):
        parse_kv_admit_spec(spec)


def test_spec_parsing_of_non_strings():
    assert parse_kv_admit_spec(None) is None
    assert parse_kv_admit_spec(False) is None
    assert parse_kv_admit_spec(True) == KVAdmitConfig()
    cfg = KVAdmitConfig(util=0.7)
    assert parse_kv_admit_spec(cfg) is cfg


def _seq(n_tokens, max_tokens=8, tag=""):
    return SeqState.from_request(
        f"r-{tag}-{n_tokens}-{np.random.randint(1 << 30)}",
        PreprocessedRequest(
            token_ids=list(range(1, n_tokens + 1)),
            stop_conditions=tcommon.StopConditions(max_tokens=max_tokens),
            sampling_options=tcommon.SamplingOptions(temperature=0.0),
            eos_token_ids=[0],
        ),
        16,
    )


def test_budget_admission_starvation_free_both_directions():
    """Skip-ahead keeps short traffic flowing past a budget-blocked long
    head; the aging floor then stops the skip-ahead so the head admits
    once pages free -- neither side starves."""
    sched = Scheduler(
        SchedulerConfig(max_batch_size=4, max_seq_len=1024, page_size=16,
                        kv_admit=KVAdmitConfig(util=0.9, floor_s=0.5, max_skips=2)),
        PagePool(64, pages_per_block=1),
    )
    small1, small2, small3 = _seq(32, 16), _seq(32, 16), _seq(32, 16)
    big = _seq(640, 256)  # predicted 56 pages: fits alone, not alongside
    sched.enqueue(small1)
    sched.plan()
    assert small1.slot >= 0
    sched.enqueue(big)
    sched.enqueue(small2)
    sched.plan()
    # direction 1: the long head is budget-blocked, shorts keep admitting
    assert big.slot < 0
    assert small2.slot >= 0
    assert sched.admit_skips >= 1 and sched.admit_blocked >= 1
    # direction 2: once the head ages past floor_s, nothing skips it
    big.arrival_s = time.monotonic() - 10.0
    sched.enqueue(small3)
    sched.plan()
    assert small3.slot < 0, "aged head must stop skip-ahead"
    for s in (small1, small2):
        sched._release_slot(s)
    sched.plan()
    assert big.slot >= 0, "head admits once pages free"
    assert small3.slot >= 0 or small3 in sched.waiting


def test_budget_admission_empty_batch_always_admits():
    """A request whose prediction exceeds the whole budget still runs
    when the batch is empty (the physical floor is the only gate)."""
    sched = Scheduler(
        SchedulerConfig(max_batch_size=2, max_seq_len=2048, page_size=16,
                        kv_admit=KVAdmitConfig(util=0.5)),
        PagePool(64, pages_per_block=1),
    )
    huge = _seq(512, 512)  # predicted 64 pages > 0.5 * 63
    sched.enqueue(huge)
    sched.plan()
    assert huge.slot >= 0


# ---------------------------------------------------------------------------
# plan by plan against the JAX scheduler
# ---------------------------------------------------------------------------


PKGS = {
    "jax": (jsched, jcommon, JaxPagePool),
    "torch": (tsched, tcommon, PagePool),
}


def _workload(seed: int):
    """(tick, prompt length, max_tokens) arrivals: shorts with long decode
    headroom and a few long prompts, on a pool that cannot hold them all."""
    rs = np.random.default_rng(seed)
    out = []
    for i in range(14):
        tick = int(rs.integers(0, 10))
        if rs.random() < 0.25:
            out.append((tick, int(rs.integers(120, 200)), int(rs.integers(4, 16))))
        else:
            out.append((tick, int(rs.integers(8, 40)), int(rs.integers(16, 64))))
    return sorted(out, key=lambda a: a[0])


def _drive(pkg: str, seed: int, inflight: int, block: int):
    """One package's scheduler through the workload on a pinned clock:
    per tick, the arrivals enqueue, ``decode_inflight_tokens`` is set, the
    plan admits, each admitted lane commits its first token, and every
    decode lane commits up to 3 more; finished lanes leave."""
    sched_mod, common, pool_cls = PKGS[pkg]
    sched = sched_mod.Scheduler(
        sched_mod.SchedulerConfig(
            max_batch_size=6, max_seq_len=256, page_size=4, block_size=block,
            kv_admit=sched_mod.KVAdmitConfig(util=0.85, floor_s=3.0, max_skips=3,
                                              headroom_tokens=48),
        ),
        pool_cls(97, pages_per_block=block // 4),
    )
    rs = np.random.default_rng(seed + 1)
    arrivals = _workload(seed)
    ticks = []
    seqs = {}
    for tick in range(120):
        now = 1000.0 + tick
        for i, (t, n, mt) in enumerate(arrivals):
            if t == tick:
                seq = sched_mod.SeqState.from_request(
                    f"r{i}",
                    common.PreprocessedRequest(
                        token_ids=(np.arange(n) * 7 % 200 + 1 + i).tolist(),
                        stop_conditions=common.StopConditions(max_tokens=mt),
                        sampling_options=common.SamplingOptions(temperature=0.0),
                        eos_token_ids=[],
                    ),
                    block,
                )
                seq.arrival_s = now - 0.5
                seqs[seq.request_id] = seq
                sched.enqueue(seq)
        sched.decode_inflight_tokens = inflight
        predicted = {s.request_id: sched.predicted_pages(s)
                     for s in list(sched.waiting) + [s for s in sched.slots if s is not None]}
        # the planner's clock: the module's ``time`` pinned to this tick
        sched_mod.time = types.SimpleNamespace(monotonic=lambda: now)
        try:
            plan = sched.plan()
        finally:
            sched_mod.time = time
        admitted = [s.request_id for s, _n in plan.prefills]
        for s, _n in plan.prefills:
            sched.commit_prefill_token(s, int(rs.integers(1, 200)))
        B = sched.cfg.max_batch_size
        sampled = np.full((B, 3), -1, np.int32)
        for b, s in enumerate(sched.slots):
            if s is not None and s.request_id not in admitted:
                sampled[b] = rs.integers(1, 200, 3)
        sched.ensure_decode_capacity(lookahead=4)
        sched.commit_block(sampled)
        ticks.append(dict(admitted=admitted, skips=sched.admit_skips,
                          blocked=sched.admit_blocked, predicted=predicted,
                          waiting=[s.request_id for s in sched.waiting]))
    return ticks, {rid: s.finish for rid, s in seqs.items()}


@pytest.mark.parametrize("seed, inflight, block", [(0, 0, 4), (1, 16, 4), (2, 8, 16), (3, 24, 16)])
def test_plans_equal_jax_tick_by_tick(seed, inflight, block):
    t_ticks, t_fin = _drive("torch", seed, inflight, block)
    j_ticks, j_fin = _drive("jax", seed, inflight, block)
    for i, (t, j) in enumerate(zip(t_ticks, j_ticks)):
        assert t == j, f"tick {i}"
    assert {k: str(v) for k, v in t_fin.items()} == {k: str(v) for k, v in j_fin.items()}
    assert t_ticks[-1]["skips"] >= 1 and t_ticks[-1]["blocked"] >= 1
    assert all(v is not None for v in t_fin.values()), "a request never finished"


def test_inflight_tokens_charge_decode_lanes():
    sched = Scheduler(
        SchedulerConfig(max_batch_size=2, max_seq_len=256, page_size=4,
                        kv_admit=KVAdmitConfig(headroom_tokens=4)),
        PagePool(64),
    )
    seq = _seq(16, 64)
    sched.enqueue(seq)
    sched.plan()
    sched.commit_prefill_token(seq, 5)
    base = sched.predicted_pages(seq)
    sched.decode_inflight_tokens = 32
    assert sched.predicted_pages(seq) == base + (32 - 4) // 4


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


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


def request(tokens, max_tokens=6, **sampling) -> dict:
    return {
        "token_ids": list(tokens),
        "stop_conditions": {"max_tokens": max_tokens},
        "sampling_options": {"temperature": 0.0, **sampling},
        "eos_token_ids": [],
    }


async def collect(engine, req: dict) -> list:
    if isinstance(engine, JaxEngine):
        stream = await engine.generate(JaxContext.new(JaxRequest.from_dict(req)))
    else:
        stream = await engine.generate(Context.new(PreprocessedRequest.from_dict(req)))

    async def body():
        tokens = []
        async for item in stream:
            assert not item.is_error(), item.error_message()
            tokens += (item.data or {}).get("token_ids") or []
        return tokens

    return await asyncio.wait_for(body(), WAIT_S)


async def _batch(engine, prompts, max_tokens=6, **sampling):
    try:
        out = await asyncio.gather(*[collect(engine, request(p, max_tokens, **sampling))
                                     for p in prompts])
        return dict(streams=out, skips=engine.sched.admit_skips,
                    blocked=engine.sched.admit_blocked,
                    used=engine.kv.allocator.used_pages)
    finally:
        await engine.stop()


def _serve(pkg, weights, prompts, max_tokens=6, sampling=None, **kw):
    return asyncio.run(asyncio.wait_for(
        _batch(make_engine(pkg, weights, **kw), prompts, max_tokens, **(sampling or {})), RUN_S))


@pytest.fixture(scope="module")
def identity(weights):
    """The JAX identity case's batches on the port, admission on and off,
    greedy and seeded."""
    seeded = dict(temperature=0.8, top_p=0.9, seed=11)
    return {
        (budget, name): _serve("torch", weights, PROMPTS, sampling=samp,
                               kv_admit_budget=budget, **TIGHT)
        for budget in ("on", None)
        for name, samp in (("greedy", None), ("seeded", seeded))
    }


@pytest.mark.parametrize("name", ["greedy", "seeded"])
def test_budget_admission_token_identity(identity, name):
    """Budget admission reorders admission ticks under pressure, never
    tokens: the same prompts produce the same streams with it on and off."""
    assert identity[("on", name)]["streams"] == identity[(None, name)]["streams"]
    assert identity[("on", name)]["used"] == 0


# a tight pool where a long prompt waits behind shorts with long headroom
LONG_MIX = [[3] * 8, [4] * 9, list(range(60, 100)), [5] * 7, [6] * 10]
LONG_KW = dict(max_batch_size=4, max_seq_len=96, page_size=4, num_pages=24,
               kv_admit_budget="util=0.9,floor_s=30,skips=4")


@pytest.fixture(scope="module")
def cross(weights):
    out = {}
    for pkg in ("jax", "torch"):
        for loop in ("serial", "async"):
            if pkg == "jax" and loop == "async":
                continue
            out[(pkg, loop)] = _serve(pkg, weights, LONG_MIX, max_tokens=24,
                                      async_dispatch=loop == "async", **LONG_KW)
    out["off"] = _serve("torch", weights, LONG_MIX, max_tokens=24,
                        **(LONG_KW | dict(kv_admit_budget=None)))
    return out


def test_admission_streams_equal_jax(cross):
    t, j = cross[("torch", "serial")], cross[("jax", "serial")]
    assert t["streams"] == j["streams"] == cross["off"]["streams"]
    assert t["blocked"] >= 1 and t["skips"] >= 1
    assert (t["skips"], t["blocked"]) == (j["skips"], j["blocked"])
    assert t["used"] == 0


def test_admission_async_equals_serial(cross):
    a, s = cross[("torch", "async")], cross[("torch", "serial")]
    assert a["streams"] == s["streams"]
    assert a["blocked"] >= 1
    assert a["used"] == 0


def test_inflight_tokens_follow_the_pipeline_and_k(weights):
    """Before each plan the engine charges decode lanes its pipeline depth
    times its multistep K (the JAX engine's rule); 0 without multistep."""
    seen = {}

    for name, kw in {"async": {}, "serial": dict(async_dispatch=False),
                     "single-step": dict(multistep_decode=False)}.items():
        engine = make_engine("torch", weights, **TIGHT, kv_admit_budget="on", **kw)
        values = []
        plan = engine.sched.plan

        def spy(plan=plan, engine=engine, values=values):
            values.append(engine.sched.decode_inflight_tokens)
            return plan()

        engine.sched.plan = spy
        asyncio.run(asyncio.wait_for(_batch(engine, PROMPTS, 24), RUN_S))
        seen[name] = (set(values), engine._pipe_depth, engine._ms_max)
    vals, depth, kmax = seen["async"]
    assert depth == 2 and max(vals) > 0 and max(vals) <= depth * kmax
    assert all(v % depth == 0 for v in vals)
    vals, depth, kmax = seen["serial"]
    assert depth == 1 and max(vals) <= kmax
    assert seen["single-step"][0] == {0}


# ---------------------------------------------------------------------------
# the knobs
# ---------------------------------------------------------------------------


def test_env_overrides_the_config(weights, monkeypatch, caplog):
    monkeypatch.setenv("DYN_KV_ADMIT_BUDGET", "util=0.7,skips=3")
    eng = make_engine("torch", weights, **TIGHT)
    assert (eng.sched.kv_admit.util, eng.sched.kv_admit.max_skips) == (0.7, 3)
    monkeypatch.setenv("DYN_KV_ADMIT_BUDGET", "off")
    assert make_engine("torch", weights, **TIGHT, kv_admit_budget="on").sched.kv_admit is None
    monkeypatch.setenv("DYN_KV_ADMIT_BUDGET", "util=0.5,bogus=2")
    with caplog.at_level(logging.WARNING, logger=engine_mod.logger.name):
        eng = make_engine("torch", weights, **TIGHT, kv_admit_budget="skips=2")
    assert eng.sched.kv_admit.max_skips == 2
    assert "ignoring malformed DYN_KV_ADMIT_BUDGET" in caplog.text
    monkeypatch.setenv("DYN_KV_ADMIT_BUDGET", "  ")
    assert make_engine("torch", weights, **TIGHT).sched.kv_admit is None


def test_cli_flag_reaches_the_engine_config(monkeypatch):
    args = cli.build_parser().parse_args(
        ["run", "in=text", "out=torch", "--model-path", "m", "--device", "cpu",
         "--kv-admit-budget", "util=0.8,floor_s=1", "--page-size", "4", "--block-size", "16",
         "--no-multistep-decode"])
    assert args.kv_admit_budget == "util=0.8,floor_s=1"
    args.inp, args.out = cli._parse_io(args.io)
    captured = {}

    def fake(path, cfg, device=None):
        captured["cfg"] = cfg
        return object()

    monkeypatch.setattr("dynamo_tpu_torch.llm.local_model.resolve_model_path", lambda p: p)
    monkeypatch.setattr(TorchEngine, "from_pretrained", staticmethod(fake))
    cli._make_engine(args)
    cfg = captured["cfg"]
    assert (cfg.kv_admit_budget, cfg.page_size, cfg.block_size, cfg.multistep_decode) == (
        "util=0.8,floor_s=1", 4, 16, False)
