"""The port's tick profiler and flight recorder against the JAX package's.

Both packages' process-wide profilers run armed on the same traffic over the
same weights (a tiny f32 model; the JAX engines module-scoped): every tick's
phases sum to its wall within 10%; under the serial loop each tick's
dispatches by kind equal the JAX engine's tick for tick (the classic path,
the mixed packed path and the rectangle); the ``DYN_MULTISTEP`` grammar
parses alike, pinned K gives equal greedy streams and equal K sequences,
and a host-bound loop (``recent_host_occupancy`` pinned to 0.9 in both
packages) jumps K to its ceiling in both.  Then the record-level pieces
against the JAX classes on identical inputs: ``summary()``'s keys and
values, the Chrome-trace merge of tick phases and request spans, the flight
recorder's snapshot contents, co-located providers and per-reason
throttle, the engine's provider state, and a device trace on the CPU.
Every wait is bounded.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import re

import jax
import numpy as np
import pytest

from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.runtime import profiling as jax_profiling
from dynamo_tpu.runtime import slo as jax_slo
from dynamo_tpu.runtime import tracing as jax_tracing
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime import profiling, slo, tracing

from tests.test_torch_async import collect
from tests.test_torch_ops import _free_compiled_programs  # noqa: F401 (autouse)

ENGINE = dict(max_batch_size=4, max_seq_len=64, page_size=4, num_pages=64)
WAIT_S = 60  # bound on any one served batch
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run
# the serial loop's configs the tick-by-tick comparison serves
TICK_CONFIGS = {
    "classic": dict(mixed_batching=False, prefill_chunk_tokens=8),
    "mixed": dict(prefill_chunk_tokens=8),
    "rectangle": dict(packed_ragged=False),
}


def request(tokens, max_tokens=10) -> dict:
    return {
        "token_ids": list(tokens),
        "stop_conditions": {"max_tokens": max_tokens},
        "sampling_options": {"temperature": 0.0},
        "eos_token_ids": [],
    }


def workload():
    """Five greedy prompts of 6 to 22 tokens, admitted together."""
    return [request(list(range(1 + i, 7 + 4 * i)), 10) for i in range(5)]


async def serve(engine, reqs, timeout=WAIT_S):
    try:
        return await asyncio.wait_for(
            asyncio.gather(*[collect(engine, r, f"r{i}") for i, r in enumerate(reqs)]),
            timeout,
        )
    finally:
        await engine.stop()


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def jax_engine(weights, **kw) -> JaxEngine:
    jcfg, jparams, _ = weights
    return JaxEngine(jcfg, jparams, JaxEngineConfig(**{**ENGINE, **kw}))


def torch_engine(weights, **kw) -> TorchEngine:
    cfg = ModelConfig.tiny()
    params = params_from_numpy(weights[2], cfg, device="cpu")
    return TorchEngine(cfg, params, EngineConfig(**{**ENGINE, **kw}), device="cpu")


def jax_record(r) -> "jax_profiling.TickRecord":
    """The JAX package's record of a port record (its marks left out)."""
    return jax_profiling.TickRecord(
        idx=r.idx, start_s=r.start_s, wall_s=r.wall_s, phases=r.phases,
        dispatches=r.dispatches, gap_s=r.gap_s, n_gaps=r.n_gaps,
    )


class Armed:
    """Both packages' profilers armed and cleared, restored on exit;
    ``occupancy`` pins ``recent_host_occupancy`` in both (None = no
    reading, so the adaptive controllers ramp alike)."""

    def __init__(self, mp: pytest.MonkeyPatch, occupancy="unset") -> None:
        self.mp = mp
        self.occupancy = occupancy

    def __enter__(self):
        self.was = [p.enabled for p in (profiling.profiler, jax_profiling.profiler)]
        for p in (profiling.profiler, jax_profiling.profiler):
            p.clear()
            p.enable()
            if self.occupancy != "unset":
                self.mp.setattr(p, "recent_host_occupancy", lambda last=32: self.occupancy)
        return self

    def __exit__(self, *exc):
        for p, was in zip((profiling.profiler, jax_profiling.profiler), self.was):
            p.clear()
            if not was:
                p.disable()
        self.mp.undo()
        return False


@pytest.fixture(scope="module")
def ticked(weights):
    """Each TICK_CONFIGS config served once per package in the serial loop
    with both profilers armed (occupancy pinned to no reading): the streams
    and each package's tick records."""
    out = {}
    mp = pytest.MonkeyPatch()
    for name, kw in TICK_CONFIGS.items():
        kw = dict(kw, async_dispatch=False)
        with Armed(mp, occupancy=None):
            jstreams = asyncio.run(
                asyncio.wait_for(serve(jax_engine(weights, **kw), workload()), RUN_S)
            )
            jrecs = jax_profiling.profiler.records()
        with Armed(mp, occupancy=None):
            eng = torch_engine(weights, **kw)
            tstreams = asyncio.run(asyncio.wait_for(serve(eng, workload()), RUN_S))
            trecs = profiling.profiler.records()
        out[name] = dict(jax=(jstreams, jrecs), port=(tstreams, trecs, eng))
    return out


@pytest.mark.parametrize("config", list(TICK_CONFIGS))
def test_tick_phases_sum_to_the_wall(ticked, config):
    """Every tick record's phases (``other`` included) sum to its wall
    within 10%, in the port's records and in the JAX engine's."""
    _, trecs, _ = ticked[config]["port"]
    _, jrecs = ticked[config]["jax"]
    assert trecs and jrecs
    for recs in (trecs, jrecs):
        for r in recs:
            total = sum(r.phases.values())
            assert abs(total - r.wall_s) <= 0.1 * r.wall_s + 1e-6, r.to_dict()
    assert set().union(*(r.phases for r in trecs)) <= set(profiling.PHASES)
    for r in trecs:
        # the marks lay the phases out in time: each ends after the last
        assert [p for p, _ in r.marks][-1] == "other"
        ends = [t for _, t in r.marks]
        assert ends == sorted(ends) and abs(ends[-1] - r.wall_s) <= 1e-3
        assert r.phase_at(0.0) == r.marks[0][0] and r.phase_at(r.wall_s + 1) is None


@pytest.mark.parametrize("config", list(TICK_CONFIGS))
def test_tick_dispatches_equal_the_jax_engines(ticked, config):
    """Serial loop, same traffic: the port's streams equal the JAX
    engine's, and so do the dispatching ticks' dispatch kinds and counts,
    tick for tick; their totals equal the port's own counters."""
    tstreams, trecs, eng = ticked[config]["port"]
    jstreams, jrecs = ticked[config]["jax"]
    assert tstreams == jstreams
    port = [r.dispatches for r in trecs if r.dispatches]
    ref = [r.dispatches for r in jrecs if r.dispatches]
    assert port == ref
    totals: dict = {}
    for d in port:
        for k, n in d.items():
            totals[k] = totals.get(k, 0) + n
    assert totals == eng.dispatches
    # the dispatch gaps: one per results-ready -> next enqueue, in both
    assert sum(r.n_gaps for r in trecs) > 0 and sum(r.n_gaps for r in jrecs) > 0


def test_summary_matches_the_jax_profiler(ticked):
    """``summary()`` over identical records: the same keys and the same
    values in both packages."""
    _, trecs, _ = ticked["classic"]["port"]
    jp = jax_profiling.TickProfiler()
    tp = profiling.TickProfiler()
    for r in trecs:
        jp._ring.append(jax_record(r))
        tp._ring.append(r)
    for p in (jp, tp):
        p._compiles["packed"] = 2
    assert tp.summary() == jp.summary()
    assert set(tp.summary()) == {
        "ticks", "dispatches", "wall_s", "host_s", "host_occupancy", "phase_totals_s",
        "top_phases", "gap_p50_ms", "gap_p95_ms", "compile_events",
    }
    assert tp.recent_host_occupancy() is None  # disabled: no reading
    tp.enable()
    jp.enable()
    assert tp.recent_host_occupancy() == jp.recent_host_occupancy()


def test_chrome_trace_merge_matches_the_jax_export(ticked, monkeypatch):
    """Tick phases merged with request spans: the port's Chrome trace
    equals the JAX package's on the same records and spans (both clocks'
    wall offsets pinned to 0), with an ``engine.tick`` process row beside
    the spans' and each phase inside its tick's window."""
    monkeypatch.setattr(tracing, "_MONO_TO_WALL", 0.0)
    monkeypatch.setattr(jax_tracing, "_MONO_TO_WALL", 0.0)
    _, trecs, _ = ticked["mixed"]["port"]
    tp, jp = profiling.TickProfiler(), jax_profiling.TickProfiler()
    for r in trecs:
        tp._ring.append(r)
        jp._ring.append(jax_record(r))
    spans = [
        tracing.Span("http.request", "rid-1", trecs[0].start_s, trecs[-1].start_s + 0.5,
                     trace_id="t1", span_id="s1", component="http").to_dict(),
        tracing.Span("engine.prefill_dispatch", "rid-1", trecs[0].start_s,
                     trecs[0].start_s + 1e-3, component="engine",
                     attrs={"mixed": True}).to_dict(),
    ]
    merged = tp.chrome_trace(spans)
    assert merged == jp.chrome_trace(spans)
    events = merged["traceEvents"]
    rows = {e["args"]["name"] for e in events if e.get("ph") == "M"}
    assert {"engine.tick", "http", "engine"} <= rows
    ticks = {e["args"]["request_id"]: e for e in events if e["name"] == "tick"}
    phases = [e for e in events if e.get("ph") == "X" and e["name"] in profiling.PHASES]
    assert ticks and phases
    for e in phases:
        t = ticks[e["args"]["request_id"]]
        assert e["ts"] >= t["ts"] - 5.0
        assert e["ts"] + e["dur"] <= t["ts"] + t["dur"] + 5.0


# ---------------------------------------------------------------------------
# DYN_MULTISTEP and the occupancy jump
# ---------------------------------------------------------------------------


def grammar_case(engine_of, monkeypatch, value, **kw):
    if value is None:
        monkeypatch.delenv("DYN_MULTISTEP", raising=False)
    else:
        monkeypatch.setenv("DYN_MULTISTEP", value)
    eng = engine_of(**kw)
    try:
        fixed = getattr(eng, "_multistep_fixed", None) if isinstance(eng, JaxEngine) \
            else eng._ms_fixed
        ceiling = eng._multistep_max if isinstance(eng, JaxEngine) else eng._ms_max
        return eng._multistep, fixed, ceiling
    finally:
        asyncio.run(asyncio.wait_for(eng.stop(), RUN_S))


@pytest.mark.parametrize(
    "value,kw",
    [("0", {}), ("off", {}), ("4", {}), ("16", {}), ("1", {}), ("adaptive", {}),
     ("on", dict(packed_ragged=False)), ("adaptive", dict(mixed_batching=False)),
     ("bogus", {}), (None, {})],
)
def test_dyn_multistep_grammar_matches_jax(weights, monkeypatch, caplog, value, kw):
    """0/off disables, 1/on/adaptive is the controller (on the packed mixed
    plane only), N > 1 is fixed K = N with the ceiling raised to N, a
    malformed value warns and keeps the config -- on both engines alike."""
    caplog.set_level(logging.WARNING)
    port = grammar_case(lambda **k: torch_engine(weights, **k), monkeypatch, value, **kw)
    ref = grammar_case(lambda **k: jax_engine(weights, **k), monkeypatch, value, **kw)
    assert port == ref
    if value == "bogus":
        warned = [r for r in caplog.records if "DYN_MULTISTEP" in r.getMessage()]
        assert len(warned) == 2  # one per engine


def by_k_spy(eng) -> dict:
    """The engine's unified dispatches by fused steps K, in dispatch order."""
    seq: list = []
    if isinstance(eng, JaxEngine):
        unified = eng._dispatch_unified

        def spy(chunks, fold_spec=False, num_steps=0):
            rec = unified(chunks, fold_spec, num_steps)
            if rec is not None:
                seq.append(rec.n_steps)
            return rec

        eng._dispatch_unified = spy
    else:
        unified = eng._dispatch_unified

        def spy(chunks, num_steps, fold_spec=False):
            rec = unified(chunks, num_steps, fold_spec)
            if rec is not None:
                seq.append(rec.n_steps)
            return rec

        eng._dispatch_unified = spy
    return seq


@pytest.mark.parametrize(
    "value,occupancy",
    [("4", "unset"), ("0", "unset"), ("adaptive", None), ("adaptive", 0.9)],
)
def test_multistep_k_sequences_equal_jax(weights, monkeypatch, value, occupancy):
    """Serial loop, greedy: under ``DYN_MULTISTEP`` = 4, 0 and adaptive
    (no occupancy reading), and adaptive with ``recent_host_occupancy``
    pinned to 0.9 in both packages (the jump to the ceiling), the port's
    streams and its sequence of fused K equal the JAX engine's; pinned to
    4 only K 1 and 4 occur, and the jump reaches K 8 without the ramp."""
    monkeypatch.setenv("DYN_MULTISTEP", value)
    reqs = [request(list(range(1 + i, 9 + i)), 24) for i in range(3)]
    runs = {}
    for pkg, make in (("jax", jax_engine), ("port", torch_engine)):
        with Armed(pytest.MonkeyPatch(), occupancy=occupancy):
            eng = make(weights, async_dispatch=False)
            seq = by_k_spy(eng)
            runs[pkg] = (asyncio.run(asyncio.wait_for(serve(eng, reqs), RUN_S)), seq)
    assert runs["port"] == runs["jax"]
    streams, seq = runs["port"]
    assert all(len(t) == 24 for t, _ in streams)
    if value == "4":
        assert set(seq) == {1, 4}
    elif value == "0":
        assert set(seq) == {1}  # prefill ticks only: decode takes blocks
    elif occupancy == 0.9:
        first = seq.index(next(k for k in seq if k > 1))
        assert seq[first] == 8  # no 2, 4 ramp: straight to the ceiling
    else:
        assert 2 in seq and 8 in seq  # the ramp


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------


@pytest.fixture
def recorders():
    """Fresh flight recorders of both packages and both SLO trackers
    disarmed; the process-wide ones restored after."""
    for mod in (profiling, jax_profiling):
        mod.flight_recorder.clear()
    slo.tracker.disable()
    jax_slo.tracker.disable()
    yield profiling.flight_recorder, jax_profiling.flight_recorder
    for mod in (profiling, jax_profiling):
        mod.flight_recorder.clear()
    slo.tracker.disable()
    jax_slo.tracker.disable()


def strip_times(snap: dict) -> dict:
    """A snapshot without its wall-clock stamps."""
    out = dict(snap)
    out.pop("ts")
    assert re.fullmatch(r"fr-\d{4,}", out.pop("id"))
    out["slo_violations"] = [
        {k: v for k, v in d.items() if k != "ts"} for d in snap["slo_violations"]
    ]
    out["ticks"] = [{k: v for k, v in t.items() if k != "start_s"} for t in snap["ticks"]]
    return out


def test_flight_recorder_snapshot_matches_jax(recorders, ticked, monkeypatch):
    """The same tick ring, SLO violation and provider give the same
    snapshot (reason, trace id, extra, tick window, violations, state) in
    both packages; the listing and unknown ids agree too."""
    port_fr, jax_fr = recorders
    _, trecs, _ = ticked["classic"]["port"]
    tp, jp = profiling.TickProfiler(), jax_profiling.TickProfiler()
    for r in trecs:
        tp._ring.append(r)
        jp._ring.append(jax_record(r))
    monkeypatch.setattr(profiling, "profiler", tp)
    monkeypatch.setattr(jax_profiling, "profiler", jp)
    snaps = []
    for fr, tracker in ((port_fr, slo.tracker), (jax_fr, jax_slo.tracker)):
        tracker.configure("ttft=1ms")
        tracker.record_ttft("slow-req", 0.5)
        fr.add_provider("unit", lambda: {"queue": 3})
        try:
            fid = fr.snapshot("unit_test", request_id="slow-req")
        finally:
            fr.remove_provider("unit")
        snap = fr.get(fid)
        assert fr.list()[0]["id"] == fid and fr.get("fr-nope") is None
        snaps.append(strip_times(snap))
    assert snaps[0] == snaps[1]
    snap = snaps[0]
    assert snap["reason"] == "unit_test" and snap["trace_id"] == "slow-req"
    assert snap["state"] == {"unit": {"queue": 3}}
    assert len(snap["ticks"]) == min(len(trecs), port_fr.tick_window)
    assert [v["cause"] for v in snap["slo_violations"]] == ["service"]


def test_flight_recorder_providers_and_throttle_match_jax(recorders):
    """Two co-located engines' providers both land (``engine``,
    ``engine#2``), a provider that raises is recorded, not fatal, and a
    second trigger of one reason inside the interval reuses the snapshot,
    in both packages."""
    ids = []
    for fr in recorders:
        a = fr.add_provider("engine", lambda: {"who": "a"})
        b = fr.add_provider("engine", lambda: {"who": "b"})
        c = fr.add_provider("broken", lambda: 1 / 0)
        assert (a, b, c) == ("engine", "engine#2", "broken")
        s1 = fr.snapshot("storm")
        s2 = fr.snapshot("storm")
        s3 = fr.snapshot("other_reason")
        state = fr.get(s1)["state"]
        assert state["engine"] == {"who": "a"} and state["engine#2"] == {"who": "b"}
        assert "ZeroDivisionError" in state["broken"]["error"]
        for key in (a, b, c):
            fr.remove_provider(key)
        ids.append(s1 == s2 != s3)
    assert ids == [True, True]


def test_engine_provider_state_matches_jax(recorders, weights):
    """While an engine runs, snapshots carry its ``engine`` provider: the
    same keys and, idle after a served batch, the same values as the JAX
    engine's; stop() removes it."""
    states = []
    for make, fr in ((torch_engine, recorders[0]), (jax_engine, recorders[1])):

        async def body(eng=make(weights), fr=fr):
            await eng.start()
            try:
                await asyncio.wait_for(
                    asyncio.gather(*[collect(eng, r) for r in workload()[:2]]), WAIT_S
                )
                return fr.get(fr.snapshot("probe"))["state"]
            finally:
                await eng.stop()

        states.append(asyncio.run(asyncio.wait_for(body(), RUN_S)))
        assert "engine" not in fr.get(fr.snapshot("after_stop"))["state"]
    assert states[0] == states[1]
    assert states[0]["engine"]["tokens_generated"] == 2 * 10


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------


def test_device_trace_on_the_cpu(tmp_path):
    """A capture on the CPU: ``ok`` with JAX's body keys, the duration
    clamped to 0.05..30 s, a Chrome trace written under ``log_dir``; a
    second capture while one runs answers ``ok=false``."""

    async def body():
        first = asyncio.ensure_future(
            profiling.capture_device_trace(0.3, str(tmp_path / "a"))
        )
        await asyncio.sleep(0.05)
        second = await profiling.capture_device_trace(0.01, str(tmp_path / "b"))
        return await asyncio.wait_for(first, WAIT_S), second

    first, second = asyncio.run(asyncio.wait_for(body(), RUN_S))
    assert first == {"ok": True, "log_dir": str(tmp_path / "a"), "duration_s": 0.3}
    assert second["ok"] is False and "already running" in second["error"]
    with open(tmp_path / "a" / profiling.DEVICE_TRACE_FILE) as fh:
        assert json.load(fh)["traceEvents"]
    third = asyncio.run(
        asyncio.wait_for(profiling.capture_device_trace(0.0001, str(tmp_path / "c")), WAIT_S)
    )
    assert third["ok"] and third["duration_s"] == 0.05
    assert os.path.exists(tmp_path / "c" / profiling.DEVICE_TRACE_FILE)
