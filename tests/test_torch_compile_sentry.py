"""The port's compile sentry (``runtime/compile_sentry.py``) against the JAX
package's.

The module API behaves alike in both packages: thread-local and nested
entry labels, counts per entry, the ``dynamo_compile_events_total`` series,
the feed into the tick profiler's ``compile_events``, and budgets that
raise only armed, only past a registered limit, at the site.  The port's
events: ``engine/graphs.py`` registers ``GRAPH_BUDGET`` (one budget per
graph kind) at import, derived from the key space the engine mints graphs
in, and each ``nvcc`` build counts under ``kernel_build``, with no budget.
On the CPU an engine captures no graph, so its sentry total stays equal to
``graph_captures`` (0); the card's count is ``test_torch_cuda.py``'s.
"""

from __future__ import annotations

import asyncio
import subprocess
import threading

import pytest
import torch

from dynamo_tpu.runtime import compile_sentry as jax_sentry
from dynamo_tpu.runtime import profiling as jax_profiling
from dynamo_tpu_torch.engine import graphs
from dynamo_tpu_torch.engine.bucketing import PACKED_SHAPE_BUDGET
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.model import init_params
from dynamo_tpu_torch.ops import build
from dynamo_tpu_torch.runtime import compile_sentry, metrics, profiling

from tests.test_torch_async import collect

RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run

PACKAGES = {"port": (compile_sentry, profiling), "jax": (jax_sentry, jax_profiling)}


@pytest.fixture(params=list(PACKAGES))
def sentry(request):
    """One package's sentry from a clean slate, disarmed and zeroed after."""
    mod, _ = PACKAGES[request.param]
    mod.reset()
    prev = mod.arm(False)
    yield mod
    mod.arm(prev)
    mod.reset()
    mod.set_entry(None)


def events_sample(entry: str) -> float:
    """The port's ``dynamo_compile_events_total{entry}`` in the process
    registry (0 before its first event)."""
    for line in metrics.default_registry().render()[0].decode().splitlines():
        if line.startswith("dynamo_compile_events_total{") and f'entry="{entry}"' in line:
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def test_entry_labels_are_thread_local_and_nest(sentry):
    sentry.set_entry("alpha")
    seen = []
    t = threading.Thread(target=lambda: seen.append(sentry.current_entry()))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert sentry.current_entry() == "alpha" and seen == [None]
    sentry.set_entry(None)
    with sentry.entry("outer"):
        with sentry.entry("inner"):
            assert sentry.current_entry() == "inner"
        assert sentry.current_entry() == "outer"
    assert sentry.current_entry() is None


def test_counts_attribute_to_the_current_entry(sentry):
    with sentry.entry("probe_entry"):
        sentry.note_compilation()
        sentry.note_compilation()
    sentry.note_compilation()
    assert sentry.counts() == {"probe_entry": 2, sentry.UNATTRIBUTED: 1}
    assert sentry.total() == 3
    sentry.reset()
    assert sentry.counts() == {} and sentry.total() == 0


def test_budgets_raise_only_armed_past_a_registered_limit(sentry):
    sentry.register_budgets({"t_strict": 2})
    for _ in range(4):
        sentry.note_compilation("t_strict")  # disarmed: counts, never raises
    sentry.reset()
    sentry.arm(True)
    sentry.note_compilation("t_strict")
    sentry.note_compilation("t_strict")
    with pytest.raises(sentry.CompileBudgetError) as exc:
        sentry.note_compilation("t_strict")
    assert "t_strict" in str(exc.value) and "budget 2" in str(exc.value)
    assert sentry.ENV_VAR in str(exc.value)
    for _ in range(20):
        sentry.note_compilation("t_adhoc")  # no budget: never raises
    assert sentry.counts() == {"t_strict": 3, "t_adhoc": 20}
    assert issubclass(sentry.CompileBudgetError, AssertionError)


def test_the_profiler_prices_events(sentry):
    prof = profiling.profiler if sentry is compile_sentry else jax_profiling.profiler
    was = prof.enabled
    prof.clear()
    prof.enable()
    try:
        sentry.note_compilation("prof_probe")
        sentry.note_compilation("prof_probe")
        assert prof.summary()["compile_events"] == {"prof_probe": 2}
    finally:
        prof.clear()
        if not was:
            prof.disable()


def test_the_api_is_the_jax_modules():
    names = ("entry", "set_entry", "current_entry", "register_budgets", "budgets",
             "counts", "total", "reset", "note_compilation", "armed", "arm",
             "CompileBudgetError", "ENV_VAR", "UNATTRIBUTED")
    for name in names:
        assert hasattr(compile_sentry, name) and hasattr(jax_sentry, name), name
    assert compile_sentry.ENV_VAR == jax_sentry.ENV_VAR


def test_events_count_in_the_series():
    before = events_sample("metric_probe")
    compile_sentry.note_compilation("metric_probe")
    compile_sentry.note_compilation("metric_probe")
    assert events_sample("metric_probe") == before + 2.0
    compile_sentry.reset()


def test_graph_budgets_are_registered_per_kind():
    """The graphs register a budget per captured kind, derived from the key
    space: the packed pairs a decode-only dispatch can mint (s_max 1,
    power-of-two lane buckets, within PACKED_SHAPE_BUDGET) x page-table
    widths x sampling variants; the step's widths x variants x penalties."""
    budgets = compile_sentry.budgets()
    assert budgets["packed"] == graphs.GRAPH_BUDGET["packed"] == (
        min(PACKED_SHAPE_BUDGET, 9) * 10 * 4
    )
    assert budgets["step"] == graphs.GRAPH_BUDGET["step"] == 10 * 4 * 2
    assert compile_sentry.KERNEL_BUILD not in budgets


def test_a_kernel_build_counts_under_its_own_entry(monkeypatch, tmp_path):
    """Starting an ``nvcc`` build is one ``kernel_build`` event (armed, never
    a budget overrun); a kernel whose library is built starts none."""
    started = []

    class FakeProc:
        def __init__(self, cmd, **kw):
            started.append(cmd)

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", FakeProc)
    kernel = build.KERNELS[0]
    monkeypatch.setattr(type(kernel), "library_path", lambda self: tmp_path / f"{self.name}.so")
    compile_sentry.reset()
    prev = compile_sentry.arm(True)
    try:
        for _ in range(3):
            assert kernel.start_build() is not None
        (tmp_path / f"{kernel.name}.so").write_bytes(b"")
        assert kernel.start_build() is None
        assert compile_sentry.counts() == {compile_sentry.KERNEL_BUILD: 3}
        assert len(started) == 3
    finally:
        compile_sentry.arm(prev)
        compile_sentry.reset()


def test_a_cpu_engine_captures_nothing():
    """Armed, a served CPU batch raises nothing and counts no capture: the
    sentry's total equals the engine's ``graph_captures``."""
    cfg = ModelConfig.tiny()
    eng = TorchEngine(
        cfg, init_params(cfg, 0, torch.device("cpu"), torch.float32),
        EngineConfig(max_batch_size=2, max_seq_len=64, page_size=4, num_pages=64),
        device="cpu",
    )
    reqs = [{"token_ids": list(range(1, 9 + i)), "stop_conditions": {"max_tokens": 12},
             "sampling_options": {"temperature": 0.0}, "eos_token_ids": []} for i in range(3)]
    compile_sentry.reset()
    prev = compile_sentry.arm(True)

    async def body():
        try:
            return await asyncio.wait_for(asyncio.gather(*[collect(eng, r) for r in reqs]), 60)
        finally:
            await eng.stop()

    try:
        streams = asyncio.run(asyncio.wait_for(body(), RUN_S))
        assert all(len(t) == 12 for t, _ in streams)
        assert compile_sentry.total() == eng.graph_captures == 0
    finally:
        compile_sentry.arm(prev)
        compile_sentry.reset()
