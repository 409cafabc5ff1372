"""The port's SLO plane (``runtime/slo.py``) against the JAX package's.

The ``DYN_SLO`` grammar parses, and refuses, alike; the same samples give
the same rolling-window attainment, the same violations by kind and cause
(the queue-versus-service split read from the engine's first-token note
included) and the same ``dynamo_slo_*`` series on each package's registry;
a window ages old samples out and ``refresh_gauges`` re-derives an idle
gauge.  The HTTP guard records TTFT, ITL and E2E, a shed and a deadline
record their causes, and the port's engine hands the tracker each
request's queue/service split at its first token, with the stamps the JAX
engine uses.
"""

from __future__ import annotations

import asyncio
import re

import pytest
import torch

from dynamo_tpu.http.metrics import ServiceMetrics as JaxServiceMetrics
from dynamo_tpu.runtime import metrics as jax_metrics
from dynamo_tpu.runtime import slo as jax_slo
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.model import init_params
from dynamo_tpu_torch.http.metrics import ServiceMetrics
from dynamo_tpu_torch.runtime import metrics
from dynamo_tpu_torch.runtime import slo

from tests.test_torch_async import collect

WAIT_S = 60
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run


def slo_samples(registry) -> dict:
    """``{sample name + labels: value}`` of the rendered dynamo_slo_
    families (the identity labels of a worker stripped)."""
    out = {}
    text = registry.render()[0].decode()
    for line in text.splitlines():
        if line.startswith("dynamo_slo_") and "_created" not in line:
            key, value = line.rsplit(" ", 1)
            key = re.sub(r',?(worker_id|role)="[^"]*"', "", key).replace("{,", "{")
            out[key] = float(value)
    return out


@pytest.fixture
def trackers(monkeypatch):
    """Fresh trackers of both packages as the process-wide ones, each on a
    fresh registry as its process default."""
    pairs = []
    for mod, rtm in ((slo, metrics), (jax_slo, jax_metrics)):
        reg = rtm.MetricsRegistry()
        monkeypatch.setattr(rtm, "default_registry", lambda reg=reg: reg)
        tracker = mod.SloTracker()
        monkeypatch.setattr(mod, "tracker", tracker)
        pairs.append((tracker, reg))
    return pairs


@pytest.mark.parametrize(
    "spec",
    ["ttft=300ms,itl=40ms,e2e=30s", "ttft=1.5s,window=10s", "itl=500us", "e2e=30",
     " TTFT = 2s , , e2e=1ms", "ttfx=1s", "ttft", "ttft=abcms", "ttft=-1s", "ttft=0s",
     "window=5s", "itl=ms"],
)
def test_slo_grammar_matches_jax(spec):
    """The same targets and window, or a refusal of the same spec."""
    def parse(mod):
        try:
            return mod.parse_slo_spec(spec)
        except mod.SloSpecError as e:
            return type(e).__name__, str(e)

    assert parse(slo) == parse(jax_slo)


def test_attainment_and_violations_match_jax(trackers):
    """The same samples, split notes, sheds and deadlines: equal
    attainment per kind, equal violations (kind, cause, request), equal
    ``dynamo_slo_*`` series."""
    reads = []
    for tracker, reg in trackers:
        tracker.configure("ttft=100ms,itl=10ms,e2e=5s,window=60s")
        for i, s in enumerate([0.05, 0.08, 0.15, 0.09, 0.30, 0.02, 0.11, 0.04]):
            if i % 3 == 0:
                # the engine's split: queue-wait dominated for r0, r3, r6
                tracker.note_first_token(f"r{i}", queue_s=0.3, service_s=0.01)
            tracker.record_ttft(f"r{i}", s)
        tracker.record_itl(0.002)
        tracker.record_itl(0.020)
        tracker.record_e2e("r0", 1.0)
        tracker.record_e2e("r1", 9.0)
        tracker.record_shed("shed-1")
        tracker.record_deadline("late-1", 0.5)
        tracker.refresh_gauges()
        reads.append(dict(
            attainment={k: tracker.attainment(k) for k in slo.KINDS},
            violations=[
                {k: v for k, v in d.items() if k != "ts"}
                for d in tracker.recent_violations()
            ],
            counts={(k, c): tracker.violation_count(k, c)
                    for k in slo.KINDS for c in slo.CAUSES},
            series=slo_samples(reg),
        ))
    assert reads[0] == reads[1]
    r = reads[0]
    assert r["attainment"] == {"ttft": 5 / 8, "itl": 0.5, "e2e": 1 / 4}
    # misses r2, r4, r6: r6's split says queue-wait dominated
    assert r["counts"][("ttft", "queue")] == 1
    assert r["counts"][("ttft", "service")] == 2
    assert r["counts"][("e2e", "shed")] == r["counts"][("e2e", "deadline")] == 1
    assert r["series"]['dynamo_slo_attainment{kind="ttft"}'] == 5 / 8
    assert r["series"]['dynamo_slo_target_seconds{kind="itl"}'] == 0.01


def test_queue_versus_service_split_matches_jax(trackers):
    """A TTFT miss whose engine split says queue-wait dominated is a queue
    violation; service-dominated (or no split) is a service one."""
    causes = []
    for tracker, _ in trackers:
        tracker.configure("ttft=100ms")
        tracker.note_first_token("rq", queue_s=0.4, service_s=0.05)
        tracker.record_ttft("rq", 0.45)
        tracker.note_first_token("rs", queue_s=0.01, service_s=0.3)
        tracker.record_ttft("rs", 0.31)
        tracker.record_ttft("rn", 0.2)
        causes.append({v["request_id"]: v["cause"] for v in tracker.recent_violations()})
    assert causes[0] == causes[1] == {"rq": "queue", "rs": "service", "rn": "service"}


def test_window_evicts_and_refresh_ages_out_alike(trackers):
    """An old miss leaves the window; an idle gauge re-derives to 1.0."""
    out = []
    for tracker, reg in trackers:
        tracker.configure("ttft=100ms,window=60s")
        tracker.record_ttft("old", 0.5)
        before = tracker.attainment("ttft")
        q = tracker._windows["ttft"]
        q[0] = (q[0][0] - 120.0, q[0][1])  # age the miss out
        tracker.refresh_gauges()
        idle = slo_samples(reg)['dynamo_slo_attainment{kind="ttft"}']
        tracker.record_ttft("new", 0.05)
        out.append((before, idle, tracker.attainment("ttft")))
    assert out[0] == out[1] == (0.0, 1.0, 1.0)


def test_guard_records_slo_as_jax(trackers):
    """The HTTP guard is the frontend's one recording site: TTFT at the
    first token, ITL after, E2E at a successful finish (an errored request
    records no plain E2E miss)."""
    out = []
    for (tracker, _), guard_cls in zip(trackers, (ServiceMetrics, JaxServiceMetrics)):
        tracker.configure("ttft=10s,itl=10s,e2e=10s")
        m = guard_cls()
        g = m.guard("m", "chat_completions", "rid-slo")
        g.token()
        g.token()
        g.mark_ok()
        g.finish()
        bad = m.guard("m", "chat_completions", "rid-err")
        bad.mark_error()
        bad.finish()
        out.append([len(tracker._windows[k]) for k in slo.KINDS])
    assert out[0] == out[1] == [1, 1, 1]


def test_engine_notes_the_first_token_split(trackers):
    """The port's engine hands the tracker each request's queue-wait
    (arrival -> admission) and service (admission -> first token) split
    at its first token, once."""
    tracker, _ = trackers[0]
    tracker.configure("ttft=10s")
    cfg = ModelConfig.tiny()
    eng = TorchEngine(
        cfg, init_params(cfg, 0, torch.device("cpu"), torch.float32),
        EngineConfig(max_batch_size=2, max_seq_len=64, page_size=4, num_pages=64),
        device="cpu",
    )
    reqs = [{"token_ids": [4, 5, 6, i], "stop_conditions": {"max_tokens": 4},
             "sampling_options": {"temperature": 0.0}, "eos_token_ids": []} for i in range(3)]

    async def body():
        try:
            return await asyncio.wait_for(
                asyncio.gather(*[collect(eng, r, f"q{i}") for i, r in enumerate(reqs)]),
                WAIT_S,
            )
        finally:
            await eng.stop()

    asyncio.run(asyncio.wait_for(body(), RUN_S))
    splits = [tracker.split(f"q{i}") for i in range(3)]
    assert all(s is not None and s[0] >= 0.0 and s[1] >= 0.0 for s in splits)
    assert len(tracker._splits) == 3
    # two slots: the third request queued behind the first two
    assert splits[2][0] > max(splits[0][0], splits[1][0])
