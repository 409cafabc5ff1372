"""The port's SLA profiler and its ``profile-sla`` subcommand.

The cases of ``tests/test_profile_sla.py`` on the port's mocker; the
port's ``SlaProfile.recommend`` against the JAX package's on the same
seeded tables; a profile of a 2-layer f32 ``TorchEngine`` on the CPU;
``python -m dynamo_tpu_torch profile-sla`` as a subprocess over a
checkpoint written here (``--out torch|mocker|echo``), whose printed
recommendation must be the rule applied to its printed table; and the
``fleet --plan`` view of a summary whose plan a planner's
``on_adjustment`` wrote through ``FleetObservatory.note_adjustment``.
"""

from __future__ import annotations

import asyncio
import contextlib
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dynamo_tpu_torch
from dynamo_tpu.planner.profile_sla import SlaProfile as JaxProfile
from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine
from dynamo_tpu_torch.planner.profile_sla import SlaProfile, SlaProfiler
from dynamo_tpu_torch.runtime import metrics as rtm
from tests.test_torch_isolation import _checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(dynamo_tpu_torch.__file__)))
WAIT_S = 60.0


def test_profile_measures_mocker_latencies(run):
    """A mocker with a known per-step decode cost must profile to roughly
    that ITL, and TTFT must grow with ISL (prefill cost model)."""

    async def main():
        engine = MockerEngine(
            MockerConfig(block_size=4, prefill_s_per_compute=0.000001,
                         decode_s_per_step=0.005, vocab_size=300),
            registry=rtm.MetricsRegistry(),
        )
        try:
            return await asyncio.wait_for(SlaProfiler(engine, vocab_size=300).profile(
                isls=[16, 256], batches=[1, 4], osl=24, ttft_repeats=2), WAIT_S)
        finally:
            await engine.stop()

    prof = run(main())
    # decode_s_per_step=5ms is the floor; asyncio timer granularity adds
    # real overhead on top, so only bound loosely
    assert 3.0 < prof.itl_ms[1] < 80.0
    assert prof.ttft_ms[256] > prof.ttft_ms[16]
    # the mocker's tick cost scales with active KV blocks, so batch 4
    # carries ~4x the blocks per tick: ITL grows with batch
    assert prof.itl_ms[4] >= prof.itl_ms[1] * 0.8
    assert prof.tok_s[4] > 0 and prof.tok_s[1] > 0


def test_recommendation_picks_largest_within_slo():
    prof = SlaProfile(
        ttft_ms={128: 20.0, 512: 45.0, 2048: 140.0},
        itl_ms={1: 4.0, 4: 5.0, 8: 9.0, 16: 20.0},
        tok_s={1: 250.0, 4: 800.0, 8: 890.0, 16: 800.0},
    )
    rec = prof.recommend(ttft_slo_ms=50.0, itl_slo_ms=10.0)
    assert rec["max_isl_within_ttft_slo"] == 512
    assert rec["max_batch_within_itl_slo"] == 8
    assert rec["throughput_at_max_batch"] == 890.0
    # unconstrained -> the largest measured everything
    rec = prof.recommend(None, None)
    assert rec["max_isl_within_ttft_slo"] == 2048
    assert rec["max_batch_within_itl_slo"] == 16


def test_recommendation_none_when_slo_unreachable():
    prof = SlaProfile(ttft_ms={128: 90.0}, itl_ms={1: 50.0}, tok_s={1: 20.0})
    rec = prof.recommend(ttft_slo_ms=10.0, itl_slo_ms=10.0)
    assert rec["max_isl_within_ttft_slo"] is None
    assert rec["max_batch_within_itl_slo"] is None
    assert rec["throughput_at_max_batch"] is None


def test_profile_cli():
    """The profile-sla subcommand runs against the mocker in process and
    prints the table + recommendation JSON."""
    from dynamo_tpu_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([
            "profile-sla", "--out", "mocker",
            "--isl", "8,16", "--batch", "1,2", "--osl", "8",
            "--ttft-slo-ms", "10000", "--itl-slo-ms", "10000",
        ])
    assert rc == 0
    out = json.loads(buf.getvalue())
    assert set(out) == {"profile", "recommendation"}
    assert out["recommendation"]["max_batch_within_itl_slo"] == 2


def seeded_table(seed: int):
    """A profile table of seeded latencies (TTFT not always rising with
    ISL, nor ITL with batch) and SLO pairs around its values."""
    rng = np.random.default_rng(seed)
    isls = sorted(rng.choice([64, 128, 256, 512, 1024, 2048, 4096], 4, replace=False))
    batches = sorted(rng.choice([1, 2, 4, 8, 16, 32], 4, replace=False))
    ttft = {int(i): float(rng.uniform(5, 500)) for i in isls}
    itl = {int(b): float(rng.uniform(2, 40)) for b in batches}
    tok_s = {int(b): float(rng.uniform(50, 5000)) for b in batches}
    slos = [(None, None), (float(rng.uniform(5, 500)), None),
            (None, float(rng.uniform(2, 40)))]
    slos += [(float(rng.uniform(5, 500)), float(rng.uniform(2, 40))) for _ in range(6)]
    slos.append((min(ttft.values()) - 1.0, min(itl.values()) - 1.0))
    return (ttft, itl, tok_s), slos


@pytest.mark.parametrize("seed", range(6))
def test_recommend_equals_jax(seed):
    (ttft, itl, tok_s), slos = seeded_table(seed)
    port = SlaProfile(ttft_ms=dict(ttft), itl_ms=dict(itl), tok_s=dict(tok_s))
    jax = JaxProfile(ttft_ms=dict(ttft), itl_ms=dict(itl), tok_s=dict(tok_s))
    for t, i in slos:
        assert port.recommend(t, i) == jax.recommend(t, i)
    assert port.to_dict() == jax.to_dict()


def test_profile_torch_engine_on_cpu(run):
    """A 2-layer f32 TorchEngine on the CPU: every probe streams, and the
    table's TTFTs, ITLs and rates are finite and positive."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.engine.config import ModelConfig
    from dynamo_tpu_torch.engine.model import init_params

    cfg = ModelConfig.tiny()
    params = init_params(cfg, 0, torch.device("cpu"), torch.float32)

    async def main():
        engine = TorchEngine(cfg, params, EngineConfig(max_seq_len=256, num_pages=64),
                             device="cpu", metrics_registry=rtm.MetricsRegistry())
        try:
            return await asyncio.wait_for(
                SlaProfiler(engine, vocab_size=cfg.vocab_size).profile(
                    isls=[16, 64], batches=[1, 4], osl=32, ttft_repeats=2), WAIT_S)
        finally:
            await engine.stop()

    prof = run(main())
    assert sorted(prof.ttft_ms) == [16, 64]
    assert sorted(prof.itl_ms) == sorted(prof.tok_s) == [1, 4]
    for table in (prof.ttft_ms, prof.itl_ms, prof.tok_s):
        assert all(math.isfinite(v) and v > 0 for v in table.values()), table
    rec = prof.recommend(None, None)
    assert rec["max_isl_within_ttft_slo"] == 64
    assert rec["max_batch_within_itl_slo"] == 4


def check_recommended(rec: dict, table: dict, ttft_slo, itl_slo) -> None:
    """``rec`` is the recommendation rule applied to a printed ``to_dict``
    table (whose rates are rounded to 0.1 tok/s)."""
    ttft = {int(k): v for k, v in table["ttft_ms"].items()}
    itl = {int(k): v for k, v in table["itl_ms"].items()}
    tok_s = {int(k): v for k, v in table["tok_s"].items()}
    want = SlaProfile(ttft_ms=ttft, itl_ms=itl, tok_s=tok_s).recommend(ttft_slo, itl_slo)
    assert set(rec) == set(want)
    for key in ("max_isl_within_ttft_slo", "max_batch_within_itl_slo"):
        assert rec[key] == want[key], key
    assert rec["throughput_at_max_batch"] == pytest.approx(
        want["throughput_at_max_batch"], abs=0.05)


@pytest.mark.parametrize("out", ["torch", "mocker", "echo"])
def test_profile_sla_subcommand(model_dir, tmp_path, out):
    """``python -m dynamo_tpu_torch profile-sla --out OUT`` over a
    checkpoint directory: exit code 0, one JSON object with ``profile``
    and ``recommendation``, the recommendation the rule applied to the
    printed table."""
    ckpt = _checkpoint(model_dir, str(tmp_path / "ckpt"))
    cmd = [sys.executable, "-m", "dynamo_tpu_torch", "profile-sla", "--out", out,
           "--model-path", ckpt, "--isl", "16,64", "--batch", "1,2", "--osl", "32",
           "--ttft-slo-ms", "100000", "--itl-slo-ms", "100000"]
    if out == "torch":
        cmd += ["--device", "cpu", "--max-seq-len", "256", "--num-pages", "64"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=180,
                          env={**os.environ, "DYN_LOG": "warning"})
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    assert set(doc) == {"profile", "recommendation"}
    table = doc["profile"]
    assert sorted(table["ttft_ms"]) == ["16", "64"]
    assert sorted(table["itl_ms"]) == sorted(table["tok_s"]) == ["1", "2"]
    check_recommended(doc["recommendation"], table, 100000.0, 100000.0)
    assert doc["recommendation"]["max_batch_within_itl_slo"] == 2


def test_fleet_plan_shows_the_planners_last_decision(run):
    """A planner wired to the observatory's ``note_adjustment`` fills
    ``summary()["plan"]``, and the ``fleet --plan`` table renders it."""
    from dynamo_tpu_torch.cli import format_fleet_table
    from dynamo_tpu_torch.fleet import FleetObservatory
    from dynamo_tpu_torch.planner import LocalConnector, Planner, PlannerConfig
    from dynamo_tpu_torch.protocols.common import ForwardPassMetrics

    obs = FleetObservatory(rtm.MetricsRegistry())
    assert "plan:  (no planner adjustments yet)" in format_fleet_table(
        obs.summary(), show_plan=True)

    async def handle():
        return object()

    async def body():
        conn = LocalConnector({"decode": handle})
        await conn.add_worker("decode")
        planner = Planner(
            conn,
            lambda: {1: ForwardPassMetrics(kv_total_blocks=100, gpu_cache_usage_perc=0.95)},
            cfg=PlannerConfig(max_decode_workers=2),
            on_adjustment=lambda adj: obs.note_adjustment(
                adj.kind, adj.action, adj.reason, adj.count_before),
        )
        try:
            await asyncio.wait_for(planner.step(), WAIT_S)
        finally:
            await asyncio.wait_for(planner.stop(), WAIT_S)
        return conn.worker_count("decode")

    try:
        assert run(body()) == 2
        plan = obs.summary()["plan"]
        assert plan["decode"]["action"] == "up"
        assert plan["decode"]["count_before"] == 1
        text = format_fleet_table(obs.summary(), show_plan=True)
        assert "plan:  decode: up from 1 -- avg kv load 0.95 (0s ago)" in text
    finally:
        reg = rtm.default_registry()
        for name in ("dynamo_planner_adjustments", "dynamo_planner_pool_size"):
            fam = reg._families.get(name)
            if fam is not None:
                for key in list(fam._children):
                    fam.remove(*key)
