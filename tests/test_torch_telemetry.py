"""The port's worker telemetry against the JAX package's.

* ``TelemetrySnapshot``'s wire bytes: the port encodes what the JAX codec
  decodes and re-encodes byte for byte, and the other way round.
* ``snapshot_from_registry`` reads the port's package-free registry as the
  JAX one reads its own: the same observations give the same snapshot.
* ``TransferLog`` rejects garbage samples, as in the JAX fleet tests.
* The JAX package's ``FleetObservatory``, fed a port mocker's snapshots
  over the JSON wire, fits the mocker's synthetic link within 20%.
* The link samples the port's delivery paths now record land in the next
  snapshot: ``RemoteTier``'s puts and fetches (to and from the G4 store),
  and a ``PrefillWorker``'s wire delivery to its decode worker, each with
  the bytes moved and a time no longer than the step's wall.
* ``run in=dyn out=mocker`` publishes its snapshots on the hub: a JAX
  decoder reads its worker id and role.

The process-wide transfer log is drained before each case that reads it,
the default registry's labels are restored after the CLI case, and every
wait is bounded.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import random
import time

import pytest
import torch

from dynamo_tpu.fleet import FleetObservatory
from dynamo_tpu.runtime import metrics as jax_metrics
from dynamo_tpu.runtime import telemetry as jax_telemetry
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.model import init_params
from dynamo_tpu_torch import offload as toff
from dynamo_tpu_torch.llm import disagg as tdis
from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime import metrics, telemetry
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.transports.hub import HubServer

WAIT_S = 30
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run


def full_snapshot(mod):
    return mod.TelemetrySnapshot(
        worker_id=7, role="prefill", seq=42, ts=1234.5, started_ts=1000.25,
        tokens_generated=999.0, step_count=50.0, step_seconds=1.5,
        prefix_hit_tokens=30.0, prefix_lookup_tokens=60.0, kv_pages_used=12,
        kv_pages_total=256, kv_utilization=0.046875, queue_depth=3, batch_occupancy=4,
        batch_slots=8, slo={"ttft": 0.875, "e2e": 1.0}, slo_violations={"ttft/queue": 2.0},
        transfers=[{"src": 1, "dst": 7, "bytes": 4096, "seconds": 0.001}],
        extra={"note": "x"},
    )


def test_snapshot_bytes_cross_both_ways():
    port, jax = full_snapshot(telemetry), full_snapshot(jax_telemetry)
    assert port.encode() == jax.encode()
    assert jax_telemetry.TelemetrySnapshot.decode(port.encode()).encode() == port.encode()
    assert telemetry.TelemetrySnapshot.decode(jax.encode()).encode() == jax.encode()
    assert telemetry.TelemetrySnapshot.decode(port.encode()) == port
    # an older publisher's sparse dict decodes to the same defaults
    sparse = {"worker_id": 3}
    assert (telemetry.TelemetrySnapshot.from_dict(sparse).encode()
            == jax_telemetry.TelemetrySnapshot.from_dict(sparse).encode())
    assert telemetry.TELEMETRY_TOPIC == jax_telemetry.TELEMETRY_TOPIC
    assert telemetry.SCHEMA == jax_telemetry.SCHEMA


def _observe(m) -> None:
    m.observe_sched(waiting=3, active=5)
    m.observe_kv(used=12, total=48)
    for kind, s in (("decode_block", 0.004), ("unified", 0.02), ("decode_block", 0.3)):
        m.observe_step(kind, s)
    m.tokens.inc(17)
    m.prefix_hits.inc(8)
    m.prefix_lookups.inc(32)


def test_snapshot_from_registry_reads_like_jax():
    treg, jreg = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    _observe(metrics.EngineMetrics(treg, max_slots=8))
    _observe(jax_metrics.EngineMetrics(jreg, max_slots=8))
    kw = dict(worker_id=9, role="decode", seq=4, started_ts=5.0,
              transfer_log=telemetry.TransferLog(), refresh_slo=False)
    got = telemetry.snapshot_from_registry(treg, **kw).to_dict()
    want = jax_telemetry.snapshot_from_registry(
        jreg, **kw | {"transfer_log": jax_telemetry.TransferLog()}).to_dict()
    got.pop("ts"), want.pop("ts")
    assert got == want
    assert got["step_count"] == 3.0 and got["kv_pages_used"] == 12
    for name, labels in (("dynamo_engine_tokens_generated", None),
                         ("dynamo_engine_kv_utilization", None),
                         ("dynamo_engine_step_latency_seconds", {"kind": "unified"}),
                         ("dynamo_engine_step_latency_seconds", None),
                         ("dynamo_engine_nope", None)):
        assert treg.sample(name, labels) == jreg.sample(name, labels), name


def test_transfer_log_rejects_garbage():
    log = telemetry.TransferLog()
    log.note(1, 2, 0, 0.5)  # zero bytes
    log.note(1, 2, -5, 0.5)  # negative bytes
    log.note(1, 2, 100, -0.1)  # negative time
    assert len(log) == 0
    log.note(1, 2, 100, 0.0)  # zero seconds is a valid (fast) sample
    assert len(log) == 1
    assert log.drain() == [{"src": 1, "dst": 2, "bytes": 100, "seconds": 0.0}]
    assert len(log) == 0


def req(tokens, max_tokens=4) -> PreprocessedRequest:
    return PreprocessedRequest.from_dict({
        "token_ids": list(tokens), "stop_conditions": {"max_tokens": max_tokens},
        "sampling_options": {"temperature": 0.0}, "eos_token_ids": [],
    })


async def drain_stream(stream) -> list:
    async def body():
        tokens = []
        async for item in stream:
            assert not item.is_error(), item.error_message()
            tokens += (item.data or {}).get("token_ids") or []
        return tokens

    return await asyncio.wait_for(body(), WAIT_S)


def test_jax_observatory_fits_the_port_mockers_link_within_20pct():
    """The JAX fleet tests' acceptance, on a port mocker: its snapshots
    cross the JSON wire into the JAX ``FleetObservatory``, whose learned
    link model predicts within 20% of the configured bandwidth."""
    bw, setup = 50e6, 0.001
    engine = MockerEngine(
        MockerConfig(block_size=4, worker_id=5, role="decode", link_src=1,
                     link_bandwidth_bytes_per_s=bw, link_setup_s=setup,
                     link_jitter_frac=0.05, kv_bytes_per_token=4096),
        registry=metrics.MetricsRegistry(),
    )
    obs = FleetObservatory(jax_metrics.MetricsRegistry())
    wire = []
    pub = engine.telemetry_publisher(sink=lambda d: wire.append(json.dumps(d)))

    async def drive():
        rng = random.Random(1)
        try:
            for i in range(12):
                toks = [i * 300 + j for j in range(rng.randint(20, 200))]
                await drain_stream(await engine.generate(Context.new(req(toks))))
                await pub.publish_once()
        finally:
            await engine.stop()

    asyncio.run(asyncio.wait_for(drive(), RUN_S))
    for blob in wire:
        obs.ingest(jax_telemetry.TelemetrySnapshot.decode(blob.encode()))
    pred = obs.predict_transfer_ms(1_000_000, 1, 5)
    truth = (setup + 1_000_000 / bw) * 1000.0
    assert pred is not None and abs(pred - truth) / truth < 0.2
    rows = obs.link_table()
    assert rows and rows[0]["src"] == 1 and rows[0]["dst"] == 5 and rows[0]["samples"] > 0
    last = json.loads(wire[-1])
    assert last["worker_id"] == 5 and last["role"] == "decode" and last["tokens_generated"] == 48


def test_remote_tier_records_its_link_samples():
    """A G4 put is a sample worker -> store, a fetch store -> worker, each
    with the frame's bytes, in the next snapshot."""
    telemetry.transfers.drain()
    tier = toff.RemoteTier(toff.InMemoryBlobStore(), worker_id=3, namespace="t",
                           registry=metrics.MetricsRegistry())
    blob = torch.randn(2, 2, 1, 4, 2, 8).numpy()
    try:
        t0 = time.perf_counter()
        assert tier.submit_put(42, blob, toff.BlockMeta(block_hash=9)).result(WAIT_S)
        assert tier.fetch_blocking(42) is not None
        wall = time.perf_counter() - t0
        frame = tier._known[42]
    finally:
        tier.close()
    snap = telemetry.snapshot_from_registry(
        metrics.MetricsRegistry(), worker_id=3, role="worker", refresh_slo=False)
    got = [(t["src"], t["dst"], t["bytes"]) for t in snap.transfers]
    assert got == [(3, toff.G4_STORE_ID, frame), (toff.G4_STORE_ID, 3, frame)]
    assert all(0 <= t["seconds"] <= wall for t in snap.transfers)
    assert frame > blob.nbytes


def test_prefill_worker_records_its_wire_delivery():
    """A ``PrefillWorker``'s wire delivery to a decode worker is a sample
    prefill lease -> decode instance, with the delivery's bytes and time."""
    cfg = ModelConfig.tiny()
    params = init_params(cfg, 0, torch.device("cpu"), torch.float32)
    ecfg = dict(max_batch_size=4, max_seq_len=64, page_size=4, num_pages=64)

    def engine():
        return TorchEngine(cfg, params, EngineConfig(**ecfg), device="cpu",
                           metrics_registry=metrics.MetricsRegistry())

    async def body():
        telemetry.transfers.drain()
        hub = HubServer()
        host, port = await hub.start()
        addr = f"{host}:{port}"
        drt = await DistributedRuntime.detached(addr)
        prt = await DistributedRuntime.detached(addr)
        dec_engine, pre_engine = engine(), engine()
        pw = None
        try:
            ns = drt.namespace("disagg")
            disagg = tdis.DisaggDecodeEngine(
                dec_engine, ns, "decode", instance_id=drt.primary_lease,
                cfg=tdis.DisaggConfig(max_local_prefill_length=8), block_size=4)
            await ns.component("decode").endpoint(tdis.KV_DELIVER_ENDPOINT).serve_raw(
                disagg.kv_deliver_handler())
            pw = tdis.PrefillWorker(pre_engine, prt.namespace("disagg"), allow_local=False)
            await pw.start()
            t0 = time.perf_counter()
            tokens = await drain_stream(await disagg.generate(
                Context.new(req([7, 3, 7, 3, 5, 5, 9, 1, 2, 8, 4, 6], 6))))
            wall = time.perf_counter() - t0
            assert len(tokens) == 6 and disagg.remote_prefills == 1
            rows = [r for r in pw.delivery_stats if r["path"] == "wire"]
            snap = telemetry.snapshot_from_registry(
                metrics.MetricsRegistry(), worker_id=prt.primary_lease, role="prefill",
                refresh_slo=False)
            return rows, snap, wall, prt.primary_lease, drt.primary_lease
        finally:
            if pw is not None:
                await pw.stop()
            for e in (dec_engine, pre_engine):
                await e.stop()
            for rt in (prt, drt):
                await rt.shutdown()
            await hub.stop()

    rows, snap, wall, src, dst = asyncio.run(asyncio.wait_for(body(), RUN_S))
    assert len(rows) == 1
    (t,) = snap.transfers
    assert (t["src"], t["dst"], t["bytes"]) == (src, dst, rows[0]["bytes"])
    assert t["seconds"] == round(rows[0]["deliver_ms"] / 1e3, 9)
    assert 0 < t["seconds"] <= wall


def test_mocker_worker_publishes_telemetry_on_the_hub(monkeypatch):
    """``run in=dyn out=mocker`` (no model card) stamps its identity and
    publishes snapshots on ``{ns}.events.fleet_telemetry`` that the JAX
    codec decodes; the publisher stops with the worker."""
    from dynamo_tpu_torch import cli

    monkeypatch.setenv("DYN_LOG", "warning")

    async def body():
        hub = HubServer()
        host, port = await hub.start()
        addr = f"{host}:{port}"
        rt = await DistributedRuntime.detached(addr)
        sub = await rt.namespace("dynamo").subscribe(telemetry.TELEMETRY_TOPIC)
        args = cli.build_parser().parse_args(["run", "in=dyn", "out=mocker", "--hub", addr])
        args.inp, args.out = cli._parse_io(args.io)
        cli._check_served(args)
        task = asyncio.ensure_future(cli.run_worker(args))
        try:
            generate = await rt.namespace("dynamo").component("backend").endpoint(
                "generate").client()
            await asyncio.wait_for(generate.wait_for_instances(), WAIT_S)
            (lease,) = generate.instance_ids()
            _, payload = await asyncio.wait_for(sub.next(), WAIT_S)
            return lease, payload, metrics.worker_identity()
        finally:
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task
            await rt.shutdown()
            await hub.stop()

    identity = metrics.worker_identity()
    try:
        lease, payload, stamped = asyncio.run(asyncio.wait_for(body(), RUN_S))
    finally:
        metrics.default_registry().set_default_labels(**identity)
    blob = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    snap = jax_telemetry.TelemetrySnapshot.decode(blob)
    assert snap.worker_id == lease and snap.role == "worker" and snap.seq >= 1
    assert stamped == {"worker_id": str(lease), "role": "worker"}
