"""The port's fleet observatory against the JAX package's.

The same seeded snapshots (numpy) go into the JAX ``FleetObservatory``
and the port's, each on a private registry, with ``time.time`` pinned to
one clock so ages and ``_created`` stamps agree.  Then the summary, the
link table, the transfer predictions (relative 1e-9), the stragglers,
the quarantine ledger, the scale-down victims, the planner's plan record
and the ``dynamo_fleet_*`` exposition (the JAX one through
``prometheus_client``, the port's through its own registry, byte for
byte) must be equal -- over a straggling fleet and its recovery, a
worker restart, a worker leaving, and the zeroing of gauge rows whose
label vanished.  On port mockers: the link fit converges within 20% of
the mocker's synthetic link, and a slowed mocker is flagged.  The port's
``HttpService`` serves ``/fleet`` and ``/fleet/metrics`` with an
observatory, 503 without one.
"""

from __future__ import annotations

import asyncio
import random
import time

import numpy as np
import pytest

from dynamo_tpu.fleet import FleetObservatory as JaxObservatory
from dynamo_tpu.runtime import metrics as jax_rtm
from dynamo_tpu.runtime import profiling as jax_profiling
from dynamo_tpu.runtime.telemetry import TelemetrySnapshot as JaxSnapshot
from dynamo_tpu_torch.fleet import FleetObservatory, LinkModel, SeriesRing
from dynamo_tpu_torch.http.service import HttpService, ModelManager
from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine
from dynamo_tpu_torch.runtime import metrics as rtm
from dynamo_tpu_torch.runtime import profiling
from dynamo_tpu_torch.runtime.telemetry import TelemetrySnapshot
from tests.test_serving import http_request

T0 = 1_790_000_000.0
WAIT_S = 30.0
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run


@pytest.fixture
def clock(monkeypatch):
    """``time.time`` pinned to a settable value for both packages (and
    ``prometheus_client``, which reads the same attribute)."""
    now = [T0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    return now


@pytest.fixture
def flightrec():
    for rec in (profiling.flight_recorder, jax_profiling.flight_recorder):
        rec.clear()
    yield profiling.flight_recorder
    for rec in (profiling.flight_recorder, jax_profiling.flight_recorder):
        rec.clear()


class Pair:
    """The JAX and the port observatory, fed the same snapshot dicts."""

    def __init__(self, **kw) -> None:
        self.jax = JaxObservatory(jax_rtm.MetricsRegistry(), **kw)
        self.port = FleetObservatory(rtm.MetricsRegistry(), **kw)

    def ingest(self, snap: dict) -> None:
        # the port's wire form is the JAX package's
        assert JaxSnapshot.from_dict(snap).to_dict() == snap
        self.jax.ingest(snap)
        self.port.ingest(snap)

    def expire(self, now: float):
        gone = self.jax.expire_stale(now=now)
        assert self.port.expire_stale(now=now) == gone
        return gone

    def check(self, probes=()) -> dict:
        """Every read surface equal; returns the port's summary."""
        doc = self.port.summary()
        assert doc == self.jax.summary()
        assert self.port.link_table() == self.jax.link_table()
        assert self.port.stragglers == self.jax.stragglers
        assert self.port.quarantined == self.jax.quarantined
        assert self.port.worker_count == self.jax.worker_count
        for nbytes, src, dst in probes:
            want = self.jax.predict_transfer_ms(nbytes, src, dst)
            got = self.port.predict_transfer_ms(nbytes, src, dst)
            assert (got is None) == (want is None)
            if want is not None:
                assert got == pytest.approx(want, rel=1e-9)
        for wid in [w["worker_id"] for w in doc["workers"]]:
            assert self.port.worker_series(wid) == self.jax.worker_series(wid)
        assert set(self.port.forward_pass_metrics()) == set(
            self.jax.forward_pass_metrics()
        )
        for wid, fpm in self.port.forward_pass_metrics().items():
            assert vars(fpm) == vars(self.jax.forward_pass_metrics()[wid])
        body, ctype = self.port.render()
        jbody, jctype = self.jax.render()
        assert body == jbody
        assert ctype == jctype
        return doc


def snap(wid, seq, ts, *, started=T0 - 100.0, role="decode", **kw) -> dict:
    kw.setdefault("kv_pages_used", 10)
    kw.setdefault("kv_pages_total", 100)
    kw.setdefault("kv_utilization", 0.1)
    kw.setdefault("batch_slots", 8)
    return TelemetrySnapshot(
        worker_id=wid, role=role, seq=seq, ts=ts, started_ts=started, **kw
    ).to_dict()


def fleet_rounds(pair, step_s, rounds, *, seq0=1, t=T0, rng=None, links=()):
    """``rounds`` snapshot rounds of workers ``step_s`` (id -> seconds per
    step), each with seeded load and, for ``links`` ((src, dst, bytes/s,
    setup s)), one transfer of a seeded size."""
    rng = rng or np.random.default_rng(0)
    for i in range(rounds):
        seq = seq0 + i
        for wid, step in step_s.items():
            transfers = []
            for src, dst, bw, setup in links:
                if dst == wid:
                    n = int(rng.integers(1 << 16, 1 << 24))
                    transfers.append({"src": src, "dst": dst, "bytes": n,
                                      "seconds": setup + n / bw * float(rng.uniform(0.95, 1.05))})
            pair.ingest(snap(
                wid, seq, t + seq,
                tokens_generated=float(40 * seq + int(rng.integers(0, 9))),
                step_count=10.0 * seq,
                step_seconds=step * 10.0 * seq,
                kv_pages_used=int(rng.integers(0, 100)),
                kv_utilization=float(rng.uniform(0, 1)),
                queue_depth=int(rng.integers(0, 5)),
                batch_occupancy=int(rng.integers(0, 8)),
                slo={"ttft": float(rng.uniform(0.8, 1.0))},
                transfers=transfers,
            ))


def test_series_ring_and_link_model_match_jax():
    from dynamo_tpu.fleet import LinkModel as JaxLink, SeriesRing as JaxRing

    rng = np.random.default_rng(3)
    rings = (SeriesRing(raw_capacity=10, coarse_capacity=4, bucket=3),
             JaxRing(raw_capacity=10, coarse_capacity=4, bucket=3))
    links = (LinkModel(0.9), JaxLink(0.9))
    for i in range(60):
        v = float(rng.normal())
        n = int(rng.integers(1, 1 << 22))
        for r in rings:
            r.append(float(i), v)
        for m in links:
            m.observe(n, 1e-3 + n / 5e8)
        assert rings[0].points() == rings[1].points()
        assert rings[0].carry_average() == rings[1].carry_average()
        assert links[0].predict_s(1 << 20) == pytest.approx(links[1].predict_s(1 << 20), rel=1e-9)
    assert links[0].bandwidth_bytes_per_s == pytest.approx(5e8, rel=0.01)
    # equal sizes: the through-origin fit
    deg = LinkModel()
    for _ in range(10):
        deg.observe(1_000_000, 0.01)
    assert deg.predict_s(2_000_000) == pytest.approx(0.02, rel=0.01)


@pytest.mark.parametrize("slow", [None, 3])
def test_straggler_quarantine_and_recovery_match_jax(clock, flightrec, slow):
    """A fleet of four with one slow worker (or none): stragglers, the
    quarantine, its lifting after the recovery windows, and the flight
    recorder's snapshots, equal on both observatories at every round."""
    pair = Pair(quarantine_recovery_windows=3)
    rng = np.random.default_rng(11)
    links = [(1, 2, 2e8, 0.002), (2, 4, 5e7, 0.0)]
    probes = [(1 << 20, 1, 2), (12345, 2, 4), (1 << 20, 4, 1)]
    steps = {w: 0.001 * (20 if w == slow else 1) for w in (1, 2, 3, 4)}
    for r in range(6):
        fleet_rounds(pair, steps, 1, seq0=r + 1, rng=rng, links=links)
        clock[0] = T0 + r + 1
        pair.check(probes)
    doc = pair.check(probes)
    assert doc["stragglers"] == doc["quarantined"] == ([slow] if slow else [])
    trips = [s for s in flightrec.list() if s["reason"] == "straggler_detected"]
    assert len(trips) == (1 if slow else 0)
    if slow:
        assert flightrec.get(trips[0]["id"])["extra"]["worker_id"] == slow
        assert pair.port.quarantine_source()() == [slow]
        assert b"dynamo_fleet_quarantined 1.0" in pair.port.render()[0]
    # the slow worker heals: the quarantine lifts after 3 clean windows
    healed = {w: 0.001 for w in (1, 2, 3, 4)}
    for r in range(6, 30):
        fleet_rounds(pair, healed, 1, seq0=r + 1, rng=rng, links=links)
        clock[0] = T0 + r + 1
        pair.check(probes)
    assert pair.port.quarantined == []
    if slow:
        assert [s for s in flightrec.list() if s["reason"] == "straggler_recovered"]


def test_restart_resets_rings_and_links_as_jax(clock):
    pair = Pair()
    for i in range(1, 6):
        pair.ingest(snap(
            2, i, T0 + i, tokens_generated=100.0 * i, step_count=10.0 * i,
            step_seconds=0.01 * i,
            transfers=[{"src": 1, "dst": 2, "bytes": 1 << 20, "seconds": 0.02}],
        ))
    clock[0] = T0 + 6
    pair.check([(1 << 20, 1, 2)])
    assert pair.port.predict_transfer_ms(1 << 20, 1, 2) is not None
    # a new incarnation: rings and its link edges drop
    pair.ingest(snap(2, 1, T0 + 10, started=T0 + 9, tokens_generated=5.0))
    clock[0] = T0 + 10
    pair.check([(1 << 20, 1, 2)])
    series = pair.port.worker_series(2)
    assert series["restarts"] == 1 and series["tokens_per_s"] == []
    assert pair.port.predict_transfer_ms(1 << 20, 1, 2) is None
    pair.ingest(snap(2, 2, T0 + 11, started=T0 + 9, tokens_generated=15.0))
    clock[0] = T0 + 11
    pair.check()
    assert pair.port.worker_series(2)["tokens_per_s"][-1][1] == pytest.approx(10.0)


def test_leave_expiry_and_gauge_zeroing_as_jax(clock):
    pair = Pair(stale_after_s=5.0)
    pair.ingest(snap(1, 1, T0, role="prefill", slo={"itl": 0.5}))
    pair.ingest(snap(2, 1, T0 + 4,
                     transfers=[{"src": 1, "dst": 2, "bytes": 4096, "seconds": 0.01}]))
    clock[0] = T0 + 4
    doc = pair.check([(4096, 1, 2)])
    assert doc["totals"]["workers_by_role"] == {"prefill": 1, "decode": 1}
    body = pair.port.render()[0].decode()
    assert 'dynamo_fleet_workers{role="prefill"} 1.0' in body
    assert pair.expire(T0 + 7) == [1]
    assert pair.port.predict_transfer_ms(4096, 1, 2) is None
    clock[0] = T0 + 7
    pair.check([(4096, 1, 2)])
    body = pair.port.render()[0].decode()
    # the vanished role's and link's rows read 0, not their last value
    assert 'dynamo_fleet_workers{role="prefill"} 0.0' in body
    assert 'dynamo_fleet_tokens_per_s{role="prefill"} 0.0' in body
    assert 'dynamo_fleet_link_bandwidth_bytes_per_s{dst="2",src="1"} 0.0' in body
    assert pair.expire(T0 + 100) == [2]
    clock[0] = T0 + 100
    assert pair.check()["workers"] == []


def test_victims_and_plan_record_as_jax(clock):
    class H:
        def __init__(self, wid):
            self.worker_id = wid

    pair = Pair()
    for wid, occ in ((1, 6), (2, 1), (3, 4), (4, 5), (5, 5)):
        for i in (1, 2):
            pair.ingest(snap(wid, i, T0 + i, batch_occupancy=occ, queue_depth=0,
                             step_count=10.0 * i, step_seconds=(0.05 if wid == 2 else 0.001) * 10 * i))
    clock[0] = T0 + 2
    pair.check()
    assert pair.port.quarantined == [2]
    handles = [H(w) for w in (1, 2, 3, 9)]
    for hs in (handles[:3], handles, handles[1:3], [handles[1]], []):
        want = pair.jax.victim_source()("decode", hs)
        assert pair.port.victim_source()("decode", hs) is want
    pair.jax.note_adjustment("decode", "up", "itl attainment 0.71 < floor", 3, ts=T0)
    pair.port.note_adjustment("decode", "up", "itl attainment 0.71 < floor", 3, ts=T0)
    # an off-process planner's record rides a snapshot's extra
    pair.ingest(snap(1, 3, T0 + 3, extra={"plan": {"prefill": {
        "kind": "prefill", "action": "down", "reason": "queue/worker 0.0",
        "count_before": 2, "ts": T0 + 1}}}))
    clock[0] = T0 + 3
    plan = pair.check()["plan"]
    assert plan["decode"]["action"] == "up" and plan["prefill"]["count_before"] == 2


def test_mocker_link_converges_within_20pct():
    """Port mockers' synthetic link: the fit lands within 20% of the
    configured link, and the JAX observatory fed the same snapshots
    predicts the same."""
    bw, setup = 50e6, 0.001
    engine = MockerEngine(
        MockerConfig(block_size=4, worker_id=5, role="decode", link_src=1,
                     link_bandwidth_bytes_per_s=bw, link_setup_s=setup,
                     link_jitter_frac=0.05, kv_bytes_per_token=4096),
        registry=rtm.MetricsRegistry(),
    )
    pair = Pair()
    pub = engine.telemetry_publisher(sink=pair.ingest)

    async def drive():
        from tests.test_torch_mocker import PKGS, collect, req

        pkg = PKGS["torch"]

        rng = random.Random(1)
        try:
            for i in range(12):
                toks = [i * 300 + j for j in range(rng.randint(20, 200))]
                await asyncio.wait_for(
                    collect(pkg, engine, req(pkg, toks, max_tokens=4)), WAIT_S
                )
                await pub.publish_once()
        finally:
            await asyncio.wait_for(engine.stop(), WAIT_S)

    asyncio.run(asyncio.wait_for(drive(), RUN_S))
    truth = (setup + 1_000_000 / bw) * 1000.0
    pred = pair.port.predict_transfer_ms(1_000_000, 1, 5)
    assert pred is not None and abs(pred - truth) / truth < 0.2
    assert pred == pytest.approx(pair.jax.predict_transfer_ms(1_000_000, 1, 5), rel=1e-9)
    rows = pair.port.link_table()
    assert rows[0]["src"] == 1 and rows[0]["dst"] == 5 and rows[0]["samples"] > 0


def test_straggler_in_slowed_mocker_fleet(flightrec):
    """Four port mockers, one slowed: the port's observatory flags and
    quarantines it, as the JAX one does on the same snapshots."""
    pair = Pair()
    engines, pubs = [], []
    for wid in range(4):
        eng = MockerEngine(
            MockerConfig(block_size=4, worker_id=wid,
                         decode_s_per_step=0.02 if wid == 3 else 0.0005),
            registry=rtm.MetricsRegistry(),
        )
        engines.append(eng)
        pubs.append(eng.telemetry_publisher(sink=pair.ingest))

    async def drive():
        from tests.test_torch_mocker import PKGS, collect, req

        pkg = PKGS["torch"]

        try:
            for _ in range(3):
                await asyncio.wait_for(asyncio.gather(*[
                    collect(pkg, eng, req(pkg, [1, 2, 3], max_tokens=6))
                    for eng in engines
                ]), WAIT_S)
                for pub in pubs:
                    await pub.publish_once()
        finally:
            for eng in engines:
                await asyncio.wait_for(eng.stop(), WAIT_S)

    asyncio.run(asyncio.wait_for(drive(), RUN_S))
    assert pair.port.stragglers == pair.jax.stragglers == [3]
    assert pair.port.quarantined == [3]
    assert [s for s in flightrec.list() if s["reason"] == "straggler_detected"]


def test_fleet_http_routes(clock):
    pair = Pair()
    pair.ingest(snap(1, 1, T0, role="prefill"))
    pair.ingest(snap(2, 1, T0,
                     transfers=[{"src": 1, "dst": 2, "bytes": 4096, "seconds": 0.01}]))

    async def go():
        svc = HttpService(ModelManager(), observatory=pair.port)
        await svc.start()
        try:
            host, port = svc.address
            status, _h, doc = await asyncio.wait_for(
                http_request(host, port, "GET", "/fleet"), WAIT_S)
            assert status == 200
            assert doc == pair.jax.summary()
            assert doc["totals"]["workers_by_role"] == {"prefill": 1, "decode": 1}
            status, headers, body = await asyncio.wait_for(http_request(
                host, port, "GET", "/fleet/metrics", raw_response=True), WAIT_S)
            assert status == 200
            assert body == pair.jax.render()[0]
            assert b"dynamo_fleet_workers" in body and b"dynamo_engine_" not in body
        finally:
            await svc.stop()
        bare = HttpService(ModelManager())
        await bare.start()
        try:
            host, port = bare.address
            for path in ("/fleet", "/fleet/metrics"):
                status, _h, _p = await asyncio.wait_for(http_request(
                    host, port, "GET", path, raw_response=True), WAIT_S)
                assert status == 503
        finally:
            await bare.stop()

    asyncio.run(asyncio.wait_for(go(), RUN_S))


def test_registry_render_prefix_matches_prometheus_client(clock):
    """``render_prefix``: only the named families, no identity labels,
    the bytes ``prometheus_client`` renders for the filtered view."""
    from prometheus_client import generate_latest

    from dynamo_tpu.fleet.observatory import _FamilyFilterView

    texts = []
    for reg in (jax_rtm.MetricsRegistry(), rtm.MetricsRegistry()):
        reg.counter("x_a", "a", ["k"]).labels("v").inc(3)
        reg.gauge("y_b", "b").set(2.5)
        reg.histogram("x_c", "c", buckets=(0.1, 1.0)).observe(0.5)
        reg.set_default_labels(worker_id=7, role="decode")
        if isinstance(reg, rtm.MetricsRegistry):
            texts.append(reg.render_prefix("x_")[0])
        else:
            texts.append(generate_latest(_FamilyFilterView(reg.registry, "x_")))
    assert texts[1] == texts[0]
    assert b"y_b" not in texts[1] and b"worker_id" not in texts[1]
