"""The port's planner against the JAX package's.

Every case of ``tests/test_planner.py`` runs on the port.  Where a case
feeds metrics, the same ``ForwardPassMetrics`` sequence goes to the JAX
``Planner`` and to the port's, each over its own ``LocalConnector`` (or
its own fake ``kubectl``), and after every round the two hold the same
``(kind, action, reason, count_before, evidence)`` list, the same pool
counts, the same JSONL log lines (``ts`` aside) and the same fake cluster
state.  A live case (the mocker load ramp) records what the port's planner
read each round and replays it into the JAX planner.  Then: a seeded
differential over 40 rounds of random load, queue depth, attainment,
violation counts and quarantine; the registry and fleet metrics sources
deciding alike in both packages; and a prefill pool scaled on the port's
hub ``queue_depth``.

Every round is bounded by ``asyncio.wait_for`` and every planner stopped
in a ``finally``; the planner's ``dynamo_planner_*`` rows on the port's
default registry are cleared after each test.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import stat
import time
from types import SimpleNamespace

import numpy as np
import pytest

from dynamo_tpu.fleet import FleetObservatory as JaxObservatory
from dynamo_tpu.planner import connector as jax_connector
from dynamo_tpu.planner import planner as jax_planner
from dynamo_tpu.protocols.common import ForwardPassMetrics as JaxFPM
from dynamo_tpu.runtime import metrics as jax_rtm
from dynamo_tpu.runtime import slo as jax_slo
from dynamo_tpu.runtime.telemetry import TelemetryPublisher as JaxPublisher
from dynamo_tpu_torch.fleet import FleetObservatory
from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine
from dynamo_tpu_torch.planner import (
    DECODE,
    PREFILL,
    KubernetesConnector,
    LocalConnector,
    Planner,
    PlannerConfig,
)
from dynamo_tpu_torch.planner import planner as port_planner
from dynamo_tpu_torch.protocols.common import (
    ForwardPassMetrics,
    PreprocessedRequest,
    StopConditions,
)
from dynamo_tpu_torch.runtime import metrics as rtm
from dynamo_tpu_torch.runtime import slo
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.telemetry import TelemetryPublisher, TelemetrySnapshot

WAIT_S = 30.0

PACKAGES = {
    "jax": SimpleNamespace(
        Planner=jax_planner.Planner, PlannerConfig=jax_planner.PlannerConfig,
        LocalConnector=jax_connector.LocalConnector,
        KubernetesConnector=jax_connector.KubernetesConnector, FPM=JaxFPM,
        Observatory=JaxObservatory, Registry=jax_rtm.MetricsRegistry,
        Publisher=JaxPublisher, registry_source=jax_planner.registry_metrics_source,
        fleet_source=jax_planner.fleet_metrics_source,
    ),
    "port": SimpleNamespace(
        Planner=Planner, PlannerConfig=PlannerConfig, LocalConnector=LocalConnector,
        KubernetesConnector=KubernetesConnector, FPM=ForwardPassMetrics,
        Observatory=FleetObservatory, Registry=rtm.MetricsRegistry,
        Publisher=TelemetryPublisher, registry_source=port_planner.registry_metrics_source,
        fleet_source=port_planner.fleet_metrics_source,
    ),
}

PLANNER_FAMILIES = ("dynamo_planner_adjustments", "dynamo_planner_pool_size")


@pytest.fixture(autouse=True)
def planner_series():
    """The planner mints its families on the port's process-wide
    registry: clear their rows after each test."""
    yield
    reg = rtm.default_registry()
    for name in PLANNER_FAMILIES:
        fam = reg._families.get(name)
        if fam is not None:
            for key in list(fam._children):
                fam.remove(*key)


@pytest.fixture
def slo_trackers():
    for t in (slo.tracker, jax_slo.tracker):
        t.disable()
    yield
    for t in (slo.tracker, jax_slo.tracker):
        t.disable()


def fpm(load, waiting=0):
    """The fields of ``tests/test_planner.py``'s ``fpm``: one worker's
    metrics, as a dict each package makes its ``ForwardPassMetrics`` of."""
    return dict(
        kv_active_blocks=0, kv_total_blocks=100, num_requests_waiting=waiting,
        gpu_cache_usage_perc=load, gpu_prefix_cache_hit_rate=0.0,
        request_active_slots=0, request_total_slots=8,
    )


def slo_fpm(load=0.5, waiting=0, *, itl=1.0, ttft=1.0, qv=0.0, sv=0.0):
    return dict(
        fpm(load, waiting), slo_itl_attainment=itl, slo_ttft_attainment=ttft,
        slo_ttft_queue_violations=qv, slo_ttft_service_violations=sv,
    )


def decisions(planner):
    return [(a.kind, a.action, a.reason, a.count_before, a.evidence)
            for a in planner.adjustments]


async def _handle():
    return object()


async def local_pool(pkg, decode: int, prefill: int):
    """A package's ``LocalConnector`` holding ``decode`` and ``prefill``
    plain handles (the JAX tests' ``FakeConnector`` counts)."""
    conn = pkg.LocalConnector({DECODE: _handle, PREFILL: _handle})
    for kind, n in ((DECODE, decode), (PREFILL, prefill)):
        for _ in range(n):
            await conn.add_worker(kind)
    return conn


class Twin:
    """The JAX planner and the port's, each over its own connector, fed
    the same metrics (``self.metrics``: worker id -> fields), queue depth
    (``self.depth["v"]``) and quarantine list."""

    def __init__(self) -> None:
        self.metrics: dict = {}
        self.depth = {"v": 0}
        self.quarantine: list = []
        self.sides: dict = {}
        self.logs: dict = {}

    @classmethod
    async def create(cls, *, decode=1, prefill=1, metrics=None, queue=False,
                     quarantine=False, log_dir=None, connectors=None, **cfg):
        twin = cls()
        twin.metrics = metrics if metrics is not None else {}
        for name, pkg in PACKAGES.items():
            conn = (connectors[name] if connectors is not None
                    else await local_pool(pkg, decode, prefill))
            log = None
            if log_dir is not None:
                log = twin.logs[name] = os.path.join(str(log_dir), f"{name}.jsonl")

            async def qdepth():
                return twin.depth["v"]

            planner = pkg.Planner(
                conn,
                metrics_source=lambda pkg=pkg: {
                    w: pkg.FPM(**f) for w, f in twin.metrics.items()},
                queue_depth_source=qdepth if queue else None,
                cfg=pkg.PlannerConfig(adjustment_log_path=log, **cfg),
                quarantine_source=(lambda: twin.quarantine) if quarantine else None,
            )
            twin.sides[name] = SimpleNamespace(conn=conn, planner=planner)
        return twin

    @property
    def planner(self):
        return self.sides["port"].planner

    def count(self, kind: str) -> int:
        return self.sides["port"].conn.worker_count(kind)

    async def step(self, rounds: int = 1) -> None:
        for _ in range(rounds):
            for side in self.sides.values():
                await asyncio.wait_for(side.planner.step(), WAIT_S)
            self.check()

    def check(self) -> None:
        jax, port = self.sides["jax"], self.sides["port"]
        assert decisions(port.planner) == decisions(jax.planner)
        for kind in (DECODE, PREFILL):
            assert port.conn.worker_count(kind) == jax.conn.worker_count(kind)
        if self.logs:
            assert self.log_lines("port") == self.log_lines("jax")

    def log_lines(self, name: str) -> list:
        path = self.logs[name]
        if not os.path.exists(path):
            return []
        with open(path) as f:
            lines = [json.loads(line) for line in f.read().splitlines()]
        for rec in lines:
            assert isinstance(rec.pop("ts"), float)
        return lines

    async def stop(self) -> None:
        for side in self.sides.values():
            await asyncio.wait_for(side.planner.stop(), WAIT_S)


async def twin_case(body, **kw):
    twin = await Twin.create(**kw)
    try:
        await body(twin)
        twin.check()
    finally:
        await twin.stop()
    return twin


# -- the load pass: thresholds and grace periods ------------------------------


def test_decode_scale_up_with_grace(run):
    async def body(twin):
        await twin.step()
        assert twin.count(DECODE) == 2  # scaled up
        # grace: two intervals of high load change nothing
        await twin.step(2)
        assert twin.count(DECODE) == 2
        # grace over: scales again
        await twin.step()
        assert twin.count(DECODE) == 3

    run(twin_case(body, metrics={1: fpm(0.95), 2: fpm(0.9)},
                  decode_grace_periods=2, max_decode_workers=4))


def test_decode_scale_down_requires_idle(run):
    async def body(twin):
        await twin.step()
        assert twin.count(DECODE) == 3  # waiting requests block scale-down
        twin.metrics[1] = fpm(0.1, waiting=0)
        await twin.step()
        assert twin.count(DECODE) == 2
        # never below the floor
        twin.metrics[1] = fpm(0.0)
        await twin.step()
        assert twin.count(DECODE) == 1
        await twin.step()
        assert twin.count(DECODE) == 1

    run(twin_case(body, decode=3, metrics={1: fpm(0.1, waiting=2)}))


def test_prefill_scales_on_queue_depth(run):
    async def body(twin):
        twin.depth["v"] = 8
        await twin.step()
        assert twin.count(PREFILL) == 2  # 8 deep / 1 worker > 2.0
        twin.depth["v"] = 0
        await twin.step()
        assert twin.count(PREFILL) == 1  # drains back down
        await twin.step()
        assert twin.count(PREFILL) == 0  # min_prefill_workers=0

    run(twin_case(body, queue=True, prefill_grace_periods=0, max_prefill_workers=3))


def test_no_op_mode_records_without_acting(run):
    async def body(twin):
        await twin.step()
        assert twin.count(DECODE) == 1
        assert [a.action for a in twin.planner.adjustments] == ["up"]

    run(twin_case(body, metrics={1: fpm(0.95)}, no_op=True))


def test_load_ramp_scales_mocker_fleet(run):
    """End-to-end ramp on the port's mocker: flood a live worker until its
    KV load crosses the threshold, watch the planner (on its own timer)
    add a worker, drain, watch it scale back down.  The metrics the port's
    planner read each round, replayed into the JAX planner, give the same
    decisions."""
    seen: list = []

    async def body():
        engines = []

        async def make_decoder():
            eng = MockerEngine(
                MockerConfig(block_size=4, kv_capacity_blocks=96, decode_s_per_step=0.004),
                registry=rtm.MetricsRegistry(),
            )
            await eng.start()
            engines.append(eng)
            return eng

        conn = LocalConnector({DECODE: make_decoder})
        await conn.add_worker(DECODE)  # initial fleet of 1

        def metrics():
            got = {i: e.metrics() for i, e in enumerate(conn.workers[DECODE])}
            seen.append({i: dataclasses.asdict(m) for i, m in got.items()})
            return got

        cfg = dict(kv_load_scale_up=0.5, kv_load_scale_down=0.1,
                   decode_grace_periods=2, max_decode_workers=3)
        planner = Planner(conn, metrics_source=metrics,
                          cfg=PlannerConfig(adjustment_interval_s=0.05, **cfg))
        await planner.start()
        try:
            # flood the single worker: long prompts, long generations
            streams = []
            for i in range(6):
                req = PreprocessedRequest(
                    token_ids=[i + 1] * 32, stop_conditions=StopConditions(max_tokens=64))
                worker = conn.workers[DECODE][0]
                streams.append(await worker.generate(Context.new(req.to_dict())))

            async def drain(s):
                async for _ in s:
                    pass

            drains = [asyncio.create_task(drain(s)) for s in streams]
            # scale-up must happen while the flood is in flight
            for _ in range(60):
                if conn.worker_count(DECODE) >= 2:
                    break
                await asyncio.sleep(0.05)
            assert conn.worker_count(DECODE) >= 2, (
                f"no scale-up; adjustments={planner.adjustments}")
            await asyncio.wait_for(asyncio.gather(*drains), WAIT_S)
            # idle fleet drains back to the floor
            for _ in range(100):
                if conn.worker_count(DECODE) == 1:
                    break
                await asyncio.sleep(0.05)
            assert conn.worker_count(DECODE) == 1
        finally:
            await asyncio.wait_for(planner.stop(), WAIT_S)
            for e in engines:
                await e.stop()
        return decisions(planner), cfg

    port, cfg = run(body())
    assert [a for a in port if a[1] != "hold"][0][:2] == (DECODE, "up")

    async def replay():
        rounds = iter(seen)
        conn = await local_pool(PACKAGES["jax"], 1, 0)
        planner = jax_planner.Planner(
            conn, metrics_source=lambda: {
                w: JaxFPM(**f) for w, f in next(rounds).items()},
            cfg=jax_planner.PlannerConfig(**cfg))
        try:
            for _ in seen:
                await asyncio.wait_for(planner.step(), WAIT_S)
        finally:
            await asyncio.wait_for(planner.stop(), WAIT_S)
        return decisions(planner)

    # the port's last round may have been cut by stop() after its read
    want = run(replay())
    assert port == want[: len(port)] and len(want) - len(port) <= 1


def test_prefill_trend_suppresses_scale_up(run):
    """Reference planner.py:281-291: above threshold with a draining
    trend, the scale-up is suppressed; a rising trend still scales."""

    async def body(twin):
        twin.depth["v"] = 12
        await twin.step()  # first step: no trend yet, scales up
        assert twin.count(PREFILL) == 2
        # ride out the grace window with a draining queue
        for v in (9, 8, 7):
            twin.depth["v"] = v
            await twin.step()
        assert twin.count(PREFILL) == 2  # grace held
        # still above threshold (5/2 = 2.5 > 2.0) but the trend (-2/interval)
        # predicts 5 - 6 < 0 -> <= threshold: hold
        twin.depth["v"] = 5
        await twin.step()
        assert twin.count(PREFILL) == 2
        assert twin.planner.adjustments[-1].action == "hold"
        assert "trend" in twin.planner.adjustments[-1].reason
        # rising queue: trend no longer saves it, scale up
        twin.depth["v"] = 40
        await twin.step()
        assert twin.count(PREFILL) == 3

    run(twin_case(body, queue=True, prefill_grace_periods=3, max_prefill_workers=4))


# -- the Kubernetes connector over a fake kubectl ------------------------------


def _fake_kubectl(tmp_path):
    """A kubectl stand-in: replica state lives in a JSON file; supports the
    two invocations the connector makes (get jsonpath / patch -p)."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    state = tmp_path / "k8s_state.json"
    state.write_text(json.dumps({}))
    script = tmp_path / "kubectl"
    script.write_text(
        "#!/usr/bin/env python3\n"
        "import json, sys\n"
        f"STATE = {str(state)!r}\n"
        "args = sys.argv[1:]\n"
        "state = json.load(open(STATE))\n"
        "verb = args[0]\n"
        "name = args[2]\n"
        "if verb == 'get':\n"
        "    if name not in state:\n"
        "        sys.stderr.write('NotFound')\n"
        "        sys.exit(1)\n"
        "    sys.stdout.write(str(state[name]))\n"
        "elif verb == 'patch':\n"
        "    patch = json.loads(args[args.index('-p') + 1])\n"
        "    state[name] = patch['spec']['replicas']\n"
        "    json.dump(state, open(STATE, 'w'))\n"
        "else:\n"
        "    sys.exit(2)\n"
    )
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    return script, state


def test_kubernetes_connector_scales_rendered_deployment(run, tmp_path):
    """Against the JAX package's rendered graph: the connector's
    deployment names match the manifests', and each package's planner
    drives its own fake cluster's replicas alike."""
    import yaml

    from dynamo_tpu.deploy import DeploymentSpec, render_manifests

    spec = DeploymentSpec(name="graph", model_path="/models/m", prefill_workers=1,
                          decode_workers=2)
    decode = yaml.safe_load(render_manifests(spec)["decode-worker.yaml"])
    seeded = {decode["metadata"]["name"]: decode["spec"]["replicas"], "graph-prefill": 1}
    fakes = {name: _fake_kubectl(tmp_path / name) for name in PACKAGES}
    for _, state in fakes.values():
        state.write_text(json.dumps(seeded))

    def states():
        got = {name: json.loads(state.read_text()) for name, (_, state) in fakes.items()}
        assert got["port"] == got["jax"]
        return got["port"]

    async def body():
        conns = {name: PACKAGES[name].KubernetesConnector("graph", kubectl=str(kubectl))
                 for name, (kubectl, _) in fakes.items()}
        for conn in conns.values():
            await asyncio.wait_for(conn.refresh(), WAIT_S)
        # the connector targets exactly the names deploy.py rendered
        assert conns["port"].deployment(DECODE) == decode["metadata"]["name"]
        assert conns["port"].worker_count(DECODE) == 2

        async def steps(twin):
            await twin.step()  # hot kv load: decode scales up via kubectl
            assert states()["graph-decode"] == 3
            twin.metrics[1] = fpm(0.05, waiting=0)
            await twin.step(2)
            assert states()["graph-decode"] == 1
            await twin.step()  # floor respected
            assert states()["graph-decode"] == 1

        await twin_case(steps, connectors=conns, metrics={1: fpm(0.95)}, queue=True,
                        decode_grace_periods=0, max_decode_workers=4)

    run(body())


def test_kubernetes_connector_missing_deployment_is_loud(run, tmp_path):
    async def body():
        for name, pkg in PACKAGES.items():
            kubectl, _state = _fake_kubectl(tmp_path / name)
            conn = pkg.KubernetesConnector("absent", kubectl=str(kubectl))
            with pytest.raises(RuntimeError, match="NotFound"):
                await asyncio.wait_for(conn.refresh(), WAIT_S)

    run(body())


def test_adjustment_jsonl_sink(run, tmp_path):
    """Every decision appends one JSON line, the same line in both
    packages (``ts`` aside)."""

    async def body(twin):
        await twin.step()  # scale up
        twin.metrics[1] = fpm(0.1)
        await twin.step(2)  # grace hold, scale down

    twin = run(twin_case(body, metrics={1: fpm(0.95)}, log_dir=tmp_path,
                         decode_grace_periods=1))
    lines = twin.log_lines("port")
    assert lines == twin.log_lines("jax")
    assert len(lines) >= 2
    for rec in lines:
        assert {"kind", "action", "reason", "count_before"} <= set(rec)
    actions = [r["action"] for r in lines]
    assert "up" in actions and "down" in actions


# -- the SLO loop ----------------------------------------------------------------


def test_slo_itl_breach_needs_hysteresis_then_scales_decode(run):
    async def body(twin):
        await twin.step()
        assert twin.count(DECODE) == 1  # breach 1/2: hold
        holds = [a for a in twin.planner.adjustments if a.action == "hold"]
        assert holds and holds[-1].evidence["itl_attainment"] == 0.5
        await twin.step()
        assert twin.count(DECODE) == 2  # breach 2/2: actuate
        up = next(a for a in twin.planner.adjustments if a.action == "up")
        assert up.kind == DECODE
        assert up.evidence["cause"] == "service"
        assert up.evidence["itl_attainment"] == 0.5

    run(twin_case(body, metrics={1: slo_fpm(itl=0.5)}, decode_grace_periods=0,
                  slo_breach_rounds=2))


def test_slo_square_wave_never_actuates(run):
    async def body(twin):
        for i in range(8):
            twin.metrics[1] = slo_fpm(itl=0.5 if i % 2 == 0 else 1.0)
            await twin.step()
        assert twin.count(DECODE) == 1
        assert not [a for a in twin.planner.adjustments if a.action != "hold"]

    run(twin_case(body, decode_grace_periods=0, slo_breach_rounds=2))


def test_slo_cooldown_paces_sustained_breach(run):
    async def body(twin):
        await twin.step(6)
        ups = [a for a in twin.planner.adjustments if a.action == "up"]
        assert len(ups) == 2
        assert twin.count(DECODE) == 3

    run(twin_case(body, metrics={1: slo_fpm(itl=0.5)}, decode_grace_periods=0,
                  slo_breach_rounds=2, slo_cooldown_rounds=3, max_decode_workers=8))


def test_slo_pressure_blocks_legacy_scale_down(run):
    async def body(twin):
        await twin.step()
        assert twin.count(DECODE) == 3  # low load, but SLO gate holds
        assert not [a for a in twin.planner.adjustments if a.action == "down"]
        twin.metrics[1] = slo_fpm(load=0.1, itl=1.0)
        await twin.step()
        assert twin.count(DECODE) == 2  # gate lifted: legacy down fires

    run(twin_case(body, decode=3, metrics={1: slo_fpm(load=0.1, itl=0.5)},
                  decode_grace_periods=0))


def test_slo_ttft_queue_cause_scales_prefill(run):
    async def body(twin):
        await twin.step()  # breach 1/2, baseline counters recorded
        assert twin.count(PREFILL) == 1
        twin.metrics[1] = slo_fpm(ttft=0.6, qv=5.0, sv=0.0)
        await twin.step()  # breach 2/2, dq=5 > ds=0 -> queue-caused
        assert twin.count(PREFILL) == 2
        up = next(a for a in twin.planner.adjustments
                  if a.action == "up" and a.kind == PREFILL)
        assert up.evidence["cause"] == "queue"
        assert up.evidence["queue_violations_delta"] == 5.0

    run(twin_case(body, metrics={1: slo_fpm(ttft=0.6)}, prefill_grace_periods=0,
                  slo_breach_rounds=2))


def test_slo_ttft_service_cause_holds_prefill(run):
    async def body(twin):
        await twin.step()
        twin.metrics[1] = slo_fpm(ttft=0.6, qv=0.0, sv=7.0)
        await twin.step()
        assert twin.count(PREFILL) == 1  # no thrash
        hold = next(a for a in twin.planner.adjustments
                    if a.kind == PREFILL and a.evidence is not None)
        assert hold.action == "hold"
        assert hold.evidence["cause"] == "service"

    run(twin_case(body, metrics={1: slo_fpm(ttft=0.6)}, prefill_grace_periods=0,
                  slo_breach_rounds=2))


def test_slo_quarantined_worker_excluded_from_aggregates(run):
    async def body(twin):
        twin.quarantine.append(2)
        await twin.step(2)
        assert twin.count(DECODE) == 2
        assert not [a for a in twin.planner.adjustments if a.action == "up"]

    run(twin_case(body, decode=2, quarantine=True,
                  metrics={1: slo_fpm(itl=1.0), 2: slo_fpm(itl=0.2)},
                  decode_grace_periods=0, slo_breach_rounds=1))


def test_slo_quarantine_mid_window_resets_breach(run):
    async def body(twin):
        await twin.step()  # breach 1/2 building on worker 2
        twin.quarantine.append(2)  # observatory trips mid-window
        await twin.step(2)  # healthy view fully attained: breach resets
        assert twin.count(DECODE) == 2
        assert not [a for a in twin.planner.adjustments if a.action != "hold"]

    run(twin_case(body, decode=2, quarantine=True,
                  metrics={1: slo_fpm(itl=1.0), 2: slo_fpm(itl=0.5)},
                  decode_grace_periods=0, slo_breach_rounds=2))


def test_slo_restart_carry_keeps_planner_quiet(run):
    """A worker restart zeroes its gauges and resets its rings; each
    package's fleet source carries the pre-restart coarse average until
    fresh samples exist, so both planners hold instead of scaling down on
    a phantom idle."""

    def snap(seq, ts, *, started, util):
        return TelemetrySnapshot(
            worker_id=1, role="decode", seq=seq, ts=ts, started_ts=started,
            kv_pages_used=int(util * 100), kv_pages_total=100,
            kv_utilization=util, batch_slots=8,
        ).to_dict()

    async def body():
        t0 = time.time() - 8
        snaps = [snap(i, t0 + i, started=t0, util=0.5) for i in range(1, 7)]
        # restart: new incarnation, seq reset, gauges zeroed, one sample
        snaps.append(snap(1, t0 + 7.5, started=t0 + 7, util=0.0))
        obs = {}
        for name, pkg in PACKAGES.items():
            obs[name] = pkg.Observatory(pkg.Registry())
            for s in snaps:
                obs[name].ingest(s)
        conns = {name: await local_pool(pkg, 2, 1) for name, pkg in PACKAGES.items()}
        planners = {name: pkg.Planner(conns[name], metrics_source=pkg.fleet_source(obs[name]),
                                      cfg=pkg.PlannerConfig(decode_grace_periods=0))
                    for name, pkg in PACKAGES.items()}
        try:
            for p in planners.values():
                await asyncio.wait_for(p.step(), WAIT_S)
        finally:
            for p in planners.values():
                await asyncio.wait_for(p.stop(), WAIT_S)
        assert decisions(planners["port"]) == decisions(planners["jax"])
        assert conns["port"].worker_count(DECODE) == 2
        assert not [a for a in planners["port"].adjustments if a.action == "down"]
        m = obs["port"].forward_pass_metrics()[1]
        assert m.gpu_cache_usage_perc > 0.3  # carried, not the raw 0.0
        assert vars(m) == vars(obs["jax"].forward_pass_metrics()[1])

    run(body())


# -- LocalConnector safe actuation (drain/refund, standby, victims) ------------


class _DrainHandle:
    def __init__(self, mode="ok"):
        self.mode = mode  # "ok" | "hang"
        self.stopped = False

    async def drain(self, timeout_s):
        if self.mode == "hang":
            await asyncio.sleep(60)
        return True

    async def stop(self):
        self.stopped = True


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_local_connector_drain_refunds_on_timeout(run, package):
    """A scale-down whose drain times out refunds the replica: the pool
    keeps the handle, ``forced_kills`` counts the refused kill, and a
    later round can retry -- in the JAX connector as in the port's."""

    async def body():
        handles = [_DrainHandle(), _DrainHandle()]
        it = iter(handles)

        async def factory():
            return next(it)

        conn = PACKAGES[package].LocalConnector({"decode": factory}, drain_timeout_s=0.05)
        await conn.add_worker("decode")
        await conn.add_worker("decode")
        handles[1].mode = "hang"
        await asyncio.wait_for(conn.remove_worker("decode"), WAIT_S)  # LIFO victim hangs
        assert conn.worker_count("decode") == 2  # refunded
        assert conn.forced_kills == 1
        assert not handles[1].stopped
        handles[1].mode = "ok"
        await asyncio.wait_for(conn.remove_worker("decode"), WAIT_S)  # retry drains
        assert conn.worker_count("decode") == 1
        assert handles[1].stopped

    run(body())


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_local_connector_standby_promotion(run, package):
    async def body():
        built = []

        async def factory():
            h = _DrainHandle()
            built.append(h)
            return h

        conn = PACKAGES[package].LocalConnector({"decode": factory}, standby_spares=1)
        await conn.prewarm("decode")
        assert len(built) == 1 and conn.worker_count("decode") == 0
        await conn.add_worker("decode")
        assert conn.worker_count("decode") == 1
        assert conn.workers["decode"][0] is built[0]  # the spare, promoted
        assert len(conn.spares["decode"]) == 1  # replenished
        assert len(built) == 2

    run(body())


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_local_connector_victim_source_picks_named_handle(run, package):
    async def body():
        handles = [_DrainHandle(), _DrainHandle(), _DrainHandle()]
        it = iter(handles)

        async def factory():
            return next(it)

        conn = PACKAGES[package].LocalConnector(
            {"decode": factory}, victim_source=lambda kind, pool: pool[0])
        for _ in range(3):
            await conn.add_worker("decode")
        await asyncio.wait_for(conn.remove_worker("decode"), WAIT_S)
        assert handles[0].stopped  # victim source chose the oldest
        assert conn.workers["decode"] == handles[1:]

    run(body())


# -- a seeded differential -------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_random_rounds_decide_alike(run, tmp_path, seed):
    """40 rounds of random per-worker load, waiting requests, attainment,
    cumulative TTFT violation counts, quarantine and prefill queue depth
    over 1 to 4 workers: both planners make the same decisions with the
    same reasons, evidence and log lines, round by round."""
    rng = np.random.default_rng(seed)
    viol = {w: [0.0, 0.0] for w in range(6)}

    async def body(twin):
        for _ in range(40):
            workers = sorted(rng.choice(6, size=int(rng.integers(1, 5)), replace=False))
            twin.metrics.clear()
            # a hot, a cold or a mixed round of KV load
            lo, hi = ((0.7, 1.0), (0.0, 0.3), (0.0, 1.0))[int(rng.integers(0, 3))]
            for w in workers:
                w = int(w)
                viol[w][0] += float(rng.integers(0, 3)) * float(rng.random() < 0.5)
                viol[w][1] += float(rng.integers(0, 3)) * float(rng.random() < 0.5)
                twin.metrics[w] = slo_fpm(
                    load=float(rng.uniform(lo, hi)),
                    waiting=int(rng.integers(0, 3)) * int(rng.random() < 0.2),
                    itl=float(rng.uniform(0.5, 1.0)) if rng.random() < 0.25 else 1.0,
                    ttft=float(rng.uniform(0.5, 1.0)) if rng.random() < 0.25 else 1.0,
                    qv=viol[w][0], sv=viol[w][1],
                )
            twin.quarantine[:] = [int(w) for w in workers if rng.random() < 0.15]
            twin.depth["v"] = int(rng.integers(0, 12))
            await twin.step()

    twin = run(twin_case(
        body, decode=2, prefill=1, queue=True, quarantine=True, log_dir=tmp_path,
        decode_grace_periods=1, prefill_grace_periods=1, slo_breach_rounds=2,
        slo_cooldown_rounds=2, max_decode_workers=4, max_prefill_workers=3,
        min_prefill_workers=1))
    actions = {a.action for a in twin.planner.adjustments}
    assert {"up", "down", "hold"} <= actions
    assert len(twin.log_lines("port")) == len(twin.planner.adjustments)


# -- the metrics sources ----------------------------------------------------------


def _seed_engine_gauges(reg):
    g = reg.gauge
    g("dynamo_engine_kv_pages_total", "t").set(256)
    g("dynamo_engine_kv_pages_used", "t").set(230)
    g("dynamo_engine_kv_utilization", "t").set(230 / 256)
    g("dynamo_engine_prefill_queue_depth", "t").set(5)
    g("dynamo_engine_batch_occupancy", "t").set(3)
    g("dynamo_engine_batch_slots", "t").set(8)
    reg.counter("dynamo_engine_prefix_hit_tokens", "t").inc(30)
    reg.counter("dynamo_engine_prefix_lookup_tokens", "t").inc(120)


def test_planner_decisions_identical_across_sources(run, slo_trackers):
    """On a single-worker fleet the registry source and the fleet source
    give the same metrics and the same decision, in each package, and the
    packages decide alike."""
    got = {}
    for name, pkg in PACKAGES.items():
        registry = pkg.Registry()
        _seed_engine_gauges(registry)  # kv load 0.9 -> decode scale-up
        obs = pkg.Observatory(pkg.Registry())
        pub = pkg.Publisher(worker_id=0, role="decode", registry=registry)
        obs.ingest(pub.collect().to_dict())
        local = pkg.registry_source(registry)()
        fleet = pkg.fleet_source(obs)()
        assert set(local) == set(fleet) == {0}
        assert vars(local[0]) == pytest.approx(vars(fleet[0]))

        async def run_planner(source, pkg=pkg):
            conn = await local_pool(pkg, 1, 0)
            planner = pkg.Planner(conn, source, queue_depth_source=None,
                                  cfg=pkg.PlannerConfig(adjustment_interval_s=3600.0))
            try:
                await asyncio.wait_for(planner.step(), WAIT_S)
            finally:
                await asyncio.wait_for(planner.stop(), WAIT_S)
            return conn.worker_count(DECODE), decisions(planner)

        a = run(run_planner(pkg.registry_source(registry)))
        b = run(run_planner(pkg.fleet_source(obs)))
        assert a == b
        got[name] = (a, vars(local[0]))
    assert got["port"] == got["jax"]
    (count, made), _ = got["port"]
    assert count == 2
    assert [d[:2] + (d[3],) for d in made] == [(DECODE, "up", 1)]


# -- a prefill pool scaled on the hub's queue depth --------------------------------


def test_prefill_pool_scales_on_hub_queue_depth(run):
    """Prefill consumers over the port's hub: the planner reads the
    queue's depth through ``HubClient.queue_depth``, adds consumers while
    the backlog stands, and retires them (drained first) once it is
    gone; the JAX planner, fed the depths the port's read, decides
    alike."""
    from dynamo_tpu_torch.llm.disagg import PREFILL_QUEUE_SUFFIX
    from dynamo_tpu_torch.runtime.transports.client import HubClient
    from dynamo_tpu_torch.runtime.transports.hub import HubServer

    queue = "dynamo" + PREFILL_QUEUE_SUFFIX
    depths: list = []

    async def body():
        server = HubServer(host="127.0.0.1", port=0)
        host, port = await server.start()
        client = await HubClient(host, port).connect()
        go = asyncio.Event()
        consumers = []

        class Consumer:
            """One prefill worker: pops the queue once released."""

            def __init__(self) -> None:
                self.popped = 0
                self.task = asyncio.create_task(self.loop())

            async def loop(self) -> None:
                await go.wait()
                while True:
                    if await client.queue_pop(queue, block=False) is None:
                        await asyncio.sleep(0.01)
                    else:
                        self.popped += 1

            async def drain(self, timeout_s: float) -> bool:
                return True

            async def stop(self) -> None:
                self.task.cancel()
                await asyncio.gather(self.task, return_exceptions=True)

        async def make_consumer():
            consumers.append(Consumer())
            return consumers[-1]

        async def qdepth():
            depths.append(await client.queue_depth(queue))
            return depths[-1]

        conn = LocalConnector({PREFILL: make_consumer}, drain_timeout_s=1.0)
        await conn.add_worker(PREFILL)
        planner = Planner(conn, metrics_source=lambda: {}, queue_depth_source=qdepth,
                          cfg=PlannerConfig(prefill_grace_periods=0, min_prefill_workers=1,
                                            max_prefill_workers=3))
        try:
            for i in range(12):
                await client.queue_push(queue, f"req-{i}".encode())
            await asyncio.wait_for(planner.step(), WAIT_S)  # 12 / 1 worker
            await asyncio.wait_for(planner.step(), WAIT_S)  # 12 / 2, flat trend
            assert conn.worker_count(PREFILL) == 3
            go.set()
            for _ in range(500):
                if await client.queue_depth(queue) == 0:
                    break
                await asyncio.sleep(0.01)
            for _ in range(3):
                await asyncio.wait_for(planner.step(), WAIT_S)
            assert conn.worker_count(PREFILL) == 1  # the floor
            assert sum(c.popped for c in consumers) == 12
            assert all(c.task.cancelled() for c in consumers if c not in conn.workers[PREFILL])
        finally:
            await asyncio.wait_for(planner.stop(), WAIT_S)
            for c in consumers:
                await c.stop()
            await client.close()
            await server.stop()
        return decisions(planner)

    port = run(body())
    assert [d[:2] for d in port if d[1] != "hold"] == [
        (PREFILL, "up"), (PREFILL, "up"), (PREFILL, "down"), (PREFILL, "down")]

    async def replay():
        it = iter(depths)

        async def qdepth():
            return next(it)

        conn = await local_pool(PACKAGES["jax"], 0, 1)
        planner = jax_planner.Planner(
            conn, metrics_source=lambda: {}, queue_depth_source=qdepth,
            cfg=jax_planner.PlannerConfig(prefill_grace_periods=0, min_prefill_workers=1,
                                          max_prefill_workers=3))
        try:
            for _ in depths:
                await asyncio.wait_for(planner.step(), WAIT_S)
        finally:
            await asyncio.wait_for(planner.stop(), WAIT_S)
        return decisions(planner)

    assert run(replay()) == port


def test_planner_families_follow_the_pool(run):
    """``dynamo_planner_adjustments`` counts each actuated decision by
    kind and action, and ``dynamo_planner_pool_size`` follows the
    connector round by round, on the port's default registry."""
    reg = rtm.default_registry()

    async def body(twin):
        sizes = []
        await twin.step()
        sizes.append(reg.sample("dynamo_planner_pool_size", {"kind": DECODE}))
        twin.metrics[1] = fpm(0.1)
        await twin.step(2)
        sizes.append(reg.sample("dynamo_planner_pool_size", {"kind": DECODE}))
        assert sizes == [2.0, 1.0]
        assert reg.sample("dynamo_planner_pool_size", {"kind": PREFILL}) == 1.0
        for action in ("up", "down"):
            assert reg.sample("dynamo_planner_adjustments",
                              {"kind": DECODE, "action": action}) == 1.0
        text = reg.render()[0].decode()
        assert "# TYPE dynamo_planner_adjustments_total counter" in text
        assert "# TYPE dynamo_planner_pool_size gauge" in text

    run(twin_case(body, metrics={1: fpm(0.95)}, decode_grace_periods=1))


def test_log_writer_keeps_the_planner_log_role(run, tmp_path):
    """With the thread sentry armed, the JSONL writer runs on the
    ``planner-log`` thread (its role check passes and the line lands),
    and the same write from the event loop's thread is refused."""
    from dynamo_tpu_torch.runtime import thread_sentry

    path = tmp_path / "adjust.jsonl"

    async def body():
        conn = await local_pool(PACKAGES["port"], 1, 0)
        planner = Planner(conn, lambda: {1: ForwardPassMetrics(**fpm(0.95))},
                          cfg=PlannerConfig(adjustment_log_path=str(path)))
        try:
            await asyncio.wait_for(planner.step(), WAIT_S)
            with pytest.raises(thread_sentry.ThreadConfinementError):
                planner._append_log_line("{}")
        finally:
            await asyncio.wait_for(planner.stop(), WAIT_S)

    armed = thread_sentry.armed()
    thread_sentry.arm(True)
    try:
        run(body())
    finally:
        thread_sentry.arm(armed)
    assert [json.loads(line)["action"] for line in path.read_text().splitlines()] == ["up"]
