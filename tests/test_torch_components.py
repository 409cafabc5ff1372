"""The port's standalone cluster components and the fleet subcommands.

In process, over one hub: two port mocker workers; the port's
``RouterService`` (served, and called through a JAX client) and the JAX
one pick the same worker and overlap for a cached prefix, and the port's
``MetricsService`` renders the bytes the JAX one renders from the same
scrapes and hit-rate events (its ``GET /metrics`` too).  The front end's
KV router reads the observatory: a quarantined worker is never chosen and
the fetch gate's predicted fetch is the fitted link's.

As subprocesses, beside a port hub, a port mocker worker and the port's
KV-routed front end: ``fleet --once --json`` and the front end's
``/fleet`` name the same workers, ``metrics --hub`` serves the load
gauges and stops on SIGINT with code 0, ``bench --fleet`` attaches the
front end's fleet summary to its report.  Every wait is bounded.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time

import pytest

from dynamo_tpu.llm.components import MetricsService as JaxMetricsService
from dynamo_tpu.llm.components import RouterService as JaxRouterService
from dynamo_tpu.runtime.component import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime.component import PushRouter as JaxPushRouter
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch import cli
from dynamo_tpu_torch.fleet import FleetObservatory
from dynamo_tpu_torch.llm.components import MetricsService, RouterService
from dynamo_tpu_torch.mocker import MockerConfig, MockerEngine
from dynamo_tpu_torch.runtime import metrics as rtm
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.telemetry import TelemetrySnapshot
from dynamo_tpu_torch.runtime.transports.hub import HubServer
from tests.test_serving import http_request
from tests.test_torch_cli_model_free import ROOT, WAIT_S, Proc, base_url, get, wait_for_model

BLOCK = 4
PREFIX = list(range(100, 116))  # four blocks


async def until(pred, what: str, timeout: float = 20.0):
    """Poll an async predicate until it returns a truthy value (bounded)."""
    deadline = time.monotonic() + timeout
    while True:
        got = await asyncio.wait_for(pred(), timeout)
        if got:
            return got
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        await asyncio.sleep(0.1)


async def spawn_mocker(addr: str, worker_id: int):
    rt = await asyncio.wait_for(DistributedRuntime.detached(addr), WAIT_S)
    eng = MockerEngine(MockerConfig(block_size=BLOCK, worker_id=worker_id),
                       registry=rtm.MetricsRegistry())
    _card, served = await asyncio.wait_for(
        cli.serve_worker(rt, eng, "dyn://dynamo.backend.generate", None), WAIT_S)
    return rt, eng, served


async def drain(stream) -> list:
    return [item async for item in stream]


def test_router_and_metrics_services_match_jax(run):
    async def body():
        hub = HubServer()
        host, port = await hub.start()
        addr = f"{host}:{port}"
        workers = [await spawn_mocker(addr, i) for i in range(2)]
        front = await DistributedRuntime.detached(addr)
        jrt = await asyncio.wait_for(JaxRuntime.detached(addr), WAIT_S)
        svc = RouterService(front, "dynamo", block_size=BLOCK)
        jsvc = JaxRouterService(jrt, "dynamo", block_size=BLOCK)
        msvc = MetricsService(front, "dynamo", scrape_interval_s=0.1)
        jmsvc = JaxMetricsService(jrt, "dynamo", scrape_interval_s=0.1)
        try:
            await asyncio.wait_for(svc.start(), WAIT_S)
            await asyncio.wait_for(jsvc.router.start(), WAIT_S)
            await asyncio.wait_for(msvc.start(), WAIT_S)
            await asyncio.wait_for(jmsvc.start(), WAIT_S)
            # cache the prefix on worker 0 only
            rt0, eng0, _ = workers[0]
            from dynamo_tpu_torch.protocols.common import (
                PreprocessedRequest, SamplingOptions, StopConditions,
            )
            req = PreprocessedRequest(
                token_ids=PREFIX + [1], stop_conditions=StopConditions(max_tokens=2),
                sampling_options=SamplingOptions(temperature=0.0),
            )
            await asyncio.wait_for(drain(await eng0.generate(Context.new(req))), WAIT_S)
            lease0 = rt0.primary_lease

            async def both_see():
                a = await svc.router.find_best_match(PREFIX)
                b = await jsvc.router.find_best_match(PREFIX)
                return (a, b) if a == b == (lease0, 4) else None

            await until(both_see, "both routers to index worker 0's prefix")
            # the port's served endpoint, called through a JAX client
            client = await jrt.namespace("dynamo").component("router").endpoint(
                "generate").client()
            await asyncio.wait_for(client.wait_for_instances(), WAIT_S)
            items = await asyncio.wait_for(drain(await JaxPushRouter(client).generate(
                JaxContext.new({"token_ids": PREFIX}))), WAIT_S)
            assert [i.data for i in items] == [{"worker_id": lease0, "overlap_blocks": 4}]
            await client.close()

            async def same_render():
                eps = (msvc.aggregator.endpoints.endpoints,
                       jmsvc.aggregator.endpoints.endpoints)
                if not (len(eps[0]) == len(eps[1]) == 2):
                    return None
                if msvc._hit_events != jmsvc._hit_events or msvc._hit_events < 3:
                    return None
                a, b = msvc.render()[0], jmsvc.render()[0]
                return a if a == b else None

            body_bytes = await until(same_render, "equal cluster metrics")
            assert b'llm_kv_blocks_total{component="backend"}' in body_bytes
            assert b"llm_kv_hit_rate" in body_bytes
            mhost, mport = await asyncio.wait_for(msvc.serve_http("127.0.0.1", 0), WAIT_S)
            status, _h, scraped = await asyncio.wait_for(
                http_request(mhost, mport, "GET", "/metrics", raw_response=True), WAIT_S)
            assert status == 200 and b"llm_requests_total_slots" in scraped
        finally:
            for s in (jmsvc, msvc, svc):
                await asyncio.wait_for(s.stop(), WAIT_S)
            await asyncio.wait_for(jsvc.router.stop(), WAIT_S)
            for rt, eng, served in workers:
                await served.close()
                await eng.stop()
                await rt.shutdown()
            await jrt.shutdown()
            await front.shutdown()
            await hub.stop()

    run(body())


def test_front_end_router_reads_the_observatory(run, model_dir):
    """``kv_engine_factory(observatory=...)``: the observatory's quarantined
    worker is never chosen, and the gate prices a donor with the fitted
    link, not the prior."""

    async def body():
        hub = HubServer()
        host, port = await hub.start()
        addr = f"{host}:{port}"
        workers = [await spawn_mocker(addr, i) for i in range(2)]
        front = await DistributedRuntime.detached(addr)
        obs = FleetObservatory(rtm.MetricsRegistry())
        factory = cli.kv_engine_factory(front, observatory=obs)

        class Card:
            kv_block_size = BLOCK

            def tokenizer(self):
                from dynamo_tpu_torch.llm.tokenizer import Tokenizer

                return Tokenizer.from_file(f"{model_dir}/tokenizer.json")

        class Entry:
            namespace, component, name = "dynamo", "backend", "m"

        ep = front.namespace("dynamo").component("backend").endpoint("generate")
        client = await ep.client()
        from dynamo_tpu_torch.runtime.component import PushRouter

        try:
            await asyncio.wait_for(client.wait_for_instances(), WAIT_S)
            _engine, stop_chooser = await asyncio.wait_for(
                factory(Entry, Card(), client, PushRouter(client)), WAIT_S)
            chooser, push = factory.choosers["m"], factory.push_routers["m"]
            slow, fast = (rt.primary_lease for rt, _e, _s in workers)
            # telemetry of the two workers and two peers: ``slow`` straggles
            now = time.time()
            for seq in range(1, 7):
                for wid in (slow, fast, 7, 8):
                    step = 0.02 if wid == slow else 0.001
                    obs.ingest(TelemetrySnapshot(
                        worker_id=wid, role="worker", seq=seq, ts=now - 7 + seq,
                        started_ts=now - 10, step_count=10.0 * seq,
                        step_seconds=step * 10 * seq, batch_slots=8,
                        transfers=[{"src": 7, "dst": fast, "bytes": n,
                                    "seconds": 0.004 + n / 2e8}
                                   for n in ((1 << 20) * seq,) if wid == fast],
                    ).to_dict())
            assert obs.quarantined == [slow]

            async def scraped():
                return len(chooser.scheduler.workers.endpoints) == 2

            await until(scraped, "the chooser's load scrape")
            picks = {(await chooser.find_best_match(list(range(i, i + 8))))[0]
                     for i in range(0, 400, 8)}
            assert picks == {fast}
            row = push._gate_donor("r1", fast, 0, {
                "instance": 7, "blocks": 8, "nbytes": 8 << 20, "source": "peer"})
            assert row["pred_fetch_ms"] == obs.predict_transfer_ms(8 << 20, 7, fast)
            # a link with no samples: the prior prices it
            row = push._gate_donor("r2", fast, 0, {
                "instance": 8, "blocks": 8, "nbytes": 8 << 20, "source": "peer"})
            assert row["pred_fetch_ms"] == pytest.approx((8 << 20) / 1e9 * 1e3)
            await stop_chooser()
        finally:
            await client.close()
            for rt, eng, served in workers:
                await served.close()
                await eng.stop()
                await rt.shutdown()
            await front.shutdown()
            await hub.stop()

    run(body())


def cli_run(*argv: str, timeout: float = WAIT_S) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch", *argv], cwd=ROOT,
        capture_output=True, text=True, timeout=timeout,
        env={**__import__("os").environ, "DYN_LOG": "warning"},
    )


def test_fleet_metrics_and_bench_subcommands(model_dir, tmp_path):
    procs = []
    try:
        hub = Proc("dynamo_tpu_torch", "hub", "--port", "0", tmp=tmp_path)
        procs.append(hub)
        addr = hub.expect("hub at ").split()[-1]
        worker = Proc("dynamo_tpu_torch", "run", "in=dyn", "out=mocker",
                      "--model-path", model_dir, "--model-name", "m", "--hub", addr,
                      tmp=tmp_path)
        procs.append(worker)
        worker.expect("worker serving model m")
        front = Proc("dynamo_tpu_torch", "run", "in=http", "out=dyn", "--hub", addr,
                     "--router-mode", "kv", "--port", "0", tmp=tmp_path)
        procs.append(front)
        base = base_url(front.expect("frontend at "))
        wait_for_model(base, "m")

        fleet = cli_run("fleet", "--hub", addr, "--once", "--json", "--interval", "2.5")
        assert fleet.returncode == 0, fleet.stderr
        doc = json.loads(fleet.stdout)
        ids = {w["worker_id"] for w in doc["workers"]}
        assert len(ids) == 1 and doc["totals"]["workers_by_role"] == {"worker": 1}
        deadline = time.monotonic() + WAIT_S
        while {w["worker_id"] for w in get(f"{base}/fleet")["workers"]} != ids:
            assert time.monotonic() < deadline, "front end's /fleet never named the worker"
            time.sleep(0.2)
        table = cli_run("fleet", "--hub", addr, "--once", "--plan", "--interval", "1.5")
        assert table.returncode == 0, table.stderr
        assert f"{ids.pop()}  worker" in table.stdout
        assert "plan:  (no planner adjustments yet)" in table.stdout

        metrics = Proc("dynamo_tpu_torch", "metrics", "--hub", addr, "--host",
                       "127.0.0.1", "--port", "0", tmp=tmp_path)
        procs.append(metrics)
        url = metrics.expect("cluster metrics at ").split()[3]
        deadline = time.monotonic() + WAIT_S
        while True:
            import urllib.request

            with urllib.request.urlopen(url, timeout=WAIT_S) as resp:
                text = resp.read().decode()
            if 'llm_requests_total_slots{component="backend"} 64.0' in text:
                break
            assert time.monotonic() < deadline, text
            time.sleep(0.2)
        metrics.stop()
        assert metrics.p.returncode == 0, metrics.stderr()

        port = base.rsplit(":", 1)[1]
        bench = cli_run("bench", "--port", port, "--model", "m", "--num-requests", "4",
                        "--isl", "8", "--osl", "4", "--vocab-size", "100", "--fleet")
        assert bench.returncode == 0, bench.stderr
        report = json.loads(bench.stdout)
        assert report["num_errors"] == 0
        assert {w["worker_id"] for w in report["fleet"]["workers"]} == {
            w["worker_id"] for w in doc["workers"]}
    finally:
        for p in reversed(procs):
            p.stop()
    for p in procs:
        assert p.p.returncode == 0, p.stderr()
