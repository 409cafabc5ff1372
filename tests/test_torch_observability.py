"""The port's observability routes and CLI against the JAX package's.

Each package's ``HttpService`` serves the same slow chat engine (one
content chunk every 20 ms until its context stops) under a short deadline
with the SLO plane armed: on every 504 path -- the dispatch raising
``DeadlineExceededError``, the aggregated body and the SSE stream -- the
port's 504 body and SSE error frame equal the JAX service's field for
field, ``flightrec`` included (the ids differ only in their number), the
snapshot at ``GET /debug/flightrec/{id}`` carries the ``deadline``
violation, and an unknown id is a 404 in both.  The routes' answers to bad
input (``/trace/`` bare or unknown, a non-object ``/profile/ticks`` body,
a non-numeric ``/profile/device`` duration) are the JAX service's.  Over
the port's real pipeline (a tiny ``TorchEngine`` behind
``OpenAIPreprocessor`` and ``Backend``) with the profiler and tracing on:
``GET``/``POST /profile/ticks``, ``/trace/{id}`` holding the mixed
``engine.prefill_dispatch`` span, a device trace on the CPU, and the
``profile`` subcommand, whose output equals the JAX CLI's against the same
server.  The ``trace`` subcommand assembles a request's spans from an
in-process hub cluster, and prints what the JAX CLI prints there.  Every
wait is bounded.
"""

from __future__ import annotations

import asyncio
import json
import re

import pytest

from dynamo_tpu import cli as jax_cli
from dynamo_tpu.http.service import HttpService as JaxHttpService
from dynamo_tpu.http.service import ModelManager as JaxModelManager
from dynamo_tpu.runtime import engine as jax_engine
from dynamo_tpu.runtime import profiling as jax_profiling
from dynamo_tpu.runtime import slo as jax_slo
from dynamo_tpu.runtime import tracing as jax_tracing
from dynamo_tpu_torch import cli
from dynamo_tpu_torch.http.service import HttpService, ModelManager
from dynamo_tpu_torch.runtime import engine as port_engine
from dynamo_tpu_torch.runtime import profiling, slo, tracing

from tests.test_torch_frontend import NAME, http, sse_events, stack, torch_service  # noqa: F401
from tests.test_torch_runtime import Cluster

WAIT_S = 60
PACKAGES = {
    "port": (HttpService, ModelManager, port_engine, profiling, slo),
    "jax": (JaxHttpService, JaxModelManager, jax_engine, jax_profiling, jax_slo),
}


class SlowChat:
    """A chat engine of one package: one content chunk every 20 ms until
    its context stops, or -- ``refuse`` -- a dispatch that raises the
    package's ``DeadlineExceededError``."""

    def __init__(self, engine_mod, refuse: bool = False) -> None:
        self.mod, self.refuse = engine_mod, refuse

    async def generate(self, request):
        if self.refuse:
            raise self.mod.DeadlineExceededError()
        ctx = request.ctx

        async def gen():
            for i in range(500):
                if ctx.is_stopped():
                    return
                yield {"id": "c", "object": "chat.completion.chunk", "created": 0,
                       "model": NAME, "choices": [{"index": 0, "delta": {"content": "x"}}]}
                await asyncio.sleep(0.02)

        return self.mod.ResponseStream(ctx, gen())


@pytest.fixture
def planes():
    """Both packages' SLO trackers armed (e2e=60s), flight recorders and
    profilers cleared; everything disarmed after."""
    for s in (slo, jax_slo):
        s.tracker.configure("e2e=60s")
    for p in (profiling, jax_profiling):
        p.flight_recorder.clear()
    yield
    for s in (slo, jax_slo):
        s.tracker.disable()
    for p in (profiling, jax_profiling):
        p.flight_recorder.clear()
        p.profiler.clear()
        p.profiler.disable()


def fid_free(doc):
    """A body or frame with its flight-recorder id replaced by its form."""
    text = json.dumps(doc, sort_keys=True)
    return re.sub(r"fr-\d{4,}", "fr-N", text)


async def deadline_probe(pkg: str, path: str) -> dict:
    service_cls, manager_cls, engine_mod, prof_mod, slo_mod = PACKAGES[pkg]
    manager = manager_cls()
    manager.add_chat_model(NAME, SlowChat(engine_mod, refuse=path == "dispatch"))
    service = service_cls(manager, default_deadline_s=0.15)
    await service.start()
    port = service.address[1]
    try:
        body = {"model": NAME, "messages": [{"role": "user", "content": "hi"}],
                "max_tokens": 400, "stream": path == "sse"}
        status, hdrs, raw = await http(port, "POST", "/v1/chat/completions", body)
        if path == "sse":
            frames = [json.loads(e) for e in sse_events(raw) if e != "[DONE]"]
            error = frames[-1]
            fid = re.search(r"\[flightrec:(fr-\d+)\]", error["error"]["message"]).group(1)
            out = {"status": status, "error": error, "chunks": len(frames) - 1}
        else:
            error = json.loads(raw)
            fid = error["error"]["flightrec"]
            out = {"status": status, "error": error}
        snap_status, _, snap = await http(port, "GET", f"/debug/flightrec/{fid}")
        snap = json.loads(snap)
        _, _, listing = await http(port, "GET", "/debug/flightrec")
        missing, _, _ = await http(port, "GET", "/debug/flightrec/fr-nope")
        out.update(
            snap_status=snap_status, missing=missing,
            snap_keys=sorted(snap), reason=snap["reason"],
            violations=[(v["kind"], v["cause"], v["request_id"] == snap["trace_id"])
                        for v in snap["slo_violations"]],
            listed=[s["id"] for s in json.loads(listing)["snapshots"]] == [fid],
            deadline_count=slo_mod.tracker.violation_count("e2e", "deadline"),
        )
        return out
    finally:
        await service.stop()


@pytest.mark.parametrize("path", ["dispatch", "aggregate", "sse"])
def test_deadline_504_matches_jax(planes, path):
    """Every 504 path: the body (or SSE error frame) equals the JAX
    service's but for the id's number; the snapshot holds the deadline
    violation of this request and lists once; unknown ids are 404."""
    runs = {
        pkg: asyncio.run(asyncio.wait_for(deadline_probe(pkg, path), WAIT_S))
        for pkg in PACKAGES
    }
    port, ref = runs["port"], runs["jax"]
    assert fid_free(port["error"]) == fid_free(ref["error"])
    for key in ("status", "snap_status", "missing", "snap_keys", "reason", "violations",
                "listed", "deadline_count"):
        assert port[key] == ref[key], key
    assert port["missing"] == 404 and port["snap_status"] == 200 and port["listed"]
    assert port["reason"] == "deadline_expired"
    assert port["violations"] == [("e2e", "deadline", True)]
    if path == "sse":
        assert port["status"] == 200 and port["chunks"] > 0
        assert port["error"]["error"]["type"] == "server_error"
    else:
        assert port["status"] == 504
        assert port["error"]["error"]["type"] == "timeout_error"
        assert port["error"]["error"]["message"] == port_engine.DEADLINE_EXCEEDED_MSG


async def bad_input_probe(pkg: str) -> list:
    service_cls, manager_cls, engine_mod, _, _ = PACKAGES[pkg]
    manager = manager_cls()
    manager.add_chat_model(NAME, SlowChat(engine_mod))
    service = service_cls(manager)
    await service.start()
    port = service.address[1]
    try:
        out = []
        for method, route, body in (
            ("GET", "/trace/", None),
            ("GET", "/trace/no-such-request", None),
            ("POST", "/profile/ticks", [1, 2]),
            ("POST", "/profile/device", {"duration_s": "nope"}),
            ("POST", "/profile/device", [1]),
            ("GET", "/debug/flightrec/fr-0", None),
            ("GET", "/debug/flightrec", None),
        ):
            status, _, raw = await http(port, method, route, body)
            out.append((route, status, json.loads(raw)))
        return out
    finally:
        await service.stop()


def test_route_errors_match_jax(planes):
    """Bad or unknown input gets the JAX service's status and body."""
    port = asyncio.run(asyncio.wait_for(bad_input_probe("port"), WAIT_S))
    ref = asyncio.run(asyncio.wait_for(bad_input_probe("jax"), WAIT_S))
    assert port == ref
    assert [s for _, s, _ in port] == [400, 404, 400, 400, 400, 404, 200]


# -- the port's real pipeline ---------------------------------------------------


def chat(max_tokens=6):
    return {"model": NAME, "messages": [{"role": "user", "content": "hello world"}],
            "max_tokens": max_tokens}


@pytest.fixture
def traced():
    tracing.collector.clear()
    tracing.collector.enable()
    yield
    tracing.collector.disable()
    tracing.collector.clear()


def test_profile_and_trace_routes_on_the_served_pipeline(stack, planes, traced):
    """Armed live by ``POST /profile/ticks``, the served pipeline's ticks
    come back from ``GET /profile/ticks`` (summary keys as JAX's, phases,
    a Chrome trace with its ``engine.tick`` row and the request spans);
    ``/trace/{X-Request-Id}`` holds ``http.request`` and the mixed
    ``engine.prefill_dispatch``; a device trace answers ``ok`` on the
    CPU; ``POST`` disarms."""
    engine, service = torch_service(stack, {})

    async def body():
        await service.start()
        port = service.address[1]
        try:
            status, _, raw = await http(port, "POST", "/profile/ticks",
                                        {"enabled": True, "clear": True})
            assert status == 200 and json.loads(raw) == {"enabled": True}
            status, hdrs, raw = await http(port, "POST", "/v1/chat/completions", chat())
            assert status == 200, raw
            rid = hdrs["x-request-id"]
            status, _, raw = await http(port, "GET", "/profile/ticks")
            ticks = json.loads(raw)
            status_t, _, raw_t = await http(port, "GET", f"/trace/{rid}")
            status_d, _, raw_d = await http(port, "POST", "/profile/device",
                                            {"duration_s": 0.05})
            status_off, _, raw_off = await http(port, "POST", "/profile/ticks",
                                                {"enabled": False})
            return (status, ticks, status_t, json.loads(raw_t), status_d,
                    json.loads(raw_d), status_off, json.loads(raw_off))
        finally:
            await service.stop()
            await engine.stop()

    (status, ticks, status_t, trace, status_d, dev, status_off, off) = asyncio.run(
        asyncio.wait_for(body(), WAIT_S)
    )
    assert status == 200 and ticks["enabled"] is True
    summary = ticks["summary"]
    assert set(summary) == set(jax_profiling.TickProfiler().summary())
    assert summary["ticks"] == len(ticks["ticks"]) >= 1
    assert summary["dispatches"] == sum(
        sum(t["dispatches"].values()) for t in ticks["ticks"]
    ) == sum(engine.dispatches.get(k, 0) for k in ("prefill", "unified", "decode_block"))
    assert {"plan", "dispatch", "commit"} <= set(summary["phase_totals_s"])
    rows = {e["args"]["name"] for e in ticks["chrome_trace"]["traceEvents"]
            if e.get("ph") == "M"}
    assert {"engine.tick", "http"} <= rows
    assert status_t == 200
    names = [(s["name"], (s.get("attrs") or {}).get("mixed")) for s in trace["spans"]]
    assert ("engine.prefill_dispatch", True) in names and ("http.request", None) in names
    assert trace["chrome_trace"]["traceEvents"]
    assert status_d == 200 and dev["ok"] and dev["duration_s"] == 0.05
    assert status_off == 200 and off == {"enabled": False}
    assert not profiling.profiler.enabled


@pytest.mark.parametrize("device", [False, True])
def test_profile_subcommand_prints_what_jax_prints(stack, planes, capsys, tmp_path, device):
    """``profile URL --enable`` then traffic, then ``profile URL --json F``
    (and ``--device``): the port's CLI exits 0 and prints what the JAX
    CLI prints against the same server; the Chrome trace holds
    ``engine.tick`` rows; without traffic and armed, both report no
    ticks with exit 1."""
    engine, service = torch_service(stack, {})
    out = {}

    async def body():
        await service.start()
        url = f"http://127.0.0.1:{service.address[1]}"
        try:
            for mod in (cli, jax_cli):
                assert await mod.run_profile(
                    mod.build_parser().parse_args(["profile", url, "--enable"])
                ) == 1
                capsys.readouterr()
            for _ in range(2):
                status, _, raw = await http(service.address[1], "POST",
                                            "/v1/chat/completions", chat(8))
                assert status == 200, raw
            for name, mod in (("port", cli), ("jax", jax_cli)):
                argv = ["profile", url, "--json", str(tmp_path / f"{name}.json")]
                if device:
                    argv += ["--device", "0.05"]
                rc = await mod.run_profile(mod.build_parser().parse_args(argv))
                out[name] = (rc, capsys.readouterr().out)
            assert await cli.run_profile(
                cli.build_parser().parse_args(["profile", url, "--disable"])
            ) == 0
        finally:
            await service.stop()
            await engine.stop()

    asyncio.run(asyncio.wait_for(body(), WAIT_S))
    rc, text = out["port"]
    assert rc == 0 and "dispatch gap p50=" in text and "host occupancy" in text
    strip = lambda t: re.sub(r"(device trace captured to |written to )\S+", r"\1X", t)  # noqa: E731
    assert strip(text) == strip(out["jax"][1])
    assert ("device trace captured to" in text) == device
    trace = json.loads((tmp_path / "port.json").read_text())
    assert any(e.get("args", {}).get("name") == "engine.tick"
               for e in trace["traceEvents"] if e.get("ph") == "M")
    assert any(e["name"] == "tick" for e in trace["traceEvents"])


def test_trace_subcommand_assembles_the_cluster_spans(capsys, tmp_path):
    """With tracing on, a request through an in-process hub cluster: the
    port's ``trace`` prints its spans (the worker's ``ingress`` under the
    caller's ``egress``) and writes a Chrome trace, as the JAX CLI prints
    them; an unknown request prints nothing and exits 1."""
    for mod in (tracing, jax_tracing):
        mod.collector.clear()
        mod.collector.enable()
    out = {}

    async def body():
        cluster = await Cluster().start(1)
        try:
            request = port_engine.Context.new({"n": 2})
            from dynamo_tpu_torch.runtime.component import PushRouter

            stream = await PushRouter(cluster.client).generate(request)
            assert len([x async for x in stream]) == 2
            for name, mod in (("port", cli), ("jax", jax_cli)):
                argv = ["trace", "--hub", cluster.addr, "--namespace", "t", request.id,
                        "--json", str(tmp_path / f"{name}.json")]
                rc = await mod.run_trace(mod.build_parser().parse_args(argv))
                out[name] = (rc, capsys.readouterr().out)
            rc = await cli.run_trace(cli.build_parser().parse_args(
                ["trace", "--hub", cluster.addr, "--namespace", "t", "nope"]))
            out["unknown"] = (rc, capsys.readouterr().out)
        finally:
            await cluster.stop()

    try:
        asyncio.run(asyncio.wait_for(body(), WAIT_S))
    finally:
        for mod in (tracing, jax_tracing):
            mod.collector.disable()
            mod.collector.clear()
    rc, text = out["port"]
    assert rc == 0 and "ingress" in text and "egress" in text
    strip = lambda t: re.sub(r"written to \S+", "written to X", t)  # noqa: E731
    assert strip(text) == strip(out["jax"][1])
    names = {e["name"] for e in json.loads((tmp_path / "port.json").read_text())["traceEvents"]}
    assert {"ingress", "egress"} <= names
    assert out["unknown"][0] == 1 and "no spans for request nope" in out["unknown"][1]
