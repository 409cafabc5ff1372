"""The port stands alone: every module of ``dynamo_tpu_torch`` imports under
a hook that refuses JAX, the JAX package and the libraries the port must not
need at import (the card's machine has none of them but triton, which the
port may only import inside a launch).  Under the same hook,
``python -m dynamo_tpu_torch run in=http`` serves a chat completion from a
safetensors checkpoint directory, answers ``/v1/embeddings`` and exits 0
on SIGINT; so do ``hub``, ``run in=dyn out=torch`` and ``run in=http
out=dyn``, serving the same through the distributed runtime.  The fleet
observatory's render, the front end's ``/fleet`` routes and the ``fleet``
and ``metrics`` subcommands run under the hook too: ``prometheus_client``
is on this machine, not on the card's, so a lazy import of it would pass
everywhere else.  So do a planner round that mints the planner's families
and writes its JSONL log, and ``profile-sla --out mocker``; and a
Mixtral round: an MoE model made layer by layer in int8, one capacity
dispatch, a memory plan, and a SentencePiece-style tokenizer's round
trip through byte fallback."""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import textwrap
import urllib.request

import torch
from safetensors.torch import save_file

import dynamo_tpu_torch
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.model import init_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(dynamo_tpu_torch.__file__)))

REFUSED = (
    "jax", "jaxlib", "dynamo_tpu", "safetensors", "tokenizers",
    "transformers", "prometheus_client", "triton", "regex",
    "huggingface_hub", "aiohttp",
)

HOOK = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    REFUSED = set(sys.argv[1].split(","))

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            # the top-level package decides: dynamo_tpu_torch is not dynamo_tpu
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"the port must not import {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    """
)

SCRIPT = HOOK + textwrap.dedent(
    """
    import dynamo_tpu_torch

    names = [dynamo_tpu_torch.__name__]
    for info in pkgutil.walk_packages(
        dynamo_tpu_torch.__path__, dynamo_tpu_torch.__name__ + "."
    ):
        names.append(info.name)
    for name in names:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
    assert not leaked, leaked
    print(len(names))
    """
)


SERVE = HOOK + textwrap.dedent(
    """
    import runpy
    sys.argv = ["dynamo_tpu_torch"] + sys.argv[2:]
    try:
        runpy.run_module("dynamo_tpu_torch", run_name="__main__")
    except SystemExit as e:
        code = e.code
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
    print("leaked", leaked, flush=True)
    sys.exit(code)
    """
)


def test_port_imports_nothing_refused():
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, ",".join(REFUSED)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # the package, its subpackages and every module beneath them: 26 with
    # ops/flash_prefill.py, 42 with the front end (protocols/openai,
    # runtime/pipeline and metrics, llm/*, http/*, bench_serving, cli,
    # __main__), 44 with vision.py and llm/embedding.py, 48 with spec/
    # (its package, drafter.py, model_drafter.py) and engine/quant.py, 69
    # with the distributed runtime (runtime/transports/, component, config,
    # faults, thread_sentry, tracing, utils, protocols/endpoint,
    # llm/model_card, llm/discovery, llm/kv_router/), 70 with llm/disagg,
    # 71 with llm/prefix_onboard, 75 with the observability plane
    # (runtime/profiling, slo, compile_sentry, recorder), 80 with
    # runtime/telemetry, the model-free engines (mocker/ and its engine
    # and kv_manager, llm/echo), 83 with the fleet observatory (fleet/ and
    # fleet/observatory) and llm/components, 87 with the planner (planner/
    # and its connector, planner and profile_sla), 88 with
    # engine/memory_plan
    assert int(out.stdout.strip().splitlines()[-1]) >= 88


# the speculative decoding package, the model drafter and weight-only int8:
# copies and rewrites of JAX modules, the drafter's of one that imports the
# JAX package's analysis tooling
SPEC_AND_QUANT = (
    "dynamo_tpu_torch.spec", "dynamo_tpu_torch.spec.drafter",
    "dynamo_tpu_torch.spec.model_drafter", "dynamo_tpu_torch.engine.quant",
)

ONLY = HOOK + textwrap.dedent(
    """
    for name in sys.argv[2].split(","):
        importlib.import_module(name)
    try:
        importlib.import_module("dynamo_tpu.analysis.hotpath")
    except ImportError:
        pass
    else:
        raise AssertionError("the hook let dynamo_tpu.analysis through")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
    assert not leaked, leaked
    print("ok")
    """
)


def test_spec_and_quant_import_nothing_refused():
    out = subprocess.run(
        [sys.executable, "-c", ONLY, ",".join(REFUSED), ",".join(SPEC_AND_QUANT)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


# the distributed runtime, the KV router, disaggregation, prefix onboarding
# and the offload plane with its G4 tier: copies of JAX modules that import
# no JAX (disagg's original: only to name dtypes; prefix_onboard's imports
# jax.numpy), but whose JAX originals reach the JAX package's profiling,
# telemetry, fleet and prefix-onboarding modules
RUNTIME = (
    "dynamo_tpu_torch.runtime.transports", "dynamo_tpu_torch.runtime.transports.codec",
    "dynamo_tpu_torch.runtime.transports.hub",
    "dynamo_tpu_torch.runtime.transports.request_plane",
    "dynamo_tpu_torch.runtime.transports.client", "dynamo_tpu_torch.runtime.component",
    "dynamo_tpu_torch.runtime.config", "dynamo_tpu_torch.runtime.faults",
    "dynamo_tpu_torch.runtime.thread_sentry", "dynamo_tpu_torch.runtime.tracing",
    "dynamo_tpu_torch.runtime.utils", "dynamo_tpu_torch.protocols.endpoint",
    "dynamo_tpu_torch.llm.model_card", "dynamo_tpu_torch.llm.discovery",
    "dynamo_tpu_torch.llm.kv_router", "dynamo_tpu_torch.llm.kv_router.router",
    "dynamo_tpu_torch.llm.disagg", "dynamo_tpu_torch.llm.prefix_onboard",
    "dynamo_tpu_torch.offload", "dynamo_tpu_torch.cli",
)


def test_runtime_imports_nothing_refused():
    out = subprocess.run(
        [sys.executable, "-c", ONLY, ",".join(REFUSED), ",".join(RUNTIME)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


# the observability plane: copies and rewrites of JAX modules (the JAX
# profiler's device trace imports jax.profiler, its compile sentry
# jax.monitoring), and the modules that wire them in
OBSERVABILITY = (
    "dynamo_tpu_torch.runtime.profiling", "dynamo_tpu_torch.runtime.slo",
    "dynamo_tpu_torch.runtime.compile_sentry", "dynamo_tpu_torch.runtime.recorder",
    "dynamo_tpu_torch.http.service", "dynamo_tpu_torch.http.metrics",
    "dynamo_tpu_torch.llm.backend", "dynamo_tpu_torch.engine.graphs",
    "dynamo_tpu_torch.engine.engine", "dynamo_tpu_torch.ops.build",
)


def test_observability_imports_nothing_refused():
    out = subprocess.run(
        [sys.executable, "-c", ONLY, ",".join(REFUSED), ",".join(OBSERVABILITY)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


# worker telemetry and the model-free engines: copies of JAX modules that
# import no JAX, whose JAX originals reach the JAX package's runtime
MODEL_FREE = (
    "dynamo_tpu_torch.runtime.telemetry", "dynamo_tpu_torch.mocker",
    "dynamo_tpu_torch.mocker.engine", "dynamo_tpu_torch.mocker.kv_manager",
    "dynamo_tpu_torch.llm.echo", "dynamo_tpu_torch.llm.embedding",
)


def test_telemetry_and_model_free_engines_import_nothing_refused():
    out = subprocess.run(
        [sys.executable, "-c", ONLY, ",".join(REFUSED), ",".join(MODEL_FREE)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


# the fleet observatory and the cluster components, driven: a render, a
# summary and the cluster metrics' render, each under the hook
FLEET = HOOK + textwrap.dedent(
    """
    import time
    from dynamo_tpu_torch.fleet import FleetObservatory
    from dynamo_tpu_torch.llm import components
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
    from dynamo_tpu_torch.runtime.telemetry import TelemetrySnapshot

    obs = FleetObservatory(MetricsRegistry())
    now = time.time()
    for seq in (1, 2):
        obs.ingest(TelemetrySnapshot(
            worker_id=3, role="decode", seq=seq, ts=now + seq, started_ts=now,
            step_count=seq, step_seconds=0.01 * seq, transfers=[
                {"src": 1, "dst": 3, "bytes": 4096 * seq, "seconds": 0.01 * seq}],
        ).to_dict())
    body, ctype = obs.render()
    assert b"dynamo_fleet_workers" in body and ctype.startswith("text/plain")
    assert obs.summary()["workers"][0]["worker_id"] == 3
    assert obs.predict_transfer_ms(8192, 1, 3) is not None
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
    assert not leaked, leaked
    print("ok")
    """
)


def test_fleet_observatory_renders_without_refused():
    out = subprocess.run(
        [sys.executable, "-c", FLEET, ",".join(REFUSED)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


# the Mixtral family, driven: an MoE model (int8, made layer by layer),
# one capacity dispatch and its dense ground truth, the memory plan, and a
# SentencePiece-style tokenizer.json (written here by hand) round trip
MIXTRAL = HOOK + textwrap.dedent(
    """
    import json
    import torch
    from dynamo_tpu_torch.engine import model
    from dynamo_tpu_torch.engine.config import ModelConfig
    from dynamo_tpu_torch.engine.memory_plan import plan_memory
    from dynamo_tpu_torch.llm.tokenizer import Tokenizer

    cfg = ModelConfig.tiny(num_experts=4, num_experts_per_tok=2)
    params = model.init_params(cfg, 0, torch.device("cpu"), quantize="int8")
    lp = {k: w[0] for k, w in params["layers"].items()}
    x = torch.randn(9, cfg.hidden_size)
    sparse, dense = model._moe_mlp(lp, x, cfg), model._moe_mlp_dense(lp, x, cfg)
    assert (sparse - dense).abs().max().item() < 1e-5
    plan = plan_memory(ModelConfig.mixtral_8x7b(), quantize="int8", hbm_bytes=80 * 2**30)
    assert plan.fits and plan.dequant_bytes > 0
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab["<0x%02X>" % b] = len(vocab)
    for c in ["\u2581"] + list("abcdefghijklmnopqrstuvwxyz"):
        vocab[c] = len(vocab)
    spec = {
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "\u2581"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "\u2581"}]},
        "pre_tokenizer": None,
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "\u2581"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "unk_token": "<unk>", "byte_fallback": True,
                  "fuse_unk": True, "vocab": vocab, "merges": [["\u2581", "a"]]},
        "added_tokens": [],
    }
    vocab["\u2581a"] = len(vocab)
    tok = Tokenizer.from_str(json.dumps(spec))
    text = "a cafe \u00e9t\u00e9 \U0001F600"
    ids = tok.encode(text)
    assert ids[0] == vocab["\u2581a"] and vocab["<0xF0>"] in ids
    assert tok.decode(ids) == text
    stream = tok.decode_stream()
    assert "".join(d for d in (stream.step(t) for t in ids) if d) == text
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
    assert not leaked, leaked
    print("ok")
    """
)


def test_mixtral_round_imports_nothing_refused():
    out = subprocess.run(
        [sys.executable, "-c", MIXTRAL, ",".join(REFUSED)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


# the planner, driven: one round over a hot worker (a scale-up through a
# LocalConnector, the dynamo_planner_* families minted, a JSONL log line
# written on the planner-log thread), then stopped
PLANNER = HOOK + textwrap.dedent(
    """
    import asyncio, json, os, tempfile
    from dynamo_tpu_torch.planner import LocalConnector, Planner, PlannerConfig
    from dynamo_tpu_torch.planner.profile_sla import SlaProfile
    from dynamo_tpu_torch.protocols.common import ForwardPassMetrics
    from dynamo_tpu_torch.runtime.metrics import default_registry

    async def handle():
        return object()

    async def main(log):
        conn = LocalConnector({"decode": handle})
        await conn.add_worker("decode")
        planner = Planner(
            conn, lambda: {0: ForwardPassMetrics(kv_total_blocks=8, gpu_cache_usage_perc=0.9)},
            cfg=PlannerConfig(adjustment_log_path=log))
        try:
            await asyncio.wait_for(planner.step(), 30)
        finally:
            await asyncio.wait_for(planner.stop(), 30)
        return conn.worker_count("decode")

    log = os.path.join(tempfile.mkdtemp(), "adjust.jsonl")
    assert asyncio.run(main(log)) == 2
    with open(log) as f:
        assert json.loads(f.read())["action"] == "up"
    reg = default_registry()
    assert reg.sample("dynamo_planner_adjustments", {"kind": "decode", "action": "up"}) == 1.0
    assert reg.sample("dynamo_planner_pool_size", {"kind": "decode"}) == 2.0
    assert SlaProfile(itl_ms={1: 2.0}).recommend(None, 1.0)["max_batch_within_itl_slo"] is None
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
    assert not leaked, leaked
    print("ok")
    """
)


def test_planner_round_and_profile_sla_import_nothing_refused():
    out = subprocess.run(
        [sys.executable, "-c", PLANNER, ",".join(REFUSED)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
    prof = subprocess.run(
        [sys.executable, "-c", SERVE, ",".join(REFUSED), "profile-sla", "--out", "mocker",
         "--isl", "8,16", "--batch", "1,2", "--osl", "8"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "DYN_LOG": "warning"},
    )
    assert prof.returncode == 0, prof.stderr
    body, leaked = prof.stdout.rsplit("leaked", 1)
    assert leaked.strip() == "[]"
    assert set(json.loads(body)) == {"profile", "recommendation"}


def test_fleet_routes_and_subcommands_import_nothing_refused():
    """A hub, a mocker worker and the KV-routed front end under the hook:
    ``GET /fleet`` and ``GET /fleet/metrics`` answer, ``fleet --once`` and
    ``metrics`` run, and no process loaded a refused package."""
    import time

    procs = []

    def start(*args):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", SERVE, ",".join(REFUSED), *args],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "DYN_LOG": "warning"},
        ))
        return procs[-1]

    try:
        hub = start("hub", "--host", "127.0.0.1", "--port", "0")
        addr = hub.stdout.readline().split()[2]
        worker = start("run", "in=dyn", "out=mocker", "--hub", addr)
        assert worker.stdout.readline().startswith("worker serving on")
        front = start("run", "in=http", "out=dyn", "--hub", addr, "--router-mode", "kv",
                      "--port", "0")
        url = front.stdout.readline().split()[2]
        deadline = time.monotonic() + 60
        while True:
            with urllib.request.urlopen(url + "/fleet", timeout=10) as resp:
                if json.loads(resp.read())["workers"]:
                    break
            assert time.monotonic() < deadline, "no worker on /fleet"
            time.sleep(0.2)
        with urllib.request.urlopen(url + "/fleet/metrics", timeout=10) as resp:
            assert b'dynamo_fleet_workers{role="worker"} 1.0' in resp.read()
        fleet = subprocess.run(
            [sys.executable, "-c", SERVE, ",".join(REFUSED), "fleet", "--hub", addr,
             "--once", "--interval", "1.5"],
            cwd=ROOT, capture_output=True, text=True, timeout=60,
            env={**os.environ, "DYN_LOG": "warning"},
        )
        assert fleet.returncode == 0, fleet.stderr
        assert "fleet: 1 worker" in fleet.stdout and "leaked []" in fleet.stdout
        metrics = start("metrics", "--hub", addr, "--host", "127.0.0.1", "--port", "0")
        murl = metrics.stdout.readline().split()[3]
        with urllib.request.urlopen(murl, timeout=10) as resp:
            assert b"llm_kv_blocks_total" in resp.read()
        for p in (metrics, front, worker, hub):
            p.send_signal(signal.SIGINT)
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err
            assert "leaked []" in out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)


def _checkpoint(model_dir: str, path: str) -> str:
    """A checkpoint directory: model_dir's tokenizer and config, and random
    weights under HuggingFace names written by ``safetensors``."""
    os.makedirs(path)
    for f in ("tokenizer.json", "tokenizer_config.json", "config.json"):
        shutil.copy(os.path.join(model_dir, f), path)
    cfg = ModelConfig.from_pretrained(path)
    p = init_params(cfg, 0, torch.device("cpu"))
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    sd = {
        "model.embed_tokens.weight": p["embed"],
        "model.norm.weight": p["final_norm"],
        "lm_head.weight": p["lm_head"].T.contiguous(),
    }
    for i in range(cfg.num_layers):
        for key, name in names.items():
            sd[f"model.layers.{i}.{name}.weight"] = p["layers"][key][i].T.contiguous()
        sd[f"model.layers.{i}.input_layernorm.weight"] = p["layers"]["input_norm"][i]
        sd[f"model.layers.{i}.post_attention_layernorm.weight"] = p["layers"]["post_norm"][i]
    save_file({k: v.contiguous() for k, v in sd.items()},
              os.path.join(path, "model.safetensors"))
    return path


def test_http_server_imports_nothing_refused(model_dir, tmp_path):
    ckpt = _checkpoint(model_dir, str(tmp_path / "ckpt"))
    proc = subprocess.Popen(
        [sys.executable, "-c", SERVE, ",".join(REFUSED), "run", "in=http",
         "out=torch", "--model-path", ckpt, "--model-name", "m", "--port", "0",
         "--device", "cpu", "--max-seq-len", "256", "--num-pages", "64"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "DYN_LOG": "warning"},
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving m at http://"), (line, proc.stderr.read())
        url = line.split()[3]
        req = urllib.request.Request(
            url + "/v1/chat/completions",
            data=json.dumps({"model": "m", "max_tokens": 5, "ignore_eos": True, "messages": [
                {"role": "user", "content": "hello"}]}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
        assert body["usage"]["completion_tokens"] == 5
        assert body["choices"][0]["finish_reason"] == "length"
        req = urllib.request.Request(
            url + "/v1/embeddings",
            data=json.dumps({"model": "m", "input": ["hello", "world!"]}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
        assert [d["index"] for d in body["data"]] == [0, 1]
        assert all(abs(sum(x * x for x in d["embedding"]) - 1.0) < 1e-4 for d in body["data"])
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        assert "leaked []" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)


def test_distributed_serving_imports_nothing_refused(model_dir, tmp_path):
    """``hub``, ``run in=dyn out=torch`` and ``run in=http out=dyn
    --router-mode kv``, each under the hook: a chat completion and an
    embedding through hub, KV router and worker, then SIGINT; no process
    loaded a refused package."""
    import time

    ckpt = _checkpoint(model_dir, str(tmp_path / "ckpt"))
    procs = []

    def start(*args):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", SERVE, ",".join(REFUSED), *args],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "DYN_LOG": "warning"},
        ))
        return procs[-1]

    def post(url, body):
        req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    try:
        hub = start("hub", "--host", "127.0.0.1", "--port", "0")
        line = hub.stdout.readline()
        assert line.startswith("hub at 127.0.0.1:"), line
        addr = line.split()[2]
        worker = start("run", "in=dyn", "out=torch", "--model-path", ckpt, "--model-name", "m",
                       "--device", "cpu", "--max-seq-len", "256", "--num-pages", "64",
                       "--hub", addr)
        assert worker.stdout.readline().startswith("worker serving model m")
        front = start("run", "in=http", "out=dyn", "--hub", addr, "--router-mode", "kv",
                      "--port", "0")
        url = front.stdout.readline().split()[2]
        deadline = time.monotonic() + 60
        while True:
            with urllib.request.urlopen(url + "/v1/models", timeout=10) as resp:
                if json.loads(resp.read())["data"]:
                    break
            assert time.monotonic() < deadline, "model never discovered"
            time.sleep(0.1)
        body = post(url + "/v1/chat/completions", {
            "model": "m", "max_tokens": 5, "ignore_eos": True,
            "messages": [{"role": "user", "content": "hello"}]})
        assert body["usage"]["completion_tokens"] == 5
        body = post(url + "/v1/embeddings", {"model": "m", "input": ["hello"]})
        assert abs(sum(x * x for x in body["data"][0]["embedding"]) - 1.0) < 1e-4
        for p in (front, worker, hub):
            p.send_signal(signal.SIGINT)
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err
            assert "leaked []" in out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
