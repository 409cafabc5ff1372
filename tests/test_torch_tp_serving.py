"""Tensor- and expert-parallel serving on the port, held to one card and to
the JAX tp engine (the counterparts of ``tests/test_tp_serving.py`` and
``tests/test_parallel_serving.py``).

Every sharded engine here is a leader in this process with follower
ranks it starts itself (``--device cpu``: one process per rank, gloo,
a ``file://`` rendezvous); every asyncio run, process wait and
``communicate`` is bounded.  The weights are the JAX ``init_params`` of
the tiny f32 model, crossed by ``params_from_numpy`` and scattered to the
ranks by the leader.

* Greedy streams of the port at tp=2 (``ModelConfig.tiny()``) and at tp=4
  (``num_kv_heads=4``) equal the port's tp=1 engine's and the JAX tp
  engine's; seeded lanes equal across tp too.
* After the same requests, every rank's pool equals the tp=1 pool's head
  slice (f32: within 1e-6 of the pool's largest magnitude, the all-reduce
  summing the partial products in another order than one card's product;
  layer 0, upstream of any all-reduce, bit for bit; an int8 pool's data bit for
  bit and its row scales, reduced with a max over the tp group, within
  1e-6 relative) under the default, classic and rectangle configs, the
  int8 pool and int8 weights.
* ep=2 and ep=4 MoE greedy streams equal the unsharded engines' (port and
  JAX); at a binding capacity every rank counts the dropped assignments
  one card counts.
* A tp=2 prefiller's export is full width, stamped ``{"axis": 4, "parts":
  2}``, has the wire size, shape and dtype of a tp=1 and of the JAX tp=2
  prefiller's export, equals the tp=1 export (layer 0 byte for byte, the
  rest within the pool tolerance) and JAX's (within 1e-5), and decodes on
  a one-card engine into the aggregated stream.
* Refused by name: the offload plane, G4, the model drafter, dp, sp, pp,
  a tp that does not divide the heads, an ep that does not divide the
  experts, NCCL ranks on cards, importing a remote prefill and the block
  export of prefix onboarding.
* A killed follower fails the leader's request within the groups' timeout
  and stops the engine; later requests fail at once.
* ``run in=http out=torch --device cpu --tp 2`` and two ``--num-nodes 2``
  processes answer chats as an in-process tp=1 engine does (a bf16
  checkpoint: the same tokens, or the same up to a near tie of one
  card's two best tokens, with the same finish and usage).
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.metrics import MetricsRegistry as JaxRegistry
from dynamo_tpu_torch.engine import model as port_model
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.parallel.mesh import MeshConfig
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from tests.test_torch_ops import _free_compiled_programs  # noqa: F401 (autouse)

RUN_S = 180  # bound on any one asyncio.run
WAIT_S = 120  # bound on any process wait
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(max_batch_size=4, max_seq_len=64, page_size=4, num_pages=64, seed=0)
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [3, 3, 3, 3, 3, 3, 3, 3], [5, 1]]
# f32 pools and exports of a sharded engine against one card's: within
# this share of the largest magnitude (the all-reduces sum the partial
# products in another order than one card's product does)
TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread_a_rank(monkeypatch):
    """The follower and CLI processes these tests start inherit one torch
    thread each: tiny models need no more, and eight threads a process
    beside the suite's other workers would starve the host."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(autouse=True)
def _free_jax_programs():
    """The JAX tp engines here compile sharded programs no other module
    reuses; each holds memory mappings of its own, and a worker that keeps
    them all can reach the kernel's mapping limit in a later module's
    compile.  Free them after each test."""
    yield
    jax.clear_caches()


def request(tokens, max_tokens=6, **sampling) -> dict:
    return {
        "token_ids": list(tokens),
        "stop_conditions": {"max_tokens": max_tokens},
        "sampling_options": {"temperature": 0.0, **sampling},
        "eos_token_ids": [],
    }


def seeded(tokens, seed) -> dict:
    return request(tokens, temperature=1.0, top_p=0.9, seed=seed)


async def collect(engine, req: dict) -> list:
    async def body():
        if isinstance(engine, JaxEngine):
            stream = await engine.generate(JaxContext.new(JaxRequest.from_dict(req)))
        else:
            stream = await engine.generate(Context.new(PreprocessedRequest.from_dict(req)))
        toks = []
        async for item in stream:
            assert not item.is_error(), item.error_message()
            toks += (item.data or {}).get("token_ids") or []
        return toks

    return await asyncio.wait_for(body(), RUN_S)


def weights(**overrides):
    jcfg = JaxModelConfig.tiny(**overrides)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, ModelConfig.tiny(**overrides), np_params


def port_engine(cfg, np_params, mesh=None, **kw):
    """tp from ``kw`` or an ep/tp grid from ``mesh``: the engine starts
    its ranks and scatters the weights to them."""
    return TorchEngine(
        cfg, params_from_numpy(np_params, cfg, device="cpu"), EngineConfig(**{**BASE, **kw}),
        device="cpu", metrics_registry=MetricsRegistry(), mesh=mesh,
    )


def jax_engine(jcfg, jparams, **kw):
    return JaxEngine(jcfg, jparams, JaxEngineConfig(**{**BASE, **kw}),
                     metrics_registry=JaxRegistry())


async def serve_each(engine, reqs):
    """The requests one after another (the same pages on every engine)."""
    return [await collect(engine, r) for r in reqs]


async def serve_batch(engine, reqs):
    return list(await asyncio.gather(*[collect(engine, r) for r in reqs]))


def assert_pools_match(one, ranks, tp):
    """Every rank's pool against the tp=1 pool's head slice (trash page 0
    aside: duplicate dead-row writes land there in any order)."""
    assert len(ranks) == tp
    if isinstance(one, tuple):
        q1, s1 = one
        w = q1.shape[4] // tp
        for r, (q, s) in enumerate(ranks):
            assert torch.equal(q[:, :, 1:], q1[:, :, 1:, :, r * w:(r + 1) * w])
            torch.testing.assert_close(s[:, :, 1:], s1[:, :, 1:], atol=0.0, rtol=1e-6)
        return
    w = one.shape[4] // tp
    for r, p in enumerate(ranks):
        want = one[:, :, 1:, :, r * w:(r + 1) * w]
        assert torch.equal(p[0, :, 1:], want[0]), "layer 0 is upstream of every all-reduce"
        assert (p[:, :, 1:] - want).abs().max() <= TOL * want.abs().max()


# -- streams and pools ------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_greedy_equals_tp1_and_jax(run, tp):
    over = {} if tp == 2 else {"num_kv_heads": 4}
    jcfg, jparams, cfg, np_params = weights(**over)

    async def body():
        one = port_engine(cfg, np_params)
        try:
            want = await serve_each(one, [request(p) for p in PROMPTS])
            pool1 = one.rank_pools()[0]
        finally:
            await one.stop()
        sharded = port_engine(cfg, np_params, tp=tp)
        try:
            assert sharded.kv.shard_geometry == {"axis": 4, "parts": tp}
            assert sharded.status()["mesh"]["backend"] == "gloo"
            assert await serve_each(sharded, [request(p) for p in PROMPTS]) == want
            assert_pools_match(pool1, sharded.rank_pools(), tp)
            stats = sharded.rank_stats()
            assert [s["collectives"] for s in stats[1:]] == [stats[0]["collectives"]] * (tp - 1)
            assert all(s["graphs"] == {"captures": 0, "replays": 0} for s in stats)
        finally:
            await sharded.stop()
        jx = jax_engine(jcfg, jparams, tp=tp)
        try:
            assert await serve_batch(jx, [request(p) for p in PROMPTS]) == want
        finally:
            await jx.stop()

    run(body())


def test_seeded_lanes_equal_across_tp(run):
    """Seeded lanes draw from a counter hash of (key, position): every tp
    gives the tokens of one card (the port's hash is its own, so this is
    held to the port's tp=1 engine, as JAX's holds its tp=1 engine)."""
    _, _, cfg, np_params = weights()
    reqs = [seeded(p, 11 + i) for i, p in enumerate(PROMPTS)]

    async def body():
        one = port_engine(cfg, np_params)
        try:
            want = await serve_batch(one, reqs)
        finally:
            await one.stop()
        sharded = port_engine(cfg, np_params, tp=2)
        try:
            assert await serve_batch(sharded, reqs) == want
        finally:
            await sharded.stop()

    run(body())


CONFIGS = {
    "classic": dict(mixed_batching=False, prefill_chunk_tokens=8),
    "rectangle": dict(packed_ragged=False),
    "int8-pool": dict(kv_dtype="int8"),
    "int8-weights": dict(quantize="int8"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp2_configs_match_tp1(run, name):
    _, _, cfg, np_params = weights()
    kw = CONFIGS[name]
    reqs = [request(p, max_tokens=8) for p in PROMPTS + [list(range(1, 20))]]

    async def body():
        one = port_engine(cfg, np_params, **kw)
        try:
            want = await serve_each(one, reqs)
            pool1 = one.rank_pools()[0]
        finally:
            await one.stop()
        sharded = port_engine(cfg, np_params, tp=2, **kw)
        try:
            assert await serve_each(sharded, reqs) == want
            assert_pools_match(pool1, sharded.rank_pools(), 2)
        finally:
            await sharded.stop()

    run(body())


# -- expert parallelism -------------------------------------------------------------

MOE = dict(num_experts=4, num_experts_per_tok=2, moe_capacity_factor=4.0)


@pytest.mark.parametrize("ep", [2, 4])
def test_ep_moe_equals_unsharded(run, ep):
    jcfg, jparams, cfg, np_params = weights(**MOE)
    prompt = [7, 1, 8, 2, 8, 1, 8]

    async def body():
        jx = jax_engine(jcfg, jparams)
        try:
            want = await collect(jx, request(prompt))
        finally:
            await jx.stop()
        one = port_engine(cfg, np_params)
        try:
            assert await collect(one, request(prompt)) == want
        finally:
            await one.stop()
        sharded = port_engine(cfg, np_params, mesh=MeshConfig(ep=ep))
        try:
            assert sharded.params["layers"]["w_gate"].shape[1] == 4 // ep
            assert await collect(sharded, request(prompt)) == want
        finally:
            await sharded.stop()

    run(body())


def test_ep_drops_equal_one_card_at_a_binding_capacity(run):
    jcfg, jparams, cfg, np_params = weights(
        num_experts=4, num_experts_per_tok=2, moe_capacity_factor=0.5
    )
    reqs = [request(p, max_tokens=5) for p in PROMPTS]

    async def body():
        one = port_engine(cfg, np_params)
        port_model.moe_counts(torch.device("cpu"), reset=True)
        try:
            want = await serve_each(one, reqs)
            drops = port_model.moe_counts(torch.device("cpu"), reset=True)[1]
        finally:
            await one.stop()
        assert drops > 0
        sharded = port_engine(cfg, np_params, mesh=MeshConfig(ep=2))
        try:
            sharded.reset_rank_stats()
            assert await serve_each(sharded, reqs) == want
            assert [s["moe_drops"] for s in sharded.rank_stats()] == [drops, drops]
        finally:
            await sharded.stop()

    run(body())


# -- the disaggregated export ---------------------------------------------------------


def test_disagg_export_from_a_tp2_prefiller(run):
    jcfg, jparams, cfg, np_params = weights()
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]

    async def export(engine, jax_side=False):
        req = (JaxRequest if jax_side else PreprocessedRequest).from_dict(request(prompt))
        (stream,) = await asyncio.wait_for(engine.prefill_export_batch_stream([req]), RUN_S)
        assert not isinstance(stream, Exception), stream
        blob = await asyncio.wait_for(stream.assemble(), RUN_S)
        return stream, np.asarray(blob)

    async def body():
        one = port_engine(cfg, np_params)
        try:
            agg = await collect(one, request(prompt))
            s1, b1 = await export(one)
        finally:
            await one.stop()
        jx = jax_engine(jcfg, jparams, tp=2)
        try:
            sj, bj = await export(jx, jax_side=True)
        finally:
            await jx.stop()
        sharded = port_engine(cfg, np_params, tp=2)
        try:
            s2, b2 = await export(sharded)
        finally:
            await sharded.stop()
        assert s2.shards == sj.shards == {"axis": 4, "parts": 2} and s1.shards is None
        for s, b in ((s1, b1), (sj, bj)):
            assert (b2.shape, b2.dtype, s2.nbytes, s2.dtype) == (b.shape, b.dtype, s.nbytes, s.dtype)
        # against one card of the port: layer 0 (upstream of every
        # all-reduce) byte for byte, the rest within the pool tolerance;
        # against JAX's tp=2 export: the port-vs-JAX export tolerance of
        # the disaggregation tests (1e-5, f32)
        assert b2[0].tobytes() == b1[0].tobytes()
        assert np.abs(b2 - b1).max() <= TOL * np.abs(b1).max()
        np.testing.assert_allclose(b2, bj, atol=1e-5, rtol=1e-5)
        assert int(s2.row[0]) == int(s1.row[0]) == int(np.asarray(sj.row).reshape(-1)[0])
        decode = port_engine(cfg, np_params)
        try:
            r = request(prompt)
            ctx = Context.new(PreprocessedRequest.from_dict(r))
            stream = await decode.generate_external(ctx)
            assert decode.deliver_external(ctx.id, b2, int(s2.row[0]))
            toks = []
            async for item in stream:
                assert not item.is_error(), item.error_message()
                toks += (item.data or {}).get("token_ids") or []
            assert toks == agg
        finally:
            await decode.stop()

    run(body())


# -- refusals -------------------------------------------------------------------------

REFUSALS = {
    "offload-host": (dict(tp=2, host_offload_blocks=8), None, "EngineConfig.tp=2 with host_offload_blocks"),
    "offload-disk": (dict(tp=2, disk_offload_blocks=8, disk_offload_dir="/x"), None,
                     "disk_offload_blocks"),
    "g4": (dict(tp=2, kv_remote="on"), None, "kv_remote"),
    "drafter": (dict(tp=2, draft_model="random"), None, "draft_model"),
    "ep-offload": (dict(host_offload_blocks=8), MeshConfig(ep=2), "ep=2 with host_offload_blocks"),
    "dp": (dict(dp=2), None, "EngineConfig.dp"),
    "sp": ({}, MeshConfig(sp=2), "sp=2: not served"),
    "pp": ({}, MeshConfig(pp=2), "pp=2: not served"),
    "tp3": (dict(tp=3), None, "tp=3 does not divide num_heads=4"),
    "tp4": (dict(tp=4), None, "num_kv_heads"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refused_by_name_before_any_rank_starts(name):
    _, _, cfg, np_params = weights()
    kw, mesh, match = REFUSALS[name]
    with pytest.raises(ValueError, match=match):
        port_engine(cfg, np_params, mesh=mesh, **kw)


def test_ep_that_does_not_divide_the_experts_is_refused_before_any_rank_starts():
    """E = 4 at ep = 3: refused by name at construction (a rank would hold
    no equal share of the experts), before a follower starts."""
    cfg = ModelConfig.tiny(num_experts=4, num_experts_per_tok=2)
    params = port_model.init_params(cfg, 0, torch.device("cpu"), torch.float32)
    with pytest.raises(ValueError, match="ep=3 does not divide num_experts=4"):
        TorchEngine(cfg, params, EngineConfig(**BASE), device="cpu",
                    metrics_registry=MetricsRegistry(), mesh=MeshConfig(ep=3))


def test_killed_follower_fails_requests_and_stops_the_engine(run, monkeypatch):
    monkeypatch.setenv("DYN_DIST_TIMEOUT_S", "20")
    _, _, cfg, np_params = weights()

    async def body():
        engine = port_engine(cfg, np_params, tp=2)
        try:
            for what, call in (
                ("importing a remote prefill", lambda: engine.generate_external(
                    Context.new(PreprocessedRequest.from_dict(request([1, 2]))))),
                ("block export", lambda: engine.export_blocks([1])),
            ):
                with pytest.raises(ValueError, match=what):
                    await call()
            assert await collect(engine, request([1, 2, 3]))  # serving
            engine._ranks.procs[1].kill()
            t0 = time.monotonic()
            stream = await engine.generate(Context.new(PreprocessedRequest.from_dict(
                request([4, 5, 6], max_tokens=40))))
            errors = []

            async def drain():
                async for item in stream:
                    if item.is_error():
                        errors.append(item.error_message())

            await asyncio.wait_for(drain(), 60)
            assert errors and time.monotonic() - t0 < 60
            assert engine.mesh_error is not None
            again = await engine.generate(Context.new(PreprocessedRequest.from_dict(request([7]))))
            items = [item async for item in again]
            assert items[0].is_error() and "engine stopped" in items[0].error_message()
        finally:
            await asyncio.wait_for(engine.stop(), RUN_S)

    run(body())


# -- the command line -------------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(model_dir, tmp_path_factory):
    """An f32 checkpoint of the model directory's config (seed 0)."""
    from safetensors.torch import save_file

    from dynamo_tpu_torch.engine.model import init_params

    path = str(tmp_path_factory.mktemp("tp-ckpt"))
    for f in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(model_dir, f), path)
    with open(os.path.join(model_dir, "config.json")) as f:
        conf = json.load(f)
    conf["torch_dtype"] = "float32"
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(conf, f)
    cfg = ModelConfig.from_pretrained(path)
    p = init_params(cfg, 0, torch.device("cpu"))
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
             "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    sd = {"model.embed_tokens.weight": p["embed"], "model.norm.weight": p["final_norm"]}
    if "lm_head" in p:
        sd["lm_head.weight"] = p["lm_head"].T
    for i in range(cfg.num_layers):
        for key, name in names.items():
            sd[f"model.layers.{i}.{name}.weight"] = p["layers"][key][i].T
        sd[f"model.layers.{i}.input_layernorm.weight"] = p["layers"]["input_norm"][i]
        sd[f"model.layers.{i}.post_attention_layernorm.weight"] = p["layers"]["post_norm"][i]
    save_file({k: v.contiguous() for k, v in sd.items()}, os.path.join(path, "model.safetensors"))
    return path


CHATS = ["hello", "tell me a story about the quick brown fox"]
# a checkpoint serves in bf16 (the config's dtype): the tp all-reduces round
# partial sums where one card rounds once, so a greedy stream may leave
# one card's only at a near tie of its two best tokens -- a logprob gap
# within a few bf16 steps of logits of order one (the bf16 rule of the
# port's card checks)
BF16_TIE = 2.0**-5


def chat(url: str, text: str) -> dict:
    req = urllib.request.Request(
        url + "/v1/chat/completions",
        data=json.dumps({"model": "m", "max_tokens": 6, "temperature": 0.0, "ignore_eos": True,
                         "logprobs": True, "top_logprobs": 2,
                         "messages": [{"role": "user", "content": text}]}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        body = json.loads(resp.read())
    choice = body["choices"][0]
    steps = choice["logprobs"]["content"]
    return {"tokens": [s["token"] for s in steps],
            "top2": [[t["logprob"] for t in s["top_logprobs"]] for s in steps],
            "finish": choice["finish_reason"], "usage": body["usage"]}


def assert_chats_agree(got, want):
    """Equal usage and finish; equal tokens, or tokens that part from one
    card's at a bf16 near tie (and are not compared after it)."""
    for g, w in zip(got, want, strict=True):
        assert (g["finish"], g["usage"]) == (w["finish"], w["usage"])
        j = next((j for j, (a, b) in enumerate(zip(g["tokens"], w["tokens"])) if a != b), None)
        if j is not None:
            a, b = w["top2"][j]
            assert abs(a - b) <= BF16_TIE, (j, g["tokens"], w["tokens"], w["top2"][j])


@pytest.fixture(scope="module")
def tp1_chats(checkpoint):
    """The chats of an in-process tp=1 engine behind the port's service."""
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.http.service import HttpService, ModelManager

    args = cli.build_parser().parse_args(
        ["run", "in=http", "out=torch", "--model-path", checkpoint, "--model-name", "m",
         "--device", "cpu", "--max-seq-len", "256", "--num-pages", "64"]
    )
    args.inp, args.out = "http", "torch"

    async def body():
        engine, name, _tok, pipeline = cli._pipeline(args)
        manager = ModelManager()
        manager.add_chat_model(name, pipeline)
        service = HttpService(manager, host="127.0.0.1", port=0)
        await service.start()
        try:
            return [await asyncio.to_thread(chat, service.url, t) for t in CHATS]
        finally:
            await service.stop()
            await engine.stop()

    return asyncio.run(asyncio.wait_for(body(), RUN_S))


def _serve(*argv):
    return subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch", "run", "in=http", "out=torch", *argv],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "DYN_LOG": "warning", "DYN_DIST_TIMEOUT_S": "60"},
    )


def _stop(procs):
    outs = []
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGINT)
    for p in procs:
        try:
            outs.append(p.communicate(timeout=WAIT_S))
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate(timeout=30))
    return outs


def test_cli_tp2_answers_chats_like_tp1(checkpoint, tp1_chats):
    proc = _serve("--model-path", checkpoint, "--model-name", "m", "--port", "0",
                  "--device", "cpu", "--max-seq-len", "256", "--num-pages", "64", "--tp", "2")
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving m at http://"), (line, proc.stderr.read())
        url = line.split()[3]
        got = [chat(url, t) for t in CHATS]
        assert_chats_agree(got, tp1_chats)
        assert all(g["finish"] == "length" and g["usage"]["completion_tokens"] == 6 for g in got)
    finally:
        (out, err), = _stop([proc])
    assert proc.returncode == 0, err


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_two_nodes_answer_chats_like_tp1(checkpoint, tp1_chats):
    leader = f"127.0.0.1:{_free_port()}"
    common = ("--model-path", checkpoint, "--model-name", "m", "--device", "cpu",
              "--max-seq-len", "256", "--num-pages", "64", "--tp", "2", "--num-nodes", "2",
              "--leader-addr", leader)
    node1 = _serve(*common, "--node-rank", "1")
    node0 = _serve(*common, "--node-rank", "0", "--port", "0")
    try:
        line = node1.stdout.readline()
        assert line.startswith("follower ranks of node 1"), (line, node1.stderr.read())
        line = node0.stdout.readline()
        assert line.startswith("serving m at http://"), (line, node0.stderr.read())
        assert_chats_agree([chat(line.split()[3], t) for t in CHATS], tp1_chats)
    finally:
        # the leader's stop ends the follower node's loop: it exits alone
        (out0, err0), = _stop([node0])
        try:
            out1, err1 = node1.communicate(timeout=WAIT_S)
        except subprocess.TimeoutExpired:
            (out1, err1), = _stop([node1])
    assert node0.returncode == 0, err0
    assert node1.returncode == 0, err1


@pytest.mark.parametrize("argv, name", [
    (["--dp", "2"], "--dp"),
    (["--sp", "2"], "--sp"),
    (["--pp", "2"], "--pp"),
    (["--tp", "2", "--host-offload-blocks", "8"], "--host-offload-blocks"),
    (["--ep", "2", "--draft-model", "random"], "--draft-model"),
    (["--tp", "3"], "--tp 3: tp=3 does not divide num_heads=4"),
])
def test_cli_refuses_by_name(checkpoint, argv, name):
    from dynamo_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["run", "in=http", "out=torch", "--model-path", checkpoint, "--device", "cpu", *argv]
    )
    args.inp, args.out = "http", "torch"
    with pytest.raises(SystemExit, match=name):
        cli._check_served(args)
        cli._rank_plan(args, torch.device("cpu"))


def test_cli_refuses_nccl_ranks_by_name(checkpoint, monkeypatch):
    """With the cards there, ``--tp 2`` on them is still refused by name:
    NCCL ranks are not served yet."""
    from dynamo_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["run", "in=http", "out=torch", "--model-path", checkpoint, "--tp", "2"]
    )
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit, match="--tp 2 --ep 1: tp and ep over NCCL"):
        cli._rank_plan(args, torch.device("cuda"))


def test_cli_refuses_more_ranks_than_cards(checkpoint):
    """On a card, ``--tp N`` needs N cards (JAX's message); this host
    has fewer than 2."""
    from dynamo_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["run", "in=http", "out=torch", "--model-path", checkpoint, "--tp", "2"]
    )
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have >= 2:
        pytest.skip("this host has the cards")
    with pytest.raises(SystemExit, match=f"mesh needs 2 devices, have {have}"):
        cli._rank_plan(args, torch.device("cuda"))

