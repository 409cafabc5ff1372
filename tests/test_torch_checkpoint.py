"""Checkpoint loading and the command line of the port, against the JAX
package.

* The port's safetensors reader against files the ``safetensors`` package
  writes (numpy and torch front ends; f32, f16 and bf16).
* ``ModelConfig.from_pretrained`` gives the JAX config field for field, on
  several ``config.json`` shapes (Llama 3 with RoPE scaling, Qwen2 with and
  without its window, Gemma, Phi-3) and refuses what the JAX one refuses.
* ``TorchEngine.from_pretrained(dir, device="cpu")`` loads the parameters
  that ``params_from_numpy`` makes of the JAX loader's pytree, for a plain
  and a Phi-3 (fused projections) checkpoint.
* ``python -m dynamo_tpu_torch run in=text|batch out=torch --device cpu``
  prints the JAX pipeline's greedy text for the same checkpoint, a refused
  flag exits non-zero naming it, and with no card and no ``--device`` the
  command refuses to run.
* The distributed command line: ``hub``, ``run in=dyn`` (aggregated, and
  the ``--disagg decode|prefill`` roles with ``disagg-conf``), ``run
  in=http out=dyn`` and ``llmctl`` as processes give the JAX pipeline's
  texts; its flags parse like the JAX CLI's.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as save_numpy
from safetensors.torch import save_file as save_torch

from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.engine.weights import load_safetensors_params as jax_load
from dynamo_tpu.llm.backend import Backend as JaxBackend
from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as JaxPreprocessor
from dynamo_tpu.llm.tokenizer import Tokenizer as JaxTokenizer
from dynamo_tpu.protocols.openai import ChatCompletionRequest
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.engine import as_response_stream as jax_stream
from dynamo_tpu.runtime.pipeline import link as jax_link
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import SafetensorsFile, params_from_numpy
from tests.test_torch_ops import _free_compiled_programs  # noqa: F401 (autouse)

RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ["hello world", "tell me a story about the quick brown fox"]
MAX_TOKENS = 8


def hf_state_dict(np_params, cfg) -> dict:
    """The JAX pytree under HuggingFace Llama names, ``[out, in]``."""
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    out = {
        "model.embed_tokens.weight": np_params["embed"],
        "model.norm.weight": np_params["final_norm"],
        "lm_head.weight": np_params["lm_head"].T,
    }
    lay = np_params["layers"]
    for i in range(cfg.num_layers):
        for key, name in names.items():
            out[f"model.layers.{i}.{name}.weight"] = lay[key][i].T
        out[f"model.layers.{i}.input_layernorm.weight"] = lay["input_norm"][i]
        out[f"model.layers.{i}.post_attention_layernorm.weight"] = lay["post_norm"][i]
    return out


def fuse_phi3(sd: dict, layers: int) -> dict:
    sd = dict(sd)
    for i in range(layers):
        p = f"model.layers.{i}."
        sd[p + "self_attn.qkv_proj.weight"] = np.concatenate(
            [sd.pop(p + f"self_attn.{x}_proj.weight") for x in "qkv"]
        )
        sd[p + "mlp.gate_up_proj.weight"] = np.concatenate(
            [sd.pop(p + "mlp.gate_proj.weight"), sd.pop(p + "mlp.up_proj.weight")]
        )
    return sd


def to_torch(arr) -> torch.Tensor:
    a = np.array(arr, order="C")  # keeps a 0-d array 0-d
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def write_checkpoint(dirpath, model_dir, sd: dict) -> str:
    os.makedirs(dirpath, exist_ok=True)
    for f in ("tokenizer.json", "tokenizer_config.json", "config.json"):
        shutil.copy(os.path.join(model_dir, f), dirpath)
    names = sorted(sd)
    half = len(names) // 2  # two shards
    for k, part in enumerate((names[:half], names[half:])):
        save_torch({n: to_torch(sd[n]) for n in part},
                   os.path.join(dirpath, f"model-0000{k + 1}.safetensors"))
    return str(dirpath)


@pytest.fixture(scope="module")
def checkpoint(model_dir, tmp_path_factory):
    """A bf16 Llama checkpoint directory (the config.json of ``model_dir``)
    made from the JAX ``init_params`` of seed 0."""
    jcfg = JaxModelConfig.from_pretrained(model_dir)
    np_params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    path = write_checkpoint(
        tmp_path_factory.mktemp("ckpt"), model_dir, hf_state_dict(np_params, jcfg)
    )
    return path, jcfg, np_params


# -- the safetensors reader -------------------------------------------------------


@pytest.mark.parametrize("writer", ["numpy", "torch"])
def test_safetensors_reader_matches_package(tmp_path, writer):
    rs = np.random.RandomState(0)
    tensors = {
        "a.f32": rs.randn(3, 5).astype(np.float32),
        "b.f16": rs.randn(7).astype(np.float16),
        "c.bf16": rs.randn(4, 2, 3).astype(ml_dtypes.bfloat16),
        "d.scalar": np.asarray(rs.randn(1).astype(np.float32)[0]),
        "e.empty": np.zeros((0, 4), np.float32),
    }
    path = str(tmp_path / "x.safetensors")
    if writer == "numpy":
        save_numpy({k: v for k, v in tensors.items() if k != "c.bf16"}, path)
        tensors.pop("c.bf16")
    else:
        save_torch({k: to_torch(v) for k, v in tensors.items()}, path)
    f = SafetensorsFile(path)
    assert sorted(f.keys()) == sorted(tensors)
    for name, want in tensors.items():
        got = f.get(name)
        assert tuple(got.shape) == want.shape
        assert torch.equal(got, to_torch(want)), name


def test_safetensors_reader_refuses_other_dtypes(tmp_path):
    path = str(tmp_path / "x.safetensors")
    save_numpy({"i": np.arange(4, dtype=np.int32)}, path)
    with pytest.raises(ValueError, match="I32"):
        SafetensorsFile(path).get("i")


# -- ModelConfig.from_pretrained ----------------------------------------------------

BASE = {"vocab_size": 300, "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4}
HF_CONFIGS = {
    "llama3": {**BASE, "model_type": "llama", "num_key_value_heads": 2,
               "rope_theta": 500000.0, "max_position_embeddings": 8192,
               "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                                "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                "original_max_position_embeddings": 8192}},
    "qwen2": {**BASE, "model_type": "qwen2", "sliding_window": 4096,
              "tie_word_embeddings": True},
    "qwen2-window": {**BASE, "model_type": "qwen2", "sliding_window": 64,
                     "use_sliding_window": True, "max_window_layers": 2},
    "mistral": {**BASE, "model_type": "mistral", "sliding_window": 128},
    "gemma": {**BASE, "model_type": "gemma", "head_dim": 32,
              "hidden_activation": "gelu_pytorch_tanh"},
    "phi3": {**BASE, "model_type": "phi3", "rms_norm_eps": 1e-6},
    "qwen3": {**BASE, "model_type": "qwen3", "head_dim": 8},
}
BAD_CONFIGS = {
    "gemma2": {**BASE, "model_type": "gemma2"},
    "yarn": {**BASE, "model_type": "llama", "rope_scaling": {"type": "yarn", "factor": 2}},
    "mixed-window": {**BASE, "model_type": "qwen2", "sliding_window": 64,
                     "use_sliding_window": True, "max_window_layers": 1},
}


@pytest.mark.parametrize("name", list(HF_CONFIGS))
def test_model_config_matches_jax(tmp_path, name):
    (tmp_path / "config.json").write_text(json.dumps(HF_CONFIGS[name]))
    got = dataclasses.asdict(ModelConfig.from_pretrained(str(tmp_path)))
    want = dataclasses.asdict(JaxModelConfig.from_pretrained(str(tmp_path)))
    assert got == want


@pytest.mark.parametrize("name", list(BAD_CONFIGS))
def test_model_config_refuses_like_jax(tmp_path, name):
    (tmp_path / "config.json").write_text(json.dumps(BAD_CONFIGS[name]))
    with pytest.raises(ValueError):
        JaxModelConfig.from_pretrained(str(tmp_path))
    with pytest.raises(ValueError):
        ModelConfig.from_pretrained(str(tmp_path))


# -- TorchEngine.from_pretrained --------------------------------------------------


def _assert_params_equal(got, want):
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    for key in ("embed", "final_norm", "lm_head"):
        assert got[key].dtype == want[key].dtype
        assert torch.equal(got[key], want[key]), key
    for key, t in want["layers"].items():
        assert torch.equal(got["layers"][key], t), key


@pytest.mark.parametrize("fused", [False, True], ids=["llama", "phi3-fused"])
def test_from_pretrained_equals_jax_loader(checkpoint, model_dir, tmp_path, fused):
    path, jcfg, np_params = checkpoint
    if fused:
        cfg_json = json.load(open(os.path.join(model_dir, "config.json")))
        sd = fuse_phi3(hf_state_dict(np_params, jcfg), jcfg.num_layers)
        path = write_checkpoint(tmp_path / "phi3", model_dir, sd)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump({**cfg_json, "model_type": "phi3"}, f)
        jcfg = JaxModelConfig.from_pretrained(path)
    engine = TorchEngine.from_pretrained(path, device="cpu")
    cfg = ModelConfig.from_pretrained(path)
    assert engine.model_cfg == cfg and cfg.dtype == "bfloat16"
    want = params_from_numpy(
        jax.tree.map(np.asarray, jax_load(path, jcfg)), cfg, device="cpu"
    )
    _assert_params_equal(engine.params, want)
    asyncio.run(asyncio.wait_for(engine.stop(), RUN_S))


# -- the command line -----------------------------------------------------------


def jax_texts(path: str, prompts=PROMPTS) -> list:
    """The JAX pipeline's greedy chat text per prompt, with the CLI's
    engine defaults."""
    async def body():
        engine = JaxEngine.from_pretrained(path)
        tok = JaxTokenizer.from_model_dir(path)
        name = os.path.basename(path)
        pipe = jax_link(JaxPreprocessor(name, tok), JaxBackend(tok), engine)
        out = []
        try:
            for prompt in prompts:
                req = ChatCompletionRequest.from_dict({
                    "model": name, "stream": True, "max_tokens": MAX_TOKENS,
                    "messages": [{"role": "user", "content": prompt}],
                })
                text = ""
                async for item in await jax_stream(pipe, JaxContext.new(req)):
                    for ch in (item.data or {}).get("choices", []):
                        text += (ch.get("delta") or {}).get("content") or ""
                out.append(text)
        finally:
            await engine.stop()
        return out

    return asyncio.run(asyncio.wait_for(body(), 120))


def run_cli(*args, timeout=180):
    return subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "DYN_LOG": "warning"},
    )


@pytest.fixture(scope="module")
def expected(checkpoint):
    return jax_texts(checkpoint[0])


def test_cli_text_prints_jax_text(checkpoint, expected):
    path = checkpoint[0]
    out = run_cli("run", "in=text", "out=torch", "--model-path", path,
                  "--device", "cpu", "--max-tokens", str(MAX_TOKENS),
                  "--prompt", PROMPTS[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout == expected[1] + "\n"


def test_cli_batch_prints_jax_text(checkpoint, expected, tmp_path):
    path = checkpoint[0]
    prompts = tmp_path / "p.jsonl"
    prompts.write_text("".join(json.dumps({"text": p}) + "\n" for p in PROMPTS))
    results = tmp_path / "r.jsonl"
    out = run_cli("run", "in=batch", "out=torch", "--model-path", path,
                  "--device", "cpu", "--max-tokens", str(MAX_TOKENS),
                  "--input-file", str(prompts), "--output-file", str(results))
    assert out.returncode == 0, out.stderr
    rows = [json.loads(line) for line in results.read_text().splitlines()]
    assert [r["index"] for r in rows] == [0, 1]
    assert [r["response"] for r in rows] == expected
    assert not any("error" in r for r in rows)


@pytest.mark.parametrize(
    "extra, name",
    [
        (["--tp", "2"], "--tp"),
        (["--kv-remote", "on"], "--kv-remote"),
        (["--disagg", "decode"], "--disagg"),
        (["--hub", "h:1"], "--hub"),
    ],
)
def test_cli_refuses_unported_flag(checkpoint, extra, name):
    out = run_cli("run", "in=http", "out=torch", "--model-path", checkpoint[0],
                  "--device", "cpu", *extra, timeout=60)
    assert out.returncode != 0 and name in out.stderr


@pytest.mark.parametrize(
    "extra",
    [
        ["--host-offload-blocks", "8", "--no-swap-preemption"],
        ["--host-offload-blocks", "1", "--disk-offload-blocks", "8",
         "--disk-offload-dir", "{tmp}", "--kv-prefetch-window", "4"],
    ],
)
def test_cli_serves_offload_flags(checkpoint, expected, tmp_path, extra):
    """The offload flags the JAX CLI takes (``--no-swap-preemption`` with
    its ``dest`` and default) are served: ``run in=text`` with the plane
    armed answers the JAX engine's text."""
    out = run_cli("run", "in=text", "out=torch", "--model-path", checkpoint[0],
                  "--device", "cpu", "--max-tokens", str(MAX_TOKENS),
                  "--prompt", PROMPTS[1],
                  *[x.format(tmp=tmp_path / "g3") for x in extra])
    assert out.returncode == 0, out.stderr
    assert out.stdout == expected[1] + "\n"


def test_cli_parses_swap_preemption_like_jax():
    from dynamo_tpu.cli import build_parser as jax_parser
    from dynamo_tpu_torch.cli import build_parser

    for argv in ([], ["--no-swap-preemption"]):
        base = ["run", "in=text", "out=torch", *argv]
        got = build_parser().parse_args(base)
        want = jax_parser().parse_args(["run", "in=text", "out=jax", *argv])
        assert got.swap_preemption is want.swap_preemption is (not argv)
    for flag in ("--host-offload-blocks", "--disk-offload-blocks", "--kv-prefetch-window"):
        assert build_parser().parse_args(["run", "in=text", "out=torch", flag, "3"])


@pytest.mark.parametrize("io", [("in=dyn", "out=torch"), ("in=http", "out=jax")])
def test_cli_refuses_unported_io(checkpoint, io):
    out = run_cli("run", *io, "--model-path", checkpoint[0], "--device", "cpu",
                  timeout=60)
    assert out.returncode != 0 and io[0 if io[0] == "in=dyn" else 1] in out.stderr


def test_cli_needs_card_or_cpu(checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    out = run_cli("run", "in=text", "out=torch", "--model-path", checkpoint[0],
                  "--prompt", "x", timeout=60)
    assert out.returncode != 0 and "--device cpu" in out.stderr


def test_cli_refuses_hub_id():
    out = run_cli("run", "in=http", "out=torch", "--model-path",
                  "meta-llama/Meta-Llama-3-8B", "--device", "cpu", timeout=60)
    assert out.returncode != 0 and "hub" in out.stderr


def test_cli_http_serves_the_bench_client(checkpoint):
    """``run in=http`` on the CPU answers ``python -m dynamo_tpu_torch
    bench``'s workload without an error, then exits 0 on SIGINT."""
    import signal

    path = checkpoint[0]
    server = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch", "run", "in=http", "out=torch",
         "--model-path", path, "--model-name", "m", "--port", "0", "--device", "cpu",
         "--max-seq-len", "256", "--num-pages", "64"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "DYN_LOG": "warning"},
    )
    try:
        line = server.stdout.readline()
        assert line.startswith("serving m at http://"), (line, server.stderr.read())
        port = line.split()[3].rsplit(":", 1)[1]
        out = run_cli("bench", "--port", port, "--model", "m", "--num-requests", "4",
                      "--isl", "12", "--osl", "5", "--vocab-size", "200", timeout=120)
        assert out.returncode == 0, out.stderr
        summary = json.loads(out.stdout)
        assert summary["num_ok"] == 4 and summary["num_errors"] == 0
        assert summary["mean_output_tokens"] == 5.0
        assert summary["ttft_ms"]["p50"] is not None
        server.send_signal(signal.SIGINT)
        server.communicate(timeout=60)
        assert server.returncode == 0
    finally:
        if server.poll() is None:
            server.kill()
            server.communicate(timeout=30)


# -- the distributed command line -------------------------------------------------


def test_cli_parses_dyn_flags_like_jax():
    """The runtime flags and subcommands the port now serves parse to the
    JAX CLI's defaults and values."""
    from dynamo_tpu.cli import build_parser as jax_parser
    from dynamo_tpu_torch.cli import build_parser

    keys = ("hub", "endpoint", "router_mode", "router_index_shards", "host", "port")
    for argv in ([], ["--hub", "auto", "--endpoint", "dyn://a.b.c", "--router-mode", "kv",
                      "--router-index-shards", "3"]):
        got = build_parser().parse_args(["run", "in=http", "out=dyn", *argv])
        want = jax_parser().parse_args(["run", "in=http", "out=dyn", *argv])
        assert {k: getattr(got, k) for k in keys} == {k: getattr(want, k) for k in keys}
    for argv in (["hub"], ["hub", "--port", "0", "--data-dir", "/d"],
                 ["llmctl", "--hub", "h:1", "list"], ["llmctl", "--hub", "h:1", "remove", "m"]):
        assert vars(build_parser().parse_args(argv)) == vars(jax_parser().parse_args(argv))
    for bad in (["--router-mode", "least_loaded"], ["--router-index-shards", "0"]):
        with pytest.raises(SystemExit):
            build_parser().parse_args(["run", "in=http", "out=dyn", *bad])


def refusal(argv) -> str:
    """The message ``run`` exits with, in process: the refusals come from
    the parsed flags, before any engine is built."""
    from dynamo_tpu_torch.cli import _check_served, _parse_io, build_parser

    args = build_parser().parse_args(["run", *argv])
    args.inp, args.out = _parse_io(args.io)
    with pytest.raises(SystemExit) as exc:
        _check_served(args)
    return str(exc.value)


# the argv the port refused while it had no prefix onboarding, and the
# decode role with the whole plane: each is served now
OFFLOAD_WORKERS = {
    "host": (["--host-offload-blocks", "8"], {}),
    "disk": (["--disk-offload-blocks", "8", "--disk-offload-dir", "{tmp}"], {}),
    "env": ([], {"DYN_KV_OFFLOAD": "host=16"}),
    "prefill": (["--disagg", "prefill", "--host-offload-blocks", "8"], {}),
    "kv-remote": (["--kv-remote", "on"], {}),
    "decode-g4": (["--disagg", "decode", "--host-offload-blocks", "8", "--kv-remote",
                   "namespace=t,mirror=0"], {}),
}


@pytest.mark.parametrize("case", list(OFFLOAD_WORKERS))
def test_cli_serves_offload_on_a_worker(checkpoint, monkeypatch, tmp_path, case):
    """``run in=dyn out=torch`` with the offload plane or ``--kv-remote``,
    in process against a hub: the flags parse, ``EngineConfig`` carries
    ``kv_remote``, and the worker serves -- ``kv_export`` beside the
    generate endpoint whenever the plane is armed (not on the prefill
    role, which has no generate endpoint), with the G4 tier attached over
    the hub's blob verbs when a spec was given."""
    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.offload import parse_kv_remote_spec
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.transports.client import HubBlobClient
    from dynamo_tpu_torch.runtime.transports.hub import HubServer

    extra, env = OFFLOAD_WORKERS[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    engines = []
    make = cli._make_engine
    monkeypatch.setattr(cli, "_make_engine", lambda a: engines.append(make(a)) or engines[-1])

    async def body():
        hub = HubServer()
        host, port = await hub.start()
        addr = f"{host}:{port}"
        args = cli.build_parser().parse_args(
            ["run", "in=dyn", "out=torch", "--model-path", checkpoint[0], "--device", "cpu",
             "--hub", addr, "--page-size", "4", *[x.format(tmp=tmp_path) for x in extra]])
        args.inp, args.out = cli._parse_io(args.io)
        cli._check_served(args)  # refuses nothing
        task = asyncio.ensure_future(cli.run_worker(args))
        rt = await DistributedRuntime.detached(addr)
        try:
            ns = rt.namespace("dynamo")
            exports = await ns.component("backend").endpoint("kv_export").client()
            # the holdings publisher hooks last, after the G4 attach
            while not engines or (
                engines[0].offload_engine is not None and engines[0].kv_holdings_sink is None
            ):
                await asyncio.sleep(0.05)
                assert not task.done(), task.exception()
            if args.disagg != "prefill":
                generate = await ns.component("backend").endpoint("generate").client()
                await asyncio.wait_for(generate.wait_for_instances(), 60)
                if engines[0].offload_engine is not None:
                    await asyncio.wait_for(exports.wait_for_instances(), 60)
            engine = engines[0]
            return (args, engine.cfg.kv_remote, engine.kv_remote_spec,
                    engine.offload_engine, len(exports.instances))
        finally:
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task
            await rt.shutdown()
            await hub.stop()

    from dynamo_tpu_torch.runtime import metrics as rtm

    identity = rtm.worker_identity()
    try:
        args, kv_remote, spec, oe, instances = asyncio.run(asyncio.wait_for(body(), RUN_S))
    finally:
        # the worker stamped its identity on the process registry: later
        # tests in this process read its series without those labels
        rtm.default_registry().set_default_labels(**identity)
    assert kv_remote == args.kv_remote
    assert spec == (parse_kv_remote_spec(args.kv_remote) if args.kv_remote else None)
    if case == "kv-remote":  # no plane: a spec, no tier, no kv_export
        assert oe is None and spec is not None and instances == 0
        return
    assert oe is not None
    assert instances == (0 if args.disagg == "prefill" else 1)
    if spec is not None:
        assert isinstance(oe.remote.store, HubBlobClient)
        assert oe.remote.namespace == "t" and oe._remote_mirror is False
    else:
        assert oe.remote is None


def test_cli_refuses_kv_remote_outside_a_worker():
    """The G4 store is the hub's: ``--kv-remote`` off a worker is refused,
    naming it (the JAX CLI parses it there and never attaches it)."""
    for argv in (["in=http", "out=torch"], ["in=text", "out=torch"],
                 ["in=http", "out=dyn", "--hub", "127.0.0.1:1"]):
        assert "--kv-remote serves in=dyn out=torch workers only" in refusal(
            [*argv, "--kv-remote", "on", "--model-path", "m", "--device", "cpu"])


def test_cli_parses_kv_remote_like_jax():
    from dynamo_tpu.cli import build_parser as jax_parser
    from dynamo_tpu_torch.cli import build_parser

    for argv in ([], ["--kv-remote", "on"], ["--kv-remote", "gbps=2,namespace=x"]):
        got = build_parser().parse_args(["run", "in=dyn", "out=torch", *argv])
        want = jax_parser().parse_args(["run", "in=dyn", "out=jax", *argv])
        assert got.kv_remote == want.kv_remote


@pytest.mark.parametrize(
    "argv, name",
    [
        # the ids these cases had beside the model-free engines' refusals
        pytest.param(["in=text", "out=dyn", "--hub", "127.0.0.1:1"], "out=dyn",
                     id="argv3-out=dyn"),
        pytest.param(["in=http", "out=dyn"], "in=http out=dyn requires --hub",
                     id="argv4-in=http out=dyn requires --hub"),
    ],
)
def test_cli_refuses_unported_dyn(argv, name):
    assert name in refusal([*argv, "--model-path", "m", "--device", "cpu"])


@pytest.mark.parametrize(
    "argv",
    [
        ["in=http", "out=torch", "--disagg", "decode"],
        ["in=text", "out=torch", "--disagg", "prefill"],
        ["in=http", "out=dyn", "--hub", "127.0.0.1:1", "--disagg", "decode"],
        ["in=dyn", "out=mocker", "--hub", "127.0.0.1:1", "--disagg", "decode"],
    ],
)
def test_cli_refuses_disagg_outside_a_worker(argv):
    """The JAX CLI ignores ``--disagg`` outside ``in=dyn``; the port
    refuses it there, naming it."""
    assert "--disagg serves in=dyn out=torch workers only" in refusal(
        [*argv, "--model-path", "m", "--device", "cpu"])


def test_cli_parses_disagg_flags_like_jax():
    """``--disagg`` and its flags, and ``disagg-conf``, parse to the JAX
    CLI's defaults and values."""
    from dynamo_tpu.cli import build_parser as jax_parser
    from dynamo_tpu_torch.cli import build_parser

    keys = ("disagg", "max_local_prefill_length", "max_prefill_queue_depth",
            "kv_chunk_layers", "no_chunked_kv", "block_size")
    for argv in ([], ["--disagg", "decode", "--max-local-prefill-length", "4",
                      "--max-prefill-queue-depth", "2", "--block-size", "4"],
                 ["--disagg", "prefill", "--kv-chunk-layers", "3", "--no-chunked-kv"]):
        got = build_parser().parse_args(["run", "in=dyn", "out=torch", *argv])
        want = jax_parser().parse_args(["run", "in=dyn", "out=jax", *argv])
        assert {k: getattr(got, k) for k in keys} == {k: getattr(want, k) for k in keys}
    for argv in (["disagg-conf", "--hub", "h:1"],
                 ["disagg-conf", "--hub", "h:1", "--namespace", "ns",
                  "--max-local-prefill-length", "7", "--max-prefill-queue-depth", "1"]):
        assert vars(build_parser().parse_args(argv)) == vars(jax_parser().parse_args(argv))


def test_cli_worker_needs_card_or_cpu(checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    out = run_cli("run", "in=dyn", "out=torch", "--model-path", checkpoint[0],
                  "--hub", "127.0.0.1:1", timeout=60)
    assert out.returncode != 0 and "--device cpu" in out.stderr


def _post(url: str, body: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_cli_serves_hub_worker_and_kv_frontend(checkpoint, expected):
    """``hub``, ``run in=dyn out=torch --device cpu`` and ``run in=http
    out=dyn --router-mode kv`` as three processes: the front end's chat
    texts are the JAX pipeline's, ``llmctl list`` names the model with one
    instance, and SIGINT ends each process with exit code 0."""
    import signal
    import time
    import urllib.request

    path = checkpoint[0]
    env = {**os.environ, "DYN_LOG": "warning"}
    procs = []

    def start(*args):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch", *args], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        ))
        return procs[-1]

    try:
        hub = start("hub", "--host", "127.0.0.1", "--port", "0")
        line = hub.stdout.readline()
        assert line.startswith("hub at 127.0.0.1:"), line
        addr = line.split()[2]
        worker = start("run", "in=dyn", "out=torch", "--model-path", path, "--model-name", "m",
                       "--device", "cpu", "--hub", addr)
        line = worker.stdout.readline()
        assert line.startswith("worker serving model m on dyn://dynamo.backend.generate"), (
            line, worker.stderr.read() if worker.poll() is not None else "")
        front = start("run", "in=http", "out=dyn", "--hub", addr, "--router-mode", "kv",
                      "--port", "0")
        line = front.stdout.readline()
        assert line.startswith("frontend at http://"), line
        url = line.split()[2]
        deadline = time.monotonic() + 60
        while True:
            with urllib.request.urlopen(url + "/v1/models", timeout=10) as resp:
                if json.loads(resp.read())["data"]:
                    break
            assert time.monotonic() < deadline, "model never discovered"
            time.sleep(0.1)
        for prompt, want in zip(PROMPTS, expected):
            body = _post(url + "/v1/chat/completions", {
                "model": "m", "max_tokens": MAX_TOKENS,
                "messages": [{"role": "user", "content": prompt}]})
            assert body["choices"][0]["message"]["content"] == want
        out = run_cli("llmctl", "--hub", addr, "list", timeout=60)
        assert out.returncode == 0, out.stderr
        assert out.stdout.startswith("m  instances=1  endpoint=dyn://dynamo.backend.generate")
        for p in (front, worker, hub):
            p.send_signal(signal.SIGINT)
            p.communicate(timeout=60)
            assert p.returncode == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)


def test_cli_serves_disaggregated_decode_and_prefill_workers(checkpoint, expected, tmp_path):
    """``hub``, ``run in=dyn out=torch --disagg decode`` and ``--disagg
    prefill`` (both ``--device cpu``) and ``run in=http out=dyn`` as four
    processes: prompts longer than ``--max-local-prefill-length`` ship to
    the prefill worker (its log names each delivery) and the front end's
    chat texts are the JAX pipeline's; only the decode worker registers the
    model; ``disagg-conf`` turns the next long prompt local; SIGINT ends
    each process with exit code 0."""
    import signal
    import time
    import urllib.request

    path = checkpoint[0]
    procs = []

    def start(*args, log=None):
        env = {**os.environ, "DYN_LOG": "info" if log else "warning"}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch", *args], cwd=ROOT, text=True, env=env,
            stdout=subprocess.PIPE, stderr=open(log, "w") if log else subprocess.PIPE,
        ))
        return procs[-1]

    prefill_log = tmp_path / "prefill.log"

    def deliveries() -> int:
        return prefill_log.read_text().count("prefilled ")

    try:
        hub = start("hub", "--host", "127.0.0.1", "--port", "0")
        line = hub.stdout.readline()
        assert line.startswith("hub at 127.0.0.1:"), line
        addr = line.split()[2]
        engine = ["--model-path", path, "--model-name", "m", "--device", "cpu", "--hub", addr,
                  "--page-size", "4"]
        decode = start("run", "in=dyn", "out=torch", *engine, "--disagg", "decode",
                       "--max-local-prefill-length", "4", "--block-size", "4")
        line = decode.stdout.readline()
        assert line.startswith("decode worker serving model m on dyn://dynamo.backend.generate"), (
            line, decode.stderr.read() if decode.poll() is not None else "")
        prefill = start("run", "in=dyn", "out=torch", *engine, "--disagg", "prefill",
                        "--kv-chunk-layers", "1", log=prefill_log)
        line = prefill.stdout.readline()
        assert line.startswith("prefill worker consuming dynamo_prefill_queue"), (
            line, prefill_log.read_text())
        front = start("run", "in=http", "out=dyn", "--hub", addr, "--port", "0")
        line = front.stdout.readline()
        assert line.startswith("frontend at http://"), line
        url = line.split()[2]
        deadline = time.monotonic() + 60
        while True:
            with urllib.request.urlopen(url + "/v1/models", timeout=10) as resp:
                if json.loads(resp.read())["data"]:
                    break
            assert time.monotonic() < deadline, "model never discovered"
            time.sleep(0.1)

        def chat(prompt: str) -> str:
            body = _post(url + "/v1/chat/completions", {
                "model": "m", "max_tokens": MAX_TOKENS,
                "messages": [{"role": "user", "content": prompt}]})
            return body["choices"][0]["message"]["content"]

        for i, (prompt, want) in enumerate(zip(PROMPTS, expected)):
            assert chat(prompt) == want
            assert deliveries() == i + 1, prefill_log.read_text()
        out = run_cli("llmctl", "--hub", addr, "list", timeout=60)
        assert out.returncode == 0, out.stderr
        assert out.stdout.startswith("m  instances=1  endpoint=dyn://dynamo.backend.generate")
        out = run_cli("disagg-conf", "--hub", addr, "--max-local-prefill-length", "100000",
                      timeout=60)
        assert out.returncode == 0 and "100000" in out.stdout, out.stderr
        # the decode worker's watch reloads the policy within milliseconds;
        # a prompt sent before that still ships, so ask until one stays
        for _ in range(20):
            shipped = deliveries()
            assert chat(PROMPTS[0]) == expected[0]
            if deliveries() == shipped:
                break
            time.sleep(0.2)
        else:
            raise AssertionError("disagg-conf never turned the prompts local")
        for p in (front, prefill, decode, hub):
            p.send_signal(signal.SIGINT)
            p.communicate(timeout=60)
            assert p.returncode == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
