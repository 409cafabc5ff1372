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
"""

from __future__ import annotations

import asyncio
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
    asyncio.run(engine.stop())


# -- the command line -----------------------------------------------------------


def jax_texts(path: str) -> list:
    """The JAX pipeline's greedy chat text per prompt, with the CLI's
    engine defaults."""
    async def body():
        engine = JaxEngine.from_pretrained(path)
        tok = JaxTokenizer.from_model_dir(path)
        name = os.path.basename(path)
        pipe = jax_link(JaxPreprocessor(name, tok), JaxBackend(tok), engine)
        out = []
        try:
            for prompt in PROMPTS:
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


@pytest.mark.parametrize("io", [("in=dyn", "out=torch"), ("in=http", "out=jax"),
                                ("in=http", "out=mocker")])
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
            server.communicate()
