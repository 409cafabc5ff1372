"""The port's perplexity evaluation (``llm/evaluate.py``) and its ``eval``
subcommand against the JAX package's.

* ``evaluate_perplexity`` on the same f32 weights (the JAX ``init_params``
  pytree through ``params_from_numpy``) and the same token stream: the JAX
  result within 1e-5 relative (the trunks sum in other orders; seen some
  1e-7), ``tokens_scored`` exactly, at windows 16, 64 and 100 (rounded
  down to 96), on a model of as many KV heads as query heads and one of
  four query heads a KV head.
* The ``eval`` subcommand (``--device cpu``, parsed and run in process) on a GGUF-only
  directory (bare and with ``--quantize int8``) and on a safetensors
  directory prints JAX ``run_eval``'s JSON line: ``tokens_scored``,
  ``model`` and ``quantize`` equal; with both packages' configs in f32,
  perplexity and ``avg_nll`` within one unit of the 4th printed decimal
  (1e-4: a 1e-7 relative difference can tip the rounding of the last
  digit); in the checkpoints' own bf16 within 1e-3 relative, since the two
  bf16 trunks round in other places (ROADMAP's score-precision mismatch;
  seen: 4e-4 on a perplexity of 486).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os

import jax
import numpy as np
import pytest

from dynamo_tpu.cli import build_parser as jax_parser
from dynamo_tpu.cli import run_eval as jax_run_eval
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.llm.evaluate import evaluate_perplexity as jax_evaluate
from dynamo_tpu_torch.cli import build_parser, run_eval
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.evaluate import evaluate_perplexity
from tests.test_torch_checkpoint import checkpoint  # noqa: F401 (fixture)
from tests.test_torch_gguf import write_model_gguf
from tests.test_torch_ops import _free_compiled_programs  # noqa: F401 (autouse)

MODELS = {
    "mha": dict(num_kv_heads=4),
    "gqa4": dict(num_heads=8, num_kv_heads=2),
}
TOKENS = np.random.default_rng(2).integers(0, 256, 211).tolist()
TEXT = ("the quick brown fox jumps over the lazy dog; hello world, "
        "tell me a story about the fox 😀 ") * 6


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, over in MODELS.items():
        jcfg = JaxModelConfig.tiny(**over)
        jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
        cfg = ModelConfig(**dataclasses.asdict(jcfg))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        out[name] = (jcfg, jparams, cfg, params)
    return out


@pytest.mark.parametrize("window", [16, 64, 100])
@pytest.mark.parametrize("name", list(MODELS))
def test_perplexity_matches_jax(models, name, window):
    jcfg, jparams, cfg, params = models[name]
    got = evaluate_perplexity(params, cfg, TOKENS, window=window)
    want = jax_evaluate(jparams, jcfg, TOKENS, window=window)
    assert got["tokens_scored"] == want["tokens_scored"]
    # windows of 16 (the last of 3 tokens), 64 and 96: every token but
    # each window's first is scored
    assert got["tokens_scored"] == len(TOKENS) - -(-len(TOKENS) // (window // 16 * 16))
    for key in ("avg_nll", "perplexity"):
        assert abs(got[key] - want[key]) <= 1e-5 * abs(want[key]), (key, got, want)


def test_too_few_tokens_refused_as_jax(models):
    jcfg, jparams, cfg, params = models["mha"]
    for fn, p, c in ((evaluate_perplexity, params, cfg), (jax_evaluate, jparams, jcfg)):
        with pytest.raises(ValueError, match="need at least 2 tokens"):
            fn(p, c, [5], window=16)


def _json_line(runner, argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert runner(argv) == 0
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def _f32_configs(monkeypatch) -> None:
    """Both packages' ``ModelConfig.from_pretrained`` give the checkpoint's
    config in f32, so ``eval`` loads and scores in f32."""
    for cls in (JaxModelConfig, ModelConfig):
        orig = cls.from_pretrained
        monkeypatch.setattr(cls, "from_pretrained", classmethod(
            lambda c, p, orig=orig: dataclasses.replace(orig(p), dtype="float32")))


def _check_eval(path: str, extra, dtype, monkeypatch) -> dict:
    """The port's ``eval`` JSON line against JAX ``run_eval``'s on
    ``path``: in f32, perplexity and ``avg_nll`` within one unit of the 4th
    printed decimal; in the checkpoint's bf16 within 1e-3 relative (the two
    bf16 trunks round in other places)."""
    if dtype == "float32":
        _f32_configs(monkeypatch)
    argv = ["eval", "--model-path", path, "--text", TEXT, "--window", "100", *extra]
    want = _json_line(lambda a: jax_run_eval(jax_parser().parse_args(a)), argv)
    got = _json_line(lambda a: run_eval(build_parser().parse_args(a)), argv + ["--device", "cpu"])
    assert set(got) == set(want)
    for key in ("tokens_scored", "model", "quantize"):
        assert got[key] == want[key], key
    for key in ("perplexity", "avg_nll"):
        tol = 1e-4 + 1e-9 if dtype == "float32" else 1e-3 * abs(want[key])
        assert abs(got[key] - want[key]) <= tol, (key, got, want)
    assert got["tokens_scored"] > 100
    return got


@pytest.fixture(scope="module")
def gguf_dir(tmp_path_factory):
    jcfg = JaxModelConfig.tiny()
    np_params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(3)))
    d = tmp_path_factory.mktemp("gguf-only")
    write_model_gguf(str(d / "model.gguf"), jcfg, np_params)
    return str(d)


DTYPES = pytest.mark.parametrize("dtype", ["float32", None], ids=["f32", "bf16"])


@DTYPES
@pytest.mark.parametrize("quantize", [None, "int8"], ids=["bare", "int8"])
def test_eval_cli_gguf_only_dir_prints_jax_json(gguf_dir, quantize, dtype, monkeypatch):
    got = _check_eval(gguf_dir, ["--quantize", quantize] if quantize else [], dtype,
                      monkeypatch)
    assert got["quantize"] == quantize


@DTYPES
def test_eval_cli_safetensors_dir_prints_jax_json(checkpoint, dtype, monkeypatch):  # noqa: F811
    path = checkpoint[0]
    assert any(f.endswith(".safetensors") for f in os.listdir(path))
    _check_eval(path, [], dtype, monkeypatch)


def test_eval_cli_needs_text(gguf_dir):
    with pytest.raises(SystemExit, match="need --text or --text-file"):
        run_eval(build_parser().parse_args(["eval", "--model-path", gguf_dir]))
