"""Weight-only int8 (``engine/quant.py``) against the JAX package's.

``quantize_tensor`` gives the JAX rule's int8 data and scales bit for bit
(f32 and bf16 weights, stacked and not, an all-zero channel among them),
and ``quantize_params`` the JAX tree's leaves.  ``params_from_numpy`` takes
the JAX quantized tree (each ``QuantizedTensor`` a ``(q, s)`` pair).  The
port's ``TorchEngine(quantize="int8")`` serves the greedy streams of the
JAX engine's ``quantize="int8"``, from the plain weights and from the JAX
quantized tree alike, and its prefill logits keep a cosine above 0.999
against the unquantized model's.  Another ``quantize`` value is refused.
The CLI serves ``--quantize int8`` and ``--draft-model random`` on the
CPU, and its refused-flag table names neither.  Every wait is bounded.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.engine.quant import QuantizedTensor as JaxQuantized
from dynamo_tpu.engine.quant import quantize_params as jax_quantize_params
from dynamo_tpu.engine.quant import quantize_tensor as jax_quantize_tensor
from dynamo_tpu_torch import cli
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine import quant as quant_module
from dynamo_tpu_torch.engine.model import init_params
from dynamo_tpu_torch.engine.quant import (
    QUANT_KEYS,
    QuantizedTensor,
    mat,
    quantize_params,
    quantize_tensor,
    weight_bytes,
)
from dynamo_tpu_torch.engine.step import prefill_step
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from tests.test_torch_checkpoint import hf_state_dict, run_cli, to_torch
from tests.test_torch_spec import collect, request, streams
from tests.test_torch_ops import _free_compiled_programs  # noqa: F401 (autouse)

ENGINE = dict(max_batch_size=4, max_seq_len=96, page_size=4, num_pages=64,
              mixed_token_budget=16)
WAIT_S = 60
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run


def _bits(a) -> np.ndarray:
    """Array bytes as integers (bf16 through a 16-bit view)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    return a


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.float32:
        return t.numpy().view(np.uint32)
    return t.numpy()


def _as_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 96), (3, 32, 48)], ids=["2d", "stacked"])
def test_quantize_tensor_bit_for_bit(dtype, shape, monkeypatch):
    # 40 output channels at a time: the weights quantize in column chunks,
    # the last one short, as Llama-3-70B's lm_head does at 8192 (a weight
    # within one chunk: quantize_params's lm_head, below)
    monkeypatch.setattr(quant_module, "QUANT_COLUMNS", 40)
    rs = np.random.default_rng(0)
    # channels of magnitudes 1e-4 to 30, and one all-zero channel
    w = rs.standard_normal(shape) * np.logspace(-4, 1.5, shape[-1])
    w[..., 5] = 0.0
    jw = jnp.asarray(w, jnp.dtype(dtype))
    ref = jax_quantize_tensor(jw, dtype)
    got = quantize_tensor(_as_torch(np.asarray(jw)), torch.float32 if dtype == "float32"
                          else torch.bfloat16)
    assert got.q.dtype == torch.int8 and got.shape == tuple(shape)
    assert tuple(got.s.shape) == tuple(np.shape(ref.s))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(_torch_bits(got.s), _bits(ref.s))
    assert (got.q[..., 5] == 0).all() and (got.s[..., 0, 5] == 1).all()
    # at the point of use: the data times its scale, in the scale's dtype
    deq = mat(got)
    assert deq.dtype == got.s.dtype
    torch.testing.assert_close(deq, got.q.to(got.s.dtype) * got.s, rtol=0, atol=0)
    plain = torch.ones(2, 2)
    assert mat(plain) is plain


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def _pairs(tree):
    """The JAX quantized tree as numpy, each QuantizedTensor a (q, s) pair."""
    np_tree = jax.tree.map(np.asarray, tree)

    def conv(v):
        if isinstance(v, JaxQuantized):
            return (np.asarray(v.q), np.asarray(v.s))
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return v

    return conv(np_tree)


def test_quantize_params_matches_jax_tree(weights):
    jcfg, jparams, np_params = weights
    cfg = ModelConfig.tiny()
    jq = _pairs(jax_quantize_params(jparams, jcfg))
    port = quantize_params(params_from_numpy(np_params, cfg, device="cpu"), torch.float32)
    carried = params_from_numpy(jq, cfg, device="cpu")
    for got in (port, carried):
        for k in QUANT_KEYS:
            leaf = got["layers"][k]
            assert isinstance(leaf, QuantizedTensor)
            np.testing.assert_array_equal(leaf.q.numpy(), jq["layers"][k][0])
            np.testing.assert_array_equal(_torch_bits(leaf.s), _bits(jq["layers"][k][1]))
        np.testing.assert_array_equal(got["lm_head"].q.numpy(), jq["lm_head"][0])
        # the embedding and the norms stay as they are
        assert not isinstance(got["embed"], QuantizedTensor)
        assert torch.equal(got["layers"]["input_norm"],
                           torch.from_numpy(np_params["layers"]["input_norm"].copy()))
    # quantizing again leaves quantized leaves as they are
    again = quantize_params(carried, torch.float32)
    assert again["layers"]["wq"] is carried["layers"]["wq"]
    assert weight_bytes(port) < weight_bytes(params_from_numpy(np_params, cfg, device="cpu"))
    with pytest.raises(ValueError, match="int8"):
        bad = dict(jq, layers=dict(jq["layers"], wq=(jq["layers"]["wq"][0].astype(np.int16),
                                                     jq["layers"]["wq"][1])))
        params_from_numpy(bad, cfg, device="cpu")


def test_logits_cosine_against_unquantized(weights):
    cfg = ModelConfig.tiny()
    params = params_from_numpy(weights[2], cfg, device="cpu")
    qparams = quantize_params(params, torch.float32)
    pool = torch.zeros((cfg.num_layers, 2, 16, 4, cfg.num_kv_heads, cfg.head_dim))
    tokens = torch.tensor([[5, 9, 2, 6, 3, 1, 4, 7]])
    lens = torch.tensor([8])
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    with torch.inference_mode():
        ref = prefill_step(params, cfg, pool.clone(), tokens, lens, table)[0].double()
        got = prefill_step(qparams, cfg, pool.clone(), tokens, lens, table)[0].double()
    cos = float(ref @ got / (ref.norm() * got.norm()))
    assert cos > 0.999, cos
    assert not torch.equal(ref, got)


def serve(engine, reqs):
    async def run():
        try:
            return await asyncio.wait_for(
                asyncio.gather(*[collect(engine, r) for r in reqs]), WAIT_S
            )
        finally:
            await engine.stop()

    return asyncio.run(asyncio.wait_for(run(), RUN_S))


@pytest.mark.parametrize("kw", [{}, dict(mixed_batching=False, prefill_chunk_tokens=8)],
                         ids=["default", "classic"])
def test_quantized_engine_streams_match_jax(weights, kw):
    jcfg, jparams, np_params = weights
    cfg = ModelConfig.tiny()
    rs = np.random.default_rng(8)
    reqs = [request(rs.integers(1, 256, n).tolist(), mt) for n, mt in ((37, 10), (9, 14), (5, 8))]
    reqs.append(request([5, 9, 2, 7] * 5, 12, "ngram"))
    ref = serve(JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE, **kw, quantize="int8")), reqs)
    eng = TorchEngine(cfg, params_from_numpy(np_params, cfg, device="cpu"),
                      EngineConfig(**ENGINE, **kw, quantize="int8"), device="cpu",
                      metrics_registry=MetricsRegistry())
    assert isinstance(eng.params["layers"]["w_up"], QuantizedTensor)
    port = serve(eng, reqs)
    assert streams(port) == streams(ref)
    # the JAX quantized tree carried across serves the same streams
    carried = params_from_numpy(_pairs(jax_quantize_params(jparams, jcfg)), cfg, device="cpu")
    again = serve(TorchEngine(cfg, carried, EngineConfig(**ENGINE, **kw), device="cpu",
                              metrics_registry=MetricsRegistry()), reqs)
    assert streams(again) == streams(ref)
    plain = serve(TorchEngine(cfg, params_from_numpy(np_params, cfg, device="cpu"),
                              EngineConfig(**ENGINE, **kw), device="cpu",
                              metrics_registry=MetricsRegistry()), reqs)
    # int8 weights are another model: the streams need not equal these
    assert [len(t) for t, _, _ in streams(plain)] == [len(t) for t, _, _ in streams(port)]


def test_unknown_quantize_refused():
    cfg = ModelConfig.tiny()
    with pytest.raises(ValueError, match="int8 only"):
        TorchEngine(cfg, init_params(cfg, 0, torch.device("cpu")),
                    EngineConfig(**ENGINE, quantize="int4"), device="cpu")


# -- the command line --------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_checkpoint(model_dir, tmp_path_factory):
    """A checkpoint directory of ModelConfig.tiny()'s geometry and
    vocabulary (the ``random`` draft preset's), with ``model_dir``'s
    tokenizer (fewer ids than the model: ids past it decode to nothing)."""
    path = str(tmp_path_factory.mktemp("tiny-ckpt"))
    for f in ("tokenizer.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(model_dir, f), path)
    with open(os.path.join(model_dir, "config.json")) as f:
        config = json.load(f)
    config["vocab_size"] = 256
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    cfg = ModelConfig.from_pretrained(path)
    jcfg = JaxModelConfig.from_pretrained(path)
    np_params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    sd = {k: to_torch(v) for k, v in hf_state_dict(np_params, jcfg).items()}
    save_file(sd, os.path.join(path, "model.safetensors"))
    assert cfg.vocab_size == ModelConfig.tiny().vocab_size
    return path


def test_cli_serves_quantize_and_draft_model(tiny_checkpoint):
    assert "--quantize" not in cli._REFUSED and "--draft-model" not in cli._REFUSED
    base = ("run", "in=text", "out=torch", "--model-path", tiny_checkpoint, "--device",
            "cpu", "--max-tokens", "6", "--prompt", "hello world")
    plain = run_cli(*base)
    assert plain.returncode == 0, plain.stderr
    drafted = run_cli(*base, "--draft-model", "random", "--no-fold-spec-verify",
                      "--no-spec-auto-disable")
    assert drafted.returncode == 0, drafted.stderr
    assert drafted.stdout == plain.stdout
    quant = run_cli(*base, "--quantize", "int8")
    assert quant.returncode == 0, quant.stderr
    assert quant.stdout.endswith("\n")
    refused = run_cli(*base, "--quantize", "int4")
    assert refused.returncode != 0 and "int4" in refused.stderr
