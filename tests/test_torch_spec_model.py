"""The port's model drafter (``spec/model_drafter.py``) against the JAX
package's.

On the same tiny f32 weights (the JAX ``init_params`` pytree through
``params_from_numpy``) ``ModelDrafter.propose`` gives the JAX drafter's
proposals for several histories, short and past its window.
``load_draft_model("random")`` is ``TorchEngine.random_init``'s tiny
model, so a ``random`` drafter on that target accepts every column it
drafts; a draft model of another vocabulary is refused at engine
construction; a checkpoint directory the test writes loads through the
port's safetensors reader and drafts for an engine, and a GGUF path is
refused.  The drafter binds to its engine, not to the process-wide
registry, and ``DYN_DRAFT_MODEL`` arms one.  Greedy streams with the
model drafter equal the JAX engine's with its own.  Every wait is
bounded (``asyncio.wait_for``).
"""

from __future__ import annotations

import asyncio
import json

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.spec.model_drafter import ModelDrafter as JaxModelDrafter
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.model import init_params
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.spec import DRAFTERS, MAX_DRAFT_TOKENS
from dynamo_tpu_torch.spec.model_drafter import ModelDrafter, load_draft_model
from tests.test_torch_spec import collect, request, streams

ENGINE = dict(max_batch_size=4, max_seq_len=96, page_size=4, num_pages=64,
              mixed_token_budget=16)
WAIT_S = 60
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def serve(engine, reqs):
    async def run():
        try:
            return await asyncio.wait_for(
                asyncio.gather(*[collect(engine, r) for r in reqs]), WAIT_S
            )
        finally:
            await engine.stop()

    return asyncio.run(asyncio.wait_for(run(), RUN_S))


def test_propose_matches_jax(weights):
    jcfg, jparams, np_params = weights
    cfg = ModelConfig.tiny()
    port = ModelDrafter(params_from_numpy(np_params, cfg, device="cpu"), cfg, "cpu", window=32)
    ref = JaxModelDrafter(jparams, jcfg, window=32)
    rs = np.random.default_rng(1)
    histories = [[1, 2, 3], [7], rs.integers(1, 256, 20).tolist(),
                 rs.integers(1, 256, 40).tolist(), [5, 9, 2, 7] * 12]
    for h in histories:
        for n in (1, 3, 4, 8):
            assert port.propose(h, n) == ref.propose(h, n), (h, n)
    assert port.propose([], 4) == [] and port.propose([1, 2], 0) == []
    assert len(port.propose(list(range(1, 20)), 99)) == MAX_DRAFT_TOKENS


def test_random_preset_is_random_init_and_accepts_every_column():
    cfg, params = load_draft_model("random", "cpu")
    assert cfg == ModelConfig.tiny()
    same = init_params(cfg, 0, torch.device("cpu"))
    assert all(torch.equal(params["layers"][k], same["layers"][k]) for k in same["layers"])
    assert torch.equal(params["lm_head"], same["lm_head"])
    _, seeded = load_draft_model("random:3", "cpu")
    assert not torch.equal(seeded["embed"], params["embed"])

    eng = TorchEngine.random_init(
        ModelConfig.tiny(), EngineConfig(**ENGINE, draft_model="random"), seed=0,
        device="cpu",
    )
    assert isinstance(eng.model_drafter, ModelDrafter)
    assert "model" not in DRAFTERS  # engine-scoped, not process-wide
    rs = np.random.default_rng(2)
    prompts = [rs.integers(1, 256, n).tolist() for n in (5, 11, 19)]
    out = serve(eng, [request(p, 12, "model") for p in prompts])
    plain = serve(TorchEngine.random_init(ModelConfig.tiny(), EngineConfig(**ENGINE),
                                          seed=0, device="cpu"),
                  [request(p, 12) for p in prompts])
    assert streams(out) == streams(plain)
    for r in out:
        st = r["spec"]
        assert st["drafter"] == "model" and st["drafted_tokens"] > 0
        assert st["accepted_tokens"] == st["drafted_tokens"], st
    assert eng.spec_verify_steps < sum(len(r["tokens"]) for r in out)


def test_vocab_mismatch_refused_at_construction():
    cfg = ModelConfig.tiny(vocab_size=128)
    with pytest.raises(ValueError, match="vocab"):
        TorchEngine(cfg, init_params(cfg, 0, torch.device("cpu")),
                    EngineConfig(**ENGINE, draft_model="random"), device="cpu")


def test_unarmed_engine_refuses_model_kind(weights):
    cfg = ModelConfig.tiny()
    eng = TorchEngine(cfg, params_from_numpy(weights[2], cfg, device="cpu"),
                      EngineConfig(**ENGINE), device="cpu", metrics_registry=MetricsRegistry())
    out = serve(eng, [request([1, 2, 3], 6, "model")])
    assert "unknown drafter 'model'" in out[0]["error"]


def _write_checkpoint(path, cfg: ModelConfig, params) -> None:
    path.mkdir()
    (path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "max_position_embeddings": cfg.max_position, "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta, "tie_word_embeddings": False,
    }))
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj", "w_down": "mlp.down_proj"}
    sd = {
        "model.embed_tokens.weight": params["embed"],
        "model.norm.weight": params["final_norm"],
        "lm_head.weight": params["lm_head"].T,
    }
    for i in range(cfg.num_layers):
        for key, name in names.items():
            sd[f"model.layers.{i}.{name}.weight"] = params["layers"][key][i].T
        sd[f"model.layers.{i}.input_layernorm.weight"] = params["layers"]["input_norm"][i]
        sd[f"model.layers.{i}.post_attention_layernorm.weight"] = params["layers"]["post_norm"][i]
    save_file({k: v.contiguous() for k, v in sd.items()}, str(path / "model.safetensors"))


def test_checkpoint_directory_loads_and_drafts(weights, tmp_path):
    cfg = ModelConfig.tiny()
    params = params_from_numpy(weights[2], cfg, device="cpu")
    ckpt = tmp_path / "draft"
    _write_checkpoint(ckpt, cfg, params)
    dcfg, dparams = load_draft_model(str(ckpt), "cpu")
    # the checkpoint's geometry; weights in the loaded config's dtype
    assert (dcfg.vocab_size, dcfg.num_layers, dcfg.head_dim) == (256, 2, 16)
    assert torch.equal(dparams["layers"]["wq"], params["layers"]["wq"].to(dparams["embed"].dtype))
    eng = TorchEngine(cfg, params, EngineConfig(**ENGINE, draft_model=str(ckpt)),
                      device="cpu", metrics_registry=MetricsRegistry())
    prompt = [5, 9, 2, 7, 5, 9, 2, 7, 1]
    out = serve(eng, [request(prompt, 12, "model")])
    base = serve(TorchEngine(cfg, params, EngineConfig(**ENGINE), device="cpu",
                             metrics_registry=MetricsRegistry()), [request(prompt, 12)])
    assert streams(out) == streams(base)
    assert out[0]["spec"]["drafted_tokens"] > 0
    with pytest.raises(FileNotFoundError, match="GGUF"):
        load_draft_model(str(tmp_path / "model.gguf"), "cpu")


def test_env_arms_the_model_drafter(monkeypatch):
    monkeypatch.setenv("DYN_DRAFT_MODEL", "random")
    cfg = ModelConfig.tiny()
    eng = TorchEngine(cfg, init_params(cfg, 0, torch.device("cpu")), EngineConfig(**ENGINE),
                      device="cpu", metrics_registry=MetricsRegistry())
    assert isinstance(eng.model_drafter, ModelDrafter)
    monkeypatch.setenv("DYN_DRAFT_MODEL", "off")
    eng = TorchEngine(cfg, init_params(cfg, 0, torch.device("cpu")),
                      EngineConfig(**ENGINE, draft_model="random"), device="cpu",
                      metrics_registry=MetricsRegistry())
    assert eng.model_drafter is None


def test_model_drafter_streams_match_jax(weights):
    """Each package's engine with its ``random`` model drafter over the
    same target weights: the greedy streams are the target's in both."""
    jcfg, jparams, np_params = weights
    cfg = ModelConfig.tiny()
    rs = np.random.default_rng(3)
    reqs = [request(rs.integers(1, 256, n).tolist(), 10, "model") for n in (6, 13)]
    port = serve(TorchEngine(cfg, params_from_numpy(np_params, cfg, device="cpu"),
                             EngineConfig(**ENGINE, draft_model="random"), device="cpu",
                             metrics_registry=MetricsRegistry()), reqs)
    ref = serve(JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE, draft_model="random")), reqs)
    assert streams(port) == streams(ref)
    assert all(r["spec"]["drafter"] == "model" for r in port)
