"""Mixtral checkpoints and the memory plan of the port, against the JAX
package and ``transformers``.

* A Mixtral-layout checkpoint directory written here (a tiny
  ``MixtralForCausalLM`` of ``transformers``, saved as safetensors, with a
  SentencePiece-style ``tokenizer.json`` of the older form): the port's
  ``load_safetensors_params`` equals ``params_from_numpy`` of the JAX
  loader's pytree (``block_sparse_moe.gate`` -> ``router``,
  ``experts.{e}.w1/w3/w2`` -> ``w_gate/w_up/w_down``); its trunk
  reproduces ``MixtralForCausalLM``'s logits in f32; its int8 load,
  quantized layer by layer, equals ``quantize_params`` of the bf16 load.
* ``python -m dynamo_tpu_torch run in=batch out=torch --device cpu`` on
  that directory prints the JAX pipeline's greedy texts; ``profile-sla
  --out torch`` profiles it.
* ``memory_plan``: the port's plan equals the JAX plan field for field at
  ``tp = 1`` for the tiny, ``llama3_8b`` and ``mixtral_8x7b`` presets, in
  the model's dtype and in int8, beside the port's own int8 dequantization
  term; ``param_bytes`` equals the bytes of the port's own ``init_params``;
  ``tp`` or ``ep`` above 1 raises, naming multi-GPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import memory_plan as jax_plan
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.weights import load_safetensors_params as jax_load
from dynamo_tpu_torch.engine import memory_plan
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.model import init_params, lm_logits, transformer
from dynamo_tpu_torch.engine.quant import QuantizedTensor, quantize_params, weight_bytes
from dynamo_tpu_torch.engine.weights import load_safetensors_params, params_from_numpy
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from test_torch_checkpoint import MAX_TOKENS, jax_texts
from test_torch_moe import port_causal
from test_torch_tokenizer import sentencepiece_json
from tests.test_torch_ops import _free_compiled_programs  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ["hello world", "tell me a story about the quick brown fox 😀"]
HF = dict(
    vocab_size=640, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16,
    max_position_embeddings=256, num_local_experts=4, num_experts_per_tok=2,
    rope_theta=1000000.0, tie_word_embeddings=False,
)


@pytest.fixture(scope="module")
def mixtral(tmp_path_factory):
    """A tiny ``MixtralForCausalLM`` of seed 0, saved with its
    SentencePiece-style tokenizer files."""
    from transformers import MixtralConfig, MixtralForCausalLM

    torch.manual_seed(0)
    model = MixtralForCausalLM(MixtralConfig(**HF)).eval()
    path = str(tmp_path_factory.mktemp("mixtral"))
    model.save_pretrained(path, safe_serialization=True)
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        f.write(sentencepiece_json("legacy"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({
            "bos_token": "<s>", "eos_token": "</s>",
            "chat_template": (
                "{% for message in messages %}[INST] {{ message['content'] }} [/INST]"
                "{% endfor %}"
            ),
        }, f)
    return path, model


def test_mixtral_config_and_params_equal_jax(mixtral):
    path, _ = mixtral
    cfg = ModelConfig.from_pretrained(path)
    jcfg = JaxModelConfig.from_pretrained(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.is_moe and cfg.num_experts == 4 and cfg.num_experts_per_tok == 2
    mine = load_safetensors_params(path, cfg, device="cpu")
    want = params_from_numpy(jax.tree.map(np.asarray, jax_load(path, jcfg)), cfg, device="cpu")
    assert set(mine["layers"]) == set(want["layers"]) >= {"router", "w_gate", "w_up", "w_down"}
    assert tuple(mine["layers"]["w_down"].shape) == (2, 4, 128, 64)
    for k in ("embed", "final_norm", "lm_head"):
        assert torch.equal(mine[k], want[k]), k
    for k, v in mine["layers"].items():
        assert torch.equal(v, want["layers"][k]), k


def test_mixtral_logits_match_hf(mixtral):
    """The capacity dispatch (E = 4, K = 2, cf = 2: nothing drops) over
    the loaded checkpoint gives ``MixtralForCausalLM``'s logits."""
    path, model = mixtral
    cfg = dataclasses.replace(ModelConfig.from_pretrained(path), dtype="float32")
    params = load_safetensors_params(path, cfg, device="cpu")
    tokens = [3, 17, 42, 7, 55, 23, 9, 80, 301, 612]
    with torch.no_grad():
        ref = model(torch.tensor([tokens])).logits[0].numpy()
        h = transformer(params, cfg, torch.tensor(tokens), torch.arange(len(tokens)),
                        None, port_causal)
        got = lm_logits(params, cfg, h).numpy()
    assert (got.argmax(-1) == ref.argmax(-1)).all()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


def test_int8_load_quantizes_each_layer(mixtral):
    path, _ = mixtral
    cfg = ModelConfig.from_pretrained(path)
    layered = load_safetensors_params(path, cfg, device="cpu", quantize="int8")
    whole = quantize_params(load_safetensors_params(path, cfg, device="cpu"), torch.bfloat16)
    for k, v in layered["layers"].items():
        w = whole["layers"][k]
        if isinstance(w, QuantizedTensor):
            assert isinstance(v, QuantizedTensor), k
            assert torch.equal(v.q, w.q) and torch.equal(v.s, w.s), k
        else:
            assert torch.equal(v, w), k
    assert tuple(layered["layers"]["w_gate"].s.shape) == (2, 4, 1, 128)


def test_cli_serves_mixtral_like_jax(mixtral, tmp_path):
    path, _ = mixtral
    prompts = tmp_path / "p.jsonl"
    prompts.write_text("".join(json.dumps({"text": p}) + "\n" for p in PROMPTS))
    results = tmp_path / "r.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch", "run", "in=batch", "out=torch",
         "--model-path", path, "--device", "cpu", "--max-tokens", str(MAX_TOKENS),
         "--input-file", str(prompts), "--output-file", str(results)],
        cwd=ROOT, capture_output=True, text=True, timeout=180,
        env={**os.environ, "DYN_LOG": "warning"},
    )
    assert out.returncode == 0, out.stderr
    rows = [json.loads(line) for line in results.read_text().splitlines()]
    assert [r["index"] for r in rows] == [0, 1]
    assert [r["response"] for r in rows] == jax_texts(path, PROMPTS)
    assert not any("error" in r for r in rows)
    # the port's tokenizer reads the checkpoint's SentencePiece file
    tok = Tokenizer.from_model_dir(path)
    assert tok.decode(tok.encode(PROMPTS[1])) == PROMPTS[1]


def test_profile_sla_serves_mixtral(mixtral):
    """``profile-sla --out torch`` over the Mixtral directory: exit code 0
    and a finite, positive table."""
    path, _ = mixtral
    out = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch", "profile-sla", "--out", "torch",
         "--model-path", path, "--device", "cpu", "--isl", "16,64", "--batch", "1,2",
         "--osl", "32", "--max-seq-len", "256", "--num-pages", "64"],
        cwd=ROOT, capture_output=True, text=True, timeout=180,
        env={**os.environ, "DYN_LOG": "warning"},
    )
    assert out.returncode == 0, out.stderr
    table = json.loads(out.stdout)["profile"]
    assert sorted(table["ttft_ms"]) == ["16", "64"] and sorted(table["tok_s"]) == ["1", "2"]
    assert all(0 < v < float("inf") for k in ("ttft_ms", "itl_ms", "tok_s")
               for v in table[k].values())


# -- the memory plan ----------------------------------------------------------

PRESETS = ["tiny", "llama3_8b", "llama3_70b", "mixtral_8x7b"]
FIELDS = ("param_bytes", "kv_bytes", "scratch_bytes", "reserve_bytes", "hbm_bytes",
          "num_pages", "bytes_per_page", "detail")
CARD = 80 * 1024**3


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("preset", PRESETS)
def test_plan_equals_jax(preset, quantize):
    jcfg = getattr(JaxModelConfig, preset)()
    cfg = getattr(ModelConfig, preset)()
    kw = dict(quantize=quantize, num_pages=1024, hbm_bytes=CARD)
    want = jax_plan.plan_memory(jcfg, **kw)
    got = memory_plan.plan_memory(cfg, **kw)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    if quantize is None:
        assert got.dequant_bytes == 0
        assert got.total_bytes == want.total_bytes
        assert memory_plan.max_kv_pages(cfg, hbm_bytes=CARD) == jax_plan.max_kv_pages(
            jcfg, hbm_bytes=CARD
        )
    else:
        # two copies of the largest per-layer weight in the compute dtype
        big = max(
            (np.prod(s[1:]) if p.startswith("layers/") else np.prod(s))
            for p, s in memory_plan._param_shapes(cfg).items() if p in memory_plan._QUANT_PATHS
        )
        wbytes = 2 if cfg.dtype == "bfloat16" else 4
        assert got.dequant_bytes == 2 * big * wbytes
        assert got.total_bytes == want.total_bytes + got.dequant_bytes
    if preset == "mixtral_8x7b":
        # about 93 GB in bf16 does not fit the card; int8 (about 47 GB) does
        assert got.fits == (quantize == "int8")


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("moe", [False, True])
def test_param_bytes_are_the_models_own(moe, quantize):
    cfg = ModelConfig.tiny(**(dict(num_experts=4) if moe else {}))
    params = init_params(cfg, 0, torch.device("cpu"), quantize=quantize)
    plan = memory_plan.plan_memory(cfg, quantize=quantize, hbm_bytes=CARD)
    assert plan.param_bytes == weight_bytes(params)
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    params = init_params(bf16, 0, torch.device("cpu"), quantize=quantize)
    assert memory_plan.plan_memory(bf16, quantize=quantize, hbm_bytes=CARD).param_bytes == (
        weight_bytes(params)
    )


@pytest.mark.parametrize("kw", [dict(tp=2), dict(ep=2), dict(tp=2, ep=4)])
def test_sharded_plans_are_refused(kw):
    cfg = ModelConfig.mixtral_8x7b()
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        memory_plan.plan_memory(cfg, hbm_bytes=CARD, **kw)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        memory_plan.max_kv_pages(cfg, hbm_bytes=CARD, **kw)


def test_plan_needs_a_card_or_its_size():
    """No default card: the card's own memory, or an error naming
    ``hbm_bytes``."""
    if torch.cuda.is_available():
        total = torch.cuda.mem_get_info()[1]
        assert memory_plan.plan_memory(ModelConfig.tiny()).hbm_bytes == total
    else:
        with pytest.raises(RuntimeError, match="hbm_bytes"):
            memory_plan.plan_memory(ModelConfig.tiny())


def test_mixtral_preset_equals_jax():
    assert dataclasses.asdict(ModelConfig.mixtral_8x7b()) == dataclasses.asdict(
        JaxModelConfig.mixtral_8x7b()
    )


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_llama3_70b_preset_and_plan_config_equal_jax(dtype):
    assert dataclasses.asdict(ModelConfig.llama3_70b()) == dataclasses.asdict(
        JaxModelConfig.llama3_70b()
    )
    assert dataclasses.asdict(memory_plan.llama3_70b_config(dtype)) == dataclasses.asdict(
        jax_plan.llama3_70b_config(dtype)
    )


# the plans chip_smoke.py serves Llama-3-70B under: 16 of its 80 layers in
# bf16 over 1024 pages at batch 8, and the whole model with int8 weights
# over 256 pages at batch 4; (layers, quantize, pages, batch, GiB of the
# whole plan on a card of 85.52e9 bytes)
LLAMA3_70B_PLANS = {
    "16-layers-bf16": (16, None, 1024, 8, 37.014),
    "80-layers-int8": (80, "int8", 256, 4, 77.554),
}


@pytest.mark.parametrize("name", list(LLAMA3_70B_PLANS))
def test_llama3_70b_plan_bytes_equal_jax(name):
    layers, quantize, pages, batch, gib = LLAMA3_70B_PLANS[name]
    cfg = dataclasses.replace(memory_plan.llama3_70b_config(), num_layers=layers)
    jcfg = dataclasses.replace(jax_plan.llama3_70b_config(), num_layers=layers)
    kw = dict(quantize=quantize, num_pages=pages, max_batch_size=batch, hbm_bytes=int(85.52e9))
    got, want = memory_plan.plan_memory(cfg, tp=1, **kw), jax_plan.plan_memory(jcfg, tp=1, **kw)
    assert got.param_bytes == want.param_bytes
    assert got.kv_bytes == want.kv_bytes
    assert got.detail == want.detail
    assert round(got.total_bytes / 2**30, 3) == gib
    assert got.fits

