"""Head geometries: the kernels' one rule, at construction and on the CPU.

``check_geometry`` (``dynamo_tpu_torch/ops/build.py``) is the rule every
kernel wrapper applies before its launch, and ``TorchEngine`` applies at
construction: on a CUDA device it refuses a model whose (dtype, Hq, Hkv,
D) no kernel instantiation takes, before any weight or pool is allocated,
so such a model fails there and not at its first dispatch.  The kernels
take every GQA group from 1 to 8 with head dims 64, 96, 128 and 256 in
bf16 and f32: the geometries of the published checkpoints the JAX package
serves on its TPU kernels, Llama-3-70B's 64/8/128 among them.  Still
refused: ``ModelConfig.tiny()``'s D 16, D 80, groups above 8.  On the CPU
the plain versions serve any geometry, as the JAX engine does: models at
the taken geometries serve the JAX engine's greedy tokens.  No card is
needed: the refusal comes before anything touches the device.
"""

from __future__ import annotations

import asyncio

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine, check_model_geometry
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.ops.build import check_geometry
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_ops import _free_compiled_programs  # noqa: F401 (autouse)

RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run

CUDA = torch.device("cuda")
ENGINE = dict(max_batch_size=2, max_seq_len=64, page_size=4, num_pages=32)
# (Hq, Hkv, D) the kernels refuse: ModelConfig.tiny()'s D = 16, a head dim
# between the instantiated ones (80), a group above 8 (9) and group 16 at
# D 128 (the m16 decode tile would hold it; no entry instantiates it)
REFUSED = {
    "tiny-d16": (4, 2, 16),
    "d80": (32, 8, 80),
    "group9": (9, 1, 128),
    "group16-d128": (32, 2, 128),
}
# Llama-3-8B's 32/8/128, chip_smoke.py's reference model, 4/2/64, and the
# head geometries of the published checkpoints the JAX package serves
TAKEN = {
    "llama3_8b-32-8": (32, 8, 128),
    "reference-4-2-64": (4, 2, 64),
    "default-32-32": (32, 32, 128),  # ModelConfig(), Llama-2-7B: group 1
    "llama3_70b-64-8": (64, 8, 128),  # also Qwen2.5-72B, Qwen3-32B: group 8
    "llama3_2_3b-24-8": (24, 8, 128),  # group 3
    "qwen2_5_14b-40-8": (40, 8, 128),  # group 5
    "qwen2_1_5b-12-2": (12, 2, 128),  # group 6
    "qwen2_7b-28-4": (28, 4, 128),  # group 7
    "gemma_7b-16-16": (16, 16, 256),  # D 256
    "gemma_2b-8-1": (8, 1, 256),  # D 256, group 8
    "phi3_mini-32-32": (32, 32, 96),  # D 96
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(REFUSED))
def test_rule_refuses_on_the_card_what_no_kernel_takes(name, dtype):
    Hq, Hkv, D = REFUSED[name]
    with pytest.raises(ValueError, match="unsupported head geometry"):
        check_geometry(CUDA, dtype, Hq, Hkv, D)
    check_geometry(torch.device("cpu"), dtype, Hq, Hkv, D)  # the CPU serves it


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(TAKEN))
def test_rule_takes_the_kernels_geometries(name, dtype):
    check_geometry(CUDA, dtype, *TAKEN[name])


def test_rule_refuses_a_dtype_without_kernels():
    with pytest.raises(ValueError, match="unsupported dtype"):
        check_geometry(CUDA, torch.float16, 32, 8, 128)


@pytest.mark.parametrize("name", list(REFUSED))
def test_engine_refuses_the_geometry_at_construction(name):
    Hq, Hkv, D = REFUSED[name]
    cfg = ModelConfig(num_heads=Hq, num_kv_heads=Hkv, head_dim=D)
    # raised before the weights are read or a pool is allocated on the card
    with pytest.raises(ValueError, match="unsupported head geometry"):
        TorchEngine(cfg, None, EngineConfig(**ENGINE), device="cuda")
    with pytest.raises(ValueError, match="unsupported head geometry"):
        TorchEngine.random_init(cfg, EngineConfig(**ENGINE), device="cuda")


def test_engine_refuses_the_default_model_on_the_card():
    # ModelConfig()'s 32/32/128 is taken now; ModelConfig.tiny()'s D 16 is not
    with pytest.raises(ValueError, match="Hq=4 Hkv=2 D=16"):
        TorchEngine(ModelConfig.tiny(), None, device="cuda")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_engine_takes_the_llama3_70b_preset_on_the_card(dtype):
    """The construction rule takes the whole preset (64/8/128) in both
    dtypes (its fields are held to the JAX preset's in
    test_torch_moe_checkpoint.py)."""
    check_model_geometry(ModelConfig.llama3_70b(dtype=dtype), CUDA)


def _request(tokens, max_tokens: int) -> dict:
    return {
        "token_ids": list(tokens),
        "stop_conditions": {"max_tokens": max_tokens},
        "sampling_options": {"temperature": 0.0},
        "eos_token_ids": [],
    }


async def _serve(engine, reqs):
    async def one(req):
        if isinstance(engine, JaxEngine):
            stream = await engine.generate(JaxContext.new(JaxRequest.from_dict(req)))
        else:
            stream = await engine.generate(Context.new(PreprocessedRequest.from_dict(req)))
        tokens = []
        async for item in stream:
            assert not item.is_error(), item.error_message()
            tokens += (item.data or {}).get("token_ids") or []
        return tokens

    try:
        return await asyncio.wait_for(asyncio.gather(*(one(r) for r in reqs)), 60)
    finally:
        await engine.stop()


def _serve_both(over, seed: int = 2):
    """A CPU ``TorchEngine`` and a ``JaxEngine`` over the same random
    weights of ``ModelConfig.tiny(**over)``: their greedy tokens."""
    jcfg = JaxModelConfig.tiny(**over)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    cfg = ModelConfig.tiny(**over)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    rs = np.random.default_rng(seed)
    reqs = [_request(rs.integers(1, 256, 9).tolist(), 6), _request([3, 1, 4, 1, 5], 6)]
    port = asyncio.run(
        asyncio.wait_for(_serve(TorchEngine(cfg, params, EngineConfig(**ENGINE), device="cpu"), reqs), RUN_S)
    )
    ref = asyncio.run(
        asyncio.wait_for(_serve(JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE)), reqs), RUN_S)
    )
    return port, ref


def test_cpu_engine_serves_32_32_heads_as_the_jax_engine():
    over = dict(num_heads=32, num_kv_heads=32, head_dim=8, hidden_size=64, num_layers=1)
    port, ref = _serve_both(over)
    assert [len(t) for t in port] == [6, 6]
    assert port == ref


# taken geometries at narrow widths: Llama-3-70B's heads (group 8), Phi-3's
# D 96 with a sliding window shorter than the prompts, Gemma-2B's 8/1/256
SERVED = {
    "llama3_70b-64-8": dict(num_heads=64, num_kv_heads=8, head_dim=128),
    "phi3-32-32-96-window": dict(num_heads=32, num_kv_heads=32, head_dim=96,
                                 sliding_window=6),
    "gemma_2b-8-1-256": dict(num_heads=8, num_kv_heads=1, head_dim=256),
}


@pytest.mark.parametrize("name", list(SERVED))
def test_cpu_engine_serves_taken_geometries_as_the_jax_engine(name):
    over = dict(SERVED[name], hidden_size=64, num_layers=1)
    port, ref = _serve_both(over, seed=3)
    assert [len(t) for t in port] == [6, 6]
    assert port == ref
