"""Head geometries: the kernels' one rule, at construction and on the CPU.

``check_geometry`` (``dynamo_tpu_torch/ops/build.py``) is the rule every
kernel wrapper applies before its launch, and ``TorchEngine`` applies at
construction: on a CUDA device it refuses a model whose (dtype, Hq, Hkv,
D) no kernel instantiation takes, before any weight or pool is allocated,
so such a model fails there and not at its first dispatch.  On the CPU the
plain versions serve any geometry, as the JAX engine does: a 32/32-head
model (``ModelConfig()``'s heads, group 1) serves the JAX engine's greedy
tokens.  No card is needed: the refusal comes before anything touches the
device.
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
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.ops.build import check_geometry
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime.engine import Context

RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run

CUDA = torch.device("cuda")
ENGINE = dict(max_batch_size=2, max_seq_len=64, page_size=4, num_pages=32)
# (Hq, Hkv, D) the kernels refuse: ModelConfig()'s 32/32 heads (group 1),
# the JAX llama3_70b preset's 64/8 (group 8), ModelConfig.tiny()'s D = 16
REFUSED = {
    "default-32-32": (32, 32, 128),
    "llama3_70b-64-8": (64, 8, 128),
    "tiny-d16": (4, 2, 16),
}
# Llama-3-8B's 32/8/128 and chip_smoke.py's reference model, 4/2/64
TAKEN = {"llama3_8b-32-8": (32, 8, 128), "reference-4-2-64": (4, 2, 64)}


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
    with pytest.raises(ValueError, match="Hq=32 Hkv=32 D=128"):
        TorchEngine(ModelConfig(), None, device="cuda")


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


def test_cpu_engine_serves_32_32_heads_as_the_jax_engine():
    over = dict(num_heads=32, num_kv_heads=32, head_dim=8, hidden_size=64, num_layers=1)
    jcfg = JaxModelConfig.tiny(**over)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    cfg = ModelConfig.tiny(**over)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    rs = np.random.default_rng(2)
    reqs = [_request(rs.integers(1, 256, 9).tolist(), 6), _request([3, 1, 4, 1, 5], 6)]
    port = asyncio.run(
        asyncio.wait_for(_serve(TorchEngine(cfg, params, EngineConfig(**ENGINE), device="cpu"), reqs), RUN_S)
    )
    ref = asyncio.run(
        asyncio.wait_for(_serve(JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE)), reqs), RUN_S)
    )
    assert [len(t) for t in port] == [6, 6]
    assert port == ref
