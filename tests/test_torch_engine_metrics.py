"""The port's ``EngineMetrics`` against the JAX engine's.

Both engines serve one fixed workload (echo requests included) in the
serial loop, each over a private registry, under the mixed path, the
classic path and the rectangle layout.  The rendered ``dynamo_engine_*`` families, their types and
their label sets (histogram bounds included) must be equal; so must every
value that does not depend on timing (dispatches by kind, tokens, prefix
hit and lookup tokens, mixed-batch fill, multistep K, packed shapes, KV
pages, slots, step-latency counts).  The dispatch counter equals the
port's ``engine.dispatches`` kind by kind, and an embedding call adds its
``embed`` dispatches to it (the JAX engine does not count those).
"""

from __future__ import annotations

import asyncio
import re

import jax
import numpy as np
import pytest

from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.runtime.metrics import MetricsRegistry as JaxRegistry
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

from tests.test_torch_score import ENGINE, WAIT_S, serve, workload

RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run

CONFIGS = {
    "mixed": {},
    "classic": dict(mixed_batching=False, prefill_chunk_tokens=8),
    "rectangle": dict(packed_ragged=False),
}
# values set by the last admission pass or measured on the host clock
TIMING = ("dynamo_engine_batch_occupancy", "dynamo_engine_prefill_queue_depth",
          "dynamo_engine_step_latency_seconds_bucket",
          "dynamo_engine_step_latency_seconds_sum")


def engine_samples(text: str):
    """``{sample name + labels: value}`` of the dynamo_engine_ families,
    and their ``# TYPE`` lines."""
    samples, types = {}, []
    for line in text.splitlines():
        if line.startswith("# TYPE dynamo_engine_") and "_created " not in line:
            types.append(line)
        elif line.startswith("dynamo_engine_") and "_created" not in line:
            key, value = line.rsplit(" ", 1)
            samples[key] = float(value)
    return samples, sorted(types)


EMBED_INPUTS = [[1, 2, 3], list(range(1, 40)), [9] * 7, [4, 4], [5], [6, 7]]


@pytest.fixture(scope="module", params=list(CONFIGS))
def served(request):
    """The port's registry text after the workload, its dispatch counts
    then, and both again after an embedding call; the JAX registry's
    text after the workload."""
    jcfg = JaxModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    cfg = ModelConfig.tiny()
    kw = dict(CONFIGS[request.param], async_dispatch=False)
    treg, jreg = MetricsRegistry(), JaxRegistry()
    teng = TorchEngine(
        cfg, params_from_numpy(np_params, cfg, device="cpu"),
        EngineConfig(**ENGINE, **kw), device="cpu", metrics_registry=treg,
    )
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE, **kw), metrics_registry=jreg)
    out = {}

    async def then(engine):
        out["served"] = (treg.render()[0].decode(), dict(engine.dispatches))
        out["vectors"] = await engine.embed(EMBED_INPUTS)
        out["embedded"] = (treg.render()[0].decode(), dict(engine.dispatches))
        out["tokens"] = engine.tokens_generated

    asyncio.run(asyncio.wait_for(serve(teng, workload(), then), RUN_S))
    asyncio.run(asyncio.wait_for(serve(jeng, workload()), RUN_S))
    out["jax"] = jreg.render()[0].decode()
    return out


def test_families_and_labels_equal_jax(served):
    tsamples, ttypes = engine_samples(served["served"][0])
    jsamples, jtypes = engine_samples(served["jax"])
    assert ttypes == jtypes and len(ttypes) == 17
    assert sorted(tsamples) == sorted(jsamples)
    steady = {k: v for k, v in jsamples.items() if not k.startswith(TIMING)}
    assert {k: tsamples[k] for k in steady} == steady
    assert tsamples['dynamo_engine_dispatches_total{kind="prompt_score"}'] == 4


def counted(text: str):
    samples, _ = engine_samples(text)
    return {
        re.search(r'kind="(\w+)"', k).group(1): int(v)
        for k, v in samples.items() if k.startswith("dynamo_engine_dispatches_total")
    }


def test_dispatch_counter_equals_engine_dispatches(served):
    text, dispatches = served["served"]
    assert counted(text) == dispatches and "embed" not in dispatches
    text, dispatches = served["embedded"]
    assert len(served["vectors"]) == len(EMBED_INPUTS) and dispatches["embed"] == 2
    assert counted(text) == dispatches
    # the embedding call generated no token
    samples, _ = engine_samples(text)
    assert samples["dynamo_engine_tokens_generated_total"] == served["tokens"]
