"""The port's engine against the JAX package's, through ``generate()``.

``TorchEngine(device="cpu")`` and ``JaxEngine`` serve the same weights (the
JAX ``init_params`` pytree, carried across by ``params_from_numpy``) and the
same concurrent batch: a prompt longer than the mixed token budget (so it
is chunked), two prompts sharing a prefix (the second starts once the first
has streamed a token, so it hits the prefix cache), a stop-token request
and plain ``max_tokens`` requests.  Greedy streams must be equal token for
token.  The JAX engine runs its CPU path (XLA references), the port its
ops' plain versions.

Within the port: fused multistep (K up to 8) gives the tokens of K=1 for
greedy and seeded lanes, a seeded lane gives the same tokens alone and in a
batch, recompute preemption in a tight pool changes no token, a cancel
leaks no pages, and the entry points refuse to run without a card unless
the CPU is asked for.
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
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime.engine import Context

ENGINE = dict(
    max_batch_size=4, max_seq_len=96, page_size=4, num_pages=64,
    mixed_token_budget=16,
)
SHARED = [(7 * i + 3) % 250 + 1 for i in range(12)]  # three whole pages


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, np_params


def torch_engine(np_params, **kw) -> TorchEngine:
    cfg = ModelConfig.tiny()
    params = params_from_numpy(np_params, cfg, device="cpu")
    return TorchEngine(cfg, params, EngineConfig(**{**ENGINE, **kw}), device="cpu")


def request(tokens, max_tokens=8, stop_ids=None, **sampling) -> dict:
    stop = {"max_tokens": max_tokens}
    if stop_ids:
        stop["stop_token_ids_hidden"] = list(stop_ids)
    return {
        "token_ids": list(tokens),
        "stop_conditions": stop,
        "sampling_options": {"temperature": 0.0, **sampling},
        "eos_token_ids": [],
    }


async def collect(engine, req: dict, first=None, after=None):
    """Stream one request; ``after`` delays the start until that event is
    set, ``first`` is set once a token has arrived."""
    if after is not None:
        await after.wait()
    if isinstance(engine, JaxEngine):
        stream = await engine.generate(JaxContext.new(JaxRequest.from_dict(req)))
    else:
        stream = await engine.generate(Context.new(PreprocessedRequest.from_dict(req)))
    tokens, finish = [], None
    async for item in stream:
        assert not item.is_error(), item.error_message()
        data = item.data or {}
        tokens += data.get("token_ids") or []
        if tokens and first is not None:
            first.set()
        finish = data.get("finish_reason") or finish
    return tokens, str(finish) if finish is not None else None


async def serve_mixed(engine, reqs):
    """``reqs[1]`` and ``reqs[2]`` share a prefix: the second starts after
    the first has streamed, so its prompt finds the prefix registered."""
    try:
        first = asyncio.Event()
        jobs = [
            collect(engine, reqs[0]),
            collect(engine, reqs[1], first=first),
            collect(engine, reqs[2], after=first),
        ] + [collect(engine, r) for r in reqs[3:]]
        return await asyncio.gather(*jobs)
    finally:
        await engine.stop()


def mixed_batch(stop_token: int):
    rs = np.random.default_rng(4)
    toks = lambda n: rs.integers(1, 256, n).tolist()  # noqa: E731
    return [
        request(toks(37), 10),  # longer than the budget: chunked
        request(SHARED + toks(3), 10),
        request(SHARED + toks(5), 10),  # prefix hit
        request([5, 9, 2, 7], 12, stop_ids=[stop_token]),  # stop token
        request(toks(6), 14),  # max_tokens
    ]


def test_engine_greedy_streams_match_jax(weights):
    jcfg, jparams, np_params = weights
    # the stop token is the fourth greedy token of its prompt
    probe = asyncio.run(serve_mixed(torch_engine(np_params), mixed_batch(-5)))
    stop_token = probe[3][0][3]
    reqs = mixed_batch(stop_token)

    eng = torch_engine(np_params)
    port = asyncio.run(serve_mixed(eng, reqs))
    assert eng.metrics().gpu_prefix_cache_hit_rate > 0, "no prefix hit"
    assert eng.kv.allocator.used_pages == 0
    assert eng.tokens_generated == sum(len(t) for t, _ in port)

    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE))
    ref = asyncio.run(serve_mixed(jeng, reqs))

    assert port == ref
    assert port[3][1] == "stop" and len(port[3][0]) < 12
    assert [len(t) for t, _ in port] == [10, 10, 10, len(port[3][0]), 14]


def test_engine_logprobs_match_jax(weights):
    """Chosen and top-2 logprobs of a greedy stream, within 1e-4 (f32
    log-softmax over a 256-way vocabulary, summed in other orders)."""
    jcfg, jparams, np_params = weights
    req = request([3, 1, 4, 1, 5], 6, logprobs=2)

    async def frames(engine):
        try:
            if isinstance(engine, JaxEngine):
                ctx = JaxContext.new(JaxRequest.from_dict(req))
            else:
                ctx = Context.new(PreprocessedRequest.from_dict(req))
            stream = await engine.generate(ctx)
            out = {"token_ids": [], "logprobs": [], "top_logprobs": []}
            async for item in stream:
                for key in out:
                    out[key] += (item.data or {}).get(key) or []
            return out
        finally:
            await engine.stop()

    port = asyncio.run(frames(torch_engine(np_params)))
    ref = asyncio.run(frames(JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE))))
    assert port["token_ids"] == ref["token_ids"] and len(port["token_ids"]) == 6
    np.testing.assert_allclose(port["logprobs"], ref["logprobs"], atol=1e-4, rtol=0)
    assert len(port["top_logprobs"]) == 6
    for got, want in zip(port["top_logprobs"], ref["top_logprobs"]):
        assert [int(t) for t, _ in got] == [int(t) for t, _ in want]
        np.testing.assert_allclose(
            [lp for _, lp in got], [lp for _, lp in want], atol=1e-4, rtol=0
        )


def test_multistep_matches_single_step_and_seeded_lanes_are_isolated(weights):
    _, _, np_params = weights
    reqs = [
        request([1, 2, 3, 4, 5], 20),
        request([9, 8, 7], 20, temperature=0.9, seed=42),
        request([4, 4, 4, 4, 4, 4], 20, temperature=1.1, seed=7, top_k=20),
        request([3, 1, 4, 1, 5, 9, 2, 6], 20),
    ]

    async def run(engine, batch):
        try:
            return await asyncio.gather(*[collect(engine, r) for r in batch])
        finally:
            await engine.stop()

    k8 = torch_engine(np_params)
    fused = asyncio.run(run(k8, reqs))
    assert any(k > 1 for k in k8.dispatches_by_k), k8.dispatches_by_k
    k1 = torch_engine(np_params, multistep_max_k=1)
    single = asyncio.run(run(k1, reqs))
    assert set(k1.dispatches_by_k) == {1}
    assert fused == single
    assert all(len(t) == 20 for t, _ in fused)
    alone = asyncio.run(run(torch_engine(np_params), [reqs[1]]))
    assert alone[0] == fused[1]


def test_recompute_preemption_keeps_streams(weights):
    """A pool too small for both lanes' growth preempts one by recompute;
    every stream equals the roomy pool's."""
    _, _, np_params = weights
    reqs = [request([1, 2, 3], 40), request([6, 5, 4], 40)]

    async def run(engine):
        try:
            return await asyncio.gather(*[collect(engine, r) for r in reqs])
        finally:
            await engine.stop()

    roomy = asyncio.run(run(torch_engine(np_params)))
    tight_eng = torch_engine(np_params, num_pages=17)
    tight = asyncio.run(run(tight_eng))
    assert tight == roomy
    assert tight_eng.sched.preempt_recompute > 0


def test_cancel_frees_every_page(weights):
    _, _, np_params = weights

    async def body():
        engine = torch_engine(np_params)
        try:
            solo = await collect(engine, request([9, 8, 7], 16))
            stream = await engine.generate(
                Context.new(PreprocessedRequest.from_dict(request([1, 2, 3, 4], 80)))
            )
            survivor = asyncio.ensure_future(collect(engine, request([9, 8, 7], 16)))
            got = []
            async for item in stream:
                got.append(item)
                if len(got) == 2:
                    stream.ctx.stop_generating()
            assert (await survivor) == solo
            for _ in range(500):
                if engine.kv.allocator.used_pages == 0 and engine.sched.num_active == 0:
                    break
                await asyncio.sleep(0.01)
            assert engine.kv.allocator.used_pages == 0
            assert engine.sched.num_active == 0
        finally:
            await engine.stop()

    asyncio.run(body())


def test_penalized_request_gets_an_error_frame(weights):
    _, _, np_params = weights

    async def body():
        engine = torch_engine(np_params)
        try:
            req = request([1, 2, 3], 4, frequency_penalty=0.5)
            stream = await engine.generate(Context.new(PreprocessedRequest.from_dict(req)))
            items = [item async for item in stream]
            assert len(items) == 1 and items[0].is_error()
            assert "penalt" in items[0].error_message()
        finally:
            await engine.stop()

    asyncio.run(body())


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEngine.random_init(ModelConfig.tiny())
    eng = TorchEngine.random_init(ModelConfig.tiny(), EngineConfig(num_pages=8), device="cpu")
    assert eng.kv.pages.device.type == "cpu"
