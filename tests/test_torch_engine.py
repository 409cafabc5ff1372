"""The port's engine against the JAX package's, through ``generate()``.

``TorchEngine(device="cpu")`` and ``JaxEngine`` serve the same weights (the
JAX ``init_params`` pytree, carried across by ``params_from_numpy``) and the
same concurrent batch: a prompt longer than the mixed token budget (so it
is chunked), two prompts sharing a prefix (the second starts once the first
has streamed a token, so it hits the prefix cache), a stop-token request
and plain ``max_tokens`` requests.  Greedy streams must be equal token for
token, under the default config, the classic path (``mixed_batching=False``
with chunked prefill), the rectangle layout (``packed_ragged=False``) and
the default config with penalized lanes (classic ticks take over while one
holds a slot), a penalized arrival during a pending mixed prefill, and
penalized lanes through recompute preemption.  The JAX engine runs its CPU
path (XLA references), the port its ops' plain versions.

Within the port: unpenalized lanes give the same tokens under every
config, fused multistep (K up to 8) gives the tokens of K=1 for greedy and
seeded lanes, a seeded lane gives the same tokens alone and in a batch,
recompute preemption in a tight pool changes no token, a cancel leaks no
pages, and the entry points refuse to run without a card unless the CPU is
asked for.  Every wait is bounded (``asyncio.wait_for``), so a hang fails
in seconds.
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
from dynamo_tpu_torch.engine.sampling import PROMPT_FLAG
from dynamo_tpu_torch.engine.scheduler import SeqState
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_ops import _free_compiled_programs  # noqa: F401 (autouse)

ENGINE = dict(
    max_batch_size=4, max_seq_len=96, page_size=4, num_pages=64,
    mixed_token_budget=16,
)
SHARED = [(7 * i + 3) % 250 + 1 for i in range(12)]  # three whole pages
WAIT_S = 60  # bound on any one served batch
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run
# the configs held against the JAX engine, and whether their batch carries
# the two penalized lanes
CONFIGS = {
    "classic": (dict(mixed_batching=False, prefill_chunk_tokens=8), True),
    "rectangle": (dict(packed_ragged=False), False),
    "penalized": ({}, True),
}


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


async def serve_mixed(engine, reqs, timeout=WAIT_S):
    """``reqs[1]`` and ``reqs[2]`` share a prefix: the second starts after
    the first has streamed, so its prompt finds the prefix registered."""
    try:
        first = asyncio.Event()
        jobs = [
            collect(engine, reqs[0]),
            collect(engine, reqs[1], first=first),
            collect(engine, reqs[2], after=first),
        ] + [collect(engine, r) for r in reqs[3:]]
        return await asyncio.wait_for(asyncio.gather(*jobs), timeout)
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


def penalized_lanes():
    rs = np.random.default_rng(9)
    return [
        request(rs.integers(1, 256, 9).tolist(), 10, frequency_penalty=0.7),
        request(rs.integers(1, 256, 14).tolist(), 10, repetition_penalty=1.3),
    ]


@pytest.fixture(scope="module")
def stop_token(weights):
    # the stop token is the fourth greedy token of its prompt
    probe = asyncio.run(
        asyncio.wait_for(serve_mixed(torch_engine(weights[2]), mixed_batch(-5), WAIT_S), RUN_S)
    )
    return probe[3][0][3]


@pytest.fixture(scope="module")
def served(weights, stop_token):
    """Each config's streams from both engines, served once per module."""
    jcfg, jparams, np_params = weights
    out = {}
    for name, (kw, with_penalties) in CONFIGS.items():
        reqs = mixed_batch(stop_token) + (penalized_lanes() if with_penalties else [])
        eng = torch_engine(np_params, **kw)
        port = asyncio.run(asyncio.wait_for(serve_mixed(eng, reqs, WAIT_S), RUN_S))
        jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE, **kw))
        ref = asyncio.run(asyncio.wait_for(serve_mixed(jeng, reqs, WAIT_S), RUN_S))
        out[name] = dict(port=port, ref=ref, engine=eng)
    return out


def test_engine_greedy_streams_match_jax(weights, stop_token):
    jcfg, jparams, np_params = weights
    reqs = mixed_batch(stop_token)

    eng = torch_engine(np_params)
    port = asyncio.run(asyncio.wait_for(serve_mixed(eng, reqs), RUN_S))
    assert eng.metrics().gpu_prefix_cache_hit_rate > 0, "no prefix hit"
    assert eng.kv.allocator.used_pages == 0
    assert eng.tokens_generated == sum(len(t) for t, _ in port)

    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE))
    ref = asyncio.run(asyncio.wait_for(serve_mixed(jeng, reqs), RUN_S))

    assert port == ref
    assert port[3][1] == "stop" and len(port[3][0]) < 12
    assert [len(t) for t, _ in port] == [10, 10, 10, len(port[3][0]), 14]


async def logprob_frames(engine, req: dict, timeout=WAIT_S) -> dict:
    """Token ids, chosen logprobs and top logprobs of one stream."""
    try:
        if isinstance(engine, JaxEngine):
            ctx = JaxContext.new(JaxRequest.from_dict(req))
        else:
            ctx = Context.new(PreprocessedRequest.from_dict(req))

        async def frames() -> dict:
            stream = await engine.generate(ctx)
            out = {"token_ids": [], "logprobs": [], "top_logprobs": []}
            async for item in stream:
                for key in out:
                    out[key] += (item.data or {}).get(key) or []
            return out

        return await asyncio.wait_for(frames(), timeout)
    finally:
        await engine.stop()


def assert_logprobs_match(port: dict, ref: dict, n: int) -> None:
    assert port["token_ids"] == ref["token_ids"] and len(port["token_ids"]) == n
    np.testing.assert_allclose(port["logprobs"], ref["logprobs"], atol=1e-4, rtol=0)
    assert len(port["top_logprobs"]) == n
    for got, want in zip(port["top_logprobs"], ref["top_logprobs"]):
        assert [int(t) for t, _ in got] == [int(t) for t, _ in want]
        np.testing.assert_allclose(
            [lp for _, lp in got], [lp for _, lp in want], atol=1e-4, rtol=0
        )


def test_engine_logprobs_match_jax(weights):
    """Chosen and top-2 logprobs of a greedy stream, within 1e-4 (f32
    log-softmax over a 256-way vocabulary, summed in other orders)."""
    jcfg, jparams, np_params = weights
    req = request([3, 1, 4, 1, 5], 6, logprobs=2)
    port = asyncio.run(asyncio.wait_for(logprob_frames(torch_engine(np_params), req), RUN_S))
    ref = asyncio.run(
        asyncio.wait_for(logprob_frames(JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE)), req), RUN_S)
    )
    assert_logprobs_match(port, ref, 6)


def test_classic_logprobs_match_jax(weights):
    """The classic path reports them too: the first token's from the
    prefill dispatch, the rest from decode blocks; a penalized lane
    reports the raw distribution, not the penalized one it sampled."""
    jcfg, jparams, np_params = weights
    kw = dict(mixed_batching=False, decode_block_size=4)
    req = request(list(range(1, 12)), 7, logprobs=2, repetition_penalty=1.4)
    port = asyncio.run(
        asyncio.wait_for(logprob_frames(torch_engine(np_params, **kw), req, WAIT_S), RUN_S)
    )
    ref = asyncio.run(
        asyncio.wait_for(logprob_frames(
            JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE, **kw)), req, WAIT_S
        ), RUN_S)
    )
    assert_logprobs_match(port, ref, 7)


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
            return await asyncio.wait_for(
                asyncio.gather(*[collect(engine, r) for r in batch]), WAIT_S
            )
        finally:
            await engine.stop()

    k8 = torch_engine(np_params)
    fused = asyncio.run(asyncio.wait_for(run(k8, reqs), RUN_S))
    assert any(k > 1 for k in k8.dispatches_by_k), k8.dispatches_by_k
    k1 = torch_engine(np_params, multistep_max_k=1)
    single = asyncio.run(asyncio.wait_for(run(k1, reqs), RUN_S))
    assert set(k1.dispatches_by_k) == {1}
    assert fused == single
    assert all(len(t) == 20 for t, _ in fused)
    alone = asyncio.run(asyncio.wait_for(run(torch_engine(np_params), [reqs[1]]), RUN_S))
    assert alone[0] == fused[1]


def test_recompute_preemption_keeps_streams(weights):
    """A pool too small for both lanes' growth preempts one by recompute;
    every stream equals the roomy pool's."""
    _, _, np_params = weights
    reqs = [request([1, 2, 3], 40), request([6, 5, 4], 40)]

    async def run(engine):
        try:
            return await asyncio.wait_for(
                asyncio.gather(*[collect(engine, r) for r in reqs]), WAIT_S
            )
        finally:
            await engine.stop()

    roomy = asyncio.run(asyncio.wait_for(run(torch_engine(np_params)), RUN_S))
    tight_eng = torch_engine(np_params, num_pages=17)
    tight = asyncio.run(asyncio.wait_for(run(tight_eng), RUN_S))
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

    asyncio.run(asyncio.wait_for(body(), WAIT_S))


def test_killed_before_its_stream_is_read_frees_its_lane(weights):
    """A consumer that gives up before reading the stream at all (an HTTP
    deadline that expires while the pipeline is being set up) kills the
    context of a request the engine already holds: its lane is freed long
    before its 4000 tokens, and the next request is served."""
    _, _, np_params = weights

    async def body():
        engine = torch_engine(np_params, max_batch_size=1, max_seq_len=4096, num_pages=1100)
        try:
            stream = await engine.generate(
                Context.new(PreprocessedRequest.from_dict(request([1, 2, 3], 4000)))
            )
            await asyncio.sleep(0.05)
            stream.ctx.kill()
            for _ in range(500):
                if engine.sched.num_active == 0 and not engine.sched.waiting:
                    break
                await asyncio.sleep(0.01)
            assert engine.sched.num_active == 0 and engine.kv.allocator.used_pages == 0
            assert engine.tokens_generated < 2000
            got, finish = await collect(engine, request([9, 8, 7], 5))
            assert len(got) == 5 and finish == "length"
        finally:
            await engine.stop()

    asyncio.run(asyncio.wait_for(body(), WAIT_S))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_classic_rectangle_and_penalized_streams_match_jax(served, config):
    got = served[config]
    port, eng = got["port"], got["engine"]
    assert port == got["ref"]
    assert eng.kv.allocator.used_pages == 0
    assert eng.metrics().gpu_prefix_cache_hit_rate > 0, "no prefix hit"
    kinds = eng.dispatches
    if config == "classic":
        assert kinds.get("chunk") and kinds.get("prefill") and kinds.get("decode_block")
        assert "unified" not in kinds
    elif config == "rectangle":
        assert kinds.get("unified") and kinds.get("decode_block")
        assert set(eng.dispatches_by_k) == {1}
    else:
        # penalized lanes get tokens, and classic ticks ran while they held
        # slots
        assert all(len(t) == 10 and f == "length" for t, f in port[5:])
        assert kinds.get("decode_block") and kinds.get("prefill")


def test_unpenalized_lanes_agree_across_configs(weights, served):
    streams = [served[c]["port"][:5] for c in CONFIGS]
    assert streams[0] == streams[1] == streams[2]
    # the penalties changed what the penalized lanes sample
    plain = [request(r["token_ids"], 10) for r in penalized_lanes()]

    async def run(engine):
        try:
            return await asyncio.wait_for(
                asyncio.gather(*[collect(engine, r) for r in plain]), WAIT_S
            )
        finally:
            await engine.stop()

    unpenalized = asyncio.run(asyncio.wait_for(run(torch_engine(weights[2])), RUN_S))
    for config in ("classic", "penalized"):
        got = served[config]["port"][5:]
        assert all(a != b for a, b in zip(got, unpenalized))


def test_penalized_arrival_mid_mixed_prefill_matches_jax(weights):
    """A penalized request admitted while a mixed prefill is mid-flight
    turns the tick classic: the pending lane drains to the classic path
    (one suffix dispatch from its page-aligned progress) and both streams
    equal the JAX engine's."""
    jcfg, jparams, np_params = weights
    kw = dict(mixed_token_budget=8, max_seq_len=128, num_pages=128)
    long_req = request(list(range(1, 41)), 6)
    pen_req = request([9, 8, 7, 6], 6, frequency_penalty=0.5)

    async def body(engine):
        try:
            t_a = asyncio.ensure_future(collect(engine, long_req))
            for _ in range(400):
                await asyncio.sleep(0.005)
                if any(s is not None and s.prefilling for s in engine.sched.slots):
                    break
            t_b = asyncio.ensure_future(collect(engine, pen_req))
            return await asyncio.wait_for(asyncio.gather(t_a, t_b), WAIT_S)
        finally:
            await engine.stop()

    eng = torch_engine(np_params, **kw)
    port = asyncio.run(asyncio.wait_for(body(eng), RUN_S))
    assert eng.dispatches.get("unified") and eng.dispatches.get("prefill")
    ref = asyncio.run(
        asyncio.wait_for(body(JaxEngine(jcfg, jparams, JaxEngineConfig(**{**ENGINE, **kw}))), RUN_S)
    )
    assert port == ref
    assert [len(t) for t, _ in port] == [6, 6]


def test_penalty_history_survives_recompute_preemption(weights):
    """A pool too small for both penalized lanes' growth preempts one by
    recompute; the histogram rebuilt from the folded prompt still counts
    the earlier output as output, so the streams equal the roomy pool's
    and the JAX engine's."""
    jcfg, jparams, np_params = weights
    reqs = [
        request([1, 2, 3], 40, frequency_penalty=0.6),
        request([6, 5, 4], 40, repetition_penalty=1.2, presence_penalty=0.4),
    ]

    async def run(engine):
        try:
            return await asyncio.wait_for(
                asyncio.gather(*[collect(engine, r) for r in reqs]), WAIT_S
            )
        finally:
            await engine.stop()

    tight_eng = torch_engine(np_params, num_pages=17)
    tight = asyncio.run(asyncio.wait_for(run(tight_eng), RUN_S))
    assert tight_eng.sched.preempt_recompute > 0
    assert tight == asyncio.run(asyncio.wait_for(run(torch_engine(np_params)), RUN_S))
    assert tight == asyncio.run(
        asyncio.wait_for(run(JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE))), RUN_S)
    )
    # the fold itself: two generated tokens absorbed into the prompt stay
    # output (count 1), the prompt proper carries the prompt flag
    seq = SeqState.from_request(
        "x", PreprocessedRequest.from_dict(reqs[0]), tight_eng.sched.block_size
    )
    seq.prompt = seq.prompt + [41, 42]
    seq.prior_generated = 2
    toks, amounts = tight_eng._penalty_history(seq)
    assert toks == [41, 42, 1, 2, 3]
    assert amounts == [1, 1] + [PROMPT_FLAG] * 3


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEngine.random_init(ModelConfig.tiny())
    eng = TorchEngine.random_init(ModelConfig.tiny(), EngineConfig(num_pages=8), device="cpu")
    assert eng.kv.pages.device.type == "cpu"
