"""Prompt scoring (echo+logprobs) in the port against the JAX package.

``score_prompt_step`` on the same weights and prompts as the JAX step
(token ids and top ids equal, logprobs within 1e-5), at a bucket short of
one scoring chunk and at one past it (two chunks of logits).  Then through
``TorchEngine.generate`` against ``JaxEngine.generate``: requests with
``prompt_logprobs`` carry per-prompt-token entries on their first frame
(entry 0 ``[token, None, None]``), equal ids and logprobs within 1e-4, in
the mixed path (the final chunk of a mixed prefill, a prefix hit), the
classic path (a single chunked prefill and prefill groups, a suffix
prefill on a prefix hit), and the pipelined loop with its readiness probe
pinned to "not ready".  A lane preempted by recompute after its first
token sends its prompt logprobs once.  The pipelined loop waits for the
scoring rows' own event before a commit reads them.  Every wait is
bounded.
"""

from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import step as jstep
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import engine as engine_mod
from dynamo_tpu_torch.engine import step as tstep
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import (
    InflightPrefill,
    InflightPrefillGroup,
    InflightUnified,
    Result,
    TorchEngine,
)
from dynamo_tpu_torch.engine.scheduler import SeqState
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime.engine import Context

ENGINE = dict(
    max_batch_size=4, max_seq_len=96, page_size=4, num_pages=64,
    mixed_token_budget=16,
)
SHARED = [(7 * i + 3) % 250 + 1 for i in range(12)]  # three whole pages
WAIT_S = 60
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run
CONFIGS = {
    "mixed": {},
    "classic": dict(mixed_batching=False, prefill_chunk_tokens=8),
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


def request(tokens, max_tokens=6, prompt_logprobs=None) -> dict:
    req = {
        "token_ids": [int(t) for t in tokens],
        "stop_conditions": {"max_tokens": max_tokens},
        "sampling_options": {"temperature": 0.0},
        "eos_token_ids": [],
    }
    if prompt_logprobs is not None:
        req["prompt_logprobs"] = prompt_logprobs
    return req


async def collect(engine, req: dict, first=None, after=None) -> dict:
    """One stream: its tokens and every frame's prompt logprobs."""
    if after is not None:
        await after.wait()
    if isinstance(engine, JaxEngine):
        stream = await engine.generate(JaxContext.new(JaxRequest.from_dict(req)))
    else:
        stream = await engine.generate(Context.new(PreprocessedRequest.from_dict(req)))
    out = {"tokens": [], "plp": []}
    async for item in stream:
        assert not item.is_error(), item.error_message()
        data = item.data or {}
        out["tokens"] += data.get("token_ids") or []
        if data.get("prompt_logprobs") is not None:
            out["plp"].append(data["prompt_logprobs"])
        if out["tokens"] and first is not None:
            first.set()
    return out


async def serve(engine, reqs, then=None):
    """``reqs[1]`` and ``reqs[2]`` share a prefix: the second starts once
    the first has streamed, so it hits the prefix cache.  ``then(engine)``
    runs once every stream has ended, before the engine stops."""
    try:
        first = asyncio.Event()
        jobs = [
            collect(engine, reqs[0]),
            collect(engine, reqs[1], first=first),
            collect(engine, reqs[2], after=first),
        ] + [collect(engine, r) for r in reqs[3:]]
        out = await asyncio.wait_for(asyncio.gather(*jobs), WAIT_S)
        if then is not None:
            await asyncio.wait_for(then(engine), WAIT_S)
        return out
    finally:
        await engine.stop()


def workload():
    rs = np.random.default_rng(5)
    toks = lambda n: rs.integers(1, 256, n).tolist()  # noqa: E731
    return [
        request(toks(37), 6, prompt_logprobs=3),  # chunked
        request(SHARED + toks(3), 6, prompt_logprobs=0),  # chosen logprobs only
        request(SHARED + toks(5), 6, prompt_logprobs=2),  # prefix hit
        request(toks(6), 8),  # no echo
        request(toks(9), 5, prompt_logprobs=1),
    ]


def assert_entries_close(got, ref, tol=1e-4):
    assert len(got) == len(ref)
    assert got[0][1:] == [None, None] and ref[0][1:] == [None, None]
    for g, r in zip(got, ref):
        assert g[0] == r[0]
        if r[1] is None:
            assert g[1] is None and g[2] is None
            continue
        assert g[1] <= 0 and abs(g[1] - r[1]) <= tol, (g[1], r[1])
        if r[2] is None:
            assert g[2] is None
            continue
        assert [t for t, _ in g[2]] == [t for t, _ in r[2]]
        np.testing.assert_allclose(
            [lp for _, lp in g[2]], [lp for _, lp in r[2]], atol=tol, rtol=0
        )
        assert [lp for _, lp in g[2]] == sorted((lp for _, lp in g[2]), reverse=True)


def assert_streams_match(port, ref, reqs):
    for p, r, req in zip(port, ref, reqs):
        assert p["tokens"] == r["tokens"]
        assert len(p["tokens"]) == req["stop_conditions"]["max_tokens"]
        if "prompt_logprobs" not in req:
            assert p["plp"] == [] and r["plp"] == []
            continue
        # one frame carries them, covering every prompt token
        assert len(p["plp"]) == 1 and len(r["plp"]) == 1
        assert [e[0] for e in p["plp"][0]] == req["token_ids"]
        assert_entries_close(p["plp"][0], r["plp"][0])


# -- the step -----------------------------------------------------------------


@pytest.mark.parametrize("top_n", [0, 8])
@pytest.mark.parametrize("shape", ["one-chunk", "two-chunks"])
def test_score_prompt_step_matches_jax(weights, shape, top_n):
    """Pad lanes and rows past a lane's length are never read; every other
    row: the target id (the next prompt token), its logprob and the top
    ids equal the JAX step's."""
    jcfg, jparams, np_params = weights
    cfg = ModelConfig.tiny()
    tparams = params_from_numpy(np_params, cfg, device="cpu")
    if shape == "one-chunk":
        seq_lens = np.array([16, 9, 1, 0], np.int32)
        T = 16
    else:  # past SCORE_CHUNK: the logits go in two chunks
        seq_lens = np.array([600], np.int32)
        T = tstep.SCORE_CHUNK + 128
    rs = np.random.default_rng(7)
    tokens = rs.integers(1, cfg.vocab_size, (len(seq_lens), T)).astype(np.int32)
    pool = np.zeros((cfg.num_layers, 2, 4, 4, cfg.num_kv_heads, cfg.head_dim), np.float32)
    ref = np.asarray(jstep.score_prompt_step(
        jparams, jcfg, jnp.asarray(pool), jnp.asarray(tokens), jnp.asarray(seq_lens), top_n,
    ))
    tpool = torch.from_numpy(pool.copy())
    with torch.inference_mode():
        got = tstep.score_prompt_step(
            tparams, cfg, tpool, torch.from_numpy(tokens).long(),
            torch.from_numpy(seq_lens).long(), top_n,
        ).numpy()
    assert got.shape == ref.shape == (len(seq_lens), T, 2 + 2 * top_n)
    assert not tpool.any(), "scoring wrote the pool"
    for b, n in enumerate(seq_lens):
        rows = slice(0, max(int(n) - 1, 0))
        g, r = got[b, rows], ref[b, rows]
        np.testing.assert_array_equal(g[:, 0], tokens[b, 1:n])
        np.testing.assert_array_equal(g[:, 0], r[:, 0])
        np.testing.assert_allclose(
            g[:, 1].view(np.float32), r[:, 1].view(np.float32), atol=1e-5, rtol=0
        )
        if top_n:
            np.testing.assert_array_equal(g[:, 2 : 2 + top_n], r[:, 2 : 2 + top_n])
            np.testing.assert_allclose(
                g[:, 2 + top_n :].view(np.float32), r[:, 2 + top_n :].view(np.float32),
                atol=1e-5, rtol=0,
            )


# -- through generate() ---------------------------------------------------------


@pytest.fixture(scope="module")
def served(weights):
    """Each config on both engines, and the mixed config once more on the
    port with the readiness probe pinned to "not ready"."""
    jcfg, jparams, np_params = weights
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, kw in CONFIGS.items():
            reqs = workload()
            eng = torch_engine(np_params, **kw)
            port = asyncio.run(asyncio.wait_for(serve(eng, reqs), RUN_S))
            jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE, **kw))
            ref = asyncio.run(asyncio.wait_for(serve(jeng, reqs), RUN_S))
            out[name] = dict(port=port, ref=ref, engine=eng, reqs=reqs)
        reqs = workload()
        eng = torch_engine(np_params)
        mp.setattr(engine_mod, "_handles_ready", lambda res: False)
        out["not-ready"] = dict(
            port=asyncio.run(
                asyncio.wait_for(serve(eng, reqs), RUN_S)
            ), ref=out["mixed"]["ref"], engine=eng,
            reqs=reqs,
        )
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", list(CONFIGS) + ["not-ready"])
def test_echo_entries_match_jax(served, name):
    run = served[name]
    assert_streams_match(run["port"], run["ref"], run["reqs"])
    eng = run["engine"]
    # one scoring dispatch per echo request, none for the plain one
    assert eng.dispatches["prompt_score"] == 4
    assert eng.metrics().gpu_prefix_cache_hit_rate > 0, "no prefix hit"
    assert eng.kv.allocator.used_pages == 0 and not eng._pending_injects
    if name == "classic":
        # every site: a chunked single prefill, groups, suffix prefills
        assert eng.dispatches.get("chunk") and eng.prefill_dispatches["suffix"]
        assert "unified" not in eng.dispatches
    else:
        assert "prefill" not in eng.dispatches and eng.dispatches["unified"]


def test_preempted_lane_sends_prompt_logprobs_once(weights):
    """A pool too small for both lanes' growth preempts one by recompute
    after its first token: each stream carries its prompt logprobs once,
    over the prompt it was sent with, equal to the JAX engine's (roomy
    pool)."""
    jcfg, jparams, np_params = weights
    reqs = [request([1, 2, 3, 4, 5], 40, prompt_logprobs=2),
            request([6, 5, 4, 3], 40, prompt_logprobs=1)]

    async def run(engine):
        try:
            return await asyncio.wait_for(
                asyncio.gather(*[collect(engine, r) for r in reqs]), WAIT_S
            )
        finally:
            await engine.stop()

    tight = torch_engine(np_params, num_pages=17, async_dispatch=False)
    got = asyncio.run(asyncio.wait_for(run(tight), RUN_S))
    assert tight.sched.preempt_recompute > 0
    assert tight.dispatches["prompt_score"] == 2
    ref = asyncio.run(
        asyncio.wait_for(run(JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE))), RUN_S)
    )
    for g, r, req in zip(got, ref, reqs):
        assert g["tokens"] == r["tokens"]
        assert len(g["plp"]) == 1
        assert [e[0] for e in g["plp"][0]] == req["token_ids"]
        assert_entries_close(g["plp"][0], r["plp"][0])


class _Event:
    """A CUDA event's interface with a settable readiness."""

    def __init__(self) -> None:
        self.ready = False
        self.waited = False

    def query(self) -> bool:
        return self.ready

    def synchronize(self) -> None:
        self.waited = True


def test_pipeline_waits_for_the_scoring_rows(weights):
    """A generation whose sampled rows have landed but whose scoring rows
    have not is not ready, in every record that carries a first token; the
    commit reads the scoring rows through their own event."""
    eng = torch_engine(weights[2])
    B = ENGINE["max_batch_size"]
    seq = SeqState.from_request(
        "r", PreprocessedRequest.from_dict(request([5, 6, 7], 4, prompt_logprobs=1)), 4
    )
    ev = _Event()
    pf = InflightPrefill(
        tok=torch.zeros(1, dtype=torch.long), seq=seq, slot=0, life=0,
        sampled=Result(torch.zeros((1, 2), dtype=torch.int32)),
        prompt_lp=Result(torch.zeros((1, 4, 4), dtype=torch.int32), ev),
    )
    records = [
        pf,
        InflightPrefillGroup(Result(torch.zeros((1, 2), dtype=torch.int32)), [pf]),
        InflightUnified(
            Result(torch.zeros((B, 1, 2), dtype=torch.int32)), [None] * B, [-1] * B, [pf]
        ),
    ]
    for rec in records:
        ev.ready = False
        assert not eng._entries_ready([rec])
        ev.ready = True
        assert eng._entries_ready([rec])
    ev.waited = False
    eng._commit_all([pf])  # the lane holds no slot: nothing commits
    assert ev.waited
    asyncio.run(asyncio.wait_for(eng.stop(), RUN_S))
