"""Pooled embeddings in the port against the JAX package.

``embed_step`` on the same weights and inputs as the JAX step (unit
vectors within 1e-5, zero rows for pad lanes, the pool untouched);
``TorchEngine.embed`` groups and pads its inputs as ``JaxEngine.embed``
does (the same step shapes, in the same order) and returns the same
vectors in input order; an embedding call interleaved with running
``generate()`` streams changes none of their tokens; and both engines
refuse the same inputs with the same messages.  Every wait is bounded.
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
from dynamo_tpu_torch.engine import engine as engine_mod
from dynamo_tpu_torch.engine import step as tstep
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime.engine import Context

ENGINE = dict(max_batch_size=4, max_seq_len=96, page_size=4, num_pages=64)
WAIT_S = 60
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run
# six inputs over two groups of max_batch_size: 4 lanes, then 2
INPUTS = [[(5 * i + 7 * j) % 250 + 1 for j in range(n)] for i, n in enumerate([30, 3, 17, 1, 64, 9])]


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


def test_embed_step_matches_jax(weights):
    jcfg, jparams, np_params = weights
    cfg = ModelConfig.tiny()
    tparams = params_from_numpy(np_params, cfg, device="cpu")
    seq_lens = np.array([16, 9, 1, 0], np.int32)
    rs = np.random.default_rng(11)
    tokens = rs.integers(1, cfg.vocab_size, (4, 16)).astype(np.int32)
    pool = np.ones((cfg.num_layers, 2, 4, 4, cfg.num_kv_heads, cfg.head_dim), np.float32)
    ref = np.asarray(jstep.embed_step(
        jparams, jcfg, jnp.asarray(pool), jnp.asarray(tokens), jnp.asarray(seq_lens)
    ))
    tpool = torch.from_numpy(pool.copy())
    with torch.inference_mode():
        got = tstep.embed_step(
            tparams, cfg, tpool, torch.from_numpy(tokens).long(),
            torch.from_numpy(seq_lens).long(),
        ).numpy()
    assert got.shape == ref.shape == (4, cfg.hidden_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got[:3], axis=1), 1.0, atol=1e-5)
    assert not got[3].any(), "a pad lane must come out as a zero row"
    assert (tpool.numpy() == pool).all(), "embedding wrote the pool"


def _spy(monkeypatch, module, attr):
    """Record the (batch, bucket, lengths) of each call of ``module.attr``."""
    calls = []
    inner = getattr(module, attr)

    def spy(params, cfg, kv, tokens, seq_lens):
        calls.append((tuple(tokens.shape), [int(n) for n in np.asarray(seq_lens)]))
        return inner(params, cfg, kv, tokens, seq_lens)

    monkeypatch.setattr(module, attr, spy)
    return calls


def test_embed_groups_and_pads_as_jax(weights, monkeypatch):
    jcfg, jparams, np_params = weights
    jcalls = _spy(monkeypatch, jstep, "embed_step")
    tcalls = _spy(monkeypatch, engine_mod, "embed_step")
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE))
    teng = torch_engine(np_params)
    ref = asyncio.run(asyncio.wait_for(jeng.embed(INPUTS), WAIT_S))
    got = asyncio.run(asyncio.wait_for(teng.embed(INPUTS), WAIT_S))
    asyncio.run(asyncio.wait_for(teng.stop(), RUN_S))
    # sorted by length, groups of max_batch_size, pow2 batch, one bucket each
    assert tcalls == jcalls == [((4, 32), [1, 3, 9, 17]), ((2, 64), [30, 64])]
    assert teng.dispatches == {"embed": 2}
    assert len(got) == len(INPUTS)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5, rtol=0)
    # input order is kept: each vector equals its input embedded alone
    alone = torch_engine(np_params)
    solo = asyncio.run(asyncio.wait_for(alone.embed([INPUTS[2]]), WAIT_S))
    asyncio.run(asyncio.wait_for(alone.stop(), RUN_S))
    np.testing.assert_allclose(solo[0], got[2], atol=1e-5, rtol=0)


def _request(tokens, max_tokens) -> dict:
    return {
        "token_ids": list(tokens),
        "stop_conditions": {"max_tokens": max_tokens},
        "sampling_options": {"temperature": 0.0},
        "eos_token_ids": [],
    }


async def _tokens(engine, req):
    stream = await engine.generate(Context.new(PreprocessedRequest.from_dict(req)))
    out = []
    async for item in stream:
        assert not item.is_error(), item.error_message()
        out += (item.data or {}).get("token_ids") or []
    return out


@pytest.mark.parametrize("async_dispatch", [True, False], ids=["async", "serial"])
def test_embed_between_ticks_leaves_streams_unchanged(weights, async_dispatch):
    """Embedding calls land between the ticks of running streams: every
    stream's tokens equal those of a run without them, and each call's
    vectors equal an idle engine's."""
    np_params = weights[2]
    reqs = [_request([3 + i, 9, 27, 81 % 50, 4 * i + 1], 24) for i in range(3)]

    async def run(engine, with_embeds):
        try:
            streams = [asyncio.ensure_future(_tokens(engine, r)) for r in reqs]
            vecs = []
            while with_embeds and len(vecs) < 3:
                await asyncio.sleep(0)
                vecs.append(await engine.embed(INPUTS[:2]))
            return await asyncio.gather(*streams), vecs
        finally:
            await engine.stop()

    plain, _ = asyncio.run(asyncio.wait_for(
        run(torch_engine(np_params, async_dispatch=async_dispatch), False), WAIT_S))
    eng = torch_engine(np_params, async_dispatch=async_dispatch)
    mixed, vecs = asyncio.run(asyncio.wait_for(run(eng, True), WAIT_S))
    assert mixed == plain
    assert all(len(t) == 24 for t in mixed)
    assert eng.dispatches["embed"] == 3 and eng.dispatches["unified"]
    idle = torch_engine(np_params)
    want = asyncio.run(asyncio.wait_for(idle.embed(INPUTS[:2]), WAIT_S))
    asyncio.run(asyncio.wait_for(idle.stop(), RUN_S))
    for v in vecs:
        np.testing.assert_allclose(v, want, atol=1e-5, rtol=0)


def test_embed_refuses_what_jax_refuses(weights):
    jcfg, jparams, np_params = weights
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE))
    teng = torch_engine(np_params)
    for bad in ([[1, 2], []], [list(range(1, 98))]):
        messages = []
        for eng in (jeng, teng):
            with pytest.raises(ValueError) as err:
                asyncio.run(asyncio.wait_for(eng.embed(bad), RUN_S))
            messages.append(str(err.value))
        assert messages[1] == messages[0]
    assert asyncio.run(asyncio.wait_for(teng.embed([]), RUN_S)) == []
    assert asyncio.run(asyncio.wait_for(jeng.embed([]), RUN_S)) == []
    assert "embed" not in teng.dispatches
    asyncio.run(asyncio.wait_for(teng.stop(), RUN_S))
