"""Multimodal (llava-style soft prompt) prefill in the port against the JAX
package.

The vision encoder (``vision.encode_image``) on the JAX encoder's weights
within 1e-5, its random parameters in the JAX layout, and
``decode_image_payload``'s forms; ``prefill_mm_and_sample``
rows and pool writes against the JAX step (lanes with soft prompts of
different lengths, a text lane, a pad lane, penalties on and off);
through ``generate()``, greedy streams of soft-prompt requests beside text
requests identical to the JAX engine's, under the mixed and classic
paths; the JAX package's own identity (``tests/test_multimodal.py``): the
model's embedding rows fed as ``mm_embeds`` reproduce the token prompt's
greedy stream; two images over the same placeholder ids share no prefix
page; rows of another width than the model's are refused at
``generate()``; and a soft-prompt lane is never chunked nor packed into a
mixed dispatch.  Every wait is bounded.
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
from dynamo_tpu.vision import VisionConfig as JaxVisionConfig
from dynamo_tpu.vision import decode_image_payload as jax_decode_image_payload
from dynamo_tpu.vision import encode_image as jax_encode_image
from dynamo_tpu.vision import init_vision_params as jax_init_vision_params
from dynamo_tpu_torch.engine import step as tstep
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.scheduler import Scheduler
from dynamo_tpu_torch.engine.weights import params_from_numpy, vision_params_from_numpy
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.vision import (
    VisionConfig,
    decode_image_payload,
    encode_image,
    init_vision_params,
)

from tests.test_torch_step import CFG, _check_packed, _check_written, _prefill_inputs, _samplers
from tests.test_torch_ops import _free_compiled_programs  # noqa: F401 (autouse)

ENGINE = dict(
    max_batch_size=4, max_seq_len=96, page_size=4, num_pages=64,
    mixed_token_budget=16,
)
WAIT_S = 60
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run
CONFIGS = {
    "mixed": dict(prefill_chunk_tokens=8),
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


def request(tokens, max_tokens=8, mm=None) -> dict:
    req = {
        "token_ids": [int(t) for t in tokens],
        "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True},
        "sampling_options": {"temperature": 0.0},
        "eos_token_ids": [],
    }
    if mm is not None:
        req["mm_embeds"] = np.asarray(mm, np.float32).tolist()
        req["token_ids"] = [0] * len(mm) + req["token_ids"]
    return req


async def collect(engine, req: dict):
    if isinstance(engine, JaxEngine):
        stream = await engine.generate(JaxContext.new(JaxRequest.from_dict(req)))
    else:
        stream = await engine.generate(Context.new(PreprocessedRequest.from_dict(req)))
    tokens = []
    async for item in stream:
        assert not item.is_error(), item.error_message()
        tokens += (item.data or {}).get("token_ids") or []
    return tokens


async def serve(engine, reqs):
    try:
        return await asyncio.wait_for(
            asyncio.gather(*[collect(engine, r) for r in reqs]), WAIT_S
        )
    finally:
        await engine.stop()


# -- the vision encoder ---------------------------------------------------------


def test_encode_image_matches_jax():
    jcfg = JaxVisionConfig.tiny(out_dim=48)
    jparams = jax_init_vision_params(jcfg, jax.random.PRNGKey(0))
    params = vision_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    imgs = np.random.default_rng(0).random((2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jax_encode_image(jparams, jcfg, imgs))
    got = encode_image(params, VisionConfig.tiny(out_dim=48), torch.from_numpy(imgs)).numpy()
    assert got.shape == ref.shape == (2, 16, 48)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    # a changed patch reaches the rows
    imgs[0, :8, :8] = 0.0
    moved = encode_image(params, VisionConfig.tiny(out_dim=48), torch.from_numpy(imgs)).numpy()
    assert np.abs(moved[0] - got[0]).max() > 1e-4


def test_init_vision_params_has_the_jax_layout():
    """The port's random parameters have the JAX pytree's names and shapes,
    and encode pixels into finite soft-prompt rows."""
    cfg = VisionConfig.tiny(out_dim=48)
    jparams = jax_init_vision_params(JaxVisionConfig.tiny(out_dim=48), jax.random.PRNGKey(0))
    params = init_vision_params(cfg, 0, device="cpu")
    shapes = lambda p: jax.tree.map(lambda a: tuple(a.shape), p)  # noqa: E731
    assert shapes({k: v for k, v in params.items() if k != "layers"}) == shapes(
        {k: v for k, v in jparams.items() if k != "layers"})
    assert [shapes(lp) for lp in params["layers"]] == [shapes(lp) for lp in jparams["layers"]]
    rows = encode_image(params, cfg, torch.rand((1, 32, 32, 3)))
    assert rows.shape == (1, cfg.num_patches, 48) and torch.isfinite(rows).all()


def test_decode_image_payload_forms_match_jax():
    """Decoded pixels (a nested list, a smaller or a larger array) are padded
    or cropped as the JAX decode does; byte and base64 payloads that no
    decoder reads raise in both."""
    rs = np.random.RandomState(3)
    small = [[[0.25, 0.5, 0.75]] * 4] * 4
    for payload in (small, rs.rand(5, 11, 3).astype(np.float32)):
        got = decode_image_payload(payload, 8, device="cpu").numpy()
        ref = np.asarray(jax_decode_image_payload(payload, 8, allow_pseudo=False))
        assert got.shape == (8, 8, 3)
        np.testing.assert_array_equal(got, ref)
    for payload in (b"not an image", "bm90IGFuIGltYWdl"):
        with pytest.raises(ValueError):
            decode_image_payload(payload, 8, device="cpu")
        with pytest.raises(ValueError):
            jax_decode_image_payload(payload, 8, allow_pseudo=False)


# -- the step -----------------------------------------------------------------


@pytest.mark.parametrize("penalties", [False, True], ids=["plain", "penalized"])
def test_prefill_mm_and_sample_matches_jax(penalties):
    """Soft prompts of 5 and 3 rows (M padded to 8), a text lane and a pad
    lane: first tokens, their logprobs and the pool rows written equal the
    JAX step's."""
    jcfg = JaxModelConfig.tiny(**CFG)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = ModelConfig.tiny(**CFG)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    seq_lens = np.array([16, 9, 7, 0], np.int32)
    mm_len = np.array([5, 3, 0, 0], np.int32)
    B, T, M = len(seq_lens), 16, 8
    rs, pool, perm, tokens = _prefill_inputs(5, B, T)
    mm = (0.05 * rs.standard_normal((B, M, cfg.hidden_size))).astype(np.float32)
    table = perm[: B * T // 8].reshape(B, T // 8).astype(np.int32)
    table[3] = 0
    js, ts = _samplers(B, penalties)
    jp, jpool = jstep.prefill_mm_and_sample(
        jparams, jcfg, jnp.asarray(pool), jnp.asarray(tokens), jnp.asarray(seq_lens),
        jnp.asarray(table), jnp.asarray(mm), jnp.asarray(mm_len),
        jax.random.PRNGKey(0), js, 2, penalties,
    )
    tpool = torch.from_numpy(pool.copy())
    with torch.inference_mode():
        tp = tstep.prefill_mm_and_sample(
            tparams, cfg, tpool, torch.from_numpy(tokens).long(),
            torch.from_numpy(seq_lens).long(), torch.from_numpy(table),
            torch.from_numpy(mm), torch.from_numpy(mm_len).long(), ts, 2, penalties,
        )
    live = seq_lens > 0
    _check_packed(np.asarray(jp)[live], tp[live], 2)
    _check_written(jpool, tpool.numpy(), table, seq_lens)
    # the soft prompt reaches the trunk: without it lane 0 writes other rows
    plain = torch.from_numpy(pool.copy())
    with torch.inference_mode():
        tstep.prefill_and_sample(
            tparams, cfg, plain, torch.from_numpy(tokens).long(),
            torch.from_numpy(seq_lens).long(), torch.from_numpy(table), ts, 2,
        )
    page = table[0, 0]
    assert not torch.equal(plain[:, :, page], tpool[:, :, page])


# -- through generate() ---------------------------------------------------------


def soft_prompts(rows: int, seed: int) -> np.ndarray:
    rs = np.random.default_rng(seed)
    return 0.05 * rs.standard_normal((rows, ModelConfig.tiny().hidden_size))


def mm_workload():
    rs = np.random.default_rng(2)
    toks = lambda n: rs.integers(1, 256, n).tolist()  # noqa: E731
    return [
        request(toks(6), 10, mm=soft_prompts(30, 1)),  # longer than a chunk
        request(toks(37), 8),  # text, chunked
        request(toks(3), 9, mm=soft_prompts(4, 2)),
        request(toks(5), 7),
    ]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_mm_streams_match_jax(weights, config):
    jcfg, jparams, np_params = weights
    kw = CONFIGS[config]
    reqs = mm_workload()
    eng = torch_engine(np_params, **kw)
    port = asyncio.run(asyncio.wait_for(serve(eng, reqs), RUN_S))
    ref = asyncio.run(
        asyncio.wait_for(serve(JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE, **kw)), reqs), RUN_S)
    )
    assert port == ref
    assert [len(t) for t in port] == [10, 8, 9, 7]
    assert eng.dispatches["prefill"] >= 1
    assert eng.kv.allocator.used_pages == 0


def test_own_embedding_rows_reproduce_the_token_prompt(weights):
    """Feeding the model's own embedding rows as ``mm_embeds`` must give
    the plain token prompt's greedy stream exactly: the same values enter
    the trunk either way."""
    np_params = weights[2]
    prompt = [5, 9, 2, 6, 3, 1]
    eng = torch_engine(np_params)
    expect = asyncio.run(asyncio.wait_for(serve(eng, [request(prompt, 6)]), RUN_S))[0]
    rows = np_params["embed"][prompt[:4]]
    eng = torch_engine(np_params)
    got = asyncio.run(asyncio.wait_for(serve(eng, [request(prompt[4:], 6, mm=rows)]), RUN_S))[0]
    assert got == expect and len(got) == 6


def test_images_share_no_prefix(weights):
    """Two soft prompts over the same placeholder ids: the second request
    finds no cached prefix, registers no block, and streams as it does on
    a fresh engine."""
    np_params = weights[2]
    text = [7, 8, 9, 10]
    first = request(text, 6, mm=soft_prompts(12, 3))
    second = request(text, 6, mm=soft_prompts(12, 4))
    eng = torch_engine(np_params)

    async def both():
        try:
            return [await asyncio.wait_for(collect(eng, r), WAIT_S) for r in (first, second)]
        finally:
            await eng.stop()

    got = asyncio.run(asyncio.wait_for(both(), RUN_S))
    assert eng.metrics().gpu_prefix_cache_hit_rate == 0.0
    assert eng.kv.allocator.used_pages == 0
    alone = asyncio.run(asyncio.wait_for(serve(torch_engine(np_params), [second]), RUN_S))[0]
    assert got[1] == alone
    assert got[0] != got[1], "the soft prompt does not reach the trunk"


def test_soft_prompt_of_another_width_is_refused(weights):
    """Rows that are not the model's hidden size get an error frame at
    ``generate()``; the engine goes on serving."""
    np_params = weights[2]
    eng = torch_engine(np_params)

    async def body():
        try:
            bad = request([1, 2], 4, mm=np.zeros((3, 5)))
            stream = await eng.generate(Context.new(PreprocessedRequest.from_dict(bad)))
            items = [item async for item in stream]
            assert len(items) == 1 and items[0].is_error()
            assert "hidden size" in items[0].error_message()
            return await collect(eng, request([1, 2], 4))
        finally:
            await eng.stop()

    assert len(asyncio.run(asyncio.wait_for(body(), WAIT_S))) == 4


@pytest.mark.parametrize("config", list(CONFIGS))
def test_mm_lane_is_never_chunked_nor_mixed(weights, config, monkeypatch):
    """A 40-position soft-prompt lane, past both the chunk size and the
    mixed token budget, prefills in one classic dispatch."""
    np_params = weights[2]
    chunked = []
    inner = Scheduler.form_mixed_chunks

    def spy(self, *args, **kw):
        out = inner(self, *args, **kw)
        chunked.extend(ch.seq.mm_embeds is not None for ch in out)
        return out

    monkeypatch.setattr(Scheduler, "form_mixed_chunks", spy)
    eng = torch_engine(np_params, **CONFIGS[config])
    got = asyncio.run(
        asyncio.wait_for(serve(eng, [request([1, 2], 6, mm=soft_prompts(38, 5))]), RUN_S)
    )[0]
    assert len(got) == 6
    assert eng.dispatches["prefill"] == 1 and "chunk" not in eng.dispatches
    assert eng.prefill_dispatches == {"full": 1, "suffix": 0}
    assert not any(chunked)
