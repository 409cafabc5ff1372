"""The port's MoE MLP (Mixtral family) against the JAX package's.

The same layer weights (the JAX ``init_params`` pytree of an MoE config,
carried across by ``params_from_numpy``) and the same seeded numpy rows go
through the JAX ``_moe_mlp``/``_moe_mlp_dense`` and the port's:

* capacity-based dispatch equals JAX's within f32 tolerance (1e-5) with no
  drops (``K * cf >= E``), with drops (``K = 1, cf = 1.0``, as JAX's
  ``test_moe_capacity_drops_are_bounded``), at an odd row count, and
  where capacity binds at ``E = 8, K = 2, cf = 1``; equals the dense
  dispatch wherever nothing drops; and routes a constant row (every expert
  tied) to the lowest experts, as ``jax.lax.top_k`` does;
* the trunk's logits over a causal prompt, int8 weights included (the JAX
  ``quantize_params`` tree carried as ``(q, s)`` pairs, and the port's own
  layer-at-a-time int8 build equal to ``quantize_params``);
* ``TorchEngine`` against ``JaxEngine`` (E = 4, K = 2, so nothing drops):
  identical greedy streams under the default packed, the rectangle and
  the classic configurations, and the pipelined loop equal to the serial
  one;
* where capacity binds, a row's output depends on every other row of its
  dispatch, pad rows and idle lanes included, in both packages.  On the
  CPU the JAX engine runs its XLA attention references, which give an
  idle decode row attention over its prefix where the port (and the
  Pallas kernels) give zeros (ROADMAP C, "Fully masked query rows and
  idle lanes"), so the served streams part there.

Every wait is bounded (``asyncio.wait_for``).
"""

from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamo_tpu.engine.model as jax_model
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.quant import quantize_params as jax_quantize_params
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import model as port_model
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.quant import QuantizedTensor, quantize_params
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_ops import _free_compiled_programs  # noqa: F401 (autouse)

WAIT_S = 60  # bound on any one served batch
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run
TOL = 1e-5  # f32: the same products summed in another order
ENGINE = dict(max_batch_size=4, max_seq_len=96, page_size=4, num_pages=64,
              mixed_token_budget=16)
MOE = dict(num_experts=4, num_experts_per_tok=2)  # K * cf >= E: nothing drops


def moe_configs(**kw):
    return JaxModelConfig.tiny(**{**MOE, **kw}), ModelConfig.tiny(**{**MOE, **kw})


@pytest.fixture(scope="module")
def weights():
    """The JAX MoE pytree, its numpy leaves, and the port's params."""
    jcfg, cfg = moe_configs()
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, np_params, cfg, params_from_numpy(np_params, cfg, device="cpu")


def layer0(np_params):
    """Layer 0's leaves as JAX and as port arrays."""
    lp = {k: np.asarray(v[0]) for k, v in np_params["layers"].items()}
    return ({k: jnp.asarray(v) for k, v in lp.items()},
            {k: torch.from_numpy(v.copy()) for k, v in lp.items()})


def rows(n: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, 64)).astype(np.float32)


def kept_share(topi: torch.Tensor, C: int, E: int) -> float:
    """The share of assignments within capacity, counted here from the
    routing (the slot rule in plain Python)."""
    seen = [0] * E
    kept = 0
    for e in topi.reshape(-1).tolist():
        kept += seen[e] < C
        seen[e] += 1
    return kept / topi.numel()


CASES = {
    # E, K, cf, N
    "no-drops": (4, 2, 4.0, 16),
    "drops": (4, 1, 1.0, 16),
    "odd-n": (4, 2, 4.0, 13),
    "binds": (8, 2, 1.0, 9),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_mlp_matches_jax(case):
    E, K, cf, N = CASES[case]
    jcfg, cfg = moe_configs(num_experts=E, num_experts_per_tok=K, moe_capacity_factor=cf)
    np_params = jax.tree.map(np.asarray, jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
    jlp, tlp = layer0(np_params)
    x = rows(N)
    x[-2:] = 0.0  # constant rows tie on every expert
    ref = np.asarray(jax_model._moe_mlp(jlp, jnp.asarray(x), jcfg))
    got = port_model._moe_mlp(tlp, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    dense = port_model._moe_mlp_dense(tlp, torch.from_numpy(x), cfg).numpy()
    _, topi = port_model._route(tlp, torch.from_numpy(x), K)
    share = kept_share(topi, port_model.moe_capacity(N, cfg), E)
    if K * cf >= E:
        assert share == 1.0
        np.testing.assert_allclose(got, dense, atol=TOL, rtol=0)
    else:
        # capacity dropped assignments: the sparse dispatch is not the
        # dense one, in both packages alike
        assert share < 1.0
        assert np.abs(got - dense).max() > 1e-3


def test_capacity_is_jax_rule():
    for E, K, cf in [(4, 2, 2.0), (8, 2, 1.0), (4, 1, 1.0), (8, 2, 1.25), (3, 2, 2.0)]:
        _, cfg = moe_configs(num_experts=E, num_experts_per_tok=K, moe_capacity_factor=cf)
        for n in (1, 2, 7, 16, 33, 512):
            want = min(int(max(1, -(-n * K * cf // E))), n * K)
            assert port_model.moe_capacity(n, cfg) == want


def test_dense_dispatch_matches_jax(weights):
    jcfg, _, np_params, cfg, _ = weights
    jlp, tlp = layer0(np_params)
    x = rows(11, seed=3)
    ref = np.asarray(jax_model._moe_mlp_dense(jlp, jnp.asarray(x), jcfg))
    got = port_model._moe_mlp_dense(tlp, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_router_ties_take_the_lowest_experts(weights):
    """A constant row ties on every expert; ``jax.lax.top_k`` keeps the
    lower index, so does the port."""
    *_, cfg, tparams = weights
    _, tlp = layer0(jax.tree.map(np.asarray, weights[1]))
    zeros = torch.zeros(5, 64)
    _, topi = port_model._route(tlp, zeros, 2)
    assert topi.tolist() == [[0, 1]] * 5
    _, jtopi = jax.lax.top_k(jnp.zeros((5, 4), jnp.float32), 2)
    assert np.asarray(jtopi).tolist() == [[0, 1]] * 5


def test_pad_rows_take_capacity_in_both_packages():
    """Slots go in flat row order, so pad rows after every valid row (the
    packed layout's tail) only lose their own assignments; pad rows
    between valid ones (a lane's padding in the ``[B, S]`` rectangle, an
    idle lane's decode row) take capacity.  Where capacity binds,
    changing only such pad rows moves the later valid rows' outputs, in
    the JAX dispatch and in the port's alike; with ``K * cf >= E`` it
    never does."""
    for cf, binds in ((1.0, True), (4.0, False)):
        jcfg, cfg = moe_configs(num_experts=8, num_experts_per_tok=2, moe_capacity_factor=cf)
        np_params = jax.tree.map(np.asarray, jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
        jlp, tlp = layer0(np_params)
        valid = rows(12, seed=5)
        outs = {}
        at = np.r_[0:6, 16:22]  # the valid rows' places among the pad rows
        for pad_seed in (6, 7):
            pad = rows(20, seed=pad_seed)
            x = np.concatenate([valid[:6], pad[:10], valid[6:], pad[10:]])
            assert np.array_equal(x[at], valid)
            outs[pad_seed] = (
                np.asarray(jax_model._moe_mlp(jlp, jnp.asarray(x), jcfg))[at],
                port_model._moe_mlp(tlp, torch.from_numpy(x), cfg).numpy()[at],
            )
            # pad rows at the tail move nothing before them
            tail = np.concatenate([valid, pad])
            np.testing.assert_array_equal(
                port_model._moe_mlp(tlp, torch.from_numpy(tail), cfg).numpy()[:12],
                port_model._moe_mlp(tlp, torch.from_numpy(np.concatenate([valid, pad * 0])), cfg
                                    ).numpy()[:12],
            )
        for pkg in (0, 1):
            moved = np.abs(outs[6][pkg] - outs[7][pkg]).max()
            assert (moved > 1e-3) if binds else (moved == 0.0), (cf, pkg, moved)
        np.testing.assert_allclose(outs[6][1], outs[6][0], atol=TOL, rtol=0)


# -- the trunk ---------------------------------------------------------------


def jax_causal(q, k, v, kv_pages, layer):
    """Plain causal attention over the call's own rows (JAX)."""
    B, T, Hq, D = q.shape
    rep = Hq // k.shape[2]
    k = jnp.repeat(k, rep, axis=2)
    v = jnp.repeat(v, rep, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / jnp.sqrt(jnp.float32(D))
    s = jnp.where(jnp.tril(jnp.ones((T, T), bool)), s, -jnp.inf)
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v), kv_pages


def port_causal(q, k, v, kv_pages, layer):
    T, Hq, D = q.shape
    rep = Hq // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / D ** 0.5
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)


def trunk_logits(jparams, jcfg, tparams, cfg, T: int = 19):
    tokens = np.random.default_rng(2).integers(1, 256, T)
    jh, _ = jax_model.transformer(
        jparams, jcfg, jnp.asarray(tokens[None], jnp.int32),
        jnp.arange(T, dtype=jnp.int32)[None], jnp.zeros((jcfg.num_layers,)), jax_causal,
    )
    ref = np.asarray(jax_model.lm_logits(jparams, jcfg, jh))[0]
    with torch.inference_mode():
        th = port_model.transformer(
            tparams, cfg, torch.from_numpy(tokens), torch.arange(T), None, port_causal
        )
        got = port_model.lm_logits(tparams, cfg, th).numpy()
    return got, ref


def test_trunk_logits_match_jax(weights):
    jcfg, jparams, _, cfg, tparams = weights
    got, ref = trunk_logits(jparams, jcfg, tparams, cfg)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert (got.argmax(-1) == ref.argmax(-1)).all()


def test_int8_weights_match_jax_quantized_model(weights):
    """The JAX int8 tree (expert stacks quantized per expert and output
    channel, ``[L, E, 1, out]`` scales) carried as ``(q, s)`` pairs gives
    the JAX quantized trunk's logits; the port's own ``quantize_params``
    makes the same int8 data and scales, and its layer-at-a-time int8
    build equals ``quantize_params`` over its bf16-free float build."""
    jcfg, jparams, _, cfg, tparams = weights
    jq = jax_quantize_params(jparams, jcfg)

    def pairs(t):
        if type(t).__name__ == "QuantizedTensor":
            return (np.asarray(t.q), np.asarray(t.s))
        if isinstance(t, dict):
            return {k: pairs(v) for k, v in t.items()}
        return np.asarray(t)

    np_q = pairs(jq)
    tq = params_from_numpy(np_q, cfg, device="cpu")
    assert isinstance(tq["layers"]["w_gate"], QuantizedTensor)
    assert tuple(tq["layers"]["w_gate"].s.shape) == (2, 4, 1, 128)
    got, ref = trunk_logits(jq, jcfg, tq, cfg)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    mine = quantize_params(tparams, torch.float32)
    for k in ("w_gate", "w_up", "w_down", "wq"):
        assert torch.equal(mine["layers"][k].q, tq["layers"][k].q), k
        torch.testing.assert_close(mine["layers"][k].s, tq["layers"][k].s, atol=1e-7, rtol=0)
    built = port_model.init_params(cfg, 3, torch.device("cpu"), quantize="int8")
    whole = quantize_params(port_model.init_params(cfg, 3, torch.device("cpu")), torch.float32)
    for k, v in built["layers"].items():
        if isinstance(v, QuantizedTensor):
            assert torch.equal(v.q, whole["layers"][k].q) and torch.equal(v.s, whole["layers"][k].s)
        else:
            assert torch.equal(v, whole["layers"][k])


# -- the engines -------------------------------------------------------------


def request(tokens, max_tokens=8) -> dict:
    return {
        "token_ids": list(tokens),
        "stop_conditions": {"max_tokens": max_tokens},
        "sampling_options": {"temperature": 0.0},
        "eos_token_ids": [],
    }


def batch():
    """Five requests over four lanes: one chunked, two sharing a prefix,
    lanes finishing at different steps (idle lanes in decode dispatches)."""
    rs = np.random.default_rng(4)
    shared = [(7 * i + 3) % 250 + 1 for i in range(12)]
    return [
        request(rs.integers(1, 256, 37).tolist(), 10),  # over the budget: chunked
        request(shared + rs.integers(1, 256, 3).tolist(), 10),
        request(shared + rs.integers(1, 256, 5).tolist(), 10),
        request([5, 9, 2, 7], 12),
        request(rs.integers(1, 256, 6).tolist(), 14),
    ]


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


def run(engine, reqs):
    return asyncio.run(asyncio.wait_for(serve(engine, reqs), RUN_S))


CONFIGS = {
    "packed": {},
    "rectangle": dict(packed_ragged=False),
    "classic": dict(mixed_batching=False, prefill_chunk_tokens=8),
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_engine_streams_match_jax(weights, config):
    jcfg, jparams, np_params, cfg, _ = weights
    kw = CONFIGS[config]
    reqs = batch()
    port = run(TorchEngine(cfg, params_from_numpy(np_params, cfg, device="cpu"),
                           EngineConfig(**ENGINE, **kw), device="cpu"), reqs)
    serial = run(TorchEngine(cfg, params_from_numpy(np_params, cfg, device="cpu"),
                             EngineConfig(**ENGINE, **kw, async_dispatch=False),
                             device="cpu"), reqs)
    ref = run(JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE, **kw)), reqs)
    assert [len(t) for t in port] == [r["stop_conditions"]["max_tokens"] for r in reqs]
    assert port == ref
    assert serial == port


def test_binding_capacity_parts_on_idle_rows_on_the_cpu():
    """E = 8, K = 2, cf = 1, both serial loops, single-step dispatches:
    the MoE inputs of both packages agree call for call until a decode
    dispatch whose idle lane attends differently (the JAX CPU reference
    attends over its prefix, the port gives it zeros); from there that
    row takes other experts' capacity and the streams part."""
    jcfg, cfg = moe_configs(num_experts=8, moe_capacity_factor=1.0)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    kw = dict(async_dispatch=False, multistep_max_k=1)
    calls = {"jax": [], "port": []}
    jax_moe, port_moe = jax_model._moe_mlp, port_model._moe_mlp

    def spy_jax(lp, x, c):
        jax.debug.callback(
            lambda v: calls["jax"].append(np.asarray(v).reshape(-1, v.shape[-1]).copy()), x
        )
        return jax_moe(lp, x, c)

    def spy_port(lp, x, c):
        calls["port"].append(x.reshape(-1, x.shape[-1]).numpy().copy())
        return port_moe(lp, x, c)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_model, "_moe_mlp", spy_jax)
    mp.setattr(port_model, "_moe_mlp", spy_port)
    try:
        reqs = batch()
        port = run(TorchEngine(cfg, params_from_numpy(np_params, cfg, device="cpu"),
                               EngineConfig(**ENGINE, **kw), device="cpu"), reqs)
        ref = run(JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE, **kw)), reqs)
    finally:
        mp.undo()
    assert [len(t) for t in port] == [len(t) for t in ref]
    assert port != ref
    first = next(
        i for i, (a, b) in enumerate(zip(calls["jax"], calls["port"]))
        if a.shape != b.shape or np.abs(a - b).max() > 1e-4
    )
    a, b = calls["jax"][first], calls["port"][first]
    assert a.shape == b.shape and a.shape[0] <= ENGINE["max_batch_size"]  # a decode dispatch
    parted = np.abs(a - b).max(axis=1) > 1e-4
    # one idle lane's row parts, the live rows agree
    assert 0 < parted.sum() < a.shape[0]
