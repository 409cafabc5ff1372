"""The port's packed unified step and its multistep tail against the JAX
package's, on the same inputs and the same weights.

The JAX parameter pytree (``init_params``) crosses into the port through
``params_from_numpy``; the KV pool, page table, lane state and packed
token axis are made with numpy from a seed and handed to both.  The JAX
side runs on the CPU through its XLA references (no Pallas off the TPU),
the port through its ops' plain versions.

Greedy token columns, top-N ids, ``tokens``, ``seq_lens`` and ``active``
must be equal; logprobs and the pool (past trash page 0, which both sides
fill with garbage by design) agree within f32 tolerance, 1e-5 for the
pool and 1e-4 for log-softmax values of a 256-way vocabulary.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.engine.sampling import SamplingParams as JaxSampling
from dynamo_tpu.engine.step import packed_unified_multistep as jax_multistep
from dynamo_tpu.engine.step import packed_unified_step as jax_step
from dynamo_tpu_torch.engine.bucketing import packed_axis_len, pow2_bucket
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.step import packed_unified_multistep, packed_unified_step
from dynamo_tpu_torch.engine.weights import params_from_numpy

CFG = dict(num_layers=2)
PAGE, N, P, E = 8, 40, 8, 4  # page size, pool pages, table width, stop width


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig.tiny(**CFG)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    cfg = ModelConfig.tiny(**CFG)
    tparams = params_from_numpy(np_params, cfg, device="cpu")
    return jcfg, jparams, cfg, tparams


def _scenario(seed: int, lanes):
    """``lanes``: per slot ``(kind, cache_len, chunk_len, limit)`` with
    kind in decode / final / chunk / idle; returns host arrays for one
    packed dispatch, assembled as the engine assembles it."""
    cfg = ModelConfig.tiny(**CFG)
    rs = np.random.default_rng(seed)
    B = len(lanes)
    pool = (0.5 * rs.standard_normal(
        (cfg.num_layers, 2, N, PAGE, cfg.num_kv_heads, cfg.head_dim)
    )).astype(np.float32)
    table = np.stack([rs.permutation(N - 1)[:P] + 1 for _ in range(B)]).astype(np.int32)
    a = {n: np.zeros(B, np.int32) for n in (
        "tokens", "seq_lens", "limit", "p_start", "p_lens", "seg_off")}
    for n in ("active", "p_sample", "dec_cap"):
        a[n] = np.zeros(B, bool)
    stop_ids = np.full((B, E), -1, np.int32)
    q_host = np.zeros(B, np.int32)
    for b, (kind, cache, chunk, limit) in enumerate(lanes):
        a["limit"][b] = limit
        if kind == "decode":
            a["tokens"][b] = rs.integers(1, cfg.vocab_size)
            a["seq_lens"][b] = cache
            a["active"][b] = a["dec_cap"][b] = True
            q_host[b] = 1
        elif kind in ("final", "chunk"):
            a["p_start"][b], a["p_lens"][b] = cache, chunk
            a["seq_lens"][b] = cache + chunk if kind == "final" else 0
            a["p_sample"][b] = kind == "final"
            q_host[b] = chunk
    total = int(q_host.sum())
    off = off_last = 0
    for b in range(B):
        if q_host[b]:
            a["seg_off"][b] = off_last = off
            off += int(q_host[b])
    s_max = pow2_bucket(int(q_host.max()))
    Np = packed_axis_len(s_max, off_last, total)
    t_tokens = np.zeros(Np, np.int32)
    t_lane = np.full(Np, B, np.int32)
    t_rel = np.zeros(Np, np.int32)
    t_dec = np.zeros(Np, bool)
    for b in range(B):
        o, n = int(a["seg_off"][b]), int(q_host[b])
        t_lane[o : o + n] = b
        t_rel[o : o + n] = np.arange(n)
        if lanes[b][0] == "decode":
            t_dec[o] = True
        else:
            t_tokens[o : o + n] = rs.integers(1, cfg.vocab_size, n)
    a.update(pool=pool, table=table, stop_ids=stop_ids, t_tokens=t_tokens,
             t_lane=t_lane, t_rel=t_rel, t_dec=t_dec, s_max=s_max)
    return a


def _jax_args(a):
    j = lambda n: jnp.asarray(a[n])  # noqa: E731
    B = a["tokens"].shape[0]
    return (
        jnp.asarray(a["pool"]), j("tokens"), j("seq_lens"), j("limit"),
        j("active"), j("stop_ids"), j("table"), j("t_tokens"), j("t_lane"),
        j("t_rel"), j("t_dec"), j("p_start"), j("p_lens"), j("p_sample"),
        j("p_sample"), j("dec_cap"), j("seg_off"), jnp.zeros(B, jnp.int32),
        jax.random.PRNGKey(0), JaxSampling.fill(B),
    )


def _torch_args(a):
    t = lambda n: torch.from_numpy(a[n].copy())  # noqa: E731
    i = lambda n: t(n).long()  # noqa: E731
    B = a["tokens"].shape[0]
    sampling = SamplingParams(
        temperature=torch.zeros(B), top_p=torch.ones(B),
        top_k=torch.zeros(B, dtype=torch.long),
        key=torch.zeros(B, dtype=torch.long),
        seeded=torch.zeros(B, dtype=torch.bool),
    )
    return (
        t("pool"), i("tokens"), i("seq_lens"), i("limit"), t("active"),
        i("stop_ids"), t("table"), i("t_tokens"), i("t_lane"), i("t_rel"),
        t("t_dec"), i("p_start"), i("p_lens"), t("p_sample"), t("p_sample"),
        t("dec_cap"), i("seg_off"), sampling,
    )


def _check(jout, tout, top_n):
    jp, jtok, jseq, jact, jpool = (np.asarray(x) for x in jout)
    tp, ttok, tseq, tact, tpool = (x.numpy() for x in tout)
    assert jp.shape == tp.shape
    np.testing.assert_array_equal(tp[..., 0], jp[..., 0])  # tokens
    live = jp[..., 0] >= 0
    lp = lambda x: x[..., 1].view(np.float32)  # noqa: E731
    np.testing.assert_allclose(lp(tp)[live], lp(jp)[live], atol=1e-4, rtol=0)
    if top_n:
        ids = slice(2, 2 + top_n)
        np.testing.assert_array_equal(tp[..., ids][live], jp[..., ids][live])
        tl = tp[..., 2 + top_n :].view(np.float32)[live]
        jl = jp[..., 2 + top_n :].view(np.float32)[live]
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    # rows of a step no lane was active for are all -1, as in dead_step
    dead = ~live.any(axis=0) if jp.ndim == 3 else None
    if dead is not None and dead.any():
        assert (tp[:, dead] == -1).all()
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(tseq, jseq)
    np.testing.assert_array_equal(tact, jact)
    np.testing.assert_allclose(tpool[:, :, 1:], jpool[:, :, 1:], atol=1e-5, rtol=0)


MIXED = [
    ("decode", 21, 0, 40),
    ("final", 8, 10, 40),
    ("chunk", 0, 16, 40),
    ("idle", 0, 0, 0),
]


@pytest.mark.parametrize("top_n", [0, 2])
def test_packed_unified_step_matches_jax(weights, top_n):
    """A decode lane, a final chunk over a resident prefix, a non-final
    chunk from position 0 and an idle lane in one packed dispatch."""
    jcfg, jparams, cfg, tparams = weights
    a = _scenario(1, MIXED)
    jargs = _jax_args(a)
    jp, _, jtok, jseq, jact, jpool, _ = jax_step(
        jparams, jcfg, *jargs, a["s_max"], 0, top_n, True
    )
    targs = _torch_args(a)
    with torch.inference_mode():
        tp, ttok, tseq, tact = packed_unified_step(
            tparams, cfg, *targs, a["s_max"], top_n, True
        )
    _check((jp, jtok, jseq, jact, jpool), (tp, ttok, tseq, tact, targs[0]), top_n)


@pytest.mark.parametrize(
    "lanes",
    [
        # a final chunk joins decode inside the block; lane 0 hits its
        # limit mid-block
        [("decode", 30, 0, 33), ("final", 8, 10, 40), ("decode", 5, 0, 40),
         ("idle", 0, 0, 0)],
        # every lane reaches its limit early: the tail ends in dead steps
        [("decode", 12, 0, 14), ("decode", 40, 0, 41), ("idle", 0, 0, 0),
         ("decode", 3, 0, 4)],
    ],
    ids=["joins-and-limits", "dead-steps"],
)
def test_packed_unified_multistep_matches_jax(weights, lanes):
    jcfg, jparams, cfg, tparams = weights
    a = _scenario(2, lanes)
    K, top_n = 4, 1
    jp, _, jtok, jseq, jact, jpool, _ = jax_multistep(
        jparams, jcfg, *_jax_args(a), a["s_max"], K, 0, top_n, True
    )
    targs = _torch_args(a)
    with torch.inference_mode():
        tp, ttok, tseq, tact = packed_unified_multistep(
            tparams, cfg, *targs, a["s_max"], K, top_n, True
        )
    assert tp.shape == (len(lanes), K, 2 + 2 * top_n)
    _check((jp, jtok, jseq, jact, jpool), (tp, ttok, tseq, tact, targs[0]), top_n)
