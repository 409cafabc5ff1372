"""The port's engine steps against the JAX package's, on the same inputs
and the same weights: the packed unified step and its multistep tail, the
rectangle unified step, the classic decode block (with and without penalty
histograms), full and prefix-suffix prefill with first-token sampling, and
the penalty arithmetic.

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
from dynamo_tpu.engine import step as jstep
from dynamo_tpu.engine.sampling import PROMPT_FLAG as JAX_PROMPT_FLAG
from dynamo_tpu.engine.sampling import SamplingParams as JaxSampling
from dynamo_tpu.engine.sampling import apply_penalties as jax_apply_penalties
from dynamo_tpu.engine.step import packed_unified_multistep as jax_multistep
from dynamo_tpu.engine.step import packed_unified_step as jax_step
from dynamo_tpu_torch.engine import step as tstep
from dynamo_tpu_torch.engine.bucketing import packed_axis_len, pow2_bucket
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.sampling import PROMPT_FLAG, SamplingParams, apply_penalties
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
        tp, ttok, tseq, tact, _ = packed_unified_step(
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
        tp, ttok, tseq, tact, _ = packed_unified_multistep(
            tparams, cfg, *targs, a["s_max"], K, top_n, True
        )
    assert tp.shape == (len(lanes), K, 2 + 2 * top_n)
    _check((jp, jtok, jseq, jact, jpool), (tp, ttok, tseq, tact, targs[0]), top_n)


# ---------------------------------------------------------------------------
# classic dispatches and the rectangle layout
# ---------------------------------------------------------------------------

PENALTIES = dict(
    freq=np.array([0.0, 0.7, 0.0, 0.3], np.float32),
    pres=np.array([0.0, 0.0, 0.5, 0.2], np.float32),
    rep=np.array([1.5, 1.0, 1.3, 1.1], np.float32),
)


def _samplers(B: int, penalties: bool):
    """Greedy sampling settings for both packages, with or without the
    penalty columns of PENALTIES."""
    pen = {n: a[:B] for n, a in PENALTIES.items()} if penalties else dict(
        freq=np.zeros(B, np.float32), pres=np.zeros(B, np.float32),
        rep=np.ones(B, np.float32),
    )
    j = JaxSampling(
        temperature=jnp.zeros(B), top_p=jnp.ones(B), top_k=jnp.zeros(B, jnp.int32),
        seed=jnp.zeros(B, jnp.uint32), **{n: jnp.asarray(a) for n, a in pen.items()},
    )
    t = SamplingParams(
        temperature=torch.zeros(B), top_p=torch.ones(B),
        top_k=torch.zeros(B, dtype=torch.long), key=torch.zeros(B, dtype=torch.long),
        seeded=torch.zeros(B, dtype=torch.bool),
        **{n: torch.from_numpy(a) for n, a in pen.items()},
    )
    return j, t


def _check_packed(jp, tp, top_n):
    jp, tp = np.asarray(jp), tp.numpy()
    assert jp.shape == tp.shape
    np.testing.assert_array_equal(tp[..., 0], jp[..., 0])
    live = jp[..., 0] >= 0
    lp = lambda x: x[..., 1].view(np.float32)  # noqa: E731
    np.testing.assert_allclose(lp(tp)[live], lp(jp)[live], atol=1e-4, rtol=0)
    if top_n:
        ids = slice(2, 2 + top_n)
        np.testing.assert_array_equal(tp[..., ids][live], jp[..., ids][live])


def _check_written(jpool, tpool, table, lens):
    """The pool rows of each lane's first ``lens[b]`` positions through its
    table (pad rows past a lane's length hold garbage by design on both
    sides)."""
    jpool = np.asarray(jpool)
    for b in range(table.shape[0]):
        for p in range(int(lens[b])):
            page, slot = table[b, p // PAGE], p % PAGE
            np.testing.assert_allclose(
                tpool[:, :, page, slot], jpool[:, :, page, slot], atol=1e-5, rtol=0
            )


def _prefill_inputs(seed: int, B: int, T: int):
    cfg = ModelConfig.tiny(**CFG)
    rs = np.random.default_rng(seed)
    pool = (0.5 * rs.standard_normal(
        (cfg.num_layers, 2, N, PAGE, cfg.num_kv_heads, cfg.head_dim)
    )).astype(np.float32)
    perm = rs.permutation(N - 1) + 1
    return rs, pool, perm, rs.integers(1, cfg.vocab_size, (B, T)).astype(np.int32)


@pytest.mark.parametrize("penalties", [False, True], ids=["plain", "penalized"])
def test_prefill_and_sample_matches_jax(weights, penalties):
    """A full bucket, a shorter lane, a one-token lane, a pad lane; the
    first token is repetition-penalized over the lane's own prompt."""
    jcfg, jparams, cfg, tparams = weights
    seq_lens = np.array([16, 9, 1, 0], np.int32)
    B, T = len(seq_lens), 16
    _, pool, perm, tokens = _prefill_inputs(3, B, T)
    table = perm[: B * T // PAGE].reshape(B, T // PAGE).astype(np.int32)
    table[3] = 0  # the pad lane writes the trash page
    js, ts = _samplers(B, penalties)
    jp, jpool = jstep.prefill_and_sample(
        jparams, jcfg, jnp.asarray(pool), jnp.asarray(tokens), jnp.asarray(seq_lens),
        jnp.asarray(table), jax.random.PRNGKey(0), js, 2, penalties,
    )
    tpool = torch.from_numpy(pool.copy())
    with torch.inference_mode():
        tp = tstep.prefill_and_sample(
            tparams, cfg, tpool, torch.from_numpy(tokens).long(),
            torch.from_numpy(seq_lens).long(), torch.from_numpy(table), ts, 2,
            penalties,
        )
    live = seq_lens > 0
    _check_packed(np.asarray(jp)[live], tp[live], 2)
    _check_written(jpool, tpool.numpy(), table, seq_lens)


@pytest.mark.parametrize("penalties", [False, True], ids=["plain", "penalized"])
def test_prefill_suffix_and_sample_matches_jax(weights, penalties):
    """Suffixes over resident prefixes: a two-page prefix, a one-page
    prefix with a full bucket, a chunk from position 0, a pad lane."""
    jcfg, jparams, cfg, tparams = weights
    offsets = np.array([16, 8, 0, 0], np.int32)
    slens = np.array([5, 16, 9, 0], np.int32)
    B, T, Pp = len(offsets), 16, 2
    _, pool, perm, tokens = _prefill_inputs(5, B, T)
    pages = perm[: B * (Pp + T // PAGE)].reshape(B, -1).astype(np.int32)
    prefix_table = np.zeros((B, Pp), np.int32)
    suffix_table = np.zeros((B, T // PAGE), np.int32)
    for b in range(B):
        npp = offsets[b] // PAGE
        prefix_table[b, :npp] = pages[b, :npp]
        if slens[b]:
            suffix_table[b] = pages[b, npp : npp + T // PAGE]
    js, ts = _samplers(B, penalties)
    jp, jpool = jstep.prefill_suffix_and_sample(
        jparams, jcfg, jnp.asarray(pool), jnp.asarray(tokens), jnp.asarray(offsets),
        jnp.asarray(slens), jnp.asarray(prefix_table), jnp.asarray(suffix_table),
        jax.random.PRNGKey(0), js, 1, penalties,
    )
    tpool = torch.from_numpy(pool.copy())
    t = lambda a: torch.from_numpy(a).long()  # noqa: E731
    with torch.inference_mode():
        tp = tstep.prefill_suffix_and_sample(
            tparams, cfg, tpool, t(tokens), t(offsets), t(slens),
            torch.from_numpy(prefix_table), torch.from_numpy(suffix_table), ts, 1,
            penalties,
        )
    live = slens > 0
    _check_packed(np.asarray(jp)[live], tp[live], 1)
    _check_written(jpool, tpool.numpy(), suffix_table, slens)


def _counts(rs, B: int, V: int) -> np.ndarray:
    """Packed histograms dense enough to move a greedy choice: output
    counts on about a third of the vocabulary, prompt flags on another."""
    counts = np.zeros((B, V), np.int32)
    for b in range(B):
        np.add.at(counts[b], rs.integers(0, V, V // 3), 1)
        counts[b, rs.integers(0, V, V // 3)] += JAX_PROMPT_FLAG
    return counts


@pytest.mark.parametrize("penalties", [False, True], ids=["plain", "penalized"])
@pytest.mark.parametrize(
    "lanes",
    [
        # lane 0 hits its limit mid-block, lane 2 is idle
        [("decode", 30, 0, 32), ("decode", 5, 0, 40), ("idle", 0, 0, 0),
         ("decode", 17, 0, 40)],
        # every lane reaches its limit early: the block ends in dead steps
        [("decode", 12, 0, 13), ("decode", 40, 0, 41), ("idle", 0, 0, 0),
         ("decode", 3, 0, 4)],
    ],
    ids=["limit", "dead-tail"],
)
def test_decode_block_matches_jax(weights, lanes, penalties):
    jcfg, jparams, cfg, tparams = weights
    a = _scenario(4, lanes)
    B, K, top_n = len(lanes), 4, 1
    counts = _counts(np.random.default_rng(6), B, cfg.vocab_size)
    js, ts = _samplers(B, penalties)
    j = lambda n: jnp.asarray(a[n])  # noqa: E731
    jp, jtok, jseq, jact, jpool, _, jcounts = jstep.decode_block(
        jparams, jcfg, jnp.asarray(a["pool"]), j("tokens"), j("seq_lens"),
        j("limit"), j("active"), j("stop_ids"), j("table"),
        jax.random.PRNGKey(0), js, K, True, top_n,
        jnp.asarray(counts) if penalties else None, penalties,
    )
    t = lambda n: torch.from_numpy(a[n].copy())  # noqa: E731
    tpool = t("pool")
    with torch.inference_mode():
        tp, ttok, tseq, tact, tcounts = tstep.decode_block(
            tparams, cfg, tpool, t("tokens").long(), t("seq_lens").long(),
            t("limit").long(), t("active"), t("stop_ids").long(), t("table"), ts,
            K, True, top_n, torch.from_numpy(counts) if penalties else None,
            penalties,
        )
    assert tp.shape == (B, K, 2 + 2 * top_n)
    _check((jp, jtok, jseq, jact, jpool), (tp, ttok, tseq, tact, tpool), top_n)
    if penalties:
        np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
        with torch.inference_mode():
            plain = tstep.decode_block(
                tparams, cfg, t("pool"), t("tokens").long(), t("seq_lens").long(),
                t("limit").long(), t("active"), t("stop_ids").long(), t("table"),
                _samplers(B, False)[1], K, True, top_n,
            )[0]
        assert (plain[..., 0] != tp[..., 0]).any(), "the penalty moved no token"


def test_unified_step_matches_jax(weights):
    """The rectangle: a decode lane, a final chunk over a resident prefix,
    a non-final chunk from position 0 and an idle lane, S = 16."""
    jcfg, jparams, cfg, tparams = weights
    a = _scenario(1, MIXED)
    B, top_n = len(MIXED), 2
    S = pow2_bucket(int(a["p_lens"].max()))
    p_tokens = np.zeros((B, S), np.int32)
    for b in range(B):
        n = int(a["p_lens"][b])
        if n:
            o = int(a["seg_off"][b])
            p_tokens[b, :n] = a["t_tokens"][o : o + n]
    j = lambda n: jnp.asarray(a[n])  # noqa: E731
    js, ts = _samplers(B, False)
    jp, jtok, jseq, jact, jpool, _ = jstep.unified_step(
        jparams, jcfg, jnp.asarray(a["pool"]), j("tokens"), j("seq_lens"),
        j("limit"), j("active"), j("stop_ids"), j("table"), jnp.asarray(p_tokens),
        j("p_start"), j("p_lens"), j("p_sample"), j("p_sample"),
        jax.random.PRNGKey(0), js, top_n, True,
    )
    t = lambda n: torch.from_numpy(a[n].copy())  # noqa: E731
    tpool = t("pool")
    with torch.inference_mode():
        tp, ttok, tseq, tact = tstep.unified_step(
            tparams, cfg, tpool, t("tokens").long(), t("seq_lens").long(),
            t("limit").long(), t("active"), t("stop_ids").long(), t("table"),
            torch.from_numpy(p_tokens).long(), t("p_start").long(),
            t("p_lens").long(), t("p_sample"), t("p_sample"), ts, top_n, True,
        )
    _check((jp, jtok, jseq, jact, jpool), (tp, ttok, tseq, tact, tpool), top_n)


def test_prompt_penalized_logits_matches_jax():
    """The first-token penalty: a repetition penalty over each lane's own
    valid prompt tokens only (pad columns and a pad lane count nothing)."""
    rs = np.random.default_rng(10)
    B, T, V = 4, 12, 256
    logits = (3 * rs.standard_normal((B, V))).astype(np.float32)
    tokens = rs.integers(0, V, (B, T)).astype(np.int32)
    lens = np.array([12, 5, 1, 0], np.int32)
    js, ts = _samplers(B, True)
    want = np.asarray(
        jstep._prompt_penalized_logits(
            jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(lens), js
        )
    )
    got = tstep.prompt_penalized_logits(
        torch.from_numpy(logits), torch.from_numpy(tokens).long(),
        torch.from_numpy(lens).long(), ts,
    ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    moved = (got != logits).any(axis=1)
    assert moved[0] and moved[2] and not moved[3]


def test_apply_penalties_matches_jax():
    """Random logits of both signs and random packed histograms."""
    rs = np.random.default_rng(8)
    B, V = 4, 256
    logits = (3 * rs.standard_normal((B, V))).astype(np.float32)
    counts = _counts(rs, B, V)
    assert PROMPT_FLAG == JAX_PROMPT_FLAG
    pen = {n: a for n, a in PENALTIES.items()}
    want = np.asarray(
        jax_apply_penalties(
            jnp.asarray(logits), jnp.asarray(counts),
            *(jnp.asarray(pen[n]) for n in ("freq", "pres", "rep")),
        )
    )
    got = apply_penalties(
        torch.from_numpy(logits), torch.from_numpy(counts),
        *(torch.from_numpy(pen[n]) for n in ("freq", "pres", "rep")),
    ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got != logits).any(axis=1)[1:].all(), "the penalized lanes moved"
