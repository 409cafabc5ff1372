"""The port's speculative decoding against the JAX package's.

Units: the drafter copy (``spec/drafter.py``) proposes, walks and resolves
kinds as the JAX module does; the standalone ``verify_and_sample`` and the
packed step's folded verify columns (``s_spec > 0``) give the JAX steps'
tokens, logprobs within 1e-5 and pool within 1e-6 on the same inputs.

Engines: ``TorchEngine(device="cpu")`` and ``JaxEngine`` serve the same
weights (the JAX ``init_params`` pytree through ``params_from_numpy``) and
the same batch -- n-gram lanes (a repetitive prompt among them), lanes
whose oracle drafter (registered by the test in each package) proposes
the plain continuation, a prompt chunked past the mixed token budget and
a plain lane -- folded (the default), with ``fold_spec_verify=False`` and
on the rectangle layout; greedy streams equal JAX's, and equal the
spec-off streams of both.  Within the port: seeded lanes give the same
tokens with speculation on and off; a folded run pays no standalone
verify dispatch, a fold-off run one per verify; auto-disable reverts a
hopeless lane with no output change and stays off when disabled; EOS
inside an accepted column, cancellation mid-verify, penalized lanes,
classic chunked prefill and echo+logprobs compose; an unknown drafter or
a drafter that raises fails its request; ``usage.speculation`` through
the HTTP service carries the JAX service's keys and accepted counts, and
the ``dynamo_spec_*`` families render on ``/metrics``.  Every wait is
bounded (``asyncio.wait_for``).
"""

from __future__ import annotations

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamo_tpu.spec as jax_spec
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.engine.sampling import SamplingParams as JaxSampling
from dynamo_tpu.engine.step import packed_unified_step as jax_packed_step
from dynamo_tpu.engine.step import verify_and_sample as jax_verify
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch import spec
from dynamo_tpu_torch.engine.bucketing import packed_axis_len, pow2_bucket
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import SeqState
from dynamo_tpu_torch.engine.step import packed_unified_step, verify_and_sample
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from tests.test_torch_ops import _free_compiled_programs  # noqa: F401 (autouse)

ENGINE = dict(
    max_batch_size=4, max_seq_len=96, page_size=4, num_pages=64,
    mixed_token_budget=16,
)
WAIT_S = 60
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run
CFG = dict(num_layers=2)
PAGE, N, P = 8, 40, 8  # the step tests' page size, pool pages, table width


class OracleDrafter:
    """Replays a known continuation of the history (full acceptance)."""

    def __init__(self, full):
        self.full = list(full)

    def propose(self, history, n):
        k = len(history)
        return self.full[k : k + n]


class WrongDrafter:
    """Proposes tokens the model never samples here: every column rejects."""

    def propose(self, history, n):
        return [int(history[-1]) ^ 1] * n


class FailingDrafter:
    def propose(self, history, n):
        raise RuntimeError("drafter exploded")


def register_both(kind: str, factory) -> None:
    """One drafter kind in both packages' registries."""
    spec.register_drafter(kind, factory)
    jax_spec.register_drafter(kind, factory)


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def torch_engine(np_params, registry=None, **kw) -> TorchEngine:
    cfg = ModelConfig.tiny()
    return TorchEngine(
        cfg, params_from_numpy(np_params, cfg, device="cpu"),
        EngineConfig(**{**ENGINE, **kw}), device="cpu",
        metrics_registry=registry or MetricsRegistry(),
    )


def request(tokens, max_tokens=10, drafter=None, n=4, **extra) -> dict:
    sampling = {"temperature": 0.0}
    sampling.update(extra.pop("sampling", {}))
    r = {
        "token_ids": list(tokens),
        "stop_conditions": {"max_tokens": max_tokens},
        "sampling_options": sampling,
        "eos_token_ids": extra.pop("eos", []),
        **extra,
    }
    if drafter is not None:
        r["speculation"] = {"enabled": True, "num_draft_tokens": n, "drafter": drafter}
    return r


async def collect(engine, req: dict) -> dict:
    """One stream: tokens, finish reason, spec stats, prompt logprobs and
    the error message, if any."""
    if isinstance(engine, JaxEngine):
        stream = await engine.generate(JaxContext.new(JaxRequest.from_dict(req)))
    else:
        stream = await engine.generate(Context.new(PreprocessedRequest.from_dict(req)))
    out = dict(tokens=[], finish=None, spec=None, plp=None, error=None)
    async for item in stream:
        if item.is_error():
            out["error"] = item.error_message()
            continue
        data = item.data or {}
        out["tokens"] += data.get("token_ids") or []
        out["finish"] = data.get("finish_reason") or out["finish"]
        out["spec"] = data.get("spec") or out["spec"]
        if data.get("prompt_logprobs") is not None:
            out["plp"] = data["prompt_logprobs"]
    return out


def serve(engine, reqs, timeout=WAIT_S):
    async def run():
        try:
            return await asyncio.wait_for(
                asyncio.gather(*[collect(engine, r) for r in reqs]), timeout
            )
        finally:
            await engine.stop()

    return asyncio.run(asyncio.wait_for(run(), RUN_S))


# -- the drafter copy -----------------------------------------------------------


def test_drafter_copy_matches_jax():
    rs = np.random.default_rng(0)
    histories = [rs.integers(0, 6, n).tolist() for n in (0, 1, 2, 3, 5, 9, 40, 300)]
    histories += [[1, 4, 5, 6, 7, 9, 4, 5], [5, 9, 2, 7] * 6, list(range(50))]
    for kw in ({}, dict(max_ngram=3, min_ngram=2), dict(max_ngram=2, min_ngram=1, max_scan=8)):
        port, ref = spec.NGramDrafter(**kw), jax_spec.NGramDrafter(**kw)
        for h in histories:
            for n in (0, 1, 4, 8):
                assert port.propose(h, n) == ref.propose(h, n), (kw, h, n)
    for draft, target in (([], [3]), ([1, 2, 3], [1, 2, 4, 9]), ([5], [5, 6]),
                          ([1, 2], [9, 2, 3]), ([4, 4, 4, 4], [4, 4, 4, 4, 4])):
        assert spec.longest_accepted(draft, target) == jax_spec.longest_accepted(draft, target)
    assert spec.MAX_DRAFT_TOKENS == jax_spec.MAX_DRAFT_TOKENS
    for kind in ("ngram", "prompt_lookup"):
        assert type(spec.make_drafter(kind)).__name__ == type(jax_spec.make_drafter(kind)).__name__
    with pytest.raises(ValueError, match="unknown drafter 'nope'"):
        spec.make_drafter("nope")
    with pytest.raises(ValueError):
        spec.NGramDrafter(max_ngram=1, min_ngram=2)
    for cls in (spec.SpecState, jax_spec.SpecState):
        st = cls(drafter=None, num_draft_tokens=4)
        st.pending_draft = (7, [1, 2, 3])
        assert st.take_pending_draft(8, 2) is None and st.pending_draft is None
        st.pending_draft = (7, [1, 2, 3])
        assert st.take_pending_draft(7, 2) == [1, 2]
        st.drafted, st.accepted = 8, 6
        assert st.accept_rate == 0.75
        assert spec.spec_live(st) and not spec.spec_live(None)


# -- the steps ------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_weights():
    jcfg = JaxModelConfig.tiny(**CFG)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = ModelConfig.tiny(**CFG)
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _pool_and_tables(seed: int, B: int, cfg: ModelConfig):
    rs = np.random.default_rng(seed)
    pool = (0.5 * rs.standard_normal(
        (cfg.num_layers, 2, N, PAGE, cfg.num_kv_heads, cfg.head_dim)
    )).astype(np.float32)
    table = np.stack([rs.permutation(N - 1)[:P] + 1 for _ in range(B)]).astype(np.int32)
    return rs, pool, table


def _torch_greedy(B: int) -> SamplingParams:
    return SamplingParams(
        temperature=torch.zeros(B), top_p=torch.ones(B),
        top_k=torch.zeros(B, dtype=torch.long), key=torch.zeros(B, dtype=torch.long),
        seeded=torch.zeros(B, dtype=torch.bool),
    )


def _check_columns(tp: np.ndarray, jp: np.ndarray, valid: np.ndarray, top_n: int) -> None:
    """Equal tokens and top ids, logprobs within 1e-5, on valid columns."""
    np.testing.assert_array_equal(tp[..., 0][valid], jp[..., 0][valid])
    f32 = lambda x: x.view(np.float32)  # noqa: E731
    np.testing.assert_allclose(f32(tp[..., 1])[valid], f32(jp[..., 1])[valid], atol=1e-5, rtol=0)
    if top_n:
        ids = slice(2, 2 + top_n)
        np.testing.assert_array_equal(tp[..., ids][valid], jp[..., ids][valid])
        np.testing.assert_allclose(
            f32(tp[..., 2 + top_n:])[valid], f32(jp[..., 2 + top_n:])[valid],
            atol=1e-5, rtol=0,
        )


def test_verify_and_sample_matches_jax(step_weights):
    """Three lanes of 1, 3 and 5 columns over prefixes of 7, 20 and 33
    tokens (none page-aligned), and an idle lane."""
    jcfg, jparams, cfg, tparams = step_weights
    B, top_n = 4, 2
    rs, pool, table = _pool_and_tables(5, B, cfg)
    n_tok = np.array([1, 3, 5, 0], np.int32)
    base = np.array([7, 20, 33, 0], np.int32)
    S = 1 + pow2_bucket(int(n_tok.max()) - 1)
    tokens = np.zeros((B, S), np.int32)
    for b in range(B):
        tokens[b, : n_tok[b]] = rs.integers(1, cfg.vocab_size, n_tok[b])
    jp, jpool = jax_verify(
        jparams, jcfg, jnp.asarray(pool), jnp.asarray(tokens), jnp.asarray(base),
        jnp.asarray(n_tok), jnp.asarray(table), jax.random.PRNGKey(0),
        JaxSampling.fill(B), top_n, True,
    )
    tpool = torch.from_numpy(pool.copy())
    with torch.inference_mode():
        tp = verify_and_sample(
            tparams, cfg, tpool, torch.from_numpy(tokens).long(),
            torch.from_numpy(base).long(), torch.from_numpy(n_tok).long(),
            torch.from_numpy(table), _torch_greedy(B), top_n, True,
        )
    jp, tp = np.asarray(jp), tp.numpy()
    assert tp.shape == jp.shape == (B, S, 2 + 2 * top_n)
    valid = np.arange(S)[None, :] < n_tok[:, None]
    _check_columns(tp, jp, valid, top_n)
    # every valid column's KV was written where JAX writes it (page 0 is
    # the trash page): layer 0's rows come straight from the projections,
    # within 1e-6; a later layer's pass through each package's attention
    # and MLP first (f32 sums in another order: 1.7e-6 seen), within the
    # step tests' 1e-5
    got, ref = tpool.numpy()[:, :, 1:], np.asarray(jpool)[:, :, 1:]
    np.testing.assert_allclose(got[:1], ref[:1], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert not np.allclose(got, pool[:, :, 1:])


def test_packed_step_spec_columns_match_jax(step_weights):
    """One packed dispatch: a decode lane, a speculating lane of 3 columns,
    a final prefill chunk over a resident prefix and a speculating lane of
    5 columns (s_spec = 5)."""
    jcfg, jparams, cfg, tparams = step_weights
    B, top_n = 4, 2
    rs, pool, table = _pool_and_tables(6, B, cfg)
    kinds = [("decode", 21, 1), ("spec", 12, 3), ("final", 8, 10), ("spec", 26, 5)]
    i32 = lambda: np.zeros(B, np.int32)  # noqa: E731
    tokens, seq_lens, limit, p_start, p_lens, seg_off, v_lens = (i32() for _ in range(7))
    active, p_sample, dec_cap = (np.zeros(B, bool) for _ in range(3))
    q_host = i32()
    for b, (kind, at, n) in enumerate(kinds):
        limit[b] = 60
        q_host[b] = n
        if kind == "decode":
            tokens[b] = rs.integers(1, cfg.vocab_size)
            seq_lens[b], active[b], dec_cap[b] = at, True, True
        elif kind == "final":
            p_start[b], p_lens[b], p_sample[b], seq_lens[b] = at, n, True, at + n
        else:
            p_start[b], v_lens[b], seq_lens[b] = at, n, at
    off = off_last = 0
    for b in range(B):
        seg_off[b] = off_last = off
        off += int(q_host[b])
    total = int(q_host.sum())
    s_max = pow2_bucket(int(q_host.max()))
    s_spec = 1 + pow2_bucket(int(v_lens.max()) - 1)
    Np = packed_axis_len(s_max, off_last, total)
    t_tokens, t_rel = np.zeros(Np, np.int32), np.zeros(Np, np.int32)
    t_lane, t_dec = np.full(Np, B, np.int32), np.zeros(Np, bool)
    for b, (kind, _, n) in enumerate(kinds):
        o = int(seg_off[b])
        t_lane[o : o + n], t_rel[o : o + n] = b, np.arange(n)
        if kind == "decode":
            t_dec[o] = True
        else:
            t_tokens[o : o + n] = rs.integers(1, cfg.vocab_size, n)
    stop_ids = np.full((B, 4), -1, np.int32)
    j = jnp.asarray
    jp, jspec, jtok, jseq, jact, jpool, _ = jax_packed_step(
        jparams, jcfg, j(pool), j(tokens), j(seq_lens), j(limit), j(active), j(stop_ids),
        j(table), j(t_tokens), j(t_lane), j(t_rel), j(t_dec), j(p_start), j(p_lens),
        j(p_sample), j(p_sample), j(dec_cap), j(seg_off), j(v_lens),
        jax.random.PRNGKey(0), JaxSampling.fill(B), s_max, s_spec, top_n, True,
    )
    t = lambda a: torch.from_numpy(a.copy())  # noqa: E731
    L = lambda a: t(a).long()  # noqa: E731
    tpool = t(pool)
    with torch.inference_mode():
        tp, ttok, tseq, tact, tspec = packed_unified_step(
            tparams, cfg, tpool, L(tokens), L(seq_lens), L(limit), t(active),
            L(stop_ids), t(table), L(t_tokens), L(t_lane), L(t_rel), t(t_dec),
            L(p_start), L(p_lens), t(p_sample), t(p_sample), t(dec_cap), L(seg_off),
            _torch_greedy(B), s_max, top_n, True, L(v_lens), s_spec,
        )
    jspec, tspec = np.asarray(jspec), tspec.numpy()
    assert tspec.shape == jspec.shape == (B, s_spec, 2 + 2 * top_n)
    valid = np.arange(s_spec)[None, :] < v_lens[:, None]
    assert (tspec[..., 0][~valid] == -1).all() and (jspec[..., 0][~valid] == -1).all()
    _check_columns(tspec, jspec, valid, top_n)
    # the single-row epilogue (decode and final lanes) and the state, too
    jp = np.asarray(jp)
    live = jp[..., 0] >= 0
    _check_columns(tp.numpy(), jp, live, top_n)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    np.testing.assert_allclose(tpool.numpy()[:, :, 1:], np.asarray(jpool)[:, :, 1:],
                               atol=1e-5, rtol=0)


# -- engines ----------------------------------------------------------------------

# per prompt: (tokens, max_tokens, drafter or None, draft tokens)
def batch_prompts():
    rs = np.random.default_rng(7)
    toks = lambda n: rs.integers(1, 256, n).tolist()  # noqa: E731
    return [
        ([5, 9, 2, 7] * 5, 14, "ngram", 4),  # repetitive: the n-gram drafter rides it
        (toks(37), 12, "t-oracle-1", 4),  # chunked past the mixed budget
        (toks(9), 14, "ngram", 2),
        (toks(6), 10, None, 0),  # plain
        (toks(12), 16, "t-oracle-4", 8),  # waits for a slot
    ]


# the spec configs held against the JAX engine
CONFIGS = {
    "folded": {},
    "fold-off": dict(fold_spec_verify=False),
    "rectangle": dict(packed_ragged=False),
}


@pytest.fixture(scope="module")
def plain(weights):
    """The batch without speculation on both engines; registers the
    oracle drafters from the streams."""
    jcfg, jparams, np_params = weights
    reqs = [request(p, mt) for p, mt, _, _ in batch_prompts()]
    port = serve(torch_engine(np_params), reqs)
    ref = serve(JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE)), reqs)
    for i, (p, _, drafter, _) in enumerate(batch_prompts()):
        if drafter and drafter.startswith("t-oracle"):
            full = list(p) + port[i]["tokens"]
            register_both(drafter, lambda full=full: OracleDrafter(full))
    return port, ref


@pytest.fixture(scope="module")
def served(weights, plain):
    jcfg, jparams, np_params = weights
    reqs = [request(p, mt, d, n) for p, mt, d, n in batch_prompts()]
    out = {}
    for name, kw in CONFIGS.items():
        eng = torch_engine(np_params, **kw)
        port = serve(eng, reqs)
        ref = serve(JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE, **kw)), reqs)
        out[name] = dict(port=port, ref=ref, engine=eng)
    return out


def streams(results):
    return [(r["tokens"], r["finish"], r["error"]) for r in results]


def test_spec_off_streams_match_jax(plain):
    port, ref = plain
    assert streams(port) == streams(ref)
    assert [len(r["tokens"]) for r in port] == [mt for _, mt, _, _ in batch_prompts()]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_spec_streams_match_jax_and_plain(served, plain, name):
    """n-gram and oracle lanes: the port's streams equal the JAX engine's
    and the spec-off streams; the oracle lanes commit multi-token columns."""
    got = served[name]
    assert streams(got["port"]) == streams(got["ref"])
    assert streams(got["port"]) == streams(plain[0])
    for r, (_, mt, drafter, _) in zip(got["port"], batch_prompts()):
        if drafter is None:
            assert r["spec"] is None
            continue
        st = r["spec"]
        assert st["drafter"] == drafter and st["auto_disabled"] is False
        assert st["accepted_tokens"] <= st["drafted_tokens"]
        if drafter.startswith("t-oracle"):
            assert st["accepted_tokens"] > mt // 2, st
    # the JAX finish items carry the same stats keys
    for r, ref in zip(got["port"], got["ref"]):
        assert (r["spec"] is None) == (ref["spec"] is None)
        if r["spec"] is not None:
            assert sorted(r["spec"]) == sorted(ref["spec"])
    eng = got["engine"]
    assert eng.kv.allocator.used_pages == 0
    assert eng.spec_verify_steps > 0 and eng.spec_accepted > 0


def test_folded_pays_no_standalone_verify(served):
    """Folded: every verify rode a unified dispatch.  Fold off and the
    rectangle: one standalone verify dispatch per verify."""
    eng = served["folded"]["engine"]
    assert eng.dispatches.get("verify", 0) == 0
    folded = eng.spec_metrics.folded_steps.labels().value
    assert folded == eng.spec_verify_steps > 0
    for name in ("fold-off", "rectangle"):
        eng = served[name]["engine"]
        assert eng.dispatches["verify"] == eng.spec_verify_steps > 0
        assert eng.spec_metrics.folded_steps.labels().value == 0
    # multi-token commits: fewer verifies than the speculating lanes' tokens
    tokens = sum(mt for _, mt, d, _ in batch_prompts() if d)
    assert served["folded"]["engine"].spec_verify_steps < tokens


@pytest.mark.parametrize("kw", [{}, dict(fold_spec_verify=False)], ids=["folded", "fold-off"])
def test_seeded_lanes_equal_with_spec_on_and_off(weights, kw):
    np_params = weights[2]
    rs = np.random.default_rng(11)
    prompts = [rs.integers(1, 256, n).tolist() for n in (7, 15)] + [[3, 8, 3, 8, 3, 8, 3, 8]]
    samp = [dict(temperature=0.9, seed=5), dict(temperature=1.2, top_p=0.9, seed=7),
            dict(temperature=0.7, top_k=20, seed=9)]
    off = serve(torch_engine(np_params, **kw),
                [request(p, 12, sampling=s) for p, s in zip(prompts, samp)])
    on = serve(torch_engine(np_params, **kw),
               [request(p, 12, "ngram", 4, sampling=s) for p, s in zip(prompts, samp)])
    assert streams(on) == streams(off)
    assert all(r["spec"] is not None for r in on)


def test_classic_chunked_prefill_composes(weights, plain):
    """The classic path (chunked prefill, decode blocks) with speculating
    lanes: standalone verifies, the plain streams."""
    eng = torch_engine(weights[2], mixed_batching=False, prefill_chunk_tokens=8)
    out = serve(eng, [request(p, mt, d, n) for p, mt, d, n in batch_prompts()])
    assert streams(out) == streams(plain[0])
    assert eng.dispatches["verify"] > 0 and eng.dispatches["chunk"] > 0


@pytest.mark.parametrize("kw", [{}, dict(fold_spec_verify=False),
                                dict(mixed_batching=False, prefill_chunk_tokens=8)],
                         ids=["folded", "fold-off", "classic"])
def test_spec_lanes_stay_off_the_device_decode(weights, plain, monkeypatch, kw):
    """With the readiness probe pinned to "not ready" the loop keeps two
    generations in flight, as on a busy card: a speculating lane must not
    also decode in a decode block or a multistep tail in flight beside its
    verify, or its commits would repeat tokens."""
    import dynamo_tpu_torch.engine.engine as engine_mod

    monkeypatch.setattr(engine_mod, "_handles_ready", lambda res: False)
    eng = torch_engine(weights[2], **kw)
    out = serve(eng, [request(p, mt, d, n) for p, mt, d, n in batch_prompts()])
    assert streams(out) == streams(plain[0])


def test_spec_lanes_are_device_inactive(weights):
    """The device-resident decode state never steps a speculating lane
    (it advances through verify columns from the host mirrors), on a full
    rebuild and on a row scatter alike; an auto-disabled lane steps
    again."""
    eng = torch_engine(weights[2])
    seqs = [
        SeqState.from_request(
            f"r{i}", PreprocessedRequest.from_dict(request([1, 2, 3, 4, 5], 8, drafter)),
            eng.sched.block_size,
        )
        for i, drafter in enumerate(["ngram", None])
    ]
    for seq in seqs:
        eng._arm_speculation(seq)
        eng.sched.enqueue(seq)
    eng.sched.plan()
    spec_lane, plain_lane = (seq.slot for seq in seqs)
    with torch.inference_mode():
        eng._push_device_state()
        active = eng._v["active"]
        assert not active[spec_lane] and active[plain_lane]
        seqs[0].spec.enabled = False  # what auto-disable does, with a dirty row
        eng.sched.dirty_slots.add(spec_lane)
        eng._sync_device_state()
        assert active[spec_lane]
        seqs[0].spec.enabled = True
        eng.sched.dirty_slots.add(spec_lane)
        eng._sync_device_state()
        assert not active[spec_lane]


def test_auto_disable_reverts_without_output_change(weights):
    np_params = weights[2]
    spec.register_drafter("t-wrong", WrongDrafter)
    prompt = [3, 1, 4, 1, 5]
    base = serve(torch_engine(np_params), [request(prompt, 20)])
    eng = torch_engine(np_params, spec_min_accept=0.5, spec_disable_after=4)
    out = serve(eng, [request(prompt, 20, "t-wrong")])
    assert streams(out) == streams(base)
    st = out[0]["spec"]
    assert st["auto_disabled"] is True and st["accepted_tokens"] == 0
    assert eng.spec_auto_disabled == 1 and eng.spec_enabled_frac < 1.0
    assert eng.spec_metrics.auto_disabled.labels().value == 1
    assert eng.spec_metrics.enabled_frac.labels().value < 1.0
    # the lane decoded plainly afterwards: fewer verifies than tokens
    assert eng.spec_verify_steps < 20
    # with auto-disable off the hopeless lane drafts to the end
    eng = torch_engine(np_params, spec_auto_disable=False, spec_min_accept=0.99,
                       spec_disable_after=1)
    out = serve(eng, [request(prompt, 12, "t-wrong")])
    assert streams(out) == [(t[:12], f, e) for t, f, e in streams(base)]
    assert out[0]["spec"]["auto_disabled"] is False
    assert out[0]["spec"]["drafted_tokens"] > 8 and eng.spec_auto_disabled == 0


def test_eos_mid_column(weights):
    """An EOS inside an accepted column finishes the lane through the
    stop-rule replay; the rest of the column is dropped, no page leaks."""
    np_params = weights[2]
    prompt = [1, 2, 3]
    base = serve(torch_engine(np_params), [request(prompt, 8)])[0]["tokens"]
    spec.register_drafter("t-eos-oracle", lambda: OracleDrafter(prompt + base))
    eos = base[3]
    ref = serve(torch_engine(np_params), [request(prompt, 8, eos=[eos])])
    eng = torch_engine(np_params)
    out = serve(eng, [request(prompt, 8, "t-eos-oracle", eos=[eos])])
    assert streams(out) == streams(ref)
    assert out[0]["finish"] == "eos" and out[0]["tokens"] == base[:3]
    assert eng.kv.allocator.used_pages == 0


def test_cancellation_discards_the_column(weights):
    np_params = weights[2]
    prompt = [1, 2, 3, 4]
    eng = torch_engine(np_params)
    base = [5, 9, 2, 7] * 10

    async def run():
        try:
            stream = await eng.generate(
                Context.new(PreprocessedRequest.from_dict(request(base, 40, "ngram")))
            )
            got = 0
            async for item in stream:
                got += len((item.data or {}).get("token_ids") or [])
                if got >= 2:
                    stream.ctx.stop_generating()
            for _ in range(200):
                await asyncio.sleep(0.01)
                if eng.kv.allocator.used_pages == 0:
                    break
            assert eng.kv.allocator.used_pages == 0
            return got, await collect(eng, request(prompt, 8))
        finally:
            await eng.stop()

    got, after = asyncio.run(asyncio.wait_for(run(), WAIT_S))
    assert got >= 2 and after["error"] is None
    assert streams([after]) == streams(serve(torch_engine(np_params), [request(prompt, 8)]))
    assert all(s is None or not s.spec.inflight for s in eng.sched.slots)


def test_penalized_lane_falls_back(weights):
    np_params = weights[2]
    prompt = [5, 9, 2, 7] * 4
    pen = dict(frequency_penalty=0.6)
    base = serve(torch_engine(np_params), [request(prompt, 12, sampling=pen)])
    eng = torch_engine(np_params)
    out = serve(eng, [request(prompt, 12, "ngram", sampling=pen)])
    assert streams(out) == streams(base)
    assert out[0]["spec"] is None and eng.spec_armed_requests == 0


def test_echo_logprobs_compose(weights):
    np_params = weights[2]
    prompt = [5, 6, 7, 8, 5, 6, 7, 8]
    samp = dict(logprobs=2)
    base = serve(torch_engine(np_params),
                 [request(prompt, 6, sampling=samp, prompt_logprobs=2)])[0]
    spec.register_drafter("t-echo-oracle", lambda: OracleDrafter(prompt + base["tokens"]))
    out = serve(torch_engine(np_params),
                [request(prompt, 6, "t-echo-oracle", sampling=samp, prompt_logprobs=2)])[0]
    assert out["tokens"] == base["tokens"]
    assert out["spec"]["accepted_tokens"] > 0
    assert out["plp"] == base["plp"] and len(out["plp"]) == len(prompt)


def test_unknown_or_failing_drafter_fails_its_request(weights):
    np_params = weights[2]
    spec.register_drafter("t-failing", FailingDrafter)
    eng = torch_engine(np_params)
    out = serve(eng, [request([1, 2, 3], 6, "no-such-drafter"), request([4, 5, 6], 6),
                      request([7, 8, 9, 7, 8, 9], 12, "t-failing")])
    assert "unknown drafter 'no-such-drafter'" in out[0]["error"]
    assert out[1]["error"] is None and len(out[1]["tokens"]) == 6
    assert "drafter 't-failing' failed: drafter exploded" in out[2]["error"]
    assert eng.kv.allocator.used_pages == 0


def test_serving_env_overrides(weights, monkeypatch):
    """``DYN_SPEC_FOLD`` and ``DYN_SPEC_AUTO_DISABLE`` win over the config,
    with the JAX engine's parse; folding needs the packed mixed plane."""
    np_params = weights[2]
    monkeypatch.setenv("DYN_SPEC_FOLD", "0")
    monkeypatch.setenv("DYN_SPEC_AUTO_DISABLE", "off")
    eng = torch_engine(np_params)
    assert not eng._fold_spec and not eng._spec_auto_disable
    monkeypatch.setenv("DYN_SPEC_FOLD", "1")
    monkeypatch.setenv("DYN_SPEC_AUTO_DISABLE", "yes")
    eng = torch_engine(np_params, fold_spec_verify=False, spec_auto_disable=False)
    assert eng._fold_spec and eng._spec_auto_disable
    assert not torch_engine(np_params, packed_ragged=False)._fold_spec
    monkeypatch.delenv("DYN_SPEC_FOLD")
    assert torch_engine(np_params)._fold_spec
    assert not torch_engine(np_params, fold_spec_verify=False)._fold_spec


def test_pending_draft_precompute_consumed(weights):
    """Each commit precomputes the lane's next proposal, stamped with its
    history length, and the next dispatch takes it: about one proposal
    per verify, not two."""

    class CountingOracle(OracleDrafter):
        calls = 0

        def propose(self, history, n):
            CountingOracle.calls += 1
            return super().propose(history, n)

    np_params = weights[2]
    prompt = [1, 2, 3, 4, 5]
    base = serve(torch_engine(np_params), [request(prompt, 16)])[0]["tokens"]
    spec.register_drafter("t-counting", lambda: CountingOracle(prompt + base))
    for kw in ({}, dict(fold_spec_verify=False)):
        CountingOracle.calls = 0
        eng = torch_engine(np_params, **kw)
        out = serve(eng, [request(prompt, 16, "t-counting")])[0]
        assert out["tokens"] == base and out["spec"]["accepted_tokens"] > 0
        assert 0 < eng.spec_verify_steps <= CountingOracle.calls <= eng.spec_verify_steps + 1


def test_usage_speculation_and_metrics_over_http(model_dir):
    """A completion with ``speculation`` through both HTTP services: the
    plain text, ``usage.speculation`` with the JAX service's keys and
    accepted counts (a greedy oracle), and the ``dynamo_spec_*`` families
    on the port's ``/metrics``."""
    from dynamo_tpu_torch.llm.tokenizer import Tokenizer
    from tests.test_torch_frontend import NAME, http, jax_service, torch_service

    tok = Tokenizer.from_model_dir(model_dir)
    jcfg = JaxModelConfig.tiny(vocab_size=tok.vocab_size)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    stack = (model_dir, jcfg, jparams, np_params)
    prompt = tok.encode("hello world hello world", add_special_tokens=False)
    # the oracle: the greedy continuation, from the engine directly
    cfg = ModelConfig.tiny(vocab_size=tok.vocab_size)
    direct = TorchEngine(cfg, params_from_numpy(np_params, cfg, device="cpu"),
                         EngineConfig(**ENGINE), device="cpu",
                         metrics_registry=MetricsRegistry())
    plain_ids = serve(direct, [request(prompt, 8)])[0]["tokens"]
    register_both("t-http-oracle", lambda: OracleDrafter(prompt + plain_ids))
    body = {"model": NAME, "prompt": prompt, "max_tokens": 8, "temperature": 0}
    extra = {"speculation": {"num_draft_tokens": 4, "drafter": "t-http-oracle"}}

    async def post(engine, service, extra, scrape=False):
        await service.start()
        try:
            status, _, raw = await asyncio.wait_for(
                http(service.address[1], "POST", "/v1/completions", {**body, **extra}),
                WAIT_S,
            )
            assert status == 200, raw[:300]
            metrics = b""
            if scrape:
                _, _, metrics = await asyncio.wait_for(
                    http(service.address[1], "GET", "/metrics"), WAIT_S
                )
            return json.loads(raw), metrics.decode()
        finally:
            await service.stop()
            await engine.stop()

    async def all_three():
        plain, _ = await post(*torch_service(stack, {}), {})
        ref, _ = await post(*jax_service(stack, {}), extra)
        got, metrics = await post(*torch_service(stack, {}), extra, scrape=True)
        return plain, ref, got, metrics

    plain, ref, got, metrics = asyncio.run(asyncio.wait_for(all_three(), RUN_S))
    text = plain["choices"][0]["text"]
    assert got["choices"][0]["text"] == ref["choices"][0]["text"] == text
    assert "speculation" not in plain["usage"]
    usage, ref_usage = got["usage"]["speculation"], ref["usage"]["speculation"]
    assert sorted(usage) == sorted(ref_usage)
    assert usage["drafter"] == ref_usage["drafter"] == "t-http-oracle"
    assert usage["accepted_tokens"] == ref_usage["accepted_tokens"] > 0
    assert usage["drafted_tokens"] == ref_usage["drafted_tokens"]
    for family in ("dynamo_spec_drafted_tokens_total", "dynamo_spec_accepted_tokens_total",
                   "dynamo_spec_verify_steps_total", "dynamo_spec_folded_verify_steps_total",
                   "dynamo_spec_requests_total", "dynamo_spec_accept_rate",
                   "dynamo_spec_enabled_frac", "dynamo_spec_draft_seconds_bucket",
                   "dynamo_spec_verify_seconds_bucket",
                   "dynamo_spec_auto_disabled_requests_total"):
        assert family in metrics, family
