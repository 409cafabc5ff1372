"""The port's engine chaos sites against the JAX package's.

``offload.copy_fail`` (the eviction snapshot, ``evict/{hash:x}``; the swap
snapshot, ``swap/{rid}``), ``onboard.truncate`` (a prefix onboard keyed by
the request id; the swap restore, ``swap/{rid}``) and
``spec.draft_corrupt`` (the settled draft) fire in ``TorchEngine`` where
they fire in ``JaxEngine``, with the same keys.  Each scenario serves the
same tiny f32 weights (the JAX ``init_params`` pytree through
``params_from_numpy``) and the same traffic in both packages, each armed
by its own package's injector with the same ``DYN_FAULTS`` schedule:

* the greedy streams equal the JAX engine's and the unfaulted run's (a
  chaos fallback recomputes, it never changes output);
* the fallbacks' counters (``copy_fails``, ``swap_fallbacks``,
  ``onboard_fallbacks`` and their ``dynamo_kv_*`` series by cause) and the
  injectors' fire counts equal the JAX engine's;
* no page leaks, and a refused swap releases its budget;
* a corrupted draft, folded or standalone, costs only acceptance: the
  stream equals spec-off and no drafted token is accepted.

Every scenario runs once per package in a module fixture (the serial loop,
so counts are deterministic); every served request is bounded by
``asyncio.wait_for``.
"""

from __future__ import annotations

import asyncio

import jax
import numpy as np
import pytest

import dynamo_tpu.spec as jax_spec
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.runtime import faults as jax_faults
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.metrics import MetricsRegistry as JaxRegistry
from dynamo_tpu_torch import spec
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime import faults
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.tokens.sequence import TokenBlockSequence

WAIT_S = 60  # bound on any one served request or batch
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run
PROMPT_A = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]  # 3 blocks of 4
PROMPT_B = [7, 7, 7, 7, 8, 8, 8, 8, 6, 6, 6, 6]
EXTEND = [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22]  # past A's blocks
PAIR = ([3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8])
OFFLOAD = dict(max_batch_size=2, max_seq_len=64, page_size=4, num_pages=17,
               host_offload_blocks=32, async_dispatch=False)
SPEC_ENGINE = dict(max_batch_size=4, max_seq_len=96, page_size=4, num_pages=64,
                   mixed_token_budget=16, async_dispatch=False)
SPEC_PROMPT = [1, 2, 3, 4, 5]
FALLBACK_SERIES = ("dynamo_kv_offload_copy_failures", "dynamo_kv_swap_fallbacks",
                   "dynamo_kv_onboard_fallbacks")
INJECTORS = {"jax": jax_faults.injector, "torch": faults.injector}


class OracleDrafter:
    """Replays a known continuation of the history (full acceptance)."""

    def __init__(self, full):
        self.full = list(full)

    def propose(self, history, n):
        k = len(history)
        return self.full[k : k + n]


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def make_engine(pkg, weights, **kw):
    """An engine of either package with a registry of its own (returned
    beside it, so the fallback series can be read)."""
    jcfg, jparams, np_params = weights
    if pkg == "jax":
        reg = JaxRegistry()
        return JaxEngine(jcfg, jparams, JaxEngineConfig(**kw), metrics_registry=reg), reg
    cfg = ModelConfig.tiny()
    reg = MetricsRegistry()
    eng = TorchEngine(cfg, params_from_numpy(np_params, cfg, device="cpu"),
                      EngineConfig(**kw), device="cpu", metrics_registry=reg)
    return eng, reg


def request(tokens, max_tokens=4, drafter=None) -> dict:
    r = {
        "token_ids": list(tokens),
        "stop_conditions": {"max_tokens": max_tokens},
        "sampling_options": {"temperature": 0.0},
        "eos_token_ids": [],
    }
    if drafter is not None:
        r["speculation"] = {"enabled": True, "num_draft_tokens": 4, "drafter": drafter}
    return r


async def collect(engine, req: dict) -> dict:
    if isinstance(engine, JaxEngine):
        stream = await engine.generate(JaxContext.new(JaxRequest.from_dict(req)))
    else:
        stream = await engine.generate(Context.new(PreprocessedRequest.from_dict(req)))

    async def read():
        out = dict(tokens=[], finish=None, spec=None)
        async for item in stream:
            assert not item.is_error(), item.error_message()
            data = item.data or {}
            out["tokens"] += data.get("token_ids") or []
            out["finish"] = data.get("finish_reason") or out["finish"]
            out["spec"] = data.get("spec") or out["spec"]
        return out

    return await asyncio.wait_for(read(), WAIT_S)


def fallback_lines(registry) -> list:
    """The samples of the chaos fallbacks' series, as rendered."""
    text = registry.render()[0].decode()
    return sorted(
        line for line in text.splitlines()
        if line.startswith(FALLBACK_SERIES) and "_created" not in line
    )


def offload_counts(engine) -> dict:
    oe = engine.offload_engine
    return dict(
        copy_fails=oe.copy_fails, swap_fallbacks=oe.swap_fallbacks,
        onboard_fallbacks=oe.onboard_fallbacks, swap_outs=oe.swap_outs,
        swap_ins=oe.swap_ins, swap_used=oe._swap_used,
        preempt_swap=engine.sched.preempt_swap,
        preempt_recompute=engine.sched.preempt_recompute,
        used_pages=engine.kv.allocator.used_pages,
    )


async def _armed(pkg, spec_str, body):
    """Run ``body()`` with ``spec_str`` armed in ``pkg``'s injector; the
    injector's fire counts come back beside its result."""
    inj = INJECTORS[pkg]
    inj.configure(spec_str)
    try:
        out = await body()
        fired = {site: inj.fire_count(site) for site in
                 ("offload.copy_fail", "onboard.truncate", "spec.draft_corrupt")}
    finally:
        inj.disable()
    return out, fired


async def _pressure(pkg, weights, spec_str, num_pages=13):
    """The swap pair over a tight pool (preemption under decode growth)."""
    engine, reg = make_engine(pkg, weights, **OFFLOAD | dict(num_pages=num_pages))
    try:
        async def body():
            return await asyncio.gather(*[collect(engine, request(p, 24)) for p in PAIR])

        if spec_str:
            outs, fired = await _armed(pkg, spec_str, body)
        else:
            outs, fired = await body(), {}
        return dict(streams=[o["tokens"] for o in outs], fired=fired,
                    counts=offload_counts(engine), series=fallback_lines(reg))
    finally:
        await engine.stop()


async def _evict_copy_fail(pkg, weights):
    """Every eviction snapshot's copy fails: nothing lands in G2, and A's
    second serve recomputes what the first computed."""
    engine, reg = make_engine(pkg, weights, **OFFLOAD)
    try:
        async def body():
            first = await collect(engine, request(PROMPT_A))
            churn = []
            for i in range(12):
                churn.append(await collect(engine, request([(7 + p + i) % 30 for p in PROMPT_A])))
            await asyncio.to_thread(engine.offload_engine.drain)
            return first, churn

        (first, churn), fired = await _armed(pkg, "seed=1;offload.copy_fail=1:match=evict/", body)
        landed = len(engine.offload)
        second = await collect(engine, request(PROMPT_A))
        return dict(first=first["tokens"], second=second["tokens"],
                    churn=[c["tokens"] for c in churn], landed=landed, fired=fired,
                    tier_hits=dict(engine.offload_engine.tier_hits),
                    counts=offload_counts(engine), series=fallback_lines(reg))
    finally:
        await engine.stop()


async def _prefix_truncate(pkg, weights, **kw):
    """A's blocks evicted to G2, then A extended past them: the admission
    matches A's blocks in the host tier and the truncated onboard
    recomputes them in place."""
    engine, reg = make_engine(pkg, weights, **OFFLOAD | kw)
    try:
        longer = PROMPT_A + EXTEND
        first = await collect(engine, request(longer))
        a_hashes = TokenBlockSequence(PROMPT_A, block_size=4).sequence_hashes()
        pool = engine.sched.pool
        for i in range(12):
            if not any(pool.is_registered(h) for h in a_hashes):
                break
            await collect(engine, request([(p + i) % 30 for p in PROMPT_B]))
        await asyncio.to_thread(engine.offload_engine.drain)
        offloaded = len(engine.offload)

        async def body():
            return await collect(engine, request(longer))

        second, fired = await _armed(pkg, "seed=1;onboard.truncate=1", body)
        # unfaulted again: the recomputed blocks registered in G1
        third = await collect(engine, request(longer))
        return dict(first=first["tokens"], second=second["tokens"], third=third["tokens"],
                    offloaded=offloaded, fired=fired, counts=offload_counts(engine),
                    series=fallback_lines(reg))
    finally:
        await engine.stop()


async def _draft_corrupt(pkg, weights, **kw):
    """Spec-off, then an oracle drafter clean, then the oracle corrupted."""
    engine, _ = make_engine(pkg, weights, **SPEC_ENGINE | kw)
    try:
        base = await collect(engine, request(SPEC_PROMPT, max_tokens=12))
        kind = f"chaos-oracle-{len(kw)}"  # each package has its own registry
        register = jax_spec.register_drafter if pkg == "jax" else spec.register_drafter
        register(kind, lambda: OracleDrafter(SPEC_PROMPT + base["tokens"]))
        clean = await collect(engine, request(SPEC_PROMPT, max_tokens=12, drafter=kind))

        async def body():
            return await collect(engine, request(SPEC_PROMPT, max_tokens=12, drafter=kind))

        corrupt, fired = await _armed(pkg, "seed=7;spec.draft_corrupt=1", body)
        return dict(base=base, clean=clean, corrupt=corrupt, fired=fired,
                    used_pages=engine.kv.allocator.used_pages)
    finally:
        await engine.stop()


SCENARIOS = {
    "swap_roomy": lambda pkg, w: _pressure(pkg, w, None, num_pages=41),
    "swap_copy_fail": lambda pkg, w: _pressure(pkg, w, "seed=3;offload.copy_fail=1:match=swap/"),
    "swap_truncate": lambda pkg, w: _pressure(pkg, w, "seed=3;onboard.truncate=1:match=swap/"),
    "evict_copy_fail": _evict_copy_fail,
    "prefix_packed": _prefix_truncate,
    "prefix_classic": lambda pkg, w: _prefix_truncate(pkg, w, mixed_batching=False),
    "prefix_chunked": lambda pkg, w: _prefix_truncate(
        pkg, w, mixed_batching=False, prefill_chunk_tokens=4),
    "spec_folded": _draft_corrupt,
    "spec_fold_off": lambda pkg, w: _draft_corrupt(pkg, w, fold_spec_verify=False),
}


@pytest.fixture(scope="module")
def served(weights):
    for inj in INJECTORS.values():
        inj.disable()
    out = {}
    try:
        for pkg in ("jax", "torch"):
            out[pkg] = {name: asyncio.run(
                asyncio.wait_for(run(pkg, weights), RUN_S)
            ) for name, run in SCENARIOS.items()}
    finally:
        for inj in INJECTORS.values():
            inj.disable()
    return out


@pytest.mark.parametrize("name", ["swap_copy_fail", "swap_truncate"])
def test_swap_chaos_recomputes_like_jax(served, name):
    t, j = served["torch"][name], served["jax"][name]
    roomy = served["torch"]["swap_roomy"]["streams"]
    assert t["streams"] == j["streams"] == roomy
    assert t["counts"] == j["counts"]
    assert t["fired"] == j["fired"]
    assert t["series"] == j["series"]
    c = t["counts"]
    assert c["used_pages"] == 0 and c["swap_used"] == 0  # nothing leaked
    if name == "swap_copy_fail":
        site, cause = "offload.copy_fail", "copy_fail"
        assert c["preempt_swap"] == 0 and c["preempt_recompute"] >= 1
        assert c["copy_fails"] == c["swap_fallbacks"] == t["fired"][site] >= 1
    else:
        site, cause = "onboard.truncate", "truncate"
        assert c["swap_ins"] == 0 and c["swap_fallbacks"] == t["fired"][site] >= 1
    assert f'dynamo_kv_swap_fallbacks_total{{cause="{cause}"}} {float(t["fired"][site])}' in t["series"]


def test_evict_copy_fail_is_a_cache_miss_like_jax(served):
    t, j = served["torch"]["evict_copy_fail"], served["jax"]["evict_copy_fail"]
    assert t["first"] == t["second"] == j["first"] == j["second"]
    assert t["churn"] == j["churn"]
    assert t["landed"] == 0  # failed copies never land in G2
    assert t["tier_hits"]["host"] == 0
    assert t["fired"] == j["fired"] and t["fired"]["offload.copy_fail"] >= 1
    assert t["counts"] == j["counts"]
    assert t["counts"]["copy_fails"] == t["fired"]["offload.copy_fail"]
    assert t["counts"]["used_pages"] == 0
    assert t["series"] == j["series"]


@pytest.mark.parametrize("name", ["prefix_packed", "prefix_classic", "prefix_chunked"])
def test_prefix_onboard_truncate_recomputes_like_jax(served, name):
    t, j = served["torch"][name], served["jax"][name]
    assert t["offloaded"] > 0
    assert t["first"] == t["second"] == t["third"] == j["first"] == j["second"]
    assert t["fired"] == j["fired"] and t["fired"]["onboard.truncate"] >= 1
    assert t["counts"] == j["counts"]
    assert t["counts"]["onboard_fallbacks"] == t["fired"]["onboard.truncate"]
    assert t["counts"]["used_pages"] == 0
    assert t["series"] == j["series"]
    n = float(t["fired"]["onboard.truncate"])
    assert f'dynamo_kv_onboard_fallbacks_total{{cause="truncate"}} {n}' in t["series"]


@pytest.mark.parametrize("name", ["spec_folded", "spec_fold_off"])
def test_draft_corrupt_costs_only_acceptance_like_jax(served, name):
    t, j = served["torch"][name], served["jax"][name]
    base = t["base"]["tokens"]
    assert len(base) == 12
    assert t["clean"]["tokens"] == t["corrupt"]["tokens"] == base == j["corrupt"]["tokens"]
    assert t["clean"]["spec"]["acceptance_rate"] == 1.0
    assert t["fired"]["spec.draft_corrupt"] >= 1
    assert t["fired"] == j["fired"]
    assert t["corrupt"]["spec"]["accepted_tokens"] == 0
    assert t["corrupt"]["spec"]["acceptance_rate"] == 0.0
    assert t["corrupt"]["spec"] == j["corrupt"]["spec"]
    assert t["corrupt"]["finish"] == j["corrupt"]["finish"] == "length"
    assert t["used_pages"] == 0
