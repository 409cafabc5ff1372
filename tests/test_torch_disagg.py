"""The port's disaggregated prefill/decode (``dynamo_tpu_torch/llm/disagg.py``
and the engine's KV export and import) against the JAX package's.

Every case of ``tests/test_disagg.py`` has a counterpart here, driven
through ``TorchEngine(device="cpu")`` workers on the tiny f32 model whose
weights come from the JAX ``init_params`` (crossed by
``params_from_numpy``); the streams a case expects are the JAX aggregated
engine's on the same weights and prompts.  Beyond them:

* the port's export blob and first-token row equal
  ``JaxEngine._prefill_export``'s (within 1e-5, f32);
* wire compatibility both ways on one hub: a JAX ``PrefillWorker`` feeds
  the port's ``DisaggDecodeEngine`` and the port's ``PrefillWorker`` feeds
  the JAX one, chunked and monolithic, with the aggregated streams; a bf16
  JAX export lands in the port's pool byte for byte;
* a dense prefiller feeding an int8 decode pool gives the JAX package's
  streams for the same mix (wire and same-process device handoff);
* ``disagg.enqueue_fail`` falls back to local prefill and opens the
  breaker; the port's ``disagg-conf`` writes the key JAX's
  ``start_config_watch`` reads; ``KVStagingBuffer`` bounds equal JAX's.

The JAX runs happen once per module; every async wait is bounded.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu import offload as joff
from dynamo_tpu.engine import kv_cache as jkv
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.llm import disagg as jdis
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.runtime.component import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.metrics import MetricsRegistry as JaxRegistry
from dynamo_tpu.runtime.transports.codec import encode_chunk_frame
from dynamo_tpu_torch import offload as toff
from dynamo_tpu_torch.engine import kv_cache as tkv
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.model import init_params
from dynamo_tpu_torch.engine.step import gather_block_pages
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm import disagg as tdis
from dynamo_tpu_torch.llm.disagg import (
    DisaggConfig,
    DisaggDecodeEngine,
    DisaggRouter,
    disagg_conf_key,
)
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime import faults
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.component import DistributedRuntime, PushRouter
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.transports.hub import HubServer

WAIT_S = 30  # bound on any one stream, delivery or poll
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run
ENGINE = dict(max_batch_size=4, max_seq_len=64, page_size=4, num_pages=64)
LONG = [7, 3, 7, 3, 5, 5, 9, 1, 2, 8, 4, 6]
SHORT = [1, 2, 3]
EIGHT = [3, 1, 4, 1, 5, 9, 2, 6]
DESC = [5, 4, 3, 2, 1, 0, 1, 2]
# (prompt, max_tokens) of every stream a case compares with aggregated
# serving, by the name the cases use
PROMPTS = {
    "long": (LONG, 6), "short": (SHORT, 6), "eight": (EIGHT, 6), "desc": (DESC, 5),
    "ok": ([1, 2, 3], 6),
}


def request(tokens, max_tokens=6) -> dict:
    return {
        "token_ids": list(tokens),
        "stop_conditions": {"max_tokens": max_tokens},
        "sampling_options": {"temperature": 0.0},
        "eos_token_ids": [],
    }


def preq(tokens, max_tokens=6) -> PreprocessedRequest:
    return PreprocessedRequest.from_dict(request(tokens, max_tokens))


async def read(stream) -> list:
    async def body():
        tokens = []
        async for item in stream:
            assert not item.is_error(), item.error_message()
            tokens += (item.data or {}).get("token_ids") or []
        return tokens

    return await asyncio.wait_for(body(), WAIT_S)


async def read_error(stream):
    async def body():
        async for item in stream:
            if item.is_error():
                return item.error_message()
        return None

    return await asyncio.wait_for(body(), WAIT_S)


# ---------------------------------------------------------------------------
# weights, engines, and the JAX package's runs (once per module)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = ModelConfig.tiny()
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, tparams


def port_engine(weights, **kw) -> TorchEngine:
    _, _, cfg, tparams = weights
    return TorchEngine(cfg, tparams, EngineConfig(**(ENGINE | kw)), device="cpu",
                       metrics_registry=MetricsRegistry())


def jax_engine(weights, **kw) -> JaxEngine:
    jcfg, jparams, _, _ = weights
    return JaxEngine(jcfg, jparams, JaxEngineConfig(**(ENGINE | kw)),
                     metrics_registry=JaxRegistry())


async def jax_collect(engine, tokens, max_tokens):
    stream = await engine.generate(JaxContext.new(JaxRequest.from_dict(request(tokens, max_tokens))))
    return await read(stream)


class _Holder:
    """A weakly referenceable stand-in engine for a decode engine whose
    config watch is all a case reads."""


@contextlib.asynccontextmanager
async def hub_addr():
    hub = HubServer()
    host, port = await hub.start()
    try:
        yield hub, f"{host}:{port}"
    finally:
        await hub.stop()


@contextlib.asynccontextmanager
async def decode_side(pkg, addr, engine, **cfg_kw):
    """A decode worker of package ``pkg`` on its own runtime: the disagg
    engine over ``engine`` with ``kv_deliver`` served."""
    rt = await (JaxRuntime if pkg == "jax" else DistributedRuntime).detached(addr)
    mod = jdis if pkg == "jax" else tdis
    ns = rt.namespace("disagg")
    disagg = mod.DisaggDecodeEngine(
        engine, ns, "decode", instance_id=rt.primary_lease,
        cfg=mod.DisaggConfig(**({"max_local_prefill_length": 8} | cfg_kw)), block_size=4,
    )
    await ns.component("decode").endpoint(mod.KV_DELIVER_ENDPOINT).serve_raw(
        disagg.kv_deliver_handler()
    )
    try:
        yield disagg
    finally:
        await engine.stop()
        await rt.shutdown()


@contextlib.asynccontextmanager
async def prefill_side(pkg, addr, engine, **kw):
    rt = await (JaxRuntime if pkg == "jax" else DistributedRuntime).detached(addr)
    mod = jdis if pkg == "jax" else tdis
    pw = mod.PrefillWorker(engine, rt.namespace("disagg"), **kw)
    await pw.start()
    try:
        yield pw
    finally:
        await pw.stop()
        await engine.stop()
        await rt.shutdown()


async def disagg_tokens(disagg, tokens, max_tokens):
    ctx_cls = JaxContext if isinstance(disagg, jdis.DisaggDecodeEngine) else Context
    return await read(await disagg.generate(ctx_cls.new(request(tokens, max_tokens))))


async def _jax_reference(weights) -> dict:
    out: dict = {}
    agg = jax_engine(weights)
    try:
        out["agg"] = {n: await jax_collect(agg, p, m) for n, (p, m) in PROMPTS.items()}
        blob, row = await agg.prefill_export(JaxRequest.from_dict(request(EIGHT)))
        out["export"] = (np.asarray(blob), np.asarray(row))
    finally:
        await agg.stop()
    q = jax_engine(weights, kv_dtype="int8")
    try:
        out["int8"] = await jax_collect(q, LONG, 6)
    finally:
        await q.stop()
    # the JAX package's own disagg stack on a dense prefiller feeding an
    # int8 decode pool over the wire: what the port's mix must give
    async with hub_addr() as (_hub, addr):
        async with decode_side("jax", addr, jax_engine(weights, kv_dtype="int8")) as dec:
            async with prefill_side("jax", addr, jax_engine(weights), allow_local=False):
                out["mix"] = await disagg_tokens(dec, LONG, 6)
    bcfg = JaxModelConfig.tiny(dtype="bfloat16")
    bf = JaxEngine(bcfg, jax_init_params(bcfg, jax.random.PRNGKey(1)),
                   JaxEngineConfig(**ENGINE), metrics_registry=JaxRegistry())
    try:
        out["bf16"] = await bf.prefill_export(JaxRequest.from_dict(request(LONG)))
        streams = await bf.prefill_export_batch_stream(
            [JaxRequest.from_dict(request(LONG))], layers_per_chunk=1
        )
        s = streams[0]
        out["bf16_stream"] = (s, [(i, part) async for i, _lo, _hi, part in s.chunks()])
    finally:
        await bf.stop()
    return out


@pytest.fixture(scope="module")
def ref(weights):
    return asyncio.run(asyncio.wait_for(_jax_reference(weights), RUN_S))


def expect(ref, name):
    return ref["agg"][name]


# ---------------------------------------------------------------------------
# the counterparts of tests/test_disagg.py
# ---------------------------------------------------------------------------


def test_disagg_router_policy_equals_jax():
    cases = [(80, 0, 0), (200, 0, 0), (200, 150, 0), (200, 0, 4), (101, 0, 3), (100, 0, 0)]
    cfg = dict(max_local_prefill_length=100, max_prefill_queue_depth=4)
    t = DisaggRouter(DisaggConfig(**cfg))
    j = jdis.DisaggRouter(jdis.DisaggConfig(**cfg))
    got = [t.prefill_remote(*c) for c in cases]
    assert got == [j.prefill_remote(*c) for c in cases]
    assert got == [False, True, False, False, True, False]


def test_prefill_export_import_roundtrip(weights, ref):
    async def body():
        prefiller, decode = port_engine(weights), port_engine(weights)
        try:
            blob, first = await prefiller.prefill_export(preq(EIGHT))
            assert blob.shape[0] == decode.model_cfg.num_layers
            ctx = Context.new(preq(EIGHT))
            stream = await decode.generate_external(ctx)
            assert decode.deliver_external(ctx.id, blob, first)
            assert await read(stream) == expect(ref, "eight")
            assert decode.kv.allocator.used_pages == 0
            assert prefiller.kv.allocator.used_pages == 0
        finally:
            await decode.stop()
            await prefiller.stop()

    asyncio.run(asyncio.wait_for(body(), RUN_S))


def test_export_blob_and_row_equal_jax(weights, ref):
    """The port's export of a prompt equals ``JaxEngine._prefill_export``'s:
    the blob within 1e-5 (f32), the first token exactly, its logprob
    within 1e-5."""

    async def body():
        engine = port_engine(weights)
        try:
            return await engine.prefill_export(preq(EIGHT))
        finally:
            await engine.stop()

    blob, row = asyncio.run(asyncio.wait_for(body(), RUN_S))
    jblob, jrow = ref["export"]
    assert blob.shape == jblob.shape and blob.dtype == np.float32
    np.testing.assert_allclose(blob, jblob, rtol=1e-5, atol=1e-5)
    assert int(row[0]) == int(jrow[0])
    np.testing.assert_allclose(row[1:2].view(np.float32), jrow[1:2].view(np.float32),
                               rtol=1e-5, atol=1e-5)


def test_deliver_for_dead_request_is_refused(weights):
    async def body():
        engine = port_engine(weights)
        try:
            assert not engine.deliver_external("nope", np.zeros(1), 5)
            assert not engine.fail_external("nope", "boom")
            assert not engine.begin_external_chunked("nope", (1,), "float32")
        finally:
            await engine.stop()

    asyncio.run(asyncio.wait_for(body(), RUN_S))


def test_fail_external_errors_parked_request_and_frees_pages(weights):
    async def body():
        engine = port_engine(weights)
        try:
            ctx = Context.new(preq([1, 2, 3, 4, 5, 6], 4))
            stream = await engine.generate_external(ctx)
            await asyncio.sleep(0.1)  # let plan() admit + park the lane
            assert engine.sched.num_active == 1
            assert engine.fail_external(ctx.id, "prefill OOM")
            msg = await read_error(stream)
            assert msg is not None and "prefill OOM" in msg
            assert not engine.awaiting_external(ctx.id)
            assert engine.kv.allocator.used_pages == 0
            assert engine.sched.num_active == 0
        finally:
            await engine.stop()

    asyncio.run(asyncio.wait_for(body(), RUN_S))


def test_external_kv_timeout_fails_parked_request(weights):
    async def body():
        engine = port_engine(weights, external_kv_timeout_s=0.3)
        try:
            stream = await engine.generate_external(Context.new(preq([9, 8, 7, 6, 5], 4)))
            msg = await read_error(stream)
            assert msg is not None and "timed out" in msg
            assert engine.kv.allocator.used_pages == 0
        finally:
            await engine.stop()

    asyncio.run(asyncio.wait_for(body(), RUN_S))


def test_misshaped_delivery_fails_only_that_request(weights, ref):
    async def body():
        engine = port_engine(weights)
        try:
            ok = asyncio.ensure_future(read(await engine.generate(Context.new(preq(SHORT, 6)))))
            await asyncio.sleep(0.05)
            ctx = Context.new(preq([4, 5, 6, 7], 4))
            stream = await engine.generate_external(ctx)
            await asyncio.sleep(0.1)
            bad = np.zeros((1, 2, 3, 4, 5, 6), np.float32)  # wrong everything
            assert engine.deliver_external(ctx.id, bad, 1)
            msg = await read_error(stream)
            assert msg is not None and "does not match decode geometry" in msg
            assert await asyncio.wait_for(ok, WAIT_S) == expect(ref, "ok")
        finally:
            await engine.stop()

    asyncio.run(asyncio.wait_for(body(), RUN_S))


def test_oversized_remote_prompt_is_not_enqueued(weights):
    async def body():
        async with hub_addr() as (_hub, addr):
            async with decode_side("torch", addr, port_engine(weights, max_seq_len=32)) as disagg:
                stream = await disagg.generate(Context.new(request(list(range(40)), 4)))
                msg = await read_error(stream)
                assert msg is not None and "max_seq_len" in msg
                assert await disagg.queue.depth() == 0
                assert disagg.remote_prefills == 0

    asyncio.run(asyncio.wait_for(body(), RUN_S))


@pytest.fixture
def traced():
    prev = tracing.collector.component
    tracing.collector.clear()
    tracing.collector.enable()
    yield tracing.collector
    tracing.collector.disable()
    tracing.collector.clear()
    tracing.collector.component = prev


def test_disagg_end_to_end_matches_aggregated(weights, ref, traced):
    """Decode worker + prefill worker + caller over a hub, tracing on: the
    long prompt ships over the wire, the short one stays local, both give
    the aggregated streams; the prefill worker's ``prefill.deliver`` span
    lands under the request's trace, and no KV object ever reaches the
    hub."""

    async def body():
        async with hub_addr() as (hub, addr):
            async with decode_side("torch", addr, port_engine(weights),
                                   max_prefill_queue_depth=4) as disagg:
                drt = disagg.namespace.runtime
                await drt.namespace("disagg").component("decode").endpoint("generate").serve(disagg)
                # pin the wire: the same-process handoff would bypass it
                async with prefill_side("torch", addr, port_engine(weights),
                                        allow_local=False) as pw:
                    crt = await DistributedRuntime.detached(addr)
                    client = await crt.namespace("disagg").component("decode").endpoint(
                        "generate").client()
                    try:
                        await client.wait_for_instances()
                        router = PushRouter(client)

                        async def ask(prompt):
                            ctx = Context.new(request(prompt, 6))
                            return await read(await router.generate(ctx)), ctx.id

                        got_long, rid = await ask(LONG)
                        assert got_long == expect(ref, "long")
                        assert disagg.remote_prefills == 1 and pw.prefills_done == 1
                        spans = {s.name: s for s in traced.get(rid)}
                        assert "prefill.deliver" in spans and "ingress" in spans, sorted(spans)
                        assert spans["prefill.deliver"].trace_id == spans["ingress"].trace_id
                        assert spans["prefill.deliver"].parent_span_id
                        got_short, _ = await ask(SHORT)
                        assert got_short == expect(ref, "short")
                        assert disagg.local_prefills == 1
                        assert hub.state.objects == {}
                        assert pw.transfer_stats()["wire"]["count"] == 1
                    finally:
                        await client.close()
                        await crt.shutdown()

    asyncio.run(asyncio.wait_for(body(), RUN_S))


def test_local_device_delivery_matches_aggregated(weights, ref):
    """Colocated decode + prefill workers hand the KV over as a tensor --
    no wire upload, the aggregated stream."""

    async def body():
        async with hub_addr() as (_hub, addr):
            async with decode_side("torch", addr, port_engine(weights)) as disagg:
                async with prefill_side("torch", addr, port_engine(weights)) as pw:
                    uploads = []
                    orig = pw._upload

                    async def spy(msg, meta, chunks):
                        uploads.append(meta)
                        return await orig(msg, meta, chunks)

                    pw._upload = spy
                    assert await disagg_tokens(disagg, LONG, 6) == expect(ref, "long")
                    assert pw.local_deliveries == 1 and uploads == []
                    assert pw.transfer_stats()["device"]["count"] == 1

    asyncio.run(asyncio.wait_for(body(), RUN_S))


def test_prefill_export_batch_matches_singles(weights):
    """One padded dispatch for a burst gives each request the KV and first
    token of its own export; an empty prompt fails alone."""
    prompts = [EIGHT, [2, 7, 1, 8], [1, 6, 1, 8, 0, 3, 3, 9, 8, 8]]

    async def body():
        engine = port_engine(weights)
        try:
            singles = [await engine.prefill_export(preq(p, 4)) for p in prompts]
            reqs = [preq(p, 4) for p in prompts]
            reqs.insert(2, PreprocessedRequest.from_dict(request([], 4)))
            results = await engine.prefill_export_batch(reqs)
            assert isinstance(results[2], Exception)
            for (blob_s, row_s), (blob_b, row_b) in zip(singles, results[:2] + results[3:]):
                assert row_s[0] == row_b[0]
                np.testing.assert_allclose(row_s[1:2].view(np.float32), row_b[1:2].view(np.float32),
                                           rtol=1e-4, atol=1e-4)
                assert blob_s.shape == blob_b.shape
                np.testing.assert_allclose(blob_s, blob_b, rtol=1e-5, atol=1e-5)
            assert engine.kv.allocator.used_pages == 0
        finally:
            await engine.stop()

    asyncio.run(asyncio.wait_for(body(), RUN_S))


def test_truncated_kv_delivery_fails_parked_lane(weights):
    async def body():
        prefiller, decode = port_engine(weights), port_engine(weights)
        async with hub_addr() as (_hub, addr):
            rt = await DistributedRuntime.detached(addr)
            disagg = DisaggDecodeEngine(decode, rt.namespace("disagg"), "decode", instance_id=0)
            try:
                blob, first = await prefiller.prefill_export(preq(DESC, 4))
                ctx = Context.new(preq(DESC, 4))
                stream = await decode.generate_external(ctx)
                await asyncio.sleep(0.1)
                raw = np.ascontiguousarray(blob).tobytes()

                async def short_chunks():
                    yield raw[: len(raw) // 2]  # ... and the peer dies

                meta = {"request_id": ctx.id, "dtype": str(blob.dtype),
                        "shape": list(blob.shape), "first_token": int(first[0])}
                acks = [a async for a in disagg._kv_deliver({"meta": meta}, short_chunks(), None)]
                assert len(acks) == 1
                msg = await read_error(stream)
                assert msg is not None and "truncated" in msg
                assert decode.kv.allocator.used_pages == 0
            finally:
                await decode.stop()
                await prefiller.stop()
                await rt.shutdown()

    asyncio.run(asyncio.wait_for(body(), RUN_S))


def test_delivery_while_waiting_for_slot_outlives_timeout(weights):
    """A delivery that lands while its request still waits for a slot
    clears the remote-prefill deadline: the request decodes once the slot
    frees."""

    async def body():
        prefiller = port_engine(weights)
        decode = port_engine(weights, max_batch_size=1, external_kv_timeout_s=0.5)
        try:
            blob, first = await prefiller.prefill_export(preq([3, 1, 4, 1, 5], 4))
            # request A holds the only slot, parked without a delivery; it
            # dies at the 0.5 s deadline, freeing the slot
            stream_a = await decode.generate_external(Context.new(preq([9, 8, 7], 4)))
            ctx_b = Context.new(preq([3, 1, 4, 1, 5], 4))
            stream_b = await decode.generate_external(ctx_b)
            assert decode.deliver_external(ctx_b.id, blob, first)
            msg = await read_error(stream_a)
            assert msg is not None and "timed out" in msg
            assert len(await read(stream_b)) == 4
        finally:
            await decode.stop()
            await prefiller.stop()

    asyncio.run(asyncio.wait_for(body(), RUN_S))


def test_disagg_conf_live_reload(weights):
    async def body():
        async with hub_addr() as (_hub, addr):
            rt = await DistributedRuntime.detached(addr)
            engine = port_engine(weights)
            disagg = DisaggDecodeEngine(
                engine, rt.namespace("disagg"), "decode", instance_id=0,
                cfg=DisaggConfig(max_local_prefill_length=8, max_prefill_queue_depth=4),
            )
            await disagg.start_config_watch()
            try:
                await rt.hub.kv_put(disagg_conf_key("disagg"), json.dumps(
                    {"max_local_prefill_length": 100, "max_prefill_queue_depth": 2}).encode())
                await poll(lambda: disagg.router.cfg.max_local_prefill_length == 100)
                assert disagg.router.cfg.max_prefill_queue_depth == 2
                # a malformed update is ignored whole
                await rt.hub.kv_put(disagg_conf_key("disagg"), b"not json")
                await asyncio.sleep(0.2)
                assert disagg.router.cfg.max_local_prefill_length == 100
            finally:
                await disagg.stop_config_watch()
                await engine.stop()
                await rt.shutdown()

    asyncio.run(asyncio.wait_for(body(), RUN_S))


async def poll(cond) -> None:
    for _ in range(int(WAIT_S / 0.02)):
        if cond():
            return
        await asyncio.sleep(0.02)
    raise AssertionError("condition never held")


def test_prefill_export_stream_matches_monolithic(weights):
    async def body():
        engine = port_engine(weights)
        try:
            blob, row = await engine.prefill_export(preq(EIGHT, 4))
            (s,) = await engine.prefill_export_batch_stream([preq(EIGHT, 4)], layers_per_chunk=1)
            assert not isinstance(s, Exception), s
            L = engine.model_cfg.num_layers
            assert s.spans == [(i, i + 1) for i in range(L)]
            got = await s.assemble()
            assert got.shape == blob.shape
            np.testing.assert_allclose(got, blob, rtol=1e-5, atol=1e-5)
            assert int(row[0]) == int(s.row[0])
            bounds = s.chunk_bounds
            assert bounds[0][0] == 0 and bounds[-1][1] == s.nbytes == blob.nbytes
            assert all(b == c for (_a, b), (c, _d) in zip(bounds, bounds[1:]))
            assert s.first_ready_at is not None and s.last_ready_at >= s.first_ready_at
            assert engine.kv.allocator.used_pages == 0
        finally:
            await engine.stop()

    asyncio.run(asyncio.wait_for(body(), RUN_S))


async def _wire_tokens(weights, prompt, max_tokens, chunked, decode_kw=(), prefill_kw=(),
                       decode_pkg="torch", prefill_pkg="torch", layers_per_chunk=1):
    """A decode worker and a prefill worker (either package) over one hub,
    the wire pinned; returns (tokens, the prefill worker's delivery rows)."""
    make = {"torch": port_engine, "jax": jax_engine}
    async with hub_addr() as (_hub, addr):
        async with decode_side(decode_pkg, addr, make[decode_pkg](weights, **dict(decode_kw))) as dec:
            async with prefill_side(
                prefill_pkg, addr, make[prefill_pkg](weights, **dict(prefill_kw)),
                allow_local=False, chunked=chunked, layers_per_chunk=layers_per_chunk,
            ) as pw:
                tokens = await disagg_tokens(dec, prompt, max_tokens)
                assert dec.remote_prefills == 1
                return tokens, list(pw.delivery_stats)


def test_chunked_wire_delivery_is_bit_identical_to_monolithic(weights, ref):
    got_c, stats_c = asyncio.run(asyncio.wait_for(_wire_tokens(weights, LONG, 6, True), RUN_S))
    got_m, stats_m = asyncio.run(asyncio.wait_for(_wire_tokens(weights, LONG, 6, False), RUN_S))
    assert got_c == got_m == expect(ref, "long")
    assert stats_c and stats_c[0]["chunks"] == 2 and "overlap_ratio" in stats_c[0]
    assert stats_m and "chunks" not in stats_m[0]
    assert stats_c[0]["bytes"] == stats_m[0]["bytes"]


@pytest.mark.parametrize("chunked", [True, False])
def test_int8_pool_wire_delivery_matches_aggregated(weights, ref, chunked):
    """An int8 pool's (data, scales) pair on the wire, both framings: the
    JAX aggregated int8 engine's stream."""
    got, stats = asyncio.run(asyncio.wait_for(_wire_tokens(
        weights, LONG, 6, chunked, decode_kw={"kv_dtype": "int8"},
        prefill_kw={"kv_dtype": "int8"},
    ), RUN_S))
    assert got == ref["int8"]
    assert stats and stats[0]["bytes"] == tkv.quant_blob_nbytes((2, 2, 3, 4, 2, 16))


@pytest.mark.parametrize("path", ["wire", "device"])
def test_dense_prefiller_feeds_int8_decode_pool_like_jax(weights, ref, path):
    """A dense prefiller feeding an int8 decode pool converts through the
    shared quantization rule (``coerce_kv_blob``; on the device, the
    pool's own row rule): the JAX package's stream for the same mix."""

    async def device_run():
        async with hub_addr() as (_hub, addr):
            async with decode_side("torch", addr, port_engine(weights, kv_dtype="int8")) as dec:
                async with prefill_side("torch", addr, port_engine(weights)) as pw:
                    tokens = await disagg_tokens(dec, LONG, 6)
                    assert pw.local_deliveries == 1
                    return tokens

    if path == "wire":
        got, _ = asyncio.run(
            asyncio.wait_for(_wire_tokens(weights, LONG, 6, True, decode_kw={"kv_dtype": "int8"}), RUN_S)
        )
    else:
        got = asyncio.run(asyncio.wait_for(device_run(), RUN_S))
    assert got == ref["mix"]


async def _export_chunk_frames(prefiller, prompt, max_tokens):
    """One request's chunked export as (meta, wire frames)."""
    (s,) = await prefiller.prefill_export_batch_stream([preq(prompt, max_tokens)],
                                                       layers_per_chunk=1)
    row = np.asarray(s.row).reshape(-1)
    bounds = s.chunk_bounds
    frames = [encode_chunk_frame(idx, bounds[idx][0], part.tobytes())
              async for idx, _lo, _hi, part in s.chunks()]
    meta = {"request_id": None, "dtype": s.dtype, "shape": list(s.shape),
            "first_token": int(row[0]), "lp_row": [int(x) for x in row],
            "chunked": {"layers": [list(sp) for sp in s.spans], "total_bytes": s.nbytes}}
    return meta, frames


async def _deliver_frames(weights, prompt, max_tokens, edit):
    """Export ``prompt`` on one engine, park it on another, hand the
    decode worker's raw handler ``edit(meta, frames)``'s frames; returns
    (acks, the parked stream, the decode engine)."""
    prefiller, decode = port_engine(weights), port_engine(weights)
    hub = HubServer()
    host, port = await hub.start()
    rt = await DistributedRuntime.detached(f"{host}:{port}")
    disagg = DisaggDecodeEngine(decode, rt.namespace("disagg"), "decode", instance_id=0)
    try:
        meta, frames = await _export_chunk_frames(prefiller, prompt, max_tokens)
        ctx = Context.new(preq(prompt, max_tokens))
        stream = await decode.generate_external(ctx)
        await asyncio.sleep(0.1)  # let plan() admit + park the lane
        meta["request_id"] = ctx.id
        frames = edit(meta, frames)

        async def gen():
            for f in frames:
                yield f

        acks = [a async for a in disagg._kv_deliver({"meta": meta}, gen(), None)]
        return acks, stream, decode
    finally:
        await prefiller.stop()
        await rt.shutdown()
        await hub.stop()


def test_out_of_order_chunk_arrival_decodes_identically(weights, ref):
    async def body():
        acks, stream, decode = await _deliver_frames(
            weights, DESC, 5, lambda meta, frames: list(reversed(frames)))
        try:
            assert [json.loads(a)["ok"] for a in acks] == [True]
            assert await read(stream) == expect(ref, "desc")
            assert decode.kv.allocator.used_pages == 0
        finally:
            await decode.stop()

    asyncio.run(asyncio.wait_for(body(), RUN_S))


def test_truncated_chunked_delivery_fails_parked_lane(weights):
    async def body():
        acks, stream, decode = await _deliver_frames(
            weights, DESC, 4, lambda meta, frames: frames[:1])  # ... and the peer dies
        try:
            assert len(acks) == 1
            msg = await read_error(stream)
            assert msg is not None and "truncated" in msg
            assert decode.kv.allocator.used_pages == 0
        finally:
            await decode.stop()

    asyncio.run(asyncio.wait_for(body(), RUN_S))


def test_non_tiling_layer_spans_are_rejected(weights):
    def duplicate_first_span(meta, frames):
        # 1 + 1 layers "delivered" on a 2-layer model, layer 1 never written
        meta["chunked"]["layers"] = [[0, 1], [0, 1]]
        return frames

    async def body():
        acks, stream, decode = await _deliver_frames(weights, [1, 2, 3, 4, 5], 4,
                                                     duplicate_first_span)
        try:
            assert len(acks) == 1
            msg = await read_error(stream)
            assert msg is not None and "rejected" in msg
            assert decode.kv.allocator.used_pages == 0
        finally:
            await decode.stop()

    asyncio.run(asyncio.wait_for(body(), RUN_S))


def test_layer_chunk_spans_validates_granularity_like_jax():
    for args in [(4, 2), (5, 2), (5, None, 2), (32, None, 8), (3, 7)]:
        assert tkv.layer_chunk_spans(*args) == jkv.layer_chunk_spans(*args)
    for bad in [(4, -1), (0, 1)]:
        with pytest.raises(ValueError, match="positive"):
            tkv.layer_chunk_spans(*bad)


# ---------------------------------------------------------------------------
# across the packages, and the port's own surfaces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunked", [True, False])
def test_jax_prefill_worker_feeds_port_decode_worker(weights, ref, chunked):
    got, stats = asyncio.run(
        asyncio.wait_for(_wire_tokens(weights, LONG, 6, chunked, prefill_pkg="jax"), RUN_S)
    )
    assert got == expect(ref, "long")
    assert stats and stats[0]["path"] == "wire"


@pytest.mark.parametrize("chunked", [True, False])
def test_port_prefill_worker_feeds_jax_decode_worker(weights, ref, chunked):
    got, stats = asyncio.run(
        asyncio.wait_for(_wire_tokens(weights, LONG, 6, chunked, decode_pkg="jax"), RUN_S)
    )
    assert got == expect(ref, "long")
    assert stats and stats[0]["path"] == "wire"


@pytest.mark.parametrize("chunked", [True, False])
def test_bf16_jax_export_lands_byte_for_byte(ref, chunked):
    """A bf16 JAX export (``ml_dtypes`` on the JAX side, ``dtype:
    "bfloat16"`` on the wire) lands in a bf16 port pool bit for bit, both
    framings: the landing zone holds the bits as ``uint16``."""
    blob, row = ref["bf16"]
    s, parts = ref["bf16_stream"]
    cfg = ModelConfig.tiny(dtype="bfloat16")

    async def body():
        decode = TorchEngine(cfg, init_params(cfg, 1, torch.device("cpu"), torch.bfloat16),
                             EngineConfig(**ENGINE), device="cpu",
                             metrics_registry=MetricsRegistry())
        landed = {}
        commit = decode._apply_external_commit

        def spy(seq, *args):
            ids = torch.as_tensor(decode._lane_prompt_pages(seq))
            landed["pages"] = gather_block_pages(decode.kv.pages, ids).view(torch.int16).numpy()
            return commit(seq, *args)

        decode._apply_external_commit = spy
        async with hub_addr() as (_hub, addr):
            rt = await DistributedRuntime.detached(addr)
            disagg = DisaggDecodeEngine(decode, rt.namespace("disagg"), "decode", instance_id=0)
            try:
                ctx = Context.new(preq(LONG, 3))
                stream = await decode.generate_external(ctx)
                first = [int(x) for x in np.asarray(row).reshape(-1)]
                meta = {"request_id": ctx.id, "dtype": str(blob.dtype),
                        "shape": list(blob.shape), "first_token": first[0], "lp_row": first}
                if chunked:
                    meta["chunked"] = {"layers": [list(sp) for sp in s.spans],
                                       "total_bytes": s.nbytes}
                    frames = [encode_chunk_frame(i, s.chunk_bounds[i][0], np.asarray(p).tobytes())
                              for i, p in parts]
                else:
                    raw = np.ascontiguousarray(blob).tobytes()
                    frames = [raw[: len(raw) // 3], raw[len(raw) // 3:]]

                async def gen():
                    for f in frames:
                        yield f

                acks = [a async for a in disagg._kv_deliver({"meta": meta}, gen(), None)]
                assert [json.loads(a)["ok"] for a in acks] == [True]
                tokens = await read(stream)
                assert len(tokens) == 3 and tokens[0] == first[0]
            finally:
                await decode.stop()
                await rt.shutdown()
        return landed["pages"]

    assert str(blob.dtype) == "bfloat16"
    got = asyncio.run(asyncio.wait_for(body(), RUN_S))
    assert got.tobytes() == np.ascontiguousarray(blob).tobytes()


def test_enqueue_fault_falls_back_local_and_opens_breaker(weights, ref):
    """``disagg.enqueue_fail``: the parked lane is released, the request
    prefills locally with the aggregated stream, and repeated failures open
    the breaker (no more enqueue attempts)."""

    async def body():
        faults.injector.configure("seed=1;disagg.enqueue_fail=1")
        try:
            async with hub_addr() as (_hub, addr):
                async with decode_side("torch", addr, port_engine(weights)) as disagg:
                    disagg.breaker.failure_threshold = 2
                    for _ in range(2):
                        assert await disagg_tokens(disagg, LONG, 6) == expect(ref, "long")
                    assert disagg.breaker.state == disagg.breaker.OPEN
                    assert disagg.remote_prefills == 0 and disagg.local_prefills == 2
                    assert await disagg.queue.depth() == 0
                    assert disagg.engine.kv.allocator.used_pages == 0
                    # open: the next long request runs local without trying
                    fired = faults.injector.fire_count("disagg.enqueue_fail")
                    assert fired == 2
                    assert await disagg_tokens(disagg, LONG, 6) == expect(ref, "long")
                    assert faults.injector.fire_count("disagg.enqueue_fail") == fired
        finally:
            faults.injector.disable()

    asyncio.run(asyncio.wait_for(body(), RUN_S))


def test_disagg_conf_cli_writes_the_key_jax_watches(monkeypatch, capsys):
    """``disagg-conf`` (read-modify-write of the namespace's key) moves a
    JAX decode worker's policy."""
    from dynamo_tpu_torch.cli import run_disagg_conf

    async def body():
        async with hub_addr() as (_hub, addr):
            rt = await JaxRuntime.detached(addr)
            disagg = jdis.DisaggDecodeEngine(
                _Holder(), rt.namespace("dynamo"), "decode", instance_id=0,
                cfg=jdis.DisaggConfig(max_local_prefill_length=8, max_prefill_queue_depth=4),
            )
            await disagg.start_config_watch()
            try:
                for length, depth in ((100000, None), (None, 3)):
                    args = argparse.Namespace(hub=addr, namespace="dynamo",
                                              max_local_prefill_length=length,
                                              max_prefill_queue_depth=depth)
                    assert await run_disagg_conf(args) == 0
                await poll(lambda: disagg.router.cfg.max_prefill_queue_depth == 3)
                assert disagg.router.cfg.max_local_prefill_length == 100000
                nothing = argparse.Namespace(hub=addr, namespace="dynamo",
                                             max_local_prefill_length=None,
                                             max_prefill_queue_depth=None)
                assert await run_disagg_conf(nothing) == 2
            finally:
                await disagg.stop_config_watch()
                await rt.shutdown()

    asyncio.run(asyncio.wait_for(body(), RUN_S))
    assert "100000" in capsys.readouterr().out


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_staging_buffer_bounds_equal_jax(dtype):
    shape, spans = (3, 2, 2, 4, 2, 16), [(0, 2), (2, 3)]
    t = toff.KVStagingBuffer.for_layer_spans(shape, dtype, spans)
    j = joff.KVStagingBuffer.for_layer_spans(shape, dtype, spans)
    assert t.bounds == j.bounds and t.flat.size == j.flat.size
    # the same bytes read back as the same blob
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, t.flat.size, dtype=np.uint8)
    raw[:] = np.frombuffer(jkv.pack_quant_blob_bytes(jkv.quantize_kv_blob(
        rng.standard_normal(shape).astype(np.float32)))
        if dtype == "int8" else rng.standard_normal(shape).astype(np.float32).tobytes(), np.uint8)
    t.flat[:], j.flat[:] = raw, raw
    for lo, hi in spans:
        a, b = t.layer_slice(lo, hi), j.layer_slice(lo, hi)
        if dtype == "int8":
            assert a.q.tobytes() == np.asarray(b.q).tobytes()
            assert a.s.tobytes() == np.asarray(b.s).tobytes()
        else:
            assert a.tobytes() == np.asarray(b).tobytes()


def test_bf16_staging_buffer_holds_bits():
    """The bf16 landing zone is ``uint16`` (the card's machine has no
    ``ml_dtypes``), the same bytes as the JAX package's bfloat16 one."""
    shape = (2, 2, 1, 4, 2, 8)
    t = toff.KVStagingBuffer.for_layer_spans(shape, "bfloat16", [(0, 1), (1, 2)])
    j = joff.KVStagingBuffer.for_layer_spans(shape, jnp.dtype("bfloat16"), [(0, 1), (1, 2)])
    assert t.array.dtype == np.uint16 and t.bounds == j.bounds
    vals = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    j.array[:] = vals.astype(jnp.bfloat16)
    t.flat[:] = j.flat
    back = tkv.tensor_view(t.layer_slice(0, 2)).float().numpy()
    assert np.array_equal(back, np.asarray(j.array, np.float32))
    with pytest.raises(ValueError, match="unsupported"):
        toff.KVStagingBuffer.for_layer_spans(shape, "float64", [(0, 2)])
