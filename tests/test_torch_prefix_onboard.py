"""The port's cross-worker prefix onboarding (``dynamo_tpu_torch/llm/
prefix_onboard.py`` and ``TorchEngine.export_blocks``) against the JAX
package's.

Both packages' engines run on the tiny f32 model, the port's on weights
crossed from the JAX ``init_params`` by ``params_from_numpy``:

* ``export_blocks`` gives ``JaxEngine.export_blocks``'s hashes, metas and
  blob bytes for a chain whose head is resident in G1 and whose tail lies
  in the offload tiers (G2 host, G3 disk), and the ``kv_export`` handlers
  stream the same frames byte for byte;
* cross-worker onboarding over one in-process hub, both ways and within
  each package (the JAX tests' ``test_prefix_onboard.py`` case): the
  importer's greedy tokens equal a plain engine's, it onboards the blocks
  asked for, fails no fetch, counts the JAX importer's ``_prefix_hits``,
  and its imported pages equal the donor's byte for byte;
* a dead donor recomputes the prefix (the JAX tests' second case), and the
  legacy one-frame donor stream is read.

The cross-package runs happen once per module; every wait is bounded.
"""

from __future__ import annotations

import asyncio
import contextlib
import json

import jax
import numpy as np
import pytest

from dynamo_tpu import offload as joff
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.llm import prefix_onboard as jpo
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.runtime.component import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime.engine import AsyncEngineContext as JaxEngineContext
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.metrics import MetricsRegistry as JaxRegistry
from dynamo_tpu_torch import offload as toff
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm import prefix_onboard as tpo
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import AsyncEngineContext, Context
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.transports.hub import HubServer
from dynamo_tpu_torch.tokens.hashing import hash_blocks

WAIT_S = 60  # bound on any one stream, export or onboard
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run
ENGINE = dict(max_batch_size=2, max_seq_len=64, page_size=4, num_pages=17, async_dispatch=False)
PROMPT = [7, 3, 7, 3, 5, 5, 9, 1, 2, 8, 4, 6]  # 3 blocks of 4; 2 onboard
MAX_TOKENS = 6
# the export chain: PROMPT's 3 blocks (G1 on the donor) then 2 blocks the
# test puts into the donor's tiers (host ring of 1: the first demotes to disk)
CHAIN = PROMPT + [1, 1, 2, 2, 3, 3, 4, 4]
PAIRS = [("jax", "jax"), ("jax", "torch"), ("torch", "jax"), ("torch", "torch")]
PKG = {"jax": jpo, "torch": tpo}


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = ModelConfig.tiny()
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, tparams


def make_engine(pkg, weights, **kw):
    jcfg, jparams, cfg, tparams = weights
    if pkg == "jax":
        return JaxEngine(jcfg, jparams, JaxEngineConfig(**(ENGINE | kw)),
                         metrics_registry=JaxRegistry())
    return TorchEngine(cfg, tparams, EngineConfig(**(ENGINE | kw)), device="cpu",
                       metrics_registry=MetricsRegistry())


def request(tokens, max_tokens=MAX_TOKENS) -> dict:
    return {
        "token_ids": list(tokens),
        "stop_conditions": {"max_tokens": max_tokens},
        "sampling_options": {"temperature": 0.0},
        "eos_token_ids": [],
    }


def context(pkg, tokens, donor=None):
    if pkg == "jax":
        ctx = JaxContext.new(JaxRequest.from_dict(request(tokens)))
    else:
        ctx = Context.new(PreprocessedRequest.from_dict(request(tokens)))
    if donor is not None:
        ctx.metadata[tpo.DONOR_META_KEY] = donor
    return ctx


async def read(stream) -> list:
    async def body():
        tokens = []
        async for item in stream:
            assert not item.is_error(), item.error_message()
            tokens += (item.data or {}).get("token_ids") or []
        return tokens

    return await asyncio.wait_for(body(), WAIT_S)


async def serve(engine, pkg, tokens, donor=None) -> list:
    return await read(await engine.generate(context(pkg, tokens, donor)))


def pages_of(engine, hashes) -> list:
    """Host bytes of the pool pages registered under ``hashes``."""
    pool, kv = engine.sched.pool, np.asarray(engine.kv.pages)
    return [kv[:, :, list(pool._registered[h].pages)].tobytes() for h in hashes]


@contextlib.asynccontextmanager
async def hub_addr():
    hub = HubServer()
    host, port = await hub.start()
    try:
        yield f"{host}:{port}"
    finally:
        await hub.stop()


async def no_body():
    return
    yield


# ---------------------------------------------------------------------------
# the donor side: export_blocks and the kv_export stream
# ---------------------------------------------------------------------------


def _tail_blob(seed: int) -> np.ndarray:
    c = ModelConfig.tiny()
    shape = (c.num_layers, 2, 1, ENGINE["page_size"], c.num_kv_heads, c.head_dim)
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


async def _export(pkg, weights, root) -> dict:
    """A donor of ``pkg`` with PROMPT's blocks in G1 and CHAIN's two last
    blocks in its tiers: its export of CHAIN, and its handler's frames."""
    engine = make_engine(pkg, weights, host_offload_blocks=1, disk_offload_blocks=8,
                         disk_offload_dir=root)
    off = joff if pkg == "jax" else toff
    try:
        await serve(engine, pkg, PROMPT)
        _, hashes = hash_blocks(CHAIN, 4)
        for i in (3, 4):
            engine.offload_engine.submit_put(
                hashes[i], _tail_blob(i),
                off.BlockMeta(block_hash=100 + i, parent_sequence_hash=hashes[i - 1],
                              position=i, kv_dtype="float32"),
            )
        await asyncio.to_thread(engine.offload_engine.drain)
        assert len(engine.offload_engine.disk) == 1  # the first tail block demoted
        found = await asyncio.wait_for(engine.export_blocks(list(hashes)), WAIT_S)
        ctx = (JaxEngineContext if pkg == "jax" else AsyncEngineContext)("x")
        gen = await PKG[pkg].kv_export_handler(engine)(
            {"meta": {"hashes": list(hashes)}}, no_body(), ctx
        )
        frames = [bytes(f) async for f in gen]
        return {
            "hashes": [int(h) for h, _b, _m in found],
            "metas": [dict(m) for _h, _b, m in found],
            "blobs": [np.asarray(b).tobytes() for _h, b, _m in found],
            "frames": frames,
        }
    finally:
        await engine.stop()


@pytest.fixture(scope="module")
def exports(weights, tmp_path_factory):
    return {
        pkg: asyncio.run(
            asyncio.wait_for(_export(pkg, weights, str(tmp_path_factory.mktemp(f"g3-{pkg}"))), RUN_S)
        )
        for pkg in ("jax", "torch")
    }


def test_export_blocks_matches_jax(exports):
    """G1 head (3 blocks) then the G2 and G3 tail (2 blocks): the same
    hashes, metas and blob bytes as the JAX engine's export."""
    jax_out, port_out = exports["jax"], exports["torch"]
    _, hashes = hash_blocks(CHAIN, 4)
    assert port_out["hashes"] == jax_out["hashes"] == [int(h) for h in hashes]
    assert port_out["metas"] == jax_out["metas"]
    assert port_out["metas"][0]["kv_dtype"] == "float32"
    assert port_out["blobs"][3:] == [_tail_blob(3).tobytes(), _tail_blob(4).tobytes()]
    for got, want in zip(port_out["blobs"], jax_out["blobs"]):
        np.testing.assert_allclose(
            np.frombuffer(got, np.float32), np.frombuffer(want, np.float32), atol=1e-5
        )


def test_kv_export_frames_match_jax(exports):
    """The handlers' streams: the same meta frames byte for byte and the
    same chunk frames (the G1 blocks' values within 1e-5, f32)."""
    jax_frames, port_frames = exports["jax"]["frames"], exports["torch"]["frames"]
    assert len(port_frames) == len(jax_frames) == 2 * len(CHAIN) // 4
    for i, (got, want) in enumerate(zip(port_frames, jax_frames)):
        if i % 2 == 0:
            assert got == want
            assert json.loads(got)["chunk_bytes"] == tpo.EXPORT_CHUNK_BYTES
        else:
            assert len(got) == len(want) and got[:16] == want[:16]  # index, offset
            np.testing.assert_allclose(
                np.frombuffer(got[16:], np.float32), np.frombuffer(want[16:], np.float32),
                atol=1e-5,
            )
    assert port_frames[-1] == jax_frames[-1]  # the G3 block's bytes exactly


# ---------------------------------------------------------------------------
# cross-worker onboarding over one hub, both ways
# ---------------------------------------------------------------------------


async def _onboard(weights, donor_pkg, importer_pkg, addr, ns_name) -> dict:
    drt = await (JaxRuntime if donor_pkg == "jax" else DistributedRuntime).detached(addr)
    irt = await (JaxRuntime if importer_pkg == "jax" else DistributedRuntime).detached(addr)
    donor = make_engine(donor_pkg, weights)
    importer = make_engine(importer_pkg, weights, host_offload_blocks=8)
    wrapper = PKG[importer_pkg].PrefixOnboardEngine(
        importer, irt.namespace(ns_name), "workers"
    )
    try:
        await drt.namespace(ns_name).component("workers").endpoint(
            PKG[donor_pkg].KV_EXPORT_ENDPOINT
        ).serve_raw(PKG[donor_pkg].kv_export_handler(donor))
        donor_tokens = await serve(donor, donor_pkg, PROMPT)
        tokens = await serve(
            wrapper, importer_pkg, PROMPT, {"instance": drt.primary_lease, "blocks": 2}
        )
        _, hashes = hash_blocks(PROMPT, 4)
        return {
            "donor_tokens": donor_tokens,
            "tokens": tokens,
            "onboarded": wrapper.onboarded_blocks,
            "failed": wrapper.failed_fetches,
            "prefix_hits": importer._prefix_hits,
            "donor_pages": pages_of(donor, hashes[:2]),
            "pages": pages_of(importer, hashes[:2]),
        }
    finally:
        await wrapper.close()
        await importer.stop()
        await donor.stop()
        await drt.shutdown()
        await irt.shutdown()


async def _cross(weights) -> dict:
    plain = make_engine("jax", weights)
    try:
        out = {"expect": await serve(plain, "jax", PROMPT)}
    finally:
        await plain.stop()
    async with hub_addr() as addr:
        for i, (d, m) in enumerate(PAIRS):
            out[(d, m)] = await _onboard(weights, d, m, addr, f"onb{i}")
    return out


@pytest.fixture(scope="module")
def cross(weights):
    return asyncio.run(asyncio.wait_for(_cross(weights), RUN_S))


@pytest.mark.parametrize("donor, importer", PAIRS, ids=[f"{d}-to-{m}" for d, m in PAIRS])
def test_onboarding_crosses_packages(cross, donor, importer):
    got = cross[(donor, importer)]
    assert got["donor_tokens"] == cross["expect"]
    assert got["tokens"] == cross["expect"]
    assert got["onboarded"] == 2 and got["failed"] == 0
    # the prefix really was reused: 2 blocks x 4 tokens hit the importer's
    # cache, as they do the JAX importer's fed by a JAX donor
    assert got["prefix_hits"] == cross[("jax", "jax")]["prefix_hits"] == 8
    assert got["pages"] == got["donor_pages"]


def test_onboarding_donor_failure_recomputes(weights):
    """A dead donor must not fail the request: it recomputes the prefix,
    and the failure is counted."""

    async def body():
        async with hub_addr() as addr:
            rt = await DistributedRuntime.detached(addr)
            engine = make_engine("torch", weights, host_offload_blocks=8)
            wrapper = tpo.PrefixOnboardEngine(engine, rt.namespace("onb"), "workers")
            try:
                tokens = await serve(wrapper, "torch", PROMPT, {"instance": 0xDEAD, "blocks": 2})
                return tokens, wrapper.failed_fetches, wrapper.onboarded_blocks
            finally:
                await wrapper.close()
                await engine.stop()
                await rt.shutdown()

    tokens, failed, onboarded = asyncio.run(asyncio.wait_for(body(), RUN_S))
    assert tokens == asyncio.run(asyncio.wait_for(_plain_port(weights), RUN_S))
    assert failed == 1 and onboarded == 0


async def _plain_port(weights) -> list:
    engine = make_engine("torch", weights)
    try:
        return await serve(engine, "torch", PROMPT)
    finally:
        await engine.stop()


def test_legacy_one_frame_donor_is_read(weights):
    """A donor of the legacy wire form (one meta frame without
    ``chunk_bytes``, then the whole blob in one frame) still onboards."""

    def legacy_handler(engine):
        async def handler(hdr, chunks, ctx):
            async for _ in chunks:
                pass

            async def gen():
                found = await engine.export_blocks([int(h) for h in hdr["meta"]["hashes"]])
                for seq_hash, blob, meta in found:
                    yield json.dumps({"seq_hash": int(seq_hash), "dtype": str(blob.dtype),
                                      "shape": list(blob.shape), "meta": meta}).encode()
                    yield np.ascontiguousarray(blob).tobytes()

            return gen()

        return handler

    async def body():
        async with hub_addr() as addr:
            drt = await DistributedRuntime.detached(addr)
            irt = await DistributedRuntime.detached(addr)
            donor = make_engine("torch", weights)
            importer = make_engine("torch", weights, host_offload_blocks=8)
            wrapper = tpo.PrefixOnboardEngine(importer, irt.namespace("legacy"), "workers")
            try:
                await drt.namespace("legacy").component("workers").endpoint(
                    tpo.KV_EXPORT_ENDPOINT
                ).serve_raw(legacy_handler(donor))
                expect = await serve(donor, "torch", PROMPT)
                tokens = await serve(wrapper, "torch", PROMPT,
                                     {"instance": drt.primary_lease, "blocks": 2})
                _, hashes = hash_blocks(PROMPT, 4)
                return (expect, tokens, wrapper.onboarded_blocks, wrapper.failed_fetches,
                        pages_of(donor, hashes[:2]), pages_of(importer, hashes[:2]))
            finally:
                await wrapper.close()
                await importer.stop()
                await donor.stop()
                await drt.shutdown()
                await irt.shutdown()

    expect, tokens, onboarded, failed, donor_pages, pages = asyncio.run(
        asyncio.wait_for(body(), RUN_S)
    )
    assert tokens == expect
    assert onboarded == 2 and failed == 0
    assert pages == donor_pages
