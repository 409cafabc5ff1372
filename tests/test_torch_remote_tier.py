"""The port's G4 remote tier (``dynamo_tpu_torch/offload.py``: the blob
frames, ``InMemoryBlobStore``, ``RemoteTier``, the ``--kv-remote`` grammar,
``RemoteKVMetrics``) against the JAX package's.

* **Frames**: dense f32, bf16 and quantized blobs round-trip; a frame
  either package packs is the other's byte for byte and unpacks there (a
  bf16 blob as the port's ``uint16`` bits, as JAX's ``bfloat16``); the JAX
  tests' framing violations raise ``ValueError`` in both.
* **RemoteTier** put and fetch through ``InMemoryBlobStore`` and
  ``note_remote`` (the JAX tests' cases); the ``dynamo_kv_g4_*`` series
  render as the JAX package's do.
* **Faults**: ``remote.fetch_fail`` and ``remote.blob_corrupt`` fall back to
  recompute with no leaked page and the JAX engine's tokens; with no fault
  the same onboard reuses the prefix.
* **Both ways through the hub's blob verbs**: a worker of either package
  mirrors its evicted blocks into a ``HubServer`` over ``HubBlobClient``
  and a cold worker of the other fetches them; equal greedy tokens, and the
  imported pages are the stored blobs byte for byte.
* ``parse_kv_remote_spec`` and the engines' ``kv_remote_spec`` (config,
  ``DYN_KV_REMOTE`` winning, a malformed value warning) equal JAX's.

Every wait is bounded.
"""

from __future__ import annotations

import asyncio
import logging

import jax
import ml_dtypes
import numpy as np
import pytest

from dynamo_tpu import offload as joff
from dynamo_tpu.engine import kv_cache as jkv
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.llm import prefix_onboard as jpo
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.metrics import MetricsRegistry as JaxRegistry
from dynamo_tpu.runtime.metrics import RemoteKVMetrics as JaxRemoteKVMetrics
from dynamo_tpu.runtime.transports.client import HubBlobClient as JaxHubBlobClient
from dynamo_tpu.runtime.transports.client import HubClient as JaxHubClient
from dynamo_tpu_torch import offload as toff
from dynamo_tpu_torch.engine import kv_cache as tkv
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm import prefix_onboard as tpo
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime import faults
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry, RemoteKVMetrics
from dynamo_tpu_torch.runtime.transports.client import HubBlobClient, HubClient
from dynamo_tpu_torch.runtime.transports.hub import HubServer
from dynamo_tpu_torch.tokens.sequence import TokenBlockSequence

WAIT_S = 60  # bound on any one served request, onboard or drain
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run
OFFLOAD = dict(max_batch_size=2, max_seq_len=64, page_size=4, num_pages=17,
               host_offload_blocks=32)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]  # 3 blocks of 4


@pytest.fixture
def injector():
    """The port's process injector, disarmed on the way out."""
    faults.injector.disable()
    yield faults.injector
    faults.injector.disable()


def _blob(seed, shape=(2, 2, 3, 4, 2, 8)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _blobs(kind: str):
    """(JAX blob, port blob) of the same values: f32, bf16 (ml_dtypes'
    bfloat16 and its uint16 bits), int8 (a quantized pair in each form)."""
    x = _blob(7)
    if kind == "f32":
        return x, x
    if kind == "bf16":
        xb = x.astype(ml_dtypes.bfloat16)
        return xb, xb.view(np.uint16)
    q = jkv.quantize_kv_blob(x)
    return q, tkv.QuantKV(q=q.q, s=q.s)


def _same(a, b) -> None:
    if isinstance(a, (jkv.QuantKV, tkv.QuantKV)):
        _same(a.q, b.q)
        _same(a.s, b.s)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# the wire frame
# ---------------------------------------------------------------------------


KINDS = ["f32", "bf16", "int8"]
DTYPE = {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}


@pytest.mark.parametrize("kind", KINDS)
def test_frame_roundtrip(kind):
    _jblob, blob = _blobs(kind)
    meta = toff.BlockMeta(block_hash=11, parent_sequence_hash=7, position=3,
                          kv_dtype=DTYPE[kind])
    frame = toff.pack_kv_blob_frame(blob, meta)
    out, m = toff.unpack_kv_blob_frame(frame)
    _same(out, blob)
    if kind == "bf16":
        assert out.dtype == np.uint16
    if kind == "int8":
        # int8 ships the int8 bytes and f32 scales, not a full-width payload
        assert isinstance(out, tkv.QuantKV) and len(frame) < _blob(7).nbytes
    assert m.to_dict() == meta.to_dict()


@pytest.mark.parametrize("kind", KINDS)
def test_frames_cross_packages(kind):
    """The port's frame is the JAX package's byte for byte, and each
    package unpacks the other's."""
    jblob, tblob = _blobs(kind)
    meta = dict(block_hash=5, parent_sequence_hash=2, position=1, kv_dtype=DTYPE[kind])
    tframe = toff.pack_kv_blob_frame(tblob, toff.BlockMeta(**meta))
    jframe = joff.pack_kv_blob_frame(jblob, joff.BlockMeta(**meta))
    assert tframe == jframe
    out, m = joff.unpack_kv_blob_frame(tframe)
    _same(out, jblob)
    assert m.to_dict() == meta
    out, m = toff.unpack_kv_blob_frame(jframe)
    _same(out, tblob)
    assert m.to_dict() == meta


def _violations():
    frame = joff.pack_kv_blob_frame(_blob(3), joff.BlockMeta(block_hash=1))
    return {
        "header-word": frame[:2],
        "header": frame[:20],
        "half": frame[: len(frame) // 2],
        "short": frame[:-1],
        "long": frame + b"x",
        "header-length": b"\xff\xff\xff\xff" + frame[4:],
        "not-json": b"\x08\x00\x00\x00notjson!" + frame[4:],
    }


@pytest.mark.parametrize("case", list(_violations()))
def test_frame_violations_raise_value_error(case):
    bad = _violations()[case]
    for off in (toff, joff):
        with pytest.raises(ValueError):
            off.unpack_kv_blob_frame(bad)


# ---------------------------------------------------------------------------
# RemoteTier over the in-memory store; the G4 series
# ---------------------------------------------------------------------------


def test_remote_tier_put_fetch_roundtrip():
    tier = toff.RemoteTier(toff.InMemoryBlobStore(), worker_id=3, namespace="t",
                           registry=MetricsRegistry())
    try:
        adverts = []
        tier.holdings_cb = adverts.extend
        blob = _blob(4)
        meta = toff.BlockMeta(block_hash=9, position=1)
        assert tier.submit_put(42, blob, meta).result(WAIT_S) is True
        assert tier.contains(42)
        got = tier.fetch_blocking(42)
        assert got is not None
        out, m = got
        assert np.array_equal(out, blob) and m.block_hash == 9
        # a successful put advertised (hash, "remote", frame nbytes)
        assert len(adverts) == 1
        h, t, nbytes = adverts[0]
        assert (h, t) == (42, "remote") and nbytes > blob.nbytes
        st = tier.stats()
        assert st["g4_puts"] == 1 and st["g4_fetches"] == 1
        assert st["kv_g4_gbps"] > 0
        # a hash nobody stored is a miss, counted as such
        assert tier.fetch_blocking(777) is None
        assert tier.stats()["g4_fetch_fails"] == {"missing": 1}
        # the store's names are the JAX package's
        assert tier._name(42) == joff.RemoteTier._name(tier, 42) == "kv/t/000000000000002a"
    finally:
        tier.close()


def test_remote_tier_note_remote_merges_adverts():
    tier = toff.RemoteTier(toff.InMemoryBlobStore(), worker_id=1, registry=MetricsRegistry())
    try:
        assert not tier.contains(5)
        tier.note_remote(5, 1234)  # another worker's G4 advert
        assert tier.contains(5) and tier.known_blocks() == 1
    finally:
        tier.close()


def _g4_lines(text: str) -> list:
    return sorted(
        line for line in text.splitlines()
        if "dynamo_kv_g4" in line and "_created" not in line
    )


def test_remote_metrics_render_like_jax():
    treg, jreg = MetricsRegistry(), JaxRegistry()
    for m in (RemoteKVMetrics(treg), JaxRemoteKVMetrics(jreg)):
        m.record_store(4096, 0.002)
        m.record_fetch(2048, 0.3)
        m.blocks.set(3)
        m.fetch_failures.labels("blob_corrupt").inc()
    got, want = _g4_lines(treg.render()[0].decode()), _g4_lines(jreg.render()[0].decode())
    assert got == want
    assert 'dynamo_kv_g4_bytes_total{op="store"} 4096.0' in got


def test_staging_buffer_byte_chunks_equal_jax():
    for shape, dtype in (((2, 2, 1, 4, 2, 8), "float32"), ((2, 2, 1, 4, 2, 8), "bfloat16"),
                         ((2, 2, 1, 4, 2, 8), "int8"), ((0, 2, 1, 4, 2, 8), "float32")):
        t = toff.KVStagingBuffer.for_byte_chunks(shape, dtype, 100)
        j = joff.KVStagingBuffer.for_byte_chunks(shape, jax.numpy.dtype(dtype), 100)
        assert t.bounds == j.bounds
        raw = np.arange(t.flat.size, dtype=np.uint8)
        t.flat[:] = raw
        j.flat[:] = raw
        _same(j.payload(), t.payload())  # bf16: JAX's values, the port's bits
        if dtype == "bfloat16":
            assert t.payload().dtype == np.uint16


# ---------------------------------------------------------------------------
# faults: a failed or corrupt G4 fetch recomputes, leaks nothing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = ModelConfig.tiny()
    return jcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def make_engine(pkg, weights, **kw):
    jcfg, jparams, tparams = weights
    if pkg == "jax":
        return JaxEngine(jcfg, jparams, JaxEngineConfig(**(OFFLOAD | kw)),
                         metrics_registry=JaxRegistry())
    return TorchEngine(ModelConfig.tiny(), tparams, EngineConfig(**(OFFLOAD | kw)),
                       device="cpu", metrics_registry=MetricsRegistry())


def request(tokens) -> dict:
    return {
        "token_ids": list(tokens),
        "stop_conditions": {"max_tokens": 4},
        "sampling_options": {"temperature": 0.0},
        "eos_token_ids": [],
    }


async def collect(engine, tokens) -> list:
    if isinstance(engine, JaxEngine):
        stream = await engine.generate(JaxContext.new(JaxRequest.from_dict(request(tokens))))
    else:
        stream = await engine.generate(Context.new(PreprocessedRequest.from_dict(request(tokens))))

    async def read():
        out = []
        async for item in stream:
            assert not item.is_error(), item.error_message()
            out += (item.data or {}).get("token_ids") or []
        return out

    return await asyncio.wait_for(read(), WAIT_S)


async def publish_prefix(engine, store, prompt, worker_id=1) -> tuple:
    """A warm worker: serve ``prompt``, churn it out of G1 so the host-tier
    eviction mirrors every prefix block into the G4 store; returns the
    greedy tokens, the prefix hashes and the store's blob of each."""
    oe = engine.offload_engine
    oe.attach_remote(store, worker_id=worker_id, namespace="t", mirror=True)
    first = await collect(engine, prompt)
    hashes = [int(h) for h in TokenBlockSequence(prompt, block_size=4).sequence_hashes()]
    pool = engine.sched.pool
    for i in range(16):
        await asyncio.wait_for(asyncio.to_thread(oe.drain), WAIT_S)
        if not any(pool.is_registered(h) for h in hashes) and all(
            oe.remote.contains(h) for h in hashes
        ):
            break
        await collect(engine, [(7 + p + i) % 30 for p in prompt])
    await asyncio.wait_for(asyncio.to_thread(oe.drain), WAIT_S)
    assert all(oe.remote.contains(h) for h in hashes)
    return first, hashes


def _onboarder(mod, engine):
    return mod.PrefixOnboardEngine(engine, None, "workers", engine=engine)


@pytest.fixture(scope="module")
def jax_tokens(weights):
    async def body():
        engine = make_engine("jax", weights)
        try:
            return await collect(engine, PROMPT)
        finally:
            await engine.stop()

    return asyncio.run(asyncio.wait_for(body(), RUN_S))


async def _published(weights):
    store = toff.InMemoryBlobStore()
    w = make_engine("torch", weights)
    try:
        first, hashes = await publish_prefix(w, store, PROMPT)
    finally:
        await w.stop()
    return store, first, hashes


@pytest.mark.parametrize("site", ["remote.fetch_fail", "remote.blob_corrupt"])
def test_remote_fault_falls_back_to_recompute(weights, jax_tokens, injector, site):
    async def body():
        store, first, hashes = await _published(weights)
        assert first == jax_tokens
        c = make_engine("torch", weights)
        try:
            remote = c.offload_engine.attach_remote(store, worker_id=2, namespace="t",
                                                    mirror=False)
            injector.configure(f"seed=3;{site}=1")
            ob = _onboarder(tpo, c)
            free_before = c.kv.allocator.free_pages
            await asyncio.wait_for(ob._onboard_remote(hashes), WAIT_S)
            # every fetch failed: nothing onboarded, nothing half applied
            assert ob.onboarded_blocks == 0 and ob.failed_fetches >= 1
            assert len(c.offload) == 0
            # no leaked page: a failed onboard must not touch the pool
            assert c.kv.allocator.free_pages == free_before
            assert remote.fetch_fails.get(site.split(".", 1)[1], 0) >= 1
            # the request recomputes the prefix: the JAX engine's tokens
            assert await collect(c, PROMPT) == jax_tokens
        finally:
            await c.stop()

    asyncio.run(asyncio.wait_for(body(), RUN_S))


def test_remote_onboard_happy_path_reuses_prefix(weights, jax_tokens, injector):
    """The fault pair's control leg: with no fault the same onboard delivers
    every block and the tokens still match."""

    async def body():
        store, _first, hashes = await _published(weights)
        c = make_engine("torch", weights)
        try:
            c.offload_engine.attach_remote(store, worker_id=2, namespace="t", mirror=False)
            ob = _onboarder(tpo, c)
            await asyncio.wait_for(ob._onboard_remote(hashes), WAIT_S)
            assert ob.onboarded_blocks == len(hashes) and ob.failed_fetches == 0
            assert len(c.offload) == len(hashes)
            hits_before = c._prefix_hits
            assert await collect(c, PROMPT) == jax_tokens
            assert c._prefix_hits > hits_before
        finally:
            await c.stop()

    asyncio.run(asyncio.wait_for(body(), RUN_S))


# ---------------------------------------------------------------------------
# both ways through the hub's blob verbs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("publisher, importer", [("jax", "torch"), ("torch", "jax")],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_g4_crosses_packages_over_the_hub(weights, jax_tokens, publisher, importer):
    """A worker of one package mirrors its evicted prefix into a hub over
    ``HubBlobClient``; a cold worker of the other fetches it from there,
    onboards every block, serves the JAX engine's tokens, and holds the
    stored blobs in its pages byte for byte."""
    clients = {"jax": (JaxHubClient, JaxHubBlobClient), "torch": (HubClient, HubBlobClient)}
    mods = {"jax": jpo, "torch": tpo}

    async def body():
        server = HubServer()
        host, port = await server.start()
        conns = []
        try:
            loop = asyncio.get_running_loop()

            async def store(pkg):
                client_cls, blob_cls = clients[pkg]
                conns.append(await client_cls(host, port).connect())
                return blob_cls(conns[-1], loop)

            w = make_engine(publisher, weights)
            try:
                first, hashes = await publish_prefix(w, await store(publisher), PROMPT)
            finally:
                await w.stop()
            c = make_engine(importer, weights)
            try:
                c.offload_engine.attach_remote(await store(importer), worker_id=2,
                                               namespace="t", mirror=False)
                ob = _onboarder(mods[importer], c)
                await asyncio.wait_for(ob._onboard_remote(hashes), WAIT_S)
                tokens = await collect(c, PROMPT)
                frames = [await conns[0].blob_get(f"kv/t/{h & (2**64 - 1):016x}")
                          for h in hashes]
                pool, kv = c.sched.pool, np.asarray(c.kv.pages)
                reused = hashes[: (len(PROMPT) - 1) // 4]
                pages = [kv[:, :, list(pool._registered[h].pages)].tobytes() for h in reused]
                return first, tokens, ob.onboarded_blocks, ob.failed_fetches, frames, pages, reused
            finally:
                await c.stop()
        finally:
            for conn in conns:
                await conn.close()
            await server.stop()

    first, tokens, onboarded, failed, frames, pages, reused = asyncio.run(
        asyncio.wait_for(body(), RUN_S)
    )
    assert first == tokens == jax_tokens
    assert onboarded == len(frames) and failed == 0
    for frame, page in zip(frames, pages):
        blob, _meta = toff.unpack_kv_blob_frame(frame)
        assert np.ascontiguousarray(blob).tobytes() == page
    assert len(pages) == len(reused) == 2


# ---------------------------------------------------------------------------
# the --kv-remote grammar and the engines' parse
# ---------------------------------------------------------------------------


SPECS = [
    "", "off", "0", "on", "1", "yes",
    "mirror=0,fetch=1", "prefill_tok_s=2000,gbps=2.5,namespace=prod",
    "mirror=off,namespace=x,", "gbps=0", "gbps=-1", "gbps=fast", "bogus=1", "mirror",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_kv_remote_spec_equals_jax(spec):
    try:
        want = joff.parse_kv_remote_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            toff.parse_kv_remote_spec(spec)
        return
    assert toff.parse_kv_remote_spec(spec) == want
    assert toff.env_remote_spec({"DYN_KV_REMOTE": spec}) == joff.env_remote_spec(
        {"DYN_KV_REMOTE": spec}
    )


@pytest.mark.parametrize(
    "config, env",
    [("on", None), ("namespace=prod,mirror=0", "gbps=2"), ("on", "off"),
     ("on", "gbps=fast"), ("bogus=1", None), (None, None)],
)
def test_engine_kv_remote_spec_equals_jax(weights, monkeypatch, caplog, config, env):
    """``EngineConfig.kv_remote`` parsed into ``kv_remote_spec``:
    ``DYN_KV_REMOTE`` wins (an explicit off disarms), a malformed value
    warns and is not used -- the JAX engine's rule."""
    if env is not None:
        monkeypatch.setenv("DYN_KV_REMOTE", env)
    else:
        monkeypatch.delenv("DYN_KV_REMOTE", raising=False)
    specs = {}
    with caplog.at_level(logging.WARNING):
        for pkg in ("jax", "torch"):
            e = make_engine(pkg, weights, kv_remote=config)
            specs[pkg] = e.kv_remote_spec
            e.offload_engine.close()
    assert specs["torch"] == specs["jax"]
    malformed = "fast" in (env or "") or "bogus" in (config or "")
    assert any("malformed" in r.getMessage() for r in caplog.records) == malformed


def test_attach_remote_kv_needs_spec_and_plane(weights):
    store = toff.InMemoryBlobStore()
    armed = make_engine("torch", weights, kv_remote="namespace=prod,mirror=0")
    unarmed = make_engine("torch", weights)
    no_plane = make_engine("torch", weights, kv_remote="on", host_offload_blocks=0)
    try:
        armed.attach_remote_kv(store, worker_id=7)
        remote = armed.offload_engine.remote
        assert remote is not None and remote.namespace == "prod" and remote.worker_id == 7
        assert armed.offload_engine._remote_mirror is False
        unarmed.attach_remote_kv(store)
        assert unarmed.offload_engine.remote is None
        no_plane.attach_remote_kv(store)  # no offload plane: a no-op
        assert no_plane.offload_engine is None
    finally:
        for e in (armed, unarmed):
            e.offload_engine.close()
