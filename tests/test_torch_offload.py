"""The port's KV offload plane (G2 host, G3 disk, swap preemption, the
queue-side prefetch and the KV events) against the JAX package's.

* **Tiers**: the JAX package's tier unit cases (``tests/test_offload.py``),
  parametrised over both packages' ``HostTier``/``DiskTier``/
  ``KVOffloadEngine``, with equal holdings deltas.
* **Blob helpers and page copies**: the host blob rules give the JAX
  helpers' bytes; the page gathers and scatters the JAX steps' pools.
* **Engines**: ``TorchEngine(device="cpu")`` and ``JaxEngine`` on the same
  tiny f32 weights (crossed by ``params_from_numpy``) and the same
  traffic: the host round trip, the disk-spill round trip, swap ==
  recompute == a roomy pool (and the host-blob restore path), budget
  exhaustion, the int8 pool.  Streams are equal across packages; in the
  serial loop offloaded-block, tier-hit and ``preempt_swap`` counts and
  the ``stored``/``removed``/``holdings`` event sequences are equal too (as
  multisets in the pipelined loop).  A G3 directory written by either
  engine is read by the other's, a bf16 blob through the ``uint16`` view.
* **Prefetch**: a queued request's chain is promoted and pinned;
  admission and cancel both release the pins.

Each engine scenario runs once per module; every served batch is bounded
by ``asyncio.wait_for``.
"""

from __future__ import annotations

import asyncio
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu import offload as joff
from dynamo_tpu.engine import kv_cache as jkv
from dynamo_tpu.engine import step as jstep
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.ops import paged_attention as jpa
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.metrics import MetricsRegistry as JaxRegistry
from dynamo_tpu_torch import offload as toff
from dynamo_tpu_torch.engine import kv_cache as tkv
from dynamo_tpu_torch.engine import step as tstep
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.tokens.sequence import TokenBlockSequence
from tests.test_torch_ops import _free_compiled_programs  # noqa: F401 (autouse)

WAIT_S = 60  # bound on any one served request or batch
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run
PACKAGES = {"jax": joff, "torch": toff}
PROMPT_A = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]  # 3 blocks of 4
PROMPT_B = [7, 7, 7, 7, 8, 8, 8, 8, 6, 6, 6, 6]
PAIR = ([3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8])
OFFLOAD = dict(max_batch_size=2, max_seq_len=64, page_size=4, num_pages=17,
               host_offload_blocks=32)


def _blob(seed, shape=(2, 2, 1, 4, 2, 8)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _same_blob(a, b) -> None:
    if isinstance(a, (jkv.QuantKV, tkv.QuantKV)):
        _same_blob(a.q, b.q)
        _same_blob(a.s, b.s)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# tiers, parametrised over both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_host_tier_lru_and_capacity(pkg):
    off = PACKAGES[pkg]
    t = off.HostTier(2)
    t.put(1, _blob(1), off.BlockMeta(position=0))
    t.put(2, _blob(2), off.BlockMeta(position=1))
    t.put(3, _blob(3), off.BlockMeta(position=2))  # evicts 1 (LRU, no parent)
    assert t.get(1) is None
    blob, meta = t.get(2)
    assert meta.position == 1 and np.array_equal(blob, _blob(2))
    assert len(t) == 2


def _holdings_run(off, root):
    """One demote/promote/spill sequence with the holdings sink recording."""
    deltas = []
    disk = off.DiskTier(str(root), capacity_blocks=2)
    t = off.HostTier(1, parent=disk)
    t.holdings_cb = deltas.append
    t.put(1, _blob(1), off.BlockMeta(block_hash=11))
    t.put(2, _blob(2), off.BlockMeta(block_hash=22))  # demotes 1 to disk
    assert len(t) == 1 and len(disk) == 1
    blob, meta = t.get(1)  # disk hit, promoted back to G2 (demotes 2)
    assert meta.block_hash == 11 and np.array_equal(blob, _blob(1))
    assert disk.hits == 1
    t.put(3, _blob(3), off.BlockMeta(block_hash=33))  # demotes 1; disk drops 2
    return deltas


def test_host_tier_demotes_to_disk_and_promotes_back_like_jax(tmp_path):
    got = {pkg: _holdings_run(off, tmp_path / pkg) for pkg, off in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    assert any(tier == "disk" for d in got["torch"] for _, tier, _ in d)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_disk_tier_capacity_deletes_files(pkg, tmp_path):
    off = PACKAGES[pkg]
    disk = off.DiskTier(str(tmp_path), capacity_blocks=2)
    for i in range(4):
        disk.put(i, _blob(i), off.BlockMeta())
    assert len(disk) == 2
    assert disk.get(0) is None and disk.get(1) is None
    blob, _ = disk.get(3)
    assert np.array_equal(blob, _blob(3))
    assert len(list(tmp_path.iterdir())) == 2


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_host_ring_is_single_allocation(pkg):
    off = PACKAGES[pkg]
    t = off.HostTier(4)
    for i in range(16):
        t.put(i, _blob(i), off.BlockMeta(position=i))
    assert len(t) == 4
    ring = t._ring
    assert ring is not None and ring.shape[0] == 4
    for i in range(16, 32):
        t.put(i, _blob(i), off.BlockMeta(position=i))
    assert t._ring is ring  # never reallocated
    blob, meta = t.get(31)
    assert np.array_equal(blob, _blob(31)) and meta.position == 31
    for i in range(32, 40):
        t.put(i, _blob(i), off.BlockMeta())
    assert np.array_equal(blob, _blob(31))  # decoupled from slot recycling


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_kv_offload_engine_lookup_is_ram_only(pkg, tmp_path):
    off = PACKAGES[pkg]
    registry = JaxRegistry() if pkg == "jax" else MetricsRegistry()
    eng = off.KVOffloadEngine(2, 8, str(tmp_path / "g3"), registry=registry)
    try:
        eng.disk.put(99, _blob(99), off.BlockMeta(position=7))
        assert eng.lookup(99) is None  # disk-only: schedules the promote
        eng.drain()
        blob, meta, tier = eng.lookup(99)
        assert tier == "host" and meta.position == 7
        assert np.array_equal(blob, _blob(99))
        assert eng.disk_promotes == 1 and eng.tier_hits["host"] == 1
        assert eng.tier_hits["disk"] == 0
        assert 0.0 < eng.tier_hit_rate <= 1.0
    finally:
        eng.close()


def test_env_offload_spec_grammar_equals_jax():
    for env in ({}, {"DYN_KV_OFFLOAD": "off"}, {"DYN_KV_OFFLOAD": "1"},
                {"DYN_KV_OFFLOAD": "host=64,disk=128,dir=/tmp/kv,swap=0"}):
        assert toff.env_offload_spec(env) == joff.env_offload_spec(env)
    for bad in ("host=abc", "bogus=1", "host"):
        for off in PACKAGES.values():
            with pytest.raises(ValueError):
                off.env_offload_spec({"DYN_KV_OFFLOAD": bad})


def test_blocks_meta_round_trip_like_jax():
    d = dict(block_hash=5, parent_sequence_hash=2**63 + 3, position=4, kv_dtype="int8")
    for off in PACKAGES.values():
        m = off.BlockMeta(**d)
        assert off.BlockMeta.from_dict(m.to_dict()) == m
    assert toff.BlockMeta(**d).to_dict() == joff.BlockMeta(**d).to_dict()


# ---------------------------------------------------------------------------
# blob helpers and page copies
# ---------------------------------------------------------------------------


def _dense(rs, shape=(2, 2, 3, 4, 2, 8)):
    x = (rs.standard_normal(shape) * np.logspace(-2, 1, shape[-1])).astype(np.float32)
    x[0, 1, -1, 3] = 0.0  # an all-zero row
    return x


def test_blob_helpers_give_jax_bytes():
    rs = np.random.default_rng(0)
    x = _dense(rs)
    jq, tq = jkv.quantize_kv_blob(x), tkv.quantize_kv_blob(x)
    _same_blob(tq, jq)
    # bf16 bits in, as a bf16 pool's blob travels
    xb = x.astype(ml_dtypes.bfloat16)
    _same_blob(tkv.quantize_kv_blob(xb.view(np.uint16)), jkv.quantize_kv_blob(xb))
    _same_blob(tkv.dequantize_kv_blob(tq), jkv.dequantize_kv_blob(jq))
    _same_blob(
        tkv.dequantize_kv_blob(tq, "bfloat16"),
        jkv.dequantize_kv_blob(jq, ml_dtypes.bfloat16).view(np.uint16),
    )
    parts = [_dense(rs, (2, 2, 1, 4, 2, 8)) for _ in range(3)]
    _same_blob(tkv.kv_blob_concat(parts), jkv.kv_blob_concat(parts))
    qparts = [tkv.quantize_kv_blob(p) for p in parts]
    _same_blob(tkv.kv_blob_concat(qparts), jkv.kv_blob_concat(
        [jkv.QuantKV(q=p.q, s=p.s) for p in qparts]))
    for pool_quant in (False, True):
        for blob_t, blob_j in ((x, x), (tq, jq)):
            _same_blob(
                tkv.coerce_kv_blob(blob_t, pool_quant, "float32"),
                jkv.coerce_kv_blob(blob_j, pool_quant, np.float32),
            )
    wire = tkv.pack_quant_blob_bytes(tq)
    assert wire == jkv.pack_quant_blob_bytes(jq)
    assert len(wire) == tkv.quant_blob_nbytes(x.shape) == jkv.quant_blob_nbytes(x.shape)
    _same_blob(tkv.unpack_quant_blob_bytes(wire, x.shape), jq)
    for L, g in ((32, None), (2, None), (7, 3), (1, 1)):
        assert tkv.layer_chunk_spans(L, g) == jkv.layer_chunk_spans(L, g)
    _same_blob(tkv.pad_page_axis(x, 8), jkv.pad_page_axis(x, 8))
    _same_blob(tkv.pad_page_axis(tq, 4), jkv.pad_page_axis(jq, 4))
    assert torch.equal(tkv.pad_page_axis(torch.from_numpy(x), 8),
                       torch.from_numpy(jkv.pad_page_axis(x, 8)))


def test_host_view_is_bit_exact_for_bf16():
    x = _dense(np.random.default_rng(1)).astype(ml_dtypes.bfloat16)
    t = tkv.tensor_view(x.view(np.uint16))
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(), x.astype(np.float32))
    assert tkv.host_view(t).tobytes() == x.tobytes()


@pytest.mark.parametrize("quant", [False, True])
def test_page_copies_leave_the_jax_pools(quant):
    rs = np.random.default_rng(2)
    dense = _dense(rs, (3, 2, 10, 4, 2, 8))
    if quant:
        jpool = jkv.quantize_kv_blob(dense)
        tpool = tkv.QuantKV(q=torch.from_numpy(jpool.q.copy()), s=torch.from_numpy(jpool.s.copy()))
        jpool = jkv.QuantKV(q=jnp.asarray(jpool.q), s=jnp.asarray(jpool.s))
    else:
        tpool, jpool = torch.from_numpy(dense.copy()), jnp.asarray(dense)
    ids = np.array([7, 2, 5], np.int32)
    got = tstep.gather_block_pages(tpool, torch.from_numpy(ids))
    _same_blob(tkv.blob_to_host(tkv.QuantKV(q=got.q.numpy(), s=got.s.numpy()) if quant
               else got.numpy()), jkv.blob_to_host(jstep.slice_block_pages(jpool, jnp.asarray(ids))))
    layers = np.array([1, 2], np.int32)
    chunk_t = tstep.gather_layer_pages(tpool, torch.from_numpy(layers), torch.from_numpy(ids))
    chunk_j = jpa.gather_layer_pages(jpool, jnp.asarray(layers), jnp.asarray(ids))
    host = lambda c: (tkv.QuantKV(q=c.q.numpy(), s=c.s.numpy())  # noqa: E731
                      if quant else c.numpy())
    _same_blob(host(chunk_t), jkv.blob_to_host(chunk_j))
    # scatter the chunk into other pages (pads to the trash page) in place
    dst = np.array([1, 9, 3, 0, 0], np.int32)
    pad = lambda c: tkv.pad_page_axis(c, 5)  # noqa: E731
    before = tpool.q if quant else tpool
    addr = before.data_ptr()
    tstep.scatter_layer_pages(tpool, torch.from_numpy(layers), torch.from_numpy(dst), pad(chunk_t))
    # the engine's form: a layer slice, one index_copy_ per pool tensor
    tstep.scatter_layer_pages(tpool, slice(1, 3), torch.from_numpy(dst), pad(chunk_t))
    jpool = jpa.scatter_layer_pages(
        jpool, jnp.asarray(layers), jnp.asarray(dst), jkv.pad_page_axis(chunk_j, 5))
    assert (tpool.q if quant else tpool).data_ptr() == addr, "the pool keeps its address"
    real = np.array([p for p in range(10) if p != 0])
    if quant:
        _same_blob(tkv.QuantKV(q=tpool.q.numpy()[:, :, real], s=tpool.s.numpy()[:, :, real]),
                   jkv.QuantKV(q=np.asarray(jpool.q)[:, :, real], s=np.asarray(jpool.s)[:, :, real]))
    else:
        _same_blob(tpool.numpy()[:, :, real], np.asarray(jpool)[:, :, real])
    tstep.scatter_block_pages(tpool, torch.tensor([4, 6, 8]), got)
    jpool = jstep.scatter_block_pages(jpool, jnp.asarray([4, 6, 8]),
                                      jstep.slice_block_pages(jpool, jnp.asarray(ids)))
    if quant:
        _same_blob(tpool.q.numpy()[:, :, real], np.asarray(jpool.q)[:, :, real])
        _same_blob(tpool.s.numpy()[:, :, real], np.asarray(jpool.s)[:, :, real])
    else:
        _same_blob(tpool.numpy()[:, :, real], np.asarray(jpool)[:, :, real])


def test_disk_files_cross_packages_bf16_too(tmp_path):
    """Files either package's DiskTier writes read back in the other with
    the same blob bytes and meta: f32, int8 pairs, and bf16 -- ml_dtypes
    arrays on the JAX side, their uint16 bits on the port's."""
    rs = np.random.default_rng(3)
    x = _dense(rs, (2, 2, 1, 4, 2, 8))
    xb = x.astype(ml_dtypes.bfloat16)
    q = jkv.quantize_kv_blob(x)
    cases = {
        "f32": (x, x, "float32"),
        "bf16": (xb, xb.view(np.uint16), "bfloat16"),
        "int8": (q, tkv.QuantKV(q=q.q, s=q.s), "int8"),
    }
    for name, (jblob, tblob, dt) in cases.items():
        meta = dict(block_hash=17, parent_sequence_hash=9, position=2, kv_dtype=dt)
        jd = joff.DiskTier(str(tmp_path / f"j-{name}"), 4)
        td = toff.DiskTier(str(tmp_path / f"t-{name}"), 4)
        jd.put(5, jblob, joff.BlockMeta(**meta))
        td.put(5, tblob, toff.BlockMeta(**meta))
        for src, off in ((jd, toff), (td, joff)):
            # the other package's DiskTier over a copy of this one's file
            dst = off.DiskTier(str(tmp_path / f"read-{name}-{off.__name__}"), 4)
            shutil.copy(src._path(5), dst._path(5))
            dst._lru[5] = None
            blob, m = dst.get(5)
            assert m.to_dict() == off.BlockMeta(**meta).to_dict()
            raw = lambda b: b.q if isinstance(b, (jkv.QuantKV, tkv.QuantKV)) else b  # noqa: E731
            if off is toff:
                if dt == "bfloat16":
                    assert raw(blob).dtype == np.uint16
                _same_blob(blob, tblob)
            else:
                # the JAX package reads a bf16 file (its own or the port's)
                # as |V2 bytes
                assert (raw(blob).dtype == np.dtype("V2")) == (dt == "bfloat16")
                _same_blob(blob, jblob)


# ---------------------------------------------------------------------------
# engines: the same weights and traffic through both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def request(tokens, max_tokens=4) -> dict:
    return {
        "token_ids": list(tokens),
        "stop_conditions": {"max_tokens": max_tokens},
        "sampling_options": {"temperature": 0.0},
        "eos_token_ids": [],
    }


async def collect(engine, req: dict):
    if isinstance(engine, JaxEngine):
        stream = await engine.generate(JaxContext.new(JaxRequest.from_dict(req)))
    else:
        stream = await engine.generate(Context.new(PreprocessedRequest.from_dict(req)))

    async def read():
        tokens = []
        async for item in stream:
            assert not item.is_error(), item.error_message()
            tokens += (item.data or {}).get("token_ids") or []
        return tokens

    return await asyncio.wait_for(read(), WAIT_S)


def make_engine(pkg, weights, **kw):
    jcfg, jparams, np_params = weights
    if pkg == "jax":
        return JaxEngine(jcfg, jparams, JaxEngineConfig(**kw), metrics_registry=JaxRegistry())
    cfg = ModelConfig.tiny()
    return TorchEngine(cfg, params_from_numpy(np_params, cfg, device="cpu"),
                       EngineConfig(**kw), device="cpu", metrics_registry=MetricsRegistry())


def hashes_of(tokens, block_size=4):
    return TokenBlockSequence(tokens, block_size=block_size).sequence_hashes()


def _a_pages(engine, hashes):
    """Host bytes of the pool pages registered under ``hashes`` (either
    package, either pool form)."""
    pool, kv = engine.sched.pool, engine.kv.pages
    out = {}
    for h in hashes:
        blk = pool._registered.get(h)
        if blk is None:
            continue
        ids = list(blk.pages)
        if isinstance(kv, (jkv.QuantKV, tkv.QuantKV)):
            out[h] = (np.asarray(kv.q)[:, :, ids].tobytes(), np.asarray(kv.s)[:, :, ids].tobytes())
        else:
            out[h] = np.asarray(kv)[:, :, ids].tobytes()
    return out


def _record_events(engine):
    events = {"kv": [], "holdings": []}
    engine.kv_event_sink = events["kv"].append
    engine.kv_holdings_sink = events["holdings"].append
    return events


async def _roundtrip(engine, disk: bool):
    """The JAX tests' round trips: A, churn until A's blocks are evicted,
    drain, (disk: promote A's chain), A again."""
    events = _record_events(engine)
    out = {"events": events}
    try:
        prompt_a = PROMPT_A[:8] if disk else PROMPT_A
        out["first"] = await collect(engine, request(prompt_a))
        a_hashes = hashes_of(prompt_a)
        # the blocks a re-run can onboard (prefill keeps one token)
        reusable = a_hashes[: (len(prompt_a) - 1) // 4]
        out["a_before"] = _a_pages(engine, reusable)
        pool = engine.sched.pool
        churn = []
        for i in range(16 if disk else 12):
            if disk:
                engine.offload_engine.drain()
                if len(engine.offload.parent) > 0:
                    break
                prompt = [(9 + i + j) % 30 for j in range(12)]
            else:
                if not any(pool.is_registered(h) for h in a_hashes):
                    break
                prompt = [(p + i) % 30 for p in PROMPT_B]
            churn.append(await collect(engine, request(prompt)))
        engine.offload_engine.drain()
        out["churn"] = churn
        out["offloaded"] = len(engine.offload)
        out["disk"] = len(engine.offload.parent) if disk else 0
        if disk:
            engine.offload_engine.prefetch(a_hashes)
            engine.offload_engine.drain()
        out["second"] = await collect(engine, request(prompt_a))
        out["a_after"] = _a_pages(engine, reusable)
        engine.offload_engine.drain()
        oe = engine.offload_engine
        out["tier_hits"] = dict(oe.tier_hits)
        out["offload_bytes"] = oe.offload_bytes
        out["onboard_bytes"] = oe.onboard_detail.get("prefix", [0])[0]
        out["used_pages"] = engine.kv.allocator.used_pages
    finally:
        await engine.stop()
    for _ in range(3):
        await asyncio.sleep(0)  # deliver the events hopped to the loop
    return out


async def _pressure(engine, max_tokens=24):
    try:
        outs = await asyncio.gather(*[collect(engine, request(p, max_tokens)) for p in PAIR])
        oe = engine.offload_engine
        return dict(
            streams=outs,
            preempt_swap=engine.sched.preempt_swap,
            preempt_recompute=engine.sched.preempt_recompute,
            swap_ins=oe.swap_ins if oe is not None else 0,
            swap_fallbacks=oe.swap_fallbacks if oe is not None else 0,
            swap_detail=list(oe.onboard_detail.get("swap", [0, 0])) if oe is not None else None,
            used_pages=engine.kv.allocator.used_pages,
            swap_used=oe._swap_used if oe is not None else 0,
        )
    finally:
        await engine.stop()


def _pressure_kw(swap: bool, num_pages: int, **kw):
    return dict(max_batch_size=2, max_seq_len=64, page_size=4, num_pages=num_pages,
                host_offload_blocks=32, swap_preemption=swap, async_dispatch=False, **kw)


@pytest.fixture(scope="module")
def served(weights, tmp_path_factory):
    """Every engine scenario, each package once."""
    out = {}
    for pkg in ("jax", "torch"):
        run = {}
        for name, kw in {
            "serial": dict(OFFLOAD, async_dispatch=False),
            "async": dict(OFFLOAD),
            "int8": dict(OFFLOAD, async_dispatch=False, kv_dtype="int8"),
        }.items():
            eng = make_engine(pkg, weights, **kw)
            run[name] = asyncio.run(asyncio.wait_for(_roundtrip(eng, disk=False), RUN_S))
        g3 = str(tmp_path_factory.mktemp(f"g3-{pkg}"))
        eng = make_engine(pkg, weights, **OFFLOAD | dict(
            host_offload_blocks=1, disk_offload_blocks=16, disk_offload_dir=g3,
            async_dispatch=False))
        run["disk"] = asyncio.run(asyncio.wait_for(_roundtrip(eng, disk=True), RUN_S))
        run["g3_dir"], run["g3_index"] = g3, list(eng.offload.parent._lru)
        for name, (swap, pages, extra) in {
            "roomy": (True, 41, {}),
            "swap": (True, 13, {}),
            "recompute": (False, 13, {}),
            "budget": (True, 13, {"swap_blocks": 0}),
            "host_blob": (True, 13, {"swap_device_blocks": 0}),
            "swap_async": (True, 13, {"async_dispatch": True}),
        }.items():
            cfg_kw = {k: extra.pop(k) for k in list(extra) if k == "async_dispatch"}
            eng = make_engine(pkg, weights, **(_pressure_kw(swap, pages) | cfg_kw))
            for attr, v in extra.items():
                setattr(eng.offload_engine, attr, v)
            run[name] = asyncio.run(asyncio.wait_for(_pressure(eng), RUN_S))
        out[pkg] = run
    return out


@pytest.mark.parametrize("loop", ["serial", "async", "int8"])
def test_offload_roundtrip_matches_jax(served, loop):
    t, j = served["torch"][loop], served["jax"][loop]
    assert t["first"] == t["second"] == j["first"] == j["second"]
    assert t["churn"] == j["churn"]
    assert t["offloaded"] > 0 and t["tier_hits"]["host"] > 0
    assert t["used_pages"] == 0
    if loop != "async":
        for key in ("offloaded", "tier_hits", "offload_bytes", "onboard_bytes"):
            assert t[key] == j[key], key


def test_disk_spill_roundtrip_matches_jax(served):
    t, j = served["torch"]["disk"], served["jax"]["disk"]
    assert t["first"] == t["second"] == j["first"] == j["second"]
    assert t["churn"] == j["churn"]
    assert t["disk"] > 0
    for key in ("offloaded", "disk", "tier_hits", "offload_bytes", "onboard_bytes"):
        assert t[key] == j[key], key


@pytest.mark.parametrize("loop", ["serial", "async"])
def test_kv_events_match_jax(served, loop):
    t, j = served["torch"][loop]["events"], served["jax"][loop]["events"]
    kinds = {e["type"] for e in t["kv"]}
    assert kinds == {"stored", "removed"}
    assert t["holdings"], "the offload plane reported no holdings"
    if loop == "serial":
        assert t["kv"] == j["kv"]
        assert t["holdings"] == j["holdings"]
    else:
        key = lambda e: repr(sorted(e.items()))  # noqa: E731
        assert sorted(map(key, t["kv"])) == sorted(map(key, j["kv"]))
        assert sorted(map(key, t["holdings"])) == sorted(map(key, j["holdings"]))


def test_swap_preemption_token_identical_to_jax(served):
    t, j = served["torch"], served["jax"]
    assert t["swap"]["preempt_swap"] >= 1
    assert t["recompute"]["preempt_recompute"] >= 1
    assert t["swap"]["streams"] == t["recompute"]["streams"] == t["roomy"]["streams"]
    assert t["swap"]["streams"] == j["swap"]["streams"]
    for key in ("preempt_swap", "preempt_recompute", "swap_ins"):
        assert t["swap"][key] == j["swap"][key], key
    assert t["recompute"]["preempt_recompute"] == j["recompute"]["preempt_recompute"]
    assert t["swap"]["used_pages"] == t["swap"]["swap_used"] == 0


def test_swap_under_the_pipelined_loop_matches_jax(served):
    """The pipelined loop under the same pressure: preemption may swap or
    recompute as its commits land, the streams do not move."""
    t, j = served["torch"]["swap_async"], served["jax"]["swap_async"]
    assert t["streams"] == served["torch"]["roomy"]["streams"] == j["streams"]
    assert t["preempt_swap"] + t["preempt_recompute"] >= 1
    assert t["used_pages"] == t["swap_used"] == 0


def test_swap_host_blob_path_token_identical(served):
    t, j = served["torch"]["host_blob"], served["jax"]["host_blob"]
    assert t["streams"] == served["torch"]["roomy"]["streams"] == j["streams"]
    assert t["preempt_swap"] >= 1 and t["swap_ins"] >= 1
    assert t["swap_detail"][0] > 0  # host-blob bytes moved
    assert t["swap_detail"][0] == j["swap_detail"][0]


def test_swap_budget_exhausted_falls_back_to_recompute(served):
    t, j = served["torch"]["budget"], served["jax"]["budget"]
    assert t["streams"] == served["torch"]["roomy"]["streams"] == j["streams"]
    assert t["preempt_swap"] == 0 and t["preempt_recompute"] >= 1
    assert t["swap_fallbacks"] >= 1
    assert (t["preempt_recompute"], t["swap_fallbacks"]) == (
        j["preempt_recompute"], j["swap_fallbacks"])
    assert t["used_pages"] == 0


@pytest.mark.parametrize("loop", ["serial", "int8", "disk"])
def test_onboarded_pages_are_byte_exact(served, loop):
    """Prompt A's evicted blocks come back bit for bit (an int8 pool's
    data and scales alike): the pages registered under A's hashes after
    the onboard hold the bytes they held before the eviction."""
    for pkg in ("torch", "jax"):
        run = served[pkg][loop]
        assert run["a_before"] and run["a_after"].keys() == run["a_before"].keys()
        assert run["a_after"] == run["a_before"], pkg


def test_g3_directory_crosses_engines(served, weights):
    """Each engine serves prompt A's prefix from the G3 directory the
    other package's engine wrote: the same streams; both DiskTiers read
    every file to the same blob and meta."""
    prompt_a = PROMPT_A[:8]
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        src = served[writer]
        eng = make_engine(reader, weights, **OFFLOAD | dict(
            host_offload_blocks=1, disk_offload_blocks=16,
            disk_offload_dir=src["g3_dir"], async_dispatch=False))
        disk = eng.offload.parent
        for h in src["g3_index"]:
            disk._lru[h] = None  # the other engine's files
        other = (toff if reader == "jax" else joff).DiskTier(src["g3_dir"], 16)
        for h in src["g3_index"]:
            other._lru[h] = None
            (b1, m1), (b2, m2) = disk.get(h), other.get(h)
            _same_blob(b1, b2)
            assert m1.to_dict() == m2.to_dict()

        async def body():
            try:
                hs = hashes_of(prompt_a)[: (len(prompt_a) - 1) // 4]
                assert all(h in disk for h in hs), "A's prefix is not in the writer's G3"
                eng.offload_engine.prefetch(hs)
                eng.offload_engine.drain()
                got = await collect(eng, request(prompt_a))
                return got, eng.offload_engine.tier_hits["host"]
            finally:
                await eng.stop()

        got, hits = asyncio.run(asyncio.wait_for(body(), RUN_S))
        assert got == src["disk"]["first"]
        assert hits > 0, f"{reader} onboarded nothing from {writer}'s G3"


# ---------------------------------------------------------------------------
# the port alone: prefetch pins, env arming, status
# ---------------------------------------------------------------------------


def _prefetch_engine(weights, tmp_path):
    return make_engine("torch", weights, max_batch_size=1, max_seq_len=64, page_size=4,
                       num_pages=17, host_offload_blocks=1, disk_offload_blocks=16,
                       disk_offload_dir=str(tmp_path / "g3"), async_dispatch=False)


@pytest.mark.parametrize("leave", ["admit", "cancel"])
def test_prefetch_pins_and_releases(weights, tmp_path, leave):
    """A queued request (the only slot busy) has its disk-resident chain
    promoted and pinned while it waits; its admission -- or its cancel --
    releases every pin."""

    async def body():
        eng = _prefetch_engine(weights, tmp_path)
        oe = eng.offload_engine
        try:
            prompt_a = PROMPT_A[:8]
            first = await collect(eng, request(prompt_a))
            h0 = hashes_of(prompt_a)[0]
            for i in range(16):
                oe.drain()
                if not eng.sched.pool.is_registered(h0) and oe.contains(h0):
                    break
                await collect(eng, request([(9 + i + j) % 30 for j in range(12)]))
            assert not eng.sched.pool.is_registered(h0) and oe.contains(h0)
            # the slot busy with a long request; A queues behind it
            blocker = asyncio.ensure_future(collect(eng, request([21, 22, 23, 24, 25], 40)))
            while not eng.sched.num_active:
                await asyncio.sleep(0.001)
            ctx = Context.new(PreprocessedRequest.from_dict(request(prompt_a)))
            stream = await eng.generate(ctx)
            loop = asyncio.get_running_loop()
            end = loop.time() + WAIT_S
            while not oe.host.pinned_blocks:
                assert loop.time() < end, "the queued chain was never pinned"
                await asyncio.sleep(0.001)
            assert oe.prefetch_issued > 0
            if leave == "cancel":
                ctx.ctx.stop_generating()
                async for _ in stream:
                    pass
                await asyncio.wait_for(blocker, WAIT_S)
                oe.drain()
                assert oe.prefetch_wasted_bytes > 0
            else:
                got = []
                async for item in stream:
                    got += (item.data or {}).get("token_ids") or []
                await asyncio.wait_for(blocker, WAIT_S)
                assert got == first
                assert oe.tier_hits["host"] > 0
            oe.drain()
            assert oe.host.pinned_blocks == 0 and not oe._prefetch_states
            assert not eng._prefetch_issued
            assert eng.kv.allocator.used_pages == 0
        finally:
            await eng.stop()

    asyncio.run(asyncio.wait_for(body(), 2 * WAIT_S))


def test_env_arms_and_malformed_env_warns(weights, monkeypatch, caplog, tmp_path):
    monkeypatch.setenv("DYN_KV_OFFLOAD", "host=8,swap=0")
    monkeypatch.setenv("DYN_KV_PREFETCH", "off")
    eng = make_engine("torch", weights, max_batch_size=2, max_seq_len=32, page_size=4,
                      num_pages=16)
    assert eng.offload_engine is not None and eng.offload_engine.host.capacity == 8
    assert eng.sched.swap_out is None and eng._prefetch_window == 0
    assert eng.status()["swapped"] == 0
    eng.offload_engine.close()
    monkeypatch.setenv("DYN_KV_OFFLOAD", "bogus=1")
    monkeypatch.setenv("DYN_KV_PREFETCH", "many")
    eng = make_engine("torch", weights, max_batch_size=2, max_seq_len=32, page_size=4,
                      num_pages=16, kv_prefetch_window=5)
    assert eng.offload_engine is None and eng._prefetch_window == 5
    assert "DYN_KV_OFFLOAD" in caplog.text and "DYN_KV_PREFETCH" in caplog.text
    monkeypatch.delenv("DYN_KV_OFFLOAD")
    monkeypatch.delenv("DYN_KV_PREFETCH")
    eng = make_engine("torch", weights, max_batch_size=2, max_seq_len=32, page_size=4,
                      num_pages=16)
    assert eng.offload_engine is None and eng.sched.swap_out is None
    assert eng.kv.allocator.on_evict is None
    with pytest.raises(ValueError, match="disk_offload_dir"):
        make_engine("torch", weights, num_pages=16, disk_offload_blocks=4)
