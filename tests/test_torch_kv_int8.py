"""The port's int8 KV pool (``EngineConfig.kv_dtype="int8"``) against the
JAX package's ``QuantKV`` pool.

* **The rule and the helpers**: ``quantize_kv_rows`` gives the JAX rule's
  int8 bytes and f32 scales bit for bit; ``parse_kv_dtype`` and the pool's
  byte accounting equal the JAX package's.
* **Kernel parity**: the plain versions of the packed and rectangle ragged
  kernels with ``kv_scales`` against the Pallas kernels in interpret mode
  and the XLA references over the same pool; the gathered decode route
  against the JAX package's XLA ``paged_decode_attention``.
* **Writers**: every KV writer quantizes on write to the JAX writers' bytes
  and scales.
* **Engine**: ``TorchEngine(device="cpu")`` with ``kv_dtype="int8"`` gives
  the ``JaxEngine``'s greedy streams and logprobs under the default,
  rectangle, classic (chunked) and penalized configs, and its own dense
  streams; one ``prefill_and_sample`` leaves the JAX pool's contents.

Tolerances: f32 attention outputs 2e-5 (sums in other orders), bf16 2e-2
(each side rounds its output to bf16 once; the XLA references also score
in bf16); logprobs 1e-3.  Inputs are made with numpy from a seed.
"""

from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import attention as jatt
from dynamo_tpu.engine import kv_cache as jkv
from dynamo_tpu.engine import step as jstep
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.engine.sampling import SamplingParams as JaxSampling
from dynamo_tpu.ops.ragged_attention import (
    packed_ragged_attention as pallas_packed,
    packed_ragged_attention_xla,
    ragged_paged_attention as pallas_rect,
    ragged_paged_attention_xla,
)
from dynamo_tpu.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import attention as tatt
from dynamo_tpu_torch.engine import kv_cache as tkv
from dynamo_tpu_torch.engine import step as tstep
from dynamo_tpu_torch.engine.bucketing import packed_axis_len, pow2_bucket
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.ops.ragged_attention import (
    packed_ragged_attention,
    ragged_paged_attention,
)
from dynamo_tpu_torch.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_ops import _free_compiled_programs  # noqa: F401 (autouse)

L, N, PAGE, P = 2, 40, 8, 8  # layers, pool pages, page size, table width
HQ, HKV, D = 4, 2, 32  # GQA n_rep = 2
LAYER = 1
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
WAIT_S = 60  # bound on any one served batch
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run
LP_TOL, LP_TOL_PENALIZED = 1e-3, 2e-3  # see ENGINE below


def _np(dtype: str, a: np.ndarray) -> np.ndarray:
    return a.astype(np.float32 if dtype == "float32" else ml_dtypes.bfloat16)


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _rows(rs, n: int, dtype: str) -> np.ndarray:
    """``n`` rows of ``[HKV, D]`` with magnitudes from 0.01 to 50 and one
    all-zero row."""
    mag = np.logspace(-2, np.log10(50), n)[:, None, None]
    x = rs.standard_normal((n, HKV, D)) * mag
    x[n // 2] = 0.0
    return _np(dtype, x)


def _quant_pool(rs, shape=(L, 2, N, PAGE, HKV, D)):
    """An int8 pool made by the JAX rule from a random dense pool, with
    some rows never written (data and scale 0, as a fresh pool's)."""
    dense = rs.standard_normal(shape).astype(np.float32)
    q, s = (np.asarray(x) for x in jkv.quantize_kv_rows(jnp.asarray(dense)))
    q, s = q.copy(), s.copy()
    q[:, :, 2] = 0
    s[:, :, 2] = 0.0
    return q, s


# ---------------------------------------------------------------------------
# the rule and the helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_is_the_jax_rule_bit_for_bit(dtype):
    x = _rows(np.random.default_rng(0), 513, dtype)
    jq, js = (np.asarray(a) for a in jkv.quantize_kv_rows(jnp.asarray(x)))
    tq, ts = tkv.quantize_kv_rows(_torch(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), js.view(np.uint32))
    assert ts[256].item() == 1.0 and not tq[256].any(), "an all-zero row"


def test_parse_kv_dtype_and_pool_choice():
    for spec in (None, "", "auto", "int8", "bf16", "f32", "FP16", " float32 "):
        assert tkv.parse_kv_dtype(spec) == jkv.parse_kv_dtype(spec)
    for bad in ("int4", "fp8"):
        for parse in (tkv.parse_kv_dtype, jkv.parse_kv_dtype):
            with pytest.raises(ValueError):
                parse(bad)
    assert tkv.pool_is_quantized("int8", "bfloat16")
    assert not tkv.pool_is_quantized(None, "bfloat16")
    assert not tkv.pool_is_quantized("bf16", "bfloat16")
    with pytest.raises(ValueError):
        tkv.pool_is_quantized("float32", "bfloat16")
    with pytest.raises(ValueError, match="not served"):
        TorchEngine.random_init(
            ModelConfig.tiny(), EngineConfig(num_pages=8, kv_dtype="bf16"), device="cpu"
        )


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_pool_bytes_match_jax_and_the_tensors(kv_dtype):
    cfg = ModelConfig.tiny()
    jcfg = JaxModelConfig.tiny()
    pool = tkv.PagedKVCache(
        cfg, 32, 4, torch.float32, torch.device("cpu"), quantized=kv_dtype == "int8"
    )
    ref = jkv.PagedKVCache(jcfg, num_pages=32, page_size=4, dtype=kv_dtype)
    assert pool.bytes_per_page == ref.bytes_per_page
    assert pool.pool_bytes == ref.pool_bytes == pool.bytes_per_page * 32
    assert pool.pool_bytes == pool.pages.nbytes
    if kv_dtype == "int8":
        assert pool.pages.q.dtype == torch.int8 and pool.pages.s.shape == (2, 2, 32, 4)
        assert not pool.pages.q.any() and not pool.pages.s.any()


# ---------------------------------------------------------------------------
# kernel parity over the int8 pool
# ---------------------------------------------------------------------------


def _packed_case(rs, dtype: str):
    """A decode lane, a chunk from position 0, a prefix-hit chunk over a
    partial page (base 13), an idle lane; packed by the engine's rule."""
    base = np.array([37, 0, 13, 0], np.int32)
    q_lens = np.array([1, 12, 7, 0], np.int32)
    B = len(base)
    seg_off = np.zeros(B, np.int32)
    off = off_last = 0
    for b in range(B):
        if q_lens[b]:
            seg_off[b] = off_last = off
            off += int(q_lens[b])
    s_max = pow2_bucket(int(q_lens.max()))
    Np = packed_axis_len(s_max, off_last, off)
    lane = np.full(Np, B, np.int32)
    rel = np.zeros(Np, np.int32)
    for b in range(B):
        o, n = int(seg_off[b]), int(q_lens[b])
        lane[o : o + n] = b
        rel[o : o + n] = np.arange(n)
    pq, ps = _quant_pool(rs)
    table = np.stack([rs.permutation(N - 1)[:P] + 1 for _ in range(B)]).astype(np.int32)
    table[0, 1] = 2  # a page of never-written rows inside a live prefix
    q, k, v = (_np(dtype, rs.standard_normal((Np, h, D))) for h in (HQ, HKV, HKV))
    return dict(
        q=q, k=k, v=v, pq=pq, ps=ps, table=table, base=base, seg_off=seg_off,
        q_lens=q_lens, lane=lane, rel=rel, s_max=s_max,
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 5])
def test_packed_ragged_int8_matches_pallas_and_xla(dtype, window):
    c = _packed_case(np.random.default_rng(11), dtype)
    got = _f32(
        packed_ragged_attention(
            _torch(c["q"]), _torch(c["k"]), _torch(c["v"]), _torch(c["pq"]),
            torch.from_numpy(c["table"]), torch.from_numpy(c["base"]),
            torch.from_numpy(c["seg_off"]), torch.from_numpy(c["q_lens"]),
            c["s_max"], LAYER, window, kv_scales=_torch(c["ps"]),
        )
    )
    j = {n: jnp.asarray(x) for n, x in c.items() if isinstance(x, np.ndarray)}
    args = (j["q"], j["k"], j["v"])
    lanes = (j["table"], j["base"], j["seg_off"], j["q_lens"])
    pallas = _f32(
        pallas_packed(
            *args, j["pq"], *lanes, c["s_max"], LAYER, window, 4,
            interpret=True, kv_scales=j["ps"],
        )
    )
    xla = _f32(
        packed_ragged_attention_xla(
            *args, jkv.QuantKV(j["pq"], j["ps"]), *lanes, j["lane"], j["rel"],
            c["s_max"], LAYER, window,
        )
    )
    valid = c["lane"] < len(c["base"])
    tol = TOL[dtype]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[valid], pallas[valid], atol=tol, rtol=0)
    np.testing.assert_allclose(got[valid], xla[valid], atol=tol, rtol=0)
    assert not got[~valid].any(), "pad rows give zeros"


def _rect_case(rs, dtype: str):
    base = np.array([37, 0, 13, 0], np.int32)
    q_lens = np.array([1, 8, 5, 0], np.int32)
    B, S = len(base), 8
    pq, ps = _quant_pool(rs)
    table = np.stack([rs.permutation(N - 1)[:P] + 1 for _ in range(B)]).astype(np.int32)
    q, k, v = (_np(dtype, rs.standard_normal((B, S, h, D))) for h in (HQ, HKV, HKV))
    return dict(q=q, k=k, v=v, pq=pq, ps=ps, table=table, base=base, q_lens=q_lens)


def _rect_torch(c, table, layer, window):
    t = {n: _torch(c[n]) for n in ("q", "k", "v", "pq", "ps")}
    return ragged_paged_attention(
        t["q"], t["k"], t["v"], t["pq"], torch.from_numpy(table),
        torch.from_numpy(c["base"]), torch.from_numpy(c["q_lens"]), layer, window,
        kv_scales=t["ps"],
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 5])
def test_rectangle_ragged_int8_matches_pallas_and_xla(dtype, window):
    c = _rect_case(np.random.default_rng(23), dtype)
    got = _f32(_rect_torch(c, c["table"], LAYER, window))
    j = {n: jnp.asarray(x) for n, x in c.items()}
    args = (j["q"], j["k"], j["v"])
    lanes = (j["table"], j["base"], j["q_lens"])
    pallas = _f32(
        pallas_rect(
            *args, j["pq"], *lanes, LAYER, window, 4, interpret=True, kv_scales=j["ps"]
        )
    )
    xla = _f32(
        ragged_paged_attention_xla(
            *args, jkv.QuantKV(j["pq"], j["ps"]), *lanes, LAYER, window
        )
    )
    read = np.arange(c["q"].shape[1])[None, :] < c["q_lens"][:, None]
    tol = TOL[dtype]
    np.testing.assert_allclose(got[read], pallas[read], atol=tol, rtol=0)
    np.testing.assert_allclose(got[read], xla[read], atol=tol, rtol=0)
    assert not got[~read].any(), "rows past q_len give zeros"


def test_int8_ragged_clips_table_and_layer():
    """Out-of-range page ids and layer clip like the Pallas kernel's
    (ragged_attention.py:234-235), scales included."""
    c = _rect_case(np.random.default_rng(29), "float32")
    bad = c["table"].copy()
    bad[0, 1] = N + 7
    fixed = c["table"].copy()
    fixed[0, 1] = N - 1
    got = _rect_torch(c, bad, L + 2, 0)
    torch.testing.assert_close(got, _rect_torch(c, fixed, L - 1, 0), rtol=0, atol=0)
    j = {n: jnp.asarray(x) for n, x in c.items()}
    pallas = _f32(
        pallas_rect(
            j["q"], j["k"], j["v"], j["pq"], jnp.asarray(bad), j["base"],
            j["q_lens"], L + 2, 0, 4, interpret=True, kv_scales=j["ps"],
        )
    )
    read = np.arange(c["q"].shape[1])[None, :] < c["q_lens"][:, None]
    np.testing.assert_allclose(_f32(got)[read], pallas[read], atol=2e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 10])
def test_gathered_decode_matches_jax_composition(dtype, window):
    """Full-table lane, partial lanes over never-written rows, a one-token
    lane and a lane whose only key is a fresh pool's zero row."""
    rs = np.random.default_rng(7)
    kv_lens = np.array([P * PAGE, 23, 1, 1], np.int32)
    B = len(kv_lens)
    pq, ps = _quant_pool(rs)
    table = np.stack([rs.permutation(N - 1)[:P] + 1 for _ in range(B)]).astype(np.int32)
    table[3, 0] = 2
    q = _np(dtype, rs.standard_normal((B, HQ, D)))
    before = tatt.gathered_decode_calls
    got = _f32(
        tatt.decode_attention_dispatch(
            _torch(q), tkv.QuantKV(_torch(pq), _torch(ps)), torch.from_numpy(table),
            torch.from_numpy(kv_lens), LAYER, window,
        )
    )
    assert tatt.gathered_decode_calls == before + 1
    jpool = jkv.QuantKV(jnp.asarray(pq[LAYER]), jnp.asarray(ps[LAYER]))
    want = _f32(
        jatt.paged_decode_attention(
            jnp.asarray(q), jpool, jnp.asarray(table), jnp.asarray(kv_lens), window
        )
    )
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)
    assert not got[3].any(), "a zero row attends to zeros"


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------


def _pools(rs):
    pq, ps = _quant_pool(rs)
    return tkv.QuantKV(_torch(pq), _torch(ps)), jkv.QuantKV(jnp.asarray(pq), jnp.asarray(ps))


def _same_pool(tpool: tkv.QuantKV, jpool) -> None:
    """Bytes and scales equal on every page but trash page 0 (duplicate
    writes land there in no fixed order)."""
    np.testing.assert_array_equal(tpool.q.numpy()[:, :, 1:], np.asarray(jpool.q)[:, :, 1:])
    np.testing.assert_array_equal(
        tpool.s.numpy()[:, :, 1:].view(np.uint32),
        np.asarray(jpool.s)[:, :, 1:].view(np.uint32),
    )


def test_writers_quantize_like_jax():
    rs = np.random.default_rng(31)
    B, T = 3, 2 * PAGE
    table = np.stack([rs.permutation(N - 1)[:P] + 1 for _ in range(B)]).astype(np.int32)
    k, v = (rs.standard_normal((B, T, HKV, D)).astype(np.float32) for _ in range(2))

    # whole pages of a prompt
    tp, jp = _pools(rs)
    tatt.write_prefill_kv(tp, _torch(k), _torch(v), torch.from_numpy(table), LAYER)
    jp = jatt.write_prefill_kv(jp, jnp.asarray(k), jnp.asarray(v), jnp.asarray(table), LAYER)
    _same_pool(tp, jp)

    # one row per lane; a lane at its table's capacity goes to page 0
    pos = np.array([5, 17, P * PAGE], np.int32)
    tp, jp = _pools(rs)
    tatt.write_decode_kv(
        tp, _torch(k[:, 0]), _torch(v[:, 0]), torch.from_numpy(table),
        torch.from_numpy(pos).long(), LAYER,
    )
    jp = jatt.write_decode_kv(
        jp, jnp.asarray(k[:, 0]), jnp.asarray(v[:, 0]), jnp.asarray(table),
        jnp.asarray(pos), LAYER,
    )
    _same_pool(tp, jp)

    # rectangle columns past n_tokens go to page 0
    base = np.array([3, 0, 60], np.int32)
    n_tok = np.array([T, 5, T], np.int32)
    tp, jp = _pools(rs)
    tatt.write_spec_kv(
        tp, _torch(k), _torch(v), torch.from_numpy(table),
        torch.from_numpy(base).long(), torch.from_numpy(n_tok).long(), LAYER,
    )
    jp = jatt.write_spec_kv(
        jp, jnp.asarray(k), jnp.asarray(v), jnp.asarray(table), jnp.asarray(base),
        jnp.asarray(n_tok), LAYER,
    )
    _same_pool(tp, jp)

    # packed rows with pad rows (lane B) and a dead row
    Np = 12
    lane = np.array([0, 0, 0, 1, 2, 2, 2, 2, 3, 3, 3, 3], np.int32)
    pos = np.array([9, 10, 11, 4, 30, 31, 32, 33, 0, 0, 0, 0], np.int32)
    valid = lane < B
    valid[3] = False
    kp, vp = k.reshape(-1, HKV, D)[:Np], v.reshape(-1, HKV, D)[:Np]
    tp, jp = _pools(rs)
    tatt.write_packed_kv(
        tp, _torch(kp), _torch(vp), torch.from_numpy(table),
        torch.from_numpy(lane).long(), torch.from_numpy(pos).long(),
        torch.from_numpy(valid), LAYER,
    )
    jp = jatt.write_packed_kv(
        jp, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table), jnp.asarray(lane),
        jnp.asarray(pos), jnp.asarray(valid), LAYER,
    )
    _same_pool(tp, jp)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# multistep_max_k=1: the two engines then plan the same ticks.  The JAX
# engine keeps one more single-step tick after a final prefill chunk (its
# pending first-token inject), and under an int8 pool a decode row attends
# to its own K/V exactly in a unified step but quantized in a fused
# multistep or decode-block step, which moves a logprob by up to ~2e-3
# though no token changes.  The port's fused multistep runs in the default
# config against its own tokens.  In the penalized config the same extra
# tick shifts when classic decode blocks take over, so its logprobs agree
# to LP_TOL_PENALIZED (1.2e-3 seen), its tokens exactly.
ENGINE = dict(
    max_batch_size=4, max_seq_len=96, page_size=4, num_pages=64,
    mixed_token_budget=16, multistep_max_k=1,
)
SHARED = [(7 * i + 3) % 250 + 1 for i in range(12)]  # three whole pages
# the configs held against the JAX engine, and whether their batch carries
# the two penalized lanes
CONFIGS = {
    "default": ({}, False),
    "rectangle": (dict(packed_ragged=False), False),
    "classic": (dict(mixed_batching=False, prefill_chunk_tokens=8), False),
    "penalized": ({}, True),
}


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def request(tokens, max_tokens=8, **sampling) -> dict:
    return {
        "token_ids": list(tokens),
        "stop_conditions": {"max_tokens": max_tokens},
        "sampling_options": {"temperature": 0.0, "logprobs": 1, **sampling},
        "eos_token_ids": [],
    }


def mixed_batch(penalized: bool):
    """A prompt longer than the mixed budget (chunked), two sharing a
    prefix and short prompts; with ``penalized``, two penalized lanes."""
    rs = np.random.default_rng(4)
    toks = lambda n: rs.integers(1, 256, n).tolist()  # noqa: E731
    reqs = [
        request(toks(37), 10),
        request(SHARED + toks(3), 10),
        request(SHARED + toks(5), 10),
        request([5, 9, 2, 7], 12),
        request(toks(6), 14),
    ]
    if penalized:
        reqs += [
            request(toks(9), 10, frequency_penalty=0.7),
            request(toks(14), 10, repetition_penalty=1.3),
        ]
    return reqs


async def collect(engine, req: dict):
    if isinstance(engine, JaxEngine):
        stream = await engine.generate(JaxContext.new(JaxRequest.from_dict(req)))
    else:
        stream = await engine.generate(Context.new(PreprocessedRequest.from_dict(req)))
    tokens, logprobs = [], []
    async for item in stream:
        assert not item.is_error(), item.error_message()
        data = item.data or {}
        tokens += data.get("token_ids") or []
        logprobs += data.get("logprobs") or []
    return tokens, logprobs


async def serve(engine, reqs):
    """``reqs[1]`` alone first, so the pool holds its prefix, then the rest
    at once (``reqs[2]`` hits the prefix).  Every request arrives at a
    tick boundary, so both engines plan the same ticks: under an int8
    pool the logprobs depend on the schedule at the 1e-3 level (a decode
    row attends to its own K/V exactly in a unified step, quantized in a
    fused multistep or decode-block step)."""
    try:
        primer = await asyncio.wait_for(collect(engine, reqs[1]), WAIT_S)
        rest = await asyncio.wait_for(
            asyncio.gather(*[collect(engine, r) for r in reqs[:1] + reqs[2:]]), WAIT_S
        )
        return [rest[0], primer] + rest[1:]
    finally:
        await engine.stop()


def torch_engine(np_params, **kw) -> TorchEngine:
    cfg = ModelConfig.tiny()
    params = params_from_numpy(np_params, cfg, device="cpu")
    return TorchEngine(cfg, params, EngineConfig(**{**ENGINE, **kw}), device="cpu")


@pytest.fixture(scope="module")
def served(weights):
    """Each config's int8 streams from both engines and the port's dense
    streams, served once per module."""
    jcfg, jparams, np_params = weights
    out = {}
    for name, (kw, penalized) in CONFIGS.items():
        reqs = mixed_batch(penalized)
        eng = torch_engine(np_params, kv_dtype="int8", **kw)
        port = asyncio.run(asyncio.wait_for(serve(eng, reqs), RUN_S))
        jeng = JaxEngine(
            jcfg, jparams,
            JaxEngineConfig(**ENGINE, kv_dtype="int8", async_dispatch=False, **kw),
        )
        ref = asyncio.run(asyncio.wait_for(serve(jeng, reqs), RUN_S))
        dense = asyncio.run(asyncio.wait_for(serve(torch_engine(np_params, **kw), reqs), RUN_S))
        out[name] = dict(port=port, ref=ref, dense=dense, engine=eng)
    fused = torch_engine(np_params, kv_dtype="int8", multistep_max_k=8)
    out["default"].update(fused=asyncio.run(
        asyncio.wait_for(serve(fused, mixed_batch(False)), RUN_S)
    ), k=fused)
    return out


@pytest.mark.parametrize("config", list(CONFIGS))
def test_int8_engine_streams_match_jax(served, config):
    got = served[config]
    port, ref, eng = got["port"], got["ref"], got["engine"]
    assert eng.kv.quantized
    assert [t for t, _ in port] == [t for t, _ in ref]
    assert [len(t) for t, _ in port[:5]] == [10, 10, 10, 12, 14]
    tol = LP_TOL_PENALIZED if config == "penalized" else LP_TOL
    for (_, lp), (_, want) in zip(port, ref):
        np.testing.assert_allclose(lp, want, atol=tol, rtol=0)
    assert eng.kv.allocator.used_pages == 0
    assert eng.metrics().gpu_prefix_cache_hit_rate > 0, "no prefix hit"
    # the int8 pool gives the dense pool's greedy streams on this model
    assert [t for t, _ in port] == [t for t, _ in got["dense"]]
    kinds = eng.dispatches
    if config == "classic":
        assert kinds.get("chunk") and kinds.get("prefill") and "unified" not in kinds
    elif config == "penalized":
        assert kinds.get("decode_block") and kinds.get("prefill")
    else:
        assert kinds.get("unified")
    if config == "default":
        # fused multistep decode (the gathered int8 route) gives the tokens
        assert [t for t, _ in got["fused"]] == [t for t, _ in port]
        assert any(k > 1 for k in got["k"].dispatches_by_k), got["k"].dispatches_by_k


def test_prefill_leaves_the_jax_pool(weights):
    """One ``prefill_and_sample`` in each package over a fresh int8 pool,
    compared on the rows of each lane's first ``seq_len`` positions (rows
    past it hold garbage by design on both sides): scales within 2e-6
    relative (a scale is its row's amax / 127, so it carries the two
    trunks' f32 differences, up to ~10 ulp here), int8 bytes equal or one
    apart (such a difference may cross a rounding boundary), and every
    dequantized value within one step of its row's scale."""
    jcfg, jparams, np_params = weights
    cfg = ModelConfig.tiny()
    tparams = params_from_numpy(np_params, cfg, device="cpu")
    rs = np.random.default_rng(3)
    seq_lens = np.array([16, 9, 1, 0], np.int32)
    B, T, page, n = len(seq_lens), 16, 4, 24
    tokens = rs.integers(1, cfg.vocab_size, (B, T)).astype(np.int32)
    table = (1 + np.arange(B * T // page)).reshape(B, T // page).astype(np.int32)
    table[3] = 0  # the pad lane writes the trash page
    jpool = jkv.PagedKVCache(jcfg, num_pages=n, page_size=page, dtype="int8").pages
    _, jpool = jstep.prefill_and_sample(
        jparams, jcfg, jpool, jnp.asarray(tokens), jnp.asarray(seq_lens),
        jnp.asarray(table), jax.random.PRNGKey(0), JaxSampling.fill(B), 0, False,
    )
    tpool = tkv.PagedKVCache(
        cfg, n, page, torch.float32, torch.device("cpu"), quantized=True
    ).pages
    ts = SamplingParams(
        temperature=torch.zeros(B), top_p=torch.ones(B),
        top_k=torch.zeros(B, dtype=torch.long), key=torch.zeros(B, dtype=torch.long),
        seeded=torch.zeros(B, dtype=torch.bool),
    )
    with torch.inference_mode():
        tstep.prefill_and_sample(
            tparams, cfg, tpool, torch.from_numpy(tokens).long(),
            torch.from_numpy(seq_lens).long(), torch.from_numpy(table), ts,
        )
    # whole pages of the three live lanes were written, pad rows included
    assert (tpool.s.numpy()[:, :, 1:13] > 0).all()
    assert not tpool.s.numpy()[:, :, 13:].any()
    rows = [(table[b, p // page], p % page) for b in range(B) for p in range(seq_lens[b])]
    ids, slots = (np.array(x) for x in zip(*rows))
    jq, jsc = np.asarray(jpool.q)[:, :, ids, slots], np.asarray(jpool.s)[:, :, ids, slots]
    tq, tsc = tpool.q.numpy()[:, :, ids, slots], tpool.s.numpy()[:, :, ids, slots]
    np.testing.assert_allclose(tsc, jsc, rtol=2e-6, atol=0)
    assert np.abs(tq.astype(np.int32) - jq.astype(np.int32)).max() <= 1
    deq = lambda q, s: q.astype(np.float32) * s[..., None, None]  # noqa: E731
    assert (np.abs(deq(tq, tsc) - deq(jq, jsc)) <= 1.0001 * jsc[..., None, None]).all()
