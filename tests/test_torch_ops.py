"""The port's attention ops against the JAX package's: paged decode, packed
and rectangle ragged attention, full and prefix-suffix flash prefill.

Each plain PyTorch version (the CPU side of a hand-written CUDA kernel in
``dynamo_tpu_torch/ops``) is held against the JAX Pallas kernel run with
``interpret=True`` and against the JAX package's XLA reference, on the
same inputs made with numpy from a seed.

Tolerances: in f32 the three compute the same sums in other orders, so they
agree to 1e-5.  In bf16 every side rounds its output to bf16 once (and the
XLA reference also scores in bf16), so they agree to about two bf16 ulps of
values of order one: 2e-2.

Only rows somebody reads are compared: the XLA reference averages over
fully masked rows, and the packed Pallas kernel lets a lane's ``s_max``
window spill past its ``q_len`` into pad rows, where the port writes zeros.

Every kernel (and the int8 branches of the ragged ones) is also held there
at the head geometries the CUDA kernels take beyond the module's 4/2/32:
GQA groups 1, 3, 7 and 8 and head dims 96 and 256 (``GEOMETRIES``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import attention as jatt
from dynamo_tpu.engine import kv_cache as jkv
from dynamo_tpu.ops.flash_prefill import (
    flash_prefill_attention as pallas_flash,
    flash_prefix_prefill_attention as pallas_flash_prefix,
)
from dynamo_tpu.ops.paged_attention import paged_decode_attention_v2
from dynamo_tpu.ops.ragged_attention import (
    packed_ragged_attention as pallas_packed,
    packed_ragged_attention_xla,
    ragged_paged_attention as pallas_rect,
    ragged_paged_attention_xla,
)
from dynamo_tpu_torch.engine import attention as tatt
from dynamo_tpu_torch.engine.bucketing import packed_axis_len, pow2_bucket
from dynamo_tpu_torch.ops.flash_prefill import (
    flash_prefill_attention,
    flash_prefix_prefill_attention,
)
from dynamo_tpu_torch.ops.paged_attention import (
    MAX_SPLITS,
    MIN_SPLIT_POSITIONS,
    decode_split,
    paged_decode_attention,
)
from dynamo_tpu_torch.ops.ragged_attention import (
    packed_ragged_attention,
    ragged_paged_attention,
)

L, N, PAGE, P = 2, 40, 8, 8  # layers, pool pages, page size, table width
HQ, HKV, D = 4, 2, 32  # GQA n_rep = 2
LAYER = 1
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (Hq, Hkv, D) beyond the module's: the GQA groups of Llama-2 and Gemma-7B
# (1), Llama-3.2-3B (3), Qwen2-7B (7) and Llama-3-70B (8), Phi-3's head dim
# (96) and Gemma's (256), at small head counts
GEOMETRIES = {
    "group1": (2, 2, 64),
    "group3": (6, 2, 64),
    "group7": (7, 1, 64),
    "group8": (8, 1, 64),
    "d96": (4, 2, 96),
    "d256": (2, 1, 256),
}


def _np(dtype: str, a: np.ndarray) -> np.ndarray:
    return a.astype(np.float32 if dtype == "float32" else ml_dtypes.bfloat16)


# a process's memory mappings past which the module fixture below frees the
# compiled JAX programs: Linux refuses more than vm.max_map_count (65530 by
# default), and one module's cases add up to some 12000
FREE_PROGRAMS_AT_MAPPINGS = 30000


def _mappings() -> int:
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:  # no /proc: not Linux, so not its limit
        return 0


@pytest.fixture(autouse=True, scope="module")
def _free_compiled_programs():
    """Free the JAX programs compiled so far when the module starts or ends
    with more than FREE_PROGRAMS_AT_MAPPINGS memory mappings.  Each compiled
    program holds mappings of its own, and a test process that keeps every
    program of its share of the suite reaches the kernel's limit, past
    which the next compile crashes the process.  The test modules that
    compile many programs import this fixture."""

    def free() -> None:
        if _mappings() > FREE_PROGRAMS_AT_MAPPINGS:
            jax.clear_caches()

    free()
    yield
    free()


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _pool_and_table(rs, dtype: str, B: int, hkv: int = HKV, d: int = D):
    pool = _np(dtype, rs.standard_normal((L, 2, N, PAGE, hkv, d)))
    table = np.stack(
        [rs.permutation(N - 1)[:P] + 1 for _ in range(B)]
    ).astype(np.int32)
    return pool, table


def _check_paged_decode(dtype, window, geom=(HQ, HKV, D)):
    """Full-table lane, partial lanes, a one-token lane and an idle lane."""
    hq, hkv, d = geom
    rs = np.random.default_rng(7)
    kv_lens = np.array([P * PAGE, 23, 1, 0], np.int32)
    B = len(kv_lens)
    pool, table = _pool_and_table(rs, dtype, B, hkv, d)
    q = _np(dtype, rs.standard_normal((B, hq, d)))

    got = _f32(
        paged_decode_attention(
            _torch(q), _torch(pool), torch.from_numpy(table),
            torch.from_numpy(kv_lens), LAYER, window,
        )
    )
    # group=8: the JAX engine's setting (engine/attention.py:137)
    pallas = _f32(
        paged_decode_attention_v2(
            jnp.asarray(q), jnp.asarray(pool), jnp.asarray(table),
            jnp.asarray(kv_lens), LAYER, window, 8, interpret=True,
        )
    )
    xla = _f32(
        jatt.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(pool)[LAYER], jnp.asarray(table),
            jnp.asarray(kv_lens), window,
        )
    )
    tol = TOL[dtype]
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=0)
    live = kv_lens > 0
    np.testing.assert_allclose(got[live], xla[live], atol=tol, rtol=0)
    assert not got[~live].any(), "an idle lane gives zeros"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 10])
def test_paged_decode_matches_pallas_and_xla(dtype, window):
    _check_paged_decode(dtype, window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_paged_decode_geometry_matches_pallas_and_xla(geometry, dtype):
    _check_paged_decode(dtype, 10, GEOMETRIES[geometry])


def _packed_case(rs, dtype: str, geom=(HQ, HKV, D)):
    """A decode lane, a prefill chunk from position 0, a prefix-hit lane
    (base > 0 with several rows) and an idle lane, packed by the engine's
    rule (segments in slot order, s_max = pow2, off + s_max <= Np)."""
    hq, hkv, d = geom
    base = np.array([37, 0, 16, 0], np.int32)
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
    pool, table = _pool_and_table(rs, dtype, B, hkv, d)
    q = _np(dtype, rs.standard_normal((Np, hq, d)))
    k = _np(dtype, rs.standard_normal((Np, hkv, d)))
    v = _np(dtype, rs.standard_normal((Np, hkv, d)))
    return dict(
        q=q, k=k, v=v, pool=pool, table=table, base=base, seg_off=seg_off,
        q_lens=q_lens, lane=lane, rel=rel, s_max=s_max,
    )


def _jax_int8(pool: np.ndarray):
    """The int8 pool the JAX rule makes of a dense one: (data, scales)."""
    q, s = jkv.quantize_kv_rows(jnp.asarray(pool.astype(np.float32)))
    return np.array(q), np.array(s)


def _check_packed_ragged(dtype, window, geom=(HQ, HKV, D), int8=False):
    c = _packed_case(np.random.default_rng(11), dtype, geom)
    scales = None
    if int8:  # the int8 pool of the case's dense pool, by the JAX rule
        c["pool"], scales = _jax_int8(c["pool"])
    got = _f32(
        packed_ragged_attention(
            _torch(c["q"]), _torch(c["k"]), _torch(c["v"]), _torch(c["pool"]),
            torch.from_numpy(c["table"]), torch.from_numpy(c["base"]),
            torch.from_numpy(c["seg_off"]), torch.from_numpy(c["q_lens"]),
            c["s_max"], LAYER, window,
            kv_scales=None if scales is None else torch.from_numpy(scales),
        )
    )
    j = {k: jnp.asarray(v) for k, v in c.items() if isinstance(v, np.ndarray)}
    js = None if scales is None else jnp.asarray(scales)
    # group=4: the JAX engine's setting (engine/attention.py:233)
    pallas = _f32(
        pallas_packed(
            j["q"], j["k"], j["v"], j["pool"], j["table"], j["base"],
            j["seg_off"], j["q_lens"], c["s_max"], LAYER, window, 4,
            interpret=True, kv_scales=js,
        )
    )
    xla = _f32(
        packed_ragged_attention_xla(
            j["q"], j["k"], j["v"],
            j["pool"] if js is None else jkv.QuantKV(j["pool"], js),
            j["table"], j["base"], j["seg_off"], j["q_lens"], j["lane"], j["rel"],
            c["s_max"], LAYER, window,
        )
    )
    tol = TOL[dtype]
    valid = c["lane"] < len(c["base"])
    np.testing.assert_allclose(got[valid], pallas[valid], atol=tol, rtol=0)
    np.testing.assert_allclose(got[valid], xla[valid], atol=tol, rtol=0)
    assert not got[~valid].any(), "pad rows give zeros"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 5])
def test_packed_ragged_matches_pallas_and_xla(dtype, window):
    _check_packed_ragged(dtype, window)


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_packed_ragged_geometry_matches_pallas_and_xla(geometry, dtype, int8):
    _check_packed_ragged(dtype, 5, GEOMETRIES[geometry], int8)


def test_packed_ragged_clips_table_and_layer():
    """Out-of-range page ids and layer clip like the Pallas kernel's
    (ragged_attention.py:560-561) instead of raising."""
    c = _packed_case(np.random.default_rng(3), "float32")
    bad = c["table"].copy()
    bad[1, 0] = N + 5  # clips to the last page
    fixed = c["table"].copy()
    fixed[1, 0] = N - 1
    args = [
        _torch(c["q"]), _torch(c["k"]), _torch(c["v"]), _torch(c["pool"]),
    ]
    lanes = [torch.from_numpy(c[n]) for n in ("base", "seg_off", "q_lens")]
    got = packed_ragged_attention(
        *args, torch.from_numpy(bad), *lanes, c["s_max"], L + 3
    )
    want = packed_ragged_attention(
        *args, torch.from_numpy(fixed), *lanes, c["s_max"], L - 1
    )
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrappers_refuse_bad_int8_scales_and_unknown_devices():
    c = _packed_case(np.random.default_rng(5), "float32")
    t = {n: torch.from_numpy(v.copy()) for n, v in c.items() if isinstance(v, np.ndarray)}
    pool8 = t["pool"].to(torch.int8)
    good = torch.ones(pool8.shape[:4])
    for pool, scales in (
        (pool8, good.double()),  # scales of another dtype
        (pool8, good[:, :, :-1]),  # scales of another shape
        (t["pool"], good),  # data that is not int8
    ):
        with pytest.raises(ValueError):
            packed_ragged_attention(
                t["q"], t["k"], t["v"], pool, t["table"], t["base"],
                t["seg_off"], t["q_lens"], c["s_max"], 0, 0, kv_scales=scales,
            )
    with pytest.raises(ValueError):
        ragged_paged_attention(
            t["q"][None], t["k"][None], t["v"][None], pool8, t["table"][:1],
            t["base"][:1], t["q_lens"][:1], kv_scales=good.half(),
        )
    meta = torch.empty((2, HQ, D), device="meta")
    with pytest.raises(ValueError):
        paged_decode_attention(
            meta, t["pool"].to("meta"), t["table"][:2].to("meta"),
            torch.ones(2, dtype=torch.int32, device="meta"),
        )


@pytest.mark.parametrize("page", [4, 8, 16])
@pytest.mark.parametrize("lane_heads", [1, 8, 16, 64, 264, 1024])
def test_decode_split_fills_the_card_in_few_splits(page, lane_heads):
    """The bf16 decode kernel's splits, for every table width the engine
    uses (powers of two from 8 pages) and a few others, on a card of 264
    resident CTAs (an H100): each covers a multiple of 64 positions, no
    fewer than MIN_SPLIT_POSITIONS, together they reach every position of
    the table and no split lies wholly past it; there are at most
    MAX_SPLITS, and no more than fill the card when every lane is as long
    as the table -- exactly that many where the table splits evenly into
    them."""
    slots = 264
    want = max(1, min(MAX_SPLITS, slots // lane_heads))
    for width in [1, 3, 8, 16, 100, 128, 512, 1024, 4096, 8192, 65536]:
        reach = width * page
        chunk, splits = decode_split(width, page, lane_heads, slots)
        assert chunk % 64 == 0 and chunk >= MIN_SPLIT_POSITIONS
        assert (splits - 1) * chunk < reach <= splits * chunk
        assert 1 <= splits <= want
        if reach % (want * 64) == 0 and reach >= want * MIN_SPLIT_POSITIONS:
            assert splits == want
    # Llama-3-8B's 8 KV heads at 8 lanes, and at 2, over a 2048-position table
    assert decode_split(128, 16, 64, slots) == (512, 4)
    assert decode_split(128, 16, 16, slots) == (128, 16)


def _rows_below(lens, T: int) -> np.ndarray:
    """[B, T] mask of the rows somebody reads: those below each lane's length."""
    return np.arange(T)[None, :] < np.asarray(lens)[:, None]


def _check_flash_prefill(dtype, window, geom=(HQ, HKV, D)):
    """A full bucket, a lane shorter than T, a one-token lane, a pad lane."""
    hq, hkv, d = geom
    rs = np.random.default_rng(13)
    seq_lens = np.array([32, 19, 1, 0], np.int32)
    B, T = len(seq_lens), 32
    q = _np(dtype, rs.standard_normal((B, T, hq, d)))
    k = _np(dtype, rs.standard_normal((B, T, hkv, d)))
    v = _np(dtype, rs.standard_normal((B, T, hkv, d)))
    got = _f32(
        flash_prefill_attention(
            _torch(q), _torch(k), _torch(v), torch.from_numpy(seq_lens), window
        )
    )
    jq, jk, jv, jl = (jnp.asarray(x) for x in (q, k, v, seq_lens))
    pallas = _f32(
        pallas_flash(jq, jk, jv, jl, window, block_q=8, block_k=16, interpret=True)
    )
    xla = _f32(jatt.prefill_attention(jq, jk, jv, jl, window))
    read = _rows_below(seq_lens, T)
    tol = TOL[dtype]
    np.testing.assert_allclose(got[read], pallas[read], atol=tol, rtol=0)
    np.testing.assert_allclose(got[read], xla[read], atol=tol, rtol=0)
    assert not got[~read].any(), "rows past seq_len give zeros"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 6])
def test_flash_prefill_matches_pallas_and_xla(dtype, window):
    _check_flash_prefill(dtype, window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_flash_prefill_geometry_matches_pallas_and_xla(geometry, dtype):
    _check_flash_prefill(dtype, 6, GEOMETRIES[geometry])


def _prefix_case(rs, dtype: str, geom=(HQ, HKV, D)):
    """Suffix lanes over a gathered prefix: a partial-page prefix (13
    tokens), a whole-table one, an empty one and a pad lane; Pp = 4 pages
    of 8, so Kp = 32 tiles the Pallas kernel's BK = gcd(T, 8)."""
    hq, hkv, d = geom
    offsets = np.array([13, 32, 0, 8], np.int32)
    slens = np.array([16, 5, 11, 0], np.int32)
    B, T, Pp = len(offsets), 16, 4
    pool = _np(dtype, rs.standard_normal((L, 2, N, PAGE, hkv, d)))
    pt = np.stack([rs.permutation(N - 1)[:Pp] + 1 for _ in range(B)]).astype(np.int32)
    q = _np(dtype, rs.standard_normal((B, T, hq, d)))
    k = _np(dtype, rs.standard_normal((B, T, hkv, d)))
    v = _np(dtype, rs.standard_normal((B, T, hkv, d)))
    return dict(pool=pool, pt=pt, q=q, k=k, v=v, offsets=offsets, slens=slens, T=T)


def _check_flash_prefix_prefill(dtype, window, geom=(HQ, HKV, D)):
    c = _prefix_case(np.random.default_rng(17), dtype, geom)
    t = {n: _torch(c[n]) for n in ("pool", "q", "k", "v")}
    got = _f32(
        tatt.prefill_prefix_attention_dispatch(
            t["q"], t["k"], t["v"], t["pool"], LAYER, torch.from_numpy(c["pt"]),
            torch.from_numpy(c["offsets"]), torch.from_numpy(c["slens"]), window,
        )
    )
    j = {n: jnp.asarray(c[n]) for n in ("pool", "pt", "q", "k", "v", "offsets", "slens")}
    B, T = c["q"].shape[:2]
    pre = lambda side: j["pool"][LAYER, side][j["pt"]].reshape(  # noqa: E731
        B, -1, *c["pool"].shape[-2:]
    )
    pallas = _f32(
        pallas_flash_prefix(
            j["q"], jnp.concatenate([pre(0), j["k"]], 1),
            jnp.concatenate([pre(1), j["v"]], 1), j["offsets"], j["slens"],
            window, block_q=8, block_k=8, interpret=True,
        )
    )
    xla = _f32(
        jatt.prefill_prefix_attention(
            j["q"], j["k"], j["v"], j["pool"], LAYER, j["pt"], j["offsets"],
            j["slens"], window,
        )
    )
    read = _rows_below(c["slens"], T)
    tol = TOL[dtype]
    np.testing.assert_allclose(got[read], pallas[read], atol=tol, rtol=0)
    np.testing.assert_allclose(got[read], xla[read], atol=tol, rtol=0)
    assert not got[~read].any(), "rows past suffix_len give zeros"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 9])
def test_flash_prefix_prefill_matches_pallas_and_xla(dtype, window):
    _check_flash_prefix_prefill(dtype, window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_flash_prefix_prefill_geometry_matches_pallas_and_xla(geometry, dtype):
    _check_flash_prefix_prefill(dtype, 9, GEOMETRIES[geometry])


def test_flash_prefix_takes_any_prefix_span():
    """The Pallas kernel needs Kp to be a multiple of its key tile; the
    port's takes any span: a 5-token gathered prefix gives what the same
    prefix padded to a page gives."""
    rs = np.random.default_rng(19)
    B, T, Kp = 2, 8, 5
    q = torch.from_numpy(rs.standard_normal((B, T, HQ, D)).astype(np.float32))
    kc = torch.from_numpy(rs.standard_normal((B, Kp + T, HKV, D)).astype(np.float32))
    vc = torch.from_numpy(rs.standard_normal((B, Kp + T, HKV, D)).astype(np.float32))
    off = torch.tensor([5, 3], dtype=torch.int32)
    lens = torch.tensor([8, 6], dtype=torch.int32)
    got = flash_prefix_prefill_attention(q, kc, vc, off, lens, 4)

    def pad(x):
        z = torch.zeros((B, 3, HKV, D))
        return torch.cat([x[:, :Kp], z, x[:, Kp:]], dim=1)

    want = flash_prefix_prefill_attention(q, pad(kc), pad(vc), off, lens, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _rect_case(rs, dtype: str, geom=(HQ, HKV, D)):
    """The [B, S] rectangle: a decode lane, a chunk from position 0, a
    prefix-hit chunk over a partial page and an idle lane."""
    hq, hkv, d = geom
    base = np.array([37, 0, 13, 0], np.int32)
    q_lens = np.array([1, 8, 5, 0], np.int32)
    B, S = len(base), 8
    pool, table = _pool_and_table(rs, dtype, B, hkv, d)
    q = _np(dtype, rs.standard_normal((B, S, hq, d)))
    k = _np(dtype, rs.standard_normal((B, S, hkv, d)))
    v = _np(dtype, rs.standard_normal((B, S, hkv, d)))
    return dict(q=q, k=k, v=v, pool=pool, table=table, base=base, q_lens=q_lens)


def _rect_torch(c, table=None, layer=LAYER, window=0, scales=None):
    t = {n: _torch(c[n]) for n in ("q", "k", "v", "pool")}
    return ragged_paged_attention(
        t["q"], t["k"], t["v"], t["pool"],
        torch.from_numpy(c["table"] if table is None else table),
        torch.from_numpy(c["base"]), torch.from_numpy(c["q_lens"]), layer, window,
        kv_scales=None if scales is None else torch.from_numpy(scales),
    )


def _check_rectangle_ragged(dtype, window, geom=(HQ, HKV, D), int8=False):
    c = _rect_case(np.random.default_rng(23), dtype, geom)
    scales = None
    if int8:  # the int8 pool of the case's dense pool, by the JAX rule
        c["pool"], scales = _jax_int8(c["pool"])
    got = _f32(_rect_torch(c, window=window, scales=scales))
    j = {n: jnp.asarray(x) for n, x in c.items()}
    js = None if scales is None else jnp.asarray(scales)
    pool = j["pool"] if js is None else jkv.QuantKV(j["pool"], js)
    lanes = (j["table"], j["base"], j["q_lens"])
    # group=4: the JAX engine's setting (engine/attention.py:191)
    pallas = _f32(
        pallas_rect(
            j["q"], j["k"], j["v"], j["pool"], *lanes, LAYER, window, 4,
            interpret=True, kv_scales=js,
        )
    )
    xla = _f32(ragged_paged_attention_xla(j["q"], j["k"], j["v"], pool, *lanes, LAYER, window))
    read = _rows_below(c["q_lens"], c["q"].shape[1])
    tol = TOL[dtype]
    np.testing.assert_allclose(got[read], pallas[read], atol=tol, rtol=0)
    np.testing.assert_allclose(got[read], xla[read], atol=tol, rtol=0)
    assert not got[~read].any(), "rows past q_len give zeros"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 5])
def test_rectangle_ragged_matches_pallas_and_xla(dtype, window):
    _check_rectangle_ragged(dtype, window)


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_rectangle_ragged_geometry_matches_pallas_and_xla(geometry, dtype, int8):
    _check_rectangle_ragged(dtype, 5, GEOMETRIES[geometry], int8)


def test_rectangle_ragged_clips_table_and_layer():
    """Out-of-range page ids and layer clip like the Pallas kernel's
    (ragged_attention.py:234-235) instead of raising."""
    c = _rect_case(np.random.default_rng(29), "float32")
    bad = c["table"].copy()
    bad[0, 1] = N + 7  # clips to the last page
    fixed = c["table"].copy()
    fixed[0, 1] = N - 1
    got = _rect_torch(c, bad, L + 2)
    want = _rect_torch(c, fixed, L - 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    j = {n: jnp.asarray(x) for n, x in c.items()}
    pallas = _f32(
        pallas_rect(
            j["q"], j["k"], j["v"], j["pool"], jnp.asarray(bad), j["base"],
            j["q_lens"], L + 2, 0, 4, interpret=True,
        )
    )
    read = _rows_below(c["q_lens"], c["q"].shape[1])
    np.testing.assert_allclose(_f32(got)[read], pallas[read], atol=1e-5, rtol=0)
