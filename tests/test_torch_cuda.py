"""The port's hand-written CUDA kernels against their plain versions, on the
card: paged decode, packed and rectangle ragged (the dense pool's entries
and the int8 pool's), full and prefix-suffix flash prefill.  Every
instantiation the wrappers can launch (f32 and bf16, head dims 64 and 128,
GQA groups 2 and 4: those of the port's configs), with and without a
sliding window, at small shapes; paged decode also over a 2048-position
table across the bf16 kernel's splits and on a table wide enough to grow
them; the flash kernels also at lengths around their 64-row tiles and at
the serve shape of kernel 2 in ``chip_smoke.py``, the ragged kernels (both
layouts, both pools) at their tile and page edges.
The dense entries of the ragged and flash kernels also give, bit for bit,
the outputs recorded in ``DENSE_DIGESTS``.

These tests need an NVIDIA card and ``nvcc``, so they carry the ``cuda``
marker and skip elsewhere.  They import no JAX (the card's machine has
none); run them there without the JAX-loading conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: in f32 the kernel and the plain version differ by the order of
their sums and by the kernel's fast exponential (``__expf``, a few ulp),
5e-5 on outputs of order one; in bf16 each side rounds its output once,
2e-2 (two bf16 ulps of values of order one).  The bf16 decode, flash and
ragged kernels also round P to bf16 for its product with V (as the Pallas kernels
do; the plain versions keep P in f32): a relative error of at most 2^-9 on
each term's weight, some 2e-3 on an output built from a few keys of |v| up
to ~4, inside the same 2e-2.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine.kv_cache import quantize_kv_rows
from dynamo_tpu_torch.ops import flash_prefill as fp
from dynamo_tpu_torch.ops import paged_attention as pa
from dynamo_tpu_torch.ops import ragged_attention as ra

pytestmark = pytest.mark.cuda

L, N, PAGE, P = 2, 48, 8, 8  # layers, pool pages, page size, table width
HKV = 2
TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
GEOMETRY = [(d, r) for d in (64, 128) for r in (2, 4)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels build with nvcc and run there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _setup(card, dtype, D, B, seed):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    rs = np.random.default_rng(seed)
    pool = torch.randn((L, 2, N, PAGE, HKV, D), generator=gen, device=card).to(dtype)
    table = np.stack([rs.permutation(N - 1)[:P] + 1 for _ in range(B)])
    return gen, pool, torch.from_numpy(table.astype(np.int32)).to(card)


def _decode_case(card, dtype, D, n_rep, kv_lens, page, width, seed):
    """Paged decode operands: each lane's pages distinct pool pages of a
    ``width``-page table of ``page``-row pages (page 0 stays trash)."""
    B = len(kv_lens)
    n_pages = min(B * width, 4096) + 1
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    rs = np.random.default_rng(seed)
    pool = torch.randn((L, 2, n_pages, page, HKV, D), generator=gen, device=card).to(dtype)
    table = np.stack([rs.choice(n_pages - 1, width, replace=width > n_pages - 1) + 1
                      for _ in range(B)])
    q = torch.randn((B, HKV * n_rep, D), generator=gen, device=card).to(dtype)
    lens = torch.tensor(kv_lens, dtype=torch.int32, device=card)
    return q, pool, torch.from_numpy(table.astype(np.int32)).to(card), lens


# (kv_lens, page, table width, window): the small table, within one split
# of the bf16 kernel; and a 128-page table of page 16, which that kernel
# splits at multiples of 128 positions (16 splits on an H100), with lanes
# ending on a split boundary, one past it and one short of it, a one-token
# lane and an idle lane, and a window whose floor straddles the boundaries
DECODE_CASES = {
    "small": ([P * PAGE, 23, 1, 0, 40], PAGE, P, 7),
    "splits": ([2048, 1791, 512, 257, 256, 255, 1, 0], 16, 128, 300),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,n_rep", GEOMETRY)
def test_paged_decode_kernel_matches_plain(card, D, n_rep, dtype, windowed, case):
    kv_lens, page, width, window = DECODE_CASES[case]
    window = window if windowed else 0
    q, pool, table, lens = _decode_case(card, dtype, D, n_rep, kv_lens, page, width, 1)
    if case == "splits":
        chunk, splits = pa.decode_split(width, page, 8 * HKV, pa.resident_ctas(card))
        assert chunk == 128 and splits > 8
    before = pa.KERNEL.launches
    got = pa.paged_decode_attention(q, pool, table, lens, 1, window)
    torch.cuda.synchronize()
    assert pa.KERNEL.launches == before + 1
    want = pa.paged_decode_attention_plain(q, pool, table, lens, 1, window)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)
    assert not got[kv_lens.index(0)].any(), "an idle lane gives zeros"


@pytest.mark.parametrize("window", [0, 3000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_on_a_wide_table(card, dtype, window):
    # 1024 pages of 16 at 4 lanes: MAX_SPLITS splits, each grown to 512
    # positions on an H100
    kv_lens = [16384, 9001, 513, 0]
    q, pool, table, lens = _decode_case(card, dtype, 128, 4, kv_lens, 16, 1024, 3)
    chunk, splits = pa.decode_split(1024, 16, 4 * HKV, pa.resident_ctas(card))
    assert chunk > 128 and splits == pa.MAX_SPLITS
    got = pa.paged_decode_attention(q, pool, table, lens, 0, window)
    want = pa.paged_decode_attention_plain(q, pool, table, lens, 0, window)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)
    assert not got[3].any(), "an idle lane gives zeros"


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,n_rep", GEOMETRY)
def test_packed_ragged_kernel_matches_plain(card, D, n_rep, dtype, window):
    # a decode lane, a chunk from position 0 spanning several query tiles,
    # a prefix-hit chunk, an idle lane; packed by the engine's rule
    base = [37, 0, 16, 0]
    q_lens = [1, 40, 7, 0]
    B = len(base)
    offs, off = [], 0
    for n in q_lens:
        offs.append(off if n else 0)
        off += n
    s_max = 64
    Np = 128  # >= every live lane's off + s_max
    gen, pool, table = _setup(card, dtype, D, B, 2)

    def rand(h):
        return torch.randn((Np, h, D), generator=gen, device=card).to(dtype)

    q, k, v = rand(HKV * n_rep), rand(HKV), rand(HKV)
    lanes = [torch.tensor(x, dtype=torch.int32, device=card) for x in (base, offs, q_lens)]
    got = ra.packed_ragged_attention(q, k, v, pool, table, *lanes, s_max, 1, window)
    torch.cuda.synchronize()
    want = ra.packed_ragged_attention_plain(q, k, v, pool, table, *lanes, 1, window)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)
    assert not got[off:].any(), "pad rows give zeros"


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,n_rep", GEOMETRY)
def test_rectangle_ragged_kernel_matches_plain(card, D, n_rep, dtype, window):
    # a decode lane, a chunk from position 0 spanning several query tiles,
    # a prefix-hit chunk, an idle lane with a resident prefix; S = 64
    base = [37, 0, 16, 20]
    q_lens = [1, 40, 7, 0]
    B, S = len(base), 64
    gen, pool, table = _setup(card, dtype, D, B, 4)

    def rand(h):
        return torch.randn((B, S, h, D), generator=gen, device=card).to(dtype)

    q, k, v = rand(HKV * n_rep), rand(HKV), rand(HKV)
    lanes = [torch.tensor(x, dtype=torch.int32, device=card) for x in (base, q_lens)]
    before = ra.RECT_KERNEL.launches
    got = ra.ragged_paged_attention(q, k, v, pool, table, *lanes, 1, window)
    torch.cuda.synchronize()
    assert ra.RECT_KERNEL.launches == before + 1
    want = ra.ragged_paged_attention_plain(q, k, v, pool, table, *lanes, 1, window)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)
    for b, n in enumerate(q_lens):
        assert not got[b, n:].any(), "rows past q_len give zeros"


def _dirty_cache(like: torch.Tensor) -> None:
    """Hand the caching allocator a freed block of ``like``'s size full of
    NaNs, so that the wrapper's uninitialised output is not a fresh zeroed
    block and the zero-row checks test the kernel's own writes."""
    dirty = torch.full_like(like, float("nan"))
    del dirty


# (lens, T): rows on both sides of the 64-row query tiles and 64-key tiles
FLASH_CASES = {
    "small": ([96, 45, 1, 0], 96),  # full bucket, short lane, one token, pad lane
    "tile-edges": ([63, 64, 65, 130, 0], 130),  # around the tiles; an idle lane
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("window", [0, 7, 70])  # 7 and 70 cut inside a key tile
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,n_rep", GEOMETRY)
def test_flash_prefill_kernel_matches_plain(card, D, n_rep, dtype, window, case):
    seq_lens, T = FLASH_CASES[case]
    B = len(seq_lens)
    gen = torch.Generator(device=card)
    gen.manual_seed(5)

    def rand(h):
        return torch.randn((B, T, h, D), generator=gen, device=card).to(dtype)

    q, k, v = rand(HKV * n_rep), rand(HKV), rand(HKV)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device=card)
    before = fp.KERNEL.launches
    _dirty_cache(q)
    got = fp.flash_prefill_attention(q, k, v, lens, window)
    torch.cuda.synchronize()
    assert fp.KERNEL.launches == before + 1
    want = fp.flash_prefill_attention_plain(q, k, v, lens, window)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)
    for b, n in enumerate(seq_lens):
        assert not got[b, n:].any(), "rows past seq_len give zeros"


def test_flash_prefill_kernel_at_the_serve_shape(card):
    # kernel 2's check in chip_smoke.py: one 1200-token lane of the 2048
    # bucket at Llama-3-8B heads, bf16
    T, n, Hq, Hkv, D = 2048, 1200, 32, 8, 128
    gen = torch.Generator(device=card)
    gen.manual_seed(11)

    def rand(h):
        return torch.randn((1, T, h, D), generator=gen, device=card).to(torch.bfloat16)

    q, k, v = rand(Hq), rand(Hkv), rand(Hkv)
    lens = torch.tensor([n], dtype=torch.int32, device=card)
    before = fp.KERNEL.launches
    _dirty_cache(q)
    got = fp.flash_prefill_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert fp.KERNEL.launches == before + 1
    want = fp.flash_prefill_attention_plain(q, k, v, lens)
    torch.testing.assert_close(
        got.float(), want.float(), atol=TOL[torch.bfloat16], rtol=0
    )
    assert not got[0, n:].any(), "rows past seq_len give zeros"


# (offset, suffix lens, T, Kp)
PREFIX_CASES = {
    # Kp = 37: a partial-page prefix, a full one, an empty one, a pad lane
    "small": ([21, 37, 0, 8], [40, 3, 19, 0], 48, 37),
    # Kp = 100, no multiple of the 64-key tile: offsets below, at and past
    # it, suffixes around the 64-row tiles, an idle lane
    "tile-edges": ([70, 100, 0, 130, 30], [65, 63, 130, 64, 0], 130, 100),
}


@pytest.mark.parametrize("case", sorted(PREFIX_CASES))
@pytest.mark.parametrize("window", [0, 7, 70])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,n_rep", GEOMETRY)
def test_flash_prefix_prefill_kernel_matches_plain(card, D, n_rep, dtype, window, case):
    offset, suffix, T, Kp = PREFIX_CASES[case]
    B = len(offset)
    gen = torch.Generator(device=card)
    gen.manual_seed(6)

    def rand(n, h):
        return torch.randn((B, n, h, D), generator=gen, device=card).to(dtype)

    q, k, v = rand(T, HKV * n_rep), rand(Kp + T, HKV), rand(Kp + T, HKV)
    off = torch.tensor(offset, dtype=torch.int32, device=card)
    lens = torch.tensor(suffix, dtype=torch.int32, device=card)
    before = fp.PREFIX_KERNEL.launches
    _dirty_cache(q)
    got = fp.flash_prefix_prefill_attention(q, k, v, off, lens, window)
    torch.cuda.synchronize()
    assert fp.PREFIX_KERNEL.launches == before + 1
    want = fp.flash_prefix_prefill_attention_plain(q, k, v, off, lens, window)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)
    for b, n in enumerate(suffix):
        assert not got[b, n:].any(), "rows past suffix_len give zeros"


def test_wrappers_refuse_mixed_devices_and_layouts(card):
    gen, pool, table = _setup(card, torch.bfloat16, 128, 2, 3)
    q = torch.randn((2, 8, 128), generator=gen, device=card).to(torch.bfloat16)
    lens = torch.tensor([5, 9], dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, pool, table.cpu(), lens)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, pool, table.long(), lens)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q.transpose(0, 1).contiguous().transpose(0, 1), pool, table, lens)
    q8 = torch.randn((2, 8 * HKV, 128), generator=gen, device=card).to(torch.bfloat16)
    with pytest.raises(ValueError):  # GQA group 8: no config of the port has it
        pa.paged_decode_attention(q8, pool, table, lens)


def test_new_wrappers_refuse_what_their_kernels_do_not_take(card):
    gen = torch.Generator(device=card)
    gen.manual_seed(7)
    q = torch.randn((2, 32, 8, 128), generator=gen, device=card).to(torch.bfloat16)
    k = torch.randn((2, 32, HKV, 128), generator=gen, device=card).to(torch.bfloat16)
    lens = torch.tensor([5, 9], dtype=torch.int32, device=card)
    with pytest.raises(ValueError):  # lengths on the host
        fp.flash_prefill_attention(q, k, k, lens.cpu())
    with pytest.raises(ValueError):  # K/V of another dtype
        fp.flash_prefill_attention(q, k.float(), k.float(), lens)
    with pytest.raises(ValueError):  # a suffix longer than the keys
        fp.flash_prefix_prefill_attention(q, k[:, :16], k[:, :16], lens, lens)
    _, pool, table = _setup(card, torch.bfloat16, 128, 2, 8)
    with pytest.raises(ValueError):  # a pool of another dtype than q
        ra.ragged_paged_attention(q, k, k, pool.float(), table, lens, lens)
    with pytest.raises(ValueError):  # scales beside a pool that is not int8
        ra.ragged_paged_attention(q, k, k, pool, table, lens, lens, kv_scales=lens)


def _int8_pool(pool):
    """The int8 pool of a dense one (the port's rule) with page 2 never
    written: its rows carry data and scale 0, as a fresh pool's."""
    q, s = quantize_kv_rows(pool)
    q[:, :, 2] = 0
    s[:, :, 2] = 0.0
    return q.contiguous(), s.contiguous()


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,n_rep", GEOMETRY)
def test_packed_ragged_int8_kernel_matches_plain(card, D, n_rep, dtype, window):
    base = [37, 0, 16, 0]
    q_lens = [1, 40, 7, 0]
    B = len(base)
    offs, off = [], 0
    for n in q_lens:
        offs.append(off if n else 0)
        off += n
    s_max, Np = 64, 128
    gen, pool, table = _setup(card, dtype, D, B, 12)
    table[0, 1] = 2  # never-written rows inside a live prefix
    pq, ps = _int8_pool(pool)

    def rand(h):
        return torch.randn((Np, h, D), generator=gen, device=card).to(dtype)

    q, k, v = rand(HKV * n_rep), rand(HKV), rand(HKV)
    lanes = [torch.tensor(x, dtype=torch.int32, device=card) for x in (base, offs, q_lens)]
    dense_before = ra.KERNEL.launches
    before = ra.INT8_KERNEL.launches
    got = ra.packed_ragged_attention(q, k, v, pq, table, *lanes, s_max, 1, window, ps)
    torch.cuda.synchronize()
    assert ra.INT8_KERNEL.launches == before + 1
    assert ra.KERNEL.launches == dense_before
    want = ra.packed_ragged_attention_plain(q, k, v, pq, table, *lanes, 1, window, ps)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)
    assert not got[off:].any(), "pad rows give zeros"


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,n_rep", GEOMETRY)
def test_rectangle_ragged_int8_kernel_matches_plain(card, D, n_rep, dtype, window):
    base = [37, 0, 16, 20]
    q_lens = [1, 40, 7, 0]
    B, S = len(base), 64
    gen, pool, table = _setup(card, dtype, D, B, 14)
    pq, ps = _int8_pool(pool)

    def rand(h):
        return torch.randn((B, S, h, D), generator=gen, device=card).to(dtype)

    q, k, v = rand(HKV * n_rep), rand(HKV), rand(HKV)
    lanes = [torch.tensor(x, dtype=torch.int32, device=card) for x in (base, q_lens)]
    before = ra.RECT_INT8_KERNEL.launches
    got = ra.ragged_paged_attention(q, k, v, pq, table, *lanes, 1, window, ps)
    torch.cuda.synchronize()
    assert ra.RECT_INT8_KERNEL.launches == before + 1
    want = ra.ragged_paged_attention_plain(q, k, v, pq, table, *lanes, 1, window, ps)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)
    for b, n in enumerate(q_lens):
        assert not got[b, n:].any(), "rows past q_len give zeros"


def _edge_lanes(n_rep):
    """Lanes at the tile and page edges of the ragged kernels: chunk lengths
    around a CTA's 64 / n_rep query rows and around a 64-key tile, a length
    that leaves 5 rows in the last CTA (at group 2 a causal CTA on the
    key-split path), bases that are multiples of neither 64 nor the page,
    base 0, a lane whose prefix reaches past its table (reach = P * PAGE <
    base), a decode lane, an idle lane.  Returns (base, q_lens)."""
    tq = 64 // n_rep
    base = [37, 0, 13, 0, 3, 91, 70, 29, 100, 5]
    q_lens = [tq - 1, tq, tq + 1, 63, 64, 65, 20, 37, 1, 0]
    return base, q_lens


def _edge_operands(card, dtype, D, n_rep, quant, layout, seed):
    """The pool (rows of magnitudes 10^-3 to 1, so that int8 scales
    differ by orders of magnitude between rows; page 2 never written in the
    int8 pool), a table with one id past the pool (clamped), the lanes of
    ``_edge_lanes`` and fresh rows in ``layout`` ("packed" or "rect")."""
    base, q_lens = _edge_lanes(n_rep)
    B = len(base)
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    rs = np.random.default_rng(seed)
    mag = torch.logspace(-3, 0, N * PAGE, device=card).view(1, 1, N, PAGE, 1, 1)
    pool = (torch.randn((L, 2, N, PAGE, HKV, D), generator=gen, device=card) * mag).to(dtype)
    table = np.stack([rs.permutation(N - 1)[:P] + 1 for _ in range(B)]).astype(np.int32)
    table[2, 1] = N + 3  # clamped to the pool's last page
    table = torch.from_numpy(table).to(card)
    scales = None
    if quant:
        pool, scales = _int8_pool(pool)
        table[0, 2] = 2
    i32 = dict(dtype=torch.int32, device=card)
    if layout == "packed":
        offs, off = [], 0
        for n in q_lens:
            offs.append(off if n else 0)
            off += n
        s_max = 128
        Np = off + s_max
        shape = (Np,)
        lanes = (torch.tensor(base, **i32), torch.tensor(offs, **i32), torch.tensor(q_lens, **i32))
    else:
        S = 72
        shape = (B, S)
        lanes = (torch.tensor(base, **i32), torch.tensor(q_lens, **i32))

    def rand(h):
        return torch.randn((*shape, h, D), generator=gen, device=card).to(dtype)

    q, k, v = rand(HKV * n_rep), rand(HKV), rand(HKV)
    return q, k, v, pool, scales, table, lanes, q_lens


@pytest.mark.parametrize("window", [0, 7, 70, 512])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("layout", ["packed", "rect"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,n_rep", GEOMETRY)
def test_ragged_kernels_at_tile_and_page_edges(card, D, n_rep, dtype, layout, quant, window):
    q, k, v, pool, scales, table, lanes, q_lens = _edge_operands(
        card, dtype, D, n_rep, quant, layout, 20
    )
    if layout == "packed":
        kernel = ra.INT8_KERNEL if quant else ra.KERNEL
        before = kernel.launches
        got = ra.packed_ragged_attention(q, k, v, pool, table, *lanes, 128, 1, window, scales)
        want = ra.packed_ragged_attention_plain(q, k, v, pool, table, *lanes, 1, window, scales)
    else:
        kernel = ra.RECT_INT8_KERNEL if quant else ra.RECT_KERNEL
        before = kernel.launches
        got = ra.ragged_paged_attention(q, k, v, pool, table, *lanes, 1, window, scales)
        want = ra.ragged_paged_attention_plain(q, k, v, pool, table, *lanes, 1, window, scales)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)
    if layout == "packed":
        assert not got[sum(q_lens):].any(), "pad rows give zeros"
    else:
        for b, n in enumerate(q_lens):
            assert not got[b, n:].any(), "rows past q_len give zeros"


def test_int8_wrappers_refuse_what_their_kernels_do_not_take(card):
    gen, pool, table = _setup(card, torch.bfloat16, 128, 2, 9)
    pq, ps = _int8_pool(pool)
    q = torch.randn((2, 32, 8, 128), generator=gen, device=card).to(torch.bfloat16)
    k = torch.randn((2, 32, HKV, 128), generator=gen, device=card).to(torch.bfloat16)
    lens = torch.tensor([5, 9], dtype=torch.int32, device=card)
    before = ra.RECT_INT8_KERNEL.launches
    for data, scales in (
        (pq, ps.cpu()),  # scales on the host
        (pq.cpu(), ps),  # data on the host
        (pq, ps.double()),  # scales of another dtype
        (pq, ps[:, :, 1:]),  # scales of another shape
        (pq, ps.transpose(2, 3).contiguous().transpose(2, 3)),  # not contiguous
        (pool, ps),  # a dense pool beside scales
    ):
        with pytest.raises(ValueError):
            ra.ragged_paged_attention(q, k, k, data, table, lens, lens, 0, 0, scales)
    assert ra.RECT_INT8_KERNEL.launches == before
    with pytest.raises(ValueError):  # an int8 pool without scales is a dense pool
        ra.ragged_paged_attention(q, k, k, pq, table, lens, lens)


def test_quantize_rows_on_the_card_is_the_cpu_rule(card):
    gen = torch.Generator(device=card)
    gen.manual_seed(10)
    mag = torch.logspace(-2, 1.7, 4096, device=card)[:, None, None]
    x = (torch.randn((4096, 8, 128), generator=gen, device=card) * mag).to(torch.bfloat16)
    x[100] = 0.0
    qc, sc = quantize_kv_rows(x)
    qh, sh = quantize_kv_rows(x.cpu())
    assert torch.equal(qc.cpu(), qh)
    assert torch.equal(sc.cpu().view(torch.int32), sh.view(torch.int32))


def _digest(t: torch.Tensor) -> str:
    raw = t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def dense_digests(fp, ra, card) -> dict:
    """SHA-256 prefixes of the outputs of kernels 2, 3 and the dense
    entries of 4 and 5 on fixed inputs made with numpy (bf16 and f32, two
    geometries, with and without a window)."""
    out = {}
    rs = np.random.default_rng(2024)

    def rand(*shape, dtype):
        return torch.from_numpy(rs.standard_normal(shape).astype(np.float32)).to(card).to(dtype)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=card)

    for dtype in (torch.float32, torch.bfloat16):
        for D, n_rep in ((128, 4), (64, 2)):
            Hq = HKV * n_rep
            pool = rand(L, 2, N, PAGE, HKV, D, dtype=dtype)
            table = i32(np.stack([rs.permutation(N - 1)[:P] + 1 for _ in range(4)]))
            for window in (0, 7):
                tag = f"{str(dtype)[6:]}-D{D}-r{n_rep}-w{window}"
                q, k, v = (rand(2, 96, h, D, dtype=dtype) for h in (Hq, HKV, HKV))
                out[f"flash-{tag}"] = _digest(
                    fp.flash_prefill_attention(q, k, v, i32([96, 45]), window)
                )
                q = rand(2, 48, Hq, D, dtype=dtype)
                kc, vc = (rand(2, 85, HKV, D, dtype=dtype) for _ in range(2))
                out[f"prefix-{tag}"] = _digest(
                    fp.flash_prefix_prefill_attention(
                        q, kc, vc, i32([21, 37]), i32([40, 3]), window
                    )
                )
                q, k, v = (rand(128, h, D, dtype=dtype) for h in (Hq, HKV, HKV))
                lanes = (i32([37, 0, 16, 0]), i32([0, 1, 41, 0]), i32([1, 40, 7, 0]))
                out[f"packed-{tag}"] = _digest(
                    ra.packed_ragged_attention(q, k, v, pool, table, *lanes, 64, 1, window)
                )
                q, k, v = (rand(4, 64, h, D, dtype=dtype) for h in (Hq, HKV, HKV))
                out[f"rect-{tag}"] = _digest(
                    ra.ragged_paged_attention(
                        q, k, v, pool, table, i32([37, 0, 16, 20]), i32([1, 40, 7, 0]),
                        1, window,
                    )
                )
    return out


# outputs recorded on an NVIDIA H100 80GB HBM3 (nvcc of the CUDA toolkit on
# the card's machine); a change that alters a kernel's arithmetic on purpose
# records its entries anew and says why.  The f32 entries are those of the
# build before the CTA routine's prefix sources learnt to load int8 rows.
# The eight bf16 flash- and prefix- entries were recorded anew when bf16
# flash prefill moved to the tensor cores, and the eight bf16 packed- and
# rect- entries when bf16 ragged attention did: their products run as bf16
# mma with f32 accumulators in another order, and P is rounded to bf16
# before its product with V (the Pallas kernels' arithmetic), so those
# outputs changed on purpose.
DENSE_DIGESTS = {
    "flash-float32-D128-r4-w0": "626bc3177bcaef20",
    "prefix-float32-D128-r4-w0": "58e3dab768f8e5bb",
    "packed-float32-D128-r4-w0": "fd520442c4451ea8",
    "rect-float32-D128-r4-w0": "07a1b8f3f455ee0c",
    "flash-float32-D128-r4-w7": "c0d3ec9caf74263d",
    "prefix-float32-D128-r4-w7": "95df74396fb3241f",
    "packed-float32-D128-r4-w7": "e70c2edbb5e152f1",
    "rect-float32-D128-r4-w7": "d0474f530aae8b77",
    "flash-float32-D64-r2-w0": "9177676dc149b4b1",
    "prefix-float32-D64-r2-w0": "3e7cc25fae2c10f2",
    "packed-float32-D64-r2-w0": "90130d32df3ffb23",
    "rect-float32-D64-r2-w0": "173a970e4018b67f",
    "flash-float32-D64-r2-w7": "3226766f7bf052b4",
    "prefix-float32-D64-r2-w7": "b49a17e9cfd8740e",
    "packed-float32-D64-r2-w7": "0b5ac49edfffc19a",
    "rect-float32-D64-r2-w7": "cb52c3eb00be7ebb",
    "flash-bfloat16-D128-r4-w0": "500dc9ea4944794a",
    "prefix-bfloat16-D128-r4-w0": "9baba191b5f38057",
    "packed-bfloat16-D128-r4-w0": "dd038986836d0c45",
    "rect-bfloat16-D128-r4-w0": "4201591537f2a80d",
    "flash-bfloat16-D128-r4-w7": "082e8c980f71fc85",
    "prefix-bfloat16-D128-r4-w7": "213c960ba4502f04",
    "packed-bfloat16-D128-r4-w7": "766d9074769048b0",
    "rect-bfloat16-D128-r4-w7": "a862290d09670517",
    "flash-bfloat16-D64-r2-w0": "e1dd51de38bd5b5e",
    "prefix-bfloat16-D64-r2-w0": "ee1281e57e27546e",
    "packed-bfloat16-D64-r2-w0": "bbd0829b8b5e4e5e",
    "rect-bfloat16-D64-r2-w0": "e9e7c675a5f157e3",
    "flash-bfloat16-D64-r2-w7": "110030a9c40c43e0",
    "prefix-bfloat16-D64-r2-w7": "96ae7c645ea9629b",
    "packed-bfloat16-D64-r2-w7": "c970984e2f3ab079",
    "rect-bfloat16-D64-r2-w7": "eef4ab56c15ae1c2",
}


def test_dense_entries_give_the_recorded_outputs_bit_for_bit(card):
    got = dense_digests(fp, ra, card)
    print(got)
    assert got == DENSE_DIGESTS


# ---------------------------------------------------------------------------
# CUDA graphs of the engine's decode dispatches
# ---------------------------------------------------------------------------

GB = 4  # engine lanes of the graph tests


def _graph_engine(card, dtype, kv_dtype=None, max_batch_size=GB):
    """A small engine on the card with a random pool and a random,
    all-active decode state (greedy and seeded sampled lanes, one with a
    penalty so the decode block's histogram moves)."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.kv_cache import QuantKV
    from dynamo_tpu_torch.engine.model import init_params

    cfg = ModelConfig.tiny(
        head_dim=64, num_heads=4, num_kv_heads=2,
        dtype="bfloat16" if dtype == torch.bfloat16 else "float32",
    )
    ecfg = EngineConfig(
        max_batch_size=max_batch_size, max_seq_len=256, page_size=16, num_pages=64,
        kv_dtype=kv_dtype,
    )
    eng = TorchEngine(cfg, init_params(cfg, 5, card, dtype), ecfg, device=card)
    gen = torch.Generator(device=card)
    gen.manual_seed(11)
    pool = eng.kv.pages
    if isinstance(pool, QuantKV):
        pool.q.copy_(torch.randint(-127, 128, pool.q.shape, generator=gen, device=card))
        pool.s.copy_(torch.rand(pool.s.shape, generator=gen, device=card) * 0.02 + 1e-3)
    else:
        pool.copy_(torch.randn(pool.shape, generator=gen, device=card).to(pool.dtype))
    rs = np.random.default_rng(7)
    B = max_batch_size
    v = eng._v
    v["tokens"].copy_(torch.from_numpy(rs.integers(1, cfg.vocab_size, B)))
    lens = rs.integers(20, 90, B)
    v["seq_lens"].copy_(torch.from_numpy(lens))
    v["limit_lens"].copy_(torch.from_numpy(lens + 40))
    v["active"].fill_(True)
    table = np.stack([rs.permutation(63)[:8] + 1 for _ in range(B)]).astype(np.int32)
    v["page_table"][:, :8].copy_(torch.from_numpy(table))
    v["temperature"].copy_(torch.tensor([0.0, 0.9, 0.0, 1.1] * (B // 4)))
    v["key"].copy_(torch.arange(1, B + 1))
    v["seeded"].copy_(torch.tensor([False, True] * (B // 2)))
    v["freq"].copy_(torch.tensor([0.5, 0.0, 0.0, 0.0] * (B // 4)))
    v["rep"].copy_(torch.tensor([1.0, 1.0, 1.3, 1.0] * (B // 4)))
    eng._counts[:B].copy_(
        torch.randint(0, 3, (B, cfg.vocab_size), generator=gen, device=card, dtype=torch.int32)
    )
    torch.cuda.synchronize()
    return eng


def _snapshot(eng):
    from dynamo_tpu_torch.engine.kv_cache import QuantKV

    pool = eng.kv.pages
    pool_t = (pool.q, pool.s) if isinstance(pool, QuantKV) else (pool,)
    return [t.clone() for t in (*eng._st.values(), eng._counts, *pool_t)], pool_t


def _restore(eng, snap):
    saved, pool_t = snap
    for dst, src in zip((*eng._st.values(), eng._counts, *pool_t), saved):
        dst.copy_(src)
    torch.cuda.synchronize()


def _state_now(eng):
    return _snapshot(eng)[0]


def _replay_equals_eager(eng, dispatch):
    """A dispatch's first run (its graphs captured after their eager
    warm-ups) and a second run from the same starting state (replays
    alone) give the same output, state and pool bit for bit.  Returns the
    starting state, the output and the launch counts of one dispatch."""
    from dynamo_tpu_torch.engine.graphs import launch_counts

    snap = _snapshot(eng)
    before = launch_counts()
    first = dispatch().clone()
    torch.cuda.synchronize()
    launches = [a - b for a, b in zip(launch_counts(), before)]
    after_first = _state_now(eng)
    captures = eng.graph_captures
    assert captures > 0
    _restore(eng, snap)
    replays = sum(eng.graph_replays.values())
    again = dispatch().clone()
    torch.cuda.synchronize()
    assert eng.graph_captures == captures and sum(eng.graph_replays.values()) > replays
    assert torch.equal(again, first)
    for got, want in zip(_state_now(eng), after_first):
        assert torch.equal(got, want)
    assert any(launches)
    return snap, first, launches


def _packed_dispatch(eng, K, n=GB, Pb=8):
    """A decode-only packed dispatch of K steps over lanes 0..n-1: the
    packed step's graph, then K - 1 decode-step replays."""
    B = eng.cfg.max_batch_size
    z = np.zeros((B,), np.int64)
    dec_cap = np.arange(B) < n

    def dispatch():
        return eng._run_packed(
            {}, z, z, np.zeros((B,), bool), dec_cap, dec_cap.astype(np.int64), n, Pb,
            K, 0, False,
        )

    return dispatch


@pytest.mark.parametrize("K", [1, 2, 8])
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["dense", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_graph_replay_equals_eager(card, dtype, kv_dtype, K):
    from dynamo_tpu_torch.engine.graphs import launch_counts

    eng = _graph_engine(card, dtype, kv_dtype)
    dispatch = _packed_dispatch(eng, K)
    snap, first, launches = _replay_equals_eager(eng, dispatch)
    assert first.shape == (GB, K, 2) and (first[:, :, 0] >= 0).all()
    assert eng.graph_captures == (1 if K == 1 else 2)
    # the launch counts after N replayed dispatches: N times one dispatch's
    base = launch_counts()
    for _ in range(3):
        _restore(eng, snap)
        dispatch()
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(launch_counts(), base)] == [3 * n for n in launches]


@pytest.mark.parametrize("use_penalties", [False, True])
def test_decode_block_graph_replay_equals_eager(card, use_penalties):
    eng = _graph_engine(card, torch.bfloat16)
    _, first, _ = _replay_equals_eager(
        eng, lambda: eng._run_block(4, 8, 0, True, use_penalties)
    )
    assert first.shape == (GB, 4, 2) and eng.graph_captures == 1


def test_evicted_packed_key_recaptures_the_same_bits(card):
    """A shape the budget evicts releases its graph; the next dispatch of
    that shape captures it again and gives the same bits."""
    from types import SimpleNamespace

    from dynamo_tpu_torch.engine.bucketing import PackedShapeBudget

    eng = _graph_engine(card, torch.bfloat16)
    eng._packed_shapes = PackedShapeBudget(1)
    B = GB
    z = np.zeros((B,), np.int64)

    def packed_keys():
        return [k[1:3] for k in eng.graphs.keys() if k[0] == "packed"]

    def decode(n):
        dec_cap = np.arange(B) < n
        out = eng._run_packed(
            {}, z, z, np.zeros((B,), bool), dec_cap, dec_cap.astype(np.int64), n, 8, 2,
            0, False,
        )
        torch.cuda.synchronize()
        return out.clone()

    snap = _snapshot(eng)
    first = decode(B)
    assert packed_keys() == [(B, 1)] and eng.graph_captures == 2  # packed, step
    # an 8-token chunk on lane 0 alone: shape (8, 8), which (4, 1) does
    # not dominate, so it evicts (4, 1) and its graph
    p_lens = z.copy()
    p_lens[0] = 8
    chunk = SimpleNamespace(seq=SimpleNamespace(prompt=list(range(1, 9))), start=0, length=8)
    eng._run_packed(
        {0: chunk}, z, p_lens, np.zeros((B,), bool), np.zeros((B,), bool), p_lens, 8, 8,
        1, 0, False,
    )
    assert packed_keys() == [] and eng._packed_shapes.evictions == 1
    _restore(eng, snap)
    again = decode(B)
    assert eng._packed_shapes.evictions == 2 and eng.graph_captures == 3
    assert torch.equal(again, first)


def test_graph_capture_and_release_keep_memory_flat(card):
    import gc

    eng = _graph_engine(card, torch.bfloat16)
    dispatch = _packed_dispatch(eng, 8)
    snap = _snapshot(eng)
    seen = []
    for _ in range(4):
        _restore(eng, snap)
        dispatch()
        torch.cuda.synchronize()
        eng.graphs.release(lambda k: False)
        gc.collect()
        seen.append(torch.cuda.memory_allocated())
    assert eng.graph_captures == 8
    assert len(set(seen[1:])) == 1, seen
