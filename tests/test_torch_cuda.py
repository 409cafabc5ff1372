"""The port's hand-written CUDA kernels against their plain versions, on the
card: paged decode, packed and rectangle ragged (the dense pool's entries
and the int8 pool's), full and prefix-suffix flash prefill.  Every
instantiation the wrappers can launch (f32 and bf16, head dims 64 and 128,
GQA groups 2 and 4: those of the port's configs), with and without a
sliding window, at small shapes; paged decode also over a 2048-position
table across the bf16 kernel's splits and on a table wide enough to grow
them; the flash kernels also at lengths around their 64-row tiles and at
the serve shape of kernel 2 in ``chip_smoke.py``, the ragged kernels (both
layouts, both pools) at their tile and page edges; prefix-suffix prefill
and packed ragged also at the speculative verify's shapes (S = 5 and 9
columns at offsets off the page; verify segments of 2 to 9 rows beside
decode rows).  The offload plane's page copies on the card give the CPU's
bytes; an eviction snapshot keeps the bytes that the very next replayed
dispatch overwrites; a swapped lane resumes under graph replay with the
streams of a roomy pool.  A disaggregated delivery lands as the same pool
pages through the same-process device handoff as through the wire.
The dense entries of the ragged and flash kernels also give, bit for bit,
the outputs recorded in ``DENSE_DIGESTS``.  A tp = 2 engine on the card
(both ranks on one card over gloo) gives one card's streams and pools;
NCCL ranks (one card each, where there are two) are refused by name, and
a tp above the card count by JAX's message.  GGUF dequantization
(``llm/gguf.py``) on the card gives the CPU's bits for each of its five
tensor types.

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

RUN_S = 600  # bound on any one asyncio.run (kernel builds included): a hang fails its test

pytestmark = pytest.mark.cuda

L, N, PAGE, P = 2, 48, 8, 8  # layers, pool pages, page size, table width
HKV = 2
TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
# (D, n_rep): the port's first configs' geometries, then GQA groups 1, 3,
# 7 and 8 and head dims 96 and 256 (Llama-2, Llama-3.2-3B, Qwen2-7B,
# Llama-3-70B, Phi-3, Gemma)
GEOMETRY = [(d, r) for d in (64, 128) for r in (2, 4)] + [
    (64, 1), (128, 3), (64, 7), (128, 8), (96, 2), (96, 8), (256, 1), (256, 4),
]


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
        # at D 256 the bf16 kernel holds one CTA a SM, so half the splits
        chunk, splits = pa.decode_split(width, page, 8 * HKV, pa.resident_ctas(card, D))
        assert chunk == (128 if D <= 128 else 256) and splits >= 8
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
    chunk, splits = pa.decode_split(1024, 16, 4 * HKV, pa.resident_ctas(card, 128))
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
def test_packed_ragged_kernel_with_verify_segments(card, D, n_rep, dtype, window):
    # folded speculative verify: segments of 2 to 9 rows (a lane's last
    # committed token and its drafts) beside decode rows, packed by the
    # engine's rule, s_max = pow2(9)
    base = [37, 12, 3, 50, 21, 0]
    q_lens = [5, 1, 9, 1, 2, 0]
    B = len(base)
    offs, off = [], 0
    for n in q_lens:
        offs.append(off if n else 0)
        off += n
    s_max = 16
    Np = 32  # >= every live lane's off + s_max
    gen, pool, table = _setup(card, dtype, D, B, 9)

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
    # the standalone speculative verify: S = 1 + pow2(draft) columns over a
    # lane's whole page table, offsets off the page and the key tile
    "verify-s5": ([7, 20, 33, 0], [1, 3, 5, 0], 5, 48),
    "verify-s9": ([45, 3, 29, 61], [9, 2, 6, 9], 9, 64),
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


def _graph_engine(card, dtype, kv_dtype=None, max_batch_size=GB, model_kw=None, **engine_kw):
    """A small engine on the card with a random pool and a random,
    all-active decode state (greedy and seeded sampled lanes, one with a
    penalty so the decode block's histogram moves); ``model_kw`` goes to
    its ``ModelConfig``, ``engine_kw`` to its ``EngineConfig``."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.kv_cache import QuantKV
    from dynamo_tpu_torch.engine.model import init_params

    cfg = ModelConfig.tiny(**{
        **dict(head_dim=64, num_heads=4, num_kv_heads=2,
               dtype="bfloat16" if dtype == torch.bfloat16 else "float32"),
        **(model_kw or {}),
    })
    ecfg = EngineConfig(
        max_batch_size=max_batch_size, max_seq_len=256, page_size=16, num_pages=64,
        kv_dtype=kv_dtype, **engine_kw,
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
        )[0]

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


# the head geometries and trunk switches of families beyond Llama's: Gemma
# (D 256, GELU, offset norm, scaled embeddings, tied head), Phi-3 (D 96,
# a window shorter than the lanes), Llama-3-70B's group 8
FAMILIES = {
    "gemma-d256": dict(head_dim=256, num_heads=2, num_kv_heads=1, hidden_act="gelu_tanh",
                       rms_norm_offset=True, scale_embeddings=True,
                       tie_word_embeddings=True),
    "phi3-d96-window": dict(head_dim=96, num_heads=4, num_kv_heads=4, sliding_window=40),
    "group8-d128": dict(head_dim=128, num_heads=8, num_kv_heads=1),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_packed_graph_replay_equals_eager(card, family):
    """A K = 8 decode dispatch captures and replays at each family's
    geometry and switches (Gemma's embedding scale once built a device
    tensor inside the capture, which CUDA graphs refuse), bit for bit."""
    eng = _graph_engine(card, torch.bfloat16, model_kw=FAMILIES[family])
    _replay_equals_eager(eng, _packed_dispatch(eng, 8))


@pytest.mark.parametrize("cf", [1.0, 2.0], ids=["binds", "mixtral"])
def test_moe_packed_graph_replay_equals_eager(card, cf):
    """An MoE engine's K = 8 decode dispatch (E = 8, K = 2): its graphs'
    replays give the eager run's output, state and pool bit for bit, with
    capacity binding or at Mixtral's factor."""
    eng = _graph_engine(card, torch.bfloat16, model_kw=dict(
        num_experts=8, num_experts_per_tok=2, moe_capacity_factor=cf))
    _, first, _ = _replay_equals_eager(eng, _packed_dispatch(eng, 8))
    assert first.shape == (GB, 8, 2) and eng.graph_captures == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_mlp_graph_replay_equals_eager(card, dtype):
    """``_moe_mlp`` captured in a CUDA graph (no host sync: its capacity is
    a Python int of the static row count) replays the eager result bit for
    bit, on the captured rows and on new rows written into them."""
    from dynamo_tpu_torch.engine import model
    from dynamo_tpu_torch.engine.config import ModelConfig

    cfg = ModelConfig.tiny(num_experts=8, num_experts_per_tok=2, moe_capacity_factor=1.0,
                           dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    params = model.init_params(cfg, 3, card, dtype)
    lp = {k: w[0] for k, w in params["layers"].items()}
    gen = torch.Generator(device=card)
    gen.manual_seed(4)
    x = torch.randn(24, cfg.hidden_size, generator=gen, device=card).to(dtype)
    eager = model._moe_mlp(lp, x, cfg)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        model._moe_mlp(lp, x, cfg)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = model._moe_mlp(lp, x, cfg)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    x.copy_(torch.randn(x.shape, generator=gen, device=card).to(dtype))
    want = model._moe_mlp(lp, x, cfg)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("use_penalties", [False, True])
def test_decode_block_graph_replay_equals_eager(card, use_penalties):
    eng = _graph_engine(card, torch.bfloat16)
    _, first, _ = _replay_equals_eager(
        eng, lambda: eng._run_block(4, 8, 0, True, use_penalties)
    )
    assert first.shape == (GB, 4, 2) and eng.graph_captures == 1


def test_graph_captures_are_compile_sentry_events(card):
    """Each capture is one compile-sentry event under its graph's kind: a
    packed dispatch of K = 8 captures the packed step and the decode step,
    a filtered decode block another decode step; armed, nothing raises,
    and the sentry's graph events equal the engine's ``graph_captures``."""
    from dynamo_tpu_torch.runtime import compile_sentry

    eng = _graph_engine(card, torch.bfloat16)
    compile_sentry.reset()
    prev = compile_sentry.arm(True)
    try:
        _packed_dispatch(eng, 8)()
        eng._run_block(4, 8, 0, True, False)
        torch.cuda.synchronize()
        counts = compile_sentry.counts()
        counts.pop(compile_sentry.KERNEL_BUILD, None)  # a first launch builds
        assert counts == {"packed": 1, "step": 2}
        assert sum(counts.values()) == eng.graph_captures == 3
    finally:
        compile_sentry.arm(prev)
        compile_sentry.reset()


def test_device_trace_holds_the_replayed_kernels(card, tmp_path):
    """A ``torch.profiler`` capture taken on this thread (the one Kineto
    registered on) while another thread replays packed dispatches (K = 2:
    the packed step's graph, then a decode step's) records the kernels by
    name -- packed ragged and paged decode -- and answers ``ok``."""
    import asyncio
    import json
    import threading

    from dynamo_tpu_torch.runtime import profiling

    eng = _graph_engine(card, torch.bfloat16)
    dispatch = _packed_dispatch(eng, 2)
    dispatch()  # captures: the window holds replays
    torch.cuda.synchronize()
    stop = threading.Event()

    def replay():
        while not stop.is_set():
            dispatch()
            torch.cuda.synchronize()

    t = threading.Thread(target=replay)
    t.start()
    try:
        result = asyncio.run(
            asyncio.wait_for(profiling.capture_device_trace(1.0, str(tmp_path)), RUN_S)
        )
    finally:
        stop.set()
        t.join(timeout=60)
    assert result["ok"], result
    with open(tmp_path / profiling.DEVICE_TRACE_FILE) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert profiling.count_kernels(str(tmp_path / profiling.DEVICE_TRACE_FILE)) == len(
        [e for e in events if e.get("cat") == "kernel"])
    assert any("ragged" in n for n in names), names
    assert any("paged_decode" in n for n in names), names


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
        out, _ = eng._run_packed(
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


def _write_checkpoint(path, cfg, params, st_dtype: str) -> None:
    """A ``config.json`` and a ``model.safetensors`` (written here: the
    card's machine has no ``safetensors`` package) of ``params`` under
    HuggingFace names, in ``st_dtype`` (``F32`` or ``BF16``)."""
    import json
    import struct

    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    sd = {"model.embed_tokens.weight": params["embed"],
          "model.norm.weight": params["final_norm"],
          "lm_head.weight": params["lm_head"].T}
    for i in range(cfg.num_layers):
        for key, name in names.items():
            sd[f"model.layers.{i}.{name}.weight"] = params["layers"][key][i].T
        sd[f"model.layers.{i}.input_layernorm.weight"] = params["layers"]["input_norm"][i]
        sd[f"model.layers.{i}.post_attention_layernorm.weight"] = params["layers"]["post_norm"][i]
    as_type = torch.float32 if st_dtype == "F32" else torch.bfloat16
    blobs = {n: t.to(as_type).contiguous().cpu().view(torch.uint8).numpy().tobytes()
             for n, t in sd.items()}
    header, off = {}, 0
    for n, t in sd.items():
        header[n] = {"dtype": st_dtype, "shape": list(t.shape),
                     "data_offsets": [off, off + len(blobs[n])]}
        off += len(blobs[n])
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path / "model.safetensors", "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs.values()))
    (path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
    }))


@pytest.mark.parametrize("st_dtype", ["F32", "BF16"])
def test_from_pretrained_on_the_card_loads_the_cpu_params(card, tmp_path, st_dtype):
    """``TorchEngine.from_pretrained`` maps the checkpoint and copies each
    leaf to the card as it is, transposing and casting there: the card's
    parameters are the CPU load's, bit for bit."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.model import init_params

    cfg = ModelConfig.tiny(head_dim=64, num_heads=4, num_kv_heads=2)
    _write_checkpoint(tmp_path, cfg, init_params(cfg, 1, torch.device("cpu"), torch.float32),
                      st_dtype)
    ecfg = EngineConfig(num_pages=16, max_seq_len=64)
    on_card = TorchEngine.from_pretrained(str(tmp_path), ecfg, device=card)
    on_cpu = TorchEngine.from_pretrained(str(tmp_path), ecfg, device="cpu")
    assert on_card.model_cfg.dtype == "bfloat16"

    def flat(p):
        return {**{k: v for k, v in p.items() if k != "layers"}, **p["layers"]}

    card_p, cpu_p = flat(on_card.params), flat(on_cpu.params)
    assert card_p.keys() == cpu_p.keys()
    for k, t in card_p.items():
        assert t.device.type == "cuda" and t.dtype == torch.bfloat16
        assert torch.equal(t.cpu(), cpu_p[k]), k


# -- the full flash prefill's other callers: scoring, embedding, soft prompts ----


def _prefill_callers_model(card):
    """A small f32 model of a geometry the kernels take, its parameters on
    the card and on the CPU, and token rows from a seed: lanes of 40, 17
    and 1 positions and a pad lane in a 64-position bucket."""
    from dynamo_tpu_torch.engine.config import ModelConfig
    from dynamo_tpu_torch.engine.model import init_params

    cfg = ModelConfig.tiny(head_dim=64, num_heads=4, num_kv_heads=2)
    cpu = init_params(cfg, 2, torch.device("cpu"), torch.float32)
    on_card = {
        k: ({n: w.to(card) for n, w in v.items()} if isinstance(v, dict) else v.to(card))
        for k, v in cpu.items()
    }
    rs = np.random.default_rng(9)
    tokens = torch.from_numpy(rs.integers(1, cfg.vocab_size, (4, 64)))
    lens = torch.tensor([40, 17, 1, 0])
    pool = torch.zeros((cfg.num_layers, 2, 16, 16, cfg.num_kv_heads, cfg.head_dim))
    return cfg, {"cuda": on_card, "cpu": cpu}, tokens, lens, pool


def _on_both(card, fn):
    """``fn(device)`` on the card and on the CPU; the flash prefill kernel
    must have launched once per layer on the card."""
    from dynamo_tpu_torch.ops import flash_prefill as fp

    before = fp.KERNEL.launches
    with torch.inference_mode():
        got = fn(card)
        torch.cuda.synchronize()
        launched = fp.KERNEL.launches - before
        want = fn(torch.device("cpu"))
    return got.cpu(), want, launched


@pytest.mark.parametrize("top_n", [0, 8])
def test_score_prompt_step_on_the_card_is_the_cpu_run(card, top_n):
    from dynamo_tpu_torch.engine.step import score_prompt_step

    cfg, params, tokens, lens, pool = _prefill_callers_model(card)
    got, want, launched = _on_both(card, lambda dev: score_prompt_step(
        params[dev.type], cfg, pool.to(dev), tokens.to(dev), lens.to(dev), top_n,
    ))
    assert launched == cfg.num_layers
    for b, n in enumerate(lens.tolist()):
        g, w = got[b, : max(n - 1, 0)].numpy(), want[b, : max(n - 1, 0)].numpy()
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g[:, 1].view(np.float32), w[:, 1].view(np.float32),
                                   atol=1e-4, rtol=0)
        np.testing.assert_array_equal(g[:, 2 : 2 + top_n], w[:, 2 : 2 + top_n])


def test_embed_step_on_the_card_is_the_cpu_run(card):
    from dynamo_tpu_torch.engine.step import embed_step

    cfg, params, tokens, lens, pool = _prefill_callers_model(card)
    got, want, launched = _on_both(card, lambda dev: embed_step(
        params[dev.type], cfg, pool.to(dev), tokens.to(dev), lens.to(dev),
    ))
    assert launched == cfg.num_layers
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert not got[3].any()


@pytest.mark.parametrize("use_penalties", [False, True])
def test_prefill_mm_and_sample_on_the_card_is_the_cpu_run(card, use_penalties):
    """Soft prompts of 24 and 5 rows (M = 32), a text lane, a pad lane:
    the same first tokens and logprobs, and the same pool rows written."""
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.step import prefill_mm_and_sample

    cfg, params, tokens, lens, pool = _prefill_callers_model(card)
    gen = torch.Generator().manual_seed(4)
    mm = 0.05 * torch.randn((4, 32, cfg.hidden_size), generator=gen)
    mm_len = torch.tensor([24, 5, 0, 0])
    table = torch.arange(1, 17, dtype=torch.int32).reshape(4, 4)
    table[3] = 0
    pools = {}

    def run(dev):
        B = 4
        sampling = SamplingParams(
            temperature=torch.zeros(B, device=dev), top_p=torch.ones(B, device=dev),
            top_k=torch.zeros(B, dtype=torch.long, device=dev),
            key=torch.zeros(B, dtype=torch.long, device=dev),
            seeded=torch.zeros(B, dtype=torch.bool, device=dev),
            freq=torch.zeros(B, device=dev), pres=torch.zeros(B, device=dev),
            rep=torch.full((B,), 1.3, device=dev),
        )
        pools[dev.type] = pool.to(dev)
        return prefill_mm_and_sample(
            params[dev.type], cfg, pools[dev.type], tokens.to(dev), lens.to(dev),
            table.to(dev), mm.to(dev), mm_len.to(dev), sampling, 2, use_penalties,
        )

    got, want, launched = _on_both(card, run)
    assert launched == cfg.num_layers
    live = lens > 0
    assert torch.equal(got[live][:, 0], want[live][:, 0])
    assert torch.equal(got[live][:, 2:4], want[live][:, 2:4])
    torch.testing.assert_close(got[live][:, 1].view(torch.float32),
                               want[live][:, 1].view(torch.float32), atol=1e-4, rtol=0)
    written = table[:3].flatten().long()
    torch.testing.assert_close(pools["cuda"].cpu()[:, :, written],
                               pools["cpu"][:, :, written], atol=5e-5, rtol=0)


# ---------------------------------------------------------------------------
# the offload plane: page copies, eviction snapshots, swap-in
# ---------------------------------------------------------------------------


def _pools(card, kv_dtype, seed=3):
    """The same random pool on the card and on the CPU (bf16, or the int8
    pair)."""
    from dynamo_tpu_torch.engine.kv_cache import QuantKV

    gen = torch.Generator().manual_seed(seed)
    dense = torch.randn((L, 2, 12, 16, HKV, 64), generator=gen).to(torch.bfloat16)
    if kv_dtype == "int8":
        q, sc = quantize_kv_rows(dense)
        cpu = QuantKV(q=q, s=sc)
        return QuantKV(q=q.to(card), s=sc.to(card)), cpu
    return dense.to(card), dense.clone()


def _host_bytes(x) -> list:
    from dynamo_tpu_torch.engine.kv_cache import QuantKV, host_view

    parts = (x.q, x.s) if isinstance(x, QuantKV) else (x,)
    return [host_view(t.cpu()).tobytes() for t in parts]


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["bf16", "int8"])
def test_page_copies_on_the_card_are_the_cpu_bytes(card, kv_dtype):
    from dynamo_tpu_torch.engine import step
    from dynamo_tpu_torch.engine.kv_cache import PageSnapshot, QuantKV

    dev_pool, cpu_pool = _pools(card, kv_dtype)
    ids = torch.tensor([5, 1, 9])
    got = {}
    for name, pool, d in (("card", dev_pool, card), ("cpu", cpu_pool, torch.device("cpu"))):
        blk = step.gather_block_pages(pool, ids.to(d))
        snap = PageSnapshot(blk)
        host = snap.materialize()
        host_parts = (host.q, host.s) if isinstance(host, QuantKV) else (host,)
        chunk = step.gather_layer_pages(pool, torch.tensor([1], device=d), ids.to(d))
        step.scatter_layer_pages(pool, slice(0, 2),
                                 torch.tensor([3, 7, 0, 0], device=d),
                                 QuantKV(q=torch.cat([blk.q[:, :, :2]] * 2, 2),
                                         s=torch.cat([blk.s[:, :, :2]] * 2, 2))
                                 if isinstance(blk, QuantKV) else torch.cat([blk[:, :, :2]] * 2, 2))
        step.scatter_block_pages(pool, torch.tensor([10, 11], device=d),
                                 QuantKV(q=blk.q[:, :, 1:], s=blk.s[:, :, 1:])
                                 if isinstance(blk, QuantKV) else blk[:, :, 1:])
        real = torch.arange(1, 12, device=d)
        got[name] = (
            _host_bytes(blk), [a.tobytes() for a in host_parts], _host_bytes(chunk),
            _host_bytes(QuantKV(q=pool.q[:, :, real], s=pool.s[:, :, real])
                        if isinstance(pool, QuantKV) else pool[:, :, real]),
        )
    assert got["card"] == got["cpu"]
    assert got["card"][0] == got["card"][1], "the snapshot's host copy is its gather"


def test_eviction_snapshot_keeps_the_bytes_the_next_replay_overwrites(card):
    """A block evicted while the next dispatch -- a graph replay -- writes
    its page: the snapshot gathered and copied before that replay holds
    the page's old bytes (stream order), and the replay did write it."""
    from dynamo_tpu_torch.block_manager import RegisteredBlock
    from dynamo_tpu_torch.engine.kv_cache import host_view

    eng = _graph_engine(card, torch.bfloat16, host_offload_blocks=8)
    dispatch = _packed_dispatch(eng, 1)
    snap = _snapshot(eng)
    dispatch()  # eager warm-up and capture
    _restore(eng, snap)
    replays = sum(eng.graph_replays.values())
    v = eng._v
    pos = int(v["seq_lens"][0])
    page = int(v["page_table"][0, pos // 16])
    pool = eng.kv.pages
    before = pool[:, :, page : page + 1].clone()
    eng._on_pool_evict(RegisteredBlock(sequence_hash=77, pages=(page,), refs=0, position=3))
    dispatch()  # replays the packed step: lane 0 writes position `pos` of `page`
    torch.cuda.synchronize()
    assert sum(eng.graph_replays.values()) == replays + 1
    eng.offload_engine.drain()
    blob, meta = eng.offload.get_ram(77)
    assert meta.position == 3 and meta.kv_dtype == "bfloat16"
    assert blob.tobytes() == host_view(before.cpu()).tobytes()
    assert not torch.equal(pool[:, :, page : page + 1], before), "the replay wrote the page"
    assert eng.offload_engine.copy_fails == 0
    eng.offload_engine.close()


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["dense", "int8"])
def test_swap_in_under_graph_replay(card, kv_dtype):
    """Two growing lanes over a pool too small for both: the younger swaps
    out and back, its decode resumes through replayed graphs, and the
    streams equal a roomy pool's and the CPU's."""
    import asyncio

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.model import init_params
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest
    from dynamo_tpu_torch.runtime.engine import Context

    cfg = ModelConfig.tiny(head_dim=64, num_heads=4, num_kv_heads=2, num_layers=2)
    params = init_params(cfg, 3, torch.device("cpu"), torch.float32)
    rs = np.random.default_rng(5)
    prompts = [rs.integers(1, cfg.vocab_size, 20).tolist() for _ in range(2)]

    async def serve(eng):
        async def one(p):
            req = {"token_ids": p, "stop_conditions": {"max_tokens": 60},
                   "sampling_options": {"temperature": 0.0}, "eos_token_ids": []}
            stream = await eng.generate(Context.new(PreprocessedRequest.from_dict(req)))
            out = []
            async for item in stream:
                assert not item.is_error(), item.error_message()
                out += (item.data or {}).get("token_ids") or []
            return out

        try:
            return await asyncio.wait_for(asyncio.gather(*[one(p) for p in prompts]), 120)
        finally:
            await eng.stop()

    def run(dev, pages):
        on = {k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict) else v.to(dev))
              for k, v in params.items()}
        eng = TorchEngine(cfg, on, EngineConfig(
            max_batch_size=2, max_seq_len=256, mixed_token_budget=32, num_pages=pages,
            host_offload_blocks=32, kv_dtype=kv_dtype, async_dispatch=False), device=dev)
        return asyncio.run(asyncio.wait_for(serve(eng), RUN_S)), eng

    roomy, _ = run(card, 64)
    swapped, eng = run(card, 9)
    cpu, _ = run(torch.device("cpu"), 9)
    assert eng.sched.preempt_swap >= 1 and eng.offload_engine.swap_ins >= 1
    assert sum(eng.graph_replays.values()) > 0
    assert eng.offload_engine.swap_fallbacks == eng.offload_engine.copy_fails == 0
    assert swapped == roomy == cpu


CHAOS = {
    "swap-copy-fail": ("seed=3;offload.copy_fail=1:match=swap/", {}),
    "swap-truncate": ("seed=3;onboard.truncate=1:match=swap/", {}),
    "draft-corrupt-folded": ("seed=7;spec.draft_corrupt=1", {}),
    "draft-corrupt-fold-off": ("seed=7;spec.draft_corrupt=1", {"fold_spec_verify": False}),
}


@pytest.mark.parametrize("case", list(CHAOS))
def test_chaos_sites_on_the_card_are_the_cpu_runs(card, case):
    """The engine chaos sites armed on the card (swap copy failure, swap
    restore truncation, corrupted drafts folded and standalone) give the
    CPU's streams, firings and fallbacks, and the unfaulted streams."""
    import asyncio

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.model import init_params
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest
    from dynamo_tpu_torch.runtime import faults
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.spec import register_drafter

    spec_str, extra = CHAOS[case]
    drafting = case.startswith("draft")
    cfg = ModelConfig.tiny(head_dim=64, num_heads=4, num_kv_heads=2, num_layers=2)
    params = init_params(cfg, 3, torch.device("cpu"), torch.float32)
    rs = np.random.default_rng(5)
    prompts = [rs.integers(1, cfg.vocab_size, 20).tolist() for _ in range(2)]

    async def serve(eng, draft):
        async def one(p):
            req = {"token_ids": p, "stop_conditions": {"max_tokens": 60},
                   "sampling_options": {"temperature": 0.0}, "eos_token_ids": []}
            if draft:
                req["speculation"] = {"enabled": True, "num_draft_tokens": 4,
                                      "drafter": "card-chaos-oracle"}
            stream = await eng.generate(Context.new(PreprocessedRequest.from_dict(req)))
            out = []
            async for item in stream:
                assert not item.is_error(), item.error_message()
                out += (item.data or {}).get("token_ids") or []
            return out

        try:
            return await asyncio.wait_for(asyncio.gather(*[one(p) for p in prompts]), 120)
        finally:
            await eng.stop()

    def run(dev, armed, draft=False):
        on = {k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict) else v.to(dev))
              for k, v in params.items()}
        kw = dict(max_batch_size=2, max_seq_len=256, mixed_token_budget=32,
                  num_pages=64 if drafting else 9, async_dispatch=False, **extra)
        if not drafting:
            kw["host_offload_blocks"] = 32
        eng = TorchEngine(cfg, on, EngineConfig(**kw), device=dev)
        if armed:
            faults.injector.configure(spec_str)
        try:
            out = asyncio.run(asyncio.wait_for(serve(eng, draft), RUN_S))
            fired = {s: faults.injector.fire_count(s) for s in
                     ("offload.copy_fail", "onboard.truncate", "spec.draft_corrupt")}
        finally:
            faults.injector.disable()
        oe = eng.offload_engine
        counts = (eng.spec_accepted, eng.sched.preempt_swap, eng.sched.preempt_recompute,
                  None if oe is None else (oe.copy_fails, oe.swap_fallbacks, oe.swap_ins))
        return out, fired, counts

    plain = run(card, False)[0]
    if drafting:
        register_drafter("card-chaos-oracle", lambda: _Oracle(prompts, plain))
    got = run(card, True, drafting)
    want = run(torch.device("cpu"), True, drafting)
    assert got == want
    assert got[0] == plain
    assert sum(got[1].values()) > 0
    if drafting:
        assert got[2][0] == 0  # every corrupted draft rejected


class _Oracle:
    """Drafts each prompt's known plain continuation."""

    def __init__(self, prompts, streams):
        self.full = [list(p) + list(t) for p, t in zip(prompts, streams)]

    def propose(self, history, n):
        for full in self.full:
            if full[: len(history)] == list(history):
                return full[len(history): len(history) + n]
        return []


# ---------------------------------------------------------------------------
# Two engines in one process (the workers of serve-dyn)
# ---------------------------------------------------------------------------


def test_two_engines_capture_and_serve_side_by_side(card):
    """Two engines in one process, each dispatching and capturing its decode
    graphs on its own executor thread while the other serves, give the
    greedy streams each gives alone, and the process-wide launch counts
    equal the sum of what their dispatches imply (kernel 5 once per layer
    per packed dispatch, kernel 1 once per layer per fused step past the
    first)."""
    import asyncio

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.model import init_params
    from dynamo_tpu_torch.runtime.engine import Context

    cfg = ModelConfig.tiny(head_dim=64, num_heads=4, num_kv_heads=2)
    params = init_params(cfg, 4, card, torch.float32)
    rs = np.random.default_rng(4)
    reqs = [[{"token_ids": rs.integers(1, cfg.vocab_size, n).tolist(),
              "stop_conditions": {"max_tokens": 24}, "sampling_options": {},
              "eos_token_ids": []} for n in (5, 40, 90)] for _ in range(2)]

    def engine():
        return TorchEngine(cfg, params, EngineConfig(max_seq_len=256, num_pages=64),
                           device=card)

    async def serve(eng, batch):
        async def one(r):
            toks = []
            async for item in await eng.generate(Context.new(dict(r))):
                toks += (item.data or {}).get("token_ids") or []
            return toks

        try:
            return await asyncio.gather(*[one(r) for r in batch])
        finally:
            await eng.stop()

    alone = [asyncio.run(asyncio.wait_for(serve(engine(), b), RUN_S)) for b in reqs]
    pair = [engine(), engine()]
    before = (pa.KERNEL.launches, ra.KERNEL.launches)

    async def both():
        return await asyncio.gather(*[serve(e, b) for e, b in zip(pair, reqs)])

    together = asyncio.run(asyncio.wait_for(both(), RUN_S))
    assert together == alone
    assert all(sum(e.graph_replays.values()) > 0 for e in pair)
    decode = packed = 0
    for e in pair:
        decode += cfg.num_layers * sum((k - 1) * n for k, n in e.dispatches_by_k.items())
        packed += cfg.num_layers * e.dispatches.get("unified", 0)
    assert (pa.KERNEL.launches - before[0], ra.KERNEL.launches - before[1]) == (decode, packed)


# ---------------------------------------------------------------------------
# Disaggregated delivery: the same-process device handoff against the wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_device_handoff_and_wire_delivery_give_the_same_pages(card, kv_dtype):
    """A prompt exported on one engine and delivered into another's pool
    lands as the same pool pages whether it is handed over as a device
    tensor (the same-process path) or as the wire's bytes (a bf16 blob's
    ``uint16`` bits through the decode worker's raw handler); a dense
    pool holds the exported bytes, an int8 one their quantization by the
    pool's row rule either way.  Both requests then decode the same
    stream."""
    import asyncio
    import json

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.kv_cache import QuantKV, quantize_kv_blob
    from dynamo_tpu_torch.engine.model import init_params
    from dynamo_tpu_torch.engine.step import gather_block_pages
    from dynamo_tpu_torch.llm.disagg import DisaggDecodeEngine
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context

    cfg = ModelConfig.tiny(head_dim=64, num_heads=4, num_kv_heads=2, dtype="bfloat16")
    params = init_params(cfg, 6, card, torch.bfloat16)
    prompt = np.random.default_rng(6).integers(1, cfg.vocab_size, 150).tolist()

    def req():
        return PreprocessedRequest.from_dict({
            "token_ids": prompt, "stop_conditions": {"max_tokens": 12},
            "sampling_options": {}, "eos_token_ids": []})

    def host(blob):
        if isinstance(blob, QuantKV):
            return blob.q.cpu().numpy().tobytes() + blob.s.cpu().numpy().tobytes()
        return blob.cpu().view(torch.int16).numpy().tobytes()

    async def body():
        prefill = TorchEngine(cfg, params, EngineConfig(max_seq_len=256, num_pages=64),
                              device=card)
        decode = TorchEngine(cfg, params, EngineConfig(max_seq_len=256, num_pages=64,
                                                       kv_dtype=kv_dtype), device=card)
        landed = []
        commit = decode._apply_external_commit

        def spy(seq, *args):
            ids = torch.as_tensor(decode._lane_prompt_pages(seq), device=card)
            landed.append(host(gather_block_pages(decode.kv.pages, ids)))
            return commit(seq, *args)

        decode._apply_external_commit = spy
        rt = await DistributedRuntime.static()
        disagg = DisaggDecodeEngine(decode, rt.namespace("cuda"), "decode", instance_id=0)
        try:
            ((dev, row),) = await prefill.prefill_export_batch([req()], device=True)
            blob, row_h = await prefill.prefill_export(req())
            assert isinstance(dev, torch.Tensor) and dev.device.type == card.type
            assert blob.dtype == np.uint16 and host(dev) == blob.tobytes()
            assert np.array_equal(row, row_h)
            ctx = Context.new(req())
            s_dev = await decode.generate_external(ctx)
            assert decode.deliver_external(ctx.id, dev, row)
            ctx_w = Context.new(req())
            s_wire = await decode.generate_external(ctx_w)
            raw = blob.tobytes()
            meta = {"request_id": ctx_w.id, "dtype": "bfloat16", "shape": list(blob.shape),
                    "first_token": int(row[0]), "lp_row": [int(x) for x in row]}

            async def frames():
                yield raw[: len(raw) // 2]
                yield raw[len(raw) // 2:]

            acks = [a async for a in disagg._kv_deliver({"meta": meta}, frames(), None)]
            assert [json.loads(a)["ok"] for a in acks] == [True]
            streams = []
            for s in (s_dev, s_wire):
                toks = []
                async for item in s:
                    assert not item.is_error(), item.error_message()
                    toks += (item.data or {}).get("token_ids") or []
                streams.append(toks)
            return blob, landed, streams
        finally:
            await decode.stop()
            await prefill.stop()
            await rt.shutdown()

    blob, landed, streams = asyncio.run(asyncio.wait_for(body(), RUN_S))
    assert len(landed) == 2 and landed[0] == landed[1]
    if kv_dtype is None:
        assert landed[0] == blob.tobytes()
    else:
        q = quantize_kv_blob(blob)
        assert landed[0] == q.q.tobytes() + q.s.tobytes()
    assert streams[0] == streams[1] and len(streams[0]) == 12


@pytest.mark.parametrize("gtype", [0, 1, 30, 8, 2], ids=["F32", "F16", "BF16", "Q8_0", "Q4_0"])
def test_gguf_dequantize_on_card_equals_cpu(card, gtype):
    """``llm/gguf.py``'s dequantization on the card gives the CPU's bits:
    random blocks with finite f16 scales (Q8_0, Q4_0) and finite values
    (F32, F16, BF16), 64 rows of 4096."""
    from dynamo_tpu_torch.llm import gguf

    shape = (64, 4096)
    rs = np.random.default_rng(gtype)
    vals = rs.standard_normal(shape).astype(np.float32)
    if gtype in (8, 2):
        per, nbytes = {8: (32, 34), 2: (32, 18)}[gtype]
        blocks = rs.integers(0, 256, (vals.size // per, nbytes), dtype=np.uint8)
        scales = (rs.standard_normal(len(blocks)) * 0.01).astype(np.float16)
        blocks[:, :2] = scales.view(np.uint8).reshape(-1, 2)
        raw = blocks.tobytes()
    elif gtype == 30:
        raw = (vals.view(np.uint32) >> 16).astype(np.uint16).tobytes()
    else:
        raw = vals.astype({0: np.float32, 1: np.float16}[gtype]).tobytes()
    cpu = gguf.dequantize_ggml(raw, gtype, shape, "cpu")
    got = gguf.dequantize_ggml(raw, gtype, shape, card)
    assert got.device.type == "cuda" and got.dtype == cpu.dtype
    assert torch.equal(got.cpu().view(torch.uint8), cpu.view(torch.uint8))


# -- tensor and expert parallelism on the card ---------------------------------


def _tp_engines(card, backend, **kw):
    """A small f32 model (4 query heads, 2 kv heads, D 64: a rank of tp =
    2 holds 2/1/64) on one card, and the same weights on a tp = 2 grid:
    both ranks on this card over gloo, or one card a rank over NCCL (which
    the package refuses by name before any rank starts)."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.model import init_params
    from dynamo_tpu_torch.parallel.launch import grid_spec, leader_mesh, start_local_ranks
    from dynamo_tpu_torch.parallel.mesh import MeshConfig

    cfg = ModelConfig.tiny(head_dim=64, num_heads=4, num_kv_heads=2)
    ecfg = EngineConfig(num_pages=64, max_seq_len=256, mixed_token_budget=32, **kw)
    params = init_params(cfg, 3, card, torch.float32)
    grid = MeshConfig(tp=2)
    devices = ["cuda:0", "cuda:1"] if backend == "nccl" else ["cuda:0", "cuda:0"]
    ranks = start_local_ranks(grid, grid_spec(grid, devices, backend))
    mesh = leader_mesh(grid, ranks.spec, ranks)
    one = TorchEngine(cfg, params, ecfg, device=card)
    sharded = TorchEngine(cfg, params, ecfg, device=card, mesh=mesh, _ranks=ranks)
    return one, sharded


def _tp_requests():
    rs = np.random.default_rng(5)
    return [{"token_ids": rs.integers(1, 256, n).tolist(),
             "stop_conditions": {"max_tokens": 24}, "sampling_options": {},
             "eos_token_ids": []} for n in (70, 3, 40, 9)]


async def _tp_serve(engine, reqs, keep):
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(r):
        toks = []
        async for item in await engine.generate(Context.new(PreprocessedRequest.from_dict(r))):
            assert not item.is_error(), item.error_message()
            toks += (item.data or {}).get("token_ids") or []
        return toks

    import asyncio

    try:
        out = await asyncio.wait_for(asyncio.gather(*[one(r) for r in reqs]), RUN_S)
        keep["pools"] = engine.rank_pools()
        keep["stats"] = engine.rank_stats()
        return out
    finally:
        await engine.stop()


@pytest.mark.parametrize("kw", [{}, {"mixed_batching": False}, {"kv_dtype": "int8"}],
                         ids=["default", "classic", "int8-pool"])
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_tp_engine_on_card_equals_one_card(card, backend, kw):
    """tp = 2 on the card over gloo: the streams of one card; every rank's
    pool the one-card pool's head slice (f32 within 5e-6 of the largest
    value; int8 data within one step in at most 0.5% of the values, as
    ``chip_smoke.py`` serve-tp (a) holds them); no graph on either rank.
    NCCL (two cards) is refused by name before any rank starts: an NCCL
    engine's stop has not been shown to return."""
    import asyncio

    if backend == "nccl":
        if torch.cuda.device_count() < 2:
            pytest.skip("NCCL takes one card a rank: needs two cards")
        with pytest.raises(ValueError, match="over NCCL"):
            _tp_engines(card, backend, **kw)
        return
    one, sharded = _tp_engines(card, backend, **kw)
    reqs = _tp_requests()
    a, b = {}, {}
    want = asyncio.run(_tp_serve(one, reqs, a))
    got = asyncio.run(_tp_serve(sharded, reqs, b))
    assert got == want
    pool1 = a["pools"][0]
    for r, p in enumerate(b["pools"]):
        if isinstance(p, tuple):
            dq = (p[0][:, :, 1:].int() - pool1[0][:, :, 1:, :, r:r + 1].int()).abs()
            assert int(dq.max()) <= 1 and int((dq > 0).sum()) <= 5e-3 * dq.numel()
        else:
            want_p = pool1[:, :, 1:, :, r:r + 1]
            assert (p[:, :, 1:] - want_p).abs().max() <= 5e-6 * want_p.abs().max()
    graphs = [s["graphs"] for s in b["stats"]]
    assert all(g == {"captures": 0, "replays": 0} for g in graphs), graphs


def test_tp_refuses_more_ranks_than_cards(card):
    """``EngineConfig(tp=N)`` on the card would start one NCCL rank a card:
    with fewer cards it is refused by JAX's message, before any rank
    starts."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    n = torch.cuda.device_count() + 1
    cfg = ModelConfig.tiny(head_dim=64, num_heads=n, num_kv_heads=n)
    with pytest.raises(ValueError, match=f"mesh needs {n} devices, have {n - 1}"):
        TorchEngine.random_init(cfg, EngineConfig(num_pages=16, tp=n), device=card)
