"""The port's hand-written CUDA kernels against their plain versions, on the
card: paged decode, packed and rectangle ragged (the dense pool's entries
and the int8 pool's), full and prefix-suffix flash prefill.  Every
instantiation the wrappers can launch (f32 and bf16, head dims 64 and 128,
GQA groups 2 and 4: those of the port's configs), with and without a
sliding window, at small shapes.  The dense entries of the ragged and flash
kernels also give, bit for bit, the outputs recorded from their build
before the CTA routine's prefix sources learnt to load int8 rows
(``DENSE_DIGESTS``).

These tests need an NVIDIA card and ``nvcc``, so they carry the ``cuda``
marker and skip elsewhere.  They import no JAX (the card's machine has
none); run them there without the JAX-loading conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: in f32 the kernel and the plain version differ by the order of
their sums and by the kernel's fast exponential (``__expf``, a few ulp),
5e-5 on outputs of order one; in bf16 each side rounds its output once,
2e-2 (two bf16 ulps of values of order one).
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


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,n_rep", GEOMETRY)
def test_paged_decode_kernel_matches_plain(card, D, n_rep, dtype, window):
    kv_lens = torch.tensor([P * PAGE, 23, 1, 0, 40], dtype=torch.int32, device=card)
    B = kv_lens.shape[0]
    gen, pool, table = _setup(card, dtype, D, B, 1)
    q = torch.randn((B, HKV * n_rep, D), generator=gen, device=card).to(dtype)
    before = pa.KERNEL.launches
    got = pa.paged_decode_attention(q, pool, table, kv_lens, 1, window)
    torch.cuda.synchronize()
    assert pa.KERNEL.launches == before + 1
    want = pa.paged_decode_attention_plain(q, pool, table, kv_lens, 1, window)
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


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,n_rep", GEOMETRY)
def test_flash_prefill_kernel_matches_plain(card, D, n_rep, dtype, window):
    seq_lens = [96, 45, 1, 0]  # full bucket, short lane, one token, pad lane
    B, T = len(seq_lens), 96
    gen = torch.Generator(device=card)
    gen.manual_seed(5)

    def rand(h):
        return torch.randn((B, T, h, D), generator=gen, device=card).to(dtype)

    q, k, v = rand(HKV * n_rep), rand(HKV), rand(HKV)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device=card)
    before = fp.KERNEL.launches
    got = fp.flash_prefill_attention(q, k, v, lens, window)
    torch.cuda.synchronize()
    assert fp.KERNEL.launches == before + 1
    want = fp.flash_prefill_attention_plain(q, k, v, lens, window)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)
    for b, n in enumerate(seq_lens):
        assert not got[b, n:].any(), "rows past seq_len give zeros"


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,n_rep", GEOMETRY)
def test_flash_prefix_prefill_kernel_matches_plain(card, D, n_rep, dtype, window):
    # Kp = 37 (no tile multiple); a partial-page prefix, a full one, an
    # empty one, and a pad lane
    offset = [21, 37, 0, 8]
    suffix = [40, 3, 19, 0]
    B, T, Kp = len(offset), 48, 37
    gen = torch.Generator(device=card)
    gen.manual_seed(6)

    def rand(n, h):
        return torch.randn((B, n, h, D), generator=gen, device=card).to(dtype)

    q, k, v = rand(T, HKV * n_rep), rand(Kp + T, HKV), rand(Kp + T, HKV)
    off = torch.tensor(offset, dtype=torch.int32, device=card)
    lens = torch.tensor(suffix, dtype=torch.int32, device=card)
    before = fp.PREFIX_KERNEL.launches
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


# the outputs of the build before the prefix sources' refactor (sources of
# the parent commit, NVIDIA H100 80GB HBM3, nvcc of the CUDA toolkit on the
# card's machine); a change that alters the kernels' arithmetic on purpose
# records them anew and says why
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
    "flash-bfloat16-D128-r4-w0": "6921d4e2d3cb42b3",
    "prefix-bfloat16-D128-r4-w0": "b46feb6cd082e609",
    "packed-bfloat16-D128-r4-w0": "04008ce5cc74feb5",
    "rect-bfloat16-D128-r4-w0": "8a88ee922d3d495e",
    "flash-bfloat16-D128-r4-w7": "43ed1e623081c56e",
    "prefix-bfloat16-D128-r4-w7": "aa6ea029a1ed2e9e",
    "packed-bfloat16-D128-r4-w7": "d5ea4ab8004cf71b",
    "rect-bfloat16-D128-r4-w7": "6c2667f7e3aae6f1",
    "flash-bfloat16-D64-r2-w0": "72f947e1e7a831ae",
    "prefix-bfloat16-D64-r2-w0": "c9833f1f344a0a1a",
    "packed-bfloat16-D64-r2-w0": "5736ab0d19ef8cf6",
    "rect-bfloat16-D64-r2-w0": "67c2caf3f31ca9ae",
    "flash-bfloat16-D64-r2-w7": "8765f50c985c13d5",
    "prefix-bfloat16-D64-r2-w7": "a9cd741324e80fac",
    "packed-bfloat16-D64-r2-w7": "456965155f521eec",
    "rect-bfloat16-D64-r2-w7": "18c949ff3c3ecbc5",
}


def test_dense_entries_give_the_recorded_outputs_bit_for_bit(card):
    got = dense_digests(fp, ra, card)
    print(got)
    assert got == DENSE_DIGESTS
