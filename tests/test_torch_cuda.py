"""The port's hand-written CUDA kernels against their plain versions, on the
card: paged decode, packed and rectangle ragged, full and prefix-suffix
flash prefill.  Every instantiation the wrappers can launch (f32 and bf16,
head dims 64 and 128, GQA groups 2 and 4: those of the port's configs),
with and without a sliding window, at small shapes.

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

import numpy as np
import pytest
import torch

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
    with pytest.raises(NotImplementedError):
        ra.ragged_paged_attention(q, k, k, pool, table, lens, lens, kv_scales=lens)
