"""Ragged paged attention, packed and rectangle layouts: the CUDA kernels'
wrappers and their plain versions.

Replaces the TPU Pallas kernels ``packed_ragged_attention``
(``dynamo_tpu/ops/ragged_attention.py:527``) and ``ragged_paged_attention``
(:205), both branches: the dense pool, and the int8 pool with its per-row
``kv_scales`` (``_dequant_block`` :58).  All four are hand-written CUDA C++
for ``sm_90a``: four C entries of ``csrc/packed_ragged_attention.cu`` over
one kernel template, whose CTA routine (``csrc/attention_tile.cuh``) the
flash prefill kernels share; the source comments say what bounds them on
the card and how the design answers.

Packed layout: a dispatch's fresh tokens lie on one flat axis ``[Np]``;
lane b's ``q_lens[b]`` rows start at ``seg_off[b]`` and sit at absolute
positions ``base[b] + r``.  Row r attends to the lane's resident prefix
(positions ``< base`` through its page table row) and to the lane's own
fresh rows ``j <= r``; with a window, only to keys ``qpos - kpos <
window``.  Rows past ``q_len`` and pad rows come out as zeros.  The
rectangle layout ``[B, S]`` is the packed axis with ``seg_off[b] = b * S``.

With ``kv_scales`` (f32 ``[L, 2, N, page]``) the pool is int8 and a prefix
row reads as ``float(q) * s`` rounded to the query's dtype, the JAX
package's dequant rule.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors -- on the tensors' device alone, with no switch and
no fallback.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .build import (
    DTYPE_CODES,
    CudaKernel,
    I,
    P,
    check_cuda_operand,
    check_geometry,
    stream_ptr,
)

KERNEL = CudaKernel(
    "packed_ragged_attention",
    [P] * 9 + [I] * 12 + [P],
)
RECT_KERNEL = CudaKernel(
    "ragged_paged_attention",
    [P] * 8 + [I] * 12 + [P],
    source="packed_ragged_attention",
)
# the int8 pool's entries: the pool's data and scales in place of the pool
INT8_KERNEL = CudaKernel(
    "packed_ragged_attention_int8",
    [P] * 10 + [I] * 12 + [P],
    source="packed_ragged_attention",
)
RECT_INT8_KERNEL = CudaKernel(
    "ragged_paged_attention_int8",
    [P] * 9 + [I] * 12 + [P],
    source="packed_ragged_attention",
)


def check_kv_scales(
    q: torch.Tensor, kv_pages: torch.Tensor, kv_scales: torch.Tensor
) -> None:
    """Refuse an int8 pool the kernels and plain versions do not take."""
    if kv_pages.dtype != torch.int8:
        raise ValueError(f"an int8 pool's data has dtype {kv_pages.dtype}")
    if kv_scales.dtype != torch.float32:
        raise ValueError(f"kv_scales has dtype {kv_scales.dtype}, expected float32")
    if kv_scales.shape != kv_pages.shape[:4]:
        raise ValueError(
            f"kv_scales has shape {tuple(kv_scales.shape)}, expected "
            f"{tuple(kv_pages.shape[:4])}"
        )
    if not kv_scales.is_contiguous():
        raise ValueError("kv_scales must be contiguous")
    if kv_pages.device != q.device or kv_scales.device != q.device:
        raise ValueError("the int8 pool must lie on the query's device")


def _prefix_rows(
    kv_pages: torch.Tensor,
    kv_scales: Optional[torch.Tensor],
    layer: int,
    side: int,
    pages: torch.Tensor,
    dtype: torch.dtype,
) -> torch.Tensor:
    """One side of a lane's prefix pages ``[n, page, Hkv, D]``, int8 rows
    dequantized to ``dtype`` by their scales."""
    rows = kv_pages[layer, side][pages]
    if kv_scales is None:
        return rows
    return (rows.float() * kv_scales[layer, side][pages][..., None, None]).to(dtype)


def lane_attention_plain(
    q: torch.Tensor,  # [n, Hq, D] one lane's query rows
    keys: torch.Tensor,  # [K, Hkv, D]
    vals: torch.Tensor,  # [K, Hkv, D]
    qpos: torch.Tensor,  # [n] absolute query positions
    kpos: torch.Tensor,  # [K] absolute key positions
    window: int = 0,
) -> torch.Tensor:
    """One lane's masked GQA attention in f32: query i sees key j when
    ``kpos[j] <= qpos[i]`` (and, with a window, ``qpos[i] - kpos[j] <
    window``); a row with no visible key gives zeros, as the kernels'."""
    n, Hq, D = q.shape
    Hkv = keys.shape[1]
    mask = kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    qf = q.float().view(n, Hkv, Hq // Hkv, D)
    scores = torch.einsum("qgrd,kgd->gqrk", qf, keys.float()) / math.sqrt(D)
    scores = scores.masked_fill(~mask[None, :, None, :], float("-inf"))
    probs = torch.nan_to_num(torch.softmax(scores, dim=-1))
    o = torch.einsum("gqrk,kgd->qgrd", probs, vals.float())
    return o.reshape(n, Hq, D).to(q.dtype)


def packed_ragged_attention_plain(
    q: torch.Tensor,  # [Np, Hq, D]
    k: torch.Tensor,  # [Np, Hkv, D] fresh keys
    v: torch.Tensor,  # [Np, Hkv, D]
    kv_pages: torch.Tensor,  # [L, 2, num_pages, page, Hkv, D]
    page_table: torch.Tensor,  # [B, P]
    base: torch.Tensor,  # [B]
    seg_off: torch.Tensor,  # [B]
    q_lens: torch.Tensor,  # [B]
    layer: int = 0,
    window: int = 0,
    kv_scales: Optional[torch.Tensor] = None,  # [L, 2, num_pages, page] f32
) -> torch.Tensor:
    """Per live lane: gather the prefix pages (dequantized with
    ``kv_scales``), append the fresh rows, one masked f32 softmax.  A plain
    loop over lanes (it reads the lane geometry on the host)."""
    Np, Hq, D = q.shape
    L, _, N, page, Hkv, _ = kv_pages.shape
    Pw = page_table.shape[1]
    layer = min(max(int(layer), 0), L - 1)
    out = torch.zeros_like(q)
    dev = q.device
    geometry = zip(base.tolist(), seg_off.tolist(), q_lens.tolist())
    for b, (bs, off, ql) in enumerate(geometry):
        if ql <= 0:
            continue
        # prefix positions past the table width are unreachable
        n_prefix = min(bs, Pw * page)
        pages = page_table[b, : -(-n_prefix // page)].long().clamp(0, N - 1)
        kp, vp = (
            _prefix_rows(kv_pages, kv_scales, layer, side, pages, q.dtype)
            .reshape(-1, Hkv, D)[:n_prefix]
            for side in (0, 1)
        )
        keys = torch.cat([kp.float(), k[off : off + ql].float()])
        vals = torch.cat([vp.float(), v[off : off + ql].float()])
        kpos = torch.cat(
            [torch.arange(n_prefix, device=dev), bs + torch.arange(ql, device=dev)]
        )
        qpos = bs + torch.arange(ql, device=dev)
        out[off : off + ql] = lane_attention_plain(
            q[off : off + ql], keys, vals, qpos, kpos, window
        )
    return out


def _cuda_pool(
    q: torch.Tensor, kv_pages: torch.Tensor, kv_scales: Optional[torch.Tensor]
) -> tuple:
    """Check the pool operands of a launch; their pointers in entry order."""
    if kv_scales is None:
        check_cuda_operand("kv_pages", kv_pages, q.device, q.dtype, 6)
        return (kv_pages.data_ptr(),)
    check_cuda_operand("kv_pages", kv_pages, q.device, torch.int8, 6)
    check_cuda_operand("kv_scales", kv_scales, q.device, torch.float32, 4)
    return kv_pages.data_ptr(), kv_scales.data_ptr()


def packed_ragged_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_pages: torch.Tensor,
    page_table: torch.Tensor,
    base: torch.Tensor,
    seg_off: torch.Tensor,
    q_lens: torch.Tensor,
    s_max: int,
    layer: int = 0,
    window: int = 0,
    kv_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Packed ragged attention (see the module docstring).  ``s_max`` is
    the widest lane segment the dispatch packed (``off + s_max <= Np``);
    ``kv_scales`` makes ``kv_pages`` the int8 pool's data."""
    if kv_scales is not None:
        check_kv_scales(q, kv_pages, kv_scales)
    if q.device.type == "cpu":
        return packed_ragged_attention_plain(
            q, k, v, kv_pages, page_table, base, seg_off, q_lens, layer, window,
            kv_scales,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    Np, Hq, D = q.shape
    L, _, N, page, Hkv, _ = kv_pages.shape
    B, Pw = page_table.shape
    check_geometry(q.device, q.dtype, Hq, Hkv, D)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_operand(name, t, q.device, q.dtype, 3)
    pool = _cuda_pool(q, kv_pages, kv_scales)
    check_cuda_operand("page_table", page_table, q.device, torch.int32, 2)
    for name, t in (("base", base), ("seg_off", seg_off), ("q_lens", q_lens)):
        check_cuda_operand(name, t, q.device, torch.int32, 1)
        if t.shape[0] != B:
            raise ValueError(f"{name} has {t.shape[0]} lanes, expected {B}")
    if k.shape != (Np, Hkv, D) or v.shape != (Np, Hkv, D):
        raise ValueError("fresh K/V must be [Np, Hkv, D]")
    if not 0 < s_max <= Np:
        raise ValueError(f"s_max={s_max} outside (0, Np={Np}]")
    out = torch.zeros_like(q)
    (KERNEL if kv_scales is None else INT8_KERNEL).launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *pool,
        page_table.data_ptr(), base.data_ptr(), seg_off.data_ptr(),
        q_lens.data_ptr(), out.data_ptr(),
        DTYPE_CODES[q.dtype], B, Hq, Hkv, D, L, N, page, Pw,
        int(layer), int(window), int(s_max), stream_ptr(q),
    )
    return out


def ragged_paged_attention_plain(
    q: torch.Tensor,  # [B, S, Hq, D]
    k: torch.Tensor,  # [B, S, Hkv, D] fresh keys
    v: torch.Tensor,  # [B, S, Hkv, D]
    kv_pages: torch.Tensor,  # [L, 2, num_pages, page, Hkv, D]
    page_table: torch.Tensor,  # [B, P]
    base: torch.Tensor,  # [B]
    q_lens: torch.Tensor,  # [B]
    layer: int = 0,
    window: int = 0,
    kv_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The packed plain version over the rectangle's rows
    (``seg_off[b] = b * S``); rows past ``min(q_len, S)`` give zeros."""
    B, S = q.shape[:2]
    seg_off = torch.arange(B, device=q.device) * S
    out = packed_ragged_attention_plain(
        q.flatten(0, 1), k.flatten(0, 1), v.flatten(0, 1), kv_pages,
        page_table, base, seg_off, q_lens.clamp(max=S), layer, window,
        kv_scales,
    )
    return out.view(q.shape)


def ragged_paged_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_pages: torch.Tensor,
    page_table: torch.Tensor,
    base: torch.Tensor,
    q_lens: torch.Tensor,
    layer: int = 0,
    window: int = 0,
    kv_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Rectangle ragged attention (see the module docstring); ``kv_scales``
    makes ``kv_pages`` the int8 pool's data."""
    if kv_scales is not None:
        check_kv_scales(q, kv_pages, kv_scales)
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(
            q, k, v, kv_pages, page_table, base, q_lens, layer, window, kv_scales
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, S, Hq, D = q.shape
    L, _, N, page, Hkv, _ = kv_pages.shape
    Pw = page_table.shape[1]
    check_geometry(q.device, q.dtype, Hq, Hkv, D)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_operand(name, t, q.device, q.dtype, 4)
    pool = _cuda_pool(q, kv_pages, kv_scales)
    check_cuda_operand("page_table", page_table, q.device, torch.int32, 2)
    for name, t in (("base", base), ("q_lens", q_lens)):
        check_cuda_operand(name, t, q.device, torch.int32, 1)
    if base.shape[0] != B or q_lens.shape[0] != B or page_table.shape[0] != B:
        raise ValueError("lane operands disagree with the batch")
    if k.shape != (B, S, Hkv, D) or v.shape != (B, S, Hkv, D):
        raise ValueError("fresh K/V must be [B, S, Hkv, D]")
    out = torch.zeros_like(q)
    (RECT_KERNEL if kv_scales is None else RECT_INT8_KERNEL).launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *pool,
        page_table.data_ptr(), base.data_ptr(), q_lens.data_ptr(),
        out.data_ptr(), DTYPE_CODES[q.dtype], B, S, Hq, Hkv, D, L, N, page,
        Pw, int(layer), int(window), stream_ptr(q),
    )
    return out
