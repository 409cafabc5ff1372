"""Packed ragged paged attention: the CUDA kernel's wrapper and its plain
version.

Replaces the dense-pool branch of the TPU Pallas kernel
``packed_ragged_attention`` (``dynamo_tpu/ops/ragged_attention.py:527``).
The kernel is hand-written CUDA C++ for ``sm_90a`` in
``csrc/packed_ragged_attention.cu``; its source comment says what bounds it
on the card and how the design answers.

Layout: a dispatch's fresh tokens lie on one flat axis ``[Np]``; lane b's
``q_lens[b]`` rows start at ``seg_off[b]`` and sit at absolute positions
``base[b] + r``.  Row r attends to the lane's resident prefix (positions
``< base`` through its page table row) and to the lane's own fresh rows
``j <= r``; with a window, only to keys ``qpos - kpos < window``.  Rows
past ``q_len`` and pad rows come out as zeros.

``packed_ragged_attention`` launches the kernel for CUDA tensors and runs
:func:`packed_ragged_attention_plain` for CPU tensors -- on the tensors'
device alone, with no switch and no fallback.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .build import DTYPE_CODES, CudaKernel, I, P, check_cuda_operand, stream_ptr
from .paged_attention import SUPPORTED_GROUPS, SUPPORTED_HEAD_DIMS

KERNEL = CudaKernel(
    "packed_ragged_attention",
    [P] * 9 + [I] * 12 + [P],
)


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
) -> torch.Tensor:
    """Per live lane: gather the prefix pages, append the fresh rows, one
    masked f32 softmax.  A plain loop over lanes (it reads the lane
    geometry on the host)."""
    Np, Hq, D = q.shape
    L, _, N, page, Hkv, _ = kv_pages.shape
    Pw = page_table.shape[1]
    n_rep = Hq // Hkv
    layer = min(max(int(layer), 0), L - 1)
    out = torch.zeros_like(q)
    geometry = zip(base.tolist(), seg_off.tolist(), q_lens.tolist())
    for b, (bs, off, ql) in enumerate(geometry):
        if ql <= 0:
            continue
        # prefix positions past the table width are unreachable
        n_prefix = min(bs, Pw * page)
        pages = page_table[b, : -(-n_prefix // page)].long().clamp(0, N - 1)
        kp = kv_pages[layer, 0][pages].reshape(-1, Hkv, D)[:n_prefix]
        vp = kv_pages[layer, 1][pages].reshape(-1, Hkv, D)[:n_prefix]
        keys = torch.cat([kp.float(), k[off : off + ql].float()])
        vals = torch.cat([vp.float(), v[off : off + ql].float()])
        kpos = torch.cat(
            [
                torch.arange(n_prefix, device=q.device),
                bs + torch.arange(ql, device=q.device),
            ]
        )
        qpos = bs + torch.arange(ql, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        qf = q[off : off + ql].float().view(ql, Hkv, n_rep, D)
        scores = torch.einsum("qgrd,kgd->gqrk", qf, keys) / math.sqrt(D)
        scores = scores.masked_fill(~mask[None, :, None, :], float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("gqrk,kgd->qgrd", probs, vals)
        out[off : off + ql] = o.reshape(ql, Hq, D).to(q.dtype)
    return out


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
    ``kv_scales`` (the int8 pool) is not ported and raises."""
    if kv_scales is not None:
        raise NotImplementedError("the int8 pool branch is not ported")
    if q.device.type == "cpu":
        return packed_ragged_attention_plain(
            q, k, v, kv_pages, page_table, base, seg_off, q_lens, layer, window
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    Np, Hq, D = q.shape
    L, _, N, page, Hkv, _ = kv_pages.shape
    B, Pw = page_table.shape
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    if D not in SUPPORTED_HEAD_DIMS or Hq % Hkv or Hq // Hkv not in SUPPORTED_GROUPS:
        raise ValueError(f"unsupported head geometry Hq={Hq} Hkv={Hkv} D={D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_operand(name, t, q.device, q.dtype, 3)
    check_cuda_operand("kv_pages", kv_pages, q.device, q.dtype, 6)
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
    KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pages.data_ptr(),
        page_table.data_ptr(), base.data_ptr(), seg_off.data_ptr(),
        q_lens.data_ptr(), out.data_ptr(),
        DTYPE_CODES[q.dtype], B, Hq, Hkv, D, L, N, page, Pw,
        int(layer), int(window), int(s_max), stream_ptr(q),
    )
    return out
