"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

Replaces the TPU Pallas kernel ``paged_decode_attention_v2``
(``dynamo_tpu/ops/paged_attention.py:124``).  The kernel is hand-written
CUDA C++ for ``sm_90a`` in ``csrc/paged_decode_attention.cu``; its source
comment says what bounds it on the card (bytes) and how the design answers.

``paged_decode_attention`` launches the kernel for CUDA tensors and runs
:func:`paged_decode_attention_plain` for CPU tensors -- on the tensors'
device alone, with no switch and no fallback.
"""

from __future__ import annotations

import math

import torch

from .build import DTYPE_CODES, CudaKernel, I, P, check_cuda_operand, stream_ptr

KERNEL = CudaKernel(
    "paged_decode_attention",
    [P, P, P, P, P] + [I] * 11 + [P],
)
SUPPORTED_HEAD_DIMS = (64, 128)
SUPPORTED_GROUPS = (2, 4)  # the GQA groups of the port's configs


def paged_decode_attention_plain(
    q: torch.Tensor,  # [B, Hq, D]
    kv_pages: torch.Tensor,  # [L, 2, num_pages, page, Hkv, D]
    page_table: torch.Tensor,  # [B, P] page ids
    kv_lens: torch.Tensor,  # [B] cached positions to attend (0 = idle lane)
    layer: int = 0,
    window: int = 0,
) -> torch.Tensor:
    """Gather every table page, mask positions ``>= kv_len`` (and, with a
    window, ``< kv_len - window``), f32 scores and softmax.  Idle lanes
    (``kv_len == 0``) give zeros, as the kernels do."""
    B, Hq, D = q.shape
    L, _, N, page, Hkv, _ = kv_pages.shape
    Pw = page_table.shape[1]
    n_rep = Hq // Hkv
    layer = min(max(int(layer), 0), L - 1)
    pt = page_table.long().clamp(0, N - 1)
    k = kv_pages[layer, 0][pt].reshape(B, Pw * page, Hkv, D).float()
    v = kv_pages[layer, 1][pt].reshape(B, Pw * page, Hkv, D).float()
    qf = q.float().view(B, Hkv, n_rep, D)
    scores = torch.einsum("bgrd,bkgd->bgrk", qf, k) / math.sqrt(D)
    lens = kv_lens.long().to(q.device)
    idx = torch.arange(Pw * page, device=q.device)
    mask = idx[None, :] < lens[:, None]
    if window > 0:
        mask = mask & (idx[None, :] >= lens[:, None] - window)
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    live = (lens > 0)[:, None, None, None]
    probs = torch.softmax(torch.where(live, scores, 0.0), dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", probs, v)
    out = torch.where(live, out, 0.0)
    return out.reshape(B, Hq, D).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_lens: torch.Tensor,
    layer: int = 0,
    window: int = 0,
) -> torch.Tensor:
    """Decode attention over the paged pool (see the module docstring)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, kv_pages, page_table, kv_lens, layer, window
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, Hq, D = q.shape
    L, _, N, page, Hkv, _ = kv_pages.shape
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    if D not in SUPPORTED_HEAD_DIMS or Hq % Hkv or Hq // Hkv not in SUPPORTED_GROUPS:
        raise ValueError(f"unsupported head geometry Hq={Hq} Hkv={Hkv} D={D}")
    check_cuda_operand("q", q, q.device, q.dtype, 3)
    check_cuda_operand("kv_pages", kv_pages, q.device, q.dtype, 6)
    check_cuda_operand("page_table", page_table, q.device, torch.int32, 2)
    check_cuda_operand("kv_lens", kv_lens, q.device, torch.int32, 1)
    if page_table.shape[0] != B or kv_lens.shape[0] != B or kv_pages.shape[-1] != D:
        raise ValueError("operand shapes disagree")
    out = torch.empty_like(q)
    KERNEL.launch(
        q.data_ptr(), kv_pages.data_ptr(), page_table.data_ptr(),
        kv_lens.data_ptr(), out.data_ptr(),
        DTYPE_CODES[q.dtype], B, Hq, Hkv, D, L, N, page, page_table.shape[1],
        int(layer), int(window), stream_ptr(q),
    )
    return out
