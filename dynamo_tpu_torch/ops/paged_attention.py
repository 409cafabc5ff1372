"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

Replaces the TPU Pallas kernel ``paged_decode_attention_v2``
(``dynamo_tpu/ops/paged_attention.py:124``).  The kernel is hand-written
CUDA C++ for ``sm_90a`` in ``csrc/paged_decode_attention.cu`` (bf16 in
``csrc/decode_tc.cuh``).  It is bound by bytes: every live K/V row is read
once for the GQA group's few query vectors.  The bf16 form spreads a
lane's positions over CTAs (grid: split, KV head, lane), so a batch of a
few long lanes still fills the card; a second kernel merges the splits'
softmax states from an f32 workspace this wrapper allocates on the
tensors' stream.  The splits follow from what the host knows -- the page
table's width, the batch, the KV heads and the card's SM count
(:func:`decode_split`) -- never from ``kv_lens``, which stay on the card:
the wrapper makes no host sync.
The bf16 form rounds the softmax weights P to bf16 before their product
with V, as the Pallas kernel does (``probs.astype(v.dtype)``); the plain
version keeps P in f32.  The f32 form runs on the CUDA cores.

``paged_decode_attention`` launches the kernel for CUDA tensors and runs
:func:`paged_decode_attention_plain` for CPU tensors -- on the tensors'
device alone, with no switch and no fallback.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

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
    "paged_decode_attention",
    [P] * 6 + [I] * 12 + [P],
)
# the fewest positions a split covers (two 64-key tiles) and the most
# splits a lane takes
MIN_SPLIT_POSITIONS = 128
MAX_SPLITS = 32


def decode_split(width: int, page: int, lane_heads: int, slots: int) -> Tuple[int, int]:
    """``(positions per split, splits)`` of the bf16 kernel for a page table
    ``width`` pages wide, ``lane_heads`` = B * Hkv CTAs a split and a card
    that holds ``slots`` CTAs at once.  As many splits as fill those slots
    were every lane as long as the table, at most :data:`MAX_SPLITS`; each
    covers a multiple of 64 positions, at least :data:`MIN_SPLIT_POSITIONS`,
    and together they reach every position of the table.  (On an H100 at
    Llama-3-8B's 8 KV heads and 8 lanes: 4 splits; at 2 lanes, 16.)"""
    reach = width * page
    want = max(1, min(MAX_SPLITS, slots // lane_heads))
    chunk = max(MIN_SPLIT_POSITIONS, -(-reach // (want * 64)) * 64)
    return chunk, -(-reach // chunk)


@functools.lru_cache(maxsize=None)
def resident_ctas(device: torch.device, D: int) -> int:
    """The bf16 kernel's CTAs at head dim ``D`` the card ``device`` holds
    at once, by the CUDA occupancy query of the built kernel (on an H100,
    by its shared memory: four an SM at D 64, 51 KB each; two at D 96,
    which keeps 128-element rows, and 128, 100 KB; one at D 256, 200 KB)."""
    with torch.cuda.device(device):
        per_sm = KERNEL.query("paged_decode_tc_ctas_per_sm", D)
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


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
    check_geometry(q.device, q.dtype, Hq, Hkv, D)
    check_cuda_operand("q", q, q.device, q.dtype, 3)
    check_cuda_operand("kv_pages", kv_pages, q.device, q.dtype, 6)
    check_cuda_operand("page_table", page_table, q.device, torch.int32, 2)
    check_cuda_operand("kv_lens", kv_lens, q.device, torch.int32, 1)
    if page_table.shape[0] != B or kv_lens.shape[0] != B or kv_pages.shape[-1] != D:
        raise ValueError("operand shapes disagree")
    Pw = page_table.shape[1]
    out = torch.empty_like(q)
    chunk, splits = decode_split(Pw, page, B * Hkv, resident_ctas(q.device, D))
    ws = None
    if q.dtype == torch.bfloat16:
        ws = torch.empty(B * Hq * splits * (D + 2), dtype=torch.float32, device=q.device)
    KERNEL.launch(
        q.data_ptr(), kv_pages.data_ptr(), page_table.data_ptr(),
        kv_lens.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
        DTYPE_CODES[q.dtype], B, Hq, Hkv, D, L, N, page, Pw,
        int(layer), int(window), chunk, stream_ptr(q),
    )
    return out
