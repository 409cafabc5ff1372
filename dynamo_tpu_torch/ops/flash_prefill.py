"""Flash prefill attention, full and prefix-suffix: the CUDA kernels'
wrappers and their plain versions.

Replaces the TPU Pallas kernels ``flash_prefill_attention``
(``dynamo_tpu/ops/flash_prefill.py:125``) and
``flash_prefix_prefill_attention`` (:311).  Both are hand-written CUDA C++
for ``sm_90a``: two C entries of ``csrc/flash_prefill.cu``, each of which
launches the bf16 tensor-core kernel (``csrc/flash_prefill_tc.cuh``) for
bf16 operands and the CUDA-core kernel over the CTA routine the ragged
kernels share (``csrc/attention_tile.cuh``) for f32 operands; the source
comments say what bounds them on the card and how the design answers.

Full prefill: lane b's prompt starts at position 0; query row i attends to
keys ``j <= i`` with ``j < seq_lens[b]`` and, with a window, ``i - j <
window``.  Prefix-suffix prefill: suffix row i sits at absolute position
``offset[b] + i`` over ``[gathered prefix | fresh suffix]`` (``k_cat``
``[B, Kp + T, Hkv, D]``); prefix key p is valid while ``p < offset[b]``,
suffix key j while ``j <= i`` and ``j < suffix_lens[b]``, the window on
absolute positions.  Rows at or past the lane's valid length come out as
zeros (the Pallas kernels compute them; nothing reads them): the kernels
write those zeros themselves, so the wrappers allocate the output
uninitialised.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors -- on the tensors' device alone, with no switch and
no fallback.
"""

from __future__ import annotations

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
from .ragged_attention import lane_attention_plain

KERNEL = CudaKernel(
    "flash_prefill_attention", [P] * 5 + [I] * 7 + [P], source="flash_prefill"
)
PREFIX_KERNEL = CudaKernel(
    "flash_prefix_prefill_attention", [P] * 6 + [I] * 8 + [P], source="flash_prefill"
)


def flash_prefix_prefill_attention_plain(
    q: torch.Tensor,  # [B, T, Hq, D] suffix queries
    k_cat: torch.Tensor,  # [B, Kp + T, Hkv, D] [gathered prefix | suffix keys]
    v_cat: torch.Tensor,  # [B, Kp + T, Hkv, D]
    offset: torch.Tensor,  # [B] cached prefix length
    suffix_lens: torch.Tensor,  # [B] valid suffix rows
    window: int = 0,
) -> torch.Tensor:
    """Per lane: the valid prefix span and suffix rows, one masked f32
    softmax (a plain loop over lanes; it reads the lane geometry on the
    host)."""
    B, T = q.shape[:2]
    Kp = k_cat.shape[1] - T
    out = torch.zeros_like(q)
    dev = q.device
    for b, (off, n) in enumerate(zip(offset.tolist(), suffix_lens.tolist())):
        n = min(n, T)
        if n <= 0:
            continue
        off = max(off, 0)
        n_prefix = min(off, Kp)
        keys = torch.cat([k_cat[b, :n_prefix], k_cat[b, Kp : Kp + n]])
        vals = torch.cat([v_cat[b, :n_prefix], v_cat[b, Kp : Kp + n]])
        kpos = torch.cat(
            [torch.arange(n_prefix, device=dev), off + torch.arange(n, device=dev)]
        )
        qpos = off + torch.arange(n, device=dev)
        out[b, :n] = lane_attention_plain(q[b, :n], keys, vals, qpos, kpos, window)
    return out


def flash_prefill_attention_plain(
    q: torch.Tensor,  # [B, T, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,  # [B, T, Hkv, D]
    seq_lens: torch.Tensor,  # [B] valid prompt length
    window: int = 0,
) -> torch.Tensor:
    """The prefix-suffix plain version with an empty prefix."""
    return flash_prefix_prefill_attention_plain(
        q, k, v, torch.zeros_like(seq_lens), seq_lens, window
    )


def _check_prefill(q, k, v, lens_by_name) -> None:
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    check_geometry(q.device, q.dtype, Hq, Hkv, D)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_operand(name, t, q.device, q.dtype, 4)
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] < T or k.shape[3] != D:
        raise ValueError("K/V must be [B, >= T, Hkv, D] and agree")
    for name, t in lens_by_name:
        check_cuda_operand(name, t, q.device, torch.int32, 1)
        if t.shape[0] != B:
            raise ValueError(f"{name} has {t.shape[0]} lanes, expected {B}")


def flash_prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seq_lens: torch.Tensor,
    window: int = 0,
) -> torch.Tensor:
    """Causal prefill attention from position 0 (see the module docstring)."""
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(q, k, v, seq_lens, window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, T, Hq, D = q.shape
    _check_prefill(q, k, v, (("seq_lens", seq_lens),))
    if k.shape[1] != T:
        raise ValueError("K/V must be [B, T, Hkv, D]")
    out = torch.empty_like(q)
    KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), DTYPE_CODES[q.dtype], B, T, Hq, k.shape[2], D,
        int(window), stream_ptr(q),
    )
    return out


def flash_prefix_prefill_attention(
    q: torch.Tensor,
    k_cat: torch.Tensor,
    v_cat: torch.Tensor,
    offset: torch.Tensor,
    suffix_lens: torch.Tensor,
    window: int = 0,
) -> torch.Tensor:
    """Suffix prefill over a gathered prefix (see the module docstring);
    any prefix span ``Kp = k_cat.shape[1] - T`` is taken."""
    if q.device.type == "cpu":
        return flash_prefix_prefill_attention_plain(
            q, k_cat, v_cat, offset, suffix_lens, window
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, T, Hq, D = q.shape
    _check_prefill(q, k_cat, v_cat, (("offset", offset), ("suffix_lens", suffix_lens)))
    out = torch.empty_like(q)
    PREFIX_KERNEL.launch(
        q.data_ptr(), k_cat.data_ptr(), v_cat.data_ptr(), offset.data_ptr(),
        suffix_lens.data_ptr(), out.data_ptr(), DTYPE_CODES[q.dtype], B, T,
        k_cat.shape[1] - T, Hq, k_cat.shape[2], D, int(window), stream_ptr(q),
    )
    return out
