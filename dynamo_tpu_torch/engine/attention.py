"""KV writers and attention dispatch over the paged pool.

Layout: one pool ``[layers, 2, num_pages, page_size, kv_heads, head_dim]``
(``kv_cache.py``).  A request owns the pages listed in its page-table row.
Page 0 is the trash page: invalid rows, dead lanes and positions past a
lane's allocation write there, so they never corrupt live state.

The writers update the pool in place.  Every index they build is clamped
or routed to the trash page explicitly: JAX clamps out-of-range gathers and
drops out-of-range scatters silently, torch raises (CPU) or faults (CUDA).

The attention entries hand CUDA tensors to the hand-written kernels and
CPU tensors to their plain versions (``ops/``): the tensors' device decides.
Unlike the JAX package's dispatch gates, no length threshold picks between
a kernel and an XLA composition: on the card the kernel always runs.  A
pool whose dtype differs from the query's is refused (the engine never
builds one).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_prefill import flash_prefill_attention, flash_prefix_prefill_attention
from ..ops.paged_attention import paged_decode_attention
from ..ops.ragged_attention import packed_ragged_attention, ragged_paged_attention


def _scatter_rows(
    kv_pages: torch.Tensor,
    layer: int,
    ids: torch.Tensor,
    slot: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
) -> None:
    kv_pages[layer, 0, ids, slot] = k.to(kv_pages.dtype)
    kv_pages[layer, 1, ids, slot] = v.to(kv_pages.dtype)


def write_packed_kv(
    kv_pages: torch.Tensor,  # [L, 2, num_pages, page, Hkv, D]
    k: torch.Tensor,  # [Np, Hkv, D] packed fresh keys
    v: torch.Tensor,  # [Np, Hkv, D]
    page_table: torch.Tensor,  # [B, P]
    lane: torch.Tensor,  # [Np] lane per packed token (B = padding)
    pos: torch.Tensor,  # [Np] absolute position per token
    valid: torch.Tensor,  # [Np] bool (False = pad / dead row -> trash page 0)
    layer: int,
) -> None:
    """Packed token ``n`` of lane ``lane[n]`` lands at position ``pos[n]``
    through that lane's page table; invalid rows and positions past the
    table go to trash page 0."""
    page_size = kv_pages.shape[3]
    num_pages = kv_pages.shape[2]
    B, P = page_table.shape
    lane = lane.long()
    page_idx = pos // page_size
    ok = valid & (page_idx < P) & (lane < B)
    ids = page_table[lane.clamp(0, B - 1), page_idx.clamp(0, P - 1)].long()
    ok = ok & (ids >= 0) & (ids < num_pages)
    ids = torch.where(ok, ids, 0)
    slot = torch.where(ok, pos % page_size, 0)
    _scatter_rows(kv_pages, layer, ids, slot, k, v)


def write_prefill_kv(
    kv_pages: torch.Tensor,  # [L, 2, num_pages, page, Hkv, D]
    k: torch.Tensor,  # [B, T, Hkv, D] bucket-padded prompt keys
    v: torch.Tensor,
    page_table: torch.Tensor,  # [B, P] the lanes' pages from position 0
    layer: int,
) -> None:
    """Whole pages: page ``i`` of lane ``b`` takes rows ``i*page ..`` of
    its prompt (``T`` is a multiple of the page).  Pad lanes, columns past
    the table and ids outside the pool land on trash page 0."""
    B, T, Hkv, D = k.shape
    page_size = kv_pages.shape[3]
    num_pages = kv_pages.shape[2]
    n_pages = T // page_size
    w = min(n_pages, page_table.shape[1])
    ids = torch.zeros((B, n_pages), dtype=torch.long, device=k.device)
    ids[:, :w] = page_table[:, :w].long()
    ids = torch.where((ids >= 0) & (ids < num_pages), ids, 0).reshape(-1)
    kv_pages[layer, 0, ids] = k.reshape(-1, page_size, Hkv, D).to(kv_pages.dtype)
    kv_pages[layer, 1, ids] = v.reshape(-1, page_size, Hkv, D).to(kv_pages.dtype)


def write_spec_kv(
    kv_pages: torch.Tensor,  # [L, 2, num_pages, page, Hkv, D]
    k: torch.Tensor,  # [B, S, Hkv, D] column j of lane b lands at base + j
    v: torch.Tensor,
    page_table: torch.Tensor,  # [B, P]
    base: torch.Tensor,  # [B] cache length
    n_tokens: torch.Tensor,  # [B] valid columns per lane
    layer: int,
) -> None:
    """Token-granular rectangle writes: columns ``>= n_tokens`` and
    positions past the table go to trash page 0 (the packed writer over
    the rectangle's rows)."""
    B, S = k.shape[:2]
    dev = k.device
    cols = torch.arange(S, device=dev)
    lane = torch.arange(B, device=dev).repeat_interleave(S)
    pos = (base.long()[:, None] + cols[None, :]).reshape(-1)
    valid = (cols[None, :] < n_tokens.long()[:, None]).reshape(-1)
    write_packed_kv(
        kv_pages, k.flatten(0, 1), v.flatten(0, 1), page_table, lane, pos,
        valid, layer,
    )


def write_decode_kv(
    kv_pages: torch.Tensor,  # [L, 2, num_pages, page, Hkv, D]
    k: torch.Tensor,  # [B, Hkv, D] one token per lane
    v: torch.Tensor,
    page_table: torch.Tensor,  # [B, P]
    positions: torch.Tensor,  # [B] position the token lands at
    layer: int,
    write: Optional[torch.Tensor] = None,  # [] or [B] bool; False -> page 0
) -> None:
    """One token per lane.  A lane frozen at its capacity (``page_idx ==
    P``) lands on trash page 0, never clamped into its own last page, and
    so does every row ``write`` masks off."""
    page_size = kv_pages.shape[3]
    num_pages = kv_pages.shape[2]
    P = page_table.shape[1]
    page_idx = positions // page_size
    ids = page_table.gather(1, page_idx.clamp(0, P - 1)[:, None])[:, 0].long()
    ok = (page_idx < P) & (ids >= 0) & (ids < num_pages)
    if write is not None:
        ok = ok & write
    ids = torch.where(ok, ids, 0)
    slot = torch.where(ok, positions % page_size, 0)
    _scatter_rows(kv_pages, layer, ids, slot, k, v)


def _same_dtype(q: torch.Tensor, kv_pages: torch.Tensor) -> None:
    if kv_pages.dtype != q.dtype:
        raise ValueError(
            f"the pool's dtype {kv_pages.dtype} differs from the query's {q.dtype}"
        )


def decode_attention_dispatch(
    q: torch.Tensor,  # [B, Hq, D]
    kv_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, P] int32
    kv_lens: torch.Tensor,  # [B]
    layer: int,
    window: int = 0,
) -> torch.Tensor:
    _same_dtype(q, kv_pages)
    return paged_decode_attention(
        q, kv_pages, page_table, kv_lens.to(torch.int32), layer, window
    )


def packed_ragged_attention_dispatch(
    q: torch.Tensor,  # [Np, Hq, D] packed queries (lane's row i at base+i)
    k: torch.Tensor,  # [Np, Hkv, D] packed fresh keys
    v: torch.Tensor,  # [Np, Hkv, D]
    kv_pages: torch.Tensor,
    layer: int,
    page_table: torch.Tensor,  # [B, P] int32
    base: torch.Tensor,  # [B] committed cache length per lane
    seg_off: torch.Tensor,  # [B] lane's segment offset into the packed axis
    q_lens: torch.Tensor,  # [B] fresh rows per lane (0 = no segment)
    s_max: int,
    window: int = 0,
) -> torch.Tensor:
    _same_dtype(q, kv_pages)
    i32 = torch.int32
    return packed_ragged_attention(
        q, k, v, kv_pages, page_table, base.to(i32), seg_off.to(i32),
        q_lens.to(i32), s_max, layer, window,
    )


def ragged_attention_dispatch(
    q: torch.Tensor,  # [B, S, Hq, D] (lane b's row i at base[b] + i)
    k: torch.Tensor,  # [B, S, Hkv, D] fresh keys
    v: torch.Tensor,
    kv_pages: torch.Tensor,
    layer: int,
    page_table: torch.Tensor,  # [B, P] int32
    base: torch.Tensor,  # [B] committed cache length per lane
    q_lens: torch.Tensor,  # [B] fresh rows per lane (0 = idle)
    window: int = 0,
) -> torch.Tensor:
    _same_dtype(q, kv_pages)
    i32 = torch.int32
    return ragged_paged_attention(
        q, k, v, kv_pages, page_table, base.to(i32), q_lens.to(i32), layer, window
    )


def prefill_attention_dispatch(
    q: torch.Tensor,  # [B, T, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,
    seq_lens: torch.Tensor,  # [B] valid prompt length
    window: int = 0,
) -> torch.Tensor:
    return flash_prefill_attention(q, k, v, seq_lens.to(torch.int32), window)


def prefill_prefix_attention_dispatch(
    q: torch.Tensor,  # [B, T, Hq, D] suffix queries
    k: torch.Tensor,  # [B, T, Hkv, D] suffix keys
    v: torch.Tensor,
    kv_pages: torch.Tensor,
    layer: int,
    prefix_table: torch.Tensor,  # [B, Pp] reused-prefix page ids (0-padded)
    offset: torch.Tensor,  # [B] cached prefix length
    suffix_lens: torch.Tensor,  # [B] valid suffix rows
    window: int = 0,
) -> torch.Tensor:
    """Gather the prefix pages into contiguous K/V (a torch index, as the
    JAX dispatch gathers with XLA), append the suffix, run the kernel.  Any
    prefix span is taken: no padding to a key-tile multiple."""
    _same_dtype(q, kv_pages)
    B, T, Hkv, D = k.shape
    N = kv_pages.shape[2]
    ids = prefix_table.long().clamp(0, N - 1)
    kp = kv_pages[layer, 0][ids].reshape(B, -1, Hkv, D)
    vp = kv_pages[layer, 1][ids].reshape(B, -1, Hkv, D)
    i32 = torch.int32
    return flash_prefix_prefill_attention(
        q, torch.cat([kp, k], dim=1), torch.cat([vp, v], dim=1),
        offset.to(i32), suffix_lens.to(i32), window,
    )
