"""KV writers and attention dispatch over the paged pool.

Layout: one pool ``[layers, 2, num_pages, page_size, kv_heads, head_dim]``
(``kv_cache.py``).  A request owns the pages listed in its page-table row.
Page 0 is the trash page: invalid rows, dead lanes and positions past a
lane's allocation write there, so they never corrupt live state.

The writers update the pool in place.  Every index they build is clamped
or routed to the trash page explicitly: JAX clamps out-of-range gathers and
drops out-of-range scatters silently, torch raises (CPU) or faults (CUDA).

The two attention entries hand CUDA tensors to the hand-written kernels and
CPU tensors to their plain versions (``ops/``): the tensors' device decides.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.paged_attention import paged_decode_attention
from ..ops.ragged_attention import packed_ragged_attention


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


def decode_attention_dispatch(
    q: torch.Tensor,  # [B, Hq, D]
    kv_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, P] int32
    kv_lens: torch.Tensor,  # [B]
    layer: int,
    window: int = 0,
) -> torch.Tensor:
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
    i32 = torch.int32
    return packed_ragged_attention(
        q, k, v, kv_pages, page_table, base.to(i32), seg_off.to(i32),
        q_lens.to(i32), s_max, layer, window,
    )
