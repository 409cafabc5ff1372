"""Token sampling: batched, per-request parameters as tensors.

Greedy (temperature <= 0), temperature, top-k and top-p run as one
vectorized program over the batch, as in the JAX package.

Randomness is a stateless counter hash, computed with integer tensor ops on
the logits' device -- no generator state and no global RNG.  A lane's
Gumbel noise is a pure function of (lane key, position, vocab index):
seeded lanes key on the request's seed, unseeded lanes on a per-request
nonce the engine assigns at admission.  So a lane's tokens never depend on
its batchmates, on block boundaries, or on how many steps a dispatch fuses.
The JAX package draws its noise from threefry, so only greedy lanes agree
token for token across the two packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

_NEG_INF = -1e30
_MASK32 = 0xFFFFFFFF
# domain tags keep seeded and nonce-keyed streams apart
_SEEDED = 0x5EED5EED
_UNSEEDED = 0x0DDBA11


@dataclass
class SamplingParams:
    """Per-lane sampling settings as tensors on the step's device."""

    temperature: torch.Tensor  # [B] f32; <= 0 means greedy
    top_p: torch.Tensor  # [B] f32 in (0, 1]; 1 disables
    top_k: torch.Tensor  # [B] int64; 0 disables
    # [B] int64 lane key in [0, 2^32): the request's seed (seeded lanes,
    # 1..2^32-1) or its engine nonce (unseeded lanes)
    key: torch.Tensor
    seeded: torch.Tensor  # [B] bool


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 tensors holding values in [0, 2^32),
    in 16-bit halves so no intermediate overflows int64."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finalizer (lowbias32) on int64 tensors holding
    values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def lane_gumbel(
    params: SamplingParams, positions: torch.Tensor, vocab: int
) -> torch.Tensor:
    """[B, V] Gumbel noise, a pure function of (lane key, position, v)."""
    dev = positions.device
    tag = torch.where(params.seeded, _SEEDED, _UNSEEDED).to(dev)
    k = _mix32(params.key.to(dev) ^ tag)
    k = _mix32(k ^ _mix32(positions.long() & _MASK32))  # [B]
    v = _mix32(torch.arange(vocab, device=dev, dtype=torch.int64))  # [V]
    h = _mix32(k[:, None] ^ v[None, :])
    u = ((h >> 8).float() + 0.5) / float(1 << 24)  # (0, 1), exact in f32
    return -torch.log(-torch.log(u))


def sample_tokens(
    logits: torch.Tensor,  # [B, V] f32
    params: SamplingParams,
    positions: torch.Tensor,  # [B] position identity of the sampled token
    use_filters: bool = True,
) -> torch.Tensor:
    """Sampled token ids [B] int64.  ``use_filters=False`` drops the sort
    when no live request asked for top-k/top-p; the filtered variant is
    numerically identical for requests without filters."""
    B, V = logits.shape
    greedy = torch.argmax(logits, dim=-1)
    temp = torch.clamp(params.temperature, min=1e-6)[:, None]
    scaled = logits / temp
    gumbel = lane_gumbel(params, positions, V)
    if use_filters:
        # one descending sort serves both top-k and top-p
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        k = torch.where(params.top_k > 0, params.top_k, V)
        kth = sorted_logits.gather(1, (torch.clamp(k, max=V) - 1)[:, None])
        masked = torch.where(scaled >= kth, scaled, _NEG_INF)
        probs_sorted = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs_sorted, dim=-1)
        keep_sorted = (cum - probs_sorted) < params.top_p[:, None]
        thresh = torch.where(keep_sorted, sorted_logits, float("inf")).amin(
            dim=-1, keepdim=True
        )
        scaled = torch.where(scaled >= thresh, masked, _NEG_INF)
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(params.temperature <= 0.0, greedy, sampled)


def token_logprobs(
    logits: torch.Tensor,  # [B, V] f32
    sampled: torch.Tensor,  # [B]
    top_n: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(chosen_lp [B], top_ids [B, N], top_lps [B, N]) of the raw model
    distribution (log-softmax of the unscaled logits)."""
    logp = torch.log_softmax(logits, dim=-1)
    chosen = logp.gather(1, sampled.long()[:, None])[:, 0]
    if top_n <= 0:
        B = logits.shape[0]
        empty = torch.zeros((B, 0), dtype=torch.float32, device=logits.device)
        return chosen, empty.to(torch.int32), empty
    top_lps, top_ids = torch.topk(logp, top_n, dim=-1)
    return chosen, top_ids.to(torch.int32), top_lps


def pack_sampled_logprobs(
    sampled: torch.Tensor,  # [B]
    chosen_lp: torch.Tensor,  # [B] f32
    top_ids: torch.Tensor,  # [B, N] int32
    top_lps: torch.Tensor,  # [B, N] f32
) -> torch.Tensor:
    """One int32 array ``[B, 2 + 2N]`` (token | logprob bits | top ids |
    top logprob bits): the host fetches a single array per commit."""
    lp_bits = chosen_lp.float().contiguous().view(torch.int32)
    top_bits = top_lps.float().contiguous().view(torch.int32)
    return torch.cat(
        [sampled.to(torch.int32)[:, None], lp_bits[:, None], top_ids, top_bits],
        dim=-1,
    )


def unpack_sampled_logprobs(packed, top_n: int):
    """Host-side inverse of :func:`pack_sampled_logprobs` (numpy): returns
    (tokens [...], lps [...], top_ids [..., N], top_lps [..., N])."""
    arr = np.asarray(packed)
    tokens = arr[..., 0]
    lps = arr[..., 1].view(np.float32) if arr.size else arr[..., 1].astype(np.float32)
    top_ids = arr[..., 2 : 2 + top_n]
    top_lps = (
        arr[..., 2 + top_n : 2 + 2 * top_n].view(np.float32)
        if arr.size
        else arr[..., 2 + top_n :].astype(np.float32)
    )
    return tokens, lps, top_ids, top_lps
