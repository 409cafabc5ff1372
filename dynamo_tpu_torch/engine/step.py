"""Engine steps of the main path: the packed unified step and its
multi-step decode tail.

The counterparts of the JAX package's ``step.py`` functions
``_packed_unified_step`` (without folded speculative verify),
``_mixed_sample_epilogue``, ``_decode_once`` and
``_packed_unified_multistep``.  They run eagerly; the KV pool is updated in
place.  Decode state (last token, cache length, active flag) enters and
leaves each call as tensors; the sampled rows come back packed
(``sampling.pack_sampled_logprobs``) for one host transfer per dispatch.

Multi-step rule: the tail always runs all ``num_steps - 1`` steps, because
branching on ``active.any()`` between steps would cost a host sync per
step.  A step whose lanes are all inactive is the JAX package's
``dead_step`` by device-side selects: its row comes out all ``-1`` and its
KV writes go to trash page 0, so the pool ends as the JAX pool does.
Sampling noise is a stateless hash of (lane key, position), so the extra
steps draw nothing that a later token depends on: K fused steps give the
same tokens as K single-step dispatches, for greedy and seeded lanes alike.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import attention as att
from .config import ModelConfig
from .model import Params, lm_logits, transformer
from .sampling import (
    SamplingParams,
    pack_sampled_logprobs,
    sample_tokens,
    token_logprobs,
)


def mixed_sample_epilogue(
    logits: torch.Tensor,  # [B, V] last-row logits per lane
    base: torch.Tensor,  # [B]
    q_lens: torch.Tensor,  # [B]
    is_pf: torch.Tensor,  # [B] bool
    p_start: torch.Tensor,  # [B]
    p_lens: torch.Tensor,  # [B]
    p_sample: torch.Tensor,  # [B] bool
    p_activate: torch.Tensor,  # [B] bool
    tokens: torch.Tensor,  # [B]
    seq_lens: torch.Tensor,  # [B]
    limit_lens: torch.Tensor,  # [B]
    active: torch.Tensor,  # [B] bool
    stop_ids: torch.Tensor,  # [B, E]
    sampling: SamplingParams,
    top_n: int,
    use_filters: bool,
) -> Tuple[torch.Tensor, ...]:
    """Sampling plus the device bookkeeping of one packed step: decode
    lanes replay the decode step's update (stop-token swallow, limit
    deactivation); a final prefill chunk hands its lane to decode with
    cache length = prompt length and last token = the sample."""
    sampled = sample_tokens(logits, sampling, base + q_lens, use_filters)
    lp, top_ids, top_lps = token_logprobs(logits, sampled, top_n)
    final_pf = is_pf & p_sample
    live = active | final_pf
    hit_stop = (sampled[:, None] == stop_ids).any(dim=1)
    emit = live & ~hit_stop
    new_seq = torch.where(
        final_pf, p_start + p_lens, seq_lens + (emit & ~is_pf).long()
    )
    new_active = emit & (new_seq < limit_lens) & (~final_pf | p_activate)
    new_tokens = torch.where(emit, sampled, tokens)
    out = torch.where(live, sampled, -1)
    packed = pack_sampled_logprobs(out, lp, top_ids, top_lps)
    return packed, new_tokens, new_seq, new_active


def packed_unified_step(
    params: Params,
    cfg: ModelConfig,
    kv_pages: torch.Tensor,  # updated in place
    tokens: torch.Tensor,  # [B] last committed token per lane (int64)
    seq_lens: torch.Tensor,  # [B] cache length (next decode write position)
    limit_lens: torch.Tensor,  # [B] cache length at which a lane must stop
    active: torch.Tensor,  # [B] bool: decode lanes
    stop_ids: torch.Tensor,  # [B, E] device-checked stop tokens (-1 = pad)
    page_table: torch.Tensor,  # [B, P] int32
    t_tokens: torch.Tensor,  # [Np] packed fresh tokens (prefill chunk rows)
    t_lane: torch.Tensor,  # [Np] lane per packed token (B = padding)
    t_rel: torch.Tensor,  # [Np] row index within the lane's segment
    t_dec: torch.Tensor,  # [Np] bool: row carries a decode lane's query
    p_start: torch.Tensor,  # [B] chunk start position (0 on decode lanes)
    p_lens: torch.Tensor,  # [B] chunk length; 0 = decode / idle lane
    p_sample: torch.Tensor,  # [B] bool: final chunk -> sample first token
    p_activate: torch.Tensor,  # [B] bool: final chunk also joins decode
    dec_cap: torch.Tensor,  # [B] bool: a decode row was packed for the lane
    seg_off: torch.Tensor,  # [B] lane's segment offset into the packed axis
    sampling: SamplingParams,
    s_max: int,  # widest lane segment (off + s_max <= Np for live lanes)
    top_n: int = 0,
    use_filters: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """ONE mixed prefill+decode dispatch over a flat packed token axis.

    Decode lanes contribute one row whose token is the device-side last
    token; prefill lanes contribute their chunk's rows.  Attention (resident
    prefix ``< base`` plus causal fresh rows) and the token-granular KV
    scatter serve every segment alike.  Returns ``(packed [B, 2 + 2*top_n],
    tokens, seq_lens, active)``."""
    B = tokens.shape[0]
    Np = t_tokens.shape[0]
    is_pf = p_lens > 0
    q_lens = torch.where(is_pf, p_lens, (dec_cap & active).long())
    base = torch.where(is_pf, p_start, seq_lens)
    lane_c = t_lane.clamp(0, B - 1)
    tok_flat = torch.where(t_dec, tokens[lane_c], t_tokens)
    pos = base[lane_c] + t_rel
    valid = (t_lane < B) & (t_rel < q_lens[lane_c])
    positions = torch.where(valid, pos, 0)
    window = cfg.sliding_window or 0

    def attn_fn(q, k, v, kv, layer):
        out = att.packed_ragged_attention_dispatch(
            q, k, v, kv, layer, page_table, base, seg_off, q_lens, s_max, window
        )
        att.write_packed_kv(kv, k, v, page_table, t_lane, pos, valid, layer)
        return out

    hidden = transformer(params, cfg, tok_flat, positions, kv_pages, attn_fn)
    last = (seg_off + q_lens - 1).clamp(0, Np - 1)
    logits = lm_logits(params, cfg, hidden[last])  # [B, V]
    return mixed_sample_epilogue(
        logits, base, q_lens, is_pf, p_start, p_lens, p_sample, p_activate,
        tokens, seq_lens, limit_lens, active, stop_ids, sampling, top_n,
        use_filters,
    )


def decode_once(
    params: Params,
    cfg: ModelConfig,
    kv_pages: torch.Tensor,  # updated in place
    tokens: torch.Tensor,  # [B] last sampled token per lane
    seq_lens: torch.Tensor,  # [B] tokens already in cache (= new position)
    page_table: torch.Tensor,  # [B, P] int32
    write: Optional[torch.Tensor] = None,  # bool; False sends writes to page 0
) -> torch.Tensor:
    """One decode step for every lane; returns logits [B, V]."""
    positions = seq_lens
    window = cfg.sliding_window or 0

    def attn_fn(q, k, v, kv, layer):
        att.write_decode_kv(kv, k, v, page_table, positions, layer, write)
        return att.decode_attention_dispatch(
            q, kv, page_table, positions + 1, layer, window
        )

    hidden = transformer(params, cfg, tokens, positions, kv_pages, attn_fn)
    return lm_logits(params, cfg, hidden)


def packed_unified_multistep(
    params: Params,
    cfg: ModelConfig,
    kv_pages: torch.Tensor,
    tokens: torch.Tensor,
    seq_lens: torch.Tensor,
    limit_lens: torch.Tensor,
    active: torch.Tensor,
    stop_ids: torch.Tensor,
    page_table: torch.Tensor,
    t_tokens: torch.Tensor,
    t_lane: torch.Tensor,
    t_rel: torch.Tensor,
    t_dec: torch.Tensor,
    p_start: torch.Tensor,
    p_lens: torch.Tensor,
    p_sample: torch.Tensor,
    p_activate: torch.Tensor,
    dec_cap: torch.Tensor,
    seg_off: torch.Tensor,
    sampling: SamplingParams,
    s_max: int,
    num_steps: int,
    top_n: int = 0,
    use_filters: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """``num_steps`` decode iterations in one dispatch: step 0 is the full
    :func:`packed_unified_step`, steps 1..K-1 run :func:`decode_once` on
    the state step 0 left (see the module docstring for the dead-step
    rule).  Returns ``packed [B, num_steps, 2 + 2*top_n]`` (``-1`` tokens
    mark steps a lane was already inactive for) and the final state."""
    packed0, tokens, seq_lens, active = packed_unified_step(
        params, cfg, kv_pages, tokens, seq_lens, limit_lens, active, stop_ids,
        page_table, t_tokens, t_lane, t_rel, t_dec, p_start, p_lens, p_sample,
        p_activate, dec_cap, seg_off, sampling, s_max, top_n, use_filters,
    )
    rows = [packed0]
    for _ in range(num_steps - 1):
        live = active.any()  # a device scalar: no host sync
        logits = decode_once(
            params, cfg, kv_pages, tokens, seq_lens, page_table, live
        )
        sampled = sample_tokens(logits, sampling, seq_lens + 1, use_filters)
        lp, top_ids, top_lps = token_logprobs(logits, sampled, top_n)
        hit_stop = (sampled[:, None] == stop_ids).any(dim=1)
        emit = active & ~hit_stop
        new_seq = seq_lens + emit.long()
        out = torch.where(active, sampled, -1)
        row = pack_sampled_logprobs(out, lp, top_ids, top_lps)
        rows.append(torch.where(live, row, -1))
        active = emit & (new_seq < limit_lens)
        tokens = torch.where(emit, sampled, tokens)
        seq_lens = new_seq
    return torch.stack(rows, dim=1), tokens, seq_lens, active
