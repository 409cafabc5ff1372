"""Engine steps: the packed unified step and its multi-step decode tail
(the default path), the rectangle unified step (``packed_ragged=False``),
and the classic separate dispatches: full and prefix-suffix prefill with
first-token sampling, and the fixed-width decode block with penalty
histograms.

The counterparts of the JAX package's ``step.py`` functions
``_packed_unified_step`` (without folded speculative verify),
``_unified_step``, ``_mixed_sample_epilogue``, ``_decode_once``,
``_packed_unified_multistep``, ``_decode_block``, ``prefill_step``,
``prefill_and_sample``, ``prefill_suffix_and_sample``,
``sample_step_packed`` and ``_prompt_penalized_logits``.  They run eagerly;
the KV pool is updated in place.  Decode state (last token, cache length,
active flag, penalty histogram) enters and leaves each call as tensors;
the pool is a tensor or the int8 pool's ``QuantKV`` pair;
the sampled rows come back packed (``sampling.pack_sampled_logprobs``) for
one host transfer per dispatch.

The device-state helpers at the end (``inject_token(s)``,
``update_lanes``, ``zero_count_rows``, ``bump_counts``,
``seed_count_rows``) are the counterparts of the JAX functions of the same
names: they update the engine's persistent decode-state tensors in place.
Those tensors carry one spare row at index B; a pad row of a scatter (the
JAX functions' ``mode="drop"`` rows) carries slot B and lands there, and
no step ever reads it.

Multi-step dispatches (the packed step's multistep tail and the decode
block) keep their decode state in the tensors they are given, updated in
place step by step, and run each step through a ``StepRunner``: eagerly
by default; the engine passes one that replays the step's CUDA graph on
the card (``graphs.py``), so the composition here is the one that serves.

Multi-step rule (the multistep tail and the decode block): every step
runs, because branching on ``active.any()`` between steps would cost a host
sync per step.  A step whose lanes are all inactive is the JAX package's
``dead_step`` by device-side selects: its row comes out all ``-1``, its KV
writes go to trash page 0 (an int8 pool's data and scales alike) and its
histogram bump is empty, so the pool ends as the JAX pool does.  Sampling
noise is a stateless hash of (lane key, position), so the extra steps draw
nothing that a later token depends on: K fused steps give the same tokens
as K single-step dispatches, for greedy and seeded lanes alike.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from . import attention as att
from .config import ModelConfig
from .kv_cache import KVPool
from .model import Params, lm_logits, transformer
from .sampling import (
    PROMPT_FLAG,
    SamplingParams,
    apply_penalties,
    pack_sampled_logprobs,
    sample_tokens,
    token_logprobs,
)

# one step's function: takes its device inputs, updates the decode state in
# place and returns its sampled rows ``[B, 2 + 2*top_n]``
StepFn = Callable[[Tuple[torch.Tensor, ...]], torch.Tensor]
# runs one step of a multi-step dispatch: ``run(kind, fn, inputs)`` returns
# ``fn``'s rows on ``inputs`` (host or device tensors); ``kind`` is
# ``"packed"`` (the packed step, ``inputs`` = its layout) or ``"step"`` (a
# decode step, no inputs)
StepRunner = Callable[[str, StepFn, Tuple[torch.Tensor, ...]], torch.Tensor]


def run_eager(kind: str, fn: StepFn, inputs: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """The default :data:`StepRunner`: the step itself, on its inputs."""
    return fn(inputs)


def _write_state(dst: Sequence[torch.Tensor], src: Sequence[torch.Tensor]) -> None:
    for d, v in zip(dst, src):
        d.copy_(v)


def _run_steps(
    num_steps: int,
    first: Callable[[], torch.Tensor],
    step: Callable[[], torch.Tensor],
) -> torch.Tensor:
    """The K-step composition: ``first()``'s rows, then ``step()``'s for
    the remaining rows, as ``packed [B, num_steps, W]``.  Each row is copied
    out before the next step runs (a graph's static output is overwritten
    by its next replay)."""
    packed = None
    for k in range(num_steps):
        row = first() if k == 0 else step()
        if packed is None:
            packed = row.new_empty((row.shape[0], num_steps, row.shape[1]))
        packed[:, k].copy_(row)
    return packed


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
    kv_pages: KVPool,  # updated in place
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
    kv_pages: KVPool,  # updated in place
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
    kv_pages: KVPool,
    tokens: torch.Tensor,  # [B] updated in place, as are seq_lens and active
    seq_lens: torch.Tensor,
    limit_lens: torch.Tensor,
    active: torch.Tensor,
    stop_ids: torch.Tensor,
    page_table: torch.Tensor,  # [B, P]; may be a column slice of a wider table
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
    run: StepRunner = run_eager,
) -> Tuple[torch.Tensor, ...]:
    """``num_steps`` decode iterations in one dispatch: step 0 is the full
    :func:`packed_unified_step`, steps 1..K-1 run :func:`decode_step_` on
    the state step 0 left (see the module docstring for the dead-step
    rule).  The layout (``t_*``, ``p_*``, ``dec_cap``, ``seg_off``, host or
    device tensors) enters step 0 as one int64 tensor.  Returns ``packed
    [B, num_steps, 2 + 2*top_n]`` (``-1`` tokens mark steps a lane was
    already inactive for) and the final state."""
    B = tokens.shape[0]
    Np = t_tokens.shape[0]
    layout = torch.cat(
        [x.long() for x in (t_tokens, t_lane, t_rel, t_dec, p_start, p_lens,
                            p_sample, p_activate, dec_cap, seg_off)]
    )

    def packed_fn(inputs: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        tt, tl, tr, td, ps, pl, psm, pa, dc, so = torch.split(inputs[0], [Np] * 4 + [B] * 6)
        row, *new = packed_unified_step(
            params, cfg, kv_pages, tokens, seq_lens, limit_lens, active, stop_ids,
            page_table.contiguous(), tt, tl, tr, td != 0, ps, pl, psm != 0,
            pa != 0, dc != 0, so, sampling, s_max, top_n, use_filters,
        )
        _write_state((tokens, seq_lens, active), new)
        return row

    def step_fn(_inputs: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        return decode_step_(
            params, cfg, kv_pages, tokens, seq_lens, limit_lens, active, stop_ids,
            page_table, sampling, top_n, use_filters,
        )

    packed = _run_steps(
        num_steps,
        lambda: run("packed", packed_fn, (layout,)),
        lambda: run("step", step_fn, ()),
    )
    return packed, tokens, seq_lens, active


def decode_step(
    params: Params,
    cfg: ModelConfig,
    kv_pages: KVPool,
    tokens: torch.Tensor,
    seq_lens: torch.Tensor,
    limit_lens: torch.Tensor,
    active: torch.Tensor,
    stop_ids: torch.Tensor,
    page_table: torch.Tensor,
    sampling: SamplingParams,
    top_n: int,
    use_filters: bool,
    counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """One decode+sample iteration of the JAX package's ``live_step`` /
    ``dead_step`` pair, chosen by device-side selects (see the module
    docstring).  With ``counts`` (the packed penalty histogram) the lanes
    sample from penalized logits and their emitted tokens bump it; the
    logprobs report the raw logits.  Returns ``(row [B, 2 + 2*top_n],
    tokens, seq_lens, active, counts)``."""
    live = active.any()  # a device scalar: no host sync
    logits = decode_once(params, cfg, kv_pages, tokens, seq_lens, page_table, live)
    logits_s = logits
    if counts is not None:
        logits_s = apply_penalties(
            logits, counts, sampling.freq, sampling.pres, sampling.rep
        )
    # seeded lanes key their noise by the position being filled
    sampled = sample_tokens(logits_s, sampling, seq_lens + 1, use_filters)
    lp, top_ids, top_lps = token_logprobs(logits, sampled, top_n)
    hit_stop = (sampled[:, None] == stop_ids).any(dim=1)
    emit = active & ~hit_stop  # stop tokens are swallowed, not emitted
    new_seq = seq_lens + emit.long()
    out = torch.where(active, sampled, -1)
    row = torch.where(live, pack_sampled_logprobs(out, lp, top_ids, top_lps), -1)
    if counts is not None:
        counts = counts.scatter_add(1, sampled[:, None], emit.to(counts.dtype)[:, None])
    return (
        row,
        torch.where(emit, sampled, tokens),
        new_seq,
        emit & (new_seq < limit_lens),
        counts,
    )


def decode_step_(
    params: Params,
    cfg: ModelConfig,
    kv_pages: KVPool,
    tokens: torch.Tensor,  # [B] updated in place, as are seq_lens and active
    seq_lens: torch.Tensor,
    limit_lens: torch.Tensor,
    active: torch.Tensor,
    stop_ids: torch.Tensor,
    page_table: torch.Tensor,  # [B, P]; may be a column slice of a wider table
    sampling: SamplingParams,
    top_n: int,
    use_filters: bool,
    counts: Optional[torch.Tensor] = None,  # updated in place when given
) -> torch.Tensor:
    """:func:`decode_step` on state tensors it updates in place: one step
    of a multi-step dispatch, the call a step's CUDA graph captures.
    Returns the step's rows ``[B, 2 + 2*top_n]``."""
    row, *new = decode_step(
        params, cfg, kv_pages, tokens, seq_lens, limit_lens, active, stop_ids,
        page_table.contiguous(), sampling, top_n, use_filters, counts,
    )
    state = (tokens, seq_lens, active) if counts is None else (tokens, seq_lens, active, counts)
    _write_state(state, new)
    return row


def decode_block(
    params: Params,
    cfg: ModelConfig,
    kv_pages: KVPool,  # updated in place
    tokens: torch.Tensor,  # [B] last committed token per lane (updated in place)
    seq_lens: torch.Tensor,  # [B] cache length (updated in place)
    limit_lens: torch.Tensor,  # [B] cache length at which a lane must stop
    active: torch.Tensor,  # [B] bool (updated in place)
    stop_ids: torch.Tensor,  # [B, E] device-checked stop tokens (-1 = pad)
    page_table: torch.Tensor,  # [B, P] (pre-grown for num_steps of growth)
    sampling: SamplingParams,
    num_steps: int,
    use_filters: bool = True,
    top_n: int = 0,
    counts: Optional[torch.Tensor] = None,  # [B, V] int32 packed histogram
    use_penalties: bool = False,
    run: StepRunner = run_eager,
) -> Tuple[torch.Tensor, ...]:
    """``num_steps`` decode+sample iterations in one dispatch (the classic
    decode block), each one :func:`decode_step_` through ``run``.  Lanes
    self-deactivate on a ``stop_ids`` token or at ``limit_lens``; the host
    replays the stop rules at commit.  Returns ``(packed [B, num_steps, 2 +
    2*top_n], tokens, seq_lens, active, counts)``, the state tensors being
    the ones given; ``-1`` tokens mark steps a lane was already inactive
    for."""
    if not use_penalties:
        counts = None

    def step_fn(_inputs: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        return decode_step_(
            params, cfg, kv_pages, tokens, seq_lens, limit_lens, active, stop_ids,
            page_table, sampling, top_n, use_filters, counts,
        )

    step = lambda: run("step", step_fn, ())  # noqa: E731
    return _run_steps(num_steps, step, step), tokens, seq_lens, active, counts


def unified_step(
    params: Params,
    cfg: ModelConfig,
    kv_pages: KVPool,  # updated in place
    tokens: torch.Tensor,  # [B] last committed token per lane
    seq_lens: torch.Tensor,  # [B] cache length (next decode write position)
    limit_lens: torch.Tensor,  # [B]
    active: torch.Tensor,  # [B] bool: decode lanes
    stop_ids: torch.Tensor,  # [B, E]
    page_table: torch.Tensor,  # [B, P] int32
    p_tokens: torch.Tensor,  # [B, S] prefill chunk tokens (0 on decode lanes)
    p_start: torch.Tensor,  # [B] chunk start position
    p_lens: torch.Tensor,  # [B] chunk length; 0 = decode / idle lane
    p_sample: torch.Tensor,  # [B] bool: final chunk -> sample first token
    p_activate: torch.Tensor,  # [B] bool: final chunk also joins decode
    sampling: SamplingParams,
    top_n: int = 0,
    use_filters: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """ONE mixed prefill+decode dispatch over the ``[B, S]`` rectangle
    (``packed_ragged=False``): decode lanes contribute row 0 (their last
    token), prefill lanes their chunk's rows.  The same epilogue as the
    packed step.  Returns ``(packed [B, 2 + 2*top_n], tokens, seq_lens,
    active)``."""
    B, S = p_tokens.shape
    is_pf = p_lens > 0
    q_lens = torch.where(is_pf, p_lens, active.long())
    base = torch.where(is_pf, p_start, seq_lens)
    toks2d = p_tokens.clone()
    toks2d[:, 0] = torch.where(is_pf, p_tokens[:, 0], tokens)
    positions = base[:, None] + torch.arange(S, device=base.device)[None, :]
    window = cfg.sliding_window or 0

    def attn_fn(q, k, v, kv, layer):
        q4, k4, v4 = (x.view(B, S, *x.shape[1:]) for x in (q, k, v))
        out = att.ragged_attention_dispatch(
            q4, k4, v4, kv, layer, page_table, base, q_lens, window
        )
        att.write_spec_kv(kv, k4, v4, page_table, base, q_lens, layer)
        return out.view(q.shape)

    hidden = transformer(
        params, cfg, toks2d.reshape(-1), positions.reshape(-1), kv_pages, attn_fn
    )
    last = torch.arange(B, device=base.device) * S + (q_lens - 1).clamp(0, S - 1)
    logits = lm_logits(params, cfg, hidden[last])  # [B, V]
    return mixed_sample_epilogue(
        logits, base, q_lens, is_pf, p_start, p_lens, p_sample, p_activate,
        tokens, seq_lens, limit_lens, active, stop_ids, sampling, top_n,
        use_filters,
    )


# ---------------------------------------------------------------------------
# classic prefill dispatches
# ---------------------------------------------------------------------------


def prompt_penalized_logits(
    logits: torch.Tensor,  # [B, V]
    tokens: torch.Tensor,  # [B, T] the tokens this dispatch carries
    seq_lens: torch.Tensor,  # [B] valid lengths
    sampling: SamplingParams,
) -> torch.Tensor:
    """Repetition-penalize first-token logits over the dispatch's own
    prompt tokens (frequency/presence are output-only: the histogram's
    output field stays 0 here).  A suffix dispatch carries only the suffix,
    so a cached prefix is not penalized for this one token; the decode
    histogram covers every later step."""
    B, T = tokens.shape
    V = logits.shape[1]
    valid = torch.arange(T, device=tokens.device)[None, :] < seq_lens[:, None]
    seen = torch.zeros((B, V), dtype=torch.int32, device=logits.device)
    seen.scatter_add_(
        1, tokens.long().clamp(0, V - 1), valid.to(torch.int32) * PROMPT_FLAG
    )
    return apply_penalties(logits, seen, sampling.freq, sampling.pres, sampling.rep)


def sample_step_packed(
    logits: torch.Tensor,  # [B, V] raw logits (the logprobs report these)
    sampling: SamplingParams,
    top_n: int,
    positions: torch.Tensor,  # [B] position identity of the sampled token
    sample_logits: Optional[torch.Tensor] = None,  # penalized logits to sample
) -> torch.Tensor:
    """Sample + logprob packing: ``[B, 2 + 2*top_n]`` int32."""
    src = logits if sample_logits is None else sample_logits
    sampled = sample_tokens(src, sampling, positions)
    lp, top_ids, top_lps = token_logprobs(logits, sampled, top_n)
    return pack_sampled_logprobs(sampled, lp, top_ids, top_lps)


def _last_row_logits(params, cfg, hidden, lens, B, T) -> torch.Tensor:
    last = torch.arange(B, device=lens.device) * T + (lens - 1).clamp(0, T - 1)
    return lm_logits(params, cfg, hidden[last])


def prefill_step(
    params: Params,
    cfg: ModelConfig,
    kv_pages: KVPool,  # updated in place
    tokens: torch.Tensor,  # [B, T] bucket-padded prompts (T a page multiple)
    seq_lens: torch.Tensor,  # [B] true prompt lengths (0 = pad lane)
    page_table: torch.Tensor,  # [B, T // page] the lanes' pages
) -> torch.Tensor:
    """Run full prompts from position 0, write their KV pages, return the
    last prompt row's logits ``[B, V]``."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).repeat(B)
    window = cfg.sliding_window or 0

    def attn_fn(q, k, v, kv, layer):
        q4, k4, v4 = (x.view(B, T, *x.shape[1:]) for x in (q, k, v))
        out = att.prefill_attention_dispatch(q4, k4, v4, seq_lens, window)
        att.write_prefill_kv(kv, k4, v4, page_table, layer)
        return out.view(q.shape)

    hidden = transformer(params, cfg, tokens.reshape(-1), positions, kv_pages, attn_fn)
    return _last_row_logits(params, cfg, hidden, seq_lens, B, T)


def prefill_and_sample(
    params: Params,
    cfg: ModelConfig,
    kv_pages: KVPool,
    tokens: torch.Tensor,
    seq_lens: torch.Tensor,
    page_table: torch.Tensor,
    sampling: SamplingParams,
    top_n: int = 0,
    use_penalties: bool = False,
) -> torch.Tensor:
    """Prefill plus first-token sampling: ``packed [B, 2 + 2*top_n]``."""
    logits = prefill_step(params, cfg, kv_pages, tokens, seq_lens, page_table)
    pen = (
        prompt_penalized_logits(logits, tokens, seq_lens, sampling)
        if use_penalties
        else None
    )
    return sample_step_packed(logits, sampling, top_n, seq_lens, pen)


def prefill_suffix_and_sample(
    params: Params,
    cfg: ModelConfig,
    kv_pages: KVPool,  # updated in place
    tokens: torch.Tensor,  # [B, T] bucket-padded suffix tokens
    offset: torch.Tensor,  # [B] cached prefix length (page-aligned)
    suffix_lens: torch.Tensor,  # [B] true suffix length
    prefix_table: torch.Tensor,  # [B, Pp] reused-prefix pages (0-padded)
    suffix_table: torch.Tensor,  # [B, T // page] pages the suffix writes into
    sampling: SamplingParams,
    top_n: int = 0,
    use_penalties: bool = False,
) -> torch.Tensor:
    """Prefix-cache restart (and each classic prefill chunk): prefill only
    the suffix, attending to the resident prefix pages; sample the first
    token.  Returns ``packed [B, 2 + 2*top_n]``."""
    B, T = tokens.shape
    positions = (offset[:, None] + torch.arange(T, device=offset.device)[None, :])
    window = cfg.sliding_window or 0

    def attn_fn(q, k, v, kv, layer):
        q4, k4, v4 = (x.view(B, T, *x.shape[1:]) for x in (q, k, v))
        out = att.prefill_prefix_attention_dispatch(
            q4, k4, v4, kv, layer, prefix_table, offset, suffix_lens, window
        )
        att.write_prefill_kv(kv, k4, v4, suffix_table, layer)
        return out.view(q.shape)

    hidden = transformer(
        params, cfg, tokens.reshape(-1), positions.reshape(-1), kv_pages, attn_fn
    )
    logits = _last_row_logits(params, cfg, hidden, suffix_lens, B, T)
    pen = (
        prompt_penalized_logits(logits, tokens, suffix_lens, sampling)
        if use_penalties
        else None
    )
    return sample_step_packed(logits, sampling, top_n, offset + suffix_lens, pen)


# ---------------------------------------------------------------------------
# device-resident decode state: in-place row updates
# ---------------------------------------------------------------------------


def inject_token(tokens: torch.Tensor, slot: int, token: torch.Tensor) -> None:
    """Write a freshly prefilled lane's first token (``token [1]``, a device
    value) into the decode token vector at ``slot``."""
    tokens[slot : slot + 1].copy_(token)


def inject_tokens(
    tokens: torch.Tensor,  # [B + 1]
    slots: torch.Tensor,  # [G] lane indices; B = pad (the spare row)
    toks: torch.Tensor,  # [G]
) -> None:
    """Batched :func:`inject_token`: one scatter for a whole prefill
    group; pad rows land in the spare row."""
    tokens.index_put_((slots.long(),), toks.to(tokens.dtype))


# the state tensors ``update_lanes`` writes, in its argument order, and the
# ``rows`` key each one takes
LANE_ROWS = (
    ("tokens", "token"), ("seq_lens", "seq_len"), ("limit_lens", "limit"),
    ("active", "active"), ("stop_ids", "stop"), ("page_table", "pages"),
    ("temperature", "temp"), ("top_p", "top_p"), ("top_k", "top_k"),
    ("key", "key"), ("seeded", "seeded"), ("freq", "freq"), ("pres", "pres"),
    ("rep", "rep"),
)


def update_lanes(
    tokens: torch.Tensor,  # [B + 1]
    seq_lens: torch.Tensor,  # [B + 1]
    limit_lens: torch.Tensor,  # [B + 1]
    active: torch.Tensor,  # [B + 1] bool
    stop_ids: torch.Tensor,  # [B + 1, E]
    page_table: torch.Tensor,  # [B + 1, P]
    temperature: torch.Tensor,  # [B + 1]
    top_p: torch.Tensor,  # [B + 1]
    top_k: torch.Tensor,  # [B + 1]
    key: torch.Tensor,  # [B + 1]
    seeded: torch.Tensor,  # [B + 1] bool
    freq: torch.Tensor,  # [B + 1]
    pres: torch.Tensor,  # [B + 1]
    rep: torch.Tensor,  # [B + 1]
    slots: torch.Tensor,  # [G] lane indices; B = pad (the spare row)
    rows: Dict[str, torch.Tensor],  # per-lane values: token [G], stop [G, E], ...
) -> None:
    """Fold G lanes' host-side state into the device-resident decode state
    in place: how batch membership changes (admission, completion,
    revival) reach the device without draining the decode pipeline.  The
    scatters run after any dispatch already queued, so those run against
    the old rows; every later dispatch sees the new ones."""
    state = (
        tokens, seq_lens, limit_lens, active, stop_ids, page_table,
        temperature, top_p, top_k, key, seeded, freq, pres, rep,
    )
    idx = (slots.long(),)
    for t, (_, row) in zip(state, LANE_ROWS):
        t.index_put_(idx, rows[row].to(t.dtype))


def zero_count_rows(counts: torch.Tensor, slots: torch.Tensor) -> None:
    """Zero the penalty histograms of re-assigned lanes (pads: spare row)."""
    counts.index_fill_(0, slots.long(), 0)


def bump_counts(
    counts: torch.Tensor,  # [B + 1, V]
    slots: torch.Tensor,  # [G] lane indices; B = pad (the spare row)
    toks: torch.Tensor,  # [G] token ids (device values fine)
) -> None:
    """Count injected first tokens into the penalty histograms: prefill
    samples never pass through the decode step's own increment."""
    one = torch.ones((), dtype=counts.dtype, device=counts.device)
    counts.index_put_(
        (slots.long(), toks.long()), one.expand(slots.shape[0]), accumulate=True
    )


def seed_count_rows(
    counts: torch.Tensor,  # [B + 1, V]
    slot: int,
    toks: torch.Tensor,  # [T] history tokens (padded: token 0, amount 0)
    amounts: torch.Tensor,  # [T] per-token increment: 1 output, PROMPT_FLAG prompt
) -> None:
    """Rebuild one lane's packed histogram from its prompt and committed
    output history (dirty flushes zero the row first)."""
    counts[slot].index_add_(0, toks.long(), amounts.to(counts.dtype))
