"""Engine steps: the packed unified step and its multi-step decode tail
(the default path; speculating lanes' verify columns fold into it), the
rectangle unified step (``packed_ragged=False``), and the classic separate
dispatches: full and prefix-suffix prefill with first-token sampling, the
fixed-width decode block with penalty histograms and the standalone
speculative verify; and the engine's other callers of the full flash
prefill: prompt scoring (echo+logprobs), the multimodal soft-prompt
prefill and the pooled embedding forward.

The counterparts of the JAX package's ``step.py`` functions
``_packed_unified_step``, ``_spec_columns_epilogue``, ``_unified_step``,
``_mixed_sample_epilogue``, ``_decode_once``,
``_packed_unified_multistep``, ``_decode_block``, ``_verify_and_sample``,
``prefill_step``, ``prefill_and_sample``, ``prefill_mm_and_sample``,
``prefill_suffix_and_sample``, ``score_prompt_step``, ``embed_step``,
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
The page copy steps (``gather_block_pages``, ``scatter_block_pages``,
``gather_layer_pages``, ``scatter_layer_pages``; XLA gathers and donated
scatters in the JAX package) serve the offload tiers and swap records: the
gathers return new tensors, the scatters write the pool in place, pad ids
landing on trash page 0, so the pool keeps its address.
Those tensors carry one spare row at index B; a pad row of a scatter (the
JAX functions' ``mode="drop"`` rows) carries slot B and lands there, and
no step ever reads it.

Every trunk pass goes through :func:`run_trunk` (its attention variant
named, from ``ATTN_KINDS``) and every head projection through
:func:`logits_at`: the seam a tensor-parallel leader mirrors to its
follower ranks (``parallel/sharding.py``).

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

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import attention as att
from .config import ModelConfig
from .kv_cache import KVPool, QuantKV
from .model import Params, lm_logits, mesh_of, transformer
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


# -- the trunk seam -------------------------------------------------------------
#
# Every trunk call names its attention variant and hands over the integer
# tensors and Python ints the variant's callback closes over; on a
# tensor-parallel leader (``params.mirror``) the call is sent to the
# follower ranks first, which rebuild the same callback from the same
# inputs (``parallel/sharding.py``).  ``mesh`` is the rank's mesh (an int8
# pool's row scales reduce over it), None on one card.


def _attn_packed(tensors, statics, mesh):
    page_table, base, seg_off, q_lens, t_lane, pos, valid = tensors
    s_max, window = statics

    def attn_fn(q, k, v, kv, layer):
        out = att.packed_ragged_attention_dispatch(
            q, k, v, kv, layer, page_table, base, seg_off, q_lens, s_max, window
        )
        att.write_packed_kv(kv, k, v, page_table, t_lane, pos, valid, layer, mesh)
        return out

    return attn_fn


def _attn_decode(tensors, statics, mesh):
    page_table, positions, write = tensors
    (window,) = statics

    def attn_fn(q, k, v, kv, layer):
        att.write_decode_kv(kv, k, v, page_table, positions, layer, write, mesh)
        return att.decode_attention_dispatch(
            q, kv, page_table, positions + 1, layer, window
        )

    return attn_fn


def _attn_rect(tensors, statics, mesh):
    page_table, base, q_lens = tensors
    B, S, window = statics

    def attn_fn(q, k, v, kv, layer):
        q4, k4, v4 = (x.view(B, S, *x.shape[1:]) for x in (q, k, v))
        out = att.ragged_attention_dispatch(
            q4, k4, v4, kv, layer, page_table, base, q_lens, window
        )
        att.write_spec_kv(kv, k4, v4, page_table, base, q_lens, layer, mesh)
        return out.view(q.shape)

    return attn_fn


def _attn_prefill(tensors, statics, mesh):
    seq_lens, page_table = tensors
    B, T, window = statics

    def attn_fn(q, k, v, kv, layer):
        q4, k4, v4 = (x.view(B, T, *x.shape[1:]) for x in (q, k, v))
        out = att.prefill_attention_dispatch(q4, k4, v4, seq_lens, window)
        if page_table is not None:
            att.write_prefill_kv(kv, k4, v4, page_table, layer, mesh)
        return out.view(q.shape)

    return attn_fn


def _attn_suffix(tensors, statics, mesh):
    prefix_table, offset, suffix_lens, suffix_table = tensors
    B, T, window = statics

    def attn_fn(q, k, v, kv, layer):
        q4, k4, v4 = (x.view(B, T, *x.shape[1:]) for x in (q, k, v))
        out = att.prefill_prefix_attention_dispatch(
            q4, k4, v4, kv, layer, prefix_table, offset, suffix_lens, window
        )
        att.write_prefill_kv(kv, k4, v4, suffix_table, layer, mesh)
        return out.view(q.shape)

    return attn_fn


def _attn_verify(tensors, statics, mesh):
    page_table, base, n_tokens = tensors
    B, S, window = statics

    def attn_fn(q, k, v, kv, layer):
        q4, k4, v4 = (x.view(B, S, *x.shape[1:]) for x in (q, k, v))
        out = att.prefill_prefix_attention_dispatch(
            q4, k4, v4, kv, layer, page_table, base, n_tokens, window
        )
        att.write_spec_kv(kv, k4, v4, page_table, base, n_tokens, layer, mesh)
        return out.view(q.shape)

    return attn_fn


ATTN_KINDS = {
    "packed": _attn_packed, "decode": _attn_decode, "rect": _attn_rect,
    "prefill": _attn_prefill, "suffix": _attn_suffix, "verify": _attn_verify,
}


def run_trunk(
    params: Params,
    cfg: ModelConfig,
    kv_pages: KVPool,
    kind: str,
    tokens: torch.Tensor,  # [T]
    positions: torch.Tensor,  # [T]
    tensors: Sequence[Optional[torch.Tensor]],
    statics: Sequence[int],
    mm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """The trunk over a flat token axis with attention variant ``kind``
    (``ATTN_KINDS``) built from ``tensors`` and ``statics``; returns hidden
    ``[T, H]`` and writes ``kv_pages`` in place."""
    mirror = getattr(params, "mirror", None)
    if mirror is not None:
        mirror.trunk(kind, tokens, positions, tensors, statics, mm)
    attn_fn = ATTN_KINDS[kind](tensors, statics, mesh_of(params))
    return transformer(params, cfg, tokens, positions, kv_pages, attn_fn, mm)


def logits_at(
    params: Params, cfg: ModelConfig, hidden: torch.Tensor, idx: Optional[torch.Tensor]
) -> torch.Tensor:
    """f32 logits of the last trunk's rows ``idx`` (all of them when
    None); on a tensor-parallel leader the followers project the same rows
    through their slices of the head."""
    mirror = getattr(params, "mirror", None)
    if mirror is not None:
        mirror.logits(idx)
    return lm_logits(params, cfg, hidden if idx is None else hidden[idx])


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
    v_lens: Optional[torch.Tensor] = None,  # [B] verify columns (0 = none)
    s_spec: int = 0,  # verify column width; 0 = a spec-free dispatch
) -> Tuple[torch.Tensor, ...]:
    """ONE mixed prefill+decode dispatch over a flat packed token axis.

    Decode lanes contribute one row whose token is the device-side last
    token; prefill lanes contribute their chunk's rows.  Attention (resident
    prefix ``< base`` plus causal fresh rows) and the token-granular KV
    scatter serve every segment alike.

    Folded speculative verify: a speculating lane (``v_lens > 0``)
    contributes ``1 + draft`` rows -- its last committed token, then the
    host-proposed drafts, in ``t_tokens`` -- at ``base = p_start`` (the
    committed cache length: the host mirrors are authoritative for it, as
    in :func:`verify_and_sample`).  Its rows take the same attention and
    KV writes as every other segment, and their per-column target samples
    come from :func:`spec_columns_epilogue`; the single-row epilogue
    passes the lane by (device-inactive, no chunk).  With ``s_spec == 0``
    the step is exactly the spec-free one.

    Returns ``(packed [B, 2 + 2*top_n], tokens, seq_lens, active,
    spec_packed [B, s_spec, 2 + 2*top_n])``."""
    B = tokens.shape[0]
    Np = t_tokens.shape[0]
    is_pf = p_lens > 0
    if s_spec > 0:
        is_sp = v_lens > 0
        q_lens = torch.where(
            is_pf, p_lens, torch.where(is_sp, v_lens, (dec_cap & active).long())
        )
        base = torch.where(is_pf | is_sp, p_start, seq_lens)
    else:
        q_lens = torch.where(is_pf, p_lens, (dec_cap & active).long())
        base = torch.where(is_pf, p_start, seq_lens)
    lane_c = t_lane.clamp(0, B - 1)
    tok_flat = torch.where(t_dec, tokens[lane_c], t_tokens)
    pos = base[lane_c] + t_rel
    valid = (t_lane < B) & (t_rel < q_lens[lane_c])
    positions = torch.where(valid, pos, 0)
    window = cfg.sliding_window or 0
    hidden = run_trunk(
        params, cfg, kv_pages, "packed", tok_flat, positions,
        (page_table, base, seg_off, q_lens, t_lane, pos, valid), (s_max, window),
    )
    if s_spec > 0:
        spec_packed = spec_columns_epilogue(
            params, cfg, hidden, base, seg_off, v_lens, sampling, s_spec, top_n,
            use_filters,
        )
    else:
        spec_packed = torch.zeros(
            (B, 0, 2 + 2 * top_n), dtype=torch.int32, device=hidden.device
        )
    last = (seg_off + q_lens - 1).clamp(0, Np - 1)
    logits = logits_at(params, cfg, hidden, last)  # [B, V]
    return mixed_sample_epilogue(
        logits, base, q_lens, is_pf, p_start, p_lens, p_sample, p_activate,
        tokens, seq_lens, limit_lens, active, stop_ids, sampling, top_n,
        use_filters,
    ) + (spec_packed,)


def _tile_sampling(sampling: SamplingParams, n: int) -> SamplingParams:
    """Each lane's sampling settings repeated for its ``n`` columns."""
    return dataclasses.replace(
        sampling,
        **{
            f.name: getattr(sampling, f.name).repeat_interleave(n, 0)
            for f in dataclasses.fields(sampling)
            if getattr(sampling, f.name) is not None
        },
    )


def spec_columns_epilogue(
    params: Params,
    cfg: ModelConfig,
    hidden: torch.Tensor,  # [Np, H] packed trunk output
    base: torch.Tensor,  # [B] committed cache length per lane
    seg_off: torch.Tensor,  # [B] lane's segment offset into the packed axis
    v_lens: torch.Tensor,  # [B] verify columns per lane (0 = not speculating)
    sampling: SamplingParams,
    s_spec: int,  # column width (1 + pow2(draft), budget-merged)
    top_n: int,
    use_filters: bool,
) -> torch.Tensor:
    """Folded-verify sampling: the per-column half of
    :func:`verify_and_sample` over the packed layout.  Column ``j`` of a
    speculating lane is packed row ``seg_off + j`` (its KV landed at ``base
    + j``) and samples the token for position ``base + j + 1``, the decode
    step's position keying, so greedy and seeded lanes give the tokens of
    plain decode.  All ``B x s_spec`` columns sample in one call; columns
    past ``v_lens`` (and non-speculating lanes) report token ``-1``.
    Returns ``packed [B, s_spec, 2 + 2*top_n]``."""
    B = base.shape[0]
    Np = hidden.shape[0]
    cols = torch.arange(s_spec, device=hidden.device)
    idx = (seg_off[:, None] + cols[None, :]).clamp(0, Np - 1)
    logits = logits_at(params, cfg, hidden, idx.reshape(-1))  # [B * S, V]
    positions = (base[:, None] + 1 + cols[None, :]).reshape(-1)
    sampled = sample_tokens(
        logits, _tile_sampling(sampling, s_spec), positions, use_filters
    )
    lp, top_ids, top_lps = token_logprobs(logits, sampled, top_n)
    valid = (cols[None, :] < v_lens[:, None]).reshape(-1)
    out = torch.where(valid, sampled, -1)
    return pack_sampled_logprobs(out, lp, top_ids, top_lps).view(B, s_spec, -1)


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
    hidden = run_trunk(
        params, cfg, kv_pages, "decode", tokens, positions,
        (page_table, positions, write), (cfg.sliding_window or 0,),
    )
    return logits_at(params, cfg, hidden, None)


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
    v_lens: Optional[torch.Tensor] = None,
    s_spec: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """``num_steps`` decode iterations in one dispatch: step 0 is the full
    :func:`packed_unified_step`, steps 1..K-1 run :func:`decode_step_` on
    the state step 0 left (see the module docstring for the dead-step
    rule).  The layout (``t_*``, ``p_*``, ``dec_cap``, ``seg_off`` and,
    with verify columns, ``v_lens``; host or device tensors) enters step 0
    as one int64 tensor.  A dispatch with verify columns (``s_spec > 0``)
    must run its packed step eagerly: the columns come out of that run.
    Returns ``packed [B, num_steps, 2 + 2*top_n]`` (``-1`` tokens mark
    steps a lane was already inactive for), the final state and the
    verify columns ``[B, s_spec, 2 + 2*top_n]``."""
    B = tokens.shape[0]
    Np = t_tokens.shape[0]
    parts = [t_tokens, t_lane, t_rel, t_dec, p_start, p_lens, p_sample, p_activate,
             dec_cap, seg_off] + ([v_lens] if s_spec else [])
    layout = torch.cat([x.long() for x in parts])
    spec_cols: List[torch.Tensor] = []

    def packed_fn(inputs: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        tt, tl, tr, td, ps, pl, psm, pa, dc, so, *vl = torch.split(
            inputs[0], [Np] * 4 + [B] * (len(parts) - 4)
        )
        row, *new, spec = packed_unified_step(
            params, cfg, kv_pages, tokens, seq_lens, limit_lens, active, stop_ids,
            page_table.contiguous(), tt, tl, tr, td != 0, ps, pl, psm != 0,
            pa != 0, dc != 0, so, sampling, s_max, top_n, use_filters,
            vl[0] if vl else None, s_spec,
        )
        _write_state((tokens, seq_lens, active), new)
        spec_cols.append(spec)
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
    if s_spec and len(spec_cols) != 1:
        raise RuntimeError("a dispatch with verify columns must run its packed step eagerly")
    spec_packed = (
        spec_cols[0]
        if s_spec
        else torch.zeros((B, 0, packed.shape[-1]), dtype=packed.dtype, device=packed.device)
    )
    return packed, tokens, seq_lens, active, spec_packed


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
    hidden = run_trunk(
        params, cfg, kv_pages, "rect", toks2d.reshape(-1), positions.reshape(-1),
        (page_table, base, q_lens), (B, S, cfg.sliding_window or 0),
    )
    last = torch.arange(B, device=base.device) * S + (q_lens - 1).clamp(0, S - 1)
    logits = logits_at(params, cfg, hidden, last)  # [B, V]
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
    return logits_at(params, cfg, hidden, last)


def _prefill_hidden(
    params: Params,
    cfg: ModelConfig,
    kv_pages: KVPool,  # updated in place unless page_table is None
    tokens: torch.Tensor,  # [B, T] bucket-padded prompts (T a page multiple)
    seq_lens: torch.Tensor,  # [B] true prompt lengths (0 = pad lane)
    page_table: Optional[torch.Tensor],  # [B, T // page]; None: no KV writes
    mm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # soft prompt
) -> torch.Tensor:
    """The trunk over full prompts from position 0 through the full flash
    prefill (``mm``: with the soft prompt injected, see
    ``model.transformer``), writing their KV pages unless ``page_table`` is
    None; returns the hidden rows ``[B * T, H]``."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).repeat(B)
    return run_trunk(
        params, cfg, kv_pages, "prefill", tokens.reshape(-1), positions,
        (seq_lens, page_table), (B, T, cfg.sliding_window or 0), mm,
    )


def prefill_step(
    params: Params,
    cfg: ModelConfig,
    kv_pages: KVPool,  # updated in place
    tokens: torch.Tensor,  # [B, T] bucket-padded prompts (T a page multiple)
    seq_lens: torch.Tensor,  # [B] true prompt lengths (0 = pad lane)
    page_table: torch.Tensor,  # [B, T // page] the lanes' pages
    mm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Run full prompts from position 0, write their KV pages, return the
    last prompt row's logits ``[B, V]``."""
    B, T = tokens.shape
    hidden = _prefill_hidden(params, cfg, kv_pages, tokens, seq_lens, page_table, mm)
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
    return prefill_mm_and_sample(
        params, cfg, kv_pages, tokens, seq_lens, page_table, None, None,
        sampling, top_n, use_penalties,
    )


def prefill_mm_and_sample(
    params: Params,
    cfg: ModelConfig,
    kv_pages: KVPool,  # updated in place
    tokens: torch.Tensor,  # [B, T]; positions < mm_len[b] are placeholders
    seq_lens: torch.Tensor,  # [B]
    page_table: torch.Tensor,  # [B, T // page]
    mm_embeds: Optional[torch.Tensor],  # [B, M, H] f32 soft-prompt rows
    mm_len: Optional[torch.Tensor],  # [B] rows valid per lane (0: text-only)
    sampling: SamplingParams,
    top_n: int = 0,
    use_penalties: bool = False,
) -> torch.Tensor:
    """Multimodal prefill: llava-style soft-prompt injection over the first
    ``mm_len`` positions, then the causal prefill and first-token sample
    of :func:`prefill_and_sample` (which is this with no soft prompt).
    Returns ``packed [B, 2 + 2*top_n]``."""
    mm = None if mm_embeds is None else (mm_embeds, mm_len)
    logits = prefill_step(params, cfg, kv_pages, tokens, seq_lens, page_table, mm)
    pen = (
        prompt_penalized_logits(logits, tokens, seq_lens, sampling)
        if use_penalties
        else None
    )
    return sample_step_packed(logits, sampling, top_n, seq_lens, pen)


# the longest span of positions whose logits one scoring chunk projects:
# [B, 512, V] f32 is 263 MB at B = 1 over a 128256-id vocabulary
SCORE_CHUNK = 512


def score_prompt_step(
    params: Params,
    cfg: ModelConfig,
    kv_pages: KVPool,  # read only: the trunk's signature, never written
    tokens: torch.Tensor,  # [B, T] bucket-padded prompts
    seq_lens: torch.Tensor,  # [B] true prompt lengths (0 = pad lane)
    top_n: int = 0,
) -> torch.Tensor:
    """Per-position next-token logprobs over a prompt (echo+logprobs): the
    trunk runs causally with no KV writes, and entry j reports the logprob
    of prompt token j + 1 (the last entry is meaningless; the host drops
    it) through the decode sites' ``token_logprobs`` and
    ``pack_sampled_logprobs``.  The logits are projected in chunks of at
    most :data:`SCORE_CHUNK` positions, never ``[B, T, V]`` at once.
    Returns ``packed [B, T, 2 + 2*top_n]`` int32."""
    B, T = tokens.shape
    hidden = _prefill_hidden(params, cfg, kv_pages, tokens, seq_lens, None)
    targets = torch.roll(tokens, -1, dims=1)  # targets[j] = tokens[j + 1]
    lanes = torch.arange(B, device=tokens.device)[:, None] * T
    parts = []
    for lo in range(0, T, SCORE_CHUNK):
        span = min(SCORE_CHUNK, T - lo)
        rows = lanes + torch.arange(lo, lo + span, device=tokens.device)[None, :]
        logits = logits_at(params, cfg, hidden, rows.reshape(-1)).view(B, span, -1)
        tgt = targets[:, lo : lo + span].reshape(B * span)
        lp, top_ids, top_lps = token_logprobs(logits.reshape(B * span, -1), tgt, top_n)
        parts.append(pack_sampled_logprobs(tgt, lp, top_ids, top_lps).view(B, span, -1))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def embed_step(
    params: Params,
    cfg: ModelConfig,
    kv_pages: KVPool,  # read only: the trunk's signature, never written
    tokens: torch.Tensor,  # [B, T] bucket-padded inputs
    seq_lens: torch.Tensor,  # [B] true input lengths (0 = pad lane)
) -> torch.Tensor:
    """Pooled embeddings (/v1/embeddings): the trunk with no KV writes, the
    f32 mean of its final hidden rows over each lane's valid positions,
    L2-normalised with a floor of 1e-9.  Returns ``[B, H]`` f32 unit
    vectors, zero rows for pad lanes."""
    B, T = tokens.shape
    hidden = _prefill_hidden(params, cfg, kv_pages, tokens, seq_lens, None)
    valid = torch.arange(T, device=tokens.device)[None, :] < seq_lens[:, None]
    hidden = hidden.view(B, T, -1).float() * valid[:, :, None]
    denom = seq_lens[:, None].float().clamp(min=1.0)
    pooled = hidden.sum(dim=1) / denom
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / norm.clamp(min=1e-9)


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
    hidden = run_trunk(
        params, cfg, kv_pages, "suffix", tokens.reshape(-1), positions.reshape(-1),
        (prefix_table, offset, suffix_lens, suffix_table), (B, T, cfg.sliding_window or 0),
    )
    logits = _last_row_logits(params, cfg, hidden, suffix_lens, B, T)
    pen = (
        prompt_penalized_logits(logits, tokens, suffix_lens, sampling)
        if use_penalties
        else None
    )
    return sample_step_packed(logits, sampling, top_n, offset + suffix_lens, pen)


def verify_and_sample(
    params: Params,
    cfg: ModelConfig,
    kv_pages: KVPool,  # updated in place
    tokens: torch.Tensor,  # [B, S] last committed token | draft columns (padded)
    base: torch.Tensor,  # [B] cache length; column j sits at position base + j
    n_tokens: torch.Tensor,  # [B] valid columns (1 + draft len; 0 = inactive)
    page_table: torch.Tensor,  # [B, P] the lanes' pages (bucketed)
    sampling: SamplingParams,
    top_n: int = 0,
    use_filters: bool = True,
) -> torch.Tensor:
    """Batched multi-token verify (the standalone form): score every
    speculating lane's draft columns in ONE forward pass and sample the
    target token at every column.

    Column 0 carries the lane's last committed token, column j > 0 draft
    token j; its KV lands at position ``base + j`` and its logits sample
    the token for position ``base + j + 1``, the decode step's position
    keying, so greedy and seeded lanes give the tokens of plain decode.
    The host accept walk keeps the longest prefix where draft j equals
    the sample of column j - 1, plus the sample at the first mismatch; the
    rest of the column is overwritten by later writes.

    Attention is the prefix-suffix flash prefill (kernel 3 on the card):
    the lane's pages (positions ``< base``, token-granular, no page
    alignment needed) are the prefix, the S columns attend causally among
    themselves.  Returns ``packed [B, S, 2 + 2*top_n]``."""
    B, S = tokens.shape
    cols = torch.arange(S, device=base.device)
    positions = base[:, None] + cols[None, :]
    hidden = run_trunk(
        params, cfg, kv_pages, "verify", tokens.reshape(-1), positions.reshape(-1),
        (page_table, base, n_tokens), (B, S, cfg.sliding_window or 0),
    )
    logits = logits_at(params, cfg, hidden, None)  # [B * S, V]
    sampled = sample_tokens(
        logits, _tile_sampling(sampling, S), (positions + 1).reshape(-1), use_filters
    )
    lp, top_ids, top_lps = token_logprobs(logits, sampled, top_n)
    return pack_sampled_logprobs(sampled, lp, top_ids, top_lps).view(B, S, -1)


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


# -- page copies: offload tiers and swap records -------------------------------


def gather_block_pages(kv_pages: KVPool, ids: torch.Tensor) -> KVPool:
    """A copy of pages ``ids`` of every layer, ``[L, 2, n, page, Hkv, D]``
    (an int8 pool's data and scales together): the eviction and swap-out
    snapshot.  Enqueued on the current stream before any dispatch that
    reuses the pages, so it reads their contents before the reuse."""
    ids = ids.long()
    if isinstance(kv_pages, QuantKV):
        return QuantKV(q=kv_pages.q[:, :, ids], s=kv_pages.s[:, :, ids])
    return kv_pages[:, :, ids]


def scatter_block_pages(kv_pages: KVPool, ids: torch.Tensor, blob: KVPool) -> None:
    """Write a block's contents back into pages ``ids`` in place (G2/G3 ->
    G1 onboarding); an int8 pool restores data and scales byte for byte."""
    ids = ids.long()
    if isinstance(kv_pages, QuantKV):
        kv_pages.q[:, :, ids] = blob.q.to(torch.int8)
        kv_pages.s[:, :, ids] = blob.s.to(kv_pages.s.dtype)
        return
    kv_pages[:, :, ids] = blob.to(kv_pages.dtype)


def _layer_page_index(layer_ids: torch.Tensor, page_ids: torch.Tensor):
    """Three broadcast indices that keep a chunk in ``[Lg, 2, P, ...]``."""
    ki = torch.arange(2, device=page_ids.device)
    return layer_ids.long()[:, None, None], ki[None, :, None], page_ids.long()[None, None, :]


def gather_layer_pages(
    kv_pages: KVPool, layer_ids: torch.Tensor, page_ids: torch.Tensor
) -> KVPool:
    """One layer-group chunk of pages ``page_ids``: ``[Lg, 2, P, page,
    Hkv, D]``, a new tensor (the int8 pool's pair)."""
    idx = _layer_page_index(layer_ids, page_ids)
    if isinstance(kv_pages, QuantKV):
        return QuantKV(q=kv_pages.q[idx], s=kv_pages.s[idx])
    return kv_pages[idx]


def scatter_layer_pages(
    kv_pages: KVPool, layer_ids, page_ids: torch.Tensor, blob: KVPool
) -> None:
    """Write one layer-group chunk into pages ``page_ids`` in place (pad
    ids target trash page 0); an int8 pool restores the (data, scales)
    pair byte for byte.  ``layer_ids`` is a tensor of layer indices, or a
    ``slice`` of them: then each pool tensor's layer range takes the chunk
    with one ``index_copy_`` over the pages axis."""
    if isinstance(kv_pages, QuantKV):
        scatter_layer_pages(kv_pages.q, layer_ids, page_ids, blob.q)
        scatter_layer_pages(kv_pages.s, layer_ids, page_ids, blob.s)
        return
    if isinstance(layer_ids, slice):
        kv_pages[layer_ids].index_copy_(2, page_ids.long(), blob.to(kv_pages.dtype))
        return
    kv_pages.index_put_(_layer_page_index(layer_ids, page_ids), blob.to(kv_pages.dtype))
