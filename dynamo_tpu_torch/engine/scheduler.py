"""Continuous-batching scheduler: host-side state feeding the device steps.

A copy of the JAX package's scheduler (``engine/scheduler.py``) restricted
to what the PyTorch engine serves: FIFO slot admission with prefix-cache
reuse, mixed-batch chunk formation, page growth with recompute preemption,
and the host replay of the stop rules at commit (decode blocks and the
classic path's first token), with the multimodal soft prompt and the
prompt-logprob request fields, and speculation: a lane the engine arms
(``SeqState.spec``) is left out of the decode-runnable count and its
verify segments are reserved out of the mixed token budget; and the
offload plane's hooks: the prefix match continues from the page pool into
the offload tiers (``offload_lookup``; hits become ``pending_onboard``
scatters the engine applies at the prefill dispatch), and a preempted
lane may swap its KV out instead of recomputing it (``swap_out``), parked
``awaiting_kv`` -- slotted with its pages but device-inactive -- until the
engine restores it; and KV-budget admission (``KVAdmitConfig``): admit
against predicted KV pages with a skip-ahead and an aging floor instead of
slot count.  A router block is ``block_size // page_size`` pages; prefix
reuse runs when the allocator is a ``PagePool`` and the block is whole
pages.  Not carried over: data-parallel slot balancing.

The scheduler is sans-IO: it owns numpy mirrors of the device-side batch
arrays (tokens / seq_lens / page_table) and pure-Python bookkeeping; the
engine drives it and runs the device steps.  A version and a dirty-lane
set tell the engine what of its device-resident decode state is stale:
``growth_version`` (pages appended to live lanes) and ``dirty_slots``
(lanes whose mirrors changed).  ``metrics`` is the engine's observability
hook (``runtime.metrics.EngineMetrics``): the scheduler only sets its
queue and occupancy gauges at each admission pass.
"""

from __future__ import annotations

import collections
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Deque, List, Optional, Tuple

import numpy as np

from ..block_manager import OutOfPages, PagePool
from ..protocols.common import (
    FinishReason,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from ..spec.drafter import spec_live
from ..tokens.sequence import TokenBlock, TokenBlockSequence


@dataclass
class KVAdmitConfig:
    """KV-budget admission: admit against a predicted KV-page commitment
    instead of slot count, so one long prompt neither grabs a slot it
    cannot feed nor blocks the queue while short traffic could still fit.

    The predictor charges each request its peak pages -- sequence length
    plus decode headroom (``remaining_budget``, optionally capped by
    ``headroom_tokens``) -- against ``util * pool - reserve_pages``.  A
    head that does not fit is skipped over (short traffic keeps
    admitting, up to ``max_skips`` per pass) until it has aged past
    ``floor_s`` seconds; from then on no request passes it, so freed
    pages accumulate for the head instead of feeding newcomers -- the
    fairness floor in both directions.  Admission order changes; token
    streams never do.  The JAX package's model and grammar."""

    # fraction of the (trash-page-excluded) pool the predictor may commit
    util: float = 0.9
    # cap on the predicted decode headroom per request, tokens; None =
    # the request's full remaining token budget (max_tokens-capped)
    headroom_tokens: Optional[int] = None
    # pages withheld from the predictor (swap-restore / onboard slack)
    reserve_pages: int = 0
    # fairness floor: once the queue head has waited this long, nothing
    # skips past it
    floor_s: float = 2.0
    # max requests admitted past a blocked head per planning pass
    max_skips: int = 4


def parse_kv_admit_spec(spec: Any) -> Optional[KVAdmitConfig]:
    """Parse a ``DYN_KV_ADMIT_BUDGET`` value into a :class:`KVAdmitConfig`
    (None = slot-count admission).

    Grammar: ``0``/``off`` disarms, ``1``/``on`` arms the defaults, or a
    comma-separated ``k=v`` list::

        DYN_KV_ADMIT_BUDGET=util=0.9,headroom=256,reserve=16,floor_s=2,skips=4
    """
    if spec is None:
        return None
    if isinstance(spec, KVAdmitConfig):
        return spec
    if isinstance(spec, bool):
        return KVAdmitConfig() if spec else None
    s = str(spec).strip()
    if not s or s.lower() in ("0", "off", "false", "no"):
        return None
    out = KVAdmitConfig()
    if s.lower() in ("1", "on", "true", "yes"):
        return out
    for clause in filter(None, (c.strip() for c in s.split(","))):
        k, sep, v = clause.partition("=")
        k = k.strip().lower()
        if not sep:
            raise ValueError(f"malformed DYN_KV_ADMIT_BUDGET clause {clause!r}")
        if k not in ("util", "headroom", "reserve", "floor_s", "skips"):
            raise ValueError(f"unknown DYN_KV_ADMIT_BUDGET key {k!r}")
        try:
            if k == "util":
                out.util = float(v)
            elif k == "headroom":
                out.headroom_tokens = int(v)
            elif k == "reserve":
                out.reserve_pages = int(v)
            elif k == "floor_s":
                out.floor_s = float(v)
            elif k == "skips":
                out.max_skips = int(v)
        except ValueError as e:
            raise ValueError(f"bad DYN_KV_ADMIT_BUDGET value {clause!r}") from e
    return out


@dataclass
class SchedulerConfig:
    max_batch_size: int = 8
    max_seq_len: int = 2048
    page_size: int = 16
    # router-visible KV block size (token hashing): a whole number of pages
    # for prefix reuse; None = the page size
    block_size: Optional[int] = None
    # KV-budget admission (None = slot-count admission); see
    # KVAdmitConfig.  Changes which tick a request admits on, never its
    # tokens
    kv_admit: Optional[KVAdmitConfig] = None


@dataclass
class SeqState:
    """One in-flight request."""

    request_id: str
    prompt: List[int]
    stop: StopConditions
    sampling: SamplingOptions
    eos_ids: List[int]
    arrival_s: float = field(default_factory=time.monotonic)
    slot: int = -1
    # page_table view: shared (reused) pages first, then owned pages
    pages: List[int] = field(default_factory=list)
    blocks: Optional[TokenBlockSequence] = None  # router-visible block identity
    # llava-style soft prompt: [T_img, hidden] f32 rows injected over the
    # first T_img prompt positions at prefill (None = text-only)
    mm_embeds: Optional[Any] = None
    num_generated: int = 0
    # tokens generated before the last preemption (already streamed to the
    # client); stop-condition accounting uses prior_generated + num_generated
    prior_generated: int = 0
    finish: Optional[FinishReason] = None
    # number of prompt tokens whose KV was reused from a prefix-cache match
    cached_prompt_tokens: int = 0
    # registry refs this sequence holds (reused prefix + own registered blocks)
    held_blocks: List[int] = field(default_factory=list)
    # pages allocated to (and freed by) this sequence alone
    owned_pages: List[int] = field(default_factory=list)
    # completed blocks whose final token's KV is not yet written (it lands
    # with the next decode step); registered once the cache catches up
    pending_register: List[TokenBlock] = field(default_factory=list)
    # offload-tier hits awaiting their device scatter: (seq_hash, pages,
    # blob, meta) -- the engine scatters + registers them at prefill time
    pending_onboard: List[Any] = field(default_factory=list)
    # prefix-cache stats are counted once per request (first admission)
    stats_counted: bool = False
    # a swapped-out lane: re-admitted with fresh pages, it holds its slot
    # device-inactive until the engine's swap-in restores its KV
    awaiting_kv: bool = False
    # chunked prefill: prompt tokens whose KV has been dispatched so far;
    # the lane stays decode-inactive while prefilling is True
    prefilled_tokens: int = 0
    prefilling: bool = False
    # speculative decoding: the request's knobs (SpeculationOptions | None)
    # and, once the engine arms the lane, its live spec.SpecState.  A lane
    # with live speculation is device-inactive for the decode steps: it
    # advances through its verify columns
    speculation: Optional[Any] = None
    spec: Optional[Any] = None
    # echo+logprobs: top-N prompt logprobs to compute at first prefill
    prompt_logprobs: Optional[int] = None
    prompt_lp_sent: bool = False
    # queue-side prefetch accounting: offloaded prefix blocks found
    # host-staged at admission because the prefetch walk promoted them
    # during queue wait
    prefetch_hits: int = 0
    # admission stamp (time.monotonic()): closes the request's queue wait
    # (the SLO plane's queue/service split reads it); re-admissions after
    # preemption re-stamp
    admitted_s: float = 0.0
    # once-only latch of the first-token queue/service note to the SLO plane
    slo_noted: bool = False
    # slot lives: bumped whenever the lane leaves its slot (finish, cancel,
    # preemption), so a dispatch made in an earlier life never commits into
    # a later one, even when a preempted request is re-admitted into the
    # same slot before that dispatch committed
    life: int = 0

    @property
    def seq_len(self) -> int:
        return len(self.prompt) + self.num_generated

    @classmethod
    def from_request(cls, request_id: str, req: PreprocessedRequest, block_size: int) -> "SeqState":
        mm = None
        if req.mm_embeds:
            mm = np.asarray(req.mm_embeds, np.float32)
        return cls(
            request_id=request_id,
            prompt=list(req.token_ids),
            stop=req.stop_conditions,
            sampling=req.sampling_options,
            eos_ids=list(req.eos_token_ids),
            # multimodal prompts opt out of prefix caching: the block hash
            # chain is computed over token ids, and the placeholder ids for
            # embedding positions would alias across different images
            blocks=(
                None
                if mm is not None
                else TokenBlockSequence(req.token_ids, block_size=block_size)
            ),
            mm_embeds=mm,
            speculation=req.speculation,
            prompt_logprobs=req.prompt_logprobs,
        )


@dataclass
class TickPlan:
    """What the engine must execute this tick."""

    # prompts to prefill: (seq, bucket_len) -- each is one prefill dispatch
    prefills: List[Tuple[SeqState, int]] = field(default_factory=list)


@dataclass
class MixedChunk:
    """One lane's contribution of prompt tokens to a unified mixed-batch
    dispatch: ``final`` means the chunk completes the prompt, so the
    dispatch samples the lane's first token."""

    seq: SeqState
    start: int  # first prompt position this chunk covers
    length: int  # tokens in the chunk
    final: bool


@dataclass
class StepEvent:
    """Per-request outcome of a tick (tokens emitted and/or finished).

    ``tokens`` carries every token the tick emitted for the request -- a
    whole decode block's worth coalesces into ONE event (commit_block), so
    downstream per-event costs (queue put, consumer wakeup, SSE frame build)
    are paid per block, not per token.  Order within the list is emission
    order."""

    seq: SeqState
    tokens: List[int] = field(default_factory=list)
    finished: Optional[FinishReason] = None
    completed_blocks: List[TokenBlock] = field(default_factory=list)
    # aligned with ``tokens`` when the dispatch carried logprob data:
    # chosen-token logprobs, and per-token top-N alternatives as
    # [[token_id, logprob], ...] (None when the dispatch ran without tops)
    logprobs: List[float] = field(default_factory=list)
    top_logprobs: Optional[List[List[List[float]]]] = None
    # echo+logprobs: per-prompt-position [token_id, logprob|None, top|None]
    # entries, attached by the engine to the request's first event
    prompt_logprobs: Optional[List[Any]] = None


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, allocator: Any) -> None:
        self.cfg = cfg
        # the page allocator: a PagePool (block_manager) or the plain
        # PageAllocator (kv_cache) when prefix caching is off
        self.allocator = allocator
        self.block_size = cfg.block_size or cfg.page_size
        # prefix-cache reuse runs when the allocator is a PagePool (has a
        # sequence-hash registry) and router blocks align to whole pages
        self.pool: Optional[PagePool] = (
            allocator
            if isinstance(allocator, PagePool)
            and self.block_size % cfg.page_size == 0
            else None
        )
        self.pages_per_block = self.block_size // cfg.page_size
        # tiered prefix lookup hook: fn(seq_hash) -> (blob, meta) | None,
        # wired by the engine when offload tiers are configured
        self.offload_lookup: Optional[Any] = None
        # swap-based preemption hook: fn(seq) -> bool, wired by the engine
        # when the offload plane is armed.  Called with the victim still
        # slotted (pages intact) so the engine can enqueue the device
        # snapshot before the slot release frees them; True parks the
        # sequence for a KV restore instead of a re-prefill.
        self.swap_out: Optional[Any] = None
        self.preempt_swap = 0
        self.preempt_recompute = 0
        # KV-budget admission (None = slot-count); its counters
        self.kv_admit = cfg.kv_admit
        self.admit_skips = 0  # admissions that passed a blocked head
        self.admit_blocked = 0  # passes whose head did not fit the budget
        # tokens a decode lane may grow by before the scheduler can react
        # again: the engine sets it to its multistep K times its pipeline
        # depth before each plan, so the budget planner charges every
        # decode-phase lane at least that much in-flight growth
        self.decode_inflight_tokens = 0
        # observability hook (runtime.metrics.EngineMetrics): the scheduler
        # stays sans-IO -- it only pokes gauges the engine wired in
        self.metrics: Optional[Any] = None
        B = cfg.max_batch_size
        self.max_pages = cfg.max_seq_len // cfg.page_size
        self.waiting: Deque[SeqState] = collections.deque()
        self.slots: List[Optional[SeqState]] = [None] * B
        # slotted lanes whose prompt KV the mixed-batch plane still owes
        # (unified ragged dispatches pack their chunks; see
        # form_mixed_chunks)
        self.mix_pending: List[SeqState] = []
        # numpy mirrors of the device batch arrays
        self.tokens = np.zeros((B,), np.int32)
        self.seq_lens = np.zeros((B,), np.int32)
        self.page_table = np.zeros((B, self.max_pages), np.int32)
        # layout_version: slot membership changed (admission / release /
        # preemption).  growth_version: pages were appended to live lanes --
        # the engine refreshes the device page table and limits, keeping the
        # decode pipeline running.  dirty_slots: lanes whose mirrors changed
        # (admission/release); the engine folds them into the device-resident
        # decode state with per-row scatters instead of a full rebuild, so
        # the decode pipeline never drains for batch-membership changes.
        self.layout_version = 0
        self.growth_version = 0
        self.dirty_slots: set = set()

    # -- queue/observability -------------------------------------------------

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def num_runnable(self) -> int:
        """Slotted lanes the device can actually step (parked awaiting_kv /
        mid-chunked-prefill lanes hold a slot + pages but must not spin
        decode steps)."""
        return sum(
            1
            for s in self.slots
            if s is not None and not s.awaiting_kv and not s.prefilling
        )

    @property
    def num_decode_runnable(self) -> int:
        """Runnable lanes the decode SCAN should step: actively
        speculating lanes are excluded -- they advance via the engine's
        verify columns (host-mirror driven), and a decode block over
        only-spec lanes would burn a dispatch on dead rows.  A lane whose
        speculation auto-disabled is a plain decode lane again and counts
        (``spec.drafter.spec_live``: the same predicate the engine's
        eligibility sites consult)."""
        return sum(
            1
            for s in self.slots
            if s is not None
            and not s.awaiting_kv
            and not s.prefilling
            and not spec_live(s.spec)
        )

    @property
    def has_runnable_work(self) -> bool:
        """Work the tick loop can make progress on *right now*; a batch of
        only parked lanes sleeps until a swap-in (or timeout) wakes it."""
        return self.num_runnable > 0 or len(self.waiting) > 0

    def enqueue(self, seq: SeqState) -> None:
        if not seq.prompt:
            raise ValueError("empty prompt (zero tokens after preprocessing)")
        if len(seq.prompt) > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt of {len(seq.prompt)} tokens exceeds max_seq_len "
                f"{self.cfg.max_seq_len}"
            )
        self.waiting.append(seq)

    # -- admission -----------------------------------------------------------

    def remaining_budget(self, seq: SeqState) -> int:
        """Tokens the sequence may still emit (max_tokens / max_seq_len caps)."""
        produced = seq.prior_generated + seq.num_generated
        by_max = (
            seq.stop.max_tokens - produced
            if seq.stop.max_tokens is not None
            else self.cfg.max_seq_len
        )
        by_len = self.cfg.max_seq_len - seq.seq_len
        return max(0, min(by_max, by_len))

    def min_total_pages(self, seq: SeqState) -> int:
        """Smallest page count that lets the sequence make forward progress:
        the prompt KV plus, when at least one decode step must run, the write
        slot for the next token.  (A single-token request samples its only
        token from the prefill logits and never decodes.)"""
        n = len(seq.prompt)
        if self.remaining_budget(seq) >= 2:
            n += 1
        return -(-n // self.cfg.page_size)

    def plan(self) -> TickPlan:
        """Admit waiting requests into free slots while the physical page
        floor allows.

        With ``kv_admit`` unset the queue admits strictly FIFO against
        slot count and the page floor.  With it set, admission runs the
        KV-budget model (:class:`KVAdmitConfig`): predicted peak pages
        gate each candidate, and a head that does not fit is skipped over
        -- bounded by the fairness floor."""
        plan = TickPlan()
        if self.kv_admit is not None:
            self._plan_budget(plan)
        else:
            while self.waiting:
                slot = self._free_slot()
                if slot is None:
                    break
                if not self._try_admit(self.waiting[0], plan, slot):
                    break
                self.waiting.popleft()
        if self.metrics is not None:
            self.metrics.observe_sched(len(self.waiting), self.num_active)
        return plan

    def _try_admit(self, seq: SeqState, plan: TickPlan, slot: int) -> bool:
        """Admit one request into ``slot`` if the physical page floor
        allows; returns False (state untouched) otherwise."""
        # a swapped lane's KV returns through the swap-in scatter into
        # fresh pages: it takes no reused prefix
        cached_pages = [] if seq.awaiting_kv else self._match_prefix(seq)
        if seq.awaiting_kv:
            seq.cached_prompt_tokens = 0
        n_pages = -(-len(seq.prompt) // self.cfg.page_size)
        # admission needs room for the prompt *and* the first decode
        # write, with one page of headroom per active seq for growth;
        # reused prefix pages are already resident and cost nothing
        need = self.min_total_pages(seq) - len(cached_pages)
        if self.allocator.free_pages < need + self.num_active:
            self._unmatch_prefix(seq)
            return False
        fresh = self.allocator.alloc(n_pages - len(cached_pages))
        # onboard pages were allocated inside _match_prefix and stay
        # plain-owned until the engine registers them post-scatter
        onboard = [p for _h, pgs, _b, _m in seq.pending_onboard for p in pgs]
        seq.owned_pages = onboard + fresh
        seq.pages = cached_pages + fresh
        seq.slot = slot
        seq.admitted_s = time.monotonic()
        self.slots[slot] = seq
        self._write_slot_arrays(seq)
        self._queue_prompt_registrations(seq)
        if not seq.awaiting_kv:
            plan.prefills.append((seq, len(seq.prompt)))
        # awaiting_kv lanes hold their pages and stay device-inactive until
        # the engine's swap-in restores their KV
        return True

    def predicted_pages(self, seq: SeqState) -> int:
        """Predicted peak KV pages for a request under the budget model:
        current sequence length (the prompt, for a queued request) plus
        decode headroom -- the remaining token budget, optionally capped
        by ``headroom_tokens``.  Never below what the sequence already
        holds, never above the per-lane page ceiling."""
        adm = self.kv_admit
        remaining = self.remaining_budget(seq)
        head = remaining
        if adm is not None and adm.headroom_tokens is not None:
            head = min(head, adm.headroom_tokens)
        # the JAX planner's test, kept as it is: ``slot`` is never None
        # (-1 when queued), so every request not prefilling or parked is
        # charged the in-flight growth
        if seq.slot is not None and not seq.prefilling and not seq.awaiting_kv:
            # a decode-phase lane has up to decode_inflight_tokens of
            # uncommitted multistep growth in flight: charge at least that
            # (still capped by what it may legally emit)
            head = max(head, min(self.decode_inflight_tokens, remaining))
        n = min(seq.seq_len + head, self.cfg.max_seq_len)
        pages = -(-n // self.cfg.page_size)
        return max(min(pages, self.max_pages), len(seq.pages))

    def _plan_budget(self, plan: TickPlan) -> None:
        """KV-budget admission pass (see :class:`KVAdmitConfig`)."""
        adm = self.kv_admit
        now = time.monotonic()
        usable = self.allocator.num_pages - 1  # trash page excluded
        budget = max(int(usable * adm.util) - adm.reserve_pages, 1)
        committed = sum(self.predicted_pages(s) for s in self.slots if s is not None)

        # fairness floor: an aged head stops all skip-ahead, so pages freed
        # by completions accumulate for it.  Read against the CURRENT head
        # at each gating point: an aged head that admits mid-pass must not
        # gate the requests behind it
        def head_aged() -> bool:
            return bool(self.waiting) and now - self.waiting[0].arrival_s > adm.floor_s

        skips = 0
        i = 0
        while i < len(self.waiting):
            slot = self._free_slot()
            if slot is None:
                break
            seq = self.waiting[i]
            need = self.predicted_pages(seq)
            # an empty batch always admits its head: a request whose
            # prediction exceeds the whole budget must still run alone
            fits = committed + need <= budget or (self.num_active == 0 and i == 0)
            if fits and self._try_admit(seq, plan, slot):
                del self.waiting[i]
                committed += need
                continue
            if i == 0:
                self.admit_blocked += 1
            if head_aged() or skips >= adm.max_skips:
                break
            skips += 1
            self.admit_skips += 1
            i += 1

    # -- mixed-batch formation (unified ragged dispatch) ---------------------

    def queue_mixed_prefill(self, seq: SeqState, start: int) -> None:
        """Hand an admitted (slotted) prompt to the mixed-batch plane: the
        lane parks ``prefilling`` (decode-inactive) and its prompt tokens
        are packed into unified dispatches chunk by chunk, FIFO across
        lanes, under the per-dispatch token budget."""
        seq.prefilling = True
        seq.prefilled_tokens = start
        # a re-admitted (preemption-recomputed) lane may still have a stale
        # entry from its previous life; one entry per seq keeps one chunk
        # per lane per dispatch
        if seq not in self.mix_pending:
            self.mix_pending.append(seq)

    def form_mixed_chunks(
        self, budget: int, chunk_cap: Optional[int] = None, reserve_tokens: int = 0
    ) -> List[MixedChunk]:
        """Pack pending prefill work into this tick's unified dispatch.

        ``budget`` is the dispatch's total fresh-token budget: every
        decode-runnable lane costs one token, ``reserve_tokens`` rows are
        withheld for the tick's folded verify segments (the engine's spec
        reserve), the remainder goes to prefill chunks in arrival order.  At least one prompt token always
        packs when prefill work is pending, so a decode batch as wide as
        the budget can never starve admission.  ``chunk_cap`` bounds one
        lane's chunk (the ``prefill_chunk_tokens`` knob).

        Non-final chunk boundaries are rounded DOWN to a page multiple: a
        lane drained to the classic path (a penalized arrival turned the
        tick classic) resumes through the suffix prefill, whose prefix page
        table covers whole pages only.  When alignment rounds the head
        lane's chunk to zero, one full page packs anyway (slight budget
        overshoot beats starvation).
        """
        ps = self.cfg.page_size
        left = max(budget - self.num_decode_runnable - reserve_tokens, 1)
        chunks: List[MixedChunk] = []
        still: List[SeqState] = []
        seen: set = set()
        for seq in self.mix_pending:
            if (
                seq.finish is not None
                or seq.slot < 0
                or self.slots[seq.slot] is not seq
                or not seq.prefilling
                or id(seq) in seen
            ):
                continue  # cancelled / preempted mid-prefill / dup: drop
            seen.add(id(seq))
            remaining = len(seq.prompt) - seq.prefilled_tokens
            if remaining <= 0:  # defensive; final chunk clears prefilling
                seq.prefilling = False
                self.dirty_slots.add(seq.slot)
                continue
            take = min(remaining, left) if left > 0 else 0
            if chunk_cap is not None:
                take = min(take, chunk_cap)
            if take < remaining:
                # non-final: keep the boundary page-aligned (start is
                # aligned by induction)
                take = (seq.prefilled_tokens + take) // ps * ps \
                    - seq.prefilled_tokens
                if take <= 0 and not chunks:
                    take = min(ps, remaining)
            if take > 0:
                chunks.append(
                    MixedChunk(
                        seq=seq,
                        start=seq.prefilled_tokens,
                        length=take,
                        final=(take == remaining),
                    )
                )
                left -= take
                if take < remaining:
                    still.append(seq)
            else:
                still.append(seq)
        self.mix_pending = still
        return chunks

    def _match_prefix(self, seq: SeqState) -> List[int]:
        """Acquire the longest resident prefix of the prompt's blocks; returns
        the reused pages (front of the page table).  Reuse is capped below the
        full prompt so prefill always has at least one token to process.

        After the G1 match ends, the chain continues into the offload
        tiers: a G2 hit allocates fresh pages now and defers the device
        scatter + registration to the engine (``seq.pending_onboard``) --
        those pages stay plain-owned until the scatter is enqueued, so no
        other request can match a block whose contents haven't landed."""
        seq.cached_prompt_tokens = 0
        if self.pool is None or seq.blocks is None:
            return []
        max_blocks = max(0, (len(seq.prompt) - 1) // self.block_size)
        hashes = seq.blocks.sequence_hashes()[:max_blocks]
        matched = self.pool.match(hashes)
        pages: List[int] = []
        for blk in matched:
            got = self.pool.acquire(blk.sequence_hash)
            if got is None:  # raced away (defensive; single-threaded today)
                break
            seq.held_blocks.append(blk.sequence_hash)
            pages.extend(blk.pages)
        n_matched = len(seq.held_blocks)
        if self.offload_lookup is not None:
            for h in hashes[n_matched:]:
                if self.pool.is_registered(h):
                    break  # re-resident meanwhile; stop the offload chain
                hit = self.offload_lookup(h)
                if hit is None:
                    break
                blob, meta = hit
                try:
                    got_pages = self.allocator.alloc(self.pages_per_block)
                except OutOfPages:
                    break
                seq.pending_onboard.append((h, got_pages, blob, meta))
                pages.extend(got_pages)
        seq.cached_prompt_tokens = (n_matched + len(seq.pending_onboard)) * self.block_size
        return pages

    def _unmatch_prefix(self, seq: SeqState) -> None:
        for h in seq.held_blocks:
            self.pool.release(h)
        seq.held_blocks = []
        for _h, pages, _blob, _meta in seq.pending_onboard:
            self.allocator.free(pages)
        seq.pending_onboard = []
        seq.cached_prompt_tokens = 0

    def _queue_prompt_registrations(self, seq: SeqState) -> None:
        """Prompt blocks beyond the reused prefix register once prefill's KV
        writes are committed (the catch-up in ``_register_ready``)."""
        if self.pool is None or seq.blocks is None:
            return
        n_reused = seq.cached_prompt_tokens // self.block_size
        n_prompt_blocks = len(seq.prompt) // self.block_size
        seq.pending_register = list(seq.blocks.blocks[n_reused:n_prompt_blocks])

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _write_slot_arrays(self, seq: SeqState) -> None:
        b = seq.slot
        self.page_table[b, :] = 0
        self.page_table[b, : len(seq.pages)] = seq.pages
        self.seq_lens[b] = len(seq.prompt)
        self.tokens[b] = seq.prompt[-1] if seq.prompt else 0
        self.layout_version += 1
        self.dirty_slots.add(b)

    # -- decode bookkeeping --------------------------------------------------

    def ensure_decode_capacity(
        self, lookahead: int = 1, chunk_pages: int = 0
    ) -> List[SeqState]:
        """Grow page tables so each active sequence can absorb up to
        ``lookahead`` more tokens, never growing past the lane's remaining
        token budget (max_tokens / max_seq_len).  When growth is needed,
        over-allocate by ``chunk_pages`` so the page table (and the device
        copy of it) changes every few blocks instead of every block.

        Growth is best-effort: a lane that cannot reach the full lookahead
        pauses at its allocated capacity (the device-side ``limit_lens`` cap
        keeps it from writing past its pages) and retries next tick.
        Preemption only triggers when a lane lacks room for even one more
        token -- then the youngest lane is evicted (possibly the lane
        itself).  Returns the preempted sequences (moved back to the head of
        the waiting queue, pages freed)."""
        ps = self.cfg.page_size
        preempted: List[SeqState] = []
        for seq in [s for s in self.slots if s is not None]:
            if seq.slot < 0:
                continue  # became a preemption victim earlier this pass
            cache_len = int(self.seq_lens[seq.slot])
            budget = max(self.remaining_budget(seq), 1)
            # max cache length the lane can ever use (limit_lens semantics:
            # the final token's KV is never read, and position max_seq_len-1
            # is the last writable slot)
            useful = min(cache_len + budget, self.cfg.max_seq_len - 1)
            want_tokens = min(cache_len + lookahead, useful)
            need_tokens = min(cache_len + 1, useful)
            want = min(-(-want_tokens // ps), self.max_pages)
            need = min(-(-need_tokens // ps), self.max_pages)
            if len(seq.pages) < want:
                want = min(want + chunk_pages, -(-useful // ps), self.max_pages)
            while len(seq.pages) < want:
                try:
                    page = self.allocator.alloc(1)[0]
                except OutOfPages:
                    if len(seq.pages) >= need:
                        break  # best effort met; lane pauses at capacity
                    victim = self._pick_preemption_victim()
                    if victim is None or victim is seq:
                        # cannot make room; preempt this one
                        self._preempt(seq)
                        preempted.append(seq)
                        break
                    self._preempt(victim)
                    preempted.append(victim)
                    continue
                seq.pages.append(page)
                seq.owned_pages.append(page)
                self.page_table[seq.slot, len(seq.pages) - 1] = page
                self.growth_version += 1
        return preempted

    def _pick_preemption_victim(self) -> Optional[SeqState]:
        """Preempt the most recently arrived active sequence (reference
        vLLM-style recompute preemption favors older requests)."""
        active = [s for s in self.slots if s is not None]
        if not active:
            return None
        return max(active, key=lambda s: s.arrival_s)

    def _preempt(self, seq: SeqState) -> None:
        """Preempt a lane: swap its KV out (the engine's ``swap_out`` hook,
        called while its pages are still allocated, so the device snapshot
        is enqueued before any reuse) and park it, or -- whenever the hook
        declines -- recompute: release the lane and fold its generated
        tokens into the prompt, so the resume reproduces the full sequence
        deterministically either way."""
        swapped = False
        if self.swap_out is not None and seq.finish is None:
            try:
                swapped = bool(self.swap_out(seq))
            except Exception:
                logging.getLogger("dynamo.offload").exception(
                    "swap-out hook failed for %s; recomputing", seq.request_id
                )
        self._release_slot(seq)
        seq.prompt = seq.prompt + self._generated_tokens(seq)
        seq.prior_generated += seq.num_generated
        seq.num_generated = 0
        seq.slot = -1
        if swapped:
            # parked: holds pages at admission, stays device-inactive
            # until the engine's swap-in clears the barrier
            seq.awaiting_kv = True
            self.preempt_swap += 1
        else:
            self.preempt_recompute += 1
        self.waiting.appendleft(seq)

    def _generated_tokens(self, seq: SeqState) -> List[int]:
        if seq.blocks is None:
            return []
        all_tokens = seq.blocks.tokens
        return list(all_tokens[len(seq.prompt) :])

    def _release_slot(self, seq: SeqState) -> None:
        seq.prefilling = False
        seq.prefilled_tokens = 0
        seq.life += 1
        if seq.slot >= 0:
            b = seq.slot
            self.slots[b] = None
            self.page_table[b, :] = 0
            self.seq_lens[b] = 0
            self.tokens[b] = 0
            self.layout_version += 1
            self.dirty_slots.add(b)
        # registered blocks outlive the sequence (refcount drops; the block
        # turns inactive-reusable at zero); only exclusively-owned pages and
        # never-registered completions return to the free list
        if self.pool is not None:
            self.allocator.free(seq.owned_pages)
            for h in seq.held_blocks:
                self.pool.release(h)
            seq.held_blocks = []
            seq.pending_register = []
            seq.pending_onboard = []  # pages were owned; freed above
            seq.pages = []
            seq.owned_pages = []
        elif seq.pages:
            self.allocator.free(seq.pages)
            seq.pages = []
            seq.owned_pages = []

    # -- per-token postprocessing -------------------------------------------

    def _commit_lane_column(
        self,
        seq: SeqState,
        column: np.ndarray,
        lps: Optional[np.ndarray] = None,  # [K] chosen-token logprobs
        top_ids: Optional[np.ndarray] = None,  # [K, N]
        top_lps: Optional[np.ndarray] = None,  # [K, N]
    ) -> StepEvent:
        """Commit one lane's K sampled tokens as a single coalesced event.

        Host-side replay of the device loop for one lane: per token the
        exact stop-condition rules run (``_commit_token``); ``-1`` marks a
        step the device already knew was dead.  Once the lane finishes, the
        rest of the column was speculative decode and is discarded."""
        tokens: List[int] = []
        blocks: List[TokenBlock] = []
        logprobs: List[float] = []
        tops: Optional[List[List[List[float]]]] = (
            [] if top_ids is not None else None
        )
        finished: Optional[FinishReason] = None
        for k, raw in enumerate(column.tolist()):
            if raw < 0:
                continue
            ev = self._commit_token(seq, raw)
            if ev.tokens:
                tokens.extend(ev.tokens)
                if lps is not None:
                    logprobs.append(float(lps[k]))
                if tops is not None:
                    tops.append(
                        [
                            [int(i), float(l)]
                            for i, l in zip(top_ids[k], top_lps[k])
                        ]
                    )
            blocks.extend(ev.completed_blocks)
            if ev.finished is not None:
                finished = ev.finished
                break
        return StepEvent(
            seq=seq, tokens=tokens, finished=finished, completed_blocks=blocks,
            logprobs=logprobs, top_logprobs=tops,
        )

    def commit_prefill_token(
        self,
        seq: SeqState,
        token: int,
        logprob: Optional[float] = None,
        top: Optional[List[List[float]]] = None,
    ) -> StepEvent:
        """Apply the first token sampled from a classic prefill's logits."""
        ev = self._commit_token(seq, token)
        if ev.tokens:
            if logprob is not None:
                ev.logprobs = [logprob]
            if top is not None:
                ev.top_logprobs = [top]
        if ev.finished is not None:
            seq.finish = ev.finished
            self._release_slot(seq)
        return ev

    def commit_block(
        self,
        sampled: np.ndarray,
        slot_snapshot: Optional[List[Optional[SeqState]]] = None,
        lps: Optional[np.ndarray] = None,  # [B, K] chosen-token logprobs
        top_ids: Optional[np.ndarray] = None,  # [B, K, N]
        top_lps: Optional[np.ndarray] = None,  # [B, K, N]
        lives: Optional[List[int]] = None,
    ) -> List[StepEvent]:
        """Apply a device-decoded block of raw sampled tokens [B, K].

        Each live lane's column commits through ``_commit_lane_column``,
        which replays the device stop rules token by token but returns ONE
        coalesced event for the block -- the per-event downstream cost
        (queue put, consumer wakeup, SSE frame) is paid per block per lane,
        not per token, which is what keeps large-batch decode off the host's
        critical path.

        ``slot_snapshot`` is the slot list captured when the block was
        dispatched -- with pipelined blocks a slot may have been released (or
        even re-assigned) since, and those lanes' tokens must not be
        attributed to the new occupant.  ``lives`` (each lane's
        ``SeqState.life`` at dispatch) also drops the column of a request
        preempted and re-admitted into the same slot since.
        """
        events: List[StepEvent] = []
        B, K = sampled.shape
        slots_at_entry = (
            list(slot_snapshot) if slot_snapshot is not None else list(self.slots)
        )
        for b in range(B):
            seq = slots_at_entry[b]
            if seq is None or seq.finish is not None or seq.slot != b:
                continue
            if lives is not None and lives[b] != seq.life:
                continue  # dispatched in an earlier life of the request
            if seq.prefilling or seq.awaiting_kv:
                # a parked lane's column is placeholder garbage by
                # construction (the lane is device-inactive, rows are -1);
                # a lane re-parked since the dispatch (preempt + re-admit
                # into the same slot) must not have stale columns
                # attributed to its new life
                continue
            ev = self._commit_lane_column(
                seq, sampled[b],
                lps[b] if lps is not None else None,
                top_ids[b] if top_ids is not None else None,
                top_lps[b] if top_lps is not None else None,
            )
            if ev.finished is not None:
                seq.finish = ev.finished
                self._release_slot(seq)
            if ev.tokens or ev.finished is not None:
                events.append(ev)
        return events

    def _commit_token(self, seq: SeqState, token: int) -> StepEvent:
        """One token through the stop rules (the reference backend jail,
        lib/llm/src/backend.rs): eos finishes unless ignore_eos; hidden stop
        token ids finish without emitting the token."""
        stop = seq.stop
        # total tokens streamed to the client, across preemptions
        n_gen = seq.prior_generated + seq.num_generated + 1

        hidden_stop = stop.stop_token_ids_hidden or []
        is_eos = token in seq.eos_ids
        min_ok = stop.min_tokens is None or n_gen >= stop.min_tokens

        if token in hidden_stop and min_ok:
            return StepEvent(seq=seq, finished=FinishReason.STOP)
        if is_eos and not stop.ignore_eos and min_ok:
            return StepEvent(seq=seq, finished=FinishReason.EOS)

        seq.num_generated += 1
        completed: List[TokenBlock] = []
        if seq.blocks is not None:
            blk = seq.blocks.append(token)
            if blk is not None:
                completed.append(blk)
        b = seq.slot
        self.tokens[b] = token
        # seq_lens mirrors the *cache* length: the KV of the newest token is
        # written by the upcoming decode step at exactly this position
        # (decode_step positions = seq_lens).
        self.seq_lens[b] = seq.seq_len - 1
        if self.pool is not None:
            seq.pending_register.extend(completed)
            self._register_ready(seq)

        finished: Optional[FinishReason] = None
        if stop.max_tokens is not None and n_gen >= stop.max_tokens:
            finished = FinishReason.LENGTH
        elif seq.seq_len >= self.cfg.max_seq_len:
            finished = FinishReason.LENGTH
        return StepEvent(
            seq=seq, tokens=[token], finished=finished, completed_blocks=completed
        )

    def _register_ready(self, seq: SeqState) -> None:
        """Register completed blocks whose KV is fully written.

        A block ending at token position ``end`` is committable once the
        cache length reaches ``end``: the decode step that consumed the
        block's final token wrote its KV (commit implies the write was
        dispatched, and the device executes dispatches in order, so any
        later prefill that reuses the block reads it complete).
        """
        cache_len = int(self.seq_lens[seq.slot])
        ppb = self.pages_per_block
        while seq.pending_register:
            blk = seq.pending_register[0]
            end = (blk.position + 1) * self.block_size
            if end > cache_len:
                break
            seq.pending_register.pop(0)
            start = blk.position * ppb
            pages = seq.pages[start : start + ppb]
            if len(pages) < ppb:
                break  # table shorter than the block span (defensive)
            if self.pool.register(
                blk.sequence_hash,
                pages,
                block_hash=blk.block_hash,
                parent_sequence_hash=blk.parent_sequence_hash,
                position=blk.position,
            ):
                # ownership moves to the registry; this seq keeps a ref
                seq.held_blocks.append(blk.sequence_hash)
                for p in pages:
                    seq.owned_pages.remove(p)
            # register() == False: identical block already registered by a
            # concurrent twin; keep plain ownership of our duplicate pages

    def cancel(self, seq: SeqState) -> None:
        if seq.slot >= 0:
            self._release_slot(seq)
        elif seq in self.waiting:
            self.waiting.remove(seq)
        seq.finish = FinishReason.CANCELLED
