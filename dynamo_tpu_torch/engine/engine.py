"""TorchEngine: the PyTorch engine behind the AsyncEngine interface.

``generate(Context[PreprocessedRequest]) -> AsyncIterator[Annotated[
LLMEngineOutput-dict]]`` -- the serving interface of the JAX package's
``JaxEngine``, driven by the same scheduler rules and the same dispatches.
Every tick plans admissions and grows page tables (preempting by recompute
when the pool runs dry), then takes one of two shapes:

* **mixed** (the default): prefill chunks and decode rows share ONE unified
  step, on one flat packed token axis or, with ``packed_ragged=False``,
  the ``[B, S]`` rectangle; a pressure-free packed decode tick fuses up to
  ``multistep_max_k`` decode steps into that dispatch (the adaptive ramp
  of the JAX engine's ``_multistep_plan_k``); a rectangle tick without
  prefill work runs a classic decode block;
* **classic** (``mixed_batching=False``, or any tick while a lane with a
  sampling penalty holds a slot): classic prefill chunks advance one per
  lane, new prompts prefill in groups of one (suffix bucket, prefix-page
  bucket) with the batch padded to a power of two, each sampling its first
  token, then one decode block of ``decode_block_size`` steps runs, with
  the penalty histograms rebuilt from the host mirrors.  Mixed prefills
  still pending when a penalized lane arrives drain to the classic chunk
  path (mixed chunk ends are page-aligned for exactly this).

The host commits every dispatch's sampled tokens right away, replaying the
stop rules (``Scheduler.commit_block`` / ``commit_prefill_token``), and
streams them.  The tick loop is serial: each dispatch commits before the
next is planned, so the device-side decode state (and a penalty histogram)
is rebuilt from the scheduler's mirrors at every dispatch and nothing is
carried between dispatches but the KV pool.  Device work runs on one
executor thread; the event loop keeps serving I/O meanwhile.

Not served yet (later slices): multimodal prompts and prompt logprobs
(such a request gets an error frame), speculative decoding (its request
fields are ignored: output is the contract, speculation an optimization),
async double-buffering, offload/swap, disaggregation and tensor/data
parallelism.  The KV pool is dense in the model's dtype or, with
``EngineConfig(kv_dtype="int8")``, int8 with per-row scales; a dense pool
of another dtype is refused at construction.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import itertools
import logging
from typing import Any, AsyncIterator, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..protocols.common import (
    FinishReason,
    ForwardPassMetrics,
    LLMEngineOutput,
    PreprocessedRequest,
)
from ..runtime.engine import Annotated, Context, ResponseStream
from .bucketing import (
    packed_axis_len,
    pick_bucket,
    pick_page_bucket,
    pow2_bucket,
    prefill_buckets,
)
from .config import EngineConfig, ModelConfig
from .kv_cache import PagedKVCache, pool_is_quantized, torch_dtype
from .model import Params, init_params
from .sampling import PROMPT_FLAG, SamplingParams, unpack_sampled_logprobs
from .scheduler import MixedChunk, Scheduler, SchedulerConfig, SeqState, StepEvent
from .step import (
    decode_block,
    packed_unified_multistep,
    prefill_and_sample,
    prefill_suffix_and_sample,
    unified_step,
)

logger = logging.getLogger("dynamo.torch_engine")

# extra pages a lane takes per growth event, so its page table changes
# every few blocks instead of every block (the JAX engine's default)
GROW_CHUNK_PAGES = 4
# width of the device-checked stop-token set per lane
DEVICE_STOP_WIDTH = 8


def _unsupported(req: PreprocessedRequest) -> Optional[str]:
    """Why the PyTorch engine cannot serve ``req`` yet (None = it can)."""
    if req.mm_embeds:
        return "the PyTorch engine does not serve multimodal prompts yet"
    if req.prompt_logprobs is not None:
        return "the PyTorch engine does not serve prompt logprobs yet"
    return None


class TorchEngine:
    """Continuous-batching PyTorch engine over a paged KV cache."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        params: Params,
        cfg: Optional[EngineConfig] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.cfg = cfg or EngineConfig()
        self.params = params
        self.dtype = torch_dtype(model_cfg.dtype)
        c = self.cfg
        self.kv = PagedKVCache(
            model_cfg, c.num_pages, c.page_size, self.dtype, self.device,
            quantized=pool_is_quantized(c.kv_dtype, model_cfg.dtype),
        )
        self.sched = Scheduler(
            SchedulerConfig(
                max_batch_size=c.max_batch_size,
                max_seq_len=c.max_seq_len,
                page_size=c.page_size,
            ),
            self.kv.allocator,
        )
        self.buckets = prefill_buckets(c.page_size, c.max_seq_len)
        # classic chunks restart at page-aligned offsets: the chunk size
        # rounds up to a whole page
        self._chunk_tokens: Optional[int] = None
        if c.prefill_chunk_tokens is not None:
            ps = c.page_size
            self._chunk_tokens = max(ps, -(-c.prefill_chunk_tokens // ps) * ps)
        self._mixed = bool(c.mixed_batching)
        self._packed = bool(c.packed_ragged)
        # multistep decode rides the packed mixed plane only
        self._multistep = self._mixed and self._packed
        self._mixed_budget = max(int(c.mixed_token_budget), 1)
        self._ms_max = max(int(c.multistep_max_k), 1)
        self._ms_ramp = 1
        # lanes whose classic chunked prefill is under way (one chunk per tick)
        self._chunking: List[SeqState] = []
        # unseeded lanes key their noise on a per-request nonce
        self._nonces = itertools.count(1)
        self._nonce_of: Dict[str, int] = {}
        self._queues: Dict[str, asyncio.Queue] = {}
        self._cancelled: set = set()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._ex = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="torch-engine"
        )
        self._running = False
        self._prefix_hits = 0
        self._prefix_lookups = 0
        self._tokens_generated = 0
        # dispatch counts by kind (prefill, chunk, decode_block, unified) and
        # unified dispatches by fused decode steps K
        self.dispatches: Dict[str, int] = {}
        self.dispatches_by_k: Dict[int, int] = {}

    @classmethod
    def random_init(
        cls,
        model_cfg: ModelConfig,
        cfg: Optional[EngineConfig] = None,
        seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "TorchEngine":
        """An engine over random weights made on ``device`` from ``seed``."""
        device = resolve_device(device)
        params = init_params(model_cfg, seed, device, torch_dtype(model_cfg.dtype))
        return cls(model_cfg, params, cfg, device=device)

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._loop = asyncio.get_running_loop()
        self._wake = asyncio.Event()
        self._task = asyncio.create_task(self._run(), name="torch-engine-loop")

    async def stop(self) -> None:
        self._running = False
        if self._wake is not None:
            self._wake.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        self._ex.shutdown(wait=True)

    # -- AsyncEngine --------------------------------------------------------

    async def generate(self, request: Context[Any]) -> AsyncIterator[Annotated]:
        """Token-level generate; yields Annotated[LLMEngineOutput-dict]."""
        if not self._running:
            await self.start()
        data = request.data
        req = PreprocessedRequest.from_dict(data) if isinstance(data, dict) else data
        ctx = request.ctx
        message = _unsupported(req)
        if message is None:
            seq = SeqState.from_request(request.id, req, self.sched.block_size)
            try:
                self.sched.enqueue(seq)
            except ValueError as e:
                message = str(e)
        if message is not None:

            async def err_stream() -> AsyncIterator[Annotated]:
                yield Annotated.from_error(message)

            return ResponseStream(ctx, err_stream())
        self._nonce_of[request.id] = next(self._nonces) & 0xFFFFFFFF
        queue: asyncio.Queue = asyncio.Queue()
        self._queues[request.id] = queue
        self._wake.set()

        async def stream() -> AsyncIterator[Annotated]:
            try:
                while True:
                    get = asyncio.ensure_future(queue.get())
                    stop_waiter = asyncio.ensure_future(ctx.stopped())
                    done, _ = await asyncio.wait(
                        {get, stop_waiter}, return_when=asyncio.FIRST_COMPLETED
                    )
                    if get not in done:
                        get.cancel()
                        stop_waiter.cancel()
                        self._cancelled.add(request.id)
                        self._wake.set()
                        yield Annotated.from_data(
                            LLMEngineOutput.finished(FinishReason.CANCELLED).to_dict()
                        )
                        return
                    stop_waiter.cancel()
                    item = get.result()
                    if item is None:
                        return
                    yield item
            finally:
                self._queues.pop(request.id, None)
                if ctx.is_killed():
                    self._cancelled.add(request.id)
                    if self._wake is not None:
                        self._wake.set()

        return ResponseStream(ctx, stream())

    def metrics(self) -> ForwardPassMetrics:
        alloc = self.kv.allocator
        hit_rate = (
            self._prefix_hits / self._prefix_lookups if self._prefix_lookups else 0.0
        )
        return ForwardPassMetrics(
            kv_active_blocks=alloc.used_pages,
            kv_total_blocks=alloc.num_pages - 1,
            num_requests_waiting=self.sched.num_waiting,
            gpu_cache_usage_perc=self.kv.usage,
            gpu_prefix_cache_hit_rate=hit_rate,
            request_active_slots=self.sched.num_active,
            request_total_slots=self.cfg.max_batch_size,
        )

    @property
    def tokens_generated(self) -> int:
        return self._tokens_generated

    # -- the tick loop ------------------------------------------------------

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        sched = self.sched

        async def dispatch(fn, *args) -> bool:
            """Run one dispatch-and-commit on the executor thread and stream
            its events; False when it found nothing to dispatch."""
            events = await loop.run_in_executor(self._ex, fn, *args)
            if events:
                self._emit(events)
            return events is not None

        while self._running:
            try:
                self._process_cancellations()
                if (
                    not sched.has_runnable_work
                    and not sched.mix_pending
                    and not self._chunking
                ):
                    self._wake.clear()
                    await self._wake.wait()
                    continue
                plan = sched.plan()
                if sched.num_active > 0:
                    # room for this tick's writes: a fused multistep block
                    # or a classic decode block per lane
                    sched.ensure_decode_capacity(
                        lookahead=self._lookahead(),
                        chunk_pages=GROW_CHUNK_PAGES,
                    )
                mixed_ok = self._mixed_tick_ok()
                if not mixed_ok and sched.mix_pending:
                    self._drain_mixed_to_classic()
                dispatched = False
                # classic chunked prefills advance one chunk per lane, so
                # decode blocks interleave instead of stalling behind one
                # long prompt
                still: List[SeqState] = []
                for seq in self._chunking:
                    if not self._holds_slot(seq) or not seq.prefilling:
                        continue  # cancelled / preempted mid-prefill
                    dispatched |= await dispatch(self._dispatch_chunk, seq)
                    if self._holds_slot(seq) and seq.prefilling:
                        still.append(seq)
                self._chunking = still
                # new admissions: the mixed plane packs them; the classic
                # path batches full prompts by (suffix bucket, prefix-page
                # bucket) and starts long ones chunk by chunk
                groups: Dict[Tuple[int, int], List[Tuple[SeqState, int]]] = {}
                for seq, prompt_len in plan.prefills:
                    if not self._holds_slot(seq):
                        continue  # preempted by this tick's capacity pass
                    if mixed_ok:
                        sched.queue_mixed_prefill(seq, seq.cached_prompt_tokens)
                        continue
                    cached = seq.cached_prompt_tokens
                    if (
                        self._chunk_tokens is not None
                        and prompt_len - cached > self._chunk_tokens
                    ):
                        seq.prefilling = True
                        seq.prefilled_tokens = cached
                        dispatched |= await dispatch(self._dispatch_chunk, seq)
                        if self._holds_slot(seq) and seq.prefilling:
                            self._chunking.append(seq)
                        continue
                    key = (
                        pick_bucket(self.buckets, prompt_len - cached),
                        pick_page_bucket(
                            max(cached // self.cfg.page_size, 1), sched.max_pages
                        )
                        if cached
                        else 0,
                    )
                    groups.setdefault(key, []).append((seq, prompt_len))
                for items in groups.values():
                    dispatched |= await dispatch(self._do_prefill_group, items)
                chunks = (
                    sched.form_mixed_chunks(self._mixed_budget, self._chunk_tokens)
                    if mixed_ok
                    else []
                )
                k = self._multistep_plan_k(chunks) if self._multistep and mixed_ok else 0
                unified = False
                if chunks:
                    unified = await dispatch(self._dispatch_unified, chunks, 1)
                elif k > 0 and sched.num_decode_runnable > 0 and self._has_steppable_lane():
                    unified = await dispatch(self._dispatch_unified, [], k)
                if (
                    not unified
                    and sched.num_decode_runnable > 0
                    and self._has_steppable_lane()
                ):
                    dispatched |= await dispatch(self._dispatch_block)
                if not (dispatched or unified):
                    self._handle_stalled_admission()
                    await asyncio.sleep(0.001)
                await asyncio.sleep(0)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # the engine must never die silently
                logger.exception("engine tick failed")
                sched.mix_pending = []
                self._chunking = []
                self._fail_all(f"engine error: {e}")
                await asyncio.sleep(0.01)

    def _holds_slot(self, seq: SeqState) -> bool:
        return (
            seq.finish is None
            and seq.slot >= 0
            and self.sched.slots[seq.slot] is seq
        )

    def _lookahead(self) -> int:
        """Positions each lane's pages must absorb this tick: K + 1 for a
        fused multistep block, ``decode_block_size + 1`` when a classic
        decode block may run (writes past a lane's pages would land on the
        trash page and stall it)."""
        if self._multistep and self._mixed_tick_ok():
            return self._ms_max + 1
        ms = self._ms_max if self._multistep else 1
        return max(self.cfg.decode_block_size, ms) + 1

    def _multistep_plan_k(self, chunks: List[MixedChunk]) -> int:
        """Decode steps to fuse into this tick's dispatch: pressure (prefill
        chunks, queued, chunking or mid-prefill requests) collapses K to 1,
        each pressure-free tick doubles it toward ``multistep_max_k``."""
        sched = self.sched
        pressure = (
            bool(chunks)
            or bool(sched.waiting)
            or bool(sched.mix_pending)
            or bool(self._chunking)
            or any(s is not None and s.prefilling for s in sched.slots)
        )
        if pressure:
            self._ms_ramp = 1
            return 1
        k = min(self._ms_ramp, self._ms_max)
        self._ms_ramp = min(self._ms_ramp * 2, self._ms_max)
        return k

    # -- penalties: the classic tick takes over -----------------------------

    @staticmethod
    def _seq_penalized(seq: SeqState) -> bool:
        so = seq.sampling
        return bool(
            so.frequency_penalty
            or so.presence_penalty
            or (so.repetition_penalty and so.repetition_penalty != 1.0)
        )

    def _mixed_tick_ok(self) -> bool:
        """Whether this tick may run the unified mixed dispatch: not while
        a penalized lane holds a slot (the unified step carries no penalty
        histograms; the decode block does)."""
        if not self._mixed:
            return False
        return not any(
            s is not None and self._seq_penalized(s) for s in self.sched.slots
        )

    def _drain_mixed_to_classic(self) -> None:
        """Hand pending mixed prefills to the classic chunk path (a
        penalized lane turned the tick classic).  Safe because non-final
        mixed chunks end page-aligned, the suffix prefill's restart rule."""
        for seq in self.sched.mix_pending:
            if self._holds_slot(seq) and seq.prefilling and seq not in self._chunking:
                self._chunking.append(seq)
        self.sched.mix_pending = []

    def _output_tokens(self, seq: SeqState) -> List[int]:
        """The lane's whole committed output: this life's tokens plus the
        tail that recompute preemption folded into the prompt (the last
        ``prior_generated`` prompt entries are earlier lives' output)."""
        folded = (
            list(seq.prompt[len(seq.prompt) - seq.prior_generated :])
            if seq.prior_generated
            else []
        )
        return folded + self.sched._generated_tokens(seq)

    def _penalty_history(self, seq: SeqState) -> Tuple[List[int], List[int]]:
        """(tokens, amounts) of the packed histogram: each output occurrence
        counts 1, each prompt-proper occurrence adds PROMPT_FLAG."""
        out = self._output_tokens(seq)
        ptoks = list(seq.prompt[: len(seq.prompt) - seq.prior_generated])
        return out + ptoks, [1] * len(out) + [PROMPT_FLAG] * len(ptoks)

    def _counts_host(self) -> np.ndarray:
        """Penalty histograms [B, V] rebuilt from the scheduler's mirrors
        (penalized lanes only; other rows stay zero and are never read).
        The serial loop commits every token before the next dispatch, so
        the rebuild is exact."""
        counts = np.zeros(
            (self.cfg.max_batch_size, self.model_cfg.vocab_size), np.int32
        )
        for b, seq in enumerate(self.sched.slots):
            if seq is None or not self._seq_penalized(seq):
                continue
            toks, amounts = self._penalty_history(seq)
            if toks:
                np.add.at(counts[b], np.asarray(toks, np.int64), np.asarray(amounts))
        return counts

    # -- dispatch helpers ---------------------------------------------------

    def _compute_limits(self) -> np.ndarray:
        """Per-lane cache-length caps: the token budget, ``max_seq_len - 1``
        and the lane's allocated pages."""
        sched = self.sched
        limit = np.zeros((self.cfg.max_batch_size,), np.int64)
        for b, seq in enumerate(sched.slots):
            if seq is None:
                continue
            limit[b] = min(
                int(sched.seq_lens[b]) + sched.remaining_budget(seq),
                self.cfg.max_seq_len - 1,
                len(seq.pages) * self.cfg.page_size,
            )
        return limit

    def _has_steppable_lane(self) -> bool:
        sched = self.sched
        limits = self._compute_limits()
        return any(
            s is not None
            and s.finish is None
            and not s.prefilling
            and int(limits[b]) > int(sched.seq_lens[b])
            for b, s in enumerate(sched.slots)
        )

    def _decode_state(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(limits, active, stop_ids) of the decode lanes from the host
        mirrors: a lane decodes when slotted, fully prefilled, unfinished
        and with write headroom."""
        sched = self.sched
        B = self.cfg.max_batch_size
        limits = self._compute_limits()
        active = np.zeros((B,), bool)
        stop_ids = np.full((B, DEVICE_STOP_WIDTH), -1, np.int64)
        for b, s in enumerate(sched.slots):
            if s is None:
                continue
            active[b] = (
                not s.prefilling
                and s.finish is None
                and int(limits[b]) > int(sched.seq_lens[b])
            )
            stop_ids[b] = self._lane_stop_row(s)
        return limits, active, stop_ids

    def _lane_stop_row(self, seq: Optional[SeqState]) -> np.ndarray:
        """Device-swallowable stop tokens for one lane: only when the host
        rules coincide exactly (no min_tokens)."""
        row = np.full((DEVICE_STOP_WIDTH,), -1, np.int64)
        if seq is not None and seq.stop.min_tokens is None:
            ids = list(seq.stop.stop_token_ids_hidden or [])
            if not seq.stop.ignore_eos:
                ids += list(seq.eos_ids)
            for j, t in enumerate(ids[:DEVICE_STOP_WIDTH]):
                row[j] = t
        return row

    def _live_page_bucket(self) -> int:
        """Power-of-two page-table width covering the longest slotted
        lane's allocation (floor 8), the JAX engine's rule."""
        sched = self.sched
        live_pages = [len(s.pages) for s in sched.slots if s is not None and s.pages]
        return pick_page_bucket(
            min(max(8, max(live_pages, default=1)), sched.max_pages),
            sched.max_pages,
        )

    def _sampling_params(self, seqs: Sequence[Optional[SeqState]]) -> SamplingParams:
        """Per-lane sampling settings of ``seqs`` (None = an idle lane)."""
        n = len(seqs)
        temp = np.zeros((n,), np.float32)
        top_p = np.ones((n,), np.float32)
        top_k = np.zeros((n,), np.int64)
        key = np.zeros((n,), np.int64)
        seeded = np.zeros((n,), bool)
        freq = np.zeros((n,), np.float32)
        pres = np.zeros((n,), np.float32)
        rep = np.ones((n,), np.float32)
        for b, s in enumerate(seqs):
            if s is None:
                continue
            so = s.sampling
            if so.temperature is not None:
                temp[b] = so.temperature
            elif so.top_p is not None or so.top_k is not None:
                # unset temperature with explicit top_p/top_k means sample
                temp[b] = 1.0
            top_p[b] = so.top_p if so.top_p is not None else 1.0
            top_k[b] = so.top_k or 0
            if so.seed is not None:
                seeded[b] = True
                key[b] = (int(so.seed) % 0xFFFFFFFF) + 1
            else:
                key[b] = self._nonce_of.get(s.request_id, 0)
            freq[b] = so.frequency_penalty or 0.0
            pres[b] = so.presence_penalty or 0.0
            rep[b] = so.repetition_penalty or 1.0
        put = self._put
        return SamplingParams(
            temperature=put(temp), top_p=put(top_p), top_k=put(top_k),
            key=put(key), seeded=put(seeded), freq=put(freq), pres=put(pres),
            rep=put(rep),
        )

    @staticmethod
    def _needs_filters(so) -> bool:
        has_filter = bool(so.top_k) or (so.top_p is not None and so.top_p < 1.0)
        temp = so.temperature if so.temperature is not None else 1.0
        return has_filter and temp > 0.0

    @staticmethod
    def _lp_top(seqs: Sequence[Optional[SeqState]]) -> int:
        """Top-logprob width of a dispatch: 8 when any lane asked for them."""
        return 8 if any(s is not None and s.sampling.logprobs for s in seqs) else 0

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _count(self, kind: str) -> None:
        self.dispatches[kind] = self.dispatches.get(kind, 0) + 1

    def _note_prefix_stats(self, seq: SeqState) -> None:
        """Prefix-cache stats, token-weighted, once per request."""
        if not seq.stats_counted:
            seq.stats_counted = True
            self._prefix_lookups += len(seq.prompt)
            self._prefix_hits += seq.cached_prompt_tokens

    # -- unified and decode-block dispatches (executor thread) ---------------

    def _dispatch_unified(
        self, chunks: List[MixedChunk], num_steps: int
    ) -> Optional[List[StepEvent]]:
        """Assemble one unified mixed dispatch from the host mirrors (packed
        axis, or the [B, S] rectangle), run it and commit its sampled block;
        None when there was nothing to dispatch."""
        sched = self.sched
        B = self.cfg.max_batch_size
        p_start = np.zeros((B,), np.int64)
        p_lens = np.zeros((B,), np.int64)
        p_sample = np.zeros((B,), bool)
        chunk_by_slot: Dict[int, MixedChunk] = {}
        for ch in chunks:
            b = ch.seq.slot
            chunk_by_slot[b] = ch
            p_start[b] = ch.start
            p_lens[b] = ch.length
            p_sample[b] = ch.final
            self._note_prefix_stats(ch.seq)
        limits, active, stop_ids = self._decode_state()
        # host bookkeeping advances at dispatch: a final chunk hands its
        # lane to decode
        for ch in chunks:
            ch.seq.prefilled_tokens = ch.start + ch.length
            if ch.final:
                ch.seq.prefilling = False
        dec_cap = active & (p_lens == 0)
        q_host = np.where(dec_cap, 1, p_lens).astype(np.int64)
        total = int(q_host.sum())
        if total == 0:
            return None
        slots = list(sched.slots)
        use_filters = any(s is not None and self._needs_filters(s.sampling) for s in slots)
        top_n = self._lp_top(slots)
        put = self._put
        state = (
            put(sched.tokens.astype(np.int64)), put(sched.seq_lens.astype(np.int64)),
            put(limits), put(active), put(stop_ids),
            put(np.ascontiguousarray(sched.page_table[:, : self._live_page_bucket()])),
        )
        lanes = (put(p_start), put(p_lens), put(p_sample), put(p_sample.copy()))
        with torch.inference_mode():
            if self._packed:
                packed = self._run_packed(
                    state, lanes, chunk_by_slot, q_host, dec_cap, total, slots,
                    num_steps, top_n, use_filters,
                )
            else:
                S = pow2_bucket(max((ch.length for ch in chunks), default=1))
                p_tokens = np.zeros((B, S), np.int64)
                for ch in chunks:
                    p_tokens[ch.seq.slot, : ch.length] = ch.seq.prompt[
                        ch.start : ch.start + ch.length
                    ]
                packed, *_ = unified_step(
                    self.params, self.model_cfg, self.kv.pages, *state,
                    put(p_tokens), *lanes, self._sampling_params(slots), top_n,
                    use_filters,
                )
                packed = packed[:, None]
            mat = packed.cpu().numpy()
        self._count("unified")
        self.dispatches_by_k[num_steps] = self.dispatches_by_k.get(num_steps, 0) + 1
        return self._commit_block(mat, slots)

    def _run_packed(
        self, state, lanes, chunk_by_slot, q_host, dec_cap, total, slots,
        num_steps, top_n, use_filters,
    ) -> torch.Tensor:
        """The packed layout: segments in slot order on one flat axis,
        padded to a power of two that holds every live lane's ``s_max``
        window.  Returns ``packed [B, num_steps, 2 + 2*top_n]``."""
        B = self.cfg.max_batch_size
        s_max = pow2_bucket(int(q_host.max()))
        seg_off = np.zeros((B,), np.int64)
        off = off_last = 0
        for b in range(B):
            if q_host[b]:
                seg_off[b] = off_last = off
                off += int(q_host[b])
        Np = packed_axis_len(s_max, off_last, total)
        t_tokens = np.zeros((Np,), np.int64)
        t_lane = np.full((Np,), B, np.int64)
        t_rel = np.zeros((Np,), np.int64)
        t_dec = np.zeros((Np,), bool)
        for b in range(B):
            ql = int(q_host[b])
            if ql == 0:
                continue
            o = int(seg_off[b])
            t_lane[o : o + ql] = b
            t_rel[o : o + ql] = np.arange(ql)
            ch = chunk_by_slot.get(b)
            if ch is not None:
                t_tokens[o : o + ql] = ch.seq.prompt[ch.start : ch.start + ql]
            else:
                t_dec[o] = True
        put = self._put
        packed, *_ = packed_unified_multistep(
            self.params, self.model_cfg, self.kv.pages, *state,
            put(t_tokens), put(t_lane), put(t_rel), put(t_dec), *lanes,
            put(dec_cap), put(seg_off), self._sampling_params(slots),
            s_max, num_steps, top_n, use_filters,
        )
        return packed

    def _dispatch_block(self) -> Optional[List[StepEvent]]:
        """One classic decode block of ``decode_block_size`` steps over the
        decode lanes, with penalty histograms when a lane asked for
        penalties; commits its sampled block."""
        sched = self.sched
        if sched.num_active == 0:
            return None
        limits, active, stop_ids = self._decode_state()
        slots = list(sched.slots)
        use_filters = any(s is not None and self._needs_filters(s.sampling) for s in slots)
        use_penalties = any(s is not None and self._seq_penalized(s) for s in slots)
        put = self._put
        with torch.inference_mode():
            packed, *_ = decode_block(
                self.params, self.model_cfg, self.kv.pages,
                put(sched.tokens.astype(np.int64)),
                put(sched.seq_lens.astype(np.int64)),
                put(limits), put(active), put(stop_ids),
                put(np.ascontiguousarray(sched.page_table[:, : self._live_page_bucket()])),
                self._sampling_params(slots), self.cfg.decode_block_size,
                use_filters, self._lp_top(slots),
                put(self._counts_host()) if use_penalties else None,
                use_penalties,
            )
            mat = packed.cpu().numpy()
        self._count("decode_block")
        return self._commit_block(mat, slots)

    def _commit_block(
        self, mat: np.ndarray, slots: List[Optional[SeqState]]
    ) -> List[StepEvent]:
        N = (mat.shape[-1] - 2) // 2
        toks, lps, tids, tlps = unpack_sampled_logprobs(mat, N)
        return self.sched.commit_block(
            toks, slots, lps, tids if N else None, tlps if N else None
        )

    # -- classic prefill dispatches (executor thread) -----------------------

    def _dispatch_full_prefill_batch(
        self, seqs: List[SeqState], Bp: int
    ) -> torch.Tensor:
        """Full-prompt prefills plus first-token samples for up to ``Bp``
        lanes; rows past ``len(seqs)`` are pad lanes (length 0, trash page).
        Returns the packed samples ``[Bp, 2 + 2*top_n]``."""
        bucket = pick_bucket(self.buckets, max(len(s.prompt) for s in seqs))
        n_pages = bucket // self.cfg.page_size
        tokens = np.zeros((Bp, bucket), np.int64)
        lens = np.zeros((Bp,), np.int64)
        table = np.zeros((Bp, n_pages), np.int32)
        lanes: List[Optional[SeqState]] = [None] * Bp
        for i, seq in enumerate(seqs):
            tokens[i, : len(seq.prompt)] = seq.prompt
            lens[i] = len(seq.prompt)
            # the lane may hold growth pages past the prompt already;
            # prefill writes within the bucket's pages only
            k = min(len(seq.pages), n_pages)
            table[i, :k] = seq.pages[:k]
            lanes[i] = seq
        put = self._put
        with torch.inference_mode():
            return prefill_and_sample(
                self.params, self.model_cfg, self.kv.pages, put(tokens),
                put(lens), put(table), self._sampling_params(lanes),
                self._lp_top(lanes), any(self._seq_penalized(s) for s in seqs),
            )

    def _dispatch_suffix_prefill_batch(
        self, entries: List[Tuple[SeqState, int, int]], Bp: int
    ) -> torch.Tensor:
        """Suffix prefills over resident prefixes for up to ``Bp`` lanes;
        ``entries`` are (seq, end, start): the lane prefills prompt
        positions ``start..end`` (``start`` page-aligned) and samples at
        ``end``.  Returns the packed samples ``[Bp, 2 + 2*top_n]``."""
        ps = self.cfg.page_size
        bucket = pick_bucket(self.buckets, max(end - start for _, end, start in entries))
        n_suffix_pages = bucket // ps
        prefix_P = pick_page_bucket(
            max(max(start for _, _, start in entries) // ps, 1), self.sched.max_pages
        )
        tokens = np.zeros((Bp, bucket), np.int64)
        offsets = np.zeros((Bp,), np.int64)
        suffix_lens = np.zeros((Bp,), np.int64)
        prefix_table = np.zeros((Bp, prefix_P), np.int32)
        suffix_table = np.zeros((Bp, n_suffix_pages), np.int32)
        lanes: List[Optional[SeqState]] = [None] * Bp
        for i, (seq, end, start) in enumerate(entries):
            tokens[i, : end - start] = seq.prompt[start:end]
            offsets[i] = start
            suffix_lens[i] = end - start
            npp = start // ps
            prefix_table[i, :npp] = seq.pages[:npp]
            k = min(len(seq.pages) - npp, n_suffix_pages)
            suffix_table[i, :k] = seq.pages[npp : npp + k]
            lanes[i] = seq
        put = self._put
        with torch.inference_mode():
            return prefill_suffix_and_sample(
                self.params, self.model_cfg, self.kv.pages, put(tokens),
                put(offsets), put(suffix_lens), put(prefix_table),
                put(suffix_table), self._sampling_params(lanes),
                self._lp_top(lanes),
                any(self._seq_penalized(s) for s, _, _ in entries),
            )

    def _commit_prefill(
        self, packed: torch.Tensor, seqs: List[SeqState]
    ) -> List[StepEvent]:
        """Commit each lane's first token (row i of ``packed``)."""
        mat = packed.cpu().numpy()
        N = (mat.shape[-1] - 2) // 2
        events: List[StepEvent] = []
        for i, seq in enumerate(seqs):
            if not self._holds_slot(seq) or seq.num_generated > 0:
                continue
            tok, lp, tids, tlps = unpack_sampled_logprobs(mat[i], N)
            top = [[int(t), float(l)] for t, l in zip(tids, tlps)] if N else None
            events.append(
                self.sched.commit_prefill_token(seq, int(tok), float(lp), top)
            )
        return events

    def _do_prefill_group(
        self, items: List[Tuple[SeqState, int]]
    ) -> List[StepEvent]:
        """One prefill dispatch for a group of same-shape admissions (one
        suffix bucket, one prefix-page bucket), the batch padded to a power
        of two; commits every lane's first token."""
        seqs = [seq for seq, _ in items]
        for seq in seqs:
            self._note_prefix_stats(seq)
        Bp = pow2_bucket(len(seqs))
        if not any(seq.cached_prompt_tokens for seq in seqs):
            packed = self._dispatch_full_prefill_batch(seqs, Bp)
        else:
            packed = self._dispatch_suffix_prefill_batch(
                [(seq, pl, seq.cached_prompt_tokens) for seq, pl in items], Bp
            )
        self._count("prefill")
        return self._commit_prefill(packed, seqs)

    def _dispatch_chunk(self, seq: SeqState) -> List[StepEvent]:
        """Advance one page-aligned chunk of a classic chunked prefill.  An
        intermediate chunk writes KV and samples nothing; the last one (or,
        with chunking off, the rest of a prompt drained from the mixed
        plane) samples the first token and hands the lane to decode."""
        self._note_prefix_stats(seq)
        prompt_len = len(seq.prompt)
        start = seq.prefilled_tokens
        chunk = self._chunk_tokens
        if chunk is None or prompt_len - start <= chunk:
            seq.prefilling = False
            if start > 0:
                packed = self._dispatch_suffix_prefill_batch(
                    [(seq, prompt_len, start)], 1
                )
            else:
                packed = self._dispatch_full_prefill_batch([seq], 1)
            self._count("prefill")
            return self._commit_prefill(packed, [seq])
        self._dispatch_suffix_prefill_batch([(seq, start + chunk, start)], 1)
        seq.prefilled_tokens = start + chunk
        self._count("chunk")
        return []

    # -- events -------------------------------------------------------------

    def _emit(self, events: List[StepEvent]) -> None:
        for ev in events:
            queue = self._queues.get(ev.seq.request_id)
            self._tokens_generated += len(ev.tokens)
            if queue is None:
                continue
            if ev.tokens:
                out = LLMEngineOutput(token_ids=list(ev.tokens))
                want = ev.seq.sampling.logprobs
                if want is not None and ev.logprobs:
                    out.logprobs = list(ev.logprobs)
                    if want > 0 and ev.top_logprobs is not None:
                        out.top_logprobs = [t[:want] for t in ev.top_logprobs]
                queue.put_nowait(Annotated.from_data(out.to_dict()))
            if ev.finished is not None:
                self._nonce_of.pop(ev.seq.request_id, None)
                queue.put_nowait(
                    Annotated.from_data(LLMEngineOutput.finished(ev.finished).to_dict())
                )
                queue.put_nowait(None)

    def _fail_seq(self, seq: SeqState, message: str) -> None:
        if seq.finish is None:
            seq.finish = FinishReason.ERROR
        self._nonce_of.pop(seq.request_id, None)
        queue = self._queues.get(seq.request_id)
        if queue is not None:
            queue.put_nowait(Annotated.from_error(message))
            queue.put_nowait(None)

    def _fail_all(self, message: str) -> None:
        for seq in list(self.sched.waiting) + [
            s for s in self.sched.slots if s is not None
        ]:
            self._fail_seq(seq, message)
            self.sched.cancel(seq)

    def _process_cancellations(self) -> None:
        if not self._cancelled:
            return
        by_id = {s.request_id: s for s in self.sched.slots if s is not None}
        by_id.update({s.request_id: s for s in self.sched.waiting})
        for rid in list(self._cancelled):
            self._cancelled.discard(rid)
            self._nonce_of.pop(rid, None)
            seq = by_id.get(rid)
            if seq is not None:
                self.sched.cancel(seq)

    def _handle_stalled_admission(self) -> None:
        """Nothing running, nothing admitted: a request whose prompt can
        never fit the page pool fails instead of spinning the loop."""
        sched = self.sched
        if sched.num_active > 0 or not sched.waiting:
            return
        head = sched.waiting[0]
        if sched.min_total_pages(head) <= sched.pool.num_pages - 1:
            return
        sched.waiting.popleft()
        self._fail_seq(head, "request needs more KV pages than the pool holds")
