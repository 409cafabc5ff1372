"""TorchEngine: the PyTorch engine behind the AsyncEngine interface.

``generate(Context[PreprocessedRequest]) -> AsyncIterator[Annotated[
LLMEngineOutput-dict]]`` -- the serving interface of the JAX package's
``JaxEngine``, driven by the same scheduler rules, over the same packed
unified dispatch:

* every tick plans admissions, grows page tables (preempting by recompute
  when the pool runs dry), packs prefill chunks and decode rows onto one
  flat token axis and runs ONE unified step;
* a pressure-free decode tick fuses up to ``multistep_max_k`` decode steps
  into that dispatch (the adaptive ramp of the JAX engine's
  ``_multistep_plan_k``);
* the host commits the sampled block right away, replaying the stop rules
  (``Scheduler.commit_block``), and streams the tokens.

The tick loop is serial: each dispatch commits before the next is planned,
so the device-side decode state is rebuilt from the scheduler's mirrors at
every dispatch (a few B-sized arrays) and nothing is carried between ticks
but the KV pool.  Device work runs on one executor thread; the event loop
keeps serving I/O meanwhile.

Not served yet (later slices): sampling penalties, multimodal prompts and
prompt logprobs (such a request gets an error frame), speculative decoding
(its request fields are ignored: output is the contract, speculation an
optimization), async double-buffering, offload/swap, disaggregation,
tensor/data parallelism and int8 pools.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import itertools
import logging
from typing import Any, AsyncIterator, Dict, List, Optional, Union

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
from .bucketing import packed_axis_len, pick_page_bucket, pow2_bucket
from .config import EngineConfig, ModelConfig
from .kv_cache import PagedKVCache, torch_dtype
from .model import Params, init_params
from .sampling import SamplingParams, unpack_sampled_logprobs
from .scheduler import MixedChunk, Scheduler, SchedulerConfig, SeqState, StepEvent
from .step import packed_unified_multistep

logger = logging.getLogger("dynamo.torch_engine")

# extra pages a lane takes per growth event, so its page table changes
# every few blocks instead of every block (the JAX engine's default)
GROW_CHUNK_PAGES = 4
# width of the device-checked stop-token set per lane
DEVICE_STOP_WIDTH = 8


def _unsupported(req: PreprocessedRequest) -> Optional[str]:
    """Why the PyTorch engine cannot serve ``req`` yet (None = it can)."""
    so = req.sampling_options
    if (
        so.frequency_penalty
        or so.presence_penalty
        or (so.repetition_penalty and so.repetition_penalty != 1.0)
    ):
        return "the PyTorch engine does not serve sampling penalties yet"
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
            model_cfg, c.num_pages, c.page_size, self.dtype, self.device
        )
        self.sched = Scheduler(
            SchedulerConfig(
                max_batch_size=c.max_batch_size,
                max_seq_len=c.max_seq_len,
                page_size=c.page_size,
            ),
            self.kv.allocator,
        )
        self._mixed_budget = max(int(c.mixed_token_budget), 1)
        self._ms_max = max(int(c.multistep_max_k), 1)
        self._ms_ramp = 1
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
        # dispatch counts by fused decode steps K
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
        while self._running:
            try:
                self._process_cancellations()
                if not sched.has_runnable_work and not sched.mix_pending:
                    self._wake.clear()
                    await self._wake.wait()
                    continue
                plan = sched.plan()
                if sched.num_active > 0:
                    # room for this tick's block: up to K writes per lane
                    sched.ensure_decode_capacity(
                        lookahead=self._ms_max + 1,
                        chunk_pages=GROW_CHUNK_PAGES,
                    )
                for seq, _prompt_len in plan.prefills:
                    if seq.slot >= 0 and sched.slots[seq.slot] is seq:
                        sched.queue_mixed_prefill(seq, seq.cached_prompt_tokens)
                chunks = sched.form_mixed_chunks(self._mixed_budget)
                k = self._multistep_plan_k(chunks)
                events: Optional[List[StepEvent]] = None
                if chunks or (
                    sched.num_decode_runnable > 0 and self._has_steppable_lane()
                ):
                    events = await loop.run_in_executor(
                        self._ex, self._dispatch_and_commit, chunks, k
                    )
                if events:
                    self._emit(events)
                if events is None:
                    self._handle_stalled_admission()
                    await asyncio.sleep(0.001)
                await asyncio.sleep(0)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # the engine must never die silently
                logger.exception("engine tick failed")
                sched.mix_pending = []
                self._fail_all(f"engine error: {e}")
                await asyncio.sleep(0.01)

    def _multistep_plan_k(self, chunks: List[MixedChunk]) -> int:
        """Decode steps to fuse into this tick's dispatch: pressure (prefill
        chunks, queued or mid-prefill requests) collapses K to 1, each
        pressure-free tick doubles it toward ``multistep_max_k``."""
        sched = self.sched
        pressure = (
            bool(chunks)
            or bool(sched.waiting)
            or bool(sched.mix_pending)
            or any(s is not None and s.prefilling for s in sched.slots)
        )
        if pressure:
            self._ms_ramp = 1
            return 1
        k = min(self._ms_ramp, self._ms_max)
        self._ms_ramp = min(self._ms_ramp * 2, self._ms_max)
        return k

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

    def _sampling_params(self) -> SamplingParams:
        B = self.cfg.max_batch_size
        temp = np.zeros((B,), np.float32)
        top_p = np.ones((B,), np.float32)
        top_k = np.zeros((B,), np.int64)
        key = np.zeros((B,), np.int64)
        seeded = np.zeros((B,), bool)
        for b, s in enumerate(self.sched.slots):
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
        dev = self.device
        return SamplingParams(
            temperature=torch.from_numpy(temp).to(dev),
            top_p=torch.from_numpy(top_p).to(dev),
            top_k=torch.from_numpy(top_k).to(dev),
            key=torch.from_numpy(key).to(dev),
            seeded=torch.from_numpy(seeded).to(dev),
        )

    @staticmethod
    def _needs_filters(so) -> bool:
        has_filter = bool(so.top_k) or (so.top_p is not None and so.top_p < 1.0)
        temp = so.temperature if so.temperature is not None else 1.0
        return has_filter and temp > 0.0

    def _dispatch_and_commit(
        self, chunks: List[MixedChunk], num_steps: int
    ) -> List[StepEvent]:
        """Assemble the packed dispatch from the host mirrors, run it, and
        commit its sampled block (executor thread)."""
        sched = self.sched
        B = self.cfg.max_batch_size
        p_start = np.zeros((B,), np.int64)
        p_lens = np.zeros((B,), np.int64)
        p_sample = np.zeros((B,), bool)
        chunk_by_slot: Dict[int, MixedChunk] = {}
        for ch in chunks:
            seq = ch.seq
            b = seq.slot
            chunk_by_slot[b] = ch
            p_start[b] = ch.start
            p_lens[b] = ch.length
            p_sample[b] = ch.final
            if not seq.stats_counted:
                seq.stats_counted = True
                self._prefix_lookups += len(seq.prompt)
                self._prefix_hits += seq.cached_prompt_tokens
        limits = self._compute_limits()
        active = np.zeros((B,), bool)
        stop_ids = np.full((B, DEVICE_STOP_WIDTH), -1, np.int64)
        for b, s in enumerate(sched.slots):
            if s is None:
                continue
            # decode-active: slotted, fully prefilled, with write headroom
            active[b] = (
                not s.prefilling
                and s.finish is None
                and int(limits[b]) > int(sched.seq_lens[b])
            )
            stop_ids[b] = self._lane_stop_row(s)
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
            return []
        s_max = pow2_bucket(int(q_host.max()))
        seg_off = np.zeros((B,), np.int64)
        off = 0
        off_last = 0
        for b in range(B):
            if q_host[b]:
                seg_off[b] = off
                off_last = off
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
        live_pages = [len(s.pages) for s in sched.slots if s is not None and s.pages]
        Pb = pick_page_bucket(
            min(max(8, max(live_pages, default=1)), sched.max_pages),
            sched.max_pages,
        )
        use_filters = any(
            s is not None and self._needs_filters(s.sampling) for s in sched.slots
        )
        top_n = (
            8
            if any(s is not None and s.sampling.logprobs for s in sched.slots)
            else 0
        )
        dev = self.device

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(dev)

        slots = list(sched.slots)
        with torch.inference_mode():
            packed, _tokens, _seq, _active = packed_unified_multistep(
                self.params, self.model_cfg, self.kv.pages,
                put(sched.tokens.astype(np.int64)),
                put(sched.seq_lens.astype(np.int64)),
                put(limits), put(active), put(stop_ids),
                put(np.ascontiguousarray(sched.page_table[:, :Pb])),
                put(t_tokens), put(t_lane), put(t_rel), put(t_dec),
                put(p_start), put(p_lens), put(p_sample), put(p_sample.copy()),
                put(dec_cap), put(seg_off), self._sampling_params(),
                s_max, num_steps, top_n, use_filters,
            )
            mat = packed.cpu().numpy()
        self.dispatches_by_k[num_steps] = self.dispatches_by_k.get(num_steps, 0) + 1
        N = (mat.shape[-1] - 2) // 2
        toks, lps, tids, tlps = unpack_sampled_logprobs(mat, N)
        return sched.commit_block(
            toks, slots, lps, tids if N else None, tlps if N else None
        )

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
