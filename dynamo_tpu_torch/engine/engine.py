"""TorchEngine: the PyTorch engine behind the AsyncEngine interface.

``generate(Context[PreprocessedRequest]) -> AsyncIterator[Annotated[
LLMEngineOutput-dict]]`` -- the serving interface of the JAX package's
``JaxEngine``, driven by the same scheduler rules, the same dispatches and
the same pipelined tick loop.  Every tick plans admissions and grows page
tables (preempting by recompute when the pool runs dry), then takes one of
two shapes:

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
  device-carried penalty histograms.  Mixed prefills still pending when a
  penalized lane arrives drain to the classic chunk path (mixed chunk ends
  are page-aligned for exactly this).

The loop is the JAX engine's pipelined one.  The decode state (last token,
cache length, limit, active flag, stop tokens, page table, sampling
settings and penalty histograms) lives on the device in persistent tensors
with one spare row for pad scatters; it is rebuilt only when none exists,
and otherwise brought current with row scatters for dirty lanes and a
page-table and limit swap on growth.  A prefill's first token goes into it
on the device before the host has seen it (a pending inject, re-applied
over any later row scatter of its lane).  Each dispatch enqueues its work
and a non-blocking copy of its sampled rows into a pinned host buffer of
its own, then records a CUDA event; the host commits a dispatch
generation (replaying the stop rules, ``Scheduler.commit_block`` /
``commit_prefill_token``) once its event has completed or when the
pipeline is full: two generations deep with ``async_dispatch`` (the
default), one without.  A classic prefill dispatch commits as soon as
it lands, within its tick, so its first tokens stream then and not with
the tick's decode block.  Streams go out through a bounded fanout worker.  Token streams are the
same in both modes.  On the card the decode-only dispatches replay CUDA
graphs (``graphs.py``), and each dispatch's device span and the gap
before it are timed on CUDA events (``dispatch_spans``).  Device work
runs on one executor thread; the event loop keeps serving I/O meanwhile.

Not served yet (later slices): multimodal prompts and prompt logprobs
(such a request gets an error frame), speculative decoding (its request
fields are ignored: output is the contract, speculation an optimization),
offload/swap and external-KV deliveries, disaggregation, tensor/data
parallelism, the tick profiler and engine metrics, the
``DYN_ASYNC_DISPATCH`` and ``DYN_PACKED_SHAPE_BUDGET`` overrides, and CUDA
graphs for dispatches that carry prefill chunks.  The KV pool is dense in
the model's dtype or, with ``EngineConfig(kv_dtype="int8")``, int8 with
per-row scales; a dense pool of another dtype is refused at construction,
and so is, on the card, a head geometry its kernels do not take (the CPU
serves any).
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import itertools
import logging
from dataclasses import dataclass, field
from typing import (
    Any, AsyncIterator, Deque, Dict, Hashable, List, Optional, Sequence, Tuple, Union,
)

import numpy as np
import torch

from ..device import resolve_device
from ..ops.build import check_geometry
from ..protocols.common import (
    FinishReason,
    ForwardPassMetrics,
    LLMEngineOutput,
    PreprocessedRequest,
)
from ..runtime.engine import Annotated, Context, ResponseStream
from .bucketing import (
    PackedShapeBudget,
    pick_bucket,
    pick_page_bucket,
    pow2_bucket,
    prefill_buckets,
)
from .config import EngineConfig, ModelConfig
from .graphs import StepGraphs
from .kv_cache import PagedKVCache, pool_is_quantized, torch_dtype
from .model import Params, init_params
from .sampling import PROMPT_FLAG, SamplingParams, unpack_sampled_logprobs
from .scheduler import MixedChunk, Scheduler, SchedulerConfig, SeqState, StepEvent
from .step import (
    LANE_ROWS,
    StepFn,
    StepRunner,
    bump_counts,
    decode_block,
    inject_token,
    inject_tokens,
    packed_unified_multistep,
    prefill_and_sample,
    prefill_suffix_and_sample,
    seed_count_rows,
    unified_step,
    update_lanes,
    zero_count_rows,
)

logger = logging.getLogger("dynamo.torch_engine")

# extra pages a lane takes per growth event, so its page table changes
# every few blocks instead of every block (the JAX engine's default)
GROW_CHUNK_PAGES = 4
# width of the device-checked stop-token set per lane
DEVICE_STOP_WIDTH = 8
# bound of the stream fanout queue (async mode): a slow consumer
# backpressures the tick loop here
FANOUT_DEPTH = 64
# budget of the packed step's (Np, s_max) shapes, the JAX engine's default
PACKED_SHAPE_BUDGET = 16


def check_model_geometry(model_cfg: ModelConfig, device: torch.device) -> None:
    """Refuse a model whose head geometry the device's kernels do not take
    (``check_geometry``, the wrappers' own rule): at construction, not at
    the first dispatch.  The CPU serves any geometry."""
    check_geometry(
        device, torch_dtype(model_cfg.dtype), model_cfg.num_heads,
        model_cfg.num_kv_heads, model_cfg.head_dim,
    )


def _unsupported(req: PreprocessedRequest) -> Optional[str]:
    """Why the PyTorch engine cannot serve ``req`` yet (None = it can)."""
    if req.mm_embeds:
        return "the PyTorch engine does not serve multimodal prompts yet"
    if req.prompt_logprobs is not None:
        return "the PyTorch engine does not serve prompt logprobs yet"
    return None


# -- dispatched-but-uncommitted work ----------------------------------------


@dataclass
class Result:
    """A dispatch's sampled rows on their way to the host: the pinned host
    buffer its non-blocking copy lands in and the event recorded after that
    copy (on the card), or the computed CPU tensor itself (no event)."""

    host: torch.Tensor
    event: Optional["torch.cuda.Event"] = None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _handles_ready(res: Result) -> bool:
    """Non-blocking readiness probe of a dispatched result: True once its
    host copy has landed, so the commit reads it without waiting.  THE
    readiness primitive of the pipelined loop; a CPU result is ready once
    it is computed."""
    return res.event is None or res.event.query()


@dataclass
class InflightPrefill:
    """A lane's dispatched-but-uncommitted first token: it lives on the
    device (already injected into the decode state, ``tok`` a device view
    for the re-apply path) until the host commits it.  ``sampled`` is set
    when the prefill is a dispatch of its own; inside a group or a unified
    dispatch the parent's rows carry it."""

    tok: torch.Tensor  # [1] device view of the sampled token
    seq: SeqState
    slot: int
    life: int
    sampled: Optional[Result] = None


@dataclass
class InflightPrefillGroup:
    """A batched prefill dispatch awaiting commit: the whole group's
    packed first-token rows ``[Bp, 2 + 2N]`` in one result."""

    sampled: Result
    entries: List[InflightPrefill]


@dataclass
class InflightBlock:
    """A dispatched-but-uncommitted decode block: packed ``[B, K, 2 + 2N]``
    rows and the slot mapping (and slot lives) at dispatch."""

    sampled: Result
    slots: List[Optional[SeqState]]
    lives: List[int]


@dataclass
class InflightUnified:
    """A dispatched-but-uncommitted unified step: packed ``[B, K, 2 + 2N]``
    rows of its decode lanes and final prefill chunks (K fused decode
    steps; 1 with chunks or on the rectangle), the slot mapping at
    dispatch, and an :class:`InflightPrefill` per lane whose prompt
    completed (its first token already folded into the device state by
    the step; the record backs the pending-inject re-apply path)."""

    sampled: Result
    slots: List[Optional[SeqState]]
    lives: List[int]
    finals: List[InflightPrefill] = field(default_factory=list)
    n_steps: int = 1


Inflight = Union[InflightPrefill, InflightPrefillGroup, InflightBlock, InflightUnified]


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
        check_model_geometry(model_cfg, self.device)
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
        # whether the previous tick's dispatches sampled a first token
        self._firsts_last_tick = False
        # dispatch generations the loop may carry uncommitted
        self._pipe_depth = 2 if c.async_dispatch else 1
        self._packed_shapes = PackedShapeBudget(PACKED_SHAPE_BUDGET)
        self.graphs = StepGraphs(self.device)
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
        self._fanout_q: Optional[asyncio.Queue] = None
        self._fanout_task: Optional[asyncio.Task] = None
        self._ex = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="torch-engine"
        )
        self._running = False
        self._stopped = False
        self._prefix_hits = 0
        self._prefix_lookups = 0
        self._tokens_generated = 0
        # dispatch counts by kind (prefill, chunk, decode_block, unified) and
        # unified dispatches by fused decode steps K
        self.dispatches: Dict[str, int] = {}
        self.dispatches_by_k: Dict[int, int] = {}
        # classic prefill dispatches by route: full prompts (flash prefill)
        # and suffixes over a resident prefix, chunks included
        # (prefix-suffix flash prefill)
        self.prefill_dispatches: Dict[str, int] = {"full": 0, "suffix": 0}
        self._init_device_state()
        # dispatch spans on CUDA events (card only): (kind, start, end)
        # awaiting their end event, None marking an idle loop (no gap is
        # counted across it); per kind: spans, device ms, gap ms before them
        self._spans: Deque[Optional[Tuple[str, Any, Any]]] = collections.deque()
        self._last_end: Optional[Any] = None
        self.span_stats: Dict[str, Dict[str, float]] = {}

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
        check_model_geometry(model_cfg, device)
        params = init_params(model_cfg, seed, device, torch_dtype(model_cfg.dtype))
        return cls(model_cfg, params, cfg, device=device)

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._loop = asyncio.get_running_loop()
        self._wake = asyncio.Event()
        if self._pipe_depth > 1:
            self._fanout_q = asyncio.Queue(maxsize=FANOUT_DEPTH)
            self._fanout_task = asyncio.create_task(
                self._fanout_worker(), name="torch-engine-fanout"
            )
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
        # drain the fanout lane after the tick loop stops producing: every
        # committed event batch reaches its stream, then the worker exits
        if self._fanout_task is not None:
            assert self._fanout_q is not None
            await self._fanout_q.put(None)
            try:
                await asyncio.wait_for(self._fanout_task, timeout=5.0)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                self._fanout_task.cancel()
            while not self._fanout_q.empty():
                item = self._fanout_q.get_nowait()
                if item is not None:
                    self._deliver(item)
            self._fanout_task = None
            self._fanout_q = None
        if not self._stopped:
            self._stopped = True
            self._ex.submit(self._drain_spans, True).result()
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

    @property
    def graph_captures(self) -> int:
        """CUDA graphs captured (the JAX compile sentry's count)."""
        return self.graphs.captures

    @property
    def graph_replays(self) -> Dict[str, int]:
        """CUDA graph replays by dispatch kind."""
        return dict(self.graphs.replays)

    def dispatch_spans(self) -> Dict[str, Dict[str, float]]:
        """Per dispatch kind, from CUDA events (card only): ``n`` spans
        read, ``device_ms`` from each dispatch's first launch to its last,
        and ``gap_ms`` from the previous dispatch's end to its start (idle
        loops excluded).  A kind ending in ``/graph`` holds the dispatches
        that replayed a CUDA graph: their spans are device time alone,
        while an eager dispatch's span also holds the device's waits for
        the host's launches.  Spans whose end has not completed are not
        read yet; ``stop()`` reads them all."""
        # one C-level copy of the items: the executor thread may add a kind
        return {k: dict(v) for k, v in list(self.span_stats.items())}

    # -- the tick loop ------------------------------------------------------

    async def _on_executor(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(
            self._ex, self._inference, fn, *args
        )

    @staticmethod
    def _inference(fn, *args):
        with torch.inference_mode():
            return fn(*args)

    def _entries_ready(self, entries: List[Inflight]) -> bool:
        """Non-blocking probe: have this generation's results landed?"""
        return all(_handles_ready(e.sampled) for e in entries)

    async def _emit_events(self, events: List[StepEvent]) -> None:
        """Hand a commit's events to the streams: the bounded fanout queue
        in async mode (a full queue backpressures the tick), directly in
        serial mode."""
        if not events:
            return
        if self._fanout_q is not None:
            await self._fanout_q.put(events)
        else:
            self._deliver(events)

    async def _fanout_worker(self) -> None:
        """Async-mode stream fanout: one FIFO consumer does the per-request
        queue puts off the tick coroutine.  Exits on the ``None`` sentinel
        ``stop()`` enqueues after the tick loop halts; everything enqueued
        before it still delivers."""
        assert self._fanout_q is not None
        while True:
            item = await self._fanout_q.get()
            if item is None:
                return
            try:
                self._deliver(item)
            except Exception:  # fanout must never kill the worker
                logger.exception("stream fanout failed")

    async def _commit_ready(self, inflight: Deque[List[Inflight]], allowed: int) -> None:
        """Commit the oldest generations while the pipeline holds more than
        ``allowed`` or (async mode) the oldest has landed."""
        while inflight and (
            len(inflight) > allowed
            or (self._pipe_depth > 1 and self._entries_ready(inflight[0]))
        ):
            events = await self._on_executor(self._commit_all, inflight.popleft())
            await self._emit_events(events)

    async def _commit_prefill(self, entries: List[Inflight]) -> None:
        """Commit a classic prefill dispatch as soon as it has landed, so
        its first tokens stream then and not with the tick's decode
        dispatch.  The tick waits for it here, in both loops at the same
        point, so both plan on the same commits; the device meanwhile runs
        whatever was queued before it."""
        events = await self._on_executor(self._commit_all, entries)
        await self._emit_events(events)

    async def _run(self) -> None:
        """The tick loop, pipelined over the device queue (the JAX engine's
        ``_run``).  Up to ``_pipe_depth`` dispatch generations stay
        uncommitted: ready generations commit before the plan, a tick's
        dispatches enqueue while the previous generation may still run,
        and the oldest commits when the pipeline is past its depth (the
        one blocking point), when it has landed, or when nothing new was
        dispatched.  The plan reads a view up to one generation behind the
        device; the commit's slot snapshots and lives and the stop-rule
        replay reconcile it, and batch-membership changes reach the device
        as row scatters ordered after the work already queued."""
        sched = self.sched
        inflight: Deque[List[Inflight]] = collections.deque()
        while self._running:
            try:
                self._process_cancellations()
                if (
                    not sched.has_runnable_work
                    and not inflight
                    and not self._chunking
                    and not sched.mix_pending
                ):
                    if self.device.type == "cuda":
                        self._spans.append(None)  # idle: no gap across the wait
                    self._wake.clear()
                    await self._wake.wait()
                    continue
                # async mode: generations whose results already landed
                # commit before the plan (none is over the depth here), so
                # freed slots and pages and committed stops reach this
                # tick's plan
                await self._commit_ready(inflight, self._pipe_depth)
                plan = sched.plan()
                if sched.num_active > 0:
                    # every uncommitted generation may hold a full block's
                    # writes per lane, plus this tick's block
                    ms_block = self._ms_max if self._multistep else 1
                    sched.ensure_decode_capacity(
                        lookahead=(self._pipe_depth + 1)
                        * max(self.cfg.decode_block_size, ms_block)
                        + 1,
                        chunk_pages=GROW_CHUNK_PAGES,
                    )
                self._revive_paused_lanes()
                fresh: List[Inflight] = []
                minted = False  # a classic prefill sampled first tokens
                mixed_ok = self._mixed_tick_ok()
                if not mixed_ok and sched.mix_pending:
                    self._drain_mixed_to_classic()
                # classic chunked prefills advance one chunk per lane, so
                # decode blocks interleave instead of stalling behind one
                # long prompt
                still: List[SeqState] = []
                for seq in self._chunking:
                    if not self._holds_slot(seq) or not seq.prefilling:
                        continue  # cancelled / preempted mid-prefill
                    pf = await self._on_executor(self._dispatch_chunk, seq)
                    if pf is not None:  # final chunk sampled
                        minted = True
                        await self._commit_prefill([pf])
                    else:
                        still.append(seq)
                self._chunking = still
                # park every chunk-bound lane before any dispatch: the
                # first device-state sync of an admission burst may be a
                # full rebuild, and a lane not yet marked prefilling would
                # be rebuilt active over a half-written cache
                for seq, prompt_len in plan.prefills:
                    if (
                        self._chunk_tokens is not None
                        and prompt_len - seq.cached_prompt_tokens > self._chunk_tokens
                    ):
                        seq.prefilling = True
                        seq.prefilled_tokens = seq.cached_prompt_tokens
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
                        pf = await self._on_executor(self._do_prefill, seq)
                        if pf is not None:
                            minted = True
                            await self._commit_prefill([pf])
                        elif seq.prefilling:
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
                    minted = True
                    await self._commit_prefill(
                        await self._on_executor(self._do_prefill_group, items)
                    )
                chunks = (
                    sched.form_mixed_chunks(self._mixed_budget, self._chunk_tokens)
                    if mixed_ok
                    else []
                )
                k = (
                    self._multistep_plan_k(chunks, minted)
                    if self._multistep and mixed_ok
                    else 0
                )
                pending = [e for gen in inflight for e in gen]
                ub = None
                if chunks:
                    ub = await self._on_executor(self._dispatch_unified, chunks, 1)
                elif (
                    k > 0
                    and sched.num_decode_runnable > 0
                    and self._has_steppable_lane(pending)
                ):
                    ub = await self._on_executor(self._dispatch_unified, [], k)
                if ub is not None:
                    fresh.append(ub)
                elif sched.num_decode_runnable > 0 and self._has_steppable_lane(pending):
                    blk = await self._on_executor(self._dispatch_block)
                    if blk is not None:
                        fresh.append(blk)
                self._firsts_last_tick = minted or bool(ub is not None and ub.finals)
                if fresh:
                    inflight.append(fresh)
                # the oldest generation commits when the pipeline is past
                # its depth, when it has landed (async mode), or -- nothing
                # dispatched -- to drain toward idle
                dispatched = bool(fresh) or minted
                await self._commit_ready(inflight, self._pipe_depth if dispatched else 0)
                if not dispatched and not inflight:
                    self._handle_stalled_admission()
                    await asyncio.sleep(0.001)
                await asyncio.sleep(0)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # the engine must never die silently
                logger.exception("engine tick failed")
                inflight.clear()
                self._pending_injects.clear()
                self._chunking = []
                sched.mix_pending = []
                self._fail_all(f"engine error: {e}")
                self._firsts_last_tick = False
                self._dev_valid = False  # full rebuild once work resumes
                sched.dirty_slots.clear()
                await asyncio.sleep(0.01)

    def _holds_slot(self, seq: SeqState) -> bool:
        return (
            seq.finish is None
            and seq.slot >= 0
            and self.sched.slots[seq.slot] is seq
        )

    def _multistep_plan_k(self, chunks: List[MixedChunk], firsts: bool = False) -> int:
        """Decode steps to fuse into this tick's dispatch: pressure (prefill
        chunks, queued, chunking or mid-prefill requests, first tokens
        sampled by this tick's or the previous tick's dispatches)
        collapses K to 1, each pressure-free tick doubles it toward
        ``multistep_max_k``.  The first-token rule is the JAX engine's
        pending-inject pressure as its serial loop sees it (a first token
        stays pending until the generation after its own has been
        dispatched), read from the dispatches and not from the commits:
        so the pipelined loop fuses the same steps as the serial one,
        whenever its generations land."""
        sched = self.sched
        pressure = (
            bool(chunks)
            or bool(sched.waiting)
            or bool(sched.mix_pending)
            or bool(self._chunking)
            or firsts
            or self._firsts_last_tick
            or any(s is not None and s.prefilling for s in sched.slots)
        )
        if pressure:
            self._ms_ramp = 1
            return 1
        k = min(self._ms_ramp, self._ms_max)
        self._ms_ramp = min(self._ms_ramp * 2, self._ms_max)
        return k

    def _has_steppable_lane(self, pending: List[Inflight]) -> bool:
        """Whether any decode lane can still absorb a token once the
        in-flight work lands: skips dispatches that could only launch dead
        rows (e.g. after every lane's budget went in flight)."""
        inflight = 0
        for e in pending:
            if isinstance(e, InflightBlock):
                inflight += self.cfg.decode_block_size
            elif isinstance(e, InflightUnified):
                inflight += e.n_steps
        sched = self.sched
        limits = self._compute_limits()
        return any(
            s is not None
            and s.finish is None
            and not s.prefilling
            and int(limits[b]) > int(sched.seq_lens[b]) + inflight
            for b, s in enumerate(sched.slots)
        )

    def _revive_paused_lanes(self) -> None:
        """A lane that hit its device-side limit deactivated itself; once
        growth raised what its limit would be, mark it dirty so the next
        dispatch's row scatter folds the raised limit and ``active`` back
        in (growth-only refreshes never touch ``active``)."""
        if not self._dev_valid:
            return
        sched = self.sched
        limits = self._compute_limits()
        for b, seq in enumerate(sched.slots):
            if seq is None or seq.finish is not None:
                continue
            if (
                int(sched.seq_lens[b]) >= int(self._limit_host[b])
                and limits[b] > self._limit_host[b]
            ):
                sched.dirty_slots.add(b)

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
        """Penalty histograms [B, V] rebuilt from the committed history
        (penalized lanes only; other rows stay zero and are never read):
        the device histogram's starting point when penalties arm."""
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

    # -- host arrays on the device ------------------------------------------

    def _stage(self, a: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        """A host array as a tensor this call owns: on the card in pinned
        memory, the source of a non-blocking copy (the copy reads it when
        the stream gets there, so it must never be a scheduler mirror the
        host mutates later); on the CPU a plain copy."""
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if self.device.type == "cuda" else t.clone()

    def _put(self, a: np.ndarray) -> torch.Tensor:
        t = self._stage(a)
        if self.device.type == "cuda":
            return t.to(self.device, non_blocking=True)
        return t

    def _upload(self, dst: torch.Tensor, a: np.ndarray) -> None:
        dst.copy_(self._stage(a), non_blocking=True)

    def _span_start(self) -> Optional[Any]:
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _span_end(self, kind: str, start: Optional[Any]) -> Optional[Any]:
        if start is None:
            return None
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self._spans.append((kind, start, end))
        return end

    def _download(self, out: torch.Tensor, kind: str, start: Optional[Any]) -> Result:
        """Enqueue the non-blocking copy of a dispatch's sampled rows into a
        pinned host buffer of its own and close the dispatch's span (its
        end event marks the copy landed)."""
        if self.device.type != "cuda":
            return Result(out)
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        return Result(host, self._span_end(kind, start))

    def _graph_marks(self) -> Tuple[int, int]:
        return self.graphs.captures, sum(self.graphs.replays.values())

    def _span_kind(self, kind: str, marks: Tuple[int, int]) -> str:
        """``kind``, or ``kind/graph`` when the dispatch ran as graph
        replays alone (no capture; a dispatch with chunks replays none)."""
        captures, replays = self._graph_marks()
        if captures == marks[0] and replays > marks[1]:
            return f"{kind}/graph"
        return kind

    def _drain_spans(self, wait: bool = False) -> None:
        """Read the spans whose end event has completed (all of them after
        a synchronize when ``wait``), in dispatch order."""
        if wait and self.device.type == "cuda" and self._spans:
            torch.cuda.synchronize(self.device)
        while self._spans:
            span = self._spans[0]
            if span is None:
                self._spans.popleft()
                self._last_end = None
                continue
            kind, start, end = span
            if not end.query():
                return
            self._spans.popleft()
            st = self.span_stats.setdefault(
                kind, {"n": 0, "device_ms": 0.0, "gap_ms": 0.0}
            )
            st["n"] += 1
            st["device_ms"] += start.elapsed_time(end)
            if self._last_end is not None:
                st["gap_ms"] += self._last_end.elapsed_time(start)
            self._last_end = end

    # -- device-resident decode state ---------------------------------------

    def _init_device_state(self) -> None:
        """The persistent decode-state tensors, one spare row (index B) for
        pad scatters; the steps take their ``[:B]`` views.  Their
        addresses never change, so captured graphs read them in place."""
        B = self.cfg.max_batch_size
        dev = self.device
        i64, f32 = torch.int64, torch.float32
        st = {
            "tokens": torch.zeros((B + 1,), dtype=i64, device=dev),
            "seq_lens": torch.zeros((B + 1,), dtype=i64, device=dev),
            "limit_lens": torch.zeros((B + 1,), dtype=i64, device=dev),
            "active": torch.zeros((B + 1,), dtype=torch.bool, device=dev),
            "stop_ids": torch.full((B + 1, DEVICE_STOP_WIDTH), -1, dtype=i64, device=dev),
            "page_table": torch.zeros(
                (B + 1, self.sched.max_pages), dtype=torch.int32, device=dev
            ),
            "temperature": torch.zeros((B + 1,), dtype=f32, device=dev),
            "top_p": torch.ones((B + 1,), dtype=f32, device=dev),
            "top_k": torch.zeros((B + 1,), dtype=i64, device=dev),
            "key": torch.zeros((B + 1,), dtype=i64, device=dev),
            "seeded": torch.zeros((B + 1,), dtype=torch.bool, device=dev),
            "freq": torch.zeros((B + 1,), dtype=f32, device=dev),
            "pres": torch.zeros((B + 1,), dtype=f32, device=dev),
            "rep": torch.ones((B + 1,), dtype=f32, device=dev),
        }
        self._st = st
        self._v = {k: t[:B] for k, t in st.items()}
        v = self._v
        self._samp = SamplingParams(
            temperature=v["temperature"], top_p=v["top_p"], top_k=v["top_k"],
            key=v["key"], seeded=v["seeded"], freq=v["freq"], pres=v["pres"],
            rep=v["rep"],
        )
        # penalty histograms [B + 1, V]; maintained only while ``_counts_live``
        self._counts = torch.zeros(
            (B + 1, self.model_cfg.vocab_size), dtype=torch.int32, device=dev
        )
        self._counts_live = False
        self._dev_valid = False
        self._dev_growth = -1
        self._limit_host = np.zeros((B,), np.int64)
        # slot -> the lane's first token still only on the device
        self._pending_injects: Dict[int, InflightPrefill] = {}

    def _compute_limits(self) -> np.ndarray:
        """Per-lane cache-length caps: the token budget, ``max_seq_len - 1``
        and the lane's allocated pages.  ``seq_lens + remaining_budget`` is
        invariant under commits, so this holds while work is in flight."""
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

    def _lane_active(self, seq: Optional[SeqState], limit: int, seq_len: int) -> bool:
        """A lane decodes when slotted, fully prefilled and with write
        headroom."""
        return seq is not None and limit > seq_len and not seq.prefilling

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

    def _sampling_rows(self, seqs: Sequence[Optional[SeqState]]) -> Dict[str, np.ndarray]:
        """Per-lane sampling settings of ``seqs`` (None = an idle lane), by
        ``update_lanes`` row name."""
        n = len(seqs)
        rows = {
            "temp": np.zeros((n,), np.float32),
            "top_p": np.ones((n,), np.float32),
            "top_k": np.zeros((n,), np.int64),
            "key": np.zeros((n,), np.int64),
            "seeded": np.zeros((n,), bool),
            "freq": np.zeros((n,), np.float32),
            "pres": np.zeros((n,), np.float32),
            "rep": np.ones((n,), np.float32),
        }
        for b, s in enumerate(seqs):
            if s is None:
                continue
            so = s.sampling
            if so.temperature is not None:
                rows["temp"][b] = so.temperature
            elif so.top_p is not None or so.top_k is not None:
                # unset temperature with explicit top_p/top_k means sample
                rows["temp"][b] = 1.0
            rows["top_p"][b] = so.top_p if so.top_p is not None else 1.0
            rows["top_k"][b] = so.top_k or 0
            if so.seed is not None:
                rows["seeded"][b] = True
                rows["key"][b] = (int(so.seed) % 0xFFFFFFFF) + 1
            else:
                rows["key"][b] = self._nonce_of.get(s.request_id, 0)
            rows["freq"][b] = so.frequency_penalty or 0.0
            rows["pres"][b] = so.presence_penalty or 0.0
            rows["rep"][b] = so.repetition_penalty or 1.0
        return rows

    def _sampling_params(self, seqs: Sequence[Optional[SeqState]]) -> SamplingParams:
        """Per-lane sampling tensors of a prefill dispatch's lanes."""
        r = {k: self._put(a) for k, a in self._sampling_rows(seqs).items()}
        return SamplingParams(
            temperature=r["temp"], top_p=r["top_p"], top_k=r["top_k"], key=r["key"],
            seeded=r["seeded"], freq=r["freq"], pres=r["pres"], rep=r["rep"],
        )

    def _sync_device_state(self) -> None:
        """Bring the device-resident decode state current (executor thread):
        a full rebuild only when none exists; otherwise row scatters for
        dirty lanes and a page-table and limit swap for growth -- neither
        drains the pipeline."""
        sched = self.sched
        if not self._dev_valid:
            self._push_device_state()
            return
        if sched.dirty_slots:
            self._apply_dirty_rows()
        if self._dev_growth != sched.growth_version:
            # growth-only refresh: keep tokens/seq_lens/active on the
            # device; paused lanes revive through _revive_paused_lanes
            limit = self._compute_limits()
            self._upload(self._v["page_table"], sched.page_table)
            self._upload(self._v["limit_lens"], limit)
            self._dev_growth = sched.growth_version
            self._limit_host = limit

    def _push_device_state(self) -> None:
        """Rebuild the device-resident decode state from the mirrors."""
        sched = self.sched
        B = self.cfg.max_batch_size
        limit = self._compute_limits()
        active = np.zeros((B,), bool)
        stop_ids = np.full((B, DEVICE_STOP_WIDTH), -1, np.int64)
        for b, seq in enumerate(sched.slots):
            active[b] = self._lane_active(seq, int(limit[b]), int(sched.seq_lens[b]))
            stop_ids[b] = self._lane_stop_row(seq)
        v = self._v
        self._upload(v["tokens"], sched.tokens.astype(np.int64))
        self._upload(v["seq_lens"], sched.seq_lens.astype(np.int64))
        self._upload(v["limit_lens"], limit)
        self._upload(v["active"], active)
        self._upload(v["stop_ids"], stop_ids)
        self._upload(v["page_table"], sched.page_table)
        rows = self._sampling_rows(list(sched.slots))
        for name, row in LANE_ROWS[6:]:
            self._upload(v[name], rows[row])
        # mirrors hold a placeholder for lanes whose first token is still
        # device-only: re-apply those injections
        for slot, pf in list(self._pending_injects.items()):
            if sched.slots[slot] is pf.seq and pf.seq.finish is None:
                inject_token(self._st["tokens"], slot, pf.tok)
            else:
                del self._pending_injects[slot]
        self._counts_live = False
        self._dev_valid = True
        self._dev_growth = sched.growth_version
        self._limit_host = limit
        sched.dirty_slots.clear()

    def _apply_dirty_rows(self) -> None:
        """Fold the dirty lanes' mirrors into the device-resident state with
        one row scatter per tensor (executor thread), ordered after any
        dispatch already queued: those run against the old rows, and their
        stale lanes' output is dropped at commit.  Correct because a dirty
        lane never carries uncommitted decode progress: admission, release,
        revival and a final classic chunk act on lanes that are parked,
        fresh or committed through."""
        sched = self.sched
        B = self.cfg.max_batch_size
        limits = self._compute_limits()
        dirty = sorted(sched.dirty_slots)
        # always B rows, pads carrying slot B (the spare row)
        slots = np.full((B,), B, np.int64)
        rows: Dict[str, np.ndarray] = {
            "token": np.zeros((B,), np.int64),
            "seq_len": np.zeros((B,), np.int64),
            "limit": np.zeros((B,), np.int64),
            "active": np.zeros((B,), bool),
            "stop": np.full((B, DEVICE_STOP_WIDTH), -1, np.int64),
            "pages": np.zeros((B, sched.max_pages), np.int32),
        }
        lanes: List[Optional[SeqState]] = [None] * B
        for i, b in enumerate(dirty):
            seq = sched.slots[b]
            slots[i] = b
            rows["token"][i] = sched.tokens[b]
            rows["seq_len"][i] = sched.seq_lens[b]
            rows["limit"][i] = limits[b]
            rows["active"][i] = self._lane_active(
                seq, int(limits[b]), int(sched.seq_lens[b])
            )
            rows["stop"][i] = self._lane_stop_row(seq)
            rows["pages"][i] = sched.page_table[b]
            lanes[i] = seq
            self._limit_host[b] = limits[b]
        rows.update(self._sampling_rows(lanes))
        st = self._st
        slots_t = self._put(slots)
        update_lanes(
            *(st[name] for name, _ in LANE_ROWS), slots_t,
            {k: self._put(a) for k, a in rows.items()},
        )
        # penalty histograms: zero the flushed lanes, then re-seed each
        # penalized lane's row from its committed history
        if self._counts_live and dirty:
            zero_count_rows(self._counts, slots_t)
            for b in dirty:
                seq = sched.slots[b]
                if seq is None or not self._seq_penalized(seq):
                    continue
                toks, amts = self._penalty_history(seq)
                if not toks:
                    continue
                pad = pow2_bucket(len(toks))
                buf = np.zeros((pad,), np.int64)
                amounts = np.zeros((pad,), np.int32)
                buf[: len(toks)] = toks
                amounts[: len(toks)] = amts
                seed_count_rows(self._counts, b, self._put(buf), self._put(amounts))
        # pending injects hold the real first token for lanes whose mirror
        # still has the placeholder: re-apply them over the row scatter
        injects: List[Tuple[int, torch.Tensor]] = []
        for b in dirty:
            pf = self._pending_injects.get(b)
            if pf is not None:
                if sched.slots[b] is pf.seq and pf.seq.finish is None:
                    injects.append((b, pf.tok))
                else:
                    del self._pending_injects[b]
        if injects:
            idx = self._put(np.asarray([b for b, _ in injects], np.int64))
            toks_t = torch.cat([t.reshape(1) for _, t in injects])
            inject_tokens(st["tokens"], idx, toks_t)
            if self._counts_live:
                # re-applied first tokens are output: they count once more
                # (the row was just zeroed and re-seeded)
                bump_counts(self._counts, idx, toks_t)
        sched.dirty_slots.clear()

    def _live_page_bucket(self) -> int:
        """Power-of-two page-table width covering the longest slotted
        lane's allocation (floor 8), the JAX engine's rule."""
        sched = self.sched
        live_pages = [len(s.pages) for s in sched.slots if s is not None and s.pages]
        return pick_page_bucket(
            min(max(8, max(live_pages, default=1)), sched.max_pages),
            sched.max_pages,
        )

    def _commit_state(self, tokens, seq_lens, active) -> None:
        v = self._v
        v["tokens"].copy_(tokens)
        v["seq_lens"].copy_(seq_lens)
        v["active"].copy_(active)

    @staticmethod
    def _needs_filters(so) -> bool:
        has_filter = bool(so.top_k) or (so.top_p is not None and so.top_p < 1.0)
        temp = so.temperature if so.temperature is not None else 1.0
        return has_filter and temp > 0.0

    @staticmethod
    def _lp_top(seqs: Sequence[Optional[SeqState]]) -> int:
        """Top-logprob width of a dispatch: 8 when any lane asked for them."""
        return 8 if any(s is not None and s.sampling.logprobs for s in seqs) else 0

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
    ) -> Optional[InflightUnified]:
        """Enqueue one unified mixed dispatch (packed axis, or the [B, S]
        rectangle): decode lanes contribute one row each, read from the
        device-resident state, and each chunk its prompt rows; a final
        chunk samples its lane's first token and folds it into the decode
        state on the device.  Host chunk bookkeeping advances at dispatch.
        With ``num_steps > 1`` (a pure-decode packed tick) K decode steps
        fuse into the dispatch.  None when there was nothing to dispatch."""
        sched = self.sched
        B = self.cfg.max_batch_size
        p_start = np.zeros((B,), np.int64)
        p_lens = np.zeros((B,), np.int64)
        p_sample = np.zeros((B,), bool)
        chunk_by_slot: Dict[int, MixedChunk] = {}
        final_chunks: List[MixedChunk] = []
        for ch in chunks:
            b = ch.seq.slot
            chunk_by_slot[b] = ch
            p_start[b] = ch.start
            p_lens[b] = ch.length
            p_sample[b] = ch.final
            self._note_prefix_stats(ch.seq)
            ch.seq.prefilled_tokens = ch.start + ch.length
            if ch.final:
                ch.seq.prefilling = False
                final_chunks.append(ch)
        dec_cap = np.array(
            [
                s is not None and p_lens[b] == 0 and s.finish is None and not s.prefilling
                for b, s in enumerate(sched.slots)
            ],
            bool,
        )
        if num_steps > 1 and not dec_cap.any():
            return None
        q_host = np.where(dec_cap, 1, p_lens).astype(np.int64)
        total = int(q_host.sum())
        if total == 0:
            return None
        start = self._span_start()
        marks = self._graph_marks()
        self._sync_device_state()
        slots = list(sched.slots)
        use_filters = any(s is not None and self._needs_filters(s.sampling) for s in slots)
        top_n = self._lp_top(slots)
        Pb = self._live_page_bucket()
        if self._packed:
            packed = self._run_packed(
                chunk_by_slot, p_start, p_lens, p_sample, dec_cap, q_host, total,
                Pb, num_steps, top_n, use_filters,
            )
        else:
            S = pow2_bucket(max((ch.length for ch in chunks), default=1))
            p_tokens = np.zeros((B, S), np.int64)
            for ch in chunks:
                p_tokens[ch.seq.slot, : ch.length] = ch.seq.prompt[
                    ch.start : ch.start + ch.length
                ]
            v = self._v
            put = self._put
            packed, tokens, seq_lens, active = unified_step(
                self.params, self.model_cfg, self.kv.pages, v["tokens"],
                v["seq_lens"], v["limit_lens"], v["active"], v["stop_ids"],
                v["page_table"][:, :Pb].contiguous(), put(p_tokens), put(p_start),
                put(p_lens), put(p_sample), put(p_sample), self._samp, top_n,
                use_filters,
            )
            self._commit_state(tokens, seq_lens, active)
            packed = packed[:, None]
        finals: List[InflightPrefill] = []
        for ch in final_chunks:
            b = ch.seq.slot
            pf = InflightPrefill(tok=packed[b : b + 1, 0, 0], seq=ch.seq, slot=b, life=ch.seq.life)
            self._pending_injects[b] = pf
            finals.append(pf)
        res = self._download(packed, self._span_kind("unified", marks), start)
        self._count("unified")
        self.dispatches_by_k[num_steps] = self.dispatches_by_k.get(num_steps, 0) + 1
        return InflightUnified(
            res, slots, [s.life if s is not None else -1 for s in slots], finals,
            num_steps,
        )

    def _run_packed(
        self, chunk_by_slot, p_start, p_lens, p_sample, dec_cap, q_host, total,
        Pb, num_steps, top_n, use_filters,
    ) -> torch.Tensor:
        """The packed layout: segments in slot order on one flat axis,
        ``(Np, s_max)`` resolved through the shape budget; the packed step,
        then the multistep tail's ``num_steps - 1`` decode steps.  On the
        card a dispatch without chunks replays the packed step's graph.
        Returns ``packed [B, num_steps, 2 + 2*top_n]``."""
        B = self.cfg.max_batch_size
        seg_off = np.zeros((B,), np.int64)
        off = off_last = 0
        for b in range(B):
            if q_host[b]:
                seg_off[b] = off_last = off
                off += int(q_host[b])
        evicted = self._packed_shapes.evictions
        Np, s_max, _ = self._packed_shapes.fit(
            pow2_bucket(int(q_host.max())), off_last, total
        )
        if self._packed_shapes.evictions != evicted:
            live = set(self._packed_shapes.pairs)
            self.graphs.release(lambda k: k[0] != "packed" or (k[1], k[2], 0) in live)
        # the packed axis' tokens, lanes, rows and decode flags (the step
        # takes them with the per-lane arrays as one int64 tensor: one
        # host-to-device copy)
        t_tokens = np.zeros((Np,), np.int64)
        t_lane = np.full((Np,), B, np.int64)
        t_rel = np.zeros((Np,), np.int64)
        t_dec = np.zeros((Np,), np.int64)
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
                t_dec[o] = 1
        v = self._v
        t = torch.from_numpy
        keys = {
            "packed": ("packed", Np, s_max, Pb, top_n, use_filters),
            "step": ("step", Pb, top_n, use_filters, False),
        }
        packed, *_ = packed_unified_multistep(
            self.params, self.model_cfg, self.kv.pages, v["tokens"], v["seq_lens"],
            v["limit_lens"], v["active"], v["stop_ids"], v["page_table"][:, :Pb],
            t(t_tokens), t(t_lane), t(t_rel), t(t_dec), t(p_start), t(p_lens),
            t(p_sample), t(p_sample), t(dec_cap), t(seg_off), self._samp, s_max,
            num_steps, top_n, use_filters,
            self._step_runner(keys, eager=bool(chunk_by_slot)),
        )
        return packed

    def _run_block(
        self, K: int, Pb: int, top_n: int, use_filters: bool, use_penalties: bool
    ) -> torch.Tensor:
        """A classic decode block of K steps over the persistent decode
        state (and histograms, with penalties), each step a replay of the
        decode-step graph on the card.  Returns ``packed [B, K, 2 +
        2*top_n]``."""
        v = self._v
        key = ("step", Pb, top_n, use_filters, use_penalties)
        return decode_block(
            self.params, self.model_cfg, self.kv.pages, v["tokens"], v["seq_lens"],
            v["limit_lens"], v["active"], v["stop_ids"], v["page_table"][:, :Pb],
            self._samp, K, use_filters, top_n, self._counts[: self.cfg.max_batch_size],
            use_penalties, self._step_runner({"step": key}),
        )[0]

    def _step_runner(self, keys: Dict[str, Hashable], eager: bool = False) -> StepRunner:
        """How the steps of a multi-step dispatch run: their host inputs
        staged, then the graph of the kind's key replayed on the card
        (captured at its first use; on the CPU the step runs eagerly) --
        or, with ``eager`` (a dispatch that carries chunks), the step
        itself on its inputs copied to the device."""

        def run(kind: str, fn: StepFn, inputs: Tuple[torch.Tensor, ...]) -> torch.Tensor:
            staged = tuple(self._stage(x) for x in inputs)
            if eager:
                return fn(tuple(x.to(self.device, non_blocking=True) for x in staged))
            return self.graphs.run(kind, keys[kind], staged, fn)

        return run

    def _dispatch_block(self) -> Optional[InflightBlock]:
        """Enqueue one classic decode block of ``decode_block_size`` steps
        over the device-resident decode lanes, with the device-carried
        penalty histograms when a lane asked for penalties."""
        sched = self.sched
        if sched.num_active == 0:
            return None  # everything was preempted
        start = self._span_start()
        marks = self._graph_marks()
        self._sync_device_state()
        K = self.cfg.decode_block_size
        B = self.cfg.max_batch_size
        slots = list(sched.slots)
        Pb = self._live_page_bucket()
        use_filters = any(s is not None and self._needs_filters(s.sampling) for s in slots)
        use_penalties = any(s is not None and self._seq_penalized(s) for s in slots)
        if use_penalties and not self._counts_live:
            self._upload(self._counts[:B], self._counts_host())
            # pending first tokens are device-only (not in the committed
            # history yet): fold them in so device and host views agree
            pend = [
                (slot, pf.tok)
                for slot, pf in self._pending_injects.items()
                if sched.slots[slot] is pf.seq
            ]
            if pend:
                bump_counts(
                    self._counts,
                    self._put(np.asarray([p[0] for p in pend], np.int64)),
                    torch.cat([p[1].reshape(1) for p in pend]),
                )
            self._counts_live = True
        elif not use_penalties:
            self._counts_live = False
        top_n = self._lp_top(slots)
        packed = self._run_block(K, Pb, top_n, use_filters, use_penalties)
        res = self._download(packed, self._span_kind("decode_block", marks), start)
        self._count("decode_block")
        return InflightBlock(res, slots, [s.life if s is not None else -1 for s in slots])

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
        self.prefill_dispatches["full"] += 1
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
        self.prefill_dispatches["suffix"] += 1
        return prefill_suffix_and_sample(
            self.params, self.model_cfg, self.kv.pages, put(tokens),
            put(offsets), put(suffix_lens), put(prefix_table),
            put(suffix_table), self._sampling_params(lanes),
            self._lp_top(lanes),
            any(self._seq_penalized(s) for s, _, _ in entries),
        )

    def _inject_first_tokens(
        self, packed: torch.Tensor, seqs: List[SeqState]
    ) -> List[InflightPrefill]:
        """Bring the decode state current (admission marked the lanes
        dirty), then write each lane's sampled first token (row i of
        ``packed``) into its lane on the device: one scatter, pad rows to
        the spare row.  Returns the lanes' pending-inject records."""
        self._sync_device_state()
        B = self.cfg.max_batch_size
        Bp = packed.shape[0]
        slots = np.full((Bp,), B, np.int64)
        for i, seq in enumerate(seqs):
            slots[i] = seq.slot
        idx = self._put(slots)
        inject_tokens(self._st["tokens"], idx, packed[:, 0])
        if self._counts_live:
            bump_counts(self._counts, idx, packed[:, 0])
        entries = []
        for i, seq in enumerate(seqs):
            pf = InflightPrefill(tok=packed[i : i + 1, 0], seq=seq, slot=seq.slot, life=seq.life)
            self._pending_injects[seq.slot] = pf
            entries.append(pf)
        return entries

    def _do_prefill_group(
        self, items: List[Tuple[SeqState, int]]
    ) -> List[InflightPrefillGroup]:
        """One prefill dispatch for a group of same-shape admissions (one
        suffix bucket, one prefix-page bucket), the batch padded to a power
        of two; every lane's first token goes into the decode state on the
        device, and the tick commits them once the dispatch has landed."""
        seqs = [seq for seq, _ in items]
        for seq in seqs:
            self._note_prefix_stats(seq)
        start = self._span_start()
        Bp = pow2_bucket(len(seqs))
        if not any(seq.cached_prompt_tokens for seq in seqs):
            packed = self._dispatch_full_prefill_batch(seqs, Bp)
        else:
            packed = self._dispatch_suffix_prefill_batch(
                [(seq, pl, seq.cached_prompt_tokens) for seq, pl in items], Bp
            )
        entries = self._inject_first_tokens(packed, seqs)
        self._count("prefill")
        return [InflightPrefillGroup(self._download(packed, "prefill", start), entries)]

    def _do_prefill(self, seq: SeqState) -> Optional[InflightPrefill]:
        """A classic chunk-bound admission (already parked ``prefilling``):
        the admission row must land with the lane inactive, then the first
        chunk dispatches."""
        self._note_prefix_stats(seq)
        self._sync_device_state()
        return self._dispatch_chunk(seq)

    def _finish_prefill(self, seq: SeqState, start: int) -> InflightPrefill:
        """The rest of a prompt from ``start`` (0: the whole prompt) in one
        dispatch that samples the first token, injected on the device."""
        t0 = self._span_start()
        if start > 0:
            packed = self._dispatch_suffix_prefill_batch([(seq, len(seq.prompt), start)], 1)
        else:
            packed = self._dispatch_full_prefill_batch([seq], 1)
        (pf,) = self._inject_first_tokens(packed, [seq])
        pf.sampled = self._download(packed, "prefill", t0)
        self._count("prefill")
        return pf

    def _dispatch_chunk(self, seq: SeqState) -> Optional[InflightPrefill]:
        """Advance one page-aligned chunk of a classic chunked prefill.  An
        intermediate chunk writes KV and samples nothing (None); the last
        one (or, with chunking off, the rest of a prompt drained from the
        mixed plane) samples the first token and re-activates the lane
        (a dirty row ordered after the dispatch)."""
        self._note_prefix_stats(seq)
        prompt_len = len(seq.prompt)
        start = seq.prefilled_tokens
        chunk = self._chunk_tokens
        if chunk is None or prompt_len - start <= chunk:
            seq.prefilling = False
            pf = self._finish_prefill(seq, start)
            self.sched.dirty_slots.add(seq.slot)
            return pf
        t0 = self._span_start()
        self._dispatch_suffix_prefill_batch([(seq, start + chunk, start)], 1)
        self._span_end("chunk", t0)
        seq.prefilled_tokens = start + chunk
        self._count("chunk")
        return None

    # -- commits (executor thread) ------------------------------------------

    def _commit_all(self, entries: List[Inflight]) -> List[StepEvent]:
        """Read and commit one dispatch generation (or one classic prefill
        dispatch) in dispatch order: every result in one pass, then the
        stop-rule replay."""
        mats = [e.sampled.numpy() for e in entries]
        self._drain_spans()
        sched = self.sched
        events: List[StepEvent] = []

        def commit_prefill(pf: InflightPrefill, row: np.ndarray) -> None:
            seq = pf.seq
            if self._pending_injects.get(pf.slot) is pf:
                del self._pending_injects[pf.slot]
            if (
                seq.finish is not None
                or seq.slot != pf.slot
                or sched.slots[pf.slot] is not seq
                or seq.life != pf.life
                or seq.num_generated > 0
            ):
                return  # preempted/cancelled before the commit landed
            N = (row.shape[-1] - 2) // 2
            tok, lp, tids, tlps = unpack_sampled_logprobs(row, N)
            top = [[int(t), float(l)] for t, l in zip(tids, tlps)] if N else None
            events.append(sched.commit_prefill_token(seq, int(tok), float(lp), top))

        for e, mat in zip(entries, mats):
            if isinstance(e, InflightPrefillGroup):
                for i, pf in enumerate(e.entries):
                    commit_prefill(pf, mat[i])
            elif isinstance(e, InflightPrefill):
                commit_prefill(e, mat[0])
            else:
                if isinstance(e, InflightUnified):
                    for pf in e.finals:
                        if self._pending_injects.get(pf.slot) is pf:
                            del self._pending_injects[pf.slot]
                N = (mat.shape[-1] - 2) // 2
                toks, lps, tids, tlps = unpack_sampled_logprobs(mat, N)
                events.extend(
                    sched.commit_block(
                        toks, e.slots, lps, tids if N else None, tlps if N else None,
                        lives=e.lives,
                    )
                )
        return events

    # -- events -------------------------------------------------------------

    def _deliver(self, item) -> None:
        """One fanout item: a commit's events, or an error frame."""
        if isinstance(item, tuple):
            self._put_error(item[1], item[2])
        else:
            self._emit(item)

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
        if self._queues.get(seq.request_id) is None:
            return
        # async mode: the error rides the fanout queue, so it cannot
        # overtake committed token events still waiting there
        q = self._fanout_q
        if q is not None and self._running:
            try:
                q.put_nowait(("error", seq.request_id, message))
                return
            except asyncio.QueueFull:
                pass
        self._put_error(seq.request_id, message)

    def _put_error(self, request_id: str, message: str) -> None:
        queue = self._queues.get(request_id)
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
