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

The engine's other callers of the full flash prefill run eagerly beside
that loop, never inside a CUDA graph: an echo+logprobs request
(``prompt_logprobs``) has its prompt scored by a dispatch of its own when
its prefill dispatches (no KV writes; the rows travel in a second result
with its own pinned buffer and event, and commit with the first token); a
request with ``mm_embeds`` (a soft prompt) opts out of prefix caching and
takes a classic full prefill, never chunked and never packed into a mixed
tick; and :meth:`TorchEngine.embed` pools embeddings on the executor
thread, serialized with the tick loop.  ``EngineMetrics`` (queue depth,
occupancy, KV pages, prefix hits, dispatches by kind, step latency, mixed
batch fill, multistep K, packed shapes) is fed at the JAX engine's sites.

Speculative decoding (a request's ``speculation`` knobs) is the JAX
engine's: a lane armed at ``generate()`` (not a penalized or soft-prompt
lane; an unknown drafter fails the request) is device-inactive and
advances through verify columns from the host mirrors -- its last
committed token and its drafter's proposal, scored in one forward.  On
packed mixed ticks the columns fold into the unified dispatch as more
segments (``fold_spec_verify``, kernel 5 on the card); on classic ticks,
the rectangle layout and with folding off, a standalone
``verify_and_sample`` dispatch (kernel 3) goes out after the commit.  The
accept walk commits the verified draft prefix and the next target sample
through the stop-rule replay; a lane preempted or cancelled mid-verify
discards its column.  The next proposal is precomputed at commit, and a
lane whose acceptance stays low auto-disables (``spec_auto_disable``) and
decodes plainly.  A speculating lane collapses multistep K to 1.  Its
stats ride the finish item; ``SpecMetrics`` feeds ``dynamo_spec_*``.
``EngineConfig(draft_model=...)`` loads a model drafter at construction,
``quantize="int8"`` quantizes the weights before any pool is allocated
(``quant.py``).

The KV offload plane is the JAX engine's (``offload.KVOffloadEngine``,
armed by ``host_offload_blocks``/``disk_offload_blocks`` or
``DYN_KV_OFFLOAD``; otherwise no offload thread starts).  A block the
page pool evicts is gathered on the device by the pool's ``on_evict``
hook, on the loop thread while it plans -- the same stream as the
dispatches, so before any dispatch that reuses its pages -- and copied
without blocking into pinned host memory behind a CUDA event; the offload
thread waits for that event and stores the block in the host ring (G2),
whose overflow demotes to disk (G3).  At admission the prefix match runs
on from the pool into the host ring; the hits' pages are allocated then
and filled, at the lane's first prefill dispatch, by one page-bucketed,
layer-chunked scatter of all its hits, then registered.  The first
``kv_prefetch_window`` queued requests have their offloaded chains
promoted and pinned in the ring while they wait.  A capacity-preempted
lane swaps its committed KV out (``swap_preemption``, on whenever the
plane is armed) and parks ``awaiting_kv``: re-admitted into fresh pages,
it stays device-inactive until the swap-in scatters its snapshot back --
the retained device copy, or the host blob once that copy was dropped --
and a dirty row hands it to the decode state, so swap and recompute give
the same tokens.  The pool's ``stored``/``removed`` events and the
plane's ``holdings`` deltas go to ``kv_event_sink``/``kv_holdings_sink``,
hopping to the engine's loop from other threads.  ``OffloadMetrics``
feeds ``dynamo_kv_*``.

Not served yet (later slices): disaggregation and external-KV deliveries,
the G4 remote tier, tensor/data parallelism, the tick profiler, and CUDA
graphs for dispatches that carry prefill chunks or verify columns.

The serving-environment overrides the JAX engine reads at construction
are read here too, with its parse, for the features the port has:
``DYN_KV_DTYPE``, ``DYN_MIXED_TOKEN_BUDGET``, ``DYN_PACKED_RAGGED``,
``DYN_PACKED_SHAPE_BUDGET``, ``DYN_ASYNC_DISPATCH``, ``DYN_SPEC_FOLD``,
``DYN_SPEC_AUTO_DISABLE``, ``DYN_DRAFT_MODEL``, ``DYN_KV_OFFLOAD`` and
``DYN_KV_PREFETCH``.  A set variable wins over the config; a malformed one
logs a warning and keeps the config.

The KV pool is dense in the model's dtype or, with
``EngineConfig(kv_dtype="int8")``, int8 with per-row scales; a dense pool of
another dtype is refused at construction, and so is, on the card, a head
geometry its kernels do not take (the CPU serves any).
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import itertools
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import (
    Any, AsyncIterator, Deque, Dict, Hashable, List, Optional, Sequence, Tuple, Union,
)

import numpy as np
import torch

from ..device import resolve_device
from .. import offload as kvoffload
from ..ops.build import check_geometry
from ..protocols.common import (
    FinishReason,
    ForwardPassMetrics,
    LLMEngineOutput,
    PreprocessedRequest,
)
from ..runtime.engine import Annotated, Context, ResponseStream
from ..runtime.metrics import EngineMetrics, SpecMetrics
from ..spec.drafter import MAX_DRAFT_TOKENS, SpecState, longest_accepted, make_drafter, spec_live
from .bucketing import (
    PackedShapeBudget,
    pick_bucket,
    pick_page_bucket,
    pow2_bucket,
    prefill_buckets,
)
from .config import EngineConfig, ModelConfig
from .graphs import StepGraphs
from .kv_cache import (
    PagedKVCache,
    PageSnapshot,
    QuantKV,
    coerce_kv_blob,
    dtype_name,
    layer_chunk_spans,
    pad_page_axis,
    parse_kv_dtype,
    pool_is_quantized,
    tensor_view,
    torch_dtype,
)
from .model import Params, init_params
from .quant import quantize_params
from .sampling import PROMPT_FLAG, SamplingParams, unpack_sampled_logprobs
from .scheduler import MixedChunk, Scheduler, SchedulerConfig, SeqState, StepEvent
from .step import (
    LANE_ROWS,
    StepFn,
    StepRunner,
    bump_counts,
    decode_block,
    embed_step,
    gather_block_pages,
    inject_token,
    inject_tokens,
    packed_unified_multistep,
    prefill_mm_and_sample,
    prefill_suffix_and_sample,
    scatter_layer_pages,
    score_prompt_step,
    seed_count_rows,
    unified_step,
    update_lanes,
    verify_and_sample,
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
# layer groups of an onboard or swap-in scatter (the JAX engine's
# DEFAULT_EXPORT_CHUNKS)
ONBOARD_CHUNKS = 8


def _env_override(name: str, value: Any, parse) -> Any:
    """``value``, or the parse of a set environment variable ``name``; a
    malformed value warns and keeps ``value``."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return value
    try:
        return parse(raw)
    except ValueError:
        logger.warning("ignoring malformed %s=%r", name, raw)
        return value


def _env_flag(raw: str) -> bool:
    return raw.strip().lower() not in ("0", "off", "false", "no")


def _parse_prefetch_window(raw: str) -> int:
    """``DYN_KV_PREFETCH``: off/false/no, or a window of queued requests."""
    v = raw.strip().lower()
    return 0 if v in ("off", "false", "no") else int(v)


def _parse_offload_spec(raw: str) -> Optional[Dict[str, Any]]:
    """``DYN_KV_OFFLOAD`` by ``offload.env_offload_spec``'s grammar (None:
    0/off, the config stands)."""
    return kvoffload.env_offload_spec({"DYN_KV_OFFLOAD": raw})


def _parse_draft_model(raw: str) -> Optional[str]:
    """``DYN_DRAFT_MODEL``: a draft model spec, or 0/off/none for none."""
    raw = raw.strip()
    return None if raw.lower() in ("0", "off", "none") else raw


def check_model_geometry(model_cfg: ModelConfig, device: torch.device) -> None:
    """Refuse a model whose head geometry the device's kernels do not take
    (``check_geometry``, the wrappers' own rule): at construction, not at
    the first dispatch.  The CPU serves any geometry."""
    check_geometry(
        device, torch_dtype(model_cfg.dtype), model_cfg.num_heads,
        model_cfg.num_kv_heads, model_cfg.head_dim,
    )


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
    dispatch the parent's rows carry it.  ``prompt_lp``: an echo+logprobs
    lane's prompt-scoring rows ``[1, T, 2 + 2N]``, a result of their own
    that the commit also waits for."""

    tok: torch.Tensor  # [1] device view of the sampled token
    seq: SeqState
    slot: int
    life: int
    sampled: Optional[Result] = None
    prompt_lp: Optional[Result] = None
    dispatched_at: float = field(default_factory=time.perf_counter)


@dataclass
class InflightPrefillGroup:
    """A batched prefill dispatch awaiting commit: the whole group's
    packed first-token rows ``[Bp, 2 + 2N]`` in one result."""

    sampled: Result
    entries: List[InflightPrefill]
    dispatched_at: float = field(default_factory=time.perf_counter)


@dataclass
class InflightBlock:
    """A dispatched-but-uncommitted decode block: packed ``[B, K, 2 + 2N]``
    rows and the slot mapping (and slot lives) at dispatch."""

    sampled: Result
    slots: List[Optional[SeqState]]
    lives: List[int]
    dispatched_at: float = field(default_factory=time.perf_counter)


# one speculating lane of a verify dispatch: (seq, slot, draft, life at
# dispatch); a lane preempted, cancelled or re-admitted since discards its
# whole column at commit
SpecLane = Tuple[SeqState, int, List[int], int]


@dataclass
class InflightUnified:
    """A dispatched-but-uncommitted unified step: packed ``[B, K, 2 + 2N]``
    rows of its decode lanes and final prefill chunks (K fused decode
    steps; 1 with chunks or on the rectangle), the slot mapping at
    dispatch, and an :class:`InflightPrefill` per lane whose prompt
    completed (its first token already folded into the device state by
    the step; the record backs the pending-inject re-apply path).  With
    folded verify, ``spec_sampled`` holds the speculating lanes' column
    samples ``[B, s_spec, 2 + 2N]`` (landed with ``sampled``) and
    ``spec_lanes`` what the accept walk commits them against."""

    sampled: Result
    slots: List[Optional[SeqState]]
    lives: List[int]
    finals: List[InflightPrefill] = field(default_factory=list)
    n_steps: int = 1
    spec_sampled: Optional[Result] = None
    spec_lanes: List[SpecLane] = field(default_factory=list)
    dispatched_at: float = field(default_factory=time.perf_counter)


@dataclass
class InflightVerify:
    """A dispatched-but-uncommitted standalone verify: one forward scored
    every speculating lane's columns (``[B, S, 2 + 2N]``); the host accept
    walk runs at commit."""

    sampled: Result
    lanes: List[SpecLane]
    dispatched_at: float = field(default_factory=time.perf_counter)


Inflight = Union[
    InflightPrefill, InflightPrefillGroup, InflightBlock, InflightUnified, InflightVerify
]


def _prefills_of(e: Inflight) -> List[InflightPrefill]:
    """The first-token records an in-flight dispatch carries."""
    if isinstance(e, InflightPrefillGroup):
        return e.entries
    if isinstance(e, InflightUnified):
        return e.finals
    if isinstance(e, InflightPrefill):
        return [e]
    return []


class TorchEngine:
    """Continuous-batching PyTorch engine over a paged KV cache."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        params: Params,
        cfg: Optional[EngineConfig] = None,
        device: Optional[Union[str, torch.device]] = None,
        metrics_registry=None,  # runtime.metrics.MetricsRegistry | None
    ) -> None:
        self.device = resolve_device(device)
        check_model_geometry(model_cfg, self.device)
        self.model_cfg = model_cfg
        self.cfg = cfg or EngineConfig()
        self.params = params
        self.dtype = torch_dtype(model_cfg.dtype)
        c = self.cfg
        if c.quantize is not None:
            # before any pool is allocated: the int8 weights and the
            # one-slice f32 transient of the rounding come first
            if c.quantize != "int8":
                raise ValueError(f"unsupported quantize={c.quantize!r} (int8 only)")
            self.params = quantize_params(params, self.dtype)
        self.kv_dtype = _env_override(
            "DYN_KV_DTYPE", parse_kv_dtype(c.kv_dtype), parse_kv_dtype
        )
        self.kv = PagedKVCache(
            model_cfg, c.num_pages, c.page_size, self.dtype, self.device,
            quantized=pool_is_quantized(self.kv_dtype, model_cfg.dtype),
        )
        self.sched = Scheduler(
            SchedulerConfig(
                max_batch_size=c.max_batch_size,
                max_seq_len=c.max_seq_len,
                page_size=c.page_size,
            ),
            self.kv.allocator,
        )
        # registry-backed observability: the scheduler refreshes the queue
        # and occupancy gauges at admission, the engine observes dispatches
        # and, at commit, step latency and KV residency
        self.obs = EngineMetrics(metrics_registry, max_slots=c.max_batch_size)
        self.sched.metrics = self.obs
        # KV events for a router: the pool's stored/removed (registration
        # at commit on the executor thread, eviction on the loop thread) and
        # the offload plane's holdings deltas; None = not wired
        self.kv_event_sink: Optional[Any] = None
        self.kv_holdings_sink: Optional[Any] = None
        self.kv.allocator.event_sink = self._emit_kv_event
        self._init_offload(metrics_registry)
        # speculative decoding: per-request drafters propose draft tokens
        # from the token history, a verify dispatch scores them in one
        # forward.  Engine-lifetime counters beside the dynamo_spec_* family
        self.spec_metrics = SpecMetrics(metrics_registry)
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_verify_steps = 0
        self.spec_armed_requests = 0
        self.spec_auto_disabled = 0
        self._spec_auto_disable = _env_override(
            "DYN_SPEC_AUTO_DISABLE", bool(c.spec_auto_disable), _env_flag
        )
        self._spec_min_accept = float(c.spec_min_accept)
        self._spec_disable_after = max(int(c.spec_disable_after), 1)
        # (seq, message) of lanes whose drafter failed on the executor
        # thread; the loop fails their requests before its next plan
        self._spec_failures: List[Tuple[SeqState, str]] = []
        # the model drafter, bound to this engine under kind "model"
        self.model_drafter: Optional[Any] = None
        draft_spec = _env_override("DYN_DRAFT_MODEL", c.draft_model, _parse_draft_model)
        if draft_spec:
            self._init_model_drafter(draft_spec)
        self.buckets = prefill_buckets(c.page_size, c.max_seq_len)
        # classic chunks restart at page-aligned offsets: the chunk size
        # rounds up to a whole page
        self._chunk_tokens: Optional[int] = None
        if c.prefill_chunk_tokens is not None:
            ps = c.page_size
            self._chunk_tokens = max(ps, -(-c.prefill_chunk_tokens // ps) * ps)
        self._mixed = bool(c.mixed_batching)
        self._packed = _env_override("DYN_PACKED_RAGGED", bool(c.packed_ragged), _env_flag)
        # multistep decode rides the packed mixed plane only
        self._multistep = self._mixed and self._packed
        # folded verify needs the packed mixed plane too
        self._fold_spec = (
            _env_override("DYN_SPEC_FOLD", bool(c.fold_spec_verify), _env_flag)
            and self._mixed
            and self._packed
        )
        self._mixed_budget = max(
            int(_env_override("DYN_MIXED_TOKEN_BUDGET", c.mixed_token_budget, int)), 1
        )
        self._ms_max = max(int(c.multistep_max_k), 1)
        self._ms_ramp = 1
        # whether the previous tick's dispatches sampled a first token
        self._firsts_last_tick = False
        # dispatch generations the loop may carry uncommitted
        async_dispatch = _env_override("DYN_ASYNC_DISPATCH", bool(c.async_dispatch), _env_flag)
        self._pipe_depth = 2 if async_dispatch else 1
        self._packed_shapes = PackedShapeBudget(
            _env_override("DYN_PACKED_SHAPE_BUDGET", PACKED_SHAPE_BUDGET, int)
        )
        self.graphs = StepGraphs(self.device)
        # lanes whose classic chunked prefill is under way (one chunk per tick)
        self._chunking: List[SeqState] = []
        # unseeded lanes key their noise on a per-request nonce
        self._nonces = itertools.count(1)
        self._nonce_of: Dict[str, int] = {}
        self._queues: Dict[str, asyncio.Queue] = {}
        # live requests' contexts: a request killed before anything read its
        # stream (a consumer that gave up first) is still cancelled
        self._ctxs: Dict[str, Any] = {}
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
        # dispatch counts by kind (prefill, chunk, decode_block, unified,
        # prompt_score, embed) and unified dispatches by fused decode steps K
        self.dispatches: Dict[str, int] = {}
        self.dispatches_by_k: Dict[int, int] = {}
        # classic prefill dispatches by route: full prompts (flash prefill;
        # soft-prompt prefills included) and suffixes over a resident
        # prefix, chunks included (prefix-suffix flash prefill)
        self.prefill_dispatches: Dict[str, int] = {"full": 0, "suffix": 0}
        self._init_device_state()
        # dispatch spans on CUDA events (card only): (kind, start, end)
        # awaiting their end event, None marking an idle loop (no gap is
        # counted across it); per kind: spans, device ms, gap ms before them
        self._spans: Deque[Optional[Tuple[str, Any, Any]]] = collections.deque()
        self._last_end: Optional[Any] = None
        self.span_stats: Dict[str, Dict[str, float]] = {}

    def _init_offload(self, registry) -> None:
        """The G2/G3 offload plane (``offload.KVOffloadEngine``), armed by
        config or by ``DYN_KV_OFFLOAD`` (env wins outright: an explicit
        host=0 / disk=0 disarms a config-armed tier; only the disk dir
        falls back to config); a no-op -- no thread -- otherwise.  Swap
        preemption rides on it, on unless ``swap_preemption`` (or the
        spec's ``swap``) turns it off."""
        c = self.cfg
        self.offload: Optional[Any] = None
        self.offload_engine: Optional[kvoffload.KVOffloadEngine] = None
        self._swapped: Dict[str, SeqState] = {}
        host_blocks, disk_blocks = c.host_offload_blocks, c.disk_offload_blocks
        disk_dir, swap_on = c.disk_offload_dir, c.swap_preemption
        spec = _env_override("DYN_KV_OFFLOAD", None, _parse_offload_spec)
        if spec is not None:
            host_blocks, disk_blocks = spec["host"], spec["disk"]
            disk_dir = spec["dir"] or disk_dir
            swap_on = spec["swap"] and c.swap_preemption
        if host_blocks > 0 or disk_blocks > 0:
            if disk_blocks > 0 and not disk_dir:
                raise ValueError("disk_offload_blocks > 0 requires disk_offload_dir")
            oe = kvoffload.KVOffloadEngine(
                host_blocks, disk_blocks, disk_dir, swap_enabled=swap_on,
                registry=registry, pinned=self.device.type == "cuda",
            )
            self.offload_engine = oe
            self.offload = oe.host
            oe.holdings_cb = self._emit_kv_holdings
            self.kv.allocator.on_evict = self._on_pool_evict
            self.sched.offload_lookup = self._offload_lookup
            if swap_on:
                self.sched.swap_out = self._swap_out
        self._kv_dtype_name = dtype_name(self.kv.dtype)
        # queue-side prefetch: the offloaded chains of the first N waiting
        # requests are promoted while they wait (_drive_prefetch)
        self._prefetch_window = max(
            int(_env_override("DYN_KV_PREFETCH", c.kv_prefetch_window, _parse_prefetch_window)),
            0,
        )
        self._prefetch_issued: set = set()
        # admission settles on the executor thread while cancels clear on
        # the loop: each request's pins release on exactly one path
        self._prefetch_lock = threading.Lock()
        # onboard and swap-in scatters in flight on the card: (tier, path,
        # bytes, start event, end event, host blobs kept alive until the
        # copies read them); timed once the end event completes
        self._onboards: Deque[Tuple[str, str, int, Any, Any, Any]] = collections.deque()
        # swap-in bytes and seconds by restore path: the retained device
        # snapshot ("device") or the host blob ("host")
        self.swap_in_paths: Dict[str, List[float]] = {}

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

    @classmethod
    def from_pretrained(
        cls,
        model_path: str,
        cfg: Optional[EngineConfig] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "TorchEngine":
        """An engine over a HuggingFace checkpoint directory: its
        ``config.json`` and ``*.safetensors`` files, loaded leaf by leaf
        onto ``device``."""
        from .weights import load_safetensors_params

        device = resolve_device(device)
        model_cfg = ModelConfig.from_pretrained(model_path)
        check_model_geometry(model_cfg, device)
        params = load_safetensors_params(model_path, model_cfg, device)
        return cls(model_cfg, params, cfg, device=device)

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._loop = asyncio.get_running_loop()
        self._wake = asyncio.Event()
        if self.offload_engine is not None:
            # a ready swap blob or a finished promote wakes a sleeping loop
            self.offload_engine.wake_cb = self._wake_from_thread
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
            self._ex.submit(self._settle_onboards, True).result()
            self._ex.shutdown(wait=True)
            if self.offload_engine is not None:
                self.offload_engine.close()

    # -- AsyncEngine --------------------------------------------------------

    async def generate(self, request: Context[Any]) -> AsyncIterator[Annotated]:
        """Token-level generate; yields Annotated[LLMEngineOutput-dict]."""
        if not self._running:
            await self.start()
        data = request.data
        req = PreprocessedRequest.from_dict(data) if isinstance(data, dict) else data
        ctx = request.ctx
        message = None
        try:
            seq = SeqState.from_request(request.id, req, self.sched.block_size)
            mm = seq.mm_embeds
            if mm is not None and (mm.ndim != 2 or mm.shape[1] != self.model_cfg.hidden_size):
                raise ValueError(
                    f"mm_embeds must be rows of the model's hidden size "
                    f"{self.model_cfg.hidden_size}, got shape {list(mm.shape)}"
                )
            self._arm_speculation(seq)  # an unknown drafter: an error stream
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
        self._ctxs[request.id] = ctx
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
                self._ctxs.pop(request.id, None)
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
        """Non-blocking probe: have this generation's results landed, the
        prompt-scoring rows of its echo lanes and its folded verify columns
        included?"""
        return all(
            _handles_ready(e.sampled)
            and (
                not isinstance(e, InflightUnified)
                or e.spec_sampled is None
                or _handles_ready(e.spec_sampled)
            )
            and all(
                pf.prompt_lp is None or _handles_ready(pf.prompt_lp)
                for pf in _prefills_of(e)
            )
            for e in entries
        )

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
                self._fail_drafter_lanes()
                for seq, rec in self._process_swaps():
                    # swap-in: scatter the parked KV back into the lane's
                    # pages and clear the barrier; no token is emitted
                    await self._on_executor(self._apply_swap_in, seq, rec)
                if (
                    not sched.has_runnable_work
                    and not inflight
                    and not self._chunking
                    and not sched.mix_pending
                ):
                    if self.device.type == "cuda":
                        self._spans.append(None)  # idle: no gap across the wait
                    self._wake.clear()
                    if self._swapped:
                        # parked lanes only: a ready swap blob wakes the
                        # loop, the bound re-checks regardless
                        try:
                            await asyncio.wait_for(self._wake.wait(), 1.0)
                        except asyncio.TimeoutError:
                            pass
                    else:
                        await self._wake.wait()
                    continue
                self._drive_prefetch()
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
                    lookahead = (
                        (self._pipe_depth + 1) * max(self.cfg.decode_block_size, ms_block) + 1
                    )
                    # with speculating lanes slotted the floor also covers
                    # a verify dispatch's whole draft span (spec-free
                    # serving keeps its watermark)
                    if any(s is not None and spec_live(s.spec) for s in sched.slots):
                        lookahead = max(
                            lookahead, (self._pipe_depth + 1) * (MAX_DRAFT_TOKENS + 1) + 1
                        )
                    preempted = sched.ensure_decode_capacity(
                        lookahead=lookahead, chunk_pages=GROW_CHUNK_PAGES
                    )
                    if preempted:
                        self.obs.preemptions.inc(len(preempted))
                        if self.offload_engine is not None:
                            for s in preempted:
                                kind = "swap" if s.request_id in self._swapped else "recompute"
                                self.offload_engine.metrics.preemptions.labels(kind).inc()
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
                # be rebuilt active over a half-written cache.  A soft
                # prompt prefills in one dispatch: its injection indexes
                # positions from 0
                for seq, prompt_len in plan.prefills:
                    if (
                        self._chunk_tokens is not None
                        and prompt_len - seq.cached_prompt_tokens > self._chunk_tokens
                        and seq.mm_embeds is None
                    ):
                        seq.prefilling = True
                        seq.prefilled_tokens = seq.cached_prompt_tokens
                # new admissions: the mixed plane packs text prompts; the
                # classic path (soft prompts too, in any tick: the unified
                # step has no injection) batches full prompts by (suffix
                # bucket, prefix-page bucket) and starts long text prompts
                # chunk by chunk
                groups: Dict[Tuple[int, int], List[Tuple[SeqState, int]]] = {}
                for seq, prompt_len in plan.prefills:
                    if not self._holds_slot(seq):
                        continue  # preempted by this tick's capacity pass
                    if mixed_ok and seq.mm_embeds is None:
                        sched.queue_mixed_prefill(seq, seq.cached_prompt_tokens)
                        continue
                    cached = seq.cached_prompt_tokens
                    if (
                        self._chunk_tokens is not None
                        and prompt_len - cached > self._chunk_tokens
                        and seq.mm_embeds is None
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
                # folded verify: on packed mixed ticks the speculating
                # lanes' verify columns ride the unified dispatch; the
                # reserve keeps its token budget honest about them
                fold_active = self._fold_spec and mixed_ok
                spec_reserve = self._spec_fold_reserve() if fold_active else 0
                chunks = (
                    sched.form_mixed_chunks(
                        self._mixed_budget, self._chunk_tokens, spec_reserve
                    )
                    if mixed_ok
                    else []
                )
                k = (
                    self._multistep_plan_k(chunks, minted, spec_reserve)
                    if self._multistep and mixed_ok
                    else 0
                )
                pending = [e for gen in inflight for e in gen]
                ub = None
                if chunks or spec_reserve:
                    ub = await self._on_executor(
                        self._dispatch_unified, chunks, 1, fold_active
                    )
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
                # the standalone verify goes out after the commit phase: a
                # lane's next draft extends its committed history.  It
                # serves classic ticks, the rectangle layout and
                # fold_spec_verify=False
                if not fold_active and any(
                    s is not None and spec_live(s.spec) for s in sched.slots
                ):
                    vb = await self._on_executor(self._dispatch_verify)
                    if vb is not None:
                        if inflight:
                            inflight[-1].append(vb)
                        else:
                            inflight.append([vb])
                if not dispatched and not inflight:
                    self._handle_stalled_admission()
                    await asyncio.sleep(0.001)
                await asyncio.sleep(0)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # the engine must never die silently
                logger.exception("engine tick failed")
                inflight.clear()
                self._spec_failures.clear()
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

    def _multistep_plan_k(
        self, chunks: List[MixedChunk], firsts: bool = False, spec_reserve: int = 0
    ) -> int:
        """Decode steps to fuse into this tick's dispatch: pressure (prefill
        chunks, verify segments, speculating lanes, queued, chunking or
        mid-prefill requests, first tokens sampled by this tick's or the
        previous tick's dispatches) collapses K to 1, each pressure-free
        tick doubles it toward ``multistep_max_k``.  The first-token rule
        is the JAX engine's pending-inject pressure as its serial loop sees
        it (a first token stays pending until the generation after its own
        has been dispatched), read from the dispatches and not from the
        commits: so the pipelined loop fuses the same steps as the serial
        one, whenever its generations land."""
        sched = self.sched
        pressure = (
            bool(chunks)
            or bool(sched.waiting)
            or bool(sched.mix_pending)
            or bool(self._chunking)
            or firsts
            or self._firsts_last_tick
            or bool(spec_reserve)
            or any(
                s is not None and (s.prefilling or s.awaiting_kv or spec_live(s.spec))
                for s in sched.slots
            )
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
            and not s.awaiting_kv
            and not s.prefilling
            and not spec_live(s.spec)
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

    def _host_copy(self, out: torch.Tensor) -> torch.Tensor:
        """Enqueue the non-blocking copy of device rows into a pinned host
        buffer of their own (on the CPU: the rows themselves)."""
        if self.device.type != "cuda":
            return out
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        return host

    def _download(self, out: torch.Tensor, kind: str, start: Optional[Any]) -> Result:
        """Enqueue the non-blocking copy of a dispatch's sampled rows into a
        pinned host buffer of its own and close the dispatch's span (its
        end event marks the copy landed)."""
        if self.device.type != "cuda":
            return Result(out)
        host = self._host_copy(out)
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
        """A lane decodes when slotted, fully prefilled, not parked for a
        swap-in, with write headroom, and not speculating: a lane with live
        speculation advances through its verify columns (an auto-disabled
        one decodes again)."""
        return (
            seq is not None
            and limit > seq_len
            and not seq.awaiting_kv
            and not seq.prefilling
            and not spec_live(seq.spec)
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
        self.obs.observe_dispatch(kind)

    def _note_prefix_stats(self, seq: SeqState) -> None:
        """Prefix-cache stats, token-weighted, once per request."""
        if not seq.stats_counted:
            seq.stats_counted = True
            self._prefix_lookups += len(seq.prompt)
            self._prefix_hits += seq.cached_prompt_tokens
            self.obs.prefix_lookups.inc(len(seq.prompt))
            if seq.cached_prompt_tokens:
                self.obs.prefix_hits.inc(seq.cached_prompt_tokens)

    # -- unified and decode-block dispatches (executor thread) ---------------

    def _dispatch_unified(
        self, chunks: List[MixedChunk], num_steps: int, fold_spec: bool = False
    ) -> Optional[InflightUnified]:
        """Enqueue one unified mixed dispatch (packed axis, or the [B, S]
        rectangle): decode lanes contribute one row each, read from the
        device-resident state, and each chunk its prompt rows; a final
        chunk samples its lane's first token and folds it into the decode
        state on the device.  Host chunk bookkeeping advances at dispatch.
        With ``num_steps > 1`` (a pure-decode packed tick) K decode steps
        fuse into the dispatch.  With ``fold_spec`` (packed layout) the
        verify-eligible speculating lanes contribute their verify segments
        -- last committed token plus drafts -- to the same dispatch, their
        column samples coming back beside the rows.  None when there was
        nothing to dispatch."""
        sched = self.sched
        B = self.cfg.max_batch_size
        spec_lanes = self._gather_spec_lanes() if fold_spec else []
        if fold_spec and not chunks and not spec_lanes:
            # the verify-eligible lanes the loop saw are gone (cancelled,
            # preempted, failed): the decode lanes take a block instead
            return None
        p_start = np.zeros((B,), np.int64)
        p_lens = np.zeros((B,), np.int64)
        p_sample = np.zeros((B,), bool)
        p_act = np.zeros((B,), bool)
        chunk_by_slot: Dict[int, MixedChunk] = {}
        final_chunks: List[MixedChunk] = []
        for ch in chunks:
            b = ch.seq.slot
            chunk_by_slot[b] = ch
            p_start[b] = ch.start
            p_lens[b] = ch.length
            p_sample[b] = ch.final
            # a speculating lane samples its first token here but stays
            # device-inactive: it advances through verify columns
            p_act[b] = ch.final and not spec_live(ch.seq.spec)
            self._prepare_prefill(ch.seq)
            self._note_prefix_stats(ch.seq)
            ch.seq.prefilled_tokens = ch.start + ch.length
            if ch.final:
                ch.seq.prefilling = False
                final_chunks.append(ch)
        # verify segments at the committed cache length (host mirrors are
        # authoritative, as in the standalone verify); the lane's verify
        # is in flight from here until its commit
        v_host = np.zeros((B,), np.int64)
        for seq, b, draft, _ in spec_lanes:
            p_start[b] = sched.seq_lens[b]
            v_host[b] = 1 + len(draft)
            seq.spec.inflight = True
        dec_cap = np.array(
            [
                s is not None
                and p_lens[b] == 0
                and v_host[b] == 0
                and s.finish is None
                and not s.awaiting_kv
                and not s.prefilling
                and not spec_live(s.spec)
                for b, s in enumerate(sched.slots)
            ],
            bool,
        )
        if num_steps > 1 and not dec_cap.any():
            return None
        q_host = np.where(dec_cap, 1, np.where(v_host > 0, v_host, p_lens)).astype(np.int64)
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
        spec_packed = None
        if self._packed:
            packed, spec_packed = self._run_packed(
                chunk_by_slot, p_start, p_lens, p_sample, dec_cap, q_host, total, Pb,
                num_steps, top_n, use_filters, p_act=p_act, v_host=v_host,
                spec_lanes=spec_lanes,
            )
        else:
            S = pow2_bucket(max((ch.length for ch in chunks), default=1))
            # fresh-token rows: used, dispatched, and the rectangle's own
            self.obs.observe_mixed_tokens(total, B * S, B * S)
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
                put(p_lens), put(p_sample), put(p_act), self._samp, top_n,
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
        # the verify columns' copy goes first: the rows' end event marks both
        spec_host = self._host_copy(spec_packed) if spec_lanes else None
        res = self._download(packed, self._span_kind("unified", marks), start)
        self._count("unified")
        self.dispatches_by_k[num_steps] = self.dispatches_by_k.get(num_steps, 0) + 1
        self.obs.observe_mixed(int(dec_cap.sum()), int(p_lens.sum()))
        self.obs.observe_multistep_k(num_steps)
        for pf in finals:
            self._score_prompt(pf)
        return InflightUnified(
            res, slots, [s.life if s is not None else -1 for s in slots], finals,
            num_steps,
            spec_sampled=None if spec_host is None else Result(spec_host, res.event),
            spec_lanes=spec_lanes,
        )

    def _run_packed(
        self, chunk_by_slot, p_start, p_lens, p_sample, dec_cap, q_host, total,
        Pb, num_steps, top_n, use_filters, p_act=None, v_host=None, spec_lanes=(),
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The packed layout: segments in slot order on one flat axis,
        ``(Np, s_max, s_spec)`` resolved through the shape budget; the
        packed step, then the multistep tail's ``num_steps - 1`` decode
        steps.  A final chunk's lane joins decode where ``p_act`` says
        (default: every final chunk's); ``v_host`` and ``spec_lanes`` are
        the verify segments.  On the card a dispatch without chunks or
        verify segments replays the packed step's graph; one with either
        runs eagerly.  Returns ``packed [B, num_steps, 2 + 2*top_n]`` and,
        with verify segments, their column samples ``[B, s_spec, 2 +
        2*top_n]`` (else None)."""
        B = self.cfg.max_batch_size
        if p_act is None:
            p_act = p_sample
        seg_off = np.zeros((B,), np.int64)
        off = off_last = 0
        for b in range(B):
            if q_host[b]:
                seg_off[b] = off_last = off
                off += int(q_host[b])
        # verify columns pad to the draft pow2 rule: 1 + {0, 1, 2, 4, 8}
        max_d = max((len(d) for _, _, d, _ in spec_lanes), default=0)
        s_spec = (1 + (pow2_bucket(max_d) if max_d else 0)) if spec_lanes else 0
        evicted = self._packed_shapes.evictions
        Np, s_max, s_spec = self._packed_shapes.fit(
            pow2_bucket(int(q_host.max())), off_last, total, s_spec
        )
        if self._packed_shapes.evictions != evicted:
            live = set(self._packed_shapes.pairs)
            self.graphs.release(lambda k: k[0] != "packed" or (k[1], k[2], 0) in live)
        self.obs.observe_executable_shapes(len(self._packed_shapes))
        # fresh-token rows: `used` real ones (each fused step adds a row per
        # decode lane), `dispatched` what the steps ran, `rectangle` what
        # the [B, S] layout would have run
        n_decode = int(dec_cap.sum())
        self.obs.observe_mixed_tokens(
            total + n_decode * (num_steps - 1), Np + B * (num_steps - 1),
            B * pow2_bucket(int(p_lens.max())),
        )
        # the packed axis' tokens, lanes, rows and decode flags (the step
        # takes them with the per-lane arrays as one int64 tensor: one
        # host-to-device copy)
        t_tokens = np.zeros((Np,), np.int64)
        t_lane = np.full((Np,), B, np.int64)
        t_rel = np.zeros((Np,), np.int64)
        t_dec = np.zeros((Np,), np.int64)
        drafts = {b: draft for _, b, draft, _ in spec_lanes}
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
            elif b in drafts:
                # a verify segment: the committed token, then the drafts
                t_tokens[o] = self.sched.tokens[b]
                t_tokens[o + 1 : o + ql] = drafts[b]
            else:
                t_dec[o] = 1
        v = self._v
        t = torch.from_numpy
        keys = {
            "packed": ("packed", Np, s_max, Pb, top_n, use_filters),
            "step": ("step", Pb, top_n, use_filters, False),
        }
        packed, *_, spec_packed = packed_unified_multistep(
            self.params, self.model_cfg, self.kv.pages, v["tokens"], v["seq_lens"],
            v["limit_lens"], v["active"], v["stop_ids"], v["page_table"][:, :Pb],
            t(t_tokens), t(t_lane), t(t_rel), t(t_dec), t(p_start), t(p_lens),
            t(p_sample), t(p_act), t(dec_cap), t(seg_off), self._samp, s_max,
            num_steps, top_n, use_filters,
            self._step_runner(keys, eager=bool(chunk_by_slot) or bool(spec_lanes)),
            t(v_host) if s_spec else None, s_spec,
        )
        return packed, (spec_packed if s_spec else None)

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
        self.obs.observe_multistep_k(1)
        return InflightBlock(res, slots, [s.life if s is not None else -1 for s in slots])

    # -- speculative decoding: drafts on the host, verify in one forward ------

    def _arm_speculation(self, seq: SeqState) -> None:
        """Attach a live SpecState to a request that asked for speculation.
        A lane needs a host token history (``seq.blocks``: a soft-prompt
        lane has none) and no sampling penalty (a multi-token verify cannot
        replay the sequential penalty histograms); other requests keep
        plain decode silently.  An unknown drafter kind raises ValueError,
        which fails the request."""
        opts = seq.speculation
        if opts is None or not opts.enabled or opts.num_draft_tokens < 1:
            return
        if seq.blocks is None or self._seq_penalized(seq):
            return
        # the model drafter binds to this engine, not to the process-wide
        # registry; "model" on an engine without one falls through to
        # make_drafter, which raises unless something registered the kind
        if opts.drafter == "model" and self.model_drafter is not None:
            drafter = self.model_drafter
        else:
            drafter = make_drafter(opts.drafter)
        seq.spec = SpecState(
            drafter=drafter,
            num_draft_tokens=min(int(opts.num_draft_tokens), MAX_DRAFT_TOKENS),
            kind=opts.drafter,
        )
        self.spec_metrics.requests.inc()
        self.spec_armed_requests += 1
        self.spec_metrics.enabled_frac.set(self.spec_enabled_frac)

    def _init_model_drafter(self, spec: str) -> None:
        """Load the draft model (a second weight load, on this engine's
        device) and bind it to this engine under drafter kind ``"model"``.
        Its vocabulary must be the target's."""
        from ..spec.model_drafter import ModelDrafter, load_draft_model

        dcfg, dparams = load_draft_model(spec, self.device)
        if dcfg.vocab_size != self.model_cfg.vocab_size:
            raise ValueError(
                f"draft_model {spec!r} vocab {dcfg.vocab_size} != target vocab "
                f"{self.model_cfg.vocab_size}: drafts and targets must share one "
                "token space"
            )
        self.model_drafter = ModelDrafter(dparams, dcfg, self.device)
        logger.info(
            "model drafter armed: %s (%d layers, hidden %d)",
            spec, dcfg.num_layers, dcfg.hidden_size,
        )

    @property
    def spec_enabled_frac(self) -> float:
        """Fraction of spec-armed requests still drafting (1 - auto-disabled
        / armed)."""
        if not self.spec_armed_requests:
            return 1.0
        return 1.0 - self.spec_auto_disabled / self.spec_armed_requests

    def _verify_eligible(self, b: int, seq: Optional[SeqState]) -> bool:
        """A lane whose verify may dispatch now: speculating, committed
        through (no verify in flight, no device-only first token, not
        parked mid-prefill) and with at least one generated token."""
        return (
            seq is not None
            and seq.finish is None
            and spec_live(seq.spec)
            and not seq.spec.inflight
            and not seq.awaiting_kv
            and not seq.prefilling
            and b not in self._pending_injects
            and seq.num_generated + seq.prior_generated >= 1
        )

    def _spec_fold_reserve(self) -> int:
        """Fresh-token rows the speculating lanes would add to this tick's
        unified dispatch (one committed-token column plus the draft budget
        each), 0 when no lane is verify-eligible now.  The loop thread's
        twin of :meth:`_gather_spec_lanes`'s gates, the write-headroom gate
        included: a paused lane must not steer a tick into a unified
        dispatch with nothing to pack."""
        total = 0
        limits: Optional[np.ndarray] = None
        for b, s in enumerate(self.sched.slots):
            if not self._verify_eligible(b, s):
                continue
            if limits is None:
                limits = self._compute_limits()
            if int(limits[b]) - int(self.sched.seq_lens[b]) < 1:
                continue
            total += 1 + s.spec.num_draft_tokens
        return total

    def _propose(self, seq: SeqState, history: List[int], n: int) -> Optional[List[int]]:
        """The lane's drafter's proposal, at most ``n`` tokens.  A drafter
        that raises fails its request: the lane is cancelled here and its
        error goes out from the loop (``_fail_drafter_lanes``); None."""
        st = seq.spec
        try:
            return list(st.drafter.propose(history, n))[:n]
        except Exception as e:  # a drafter's failure is its request's
            logger.exception("drafter %r failed for %s", st.kind, seq.request_id)
            self._spec_failures.append((seq, f"drafter {st.kind!r} failed: {e}"))
            self.sched.cancel(seq)
            return None

    def _fail_drafter_lanes(self) -> None:
        """Send the error of each request whose drafter failed (loop
        thread; its committed tokens went out before)."""
        failed, self._spec_failures = self._spec_failures, []
        for seq, message in failed:
            self._fail_seq(seq, message)

    def _gather_spec_lanes(self) -> List[SpecLane]:
        """The verify-eligible speculating lanes with their drafts
        (executor thread): the one eligibility and drafting body of the
        folded and the standalone verify.  A lane's proposal comes from the
        precompute stamped at its last commit when that still extends its
        history, else from its drafter now; the draft is clamped to the
        lane's write headroom, so it never outruns its pages or budget."""
        sched = self.sched
        limits = self._compute_limits()
        lanes: List[SpecLane] = []
        t0 = time.perf_counter()
        for b, seq in enumerate(sched.slots):
            if not self._verify_eligible(b, seq):
                continue
            st = seq.spec
            headroom = int(limits[b]) - int(sched.seq_lens[b])
            if headroom < 1:
                continue  # no writable position: growth or preemption next
            n = min(st.num_draft_tokens, headroom - 1, MAX_DRAFT_TOKENS)
            draft: List[int] = []
            if n > 0:
                history = seq.blocks.tokens
                got = st.take_pending_draft(len(history), n)
                if got is None:
                    got = self._propose(seq, history, n)
                    if got is None:
                        continue  # the drafter failed: the request fails
                draft = got
            lanes.append((seq, b, draft, seq.life))
        if lanes:
            self.spec_metrics.draft_latency.observe(max(time.perf_counter() - t0, 0.0))
        return lanes

    def _dispatch_verify(self) -> Optional[InflightVerify]:
        """Enqueue one standalone verify over the speculating lanes (classic
        ticks, the rectangle layout, ``fold_spec_verify=False``): each
        lane's last committed token and drafts as columns of one
        ``verify_and_sample`` (kernel 3 on the card), the draft axis padded
        to a power of two.  A lane with no proposal rides with no draft
        column: its verify is a plain decode step."""
        lanes = self._gather_spec_lanes()
        if not lanes:
            return None
        sched = self.sched
        B = self.cfg.max_batch_size
        max_d = max(len(d) for _, _, d, _ in lanes)
        S = 1 + (pow2_bucket(max_d) if max_d else 0)
        tokens = np.zeros((B, S), np.int64)
        base = np.zeros((B,), np.int64)
        n_tok = np.zeros((B,), np.int64)
        seqs: List[Optional[SeqState]] = [None] * B
        for seq, b, draft, _ in lanes:
            tokens[b, 0] = sched.tokens[b]
            tokens[b, 1 : 1 + len(draft)] = draft
            base[b] = sched.seq_lens[b]
            n_tok[b] = 1 + len(draft)
            seqs[b] = seq
            seq.spec.inflight = True
        start = self._span_start()
        put = self._put
        packed = verify_and_sample(
            self.params, self.model_cfg, self.kv.pages, put(tokens), put(base),
            put(n_tok), put(sched.page_table[:, : self._live_page_bucket()]),
            self._sampling_params(seqs), self._lp_top(seqs),
            any(s is not None and self._needs_filters(s.sampling) for s in seqs),
        )
        res = self._download(packed, "verify", start)
        self._count("verify")
        return InflightVerify(res, lanes)

    def _commit_spec_columns(
        self, lanes: List[SpecLane], arr: np.ndarray, dispatched_at: float, now: float
    ) -> List[StepEvent]:
        """The host accept walk over one verify's columns ``[B, S, 2 + 2N]``,
        folded or standalone: a lane commits the target samples of its
        verified draft prefix and the sample at the first mismatch, through
        the stop-rule replay; the rest of its column is dropped.  A lane
        preempted, cancelled or re-admitted since the dispatch discards its
        whole column."""
        events: List[StepEvent] = []
        sched = self.sched
        N = (arr.shape[-1] - 2) // 2
        toks, lps, tids, tlps = unpack_sampled_logprobs(arr, N)
        for seq, slot, draft, life in lanes:
            st = seq.spec
            st.inflight = False
            if (
                seq.finish is not None
                or seq.slot != slot
                or sched.slots[slot] is not seq
                or seq.life != life
                or seq.awaiting_kv
                or seq.prefilling
            ):
                continue
            col = toks[slot]
            m = longest_accepted(draft, col)
            column = np.full((col.shape[0],), -1, np.int64)
            column[: m + 1] = col[: m + 1]
            ev = sched._commit_lane_column(
                seq, column, lps[slot], tids[slot] if N else None,
                tlps[slot] if N else None,
            )
            # accepted counts verified drafts that committed: the replay may
            # finish the lane mid-column
            accepted = min(m, len(ev.tokens))
            st.drafted += len(draft)
            st.accepted += accepted
            st.verify_steps += 1
            self.spec_drafted += len(draft)
            self.spec_accepted += accepted
            if draft:
                self.spec_metrics.drafted.labels(st.kind).inc(len(draft))
                if accepted:
                    self.spec_metrics.accepted.labels(st.kind).inc(accepted)
            if ev.finished is not None:
                seq.finish = ev.finished
                sched._release_slot(seq)
            else:
                self._spec_post_commit(seq, st)
            if ev.tokens or ev.finished is not None:
                events.append(ev)
        self.spec_verify_steps += 1
        self.spec_metrics.verify_steps.inc()
        if self.spec_drafted:
            self.spec_metrics.accept_rate.set(self.spec_accepted / self.spec_drafted)
        self.spec_metrics.verify_latency.observe(max(now - dispatched_at, 0.0))
        return events

    def _spec_post_commit(self, seq: SeqState, st: SpecState) -> None:
        """After a lane's columns commit: acceptance-aware auto-disable,
        then the next proposal, precomputed now and stamped with the
        history length.  An auto-disabled lane decodes plainly from its
        next row scatter on (no output change: committed tokens were always
        the target's).  The precompute runs while the pipeline's other
        generations are in flight, so a model drafter's forward does not
        sit between two dispatches."""
        if (
            self._spec_auto_disable
            and st.enabled
            and st.drafted >= self._spec_disable_after
            and st.accept_rate < self._spec_min_accept
        ):
            st.enabled = False
            st.auto_disabled = True
            st.pending_draft = None
            self.spec_auto_disabled += 1
            self.spec_metrics.auto_disabled.inc()
            self.spec_metrics.enabled_frac.set(self.spec_enabled_frac)
            self.sched.dirty_slots.add(seq.slot)
            return
        if not st.enabled:
            return
        history = seq.blocks.tokens
        got = self._propose(seq, history, st.num_draft_tokens)
        st.pending_draft = None if got is None else (len(history), got)

    # -- classic prefill dispatches (executor thread) -----------------------

    def _dispatch_full_prefill_batch(
        self, seqs: List[SeqState], Bp: int
    ) -> torch.Tensor:
        """Full-prompt prefills plus first-token samples for up to ``Bp``
        lanes; rows past ``len(seqs)`` are pad lanes (length 0, trash page).
        A group with a soft-prompt lane injects each lane's rows over its
        leading positions (text lanes take none), the row count padded to a
        power of two.  Returns the packed samples ``[Bp, 2 + 2*top_n]``."""
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
        top_n = self._lp_top(lanes)
        penalized = any(self._seq_penalized(s) for s in seqs)
        mm = mm_len = None
        if any(s.mm_embeds is not None for s in seqs):
            mm_lens = [0 if s.mm_embeds is None else len(s.mm_embeds) for s in seqs]
            M = pow2_bucket(max(mm_lens))
            rows = np.zeros((Bp, M, self.model_cfg.hidden_size), np.float32)
            for i, s in enumerate(seqs):
                if s.mm_embeds is not None:
                    rows[i, : mm_lens[i]] = s.mm_embeds
            mm = put(rows)
            mm_len = put(np.asarray(mm_lens + [0] * (Bp - len(seqs)), np.int64))
        return prefill_mm_and_sample(
            self.params, self.model_cfg, self.kv.pages, put(tokens), put(lens),
            put(table), mm, mm_len, self._sampling_params(lanes), top_n, penalized,
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
            self._prepare_prefill(seq)
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
        res = self._download(packed, "prefill", start)
        self._count("prefill")
        for pf in entries:
            self._score_prompt(pf)
        return [InflightPrefillGroup(res, entries)]

    def _do_prefill(self, seq: SeqState) -> Optional[InflightPrefill]:
        """A classic chunk-bound admission (already parked ``prefilling``):
        the admission row must land with the lane inactive, then the first
        chunk dispatches."""
        self._prepare_prefill(seq)
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
        self._score_prompt(pf)
        return pf

    def _dispatch_chunk(self, seq: SeqState) -> Optional[InflightPrefill]:
        """Advance one page-aligned chunk of a classic chunked prefill.  An
        intermediate chunk writes KV and samples nothing (None); the last
        one (or, with chunking off, the rest of a prompt drained from the
        mixed plane) samples the first token and re-activates the lane
        (a dirty row ordered after the dispatch)."""
        self._prepare_prefill(seq)
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

    # -- prompt scoring and embeddings (executor thread) -----------------------

    def _score_prompt(self, pf: InflightPrefill) -> None:
        """Echo+logprobs: dispatch the prompt-scoring forward (no KV
        writes) right after the lane's prefill dispatch, once per request
        (a recompute-resumed lane's folded prompt holds its output); its
        rows commit with the first token."""
        seq = pf.seq
        if seq.prompt_logprobs is None or seq.prompt_lp_sent or seq.prior_generated:
            return
        prompt = seq.prompt
        toks = np.zeros((1, pick_bucket(self.buckets, len(prompt))), np.int64)
        toks[0, : len(prompt)] = prompt
        t0 = self._span_start()
        out = score_prompt_step(
            self.params, self.model_cfg, self.kv.pages, self._put(toks),
            self._put(np.asarray([len(prompt)], np.int64)),
            8 if seq.prompt_logprobs else 0,
        )
        self._count("prompt_score")
        pf.prompt_lp = self._download(out, "prompt_score", t0)

    @staticmethod
    def _prompt_lp_entries(seq: SeqState, packed: np.ndarray) -> List[Any]:
        """Packed scoring rows ``[T, 2 + 2N]`` -> per-prompt-position
        entries ``[token_id, logprob|None, top|None]`` (position 0 carries
        None: nothing precedes it, the OpenAI prompt-logprobs shape)."""
        N = (packed.shape[-1] - 2) // 2
        _, lps, tids, tlps = unpack_sampled_logprobs(packed, N)
        prompt = seq.prompt
        out: List[Any] = [[int(prompt[0]), None, None]]
        for j in range(1, len(prompt)):
            top = (
                [[int(i), float(lp)] for i, lp in zip(tids[j - 1], tlps[j - 1])]
                if N
                else None
            )
            out.append([int(prompt[j]), float(lps[j - 1]), top])
        return out

    async def embed(self, token_batches: List[List[int]]) -> List[List[float]]:
        """Pooled embeddings for pre-tokenized inputs (/v1/embeddings): the
        final hidden rows mean-pooled over each input and L2-normalised.
        Inputs sorted by length go in groups of ``max_batch_size``, one
        bucket-padded dispatch each, the batch padded to a power of two.
        Runs on the engine's executor, serialized with the tick loop: the
        forward reads no KV page and writes none, so in-flight decode state
        is untouched, but a large call delays every stream by its
        duration."""
        if not token_batches:
            return []
        for t in token_batches:
            if not t:
                raise ValueError("embedding input must be non-empty")
            if len(t) > self.cfg.max_seq_len:
                raise ValueError(
                    f"embedding input of {len(t)} tokens exceeds max_seq_len"
                    f" {self.cfg.max_seq_len}"
                )
        return await self._on_executor(self._embed_sync, token_batches)

    def _embed_sync(self, token_batches: List[List[int]]) -> List[List[float]]:
        out: List[Optional[List[float]]] = [None] * len(token_batches)
        order = sorted(range(len(token_batches)), key=lambda i: len(token_batches[i]))
        B = self.cfg.max_batch_size
        for lo in range(0, len(order), B):
            group = order[lo : lo + B]
            bucket = pick_bucket(self.buckets, max(len(token_batches[i]) for i in group))
            # pad lanes have length 0 and come out as zero rows
            Bp = min(pow2_bucket(len(group)), B)
            toks = np.zeros((Bp, bucket), np.int64)
            lens = np.zeros((Bp,), np.int64)
            for row, i in enumerate(group):
                t = token_batches[i]
                toks[row, : len(t)] = t
                lens[row] = len(t)
            t0 = self._span_start()
            vecs = embed_step(
                self.params, self.model_cfg, self.kv.pages, self._put(toks), self._put(lens)
            )
            self._count("embed")
            vecs = self._download(vecs, "embed", t0).numpy()
            for row, i in enumerate(group):
                out[i] = vecs[row].tolist()
        return out  # type: ignore[return-value]

    # -- commits (executor thread) ------------------------------------------

    def _commit_all(self, entries: List[Inflight]) -> List[StepEvent]:
        """Read and commit one dispatch generation (or one classic prefill
        dispatch) in dispatch order: every result in one pass, then the
        stop-rule replay."""
        self._settle_onboards()
        mats = [e.sampled.numpy() for e in entries]
        spec_mats = {
            id(e): e.spec_sampled.numpy()
            for e in entries
            if isinstance(e, InflightUnified) and e.spec_sampled is not None
        }
        # echo lanes' prompt-scoring rows: each result waits on its own event
        lp_mats = {
            id(pf): pf.prompt_lp.numpy()
            for e in entries
            for pf in _prefills_of(e)
            if pf.prompt_lp is not None
        }
        now = time.perf_counter()
        self._drain_spans()
        sched = self.sched
        events: List[StepEvent] = []

        def attach_prompt_lps(ev: StepEvent, pf: InflightPrefill) -> None:
            plp = lp_mats.get(id(pf))
            if plp is not None and not pf.seq.prompt_lp_sent:
                ev.prompt_logprobs = self._prompt_lp_entries(pf.seq, plp[0])
                pf.seq.prompt_lp_sent = True

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
            ev = sched.commit_prefill_token(seq, int(tok), float(lp), top)
            attach_prompt_lps(ev, pf)
            events.append(ev)

        for e, mat in zip(entries, mats):
            if isinstance(e, InflightPrefillGroup):
                for i, pf in enumerate(e.entries):
                    commit_prefill(pf, mat[i])
                self.obs.observe_step("prefill", now - e.dispatched_at)
            elif isinstance(e, InflightPrefill):
                commit_prefill(e, mat[0])
                self.obs.observe_step("prefill", now - e.dispatched_at)
            elif isinstance(e, InflightVerify):
                events.extend(self._commit_spec_columns(e.lanes, mat, e.dispatched_at, now))
                self.obs.observe_step("verify", now - e.dispatched_at)
            else:
                finals = {}
                if isinstance(e, InflightUnified):
                    for pf in e.finals:
                        finals[pf.slot] = pf
                        if self._pending_injects.get(pf.slot) is pf:
                            del self._pending_injects[pf.slot]
                N = (mat.shape[-1] - 2) // 2
                toks, lps, tids, tlps = unpack_sampled_logprobs(mat, N)
                block_events = sched.commit_block(
                    toks, e.slots, lps, tids if N else None, tlps if N else None,
                    lives=e.lives,
                )
                # a final chunk's first token commits in the block replay;
                # its prompt logprobs ride that event (events fire only for
                # lanes still resident, so the slot is the dispatch's)
                for ev in block_events:
                    pf = finals.get(ev.seq.slot)
                    if pf is not None and pf.seq is ev.seq:
                        attach_prompt_lps(ev, pf)
                events.extend(block_events)
                sp = spec_mats.get(id(e))
                if sp is not None:
                    # the folded verify columns commit after the dispatch's
                    # other rows (their lanes are disjoint)
                    events.extend(
                        self._commit_spec_columns(e.spec_lanes, sp, e.dispatched_at, now)
                    )
                    self.spec_metrics.folded_steps.inc()
                kind = "unified" if isinstance(e, InflightUnified) else "decode_block"
                self.obs.observe_step(kind, now - e.dispatched_at)
        alloc = self.kv.allocator
        self.obs.observe_kv(alloc.used_pages, alloc.num_pages - 1)
        return events

    # -- KV offload: G1 -> G2 -> G3, onboarding, prefetch, swap ---------------

    def _on_pool_evict(self, blk) -> None:
        """PagePool eviction hook (loop thread, inside the pool's
        allocation, before the pages return to the free list): enqueue a
        device gather of the block's pages and its copy into pinned host
        memory on the current stream -- the dispatches' stream, so the
        gather precedes any dispatch that reuses the pages -- and hand the
        snapshot to the offload thread, which waits for its event.  A
        failed snapshot is a later cache miss, counted."""
        oe = self.offload_engine
        try:
            snap = PageSnapshot(
                gather_block_pages(self.kv.pages, self._put(np.asarray(blk.pages, np.int64)))
            )
        except Exception:
            logger.exception("offload snapshot failed for block %x", blk.sequence_hash)
            oe.note_copy_fail()
            return
        meta = kvoffload.BlockMeta(
            block_hash=blk.block_hash,
            parent_sequence_hash=blk.parent_sequence_hash,
            position=blk.position,
            kv_dtype=self._kv_dtype_name,
        )
        oe.submit_evict(blk.sequence_hash, snap, meta)

    def _drive_prefetch(self) -> None:
        """Issue tracked prefetch walks for the queue's admission window
        (loop thread, once per tick): each request's offloaded prefix chain
        is promoted disk -> host and pinned in the ring, so by the time it
        reaches a slot the prefix match's tier lookup is a RAM hit.  Only
        the first ``_prefetch_window`` waiting requests are walked -- queue
        position is the prefetch priority."""
        oe = self.offload_engine
        if oe is None or self._prefetch_window == 0 or not self.sched.waiting:
            return
        pool = self.sched.pool
        for i, seq in enumerate(self.sched.waiting):
            if i >= self._prefetch_window:
                break
            rid = seq.request_id
            if seq.blocks is None or seq.awaiting_kv:
                # swap-parked (and soft-prompt) lanes never consume onboards
                continue
            # marked even when nothing is offloaded: a block evicted after
            # this scan is handled by the admission-time tier lookup
            with self._prefetch_lock:
                if rid in self._prefetch_issued:
                    continue
                self._prefetch_issued.add(rid)
            max_blocks = max(0, (len(seq.prompt) - 1) // self.sched.block_size)
            hashes = [
                h for h in seq.blocks.sequence_hashes()[:max_blocks]
                if not pool.is_registered(h)
            ]
            if hashes:
                oe.prefetch(hashes, request_id=rid)

    def _note_prefetch_admission(self, seq: SeqState) -> None:
        """Admission reached the request: settle its tracked prefetch
        (staged blocks its onboards consume are hits; the ring pins
        release).  Runs before ``_apply_onboards`` drains the pending
        list."""
        oe = self.offload_engine
        if oe is None:
            return
        with self._prefetch_lock:
            issued = seq.request_id in self._prefetch_issued
            self._prefetch_issued.discard(seq.request_id)
        if not issued:
            return
        consumed = [h for h, _p, _b, _m in seq.pending_onboard]
        seq.prefetch_hits = oe.finish_prefetch(seq.request_id, consumed)

    def _cancel_prefetch(self, rid: str) -> None:
        """A request left without admitting (cancel, error, finish): free
        its host-staged prefetch state."""
        with self._prefetch_lock:
            issued = rid in self._prefetch_issued
            self._prefetch_issued.discard(rid)
        if issued and self.offload_engine is not None:
            self.offload_engine.cancel_prefetch(rid)

    def _offload_lookup(self, seq_hash: int):
        """The scheduler's tier lookup (the prefix match's G1 -> G2 -> G3
        continuation): RAM hits return at once; a disk-only hit starts an
        async promote and misses this admission (the queue-side prefetch
        makes that case rare)."""
        hit = self.offload_engine.lookup(seq_hash)
        if hit is None:
            return None
        blob, meta, _tier = hit
        return blob, meta

    def _prepare_prefill(self, seq: SeqState) -> None:
        """Before a lane's first prefill dispatch reads its prefix: settle
        its prefetch and scatter its pending onboards."""
        self._note_prefetch_admission(seq)
        if seq.pending_onboard:
            self._apply_onboards(seq)

    def _coerce_blob(self, blob):
        """A tier blob in this pool's dtype domain (``coerce_kv_blob``):
        same-domain blobs pass through byte for byte."""
        return coerce_kv_blob(blob, self.kv.quantized, dtype_name(self.dtype))

    def _blob_on_device(self, blobs: List[Any]) -> Any:
        """Host blobs stacked on the pages axis, on the device: each blob
        one non-blocking copy (from pinned memory on the card) into its
        block of a device tensor, the blocks then laid out as the pool's
        ``[L, 2, n, page, Hkv, D]``."""

        def stack(parts: List[np.ndarray]) -> torch.Tensor:
            first = tensor_view(parts[0])
            out = torch.empty((len(parts),) + tuple(first.shape), dtype=first.dtype, device=self.device)
            for i, a in enumerate(parts):
                out[i].copy_(first if i == 0 else tensor_view(a), non_blocking=True)
            # [n, L, 2, ppb, ...] -> [L, 2, n * ppb, ...]
            out = out.movedim(0, 2)
            return out.reshape(out.shape[:2] + (-1,) + tuple(out.shape[4:]))

        if isinstance(blobs[0], QuantKV):
            return QuantKV(q=stack([b.q for b in blobs]), s=stack([b.s for b in blobs]))
        return stack(blobs)

    def _scatter_pages(self, page_ids: Sequence[int], blob: Any) -> None:
        """One page-bucketed, layer-chunked scatter of ``blob`` (device, on
        the pages axis) into ``page_ids``: the ids pad to their page bucket
        with trash page 0, the blob with zero pages."""
        bucket = pick_page_bucket(len(page_ids), self.sched.max_pages)
        ids = np.zeros((bucket,), np.int64)
        ids[: len(page_ids)] = page_ids
        ids_t = self._put(ids)
        padded = pad_page_axis(blob, bucket)
        L = self.model_cfg.num_layers
        for lo, hi in layer_chunk_spans(L, None, ONBOARD_CHUNKS):
            chunk = (
                QuantKV(q=padded.q[lo:hi], s=padded.s[lo:hi])
                if isinstance(padded, QuantKV)
                else padded[lo:hi]
            )
            scatter_layer_pages(self.kv.pages, slice(lo, hi), ids_t, chunk)

    def _onboard_start(self) -> Any:
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _onboard_done(self, tier: str, path: str, nbytes: int, start: Any, keep: Any) -> None:
        """Account one onboard or swap-in scatter: on the card once its
        end event completes (``keep``, the host blobs its copies read,
        lives until then), on the CPU now."""
        if self.device.type != "cuda":
            self._record_onboard(tier, path, nbytes, time.perf_counter() - start)
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self._onboards.append((tier, path, nbytes, start, end, keep))

    def _settle_onboards(self, wait: bool = False) -> None:
        """Record the onboards whose scatter has landed (all of them with
        ``wait``), in order, with their device time."""
        while self._onboards:
            tier, path, nbytes, start, end, _keep = self._onboards[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self._onboards.popleft()
            self._record_onboard(tier, path, nbytes, start.elapsed_time(end) / 1e3)

    def _record_onboard(self, tier: str, path: str, nbytes: int, seconds: float) -> None:
        self.offload_engine.record_onboard(tier, nbytes, seconds)
        if tier == "swap":
            d = self.swap_in_paths.setdefault(path, [0.0, 0.0])
            d[0] += nbytes
            d[1] += seconds

    def _apply_onboards(self, seq: SeqState) -> None:
        """Scatter the lane's offload-tier hits into their pages and
        register them (executor thread, before the prefill dispatch that
        reads them): all of the admission's hits in one page-bucketed,
        layer-chunked scatter, enqueued before that dispatch on its
        stream."""
        pending, seq.pending_onboard = seq.pending_onboard, []
        ids = [p for _h, pages, _b, _m in pending for p in pages]
        blobs = [self._coerce_blob(b) for _h, _p, b, _m in pending]
        start = self._onboard_start()
        self._scatter_pages(ids, self._blob_on_device(blobs))
        self._onboard_done("prefix", "host", sum(b.nbytes for b in blobs), start, blobs)
        pool = self.sched.pool
        for seq_hash, pages, _blob, meta in pending:
            if pool.register(
                seq_hash,
                pages,
                block_hash=meta.block_hash,
                parent_sequence_hash=meta.parent_sequence_hash,
                position=meta.position,
            ):
                seq.held_blocks.append(seq_hash)
                for p in pages:
                    seq.owned_pages.remove(p)
            # register False: a twin onboarded it meanwhile; keep ownership

    def _swap_out(self, seq: SeqState) -> bool:
        """The scheduler's ``swap_out`` hook (loop thread, victim still
        slotted): snapshot the lane's committed KV -- ``cache_len`` from
        the host mirror; in-flight generations write only past it -- and
        park the sequence.  Declines (recompute) whenever the lane's state
        is not fully host-visible: mid-prefill, parked, nothing committed
        this life, a first token still device-only -- or the budget is
        exhausted."""
        if self.offload_engine is None:
            return False
        if seq.awaiting_kv or seq.prefilling or seq.finish is not None:
            return False
        if seq.num_generated < 1 or seq.slot < 0 or seq.blocks is None:
            return False
        if seq.slot in self._pending_injects:
            return False  # a device-only sampled token would be lost
        cache_len = int(self.sched.seq_lens[seq.slot])
        n_pages = -(-cache_len // self.cfg.page_size)
        if cache_len <= 0 or n_pages > len(seq.pages):
            return False
        try:
            ids = self._put(np.asarray(seq.pages[:n_pages], np.int64))
            snap = PageSnapshot(gather_block_pages(self.kv.pages, ids))
        except Exception:
            logger.exception("swap snapshot failed for %s", seq.request_id)
            return False
        n_blocks = -(-n_pages // self.sched.pool.pages_per_block)
        if not self.offload_engine.swap_out(seq.request_id, snap, cache_len, n_blocks):
            return False
        self._swapped[seq.request_id] = seq
        return True

    def _process_swaps(self) -> List[Tuple[SeqState, Any]]:
        """Loop side of swap-in: the (seq, record) pairs whose restore is
        due (lane admitted, a device copy or host blob ready).  A record
        with no restorable copy falls back to recompute."""
        if not self._swapped:
            return []
        out: List[Tuple[SeqState, Any]] = []
        for rid, seq in list(self._swapped.items()):
            if seq.finish is not None or not seq.awaiting_kv:
                self._swapped.pop(rid, None)
                self.offload_engine.drop_swap(rid)
                continue
            rec = self.offload_engine.poll_swap(rid)
            if rec is None or (rec.state == kvoffload.SWAP_FAILED and rec.dev is None):
                self._swap_recompute(seq, "copy_fail")
                continue
            if (rec.dev is None and rec.state != kvoffload.SWAP_READY) or seq.slot < 0:
                continue  # blob still materializing / lane not admitted
            self._swapped.pop(rid, None)
            out.append((seq, rec))
        return out

    def _swap_recompute(self, seq: SeqState, cause: str) -> None:
        """Swap restore impossible: unpark the sequence onto the recompute
        path (slot and pages release; the folded prompt re-prefills),
        counted as a fallback."""
        rid = seq.request_id
        self._swapped.pop(rid, None)
        oe = self.offload_engine
        oe.drop_swap(rid)
        oe.swap_fallbacks += 1
        oe.metrics.swap_fallbacks.labels(cause).inc()
        seq.awaiting_kv = False
        if seq.slot >= 0:
            self.sched._release_slot(seq)
            seq.slot = -1
            self.sched.waiting.appendleft(seq)

    def _apply_swap_in(self, seq: SeqState, rec) -> None:
        """Executor thread: scatter a parked lane's KV back into its pages
        and clear its barrier.  The snapshot covers ``cache_len =
        len(prompt) - 1`` committed positions of the folded prompt;
        admission wrote ``tokens[b] = prompt[-1]``, so with ``seq_lens``
        rewound to ``cache_len`` the lane's next decode step recomputes
        position P-1's KV and samples what a re-prefill would: swap and
        recompute give the same tokens.  The retained device snapshot
        restores device to device; a host blob (its device copy dropped for
        budget) crosses the link.  The dirty row carries the lane's token,
        length and page-table row into the device state, which the next
        dispatch (or graph replay) reads."""
        rid = seq.request_id
        sched = self.sched
        try:
            dev = rec.dev  # read once: the offload thread may drop it
            blob = dev if dev is not None else rec.blob
            if blob is None:
                self._swapped[rid] = seq  # retry next tick
                return
            cache_len = rec.cache_len
            n_pages = -(-cache_len // self.cfg.page_size)
            data = blob.q if isinstance(blob, QuantKV) else blob
            if (
                seq.slot < 0
                or sched.slots[seq.slot] is not seq
                or n_pages > len(seq.pages)
                or int(data.shape[2]) != n_pages
            ):
                self._swapped[rid] = seq  # re-examine next tick
                return
            start = self._onboard_start()
            if dev is not None:
                keep, path = None, "device"
            else:
                keep, path = self._coerce_blob(blob), "host"
                blob = self._blob_on_device([keep])
            self._scatter_pages(seq.pages[:n_pages], blob)
            self._onboard_done("swap", path, int(blob.nbytes), start, keep)
        except Exception:
            logger.exception("swap-in restore failed for %s; recomputing", rid)
            self._swap_recompute(seq, "copy_fail")
            return
        self.offload_engine.drop_swap(rid)
        sched.seq_lens[seq.slot] = cache_len
        sched.tokens[seq.slot] = seq.prompt[-1]
        seq.awaiting_kv = False
        sched.dirty_slots.add(seq.slot)

    # -- KV events ------------------------------------------------------------

    def _to_loop(self, sink, event: Dict[str, Any]) -> None:
        """Call ``sink(event)`` on the engine's loop: sinks are not
        thread-safe, so emissions from the executor and offload threads
        hop there."""
        loop = self._loop
        if loop is None:
            sink(event)
            return
        try:
            on_loop = asyncio.get_running_loop() is loop
        except RuntimeError:
            on_loop = False
        if on_loop:
            sink(event)
        else:
            try:
                loop.call_soon_threadsafe(sink, event)
            except RuntimeError:
                pass  # loop already closed during shutdown

    def _emit_kv_event(self, event: Dict[str, Any]) -> None:
        """PagePool ``event_sink`` -> ``kv_event_sink``: registration fires
        in commits on the executor thread, eviction on the loop thread."""
        sink = self.kv_event_sink
        if sink is not None:
            self._to_loop(sink, event)

    def _emit_kv_holdings(self, delta) -> None:
        """Offload-plane ``holdings_cb`` -> ``kv_holdings_sink``: tuple rows
        ``(hash, tier|None, nbytes)`` become wire rows ``{"sequence_hash",
        "tier", "nbytes"}``; deltas fire on the offload thread."""
        sink = self.kv_holdings_sink
        if sink is None:
            return
        event = {
            "type": "holdings",
            "delta": [
                {"sequence_hash": int(h), "tier": tier, "nbytes": int(n)}
                for h, tier, n in delta
            ],
        }
        self._to_loop(sink, event)

    def _wake_from_thread(self) -> None:
        loop, wake = self._loop, self._wake
        if loop is None or wake is None:
            return
        try:
            loop.call_soon_threadsafe(wake.set)
        except RuntimeError:
            pass  # loop already closed during shutdown

    def status(self) -> Dict[str, int]:
        """Queue, batch and KV occupancy (the JAX engine's flight-recorder
        state): reads only."""
        alloc = self.kv.allocator
        return {
            "waiting": len(self.sched.waiting),
            "active": self.sched.num_active,
            "slots": self.cfg.max_batch_size,
            "kv_pages_used": alloc.used_pages,
            "kv_pages_total": alloc.num_pages - 1,
            "chunking": len(self._chunking),
            "swapped": len(self._swapped),
            "tokens_generated": self._tokens_generated,
        }

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
            if ev.tokens:
                self.obs.tokens.inc(len(ev.tokens))
            if queue is None:
                continue
            if ev.tokens:
                out = LLMEngineOutput(token_ids=list(ev.tokens))
                want = ev.seq.sampling.logprobs
                if want is not None and ev.logprobs:
                    out.logprobs = list(ev.logprobs)
                    if want > 0 and ev.top_logprobs is not None:
                        out.top_logprobs = [t[:want] for t in ev.top_logprobs]
                if ev.prompt_logprobs is not None:
                    out.prompt_logprobs = ev.prompt_logprobs
                queue.put_nowait(Annotated.from_data(out.to_dict()))
            if ev.finished is not None:
                self._nonce_of.pop(ev.seq.request_id, None)
                self._ctxs.pop(ev.seq.request_id, None)
                # backstop: prefetch state still tracked at finish releases
                # its pins here
                self._cancel_prefetch(ev.seq.request_id)
                out = LLMEngineOutput.finished(ev.finished)
                if not ev.tokens and ev.prompt_logprobs is not None:
                    # the first token finished the request outright (a
                    # swallowed stop): the prompt logprobs still ship
                    out.prompt_logprobs = ev.prompt_logprobs
                st = ev.seq.spec
                if st is not None:
                    # the request's acceptance, for the usage extension
                    out.spec = {
                        "drafted_tokens": st.drafted,
                        "accepted_tokens": st.accepted,
                        "acceptance_rate": round(st.accept_rate, 6),
                        "drafter": st.kind,
                        "auto_disabled": st.auto_disabled,
                    }
                queue.put_nowait(Annotated.from_data(out.to_dict()))
                queue.put_nowait(None)

    def _fail_seq(self, seq: SeqState, message: str) -> None:
        if seq.finish is None:
            seq.finish = FinishReason.ERROR
        self._nonce_of.pop(seq.request_id, None)
        self._ctxs.pop(seq.request_id, None)
        self._cancel_prefetch(seq.request_id)
        if self._swapped.pop(seq.request_id, None) is not None:
            self.offload_engine.drop_swap(seq.request_id)
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
        # a killed context whose stream was never read never reaches the
        # stream's own cancel paths: the kill is read here
        self._cancelled.update(rid for rid, ctx in self._ctxs.items() if ctx.is_killed())
        if not self._cancelled:
            return
        by_id = {s.request_id: s for s in self.sched.slots if s is not None}
        by_id.update({s.request_id: s for s in self.sched.waiting})
        for rid in list(self._cancelled):
            self._cancelled.discard(rid)
            self._nonce_of.pop(rid, None)
            self._ctxs.pop(rid, None)
            self._cancel_prefetch(rid)
            if self._swapped.pop(rid, None) is not None:
                self.offload_engine.drop_swap(rid)
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
