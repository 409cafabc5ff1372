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

Disaggregation is the JAX engine's (``llm/disagg.py`` drives it).  A
prefill worker's engine exports prompts: ``prefill_export_batch`` runs one
full-prompt prefill dispatch per group of similar lengths into scratch
pages (``_dispatch_full_prefill_batch``, the classic path's site, so the
single, batched and aggregated exports agree), gathers the group's pages
on the dispatch stream -- before any later dispatch reuses them -- and
frees the scratch; the copy stays on the device for a decode engine in the
same process, or goes without blocking into pinned host memory behind a
CUDA event, per layer group for a chunked export
(``prefill_export_batch_stream``, :class:`KVExportStream`); the waits for
those copies run off the executor.  A decode worker's engine admits a
remote request parked ``awaiting_kv`` (``generate_external``) into fresh
pages; ``deliver_external`` (or the chunked ``begin``/``deliver``/
``commit``) queues the KV, and the tick loop scatters it into the lane's
pages in place on the dispatch stream (``_scatter_pages``, the swap-in's
scatter), commits the remotely sampled first token and hands the lane to
the device state by a dirty row, so graphs captured earlier replay it.  A
parked lane fails alone on a prefill error, a misshaped blob or its
``external_kv_timeout_s`` (a delivery that lands before its slot clears
the deadline).  ``KVExportStream`` has no ``from_blob``: the JAX export
stream's per-request fallback wraps a materialized blob with it, and the
port's fallback exports the one request through the same stream instead.

Cross-worker prefix onboarding is the JAX engine's (``llm/
prefix_onboard.py`` drives it).  The donor's ``export_blocks`` takes the
longest resident prefix of a hash chain: its G1 blocks are matched and
referenced on the loop, gathered in one gather on the dispatch stream and
copied into pinned host memory behind a CUDA event, then released; the
offload tiers fill the tail.  The importer stages the blocks in its host
ring, and the admission's tier lookup onboards them as it would its own
evicted blocks.  ``kv_remote`` (or ``DYN_KV_REMOTE``) arms the G4 tier's
spec; ``attach_remote_kv`` attaches the store: host-ring stores mirror
into it, and the tiered reads fall through to it.

The observability plane is the JAX engine's: with the process-wide tick
profiler (``runtime/profiling.py``) enabled, each working iteration of the
tick loop is one tick record whose phases (``onboard``, ``plan``,
``assemble``, ``dispatch``, ``device_wait``, ``commit``, ``fanout``) sum to
its wall, with its dispatches by kind and the host-observed dispatch gaps;
the marks run on the loop and, inside an executor hop the loop awaits, on
the executor thread, never both at once, and add no device
synchronisation (``device_wait`` is the commit's existing wait on a
dispatch's CUDA event).  ``DYN_MULTISTEP`` pins the multistep controller
(0 off, N fixed K = N) and, adaptive, K jumps to its ceiling when the
profiler reads a host-bound loop.  The first token hands the SLO plane its
queue-versus-service split, ``engine.prefill_dispatch`` and ``engine.spec``
spans record with tracing on, and ``status()`` is the flight recorder's
``engine`` provider while the engine runs.

Tensor and expert parallelism (``parallel/``): with ``EngineConfig.tp``
(or ``DYN_TP``) above 1, or a ``mesh`` (a ``parallel.MeshConfig`` of tp
and ep, or a ``ParallelMesh`` whose followers the caller runs), the
engine is the leader of a grid of ranks, one process each.  It starts this
host's followers itself for a ``MeshConfig``: NCCL ranks, one card each,
on a card; gloo ranks on the CPU.  Each holds its shard of the params and
of the KV pool (``[L, 2, pages, page, Hkv/tp, D]``), and every trunk call
of every dispatch reaches them first through the dispatch mirror
(``parallel/sharding.py``).  The scheduler, the decode state, the
sampling, the commits and the front end stay here; the followers keep no
lane state, so no host write needs mirroring.  An export gathers every
rank's head slice into the full-width blob, stamped with its shard
geometry.  Over NCCL the decode graphs are captured and replayed on every
rank (the mirror carries the graph markers); a gloo mesh, whose
collectives cannot be captured, runs every dispatch eagerly.  A
collective that fails (a rank lost) fails the requests in flight and
stops the engine, and a stop tears the ranks down in one order
(``ParallelMesh.close``).

Sequence and pipeline parallelism: a ``MeshConfig(sp=n)`` or
``MeshConfig(pp=n)`` (each alone) routes full prefills through the ring
(``parallel/ring_attention.py``) or the pipeline
(``parallel/pipeline_parallel.py``): the JAX engine's
``_dispatch_parallel_prefill``, sp when the bucket divides by sp, pp when
the batch divides by its microbatches (the layers must divide by pp at
construction); ``sp_prefills`` and ``pp_prefills`` count them.  The
leader keeps the whole model, the pool and the lane state, and runs every
other dispatch (suffix prefills, chunks, decode) alone, with its graphs;
mixed batching is pinned off there, as JAX pins it, so full prefills take
the classic dispatch that routes them.

On any mesh the engine refuses, by name, what the mirror does not carry
yet: the KV offload plane (and swap preemption and prefix onboarding over
it), the G4 remote tier, importing a remote prefill's KV and the model
drafter.

Not served yet (later slices): data parallelism inside one engine, sp or
pp beside tp or ep, and CUDA graphs for dispatches that carry prefill
chunks or verify columns.

The serving-environment overrides the JAX engine reads at construction
are read here too, with its parse, for the features the port has:
``DYN_KV_DTYPE``, ``DYN_MIXED_TOKEN_BUDGET``, ``DYN_PACKED_RAGGED``,
``DYN_PACKED_SHAPE_BUDGET``, ``DYN_ASYNC_DISPATCH``, ``DYN_MULTISTEP``, ``DYN_SPEC_FOLD``,
``DYN_SPEC_AUTO_DISABLE``, ``DYN_DRAFT_MODEL``, ``DYN_KV_OFFLOAD``,
``DYN_KV_REMOTE`` and ``DYN_KV_PREFETCH``.  A set variable wins over
the config; a malformed one logs a warning and keeps the config.

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

from ..block_manager import PagePool
from ..device import DEVICE_TURN, release_blas_workspaces, resolve_device
from .. import offload as kvoffload
from ..ops.build import check_geometry
from ..protocols.common import (
    FinishReason,
    ForwardPassMetrics,
    LLMEngineOutput,
    PreprocessedRequest,
)
from ..runtime import faults, profiling, slo, tracing
from ..runtime.engine import Annotated, Context, ResponseStream
from ..runtime.metrics import EngineMetrics, SpecMetrics
from ..spec.drafter import MAX_DRAFT_TOKENS, SpecState, longest_accepted, make_drafter, spec_live
from .bucketing import (
    PACKED_SHAPE_BUDGET,
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
    blob_index,
    blob_shape,
    blob_to_host,
    coerce_kv_blob,
    dtype_name,
    kv_blob_concat,
    layer_chunk_spans,
    pad_page_axis,
    parse_kv_dtype,
    pool_is_quantized,
    quant_blob_nbytes,
    quantize_kv_rows,
    tensor_view,
    torch_dtype,
    wire_dtype,
)
from .model import Params, init_params
from .quant import quantize_params
from .sampling import PROMPT_FLAG, SamplingParams, unpack_sampled_logprobs
from .scheduler import (
    MixedChunk,
    Scheduler,
    SchedulerConfig,
    SeqState,
    StepEvent,
    parse_kv_admit_spec,
)
from .step import (
    LANE_ROWS,
    StepFn,
    StepRunner,
    bump_counts,
    decode_block,
    embed_step,
    gather_block_pages,
    gather_layer_pages,
    inject_token,
    inject_tokens,
    packed_unified_multistep,
    prefill_mm_and_sample,
    prefill_suffix_and_sample,
    prompt_penalized_logits,
    sample_step_packed,
    scatter_layer_pages,
    score_prompt_step,
    seed_count_rows,
    unified_step,
    update_lanes,
    verify_and_sample,
    zero_count_rows,
)

logger = logging.getLogger("dynamo.torch_engine")

# bound of the stream fanout queue (async mode): a slow consumer
# backpressures the tick loop here
FANOUT_DEPTH = 64
# the dispatch kinds a tick record counts: the tick loop's own, as the JAX
# engine notes them (prompt scoring, embeddings and exports are not ticks')
TICK_KINDS = frozenset({"prefill", "chunk", "decode_block", "unified", "verify"})
# layer groups of an onboard, swap-in or delivery scatter, and of a chunked
# KV export whose caller pins none (the JAX engine's DEFAULT_EXPORT_CHUNKS)
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


def _refuse_unserved(cfg: EngineConfig, model_dtype: str) -> None:
    """Refuse, by field name, the JAX config values the port does not
    serve: data parallelism inside one engine, and a dense pool dtype
    other than the model's (the kernels read one dtype)."""
    if cfg.dp != 1:
        raise ValueError(
            f"EngineConfig.dp={cfg.dp!r}: data parallelism inside one engine is not "
            "served by the port yet (1 only)"
        )
    if cfg.dtype is not None and cfg.dtype != model_dtype:
        raise ValueError(
            f"EngineConfig.dtype={cfg.dtype!r}: a KV pool of another dtype than "
            f"the model's ({model_dtype}) is not served"
        )


def _refuse_under_mesh(cfg: EngineConfig, grid: Any) -> None:
    """What an engine on a mesh (``grid``: its ``MeshConfig`` or
    ``ParallelMesh``) does not carry yet, refused by field name before any
    rank starts: the KV offload plane (swap preemption and prefix
    onboarding ride on it), the G4 remote tier and the model drafter."""
    axis = next(a for a in ("tp", "ep", "sp", "pp") if getattr(grid, a) > 1)
    where = (f"EngineConfig.tp={grid.tp}" if axis == "tp"
             else f"{axis}={getattr(grid, axis)}")
    offload = _env_override("DYN_KV_OFFLOAD", None, _parse_offload_spec)
    host, disk = (offload["host"], offload["disk"]) if offload else (
        cfg.host_offload_blocks, cfg.disk_offload_blocks
    )
    checks = [
        ("host_offload_blocks", host, "the KV offload plane (and swap preemption over it)"),
        ("disk_offload_blocks", disk, "the KV offload plane (and swap preemption over it)"),
        ("kv_remote", cfg.kv_remote or os.environ.get("DYN_KV_REMOTE"),
         "prefix onboarding's G4 remote tier"),
        ("draft_model", _env_override("DYN_DRAFT_MODEL", cfg.draft_model, _parse_draft_model),
         "the model drafter"),
    ]
    for name, value, what in checks:
        if value and str(value).strip().lower() not in ("0", "off", "none"):
            raise ValueError(
                f"{where} with {name}={value!r}: {what} is not served under tensor, "
                "expert, sequence or pipeline parallelism yet"
            )


def resolve_mesh(cfg: Optional[EngineConfig], model_cfg: ModelConfig):
    """The engine-startup grid (a ``parallel.MeshConfig``) from
    ``EngineConfig.tp`` and ``DYN_TP``/``DYN_DP`` (a set variable wins, a
    malformed one raises), or None at tp = 1: the JAX engine's
    ``resolve_mesh``, its tp validated against the model's heads before
    any rank starts.  Data parallelism inside one engine is refused."""
    from ..parallel.mesh import env_parallel_spec, serving_mesh

    cfg = cfg or EngineConfig()
    env = env_parallel_spec()
    tp = env["tp"] if env["tp"] is not None else cfg.tp
    dp = env["dp"] if env["dp"] is not None else cfg.dp
    if dp > 1:
        raise ValueError(
            f"EngineConfig.dp={dp}: data parallelism inside one engine is not served "
            "by the port yet (1 only)"
        )
    model_cfg.validate_tp(tp)
    return serving_mesh(tp=tp)


def _kv_admit(cfg: EngineConfig):
    """The scheduler's ``KVAdmitConfig``: config arms it (a malformed value
    fails construction), a non-empty ``DYN_KV_ADMIT_BUDGET`` wins outright
    (an explicit "off" disarms a config-armed budget; a malformed value
    warns and keeps the config)."""
    try:
        spec = parse_kv_admit_spec(cfg.kv_admit_budget)
    except ValueError as e:
        raise ValueError(f"EngineConfig.kv_admit_budget: {e}") from None
    return _env_override("DYN_KV_ADMIT_BUDGET", spec, parse_kv_admit_spec)


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


def check_model_geometry(model_cfg: ModelConfig, device: torch.device, tp: int = 1) -> None:
    """Refuse a model whose head geometry -- a rank's, ``Hq/tp`` and
    ``Hkv/tp``, under tensor parallelism -- the device's kernels do not
    take (``check_geometry``, the wrappers' own rule): at construction,
    not at the first dispatch.  The CPU serves any geometry."""
    check_geometry(
        device, torch_dtype(model_cfg.dtype), model_cfg.num_heads // tp,
        model_cfg.num_kv_heads // tp, model_cfg.head_dim,
    )


def _mesh_config_of(mesh: Any, cfg: Optional[EngineConfig], model_cfg: ModelConfig):
    """(grid to start, built mesh): a ``MeshConfig`` the engine starts
    ranks for (given, or from ``resolve_mesh``), or a ``ParallelMesh``
    whose followers the caller runs."""
    from ..parallel.mesh import MeshConfig, refuse_unserved_axes

    if mesh is None:
        return resolve_mesh(cfg, model_cfg), None
    grid = mesh if isinstance(mesh, MeshConfig) else mesh.config
    refuse_unserved_axes(grid)
    model_cfg.validate_tp(grid.tp)
    model_cfg.validate_ep(grid.ep)
    if model_cfg.num_layers % grid.pp:
        raise ValueError(
            f"pp={grid.pp}: the model's {model_cfg.num_layers} layers do not split over "
            f"{grid.pp} pipeline stages"
        )
    if isinstance(mesh, MeshConfig):
        return (mesh if mesh.num_devices > 1 else None), None
    return None, mesh


def start_ranks(
    mesh_cfg: Any,
    model_cfg: ModelConfig,
    cfg: EngineConfig,
    device: torch.device,
    source: Dict[str, Any],
):
    """Start this host's follower ranks of ``mesh_cfg`` and build the
    leader's mesh: NCCL ranks on cards, one each (JAX's "mesh needs N
    devices, have M" with fewer), gloo ranks on the CPU.  Returns ``(mesh,
    ranks)``; the engine announces itself to them after."""
    from ..parallel.launch import grid_spec, leader_mesh, start_local_ranks
    from ..parallel.mesh import check_devices, default_backend, rank_devices

    _refuse_under_mesh(cfg, mesh_cfg)
    check_model_geometry(model_cfg, device, mesh_cfg.tp)
    world = mesh_cfg.num_devices
    backend = default_backend(device)
    check_devices(world, backend)
    spec = grid_spec(mesh_cfg, rank_devices(device, world), backend)
    ranks = start_local_ranks(mesh_cfg, spec)
    return leader_mesh(mesh_cfg, spec, ranks), ranks


def announce_engine(mesh, model_cfg: ModelConfig, cfg: EngineConfig, source: Dict[str, Any]) -> None:
    """The next engine's spec to the mesh's followers (they build their
    params from ``source`` and their pool, then serve it)."""
    from ..parallel.launch import announce, engine_spec

    kv_dtype = _env_override("DYN_KV_DTYPE", parse_kv_dtype(cfg.kv_dtype), parse_kv_dtype)
    announce(mesh, engine_spec(
        model_cfg, num_pages=cfg.num_pages, page_size=cfg.page_size,
        quantized_pool=pool_is_quantized(kv_dtype, model_cfg.dtype), source=source,
    ))


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
    # the lanes' device limits and row-push counts the block ran under
    limits: Optional[np.ndarray] = None
    pushes: Optional[np.ndarray] = None


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
    # the lanes' device limits and row-push counts the step ran under
    limits: Optional[np.ndarray] = None
    pushes: Optional[np.ndarray] = None


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


# -- disaggregation: KV export and import -----------------------------------


class _GroupSpanExport:
    """Shared device->host materializer for one export group's layer-group
    slices: every request of the group views the same span copies, so each
    span pays ONE transfer however many uploads read it.  Each span was
    gathered on the dispatch stream -- before any later dispatch can reuse
    the scratch pages -- and its non-blocking copy into pinned host memory
    enqueued behind a CUDA event (``kv_cache.PageSnapshot``, which keeps
    the gathered copy alive until then); ``host_span`` waits for that event
    off the event loop, so span i+1 copies while span i is on the wire."""

    def __init__(self, snaps: List[PageSnapshot]) -> None:
        self._snaps: List[Optional[PageSnapshot]] = list(snaps)
        self._host: List[Any] = [None] * len(snaps)
        self._tasks: List[Optional[asyncio.Future]] = [None] * len(snaps)

    def _materialize(self, idx: int) -> Any:
        arr = self._snaps[idx].materialize()
        # per-span slots are disjoint: host_span starts ONE task per index
        self._host[idx] = arr
        self._snaps[idx] = None  # the copy landed: release the device copy
        return arr

    async def host_span(self, idx: int) -> Any:
        got = self._host[idx]
        if got is not None:
            return got
        task = self._tasks[idx]
        if task is None:
            task = self._tasks[idx] = asyncio.ensure_future(
                asyncio.to_thread(self._materialize, idx)
            )
        return await task


@dataclass
class KVExportStream:
    """One remote prefill's KV export as a stream of layer-group chunks.

    The prefill dispatch, the per-span gathers and their host copies are
    already enqueued when this is handed out; :meth:`chunks` yields each
    group as it lands on the host, so the consumer (``PrefillWorker``) puts
    the first bytes on the wire after one span's copy instead of the whole
    blob's.  ``first_ready_at``/``last_ready_at`` record the pipeline's
    export-before-first-byte and total-materialize times.  ``dtype`` is the
    wire name (``bfloat16`` chunks are ``uint16`` bits on the host)."""

    shape: Tuple[int, ...]  # [L, 2, n_pages, page, Hkv, D]
    dtype: str
    row: np.ndarray  # packed [2 + 2N] (token | logprob | tops)
    spans: List[Tuple[int, int]]  # per-chunk [layer_lo, layer_hi)
    # the source pool's shard geometry ({"axis": 4, "parts": tp}) or None:
    # the blob itself is full width either way
    shards: Optional[Dict[str, int]] = None
    started_at: float = 0.0
    first_ready_at: Optional[float] = None
    last_ready_at: Optional[float] = None
    _group: Optional[_GroupSpanExport] = None
    _page_off: int = 0

    @property
    def quantized(self) -> bool:
        return self.dtype == "int8"

    @property
    def nbytes(self) -> int:
        """Wire bytes of the full blob.  Quantized exports count the f32
        row scales packed after each layer's int8 data (the
        kv_cache.pack_quant_blob_bytes layout), so byte framing on both
        ends derives identical extents from (shape, dtype)."""
        if self.quantized:
            return quant_blob_nbytes(self.shape)
        return int(np.prod(self.shape)) * wire_dtype(self.dtype).itemsize

    @property
    def chunk_bounds(self) -> List[Tuple[int, int]]:
        """Byte range of each chunk in the C-order blob (layer slabs are
        contiguous, so chunk i covers its layers' bytes exactly)."""
        bpl = self.nbytes // self.shape[0]
        return [(lo * bpl, hi * bpl) for lo, hi in self.spans]

    async def chunks(self):
        """Yield ``(idx, layer_lo, layer_hi, array)`` in span order as each
        group materializes; the array is a view, C-contiguity not
        guaranteed."""
        k = self.shape[2]
        for idx, (lo, hi) in enumerate(self.spans):
            span = await self._group.host_span(idx)
            part = blob_index(
                span, (slice(None), slice(None), slice(self._page_off, self._page_off + k))
            )
            now = time.perf_counter()
            if self.first_ready_at is None:
                self.first_ready_at = now
            self.last_ready_at = now
            yield idx, lo, hi, part

    async def assemble(self) -> Any:
        """Materialize the full blob (tests, the same-process handoff)."""
        parts = [part async for _, _, _, part in self.chunks()]
        if len(parts) == 1:
            p = blob_to_host(parts[0])
            if isinstance(p, QuantKV):
                return QuantKV(q=np.ascontiguousarray(p.q), s=np.ascontiguousarray(p.s))
            return np.ascontiguousarray(p)
        return kv_blob_concat(parts, axis=0)


@dataclass
class _PendingExport:
    """A request's export on its way to the host: its group's packed rows
    ``[Bp, 2 + 2N]`` and gathered pages (the device copy, its
    ``PageSnapshot`` bound for pinned host memory, or a chunked export's
    ``_GroupSpanExport``), and its row and page range in them."""

    rows: Result
    pages: Any
    row: int
    off: int
    n: int


@dataclass
class _ChunkedDelivery:
    """Decode-side staging record for an in-flight chunked KV delivery:
    layer-group parts queue here until the tick loop scatters them (the
    lane may not even hold a slot yet); ``done`` + all layers applied is
    the completion barrier before the first decode step.  ``applied``
    keeps the scattered parts (views of the landing buffer) and ``life``
    the lane's life they went into: a lane preempted and re-admitted into
    fresh pages before its barrier cleared takes them again."""

    shape: Tuple[int, ...]
    dtype: str
    parts: List[Tuple[int, int, Any]] = field(default_factory=list)
    applied: List[Tuple[int, int, Any]] = field(default_factory=list)
    life: int = -1
    applied_layers: int = 0
    validated: bool = False
    done: bool = False
    first: int = 0
    lp_row: Optional[np.ndarray] = None


class TorchEngine:
    """Continuous-batching PyTorch engine over a paged KV cache."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        params: Params,
        cfg: Optional[EngineConfig] = None,
        device: Optional[Union[str, torch.device]] = None,
        metrics_registry=None,  # runtime.metrics.MetricsRegistry | None
        mesh: Any = None,  # parallel.MeshConfig | parallel.ParallelMesh | None
        _ranks: Any = None,  # parallel.launch.LocalRanks this engine started
    ) -> None:
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.cfg = cfg or EngineConfig()
        self.params = params
        self.dtype = torch_dtype(model_cfg.dtype)
        c = self.cfg
        _refuse_unserved(c, model_cfg.dtype)
        mesh_cfg, mesh = _mesh_config_of(mesh, c, model_cfg)
        self._ranks = _ranks
        self.mesh = mesh
        self.mesh_error: Optional[str] = None
        tp = (mesh or mesh_cfg).tp if (mesh or mesh_cfg) is not None else 1
        check_model_geometry(model_cfg, self.device, tp)
        if c.quantize is not None and c.quantize != "int8":
            raise ValueError(f"unsupported quantize={c.quantize!r} (int8 only)")
        if c.quantize is not None and not hasattr(params, "mesh"):
            # before any pool is allocated: the int8 weights and the
            # one-slice f32 transient of the rounding come first (whole,
            # before sharding: a row-parallel weight's scales are its
            # whole rows')
            self.params = quantize_params(params, self.dtype)
        if mesh_cfg is not None:
            # the engine's own ranks; the whole params go out leaf by leaf
            self.mesh, self._ranks = start_ranks(
                mesh_cfg, model_cfg, c, self.device, {"kind": "scatter"}
            )
        if self.mesh is not None:
            try:
                self._init_mesh()
            except BaseException:
                self._close_mesh()
                raise
        self.kv_dtype = _env_override(
            "DYN_KV_DTYPE", parse_kv_dtype(c.kv_dtype), parse_kv_dtype
        )
        # the page allocator, as the JAX engine builds it: a block pool of
        # ``block_size // page_size`` pages a router block with prefix
        # caching on, else the plain free list.  A block that is not whole
        # pages turns prefix caching off
        block_size = c.block_size or c.page_size
        pool: Optional[PagePool] = None
        if c.enable_prefix_caching:
            if block_size % c.page_size == 0:
                pool = PagePool(c.num_pages, pages_per_block=block_size // c.page_size)
            else:
                logger.warning(
                    "prefix caching disabled: block_size %d is not a multiple of "
                    "page_size %d", block_size, c.page_size,
                )
        self.kv = PagedKVCache(
            model_cfg, c.num_pages, c.page_size, self.dtype, self.device,
            quantized=pool_is_quantized(self.kv_dtype, model_cfg.dtype),
            allocator=pool, kv_heads=model_cfg.num_kv_heads // tp,
            shard_geometry=self._shard_geometry(),
        )
        self.sched = Scheduler(
            SchedulerConfig(
                max_batch_size=c.max_batch_size,
                max_seq_len=c.max_seq_len,
                page_size=c.page_size,
                block_size=c.block_size,
                kv_admit=_kv_admit(c),
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
        if pool is not None:
            pool.event_sink = self._emit_kv_event
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
        # sp and pp meshes pin mixed batching off (the JAX engine's rule):
        # they exist to speed up full prefills, which only the classic
        # dispatch routes through the ring or the pipeline
        self._mixed = bool(c.mixed_batching) and (
            self.mesh is None or self.mesh.prefill_axis is None
        )
        self._packed = _env_override("DYN_PACKED_RAGGED", bool(c.packed_ragged), _env_flag)
        # multistep decode rides the packed mixed plane only
        self._multistep = bool(c.multistep_decode) and self._mixed and self._packed
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
        # DYN_MULTISTEP, the JAX engine's grammar: 0/off disables (single-
        # step dispatches), 1/on/adaptive is the controller, an integer
        # N > 1 fixes K = N (the ablation pin) and raises the ceiling to N.
        # A malformed value warns and keeps the config
        self._ms_fixed: Optional[int] = None
        env_ms = os.environ.get("DYN_MULTISTEP")
        if env_ms is not None and env_ms.strip():
            v = env_ms.strip().lower()
            if v in ("0", "off", "false", "no"):
                self._multistep = False
            elif v in ("1", "on", "true", "adaptive"):
                self._multistep = self._mixed and self._packed
            else:
                try:
                    k = int(v)
                    self._multistep = k > 1 and self._mixed and self._packed
                    self._ms_fixed = max(k, 1)
                    self._ms_max = max(self._ms_max, k)
                except ValueError:
                    logger.warning("ignoring malformed DYN_MULTISTEP=%r", v)
        # whether the previous tick's dispatches sampled a first token
        self._firsts_last_tick = False
        # dispatch generations the loop may carry uncommitted
        async_dispatch = _env_override("DYN_ASYNC_DISPATCH", bool(c.async_dispatch), _env_flag)
        self._pipe_depth = 2 if async_dispatch else 1
        self._packed_shapes = PackedShapeBudget(
            _env_override("DYN_PACKED_SHAPE_BUDGET", PACKED_SHAPE_BUDGET, int)
        )
        # an NCCL mesh that shards the trunk captures its decode graphs on
        # every rank (the mirror carries the markers); a gloo one runs every
        # dispatch eagerly; a ring or pipeline mesh decodes on the leader
        # alone, with its own graphs
        mirror = getattr(self.params, "mirror", None)
        self.graphs = StepGraphs(
            self.device,
            enabled=self.mesh is None or not self.mesh.shards_trunk or self.mesh.capturable,
            mirror=mirror if mirror is not None and mirror.mirrors_graphs else None,
        )
        # lanes whose classic chunked prefill is under way (one chunk per tick)
        self._chunking: List[SeqState] = []
        # unseeded lanes key their noise on a per-request nonce, counted
        # from the config's seed (EngineConfig's docstring)
        self._nonces = itertools.count(int(c.seed) + 1)
        self._nonce_of: Dict[str, int] = {}
        self._queues: Dict[str, asyncio.Queue] = {}
        # live requests' contexts: a request killed before anything read its
        # stream (a consumer that gave up first) is still cancelled
        self._ctxs: Dict[str, Any] = {}
        self._cancelled: set = set()
        # disaggregation: request_id -> seq parked for a remote prefill's
        # KV; deliveries (monolithic blobs, staged chunked parts, errors)
        # are applied by the tick loop at a controlled point
        self._external: Dict[str, SeqState] = {}
        self._deliveries: Dict[str, Tuple[Any, int, Optional[np.ndarray]]] = {}
        self._chunked: Dict[str, _ChunkedDelivery] = {}
        self._external_deadline: Dict[str, float] = {}
        self._external_errors: Dict[str, str] = {}
        # parked sequences whose request id was served again: released by
        # the tick loop without a word to the id's (new) stream
        self._abandoned: List[SeqState] = []
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
        # full prefills routed through the ring (sp) or the pipeline (pp),
        # and the pipeline's microbatches over them (each stage runs each
        # of its layers once a microbatch)
        self.sp_prefills = 0
        self.pp_prefills = 0
        self.pp_microbatches = 0
        self._init_device_state()
        # dispatch spans on CUDA events (card only): (kind, start, end)
        # awaiting their end event, None marking an idle loop (no gap is
        # counted across it); per kind: spans, device ms, gap ms before them
        self._spans: Deque[Optional[Tuple[str, Any, Any]]] = collections.deque()
        self._last_end: Optional[Any] = None
        self.span_stats: Dict[str, Dict[str, float]] = {}
        # the tick profiler: the process-wide instance, armed by
        # DYN_TICK_PROFILE or profiler.enable(); ``_tick`` is the record
        # of the iteration under way, None (one attribute check per
        # site) when disabled
        self.profiler = profiling.profiler
        self._tick: Optional[Any] = None
        self._hop_tick: Optional[Any] = None
        if self.mesh is not None:
            try:
                # every rank built its shard and pool: the followers serve
                self.mesh.gather_objects({"rank": 0, "ready": True})
            except BaseException:
                self._close_mesh()
                raise

    # -- tensor and expert parallelism ----------------------------------------

    def _init_mesh(self) -> None:
        """The leader's shard (the whole params scattered, unless a rank
        recipe built it already) and its dispatch mirror."""
        from ..parallel.sharding import DispatchMirror, build_rank_params

        mesh = self.mesh
        _refuse_under_mesh(self.cfg, mesh)
        if not hasattr(self.params, "mesh"):
            announce_engine(mesh, self.model_cfg, self.cfg, {"kind": "scatter"})
            self.params = build_rank_params(
                {"kind": "scatter"}, self.model_cfg, mesh, self.dtype, whole=self.params
            )
        self.params.mirror = DispatchMirror(mesh)
        # the ring's or the pipeline's sends and receives
        self._exchange = (mesh.exchange(mesh.prefill_axis)
                          if mesh.prefill_axis is not None else None)
        logger.info(
            "leader of a tp=%d ep=%d sp=%d pp=%d grid over %s (%s)",
            mesh.tp, mesh.ep, mesh.sp, mesh.pp, mesh.backend, mesh.device,
        )

    def _shard_geometry(self) -> Optional[Dict[str, int]]:
        from ..parallel.sharding import kv_shard_geometry

        return kv_shard_geometry(self.mesh, self.model_cfg) if self.mesh is not None else None

    def _close_mesh(self) -> None:
        """End this engine on the followers.  Ranks this engine started
        are dismissed, joined (then killed if still alive) and the mesh
        closed; a caller's mesh stays open, its followers waiting for the
        next engine."""
        from ..parallel.launch import dismiss, stop_watch

        mirror = getattr(self.params, "mirror", None)
        graphs = getattr(self, "graphs", None)
        if graphs is not None:
            # the followers drop theirs at the stop
            graphs.mirror = None
            graphs.release(lambda key: False)
        with stop_watch():
            try:
                if mirror is not None:
                    mirror.stop()
                if self._ranks is not None:
                    dismiss(self.mesh)
            except Exception:  # a follower already gone
                self.mesh_error = self.mesh_error or "a follower rank is gone"
            if self._ranks is not None:
                # every rank tears its groups down in one order, then the
                # followers exit
                self.mesh.close(lost=self.mesh_error is not None)
                self._ranks.join()
                self._ranks = None

    def _mesh_lost(self, message: str) -> None:
        """A collective failed: a rank is gone or its group broke.  The
        engine stops; later requests fail at once with the cause."""
        self.mesh_error = message
        self._running = False
        mirror = getattr(self.params, "mirror", None)
        if mirror is not None:
            mirror.closed = True
        if self._ranks is not None:
            self._ranks.kill()

    def _refuse_on_mesh(self, what: str) -> None:
        if self.mesh is not None:
            raise ValueError(
                f"{what} is not served under tensor, expert, sequence or pipeline "
                f"parallelism yet (tp={self.mesh.tp}, ep={self.mesh.ep}, "
                f"sp={self.mesh.sp}, pp={self.mesh.pp})"
            )

    def _on_ranks(self, fn, *args):
        """``fn`` on the executor thread, in order with the dispatches."""
        return self._ex.submit(fn, *args).result()

    def rank_stats(self) -> List[Dict[str, Any]]:
        """Every rank's kernel launches, collectives, graphs and peak device
        memory (``parallel.sharding.rank_stats``), in rank order; one card:
        a list of none."""
        if self.mesh is None:
            return []
        from ..parallel.sharding import rank_stats

        def read():
            own = rank_stats(self.mesh, {
                "captures": self.graphs.captures,
                "replays": sum(self.graphs.replays.values()),
            }, self.params)
            return self.params.mirror.rank_stats(own)

        return self._on_ranks(read)

    def reset_rank_stats(self) -> None:
        """Zero every rank's launch, collective and peak-memory counters."""
        if self.mesh is None:
            return
        from ..parallel.sharding import reset_rank_stats

        def reset():
            self.params.mirror.reset_stats()
            reset_rank_stats(self.mesh)

        self._on_ranks(reset)

    def rank_pools(self) -> List[Any]:
        """Every rank's whole KV pool on the host (a tensor, or the int8
        pool's ``(data, scales)``), in rank order."""
        if self.mesh is None:
            from ..parallel.sharding import _host_pool

            return [self._on_ranks(_host_pool, self.kv.pages)]
        return self._on_ranks(self.params.mirror.rank_pools, self.kv.pages)

    def _gather_pages(self, ids: torch.Tensor, layer_ids: Optional[torch.Tensor] = None):
        """Pages ``ids`` (of layers ``layer_ids``, else all) of the pool,
        full width: every tp rank's head slice under tensor parallelism."""
        mirror = getattr(self.params, "mirror", None)
        if mirror is not None:
            return mirror.gather_pages(self.kv.pages, ids, layer_ids)
        if layer_ids is None:
            return gather_block_pages(self.kv.pages, ids)
        return gather_layer_pages(self.kv.pages, layer_ids, ids)

    def _export_shape(self) -> Tuple[int, ...]:
        """``[L, 2, pages, page, Hkv, D]`` of the pool at full width."""
        shape = blob_shape(self.kv.pages)
        return shape[:4] + (self.model_cfg.num_kv_heads,) + shape[5:]

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
        # the plane hangs off the block pool's evictions and prefix matches
        if self.sched.pool is not None and (host_blocks > 0 or disk_blocks > 0):
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
        # the G4 remote tier's spec: parsed now, attached at serve wiring
        # (attach_remote_kv) once a hub blob client exists.  DYN_KV_REMOTE
        # wins over config, an explicit "off" included; a malformed value
        # (config or env) warns and is not used
        self.kv_remote_spec: Optional[Dict[str, Any]] = None
        try:
            self.kv_remote_spec = kvoffload.parse_kv_remote_spec(c.kv_remote or "")
        except ValueError:
            logger.warning("ignoring malformed kv_remote config %r", c.kv_remote)
        if "DYN_KV_REMOTE" in os.environ:
            try:
                self.kv_remote_spec = kvoffload.env_remote_spec()
            except ValueError:
                logger.warning("ignoring malformed DYN_KV_REMOTE=%r", os.environ["DYN_KV_REMOTE"])
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
        mesh: Any = None,
    ) -> "TorchEngine":
        """An engine over random weights made on ``device`` from ``seed``;
        under ``cfg.quantize="int8"`` each layer is quantized as it is
        made, so only the int8 model ever stands on the card.  Under tensor
        or expert parallelism every rank draws the same stream and keeps
        its slice (``mesh`` as the constructor takes it)."""
        device = resolve_device(device)
        quantize = cfg.quantize if cfg is not None else None
        source = {"kind": "random", "seed": seed, "quantize": quantize}
        sharded = cls._rank_start(model_cfg, cfg, device, mesh, source)
        if sharded is not None:
            return cls(model_cfg, sharded[0], cfg, device=device, mesh=sharded[1],
                       _ranks=sharded[2])
        check_model_geometry(model_cfg, device)
        params = init_params(model_cfg, seed, device, torch_dtype(model_cfg.dtype),
                             quantize=quantize)
        return cls(model_cfg, params, cfg, device=device)

    @classmethod
    def _rank_start(cls, model_cfg, cfg, device, mesh, source):
        """Under tensor or expert parallelism: ``(leader params, mesh,
        ranks)`` with every rank's params built from ``source`` (the
        engine's own ranks started first for a grid it owns); None on one
        card."""
        from ..parallel.sharding import build_rank_params

        cfg = cfg or EngineConfig()
        mesh_cfg, built = _mesh_config_of(mesh, cfg, model_cfg)
        ranks = None
        if mesh_cfg is not None:
            built, ranks = start_ranks(mesh_cfg, model_cfg, cfg, device, source)
        if built is None:
            return None
        try:
            announce_engine(built, model_cfg, cfg, source)
            params = build_rank_params(source, model_cfg, built, torch_dtype(model_cfg.dtype))
        except BaseException:
            if ranks is not None:
                ranks.kill()
            raise
        return params, built, ranks

    @classmethod
    def from_pretrained(
        cls,
        model_path: str,
        cfg: Optional[EngineConfig] = None,
        device: Optional[Union[str, torch.device]] = None,
        model_cfg: Optional[ModelConfig] = None,
        mesh: Any = None,
    ) -> "TorchEngine":
        """An engine over a checkpoint: a HuggingFace directory
        (``config.json`` and ``*.safetensors``) or a GGUF checkpoint (a
        ``.gguf`` file, or a directory holding one and no safetensors),
        loaded leaf by leaf onto ``device``; the geometry is checked before
        any weight is read.  ``model_cfg``, as the JAX engine's, stands in
        for the checkpoint's own config (a caller that parsed it already,
        or one that loads in another dtype).  Under tensor or expert
        parallelism every rank reads its own slices (``mesh`` as the
        constructor takes it)."""
        from .weights import load_checkpoint_params

        device = resolve_device(device)
        if model_cfg is None:
            model_cfg = ModelConfig.from_pretrained(model_path)
        quantize = cfg.quantize if cfg is not None else None
        source = {"kind": "pretrained", "path": model_path, "quantize": quantize}
        sharded = cls._rank_start(model_cfg, cfg, device, mesh, source)
        if sharded is not None:
            return cls(model_cfg, sharded[0], cfg, device=device, mesh=sharded[1],
                       _ranks=sharded[2])
        check_model_geometry(model_cfg, device)
        params = load_checkpoint_params(model_path, model_cfg, device, quantize=quantize)
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
        self._flightrec_key = profiling.flight_recorder.add_provider(
            "engine", self.status
        )
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
        profiling.flight_recorder.remove_provider(
            getattr(self, "_flightrec_key", "engine"), self.status
        )
        if not self._stopped:
            self._stopped = True
            # on a mesh the device's queue holds collectives its peers must
            # meet: the drain is bounded by the groups' timeout, and a
            # drain that does not end is reported, not waited for
            bound = self.mesh.timeout.total_seconds() if self.mesh is not None else None
            try:
                self._ex.submit(self._drain_spans, True).result(timeout=bound)
                self._ex.submit(self._settle_onboards, True).result(timeout=bound)
                drained = True
            except concurrent.futures.TimeoutError:
                drained = False
                self.mesh_error = self.mesh_error or (
                    f"stop: the device did not drain within {bound:.0f} s"
                )
                logger.error("engine %s", self.mesh_error)
            self._ex.shutdown(wait=drained)
            if self.mesh is not None:
                self._close_mesh()
            if self.offload_engine is not None:
                self.offload_engine.close()
            if drained:
                # the matmul workspaces this engine's thread and streams made
                release_blas_workspaces(self.device)

    # -- AsyncEngine --------------------------------------------------------

    async def generate(
        self, request: Context[Any], _external: bool = False
    ) -> AsyncIterator[Annotated]:
        """Token-level generate; yields Annotated[LLMEngineOutput-dict]."""
        data = request.data
        req = PreprocessedRequest.from_dict(data) if isinstance(data, dict) else data
        ctx = request.ctx
        message = None
        if self.mesh_error is not None:
            message = f"engine stopped: {self.mesh_error}"
        elif not self._running:
            await self.start()
        try:
            if message is not None:
                raise ValueError(message)
            seq = SeqState.from_request(request.id, req, self.sched.block_size)
            mm = seq.mm_embeds
            if mm is not None and (mm.ndim != 2 or mm.shape[1] != self.model_cfg.hidden_size):
                raise ValueError(
                    f"mm_embeds must be rows of the model's hidden size "
                    f"{self.model_cfg.hidden_size}, got shape {list(mm.shape)}"
                )
            self._arm_speculation(seq)  # an unknown drafter: an error stream
            # disaggregated: the prompt KV arrives via deliver_external
            seq.awaiting_kv = _external
            self.sched.enqueue(seq)
        except ValueError as e:
            message = str(e)
        if message is not None:

            async def err_stream() -> AsyncIterator[Annotated]:
                yield Annotated.from_error(message)

            return ResponseStream(ctx, err_stream())
        stale = self._forget_external(request.id)
        if stale is not None:
            # a parked request served again under its id (the disagg
            # fallback to a local prefill after a failed enqueue): its lane
            # is released silently at the next tick, and its pending
            # failure must not reach the new stream
            self._external_errors.pop(request.id, None)
            self._abandoned.append(stale)
        if _external:
            self._external[request.id] = seq
            self._external_deadline[request.id] = (
                time.monotonic() + self.cfg.external_kv_timeout_s
            )
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
        """CUDA graphs captured: each is one ``runtime/compile_sentry``
        event of its kind, so for one engine this is the sentry's total."""
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
        with DEVICE_TURN, torch.inference_mode():
            return fn(*args)

    async def _tick_hop(self, fn, *args):
        """An executor hop of the tick loop: its executor-side marks and
        dispatch notes go to the tick under way (``_hop_tick``, set and read
        on the executor thread only, so a hop of another coroutine -- an
        export, an embedding -- never touches the tick)."""
        return await asyncio.get_running_loop().run_in_executor(
            self._ex, self._ticked, self._tick, fn, *args
        )

    def _ticked(self, tick, fn, *args):
        self._hop_tick = tick
        try:
            return self._inference(fn, *args)
        finally:
            self._hop_tick = None

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
            t0 = time.perf_counter()
            try:
                self._deliver(item)
            except Exception:  # fanout must never kill the worker
                logger.exception("stream fanout failed")
            if self.profiler.enabled:
                # off-tick: the phase histogram only, as detok
                self.profiler.observe_phase("fanout", time.perf_counter() - t0)

    async def _commit_ready(self, inflight: Deque[List[Inflight]], allowed: int) -> None:
        """Commit the oldest generations while the pipeline holds more than
        ``allowed`` or (async mode) the oldest has landed."""
        while inflight and (
            len(inflight) > allowed
            or (self._pipe_depth > 1 and self._entries_ready(inflight[0]))
        ):
            entries = inflight.popleft()
            # pipeline_busy (async mode): another generation is still
            # queued on the device behind this one
            events = await self._tick_hop(
                self._commit_all, entries, self._pipe_depth > 1 and bool(inflight)
            )
            await self._emit_events(events)
            if self._tick is not None:
                self._tick.mark("fanout")

    async def _commit_prefill(self, entries: List[Inflight]) -> None:
        """Commit a classic prefill dispatch as soon as it has landed, so
        its first tokens stream then and not with the tick's decode
        dispatch.  The tick waits for it here, in both loops at the same
        point, so both plan on the same commits; the device meanwhile runs
        whatever was queued before it."""
        events = await self._tick_hop(self._commit_all, entries)
        await self._emit_events(events)
        if self._tick is not None:
            self._tick.mark("fanout")

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
        prof = self.profiler
        while self._running:
            try:
                # one tick record per working iteration while the profiler
                # is enabled
                self._tick = prof.begin_tick() if prof.enabled else None
                self._process_cancellations()
                self._fail_drafter_lanes()
                for work in self._process_deliveries():
                    # remote prefill KV: scatter it into the parked lane's
                    # pages (a chunked delivery part by part), then commit
                    # the remotely sampled first token and wake the lane
                    if work[0] == "blob":
                        ev = await self._tick_hop(self._apply_external_kv, *work[1:])
                        await self._emit_events([ev])
                    elif work[0] == "chunks":
                        await self._tick_hop(self._apply_external_chunks, *work[1:])
                    else:  # "commit": the chunked barrier cleared
                        ev = await self._tick_hop(self._apply_external_commit, *work[1:])
                        await self._emit_events([ev])
                for seq, rec in self._process_swaps():
                    # swap-in: scatter the parked KV back into the lane's
                    # pages and clear the barrier; no token is emitted
                    await self._tick_hop(self._apply_swap_in, seq, rec)
                if self._tick is not None:
                    self._tick.mark("onboard")
                if (
                    not sched.has_runnable_work
                    and not inflight
                    and not self._chunking
                    and not sched.mix_pending
                ):
                    if self._tick is not None:
                        self._tick.discard()
                        self._tick = None
                    if self.device.type == "cuda":
                        self._spans.append(None)  # idle: no gap across the wait
                    self._wake.clear()
                    if self._swapped or self._external:
                        # parked lanes only: a ready swap blob or a delivery
                        # wakes the loop, the bound re-checks regardless (a
                        # remote prefill's deadline fires)
                        try:
                            await asyncio.wait_for(self._wake.wait(), 1.0)
                        except asyncio.TimeoutError:
                            pass
                    else:
                        await self._wake.wait()
                    continue
                self._drive_prefetch()
                if self._tick is not None:
                    self._tick.mark("onboard")
                # async mode: generations whose results already landed
                # commit before the plan (none is over the depth here), so
                # freed slots and pages and committed stops reach this
                # tick's plan
                await self._commit_ready(inflight, self._pipe_depth)
                # the budget planner charges each decode lane the
                # uncommitted multistep tokens it may carry across the
                # pipeline before this plan's admissions take effect
                sched.decode_inflight_tokens = (
                    self._pipe_depth * min(self._ms_fixed or self._ms_ramp, self._ms_max)
                    if self._multistep
                    else 0
                )
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
                        lookahead=lookahead, chunk_pages=self.cfg.grow_chunk_pages
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
                if self._tick is not None:
                    self._tick.mark("plan")
                # classic chunked prefills advance one chunk per lane, so
                # decode blocks interleave instead of stalling behind one
                # long prompt
                still: List[SeqState] = []
                for seq in self._chunking:
                    if not self._holds_slot(seq) or not seq.prefilling:
                        continue  # cancelled / preempted mid-prefill
                    pf = await self._tick_hop(self._dispatch_chunk, seq)
                    if pf is not None:  # final chunk sampled
                        minted = True
                        await self._commit_prefill([pf])
                    else:
                        still.append(seq)
                self._chunking = still
                if self._tick is not None:
                    self._tick.mark("dispatch")
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
                        pf = await self._tick_hop(self._do_prefill, seq)
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
                        await self._tick_hop(self._do_prefill_group, items)
                    )
                if self._tick is not None:
                    self._tick.mark("dispatch")
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
                if self._tick is not None:
                    self._tick.mark("assemble")
                k = (
                    self._multistep_plan_k(chunks, minted, spec_reserve)
                    if self._multistep and mixed_ok
                    else 0
                )
                pending = [e for gen in inflight for e in gen]
                ub = None
                if chunks or spec_reserve:
                    ub = await self._tick_hop(
                        self._dispatch_unified, chunks, 1, fold_active
                    )
                elif (
                    k > 0
                    and sched.num_decode_runnable > 0
                    and self._has_steppable_lane(pending)
                ):
                    ub = await self._tick_hop(self._dispatch_unified, [], k)
                if ub is not None:
                    fresh.append(ub)
                elif sched.num_decode_runnable > 0 and self._has_steppable_lane(pending):
                    blk = await self._tick_hop(self._dispatch_block)
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
                    vb = await self._tick_hop(self._dispatch_verify)
                    if vb is not None:
                        if inflight:
                            inflight[-1].append(vb)
                        else:
                            inflight.append([vb])
                    if self._tick is not None:
                        self._tick.mark("dispatch")
                if self._tick is not None:
                    prof.finish_tick(self._tick)
                    self._tick = None
                if not dispatched and not inflight:
                    self._handle_stalled_admission()
                    await asyncio.sleep(0.001)
                await asyncio.sleep(0)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # the engine must never die silently
                logger.exception("engine tick failed")
                self._tick = None
                inflight.clear()
                self._spec_failures.clear()
                self._pending_injects.clear()
                self._chunking = []
                sched.mix_pending = []
                self._fail_all(f"engine error: {e}")
                if self.mesh is not None:
                    # a collective failed: the ranks' pools can no longer
                    # be trusted to match the leader's
                    self._mesh_lost(f"{type(e).__name__}: {e}")
                    return
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
        if self._ms_fixed is not None:
            return self._ms_fixed
        # a host-bound loop is the regime K amortizes: jump to the ceiling
        occ = self.profiler.recent_host_occupancy()
        if occ is not None and occ >= 0.5:
            self._ms_ramp = self._ms_max
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
        in (growth-only refreshes never touch ``active``).  A growth-only
        refresh may already have raised ``_limit_host`` past where the
        lane stopped (the commits lag the device), so a lane that a commit
        found at its limit (``_at_limit``) revives too."""
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
            ) or (self._at_limit[b] and limits[b] > int(sched.seq_lens[b])):
                sched.dirty_slots.add(b)

    def _note_limit_stops(self, e) -> None:
        """After committing decode dispatch ``e``: a lane whose committed
        length reached the limit it ran under in ``e`` stopped there on
        the device, and stays stopped (whatever later growth-only refreshes
        raise its limit to) until its row is pushed again -- unless it was
        pushed since ``e``."""
        sched = self.sched
        for b, seq in enumerate(e.slots):
            if (
                seq is not None
                and seq.finish is None
                and seq.slot == b
                and seq.life == e.lives[b]
                and e.pushes[b] == self._row_pushes[b]
                and int(sched.seq_lens[b]) >= int(e.limits[b])
            ):
                self._at_limit[b] = True

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
            "stop_ids": torch.full((B + 1, self.cfg.device_stop_width), -1, dtype=i64, device=dev),
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
        # the scheduler's layout and growth versions the device state holds
        self._dev_version = -1
        self._dev_growth = -1
        self._limit_host = np.zeros((B,), np.int64)
        # per lane: how often its row was pushed (rebuilds and row
        # scatters), and whether a committed dispatch since its last push
        # left it at the limit it ran under (_note_limit_stops)
        self._row_pushes = np.zeros((B,), np.int64)
        self._at_limit = np.zeros((B,), bool)
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
        row = np.full((self.cfg.device_stop_width,), -1, np.int64)
        if seq is not None and seq.stop.min_tokens is None:
            ids = list(seq.stop.stop_token_ids_hidden or [])
            if not seq.stop.ignore_eos:
                ids += list(seq.eos_ids)
            for j, t in enumerate(ids[:self.cfg.device_stop_width]):
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
        if sched.dirty_slots or self._dev_version != sched.layout_version:
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
        stop_ids = np.full((B, self.cfg.device_stop_width), -1, np.int64)
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
        self._dev_version = sched.layout_version
        self._dev_growth = sched.growth_version
        self._limit_host = limit
        self._row_pushes += 1
        self._at_limit[:] = False
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
            "stop": np.full((B, self.cfg.device_stop_width), -1, np.int64),
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
            self._row_pushes[b] += 1
            self._at_limit[b] = False
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
        self._dev_version = sched.layout_version

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
        tick = self._hop_tick
        if tick is not None and kind in TICK_KINDS:
            tick.note_dispatch(kind)
            tick.mark("dispatch")

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
            onboarding = bool(ch.seq.pending_onboard)
            self._prepare_prefill(ch.seq)
            if onboarding and ch.seq.cached_prompt_tokens < ch.start:
                # onboard truncated: the would-have-been-onboarded span is
                # recomputed, so the chunk widens back to the surviving
                # cached prefix (the classic paths read the start after
                # _prepare_prefill and get this for free)
                end = ch.start + ch.length
                ch.start = ch.seq.cached_prompt_tokens
                ch.length = end - ch.start
            chunk_by_slot[b] = ch
            p_start[b] = ch.start
            p_lens[b] = ch.length
            p_sample[b] = ch.final
            # a speculating lane samples its first token here but stays
            # device-inactive: it advances through verify columns
            p_act[b] = ch.final and not spec_live(ch.seq.spec)
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
            if self._hop_tick is not None:
                self._hop_tick.mark("assemble")
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
            if tracing.collector.enabled:
                self._prefill_span(pf.seq, mixed=True)
        return InflightUnified(
            res, slots, [s.life if s is not None else -1 for s in slots], finals,
            num_steps,
            spec_sampled=None if spec_host is None else Result(spec_host, res.event),
            spec_lanes=spec_lanes,
            limits=self._limit_host.copy(), pushes=self._row_pushes.copy(),
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
        if self._hop_tick is not None:
            self._hop_tick.mark("assemble")
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
        if self._hop_tick is not None:
            self._hop_tick.mark("assemble")
        packed = self._run_block(K, Pb, top_n, use_filters, use_penalties)
        res = self._download(packed, self._span_kind("decode_block", marks), start)
        self._count("decode_block")
        self.obs.observe_multistep_k(1)
        return InflightBlock(
            res, slots, [s.life if s is not None else -1 for s in slots],
            limits=self._limit_host.copy(), pushes=self._row_pushes.copy(),
        )

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
        lane's write headroom, so it never outruns its pages or budget.
        The ``spec.draft_corrupt`` chaos site corrupts the settled draft,
        precomputed or proposed here, before any verify column reads it."""
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
                if (
                    draft
                    and faults.injector.enabled
                    and faults.injector.should_fire("spec.draft_corrupt", seq.request_id)
                ):
                    # every proposed token shifted off its value: the accept
                    # walk rejects the whole column (a bad draft costs only
                    # compute, never output)
                    V = self.model_cfg.vocab_size
                    draft = [(t + 1) % V for t in draft]
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
        if self._hop_tick is not None:
            self._hop_tick.mark("assemble")
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
        top_n = self._lp_top(lanes)
        penalized = any(self._seq_penalized(s) for s in seqs)
        if all(s.mm_embeds is None for s in seqs):
            routed = self._dispatch_parallel_prefill(tokens, lens, table, lanes, top_n,
                                                     penalized)
            if routed is not None:
                return routed
        self.prefill_dispatches["full"] += 1
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
        if self._hop_tick is not None:
            self._hop_tick.mark("assemble")
        return prefill_mm_and_sample(
            self.params, self.model_cfg, self.kv.pages, put(tokens), put(lens),
            put(table), mm, mm_len, self._sampling_params(lanes), top_n, penalized,
        )

    def _dispatch_parallel_prefill(
        self,
        tokens: np.ndarray,  # [Bp, bucket]
        lens: np.ndarray,
        table: np.ndarray,
        lanes: List[Optional[SeqState]],
        top_n: int,
        penalized: bool,
    ) -> Optional[torch.Tensor]:
        """A full prefill through the ring (sp) or the pipeline (pp) when
        the mesh has that axis and the shapes qualify (the JAX engine's
        ``_dispatch_parallel_prefill``): the ring wants the bucket divisible
        by sp, the pipeline the batch divisible by its ``min(pp, B)``
        microbatches.  Returns the packed first-token samples, or None for
        the plain path."""
        mesh = self.mesh
        axis = mesh.prefill_axis if mesh is not None else None
        if axis is None:
            return None
        Bp, bucket = tokens.shape
        n = getattr(mesh, axis)
        M = min(n, Bp)
        if (axis == "sp" and bucket % n) or (axis == "pp" and Bp % M):
            return None
        put = self._put
        tok, ln, pt = put(tokens), put(lens), put(table)
        mirror = self.params.mirror
        if axis == "sp":
            from ..parallel.ring_attention import ring_prefill_step

            mirror.ring(tok, ln)
            logits = ring_prefill_step(self.params, self.model_cfg, self.kv.pages, tok, ln, pt,
                                       self._exchange)
            self.sp_prefills += 1
        else:
            from ..parallel.pipeline_parallel import pp_prefill_step

            mirror.pipe(tok, ln, M)
            logits = pp_prefill_step(self.params, self.model_cfg, self.kv.pages, tok, ln, pt, M,
                                     self._exchange)
            self.pp_prefills += 1
            self.pp_microbatches += M
        sampling = self._sampling_params(lanes)
        pen = prompt_penalized_logits(logits, tok, ln, sampling) if penalized else None
        return sample_step_packed(logits, sampling, top_n, ln, pen)

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
        if self._hop_tick is not None:
            self._hop_tick.mark("assemble")
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
        if tracing.collector.enabled:
            for seq in seqs:
                self._prefill_span(seq, group=len(seqs))
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
        if tracing.collector.enabled:
            self._prefill_span(seq)
        return pf

    @staticmethod
    def _prefill_span(seq: SeqState, **attrs: Any) -> None:
        """The ``engine.prefill_dispatch`` span of a lane whose prompt
        finished prefilling in this dispatch (tracing on)."""
        with tracing.span("engine.prefill_dispatch", seq.request_id) as sp:
            sp.set(
                prompt_len=len(seq.prompt), cached=seq.cached_prompt_tokens,
                kv_prefetch_hits=seq.prefetch_hits, **attrs,
            )

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

    def _commit_all(
        self, entries: List[Inflight], pipeline_busy: bool = False
    ) -> List[StepEvent]:
        """Read and commit one dispatch generation (or one classic prefill
        dispatch) in dispatch order: every result in one pass, then the
        stop-rule replay.  ``pipeline_busy``: another generation is still
        queued on the device behind this one, so the results landing here
        leave the device no idle gap."""
        tick = self._hop_tick
        if tick is not None:
            # close the loop->executor hop, so device_wait below is the wait
            tick.mark("dispatch")
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
        if tick is not None:
            # the time the reads above waited on the dispatches' events
            tick.mark("device_wait")
            if pipeline_busy:
                tick.note_zero_gap()
            else:
                self.profiler.note_results_ready()
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
                if tick is not None and isinstance(e, InflightUnified):
                    # the K - 1 step boundaries inside a fused dispatch
                    # left the device no host-visible idle
                    for _ in range(e.n_steps - 1):
                        tick.note_zero_gap()
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
                self._note_limit_stops(e)
                kind = "unified" if isinstance(e, InflightUnified) else "decode_block"
                self.obs.observe_step(kind, now - e.dispatched_at)
        alloc = self.kv.allocator
        self.obs.observe_kv(alloc.used_pages, alloc.num_pages - 1)
        if tick is not None:
            tick.mark("commit")
        return events

    # -- disaggregation: KV import (decode side) -----------------------------

    async def generate_external(self, request: Context[Any]) -> AsyncIterator[Annotated]:
        """Admit a request whose prompt KV a remote prefill worker delivers;
        the lane holds pages but decodes only after deliver_external."""
        self._refuse_on_mesh("importing a remote prefill's KV (--disagg decode)")
        return await self.generate(request, _external=True)

    def awaiting_external(self, request_id: str) -> bool:
        """True while the request is admitted (or queued) and still expects a
        remote prefill delivery."""
        return request_id in self._external

    def deliver_external(
        self,
        request_id: str,
        kv_blob: Any,
        first_token: int,
        lp_row: Optional[np.ndarray] = None,
    ) -> bool:
        """Hand over a remote prefill's KV (``[L, 2, n_pages, page, Hkv, D]``:
        a host blob, ``uint16`` for bf16 bits, or a device tensor of a
        same-process handoff; a :class:`QuantKV` pair for int8) plus its
        sampled first token (and, optionally, the packed logprob row the
        prefill worker sampled it from -- without it a logprobs request's
        first token would ship without its logprob).  Returns False when
        the request is no longer waiting (cancelled/failed).  Applied by
        the tick loop at its next iteration -- scheduler state is never
        touched from here."""
        if request_id not in self._external:
            return False
        arr = np.asarray(first_token).reshape(-1)
        if arr.size > 1 and lp_row is None:
            # caller handed the packed row itself as first_token (the
            # prefill_export return): use it for the logprob too
            lp_row = arr.astype(np.int32)
        self._deliveries[request_id] = (kv_blob, int(arr[0]), lp_row)
        # the KV is in hand: the remote-prefill deadline's job is done.  A
        # delivery that arrives while the request still waits for a slot
        # must not be discarded by the timeout scan (the remaining wait is
        # for decode capacity, not for the prefill worker)
        self._external_deadline.pop(request_id, None)
        if self._wake is not None:
            self._wake.set()
        return True

    def begin_external_chunked(self, request_id: str, shape: Tuple[int, ...], dtype: str) -> bool:
        """Open a chunked KV delivery for a parked external request: the
        sender streams layer-group chunks via :meth:`deliver_external_chunk`
        and closes with :meth:`commit_external_chunked`.  The pipelined
        counterpart of :meth:`deliver_external` -- pages scatter as chunks
        arrive instead of after the whole blob lands.  The completion
        barrier is layer coverage against ``shape[0]``, so chunk
        granularity is entirely the sender's choice."""
        if request_id not in self._external:
            return False
        self._chunked[request_id] = _ChunkedDelivery(
            shape=tuple(int(s) for s in shape), dtype=str(dtype)
        )
        return True

    def deliver_external_chunk(
        self, request_id: str, layer_lo: int, layer_hi: int, arr: Any
    ) -> bool:
        """Stage one layer-group chunk ``[layer_hi-layer_lo, 2, n_pages,
        page, Hkv, D]``; the tick loop scatters it into the lane's pages at
        its next iteration (or as soon as the lane gets a slot)."""
        rec = self._chunked.get(request_id)
        if rec is None or request_id not in self._external:
            return False
        rec.parts.append((int(layer_lo), int(layer_hi), arr))
        if self._wake is not None:
            self._wake.set()
        return True

    def commit_external_chunked(
        self, request_id: str, first_token: int, lp_row: Optional[np.ndarray] = None
    ) -> bool:
        """Close a chunked delivery: all chunks are in (or staged); commit
        the remotely-sampled first token once every layer has scattered --
        the completion barrier before the lane's first decode step."""
        rec = self._chunked.get(request_id)
        if rec is None or request_id not in self._external:
            return False
        arr = np.asarray(first_token).reshape(-1)
        if arr.size > 1 and lp_row is None:
            lp_row = arr.astype(np.int32)
        rec.first = int(arr[0])
        rec.lp_row = lp_row
        rec.done = True
        # the KV is in hand; any remaining wait is for decode capacity, not
        # the prefill worker (mirrors deliver_external)
        self._external_deadline.pop(request_id, None)
        if self._wake is not None:
            self._wake.set()
        return True

    def fail_external(self, request_id: str, message: str) -> bool:
        """Remote prefill reported failure: fail the parked request instead of
        letting it ride out the delivery timeout."""
        if request_id not in self._external:
            return False
        self._external_errors[request_id] = message
        if self._wake is not None:
            self._wake.set()
        return True

    def _expected_blob_shape(self, seq: SeqState) -> Tuple[int, ...]:
        kp = blob_shape(self.kv.pages)  # [L, 2, num_pages, page, Hkv, D]
        n_pages = -(-len(seq.prompt) // self.cfg.page_size)
        return (kp[0], kp[1], n_pages) + tuple(kp[3:])

    def _forget_external(self, rid: str) -> Optional[SeqState]:
        """Drop every disaggregation record of ``rid``; returns its parked
        sequence, if any."""
        self._deliveries.pop(rid, None)
        self._chunked.pop(rid, None)
        self._external_deadline.pop(rid, None)
        return self._external.pop(rid, None)

    def _drop_external(self, rid: str, message: str) -> None:
        """Fail one parked external request without touching the rest of the
        batch (the _fail_all hammer is for engine-wide faults only)."""
        seq = self._forget_external(rid)
        if seq is None or seq.finish is not None:
            return
        self._fail_seq(seq, message)
        self.sched.cancel(seq)

    def _process_deliveries(self) -> List[Tuple[Any, ...]]:
        """Tick-loop side: returns work items whose device dispatch is due --
        ``("blob", seq, blob, first, lp_row)`` for a monolithic delivery,
        ``("chunks", seq, parts)`` for staged layer-group scatters, and
        ``("commit", seq, first, lp_row)`` once a chunked delivery's barrier
        clears.  Drops deliveries for dead requests; fails parked lanes
        whose prefill errored, mis-shaped, or timed out."""
        for rid, msg in list(self._external_errors.items()):
            self._external_errors.pop(rid)
            self._drop_external(rid, f"remote prefill failed: {msg}")
        abandoned, self._abandoned = self._abandoned, []
        for seq in abandoned:
            if seq.finish is None:
                self.sched.cancel(seq)
        out: List[Tuple[Any, ...]] = []
        for rid in list(self._deliveries):
            blob, first, lp_row = self._deliveries.pop(rid)
            seq = self._external.pop(rid, None)
            if seq is None or seq.finish is not None:
                continue
            if seq.slot < 0:
                # not yet admitted: re-queue the delivery until plan() gives
                # the seq a slot and pages (or it dies)
                self._external[rid] = seq
                self._deliveries[rid] = (blob, first, lp_row)
                continue
            expect = self._expected_blob_shape(seq)
            if blob_shape(blob) != expect or expect[2] > len(seq.pages):
                # a mis-configured prefill worker (page_size/model mismatch)
                # must not take down the whole decode batch
                self._external_deadline.pop(rid, None)
                self._fail_seq(
                    seq,
                    f"remote prefill KV shape {blob_shape(blob)} does not "
                    f"match decode geometry {expect}",
                )
                self.sched.cancel(seq)
                continue
            self._external_deadline.pop(rid, None)
            out.append(("blob", seq, blob, first, lp_row))
        out.extend(self._process_chunked_deliveries())
        if self._external_deadline:
            now = time.monotonic()
            for rid, deadline in list(self._external_deadline.items()):
                if now >= deadline:
                    self._drop_external(
                        rid,
                        "timed out waiting for remote prefill KV "
                        f"({self.cfg.external_kv_timeout_s:.0f}s)",
                    )
        return out

    def _fail_chunked(self, rid: str, seq: SeqState, message: str) -> None:
        self._forget_external(rid)
        self._fail_seq(seq, message)
        self.sched.cancel(seq)

    def _process_chunked_deliveries(self) -> List[Tuple[Any, ...]]:
        """Chunked-delivery bookkeeping for :meth:`_process_deliveries`:
        release staged layer-group parts of admitted lanes for scatter, and
        emit the first-token commit once a delivery's barrier (``done`` +
        every layer applied or in this tick's scatter list) clears."""
        out: List[Tuple[Any, ...]] = []
        for rid in list(self._chunked):
            rec = self._chunked[rid]
            seq = self._external.get(rid)
            if seq is None or seq.finish is not None:
                del self._chunked[rid]
                continue
            if seq.slot < 0:
                continue  # not admitted yet: parts stay staged
            if not rec.validated:
                expect = self._expected_blob_shape(seq)
                if rec.shape != expect or expect[2] > len(seq.pages):
                    self._fail_chunked(
                        rid, seq,
                        f"remote prefill KV shape {rec.shape} does not "
                        f"match decode geometry {expect}",
                    )
                    continue
                rec.validated = True
            if rec.applied and rec.life != seq.life:
                # preempted and re-admitted into fresh pages since its parts
                # scattered: they go in again
                rec.parts = rec.applied + rec.parts
                rec.applied = []
                rec.applied_layers = 0
            L = rec.shape[0]
            bad = next(
                (
                    (lo, hi, arr)
                    for lo, hi, arr in rec.parts
                    if not (0 <= lo < hi <= L)
                    or blob_shape(arr) != (hi - lo,) + rec.shape[1:]
                ),
                None,
            )
            if bad is not None:
                lo, hi, arr = bad
                self._fail_chunked(
                    rid, seq,
                    f"remote prefill KV chunk layers [{lo},{hi}) shape "
                    f"{blob_shape(arr)} does not match decode geometry {rec.shape}",
                )
                continue
            if rec.parts:
                parts, rec.parts = rec.parts, []
                rec.applied_layers += sum(hi - lo for lo, hi, _ in parts)
                rec.applied += parts
                rec.life = seq.life
                out.append(("chunks", seq, parts))
            if rec.done and not rec.parts:
                self._forget_external(rid)
                if rec.applied_layers != L:
                    self._fail_seq(
                        seq,
                        f"incomplete chunked KV delivery: "
                        f"{rec.applied_layers} of {L} layers",
                    )
                    self.sched.cancel(seq)
                    continue
                out.append(("commit", seq, rec.first, rec.lp_row))
        return out

    def _delivered_on_device(self, blob: Any) -> Any:
        """A delivered blob (or chunk) on the device in this pool's dtype
        domain: a host blob through ``coerce_kv_blob`` (the JAX engine's
        rule, byte for byte within a domain) and one copy; a device blob
        of a same-process handoff as it is, or quantized / dequantized on
        the device by the same per-row rule."""
        data = blob.q if isinstance(blob, QuantKV) else blob
        if not isinstance(data, torch.Tensor):
            return self._blob_on_device([self._coerce_blob(blob)])
        if self.kv.quantized and not isinstance(blob, QuantKV):
            q, s = quantize_kv_rows(blob)
            return QuantKV(q=q, s=s)
        if not self.kv.quantized and isinstance(blob, QuantKV):
            return (blob.q.float() * blob.s[..., None, None]).to(self.dtype)
        return blob

    def _lane_prompt_pages(self, seq: SeqState) -> List[int]:
        return seq.pages[: -(-len(seq.prompt) // self.cfg.page_size)]

    def _apply_external_chunks(self, seq: SeqState, parts: List[Tuple[int, int, Any]]) -> None:
        """Executor thread: scatter staged layer-group chunks into the
        lane's pages in place, on the dispatch stream (the incremental half
        of a chunked delivery; the first-token commit waits for the
        barrier)."""
        pages = self._lane_prompt_pages(seq)
        for lo, _hi, arr in parts:
            self._scatter_pages(pages, self._delivered_on_device(arr), first_layer=lo)

    def _apply_external_kv(
        self, seq: SeqState, blob: Any, first_token: int, lp_row: Optional[np.ndarray] = None
    ) -> StepEvent:
        """Executor thread: scatter the delivered KV into the lane's pages
        (in place, on the dispatch stream: before the lane's first decode
        dispatch, and graph addresses never move), then commit the
        remotely-sampled first token."""
        self._scatter_pages(self._lane_prompt_pages(seq), self._delivered_on_device(blob))
        return self._apply_external_commit(seq, first_token, lp_row)

    def _apply_external_commit(
        self, seq: SeqState, first_token: int, lp_row: Optional[np.ndarray] = None
    ) -> StepEvent:
        """Executor thread: the KV is fully in the lane's pages (monolithic
        scatter or chunked barrier cleared); commit the remotely-sampled
        first token and wake the lane: a dirty row hands its token, length
        and page-table row to the device state, which the next dispatch (or
        graph replay) reads."""
        seq.awaiting_kv = False
        lp, top = None, None
        if lp_row is not None and len(lp_row) >= 2:
            N = (len(lp_row) - 2) // 2
            _tok, lp_v, tids, tlps = unpack_sampled_logprobs(np.asarray(lp_row, np.int32), N)
            lp = float(lp_v)
            if N:
                top = [[int(i), float(l)] for i, l in zip(tids, tlps)]
        ev = self.sched.commit_prefill_token(seq, first_token, lp, top)
        # membership changed (parked -> live): fold the lane into the
        # device state at the next dispatch
        if seq.slot >= 0:
            self.sched.dirty_slots.add(seq.slot)
        return ev

    # -- disaggregation: KV export (prefill side) -----------------------------

    async def prefill_export(self, req: PreprocessedRequest) -> Tuple[Any, np.ndarray]:
        """Prefill-worker side: prefill one prompt into scratch pages and
        return (host kv_blob ``[L, 2, n_pages, page, Hkv, D]``, packed
        first-token row); the scratch frees.  The batched export with one
        item, so the single and batched exports cannot diverge."""
        (res,) = await self.prefill_export_batch([req])
        if isinstance(res, Exception):
            raise res
        return res

    async def prefill_export_batch(
        self, reqs: List[PreprocessedRequest], device: bool = False
    ) -> List[Any]:
        """Batched :meth:`prefill_export`: one padded full-prompt dispatch
        (``_dispatch_full_prefill_batch``, the aggregated path's site, so
        disagg == aggregated output) per group of up to ``max_batch_size``
        similar lengths, and one gather of the group's pages.  Returns one
        entry per request, either ``(kv_blob, packed_row)`` or the
        per-request ``Exception`` -- one bad prompt must not fail its
        batch-mates.

        ``device=True`` keeps the blobs on the device (views of the group's
        gathered copy) for a same-process decode engine, the port's
        device-to-device handoff: only the packed rows come to the host.
        Otherwise each group's pages copy into pinned host memory without
        blocking; the waits for those copies and for the rows run in a
        thread of their own, off the engine's executor, so the other
        engine's dispatches and this one's ticks go on meanwhile."""
        if not self._running:
            await self.start()
        pending = await self._on_executor(self._prefill_export_batch, reqs, device)
        return await asyncio.to_thread(self._finish_exports, pending)

    @staticmethod
    def _finish_exports(pending: List[Any]) -> List[Any]:
        """Wait for each export's rows and pages and slice out its blob and
        row (a group's rows and host copy are read once)."""
        hosts: Dict[int, Any] = {}
        rows: Dict[int, np.ndarray] = {}
        out: List[Any] = []
        for p in pending:
            if isinstance(p, Exception):
                out.append(p)
                continue
            if id(p.rows) not in rows:
                rows[id(p.rows)] = p.rows.numpy()
            pages = p.pages
            if isinstance(pages, PageSnapshot):
                if id(pages) not in hosts:
                    hosts[id(pages)] = pages.materialize()
                pages = hosts[id(pages)]
            blob = blob_index(pages, (slice(None), slice(None), slice(p.off, p.off + p.n)))
            out.append((blob, rows[id(p.rows)][p.row]))
        return out

    def _export_groups(self, reqs: List[PreprocessedRequest], export_one) -> List[Any]:
        """Executor thread: the valid requests sorted by length (one long
        prompt must not pad a whole group's bucket) in groups of
        ``max_batch_size``, each exported by ``export_one(group, results)``;
        a group that fails (page pressure) retries its requests one by one,
        so per-item errors land on their own request."""
        results: List[Any] = [None] * len(reqs)
        valid: List[int] = []
        for i, req in enumerate(reqs):
            if not req.token_ids:
                results[i] = ValueError("empty prompt")
            else:
                valid.append(i)
        valid.sort(key=lambda i: len(reqs[i].token_ids))
        B = self.cfg.max_batch_size
        for start in range(0, len(valid), B):
            group = valid[start : start + B]
            try:
                export_one(group, results)
            except Exception:  # page pressure / bucket overflow
                logger.warning(
                    "grouped prefill export failed; retrying %d request(s) "
                    "individually", len(group), exc_info=True,
                )
                for i in group:
                    try:
                        export_one([i], results)
                    except Exception as exc:
                        results[i] = exc
        return results

    def _export_dispatch(
        self, reqs: List[PreprocessedRequest], group: List[int]
    ) -> Tuple[List[List[int]], Result, torch.Tensor]:
        """Executor thread: scratch pages for the group's prompts and one
        padded full-prompt prefill into them; returns the pages, the packed
        rows on their way to the host (their copy enqueued first, so
        waiting for them never waits for the gathers behind it) and the
        scratch page ids on the device.  The caller gathers the pages on
        this stream and then frees them: a later dispatch that reuses them
        runs after the gather."""
        ps = self.cfg.page_size
        allocated: List[List[int]] = []
        try:
            for i in group:
                allocated.append(self.kv.allocator.alloc(-(-len(reqs[i].token_ids) // ps)))
        except Exception:
            for pages in allocated:
                self.kv.allocator.free(pages)
            raise
        try:
            seqs = []
            for i, pages in zip(group, allocated):
                seq = SeqState.from_request("export", reqs[i], self.sched.block_size)
                seq.pages = pages
                seqs.append(seq)
            start = self._span_start()
            packed = self._dispatch_full_prefill_batch(
                seqs, min(pow2_bucket(len(seqs)), self.cfg.max_batch_size)
            )
            rows = self._download(packed, "export", start)
            self._count("export")
            ids = self._put(np.concatenate([np.asarray(p, np.int64) for p in allocated]))
        except Exception:
            for pages in allocated:
                self.kv.allocator.free(pages)
            raise
        return allocated, rows, ids

    def _prefill_export_batch(self, reqs: List[PreprocessedRequest], device: bool) -> List[Any]:
        def export_one(group: List[int], results: List[Any]) -> None:
            allocated, rows, ids = self._export_dispatch(reqs, group)
            try:
                dev = self._gather_pages(ids)
                pages = dev if device else PageSnapshot(dev)
            finally:
                for p in allocated:
                    self.kv.allocator.free(p)
            off = 0
            for row, (i, p) in enumerate(zip(group, allocated)):
                results[i] = _PendingExport(rows, pages, row, off, len(p))
                off += len(p)

        return self._export_groups(reqs, export_one)

    async def prefill_export_batch_stream(
        self, reqs: List[PreprocessedRequest], layers_per_chunk: Optional[int] = None
    ) -> List[Any]:
        """Chunked, layer-pipelined :meth:`prefill_export_batch`: the batch
        prefill dispatches once, then each layer group is gathered on the
        dispatch stream and copied without blocking into pinned host memory
        behind an event, and a :class:`KVExportStream` is handed back
        BEFORE any blob materializes (only the packed rows are waited for).
        The consumer streams chunk 0 onto the wire while chunks 1..N-1 are
        still copying -- export-before-first-byte drops from the whole
        blob's copy to one group's.

        ``layers_per_chunk`` pins the chunk granularity; None splits the
        stack into ~``ONBOARD_CHUNKS`` groups.  Returns one entry per
        request: a :class:`KVExportStream` or the per-request
        ``Exception``.  The same dispatch site as the aggregated path."""
        if not self._running:
            await self.start()
        spans = layer_chunk_spans(self.model_cfg.num_layers, layers_per_chunk, ONBOARD_CHUNKS)
        pending = await self._on_executor(self._prefill_export_batch_stream, reqs, spans)

        def wait_rows() -> List[Any]:
            return [p if isinstance(p, Exception) else p.rows.numpy()[p.row] for p in pending]

        shape = self._export_shape()
        out: List[Any] = []
        for p, row in zip(pending, await asyncio.to_thread(wait_rows)):
            if isinstance(p, Exception):
                out.append(p)
                continue
            out.append(KVExportStream(
                shape=shape[:2] + (p.n,) + shape[3:], dtype=dtype_name(self.kv.dtype),
                row=row, spans=spans, shards=self.kv.shard_geometry,
                _group=p.pages, _page_off=p.off,
            ))
        return out

    def _prefill_export_batch_stream(
        self, reqs: List[PreprocessedRequest], spans: List[Tuple[int, int]]
    ) -> List[Any]:
        def export_one(group: List[int], results: List[Any]) -> None:
            allocated, rows, ids = self._export_dispatch(reqs, group)
            try:
                shared = _GroupSpanExport([
                    PageSnapshot(self._gather_pages(
                        ids, self._put(np.arange(lo, hi, dtype=np.int64))
                    ))
                    for lo, hi in spans
                ])
            finally:
                for p in allocated:
                    self.kv.allocator.free(p)
            off = 0
            for row, (i, p) in enumerate(zip(group, allocated)):
                results[i] = _PendingExport(rows, shared, row, off, len(p))
                off += len(p)

        return self._export_groups(reqs, export_one)

    # -- cross-worker prefix onboarding: the donor side ----------------------

    async def export_blocks(
        self, seq_hashes: List[int]
    ) -> List[Tuple[int, Any, Dict[str, Any]]]:
        """Export the longest resident prefix of ``seq_hashes`` as ``(hash,
        blob, meta)`` triples -- the donor side of cross-worker prefix
        onboarding (refused under tensor or expert parallelism; reference
        block_manager.rs:119-146 blockset export and
        import).  The G1 blocks come first, in one gather of all their
        pages; the offload tiers fill the tail; the chain stops at the first
        miss, because an importer can only use a contiguous prefix.  Blobs
        are host blobs (bf16 as ``uint16`` bits), metas carry the JAX
        package's ``kv_dtype`` names.

        The pool belongs to the loop thread: the match and the references
        are taken here, and the gather is enqueued on the dispatch stream
        (as the eviction hook's is), so it lands after the generations
        already in flight and before any dispatch that reuses the pages;
        the blocks are released once it is enqueued.  The wait for the
        gather's host copy and the tier reads -- which wait on the offload
        and kv-remote threads -- run off the loop."""
        self._refuse_on_mesh("prefix onboarding's block export")
        if not self._running:
            await self.start()
        pool = self.sched.pool
        acquired = []
        snap = None
        try:
            # without the block pool (prefix caching off) nothing is resident
            for blk in pool.match(seq_hashes) if pool is not None else ():
                if pool.acquire(blk.sequence_hash) is None:
                    break
                acquired.append(blk)
            if acquired:
                ids = np.concatenate([np.asarray(b.pages, np.int64) for b in acquired])
                snap = PageSnapshot(gather_block_pages(self.kv.pages, self._put(ids)))
        finally:
            for blk in acquired:
                pool.release(blk.sequence_hash)
        heads = [
            (
                blk.sequence_hash,
                len(blk.pages),
                {
                    "block_hash": blk.block_hash,
                    "parent_sequence_hash": blk.parent_sequence_hash,
                    "position": blk.position,
                    "kv_dtype": self._kv_dtype_name,
                },
            )
            for blk in acquired
        ]
        return await asyncio.to_thread(self._finish_block_export, seq_hashes, heads, snap)

    def _finish_block_export(self, seq_hashes, heads, snap) -> List[Tuple[int, Any, Dict[str, Any]]]:
        """Worker thread: slice the G1 head out of its host copy, then
        continue the chain through the offload tiers (G2, G3, G4)."""
        out: List[Tuple[int, Any, Dict[str, Any]]] = []
        if snap is not None:
            blob_all = snap.materialize()
            off = 0
            for seq_hash, k, meta in heads:
                out.append(
                    (seq_hash, blob_index(blob_all, (slice(None), slice(None), slice(off, off + k))), meta)
                )
                off += k
        oe = self.offload_engine
        if oe is not None:
            for h in seq_hashes[len(out) :]:
                hit = oe.get_blocking(h)
                if hit is None:
                    break
                blob, meta = hit
                out.append((h, blob, meta.to_dict()))
        return out

    def attach_remote_kv(self, store, *, worker_id: int = 0, namespace: str = "dynamo") -> None:
        """Arm the G4 remote tier on the offload plane over ``store``, any
        blob store with sync put/get (``offload.InMemoryBlobStore``,
        ``runtime.transports.client.HubBlobClient``).  A no-op unless the
        offload plane and a parsed ``kv_remote`` spec are both armed."""
        if self.offload_engine is None or self.kv_remote_spec is None:
            return
        self.offload_engine.attach_remote(
            store,
            worker_id=worker_id,
            namespace=str(self.kv_remote_spec.get("namespace", namespace)),
            mirror=bool(self.kv_remote_spec.get("mirror", True)),
        )

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

    def _scatter_pages(self, page_ids: Sequence[int], blob: Any, first_layer: int = 0) -> None:
        """One page-bucketed, layer-chunked scatter of ``blob`` (device, on
        the pages axis; layers ``first_layer`` on) into ``page_ids``: the
        ids pad to their page bucket with trash page 0, the blob with zero
        pages."""
        bucket = pick_page_bucket(len(page_ids), self.sched.max_pages)
        ids = np.zeros((bucket,), np.int64)
        ids[: len(page_ids)] = page_ids
        ids_t = self._put(ids)
        padded = pad_page_axis(blob, bucket)
        for lo, hi in layer_chunk_spans(blob_shape(blob)[0], None, ONBOARD_CHUNKS):
            scatter_layer_pages(
                self.kv.pages, slice(first_layer + lo, first_layer + hi), ids_t,
                blob_index(padded, slice(lo, hi)),
            )

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
        stream.  The ``onboard.truncate`` chaos site abandons them
        instead."""
        if faults.injector.enabled and faults.injector.should_fire(
            "onboard.truncate", seq.request_id
        ):
            self._abandon_onboards(seq)
            return
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

    def _abandon_onboards(self, seq: SeqState) -> None:
        """Onboard aborted (chaos): recompute the would-have-been-onboarded
        prefix.  Its pages already sit at their page-table positions, so
        they stay plain-owned and the longer suffix prefill writes the
        prompt's KV into them -- no page moves, none leaks, nothing
        registers until the prefill's KV is committed."""
        sched = self.sched
        seq.pending_onboard = []
        seq.cached_prompt_tokens = len(seq.held_blocks) * sched.block_size
        if seq.prefilling:
            # a chunk-bound lane restarts its chunks at the surviving prefix
            seq.prefilled_tokens = min(seq.prefilled_tokens, seq.cached_prompt_tokens)
        sched._queue_prompt_registrations(seq)
        oe = self.offload_engine
        if oe is not None:
            oe.onboard_fallbacks += 1
            oe.metrics.onboard_fallbacks.labels("truncate").inc()

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
        n_blocks = -(-n_pages // self.sched.pages_per_block)
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
            if faults.injector.enabled and faults.injector.should_fire(
                "onboard.truncate", f"swap/{rid}"
            ):
                self._swap_recompute(seq, "truncate")
                continue
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
            "external_parked": len(self._external),
            "tokens_generated": self._tokens_generated,
            **({"mesh": self.mesh.describe()} if self.mesh is not None else {}),
        }

    # -- events -------------------------------------------------------------

    def _deliver(self, item) -> None:
        """One fanout item: a commit's events, or an error frame."""
        if isinstance(item, tuple):
            self._put_error(item[1], item[2])
        else:
            self._emit(item)

    def _emit(self, events: List[StepEvent]) -> None:
        # with the block pool, stored and removed events come from the
        # registry (registration and eviction, through _emit_kv_event);
        # without it (prefix caching off) each request publishes its
        # completed blocks and, at its end, their removal -- the JAX
        # engine's fallback
        pool = self.sched.pool
        for ev in events:
            queue = self._queues.get(ev.seq.request_id)
            self._tokens_generated += len(ev.tokens)
            if ev.tokens:
                self.obs.tokens.inc(len(ev.tokens))
                if not ev.seq.slo_noted:
                    # the first token: the SLO plane's queue-wait (arrival
                    # -> admission) and service (admission -> first commit)
                    # split of this request, what a TTFT miss is classed by
                    ev.seq.slo_noted = True
                    if slo.tracker.enabled:
                        now_m = time.monotonic()
                        adm = ev.seq.admitted_s or now_m
                        slo.tracker.note_first_token(
                            ev.seq.request_id,
                            queue_s=adm - ev.seq.arrival_s,
                            service_s=now_m - adm,
                        )
            if ev.completed_blocks and pool is None:
                self._publish_stored(ev.completed_blocks)
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
                    if tracing.collector.enabled:
                        with tracing.span("engine.spec", ev.seq.request_id) as sp:
                            sp.set(
                                spec_accept_rate=round(st.accept_rate, 6),
                                spec_drafted=st.drafted,
                                spec_accepted=st.accepted,
                                spec_verify_steps=st.verify_steps,
                            )
                queue.put_nowait(Annotated.from_data(out.to_dict()))
                queue.put_nowait(None)
                if pool is None:
                    self._publish_removed(ev.seq)

    def _publish_stored(self, blocks) -> None:
        if self.kv_event_sink is None:
            return
        self.kv_event_sink(
            {
                "type": "stored",
                "blocks": [
                    {
                        "block_hash": b.block_hash,
                        "sequence_hash": b.sequence_hash,
                        "parent_sequence_hash": b.parent_sequence_hash,
                        "position": b.position,
                    }
                    for b in blocks
                ],
            }
        )

    def _publish_removed(self, seq: SeqState) -> None:
        if self.kv_event_sink is None or seq.blocks is None:
            return
        hashes = seq.blocks.sequence_hashes()
        if hashes:
            self.kv_event_sink({"type": "removed", "sequence_hashes": hashes})

    def _fail_seq(self, seq: SeqState, message: str) -> None:
        if seq.finish is None:
            seq.finish = FinishReason.ERROR
        # a failed external request must not resurrect via a late delivery
        self._forget_external(seq.request_id)
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
            self._forget_external(rid)
            self._nonce_of.pop(rid, None)
            self._ctxs.pop(rid, None)
            self._cancel_prefetch(rid)
            if self._swapped.pop(rid, None) is not None:
                self.offload_engine.drop_swap(rid)
            seq = by_id.get(rid)
            if seq is not None:
                # with the block pool, a cancel only drops references:
                # registered blocks stay resident until evicted
                if self.sched.pool is None:
                    self._publish_removed(seq)
                self.sched.cancel(seq)

    def _handle_stalled_admission(self) -> None:
        """Nothing running, nothing admitted: a request whose prompt can
        never fit the page pool fails instead of spinning the loop."""
        sched = self.sched
        if sched.num_active > 0 or not sched.waiting:
            return
        head = sched.waiting[0]
        if sched.min_total_pages(head) <= sched.allocator.num_pages - 1:
            return
        sched.waiting.popleft()
        self._fail_seq(head, "request needs more KV pages than the pool holds")
