"""MockerEngine: deterministic fake engine behind the AsyncEngine surface.

Behavioral rebuild of the reference mocker scheduler
(lib/llm/src/mocker/scheduler.rs:185-400, sequence.rs): waiting queue ->
watermark-gated admission with a prefill cost model -> per-tick decode over
all running sequences -> LRU preemption when blocks run out -> completion
derefs blocks into the reusable pool.  Token generation is a deterministic
function of (prompt, index), so tests get reproducible streams; simulated
prefill/decode latency is configurable (0 = as fast as the event loop).

A copy of the JAX package's ``mocker/engine.py`` (which loads no JAX): the
same token streams, KV events (stored / removed), ``ForwardPassMetrics``,
telemetry snapshots and chaos sites (``worker.slow``; ``crash()`` for
``worker.kill``), over the port's metrics registry, tick profiler, SLO
tracker, compile sentry and thread sentry.  It publishes what
``TorchEngine`` publishes, so router / disagg / planner stacks are
exercised unmodified -- just pointed at a mock.
"""

from __future__ import annotations

import asyncio
import itertools
import random
import logging
import time
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, Dict, List, Optional

from ..runtime import compile_sentry, profiling, slo, thread_sentry
from ..runtime.metrics import EngineMetrics
from ..protocols.common import (
    FinishReason,
    ForwardPassMetrics,
    LLMEngineOutput,
    PreprocessedRequest,
)
from ..runtime.engine import Annotated, Context, ResponseStream
from ..tokens.sequence import TokenBlockSequence
from .kv_manager import MockKvManager, PrefillCost

logger = logging.getLogger("dynamo.mocker")

# The designated stream-fanout emitters of the mocker's tick loop: queue
# puts happen only in the per-lane commit/finish/error paths.
TICK_COMMIT_HELPERS = (
    "_generate_one",
    "_finish",
    "_emit_error",
)

_partial_ids = itertools.count(1)


def _new_partial_id() -> int:
    """Unique negative key for a still-filling block (never a valid hash)."""
    return -next(_partial_ids)


@dataclass
class MockerConfig:
    block_size: int = 16
    kv_capacity_blocks: int = 256
    max_batch_size: int = 64
    watermark: float = 0.01
    # simulated time: seconds per prefill-compute unit and per decode step;
    # 0.0 = run at event-loop speed (unit-test mode)
    prefill_s_per_compute: float = 0.0
    decode_s_per_step: float = 0.0
    # token budget per admission round (reference token_capacity)
    token_capacity: int = 8192
    vocab_size: int = 32000
    speedup_ratio: float = 1.0
    # fault injection: simulated network latency on the response path --
    # a fixed floor plus uniform jitter per item (SURVEY.md 5.3: latency-
    # model mock network for chip-free failure/SLO testing)
    network_latency_ms: float = 0.0
    network_jitter_ms: float = 0.0
    # double-buffered tick pipeline (mirrors EngineConfig.async_dispatch): tick N+1's "dispatch" (the simulated
    # decode sleep) starts BEFORE tick N's host commit/fanout runs, so
    # host work overlaps simulated device time and the dispatch gap
    # collapses to zero -- the same lane structure the engine runs,
    # exercised device-free in the tests.  False = the exact serial loop.
    # Only engages when decode_s_per_step > 0 (with no simulated device
    # time there is nothing to overlap, and unit tests keep their
    # same-tick token delivery).
    async_dispatch: bool = True
    # multi-step decode (mirrors EngineConfig.multistep_decode):
    # each simulated dispatch covers K decode steps -- K tokens per lane
    # per tick, one K-wide simulated device sleep, and K-1 zero-gap step
    # boundaries (device-internal by construction) -- so the tests exercise
    # the K-block commit/discard plane device-free.  1 = the exact
    # single-step tick (seed behavior); N > 1 = fixed K; 0 = adaptive
    # (ramp toward 8 on pressure-free ticks, collapse to 1 while anything
    # waits or prefills, the engine controller's shape).
    multistep_k: int = 1
    # fleet-telemetry identity (runtime/telemetry.py): who this engine
    # claims to be in published snapshots
    worker_id: int = 0
    role: str = "decode"
    # synthetic KV-transfer link model: with link_bandwidth_bytes_per_s > 0
    # every admission's fresh prefill tokens record one transfer from
    # link_src as if their KV arrived over the wire --
    # seconds = link_setup_s + nbytes / bandwidth, nbytes = new_tokens *
    # kv_bytes_per_token, jittered by +-link_jitter_frac.  Record-only (no
    # sleeps): the chip-free plane exercises the observatory's learned
    # cost model against a known ground truth.
    link_src: int = -1
    link_bandwidth_bytes_per_s: float = 0.0
    link_setup_s: float = 0.0
    link_jitter_frac: float = 0.0
    kv_bytes_per_token: int = 4096


@dataclass
class _MockSeq:
    request_id: str
    req: PreprocessedRequest
    blocks: TokenBlockSequence  # prompt + generated, canonical identity
    partial_id: int
    held: List[int] = field(default_factory=list)  # keys currently use()'d
    num_generated: int = 0
    cost: Optional[PrefillCost] = None
    prefilled: bool = False
    finish: Optional[FinishReason] = None
    # prefix-cache stats are counted once per request (first admission);
    # re-admissions after preemption trivially re-hit their own blocks
    stats_counted: bool = False
    # SLO attainment plane stamps (runtime/slo.py): same queue-wait vs
    # service decomposition the engine notes, so SLO-loop tests run
    # device-free
    arrival_s: float = field(default_factory=time.monotonic)
    admitted_s: float = 0.0
    slo_noted: bool = False

    @property
    def max_tokens(self) -> int:
        mt = self.req.stop_conditions.max_tokens
        return mt if mt is not None else 1 << 30


class MockerEngine:
    """AsyncEngine-compatible deterministic engine (no device, no JAX)."""

    def __init__(
        self, cfg: Optional[MockerConfig] = None, registry=None
    ) -> None:
        self.cfg = cfg or MockerConfig()
        # optional private MetricsRegistry: in-process fleets (several
        # mockers under one test) keep their engine series -- and hence
        # their telemetry snapshots -- from colliding on shared gauges
        self.registry = registry
        self.kv_event_sink: Optional[Callable[[Dict[str, Any]], None]] = None
        self.kv = MockKvManager(
            self.cfg.kv_capacity_blocks,
            self.cfg.block_size,
            event_sink=lambda ev: self._sink(ev),
        )
        self._waiting_list: List[_MockSeq] = []
        self.running: Dict[str, _MockSeq] = {}
        self._queues: Dict[str, asyncio.Queue] = {}
        self._cancelled: set = set()
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._running = False
        self._prefix_hits = 0
        self._prefix_lookups = 0
        self._tokens_generated = 0
        # same registry-backed series the engine exposes, so chip-free
        # stacks (mocker workers behind a frontend) light up /metrics too
        self.obs = EngineMetrics(
            registry=registry, max_slots=self.cfg.max_batch_size
        )
        # per-engine transfer log: the synthetic link model's observations
        # ride this engine's telemetry snapshots, never another engine's
        from ..runtime.telemetry import TransferLog

        self.transfer_log = TransferLog()
        # tick-phase profiler: the mocker marks the same phases the real
        # engine does (its simulated decode sleep plays device_wait), so
        # planner/SLO-loop tests exercise the whole plane chip-free
        self.profiler = profiling.profiler
        # double-buffered lane: the in-flight simulated dispatch --
        # (sleep_task, rids snapshot, K) -- whose host commit runs next tick
        self._inflight_tick = None
        # adaptive multi-step ramp (multistep_k == 0): doubles per
        # pressure-free tick toward the engine's default ceiling
        self._ms_ramp = 1
        # fused-K values already "compiled": each distinct K is a
        # distinct multistep graph in the real engine, so the first
        # dispatch at a new K mints one synthetic compile event -- the
        # device-free compile-sentry signal the tests assert against
        self._minted_ks: set = set()

    def _sink(self, ev: Dict[str, Any]) -> None:
        if self.kv_event_sink is not None:
            self.kv_event_sink(ev)

    async def embed(self, token_batches):
        """Deterministic fake embeddings (content-hash unit vectors) so the
        chip-free mocker exercises the /v1/embeddings leg end-to-end."""
        from ..llm.embedding import fake_embedder

        return await fake_embedder()(token_batches)

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._wake = asyncio.Event()
        self._flightrec_key = profiling.flight_recorder.add_provider(
            "mocker", self._flightrec_state
        )
        self._task = asyncio.create_task(self._run(), name="mocker-loop")

    def _flightrec_state(self):
        return {
            "waiting": len(self._waiting_list),
            "active": len(self.running),
            "slots": self.cfg.max_batch_size,
            "kv_blocks_active": self.kv.num_active_blocks,
            "kv_blocks_total": self.kv.max_capacity,
            "tokens_generated": self._tokens_generated,
        }

    async def stop(self) -> None:
        self._running = False
        inflight = self._inflight_tick
        if inflight is not None:
            self._inflight_tick = None
            if inflight[0] is not None:
                inflight[0].cancel()
        if self._wake is not None:
            self._wake.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            except Exception:
                logger.debug("mocker loop raised during stop", exc_info=True)
            self._task = None
        profiling.flight_recorder.remove_provider(
            getattr(self, "_flightrec_key", "mocker"), self._flightrec_state
        )

    async def drain(self, timeout_s: float = 5.0) -> bool:
        """Graceful retirement: stop admitting nothing new arrives here --
        the caller (LocalConnector scale-down) stops routing first -- and
        wait for every in-flight sequence to finish.  Returns True when
        the engine emptied within ``timeout_s`` (safe to stop()), False
        when work remains (the connector refunds the replica instead of
        dropping requests).  The in-process twin of the SIGTERM drain
        handler real workers install."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if (
                not self.running
                and not self._waiting_list
                and self._inflight_tick is None
            ):
                return True
            await asyncio.sleep(0.005)
        return not self.running and not self._waiting_list

    async def crash(self) -> None:
        """Die like a killed process: every in-flight and queued sequence
        gets an error frame (clients see the dropped connection and run
        failover), then the loop stops.  Chaos rigs (the SLO rig's
        worker.kill) call this; a planner scale-down never does."""
        for seq in list(self.running.values()) + list(self._waiting_list):
            self._emit_error(seq, "mocker crashed (injected worker.kill)")
            self.kv.deref(seq.held)
            seq.held = []
        self.running.clear()
        self._waiting_list.clear()
        await self.stop()

    # -- AsyncEngine --------------------------------------------------------

    async def generate(self, request: Context[Any]) -> AsyncIterator[Annotated]:
        if not self._running:
            await self.start()
        data = request.data
        req = (
            PreprocessedRequest.from_dict(data) if isinstance(data, dict) else data
        )
        seq = _MockSeq(
            request_id=request.id,
            req=req,
            blocks=TokenBlockSequence(req.token_ids, block_size=self.cfg.block_size),
            partial_id=_new_partial_id(),
        )
        ctx = request.ctx
        queue: asyncio.Queue = asyncio.Queue()
        self._queues[request.id] = queue
        self._waiting_list.append(seq)
        assert self._wake is not None
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
                    # dynalint: disable=DT001 -- 'get' is in 'done': result() is non-blocking
                    item = get.result()
                    if item is None:
                        return
                    if self.cfg.network_latency_ms or self.cfg.network_jitter_ms:
                        jitter = (
                            random.random() * self.cfg.network_jitter_ms
                            if self.cfg.network_jitter_ms
                            else 0.0
                        )
                        await asyncio.sleep(
                            (self.cfg.network_latency_ms + jitter) / 1e3
                        )
                    yield item
            finally:
                self._queues.pop(request.id, None)
                # torn down without a finish (killed ctx -> ResponseStream
                # acloses the generator; abandoned consumer): cancel the
                # sequence so its KV blocks free now, not at max_tokens
                self._cancelled.add(request.id)
                if self._wake is not None:
                    self._wake.set()

        return ResponseStream(ctx, stream())

    # -- metrics ------------------------------------------------------------

    def metrics(self) -> ForwardPassMetrics:
        hit_rate = (
            self._prefix_hits / self._prefix_lookups if self._prefix_lookups else 0.0
        )
        return ForwardPassMetrics(
            kv_active_blocks=self.kv.num_active_blocks,
            kv_total_blocks=self.kv.max_capacity,
            num_requests_waiting=len(self._waiting_list),
            # active (pinned) blocks only: inactive-reusable blocks are
            # reclaimable capacity, matching PagePool.used_pages semantics
            gpu_cache_usage_perc=(
                self.kv.num_active_blocks / self.kv.max_capacity
                if self.kv.max_capacity
                else 0.0
            ),
            gpu_prefix_cache_hit_rate=hit_rate,
            request_active_slots=len(self.running),
            request_total_slots=self.cfg.max_batch_size,
        )

    @property
    def tokens_generated(self) -> int:
        return self._tokens_generated

    # -- deterministic token function ---------------------------------------

    def _next_token(self, seq: _MockSeq) -> int:
        base = sum(seq.req.token_ids) * 1000003 + len(seq.req.token_ids) * 8191
        return (base + seq.num_generated * 7919) % self.cfg.vocab_size

    # -- the tick loop ------------------------------------------------------

    async def _run(self) -> None:
        assert self._wake is not None
        while self._running:
            try:
                prof = self.profiler
                tick = prof.begin_tick() if prof.enabled else None
                self._process_cancellations()
                if (
                    not self._waiting_list
                    and not self.running
                    and self._inflight_tick is None
                ):
                    if tick is not None:
                        tick.discard()
                        tick = None
                    self._wake.clear()
                    await self._wake.wait()
                    continue
                self._admit()
                if tick is not None:
                    tick.mark("plan")
                await self._simulate_tick(tick)
                if tick is not None:
                    prof.finish_tick(tick)
                await asyncio.sleep(0)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.exception("mocker tick failed")
                inflight = self._inflight_tick
                if inflight is not None:
                    self._inflight_tick = None
                    if inflight[0] is not None:
                        inflight[0].cancel()
                for seq in list(self.running.values()) + self._waiting_list:
                    self._emit_error(seq, f"mocker error: {e}")
                    self.kv.deref(seq.held)
                    seq.held = []
                self.running.clear()
                self._waiting_list.clear()
                await asyncio.sleep(0.01)

    def _process_cancellations(self) -> None:
        for rid in list(self._cancelled):
            self._cancelled.discard(rid)
            seq = self.running.pop(rid, None)
            if seq is not None:
                self.kv.deref(seq.held)
                seq.held = []
            else:
                self._waiting_list = [
                    s for s in self._waiting_list if s.request_id != rid
                ]

    def _admit(self) -> None:
        budget = self.cfg.token_capacity
        while self._waiting_list and len(self.running) < self.cfg.max_batch_size:
            seq = self._waiting_list[0]
            hashes = seq.blocks.sequence_hashes()
            # after a preemption the re-prefill covers generated tokens too
            cost = self.kv.try_schedule(
                hashes,
                len(seq.blocks),
                watermark=self.cfg.watermark,
                tokens_budget=budget,
            )
            if cost is None:
                if not self.running and budget == self.cfg.token_capacity:
                    # nothing running, full budget, and still unschedulable:
                    # the cache state is static, so this head can *never* be
                    # admitted -- fail it instead of spinning forever
                    self._waiting_list.pop(0)
                    self._emit_error(
                        seq,
                        f"request of {len(seq.blocks)} tokens "
                        f"({len(hashes) + 1} blocks) cannot be scheduled: "
                        f"capacity {self.kv.max_capacity} blocks, "
                        f"token budget {self.cfg.token_capacity}",
                    )
                    continue
                break
            self._waiting_list.pop(0)
            if not seq.stats_counted:
                seq.stats_counted = True
                self._prefix_lookups += 1
                if cost.cached_tokens > 0:
                    self._prefix_hits += 1
                self.obs.prefix_lookups.inc(len(seq.blocks))
                if cost.cached_tokens > 0:
                    self.obs.prefix_hits.inc(cost.cached_tokens)
            ok = self.kv.use(hashes + [seq.partial_id])
            if not ok:
                # should not happen (watermark guards admission)
                self._waiting_list.insert(0, seq)
                break
            seq.held = hashes + [seq.partial_id]
            seq.cost = cost
            seq.admitted_s = time.monotonic()
            self.running[seq.request_id] = seq
            self._note_synthetic_transfer(cost.new_tokens)
            budget -= cost.new_tokens

    def _note_synthetic_transfer(self, new_tokens: int) -> None:
        """Configured link model (``link_bandwidth_bytes_per_s > 0``):
        record the admission's fresh KV as one wire transfer into the
        per-engine transfer log -- honest ground truth for the fleet
        observatory's learned cost model, with zero added latency."""
        cfg = self.cfg
        if cfg.link_bandwidth_bytes_per_s <= 0 or new_tokens <= 0:
            return
        nbytes = new_tokens * cfg.kv_bytes_per_token
        seconds = cfg.link_setup_s + nbytes / cfg.link_bandwidth_bytes_per_s
        if cfg.link_jitter_frac:
            seconds *= 1.0 + cfg.link_jitter_frac * (2 * random.random() - 1)
        self.transfer_log.note(cfg.link_src, cfg.worker_id, nbytes, seconds)

    def telemetry_publisher(
        self, namespace=None, *, interval_s: float = 1.0, sink=None
    ):
        """A :class:`~dynamo_tpu_torch.runtime.telemetry.TelemetryPublisher`
        wired to this engine's identity, registry, and transfer log."""
        from ..runtime.telemetry import TelemetryPublisher

        return TelemetryPublisher(
            namespace,
            worker_id=self.cfg.worker_id,
            role=self.cfg.role,
            registry=self.registry,
            interval_s=interval_s,
            transfer_log=self.transfer_log,
            sink=sink,
        )

    def _plan_k(self) -> int:
        """Decode steps the next simulated dispatch fuses (the engine's
        ``_multistep_plan_k`` shape, device-free): anything waiting or
        still prefilling collapses K to single-token granularity so
        admission never stalls behind a fused block; a pressure-free tick
        returns the fixed K (``multistep_k > 1``) or ramps the adaptive
        one (``multistep_k == 0``) toward the engine's default ceiling."""
        cfg = self.cfg
        if cfg.multistep_k == 1:
            return 1
        pressure = bool(self._waiting_list) or any(
            not s.prefilled for s in self.running.values()
        )
        if pressure:
            self._ms_ramp = 1
            return 1
        if cfg.multistep_k > 1:
            return cfg.multistep_k
        k = self._ms_ramp
        self._ms_ramp = min(self._ms_ramp * 2, 8)
        return k

    async def _commit_generation(self, rids, k: int = 1) -> None:
        """Host commit of one simulated dispatch: generate (and fan out)
        the K tokens the dispatch covered for every lane its snapshot
        held.  Lanes cancelled/preempted since the snapshot simply skip,
        and a lane that finishes/preempts mid-block drops its remaining
        steps -- the mocker analog of the engine's stale-slot commit
        guards and K-block replay discard.  Token identity is K-invariant
        by construction: ``_next_token`` is a pure function of (prompt,
        num_generated)."""
        cfg = self.cfg
        for rid in rids:
            seq = self.running.get(rid)
            if seq is None:
                continue
            if not seq.prefilled:
                assert seq.cost is not None
                if cfg.prefill_s_per_compute:
                    await asyncio.sleep(
                        cfg.prefill_s_per_compute
                        * seq.cost.prefill_compute
                        / cfg.speedup_ratio
                    )
                seq.prefilled = True
            for _ in range(k):
                if self.running.get(rid) is not seq:
                    break  # finished or preempted mid-block: discard rest
                self._generate_one(seq)

    async def _simulate_tick(self, tick=None) -> None:
        cfg = self.cfg
        t0 = time.perf_counter()
        self.obs.observe_sched(len(self._waiting_list), len(self.running))
        self.obs.observe_kv(self.kv.num_active_blocks, self.kv.max_capacity)
        # decode time models HBM-bound KV reads over all active tokens;
        # a K-step fused dispatch sleeps K steps' worth in one launch
        k = self._plan_k()
        tick_s = cfg.decode_s_per_step * self.kv.num_active_blocks * k
        had_work = bool(self.running)
        # chaos plane: worker.slow injects deterministic per-step latency
        # into this worker's tick (delay= seconds x K fused steps); match=
        # on "worker-<id>" degrades exactly one worker, which is how
        # straggler detection/quarantine is driven from DYN_FAULTS
        from ..runtime import faults

        if (
            had_work
            and faults.injector.enabled
            and faults.injector.should_fire(
                "worker.slow", f"worker-{cfg.worker_id}"
            )
        ):
            tick_s += faults.injector.delay_s("worker.slow") * k
        if had_work and k not in self._minted_ks:
            self._minted_ks.add(k)
            compile_sentry.note_compilation(
                "packed_unified_multistep" if k > 1 else "packed_unified_step"
            )
        # double-buffered lanes: with simulated device time
        # armed, tick N's sleep starts BEFORE tick N-1's host commit runs
        # -- host work overlaps "device compute", dispatch gap collapses
        # to zero, exactly the engine pipeline's shape.  Unit-test mode
        # (decode_s_per_step == 0) and async_dispatch=False keep the
        # serial same-tick commit.
        pipelined = cfg.async_dispatch and (
            tick_s > 0 or self._inflight_tick is not None
        )
        if pipelined:
            if tick is not None and had_work:
                tick.note_dispatch("decode_block")
                tick.mark("dispatch")
            sleep_task = (
                asyncio.create_task(
                    asyncio.sleep(tick_s / cfg.speedup_ratio)
                )
                if had_work and tick_s > 0
                else None
            )
            prev = self._inflight_tick
            self._inflight_tick = (
                (sleep_task, list(self.running.keys()), k)
                if had_work
                else None
            )
            if prev is not None:
                prev_task, rids, prev_k = prev
                await self._commit_generation(rids, prev_k)
                if tick is not None:
                    tick.mark("commit")
                if prev_task is not None:
                    await prev_task
                if tick is not None:
                    tick.mark("device_wait")
                    # K-1 step boundaries of the fused block were
                    # device-internal: zero host-visible idle by
                    # construction (the engine commit notes the same)
                    for _ in range(prev_k - 1):
                        tick.note_zero_gap()
                    if self._inflight_tick is not None:
                        tick.note_zero_gap()
                    else:
                        self.profiler.note_results_ready()
            if self.running:
                self.obs.observe_step(
                    "decode_block", time.perf_counter() - t0
                )
            return
        if tick is not None and had_work:
            # the simulated batch "dispatches" here: phase bookkeeping
            # mirrors the real engine (generation = commit+fanout on
            # host, the decode sleep = device_wait)
            tick.note_dispatch("decode_block")
            tick.mark("dispatch")
        await self._commit_generation(list(self.running.keys()), k)
        if tick is not None and had_work:
            tick.mark("commit")
        if tick_s:
            await asyncio.sleep(tick_s / cfg.speedup_ratio)
        if tick is not None and had_work:
            tick.mark("device_wait")
            for _ in range(k - 1):
                tick.note_zero_gap()
            self.profiler.note_results_ready()
        if self.running:
            self.obs.observe_step(
                "decode_block", time.perf_counter() - t0
            )

    def _generate_one(self, seq: _MockSeq) -> None:
        # the mocker is single-threaded by declaration (its whole tick
        # plane is loop-resident); armed, the sentry proves it
        thread_sentry.assert_role(
            "event-loop", what="MockerEngine._generate_one"
        )
        token = self._next_token(seq)
        stop = seq.req.stop_conditions
        n_gen = seq.num_generated + 1
        min_ok = stop.min_tokens is None or n_gen >= stop.min_tokens
        hidden = stop.stop_token_ids_hidden or []
        if token in hidden and min_ok:
            return self._finish(seq, FinishReason.STOP)
        if token in seq.req.eos_token_ids and not stop.ignore_eos and min_ok:
            return self._finish(seq, FinishReason.EOS)

        completed = seq.blocks.append(token)
        seq.num_generated += 1
        self._tokens_generated += 1
        self.obs.tokens.inc()
        if not seq.slo_noted:
            seq.slo_noted = True
            if slo.tracker.enabled:
                now_m = time.monotonic()
                adm = seq.admitted_s or now_m
                slo.tracker.note_first_token(
                    seq.request_id,
                    queue_s=adm - seq.arrival_s,
                    service_s=now_m - adm,
                )
        out_of_room = False
        if completed is not None:
            # secure the next partial first; only then promote the completed
            # one (an unwound failure must leave partial bookkeeping intact)
            new_partial = _new_partial_id()
            if not self.kv.use([new_partial]):
                # out of blocks: preempt the oldest *other* running request;
                # if this sequence is the only one left, its own growth
                # exceeds the pool -- truncate gracefully rather than thrash
                victim = next(
                    (s for s in self.running.values() if s is not seq), seq
                )
                if victim is not seq:
                    seq.blocks.unwind(1)
                    seq.num_generated -= 1
                    self._tokens_generated -= 1
                    self._preempt(victim)
                    return
                out_of_room = True
                self.kv.promote(seq.partial_id, completed.sequence_hash)
                seq.held[-1] = completed.sequence_hash
            else:
                self.kv.promote(seq.partial_id, completed.sequence_hash)
                seq.held[-1] = completed.sequence_hash
                seq.partial_id = new_partial
                seq.held.append(new_partial)

        queue = self._queues.get(seq.request_id)
        if queue is not None:
            queue.put_nowait(
                Annotated.from_data(LLMEngineOutput(token_ids=[token]).to_dict())
            )
        if out_of_room or seq.num_generated >= seq.max_tokens:
            self._finish(seq, FinishReason.LENGTH)

    def _preempt(self, seq: _MockSeq) -> None:
        logger.debug("mocker preempting %s", seq.request_id)
        self.obs.preemptions.inc()
        self.running.pop(seq.request_id, None)
        self.kv.deref(seq.held)
        seq.held = []
        # restart from scratch with generated tokens folded into the blocks
        seq.partial_id = _new_partial_id()
        seq.prefilled = False
        seq.cost = None
        self._waiting_list.insert(0, seq)

    def _finish(self, seq: _MockSeq, reason: FinishReason) -> None:
        thread_sentry.assert_role("event-loop", what="MockerEngine._finish")
        seq.finish = reason
        self.running.pop(seq.request_id, None)
        self.kv.deref(seq.held)
        seq.held = []
        queue = self._queues.get(seq.request_id)
        if queue is not None:
            queue.put_nowait(
                Annotated.from_data(LLMEngineOutput.finished(reason).to_dict())
            )
            queue.put_nowait(None)

    def _emit_error(self, seq: _MockSeq, message: str) -> None:
        queue = self._queues.get(seq.request_id)
        if queue is not None:
            queue.put_nowait(Annotated.from_error(message))
            queue.put_nowait(None)
