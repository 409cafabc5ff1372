"""Disaggregated prefill/decode serving.

Reference architecture (examples/llm/components/worker.py:186-235 conditional
disagg decision, prefill_worker.py:139-207 queue consumer + KV write-back,
lib/llm/src/disagg_router.rs:25-90 policy): the decode worker owns the
request and its KV pages; long prefills are shipped to a pool of prefill
workers through a shared hub queue; the prefill worker computes the prompt
KV and writes it back into the decode worker's reserved pages, and decode
resumes.

The JAX package's ``llm/disagg.py`` (which loads JAX only to name dtypes),
copied for ``TorchEngine`` workers and wire-compatible with the JAX
package's both ways: the same queue items, hub keys, raw endpoint, frame
layout and blob bytes.  A delivery names its dtype as JAX does
(``bfloat16``, ``float32``, ``int8``); a bf16 blob's bytes are its values'
two bytes, held here as ``uint16`` (``kv_cache.wire_dtype``).  The
``CircuitBreaker`` takes a flight-recorder snapshot when it opens.  A
wire delivery is noted in the telemetry plane's transfer log
(``PrefillWorker._record_delivery``), so the worker's next snapshot carries
the link sample.

Transfer plane: the reference's NIXL one-sided RDMA write
(block_manager/storage/nixl.rs:173, block/transfer.rs) becomes a
peer-to-peer chunked upload over the request plane -- the prefill worker
copies its scratch pages to the host and streams the blob directly into the
decode worker's ``kv_deliver`` raw endpoint; the decode worker assembles
chunks into a preallocated host buffer as they arrive and scatters the
pages into the card's pool.  The hub carries only the queue item; bulk KV
never transits it.  When both workers share a process (and a card), the
blob is handed over on the device instead (``_LOCAL_DECODE``).

Wire pieces:

  * queue ``{ns}_prefill_queue``  -- serialized PreprocessedRequest + return
    address (decode component/instance)
  * raw endpoint ``kv_deliver``   -- chunked KV upload straight into the
    decode worker's engine (or an error notification, meta-only)
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import json
import logging
import os
import time
import weakref
from dataclasses import dataclass
from typing import Any, AsyncIterator, Dict, Iterator, Optional

import numpy as np
import torch

from ..engine.kv_cache import (
    QuantKV,
    blob_dtype_name,
    blob_shape,
    blob_to_host,
    host_view,
    pack_quant_blob_bytes,
    quant_blob_nbytes,
    unpack_quant_blob_bytes,
    wire_dtype,
)
from ..offload import KVStagingBuffer
from ..protocols.common import PreprocessedRequest
from ..runtime import faults
from ..runtime import metrics as rtm
from ..runtime import tracing
from ..runtime.component import Namespace, PushRouter
from ..runtime.engine import Annotated, AsyncEngineContext, Context
from ..runtime.transports.codec import ChunkAssembler, iter_chunk_frames
from ..runtime.utils import log_throttled

logger = logging.getLogger("dynamo.disagg")

PREFILL_QUEUE_SUFFIX = "_prefill_queue"  # reference {ns}_prefill_queue
KV_DELIVER_ENDPOINT = "kv_deliver"

# Hub key carrying a live DisaggConfig override for a namespace; decode
# workers watch it and hot-reload the routing policy (reference
# disagg_router.rs:38-90 watches the same concept in etcd).
DISAGG_CONF_KEY = "disagg/{ns}/router_conf"


def disagg_conf_key(namespace: str) -> str:
    return DISAGG_CONF_KEY.format(ns=namespace)

# Upload chunk size: large enough to amortize framing, comfortably under
# codec.MAX_FRAME, small enough that assembly overlaps the socket.
KV_CHUNK_BYTES = 8 * 1024 * 1024

# How long the decode side's queue-depth snapshot stays fresh.  One hub RTT
# per window instead of one per long request (the depth only gates a
# heuristic ship/local decision; sub-window staleness is harmless).
DEPTH_CACHE_TTL_S = 0.25

# Process-local decode-engine registry for same-process delivery: when the
# prefill worker and a decode worker share one process (one-host serving,
# colocated engine pairs), the KV blob is handed over as a device-resident
# tensor -- zero host transit, the analog of NIXL's device-to-device DMA
# (reference block_manager/storage/nixl.rs:173).  Keyed by (hub identity,
# namespace, component, instance) so two hubs in one process cannot collide;
# weak values so a stopped decode engine drops out instead of pinning.
_LOCAL_DECODE: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def _local_key(namespace: Namespace, component: str, instance_id: int):
    hub = namespace.runtime.hub
    hub_id = (getattr(hub, "host", None), getattr(hub, "port", None))
    if hub_id == (None, None):
        hub_id = id(hub)  # static mode: the hub object is the identity
    return (hub_id, namespace.name, component, int(instance_id))


@dataclass
class DisaggConfig:
    """Reference DisaggRouterConf + queue cap (disagg_router.rs:25-90,
    disagg_router.py)."""

    # prefills at most this long (after prefix-cache credit) run locally
    max_local_prefill_length: int = 512
    # stop shipping prefills when the queue is this deep (prefill pool is
    # saturated; local prefill beats queueing)
    max_prefill_queue_depth: int = 16


class DisaggMetrics:
    """Registry-backed disagg transfer-plane series (runtime/metrics.py);
    the Prometheus face of ``PrefillWorker.delivery_stats`` plus the decode
    side's placement counters.  Catalog: README "Observability"."""

    def __init__(self, registry: Optional[rtm.MetricsRegistry] = None) -> None:
        reg = registry or rtm.default_registry()
        self.transfer_bytes = reg.counter(
            "dynamo_disagg_transfer_bytes",
            "KV bytes delivered prefill->decode",
            ["path"],  # wire | device
        )
        self.transfer_latency = reg.histogram(
            "dynamo_disagg_transfer_seconds",
            "KV delivery (upload or device handoff) latency",
            ["path"],
            buckets=rtm.TRANSFER_LATENCY_BUCKETS,
        )
        self.export_latency = reg.histogram(
            "dynamo_disagg_export_seconds",
            "Prefill KV export latency before the first byte hits the wire",
            buckets=rtm.TRANSFER_LATENCY_BUCKETS,
        )
        self.overlap_ratio = reg.histogram(
            "dynamo_disagg_overlap_ratio",
            "Fraction of export materialization overlapped with transfer "
            "(0 = monolithic, -> 1 = fully pipelined)",
            buckets=rtm.RATIO_BUCKETS,
        )
        self.prefills = reg.counter(
            "dynamo_disagg_prefills",
            "Prefill placement decisions on the decode worker",
            ["target"],  # local | remote
        )
        self.queue_depth = reg.gauge(
            "dynamo_disagg_prefill_queue_depth",
            "Last observed shared prefill queue depth",
        )
        self.breaker_state = reg.gauge(
            "dynamo_disagg_breaker_state",
            "Remote-prefill circuit breaker state "
            "(0 closed, 1 open, 2 half-open)",
        )
        self.breaker_events = reg.counter(
            "dynamo_disagg_breaker_events",
            "Remote-prefill circuit breaker events",
            ["event"],  # open | close | half_open | fallback
        )


class CircuitBreaker:
    """Closed/open/half-open breaker on the remote-prefill path.

    Remote prefill is an *optimization*: when the hub queue is failing
    (enqueue errors) or saturating (enqueue latency past the breach
    threshold), shipping more work there hurts every request.  After
    ``failure_threshold`` consecutive breaches the breaker opens: requests
    run local aggregated prefill with zero hub traffic for ``open_s``.
    Then one half-open probe is let through; success closes the breaker,
    failure re-opens it.

    Env knobs: ``DYN_BREAKER_FAILURES``, ``DYN_BREAKER_OPEN_S``,
    ``DYN_BREAKER_MAX_ENQUEUE_S``."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"
    _STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

    def __init__(
        self,
        failure_threshold: Optional[int] = None,
        open_s: Optional[float] = None,
        max_enqueue_latency_s: Optional[float] = None,
        obs: Optional[DisaggMetrics] = None,
    ) -> None:
        if failure_threshold is None:
            failure_threshold = int(os.environ.get("DYN_BREAKER_FAILURES", "3"))
        if open_s is None:
            open_s = float(os.environ.get("DYN_BREAKER_OPEN_S", "5"))
        if max_enqueue_latency_s is None:
            max_enqueue_latency_s = float(
                os.environ.get("DYN_BREAKER_MAX_ENQUEUE_S", "1")
            )
        self.failure_threshold = failure_threshold
        self.open_s = open_s
        self.max_enqueue_latency_s = max_enqueue_latency_s
        self.state = self.CLOSED
        self.obs = obs
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False

    def _transition(self, state: str) -> None:
        if state == self.state:
            return
        logger.warning(
            "remote-prefill circuit breaker: %s -> %s", self.state, state
        )
        prev = self.state
        self.state = state
        if self.obs is not None:
            self.obs.breaker_state.set(self._STATE_CODE[state])
            self.obs.breaker_events.labels(state).inc()
        if state == self.OPEN:
            # breaker-open is a fleet-health edge: snapshot the flight
            # recorder so the postmortem has the tick ring and queue state
            # from the moment the remote path went dark
            from ..runtime import profiling

            profiling.flight_recorder.snapshot(
                "breaker_open", previous_state=prev
            )

    def allow(self) -> bool:
        """May a request take the remote path right now?"""
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN:
            if time.monotonic() - self._opened_at < self.open_s:
                return False
            self._transition(self.HALF_OPEN)
        # half-open: exactly one probe in flight at a time
        if self._probe_inflight:
            return False
        self._probe_inflight = True
        return True

    def release_probe(self) -> None:
        """The caller took the probe slot but never attempted the remote
        path (admission failed, engine raised): free the slot with NO
        verdict -- only a real enqueue outcome may move the state."""
        self._probe_inflight = False

    def record_success(self) -> None:
        self._probe_inflight = False
        self._consecutive_failures = 0
        if self.state != self.CLOSED:
            self._transition(self.CLOSED)

    def record_failure(self) -> None:
        self._probe_inflight = False
        self._consecutive_failures += 1
        if (
            self.state == self.HALF_OPEN
            or self._consecutive_failures >= self.failure_threshold
        ):
            self._opened_at = time.monotonic()
            self._transition(self.OPEN)


class DisaggRouter:
    """Local-vs-remote prefill policy (reference disagg_router.py:66)."""

    def __init__(self, cfg: Optional[DisaggConfig] = None) -> None:
        self.cfg = cfg or DisaggConfig()

    def prefill_remote(
        self, prefill_length: int, prefix_hit_length: int, queue_depth: int
    ) -> bool:
        effective = prefill_length - prefix_hit_length
        return (
            effective > self.cfg.max_local_prefill_length
            and queue_depth < self.cfg.max_prefill_queue_depth
        )


class PrefillQueue:
    """Hub work queue facade (reference utils/nats_queue.py:24-56)."""

    def __init__(self, namespace: Namespace) -> None:
        self.hub = namespace.runtime.hub
        self.name = f"{namespace.name}{PREFILL_QUEUE_SUFFIX}"

    async def enqueue(self, msg: Dict[str, Any]) -> None:
        await self.hub.queue_push(self.name, json.dumps(msg).encode())

    async def dequeue(self, block: bool = True) -> Optional[Dict[str, Any]]:
        payload = await self.hub.queue_pop(self.name, block=block)
        return json.loads(payload) if payload is not None else None

    async def depth(self) -> int:
        return await self.hub.queue_depth(self.name)


def _queue_deadline_expired(msg: Dict[str, Any]) -> bool:
    """Did this queue item's deadline budget die while it waited?  The
    item carries (remaining_s, wall-clock enqueue time); coarse cross-host
    wall skew is acceptable for multi-second budgets."""
    dl = msg.get("deadline")
    if not isinstance(dl, dict):
        return False
    try:
        elapsed = time.time() - float(dl.get("wall", 0.0))
        return elapsed >= float(dl.get("remaining_s", 0.0))
    except (TypeError, ValueError):
        return False


def _blob_chunks(blob: np.ndarray) -> Iterator[bytes]:
    """Yield the blob's bytes in KV_CHUNK_BYTES slices.

    One ``tobytes`` copy total -- it emits C-order bytes even from a
    non-contiguous view (the batch-export results are slices into the group
    transfer).  The per-chunk slices are zero-copy memoryviews over it.
    """
    yield from _byte_chunks(blob.tobytes())


def _byte_chunks(raw: bytes) -> Iterator[bytes]:
    """KV_CHUNK_BYTES slices over pre-packed bytes (the one chunking
    loop; :func:`_blob_chunks` and the quantized-blob wire form --
    data followed by row scales -- both route through it)."""
    view = memoryview(raw)
    for off in range(0, len(view), KV_CHUNK_BYTES):
        yield view[off : off + KV_CHUNK_BYTES]
    if not len(view):
        yield b""


def _to_host(blob: Any) -> Any:
    """A device blob (either form) as a host blob: bf16 as ``uint16``."""
    if isinstance(blob, QuantKV):
        return QuantKV(q=host_view(blob.q.cpu()), s=host_view(blob.s.cpu()))
    return host_view(blob.cpu())


class DisaggDecodeEngine:
    """Decode-worker serving engine: conditionally ships prefills.

    Serve this (instead of the engine) on the worker's ``generate`` endpoint
    and attach :meth:`kv_deliver_handler` via ``serve_raw`` on the
    ``kv_deliver`` endpoint.
    """

    def __init__(
        self,
        engine,  # TorchEngine (generate / generate_external / deliver_external)
        namespace: Namespace,
        component_name: str,
        instance_id: int,
        cfg: Optional[DisaggConfig] = None,
        block_size: int = 16,
    ) -> None:
        self.engine = engine
        self.namespace = namespace
        self.component_name = component_name
        self.instance_id = instance_id
        self.router = DisaggRouter(cfg)
        self.queue = PrefillQueue(namespace)
        self.block_size = block_size
        # observability: how many prefills went remote vs local
        self.remote_prefills = 0
        self.local_prefills = 0
        self.obs = DisaggMetrics()
        # graceful degradation: enqueue failures / latency breaches open
        # the breaker and prefills run locally instead of hard-failing
        self.breaker = CircuitBreaker(obs=self.obs)
        self._depth_at = -1e9  # monotonic time of the last depth fetch
        self._depth = 0
        # same-process delivery fast path (see _LOCAL_DECODE)
        _LOCAL_DECODE[
            _local_key(namespace, component_name, instance_id)
        ] = engine
        self._conf_watch = None
        self._conf_task: Optional[asyncio.Task] = None

    async def start_config_watch(self) -> None:
        """Hot-reload the routing policy from the hub (reference
        disagg_router.rs:38-90: etcd watch on the router conf).  An operator
        updates the key (``dynamo-tpu disagg-conf``) and every decode
        worker's local/remote threshold follows without restarts."""
        self._conf_watch = await self.namespace.runtime.hub.watch_prefix(
            disagg_conf_key(self.namespace.name)
        )
        for _key, value in self._conf_watch.snapshot:
            self._apply_conf(value)
        self._conf_task = asyncio.create_task(
            self._conf_loop(), name="disagg-conf-watch"
        )

    async def stop_config_watch(self) -> None:
        if self._conf_task is not None:
            self._conf_task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._conf_task
            self._conf_task = None
        if self._conf_watch is not None:
            with contextlib.suppress(Exception):
                await self._conf_watch.close()
            self._conf_watch = None

    async def _conf_loop(self) -> None:
        assert self._conf_watch is not None
        with contextlib.suppress(asyncio.CancelledError):
            while True:
                ev = await self._conf_watch.events.get()
                if ev.type == "put":
                    self._apply_conf(ev.value)

    def _apply_conf(self, raw: bytes) -> None:
        # parse + validate EVERY field before assigning any: a conf update
        # with one good and one malformed field must be ignored whole, not
        # half-applied while the log claims it was ignored
        try:
            d = json.loads(raw)
            updates = {}
            if "max_local_prefill_length" in d:
                updates["max_local_prefill_length"] = int(
                    d["max_local_prefill_length"]
                )
            if "max_prefill_queue_depth" in d:
                updates["max_prefill_queue_depth"] = int(
                    d["max_prefill_queue_depth"]
                )
        except Exception:
            logger.exception("malformed disagg conf update ignored")
            return
        cfg = self.router.cfg
        for field_name, value in updates.items():
            setattr(cfg, field_name, value)
        logger.info(
            "disagg conf reloaded: max_local_prefill_length=%d "
            "max_prefill_queue_depth=%d",
            cfg.max_local_prefill_length, cfg.max_prefill_queue_depth,
        )

    async def _queue_depth(self) -> int:
        """Queue depth with a short-TTL cache: the ship/local heuristic
        tolerates DEPTH_CACHE_TTL_S of staleness; a hub RTT per request on
        the hot path does not (one hub round trip per long request
        otherwise)."""
        now = time.monotonic()
        if now - self._depth_at > DEPTH_CACHE_TTL_S:
            try:
                self._depth = await self.queue.depth()
            except Exception:
                # force local on hub trouble -- and say so: every request
                # silently running local prefill is a capacity regression
                # someone must be able to see (throttled: this fires per
                # request window while the hub is down)
                log_throttled(
                    logger, "disagg-depth",
                    "prefill queue depth unavailable (hub unreachable?); "
                    "forcing local prefill", exc_info=True,
                )
                self._depth = self.router.cfg.max_prefill_queue_depth
            self._depth_at = now
        return self._depth

    async def generate(self, request: Context[Any]) -> AsyncIterator[Annotated]:
        data = request.data
        req = (
            PreprocessedRequest.from_dict(data) if isinstance(data, dict) else data
        )
        prefix_hit_tokens = (
            (req.estimated_prefix_hit_num_blocks or 0) * self.block_size
        )
        effective = len(req.token_ids) - prefix_hit_tokens
        if effective <= self.router.cfg.max_local_prefill_length:
            # short prefill can only run locally: skip the hub round trip
            # for the queue depth on the request hot path
            self.local_prefills += 1
            self.obs.prefills.labels("local").inc()
            return await self.engine.generate(request)
        depth = await self._queue_depth()
        self.obs.queue_depth.set(depth)
        if not self.router.prefill_remote(
            len(req.token_ids), prefix_hit_tokens, depth
        ):
            self.local_prefills += 1
            self.obs.prefills.labels("local").inc()
            return await self.engine.generate(request)
        if not self.breaker.allow():
            # breaker open: the remote path is known-bad right now -- run
            # the prefill locally with zero hub traffic instead of failing
            self.local_prefills += 1
            self.obs.prefills.labels("local").inc()
            self.obs.breaker_events.labels("fallback").inc()
            return await self.engine.generate(request)

        try:
            stream = await self.engine.generate_external(request)
        except BaseException:
            # no remote attempt happened: free a half-open probe slot
            # verdict-free so the breaker can still probe later
            self.breaker.release_probe()
            raise
        if not self.engine.awaiting_external(request.id):
            # admission failed (e.g. prompt > max_seq_len): the stream already
            # carries the error; don't waste a prefill worker on it.  This is
            # NOT a hub-probe outcome -- release the slot without a verdict.
            self.breaker.release_probe()
            self.local_prefills += 1
            self.obs.prefills.labels("local").inc()
            return stream
        msg = {
            "request_id": request.id,
            "request": req.to_dict(),
            "decode_component": self.component_name,
            "decode_instance": self.instance_id,
        }
        # thread the trace context through the hub-queue hop so the
        # prefill worker's spans link under this request's tree
        trace = tracing.wire_context(request.id)
        if trace:
            msg["trace"] = trace
        # the deadline budget rides the queue item too: a job whose budget
        # died on the queue is dropped by the prefill worker, and the
        # decode-side lane fails fast (pages freed) via its error notice
        rem = request.ctx.deadline_remaining()
        if rem is not None:
            msg["deadline"] = {
                "remaining_s": round(rem, 4), "wall": time.time(),
            }
        t0 = time.monotonic()
        try:
            if faults.injector.enabled and faults.injector.should_fire(
                "disagg.enqueue_fail", request.id
            ):
                raise faults.InjectedFault("injected enqueue failure")
            await self.queue.enqueue(msg)
        except Exception as e:  # noqa: BLE001 - degrade, don't hard-fail
            # graceful degradation: unpark the admitted lane (slot + pages
            # released), count the breach, and serve the request with LOCAL
            # aggregated prefill -- an unreachable hub must cost capacity,
            # not correctness
            self.breaker.record_failure()
            self.engine.fail_external(
                request.id, f"failed to enqueue remote prefill: {e}"
            )
            aclose = getattr(stream, "aclose", None)
            if aclose is not None:
                with contextlib.suppress(Exception):
                    await aclose()
            log_throttled(
                logger, "disagg-enqueue",
                "remote prefill enqueue failed (%s); falling back to local "
                "prefill", e,
            )
            self.local_prefills += 1
            self.obs.prefills.labels("local").inc()
            self.obs.breaker_events.labels("fallback").inc()
            return await self.engine.generate(request)
        except BaseException:
            # cancellation mid-enqueue: not a verdict on the hub -- free
            # the probe slot so the breaker can still probe later
            self.breaker.release_probe()
            raise
        if time.monotonic() - t0 > self.breaker.max_enqueue_latency_s:
            self.breaker.record_failure()  # queue-latency breach
        else:
            self.breaker.record_success()
        self.remote_prefills += 1
        self.obs.prefills.labels("remote").inc()
        self._depth += 1  # keep the cached snapshot roughly honest
        return stream

    async def _kv_deliver(
        self,
        hdr: Dict[str, Any],
        chunks: AsyncIterator[bytes],
        ctx: AsyncEngineContext,
    ) -> AsyncIterator[bytes]:
        """Raw ``kv_deliver`` handler: assemble the chunked KV upload into a
        preallocated host buffer and unpark the lane.  Assembly overlaps the
        sender's socket writes; the device scatter happens on the engine's
        executor at the next tick."""
        del ctx
        meta = hdr.get("meta") or {}
        rid = meta["request_id"]
        if "kv_shards" in meta:
            # a sharded JAX prefill pool's blob is full-width regardless of
            # its mesh (per-shard slices reassemble at export), so the
            # port's unsharded pool takes it as it is -- surfaced for
            # operators diagnosing cross-mesh prefill/decode pools
            logger.debug(
                "cross-mesh KV delivery for %s: prefill shards %s, decode "
                "pool unsharded", rid, meta["kv_shards"],
            )
        ok = False
        if meta.get("error"):
            # prefill worker reporting failure: fail the parked lane now
            # instead of riding out the delivery timeout
            async for _chunk in chunks:
                pass
            ok = self.engine.fail_external(rid, str(meta["error"]))
        elif meta.get("chunked"):
            ok = await self._kv_deliver_chunked(rid, meta, chunks)
        else:
            shape = tuple(int(s) for s in meta["shape"])
            quant = meta["dtype"] == "int8"
            if quant:
                # quantized wire form: data bytes then f32 row scales
                # (kv_cache.pack_quant_blob_bytes); extents derive from
                # (shape, dtype) on both ends
                flat = np.empty((quant_blob_nbytes(shape),), np.uint8)
                buf = None
            else:
                # bfloat16 lands as its uint16 bits
                buf = np.empty(shape, wire_dtype(meta["dtype"]))
                flat = buf.view(np.uint8).reshape(-1)
            size = flat.size
            off = 0
            truncated = False
            async for chunk in chunks:
                n = len(chunk)
                if truncated:
                    # drain: stopping mid-upload would stall the connection
                    # read loop on the bounded chunk queue
                    continue
                if off + n > size:
                    truncated = True  # oversized: sender/receiver disagree
                    continue
                flat[off : off + n] = np.frombuffer(chunk, np.uint8)
                off += n
            if truncated or off != size:
                # connection died mid-upload (the chunk iterator terminates
                # on peer loss) or a geometry mismatch: fail fast, don't
                # scatter garbage
                self.engine.fail_external(
                    rid,
                    f"KV delivery truncated: got {off} of {size} bytes",
                )
            else:
                if quant:
                    # zero-copy: the delivered pair aliases the landing
                    # buffer (multi-GB blobs must not double on receive)
                    buf = unpack_quant_blob_bytes(flat, shape)
                lp_row = meta.get("lp_row")
                ok = self.engine.deliver_external(
                    rid, buf, int(meta["first_token"]),
                    np.asarray(lp_row, np.int32) if lp_row else None,
                )

        yield json.dumps({"ok": ok}).encode()

    async def _kv_deliver_chunked(
        self, rid: str, meta: Dict[str, Any], chunks: AsyncIterator[bytes]
    ) -> bool:
        """Pipelined delivery leg: each wire frame carries (chunk index,
        byte offset, payload); bytes land in a preallocated host buffer as
        they arrive (out-of-order chunks welcome), and every COMPLETED
        layer-group chunk is staged into the engine immediately -- the
        decode-side pages fill while later chunks are still on the wire.
        The engine holds the completion barrier: the first decode step
        waits for every layer plus the final commit."""
        cm = meta["chunked"]
        error: Optional[str] = None
        begun = False
        spans: list = []
        staging = asm = None
        try:
            dtype = str(meta["dtype"])  # the wire name; bfloat16 lands as uint16
            shape = tuple(int(s) for s in meta["shape"])
            spans = [(int(a), int(b)) for a, b in cm["layers"]]
            # spans must tile [0, L) disjointly in order: duplicate or
            # gapped spans could sum to L layers while leaving some layer
            # never written, and the engine's applied-layer barrier counts,
            # it does not track coverage
            expect_lo = 0
            for lo, hi in spans:
                if lo != expect_lo or hi <= lo:
                    raise ValueError(
                        f"layer spans {spans} do not tile [0, {shape[0]})"
                    )
                expect_lo = hi
            if expect_lo != shape[0]:
                raise ValueError(
                    f"layer spans {spans} do not tile [0, {shape[0]})"
                )
            staging = KVStagingBuffer.for_layer_spans(shape, dtype, spans)
            if int(cm.get("total_bytes", staging.flat.size)) != staging.flat.size:
                raise ValueError(
                    f"sender claims {cm['total_bytes']} bytes, geometry "
                    f"holds {staging.flat.size}"
                )
            asm = ChunkAssembler(staging.memoryview, staging.bounds)
            begun = self.engine.begin_external_chunked(rid, shape, dtype)
        except (ValueError, KeyError, TypeError) as e:
            error = str(e)
        async for chunk in chunks:
            if error is not None:
                # drain: stopping mid-upload would stall the connection
                # read loop on the bounded chunk queue
                continue
            try:
                for done_idx in asm.add(chunk):
                    if begun:
                        lo, hi = spans[done_idx]
                        # a view into the staging buffer: the completed
                        # chunk's bytes never change again
                        self.engine.deliver_external_chunk(
                            rid, lo, hi, staging.layer_slice(lo, hi)
                        )
            except ValueError as e:
                error = str(e)
        if error is not None:
            return self.engine.fail_external(
                rid, f"chunked KV delivery rejected: {error}"
            )
        if not asm.complete:
            # connection died mid-upload (the chunk iterator terminates on
            # peer loss): fail fast, don't commit a half-filled cache
            return self.engine.fail_external(
                rid,
                f"KV delivery truncated: got {asm.received_bytes} of "
                f"{staging.flat.size} bytes",
            )
        if not begun:
            return False  # request no longer waiting (cancelled/failed)
        lp_row = meta.get("lp_row")
        return self.engine.commit_external_chunked(
            rid,
            int(meta["first_token"]),
            np.asarray(lp_row, np.int32) if lp_row else None,
        )

    def kv_deliver_handler(self):
        """Raw handler for ``Endpoint.serve_raw`` on ``kv_deliver``."""

        async def handler(hdr, chunks, ctx):
            return self._kv_deliver(hdr, chunks, ctx)

        return handler


class PrefillWorker:
    """Queue consumer: prefill remotely-shipped prompts and deliver their KV
    peer-to-peer (reference prefill_worker.py:139-207).

    Drains bursts from the queue into one batched engine dispatch
    (``prefill_export_batch``) and uploads each result concurrently, so N
    queued prefills cost one padded prefill dispatch + one device->host
    copy instead of N of each.
    """

    def __init__(
        self,
        engine,
        namespace: Namespace,
        max_batch: int = 8,
        allow_local: bool = True,
        chunked: bool = True,
        layers_per_chunk: Optional[int] = None,
    ) -> None:
        self.engine = engine
        self.namespace = namespace
        self.queue = PrefillQueue(namespace)
        self.max_batch = max_batch
        self.allow_local = allow_local  # same-process device handoff opt-out
        # chunked wire path: stream layer-group chunks as they materialize
        # (export overlaps transfer); False forces the legacy monolithic
        # blob upload.  layers_per_chunk pins the chunk granularity (None =
        # engine default, ~DEFAULT_EXPORT_CHUNKS groups).
        self.chunked = chunked and hasattr(
            engine, "prefill_export_batch_stream"
        )
        if layers_per_chunk is not None and layers_per_chunk <= 0:
            # fail at startup, not per-request inside the export fallback
            raise ValueError(
                f"layers_per_chunk must be positive, got {layers_per_chunk}"
            )
        self.layers_per_chunk = layers_per_chunk
        self.prefills_done = 0
        self.local_deliveries = 0  # same-process device handoffs
        self._task: Optional[asyncio.Task] = None
        self._clients: Dict[str, PushRouter] = {}
        # per-delivery transfer instrumentation (separates transfer-plane
        # cost from chip contention): bytes moved, amortized export
        # (dispatch+compute+materialize) ms, upload/handoff ms
        self.delivery_stats: "collections.deque" = collections.deque(
            maxlen=512
        )
        self.obs = DisaggMetrics()

    def _record_delivery(self, row: Dict[str, Any]) -> None:
        """One delivery's stats -> the local deque AND the registry (the
        Prometheus face of the same numbers the bench surface reads)."""
        self.delivery_stats.append(row)
        path = row["path"]
        self.obs.transfer_bytes.labels(path).inc(row["bytes"])
        self.obs.transfer_latency.labels(path).observe(
            row["deliver_ms"] / 1e3
        )
        self.obs.export_latency.observe(row["export_ms"] / 1e3)
        if "overlap_ratio" in row:
            self.obs.overlap_ratio.observe(row["overlap_ratio"])
        # fleet plane: dst-attributed wire transfers feed the observatory's
        # per-(src, dst) link model via the next telemetry snapshot
        if path == "wire" and "dst" in row:
            from ..runtime import telemetry

            telemetry.note_transfer(
                src=self.namespace.runtime.primary_lease,
                dst=row["dst"],
                nbytes=row["bytes"],
                seconds=row["deliver_ms"] / 1e3,
            )

    def transfer_stats(self) -> Dict[str, Any]:
        """Percentile summary of the recorded deliveries (bench/metrics
        surface): separates transfer-plane cost (deliver_ms, bytes) from
        prefill compute (export_ms) per path."""

        def pct(vals, p):
            if not vals:
                return None
            s = sorted(vals)
            return round(s[min(int(p * (len(s) - 1) + 0.5), len(s) - 1)], 2)

        out: Dict[str, Any] = {"deliveries": len(self.delivery_stats)}
        for path in ("wire", "device"):
            rows = [r for r in self.delivery_stats if r["path"] == path]
            if not rows:
                continue
            out[path] = {
                "count": len(rows),
                "bytes_p50": pct([r["bytes"] for r in rows], 0.5),
                "deliver_ms_p50": pct([r["deliver_ms"] for r in rows], 0.5),
                "deliver_ms_p99": pct([r["deliver_ms"] for r in rows], 0.99),
                "export_ms_p50": pct([r["export_ms"] for r in rows], 0.5),
                # chunked-path pipeline metrics (absent rows = legacy path)
                "export_total_ms_p50": pct(
                    [r["export_total_ms"] for r in rows
                     if "export_total_ms" in r], 0.5,
                ),
                "overlap_ratio_p50": pct(
                    [r["overlap_ratio"] for r in rows
                     if "overlap_ratio" in r], 0.5,
                ),
                "chunks_p50": pct(
                    [r["chunks"] for r in rows if "chunks" in r], 0.5
                ),
            }
        return out

    async def start(self) -> None:
        self._task = asyncio.create_task(self._loop(), name="prefill-worker")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._task
            self._task = None
        for router in self._clients.values():
            with contextlib.suppress(Exception):
                await router.client.close()
        self._clients.clear()

    async def _loop(self) -> None:
        while True:
            try:
                msg = await self.queue.dequeue(block=True)
                if msg is None:
                    continue
                batch = [msg]
                # burst drain: whatever else is already queued rides the
                # same dispatch (non-blocking pops)
                while len(batch) < self.max_batch:
                    extra = await self.queue.dequeue(block=False)
                    if extra is None:
                        break
                    batch.append(extra)
                await self._process_batch(batch)
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("prefill worker failed on a queue batch")
                # a persistent fault (hub down, conn refused) must not spin
                # the loop hot re-raising the same error
                await asyncio.sleep(0.5)

    def _local_engine(self, msg: Dict[str, Any]):
        if not self.allow_local:
            return None
        return _LOCAL_DECODE.get(
            _local_key(
                self.namespace,
                msg["decode_component"],
                int(msg["decode_instance"]),
            )
        )

    async def _process_batch(self, batch: list) -> None:
        # per-item decode: one malformed queue item must fail alone, not
        # discard its batch-mates (their lanes would ride out the delivery
        # timeout holding slots + pages)
        parsed: list = []
        for msg in batch:
            try:
                # validate the return address too: _deliver and the locality
                # probe both dereference it, and one malformed item must not
                # abort the batch
                _ = (msg["decode_component"], int(msg["decode_instance"]))
                if _queue_deadline_expired(msg):
                    # budget died on the queue: skip the prefill, tell the
                    # decode side now so its parked lane frees slot + pages
                    parsed.append(
                        TimeoutError("deadline exceeded before remote prefill")
                    )
                    continue
                parsed.append(PreprocessedRequest.from_dict(msg["request"]))
            except Exception as e:  # noqa: BLE001
                logger.exception("malformed prefill queue item")
                parsed.append(e)
        good = [i for i, p in enumerate(parsed) if not isinstance(p, Exception)]
        results: list = list(parsed)
        # device-resident export when every target decode engine lives in
        # this process (colocated serving): the blob never touches the host
        all_local = bool(good) and all(
            self._local_engine(batch[i]) is not None for i in good
        )
        export_ms_per_item = 0.0
        if good:
            t0 = time.perf_counter()
            try:
                if not all_local and self.chunked:
                    # chunked wire path: streams come back BEFORE any blob
                    # materializes; per-delivery export timing rides the
                    # stream's own first/last-chunk timestamps
                    exported = await self.engine.prefill_export_batch_stream(
                        [parsed[i] for i in good], self.layers_per_chunk
                    )
                    for res in exported:
                        if not isinstance(res, Exception):
                            res.started_at = t0
                else:
                    exported = await self.engine.prefill_export_batch(
                        [parsed[i] for i in good], device=all_local
                    )
            except Exception as e:  # noqa: BLE001 - engine-wide failure
                logger.exception("prefill export batch failed")
                exported = [e] * len(good)
            export_ms_per_item = (
                (time.perf_counter() - t0) * 1000.0 / max(len(good), 1)
            )
            for i, res in zip(good, exported):
                results[i] = res
        # deliver concurrently: uploads to distinct decode workers ride
        # distinct connections; to the same worker they multiplex
        await asyncio.gather(
            *[
                self._deliver_traced(msg, res, export_ms_per_item)
                for msg, res in zip(batch, results)
            ],
            return_exceptions=True,
        )

    async def _deliver_traced(
        self, msg: Dict[str, Any], result: Any, export_ms: float
    ) -> None:
        """Delivery wrapped in a span linked (via the trace context the
        decode worker put in the queue item) under the originating
        request's tree -- the 'prefill worker' leg of the frontend ->
        router -> prefill -> decode timeline."""
        parent = None
        if tracing.collector.enabled:
            parent = tracing.TraceContext.from_wire(msg.get("trace"))
        with tracing.span(
            "prefill.deliver",
            str(msg.get("request_id", "")),
            parent=parent,
            error=isinstance(result, Exception),
        ):
            await self._deliver(msg, result, export_ms)

    async def _deliver(
        self, msg: Dict[str, Any], result: Any, export_ms: float = 0.0
    ) -> None:
        rid = msg["request_id"]
        if isinstance(result, Exception):
            # tell the decode worker so its parked lane fails immediately
            # (the decode-side timeout is only the backstop for lost items)
            logger.error("prefill failed for request %s: %s", rid, result)
            local = self._local_engine(msg)
            if local is not None:
                local.fail_external(rid, str(result))
                return
            try:
                await self._upload(
                    msg, {"request_id": rid, "error": str(result)}, iter(())
                )
            except Exception:
                # the lane now rides out the delivery timeout; leave a trace
                logger.exception(
                    "error notification failed for request %s", rid
                )
            return
        if not isinstance(result, tuple):
            # chunked export stream: layer-group chunks go on the wire as
            # they materialize
            await self._deliver_stream(msg, result)
            return
        blob, row = result  # row: packed [2 + 2N] (token | logprob | tops)
        first = int(np.asarray(row).reshape(-1)[0])
        lp_row = [int(x) for x in np.asarray(row).reshape(-1)]
        local = self._local_engine(msg)
        quant = isinstance(blob, QuantKV)
        on_device = isinstance(blob.q if quant else blob, torch.Tensor)
        t0 = time.perf_counter()
        if local is not None and on_device:
            # same-process handoff: the device-resident blob (or quantized
            # pair) goes straight into the decode engine's delivery queue;
            # the scatter is a device-to-device copy at its next tick
            self.local_deliveries += 1
            local.deliver_external(
                rid, blob, first, np.asarray(lp_row, np.int32)
            )
            nbytes = blob.nbytes
            path = "device"
        else:
            if on_device:
                # a device export whose decode target left the process:
                # it still ships over the wire
                blob = await asyncio.to_thread(_to_host, blob)
            meta = {
                "request_id": rid,
                "dtype": blob_dtype_name(blob),
                "shape": list(blob_shape(blob)),
                "first_token": first,
                "lp_row": lp_row,
            }
            shards = getattr(getattr(self.engine, "kv", None), "shard_geometry", None)
            if shards is not None:
                # a tensor-parallel prefill pool's geometry: the blob is
                # full width all the same (JAX's provenance key)
                meta["kv_shards"] = shards
            if quant:
                # int8 export: the wire carries data bytes then the f32
                # row scales (the pack_quant_blob_bytes layout, streamed
                # as two buffer-protocol views so no (q+s)-sized concat
                # buffer ever materializes); the receiver re-derives both
                # extents from (shape, dtype)
                import itertools

                blob = blob_to_host(blob)
                q_arr = np.ascontiguousarray(blob.q)
                s_arr = np.ascontiguousarray(blob.s, np.float32)
                chunks_iter = itertools.chain(
                    _byte_chunks(q_arr.reshape(-1).view(np.uint8)),
                    _byte_chunks(s_arr.reshape(-1).view(np.uint8)),
                )
                nbytes = q_arr.nbytes + s_arr.nbytes
            else:
                chunks_iter = _blob_chunks(blob)
                nbytes = blob.nbytes
            try:
                if faults.injector.enabled:
                    await faults.injector.maybe_delay("disagg.slow_export", rid)
                await self._upload(msg, meta, chunks_iter)
            except Exception:
                logger.exception("KV delivery failed for request %s", rid)
                raise
            path = "wire"
        deliver_ms = (time.perf_counter() - t0) * 1000.0
        self._record_delivery(
            {
                "path": path,
                "dst": int(msg["decode_instance"]),
                "bytes": nbytes,
                "export_ms": export_ms,
                "deliver_ms": deliver_ms,
            }
        )
        self.prefills_done += 1
        prompt_tokens = len((msg.get("request") or {}).get("token_ids") or ())
        logger.info(
            "prefilled %d tokens for %s -> %s/%d: %s %d bytes in %.3f ms",
            # the true prompt length, not the page-padded blob capacity
            prompt_tokens or blob_shape(blob)[2] * blob_shape(blob)[3], rid,
            msg["decode_component"], int(msg["decode_instance"]), path, nbytes,
            deliver_ms,
        )

    async def _deliver_stream(self, msg: Dict[str, Any], stream) -> None:
        """Upload a chunked export: frame each layer-group chunk with its
        index + absolute byte offset (codec.encode_chunk_frame) and send it
        the moment it lands on host -- chunk i rides the socket while chunk
        i+1 is still in device->host flight.  A same-process decode target
        takes the wire too: the chunked path exists to pipeline the host
        transit that the device handoff never pays."""
        rid = msg["request_id"]
        row = np.asarray(stream.row).reshape(-1)
        bounds = stream.chunk_bounds
        meta = {
            "request_id": rid,
            "dtype": stream.dtype,
            "shape": list(stream.shape),
            "first_token": int(row[0]),
            "lp_row": [int(x) for x in row],
            "chunked": {
                "layers": [list(s) for s in stream.spans],
                "total_bytes": stream.nbytes,
            },
        }
        if stream.shards is not None:
            # the exporting pool's shard geometry; the chunks are full width
            meta["kv_shards"] = stream.shards

        async def frames() -> AsyncIterator[bytes]:
            truncated = False
            async for idx, _lo, _hi, part in stream.chunks():
                if truncated:
                    continue  # drain the export without sending (fault)
                if isinstance(part, QuantKV):
                    # quantized slab: int8 data then f32 row scales --
                    # matches the receiver's quant staging-buffer bounds
                    raw = pack_quant_blob_bytes(part)
                else:
                    raw = part.tobytes()  # C-order bytes (bf16: its uint16 bits)
                for frame in iter_chunk_frames(
                    idx, bounds[idx][0], raw, KV_CHUNK_BYTES
                ):
                    yield frame
                if faults.injector.enabled and faults.injector.should_fire(
                    "disagg.chunk_truncate", rid
                ):
                    # simulated mid-transfer loss: the receiver's assembler
                    # must detect the truncation and fail the lane fast
                    truncated = True

        t0 = time.perf_counter()
        try:
            if faults.injector.enabled:
                await faults.injector.maybe_delay("disagg.slow_export", rid)
            await self._upload(msg, meta, frames())
        except Exception:
            logger.exception("KV delivery failed for request %s", rid)
            raise
        deliver_ms = (time.perf_counter() - t0) * 1000.0
        started = stream.started_at or t0
        first_at = stream.first_ready_at or started
        last_at = stream.last_ready_at or first_at
        export_first = (first_at - started) * 1000.0
        export_total = (last_at - started) * 1000.0
        self._record_delivery(
            {
                "path": "wire",
                "dst": int(msg["decode_instance"]),
                "bytes": stream.nbytes,
                # export-before-first-byte: the number the chunked pipeline
                # exists to shrink (the legacy path's export_ms covers the
                # WHOLE blob's dispatch+compute+materialize)
                "export_ms": export_first,
                "export_total_ms": export_total,
                # fraction of export materialization that overlapped wire
                # transfer (0 = monolithic behavior, -> 1 = fully pipelined)
                "overlap_ratio": (
                    1.0 - export_first / export_total
                    if export_total > 0 else 0.0
                ),
                "chunks": len(stream.spans),
                "deliver_ms": deliver_ms,
            }
        )
        self.prefills_done += 1
        prompt_tokens = len((msg.get("request") or {}).get("token_ids") or ())
        logger.info(
            "prefilled %d tokens for %s -> %s/%d (%d chunks): wire %d bytes in %.3f ms",
            prompt_tokens, rid, msg["decode_component"],
            int(msg["decode_instance"]), len(stream.spans), stream.nbytes, deliver_ms,
        )

    async def _upload(
        self, msg: Dict[str, Any], meta: Dict[str, Any], chunks
    ) -> None:
        router = await self._router_for(msg["decode_component"])
        ctx = AsyncEngineContext(meta["request_id"])
        stream = await router.direct_upload(
            int(msg["decode_instance"]), meta["request_id"], meta, chunks, ctx
        )
        async for _ack in stream:
            pass  # single-ack stream

    async def _router_for(self, component: str) -> PushRouter:
        router = self._clients.get(component)
        if router is None:
            client = await (
                self.namespace.component(component)
                .endpoint(KV_DELIVER_ENDPOINT)
                .client()
            )
            router = PushRouter(client)
            self._clients[component] = router
        return router
