"""Metrics registry: labelled counters, gauges and histograms rendered in
the Prometheus text exposition format, with no package behind them.

The subset of the JAX package's ``runtime/metrics.py`` that the HTTP
service's metrics (``http/metrics.py``) and the engine's
(:class:`EngineMetrics`, :class:`SpecMetrics`, :class:`OffloadMetrics`,
:class:`RemoteKVMetrics`) use, written out in plain Python because the
card's machine has no ``prometheus_client``.  ``render()``
gives the text that ``prometheus_client.generate_latest`` gives for the
same families: the same family names, ``_total`` on counters,
``_bucket``/``_count``/``_sum`` on histograms, a ``_created`` gauge per
counter and histogram child, labels sorted by name, the same number
formatting, bucket bounds and content type.

``counter``/``gauge``/``histogram`` are get-or-create: asking twice for the
same family name returns the same object.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

CONTENT_TYPE_LATEST = "text/plain; version=1.0.0; charset=utf-8"

# Engine dispatch->commit latency: sub-ms decode steps up to seconds for a
# long prefill.
STEP_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0,
)

# KV transfer legs (multi-MB device<->host moves)
TRANSFER_LATENCY_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
# unit-interval ratios (prefetch overlap)
RATIO_BUCKETS = (0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 1.0)

DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75, 1.0, 2.5, 5.0,
    7.5, 10.0, float("inf"),
)


def _go_float(d: float) -> str:
    """A sample value or bucket bound as Go (and ``prometheus_client``)
    print it."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _sample(name: str, labels: Dict[str, str], value: float) -> str:
    if labels:
        body = ",".join(
            f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
        )
        return f"{name}{{{body}}} {_go_float(value)}\n"
    return f"{name} {_go_float(value)}\n"


class _Child:
    """One labelled series of a family."""

    def __init__(self, family: "_Family") -> None:
        self._family = family
        self._lock = family._lock
        self.created = time.time()
        self.value = 0.0
        if family.kind == "histogram":
            self.buckets = [0.0] * len(family.bounds)
            self.sum = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if self._family.kind == "counter" and amount < 0:
            raise ValueError("counters can only be incremented by non-negative amounts")
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        if self._family.kind != "gauge":
            raise AttributeError("only a gauge can be decremented")
        with self._lock:
            self.value -= amount

    def set(self, value: float) -> None:
        if self._family.kind != "gauge":
            raise AttributeError("only a gauge can be set")
        with self._lock:
            self.value = float(value)

    def observe(self, amount: float) -> None:
        if self._family.kind != "histogram":
            raise AttributeError("only a histogram observes")
        with self._lock:
            self.sum += amount
            for i, bound in enumerate(self._family.bounds):
                if amount <= bound:
                    self.buckets[i] += 1
                    break


class _Family:
    """A metric family: its name, help text, label names and children.

    A family without label names has one child from the start and takes
    ``inc``/``set``/``observe`` directly; one with label names makes its
    children on ``labels(...)``."""

    def __init__(
        self,
        kind: str,
        name: str,
        documentation: str,
        labelnames: Sequence[str],
        buckets: Optional[Sequence[float]] = None,
    ) -> None:
        self.kind = kind
        # a counter named ``x_total`` is the family ``x``, as in
        # ``prometheus_client``
        if kind == "counter" and name.endswith("_total"):
            name = name[: -len("_total")]
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        if kind == "histogram":
            bounds = [float(b) for b in (buckets or DEFAULT_BUCKETS)]
            if bounds != sorted(bounds):
                raise ValueError("histogram buckets must be in increasing order")
            if bounds[-1] != math.inf:
                bounds.append(math.inf)
            self.bounds = tuple(bounds)
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.labelnames:
            self._children[()] = _Child(self)

    def labels(self, *values: Any) -> _Child:
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected labels {self.labelnames}")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _Child(self)
            return child

    def remove(self, *values: Any) -> None:
        """Drop one labelled series (a dead worker's); ``KeyError`` when it
        was never made, as in ``prometheus_client``."""
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected labels {self.labelnames}")
        with self._lock:
            del self._children[tuple(str(v) for v in values)]

    def _only(self) -> _Child:
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}")
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._only().dec(amount)

    def set(self, value: float) -> None:
        self._only().set(value)

    def observe(self, amount: float) -> None:
        self._only().observe(amount)

    def render(self, extra: Dict[str, str]) -> str:
        with self._lock:
            children = [
                (dict(zip(self.labelnames, key)), child)
                for key, child in self._children.items()
            ]
        help_text = _escape_help(self.documentation)
        name = self.name + "_total" if self.kind == "counter" else self.name
        out: List[str] = [
            f"# HELP {name} {help_text}\n",
            f"# TYPE {name} {self.kind}\n",
        ]
        created: List[str] = []
        for own, child in children:
            labels = {**extra, **own}
            if self.kind == "histogram":
                acc = 0.0
                for bound, n in zip(self.bounds, child.buckets):
                    acc += n
                    out.append(_sample(
                        self.name + "_bucket", {**labels, "le": _go_float(bound)}, acc
                    ))
                out.append(_sample(self.name + "_count", labels, acc))
                out.append(_sample(self.name + "_sum", labels, child.sum))
            else:
                out.append(_sample(name, labels, child.value))
            if self.kind != "gauge":
                created.append(_sample(self.name + "_created", labels, child.created))
        if created:
            out.append(f"# HELP {self.name}_created {help_text}\n")
            out.append(f"# TYPE {self.name}_created gauge\n")
            out.extend(created)
        return "".join(out)


class MetricsRegistry:
    """Get-or-create registry of metric families."""

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()
        # identity labels stamped onto every rendered sample (worker_id,
        # role); explicit per-sample labels win on collision
        self.default_labels: Dict[str, str] = {}

    def set_default_labels(self, **labels: Any) -> None:
        """Replace the render-time identity label set (None values drop
        the key)."""
        with self._lock:
            self.default_labels = {
                k: str(v) for k, v in labels.items() if v is not None
            }

    def _get_or_create(self, kind: str, name: str, documentation: str,
                       labelnames: Sequence[str], buckets=None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(kind, name, documentation, labelnames, buckets)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(f"{name} is already a {fam.kind}")
            return fam

    def counter(
        self, name: str, documentation: str, labelnames: Sequence[str] = ()
    ) -> _Family:
        return self._get_or_create("counter", name, documentation, labelnames)

    def gauge(
        self, name: str, documentation: str, labelnames: Sequence[str] = ()
    ) -> _Family:
        return self._get_or_create("gauge", name, documentation, labelnames)

    def histogram(
        self,
        name: str,
        documentation: str,
        labelnames: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ) -> _Family:
        return self._get_or_create(
            "histogram", name, documentation, labelnames, buckets
        )

    def sample(
        self, name: str, labels: Optional[Dict[str, str]] = None
    ) -> Optional[float]:
        """Current value of one series, or None if it does not exist yet:
        a counter's or gauge's value, a histogram's sum.  The series'
        own labels must equal ``labels`` exactly (the identity labels
        stamped at render time take no part), as in the JAX package."""
        want = {k: str(v) for k, v in (labels or {}).items()}
        with self._lock:
            fam = self._families.get(name)
        if fam is None or set(want) != set(fam.labelnames):
            return None
        with fam._lock:
            child = fam._children.get(tuple(want[n] for n in fam.labelnames))
            if child is None:
                return None
            return float(child.sum if fam.kind == "histogram" else child.value)

    def histogram_totals(self, name: str) -> Tuple[float, float]:
        """(count, sum) across every label set of one histogram family."""
        with self._lock:
            fam = self._families.get(name)
        if fam is None or fam.kind != "histogram":
            return 0.0, 0.0
        with fam._lock:
            children = list(fam._children.values())
            return (float(sum(sum(c.buckets) for c in children)),
                    float(sum(c.sum for c in children)))

    def render(self) -> Tuple[bytes, str]:
        with self._lock:
            families = list(self._families.values())
            extra = dict(self.default_labels)
        text = "".join(f.render(extra) for f in families)
        return text.encode(), CONTENT_TYPE_LATEST

    def render_prefix(self, prefix: str) -> Tuple[bytes, str]:
        """Only the families whose name starts with ``prefix``, without
        the identity labels: what ``prometheus_client`` renders for a view
        of the JAX registry's collectors filtered by name (the fleet
        observatory's ``GET /fleet/metrics``)."""
        with self._lock:
            families = [
                f for f in self._families.values() if f.name.startswith(prefix)
            ]
        text = "".join(f.render({}) for f in families)
        return text.encode(), CONTENT_TYPE_LATEST


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default


def render_default() -> Tuple[bytes, str]:
    return _default.render()


def set_worker_identity(
    worker_id: Optional[Any] = None, role: Optional[str] = None
) -> None:
    """Stamp this process's worker identity (``worker_id``, ``role``) onto
    every sample the default registry renders; workers set it once at
    startup."""
    labels: Dict[str, Any] = {}
    if worker_id is not None:
        labels["worker_id"] = str(worker_id)
    if role:
        labels["role"] = str(role)
    default_registry().set_default_labels(**labels)


def worker_identity() -> Dict[str, str]:
    return dict(default_registry().default_labels)


class EngineMetrics:
    """Registry-backed engine and scheduler series: the JAX package's
    ``EngineMetrics`` (same family names, labels and buckets), which
    Dynamo's planner and KV router read.  The engine updates it at its
    synchronization points -- the admission pass, each dispatch and each
    commit -- never per token."""

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        max_slots: int = 0,
    ) -> None:
        reg = registry or default_registry()
        self.registry = reg
        self.step_latency = reg.histogram(
            "dynamo_engine_step_latency_seconds",
            "Engine device-dispatch to host-commit latency",
            ["kind"],
            buckets=STEP_LATENCY_BUCKETS,
        )
        self.occupancy = reg.gauge(
            "dynamo_engine_batch_occupancy",
            "Decode lanes currently holding a slot",
        )
        self.slots = reg.gauge(
            "dynamo_engine_batch_slots",
            "Configured decode batch lanes (max_batch_size)",
        )
        self.queue_depth = reg.gauge(
            "dynamo_engine_prefill_queue_depth",
            "Requests waiting for admission into the decode batch",
        )
        self.kv_used = reg.gauge(
            "dynamo_engine_kv_pages_used", "KV cache pages in use"
        )
        self.kv_total = reg.gauge(
            "dynamo_engine_kv_pages_total", "KV cache pages available"
        )
        self.kv_util = reg.gauge(
            "dynamo_engine_kv_utilization",
            "KV cache page utilization (used/total, 0..1)",
        )
        self.prefix_hits = reg.counter(
            "dynamo_engine_prefix_hit_tokens",
            "Prompt tokens whose KV was reused from the prefix cache",
        )
        self.prefix_lookups = reg.counter(
            "dynamo_engine_prefix_lookup_tokens",
            "Prompt tokens checked against the prefix cache",
        )
        self.tokens = reg.counter(
            "dynamo_engine_tokens_generated",
            "Output tokens committed by the engine",
        )
        self.preemptions = reg.counter(
            "dynamo_engine_preemptions",
            "Sequences preempted for KV-page capacity",
        )
        # every device dispatch the tick loop (and an embedding call) pays,
        # by kind: prefill, chunk, decode_block, unified, prompt_score, embed
        self.dispatches = reg.counter(
            "dynamo_engine_dispatches_total",
            "Device dispatches issued by the engine tick loop",
            ["kind"],
        )
        # how full each unified dispatch ran: decode lanes beside packed
        # prefill tokens
        self.mixed_decode_lanes = reg.histogram(
            "dynamo_engine_mixed_batch_decode_lanes",
            "Decode lanes per unified mixed-batch dispatch",
            buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128),
        )
        self.mixed_prefill_tokens = reg.histogram(
            "dynamo_engine_mixed_batch_prefill_tokens",
            "Prefill tokens packed into a unified mixed-batch dispatch",
            buckets=(0, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096),
        )
        # fresh-token rows per unified dispatch: `used` real rows,
        # `dispatched` the rows the step ran, `rectangle` the rows the
        # [B, S] layout would have run
        self.mixed_tokens = reg.counter(
            "dynamo_engine_mixed_tokens",
            "Fresh-token rows per unified mixed dispatch by accounting kind",
            ["kind"],
        )
        # active (Np, s_max) shape pairs of the packed step
        # (``bucketing.PackedShapeBudget``)
        self.executable_shapes = reg.gauge(
            "dynamo_engine_executable_shapes",
            "Active packed-dispatch (Np, s_max) executable shape pairs",
        )
        # decode steps fused into the last packed dispatch (1 = single step)
        self.multistep_k = reg.gauge(
            "dynamo_engine_multistep_k",
            "Decode steps fused into the last packed unified dispatch",
        )
        if max_slots:
            self.slots.set(max_slots)

    def observe_sched(self, waiting: int, active: int) -> None:
        self.queue_depth.set(waiting)
        self.occupancy.set(active)

    def observe_step(self, kind: str, seconds: float) -> None:
        self.step_latency.labels(kind).observe(max(seconds, 0.0))

    def observe_dispatch(self, kind: str) -> None:
        self.dispatches.labels(kind).inc()

    def observe_mixed(self, decode_lanes: int, prefill_tokens: int) -> None:
        self.mixed_decode_lanes.observe(decode_lanes)
        self.mixed_prefill_tokens.observe(prefill_tokens)

    def observe_mixed_tokens(self, used: int, dispatched: int, rectangle: int) -> None:
        self.mixed_tokens.labels("used").inc(used)
        self.mixed_tokens.labels("dispatched").inc(dispatched)
        self.mixed_tokens.labels("rectangle").inc(rectangle)

    def observe_kv(self, used: int, total: int) -> None:
        self.kv_used.set(used)
        self.kv_total.set(total)
        self.kv_util.set(used / total if total else 0.0)

    def observe_executable_shapes(self, n: int) -> None:
        self.executable_shapes.set(n)

    def observe_multistep_k(self, k: int) -> None:
        self.multistep_k.set(k)


class SpecMetrics:
    """Registry-backed speculative-decoding series (``dynamo_spec_*``): the
    JAX package's ``SpecMetrics``, same family names, labels and buckets.
    The engine feeds it at the JAX engine's sites.

    Updated only at the engine's commit points (per verify dispatch, never
    per token).  ``accept_rate`` is the engine-lifetime running ratio;
    per-request rates ride the finish item (``usage.speculation``)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        reg = registry or default_registry()
        self.registry = reg
        self.drafted = reg.counter(
            "dynamo_spec_drafted_tokens",
            "Draft tokens proposed and dispatched for verification",
            ["drafter"],
        )
        self.accepted = reg.counter(
            "dynamo_spec_accepted_tokens",
            "Draft tokens accepted by the verify step",
            ["drafter"],
        )
        self.verify_steps = reg.counter(
            "dynamo_spec_verify_steps",
            "Batched multi-token verify passes (standalone or folded)",
        )
        self.folded_steps = reg.counter(
            "dynamo_spec_folded_verify_steps",
            "Verify column groups folded into packed unified dispatches "
            "(no standalone verify dispatch was paid for these)",
        )
        self.auto_disabled = reg.counter(
            "dynamo_spec_auto_disabled_requests",
            "Requests whose speculation auto-disabled on low acceptance",
        )
        self.enabled_frac = reg.gauge(
            "dynamo_spec_enabled_frac",
            "Fraction of spec-armed requests still drafting "
            "(1 - auto_disabled/armed)",
        )
        self.requests = reg.counter(
            "dynamo_spec_requests",
            "Requests that ran with speculation armed",
        )
        self.accept_rate = reg.gauge(
            "dynamo_spec_accept_rate",
            "Engine-lifetime draft acceptance rate (accepted/drafted)",
        )
        self.draft_latency = reg.histogram(
            "dynamo_spec_draft_seconds",
            "Host-side drafting time per verify dispatch (all lanes)",
            buckets=STEP_LATENCY_BUCKETS,
        )
        self.verify_latency = reg.histogram(
            "dynamo_spec_verify_seconds",
            "Verify dispatch->commit latency",
            buckets=STEP_LATENCY_BUCKETS,
        )


class OffloadMetrics:
    """Registry-backed KV offload plane series (``dynamo_kv_*``: G2 host,
    G3 disk, swap records): the JAX package's ``OffloadMetrics``, same
    family names, labels and buckets.  Transfer volume and latency per
    tier, occupancy, tiered prefix hits, preemption kinds and the failure
    counters; updated from the offload thread or the engine's existing
    commit points -- never per token."""

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        reg = registry or default_registry()
        self.registry = reg
        self.offload_bytes = reg.counter(
            "dynamo_kv_offload_bytes",
            "KV bytes demoted out of HBM (eviction snapshots, swap-outs)",
            ["tier"],  # host | swap
        )
        self.offload_latency = reg.histogram(
            "dynamo_kv_offload_seconds",
            "Device->host materialize + tier store latency per blob",
            ["tier"],
            buckets=TRANSFER_LATENCY_BUCKETS,
        )
        self.onboard_bytes = reg.counter(
            "dynamo_kv_onboard_bytes",
            "KV bytes restored into HBM pages (prefix onboards, swap-ins)",
            ["tier"],  # prefix | swap
        )
        self.onboard_latency = reg.histogram(
            "dynamo_kv_onboard_seconds",
            "Host->device scatter latency per onboarded blob",
            ["tier"],
            buckets=TRANSFER_LATENCY_BUCKETS,
        )
        self.tier_blocks = reg.gauge(
            "dynamo_kv_tier_blocks",
            "Blocks resident per offload tier (swap = budget blocks in use)",
            ["tier"],  # host | disk | swap
        )
        self.tier_hits = reg.counter(
            "dynamo_kv_tier_prefix_hits",
            "Prefix-block lookups served from an offload tier",
            ["tier"],  # host | disk
        )
        self.tier_promotes = reg.counter(
            "dynamo_kv_tier_promotes",
            "Blocks promoted up a tier ahead of use (disk->host ring via "
            "prefetch or lookup-triggered promote); deliberately not a "
            "hit -- warmth counts only lookups actually served",
            ["tier"],  # disk
        )
        self.preemptions = reg.counter(
            "dynamo_kv_preemptions",
            "Capacity preemptions by recovery kind",
            ["kind"],  # swap | recompute
        )
        self.swap_events = reg.counter(
            "dynamo_kv_swap_events",
            "Swap-plane transitions (out = parked, in = restored)",
            ["event"],  # out | in
        )
        self.swap_fallbacks = reg.counter(
            "dynamo_kv_swap_fallbacks",
            "Swap attempts that fell back to recompute, by cause",
            ["cause"],  # budget | copy_fail | truncate
        )
        self.onboard_fallbacks = reg.counter(
            "dynamo_kv_onboard_fallbacks",
            "Prefix onboards abandoned (the admission recomputed the "
            "prefix in place), by cause",
            ["cause"],  # truncate
        )
        self.copy_fails = reg.counter(
            "dynamo_kv_offload_copy_failures",
            "Offload materializations dropped (I/O errors or injected "
            "offload.copy_fail faults)",
        )
        self.prefetch_issued = reg.counter(
            "dynamo_kv_prefetch_issued_blocks",
            "Prefix blocks requested by tracked queue-side prefetch walks",
        )
        self.prefetch_hits = reg.counter(
            "dynamo_kv_prefetch_hits",
            "Prefetch-staged blocks found host-resident and consumed at "
            "admission (the onboard scatter never waited on a disk read)",
        )
        self.prefetch_wasted = reg.counter(
            "dynamo_kv_prefetch_wasted_bytes",
            "Bytes prefetch-staged but never consumed (request cancelled "
            "before admission, or the admission matched elsewhere)",
        )
        self.prefetch_overlap = reg.histogram(
            "dynamo_kv_prefetch_overlap_ratio",
            "Fraction of each tracked prefetch walk that overlapped queue "
            "wait instead of the TTFT critical path (1.0 = fully hidden)",
            buckets=RATIO_BUCKETS,
        )

    def record_offload(self, tier: str, nbytes: int, seconds: float) -> None:
        self.offload_bytes.labels(tier).inc(nbytes)
        self.offload_latency.labels(tier).observe(max(seconds, 0.0))

    def record_onboard(self, tier: str, nbytes: int, seconds: float) -> None:
        self.onboard_bytes.labels(tier).inc(nbytes)
        self.onboard_latency.labels(tier).observe(max(seconds, 0.0))


class RemoteKVMetrics:
    """Registry-backed G4 remote-tier series (``dynamo_kv_g4_*``): the JAX
    package's ``RemoteKVMetrics``, same family names, labels and buckets.
    The fleet-shared store's transfer volume and latency per direction,
    the blocks this worker knows to be resident there, and the fetch
    failure causes.  Updated only from the kv-remote thread."""

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        reg = registry or default_registry()
        self.registry = reg
        self.bytes = reg.counter(
            "dynamo_kv_g4_bytes",
            "KV frame bytes moved against the G4 fleet store, by direction",
            ["op"],  # store | fetch
        )
        self.latency = reg.histogram(
            "dynamo_kv_g4_seconds",
            "G4 store round-trip latency per blob frame, by direction",
            ["op"],
            buckets=TRANSFER_LATENCY_BUCKETS,
        )
        self.blocks = reg.gauge(
            "dynamo_kv_g4_blocks",
            "Blocks this worker knows to be resident in the G4 store "
            "(own publications + merged fleet adverts)",
        )
        self.fetch_failures = reg.counter(
            "dynamo_kv_g4_fetch_failures",
            "G4 fetches that fell back to recompute, by cause",
            ["cause"],  # fetch_fail | missing | blob_corrupt
        )

    def record_store(self, nbytes: int, seconds: float) -> None:
        self.bytes.labels("store").inc(nbytes)
        self.latency.labels("store").observe(max(seconds, 0.0))

    def record_fetch(self, nbytes: int, seconds: float) -> None:
        self.bytes.labels("fetch").inc(nbytes)
        self.latency.labels("fetch").observe(max(seconds, 0.0))
