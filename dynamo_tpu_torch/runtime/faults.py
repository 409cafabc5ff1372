"""Deterministic, seed-driven fault injection: the chaos plane.

Production recovery code that cannot be exercised deterministically is
untested code; this module gives every failure path a named *injection
site* that tests (and operators, in staging) drive from one env knob:

    DYN_FAULTS="seed=42;engine.crash_before_first_token=1:max=1"

Spec grammar (clauses separated by ``;``):

    seed=<int>                     -- PRNG seed (default 0)
    <site>=<prob>[:<k>=<v>]...     -- arm a site

with per-site fields:

    max=<n>      fire at most n times (default unlimited)
    after=<k>    skip the first k *matching* evaluations
    delay=<s>    seconds of injected latency (delay-type sites)
    match=<sub>  only evaluations whose key contains <sub> draw at all

Determinism: each site draws from its own ``random.Random(f"{seed}/{site}")``
stream, so the schedule depends only on (seed, per-site evaluation order)
-- unrelated traffic on *other* sites cannot perturb it, and filtered
(non-``match``-ing) evaluations do not advance the stream.  The same
``DYN_FAULTS`` string therefore reproduces the identical fault schedule
run after run; :meth:`FaultInjector.schedule` returns the fired log for
tests to compare.

Overhead discipline (same as tracing): disabled injection is one
attribute check at every site --

    if faults.injector.enabled and faults.injector.should_fire(SITE):
        ...

Site catalog (README "Failure model & fault injection"):

    hub.frame_drop                  drop an incoming hub frame (client pump)
    hub.frame_delay                 delay an incoming hub frame
    req.stream_abort                server aborts a response stream mid-flight
                                    (error frame to the caller)
    engine.crash_before_first_token worker connection dies before any
                                    response item (the failover-retryable
                                    window)
    engine.crash_after_first_token  worker connection dies mid-stream
    disagg.enqueue_fail             remote-prefill enqueue raises (drives the
                                    circuit breaker)
    disagg.chunk_truncate           KV upload stops after the first chunk
    disagg.slow_export              injected latency before the KV upload
    offload.copy_fail               an offload-tier materialize is dropped
                                    (eviction snapshot lost = later cache
                                    miss; swap snapshot lost = resume falls
                                    back to recompute)
    onboard.truncate                a tier onboard aborts before the device
                                    scatter (prefix onboards recompute the
                                    prefix; swap-ins recompute the sequence)
    spec.draft_corrupt              a speculative drafter's proposal is
                                    corrupted before dispatch; the verify
                                    accept walk must reject it (output
                                    unchanged, only acceptance rate drops)
    worker.slow                     injected per-step latency in a worker's
                                    tick loop (``delay=`` seconds added to
                                    each fired simulated step; ``match=``
                                    on ``worker-<id>`` targets one worker)
                                    -- makes straggler detection/quarantine
                                    drivable from DYN_FAULTS
    worker.kill                     a whole worker process dies mid-run
                                    (evaluated by fleet chaos drivers --
                                    the SLO rig -- per kill opportunity,
                                    keyed ``worker-<id>``)
"""

from __future__ import annotations

import asyncio
import os
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

SITES = frozenset(
    {
        "hub.frame_drop",
        "hub.frame_delay",
        "req.stream_abort",
        "engine.crash_before_first_token",
        "engine.crash_after_first_token",
        "disagg.enqueue_fail",
        "disagg.chunk_truncate",
        "disagg.slow_export",
        "offload.copy_fail",
        "onboard.truncate",
        "remote.fetch_fail",
        "remote.blob_corrupt",
        "spec.draft_corrupt",
        "worker.slow",
        "worker.kill",
    }
)


class InjectedFault(RuntimeError):
    """Raised by crash-type injection sites; never caught as a normal
    application error -- transports translate it into the transport-level
    failure it simulates (a dropped connection)."""


class FaultSpecError(ValueError):
    """Malformed ``DYN_FAULTS`` spec (unknown site, bad field)."""


@dataclass
class _SiteSpec:
    prob: float
    max_fires: Optional[int] = None
    after: int = 0
    delay_s: float = 0.0
    match: Optional[str] = None
    # runtime state
    fires: int = 0
    evals: int = 0
    rng: Any = None


@dataclass
class _Fired:
    site: str
    draw: int  # which matching evaluation of the site fired (0-based)
    key: str

    def to_dict(self) -> Dict[str, Any]:
        return {"site": self.site, "draw": self.draw, "key": self.key}


class FaultInjector:
    """Per-process injector; the module-level :data:`injector` is the one
    every site consults.  ``enabled`` is False unless a spec armed at
    least one site, so un-chaos'd processes pay one attribute check."""

    def __init__(self, spec: Optional[str] = None) -> None:
        self.enabled = False
        self.seed = 0
        self._sites: Dict[str, _SiteSpec] = {}
        self._fired: List[_Fired] = []
        if spec is None:
            spec = os.environ.get("DYN_FAULTS", "")
        if spec:
            self.configure(spec)

    # -- configuration -----------------------------------------------------

    def configure(self, spec: str) -> None:
        """Parse and arm a ``DYN_FAULTS`` spec (replaces any prior one)."""
        seed = 0
        sites: Dict[str, _SiteSpec] = {}
        for clause in filter(None, (c.strip() for c in spec.split(";"))):
            name, sep, rest = clause.partition("=")
            name = name.strip()
            if not sep:
                raise FaultSpecError(f"malformed clause {clause!r}")
            if name == "seed":
                try:
                    seed = int(rest)
                except ValueError as e:
                    raise FaultSpecError(f"bad seed {rest!r}") from e
                continue
            if name not in SITES:
                raise FaultSpecError(
                    f"unknown fault site {name!r} (known: {sorted(SITES)})"
                )
            fields = rest.split(":")
            try:
                site = _SiteSpec(prob=float(fields[0]))
            except ValueError as e:
                raise FaultSpecError(
                    f"bad probability {fields[0]!r} for site {name}"
                ) from e
            for f in fields[1:]:
                k, ksep, v = f.partition("=")
                if not ksep:
                    raise FaultSpecError(f"malformed field {f!r} in {clause!r}")
                try:
                    if k == "max":
                        site.max_fires = int(v)
                    elif k == "after":
                        site.after = int(v)
                    elif k == "delay":
                        site.delay_s = float(v)
                    elif k == "match":
                        site.match = v
                    else:
                        raise FaultSpecError(
                            f"unknown field {k!r} in {clause!r}"
                        )
                except ValueError as e:
                    raise FaultSpecError(f"bad value {v!r} for {k}") from e
            sites[name] = site
        self.seed = seed
        self._sites = sites
        self._fired = []
        for name, site in sites.items():
            site.rng = random.Random(f"{seed}/{name}")
        self.enabled = bool(sites)

    def disable(self) -> None:
        """Disarm everything (tests' teardown path)."""
        self.enabled = False
        self._sites = {}
        self._fired = []

    # -- evaluation --------------------------------------------------------

    def should_fire(self, site: str, key: str = "") -> bool:
        """One evaluation of ``site``.  Draws from the site's private PRNG
        stream; returns True when the fault fires.  ``key`` (a subject,
        request id, ...) is consulted by ``match=`` filters -- filtered
        evaluations do not draw, so unrelated traffic cannot shift the
        schedule."""
        spec = self._sites.get(site)
        if spec is None:
            return False
        if spec.match is not None and spec.match not in key:
            return False
        draw = spec.evals
        spec.evals += 1
        if draw < spec.after:
            return False
        if spec.max_fires is not None and spec.fires >= spec.max_fires:
            return False
        if spec.rng.random() >= spec.prob:
            return False
        spec.fires += 1
        self._fired.append(_Fired(site=site, draw=draw, key=key))
        self._record_fire(site)
        return True

    def delay_s(self, site: str) -> float:
        spec = self._sites.get(site)
        return spec.delay_s if spec is not None else 0.0

    async def maybe_delay(self, site: str, key: str = "") -> bool:
        """Delay-type convenience: sleep the site's ``delay`` when it
        fires.  Returns whether it fired."""
        if self.should_fire(site, key):
            await asyncio.sleep(self.delay_s(site))
            return True
        return False

    # -- introspection -----------------------------------------------------

    def schedule(self) -> List[Dict[str, Any]]:
        """The fired-injection log, in order -- the determinism surface:
        identical specs must produce identical schedules."""
        return [f.to_dict() for f in self._fired]

    def fire_count(self, site: str) -> int:
        spec = self._sites.get(site)
        return spec.fires if spec is not None else 0

    def _record_fire(self, site: str) -> None:
        # lazy import: the injector must stay importable from the deepest
        # transport modules without dragging prometheus into their import
        from . import metrics as rtm

        rtm.default_registry().counter(
            "dynamo_faults_injected",
            "Faults fired by the injection plane",
            ["site"],
        ).labels(site).inc()


injector = FaultInjector()
