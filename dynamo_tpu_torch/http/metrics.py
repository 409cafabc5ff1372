"""HTTP service Prometheus metrics.

Reference parity: lib/llm/src/http/service/metrics.rs:27-188,402-460 -- same
metric family names (``{prefix}_http_service_requests_total``,
``_inflight_requests``, ``_request_duration_seconds``,
``_time_to_first_token_seconds``, ``_inter_token_latency_seconds``) as the
JAX package's service, so existing dashboards translate directly.  Each
service owns a private registry (tests run many services per process);
families are minted through :class:`~..runtime.metrics.MetricsRegistry`,
which renders the exposition text itself.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from ..runtime import slo
from ..runtime.metrics import MetricsRegistry

_DURATION_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
_TTFT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
_ITL_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
)


class ServiceMetrics:
    def __init__(
        self,
        prefix: str = "dynamo",
        registry: Optional[MetricsRegistry] = None,
    ) -> None:
        self._metrics = registry or MetricsRegistry()
        # the service's private registry carries the same worker identity
        # the runtime registry renders with (satellite: multi-worker
        # Prometheus scrapes must not collide on identical series)
        from ..runtime import metrics as rtm

        identity = rtm.worker_identity()
        if identity and not self._metrics.default_labels:
            self._metrics.set_default_labels(**identity)
        self.requests_total = self._metrics.counter(
            f"{prefix}_http_service_requests",
            "Total HTTP service requests",
            ["model", "endpoint", "status"],
        )
        self.inflight = self._metrics.gauge(
            f"{prefix}_http_service_inflight_requests",
            "Requests currently being processed",
            ["model", "endpoint"],
        )
        self.duration = self._metrics.histogram(
            f"{prefix}_http_service_request_duration_seconds",
            "End-to-end request duration",
            ["model", "endpoint"],
            buckets=_DURATION_BUCKETS,
        )
        self.ttft = self._metrics.histogram(
            f"{prefix}_http_service_time_to_first_token_seconds",
            "Time to first generated token",
            ["model"],
            buckets=_TTFT_BUCKETS,
        )
        self.itl = self._metrics.histogram(
            f"{prefix}_http_service_inter_token_latency_seconds",
            "Latency between consecutive tokens",
            ["model"],
            buckets=_ITL_BUCKETS,
        )
        self.sheds = self._metrics.counter(
            f"{prefix}_http_service_sheds",
            "Requests rejected 503 by admission control (inflight bound)",
            ["endpoint"],
        )

    def guard(
        self, model: str, endpoint: str, request_id: str = ""
    ) -> "InflightGuard":
        return InflightGuard(self, model, endpoint, request_id)

    def render(self) -> tuple[bytes, str]:
        return self._metrics.render()


class InflightGuard:
    """Tracks one request: inflight gauge, duration, TTFT, ITL, final status.

    Reference: metrics.rs InflightGuard -- created at admission, marked
    ok/error at completion; finishing without a mark counts as error.

    Use as a context manager: ``__exit__`` always calls :meth:`finish`
    (marking error when an exception escaped), so an abandoned stream --
    the consumer's generator torn down by cancel/GeneratorExit -- can no
    longer leak the inflight gauge.  ``finish`` is idempotent: belt-and-
    suspenders call sites cannot double-decrement.

    With the SLO plane armed (``DYN_SLO``), the same stamps feed the
    attainment tracker: TTFT at the first token, ITL per subsequent
    token, E2E at finish -- one recording site instead of parallel
    plumbing (``request_id`` links a TTFT miss to the engine's
    queue-vs-service decomposition).
    """

    def __init__(
        self,
        metrics: ServiceMetrics,
        model: str,
        endpoint: str,
        request_id: str = "",
    ) -> None:
        self.m = metrics
        self.model = model
        self.endpoint = endpoint
        self.request_id = request_id
        self.start = time.monotonic()
        self._last_token: Optional[float] = None
        self._status: Optional[str] = None
        self._finished = False
        # invoked exactly once from finish(): the admission controller's
        # release (and the deadline watchdog's cancel) piggyback on the one
        # completion point every request path already hits
        self.on_finish: Optional[callable] = None
        metrics.inflight.labels(model, endpoint).inc()

    def __enter__(self) -> "InflightGuard":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None and self._status is None:
            self._status = "error"
        self.finish()
        return False

    def token(self) -> None:
        now = time.monotonic()
        if self._last_token is None:
            self.m.ttft.labels(self.model).observe(now - self.start)
            if slo.tracker.enabled:
                slo.tracker.record_ttft(self.request_id, now - self.start)
        else:
            self.m.itl.labels(self.model).observe(now - self._last_token)
            if slo.tracker.enabled:
                slo.tracker.record_itl(now - self._last_token)
        self._last_token = now

    def mark_ok(self) -> None:
        self._status = "success"

    def mark_error(self) -> None:
        self._status = "error"

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        self.m.inflight.labels(self.model, self.endpoint).dec()
        elapsed = time.monotonic() - self.start
        self.m.duration.labels(self.model, self.endpoint).observe(elapsed)
        self.m.requests_total.labels(
            self.model, self.endpoint, self._status or "error"
        ).inc()
        if slo.tracker.enabled and self._status == "success":
            # errored/deadline requests record their violation at the
            # classifying site (cause=deadline/shed), not as a plain miss
            slo.tracker.record_e2e(self.request_id, elapsed)
        if self.on_finish is not None:
            try:
                self.on_finish()
            except Exception:
                logging.getLogger("dynamo.http.metrics").exception(
                    "guard on_finish callback failed"
                )
