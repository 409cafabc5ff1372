"""RuntimeConfig + the Worker.execute application harness.

Reference parity: lib/runtime RuntimeConfig (the ``DYN_*`` env surface)
and ``Worker::execute`` (runtime/src/worker.rs) -- the standard way an
application hosts the distributed runtime: build it from config, hand it
to the app's async main, install signal handling, and guarantee a clean
shutdown on exit, signal, or failure.

The full DYN_* surface in one place:

=====================  =====================================================
DYN_HUB_ADDRESS        hub ``host:port`` (default 127.0.0.1:6650)
DYN_BIND_HOST          data-plane bind address (default 0.0.0.0)
DYN_ADVERTISE_HOST     address other hosts reach this worker at
DYN_LEASE_TTL          primary lease TTL seconds (default 5)
DYN_LOG                log filter spec (``level`` / ``logger=level,...``)
DYN_LOG_JSONL          1 = one-JSON-object-per-line logs
DYN_TRACE              1 = collect request spans (runtime.tracing)
=====================  =====================================================

The JAX package's harness less its multi-host fields (``DYN_NUM_NODES``,
``DYN_NODE_RANK``, ``DYN_LEADER_ADDR``): the port serves one card per
process.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import signal
from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Optional

from .component import DistributedRuntime
from .utils import configure_logging

logger = logging.getLogger("dynamo.runtime")


@dataclass
class RuntimeConfig:
    """Everything the runtime reads from the environment, in one struct."""

    hub_address: str = "127.0.0.1:6650"
    bind_host: str = "0.0.0.0"
    advertise_host: Optional[str] = None
    lease_ttl_s: float = 5.0
    log_spec: str = ""
    log_jsonl: bool = False
    trace: bool = False

    @classmethod
    def from_env(cls) -> "RuntimeConfig":
        env = os.environ
        return cls(
            hub_address=env.get("DYN_HUB_ADDRESS", "127.0.0.1:6650"),
            bind_host=env.get("DYN_BIND_HOST", "0.0.0.0"),
            advertise_host=env.get("DYN_ADVERTISE_HOST") or None,
            lease_ttl_s=float(env.get("DYN_LEASE_TTL", "5")),
            log_spec=env.get("DYN_LOG", ""),
            log_jsonl=env.get("DYN_LOG_JSONL", "") not in ("", "0", "false"),
            trace=env.get("DYN_TRACE", "") not in ("", "0", "false"),
        )


class Worker:
    """Application harness (reference Worker::execute).

    ``Worker(cfg).execute(app)`` runs ``app(runtime)`` with:

    - logging configured from the DYN_LOG spec,
    - a connected ``DistributedRuntime`` (fails fast if the hub is down),
    - SIGINT/SIGTERM triggering runtime shutdown (``app`` sees the
      runtime's shutdown event and should exit),
    - guaranteed runtime shutdown afterwards, success or failure.
    """

    def __init__(self, config: Optional[RuntimeConfig] = None) -> None:
        self.config = config or RuntimeConfig.from_env()

    def execute(self, app: Callable[[DistributedRuntime], Awaitable[Any]]) -> Any:
        return asyncio.run(self.execute_async(app))

    async def execute_async(
        self, app: Callable[[DistributedRuntime], Awaitable[Any]]
    ) -> Any:
        cfg = self.config
        configure_logging()
        if cfg.trace:
            from . import tracing

            tracing.collector.enable()
        runtime = await DistributedRuntime.detached(
            cfg.hub_address, lease_ttl=cfg.lease_ttl_s
        )
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            with contextlib.suppress(NotImplementedError):
                loop.add_signal_handler(sig, runtime._shutdown.set)
        try:
            return await app(runtime)
        finally:
            await runtime.shutdown()
