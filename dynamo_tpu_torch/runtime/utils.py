"""Runtime utilities: critical tasks, object pool, logging config.

Parity targets (SURVEY.md 2.1 Utils row):

- ``CriticalTaskExecutionHandle`` -- reference runtime/src/utils/task.rs:42.
  A background task whose failure must not be swallowed: an unhandled
  exception (not cancellation) invokes ``on_failure`` -- typically the
  runtime's shutdown -- so a dead keepalive/watcher loop takes the process
  down loudly instead of leaving a zombie worker registered in the hub.
- ``Pool`` -- reference runtime/src/utils/pool.rs:23,111,197.  A bounded
  async reusable-object pool (codec scratch buffers, client connections):
  ``acquire`` hands out an idle object or builds one up to ``max_size``,
  then blocks; releasing returns the object for reuse.
- ``configure_logging`` -- reference lib/runtime logging config (DYN_LOG
  env filter), plus a JSONL mode for log aggregation pipelines.
- ``log_throttled`` -- rate-limited logging for hot paths: a per-token or
  per-request failure site logs at most once per interval per key (with a
  suppressed-hit count), so a production fault is diagnosable without a
  log flood feeding back into the latency it reports on.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import os
import sys
import time
from typing import Any, Awaitable, Callable, Generic, Optional, TypeVar

logger = logging.getLogger("dynamo.runtime")

T = TypeVar("T")


class CriticalTaskExecutionHandle:
    """Run a coroutine whose failure is fatal to its owner.

    ``on_failure(exc)`` fires exactly once, from the task's own loop, when
    the coroutine raises anything but ``asyncio.CancelledError``.  Normal
    return and cancellation are clean exits.
    """

    def __init__(
        self,
        coro: Awaitable[Any],
        on_failure: Callable[[BaseException], Any],
        name: str = "critical-task",
    ) -> None:
        self.name = name
        self._on_failure = on_failure
        # held until the guard first runs: a cancel() that lands before the
        # guard task is ever scheduled must close the inner coroutine, or
        # it is garbage-collected un-awaited ("coroutine ... was never
        # awaited" at interpreter shutdown)
        self._pending_coro: Optional[Any] = coro
        self._task = asyncio.ensure_future(self._guard(coro))

    async def _guard(self, coro: Awaitable[Any]) -> Any:
        self._pending_coro = None
        try:
            return await coro
        except asyncio.CancelledError:
            raise
        except BaseException as e:  # noqa: BLE001 -- the whole point
            logger.error("critical task %r failed: %s", self.name, e)
            try:
                result = self._on_failure(e)
                if asyncio.iscoroutine(result):
                    await result
            except Exception:
                logger.exception("on_failure handler for %r failed", self.name)
            raise

    def done(self) -> bool:
        return self._task.done()

    def cancel(self) -> None:
        """Non-blocking, drop-in for asyncio.Task.cancel()."""
        coro = self._pending_coro
        if coro is not None and asyncio.iscoroutine(coro):
            self._pending_coro = None
            coro.close()
        self._task.cancel()

    async def wait_stopped(self) -> None:
        with contextlib.suppress(asyncio.CancelledError, Exception):
            await self._task

    def __await__(self):
        return self._task.__await__()


class Pool(Generic[T]):
    """Bounded async pool of reusable objects.

    ``factory`` builds a new object when the pool is empty and fewer than
    ``max_size`` exist; beyond that, ``acquire`` waits for a release.  Use
    ``async with pool.handle() as obj`` for scoped acquire/release.
    """

    def __init__(
        self,
        factory: Callable[[], T],
        max_size: int = 16,
    ) -> None:
        if max_size < 1:
            raise ValueError("max_size must be >= 1")
        self._factory = factory
        self._max = max_size
        self._idle: list = []
        self._created = 0
        self._waiters: asyncio.Queue = asyncio.Queue()
        self._sem = asyncio.Semaphore(max_size)

    @property
    def size(self) -> int:
        """Objects in existence (idle + acquired)."""
        return self._created

    @property
    def idle(self) -> int:
        return len(self._idle)

    async def acquire(self) -> T:
        await self._sem.acquire()
        if self._idle:
            return self._idle.pop()
        obj = self._factory()
        if asyncio.iscoroutine(obj):
            obj = await obj
        self._created += 1
        return obj

    def release(self, obj: T) -> None:
        self._idle.append(obj)
        self._sem.release()

    def handle(self):
        pool = self

        class _Handle:
            async def __aenter__(self):
                self.obj = await pool.acquire()
                return self.obj

            async def __aexit__(self, *exc):
                pool.release(self.obj)
                return False

        return _Handle()


# key -> [last-emit monotonic time, hits suppressed since]
_THROTTLE: dict = {}


def log_throttled(
    log: logging.Logger,
    key: str,
    msg: str,
    *args: Any,
    level: int = logging.WARNING,
    interval_s: float = 5.0,
    exc_info: bool = False,
) -> None:
    """Log at most once per ``interval_s`` seconds per ``key``.

    Suppressed hits are counted and reported on the next emitted record,
    so the log stays honest about failure volume without flooding.  GIL
    atomicity is sufficient here: a racing duplicate emission or an
    off-by-one suppressed count is harmless for diagnostics.
    """
    now = time.monotonic()
    st = _THROTTLE.get(key)
    if st is not None and now - st[0] < interval_s:
        st[1] += 1
        return
    suppressed = st[1] if st is not None else 0
    _THROTTLE[key] = [now, 0]
    if suppressed:
        msg = f"{msg} [{suppressed} similar suppressed]"
    log.log(level, msg, *args, exc_info=exc_info)


def reset_throttle() -> None:
    """Tests only: forget throttle history."""
    _THROTTLE.clear()


class _JsonlFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": round(time.time(), 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info and record.exc_info[0] is not None:
            entry["exc"] = self.formatException(record.exc_info)
        return json.dumps(entry)


def configure_logging(
    default_level: str = "INFO", stream=None
) -> None:
    """Apply the ``DYN_LOG`` filter spec and optional JSONL mode.

    ``DYN_LOG`` grammar (reference ``DYN_LOG`` / env_logger style):
    comma-separated ``[logger=]level`` terms -- e.g.
    ``DYN_LOG=debug`` (root), ``DYN_LOG=warn,dynamo.engine=debug``.
    ``DYN_LOG_JSONL=1`` switches the handler to one-JSON-object-per-line.
    """
    spec = os.environ.get("DYN_LOG", "")
    jsonl = os.environ.get("DYN_LOG_JSONL", "") not in ("", "0", "false")

    root_level = default_level.upper()
    per_logger = {}
    for term in filter(None, (t.strip() for t in spec.split(","))):
        if "=" in term:
            name, _, lvl = term.partition("=")
            per_logger[name.strip()] = lvl.strip().upper()
        else:
            root_level = term.upper()
    alias = {"WARN": "WARNING", "ERR": "ERROR", "TRACE": "DEBUG"}
    root_level = alias.get(root_level, root_level)

    handler = logging.StreamHandler(stream or sys.stderr)
    if jsonl:
        handler.setFormatter(_JsonlFormatter())
    else:
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(name)s %(levelname)s %(message)s"
            )
        )
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(getattr(logging, root_level, logging.INFO))
    for name, lvl in per_logger.items():
        lvl = alias.get(lvl, lvl)
        logging.getLogger(name).setLevel(getattr(logging, lvl, logging.INFO))
