"""Runtime complement of dynalint's thread-role model (DT014-DT016).

The JAX package's static analyzer (dynalint) proves race-freedom only
relative to a *declared* role model: the tick coroutine is serialized with
the device executor, ``to_host`` runs only on the kv-offload thread, the
WAL writer owns the journal handle.  This module makes those declarations
checkable at runtime: armed with ``DYN_THREAD_SENTRY=1``, the engine's
hottest shared structures assert their confinement on every touch, so a
manifest entry that drifts from reality fails a test instead of silently
mis-scoping the race scan.

Overhead discipline (the FaultInjector pattern): disarmed, every site is
one module-global bool check; ``thread_confined`` returns the function
object untouched, so jits/partials/pickling are unaffected.

Usage::

    from ..runtime import thread_sentry

    def _commit_all(self, ...):
        thread_sentry.assert_role("tick", what="TorchEngine._commit_all")

or, pinning the static role AND asserting at runtime in one place::

    @thread_confined("kv-offload")
    def _store_evict(self, ...): ...

``thread_confined`` doubles as dynalint's justification mechanism: the
analyzer reads the decorator syntactically and pins the function (or every
method of a decorated class) to the named role instead of whatever
propagation inferred.  The special role ``"handoff"`` marks per-request
value classes whose instances cross domains only through ownership
transfer (admission, queue put) -- never shared live.
"""

from __future__ import annotations

import asyncio
import functools
import os
import threading
from typing import Any, Callable, Tuple, TypeVar

ENV_VAR = "DYN_THREAD_SENTRY"

_ARMED = os.environ.get(ENV_VAR, "").strip().lower() not in (
    "", "0", "false", "no", "off",
)

F = TypeVar("F", bound=Callable)

THREAD_CONFINED_ATTR = "__dynalint_thread_role__"

# role -> thread-name prefixes allowed to execute it.  The executor roles
# are keyed by their pools' thread_name_prefix (the mapping
# dynalint's EXECUTOR_PREFIX_ROLES inverts).
ROLE_THREAD_PREFIXES = {
    "tick": ("torch-engine",),
    "kv-offload": ("kv-offload",),
    "kv-remote": ("kv-remote",),
    "hub-io": ("hub-journal",),
    "recorder-io": ("recorder-io",),
    "planner-log": ("planner-log",),
    "kv-index-shard": ("kv-index-shard",),
}

# roles satisfied by running on an event-loop thread.  "tick" is included:
# the tick domain is the executor thread PLUS the tick coroutine, which
# are await-serialized -- exactly the contract DT014 relies on.
LOOP_RESIDENT_ROLES = ("tick-coro", "fanout-worker", "event-loop", "tick")

# the anonymous default-executor / to_thread pool
_WORKER_PREFIXES = ("asyncio_", "ThreadPoolExecutor")


class ThreadConfinementError(AssertionError):
    """A declared thread-role confinement was violated at runtime."""


def armed() -> bool:
    return _ARMED


def arm(on: bool = True) -> None:
    """Flip the sentry for tests.  Inline ``assert_role`` sites react
    immediately; ``thread_confined`` wrappers are bound at import time, so
    subprocess tests set ``DYN_THREAD_SENTRY=1`` in the environment."""
    global _ARMED
    _ARMED = on


def _on_event_loop() -> bool:
    try:
        asyncio.get_running_loop()
        return True
    except RuntimeError:
        return False


def _role_matches(role: str, thread_name: str) -> bool:
    # auto-minted roles are NAMED AFTER their executor's
    # thread_name_prefix (analysis/threads.py), so an unlisted role
    # matches threads carrying its own name as prefix -- naming the
    # executor is the whole declaration, on both sides
    for prefix in ROLE_THREAD_PREFIXES.get(role, (role,)):
        if thread_name.startswith(prefix):
            return True
    if role in LOOP_RESIDENT_ROLES and _on_event_loop():
        return True
    if role == "worker" and thread_name.startswith(_WORKER_PREFIXES):
        return True
    if role == "handoff":
        return True  # ownership-transfer classes: any single owner
    return False


def assert_role(*roles: str, what: str = "") -> None:
    """Assert the current thread may execute code confined to any of
    ``roles``.  No-op unless armed (one bool check)."""
    if not _ARMED:
        return
    name = threading.current_thread().name
    for role in roles:
        if _role_matches(role, name):
            return
    raise ThreadConfinementError(
        f"{what or 'confined code'} declared roles {sorted(roles)} but ran "
        f"on thread {name!r} (loop_running={_on_event_loop()}); the "
        "thread-role manifest (analysis/threads.py) and reality disagree"
    )


def thread_confined(role: str) -> Callable[[F], F]:
    """Pin ``role`` on a function or class for dynalint DT014, and (when
    the sentry is armed at import) assert it on every call.

    The decorator tags and returns the SAME object when disarmed -- safe
    around jit/partial/pickle like ``hot_path``.  On a class it only tags
    (methods assert individually if they need to)."""

    def deco(obj: Any) -> Any:
        try:
            setattr(obj, THREAD_CONFINED_ATTR, role)
        except (AttributeError, TypeError):
            pass
        if not _ARMED or isinstance(obj, type):
            return obj

        roles: Tuple[str, ...] = tuple(
            r.strip() for r in role.split(",") if r.strip()
        )

        @functools.wraps(obj)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            assert_role(*roles, what=getattr(obj, "__qualname__", repr(obj)))
            return obj(*args, **kwargs)

        return wrapper

    return deco
