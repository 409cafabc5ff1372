"""Hub client: the async API every runtime component uses for discovery,
events, queues and small objects.

Two interchangeable implementations:

* :class:`HubClient` -- TCP connection to a :class:`~.hub.HubServer`
  (distributed mode).
* :class:`StaticHub` -- in-process :class:`~.hub.HubState` (static mode, no
  sockets; reference distributed.rs:85 "static mode, no etcd").

Both expose the same coroutine surface, so Namespace/Component/Endpoint and
everything above them is transport-agnostic.
"""

from __future__ import annotations

import asyncio
import contextlib
import itertools
import logging
import random
from dataclasses import dataclass
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

from .. import faults, tracing
from .codec import encode_trace_context, read_frame, write_frame
from .hub import HubState, WatchEvent

logger = logging.getLogger("dynamo.hub.client")

# poison pill pushed into every watch/subscription queue when the hub
# connection drops: consumers must fail loudly, never hang on a dead stream
_CONN_LOST = object()


@dataclass
class WatchHandle:
    """A live prefix watch: initial snapshot + a stream of deltas."""

    snapshot: List[Tuple[str, bytes]]
    events: "asyncio.Queue[WatchEvent]"
    watch_id: int
    _close: Any = None

    async def close(self) -> None:
        if self._close is not None:
            await self._close()

    async def __aiter__(self) -> AsyncIterator[WatchEvent]:
        while True:
            ev = await self.events.get()
            if ev is _CONN_LOST:
                # re-enqueue so every current and future consumer fails too
                self.events.put_nowait(_CONN_LOST)
                raise ConnectionError("hub connection lost (watch orphaned)")
            yield ev


@dataclass
class Subscription:
    queue: "asyncio.Queue[Tuple[str, bytes]]"
    sub_id: int
    _close: Any = None

    async def next(self) -> Tuple[str, bytes]:
        return await self.__anext__()

    async def close(self) -> None:
        if self._close is not None:
            await self._close()

    def __aiter__(self) -> "Subscription":
        return self

    async def __anext__(self) -> Tuple[str, bytes]:
        msg = await self.queue.get()
        if msg is _CONN_LOST:
            # re-enqueue so every current and future consumer fails too
            self.queue.put_nowait(_CONN_LOST)
            raise ConnectionError("hub connection lost (subscription orphaned)")
        return msg


class HubClient:
    """TCP client for HubServer with request/response correlation.

    A single connection carries all ops; server-initiated frames (watch
    events, subscription messages, blocking queue pops) are demuxed to their
    owning handle's queue by id.
    """

    def __init__(
        self, host: str, port: int, reconnect_window: float = 0.0
    ) -> None:
        self.host = host
        self.port = port
        # fires once when the connection drops un-asked (not on close());
        # components register shutdown here -- the reference gets the same
        # property from etcd lease loss + CriticalTaskExecutionHandle
        self.on_connection_lost: Optional[Any] = None
        # > 0: on connection loss, retry connecting for this many seconds
        # (backoff), then re-establish watches/subscriptions and resume
        # lease keepalives -- the durable-hub restart-survival path.  The
        # restored hub holds this client's lease-bound keys (HubJournal),
        # so reconnect + keepalive is a full recovery with no
        # re-registration.  0 keeps loss fatal (fail-fast mode).
        self.reconnect_window = reconnect_window
        self._closing = False
        self._conn_lost = False
        self._connected = asyncio.Event()
        self._seq = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._watches: Dict[int, asyncio.Queue] = {}
        self._watch_prefixes: Dict[int, str] = {}
        self._subs: Dict[int, asyncio.Queue] = {}
        self._sub_patterns: Dict[int, str] = {}
        # Events for ids whose local queue isn't registered yet: the pump can
        # see a watch/sub frame before the registering coroutine resumes.
        self._early: Dict[Tuple[str, int], list] = {}
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pump: Optional[asyncio.Task] = None
        self._reconnect_task: Optional[asyncio.Task] = None
        self._reconnecting = False
        self._keepalives: Dict[int, asyncio.Task] = {}
        self._send_lock = asyncio.Lock()
        # strong refs for on_connection_lost callback coroutines (a bare
        # ensure_future can be GC'd mid-await, silently dropping the
        # notification -- dynalint DT008's hazard class)
        self._bg_tasks: set = set()

    def _spawn_bg(self, coro: Any) -> None:
        task = asyncio.ensure_future(coro)
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    async def connect(self) -> "HubClient":
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port
        )
        self._pump = asyncio.create_task(self._pump_loop())
        self._connected.set()
        return self

    async def close(self) -> None:
        self._closing = True
        # release callers parked on the reconnect gate: they re-check
        # _conn_lost and raise instead of riding out the window
        self._conn_lost = True
        self._connected.set()
        for task in self._keepalives.values():
            task.cancel()
        if self._reconnect_task:
            self._reconnect_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._reconnect_task
        if self._pump:
            self._pump.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._pump
        if self._writer:
            self._writer.close()
            with contextlib.suppress(Exception):
                await self._writer.wait_closed()

    async def _pump_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                frame = await read_frame(self._reader)
                if frame is None:
                    break
                hdr, payload = frame
                if faults.injector.enabled:
                    # chaos plane: drop or delay incoming hub frames (watch
                    # events, sub messages, RPC responses) to exercise the
                    # reconnect / stale-view recovery paths deterministically
                    if faults.injector.should_fire("hub.frame_drop"):
                        continue
                    await faults.injector.maybe_delay("hub.frame_delay")
                if "watch" in hdr:
                    ev = WatchEvent(hdr["type"], hdr["key"], payload)
                    q = self._watches.get(hdr["watch"])
                    if q is not None:
                        q.put_nowait(ev)
                    else:
                        self._early.setdefault(("w", hdr["watch"]), []).append(ev)
                elif "sub" in hdr:
                    msg = (hdr["subject"], payload)
                    q = self._subs.get(hdr["sub"])
                    if q is not None:
                        q.put_nowait(msg)
                    else:
                        self._early.setdefault(("s", hdr["sub"]), []).append(msg)
                elif "seq" in hdr:
                    fut = self._pending.pop(hdr["seq"], None)
                    if fut is not None and not fut.done():
                        fut.set_result((hdr, payload))
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001
            logger.warning("hub connection lost: %s", exc)
        finally:
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("hub connection closed"))
            self._pending.clear()
            if not self._closing:
                self._connected.clear()
                if self.reconnect_window > 0:
                    if self._reconnecting:
                        # this pump belonged to a reconnect attempt that
                        # failed mid-reestablish; the active reconnect loop
                        # owns recovery -- a second loop would race it
                        return
                    # durable-hub mode: try to ride out a hub restart before
                    # declaring the cluster view dead
                    logger.warning(
                        "hub connection lost; reconnecting for up to %.0fs",
                        self.reconnect_window,
                    )
                    self._reconnect_task = asyncio.create_task(
                        self._reconnect_loop(), name="hub-reconnect"
                    )
                else:
                    self._fail_connection()

    def _fail_connection(self) -> None:
        """Unrecoverable loss: every watch, subscription and lease this
        client held is orphaned server-side.  Poison the local streams and
        notify, so the process fails loudly instead of serving from a
        silently frozen view of the cluster."""
        self._conn_lost = True
        # wake callers parked on the reconnect gate; they re-check
        # _conn_lost and raise immediately instead of riding out the window
        self._connected.set()
        for task in self._keepalives.values():
            task.cancel()
        for q in self._watches.values():
            q.put_nowait(_CONN_LOST)
        for q in self._subs.values():
            q.put_nowait(_CONN_LOST)
        logger.error(
            "hub connection lost: %d watches, %d subscriptions and "
            "%d leases orphaned",
            len(self._watches), len(self._subs), len(self._keepalives),
        )
        cb = self.on_connection_lost
        if cb is not None:
            with contextlib.suppress(Exception):
                res = cb()
                if asyncio.iscoroutine(res):
                    self._spawn_bg(res)

    async def _reconnect_loop(self) -> None:
        """Retry the connection with backoff; on success, re-establish
        server-side registrations (watches get their current prefix state
        replayed as synthetic puts -- level-triggered catch-up; deletes
        missed while down surface when the restored hub expires the dead
        owners' leases)."""
        self._reconnecting = True
        try:
            deadline = asyncio.get_running_loop().time() + self.reconnect_window
            delay = 0.2
            while not self._closing:
                try:
                    self._reader, self._writer = await asyncio.open_connection(
                        self.host, self.port
                    )
                except OSError:
                    if asyncio.get_running_loop().time() + delay > deadline:
                        self._fail_connection()
                        return
                    # full jitter (sleep U[0, delay]): a restarted hub sees
                    # its N clients' reconnects spread across the window
                    # instead of a thundering herd of synchronized dials
                    await asyncio.sleep(random.uniform(0.0, delay))
                    delay = min(delay * 2, 2.0)
                    continue
                self._pump = asyncio.create_task(self._pump_loop())
                try:
                    await self._reestablish()
                except Exception:
                    logger.exception("hub re-establish failed; retrying")
                    with contextlib.suppress(Exception):
                        self._writer.close()
                    if asyncio.get_running_loop().time() + delay > deadline:
                        self._fail_connection()
                        return
                    await asyncio.sleep(random.uniform(0.0, delay))
                    continue
                self._connected.set()
                logger.info(
                    "hub reconnected (%d watches, %d subscriptions resumed)",
                    len(self._watches), len(self._subs),
                )
                return
        finally:
            self._reconnecting = False

    async def _reestablish(self) -> None:
        """Re-register every watch and subscription on a fresh connection.

        Transactional against retries: the registration maps are swapped
        only after EVERY re-register RPC succeeded, so a connection that
        dies mid-reestablish leaves the old maps intact for the next
        attempt (nothing is popped-then-lost)."""
        new_watches: Dict[int, asyncio.Queue] = {}
        new_prefixes: Dict[int, str] = {}
        replays: list = []
        for old_wid, prefix in list(self._watch_prefixes.items()):
            q = self._watches[old_wid]
            hdr, blob = await self._call_raw({"op": "watch", "prefix": prefix})
            self._check(hdr)
            wid = int(hdr["watch_id"])
            new_watches[wid] = q
            new_prefixes[wid] = prefix
            replays.append((q, _split_entries(hdr["entries"], blob)))
        new_subs: Dict[int, asyncio.Queue] = {}
        new_patterns: Dict[int, str] = {}
        for old_sid, pattern in list(self._sub_patterns.items()):
            q = self._subs[old_sid]
            hdr, _ = await self._call_raw(
                {"op": "subscribe", "pattern": pattern}
            )
            self._check(hdr)
            sid = int(hdr["sub_id"])
            new_subs[sid] = q
            new_patterns[sid] = pattern
        # commit: swap maps, replay watch snapshots as puts, then drain any
        # events the pump parked in _early before the ids were mapped
        self._watches = new_watches
        self._watch_prefixes = new_prefixes
        self._subs = new_subs
        self._sub_patterns = new_patterns
        for q, entries in replays:
            for key, value in entries:
                q.put_nowait(WatchEvent("put", key, value))
        for wid, q in self._watches.items():
            for ev in self._early.pop(("w", wid), ()):
                q.put_nowait(ev)
        for sid, q in self._subs.items():
            for msg in self._early.pop(("s", sid), ()):
                q.put_nowait(msg)

    async def _call_raw(
        self, hdr: Dict[str, Any], payload: bytes = b""
    ) -> Tuple[Dict[str, Any], bytes]:
        assert self._writer is not None, "not connected"
        seq = next(self._seq)
        hdr["seq"] = seq
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[seq] = fut
        async with self._send_lock:
            write_frame(self._writer, hdr, payload)
            await self._writer.drain()
        return await fut

    async def _call(
        self, hdr: Dict[str, Any], payload: bytes = b""
    ) -> Tuple[Dict[str, Any], bytes]:
        # hub RPCs issued while a request span is open (disagg queue pushes,
        # discovery lookups on the request path) carry the trace context, so
        # control-plane time attributes to the right trace; disabled tracing
        # is one attribute check and leaves the frame untouched
        if tracing.collector.enabled:
            encode_trace_context(hdr, tracing.wire_context())
        if self._conn_lost:
            raise ConnectionError("hub connection lost")
        if not self._connected.is_set() and self.reconnect_window > 0:
            # a reconnect is in progress: park until it lands (or fails,
            # which sets _conn_lost and wakes us to raise)
            try:
                await asyncio.wait_for(
                    self._connected.wait(), self.reconnect_window + 5.0
                )
            except asyncio.TimeoutError:
                raise ConnectionError("hub reconnect timed out") from None
            if self._conn_lost:
                raise ConnectionError("hub connection lost")
        return await self._call_raw(hdr, payload)

    @staticmethod
    def _check(hdr: Dict[str, Any]) -> Dict[str, Any]:
        if not hdr.get("ok"):
            raise RuntimeError(hdr.get("err", "hub op failed"))
        return hdr

    # -- kv ---------------------------------------------------------------

    async def kv_put(self, key: str, value: bytes, lease: int = 0) -> None:
        hdr, _ = await self._call({"op": "kv_put", "key": key, "lease": lease}, value)
        self._check(hdr)

    async def kv_create(self, key: str, value: bytes, lease: int = 0) -> bool:
        hdr, _ = await self._call(
            {"op": "kv_create", "key": key, "lease": lease}, value
        )
        return bool(hdr.get("ok"))

    async def kv_get_prefix(self, prefix: str) -> List[Tuple[str, bytes]]:
        hdr, blob = await self._call({"op": "kv_get", "prefix": prefix})
        self._check(hdr)
        return _split_entries(hdr["entries"], blob)

    async def kv_delete(self, key: str) -> bool:
        hdr, _ = await self._call({"op": "kv_delete", "key": key})
        return bool(hdr.get("ok"))

    async def kv_delete_prefix(self, prefix: str) -> int:
        hdr, _ = await self._call({"op": "kv_delete_prefix", "prefix": prefix})
        self._check(hdr)
        return int(hdr.get("count", 0))

    # -- leases -----------------------------------------------------------

    async def lease_grant(self, ttl: float = 10.0, keepalive: bool = True) -> int:
        hdr, _ = await self._call({"op": "lease_grant", "ttl": ttl})
        self._check(hdr)
        lease = int(hdr["lease"])
        if keepalive:
            # a silently-dead keepalive means the hub evicts this client's
            # instances while the process believes it is healthy -- exactly
            # the failure CriticalTaskExecutionHandle exists for (reference
            # runtime/src/utils/task.rs:42): promote it to connection loss
            from ..utils import CriticalTaskExecutionHandle

            self._keepalives[lease] = CriticalTaskExecutionHandle(
                self._keepalive_loop(lease, ttl),
                on_failure=lambda e: self._signal_connection_lost(
                    f"lease {lease:#x} keepalive died: {e}"
                ),
                name=f"lease-keepalive-{lease:#x}",
            )
        return lease

    def _signal_connection_lost(self, reason: str) -> None:
        logger.error("%s", reason)
        cb = self.on_connection_lost
        if cb is not None:
            try:
                res = cb()
                if asyncio.iscoroutine(res):
                    self._spawn_bg(res)
            except Exception:
                logger.exception("on_connection_lost callback failed")

    async def _keepalive_loop(self, lease: int, ttl: float) -> None:
        interval = max(ttl / 3.0, 0.2)
        with contextlib.suppress(asyncio.CancelledError):
            while True:
                await asyncio.sleep(interval)
                try:
                    hdr, _ = await self._call(
                        {"op": "lease_keepalive", "lease": lease}
                    )
                except ConnectionError:
                    if self.reconnect_window > 0 and not self._conn_lost:
                        continue  # reconnect in progress; retry next beat
                    return
                if not hdr.get("ok"):
                    # the lease genuinely expired (e.g. an outage longer
                    # than TTL + reconnect): every key it held is gone --
                    # raising lets CriticalTaskExecutionHandle promote this
                    # to connection-lost so the process fails loudly
                    # instead of serving while invisible to discovery
                    raise RuntimeError(
                        f"lease {lease:#x} lost (keepalive rejected)"
                    )

    async def lease_revoke(self, lease: int) -> None:
        task = self._keepalives.pop(lease, None)
        if task:
            task.cancel()
        hdr, _ = await self._call({"op": "lease_revoke", "lease": lease})
        self._check(hdr)

    # -- watch ------------------------------------------------------------

    async def watch_prefix(self, prefix: str) -> WatchHandle:
        q: asyncio.Queue = asyncio.Queue()
        # Register the local queue under the id the server hands back; events
        # can only start flowing after the response, so there is no race.
        hdr, blob = await self._call({"op": "watch", "prefix": prefix})
        self._check(hdr)
        wid = int(hdr["watch_id"])
        self._watches[wid] = q
        self._watch_prefixes[wid] = prefix
        for ev in self._early.pop(("w", wid), ()):
            q.put_nowait(ev)
        snapshot = _split_entries(hdr["entries"], blob)

        async def close() -> None:
            # find the watch's CURRENT id: reconnects remap it
            cur = next(
                (w for w, qq in self._watches.items() if qq is q), None
            )
            if cur is not None:
                self._watches.pop(cur, None)
                self._watch_prefixes.pop(cur, None)
                with contextlib.suppress(Exception):
                    await self._call({"op": "unwatch", "watch_id": cur})

        return WatchHandle(snapshot=snapshot, events=q, watch_id=wid, _close=close)

    # -- pub/sub ----------------------------------------------------------

    async def publish(self, subject: str, payload: bytes) -> int:
        hdr, _ = await self._call({"op": "publish", "subject": subject}, payload)
        self._check(hdr)
        return int(hdr.get("receivers", 0))

    async def subscribe(self, pattern: str) -> Subscription:
        hdr, _ = await self._call({"op": "subscribe", "pattern": pattern})
        self._check(hdr)
        sid = int(hdr["sub_id"])
        q: asyncio.Queue = asyncio.Queue()
        self._subs[sid] = q
        self._sub_patterns[sid] = pattern
        for msg in self._early.pop(("s", sid), ()):
            q.put_nowait(msg)

        async def close() -> None:
            cur = next((s for s, qq in self._subs.items() if qq is q), None)
            if cur is not None:
                self._subs.pop(cur, None)
                self._sub_patterns.pop(cur, None)
                with contextlib.suppress(Exception):
                    await self._call({"op": "unsubscribe", "sub_id": cur})

        return Subscription(queue=q, sub_id=sid, _close=close)

    # -- queues -----------------------------------------------------------

    async def queue_push(self, queue: str, payload: bytes) -> None:
        hdr, _ = await self._call({"op": "queue_push", "queue": queue}, payload)
        self._check(hdr)

    async def queue_pop(
        self, queue: str, block: bool = True
    ) -> Optional[bytes]:
        hdr, payload = await self._call(
            {"op": "queue_pop", "queue": queue, "block": block}
        )
        self._check(hdr)
        return payload if hdr.get("found") else None

    async def queue_depth(self, queue: str) -> int:
        hdr, _ = await self._call({"op": "queue_depth", "queue": queue})
        self._check(hdr)
        return int(hdr["depth"])

    # -- objects ----------------------------------------------------------

    async def obj_put(self, name: str, blob: bytes) -> None:
        hdr, _ = await self._call({"op": "obj_put", "name": name}, blob)
        self._check(hdr)

    async def obj_get(self, name: str) -> Optional[bytes]:
        hdr, blob = await self._call({"op": "obj_get", "name": name})
        if not hdr.get("ok"):
            return None
        return blob

    async def obj_del(self, name: str) -> bool:
        hdr, _ = await self._call({"op": "obj_del", "name": name})
        return bool(hdr.get("found"))

    # -- KV blobs (the G4 remote tier's verbs) -----------------------------

    async def blob_put(self, name: str, blob: bytes) -> None:
        hdr, _ = await self._call({"op": "blob_put", "name": name}, blob)
        self._check(hdr)

    async def blob_get(self, name: str) -> Optional[bytes]:
        hdr, blob = await self._call({"op": "blob_get", "name": name})
        if not hdr.get("ok"):
            return None
        return blob

    async def blob_del(self, name: str) -> bool:
        hdr, _ = await self._call({"op": "blob_del", "name": name})
        return bool(hdr.get("found"))

    async def blob_stats(self) -> Dict[str, int]:
        hdr, _ = await self._call({"op": "blob_stats"})
        self._check(hdr)
        return {
            "blobs": int(hdr.get("blobs", 0)),
            "bytes": int(hdr.get("bytes", 0)),
        }


def _split_entries(
    metas: List[Dict[str, Any]], blob: bytes
) -> List[Tuple[str, bytes]]:
    out = []
    off = 0
    for m in metas:
        n = int(m["len"])
        out.append((m["key"], blob[off : off + n]))
        off += n
    return out


class StaticHub:
    """In-process hub: same surface as HubClient, zero sockets.

    Used for single-process serving ("static mode") and unit tests; also the
    lease semantics degenerate to no-ops (nothing can crash independently).
    """

    def __init__(self, state: Optional[HubState] = None) -> None:
        self.state = state or HubState()
        self._lease_seq = itertools.count(0x9000)

    async def connect(self) -> "StaticHub":
        return self

    async def close(self) -> None:
        pass

    async def kv_put(self, key: str, value: bytes, lease: int = 0) -> None:
        self.state.kv_put(key, value, 0)

    async def kv_create(self, key: str, value: bytes, lease: int = 0) -> bool:
        try:
            self.state.kv_create(key, value, 0)
            return True
        except FileExistsError:
            return False

    async def kv_get_prefix(self, prefix: str) -> List[Tuple[str, bytes]]:
        return [(e.key, e.value) for e in self.state.kv_get_prefix(prefix)]

    async def kv_delete(self, key: str) -> bool:
        return self.state.kv_delete(key)

    async def kv_delete_prefix(self, prefix: str) -> int:
        return self.state.kv_delete_prefix(prefix)

    async def lease_grant(self, ttl: float = 10.0, keepalive: bool = True) -> int:
        return next(self._lease_seq)

    async def lease_revoke(self, lease: int) -> None:
        pass

    async def watch_prefix(self, prefix: str) -> WatchHandle:
        q: asyncio.Queue = asyncio.Queue()
        wid = self.state.watch_add(prefix, q.put_nowait)
        snapshot = [(e.key, e.value) for e in self.state.kv_get_prefix(prefix)]

        async def close() -> None:
            self.state.watch_remove(wid)

        return WatchHandle(snapshot=snapshot, events=q, watch_id=wid, _close=close)

    async def publish(self, subject: str, payload: bytes) -> int:
        return self.state.publish(subject, payload)

    async def subscribe(self, pattern: str) -> Subscription:
        q: asyncio.Queue = asyncio.Queue()
        sid = self.state.subscribe(pattern, lambda s, p: q.put_nowait((s, p)))

        async def close() -> None:
            self.state.unsubscribe(sid)

        return Subscription(queue=q, sub_id=sid, _close=close)

    async def queue_push(self, queue: str, payload: bytes) -> None:
        self.state.queue_push(queue, payload)

    async def queue_pop(self, queue: str, block: bool = True) -> Optional[bytes]:
        item = self.state.queue_try_pop(queue)
        if item is not None or not block:
            return item
        fut = self.state.queue_wait(queue)
        return await fut

    async def queue_depth(self, queue: str) -> int:
        return self.state.queue_depth(queue)

    async def obj_put(self, name: str, blob: bytes) -> None:
        self.state.objects[name] = blob

    async def obj_get(self, name: str) -> Optional[bytes]:
        return self.state.objects.get(name)

    async def obj_del(self, name: str) -> bool:
        return self.state.objects.pop(name, None) is not None

    async def blob_put(self, name: str, blob: bytes) -> None:
        await self.state.blob_store.put(name, blob)

    async def blob_get(self, name: str) -> Optional[bytes]:
        return await self.state.blob_store.get(name)

    async def blob_del(self, name: str) -> bool:
        return await self.state.blob_store.delete(name)

    async def blob_stats(self) -> Dict[str, int]:
        return self.state.blob_store.stats()


class HubBlobClient:
    """Sync adapter from the offload plane's kv-remote thread onto an
    async hub client's blob verbs.

    The RemoteTier's store protocol is synchronous (it already owns a
    dedicated thread); a real deployment's store is the hub, whose
    client is loop-bound.  Each call here schedules the coroutine on the
    client's loop with ``run_coroutine_threadsafe`` and blocks the
    CALLING thread only -- the loop never waits.  Never call from the
    event loop itself (that would deadlock by definition); the thread
    sentry on the RemoteTier's entry points already enforces this."""

    def __init__(self, client: Any, loop: asyncio.AbstractEventLoop) -> None:
        self.client = client
        self.loop = loop

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result()

    def put(self, name: str, data: bytes) -> None:
        self._run(self.client.blob_put(name, bytes(data)))

    def get(self, name: str) -> Optional[bytes]:
        return self._run(self.client.blob_get(name))

    def delete(self, name: str) -> bool:
        return self._run(self.client.blob_del(name))
