"""The control hub: discovery KV + leases + prefix watches + pub/sub + queues
+ object store, as one embeddable asyncio service.

The reference splits its L1 infra across *external* services: etcd (leases,
prefix watches; lib/runtime/src/transports/etcd.rs), NATS core (request
subjects, events), NATS JetStream (prefill queue), and the NATS object store
(model cards) (lib/runtime/src/transports/nats.rs).  This build ships its
control plane first-party instead: a single hub process (or in-process task)
speaking the two-part frame codec, providing the same primitives:

  * ``kv_*``        -- key-value with atomic create, prefix get/delete
  * ``lease_*``     -- TTL leases with keepalive; lease loss deletes its keys
                       (liveness = leases, exactly as in the reference)
  * ``watch``       -- prefix watch: initial dump + put/delete deltas
  * ``publish/subscribe`` -- subject-based events ("ns.events.kv_events", ...)
  * ``queue_*``     -- FIFO work queues with blocking pop (prefill queue)
  * ``obj_put/obj_get``   -- small-object store (model cards, tokenizer blobs)

Bulk data (response streams, KV pages) never transits the hub -- it flows
peer-to-peer over the TCP data plane (``request_plane.py``).

``StaticHub`` implements the same client interface fully in-process for
single-node / test use (reference "static mode": distributed.rs:85).
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import fnmatch
import hashlib
import itertools
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, Dict, List, Optional, Tuple

from ..utils import log_throttled
from .codec import read_frame, write_frame

logger = logging.getLogger("dynamo.hub")

# ---------------------------------------------------------------------------
# Shared data model
# ---------------------------------------------------------------------------


@dataclass
class KvEntry:
    key: str
    value: bytes
    lease_id: int = 0
    revision: int = 0


@dataclass
class WatchEvent:
    """One delta on a watched prefix. type: 'put' | 'delete'."""

    type: str
    key: str
    value: bytes = b""


def _subject_matches(pattern: str, subject: str) -> bool:
    """NATS-style matching: '.' separated tokens, '*' one token, '>' tail."""
    if pattern == subject:
        return True
    p_toks = pattern.split(".")
    s_toks = subject.split(".")
    for i, pt in enumerate(p_toks):
        if pt == ">":
            # NATS semantics: '>' matches one or more remaining tokens.
            return i < len(s_toks)
        if i >= len(s_toks):
            return False
        if pt != "*" and pt != s_toks[i]:
            return False
    return len(p_toks) == len(s_toks)


# ---------------------------------------------------------------------------
# Core state machine (shared by the TCP server and StaticHub)
# ---------------------------------------------------------------------------


class HubState:
    """The hub's data: pure in-memory state + waiter bookkeeping.

    All mutation happens on one event loop, so no locks are needed
    (the same single-writer discipline the reference applies to its radix
    tree and etcd caches).
    """

    def __init__(self) -> None:
        self.kv: Dict[str, KvEntry] = {}
        self.revision = 0
        self.leases: Dict[int, float] = {}  # lease_id -> expiry monotonic time
        self.lease_ttl: Dict[int, float] = {}
        self.lease_keys: Dict[int, set] = collections.defaultdict(set)
        self._lease_seq = itertools.count(0x1000)
        # durability hook: called with (record_dict, payload_bytes) after
        # every state mutation; None = in-memory only (StaticHub, tests).
        # The journal (HubJournal) makes a hub restart recoverable -- the
        # reference gets this property from etcd raft + NATS JetStream
        # persistence (transports/etcd.rs:41-58, nats.rs:50-123).
        self.journal: Optional[Callable[[Dict[str, Any], bytes], None]] = None
        # prefix -> list of callbacks(WatchEvent)
        self.watchers: Dict[int, Tuple[str, Callable[[WatchEvent], None]]] = {}
        self._watch_seq = itertools.count(1)
        # sub_id -> (pattern, callback(subject, payload))
        self.subs: Dict[int, Tuple[str, Callable[[str, bytes], None]]] = {}
        self._sub_seq = itertools.count(1)
        self.queues: Dict[str, collections.deque] = collections.defaultdict(
            collections.deque
        )
        self.queue_waiters: Dict[str, collections.deque] = collections.defaultdict(
            collections.deque
        )
        self.objects: Dict[str, bytes] = {}
        # the G4 KV-blob cache (blob_* verbs) -- unjournaled by design,
        # disk-backed when the owning server has a data_dir
        self.blob_store = HubBlobStore()
        # expiry-loop wakeup: called whenever a new lease deadline appears
        # (grant), so the owner's wait can re-aim at the earliest expiry
        # instead of polling on a fixed interval
        self.lease_wake: Optional[Callable[[], None]] = None

    # -- kv ---------------------------------------------------------------

    def _notify(self, ev: WatchEvent) -> None:
        for prefix, cb in list(self.watchers.values()):
            if ev.key.startswith(prefix):
                cb(ev)

    def kv_put(self, key: str, value: bytes, lease_id: int = 0) -> int:
        if lease_id and lease_id not in self.leases:
            raise KeyError(f"unknown lease {lease_id:#x}")
        self.revision += 1
        self.kv[key] = KvEntry(key, value, lease_id, self.revision)
        if lease_id:
            self.lease_keys[lease_id].add(key)
        if self.journal is not None:
            self.journal({"op": "kv_put", "key": key, "lease": lease_id}, value)
        self._notify(WatchEvent("put", key, value))
        return self.revision

    def kv_create(self, key: str, value: bytes, lease_id: int = 0) -> int:
        """Atomic create: fails if the key exists (etcd txn version==0)."""
        if key in self.kv:
            raise FileExistsError(key)
        return self.kv_put(key, value, lease_id)

    def kv_get_prefix(self, prefix: str) -> List[KvEntry]:
        return [e for k, e in sorted(self.kv.items()) if k.startswith(prefix)]

    def kv_delete(self, key: str) -> bool:
        entry = self.kv.pop(key, None)
        if entry is None:
            return False
        if entry.lease_id:
            self.lease_keys[entry.lease_id].discard(key)
        self.revision += 1
        if self.journal is not None:
            self.journal({"op": "kv_delete", "key": key}, b"")
        self._notify(WatchEvent("delete", key))
        return True

    def kv_delete_prefix(self, prefix: str) -> int:
        keys = [k for k in self.kv if k.startswith(prefix)]
        for k in keys:
            self.kv_delete(k)
        return len(keys)

    # -- leases -----------------------------------------------------------

    def lease_grant(self, ttl: float) -> int:
        lease_id = next(self._lease_seq)
        self.leases[lease_id] = time.monotonic() + ttl
        self.lease_ttl[lease_id] = ttl
        if self.journal is not None:
            self.journal({"op": "lease", "id": lease_id, "ttl": ttl}, b"")
        if self.lease_wake is not None:
            # a fresh grant can move the earliest deadline EARLIER; the
            # expiry loop re-aims.  Keepalives only push deadlines later,
            # so they never need a wake (the loop wakes at the stale
            # deadline, finds nothing expired, recomputes)
            self.lease_wake()
        return lease_id

    def next_lease_expiry(self) -> Optional[float]:
        """Earliest lease deadline (monotonic), None when no leases."""
        return min(self.leases.values()) if self.leases else None

    def lease_keepalive(self, lease_id: int) -> bool:
        # deliberately NOT journaled (high frequency): a restore re-arms
        # every lease with one fresh TTL of grace instead
        if lease_id not in self.leases:
            return False
        self.leases[lease_id] = time.monotonic() + self.lease_ttl[lease_id]
        return True

    def lease_revoke(self, lease_id: int) -> None:
        had = self.leases.pop(lease_id, None) is not None
        self.lease_ttl.pop(lease_id, None)
        if had and self.journal is not None:
            self.journal({"op": "lease_revoke", "id": lease_id}, b"")
        for key in list(self.lease_keys.pop(lease_id, ())):
            self.kv_delete(key)

    def expire_leases(self) -> None:
        now = time.monotonic()
        for lease_id, expiry in list(self.leases.items()):
            if expiry < now:
                logger.warning("lease %#x expired; dropping its keys", lease_id)
                self.lease_revoke(lease_id)

    # -- watch ------------------------------------------------------------

    def watch_add(self, prefix: str, cb: Callable[[WatchEvent], None]) -> int:
        wid = next(self._watch_seq)
        self.watchers[wid] = (prefix, cb)
        return wid

    def watch_remove(self, wid: int) -> None:
        self.watchers.pop(wid, None)

    # -- pub/sub ----------------------------------------------------------

    def subscribe(self, pattern: str, cb: Callable[[str, bytes], None]) -> int:
        sid = next(self._sub_seq)
        self.subs[sid] = (pattern, cb)
        return sid

    def unsubscribe(self, sid: int) -> None:
        self.subs.pop(sid, None)

    def publish(self, subject: str, payload: bytes) -> int:
        n = 0
        for pattern, cb in list(self.subs.values()):
            if _subject_matches(pattern, subject):
                cb(subject, payload)
                n += 1
        return n

    # -- queues -----------------------------------------------------------

    def queue_push(self, queue: str, payload: bytes) -> None:
        waiters = self.queue_waiters.get(queue)
        while waiters:
            fut = waiters.popleft()
            if not fut.done():
                # direct handoff to a blocked popper: the item never enters
                # stored state, so nothing is journaled -- an in-flight
                # delivery lost to a crash is the same at-most-once window
                # core NATS has (JetStream-grade redelivery is out of scope)
                fut.set_result(payload)
                return
        self.queues[queue].append(payload)
        if self.journal is not None:
            self.journal({"op": "qpush", "queue": queue}, payload)

    def queue_try_pop(self, queue: str) -> Optional[bytes]:
        q = self.queues.get(queue)
        if q:
            item = q.popleft()
            if self.journal is not None:
                self.journal({"op": "qpop", "queue": queue}, b"")
            return item
        return None

    def queue_depth(self, queue: str) -> int:
        return len(self.queues.get(queue, ()))

    def queue_wait(self, queue: str) -> asyncio.Future:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self.queue_waiters[queue].append(fut)
        return fut

    # -- objects ----------------------------------------------------------

    def obj_put(self, name: str, blob: bytes) -> None:
        self.objects[name] = blob
        if self.journal is not None:
            self.journal({"op": "obj_put", "name": name}, blob)

    def obj_del(self, name: str) -> bool:
        existed = self.objects.pop(name, None) is not None
        if existed and self.journal is not None:
            self.journal({"op": "obj_del", "name": name}, b"")
        return existed


class HubBlobStore:
    """The hub's G4 KV-blob store (the ``blob_put``/``blob_get``/
    ``blob_del``/``blob_stats`` verbs).

    Deliberately NOT journaled, unlike ``objects``: blobs are a fleet
    *cache* -- losing one costs a worker a recompute, never correctness
    -- so multi-MB KV frames stay out of the WAL and snapshots.  With a
    ``data_dir`` (a durable HubServer) each blob is one file under
    ``<data_dir>/blobs/`` behind an in-RAM name->size index, and every
    file op runs on the journal's single I/O worker (role ``hub-io``) --
    a slow disk stalls blob traffic, never the hub's event loop.
    Without one (StaticHub, tests) the same byte-capacity LRU runs over
    an in-RAM dict.  Capacity: ``DYN_HUB_BLOB_CAP`` bytes (default 1
    GiB)."""

    def __init__(self, cap_bytes: Optional[int] = None) -> None:
        if cap_bytes is None:
            cap_bytes = int(os.environ.get("DYN_HUB_BLOB_CAP", str(1 << 30)))
        self.cap_bytes = int(cap_bytes)
        # LRU order over resident blob names; value = blob nbytes
        self._index: "collections.OrderedDict[str, int]" = (
            collections.OrderedDict()
        )
        self._mem: Dict[str, bytes] = {}
        self._total = 0
        self._dir: Optional[str] = None
        self._io: Optional[Any] = None
        # the index is touched from the loop (StaticHub direct calls)
        # AND the hub-io worker (disk-backed ops): lock it
        self._lock = threading.Lock()

    def attach_disk(self, root: str, io: Any) -> None:
        """Back blobs with files under ``root``; ``io`` is the journal's
        single-thread executor (every file op rides it)."""
        os.makedirs(root, exist_ok=True)
        self._dir = root
        self._io = io

    def _path(self, name: str) -> str:
        # hashed filename: blob names carry '/' namespacing and arbitrary
        # worker-supplied bytes -- never let them pick filesystem paths
        digest = hashlib.sha256(name.encode("utf-8")).hexdigest()
        return os.path.join(self._dir, digest + ".blob")

    # -- RAM core (loop-safe: index + in-memory bytes, no file I/O) --------

    def _index_put(self, name: str, nbytes: int, data: Optional[bytes]) -> List[str]:
        """LRU-insert; returns evicted names (disk callers unlink them)."""
        evicted: List[str] = []
        with self._lock:
            old = self._index.pop(name, None)
            if old is not None:
                self._total -= old
            self._index[name] = nbytes
            self._total += nbytes
            if data is not None:
                self._mem[name] = data
            while self._total > self.cap_bytes and len(self._index) > 1:
                victim, vb = self._index.popitem(last=False)
                self._total -= vb
                self._mem.pop(victim, None)
                evicted.append(victim)
        return evicted

    def _mem_get(self, name: str) -> Optional[bytes]:
        with self._lock:
            if name not in self._index:
                return None
            self._index.move_to_end(name)
            return self._mem.get(name)

    def _index_del(self, name: str) -> bool:
        with self._lock:
            nbytes = self._index.pop(name, None)
            if nbytes is not None:
                self._total -= nbytes
            self._mem.pop(name, None)
        return nbytes is not None

    # -- disk core (hub-io worker only: every file op lives here) ----------

    def put_sync(self, name: str, data: bytes) -> None:
        from .. import thread_sentry

        thread_sentry.assert_role("hub-io", what="HubBlobStore.put")
        path = self._path(name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        for victim in self._index_put(name, len(data), None):
            with contextlib.suppress(OSError):
                os.remove(self._path(victim))

    def get_sync(self, name: str) -> Optional[bytes]:
        with self._lock:
            if name not in self._index:
                return None
            self._index.move_to_end(name)
        from .. import thread_sentry

        thread_sentry.assert_role("hub-io", what="HubBlobStore.get")
        try:
            with open(self._path(name), "rb") as f:
                return f.read()
        except OSError:
            self._index_del(name)
            return None

    def del_sync(self, name: str) -> bool:
        existed = self._index_del(name)
        if existed:
            with contextlib.suppress(OSError):
                os.remove(self._path(name))
        return existed

    # -- async surface (hub dispatch + StaticHub) --------------------------

    async def put(self, name: str, data: bytes) -> None:
        if self._io is not None:
            await asyncio.get_running_loop().run_in_executor(
                self._io, self.put_sync, name, data
            )
        else:
            self._index_put(name, len(data), bytes(data))

    async def get(self, name: str) -> Optional[bytes]:
        if self._io is not None:
            return await asyncio.get_running_loop().run_in_executor(
                self._io, self.get_sync, name
            )
        return self._mem_get(name)

    async def delete(self, name: str) -> bool:
        if self._io is not None:
            return await asyncio.get_running_loop().run_in_executor(
                self._io, self.del_sync, name
            )
        return self._index_del(name)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"blobs": len(self._index), "bytes": self._total}


# ---------------------------------------------------------------------------
# Durability: write-ahead journal + snapshot
# ---------------------------------------------------------------------------


class HubJournal:
    """Append-only journal + snapshot making a hub restart recoverable.

    The reference's control plane survives restarts because etcd is raft-
    replicated and the prefill queue / object store ride NATS JetStream
    (transports/etcd.rs:41-58, nats.rs:50-123).  The first-party hub gets
    the single-node equivalent: every mutation appends one framed record
    (json header + payload) to ``wal.bin``; past ``compact_every`` records
    the full state is rewritten as ``snapshot.bin`` (atomic rename) and the
    WAL truncates.  On start, snapshot then WAL replay rebuild the state.

    Leases are restored with ONE fresh TTL of grace: a surviving owner
    reconnects and keepalives within it (its keys never vanished); a dead
    owner's lease expires and drops its keys exactly as a live hub would
    have.  Keepalives themselves are not journaled (high frequency).

    Writes flush on every record; fsync only with ``DYN_HUB_FSYNC=1``
    (power-loss durability costs ~ms per mutation, process-crash
    durability is free).

    Every byte that touches disk -- WAL open, appends, rotation, snapshot
    write -- runs on ONE dedicated I/O worker thread (``_io``), never on
    the hub's event loop: a slow disk must stall the journal, not every
    connected worker's RPCs.  Submission order from the loop IS write
    order (single worker, FIFO queue), so the snapshot/rotation
    chronology the restore path depends on is preserved without locks.
    In the default (no-fsync) mode the durability point moves from "when
    the mutation returns" to "when the queued write lands" -- a few-ms
    ack-before-flush window; power-loss durability was never promised
    without fsync.  Under ``DYN_HUB_FSYNC=1`` the old contract stands:
    ``append`` BLOCKS until the record is fsynced, so a mutation is never
    acked before it is durable (that is the mode's entire point, and its
    documented ~ms/mutation price)."""

    REC_HDR = 8  # two u32 LE: header length, payload length

    def __init__(self, data_dir: str, compact_every: int = 8192) -> None:
        import concurrent.futures
        import os
        import struct

        self._struct = struct
        self.dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self.snap_path = os.path.join(data_dir, "snapshot.bin")
        self.wal_path = os.path.join(data_dir, "wal.bin")
        # mid-compaction segment: records between the state capture and the
        # snapshot landing (restore replays snapshot -> wal.old -> wal)
        self.wal_old_path = os.path.join(data_dir, "wal.old.bin")
        self.compact_every = compact_every
        self.fsync = os.environ.get("DYN_HUB_FSYNC") == "1"
        self._wal = None  # owned by the _io worker after open
        self._pending = 0
        self._compacting = False
        self._io = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="hub-journal"
        )
        self._io_failed = False

    # -- record framing ----------------------------------------------------

    def _write_record(self, f, rec: Dict[str, Any], payload: bytes) -> None:
        import json

        hdr = json.dumps(rec, separators=(",", ":")).encode()
        f.write(self._struct.pack("<II", len(hdr), len(payload)))
        f.write(hdr)
        f.write(payload)

    def _read_records(self, path: str):
        import json
        import os

        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            while True:
                head = f.read(self.REC_HDR)
                if len(head) < self.REC_HDR:
                    break  # clean end or torn tail record: stop replay here
                hlen, plen = self._struct.unpack("<II", head)
                hdr = f.read(hlen)
                payload = f.read(plen)
                if len(hdr) < hlen or len(payload) < plen:
                    logger.warning("hub journal: torn record in %s", path)
                    break
                try:
                    yield json.loads(hdr), payload
                except ValueError:
                    logger.warning("hub journal: corrupt record in %s", path)
                    break

    # -- restore -----------------------------------------------------------

    def _old_segments(self) -> List[str]:
        """Rotated-out WAL segments awaiting a snapshot, in chronological
        (replay) order: ``wal.old.bin`` first, then numbered overflow
        segments from compactions that failed before their snapshot landed
        (each number was created while every lower one already existed)."""
        import os
        import re

        out: List[str] = []
        if os.path.exists(self.wal_old_path):
            out.append(self.wal_old_path)
        pat = re.compile(
            re.escape(os.path.basename(self.wal_old_path)) + r"\.(\d+)$"
        )
        try:
            names = os.listdir(self.dir)
        except OSError:
            names = []
        extras = []
        for name in names:
            m = pat.match(name)
            if m:
                extras.append((int(m.group(1)), os.path.join(self.dir, name)))
        out.extend(p for _, p in sorted(extras))
        return out

    def load_into(self, state: HubState) -> None:
        """Snapshot + WAL replay (journaling disabled while replaying)."""
        assert state.journal is None
        max_lease = 0
        for src in (self.snap_path, *self._old_segments(), self.wal_path):
            for rec, payload in self._read_records(src):
                op = rec.get("op")
                if op == "lease":
                    lid = int(rec["id"])
                    ttl = float(rec["ttl"])
                    state.leases[lid] = time.monotonic() + ttl  # grace
                    state.lease_ttl[lid] = ttl
                    max_lease = max(max_lease, lid)
                elif op == "lease_revoke":
                    state.lease_revoke(int(rec["id"]))
                elif op == "kv_put":
                    lid = int(rec.get("lease", 0))
                    if lid and lid not in state.leases:
                        continue  # lease already gone; key would be too
                    state.kv_put(rec["key"], payload, lid)
                elif op == "kv_delete":
                    state.kv_delete(rec["key"])
                elif op == "qpush":
                    state.queues[rec["queue"]].append(payload)
                elif op == "qpop":
                    q = state.queues.get(rec["queue"])
                    if q:
                        q.popleft()
                elif op == "obj_put":
                    state.objects[rec["name"]] = payload
                elif op == "obj_del":
                    state.objects.pop(rec["name"], None)
        # fresh lease ids must not collide with restored ones
        state._lease_seq = itertools.count(max(0x1000, max_lease + 1))

    # -- append + compaction -------------------------------------------------
    #
    # The caller-facing methods below (append, compact, close) are loop-safe:
    # they only capture state and enqueue work; the file ops they imply all
    # execute on the single _io worker in submission order.

    def open(self) -> None:
        """Open the WAL for append.  Runs on the _io worker in production
        (first queued append); callable directly when no appends are in
        flight (tests driving the journal synchronously)."""
        self._wal = open(self.wal_path, "ab")

    def append(self, state: HubState, rec: Dict[str, Any], payload: bytes) -> None:
        """Queue one record for the I/O worker; never touches disk itself.

        Called from the hub's mutation path (event loop).  ``rec`` is
        framed on the worker, so callers must hand over ownership (the hub
        builds a fresh dict per mutation); ``payload`` is immutable bytes.
        """
        try:
            fut = self._io.submit(self._do_append, rec, payload)
        except RuntimeError:  # closed journal (shutdown race): drop loudly
            log_throttled(
                logger, "hub-journal-closed",
                "hub journal closed; dropping a %s record", rec.get("op"),
            )
            return
        if self.fsync:
            # DYN_HUB_FSYNC promises acked == durable: wait for the fsync
            # (the mode's documented ~ms/mutation cost) instead of letting
            # the RPC reply race the disk
            fut.result()
        self._pending += 1
        if self._pending >= self.compact_every and not self._compacting:
            # capture on the caller (the loop): the dict copies of
            # immutable values are cheap and MUST see the state exactly as
            # of the last queued append.  Rotation + snapshot write queue
            # behind the already-submitted appends, so the rotated-out
            # segment holds precisely the records the capture covers.
            self._compacting = True
            self._pending = 0
            capture = self._capture(state)
            self._io.submit(self._do_compact, capture)

    def _do_append(self, rec: Dict[str, Any], payload: bytes) -> None:
        """Worker thread: frame, write, flush (fsync if configured)."""
        import os

        from .. import thread_sentry

        thread_sentry.assert_role("hub-io", what="HubJournal._do_append")
        try:
            if self._wal is None:
                self.open()
            self._write_record(self._wal, rec, payload)
            self._wal.flush()
            if self.fsync:
                os.fsync(self._wal.fileno())
        except Exception:
            # the hub keeps serving from memory; restart-durability of the
            # records since the last good write is lost and must be loud
            log_throttled(
                logger, "hub-journal-write",
                "hub journal write failed; recent mutations will not "
                "survive a restart", level=logging.ERROR, exc_info=True,
            )
            # re-raise into the future: in fsync mode append() awaits it,
            # so a failed write fails the mutation's RPC instead of acking
            # a record that never reached disk (acked == durable)
            raise

    def _do_compact(self, capture: Dict[str, Any]) -> None:
        """Worker thread: rotate then snapshot, error-isolated."""
        try:
            self._rotate_and_snapshot(capture)
        except Exception:
            logger.exception("hub snapshot compaction failed")
        finally:
            self._compacting = False

    def _rotate_and_snapshot(self, capture: Dict[str, Any]) -> None:
        segments = self._rotate_wal()
        self._write_snapshot(capture, segments)

    def _capture(self, state: HubState) -> Dict[str, Any]:
        """Shallow-copy the state for a consistent snapshot (values are
        immutable bytes; runs on the loop, O(entries) pointer copies)."""
        now = time.monotonic()
        return {
            "leases": [
                (lid, state.lease_ttl.get(lid, max(exp - now, 1.0)))
                for lid, exp in state.leases.items()
            ],
            "kv": [
                (key, e.lease_id, e.value)
                for key, e in sorted(state.kv.items())
            ],
            "queues": {q: list(items) for q, items in state.queues.items()},
            "objects": dict(state.objects),
        }

    def _rotate_wal(self) -> List[str]:
        """Swap in a fresh WAL; returns the rotated-out segments the
        pending snapshot covers.  Always a rename, never a byte copy: when
        a previous compaction failed before its snapshot landed (wal.old
        still holds the only copy of that segment), the current WAL rotates
        into the next NUMBERED segment instead of being merge-copied onto
        wal.old on the event loop -- restore replays snapshot -> old
        segments in order -> wal, so chronology is preserved for free."""
        import os

        if self._wal is not None:
            self._wal.close()
        dst = self.wal_old_path
        if os.path.exists(dst):
            n = 1
            while os.path.exists(f"{self.wal_old_path}.{n}"):
                n += 1
            dst = f"{self.wal_old_path}.{n}"
        with contextlib.suppress(FileNotFoundError):
            os.replace(self.wal_path, dst)
        self._wal = open(self.wal_path, "wb")
        return self._old_segments()

    def _write_snapshot(
        self, capture: Dict[str, Any], segments: List[str]
    ) -> None:
        """``segments`` MUST be the old-segment list captured at rotation
        time: re-listing at deletion time (this runs in a worker thread)
        could delete a segment a racing rotation created AFTER this
        snapshot's capture -- records the snapshot does not cover."""
        import os

        tmp = self.snap_path + ".tmp"
        with open(tmp, "wb") as f:
            for lid, ttl in capture["leases"]:
                self._write_record(f, {"op": "lease", "id": lid, "ttl": ttl}, b"")
            for key, lease_id, value in capture["kv"]:
                self._write_record(
                    f, {"op": "kv_put", "key": key, "lease": lease_id}, value
                )
            for queue, items in capture["queues"].items():
                for item in items:
                    self._write_record(f, {"op": "qpush", "queue": queue}, item)
            for name, blob in capture["objects"].items():
                self._write_record(f, {"op": "obj_put", "name": name}, blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.snap_path)
        # the snapshot covers everything through the rotation point: the
        # rotated-out segments it was captured against are now redundant.
        # Delete NEWEST-first: wal.old anchors the numbered chain, so a
        # crash mid-cleanup must never leave a stale numbered segment
        # behind an already-removed wal.old (a later rotation would reuse
        # wal.old for newer records and restore would replay them BEFORE
        # the stale segment, inverting chronology)
        for path in reversed(segments):
            with contextlib.suppress(FileNotFoundError):
                os.remove(path)

    def compact(self, state: HubState) -> None:
        """Blocking compaction (tests / shutdown): capture now, then wait
        for the worker to rotate + write behind any queued appends.
        Exceptions propagate to the caller, unlike the background path."""
        capture = self._capture(state)
        self._pending = 0
        self._io.submit(self._rotate_and_snapshot, capture).result()

    def _close_wal(self) -> None:
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    def close(self) -> None:
        """Drain every queued write, close the WAL, stop the worker."""
        with contextlib.suppress(RuntimeError):  # already closed
            self._io.submit(self._close_wal)
        self._io.shutdown(wait=True)


# ---------------------------------------------------------------------------
# TCP hub server
# ---------------------------------------------------------------------------


class HubServer:
    """Serves HubState over TCP with the two-part frame codec.

    Ops are request/response correlated by ``seq``; watches, subscriptions and
    blocking queue pops push server-initiated frames tagged with their id.
    Connection drop removes that connection's watches/subs and revokes leases
    it created (so a crashed worker disappears exactly like an expired etcd
    lease in the reference).
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        data_dir: Optional[str] = None,
    ) -> None:
        self.host = host
        self.port = port
        self.state = HubState()
        self.journal: Optional[HubJournal] = None
        if data_dir:
            self.journal = HubJournal(data_dir)
            self.journal.load_into(self.state)
            self.state.journal = lambda rec, payload: self.journal.append(
                self.state, rec, payload
            )
            # KV blobs persist as files (not WAL records), served off the
            # journal's single I/O worker
            self.state.blob_store.attach_disk(
                os.path.join(data_dir, "blobs"), self.journal._io
            )
        self._server: Optional[asyncio.AbstractServer] = None
        self._expiry_task: Optional[asyncio.Task] = None
        self._conn_writers: set = set()

    async def start(self) -> Tuple[str, int]:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._expiry_task = asyncio.create_task(self._expiry_loop())
        logger.info(
            "hub listening on %s:%d%s", self.host, self.port,
            f" (journal {self.journal.dir})" if self.journal else "",
        )
        return self.host, self.port

    async def serve_forever(self) -> None:
        """Start (if needed) and run until cancelled -- the standalone-hub
        entrypoint (the ``hub`` subcommand, k8s hub Deployment)."""
        if self._server is None:
            await self.start()
        try:
            await asyncio.Event().wait()
        finally:
            await self.stop()

    async def stop(self) -> None:
        if self._expiry_task:
            self._expiry_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._expiry_task
        if self._server:
            self._server.close()
            # Force-close live connections: wait_closed() (3.12+) blocks until
            # every connection handler returns, and handlers read until EOF.
            for w in list(self._conn_writers):
                with contextlib.suppress(Exception):
                    w.close()
            await self._server.wait_closed()
        if self.journal is not None:
            # close() drains every queued write (and any in-flight
            # snapshot): that wait belongs on a thread, not on the loop a
            # colocated engine/HTTP frontend may still be serving from
            await asyncio.to_thread(self.journal.close)

    async def _expiry_loop(self) -> None:
        """Event-driven lease expiry: sleep until the EARLIEST lease
        deadline (not a fixed 2 Hz poll -- an idle hub makes zero wakeups),
        re-aimed whenever a grant introduces an earlier one.  Keepalives
        only extend deadlines, so waking at a stale deadline just finds
        nothing expired and recomputes."""
        wake = asyncio.Event()
        self.state.lease_wake = wake.set
        while True:
            self.state.expire_leases()
            # clear BEFORE reading the deadline: a grant landing between
            # the read and the wait sets the event and wakes us right back
            wake.clear()
            nxt = self.state.next_lease_expiry()
            timeout = (
                None if nxt is None else max(nxt - time.monotonic(), 0.0)
            )
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(wake.wait(), timeout)

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        st = self.state
        self._conn_writers.add(writer)
        conn_watches: list = []
        conn_subs: list = []
        conn_qwaiters: set = set()
        send_tasks: set = set()  # strong refs: loop holds only weak task refs
        send_lock = asyncio.Lock()

        async def send(hdr: Dict[str, Any], payload: bytes = b"") -> bool:
            async with send_lock:
                try:
                    write_frame(writer, hdr, payload)
                    await writer.drain()
                    return True
                except (ConnectionError, RuntimeError):
                    return False

        def send_soon(hdr: Dict[str, Any], payload: bytes = b"") -> None:
            task = asyncio.ensure_future(send(hdr, payload))
            send_tasks.add(task)
            task.add_done_callback(send_tasks.discard)

        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                hdr, payload = frame
                op = hdr.get("op")
                seq = hdr.get("seq")
                try:
                    if op == "kv_put":
                        rev = st.kv_put(hdr["key"], payload, hdr.get("lease", 0))
                        await send({"seq": seq, "ok": True, "rev": rev})
                    elif op == "kv_create":
                        try:
                            rev = st.kv_create(hdr["key"], payload, hdr.get("lease", 0))
                            await send({"seq": seq, "ok": True, "rev": rev})
                        except FileExistsError:
                            await send({"seq": seq, "ok": False, "err": "exists"})
                    elif op == "kv_get":
                        entries = st.kv_get_prefix(hdr["prefix"])
                        # values are base64-free: ship as concatenated frames
                        metas = [
                            {"key": e.key, "lease": e.lease_id, "rev": e.revision,
                             "len": len(e.value)}
                            for e in entries
                        ]
                        blob = b"".join(e.value for e in entries)
                        await send({"seq": seq, "ok": True, "entries": metas}, blob)
                    elif op == "kv_delete":
                        ok = st.kv_delete(hdr["key"])
                        await send({"seq": seq, "ok": ok})
                    elif op == "kv_delete_prefix":
                        n = st.kv_delete_prefix(hdr["prefix"])
                        await send({"seq": seq, "ok": True, "count": n})
                    elif op == "lease_grant":
                        lease = st.lease_grant(float(hdr["ttl"]))
                        await send({"seq": seq, "ok": True, "lease": lease})
                    elif op == "lease_keepalive":
                        ok = st.lease_keepalive(hdr["lease"])
                        await send({"seq": seq, "ok": ok})
                    elif op == "lease_revoke":
                        st.lease_revoke(hdr["lease"])
                        await send({"seq": seq, "ok": True})
                    elif op == "watch":
                        prefix = hdr["prefix"]

                        def on_event(ev: WatchEvent, _wid_holder=[None]) -> None:
                            send_soon(
                                {"watch": _wid_holder[0], "type": ev.type,
                                 "key": ev.key},
                                ev.value,
                            )

                        holder = on_event.__defaults__[0]
                        wid = st.watch_add(prefix, on_event)
                        holder[0] = wid
                        conn_watches.append(wid)
                        entries = st.kv_get_prefix(prefix)
                        metas = [
                            {"key": e.key, "len": len(e.value)} for e in entries
                        ]
                        blob = b"".join(e.value for e in entries)
                        await send(
                            {"seq": seq, "ok": True, "watch_id": wid,
                             "entries": metas},
                            blob,
                        )
                    elif op == "unwatch":
                        st.watch_remove(hdr["watch_id"])
                        await send({"seq": seq, "ok": True})
                    elif op == "subscribe":
                        pattern = hdr["pattern"]

                        def on_msg(subject: str, data: bytes, _sid_holder=[None]):
                            send_soon(
                                {"sub": _sid_holder[0], "subject": subject}, data
                            )

                        sholder = on_msg.__defaults__[0]
                        sid = st.subscribe(pattern, on_msg)
                        sholder[0] = sid
                        conn_subs.append(sid)
                        await send({"seq": seq, "ok": True, "sub_id": sid})
                    elif op == "unsubscribe":
                        st.unsubscribe(hdr["sub_id"])
                        await send({"seq": seq, "ok": True})
                    elif op == "publish":
                        n = st.publish(hdr["subject"], payload)
                        await send({"seq": seq, "ok": True, "receivers": n})
                    elif op == "queue_push":
                        st.queue_push(hdr["queue"], payload)
                        await send({"seq": seq, "ok": True})
                    elif op == "queue_pop":
                        item = st.queue_try_pop(hdr["queue"])
                        if item is not None:
                            await send({"seq": seq, "ok": True, "found": True}, item)
                        elif not hdr.get("block"):
                            await send({"seq": seq, "ok": True, "found": False})
                        else:
                            fut = st.queue_wait(hdr["queue"])
                            conn_qwaiters.add(fut)
                            qname = hdr["queue"]

                            async def deliver_job(
                                payload: bytes, _seq=seq, _q=qname
                            ) -> None:
                                ok = await send(
                                    {"seq": _seq, "ok": True, "found": True},
                                    payload,
                                )
                                if not ok:
                                    # Consumer died mid-delivery: requeue so
                                    # the job is not lost (at-least-once).
                                    st.queue_push(_q, payload)

                            def deliver(f: asyncio.Future) -> None:
                                conn_qwaiters.discard(f)
                                if not f.cancelled():
                                    task = asyncio.ensure_future(
                                        deliver_job(f.result())
                                    )
                                    send_tasks.add(task)
                                    task.add_done_callback(send_tasks.discard)

                            fut.add_done_callback(deliver)
                    elif op == "queue_depth":
                        await send(
                            {"seq": seq, "ok": True,
                             "depth": st.queue_depth(hdr["queue"])}
                        )
                    elif op == "obj_put":
                        st.obj_put(hdr["name"], payload)
                        await send({"seq": seq, "ok": True})
                    elif op == "obj_get":
                        blob = st.objects.get(hdr["name"])
                        if blob is None:
                            await send({"seq": seq, "ok": False, "err": "not found"})
                        else:
                            await send({"seq": seq, "ok": True}, blob)
                    elif op == "obj_del":
                        existed = st.obj_del(hdr["name"])
                        await send({"seq": seq, "ok": True, "found": existed})
                    elif op == "blob_put":
                        await st.blob_store.put(hdr["name"], payload)
                        await send({"seq": seq, "ok": True})
                    elif op == "blob_get":
                        blob = await st.blob_store.get(hdr["name"])
                        if blob is None:
                            await send(
                                {"seq": seq, "ok": False, "err": "not found"}
                            )
                        else:
                            await send({"seq": seq, "ok": True}, blob)
                    elif op == "blob_del":
                        existed = await st.blob_store.delete(hdr["name"])
                        await send({"seq": seq, "ok": True, "found": existed})
                    elif op == "blob_stats":
                        await send(
                            {"seq": seq, "ok": True, **st.blob_store.stats()}
                        )
                    elif op == "ping":
                        await send({"seq": seq, "ok": True})
                    else:
                        await send({"seq": seq, "ok": False, "err": f"bad op {op}"})
                except Exception as exc:  # noqa: BLE001 - report, keep serving
                    logger.exception("hub op %s failed", op)
                    await send({"seq": seq, "ok": False, "err": str(exc)})
        except ConnectionError as exc:
            logger.warning("hub connection failed mid-frame: %s", exc)
        finally:
            for wid in conn_watches:
                st.watch_remove(wid)
            for sid in conn_subs:
                st.unsubscribe(sid)
            # etcd semantics for conn loss: the lease is NOT revoked on a
            # dropped connection -- its keepalives simply stop, and it
            # expires after its TTL unless the owner reconnects (client
            # reconnect_window) and resumes them.  Instant revocation here
            # would make any transient disconnect erase a live worker's
            # registration behind its back (and, with a journal, persist
            # the erasure).  Crash detection latency is therefore <= TTL,
            # exactly as with reference etcd leases (transports/etcd.rs).
            # Graceful shutdown still revokes explicitly (lease_revoke op).
            # Cancel parked blocking pops so a future queue_push doesn't hand
            # a job to this dead connection (queue_push skips done futures).
            for fut in list(conn_qwaiters):
                if not fut.done():
                    fut.cancel()
            self._conn_writers.discard(writer)
            with contextlib.suppress(Exception):
                writer.close()
