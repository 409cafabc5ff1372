"""KvIndexer: which worker holds which KV blocks.

Rebuild of the reference radix-tree indexer (lib/llm/src/kv_router/
indexer.rs:187 RadixTree, :239 find_matches with early exit, :283
apply_event, :382 remove_worker).  Because this framework's sequence hashes
already bind the full prefix chain (parent-chained hashing,
dynamo_tpu/tokens/hashing.py), the radix tree collapses to a flat map keyed
by sequence hash: level-i lookup is one O(1) probe, and the walk stops at
the first level held by nobody -- the same early exit as the reference's
radix descent.

Hot path is native (native/radix.cpp via ctypes); the pure-Python fallback
implements identical semantics.  Single-threaded by contract: one asyncio
event loop owns each indexer (the reference runs its tree in a dedicated
single-threaded actor for the same reason).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ...tokens import hashing as _hashing


@dataclass
class OverlapScores:
    """Per-worker count of matched prefix blocks (reference indexer.rs
    OverlapScores).  Selection happens in the scheduler's cost function."""

    scores: Dict[int, int] = field(default_factory=dict)


class _PyIndex:
    """Pure-Python flat-map index; mirrors native/radix.cpp exactly."""

    def __init__(self) -> None:
        self.blocks: Dict[int, Set[int]] = {}
        self.by_worker: Dict[int, Set[int]] = {}

    def store(self, worker: int, hashes: Sequence[int]) -> None:
        mine = self.by_worker.setdefault(worker, set())
        for h in hashes:
            self.blocks.setdefault(h, set()).add(worker)
            mine.add(h)

    def remove(self, worker: int, hashes: Sequence[int]) -> None:
        mine = self.by_worker.get(worker)
        for h in hashes:
            ws = self.blocks.get(h)
            if ws is not None:
                ws.discard(worker)
                if not ws:
                    del self.blocks[h]
            if mine is not None:
                mine.discard(h)

    def remove_worker(self, worker: int) -> None:
        mine = self.by_worker.pop(worker, None)
        if not mine:
            return
        for h in mine:
            ws = self.blocks.get(h)
            if ws is not None:
                ws.discard(worker)
                if not ws:
                    del self.blocks[h]

    def find_matches(
        self, hashes: Sequence[int], early_exit: bool = True
    ) -> Dict[int, int]:
        scores: Dict[int, int] = {}
        for h in hashes:
            ws = self.blocks.get(h)
            if not ws:
                if early_exit:
                    break  # deeper blocks chain through this one
                continue
            for w in ws:
                scores[w] = scores.get(w, 0) + 1
        return scores

    def coverage(self, hashes: Sequence[int]) -> List[bool]:
        """Per-position: does ANY worker here hold the hash (sharded merge)."""
        return [bool(self.blocks.get(h)) for h in hashes]

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    @property
    def num_workers(self) -> int:
        return len(self.by_worker)


class _NativeIndex:
    """ctypes wrapper over native/radix.cpp."""

    MAX_WORKERS = 4096

    def __init__(self, lib: ctypes.CDLL) -> None:
        self._lib = lib
        lib.dyn_radix_new.restype = ctypes.c_void_p
        lib.dyn_radix_free.argtypes = [ctypes.c_void_p]
        lib.dyn_radix_store.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.dyn_radix_remove.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.dyn_radix_remove_worker.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.dyn_radix_find_matches.restype = ctypes.c_size_t
        lib.dyn_radix_find_matches.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.dyn_radix_num_blocks.restype = ctypes.c_size_t
        lib.dyn_radix_num_blocks.argtypes = [ctypes.c_void_p]
        lib.dyn_radix_num_workers.restype = ctypes.c_size_t
        lib.dyn_radix_num_workers.argtypes = [ctypes.c_void_p]
        # sharded-index entry points (absent in pre-r4 cached builds; the
        # sharded wrapper degrades to the py index when missing)
        self.has_sharded_api = hasattr(lib, "dyn_radix_find_matches_all")
        if self.has_sharded_api:
            lib.dyn_radix_find_matches_all.restype = ctypes.c_size_t
            lib.dyn_radix_find_matches_all.argtypes = (
                lib.dyn_radix_find_matches.argtypes
            )
            lib.dyn_radix_coverage.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p,
            ]
        self._ptr = lib.dyn_radix_new()
        # reused across queries (single-threaded by contract): find_matches
        # is the per-request routing hot path
        self._out_w = np.empty(self.MAX_WORKERS, dtype=np.uint64)
        self._out_s = np.empty(self.MAX_WORKERS, dtype=np.uint32)

    def __del__(self) -> None:
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr:
            self._lib.dyn_radix_free(ptr)

    @staticmethod
    def _arr(hashes: Sequence[int]) -> np.ndarray:
        return np.ascontiguousarray(np.asarray(hashes, dtype=np.uint64))

    def store(self, worker: int, hashes: Sequence[int]) -> None:
        a = self._arr(hashes)
        self._lib.dyn_radix_store(self._ptr, worker, a.ctypes.data, len(a))

    def remove(self, worker: int, hashes: Sequence[int]) -> None:
        a = self._arr(hashes)
        self._lib.dyn_radix_remove(self._ptr, worker, a.ctypes.data, len(a))

    def remove_worker(self, worker: int) -> None:
        self._lib.dyn_radix_remove_worker(self._ptr, worker)

    def find_matches(
        self, hashes: Sequence[int], early_exit: bool = True
    ) -> Dict[int, int]:
        a = self._arr(hashes)
        out_w, out_s = self._out_w, self._out_s
        fn = (
            self._lib.dyn_radix_find_matches
            if early_exit
            else self._lib.dyn_radix_find_matches_all
        )
        k = fn(
            self._ptr, a.ctypes.data, len(a),
            out_w.ctypes.data, out_s.ctypes.data, self.MAX_WORKERS,
        )
        return {int(out_w[i]): int(out_s[i]) for i in range(k)}

    def coverage(self, hashes: Sequence[int]) -> List[bool]:
        a = self._arr(hashes)
        out = np.zeros(len(a), dtype=np.uint8)
        self._lib.dyn_radix_coverage(
            self._ptr, a.ctypes.data, len(a), out.ctypes.data
        )
        return [bool(x) for x in out]

    @property
    def num_blocks(self) -> int:
        return self._lib.dyn_radix_num_blocks(self._ptr)

    @property
    def num_workers(self) -> int:
        return self._lib.dyn_radix_num_workers(self._ptr)


# Pseudo worker id the G4 fleet store answers prefix_sources under
# (mirrors offload.G4_STORE_ID without importing the offload plane)
REMOTE_SOURCE_ID = -4


class HoldingsIndex:
    """Cluster-global offload-tier holdings: which worker parks which
    block in which tier (G2 host / G3 disk / G4 remote), at what size.

    The G1 index above answers "route to the warm worker"; this one
    answers "fetch the prefix from a peer's tiers or from the G4 store".
    Fed by the workers' ``kv_holdings`` topic (tier residency deltas from
    the offload plane -- every put/promote/demote/evict publishes, so
    the index never advertises a tier a worker already dropped).

    ``tier == "remote"`` adverts are keyed under :data:`REMOTE_SOURCE_ID`
    rather than the publishing worker: a blob in the fleet store is
    fetchable regardless of which worker uploaded it, and its lifecycle
    is the STORE's, not the uploader's -- the worker later evicting its
    own host copy (a ``tier=None`` row) or dying must not wipe the G4
    advert while the blob still sits in the store.  A stale G4 advert
    (the store LRU'd the blob out) self-heals as a fetch miss: the
    onboarder recomputes, and the fetching tier forgets the hash.
    Single-threaded by contract, like the owning indexer."""

    def __init__(self) -> None:
        # hash -> {source_id: (tier, nbytes)}; source is the holding
        # worker, or REMOTE_SOURCE_ID for fleet-store entries
        self._by_hash: Dict[int, Dict[int, tuple]] = {}
        self._by_worker: Dict[int, Set[int]] = {}

    def apply(self, worker_id: int, delta: Sequence[Dict]) -> None:
        """Merge one holdings delta: rows ``{"sequence_hash", "tier",
        "nbytes"}``; ``tier=None`` drops the worker's entry (never the
        fleet store's -- see the class docstring)."""
        worker_id = int(worker_id)
        mine = self._by_worker.setdefault(worker_id, set())
        for row in delta:
            try:
                h = int(row["sequence_hash"])
            except (KeyError, TypeError, ValueError):
                continue
            tier = row.get("tier")
            if tier is None:
                holders = self._by_hash.get(h)
                if holders is not None:
                    holders.pop(worker_id, None)
                    if not holders:
                        del self._by_hash[h]
                mine.discard(h)
            else:
                src = REMOTE_SOURCE_ID if tier == "remote" else worker_id
                self._by_hash.setdefault(h, {})[src] = (
                    str(tier),
                    int(row.get("nbytes") or 0),
                )
                if src == worker_id:
                    mine.add(h)
        if not mine:
            self._by_worker.pop(worker_id, None)

    def remove_worker(self, worker_id: int) -> None:
        """Forget a dead worker's own-tier holdings.  Its G4 adverts stay:
        the store outlives the worker and the blobs remain fetchable."""
        mine = self._by_worker.pop(int(worker_id), None)
        if not mine:
            return
        for h in mine:
            holders = self._by_hash.get(h)
            if holders is not None:
                holders.pop(int(worker_id), None)
                if not holders:
                    del self._by_hash[h]

    def holders(self, seq_hash: int) -> Dict[int, tuple]:
        return dict(self._by_hash.get(int(seq_hash), {}))

    def prefix_sources(
        self, sequence_hashes: Sequence[int], exclude: Sequence[int] = ()
    ) -> Dict[int, Dict[str, int]]:
        """Per-source contiguous-prefix holdings over the request's block
        chain: ``{source_id: {"blocks": n, "nbytes": total, "tier": t}}``
        where ``blocks`` counts how many leading chain blocks the source
        holds contiguously from position 0 (prefix chains are only usable
        contiguously, same contract as the offload prefetch walk).  G4
        entries aggregate under ``REMOTE_SOURCE_ID``; ``exclude`` drops
        candidate workers (the chosen worker itself, quarantined ids)."""
        excluded = {int(w) for w in exclude}
        out: Dict[int, Dict[str, int]] = {}
        for i, h in enumerate(sequence_hashes):
            holders = self._by_hash.get(int(h))
            if not holders:
                break  # nobody holds position i: deeper blocks unusable
            for worker_id, (tier, nbytes) in holders.items():
                src = REMOTE_SOURCE_ID if tier == "remote" else worker_id
                if src != REMOTE_SOURCE_ID and src in excluded:
                    continue
                ent = out.get(src)
                if ent is None:
                    if i == 0:
                        out[src] = {"blocks": 1, "nbytes": nbytes, "tier": tier}
                elif ent["blocks"] == i:
                    ent["blocks"] = i + 1
                    ent["nbytes"] += nbytes
        return {s: e for s, e in out.items() if e["blocks"] > 0}

    @property
    def num_blocks(self) -> int:
        return len(self._by_hash)

    @property
    def num_workers(self) -> int:
        return len(self._by_worker)


class KvIndexer:
    """The router-side global KV-block index.

    Consumes worker KV events (``stored`` / ``removed`` / ``cleared``) and
    answers ``find_matches`` queries with per-worker overlap scores.  The
    attached :class:`HoldingsIndex` extends the view below G1: holdings
    events (``holdings`` / ``holdings_cleared``) track which offload tier
    parks which block fleet-wide.
    """

    def __init__(self, block_size: int = 16, use_native: bool = True) -> None:
        self.block_size = block_size
        lib = _hashing.NATIVE if use_native else None
        self._index = (
            _NativeIndex(lib)
            if lib is not None and hasattr(lib, "dyn_radix_new")
            else _PyIndex()
        )
        self.native = isinstance(self._index, _NativeIndex)
        self.holdings = HoldingsIndex()

    # -- event ingestion -----------------------------------------------------

    def apply_event(self, worker_id: int, event: Dict) -> None:
        """Apply one worker KV event (reference indexer.rs:283).

        Shapes (as emitted by JaxEngine/_publish_stored and the mocker):
          {"type": "stored", "blocks": [{"sequence_hash": h, ...}, ...]}
          {"type": "removed", "sequence_hashes": [h, ...]}
          {"type": "cleared"}
        plus the offload plane's tier-residency stream (KvHoldingsPublisher):
          {"type": "holdings", "delta": [{"sequence_hash", "tier", "nbytes"}]}
          {"type": "holdings_cleared"}  (publisher overflow collapse)
        """
        etype = event.get("type")
        if etype == "stored":
            hashes = [int(b["sequence_hash"]) for b in event.get("blocks", [])]
            self._index.store(worker_id, hashes)
        elif etype == "removed":
            self._index.remove(
                worker_id, [int(h) for h in event.get("sequence_hashes", [])]
            )
        elif etype == "cleared":
            self._index.remove_worker(worker_id)
            self.holdings.remove_worker(worker_id)
        elif etype == "holdings":
            self.holdings.apply(worker_id, event.get("delta", []))
        elif etype == "holdings_cleared":
            self.holdings.remove_worker(worker_id)

    def remove_worker(self, worker_id: int) -> None:
        """Drop every entry of a dead worker (reference indexer.rs:382)."""
        self._index.remove_worker(worker_id)
        self.holdings.remove_worker(worker_id)

    # -- queries -------------------------------------------------------------

    def find_matches(self, sequence_hashes: Sequence[int]) -> OverlapScores:
        return OverlapScores(scores=self._index.find_matches(sequence_hashes))

    def find_matches_for_tokens(self, tokens: Sequence[int]) -> OverlapScores:
        _, seq_hashes = _hashing.hash_blocks(tokens, self.block_size)
        return self.find_matches(seq_hashes)

    @property
    def num_blocks(self) -> int:
        return self._index.num_blocks

    @property
    def num_workers(self) -> int:
        return self._index.num_workers


class KvIndexerSharded:
    """Worker-sharded KV index (reference indexer.rs:696 KvIndexerSharded).

    Large fleets overwhelm one index: the reference pins each worker to a
    shard (least-loaded assignment), routes that worker's event stream to
    its shard's thread, broadcasts match requests to every shard, and
    merges the per-shard overlap scores.  Same structure here over N
    :class:`KvIndexer` shards; a match executes the shards through a small
    thread pool when the native index is in use (the ctypes calls drop the
    GIL, so shard matching genuinely overlaps), and falls back to a
    sequential sweep on the pure-Python index.
    """

    def __init__(
        self,
        block_size: int = 16,
        num_shards: int = 4,
        use_native: bool = True,
    ) -> None:
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.block_size = block_size
        self.shards = [
            KvIndexer(block_size, use_native=use_native)
            for _ in range(num_shards)
        ]
        if self.shards[0].native and not getattr(
            self.shards[0]._index, "has_sharded_api", False
        ):
            # stale pre-r4 native build without coverage/no-exit entry
            # points: correctness over speed, use the python index
            self.shards = [
                KvIndexer(block_size, use_native=False)
                for _ in range(num_shards)
            ]
        self._assignment: Dict[int, int] = {}  # worker -> shard
        self._counts = [0] * num_shards
        # ONE wrapper-level holdings index (tier adverts are tiny next to
        # G1 block sets; sharding them would force a merge per query)
        self.holdings = HoldingsIndex()
        self._pool = None
        if self.shards[0].native and num_shards > 1:
            import concurrent.futures

            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=num_shards, thread_name_prefix="kv-index-shard"
            )

    def _shard_of(self, worker_id: int) -> int:
        s = self._assignment.get(worker_id)
        if s is None:
            # least-loaded assignment (reference worker_counts)
            s = min(range(len(self.shards)), key=lambda i: self._counts[i])
            self._assignment[worker_id] = s
            self._counts[s] += 1
        return s

    def apply_event(self, worker_id: int, event: Dict) -> None:
        etype = event.get("type")
        if etype == "cleared":
            # the flat index forgets the worker entirely on "cleared"; the
            # assignment and load count must follow, or dead-cleared
            # workers skew least-loaded pinning forever
            self.remove_worker(worker_id)
            return
        if etype == "holdings":
            self.holdings.apply(worker_id, event.get("delta", []))
            return
        if etype == "holdings_cleared":
            self.holdings.remove_worker(worker_id)
            return
        self.shards[self._shard_of(worker_id)].apply_event(worker_id, event)

    def remove_worker(self, worker_id: int) -> None:
        self.holdings.remove_worker(worker_id)
        s = self._assignment.pop(worker_id, None)
        if s is not None:
            self._counts[s] -= 1
            self.shards[s].remove_worker(worker_id)

    def find_matches(self, sequence_hashes: Sequence[int]) -> OverlapScores:
        """Two-pass match preserving the flat index's semantics exactly.

        The flat walk stops at the first hash held by NO worker fleet-wide;
        a single shard cannot see that boundary (a hole in its own workers'
        holdings is not a fleet-wide hole).  Pass 1 ORs per-shard coverage
        to find the global early-exit point; pass 2 sweeps each shard over
        the truncated chain without a shard-local exit and merges (worker
        sets are disjoint across shards)."""
        hashes = list(sequence_hashes)
        if not hashes:
            return OverlapScores(scores={})

        def shard_cov(sh):
            return sh._index.coverage(hashes)

        if self._pool is not None:
            covs = list(self._pool.map(shard_cov, self.shards))
        else:
            covs = [shard_cov(sh) for sh in self.shards]
        L = len(hashes)
        for i in range(len(hashes)):
            if not any(c[i] for c in covs):
                L = i
                break
        prefix = hashes[:L]
        if not prefix:
            return OverlapScores(scores={})

        def shard_match(sh):
            return sh._index.find_matches(prefix, early_exit=False)

        if self._pool is not None:
            results = list(self._pool.map(shard_match, self.shards))
        else:
            results = [shard_match(sh) for sh in self.shards]
        merged: Dict[int, int] = {}
        for r in results:
            merged.update(r)
        return OverlapScores(scores=merged)

    def find_matches_for_tokens(self, tokens: Sequence[int]) -> OverlapScores:
        _, seq_hashes = _hashing.hash_blocks(tokens, self.block_size)
        return self.find_matches(seq_hashes)

    def close(self) -> None:
        """Release the shard-matching thread pool (long-lived routers that
        rebuild their index must not leak a pool per rebuild)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    @property
    def num_blocks(self) -> int:
        # sum of per-shard uniques: a block cached by workers on different
        # shards counts once per shard (the reference's per-shard tries
        # have the same property)
        return sum(sh.num_blocks for sh in self.shards)

    @property
    def num_workers(self) -> int:
        return len(self._assignment)
