"""Block manager (KVBM v1): the G1 page pool with a sequence-hash reuse
registry.

A copy of the JAX package's ``block_manager.py``.  Rebuild of the
reference block pool (lib/llm/src/block_manager/pool.rs:
339-444 allocate/register/match_sequence_hashes with reuse-priority
eviction; block/registry.rs sequence-hash registry), reshaped for the
paged KV layout: a "block" is ``pages_per_block`` consecutive KV
pages holding exactly one router-visible token block, identified by that
block's chained sequence hash.

States of a page:
  * **free** -- on the free list, contents dead.
  * **owned** -- allocated to one sequence (tail / growth pages), unshared.
  * **registered-active** -- part of a completed block some sequence(s)
    reference (refcount > 0).  Shared read-only.
  * **registered-inactive** -- completed block nobody references.  Contents
    still valid: a later request with the same prefix *reuses* it
    (``match`` + ``acquire``).  Reclaimed LRU-last when the free list runs
    dry -- that is the reuse-priority eviction.

Eviction publishes a ``removed`` KV event through ``event_sink`` so the
router's index never over-states residency; registration publishes
``stored``.  (The engine wires ``event_sink`` to its ``kv_event_sink``.)

G2 (host RAM) / G3 (disk) offload tiers compose on top of this module: the
``on_evict`` hook fires with the block *before* its pages return to the
free list (still under the pool lock, so no other thread can reuse the
pages until the hook's device read is enqueued); the engine wires it to
``offload.KVOffloadEngine`` so the wait for the snapshot's host copy
happens on the dedicated offload thread, never here.
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class OutOfPages(RuntimeError):
    pass


@dataclass
class RegisteredBlock:
    sequence_hash: int
    pages: Tuple[int, ...]
    refs: int = 1
    # router-facing identity, carried into stored events
    block_hash: int = 0
    parent_sequence_hash: int = 0
    position: int = 0


class PagePool:
    """Page allocator + block reuse registry over page ids 1..num_pages-1
    (page 0 is the trash page for inactive batch lanes)."""

    def __init__(
        self,
        num_pages: int,
        pages_per_block: int = 1,
        event_sink: Optional[Callable[[dict], None]] = None,
    ) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        if pages_per_block < 1:
            raise ValueError("pages_per_block must be >= 1")
        self.num_pages = num_pages
        self.pages_per_block = pages_per_block
        self.event_sink = event_sink
        # offload hook: called with the RegisteredBlock *before* its pages
        # return to the free list, so the owner can snapshot the contents
        # (G1 -> G2 demotion; the engine wires this to a device gather
        # enqueued on the stream of the dispatches that may reuse the pages)
        self.on_evict: Optional[Callable[[RegisteredBlock], None]] = None
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._registered: Dict[int, RegisteredBlock] = {}
        # LRU over refs==0 registered blocks (insertion-ordered)
        self._inactive: "collections.OrderedDict[int, None]" = (
            collections.OrderedDict()
        )
        self.prefix_hits = 0
        self.prefix_lookups = 0
        # reuse-priority evictions performed (each one is an offload
        # opportunity: the tier-occupancy story starts here)
        self.evictions = 0
        # alloc/free/registry mutations are locked: the scheduler runs on
        # the tick-loop thread while commits register blocks on the
        # engine's executor thread
        self._lock = threading.RLock()

    # -- capacity ------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        """Immediately allocatable pages: free list + evictable inactive."""
        return len(self._free) + len(self._inactive) * self.pages_per_block

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - self.free_pages

    @property
    def resident_pages(self) -> int:
        """Pages whose contents are live or reusable (excludes only free)."""
        return (self.num_pages - 1) - len(self._free)

    # -- allocation ----------------------------------------------------------

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages: free list first, then LRU eviction of inactive
        registered blocks (reuse-priority: most recently released last)."""
        if n <= 0:
            return []
        with self._lock:
            while len(self._free) < n and self._inactive:
                self._evict_one()
            if len(self._free) < n:
                raise OutOfPages(
                    f"requested {n} pages, {len(self._free)} free"
                )
            out = self._free[-n:][::-1]
            del self._free[len(self._free) - n:]
            return out

    def free(self, pages: Sequence[int]) -> None:
        """Return *owned* (unregistered) pages to the free list."""
        with self._lock:
            self._free.extend(pages)

    def _evict_one(self) -> None:
        seq_hash, _ = self._inactive.popitem(last=False)
        blk = self._registered.pop(seq_hash)
        self.evictions += 1
        if self.on_evict is not None:
            try:
                self.on_evict(blk)
            except Exception:  # offload is best-effort; eviction is not
                import logging

                logging.getLogger("dynamo.offload").exception(
                    "on_evict hook failed for block %x", seq_hash
                )
        self._free.extend(blk.pages)
        if self.event_sink is not None:
            self.event_sink(
                {"type": "removed", "sequence_hashes": [seq_hash]}
            )

    # -- registry ------------------------------------------------------------

    def match(self, sequence_hashes: Sequence[int]) -> List[RegisteredBlock]:
        """Longest resident prefix of ``sequence_hashes`` (reference
        pool.rs match_sequence_hashes).  Does not take references."""
        with self._lock:
            out: List[RegisteredBlock] = []
            for h in sequence_hashes:
                blk = self._registered.get(h)
                if blk is None:
                    break
                out.append(blk)
            self.prefix_lookups += len(sequence_hashes)
            self.prefix_hits += len(out)
            return out

    def acquire(self, sequence_hash: int) -> Optional[RegisteredBlock]:
        """Take a reference on a resident block (revives inactive)."""
        with self._lock:
            blk = self._registered.get(sequence_hash)
            if blk is None:
                return None
            if blk.refs == 0:
                self._inactive.pop(sequence_hash, None)
            blk.refs += 1
            return blk

    def register(
        self,
        sequence_hash: int,
        pages: Sequence[int],
        *,
        block_hash: int = 0,
        parent_sequence_hash: int = 0,
        position: int = 0,
    ) -> bool:
        """Register a completed block's pages under its sequence hash; the
        registrant holds one reference.  Returns False (caller keeps plain
        ownership of the pages) when the hash is already registered --
        duplicate content from concurrent identical prefixes."""
        if len(pages) != self.pages_per_block:
            raise ValueError(
                f"block needs {self.pages_per_block} pages, got {len(pages)}"
            )
        with self._lock:
            if sequence_hash in self._registered:
                return False
            self._registered[sequence_hash] = RegisteredBlock(
                sequence_hash=sequence_hash,
                pages=tuple(pages),
                refs=1,
                block_hash=block_hash,
                parent_sequence_hash=parent_sequence_hash,
                position=position,
            )
        if self.event_sink is not None:
            self.event_sink(
                {
                    "type": "stored",
                    "blocks": [
                        {
                            "block_hash": block_hash,
                            "sequence_hash": sequence_hash,
                            "parent_sequence_hash": parent_sequence_hash,
                            "position": position,
                        }
                    ],
                }
            )
        return True

    def release(self, sequence_hash: int) -> None:
        """Drop one reference; at zero the block turns inactive (reusable,
        evictable LRU)."""
        with self._lock:
            blk = self._registered.get(sequence_hash)
            if blk is None:
                return
            if blk.refs <= 0:
                raise RuntimeError(
                    f"negative refs for block {sequence_hash:x}"
                )
            blk.refs -= 1
            if blk.refs == 0:
                self._inactive[sequence_hash] = None
                self._inactive.move_to_end(sequence_hash)

    def is_registered(self, sequence_hash: int) -> bool:
        return sequence_hash in self._registered

    @property
    def num_registered(self) -> int:
        return len(self._registered)

    @property
    def num_inactive(self) -> int:
        return len(self._inactive)

    @property
    def hit_rate(self) -> float:
        return (
            self.prefix_hits / self.prefix_lookups if self.prefix_lookups else 0.0
        )
