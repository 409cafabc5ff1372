"""Mock paged-KV block manager: refcounted active pool + LRU inactive pool.

Behavioral rebuild of the reference mocker's KvManager / LRUEvictor
(lib/llm/src/mocker/kv_manager.rs:55-230, evictor.rs): blocks are identified
by sequence hash (full blocks) or a per-request partial id; ``use``ing a
block hits the active pool (refcount++), revives it from the inactive pool,
or allocates -- evicting LRU inactive blocks when at capacity, and failing
(=> scheduler preempts) when nothing is evictable.  Deref moves
zero-refcount blocks to the inactive (reusable, evictable) pool -- that is
what makes the mock prefix cache honest: a later request ``use``-ing the
same sequence hashes revives them instead of allocating.

Residency events (``stored`` on first allocation, ``removed`` on eviction)
are surfaced through an optional sink -- the same event shape the real
engine publishes to the KV router.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence


class LRUEvictor:
    """Insertion-refreshed LRU set (reference mocker/evictor.rs)."""

    def __init__(self) -> None:
        self._od: "collections.OrderedDict[int, None]" = collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._od)

    def __contains__(self, key: int) -> bool:
        return key in self._od

    def insert(self, key: int) -> None:
        self._od[key] = None
        self._od.move_to_end(key)

    def remove(self, key: int) -> bool:
        return self._od.pop(key, False) is None

    def evict(self) -> Optional[int]:
        if not self._od:
            return None
        key, _ = self._od.popitem(last=False)
        return key

    def keys(self) -> List[int]:
        return list(self._od.keys())


@dataclass
class PrefillCost:
    """Admission cost estimate (reference mocker try_schedule)."""

    new_blocks: int
    new_tokens: int
    cached_tokens: int

    @property
    def prefill_compute(self) -> float:
        """Quadratic-ish prefill cost: (cached + new) * new."""
        return float((self.cached_tokens + self.new_tokens) * self.new_tokens)


class MockKvManager:
    """Synchronous block-movement simulator.

    Block keys are ints: full blocks use the sequence hash; partial
    (still-filling) blocks use a unique negative id so they can never
    collide with hashes or each other.
    """

    def __init__(
        self,
        max_capacity: int,
        block_size: int,
        event_sink: Optional[Callable[[dict], None]] = None,
    ) -> None:
        self.max_capacity = max_capacity
        self.block_size = block_size
        self.event_sink = event_sink
        self.active: Dict[int, int] = {}  # key -> refcount
        self.inactive = LRUEvictor()
        self.all_blocks: set = set()

    # -- capacity observers --------------------------------------------------

    @property
    def current_capacity(self) -> int:
        return len(self.active) + len(self.inactive)

    @property
    def usage_perc(self) -> float:
        return self.current_capacity / self.max_capacity if self.max_capacity else 0.0

    @property
    def num_active_blocks(self) -> int:
        return len(self.active)

    def probe_new_blocks(self, keys: Sequence[int]) -> int:
        return sum(1 for k in keys if k not in self.all_blocks)

    def probe_cached_blocks(self, keys: Sequence[int]) -> int:
        """Resident full blocks a request would reuse (prefix-hit count)."""
        return sum(1 for k in keys if k in self.all_blocks)

    # -- block movement ------------------------------------------------------

    def use(self, keys: Sequence[int]) -> bool:
        """Acquire blocks (prefix reuse when resident).  False = out of
        space and nothing evictable: the caller must preempt.  Atomic: on
        failure no refcounts are left behind.

        Two passes: resident keys (active or inactive) are acquired first so
        at-capacity eviction can never claim a block that appears later in
        the same batch -- evicting a request's own cached prefix would emit
        a spurious removed+stored pair and invalidate the cached_tokens
        estimate try_schedule just computed."""
        applied: List[int] = []
        fresh: List[int] = []
        for key in keys:
            if key in self.active:
                self.active[key] += 1
                applied.append(key)
            elif self.inactive.remove(key):
                self.active[key] = 1
                applied.append(key)
            else:
                fresh.append(key)
        for key in fresh:
            if key in self.active:  # duplicate new key within this batch
                self.active[key] += 1
                applied.append(key)
                continue
            if self.current_capacity >= self.max_capacity:
                evicted = self.inactive.evict()
                if evicted is None:
                    self.deref(applied)
                    return False
                self.all_blocks.discard(evicted)
                self._emit_removed(evicted)
            self.active[key] = 1
            self.all_blocks.add(key)
            applied.append(key)
            if key >= 0:
                self._emit_stored(key)
        return True

    def deref(self, keys: Sequence[int]) -> None:
        """Release references; zero-ref blocks become inactive (reusable)."""
        for key in reversed(list(keys)):
            ref = self.active.get(key)
            if ref is None:
                continue
            if ref <= 0:
                raise RuntimeError(f"negative refcount for block {key}")
            ref -= 1
            if ref == 0:
                del self.active[key]
                if key >= 0:
                    self.inactive.insert(key)
                else:
                    # partial blocks have no identity to reuse; drop them
                    self.all_blocks.discard(key)
            else:
                self.active[key] = ref

    def destroy(self, keys: Sequence[int]) -> None:
        for key in reversed(list(keys)):
            self.active.pop(key, None)
            self.all_blocks.discard(key)

    def promote(self, partial_id: int, sequence_hash: int) -> None:
        """A partial block completed: rekey it to its sequence hash."""
        ref = self.active.pop(partial_id, None)
        if ref is None:
            raise RuntimeError(f"missing active partial block {partial_id}")
        self.all_blocks.discard(partial_id)
        if sequence_hash in self.active:
            # another request completed the same block concurrently
            self.active[sequence_hash] += ref
        else:
            self.inactive.remove(sequence_hash)
            self.active[sequence_hash] = ref
        if sequence_hash not in self.all_blocks:
            self.all_blocks.add(sequence_hash)
            self._emit_stored(sequence_hash)

    # -- admission -----------------------------------------------------------

    def try_schedule(
        self,
        seq_hashes: Sequence[int],
        prompt_len: int,
        watermark: float = 0.01,
        tokens_budget: int = 1 << 30,
    ) -> Optional[PrefillCost]:
        """Can a prompt with these full-block hashes be admitted?
        (reference kv_manager.rs try_schedule)"""
        if tokens_budget <= 0:
            return None
        new_blocks = self.probe_new_blocks(seq_hashes) + 1  # + the partial
        if (len(self.active) + new_blocks) > (1.0 - watermark) * self.max_capacity:
            return None
        cached_blocks = self.probe_cached_blocks(seq_hashes)
        cached_tokens = cached_blocks * self.block_size
        new_tokens = max(prompt_len - cached_tokens, 0)
        if new_tokens > tokens_budget:
            return None
        return PrefillCost(
            new_blocks=new_blocks,
            new_tokens=new_tokens,
            cached_tokens=cached_tokens,
        )

    # -- events --------------------------------------------------------------

    def _emit_stored(self, sequence_hash: int) -> None:
        if self.event_sink is not None:
            self.event_sink(
                {"type": "stored", "blocks": [{"sequence_hash": sequence_hash}]}
            )

    def _emit_removed(self, sequence_hash: int) -> None:
        if self.event_sink is not None and sequence_hash >= 0:
            self.event_sink({"type": "removed", "sequence_hashes": [sequence_hash]})
