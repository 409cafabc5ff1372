"""Shape bucketing: the pow2 and pad rules of the JAX engine.

The PyTorch engine keeps the JAX engine's padding rules so that a dispatch
here has exactly the operand shapes of the JAX dispatch it is held
against: prompts pad to a length bucket (powers of two, multiples of the
page), prefill groups to a power-of-two batch, the page table narrows to a
power-of-two width and the packed token axis pads to a power of two long
enough for every live lane's ``s_max`` window.  ``PackedShapeBudget``
bounds the packed step's ``(Np, s_max)`` set as the JAX engine bounds its
compiled executables; here it bounds the CUDA graphs captured for the
packed decode dispatch (``graphs.py``).
"""

from __future__ import annotations

import collections
from typing import List, Optional, Tuple


def pow2_bucket(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    n = max(int(n), int(floor))
    return 1 << max(n - 1, 0).bit_length()


def prefill_buckets(page_size: int, max_len: int) -> List[int]:
    """Prefill length buckets: powers of two times the page, up to
    ``max_len`` rounded up to a page."""
    max_len = -(-max_len // page_size) * page_size
    buckets = []
    b = page_size
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return buckets


def pick_bucket(buckets: List[int], n: int) -> int:
    """The smallest bucket holding ``n`` tokens."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds max bucket {buckets[-1]}")


def pick_page_bucket(n_pages: int, max_pages: int) -> int:
    """Page-table width: smallest power of two >= n_pages, capped at
    max_pages."""
    if n_pages > max_pages:
        raise ValueError(f"{n_pages} prefix pages exceed max {max_pages}")
    return min(pow2_bucket(n_pages), max_pages)


def packed_axis_len(s_max: int, off_last: int, total: int) -> int:
    """Length of the packed token axis: a power of two holding every fresh
    row (``total``) and the last live lane's whole ``s_max`` window
    (``off_last + s_max``), the slice rule of the packed attention kernel."""
    return pow2_bucket(max(total, off_last + s_max, 1))


# budget of the packed step's (Np, s_max) shapes, the JAX engine's default
PACKED_SHAPE_BUDGET = 16


class PackedShapeBudget:
    """Bound the packed unified step's ``(Np, s_max, s_spec)`` shape set.

    A copy of the JAX package's class (``engine/bucketing.py``), where each
    triple is one compiled executable; in this package a spec-free triple
    keys the CUDA graphs of the packed decode dispatch.  ``s_spec`` is the
    folded verify column count of a dispatch that carries speculating
    lanes' verify columns (0 without); such a dispatch runs eagerly
    (``graphs.py``).  A dispatch whose natural triple is already minted
    (or was merged before) reuses it; a new triple mints freely under
    ``budget``; past the budget, the dispatch is merged up into the
    smallest already-minted triple that dominates it (``s_max' >= s_max``,
    ``s_spec' >= s_spec``, and ``Np'`` covering the recomputed packed
    extent) -- more padding, identical math, no new shape.  Only when
    nothing dominates does a mint evict the least-recently-used triple.

    Correctness contract (the kernel's slice rule): a returned triple
    always satisfies ``off_last + s_max <= Np`` and ``total <= Np``,
    where ``off_last`` is the last live lane's segment offset -- padding
    rows carry lane id B and are inert.
    """

    def __init__(self, budget: int = 16) -> None:
        self.budget = max(int(budget), 1)
        # (Np, s_max, s_spec) -> hits, LRU order (oldest first)
        self._pairs: "collections.OrderedDict[Tuple[int, int, int], int]" = (
            collections.OrderedDict()
        )
        self.merges = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._pairs)

    @property
    def pairs(self) -> List[Tuple[int, int, int]]:
        return list(self._pairs)

    @property
    def spec_shapes(self) -> List[Tuple[int, int, int]]:
        """The minted triples carrying folded-verify columns (s_spec > 0)."""
        return [t for t in self._pairs if t[2] > 0]

    @staticmethod
    def _np_for(s_max: int, off_last: int, total: int) -> int:
        return pow2_bucket(max(total, off_last + s_max, 1))

    def fit(
        self, s_max: int, off_last: int, total: int, s_spec: int = 0
    ) -> Tuple[int, int, int]:
        """Resolve a dispatch's natural ``(s_max, off_last, total,
        s_spec)`` to a budgeted ``(Np, s_max, s_spec)`` triple (see class
        docstring).  ``s_spec`` is 0 for spec-free dispatches -- those
        never merge into a spec-carrying triple."""
        nat = (self._np_for(s_max, off_last, total), s_max, s_spec)
        if nat in self._pairs:
            self._pairs[nat] += 1
            self._pairs.move_to_end(nat)
            return nat
        if len(self._pairs) < self.budget:
            self._pairs[nat] = 1
            return nat
        # merge up: smallest minted triple that dominates the dispatch
        best: Optional[Tuple[int, int, int]] = None
        for np_m, s_m, sp_m in self._pairs:
            if s_m < s_max or np_m < self._np_for(s_m, off_last, total):
                continue
            if sp_m < s_spec or (s_spec == 0 and sp_m > 0):
                continue
            if best is None or (np_m, s_m, sp_m) < best:
                best = (np_m, s_m, sp_m)
        if best is not None:
            self.merges += 1
            self._pairs[best] += 1
            self._pairs.move_to_end(best)
            return best
        # nothing dominates (e.g. a new widest shape): evict the LRU triple
        self._pairs.popitem(last=False)
        self.evictions += 1
        self._pairs[nat] = 1
        return nat
