"""Shape bucketing: the pow2 and pad rules of the JAX engine.

The PyTorch engine compiles nothing per shape, but it keeps the JAX
engine's padding rules so that a dispatch here has exactly the operand
shapes of the JAX dispatch it is held against: prompts pad to a length
bucket (powers of two, multiples of the page), prefill groups to a
power-of-two batch, the page table narrows to a power-of-two width and the
packed token axis pads to a power of two long enough for every live lane's
``s_max`` window.
"""

from __future__ import annotations

from typing import List


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
