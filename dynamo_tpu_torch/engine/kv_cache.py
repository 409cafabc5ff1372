"""Paged KV cache: one device tensor per model plus its host page pool.

    pages: [num_layers, 2, num_pages, page_size, num_kv_heads, head_dim]

The layout of the JAX package's dense pool.  Page 0 is the reserved trash
page (invalid rows and dead lanes write there), so the usable pool is pages
``1..num_pages``.  Page ids are host ints; the tensor is updated in place by
the step functions, which replaces the JAX package's buffer donation.
"""

from __future__ import annotations


import torch

from ..block_manager import PagePool
from .config import ModelConfig

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


class PagedKVCache:
    """Owns the dense bf16/f32 pool tensor and its page pool."""

    def __init__(
        self,
        cfg: ModelConfig,
        num_pages: int,
        page_size: int,
        dtype: torch.dtype,
        device: torch.device,
    ) -> None:
        self.cfg = cfg
        self.num_pages = num_pages
        self.page_size = page_size
        self.dtype = dtype
        # prefix caching is always on: the allocator is the block pool,
        # one KV page per hashed token block
        self.allocator = PagePool(num_pages)
        self.pages = torch.zeros(
            (
                cfg.num_layers,
                2,
                num_pages,
                page_size,
                cfg.num_kv_heads,
                cfg.head_dim,
            ),
            dtype=dtype,
            device=device,
        )

    @property
    def usage(self) -> float:
        total = self.num_pages - 1
        return self.allocator.used_pages / total if total else 0.0
