"""Paged KV cache: one device pool per model plus its host page pool.

    pages: [num_layers, 2, num_pages, page_size, num_kv_heads, head_dim]

The layout of the JAX package's pool.  Page 0 is the reserved trash page
(invalid rows and dead lanes write there), so the usable pool is pages
``1..num_pages``.  Page ids are host ints; the pool is updated in place by
the step functions, which replaces the JAX package's buffer donation.

The pool is dense (the model's dtype) or int8 (``EngineConfig.kv_dtype =
"int8"``): a :class:`QuantKV` of int8 data in the dense geometry plus one
f32 scale per (layer, k|v, page, slot) row.  A row is quantized when it is
written (:func:`quantize_kv_rows`) and dequantized where it is read, with
the rule of the JAX package's ``kv_cache.py``: ``float(q) * s`` rounded to
the compute dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

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


@dataclass
class QuantKV:
    """The int8 pool: ``q`` int8 ``[L, 2, N, page, Hkv, D]`` and ``s`` f32
    ``[L, 2, N, page]``, one scale per token row.  The writers update both
    tensors in place, with the same (layer, k|v, page, slot) indices."""

    q: torch.Tensor
    s: torch.Tensor

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.s.nbytes


KVPool = Union[torch.Tensor, QuantKV]


def kv_data(kv_pages: KVPool) -> torch.Tensor:
    """The data tensor of either pool form (its shape is the geometry)."""
    return kv_pages.q if isinstance(kv_pages, QuantKV) else kv_pages


def gather_layer_kv(
    kv_pages: KVPool,
    layer: int,
    kv_idx: int,
    page_table: torch.Tensor,  # [..., P] page ids, clamped into the pool here
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """One side (k=0, v=1) of a layer's pages through ``page_table``:
    ``[..., P, page, Hkv, D]`` in ``out_dtype``, dequantized when the pool
    is int8 (only the gathered pages are)."""
    N = kv_data(kv_pages).shape[2]
    ids = page_table.long().clamp(0, N - 1)
    if isinstance(kv_pages, QuantKV):
        # int8 times f32 promotes to f32 (exact) in the one product
        pages = kv_pages.q[layer, kv_idx][ids]
        scales = kv_pages.s[layer, kv_idx][ids]
        return (pages * scales[..., None, None]).to(out_dtype)
    return kv_pages[layer, kv_idx][ids].to(out_dtype)


def parse_kv_dtype(spec: Optional[str]) -> Optional[str]:
    """Normalize a ``kv_dtype`` value: ``int8`` is the quantized layout,
    ``bf16``/``bfloat16``/``f32``/``float32``/``f16`` name plain pool
    dtypes, empty/None/``auto`` defers to the model dtype."""
    if spec is None:
        return None
    s = str(spec).strip().lower()
    if not s or s in ("auto", "default", "model"):
        return None
    aliases = {
        "bf16": "bfloat16",
        "f32": "float32",
        "fp32": "float32",
        "f16": "float16",
        "fp16": "float16",
    }
    s = aliases.get(s, s)
    if s not in ("int8", "bfloat16", "float32", "float16"):
        raise ValueError(f"unsupported kv dtype {spec!r}")
    return s


def pool_is_quantized(kv_dtype: Optional[str], model_dtype: str) -> bool:
    """Whether ``EngineConfig.kv_dtype`` asks for the int8 pool: None or
    the model's dtype give the dense pool; a dense pool of another dtype is
    not served and raises."""
    spec = parse_kv_dtype(kv_dtype)
    if spec is None or spec == model_dtype:
        return False
    if spec == "int8":
        return True
    raise ValueError(
        f"kv_dtype={kv_dtype!r}: a dense pool of another dtype than the "
        f"model's ({model_dtype}) is not served"
    )


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 over the trailing (heads, head_dim) axes:
    ``x [..., Hkv, D]`` gives ``(q int8 [..., Hkv, D], s f32 [...])`` with
    ``s = amax / 127`` (1 for an all-zero row) and ``q = clip(round(x /
    s), -127, 127)``, rounding half to even.  The JAX package's rule, bit
    for bit, on either device: the divisor is a tensor because CUDA
    divides by a Python scalar as a product with its reciprocal, which is
    off by an ulp."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1))
    s = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    q = torch.round(xf / s[..., None, None]).clamp(-127, 127).to(torch.int8)
    return q, s


class PagedKVCache:
    """Owns the pool (dense, or int8 with ``quantized``) and its page pool."""

    def __init__(
        self,
        cfg: ModelConfig,
        num_pages: int,
        page_size: int,
        dtype: torch.dtype,
        device: torch.device,
        quantized: bool = False,
    ) -> None:
        self.cfg = cfg
        self.num_pages = num_pages
        self.page_size = page_size
        self.quantized = quantized
        self.dtype = torch.int8 if quantized else dtype
        # prefix caching is always on: the allocator is the block pool,
        # one KV page per hashed token block
        self.allocator = PagePool(num_pages)
        shape = (
            cfg.num_layers,
            2,
            num_pages,
            page_size,
            cfg.num_kv_heads,
            cfg.head_dim,
        )
        data = torch.zeros(shape, dtype=self.dtype, device=device)
        self.pages: KVPool = (
            QuantKV(data, torch.zeros(shape[:4], dtype=torch.float32, device=device))
            if quantized
            else data
        )

    @property
    def bytes_per_page(self) -> int:
        """Device bytes per pool page, scale rows included."""
        c = self.cfg
        rows = c.num_layers * 2 * self.page_size
        n = rows * c.num_kv_heads * c.head_dim * self.dtype.itemsize
        return n + rows * 4 if self.quantized else n

    @property
    def pool_bytes(self) -> int:
        """The whole pool, trash page included."""
        return self.bytes_per_page * self.num_pages

    @property
    def usage(self) -> float:
        total = self.num_pages - 1
        return self.allocator.used_pages / total if total else 0.0
