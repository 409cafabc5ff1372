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

The host blobs of the offload tiers and swap records (``offload.py``) are
numpy arrays in the pool's page layout, ``[L, 2, n, page, Hkv, D]``: the
JAX package's blobs and rules (``quantize_kv_blob`` ... ``pad_page_axis``,
copied here).  An int8 pool's blob is a :class:`QuantKV` of numpy ``q``
int8 ``[L, 2, n, page, Hkv, D]`` and ``s`` f32 ``[L, 2, n, page]``.  numpy
has no bfloat16 here, so a bf16 pool's blob is its bits as ``uint16``
(:func:`host_view`, :func:`tensor_view`; the JAX package's files hold the
same two bytes as ``|V2``, which ``offload.DiskTier`` reads as ``uint16``),
its dtype named by ``BlockMeta.kv_dtype``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from ..block_manager import OutOfPages, PagePool
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


class PageAllocator:
    """LIFO free-list over page ids 1..num_pages-1 (0 is the trash page):
    the allocator of a pool without prefix caching.  A copy of the JAX
    package's ``PageAllocator``.

    alloc/free are locked: the scheduler allocates on the tick-loop thread
    while the disaggregated prefill export allocates scratch pages on the
    engine's executor thread."""

    def __init__(self, num_pages: int) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._lock = threading.Lock()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n <= 0:
            return []
        with self._lock:
            if n > len(self._free):
                raise OutOfPages(f"requested {n} pages, {len(self._free)} free")
            out = self._free[-n:][::-1]
            del self._free[len(self._free) - n :]
            return out

    def free(self, pages: List[int]) -> None:
        with self._lock:
            self._free.extend(pages)


class PagedKVCache:
    """Owns the pool (dense, or int8 with ``quantized``) and its page
    allocator: the engine's (a ``PagePool`` with prefix caching on), else
    a plain :class:`PageAllocator`."""

    def __init__(
        self,
        cfg: ModelConfig,
        num_pages: int,
        page_size: int,
        dtype: torch.dtype,
        device: torch.device,
        quantized: bool = False,
        allocator: Optional[Union[PagePool, PageAllocator]] = None,
    ) -> None:
        self.cfg = cfg
        self.num_pages = num_pages
        self.page_size = page_size
        self.quantized = quantized
        self.dtype = torch.int8 if quantized else dtype
        self.allocator = allocator if allocator is not None else PageAllocator(num_pages)
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


# -- host blobs ---------------------------------------------------------------


def dtype_name(dtype: torch.dtype) -> str:
    """A pool dtype by the JAX package's name (``BlockMeta.kv_dtype``)."""
    return str(dtype).replace("torch.", "")


def host_view(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's numpy view, bit for bit: bf16 as ``uint16``."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def tensor_view(a: np.ndarray) -> torch.Tensor:
    """The inverse of :func:`host_view`: ``uint16`` is bf16 bits."""
    if a.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def wire_dtype(name: str) -> np.dtype:
    """The host form of a blob dtype named on the wire (a disaggregated
    delivery's ``dtype``, the JAX package's ``str(blob.dtype)``): bf16 as
    its ``uint16`` bits, int8 the quantized pair's data."""
    if name == "bfloat16":
        return np.dtype(np.uint16)
    if name not in ("float32", "float16", "int8"):
        raise ValueError(f"unsupported KV blob dtype {name!r}")
    return np.dtype(name)


def blob_dtype_name(blob: Any) -> str:
    """The wire name of a blob's dtype (host or device): ``uint16`` host
    bits are bf16, a :class:`QuantKV` is int8."""
    if isinstance(blob, QuantKV):
        return "int8"
    if isinstance(blob, torch.Tensor):
        return dtype_name(blob.dtype)
    return "bfloat16" if blob.dtype == np.uint16 else str(blob.dtype)


def blob_shape(blob: Any) -> Tuple[int, ...]:
    """``[L, 2, n, page, Hkv, D]`` of either blob form."""
    return tuple(int(s) for s in (blob.q if isinstance(blob, QuantKV) else blob).shape)


def blob_index(blob: Any, index) -> Any:
    """``blob[index]`` over its leading (layer, k|v, page) axes, a
    :class:`QuantKV`'s data and scales together (views where the form
    gives views)."""
    if isinstance(blob, QuantKV):
        return QuantKV(q=blob.q[index], s=blob.s[index])
    return blob[index]


def host_float32(blob: np.ndarray) -> np.ndarray:
    """A dense host blob's values in f32 (bf16 bits widened exactly)."""
    if blob.dtype == np.uint16:
        return (blob.astype(np.uint32) << 16).view(np.float32)
    return np.asarray(blob, np.float32)


def _from_float32(arr: np.ndarray, dtype: str) -> np.ndarray:
    """f32 values to a host blob of ``dtype`` (bf16: round to nearest even,
    as ``astype`` to ml_dtypes' bfloat16 does)."""
    if dtype == "bfloat16":
        return host_view(torch.from_numpy(np.ascontiguousarray(arr)).to(torch.bfloat16))
    return arr.astype(dtype)


def quantize_kv_blob(blob: Any) -> QuantKV:
    """Host-side blob conversion (cross-dtype delivery into an int8 pool):
    a dense ``[L, 2, n, page, Hkv, D]`` array becomes a :class:`QuantKV`
    pair under the same per-row rule as the device writes."""
    arr = host_float32(blob)
    amax = np.max(np.abs(arr), axis=(-2, -1))
    s = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(arr / s[..., None, None]), -127, 127).astype(np.int8)
    return QuantKV(q=q, s=s)


def dequantize_kv_blob(blob: QuantKV, dtype: str = "float32") -> np.ndarray:
    """The inverse direction (int8 blob delivered into a full-width pool)."""
    arr = np.asarray(blob.q, np.float32) * np.asarray(blob.s, np.float32)[..., None, None]
    return _from_float32(arr, dtype)


def kv_blob_concat(blobs: List[Any], axis: int = 2) -> Any:
    """Concatenate KV blobs along a shared leading axis (the onboard path
    stacks an admission's tier hits on the pages axis) -- pair-aware."""
    if blobs and isinstance(blobs[0], QuantKV):
        return QuantKV(
            q=np.concatenate([np.asarray(b.q) for b in blobs], axis=axis),
            s=np.concatenate([np.asarray(b.s) for b in blobs], axis=axis),
        )
    return np.concatenate([np.asarray(b) for b in blobs], axis=axis)


def blob_to_host(blob: Any) -> Any:
    """``np.asarray`` for either blob form (tier materialize)."""
    if isinstance(blob, QuantKV):
        return QuantKV(q=np.asarray(blob.q), s=np.asarray(blob.s))
    return np.asarray(blob)


def coerce_kv_blob(blob: Any, pool_quantized: bool, compute_dtype: str) -> Any:
    """Bring a delivered blob into the receiving pool's dtype domain.

    Same-domain blobs pass through untouched (byte-exact round trip);
    cross-geometry deliveries -- a bf16 blob feeding an int8 pool, or an
    int8 tier blob restoring into a full-width pool -- convert through the
    shared quantization rule, so delivery stays exact up to the int8
    rounding the pool itself applies."""
    is_quant = isinstance(blob, QuantKV)
    if pool_quantized and not is_quant:
        return quantize_kv_blob(blob)
    if not pool_quantized and is_quant:
        return dequantize_kv_blob(blob, compute_dtype)
    return blob


def pack_quant_blob_bytes(blob: QuantKV) -> bytes:
    """Wire form of a quantized blob: the data bytes followed by the scale
    bytes, both C-order.  The receiver re-derives both extents from the
    shape + ``kv_dtype`` metadata."""
    q = np.ascontiguousarray(np.asarray(blob.q))
    s = np.ascontiguousarray(np.asarray(blob.s, np.float32))
    return q.tobytes() + s.tobytes()


def unpack_quant_blob_bytes(buf, shape: Tuple[int, ...]) -> QuantKV:
    """Inverse of :func:`pack_quant_blob_bytes` for a ``shape``-d blob; the
    returned pair ALIASES ``buf`` (zero-copy)."""
    shape = tuple(int(x) for x in shape)
    q_n = int(np.prod(shape))
    q = np.frombuffer(buf, np.int8, count=q_n).reshape(shape)
    s = np.frombuffer(buf, np.float32, offset=q_n).reshape(shape[:4])
    return QuantKV(q=q, s=s)


def quant_blob_nbytes(shape: Tuple[int, ...]) -> int:
    """Wire size of a quantized blob: int8 data + f32 per-row scales."""
    shape = tuple(int(x) for x in shape)
    return int(np.prod(shape)) + int(np.prod(shape[:4])) * 4


def layer_chunk_spans(
    num_layers: int, layers_per_chunk: Optional[int] = None, target_chunks: int = 8
) -> List[tuple]:
    """Split the layer stack into contiguous [lo, hi) spans -- the unit of
    the chunked onboard and swap-in scatters.  ``layers_per_chunk`` pins
    the group size; None aims for ``target_chunks`` groups."""
    if num_layers <= 0:
        raise ValueError(f"num_layers must be positive, got {num_layers}")
    if layers_per_chunk is not None and layers_per_chunk <= 0:
        raise ValueError(f"layers_per_chunk must be positive, got {layers_per_chunk}")
    g = layers_per_chunk or max(1, -(-num_layers // target_chunks))
    return [(lo, min(lo + g, num_layers)) for lo in range(0, num_layers, g)]


def pad_page_axis(blob, bucket: int):
    """Pad a KV blob ``[..., P, page, Hkv, D]`` (pages on axis 2) with
    zeros up to ``bucket`` pages -- the shape normalization of every
    bucketed page scatter.  Pad entries target trash page 0 with zero
    content.  Device tensors pad on the device; quantized blobs pad data
    and scales together (zero scale rows decode to zero -- inert)."""
    if isinstance(blob, QuantKV):
        return QuantKV(q=pad_page_axis(blob.q, bucket), s=pad_page_axis(blob.s, bucket))
    n = blob.shape[2]
    if bucket <= n:
        return blob
    if isinstance(blob, torch.Tensor):
        shape = list(blob.shape)
        shape[2] = bucket - n
        return torch.cat([blob, blob.new_zeros(shape)], dim=2)
    pad = [(0, 0)] * blob.ndim
    pad[2] = (0, bucket - n)
    return np.pad(blob, pad)


class PageSnapshot:
    """A copy of some pool pages on their way to the host: ``dev``, the
    gathered device copy (a tensor or a :class:`QuantKV`), and on the card
    a non-blocking copy of it into pinned host memory with a CUDA event
    recorded after it, both enqueued on the current stream where the
    snapshot is taken.  :meth:`materialize` (the offload thread's
    ``to_host``) waits for that event alone and returns the host blob.  On
    the CPU the gathered copy is the host blob."""

    def __init__(self, dev: KVPool) -> None:
        self.dev = dev
        parts = (dev.q, dev.s) if isinstance(dev, QuantKV) else (dev,)
        self.event = None
        if parts[0].is_cuda:
            host = []
            for t in parts:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                host.append(h)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            host = list(parts)
        self._host = host

    def materialize(self) -> Any:
        if self.event is not None:
            self.event.synchronize()
        h = [host_view(t) for t in self._host]
        return QuantKV(q=h[0], s=h[1]) if len(h) == 2 else h[0]
