"""Multi-tier KV offload plane: G2 (host RAM), G3 (disk) and G4 (the
fleet-shared remote store) behind the G1 page pool, coordinated by
:class:`KVOffloadEngine`.

A copy of the JAX package's ``offload.py`` (which loads no JAX):
``BlockMeta``, ``DiskTier``, ``HostTier``, ``PrefetchState``,
``SwapRecord``, ``env_offload_spec``, ``KVOffloadEngine``, the
disaggregation and prefix-onboarding landing zone ``KVStagingBuffer``, and
the G4 tier: its self-describing blob frames (``pack_kv_blob_frame``,
``unpack_kv_blob_frame``), ``InMemoryBlobStore``, ``RemoteTier`` and the
``--kv-remote`` grammar (``parse_kv_remote_spec``, ``env_remote_spec``).
The ``offload.copy_fail`` chaos site fires where the JAX package fires it,
with the same keys (``evict/{seq_hash:x}``, ``swap/{request_id}``), and the
remote tier feeds the telemetry plane's transfer log (``note_transfer``).

Reference parity: lib/llm/src/block_manager offload (offload.rs:76-80 --
eviction cascades G1 -> G2 -> G3, lookups promote back up).  An evicted
block's pages are gathered on the device before the free list reclaims
them, on the stream of the dispatches that may reuse them, and copied
without blocking into pinned host memory with a CUDA event recorded after
the copy (``kv_cache.PageSnapshot``); :func:`to_host`, on the offload
engine's dedicated thread, waits for that event and nothing else, and
every tier put and get runs there too -- never the event loop, never the
engine's executor thread.  G4 store round trips run on a thread of their
own (``kv-remote``).

A block is stored as ``(blob, meta)``: blob is the raw page content
``[L, 2, pages_per_block, page, Hkv, D]`` (numpy; an int8 pool's
``QuantKV`` pair; a bf16 pool's bits as ``uint16``), meta carries the
router-facing identity (block_hash, parent_sequence_hash, position) so an
onboarded block re-registers and re-publishes exactly as it first did.
G3 files are the JAX package's ``.npz`` files: a bf16 blob is written as
its two bytes per value (``|V2``, what numpy writes for ml_dtypes'
bfloat16) and read back through the ``uint16`` view.  G4 frames name a
bf16 blob ``"bfloat16"``, as the JAX package's do, and read it back as
``uint16`` bits.

Beyond block offload, the engine parks whole preempted sequences here:
swap-based preemption snapshots the victim lane's KV into a request-keyed
swap record and restores it through the chunked scatter path on resume,
instead of recomputing KV that already existed (FlowKV, arXiv:2504.03775).
``DYN_KV_OFFLOAD`` arms the whole plane from the environment; unset and
unconfigured, no engine is built and no offload thread ever starts.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .engine.kv_cache import (
    QuantKV,
    blob_dtype_name,
    blob_to_host,
    pack_quant_blob_bytes,
    quant_blob_nbytes,
    unpack_quant_blob_bytes,
    wire_dtype,
)

logger = logging.getLogger("dynamo.offload")

# Pseudo worker id of the hub-backed G4 store in every per-link table (the
# JAX package's transfer log and link model, the global holdings index):
# store<->worker edges are priced like any worker<->worker link.
G4_STORE_ID = -4


def to_host(arr: Any) -> Any:
    """THE device->host materialize point of the offload plane.

    Runs only on the offload engine's thread: a snapshot's copy into
    pinned host memory was enqueued where the snapshot was taken, so this
    waits for the CUDA event recorded after that copy -- usually already
    complete -- and for nothing else.  Host blobs pass through."""
    materialize = getattr(arr, "materialize", None)
    if materialize is not None:
        return materialize()
    return blob_to_host(arr)


def _host_empty(shape: Tuple[int, ...], dtype: Any, pinned: bool) -> np.ndarray:
    """An uninitialised host array; in pinned (page-locked) memory when
    ``pinned``, so copies to and from the card run without blocking."""
    if not pinned:
        return np.empty(shape, dtype)
    import torch

    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    return torch.empty((n,), dtype=torch.uint8, pin_memory=True).numpy().view(dtype).reshape(shape)


def _copy_blob(blob: Any, pinned: bool) -> Any:
    """A copy of a host blob (either form), pinned when ``pinned``."""
    if isinstance(blob, QuantKV):
        return QuantKV(q=_copy_blob(blob.q, pinned), s=_copy_blob(blob.s, pinned))
    out = _host_empty(blob.shape, blob.dtype, pinned)
    np.copyto(out, blob)
    return out


@dataclass
class BlockMeta:
    block_hash: int = 0
    parent_sequence_hash: int = 0
    position: int = 0
    # shard geometry of the pool the blob was exported from (None for an
    # unsharded pool: the port's only kind)
    shards: Optional[Dict[str, int]] = None
    # dtype of the pool the blob was sliced from ("int8" = quantized
    # QuantKV pair -- its per-row scales travel inside the blob;
    # "bfloat16" = a uint16 bit view)
    kv_dtype: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "block_hash": self.block_hash,
            "parent_sequence_hash": self.parent_sequence_hash,
            "position": self.position,
        }
        if self.shards is not None:
            out["shards"] = dict(self.shards)
        if self.kv_dtype is not None:
            out["kv_dtype"] = str(self.kv_dtype)
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BlockMeta":
        shards = d.get("shards")
        kv_dtype = d.get("kv_dtype")
        return cls(
            int(d.get("block_hash", 0)),
            int(d.get("parent_sequence_hash", 0)),
            int(d.get("position", 0)),
            dict(shards) if shards else None,
            str(kv_dtype) if kv_dtype else None,
        )


class KVStagingBuffer:
    """Host-RAM landing zone for an incoming chunked KV transfer.

    The decode side of disaggregation (and the prefix-onboard importer)
    assembles wire chunks here before the device scatter; this class owns
    the geometry arithmetic -- the preallocated ndarray, its flat byte
    view, and each chunk's [start, end) byte range -- so sender and
    receiver derive identical bounds from the same metadata.  Layer spans
    map to byte ranges because layer slabs are contiguous in the C-order
    blob ``[L, 2, pages, page, Hkv, D]``.

    ``dtype`` is the wire name (``kv_cache.wire_dtype``): a bf16 blob lands
    in a ``uint16`` array of its bits, an int8 one in the flat byte buffer
    of the quantized wire layout."""

    def __init__(self, shape, dtype, bounds, quant: bool = False) -> None:
        shape = tuple(int(s) for s in shape)
        self.quant = quant
        self.shape = shape
        if quant:
            # quantized wire layout (kv_cache.pack_quant_blob_bytes): each
            # layer slab is its int8 data followed by its f32 row scales,
            # so the landing zone is a flat byte buffer and layer_slice
            # unpacks the (data, scales) pair per span
            self.array = np.empty((quant_blob_nbytes(shape),), np.uint8)
        else:
            self.array = np.empty(shape, wire_dtype(str(dtype)))
        self.flat = self.array.view(np.uint8).reshape(-1)
        self.bounds = [(int(s), int(e)) for s, e in bounds]
        if self.bounds and self.bounds[-1][1] != self.flat.size:
            raise ValueError(
                f"chunk bounds end at {self.bounds[-1][1]}, blob holds "
                f"{self.flat.size} bytes"
            )

    @classmethod
    def for_layer_spans(cls, shape, dtype, spans) -> "KVStagingBuffer":
        """One chunk per layer-group span [lo, hi) over axis 0.  An int8
        ``dtype`` selects the quantized wire layout (data + row scales per
        layer slab)."""
        shape = tuple(int(s) for s in shape)
        quant = str(dtype) == "int8"
        if quant:
            total = quant_blob_nbytes(shape)
        else:
            total = int(np.prod(shape)) * wire_dtype(str(dtype)).itemsize
        bpl = total // max(shape[0], 1)
        return cls(shape, dtype, [(lo * bpl, hi * bpl) for lo, hi in spans], quant=quant)

    @classmethod
    def for_byte_chunks(cls, shape, dtype, chunk_bytes: int) -> "KVStagingBuffer":
        """Fixed-size byte chunks (the block-blob transfer framing of the
        ``kv_export`` stream).  An int8 ``dtype`` selects the quantized wire
        layout."""
        shape = tuple(int(s) for s in shape)
        quant = str(dtype) == "int8"
        if quant:
            total = quant_blob_nbytes(shape)
        else:
            total = int(np.prod(shape)) * wire_dtype(str(dtype)).itemsize
        if total == 0:
            return cls(shape, dtype, [(0, 0)], quant=quant)
        bounds = [(off, min(off + chunk_bytes, total)) for off in range(0, total, chunk_bytes)]
        return cls(shape, dtype, bounds, quant=quant)

    def payload(self) -> Any:
        """The assembled blob in its engine-facing form: the array for dense
        blobs (``uint16`` bits for bf16), the unpacked (data, scales) pair
        for quantized wire bytes.  Valid for whole-blob staging
        (``for_byte_chunks``) only -- the layer-span layout packs (data |
        scales) per span, which :meth:`layer_slice` unpacks.  Zero-copy:
        the blob ALIASES the staging buffer."""
        if self.quant:
            return unpack_quant_blob_bytes(self.flat, self.shape)
        return self.array

    @property
    def memoryview(self) -> memoryview:
        return memoryview(self.flat)

    def layer_slice(self, lo: int, hi: int) -> Any:
        """View of layers [lo, hi) -- stable once their bytes landed.  For
        the quantized layout this unpacks the span's (data, scales) pair;
        like the dense path it ALIASES the staging buffer (zero-copy), so
        it is valid only while the buffer's bytes stay untouched."""
        if self.quant:
            bpl = quant_blob_nbytes(self.shape) // max(self.shape[0], 1)
            span_shape = (hi - lo,) + self.shape[1:]
            return unpack_quant_blob_bytes(self.flat[lo * bpl : hi * bpl], span_shape)
        return self.array[lo:hi]


class DiskTier:
    """G3: one ``.npz`` file per block under ``root``, LRU-capped.

    ``put``/``get`` do blocking file I/O and therefore must only be
    called from the :class:`KVOffloadEngine`'s dedicated thread -- the
    event loop and the engine's executor never touch this class directly.
    The residency index (``__contains__``) is in-RAM and safe from any
    thread."""

    def __init__(self, root: str, capacity_blocks: int) -> None:
        self.root = root
        self.capacity = capacity_blocks
        os.makedirs(root, exist_ok=True)
        self._lru: "collections.OrderedDict[int, None]" = collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def _path(self, seq_hash: int) -> str:
        return os.path.join(self.root, f"{seq_hash & (2**64 - 1):016x}.npz")

    def __len__(self) -> int:
        return len(self._lru)

    def __contains__(self, seq_hash: int) -> bool:
        with self._lock:
            return seq_hash in self._lru

    def put(
        self, seq_hash: int, blob: Any, meta: BlockMeta
    ) -> List[Tuple[int, Optional[str], int]]:
        """Offload-thread only.  File I/O runs OUTSIDE the lock (write to
        a temp file, rename into place): the lock guards only the in-RAM
        index.  Returns the holdings delta this put caused -- ``(hash,
        "disk", nbytes)`` for the stored block (``(hash, None, 0)`` when
        capacity or a write error dropped it) plus ``(victim, None, 0)``
        for every LRU eviction."""
        if self.capacity <= 0:
            return [(seq_hash, None, 0)]
        path = self._path(seq_hash)
        tmp = path + ".tmp.npz"  # .npz suffix so np.savez appends nothing
        try:
            meta_d = {k: v for k, v in meta.to_dict().items() if k != "shards"}
            if isinstance(blob, QuantKV):
                # quantized pair: scales are part of the block's bytes
                np.savez(tmp, blob=blob.q, blob_scales=blob.s, **meta_d)
            else:
                if blob.dtype == np.uint16 and meta.kv_dtype == "bfloat16":
                    blob = blob.view(np.dtype("V2"))  # the JAX package's file form
                np.savez(tmp, blob=blob, **meta_d)
            os.replace(tmp, path)
        except OSError:
            logger.exception("disk tier write failed for %x", seq_hash)
            with_suppress_remove(tmp)
            return [(seq_hash, None, 0)]
        victims: List[int] = []
        with self._lock:
            self._lru[seq_hash] = None
            self._lru.move_to_end(seq_hash)
            while len(self._lru) > self.capacity:
                victim, _ = self._lru.popitem(last=False)
                victims.append(victim)
        for victim in victims:
            with_suppress_remove(self._path(victim))
        delta: List[Tuple[int, Optional[str], int]] = [(seq_hash, "disk", int(blob.nbytes))]
        delta.extend((v, None, 0) for v in victims)
        return delta

    def get(self, seq_hash: int) -> Optional[Tuple[Any, BlockMeta]]:
        """Offload-thread only (single reader; puts rename atomically, so
        a file listed in the index is always complete)."""
        with self._lock:
            if seq_hash not in self._lru:
                self.misses += 1
                return None
        try:
            with np.load(self._path(seq_hash)) as z:
                blob = z["blob"]
                if blob.dtype == np.dtype("V2"):
                    blob = blob.view(np.uint16)  # bf16 bits
                if "blob_scales" in z.files:
                    blob = QuantKV(q=blob, s=z["blob_scales"])
                meta = BlockMeta(
                    int(z["block_hash"]),
                    int(z["parent_sequence_hash"]),
                    int(z["position"]),
                    kv_dtype=(str(z["kv_dtype"]) if "kv_dtype" in z.files else None),
                )
        except OSError:
            with self._lock:
                self._lru.pop(seq_hash, None)
                self.misses += 1
            return None
        with self._lock:
            if seq_hash in self._lru:
                self._lru.move_to_end(seq_hash)
            self.hits += 1
        return blob, meta


def with_suppress_remove(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


class HostTier:
    """G2: preallocated host-RAM ring of block blobs; overflow demotes to
    the G3 parent.

    The ring is ONE array of ``capacity_blocks`` slots, allocated lazily
    from the first block's geometry -- in pinned memory with ``pinned``
    (an engine on the card), so blobs read out of it (pinned copies too)
    go to the card without blocking.  ``put`` copies into a free slot with
    ``np.copyto`` -- no allocation on the eviction path -- and ``get``
    copies out, so a returned blob stays valid after its slot is recycled.
    Blocks whose geometry does not match the ring fall back to a per-entry
    side table, counted against the same LRU capacity."""

    def __init__(
        self, capacity_blocks: int, parent: Optional[DiskTier] = None, pinned: bool = False
    ) -> None:
        self.capacity = capacity_blocks
        self.parent = parent
        self.pinned = pinned
        # LRU order over every resident hash; value = ring slot or None
        # (None = side-table entry)
        self._slots: "collections.OrderedDict[int, Optional[int]]" = collections.OrderedDict()
        self._misc: Dict[int, Tuple[Any, BlockMeta]] = {}
        self._meta: Dict[int, BlockMeta] = {}
        self._ring: Optional[np.ndarray] = None
        # scale ring of a quantized pool's blocks: the pair occupies one
        # LRU slot -- scales are part of the block
        self._ring_s: Optional[np.ndarray] = None
        self._ring_failed = False
        self._free_slots: List[int] = []
        # prefetch pins: hash -> refcount.  A pinned block is skipped by
        # LRU demotion, so a chain promoted for a queued request cannot be
        # churned back to disk before its admission consumes it; pins are
        # released at admission or cancel
        self._pins: Dict[int, int] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        # holdings sink (KVOffloadEngine._on_holdings): fired -- outside
        # the lock, on the offload thread -- with the per-put residency
        # delta
        self.holdings_cb: Optional[Any] = None

    def __len__(self) -> int:
        return len(self._slots)

    @property
    def ring_nbytes(self) -> int:
        n = self._ring.nbytes if self._ring is not None else 0
        if self._ring_s is not None:
            n += self._ring_s.nbytes
        return n

    def _ensure_ring_locked(self, blob: Any) -> None:
        if self._ring is not None or self._ring_failed or self.capacity <= 0:
            return
        try:
            if isinstance(blob, QuantKV):
                self._ring = _host_empty(
                    (self.capacity,) + tuple(blob.q.shape), blob.q.dtype, self.pinned
                )
                self._ring_s = _host_empty(
                    (self.capacity,) + tuple(blob.s.shape), blob.s.dtype, self.pinned
                )
            else:
                self._ring = _host_empty(
                    (self.capacity,) + tuple(blob.shape), blob.dtype, self.pinned
                )
        except (MemoryError, RuntimeError):
            # remember the failure: retrying a multi-GB allocation on every
            # eviction would hammer the allocator on the one thread all
            # offload work queues behind
            logger.exception(
                "host tier ring allocation failed (%d blocks); falling back "
                "to per-entry storage", self.capacity,
            )
            self._ring = None
            self._ring_s = None
            self._ring_failed = True
            return
        self._free_slots = list(range(self.capacity - 1, -1, -1))

    def _ring_fits_locked(self, blob: Any) -> bool:
        if self._ring is None:
            return False
        if isinstance(blob, QuantKV):
            return (
                self._ring_s is not None
                and tuple(blob.q.shape) == self._ring.shape[1:]
                and blob.q.dtype == self._ring.dtype
                and tuple(blob.s.shape) == self._ring_s.shape[1:]
            )
        return (
            self._ring_s is None
            and tuple(blob.shape) == self._ring.shape[1:]
            and blob.dtype == self._ring.dtype
        )

    def _ring_read_locked(self, slot: int, pinned: bool) -> Any:
        if self._ring_s is not None:
            return QuantKV(
                q=_copy_blob(self._ring[slot], pinned), s=_copy_blob(self._ring_s[slot], pinned)
            )
        return _copy_blob(self._ring[slot], pinned)

    def put(self, seq_hash: int, blob: Any, meta: BlockMeta) -> None:
        delta: List[Tuple[int, Optional[str], int]] = []
        if self.capacity <= 0:
            if self.parent is not None:
                delta = self.parent.put(seq_hash, blob, meta)
            else:
                delta = [(seq_hash, None, 0)]
            self._emit_holdings(delta)
            return
        demote: List[Tuple[int, Any, BlockMeta]] = []
        with self._lock:
            self._evict_locked(seq_hash)  # overwrite: recycle the old slot
            self._ensure_ring_locked(blob)
            slot: Optional[int] = None
            if self._ring_fits_locked(blob):
                if not self._free_slots:
                    self._demote_lru_locked(demote)
                if self._free_slots:
                    slot = self._free_slots.pop()
                    if isinstance(blob, QuantKV):
                        np.copyto(self._ring[slot], blob.q)
                        np.copyto(self._ring_s[slot], blob.s)
                    else:
                        np.copyto(self._ring[slot], blob)
            if slot is None:
                # geometry mismatch (or ring unavailable): side table
                self._misc[seq_hash] = (_copy_blob(blob, False), meta)
            self._slots[seq_hash] = slot
            self._slots.move_to_end(seq_hash)
            self._meta[seq_hash] = meta
            while len(self._slots) > self.capacity:
                if not self._demote_lru_locked(demote):
                    break  # everything resident is pinned; overshoot
        delta.append((seq_hash, "host", int(blob.nbytes)))
        for victim, vb, vm in demote:
            if self.parent is not None:
                delta.extend(self.parent.put(victim, vb, vm))
            else:
                delta.append((victim, None, 0))
        self._emit_holdings(delta)

    def _emit_holdings(self, delta: List[Tuple[int, Optional[str], int]]) -> None:
        """Forward a residency delta to the holdings sink.  Disk-LRU
        victims that are still RAM-resident (a promote leaves the disk
        copy behind) are filtered -- the worker still holds them, just in
        a warmer tier."""
        cb = self.holdings_cb
        if cb is None or not delta:
            return
        out = []
        for h, tier, nbytes in delta:
            if tier is None:
                with self._lock:
                    if h in self._slots:
                        continue
            out.append((h, tier, nbytes))
        if out:
            try:
                cb(out)
            except Exception:
                logger.debug("holdings callback failed", exc_info=True)

    def _demote_lru_locked(self, demote: List[Tuple[int, Any, BlockMeta]]) -> bool:
        """Demote the least-recent UNPINNED resident; returns False when
        every resident is pinned (the ring may transiently exceed capacity
        rather than evict a block a queued request is about to consume)."""
        victim = next((h for h in self._slots if not self._pins.get(h)), None)
        if victim is None:
            return False
        slot = self._slots.pop(victim)
        meta = self._meta.pop(victim)
        if slot is None:
            vb, meta = self._misc.pop(victim)
        else:
            vb = self._ring_read_locked(slot, False)  # bound for the disk
            self._free_slots.append(slot)
        demote.append((victim, vb, meta))
        return True

    def pin(self, seq_hash: int) -> bool:
        """Pin a RAM-resident block against demotion (prefetch holds);
        returns False when the hash is not resident."""
        with self._lock:
            if seq_hash not in self._slots:
                return False
            self._pins[seq_hash] = self._pins.get(seq_hash, 0) + 1
            return True

    def unpin(self, seq_hash: int) -> None:
        with self._lock:
            n = self._pins.get(seq_hash, 0) - 1
            if n > 0:
                self._pins[seq_hash] = n
            else:
                self._pins.pop(seq_hash, None)

    @property
    def pinned_blocks(self) -> int:
        with self._lock:
            return len(self._pins)

    @property
    def block_nbytes(self) -> int:
        """Bytes of one resident block blob (0 until the first put)."""
        if self._ring is not None:
            n = int(self._ring[0].nbytes)
            if self._ring_s is not None:
                n += int(self._ring_s[0].nbytes)
            return n
        with self._lock:
            for blob, _meta in self._misc.values():
                return int(blob.nbytes)
        return 0

    def _evict_locked(self, seq_hash: int) -> None:
        slot = self._slots.pop(seq_hash, "absent")
        if slot == "absent":
            return
        self._meta.pop(seq_hash, None)
        if slot is None:
            self._misc.pop(seq_hash, None)
        else:
            self._free_slots.append(slot)

    def get_ram(self, seq_hash: int) -> Optional[Tuple[Any, BlockMeta]]:
        """RAM-resident hit only: never consults the disk parent, so it is
        safe to call from latency-sensitive threads (the admission path)."""
        with self._lock:
            if seq_hash not in self._slots:
                return None
            slot = self._slots[seq_hash]
            self._slots.move_to_end(seq_hash)
            self.hits += 1
            if slot is None:
                blob, meta = self._misc[seq_hash]
                return _copy_blob(blob, self.pinned), meta
            return self._ring_read_locked(slot, self.pinned), self._meta[seq_hash]

    def touch(self, seq_hash: int) -> bool:
        """``get_ram``'s bookkeeping (LRU move, hit count) without the copy:
        whether the block is RAM-resident (the prefetch walk's probe)."""
        with self._lock:
            if seq_hash not in self._slots:
                return False
            self._slots.move_to_end(seq_hash)
            self.hits += 1
            return True

    def get(self, seq_hash: int) -> Optional[Tuple[Any, BlockMeta]]:
        """Tiered get: RAM first, then the disk parent (promoting the hit
        back into G2).  May do file I/O -- offload-thread only."""
        hit = self.get_ram(seq_hash)
        if hit is not None:
            return hit
        if self.parent is not None:
            promoted = self.parent.get(seq_hash)
            if promoted is not None:
                # promote back into G2 (and let LRU demote something else)
                self.put(seq_hash, *promoted)
                return promoted
        self.misses += 1
        return None

    def contains(self, seq_hash: int) -> bool:
        with self._lock:
            if seq_hash in self._slots:
                return True
        return self.parent is not None and seq_hash in self.parent

    def stats(self) -> Dict[str, Any]:
        out = {
            "g2_blocks": len(self),
            "g2_hits": self.hits,
            "g2_misses": self.misses,
            "g2_ring_bytes": self.ring_nbytes,
        }
        if self.parent is not None:
            out.update(
                g3_blocks=len(self.parent),
                g3_hits=self.parent.hits,
                g3_misses=self.parent.misses,
            )
        return out


# ---------------------------------------------------------------------------
# the G4 remote tier: fleet-shared blob store behind the hub
# ---------------------------------------------------------------------------


def pack_kv_blob_frame(blob: Any, meta: BlockMeta) -> bytes:
    """Self-describing G4 wire frame for one block blob, the JAX package's
    frame byte for byte.

    ``u32-LE header length | JSON header | payload``: quantized blobs
    (``QuantKV``) pack through the shared ``pack_quant_blob_bytes`` rule,
    dense blobs ship C-order raw.  The header names the dtype as the JAX
    package does: a ``uint16`` blob of bf16 bits is ``"bfloat16"``.  Runs
    only on the kv-remote thread."""
    if isinstance(blob, QuantKV):
        payload = pack_quant_blob_bytes(blob)
        kind, dtype = "quant", "int8"
        shape = tuple(int(s) for s in blob.q.shape)
    else:
        arr = np.ascontiguousarray(blob)
        payload = arr.tobytes()
        kind, dtype = "dense", blob_dtype_name(arr)
        shape = tuple(int(s) for s in arr.shape)
    hdr = json.dumps(
        {
            "v": 1,
            "kind": kind,
            "dtype": dtype,
            "shape": list(shape),
            "meta": meta.to_dict(),
            "payload_nbytes": len(payload),
        }
    ).encode("utf-8")
    return struct.pack("<I", len(hdr)) + hdr + payload


def unpack_kv_blob_frame(buf: Any) -> Tuple[Any, BlockMeta]:
    """Inverse of :func:`pack_kv_blob_frame`; raises ``ValueError`` on any
    framing violation (truncation, garbage header, an unknown dtype, a
    payload/shape size mismatch) so a corrupt store entry surfaces as a
    fetch miss -- the request recomputes -- never as a malformed scatter.
    A ``"bfloat16"`` payload comes back as its ``uint16`` bits.

    The returned blob ALIASES ``buf`` (zero-copy unpack); the host-tier put
    that follows copies into the ring."""
    view = memoryview(buf)
    if len(view) < 4:
        raise ValueError("G4 frame shorter than its header-length word")
    (hlen,) = struct.unpack_from("<I", view, 0)
    if hlen <= 0 or 4 + hlen > len(view):
        raise ValueError(f"G4 frame header length {hlen} exceeds frame")
    try:
        hdr = json.loads(bytes(view[4 : 4 + hlen]).decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise ValueError("G4 frame header is not valid JSON") from e
    if not isinstance(hdr, dict) or "shape" not in hdr:
        raise ValueError("G4 frame header missing blob geometry")
    try:
        shape = tuple(int(s) for s in hdr["shape"])
    except (TypeError, ValueError) as e:
        raise ValueError("G4 frame header has a malformed shape") from e
    payload = view[4 + hlen :]
    quant = hdr.get("kind") == "quant"
    if quant:
        expect = quant_blob_nbytes(shape)
    else:
        dtype = wire_dtype(str(hdr.get("dtype")))  # ValueError when unknown
        expect = int(np.prod(shape)) * dtype.itemsize
    if len(payload) != expect or expect != int(hdr.get("payload_nbytes", -1)):
        raise ValueError(
            f"G4 frame payload holds {len(payload)} bytes, geometry expects {expect}"
        )
    meta = BlockMeta.from_dict(hdr.get("meta") or {})
    if quant:
        return unpack_quant_blob_bytes(payload, shape), meta
    return np.frombuffer(payload, dtype).reshape(shape), meta


class InMemoryBlobStore:
    """Process-local G4 store (tests, single-process runs): the hub blob
    verbs' semantics -- byte-capacity LRU over named blobs -- behind the
    same sync ``put``/``get``/``delete`` protocol :class:`RemoteTier`
    speaks, without a hub in the loop.  Thread-safe: every worker's
    kv-remote thread may hit the shared instance concurrently."""

    def __init__(self, cap_bytes: int = 1 << 30) -> None:
        self.cap_bytes = int(cap_bytes)
        self._blobs: "collections.OrderedDict[str, bytes]" = collections.OrderedDict()
        self._total = 0
        self._lock = threading.Lock()

    def put(self, name: str, data: bytes) -> None:
        data = bytes(data)
        with self._lock:
            old = self._blobs.pop(name, None)
            if old is not None:
                self._total -= len(old)
            self._blobs[name] = data
            self._total += len(data)
            while self._total > self.cap_bytes and len(self._blobs) > 1:
                _, dropped = self._blobs.popitem(last=False)
                self._total -= len(dropped)

    def get(self, name: str) -> Optional[bytes]:
        with self._lock:
            data = self._blobs.get(name)
            if data is not None:
                self._blobs.move_to_end(name)
            return data

    def delete(self, name: str) -> bool:
        with self._lock:
            old = self._blobs.pop(name, None)
            if old is not None:
                self._total -= len(old)
            return old is not None

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"blobs": len(self._blobs), "bytes": self._total}


class RemoteTier:
    """G4: block blobs in a fleet-shared object store (the hub's blob verbs
    through ``HubBlobClient``, or any sync ``put``/``get`` duck type).

    All store I/O runs on ONE private thread (``kv-remote``) -- the same
    isolation contract as the kv-offload thread, so a slow or wedged store
    round trip never stalls an eviction cascade, a tick or the event loop.
    ``submit_put``/``fetch`` enqueue and return futures; ``fetch_blocking``
    is for worker threads that may wait (the offload engine's tiered
    ``get_blocking``).  The fault sites ``remote.fetch_fail`` and
    ``remote.blob_corrupt`` (``runtime/faults.py``) turn a fetch into a
    miss, as a lost or corrupt store entry would."""

    def __init__(
        self,
        store: Any,
        *,
        worker_id: int = 0,
        namespace: str = "dynamo",
        registry: Any = None,
    ) -> None:
        self.store = store
        self.worker_id = int(worker_id)
        self.namespace = namespace
        self._ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="kv-remote")
        self._lock = threading.Lock()
        # hash -> frame nbytes known to be in the store (own puts + adverts
        # merged back from the cluster-global holdings index)
        self._known: Dict[int, int] = {}
        from .runtime.metrics import RemoteKVMetrics

        self.metrics = RemoteKVMetrics(registry)
        # holdings sink (KVOffloadEngine._on_holdings): a successful put
        # advertises (hash, "remote", nbytes) to the global index
        self.holdings_cb: Optional[Any] = None
        # plain mirrors for tests and the chip smoke
        self.puts = 0
        self.fetches = 0
        self.store_bytes = 0
        self.store_seconds = 0.0
        self.fetch_bytes = 0
        self.fetch_seconds = 0.0
        self.fetch_fails: Dict[str, int] = {}

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        self._ex.shutdown(wait=True)

    def drain(self) -> None:
        self._ex.submit(lambda: None).result()

    def _name(self, seq_hash: int) -> str:
        return f"kv/{self.namespace}/{seq_hash & (2**64 - 1):016x}"

    # -- residency index ---------------------------------------------------

    def contains(self, seq_hash: int) -> bool:
        with self._lock:
            return seq_hash in self._known

    def note_remote(self, seq_hash: int, nbytes: int) -> None:
        """Merge a G4 advert from the cluster-global index (another worker
        published this block) into the local residency view."""
        with self._lock:
            self._known[seq_hash] = int(nbytes)

    def known_blocks(self) -> int:
        with self._lock:
            return len(self._known)

    # -- async surface -----------------------------------------------------

    def submit_put(self, seq_hash: int, blob: Any, meta: BlockMeta):
        """Queue a store upload; returns the future (True on success)."""
        return self._ex.submit(self._put, seq_hash, blob, meta)

    def fetch(self, seq_hash: int):
        """Queue a store fetch; the future resolves to ``(blob, meta)`` or
        None (missing, failed or corrupt -- the caller recomputes)."""
        return self._ex.submit(self._get, seq_hash)

    def fetch_blocking(self, seq_hash: int) -> Optional[Tuple[Any, BlockMeta]]:
        """Worker-thread fetch (never the event loop): waits on the
        kv-remote thread's result."""
        return self.fetch(seq_hash).result()

    # -- kv-remote thread side ---------------------------------------------

    def _put(self, seq_hash: int, blob: Any, meta: BlockMeta) -> bool:
        from .runtime import thread_sentry

        thread_sentry.assert_role("kv-remote", what="RemoteTier._put")
        try:
            frame = pack_kv_blob_frame(blob, meta)
            t0 = time.perf_counter()
            self.store.put(self._name(seq_hash), frame)
            dt = time.perf_counter() - t0
        except Exception:
            logger.debug("G4 store put failed for %x", seq_hash, exc_info=True)
            return False
        with self._lock:
            self._known[seq_hash] = len(frame)
            self.puts += 1
            self.store_bytes += len(frame)
            self.store_seconds += dt
            known = len(self._known)
        self.metrics.record_store(len(frame), dt)
        self.metrics.blocks.set(known)
        from .runtime.telemetry import note_transfer

        note_transfer(self.worker_id, G4_STORE_ID, len(frame), dt)
        cb = self.holdings_cb
        if cb is not None:
            try:
                cb([(seq_hash, "remote", len(frame))])
            except Exception:
                logger.debug("G4 holdings callback failed", exc_info=True)
        return True

    def _get(self, seq_hash: int) -> Optional[Tuple[Any, BlockMeta]]:
        from .runtime import faults, thread_sentry

        thread_sentry.assert_role("kv-remote", what="RemoteTier._get")
        if faults.injector.enabled and faults.injector.should_fire(
            "remote.fetch_fail", f"g4/{seq_hash:x}"
        ):
            self._count_fail("fetch_fail")
            return None
        t0 = time.perf_counter()
        try:
            frame = self.store.get(self._name(seq_hash))
        except Exception:
            logger.debug("G4 store get failed for %x", seq_hash, exc_info=True)
            self._count_fail("fetch_fail")
            return None
        if frame is None:
            # the store dropped it from under the index: forget it
            with self._lock:
                self._known.pop(seq_hash, None)
            self._count_fail("missing")
            return None
        dt = time.perf_counter() - t0
        if faults.injector.enabled and faults.injector.should_fire(
            "remote.blob_corrupt", f"g4/{seq_hash:x}"
        ):
            # truncate mid-payload: the frame validator must catch it
            frame = bytes(frame)[: max(len(frame) // 2, 4)]
        try:
            blob, meta = unpack_kv_blob_frame(frame)
        except ValueError:
            logger.warning("G4 blob for %x failed frame validation; treating as miss", seq_hash)
            self._count_fail("blob_corrupt")
            return None
        with self._lock:
            self.fetches += 1
            self.fetch_bytes += len(frame)
            self.fetch_seconds += dt
        self.metrics.record_fetch(len(frame), dt)
        from .runtime.telemetry import note_transfer

        note_transfer(G4_STORE_ID, self.worker_id, len(frame), dt)
        return blob, meta

    def _count_fail(self, cause: str) -> None:
        with self._lock:
            self.fetch_fails[cause] = self.fetch_fails.get(cause, 0) + 1
        self.metrics.fetch_failures.labels(cause).inc()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                "g4_known_blocks": len(self._known),
                "g4_puts": self.puts,
                "g4_fetches": self.fetches,
                "g4_store_bytes": self.store_bytes,
                "g4_fetch_bytes": self.fetch_bytes,
                "g4_fetch_fails": dict(self.fetch_fails),
            }
            seconds = self.store_seconds + self.fetch_seconds
            if seconds > 0:
                out["kv_g4_gbps"] = round(
                    (self.store_bytes + self.fetch_bytes) / seconds / 1e9, 3
                )
        return out


def parse_kv_remote_spec(spec: str) -> Optional[Dict[str, Any]]:
    """Parse a ``--kv-remote`` / ``DYN_KV_REMOTE`` value into G4 settings,
    or None when empty/off (no remote tier, no kv-remote thread).

    Grammar: ``1``/``on`` arms the tier with defaults, or a comma-separated
    ``k=v`` list::

        DYN_KV_REMOTE=mirror=1,fetch=1,prefill_tok_s=4000,gbps=1.0,namespace=prod

    ``mirror`` re-publishes host-tier eviction stores into the fleet store;
    ``fetch`` lets the router gate choose G4 as a prefix source;
    ``prefill_tok_s`` is the per-worker prefill-rate estimate and ``gbps``
    the link bandwidth prior, both feeding the router's fetch-vs-recompute
    gate."""
    spec = (spec or "").strip()
    if not spec or spec.lower() in ("0", "off", "false", "no"):
        return None
    out: Dict[str, Any] = {
        "mirror": True,
        "fetch": True,
        "prefill_tok_s": 4000.0,
        "gbps": 1.0,
        "namespace": "dynamo",
    }
    if spec.lower() in ("1", "on", "true", "yes"):
        return out
    for clause in filter(None, (c.strip() for c in spec.split(","))):
        k, sep, v = clause.partition("=")
        k = k.strip().lower()
        if not sep:
            raise ValueError(f"malformed DYN_KV_REMOTE clause {clause!r}")
        try:
            if k in ("mirror", "fetch"):
                out[k] = v.strip().lower() not in ("0", "off", "false", "no")
            elif k in ("prefill_tok_s", "gbps"):
                out[k] = float(v)
                if out[k] <= 0:
                    raise ValueError(f"{k} must be positive")
            elif k == "namespace":
                out[k] = v.strip()
            else:
                raise ValueError(f"unknown DYN_KV_REMOTE key {k!r}")
        except ValueError as e:
            raise ValueError(f"bad DYN_KV_REMOTE value {clause!r}") from e
    return out


def env_remote_spec(environ: Optional[Dict[str, str]] = None) -> Optional[Dict[str, Any]]:
    """``DYN_KV_REMOTE`` from the environment, parsed; None when unset."""
    env = environ if environ is not None else os.environ
    return parse_kv_remote_spec(env.get("DYN_KV_REMOTE", ""))


SWAP_PENDING = "pending"
SWAP_READY = "ready"
SWAP_FAILED = "failed"


@dataclass
class PrefetchState:
    """One queued request's prefetch walk (queue-side prefix promotion
    with completion tracking).

    ``done`` collects the hashes the walk found (or made) RAM-resident --
    each is pinned in the host ring until the request admits or cancels.
    ``completed_at`` stamps the walk's end; together with ``issued_at``
    and the admission stamp it yields the *overlap ratio*: the fraction of
    the disk->host walk that ran during queue wait instead of on the TTFT
    critical path (1.0 = fully hidden)."""

    hashes: List[int]
    issued_at: float = field(default_factory=time.perf_counter)
    done: set = field(default_factory=set)
    completed_at: Optional[float] = None
    # stamped by finish_prefetch when admission lands before the walk
    # finishes; the walk's tail then computes the partial overlap
    admitted_at: Optional[float] = None
    consumed: Optional[set] = None


@dataclass
class SwapRecord:
    """One preempted sequence's parked KV, staged across two homes:

    ``dev`` is the gathered device-side snapshot -- retained (budgeted) so
    a short park restores with a device-to-device scatter and never
    round-trips the host link.  ``blob`` is the host materialization the
    offload thread produces -- the spill that survives once the device
    copy is dropped for budget.  A record is restorable the moment either
    exists."""

    cache_len: int
    n_blocks: int  # block-equivalents charged against the swap budget
    shards: Optional[Dict[str, int]] = None
    state: str = SWAP_PENDING
    dev: Any = None  # device-resident staging copy (fast-path restore)
    blob: Any = None
    nbytes: int = 0
    started_at: float = field(default_factory=time.perf_counter)


def env_offload_spec(environ: Optional[Dict[str, str]] = None) -> Optional[Dict[str, Any]]:
    """Parse ``DYN_KV_OFFLOAD`` into offload-plane settings, or None when
    unset (the plane stays a no-op: no tiers, no thread, no swap).

    Grammar: ``1``/``on`` arms the host tier with defaults, or a
    comma-separated ``k=v`` list::

        DYN_KV_OFFLOAD=host=256,disk=1024,dir=/var/kv,swap=1

    with ``host``/``disk`` in blocks, ``dir`` the G3 root, and ``swap``
    enabling/disabling swap-based preemption (default on)."""
    env = environ if environ is not None else os.environ
    spec = env.get("DYN_KV_OFFLOAD", "").strip()
    if not spec or spec.lower() in ("0", "off", "false", "no"):
        return None
    out: Dict[str, Any] = {"host": 256, "disk": 0, "dir": None, "swap": True}
    if spec.lower() in ("1", "on", "true", "yes"):
        return out
    for clause in filter(None, (c.strip() for c in spec.split(","))):
        k, sep, v = clause.partition("=")
        k = k.strip().lower()
        if not sep:
            raise ValueError(f"malformed DYN_KV_OFFLOAD clause {clause!r}")
        try:
            if k == "host":
                out["host"] = int(v)
            elif k == "disk":
                out["disk"] = int(v)
            elif k == "dir":
                out["dir"] = v
            elif k == "swap":
                out["swap"] = v.strip().lower() not in ("0", "off", "false", "no")
            else:
                raise ValueError(f"unknown DYN_KV_OFFLOAD key {k!r}")
        except ValueError as e:
            raise ValueError(f"bad DYN_KV_OFFLOAD value {clause!r}") from e
    return out


class KVOffloadEngine:
    """The G2/G3 coordinator: owns the tiers, the dedicated offload
    thread, the swap records, and the plane's metrics.

    Every blocking step -- the wait for an eviction snapshot's host copy,
    disk writes, disk reads, host-ring copies -- runs on ONE private thread
    (``kv-offload``): the asyncio event loop and the engine's executor only
    ever enqueue work here or probe RAM-resident indexes.  Capacity and
    occupancy are deterministic: the host ring is one preallocated buffer,
    swap records are budgeted in block-equivalents against
    ``swap_blocks``."""

    def __init__(
        self,
        host_blocks: int,
        disk_blocks: int = 0,
        disk_dir: Optional[str] = None,
        *,
        swap_enabled: bool = True,
        swap_blocks: Optional[int] = None,
        registry: Any = None,
        pinned: bool = False,
    ) -> None:
        disk = None
        if disk_blocks > 0:
            if not disk_dir:
                raise ValueError("disk_blocks > 0 requires disk_dir")
            disk = DiskTier(disk_dir, disk_blocks)
        self.disk = disk
        self.host = HostTier(host_blocks, parent=disk, pinned=pinned)
        self.swap_enabled = swap_enabled
        self.swap_blocks = swap_blocks if swap_blocks is not None else max(host_blocks, 8)
        # device-side staging budget (block-equivalents of retained device
        # snapshots, device memory outside the page pool); 0 = host-blob
        # restores only.  Half the swap budget: short parks ride the device
        # fast path, the overflow spills to host blobs
        self.swap_device_blocks = max(self.swap_blocks // 2, 1)
        self._swaps: Dict[str, SwapRecord] = {}
        self._swap_used = 0
        self._swap_dev_used = 0
        self._promoting: set = set()
        self._lock = threading.Lock()
        self._ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="kv-offload")
        from .runtime.metrics import OffloadMetrics

        self.metrics = OffloadMetrics(registry)
        self._registry = registry
        # the G4 remote tier (attach_remote): host-tier eviction stores
        # mirror into the fleet store, and the tiered get_blocking chain
        # extends host -> disk -> remote
        self.remote: Optional[RemoteTier] = None
        self._remote_mirror = True
        # holdings sink (engine._emit_kv_holdings): receives every tier
        # residency delta [(hash, tier|None, nbytes)]
        self.holdings_cb: Optional[Any] = None
        self.host.holdings_cb = self._on_holdings
        # called (from the offload thread) when a swap blob becomes ready,
        # so a sleeping tick loop wakes to apply it
        self.wake_cb: Optional[Any] = None
        # plain-int mirrors for tests and the chip smoke
        self.offload_bytes = 0
        self.offload_seconds = 0.0
        self.onboard_bytes = 0
        self.onboard_seconds = 0.0
        # per-tier [bytes, seconds]: swap restores apart from prefix onboards
        self.onboard_detail: Dict[str, List[float]] = {}
        self.tier_hits: Dict[str, int] = {"host": 0, "disk": 0, "swap": 0}
        self.tier_lookups = 0
        # disk->host promotions (prefetch or lookup-triggered); kept OUT of
        # tier_hits so tier_hit_rate only counts lookups actually served
        self.disk_promotes = 0
        self.copy_fails = 0
        self.swap_outs = 0
        self.swap_ins = 0
        self.swap_fallbacks = 0
        self.onboard_fallbacks = 0
        # queue-side prefetch tracking: request-keyed walk states (pins +
        # stamps) and the aggregate counters behind dynamo_kv_prefetch_*
        self._prefetch_states: Dict[str, PrefetchState] = {}
        self.prefetch_issued = 0
        self.prefetch_hits = 0
        self.prefetch_wasted_bytes = 0
        self.prefetch_overlap_sum = 0.0
        self.prefetch_overlap_n = 0

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        self._ex.shutdown(wait=True)
        if self.remote is not None:
            self.remote.close()

    def drain(self) -> None:
        """Barrier: returns once every queued offload/prefetch/swap task
        -- and every G4 upload and fetch queued behind them -- has run
        (tests, shutdown and the onboarding barrier; never a hot path)."""
        self._ex.submit(lambda: None).result()
        if self.remote is not None:
            self.remote.drain()

    def attach_remote(
        self,
        store: Any,
        *,
        worker_id: int = 0,
        namespace: str = "dynamo",
        mirror: bool = True,
    ) -> RemoteTier:
        """Arm the G4 tier over ``store`` (the hub's blob verbs or any sync
        put/get duck type).  ``mirror=True`` re-publishes every host-tier
        eviction store into the fleet store so peers (and cold restarts)
        can fetch instead of recompute."""
        remote = RemoteTier(
            store, worker_id=worker_id, namespace=namespace, registry=self._registry
        )
        remote.holdings_cb = self._on_holdings
        self._remote_mirror = bool(mirror)
        self.remote = remote
        return remote

    def _on_holdings(self, delta: List[Tuple[int, Optional[str], int]]) -> None:
        cb = self.holdings_cb
        if cb is None:
            return
        try:
            cb(delta)
        except Exception:
            logger.debug("holdings sink failed", exc_info=True)

    def _wake(self) -> None:
        cb = self.wake_cb
        if cb is not None:
            try:
                cb()
            except Exception:
                logger.debug("offload wake callback failed", exc_info=True)

    # -- eviction path (G1 -> G2 -> G3) --------------------------------------

    def submit_evict(self, seq_hash: int, snap: Any, meta: BlockMeta) -> None:
        """Queue an eviction snapshot for materialize + tier store.  The
        caller has already enqueued the device gather and its host copy;
        nothing here blocks."""
        self._ex.submit(self._store_evict, seq_hash, snap, meta)

    def _store_evict(self, seq_hash: int, snap: Any, meta: BlockMeta) -> None:
        from .runtime import faults

        try:
            if faults.injector.enabled and faults.injector.should_fire(
                "offload.copy_fail", f"evict/{seq_hash:x}"
            ):
                self.note_copy_fail()
                return  # lost offload = a cache miss later, never an error
            t0 = time.perf_counter()
            blob = to_host(snap)
            self.host.put(seq_hash, blob, meta)
            dt = time.perf_counter() - t0
            with self._lock:
                self.offload_bytes += blob.nbytes
                self.offload_seconds += dt
            self.metrics.record_offload("host", blob.nbytes, dt)
            remote = self.remote
            if remote is not None and self._remote_mirror and not remote.contains(seq_hash):
                # fleet publication rides the kv-remote thread; the host
                # blob is already materialized, so this enqueue is free
                remote.submit_put(seq_hash, blob, meta)
            self._observe_occupancy()
        except Exception:
            logger.exception("offload store failed for %x", seq_hash)
            self.note_copy_fail()

    def submit_put(self, seq_hash: int, blob: Any, meta: BlockMeta) -> None:
        """Store an externally sourced block (a prefix-onboard donor's or
        the G4 store's) without touching the calling thread: the put --
        and any disk demotion it cascades into -- runs on the offload
        thread."""
        self._ex.submit(self._store_put, seq_hash, blob, meta)

    def _store_put(self, seq_hash: int, blob: Any, meta: BlockMeta) -> None:
        try:
            self.host.put(seq_hash, blob, meta)
            self._observe_occupancy()
        except Exception:
            logger.debug("tier put failed for %x", seq_hash, exc_info=True)

    def note_copy_fail(self) -> None:
        """Count a lost offload copy (a snapshot that could not be taken):
        a cache miss later, never an error."""
        with self._lock:
            self.copy_fails += 1
        self.metrics.copy_fails.inc()

    # -- lookup path (tiered prefix reuse) -----------------------------------

    def lookup(self, seq_hash: int) -> Optional[Tuple[Any, BlockMeta, str]]:
        """Admission-time probe: returns ``(blob, meta, tier)`` for a
        RAM-resident hit.  A disk-only hit schedules an asynchronous
        promote (so a later admission -- or the retry after prefetch --
        hits in RAM) and returns None: this path runs on the event loop
        and must never wait on file I/O."""
        self.tier_lookups += 1
        hit = self.host.get_ram(seq_hash)
        if hit is not None:
            self.tier_hits["host"] += 1
            self.metrics.tier_hits.labels("host").inc()
            return hit[0], hit[1], "host"
        if self.disk is not None and seq_hash in self.disk:
            with self._lock:
                schedule = seq_hash not in self._promoting
                if schedule:
                    self._promoting.add(seq_hash)
            if schedule:
                self._ex.submit(self._promote, seq_hash)
        return None

    def _promote(self, seq_hash: int) -> None:
        try:
            hit = self.host.get(seq_hash)  # promotes disk -> ring
            if hit is not None:
                self.disk_promotes += 1
                self.metrics.tier_promotes.labels("disk").inc()
                self._observe_occupancy()
        except Exception:
            logger.debug("disk promote failed for %x", seq_hash, exc_info=True)
        finally:
            with self._lock:
                self._promoting.discard(seq_hash)
            self._wake()

    def prefetch(self, seq_hashes: List[int], request_id: Optional[str] = None) -> None:
        """Queue-side prefetch: while the request waits for admission,
        promote its offloaded prefix chain into the host ring so the
        admission-time ``lookup`` is a RAM hit.  Stops at the first tier
        miss -- prefix chains are only usable contiguously.

        With a ``request_id`` the walk is *tracked*: every block it stages
        is pinned against ring demotion until the request admits
        (:meth:`finish_prefetch`) or cancels (:meth:`cancel_prefetch`), and
        the issue/complete/admit stamps feed ``dynamo_kv_prefetch_*``."""
        if not seq_hashes:
            return
        state = None
        if request_id is not None:
            state = PrefetchState(hashes=list(seq_hashes))
            with self._lock:
                old = self._prefetch_states.pop(request_id, None)
                self._prefetch_states[request_id] = state
                self.prefetch_issued += len(seq_hashes)
            if old is not None:
                self._release_prefetch(old, wasted=True)
            self.metrics.prefetch_issued.inc(len(seq_hashes))
        self._ex.submit(self._prefetch, list(seq_hashes), request_id, state)

    def _prefetch(
        self,
        seq_hashes: List[int],
        request_id: Optional[str] = None,
        state: Optional[PrefetchState] = None,
    ) -> None:
        for h in seq_hashes:
            try:
                if not self.host.touch(h):
                    if self.host.get(h) is None:
                        break
                    # a promote is NOT a hit: only lookups actually served
                    # count toward tier_hit_rate
                    self.disk_promotes += 1
                    self.metrics.tier_promotes.labels("disk").inc()
                if state is not None:
                    # pin-and-record under the engine lock so a concurrent
                    # cancel (which pops the state under the same lock and
                    # unpins ``done``) cannot miss a pin
                    with self._lock:
                        if self._prefetch_states.get(request_id) is state and self.host.pin(h):
                            state.done.add(h)
            except Exception:
                logger.debug("prefetch failed at %x", h, exc_info=True)
                break
        if state is not None:
            settle = False
            with self._lock:
                state.completed_at = time.perf_counter()
                if (
                    self._prefetch_states.get(request_id) is state
                    and state.admitted_at is not None
                ):
                    # admission landed mid-walk: settle the partial overlap
                    # now that the walk's end is known
                    self._prefetch_states.pop(request_id, None)
                    settle = True
            if settle:
                self._settle_prefetch(state)
        self._observe_occupancy()

    def finish_prefetch(self, request_id: str, consumed_hashes: List[int]) -> int:
        """Admission landed: release the request's prefetch pins, count
        hits (staged blocks the admission actually onboarded) vs wasted
        bytes, and record the overlap ratio.  Returns the hit count.  Safe
        to call for untracked ids."""
        with self._lock:
            state = self._prefetch_states.get(request_id)
            if state is None:
                return 0
            state.admitted_at = time.perf_counter()
            state.consumed = set(consumed_hashes)
            if state.completed_at is None:
                # walk still running: it settles the state at its end
                return len(state.done & state.consumed)
            self._prefetch_states.pop(request_id, None)
        return self._settle_prefetch(state)

    def cancel_prefetch(self, request_id: str) -> None:
        """A queued request left before admission (cancel / error): unpin
        every staged block and charge the bytes as wasted.  A still-running
        walk stops pinning the moment the state is popped."""
        with self._lock:
            state = self._prefetch_states.pop(request_id, None)
        if state is None:
            return
        self._release_prefetch(state, wasted=True)

    def _settle_prefetch(self, state: PrefetchState) -> int:
        """Settle one tracked walk's accounting and release its pins.
        Called from the offload thread (walk end) or the engine executor
        (admission) -- never while holding ``self._lock``."""
        consumed = state.consumed or set()
        hits = len(state.done & consumed)
        wasted = len(state.done - consumed) * self.host.block_nbytes
        walk = (state.completed_at or state.issued_at) - state.issued_at
        ratio = None
        if walk > 0 and state.admitted_at is not None:
            ratio = min(max((state.admitted_at - state.issued_at) / walk, 0.0), 1.0)
        with self._lock:
            self.prefetch_hits += hits
            self.prefetch_wasted_bytes += wasted
            if ratio is not None:
                self.prefetch_overlap_sum += ratio
                self.prefetch_overlap_n += 1
        if hits:
            self.metrics.prefetch_hits.inc(hits)
        if wasted:
            self.metrics.prefetch_wasted.inc(wasted)
        if ratio is not None:
            self.metrics.prefetch_overlap.observe(ratio)
        for h in state.done:
            self.host.unpin(h)
        return hits

    def _release_prefetch(self, state: PrefetchState, wasted: bool) -> None:
        if wasted and state.done:
            nbytes = len(state.done) * self.host.block_nbytes
            with self._lock:
                self.prefetch_wasted_bytes += nbytes
            self.metrics.prefetch_wasted.inc(nbytes)
        for h in state.done:
            self.host.unpin(h)

    def contains(self, seq_hash: int) -> bool:
        return self.host.contains(seq_hash)

    def get_blocking(self, seq_hash: int) -> Optional[Tuple[Any, BlockMeta]]:
        """Tiered get from a worker thread (the block export's donor side):
        routes the possibly-disk read through the offload thread and waits
        for it, falling through to the G4 store when the local tiers miss
        (the fetch waits on the kv-remote thread -- a different executor, so
        no deadlock).  A G4 hit is put into the host ring so the next
        lookup is a RAM hit.  Never call on the event loop."""
        hit = self._ex.submit(self.host.get, seq_hash).result()
        if hit is None and self.remote is not None and self.remote.contains(seq_hash):
            fetched = self.remote.fetch_blocking(seq_hash)
            if fetched is not None:
                self.submit_put(seq_hash, fetched[0], fetched[1])
                hit = fetched
        return hit

    # -- swap records (preempted-sequence KV) --------------------------------

    def swap_out(
        self, request_id: str, snap: Any, cache_len: int, n_blocks: int,
        shards: Optional[Dict[str, int]] = None,
    ) -> bool:
        """Reserve budget and park a preemption snapshot (a
        ``kv_cache.PageSnapshot``).  Its device copy is retained (within
        ``swap_device_blocks``) so a short park restores without crossing
        the host link; the host materialize is queued as the spill.
        Returns False (the caller falls back to recompute) when swap is
        disabled, the budget is exhausted, or the ``offload.copy_fail``
        chaos site fires -- tiers-full is a fallback, never an error."""
        from .runtime import faults

        if not self.swap_enabled:
            return False
        if faults.injector.enabled and faults.injector.should_fire(
            "offload.copy_fail", f"swap/{request_id}"
        ):
            # runs on the engine executor while the offload thread may be
            # bumping the same counters: lock-guard the increments
            with self._lock:
                self.copy_fails += 1
                self.swap_fallbacks += 1
            self.metrics.copy_fails.inc()
            self.metrics.swap_fallbacks.labels("copy_fail").inc()
            return False
        keep_dev = self.swap_device_blocks > 0
        with self._lock:
            if request_id in self._swaps:
                return False  # defensive: one parked record per request
            if self._swap_used + n_blocks > self.swap_blocks:
                self.swap_fallbacks += 1
                self.metrics.swap_fallbacks.labels("budget").inc()
                return False
            self._swap_used += n_blocks
            if keep_dev:
                self._swap_dev_used += n_blocks
            self._swaps[request_id] = SwapRecord(
                cache_len=cache_len,
                n_blocks=n_blocks,
                shards=dict(shards) if shards else None,
                dev=snap.dev if keep_dev else None,
            )
            self.swap_outs += 1
        self.metrics.swap_events.labels("out").inc()
        self._ex.submit(self._store_swap, request_id, snap)
        return True

    def _store_swap(self, request_id: str, snap: Any) -> None:
        with self._lock:  # racing drop_swap pops under the same lock
            rec = self._swaps.get(request_id)
        if rec is None:
            return  # dropped (cancel / already restored from the device copy)
        try:
            t0 = time.perf_counter()
            rec.blob = to_host(snap)
            rec.nbytes = rec.blob.nbytes
            dt = time.perf_counter() - t0
            rec.state = SWAP_READY
            with self._lock:
                self.offload_bytes += rec.nbytes
                self.offload_seconds += dt
            self.metrics.record_offload("swap", rec.nbytes, dt)
            # host spill landed: drop the device copy if the staging budget
            # is oversubscribed (long parks ride the host blob)
            with self._lock:
                if rec.dev is not None and self._swap_dev_used > self.swap_device_blocks:
                    rec.dev = None
                    self._swap_dev_used -= rec.n_blocks
        except Exception:
            logger.exception("swap store failed for %s", request_id)
            self.note_copy_fail()
            rec.state = SWAP_FAILED
        finally:
            self._observe_occupancy()
            self._wake()

    def poll_swap(self, request_id: str) -> Optional[SwapRecord]:
        return self._swaps.get(request_id)

    def drop_swap(self, request_id: str) -> None:
        with self._lock:
            rec = self._swaps.pop(request_id, None)
            if rec is not None:
                self._swap_used -= rec.n_blocks
                if rec.dev is not None:
                    rec.dev = None
                    self._swap_dev_used -= rec.n_blocks
        if rec is not None:
            self._observe_occupancy()

    def record_onboard(self, tier: str, nbytes: int, seconds: float) -> None:
        """Called by the engine once an onboard scatter has landed on the
        device; feeds the ``kv_onboard_gbps`` accounting."""
        self.onboard_bytes += nbytes
        self.onboard_seconds += seconds
        d = self.onboard_detail.setdefault(tier, [0.0, 0.0])
        d[0] += nbytes
        d[1] += seconds
        if tier == "swap":
            self.swap_ins += 1
            self.metrics.swap_events.labels("in").inc()
        self.metrics.record_onboard(tier, nbytes, seconds)

    # -- observability -------------------------------------------------------

    def _observe_occupancy(self) -> None:
        with self._lock:
            swap_used = self._swap_used
        self.metrics.tier_blocks.labels("host").set(len(self.host))
        if self.disk is not None:
            self.metrics.tier_blocks.labels("disk").set(len(self.disk))
        self.metrics.tier_blocks.labels("swap").set(swap_used)

    @property
    def tier_hit_rate(self) -> float:
        """Fraction of tier lookups served from G2/G3."""
        if not self.tier_lookups:
            return 0.0
        return min((self.tier_hits["host"] + self.tier_hits["disk"]) / self.tier_lookups, 1.0)

    def stats(self) -> Dict[str, Any]:
        out = dict(self.host.stats())
        out.update(
            offload_bytes=self.offload_bytes,
            offload_seconds=round(self.offload_seconds, 6),
            onboard_bytes=self.onboard_bytes,
            onboard_seconds=round(self.onboard_seconds, 6),
            onboard_detail={
                t: {"bytes": int(b), "seconds": round(s, 6)}
                for t, (b, s) in self.onboard_detail.items()
            },
            tier_hits=dict(self.tier_hits),
            tier_lookups=self.tier_lookups,
            disk_promotes=self.disk_promotes,
            swap_outs=self.swap_outs,
            swap_ins=self.swap_ins,
            swap_fallbacks=self.swap_fallbacks,
            onboard_fallbacks=self.onboard_fallbacks,
            swap_used_blocks=self._swap_used,
            copy_fails=self.copy_fails,
            prefetch_issued=self.prefetch_issued,
            prefetch_hits=self.prefetch_hits,
            prefetch_wasted_bytes=self.prefetch_wasted_bytes,
            prefetch_pinned_blocks=self.host.pinned_blocks,
        )
        if self.prefetch_overlap_n:
            out["prefetch_overlap_ratio"] = round(
                self.prefetch_overlap_sum / self.prefetch_overlap_n, 4
            )
        if self.onboard_seconds > 0:
            out["onboard_gbps"] = round(self.onboard_bytes / self.onboard_seconds / 1e9, 3)
        if self.remote is not None:
            out.update(self.remote.stats())
        return out
