"""Token-block hashing: the canonical block identity of the framework.

Reference parity: lib/tokens/src/lib.rs (Tokens/TokenBlock, salt/block/
sequence xxHash chained hashing; SequenceHash binds position via the parent
hash).  Block identity must be bit-identical across the KV router, the block
manager, and the engine -- it is centralized here and nowhere else.

A copy of the JAX package's ``tokens/hashing.py``.  The hot path is native
(native/tokenhash.cpp via ctypes, when ``make -C native`` has built it); a
pure-Python XXH64 (same from-spec algorithm) serves without the compiled
library.  Both are cross-checked against the JAX package in tests.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

KV_HASH_SEED = 1337  # reference: kv_router/indexer.rs:86-102 uses seed 1337

# ---------------------------------------------------------------------------
# Pure-Python XXH64 (from the public spec)
# ---------------------------------------------------------------------------

_P1 = 11400714785074694791
_P2 = 14029467366897019727
_P3 = 1609587929392839161
_P4 = 9650029242287828579
_P5 = 2870177450012600261
_M = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M, 31) * _P1) & _M


def _merge(h: int, acc: int) -> int:
    return ((h ^ _round(0, acc)) * _P1 + _P4) & _M


def xxh64_py(data: bytes, seed: int = 0) -> int:
    n = len(data)
    p = 0
    if n >= 32:
        a1 = (seed + _P1 + _P2) & _M
        a2 = (seed + _P2) & _M
        a3 = seed & _M
        a4 = (seed - _P1) & _M
        while p + 32 <= n:
            a1 = _round(a1, int.from_bytes(data[p : p + 8], "little"))
            a2 = _round(a2, int.from_bytes(data[p + 8 : p + 16], "little"))
            a3 = _round(a3, int.from_bytes(data[p + 16 : p + 24], "little"))
            a4 = _round(a4, int.from_bytes(data[p + 24 : p + 32], "little"))
            p += 32
        h = (_rotl(a1, 1) + _rotl(a2, 7) + _rotl(a3, 12) + _rotl(a4, 18)) & _M
        h = _merge(h, a1)
        h = _merge(h, a2)
        h = _merge(h, a3)
        h = _merge(h, a4)
    else:
        h = (seed + _P5) & _M

    h = (h + n) & _M
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(data[p : p + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p : p + 4], "little") * _P1) & _M
        h = (_rotl(h, 23) * _P2 + _P3) & _M
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M
        h = (_rotl(h, 11) * _P1) & _M
        p += 1

    h ^= h >> 33
    h = (h * _P2) & _M
    h ^= h >> 29
    h = (h * _P3) & _M
    h ^= h >> 32
    return h


# ---------------------------------------------------------------------------
# Native library loader
# ---------------------------------------------------------------------------

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
_NATIVE_PATHS = [
    os.environ.get("DYN_NATIVE_LIB", ""),
    os.path.join(_REPO_ROOT, "native", "build", "libdynnative.so"),
]


def _load_native() -> Optional[ctypes.CDLL]:
    for path in _NATIVE_PATHS:
        if path and os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.dyn_xxh64.restype = ctypes.c_uint64
                lib.dyn_xxh64.argtypes = [
                    ctypes.c_void_p,
                    ctypes.c_size_t,
                    ctypes.c_uint64,
                ]
                lib.dyn_hash_blocks.restype = None
                lib.dyn_hash_blocks.argtypes = [
                    ctypes.c_void_p,
                    ctypes.c_size_t,
                    ctypes.c_size_t,
                    ctypes.c_uint64,
                    ctypes.c_void_p,
                    ctypes.c_void_p,
                    ctypes.c_size_t,
                ]
                return lib
            except OSError:
                continue
    return None


NATIVE = _load_native()


def xxh64(data: bytes, seed: int = 0) -> int:
    if NATIVE is not None:
        return NATIVE.dyn_xxh64(data, len(data), seed)
    return xxh64_py(data, seed)


# ---------------------------------------------------------------------------
# Block / sequence hashing
# ---------------------------------------------------------------------------


def block_hash(tokens: Sequence[int], seed: int = KV_HASH_SEED) -> int:
    """Hash one complete token block (content identity, position-free)."""
    arr = np.asarray(tokens, dtype=np.int32)
    return xxh64(arr.tobytes(), seed)


def chain_hash(parent: int, block: int, seed: int = KV_HASH_SEED) -> int:
    """Combine a parent sequence hash with a block hash (position binding)."""
    buf = np.array([parent, block], dtype=np.uint64).tobytes()
    return xxh64(buf, seed)


def hash_blocks(
    tokens: Sequence[int], block_size: int, seed: int = KV_HASH_SEED
) -> Tuple[List[int], List[int]]:
    """Hash all *complete* blocks of ``tokens``.

    Returns ``(block_hashes, sequence_hashes)``; ``sequence_hashes[i]`` chains
    ``sequence_hashes[i-1]`` so equal values imply an identical token prefix.
    The first block's sequence hash equals its block hash.
    """
    arr = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
    n_blocks = len(arr) // block_size
    if n_blocks == 0:
        return [], []
    if NATIVE is not None:
        bh = np.empty(n_blocks, dtype=np.uint64)
        sh = np.empty(n_blocks, dtype=np.uint64)
        NATIVE.dyn_hash_blocks(
            arr.ctypes.data,
            len(arr),
            block_size,
            seed,
            bh.ctypes.data,
            sh.ctypes.data,
            n_blocks,
        )
        return bh.tolist(), sh.tolist()

    bhs: List[int] = []
    shs: List[int] = []
    parent = 0
    for i in range(n_blocks):
        block = arr[i * block_size : (i + 1) * block_size]
        bh_i = xxh64(block.tobytes(), seed)
        sh_i = bh_i if i == 0 else chain_hash(parent, bh_i, seed)
        bhs.append(bh_i)
        shs.append(sh_i)
        parent = sh_i
    return bhs, shs
