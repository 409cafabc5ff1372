"""Token block identity: hashing + block sequences (shared by router/engine/KVBM)."""

from .hashing import (
    KV_HASH_SEED,
    NATIVE,
    block_hash,
    chain_hash,
    hash_blocks,
    xxh64,
    xxh64_py,
)
from .sequence import TokenBlock, TokenBlockSequence

__all__ = [
    "KV_HASH_SEED",
    "NATIVE",
    "TokenBlock",
    "TokenBlockSequence",
    "block_hash",
    "chain_hash",
    "hash_blocks",
    "xxh64",
    "xxh64_py",
]
