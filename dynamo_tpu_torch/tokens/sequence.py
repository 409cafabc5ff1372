"""TokenBlockSequence: incremental block-aligned view of a token stream.

Reference parity: lib/llm/src/tokens.rs (TokenBlockSequence with append /
extend / truncate / unwind and incremental block completion).  The engine appends generated
tokens one at a time; each time a block completes, its block/sequence
hashes are computed and the completion is surfaced so block-manager
registrations can happen.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from .hashing import KV_HASH_SEED, block_hash, chain_hash


@dataclass(frozen=True)
class TokenBlock:
    """One complete, immutable block of tokens."""

    tokens: Tuple[int, ...]
    block_hash: int
    sequence_hash: int
    parent_sequence_hash: int
    position: int  # block index in the sequence


class TokenBlockSequence:
    """Append-only (with unwind) sequence of tokens, chunked into blocks.

    Complete blocks are hashed and frozen; the tail (< block_size tokens)
    stays mutable.  ``append`` returns the newly-completed block, if any.

    Thread model: a sequence is a per-request value object.  It is built
    where the request arrives (the event loop) and, on admission,
    ownership transfers to the engine's tick domain -- two domains never
    hold a live reference concurrently.
    """

    def __init__(
        self,
        tokens: Optional[Sequence[int]] = None,
        block_size: int = 16,
        seed: int = KV_HASH_SEED,
    ) -> None:
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = block_size
        self.seed = seed
        self.blocks: List[TokenBlock] = []
        self._tail: List[int] = []
        self._tokens: List[int] = []
        if tokens:
            self.extend(tokens)

    # -- observers ---------------------------------------------------------

    @property
    def tokens(self) -> List[int]:
        return self._tokens

    def __len__(self) -> int:
        return len(self._tokens)

    def block_hashes(self) -> List[int]:
        return [b.block_hash for b in self.blocks]

    def sequence_hashes(self) -> List[int]:
        return [b.sequence_hash for b in self.blocks]

    @property
    def last_sequence_hash(self) -> int:
        return self.blocks[-1].sequence_hash if self.blocks else 0

    # -- mutation ----------------------------------------------------------

    def append(self, token: int) -> Optional[TokenBlock]:
        """Append one token; returns the block it completed, if any."""
        self._tokens.append(int(token))
        self._tail.append(int(token))
        if len(self._tail) == self.block_size:
            return self._seal_tail()
        return None

    def extend(self, tokens: Sequence[int]) -> List[TokenBlock]:
        """Append many tokens; returns all blocks completed by them."""
        completed: List[TokenBlock] = []
        for t in tokens:
            blk = self.append(t)
            if blk is not None:
                completed.append(blk)
        return completed

    def _seal_tail(self) -> TokenBlock:
        parent = self.last_sequence_hash
        bh = block_hash(self._tail, self.seed)
        sh = bh if not self.blocks else chain_hash(parent, bh, self.seed)
        blk = TokenBlock(
            tokens=tuple(self._tail),
            block_hash=bh,
            sequence_hash=sh,
            parent_sequence_hash=parent,
            position=len(self.blocks),
        )
        self.blocks.append(blk)
        self._tail.clear()
        return blk

    def truncate(self, n_tokens: int) -> None:
        """Drop tokens from the end until ``len(self) == n_tokens``."""
        if n_tokens < 0 or n_tokens > len(self._tokens):
            raise ValueError(f"cannot truncate to {n_tokens}")
        self._tokens = self._tokens[:n_tokens]
        n_complete = n_tokens // self.block_size
        self.blocks = self.blocks[:n_complete]
        self._tail = self._tokens[n_complete * self.block_size :]

    def unwind(self, n_tokens: int) -> None:
        """Remove the last ``n_tokens`` tokens (the mocker's rollback of a
        token whose block found no room)."""
        self.truncate(len(self._tokens) - n_tokens)
