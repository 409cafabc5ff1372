"""The port's copies of the block-hash chain and the page pool against the
JAX package's: the same tokens give the same block and sequence hashes
(through the native library when it is built, and through the pure-Python
xxh64), and the same allocation and prefix-reuse story."""

from __future__ import annotations

import numpy as np
import pytest

from dynamo_tpu import block_manager as jbm
from dynamo_tpu.tokens import hashing as jhash
from dynamo_tpu.tokens.sequence import TokenBlockSequence as JaxSequence
from dynamo_tpu_torch import block_manager as tbm
from dynamo_tpu_torch.tokens import hashing as thash
from dynamo_tpu_torch.tokens.sequence import TokenBlockSequence


@pytest.mark.parametrize("block_size", [4, 16])
def test_block_hashes_equal_the_jax_package(block_size):
    rs = np.random.default_rng(block_size)
    for n in (0, 3, block_size, 5 * block_size + 3):
        tokens = rs.integers(0, 128256, n).tolist()
        want = jhash.hash_blocks(tokens, block_size)
        assert thash.hash_blocks(tokens, block_size) == want
        seq = TokenBlockSequence(tokens, block_size)
        ref = JaxSequence(tokens, block_size)
        assert seq.sequence_hashes() == ref.sequence_hashes() == want[1]
        assert seq.block_hashes() == ref.block_hashes() == want[0]


def test_pure_python_xxh64_equals_the_jax_package():
    rs = np.random.default_rng(0)
    for n in (0, 1, 7, 31, 32, 33, 100):
        data = rs.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert thash.xxh64_py(data, 17) == jhash.xxh64_py(data, 17) == jhash.xxh64(data, 17)


def test_page_pool_reuses_prefixes_like_the_jax_package():
    pools = [tbm.PagePool(16, pages_per_block=1), jbm.PagePool(16, pages_per_block=1)]
    _, hashes = thash.hash_blocks(list(range(12)), 4)
    seen = []
    for pool in pools:
        pages = pool.alloc(3)
        for h, page in zip(hashes, pages):
            pool.register(h, [page])
        for h in hashes:
            pool.release(h)
        hit = [b.pages for b in pool.match(hashes[:2])]
        seen.append((pages, hit, pool.used_pages, pool.free_pages))
    assert seen[0] == seen[1]
    assert seen[0][1] == [(p,) for p in seen[0][0][:2]]
