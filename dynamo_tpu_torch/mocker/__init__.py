"""Mocker: a deterministic fake engine for chip-free CI.

A copy of the JAX package's ``mocker/`` (which loads no JAX), the rebuild
of the reference mocker (lib/llm/src/mocker/{scheduler,kv_manager,
sequence,evictor}.rs): it simulates continuous batching, paged-KV block
movement (active/inactive pools, LRU eviction, preemption), prefix-cache
reuse, and KV event publication -- behind the exact AsyncEngine surface of
``TorchEngine``, on no device.  Router / disaggregation / planner logic
runs against it in milliseconds, and its streams and events equal the JAX
package's mocker's.
"""

from .kv_manager import LRUEvictor, MockKvManager, PrefillCost
from .engine import MockerConfig, MockerEngine

__all__ = [
    "LRUEvictor",
    "MockKvManager",
    "MockerConfig",
    "MockerEngine",
    "PrefillCost",
]
