"""CUDA graphs for the engine's decode-only dispatches.

The JAX engine runs every step as one compiled executable, and its
``PackedShapeBudget`` bounds how many exist.  On the card the engine
replays CUDA graphs for the dispatches without prefill work, over the
dense and the int8 pool: the packed unified step of a decode-only
dispatch, and the decode step -- each of the K - 1 steps of the multistep
tail and each of the ``decode_block_size`` steps of a classic decode block
(with and without penalty histograms) is one replay of it.  A graph holds
one step, not a whole dispatch: a dispatch of K steps replays K graphs, a
few microseconds of host time each, while capturing a whole 16-step block
took seconds on the card (its eager warm-up and the instantiation of a
graph sixteen times larger), and K and the block size leave the keys.
Dispatches that carry prefill chunks, and the prefill dispatches, stay
eager.

Keys.  A key holds everything that shapes the captured work: the kind;
for the packed step its axis ``Np`` and window ``s_max`` (resolved through
``PackedShapeBudget``; an eviction there releases its graphs); the live
page-table width ``Pb``; the sampling variant (``top_n``, ``use_filters``
and, for the decode step, ``use_penalties``).

Capture.  The first run of a key runs eagerly on a side stream -- it is
the warm-up, and its results are the step's own -- then
``torch.cuda.graph`` captures the same call, which executes nothing.  All
live graphs share one memory pool: replays are serialised on one stream,
so the graphs' intermediates never live at once and do not multiply.

Buffers.  What varies per dispatch within a key (the packed layout)
enters through static input tensors, filled before each replay by
non-blocking copies from pinned host memory that this call owns.  The
decode state, the sampling tensors, the penalty histograms and the KV pool
are the engine's persistent tensors themselves, at fixed addresses; the
captured call copies its new state into them.  The output is the graph's
static tensor: the caller copies it out, on the same stream, before a
later replay can overwrite it.

Launch counts.  A kernel's ``launches`` counts wrapper calls, and a replay
calls no wrapper.  So each kernel's launch delta is recorded during
capture (and taken back: capture launches nothing) and added at every
replay; the counts keep meaning kernel launches that ran.

On the CPU there are no graphs: the same call runs eagerly.  On the card
a capture or replay error raises; nothing falls back to eager.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, List, Sequence, Tuple

import torch

from ..ops import build
from . import attention as att
from .step import StepFn


def launch_counts() -> List[int]:
    """Every kernel's launch count and the gathered decode composition's
    call count (an int8 pool's decode steps), in a fixed order."""
    return [k.launches for k in build.KERNELS] + [att.gathered_decode_calls]


def set_launch_counts(counts: Sequence[int]) -> None:
    for k, n in zip(build.KERNELS, counts):
        k.launches = n
    att.gathered_decode_calls = counts[len(build.KERNELS)]


@dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    inputs: Tuple[torch.Tensor, ...]  # static inputs, filled per replay
    output: torch.Tensor  # static output
    delta: List[int]  # launch counts one replay adds


class StepGraphs:
    """The captured decode graphs of one engine, by key."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.captures = 0
        # host wall time of the captures, their eager warm-ups included
        # (``torch.cuda.graph`` synchronizes the device as it begins)
        self.capture_ms = 0.0
        self.replays: Dict[str, int] = {}
        self._graphs: Dict[Hashable, _Graph] = {}
        self._pool = None
        self._side = None

    def keys(self) -> List[Hashable]:
        return list(self._graphs)

    def run(
        self, kind: str, key: Hashable, inputs: Sequence[torch.Tensor], call: StepFn
    ) -> torch.Tensor:
        """Run one step: ``inputs`` are host tensors (pinned on the
        card).  On the CPU ``call`` runs on them eagerly; on the card the
        key's graph replays, or is captured after an eager first run."""
        if self.device.type != "cuda":
            return call(tuple(inputs))
        g = self._graphs.get(key)
        if g is None:
            return self._capture(key, inputs, call)
        for dst, src in zip(g.inputs, inputs):
            dst.copy_(src, non_blocking=True)
        g.graph.replay()
        set_launch_counts([n + d for n, d in zip(launch_counts(), g.delta)])
        self.replays[kind] = self.replays.get(kind, 0) + 1
        return g.output

    def _capture(
        self, key: Hashable, inputs: Sequence[torch.Tensor], call: StepFn
    ) -> torch.Tensor:
        t0 = time.perf_counter()
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(self.device)
        static = tuple(torch.empty_like(h, device=self.device) for h in inputs)
        for dst, src in zip(static, inputs):
            dst.copy_(src, non_blocking=True)
        # the warm-up is the step's own run, eager on a side stream
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            out = call(static)
        cur.wait_stream(self._side)
        out.record_stream(cur)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            output = call(static)
        delta = [a - b for a, b in zip(launch_counts(), before)]
        set_launch_counts(before)
        self._graphs[key] = _Graph(graph, static, output, delta)
        self.captures += 1
        self.capture_ms += (time.perf_counter() - t0) * 1e3
        return out

    def release(self, keep: Callable[[Hashable], bool]) -> None:
        """Drop the graphs whose key ``keep`` refuses (a shape the budget
        evicted); their memory returns to the shared pool."""
        for key in [k for k in self._graphs if not keep(k)]:
            del self._graphs[key]
        if not self._graphs:
            # a pool no graph holds is released and cannot take another
            # capture: the next capture starts a fresh one
            self._pool = None
