"""Speculative decoding subsystem: pluggable drafters + batched verify.

Decode at small batch is memory-bound: every decode step streams the full
weight set to produce ONE token per lane.  Draft-and-verify speculation
converts that headroom into tokens/s -- a cheap *drafter* proposes the next
few tokens from host-side token history, the engine scores all of them in
ONE forward pass, and the longest prefix whose drafts match the model's own
samples commits in a single step.  Rejected columns are discarded by the
host-side replay that already drops post-finish columns
(``scheduler._commit_lane_column``), so a bad draft can only cost wasted
compute, never wrong output: committed tokens are always the TARGET
model's samples, which makes speculative output bit-identical to plain
decode for greedy and seeded lanes (the port's per-lane noise is a pure
function of (lane key, position) -- ``engine/sampling.py``).

The package is engine-agnostic: drafters see token histories, never device
state.  ``Drafter`` is the extension point; :class:`NGramDrafter` is the
model-free prompt-lookup baseline that needs no second weight load, and
:class:`~.model_drafter.ModelDrafter` (``spec/model_drafter.py``) is the
learned proposer -- a second small weight load on the engine's device,
registered engine-scoped under kind ``"model"`` when the engine is armed
with ``draft_model``.

The verify step runs in one of two forms: the speculating lanes' columns
fold into ``engine/step.py`` ``packed_unified_step`` as more flat-axis
segments (the packed ragged attention kernel on the card), or, on classic
ticks, the rectangle layout and ``fold_spec_verify=False``, the standalone
``verify_and_sample`` (the prefix-suffix flash prefill kernel on the card).
Acceptance-aware auto-disable reverts low-acceptance lanes to plain decode
so speculation is safe to run default-on.

A port of the JAX package's ``spec/``: ``drafter.py`` is its copy,
``model_drafter.py`` its rewrite in torch.
"""

from .drafter import (
    DRAFTERS,
    MAX_DRAFT_TOKENS,
    Drafter,
    NGramDrafter,
    SpecState,
    longest_accepted,
    make_drafter,
    register_drafter,
    spec_live,
)

__all__ = [
    "DRAFTERS",
    "MAX_DRAFT_TOKENS",
    "Drafter",
    "NGramDrafter",
    "SpecState",
    "longest_accepted",
    "make_drafter",
    "register_drafter",
    "spec_live",
]
