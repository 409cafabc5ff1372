"""Drafters: cheap host-side proposers behind the ``Drafter`` protocol.

A drafter runs on the engine executor thread once per verify dispatch, so
it must be cheap relative to a device forward pass (microseconds, not
milliseconds) and must never touch device state -- it sees the request's
committed token history (prompt + generated) and returns candidate
continuations.  Proposals are *hints*: the verify step scores them against
the target model and the accept walk keeps only the prefix the model
itself would have sampled, so a drafter can be arbitrarily wrong without
affecting output (only acceptance rate).

Catalog:

``ngram`` / ``prompt_lookup``
    Model-free prompt-lookup drafting: match the sequence tail against the
    prompt + generated history and propose the continuation of the most
    recent earlier occurrence.  No second weight load, no device memory;
    wins on repetitive continuations (code, extraction, templated text,
    and the token cycles greedy decode settles into) and degrades to
    zero-cost no-ops elsewhere.

Custom drafters register via :func:`register_drafter` (tests use this to
install oracle drafters; a small-model drafter would register the same
way).

A copy of the JAX package's ``spec/drafter.py`` without its hot-path
decorator: the module imports nothing but the standard library.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import (
    Callable,
    Dict,
    List,
    Optional,
    Protocol,
    Sequence,
    Tuple,
    runtime_checkable,
)

# Hard cap on per-request draft length: the engine pads the verify
# dispatch's token axis to a power of two, so this bounds compile-cache
# entries to {1+1, 1+2, 1+4, 1+8} columns.  Requests asking for more are
# clamped (mirrors the top-logprobs clamp, PARITY.md).
MAX_DRAFT_TOKENS = 8


@runtime_checkable
class Drafter(Protocol):
    """One request's draft proposer.

    ``propose`` receives the request's full committed token history
    (prompt + generated so far, in order) and the maximum number of draft
    tokens the engine can verify this step (page/budget-clamped).  It
    returns 0..n candidate next tokens; returning fewer (or none) is
    always safe -- the verify step still commits one model-sampled token,
    so a drafter with nothing to say degrades to plain decode.
    """

    def propose(self, history: Sequence[int], n: int) -> List[int]:
        ...


class NGramDrafter:
    """Prompt-lookup drafting (model-free n-gram matching).

    Finds the most recent earlier occurrence of the history's trailing
    k-gram (longest match first, ``max_ngram`` down to ``min_ngram``) and
    proposes the tokens that followed it.  The scan walks backwards so the
    *most recent* repetition wins -- generated-text cycles beat stale
    prompt matches, which is what acceptance wants.

    Cost discipline: this runs on the engine executor inside the verify
    cadence, so the scan compares elements in place (no per-candidate
    slice allocation; the expected cost is ~O(window) because most
    candidates mismatch on their first token) and is bounded to the most
    recent ``max_scan`` history tokens -- long-context lanes pay a
    constant, not O(context), per draft.
    """

    def __init__(
        self, max_ngram: int = 4, min_ngram: int = 2, max_scan: int = 4096
    ) -> None:
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError("need max_ngram >= min_ngram >= 1")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.max_scan = max_scan

    def propose(self, history: Sequence[int], n: int) -> List[int]:
        L = len(history)
        if n <= 0 or L < self.min_ngram + 1:
            return []
        lo = max(0, L - self.max_scan)
        for k in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            tail = history[L - k:]
            # most recent earlier occurrence: candidate starts at L-k-1 at
            # the latest, so a match always has >= 1 token after it to
            # propose (history[i + k] exists)
            for i in range(L - k - 1, lo - 1, -1):
                j = 0
                while j < k and history[i + j] == tail[j]:
                    j += 1
                if j == k:
                    return list(history[i + k : i + k + n])
        return []


def spec_live(spec: Optional["SpecState"]) -> bool:
    """Whether a lane's speculation is ACTIVE: armed and not
    auto-disabled.  The ONE predicate every eligibility site consults --
    the engine's device-activity/dec_cap/verify gates AND the scheduler's
    decode-runnable count -- so an acceptance-disabled lane looks exactly
    like a plain decode lane everywhere at once (host and device views of
    who steps it must never diverge)."""
    return spec is not None and spec.enabled


def longest_accepted(draft: Sequence[int], target: Sequence[int]) -> int:
    """Length of the verified draft prefix: ``draft[j]`` is accepted while
    it equals ``target[j]`` -- the token the model sampled at that same
    position.  Everything after the first mismatch was scored against a
    context the model rejected and is discarded (the target token at the
    mismatch position is still valid and commits as the bonus token)."""
    m = 0
    for d, t in zip(draft, target):
        if int(d) != int(t):
            break
        m += 1
    return m


@dataclass
class SpecState:
    """Per-request speculation state the engine hangs off ``SeqState``."""

    drafter: Drafter
    num_draft_tokens: int
    kind: str = "ngram"
    # acceptance accounting (per-request observability: OpenAI usage
    # extension + tracing spec_accept_rate attr)
    drafted: int = 0
    accepted: int = 0
    verify_steps: int = 0
    # a verify dispatch for this lane is in flight; the next one waits for
    # its commit (drafts extend the post-commit history)
    inflight: bool = False
    # acceptance-aware auto-disable (engine knob spec_auto_disable): a
    # lane whose warmed-up acceptance rate stays below the floor stops
    # drafting and reverts to the plain decode scan -- low-acceptance
    # traffic must not keep paying draft + rejected-column cost.  The
    # SpecState stays attached (stats still ship in the usage extension);
    # ``enabled`` is what every engine eligibility site consults.
    enabled: bool = True
    auto_disabled: bool = False
    # cross-tick draft pipelining: the NEXT generation's proposal,
    # precomputed at commit time (while the tick's other device work and
    # async host copies are in flight) as ``(history_len, tokens)``.  The
    # dispatch assembly consumes it only when ``history_len`` still equals
    # the lane's committed history -- a preempt/cancel/rollback since the
    # precompute invalidates it by construction (committed histories only
    # ever extend, so a length match IS an identity match for one seq).
    pending_draft: Optional[Tuple[int, List[int]]] = None

    @property
    def accept_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    def take_pending_draft(self, history_len: int, n: int) -> Optional[List[int]]:
        """Consume the precomputed proposal if it extends exactly the
        current committed history; None forces an inline propose."""
        got = self.pending_draft
        self.pending_draft = None
        if got is None or got[0] != history_len:
            return None
        return got[1][:n]


# kind -> zero-arg factory.  ``prompt_lookup`` aliases ``ngram`` (the
# literature name); tests/extensions add entries via register_drafter.
DRAFTERS: Dict[str, Callable[[], Drafter]] = {
    "ngram": NGramDrafter,
    "prompt_lookup": NGramDrafter,
}


def register_drafter(kind: str, factory: Callable[[], Drafter]) -> None:
    """Install a drafter factory under ``kind`` (pluggability hook: oracle
    drafters in tests, future small-model drafters in deployments)."""
    DRAFTERS[kind] = factory


def make_drafter(kind: str) -> Drafter:
    factory = DRAFTERS.get(kind)
    if factory is None:
        raise ValueError(
            f"unknown drafter {kind!r} (known: {sorted(DRAFTERS)})"
        )
    return factory()
