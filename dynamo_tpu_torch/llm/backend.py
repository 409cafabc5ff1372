"""Backend operator: incremental detokenization + stop-string jail.

Reference parity: lib/llm/src/backend.rs:63-110 -- wraps the token-level
engine (``ExecutionContext``); on the response path it turns token ids into
text via a ``DecodeStream`` and enforces *string* stop conditions the engine
cannot see: text that could be the beginning of a stop sequence is jailed
(held back) until it either completes the stop sequence (request finishes
with STOP, jailed text dropped) or diverges (jail flushes downstream).
"""

from __future__ import annotations

import time
from typing import Any, AsyncIterator, Dict, List

from ..protocols.common import FinishReason, PreprocessedRequest
from ..runtime import profiling
from ..runtime.engine import Annotated, AsyncEngine, Context, as_response_stream
from ..runtime.pipeline import Operator
from .tokenizer import Tokenizer


class StopJail:
    """Holdback buffer for partial stop-sequence matches."""

    def __init__(self, stops: List[str]) -> None:
        self.stops = [s for s in stops if s]
        self.held = ""

    def push(self, delta: str) -> tuple[str, bool]:
        """Feed a text delta; returns ``(releasable_text, stopped)``.

        When a stop string completes inside the buffer, everything before its
        first occurrence is released and ``stopped`` is True (the stop string
        itself is never emitted, matching OpenAI semantics).
        """
        if not self.stops:
            return delta, False
        buf = self.held + delta
        cut = min(
            (i for i in (buf.find(s) for s in self.stops) if i >= 0),
            default=-1,
        )
        if cut >= 0:
            self.held = ""
            return buf[:cut], True
        # longest suffix of buf that is a proper prefix of any stop string
        jail = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(buf)), 0, -1):
                if buf.endswith(s[:k]):
                    jail = max(jail, k)
                    break
        self.held = buf[len(buf) - jail :] if jail else ""
        return buf[: len(buf) - jail] if jail else buf, False

    def flush(self) -> str:
        """Stream ended without a stop match: release whatever is jailed."""
        out, self.held = self.held, ""
        return out


class Backend(Operator):
    """Forward: pass the token request through.  Backward: detokenize and
    apply the stop jail, yielding BackendOutput-shaped dicts
    (``text``/``token_ids``/``finish_reason``)."""

    def __init__(self, tokenizer: Tokenizer) -> None:
        self.tokenizer = tokenizer

    async def generate(
        self, request: Context, next: AsyncEngine
    ) -> AsyncIterator[Annotated]:
        data = request.data
        req = (
            PreprocessedRequest.from_dict(data) if isinstance(data, dict) else data
        )
        stream = await as_response_stream(next, request.replace(req.to_dict()))
        decoder = self.tokenizer.decode_stream()
        jail = StopJail(req.stop_conditions.stop or [])
        ctx = request.ctx

        async def gen() -> AsyncIterator[Annotated]:
            stopped = False
            async for item in stream:
                if not isinstance(item, Annotated):
                    item = Annotated.from_data(item)
                if item.is_error() or item.data is None:
                    yield item
                    continue
                data: Dict[str, Any] = dict(item.data)
                token_ids = data.get("token_ids") or []
                # tick-phase profiling: detok runs on frontend tasks, not
                # the engine loop, so it feeds the phase histogram
                # directly (one attribute check when disabled)
                prof = profiling.profiler
                t_detok = time.perf_counter() if prof.enabled else None
                pieces = [decoder.step(t) for t in token_ids]
                # push per piece so a stop string completing mid-chunk cuts
                # the chunk at the completing token: tokens decoded after the
                # stop (a coalesced decode block can carry many) must be
                # neither emitted nor counted toward usage
                text, hit, n_used = "", False, len(token_ids)
                if jail.stops:
                    for i, p in enumerate(pieces):
                        t, hit = jail.push(p) if p else ("", False)
                        text += t
                        if hit:
                            n_used = i + 1
                            break
                else:
                    text = "".join(p for p in pieces if p)
                if t_detok is not None:
                    # keyed on the start stamp, not a re-read of enabled: a
                    # live enable between the two would otherwise record
                    # perf_counter's absolute value as a duration
                    prof.observe_phase("detok", time.perf_counter() - t_detok)
                if hit:
                    # stop string completed: emit the releasable prefix, end
                    # the request, and tell the engine to stop decoding
                    stopped = True
                    out = {
                        "token_ids": token_ids[:n_used],
                        "text": text or None,
                        "finish_reason": FinishReason.STOP.value,
                    }
                    # logprob lists stay aligned with the truncated tokens
                    if data.get("logprobs") is not None:
                        out["logprobs"] = data["logprobs"][:n_used]
                    if data.get("top_logprobs") is not None:
                        out["top_logprobs"] = data["top_logprobs"][:n_used]
                    yield Annotated.from_data(out)
                    ctx.stop_generating()
                    break
                data["text"] = text or None
                fr = data.get("finish_reason")
                if fr:
                    # natural end: flush any jailed text first
                    tail = jail.flush()
                    if tail:
                        data["text"] = (text or "") + tail
                yield Annotated.from_data(data)
                if fr:
                    stopped = True
                    break
            if not stopped:
                # engine stream ended without a finish marker (e.g. killed)
                tail = jail.flush()
                if tail:
                    yield Annotated.from_data({"token_ids": [], "text": tail})

        return gen()
