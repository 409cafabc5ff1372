"""Echo engines: deterministic no-model backends for wiring tests.

Reference parity: launch/dynamo-run echo engines (``out=echo_core`` echoes
token ids through the full preprocessor/backend pipeline, ``out=echo_full``
echoes the rendered prompt text).  Useful for driving the HTTP/router/
pipeline stack with zero model weight and exact, predictable output.  A
copy of the JAX package's ``llm/echo.py``.
"""

from __future__ import annotations

import asyncio
from typing import Any, AsyncIterator

from ..protocols.common import FinishReason, LLMEngineOutput, PreprocessedRequest
from ..runtime.engine import Annotated, AsyncEngine, Context, ResponseStream


class EchoEngineCore(AsyncEngine):
    """Token-level echo: streams the prompt's token ids back one at a time
    (capped by max_tokens), then finishes with STOP.  Sits exactly where
    TorchEngine sits, so the preprocessor -> backend -> detokenize path runs
    unchanged."""

    def __init__(self, delay_ms: float = 0.0) -> None:
        self.delay_ms = delay_ms

    async def stop(self) -> None:
        """Lifecycle parity with the real engines (callers stop() whatever
        _make_engine built)."""

    async def generate(self, request: Context[Any]) -> AsyncIterator[Annotated]:
        data = request.data
        req = (
            PreprocessedRequest.from_dict(data) if isinstance(data, dict) else data
        )
        ctx = request.ctx
        tokens = list(req.token_ids)
        cap = req.stop_conditions.max_tokens
        if cap is not None:
            tokens = tokens[:cap]
        delay = self.delay_ms / 1e3

        async def gen() -> AsyncIterator[Annotated]:
            for t in tokens:
                if ctx.is_stopped():
                    yield Annotated.from_data(
                        LLMEngineOutput.finished(FinishReason.CANCELLED).to_dict()
                    )
                    return
                if delay:
                    await asyncio.sleep(delay)
                yield Annotated.from_data(
                    LLMEngineOutput(token_ids=[t]).to_dict()
                )
            yield Annotated.from_data(
                LLMEngineOutput.finished(FinishReason.STOP).to_dict()
            )

        return ResponseStream(ctx, gen())
