"""Embedding serving: /v1/embeddings behind the same engine stack.

A copy of the JAX package's ``llm/embedding.py``: the first-party trunk
doubles as the embedder (``TorchEngine.embed``: mean-pooled, L2-normalised
final hidden rows).  ``EmbeddingEngine`` accepts an ``EmbeddingRequest``
(texts are tokenized here) and yields one item ``{"embeddings": [[...]],
"prompt_tokens": N}``.  The distributed leg: a worker serves the engine on
its ``{ep}_embed`` endpoint, where requests arrive in the wire form
``{"token_batches": [[ids], ...]}``, and the front end reaches it through
``router_embedder``.  ``fake_embedder`` is the model-free engines' leg
(the mocker and echo engines have no trunk).
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, AsyncIterator, Awaitable, Callable, List, Optional

from ..protocols.openai import INVALID_MARK, EmbeddingRequest, OpenAIError
from ..runtime.engine import Annotated, AsyncEngine, Context, ResponseStream
from .tokenizer import Tokenizer

Embedder = Callable[[List[List[int]]], Awaitable[List[List[float]]]]


class EmbeddingEngine(AsyncEngine):
    """AsyncEngine for embedding requests.

    Accepts an ``EmbeddingRequest`` (texts are tokenized here) and yields
    exactly one item: ``{"embeddings": [...], "prompt_tokens": N}``.
    """

    def __init__(
        self,
        embed_fn: Embedder,
        tokenizer: Optional[Tokenizer] = None,
        max_input_tokens: Optional[int] = None,
    ) -> None:
        """``max_input_tokens`` (the engine's max_seq_len) turns over-long
        inputs into 400s at the frontend instead of engine-side ValueErrors
        surfacing as 500s."""
        self.embed_fn = embed_fn
        self.tokenizer = tokenizer
        self.max_input_tokens = max_input_tokens

    def _tokenize(self, req: EmbeddingRequest) -> List[List[int]]:
        if req.token_batches is not None:
            batches = req.token_batches
        elif self.tokenizer is None:
            raise OpenAIError(
                "text input requires a tokenizer (this endpoint accepts"
                " pre-tokenized input only)"
            )
        else:
            batches = [self.tokenizer.encode(t) for t in req.texts]
        for i, b in enumerate(batches):
            if not b:
                raise OpenAIError(f"input {i} tokenized to zero tokens")
            if self.max_input_tokens is not None and len(b) > self.max_input_tokens:
                raise OpenAIError(
                    f"input {i} has {len(b)} tokens, over the model's"
                    f" {self.max_input_tokens}-token limit"
                )
        return batches

    async def generate(self, request: Context[Any]) -> AsyncIterator[Annotated]:
        data = request.data
        try:
            if isinstance(data, EmbeddingRequest):
                batches = self._tokenize(data)
            elif isinstance(data, dict) and "token_batches" in data:
                batches = data["token_batches"]
                if not (
                    isinstance(batches, list)
                    and batches
                    and all(isinstance(b, list) and b for b in batches)
                ):
                    raise OpenAIError(
                        "'token_batches' must be non-empty token lists"
                    )
                if self.max_input_tokens is not None:
                    for i, b in enumerate(batches):
                        if len(b) > self.max_input_tokens:
                            raise OpenAIError(
                                f"input {i} has {len(b)} tokens, over the"
                                f" {self.max_input_tokens}-token limit"
                            )
            else:
                raise OpenAIError("expected an embedding request")
        except OpenAIError as e:
            # stable wire marker: the distributed leg (router_embedder) maps
            # prologue errors carrying it back to a client-facing 400; other
            # prologue failures (engine crash) stay 500s
            raise OpenAIError(f"{INVALID_MARK}{e}") from e

        ctx = request.ctx

        async def gen() -> AsyncIterator[Annotated]:
            vectors = await self.embed_fn(batches)
            if not ctx.is_stopped():
                yield Annotated.from_data(
                    {
                        "embeddings": vectors,
                        "prompt_tokens": sum(len(b) for b in batches),
                    }
                )

        return ResponseStream(ctx, gen())


def router_embedder(router) -> Embedder:
    """An ``embed_fn`` that forwards token batches to a remote worker's
    embedding endpoint through a PushRouter (the distributed leg)."""

    async def embed(batches: List[List[int]]) -> List[List[float]]:
        from ..runtime.transports.request_plane import RemoteError

        try:
            stream = await router.generate(
                Context.new({"token_batches": batches})
            )
        except RemoteError as e:
            # the worker's EmbeddingEngine marks validation failures
            # (INVALID_MARK) before they cross the wire as flat RemoteError
            # messages; map those back to OpenAIError so the frontend
            # answers 400 with the worker's real reason, and leave genuine
            # worker faults as 500s
            msg = str(e)
            if INVALID_MARK in msg:
                raise OpenAIError(
                    msg.split(INVALID_MARK, 1)[1] or "invalid request"
                ) from e
            raise
        async for item in stream:
            if item.is_error():
                msg = item.error_message() or "embedding worker error"
                if INVALID_MARK in msg:
                    raise OpenAIError(msg.split(INVALID_MARK, 1)[1]) from None
                raise RuntimeError(msg)
            data = item.data or {}
            if "embeddings" in data:
                return data["embeddings"]
        raise RuntimeError("embedding worker returned no vectors")

    return embed


def fake_embedder(dim: int = 32) -> Embedder:
    """Deterministic, content-dependent unit vectors with no model -- the
    echo/mocker leg for wiring tests (same role the echo engines play for
    the generate path)."""

    async def embed(batches: List[List[int]]) -> List[List[float]]:
        out: List[List[float]] = []
        for toks in batches:
            h = hashlib.sha256(
                b",".join(str(t).encode() for t in toks)
            ).digest()
            vals = []
            seed = h
            while len(vals) < dim:
                seed = hashlib.sha256(seed).digest()
                vals.extend(b / 255.0 - 0.5 for b in seed)
            v = vals[:dim]
            norm = math.sqrt(sum(x * x for x in v)) or 1.0
            out.append([x / norm for x in v])
        return out

    return embed
