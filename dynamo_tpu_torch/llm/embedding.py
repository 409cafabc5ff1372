"""Embedding serving: /v1/embeddings behind the same engine stack.

A copy of the JAX package's ``llm/embedding.py``: the first-party trunk
doubles as the embedder (``TorchEngine.embed``: mean-pooled, L2-normalised
final hidden rows).  ``EmbeddingEngine`` accepts an ``EmbeddingRequest``
(texts are tokenized here) and yields one item ``{"embeddings": [[...]],
"prompt_tokens": N}``.  Not carried over: ``router_embedder`` and the
worker side's ``{"token_batches": ...}`` wire form, the distributed leg,
which wait for the distributed runtime.
"""

from __future__ import annotations

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
            else:
                raise OpenAIError("expected an embedding request")
        except OpenAIError as e:
            # stable wire marker: a distributed leg maps prologue errors
            # carrying it back to a client-facing 400
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
