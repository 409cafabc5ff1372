"""OpenAI-compatible protocol types, SSE codec, and stream aggregators.

Reference parity: lib/llm/src/protocols/openai/* (request/response types,
SSE codec codec.rs, delta generators, stream->full aggregators) reduced to
the fields the serving path consumes.  Requests arrive as JSON dicts; these
dataclasses validate and normalize them, and the builders produce
wire-shaped dicts for both the streaming (chunk) and aggregated (full)
responses.

``nvext``-style extension fields are kept under the same names the reference
uses (ignore_eos, min_tokens, annotations) but accepted at the top level
too, matching common client behavior.
"""

from __future__ import annotations

import json
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union


# Wire marker distinguishing validation failures from other remote errors
# when an OpenAIError crosses the data plane as a flat message (the
# distributed embedding leg); stripped before anything user-facing.
INVALID_MARK = "[invalid_request] "


class OpenAIError(ValueError):
    """Invalid request -> HTTP 400 with an OpenAI-shaped error body."""

    def __init__(self, message: str, code: int = 400) -> None:
        super().__init__(message)
        self.code = code

    def to_body(self) -> Dict[str, Any]:
        msg = str(self)
        if msg.startswith(INVALID_MARK):  # wire marker is not user-facing
            msg = msg[len(INVALID_MARK):]
        return {
            "error": {
                "message": msg,
                "type": "invalid_request_error",
                "code": self.code,
            }
        }


def _as_stop_list(stop: Union[None, str, List[str]]) -> Optional[List[str]]:
    if stop is None:
        return None
    if isinstance(stop, str):
        return [stop]
    if isinstance(stop, list) and all(isinstance(s, str) for s in stop):
        return list(stop) or None
    raise OpenAIError("'stop' must be a string or a list of strings")


@dataclass
class SamplingFields:
    """Sampling/stop fields shared by chat and completion requests."""

    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    max_tokens: Optional[int] = None
    min_tokens: Optional[int] = None
    stop: Optional[List[str]] = None
    seed: Optional[int] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    ignore_eos: bool = False
    # HF-style repetition penalty (nvext field, reference SamplingOptions)
    repetition_penalty: Optional[float] = None
    # normalized logprobs request: None = off, 0 = chosen-token only,
    # N > 0 = chosen + top-N alternatives (clamped to 8, PARITY.md)
    logprobs: Optional[int] = None

    @classmethod
    def from_dict(
        cls, d: Dict[str, Any], chat: bool = False
    ) -> "SamplingFields":
        nvext = d.get("nvext") or {}
        max_tokens = d.get("max_completion_tokens", d.get("max_tokens"))
        out = cls(
            temperature=d.get("temperature"),
            top_p=d.get("top_p"),
            top_k=d.get("top_k", nvext.get("top_k")),
            max_tokens=max_tokens,
            min_tokens=d.get("min_tokens", nvext.get("min_tokens")),
            stop=_as_stop_list(d.get("stop")),
            seed=d.get("seed"),
            frequency_penalty=d.get("frequency_penalty"),
            presence_penalty=d.get("presence_penalty"),
            ignore_eos=bool(d.get("ignore_eos", nvext.get("ignore_eos", False))),
            repetition_penalty=d.get(
                "repetition_penalty", nvext.get("repetition_penalty")
            ),
            logprobs=_parse_logprobs(d, chat),
        )
        if out.temperature is not None and not 0.0 <= out.temperature <= 2.0:
            raise OpenAIError("'temperature' must be in [0, 2]")
        if out.top_p is not None and not 0.0 < out.top_p <= 1.0:
            raise OpenAIError("'top_p' must be in (0, 1]")
        if out.max_tokens is not None and out.max_tokens < 1:
            raise OpenAIError("'max_tokens' must be >= 1")
        for fname in ("frequency_penalty", "presence_penalty"):
            v = getattr(out, fname)
            if v is not None and not -2.0 <= v <= 2.0:
                raise OpenAIError(f"'{fname}' must be in [-2, 2]")
        if out.repetition_penalty is not None and out.repetition_penalty <= 0:
            raise OpenAIError("'repetition_penalty' must be > 0")
        return out


def _parse_speculation(d: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Per-request speculative-decoding knobs -> normalized dict (None =
    off).  Accepted at the top level or under ``nvext`` (matching the other
    extension fields): ``{"speculation": {"enabled": true,
    "num_draft_tokens": 4, "drafter": "ngram"}}``.  A bare ``{}`` block
    means "on with defaults".  Drafter-kind existence is validated by the
    engine (the registry is pluggable); the protocol checks shape only."""
    spec = d.get("speculation", (d.get("nvext") or {}).get("speculation"))
    if spec is None or spec is False:  # false = explicitly off, like absent
        return None
    if spec is True:
        spec = {}
    if not isinstance(spec, dict):
        raise OpenAIError("'speculation' must be an object or a boolean")
    enabled = spec.get("enabled", True)
    if not isinstance(enabled, bool):
        raise OpenAIError("'speculation.enabled' must be a boolean")
    n = spec.get("num_draft_tokens", 4)
    if not isinstance(n, int) or isinstance(n, bool) or n < 1:
        raise OpenAIError(
            "'speculation.num_draft_tokens' must be a positive integer"
        )
    drafter = spec.get("drafter", "ngram")
    if not isinstance(drafter, str) or not drafter:
        raise OpenAIError("'speculation.drafter' must be a non-empty string")
    return {"enabled": enabled, "num_draft_tokens": n, "drafter": drafter}


def _parse_logprobs(d: Dict[str, Any], chat: bool) -> Optional[int]:
    """OpenAI logprobs fields -> normalized top-N (None = off).

    Chat: ``logprobs: bool`` + ``top_logprobs: int``; completions:
    ``logprobs: int`` (N alternatives alongside the chosen token).
    Reference protocol parity: openai/completions/aggregator.rs:43."""
    lp = d.get("logprobs")
    if lp is None or lp is False:
        return None
    if chat:
        if not isinstance(lp, bool):
            raise OpenAIError("chat 'logprobs' must be a boolean")
        top = d.get("top_logprobs", 0)
        if not isinstance(top, int) or top < 0:
            raise OpenAIError("'top_logprobs' must be a non-negative integer")
        return min(top, 8)
    if isinstance(lp, bool):  # completions logprobs is numeric
        raise OpenAIError("'logprobs' must be an integer for completions")
    if not isinstance(lp, int) or lp < 0:
        raise OpenAIError("'logprobs' must be a non-negative integer")
    return min(lp, 8)


@dataclass
class ChatCompletionRequest:
    """POST /v1/chat/completions body (subset the engine consumes)."""

    model: str
    messages: List[Dict[str, Any]]
    sampling: SamplingFields
    stream: bool = False
    annotations: List[str] = field(default_factory=list)
    # normalized per-request speculative-decoding knobs (None = off)
    speculation: Optional[Dict[str, Any]] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ChatCompletionRequest":
        model = d.get("model")
        if not model or not isinstance(model, str):
            raise OpenAIError("'model' is required")
        messages = d.get("messages")
        if not isinstance(messages, list) or not messages:
            raise OpenAIError("'messages' must be a non-empty list")
        for m in messages:
            if not isinstance(m, dict) or "role" not in m:
                raise OpenAIError("each message needs a 'role'")
        if d.get("n") not in (None, 1):
            raise OpenAIError("only n=1 is supported")
        nvext = d.get("nvext") or {}
        return cls(
            model=model,
            messages=messages,
            sampling=SamplingFields.from_dict(d, chat=True),
            stream=bool(d.get("stream", False)),
            annotations=list(nvext.get("annotations") or []),
            speculation=_parse_speculation(d),
        )


@dataclass
class CompletionRequest:
    """POST /v1/completions body."""

    model: str
    prompt: Union[str, List[int]]
    sampling: SamplingFields
    stream: bool = False
    echo: bool = False
    # normalized per-request speculative-decoding knobs (None = off)
    speculation: Optional[Dict[str, Any]] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CompletionRequest":
        model = d.get("model")
        if not model or not isinstance(model, str):
            raise OpenAIError("'model' is required")
        prompt = d.get("prompt")
        if isinstance(prompt, list) and all(isinstance(t, int) for t in prompt):
            pass  # pre-tokenized prompt
        elif not isinstance(prompt, str):
            raise OpenAIError("'prompt' must be a string or a list of token ids")
        if not prompt:
            raise OpenAIError("'prompt' must not be empty")
        if d.get("n") not in (None, 1):
            raise OpenAIError("only n=1 is supported")
        # echo+logprobs (legacy OpenAI prompt logprobs) is served: the
        # preprocessor threads prompt_logprobs to the engine, whose
        # verify-scoring path computes logprobs at every prompt position
        return cls(
            model=model,
            prompt=prompt,
            sampling=SamplingFields.from_dict(d),
            stream=bool(d.get("stream", False)),
            echo=bool(d.get("echo", False)),
            speculation=_parse_speculation(d),
        )


@dataclass
class RequestTemplate:
    """Request defaults from a JSON file (reference request_template.rs:18:
    ``{model, temperature, max_completion_tokens}``).  Applied to the raw
    request body BEFORE validation; explicit client fields always win."""

    model: Optional[str] = None
    temperature: Optional[float] = None
    max_completion_tokens: Optional[int] = None

    @classmethod
    def load(cls, path: str) -> "RequestTemplate":
        with open(path) as f:
            d = json.load(f)
        return cls(
            model=d.get("model"),
            temperature=d.get("temperature"),
            max_completion_tokens=d.get("max_completion_tokens"),
        )

    def apply(self, body: Dict[str, Any]) -> Dict[str, Any]:
        if self.model is not None:
            body.setdefault("model", self.model)
        if self.temperature is not None:
            body.setdefault("temperature", self.temperature)
        if self.max_completion_tokens is not None and (
            "max_tokens" not in body and "max_completion_tokens" not in body
        ):
            body["max_tokens"] = self.max_completion_tokens
        return body


@dataclass
class EmbeddingRequest:
    """/v1/embeddings request (reference: protocols/openai/embeddings.rs).

    ``input`` accepts the OpenAI forms: one string, a list of strings, one
    token-id list, or a list of token-id lists; normalized here to
    ``texts`` (strings) or ``token_batches`` (pre-tokenized), exactly one
    of which is non-None.
    """

    model: str
    texts: Optional[List[str]] = None
    token_batches: Optional[List[List[int]]] = None
    encoding_format: str = "float"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EmbeddingRequest":
        model = d.get("model")
        if not isinstance(model, str) or not model:
            raise OpenAIError("'model' must be a non-empty string")
        fmt = d.get("encoding_format", "float")
        if fmt != "float":
            raise OpenAIError("only encoding_format='float' is supported")
        inp = d.get("input")
        texts: Optional[List[str]] = None
        batches: Optional[List[List[int]]] = None
        if isinstance(inp, str):
            texts = [inp]
        elif isinstance(inp, list) and inp:
            if all(isinstance(x, str) for x in inp):
                texts = list(inp)
            elif all(isinstance(x, int) and not isinstance(x, bool) for x in inp):
                batches = [list(inp)]
            elif all(
                isinstance(x, list)
                and x
                and all(isinstance(t, int) and not isinstance(t, bool) for t in x)
                for x in inp
            ):
                batches = [list(x) for x in inp]
        if texts is None and batches is None:
            raise OpenAIError(
                "'input' must be a string, list of strings, token-id list,"
                " or list of token-id lists (non-empty)"
            )
        return cls(model=model, texts=texts, token_batches=batches,
                   encoding_format=fmt)

    @property
    def n_inputs(self) -> int:
        return len(self.texts if self.texts is not None else self.token_batches)


def embedding_response(
    model: str, vectors: List[List[float]], prompt_tokens: int
) -> Dict[str, Any]:
    return {
        "object": "list",
        "model": model,
        "data": [
            {"object": "embedding", "index": i, "embedding": v}
            for i, v in enumerate(vectors)
        ],
        "usage": {"prompt_tokens": prompt_tokens, "total_tokens": prompt_tokens},
    }


# -- response builders -------------------------------------------------------


def new_response_id(kind: str = "chatcmpl") -> str:
    return f"{kind}-{uuid.uuid4().hex}"


def chat_chunk(
    response_id: str,
    model: str,
    created: int,
    *,
    content: Optional[str] = None,
    role: Optional[str] = None,
    finish_reason: Optional[str] = None,
    logprobs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    delta: Dict[str, Any] = {}
    if role is not None:
        delta["role"] = role
    if content is not None:
        delta["content"] = content
    choice: Dict[str, Any] = {
        "index": 0, "delta": delta, "finish_reason": finish_reason
    }
    if logprobs is not None:
        choice["logprobs"] = logprobs
    return {
        "id": response_id,
        "object": "chat.completion.chunk",
        "created": created,
        "model": model,
        "choices": [choice],
    }


def completion_chunk(
    response_id: str,
    model: str,
    created: int,
    *,
    text: str = "",
    finish_reason: Optional[str] = None,
    logprobs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    choice: Dict[str, Any] = {
        "index": 0, "text": text, "finish_reason": finish_reason
    }
    if logprobs is not None:
        choice["logprobs"] = logprobs
    return {
        "id": response_id,
        "object": "text_completion",
        "created": created,
        "model": model,
        "choices": [choice],
    }


def usage_block(prompt_tokens: int, completion_tokens: int) -> Dict[str, Any]:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


def aggregate_chat(chunks: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold a chunk stream into one chat.completion response (reference
    aggregator, protocols/openai/chat_completions/aggregator.rs)."""
    content: List[str] = []
    lp_content: List[Dict[str, Any]] = []
    finish = None
    rid, model, created, usage = "", "", int(time.time()), None
    for ch in chunks:
        rid = ch.get("id") or rid
        model = ch.get("model") or model
        created = ch.get("created") or created
        usage = ch.get("usage") or usage
        for choice in ch.get("choices") or []:
            delta = choice.get("delta") or {}
            if delta.get("content"):
                content.append(delta["content"])
            lp = choice.get("logprobs")
            if lp and lp.get("content"):
                lp_content.extend(lp["content"])
            if choice.get("finish_reason"):
                finish = choice["finish_reason"]
    out = {
        "id": rid,
        "object": "chat.completion",
        "created": created,
        "model": model,
        "choices": [
            {
                "index": 0,
                "message": {"role": "assistant", "content": "".join(content)},
                "finish_reason": finish or "stop",
            }
        ],
    }
    if lp_content:
        out["choices"][0]["logprobs"] = {"content": lp_content}
    if usage:
        out["usage"] = usage
    return out


def aggregate_completion(chunks: List[Dict[str, Any]]) -> Dict[str, Any]:
    text: List[str] = []
    finish = None
    rid, model, created, usage = "", "", int(time.time()), None
    lp: Optional[Dict[str, List[Any]]] = None
    for ch in chunks:
        rid = ch.get("id") or rid
        model = ch.get("model") or model
        created = ch.get("created") or created
        usage = ch.get("usage") or usage
        for choice in ch.get("choices") or []:
            if choice.get("text"):
                text.append(choice["text"])
            clp = choice.get("logprobs")
            if clp:
                if lp is None:
                    lp = {
                        "tokens": [], "token_logprobs": [],
                        "top_logprobs": [], "text_offset": [],
                    }
                lp["tokens"].extend(clp.get("tokens") or [])
                lp["token_logprobs"].extend(clp.get("token_logprobs") or [])
                tops = clp.get("top_logprobs")
                lp["top_logprobs"].extend(
                    tops if tops is not None
                    else [None] * len(clp.get("tokens") or [])
                )
                lp["text_offset"].extend(clp.get("text_offset") or [])
            if choice.get("finish_reason"):
                finish = choice["finish_reason"]
    out = {
        "id": rid,
        "object": "text_completion",
        "created": created,
        "model": model,
        "choices": [
            {"index": 0, "text": "".join(text), "finish_reason": finish or "stop"}
        ],
    }
    if lp is not None:
        out["choices"][0]["logprobs"] = lp
    if usage:
        out["usage"] = usage
    return out


# -- SSE codec ---------------------------------------------------------------

SSE_DONE = b"data: [DONE]\n\n"


def sse_encode(obj: Dict[str, Any]) -> bytes:
    return b"data: " + json.dumps(obj, separators=(",", ":")).encode() + b"\n\n"


def sse_error(message: str) -> bytes:
    return sse_encode({"error": {"message": message, "type": "server_error"}})
