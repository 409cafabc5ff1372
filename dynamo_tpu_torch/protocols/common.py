"""Common token-level protocols between preprocessor, router, and engine.

Reference parity: ``PreprocessedRequest`` / ``LLMEngineOutput`` /
``StopConditions`` / ``SamplingOptions`` in the reference LLM crate
(lib/llm/src/protocols/common/llm_backend.rs:27-90, protocols/common.rs).
These are plain dataclasses with dict (de)serialization so they travel over
the request plane as msgpack/JSON without a schema compiler.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional


class FinishReason(str, Enum):
    EOS = "eos"
    STOP = "stop"
    LENGTH = "length"
    CANCELLED = "cancelled"
    ERROR = "error"

    def to_openai(self) -> str:
        # OpenAI surface only knows stop/length/content_filter.
        if self in (FinishReason.EOS, FinishReason.STOP, FinishReason.CANCELLED):
            return "stop"
        if self is FinishReason.LENGTH:
            return "length"
        return "stop"


@dataclass
class StopConditions:
    """Reference: common.rs StopConditions."""

    max_tokens: Optional[int] = None
    stop: Optional[List[str]] = None
    stop_token_ids_hidden: Optional[List[int]] = None
    min_tokens: Optional[int] = None
    ignore_eos: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "StopConditions":
        return cls(**(d or {}))


@dataclass
class SamplingOptions:
    """Reference: common.rs SamplingOptions (subset that maps onto the engine)."""

    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    seed: Optional[int] = None
    # OpenAI logprobs: None = off; 0 = chosen-token logprob only; N > 0 =
    # chosen + top-N alternatives per position (reference protocol parity:
    # openai/completions/aggregator.rs:43,159)
    logprobs: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "SamplingOptions":
        return cls(**(d or {}))


@dataclass
class SpeculationOptions:
    """Per-request speculative-decoding knobs (spec/ subsystem).

    ``enabled`` arms draft-and-verify for the request; ``num_draft_tokens``
    is the per-verify draft length (engine-clamped to
    ``spec.MAX_DRAFT_TOKENS``); ``drafter`` names a registered drafter
    kind (``ngram``/``prompt_lookup`` today -- see spec/drafter.py).
    Output is always the target model's: greedy and seeded lanes are
    bit-identical with speculation on or off.
    """

    enabled: bool = False
    num_draft_tokens: int = 4
    drafter: str = "ngram"

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(
        cls, d: Optional[Dict[str, Any]]
    ) -> "Optional[SpeculationOptions]":
        if d is None:
            return None
        return cls(**{k: d[k] for k in cls().__dict__ if k in d})


@dataclass
class PreprocessedRequest:
    """Token-level request handed to the engine.

    Reference: llm_backend.rs:27-56 (token_ids, stop/sampling conditions,
    annotations, ``estimated_prefix_hit_num_blocks`` injected by the KV
    router).
    """

    token_ids: List[int]
    stop_conditions: StopConditions = field(default_factory=StopConditions)
    sampling_options: SamplingOptions = field(default_factory=SamplingOptions)
    eos_token_ids: List[int] = field(default_factory=list)
    annotations: List[str] = field(default_factory=list)
    mdc_sum: Optional[str] = None
    estimated_prefix_hit_num_blocks: Optional[int] = None
    # Multimodal soft prompt (llava-style): embedding rows occupying the
    # FIRST len(mm_embeds) prompt positions; the corresponding token_ids are
    # placeholders the embed lookup ignores.  [T_img][hidden] floats.
    mm_embeds: Optional[List[List[float]]] = None
    # speculative decoding knobs (None = off)
    speculation: Optional[SpeculationOptions] = None
    # prompt logprobs (completions echo+logprobs): None = off, 0 = chosen
    # only, N > 0 = with top-N alternatives per prompt position
    prompt_logprobs: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "token_ids": list(self.token_ids),
            "stop_conditions": self.stop_conditions.to_dict(),
            "sampling_options": self.sampling_options.to_dict(),
            "eos_token_ids": list(self.eos_token_ids),
            "annotations": list(self.annotations),
            "mdc_sum": self.mdc_sum,
            "estimated_prefix_hit_num_blocks": self.estimated_prefix_hit_num_blocks,
            "mm_embeds": self.mm_embeds,
            "speculation": (
                self.speculation.to_dict() if self.speculation else None
            ),
            "prompt_logprobs": self.prompt_logprobs,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PreprocessedRequest":
        return cls(
            token_ids=list(d.get("token_ids") or []),
            stop_conditions=StopConditions.from_dict(d.get("stop_conditions")),
            sampling_options=SamplingOptions.from_dict(d.get("sampling_options")),
            eos_token_ids=list(d.get("eos_token_ids") or []),
            annotations=list(d.get("annotations") or []),
            mdc_sum=d.get("mdc_sum"),
            estimated_prefix_hit_num_blocks=d.get("estimated_prefix_hit_num_blocks"),
            mm_embeds=d.get("mm_embeds"),
            speculation=SpeculationOptions.from_dict(d.get("speculation")),
            prompt_logprobs=d.get("prompt_logprobs"),
        )


@dataclass
class ForwardPassMetrics:
    """Worker load metrics published to the KV router
    (reference kv_router/protocols.rs:43-62; 'gpu_*' names kept for parity)."""

    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    num_requests_waiting: int = 0
    gpu_cache_usage_perc: float = 0.0
    gpu_prefix_cache_hit_rate: float = 0.0
    request_active_slots: int = 0
    request_total_slots: int = 0
    # multi-tier KV offload plane (KVBM G2/G3): blocks parked per tier and
    # the fraction of tier lookups that hit -- the router's warmth signal
    # for preferring workers whose host tier holds reusable prefixes
    host_tier_blocks: int = 0
    disk_tier_blocks: int = 0
    tier_hit_rate: float = 0.0
    # live SLO attainment (runtime/slo.py, dynamo_slo_attainment{kind}):
    # rolling-window fraction of requests meeting the DYN_SLO targets.
    # 1.0 = met / not armed / no samples yet, so load-only consumers see
    # no spurious pressure when the SLO plane is off
    slo_ttft_attainment: float = 1.0
    slo_itl_attainment: float = 1.0
    slo_e2e_attainment: float = 1.0
    # cumulative TTFT-violation counts by attributed cause (runtime/slo.py
    # queue-vs-service first-token decomposition).  Cumulative, not rates:
    # the planner diffs consecutive rounds, so a lost scrape costs one
    # round of resolution, never drift -- same contract as telemetry
    # counters.  0 = SLO plane disarmed / no misses, which reads as "no
    # evidence" to cause-gated scaling rules
    slo_ttft_queue_violations: float = 0.0
    slo_ttft_service_violations: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return self.__dict__.copy()

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ForwardPassMetrics":
        d = d or {}
        return cls(**{k: d[k] for k in cls().__dict__ if k in d})


@dataclass
class LLMEngineOutput:
    """Per-step engine output (reference llm_backend.rs:58-90).

    ``token_ids`` usually holds one decoded token; the final chunk carries a
    ``finish_reason`` and empty tokens.  ``text`` stays None at the engine
    level -- detokenization happens in the Backend stage.
    """

    token_ids: List[int] = field(default_factory=list)
    tokens: Optional[List[str]] = None
    text: Optional[str] = None
    cum_log_probs: Optional[float] = None
    # per-token logprobs aligned with token_ids, and per-token top-N
    # alternatives as [[token_id, logprob], ...] lists (JSON-able)
    logprobs: Optional[List[float]] = None
    top_logprobs: Optional[List[List[List[float]]]] = None
    finish_reason: Optional[FinishReason] = None
    # completed KV blocks for this step (router/event feedback)
    completed_blocks: Optional[List[Dict[str, int]]] = None
    # prompt logprobs (first output item of an echo+logprobs completion):
    # one [token_id, logprob|None, top|None] entry per prompt position
    # (position 0 has no logprob, matching OpenAI prompt-logprobs shape)
    prompt_logprobs: Optional[List[Any]] = None
    # per-request speculation stats, attached to the finish item:
    # {drafted_tokens, accepted_tokens, acceptance_rate, drafter}
    spec: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"token_ids": list(self.token_ids)}
        if self.tokens is not None:
            out["tokens"] = self.tokens
        if self.text is not None:
            out["text"] = self.text
        if self.cum_log_probs is not None:
            out["cum_log_probs"] = self.cum_log_probs
        if self.logprobs is not None:
            out["logprobs"] = self.logprobs
        if self.top_logprobs is not None:
            out["top_logprobs"] = self.top_logprobs
        if self.finish_reason is not None:
            out["finish_reason"] = self.finish_reason.value
        if self.completed_blocks is not None:
            out["completed_blocks"] = self.completed_blocks
        if self.prompt_logprobs is not None:
            out["prompt_logprobs"] = self.prompt_logprobs
        if self.spec is not None:
            out["spec"] = self.spec
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LLMEngineOutput":
        fr = d.get("finish_reason")
        return cls(
            token_ids=list(d.get("token_ids") or []),
            tokens=d.get("tokens"),
            text=d.get("text"),
            cum_log_probs=d.get("cum_log_probs"),
            logprobs=d.get("logprobs"),
            top_logprobs=d.get("top_logprobs"),
            finish_reason=FinishReason(fr) if fr else None,
            completed_blocks=d.get("completed_blocks"),
            prompt_logprobs=d.get("prompt_logprobs"),
            spec=d.get("spec"),
        )

    @classmethod
    def finished(cls, reason: FinishReason) -> "LLMEngineOutput":
        return cls(token_ids=[], finish_reason=reason)
