"""Wire/pipeline protocol types the engine speaks."""

from .common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)

__all__ = [
    "FinishReason",
    "LLMEngineOutput",
    "PreprocessedRequest",
    "SamplingOptions",
    "StopConditions",
]
