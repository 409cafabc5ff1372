"""The PyTorch engine: scheduler, paged KV cache, Llama trunk, sampling and
the packed unified step, driving the hand-written attention kernels."""

from .config import EngineConfig, ModelConfig
from .engine import TorchEngine

__all__ = ["EngineConfig", "ModelConfig", "TorchEngine"]
