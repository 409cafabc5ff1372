"""Model and engine configuration for the PyTorch engine.

``ModelConfig`` is a field-for-field copy of the JAX package's config, so a
configuration (and the parameter pytree built from it) carries across the
two packages unchanged.  ``EngineConfig`` keeps only the fields the PyTorch
engine reads; every default equals the JAX engine's.  The engine always
caches prefixes, hashes one token block per KV page, and computes in
``ModelConfig.dtype``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_position: int = 4096
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # Qwen2-style qkv bias
    # MoE (Mixtral-style); num_experts == 0 means dense MLP.  The PyTorch
    # engine serves dense models only (model.py raises on MoE).
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 2.0
    # Gemma-family switches: RMSNorm multiplies by (1 + w), the MLP uses
    # tanh-approximated GELU, and embeddings scale by sqrt(hidden)
    rms_norm_offset: bool = False
    hidden_act: str = "silu"  # "silu" | "gelu_tanh"
    scale_embeddings: bool = False
    # Qwen3-family: per-head RMSNorm on q and k before RoPE
    qk_norm: bool = False
    # Llama-3.1 style frequency-dependent RoPE scaling, a hashable tuple
    # ("llama3", factor, low_freq_factor, high_freq_factor,
    # original_max_position)
    rope_scaling: Optional[tuple] = None
    # sliding-window attention (Mistral/Phi3); None/0 = full attention
    sliding_window: Optional[int] = None
    # activation dtype for compute; params may be stored differently
    dtype: str = "bfloat16"

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @classmethod
    def tiny(cls, **overrides: Any) -> "ModelConfig":
        """A CI-sized config: runs in milliseconds on CPU, same code paths."""
        base = dict(
            vocab_size=256,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            max_position=512,
            dtype="float32",
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def llama3_8b(cls, **overrides: Any) -> "ModelConfig":
        base = dict(
            vocab_size=128256,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=500000.0,
            max_position=8192,
        )
        base.update(overrides)
        return cls(**base)


@dataclass
class EngineConfig:
    max_batch_size: int = 8
    max_seq_len: int = 2048
    page_size: int = 16
    num_pages: int = 512
    # total fresh tokens per unified dispatch: decode lanes cost one each,
    # the remainder packs prefill chunks
    mixed_token_budget: int = 512
    # ceiling of the adaptive multi-step controller: pressure-free decode
    # ticks fuse up to this many decode steps into one dispatch (1 pins
    # single-step dispatches)
    multistep_max_k: int = 8
    # decode steps of one classic decode block (ticks with a penalized lane
    # slotted, the rectangle layout's pure-decode ticks, --no-mixed-batching)
    decode_block_size: int = 16
    # classic path: prompts whose uncached part is longer prefill in
    # page-aligned chunks of this many tokens, one chunk per tick (rounded
    # up to a page); mixed ticks cap one lane's chunk at it.  None = whole
    prefill_chunk_tokens: Optional[int] = None
    # pack prefill chunks and decode rows into one unified dispatch per
    # tick; False runs the classic separate prefill and decode dispatches
    mixed_batching: bool = True
    # the unified dispatch's layout: one flat packed token axis, or the
    # [B, S] rectangle (False); multistep decode needs the packed layout
    packed_ragged: bool = True
    # KV pool dtype: None or the model's dtype is the dense pool, "int8"
    # the quantized one (per-row f32 scales; about half the pool's bytes
    # under a bf16 model); another dtype is refused at engine construction
    kv_dtype: Optional[str] = None
