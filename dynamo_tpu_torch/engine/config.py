"""Model and engine configuration for the PyTorch engine.

``ModelConfig`` is a field-for-field copy of the JAX package's config, so a
configuration (and the parameter pytree built from it) carries across the
two packages unchanged.  ``EngineConfig`` keeps only the fields the PyTorch
engine reads; every default equals the JAX engine's.  The engine always
caches prefixes, hashes one token block per KV page, and computes in
``ModelConfig.dtype``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional


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
    # MoE (Mixtral-style); num_experts == 0 means dense MLP
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # per-expert buffer headroom over perfect balance (GShard capacity
    # factor); assignments past capacity are dropped
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

    def validate_tp(self, tp: int) -> None:
        """The JAX package's check, with its messages: a tensor-parallel
        degree must divide the query heads (the column-parallel q/k/v
        split) and the kv heads (a pool that replicated across the tp
        group would pay a gather on every decode step; the engine carries
        no head replication)."""
        if tp <= 1:
            return
        if self.num_heads % tp:
            raise ValueError(
                f"tp={tp} does not divide num_heads={self.num_heads}"
            )
        if self.num_kv_heads % tp:
            raise ValueError(
                f"tp={tp} does not divide num_kv_heads={self.num_kv_heads}: "
                "the paged KV pool would replicate across the tp group and "
                "every decode step would pay a cross-chip gather"
            )

    def validate_ep(self, ep: int) -> None:
        """The port's own check: an MoE model's expert-parallel degree
        must divide its experts, so each ep rank holds ``E/ep`` of them
        (the JAX package replicates experts an ``ep`` does not divide; the
        port carries no expert replication).  A dense model has no experts
        to split: its ep ranks repeat the tp row's work."""
        if ep > 1 and self.is_moe and self.num_experts % ep:
            raise ValueError(
                f"ep={ep} does not divide num_experts={self.num_experts}: each "
                "expert-parallel rank holds an equal share of the experts"
            )

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

    @classmethod
    def llama3_70b(cls, **overrides: Any) -> "ModelConfig":
        """Llama-3-70B: 80 layers, 64 query heads over 8 KV heads (GQA
        group 8), head dim 128."""
        base = dict(
            vocab_size=128256,
            hidden_size=8192,
            intermediate_size=28672,
            num_layers=80,
            num_heads=64,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=500000.0,
            max_position=8192,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def mixtral_8x7b(cls, **overrides: Any) -> "ModelConfig":
        base = dict(
            vocab_size=32000,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=1000000.0,
            max_position=32768,
            num_experts=8,
            num_experts_per_tok=2,
        )
        base.update(overrides)
        return cls(**base)

    SUPPORTED_MODEL_TYPES = (
        "llama", "mistral", "qwen2", "mixtral", "gemma", "phi3", "qwen3",
    )

    @classmethod
    def from_hf_config(cls, cfg: Dict[str, Any]) -> "ModelConfig":
        """Build from a HuggingFace ``config.json`` dict (llama/mistral/qwen2/
        mixtral/gemma/phi3/qwen3 architectures).

        Unknown model types raise instead of loading silently: e.g. gemma2
        carries extra pre/post_feedforward_layernorm tensors the assembler
        would skip, producing garbage output with no error."""
        mt = cfg.get("model_type")
        if mt is not None and mt not in cls.SUPPORTED_MODEL_TYPES:
            raise ValueError(
                f"unsupported model_type {mt!r}; supported: "
                f"{', '.join(cls.SUPPORTED_MODEL_TYPES)}"
            )
        # RoPE scaling: llama3 frequency-dependent scaling is implemented;
        # anything else (yarn, longrope, linear, dynamic) must fail loudly
        # for EVERY model type -- loading a scaled checkpoint with plain
        # RoPE produces garbage at long context with no error
        rope_scaling: Optional[tuple] = None
        rs = cfg.get("rope_scaling") or None
        if rs is not None:
            rs_type = rs.get("rope_type") or rs.get("type")
            if rs_type == "llama3":
                rope_scaling = (
                    "llama3",
                    float(rs["factor"]),
                    float(rs["low_freq_factor"]),
                    float(rs["high_freq_factor"]),
                    int(rs["original_max_position_embeddings"]),
                )
            elif rs_type not in (None, "default"):
                raise ValueError(
                    f"rope_scaling type {rs_type!r} is not supported"
                    " (implemented: llama3)"
                )
        # sliding-window attention: mistral/phi3 enable by presence; the
        # qwen families gate it behind use_sliding_window, whose HF default
        # is False -- a missing key must DISABLE for them or this engine
        # would window checkpoints HF attends fully
        window = cfg.get("sliding_window") or None
        if mt in ("qwen2", "qwen3") and not cfg.get("use_sliding_window", False):
            window = None
        elif window is not None and cfg.get("use_sliding_window") is False:
            window = None
        if window is not None:
            # HF qwen2 windows only layers >= max_window_layers; this engine
            # windows uniformly.  mwl >= num_layers means NO layer windows
            # (disable); 0 < mwl < num_layers is a genuine per-layer mix --
            # fail loudly, not silently-different logits
            mwl = cfg.get("max_window_layers")
            if mwl is not None:
                if mwl >= cfg["num_hidden_layers"]:
                    window = None
                elif mwl > 0:
                    raise ValueError(
                        f"per-layer sliding window (max_window_layers={mwl} <"
                        f" num_hidden_layers={cfg['num_hidden_layers']}) is"
                        " not supported"
                    )
        hidden = cfg["hidden_size"]
        heads = cfg["num_attention_heads"]
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=hidden,
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=heads,
            num_kv_heads=cfg.get("num_key_value_heads", heads),
            head_dim=cfg.get("head_dim", hidden // heads),
            rope_theta=float(cfg.get("rope_theta", 10000.0)),
            rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-5)),
            max_position=cfg.get("max_position_embeddings", 4096),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            attention_bias=bool(
                cfg.get("attention_bias", False)
                or cfg.get("model_type") == "qwen2"
            ),
            num_experts=cfg.get("num_local_experts", 0),
            num_experts_per_tok=cfg.get("num_experts_per_tok", 2),
            rms_norm_offset=cfg.get("model_type") == "gemma",
            hidden_act=(
                "gelu_tanh"
                if cfg.get("hidden_act", cfg.get("hidden_activation"))
                in ("gelu_pytorch_tanh", "gelu_tanh")
                or cfg.get("model_type") == "gemma"
                else "silu"
            ),
            scale_embeddings=cfg.get("model_type") == "gemma",
            qk_norm=cfg.get("model_type") == "qwen3",
            rope_scaling=rope_scaling,
            sliding_window=window,
        )

    @classmethod
    def from_pretrained(cls, model_path: str) -> "ModelConfig":
        """The config of a checkpoint directory's ``config.json``, else of
        a GGUF checkpoint's metadata (``model_path`` a ``.gguf`` file or a
        directory holding one)."""
        cfg_json = os.path.join(model_path, "config.json")
        if os.path.exists(cfg_json):
            with open(cfg_json) as f:
                return cls.from_hf_config(json.load(f))
        from ..llm.gguf import find_gguf_file, gguf_model_config

        gguf = find_gguf_file(model_path)
        if gguf is not None:
            return gguf_model_config(gguf)
        raise FileNotFoundError(f"{model_path}: no config.json and no .gguf file")


@dataclass
class EngineConfig:
    """The engine's knobs: the JAX package's ``EngineConfig`` fields, names
    and defaults, so a JAX config constructs here
    (``EngineConfig(**dataclasses.asdict(jax_cfg))``).  Values the port
    does not serve (``dp`` above 1, a ``dtype`` other than the model's)
    are refused at engine construction, by name.

    ``seed`` is the start of the per-request nonce stream that keys the
    sampling noise of unseeded lanes: the n-th request an engine admits
    draws its noise from nonce ``seed + n`` (mod 2^32), so two engines with
    the same seed serving the same requests in the same order give the same
    unseeded streams, and another seed gives others.  A request's own
    ``seed`` keys its lane instead, whatever the engine's."""

    max_batch_size: int = 8
    max_seq_len: int = 2048
    page_size: int = 16
    num_pages: int = 512
    # router-visible KV block size: the KV events and the router hash
    # prompts in blocks of this many tokens, each ``block_size //
    # page_size`` pages.  None = the page size.  A block that is not a
    # whole number of pages turns prefix caching off, with a warning
    block_size: Optional[int] = None
    # sequence-hash prefix-cache reuse (block_manager.PagePool); False runs
    # a plain page allocator (kv_cache.PageAllocator) and publishes KV
    # events per request instead of from the registry
    enable_prefix_caching: bool = True
    # KV-budget admission (scheduler.KVAdmitConfig): admit against
    # predicted KV pages -- prompt plus max_tokens headroom -- with a
    # skip-ahead and an aging fairness floor, instead of slot count.  A
    # spec by scheduler.parse_kv_admit_spec ("on", or
    # "util=0.9,headroom=256,reserve=16,floor_s=2,skips=4"); None = slot
    # count.  DYN_KV_ADMIT_BUDGET wins; a malformed env value warns and
    # keeps this, a malformed value here fails engine construction
    kv_admit_budget: Optional[str] = None
    # extra pages a lane takes per growth event, so its page table changes
    # every few blocks instead of every block
    grow_chunk_pages: int = 4
    # width of the device-checked stop-token set per lane (a lane's first
    # ``device_stop_width`` stop ids stop it on the device; the host replay
    # applies them all)
    device_stop_width: int = 8
    # the nonce stream of unseeded lanes starts here (see the class
    # docstring)
    seed: int = 0
    # the dense KV pool's dtype: None or the model's dtype; another dtype is
    # refused (``kv_dtype`` names the pool when set)
    dtype: Optional[str] = None
    # tensor parallelism: the engine starts tp ranks of its own (one
    # process each; DYN_TP wins).  Data parallelism inside one engine: 1
    # only (refused by name)
    tp: int = 1
    dp: int = 1
    # total fresh tokens per unified dispatch: decode lanes cost one each,
    # the remainder packs prefill chunks
    mixed_token_budget: int = 512
    # multistep decode: pressure-free packed ticks fuse several decode steps
    # into one dispatch; False pins single-step dispatches (DYN_MULTISTEP
    # overrides)
    multistep_decode: bool = True
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
    # host tick pipelining: the tick loop keeps up to two dispatch
    # generations uncommitted -- the next tick plans and enqueues while the
    # previous one runs on the device, and a generation commits once its
    # results have landed (or the pipeline is full).  Token streams equal
    # the serial loop's; False is that serial loop (one generation deep)
    async_dispatch: bool = True
    # folded speculative verify: speculating lanes' verify columns ride the
    # packed unified dispatch as more flat-axis segments, so a speculating
    # mixed tick is one dispatch; False (and classic ticks, and the
    # rectangle layout) runs the standalone verify dispatch after the
    # commit.  Token-identical either way.  Consulted only with mixed
    # batching and the packed layout on
    fold_spec_verify: bool = True
    # acceptance-aware auto-disable: a speculating lane whose acceptance
    # rate sits below ``spec_min_accept`` once it has drafted
    # ``spec_disable_after`` tokens stops drafting and decodes plainly (no
    # output change)
    spec_auto_disable: bool = True
    spec_min_accept: float = 0.35
    spec_disable_after: int = 64
    # model drafter: a checkpoint directory or ``random[:seed]``
    # (spec/model_drafter.py), loaded at construction and served to
    # requests that ask for drafter kind "model".  None = host drafters only
    draft_model: Optional[str] = None
    # queue-side prefetch window: the offloaded prefix chains of the first
    # N queued requests promote toward host RAM (with ring pins) while they
    # wait, so onboarding overlaps queue wait instead of TTFT.  0 disables;
    # DYN_KV_PREFETCH overrides
    kv_prefetch_window: int = 32
    # KV offload tiers: evicted G1 blocks demote to host RAM (G2, this many
    # blocks, in pinned memory on the card) and overflow to disk (G3, under
    # ``disk_offload_dir``); admission onboards offloaded prefixes back
    # into fresh pages.  0 disables.  DYN_KV_OFFLOAD (offload.
    # env_offload_spec grammar) arms/overrides the whole plane; with both
    # unset no offload thread ever starts
    host_offload_blocks: int = 0
    disk_offload_blocks: int = 0
    disk_offload_dir: Optional[str] = None
    # G4 remote tier (the fleet-shared KV store): a spec by offload.
    # parse_kv_remote_spec's grammar -- "on", or
    # "mirror=1,fetch=1,prefill_tok_s=4000,gbps=1.0,namespace=prod".  The
    # parsed spec is held on the engine (``kv_remote_spec``); the store
    # attaches at serve wiring through ``attach_remote_kv`` (config alone
    # cannot name a live hub connection).  Needs the offload plane armed.
    # DYN_KV_REMOTE wins; a malformed value warns and keeps config
    kv_remote: Optional[str] = None
    # swap-based preemption: a capacity-preempted lane's KV is offloaded
    # and restored through the chunked scatter path instead of re-prefilled.
    # Effective only with the offload plane armed; recompute remains the
    # fallback when the swap budget runs out
    swap_preemption: bool = True
    # weight-only quantization: "int8" stores the matmul weights as int8
    # with per-output-channel scales, dequantized at the point of use
    # (engine/quant.py).  None = the weights as given
    quantize: Optional[str] = None
    # disaggregation: a lane parked for a remote prefill's KV fails after
    # this long (lost queue item / crashed prefill worker backstop)
    external_kv_timeout_s: float = 60.0
