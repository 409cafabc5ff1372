"""Memory planning: does a ModelConfig x quantize x KV budget fit the card?

The JAX package's ``engine/memory_plan.py``, field for field, on one GPU.
Fit is computed from the exact parameter shapes the engine allocates
(``model.layer_shapes``, the same as JAX's ``init_params``) and the
quantization layout (``engine/quant.py``: an int8 body and one scale per
output channel, in the compute dtype).  ``plan_memory`` is the planning
primitive; ``max_kv_pages`` inverts it to answer "how much KV cache does
the card hold after the weights land".

Params and KV are byte-exact; activation scratch is a bound, sized from
the dominant live tensors of a prefill dispatch, as in the JAX package.
One term is the port's own: ``quant.mat`` writes each int8 weight out in
the compute dtype before its product (XLA fuses that convert into the
matmul's read), so an int8 plan adds ``dequant_bytes``, two copies of
the largest per-layer weight (the cast and the scaled product live at
once), to its total.

The card's memory comes from ``torch.cuda.mem_get_info()`` or from an
explicit ``hbm_bytes``; there is no default card.  Only ``tp = ep = 1``
is planned: the port serves one GPU, and sharded plans wait for the
multi-GPU port (the JAX plan's divisors come from ``parallel.sharding``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .config import ModelConfig
from .model import layer_shapes

# headroom for the CUDA context, the caching allocator's fragmentation and
# library workspaces, as a share of the card's memory
DEFAULT_RESERVE_FRACTION = 0.06

_DTYPE_BYTES = {
    "bfloat16": 2, "float16": 2, "float32": 4, "float64": 8, "int8": 1,
}

_QUANT_PATHS = frozenset(
    {"layers/wq", "layers/wk", "layers/wv", "layers/wo",
     "layers/w_gate", "layers/w_up", "layers/w_down", "lm_head"}
)


def _dtype_bytes(dtype: str) -> int:
    if str(dtype) not in _DTYPE_BYTES:
        raise ValueError(f"unknown dtype {dtype!r}")
    return _DTYPE_BYTES[str(dtype)]


def _param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Exact shapes of every parameter, by the JAX plan's paths."""
    L, H = cfg.num_layers, cfg.hidden_size
    shapes: Dict[str, Tuple[int, ...]] = {
        "embed": (cfg.vocab_size, H),
        "final_norm": (H,),
    }
    for name, shape in layer_shapes(cfg).items():
        shapes[f"layers/{name}"] = (L,) + shape
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (H, cfg.vocab_size)
    return shapes


def _refuse_sharding(tp: int, ep: int) -> None:
    if tp != 1 or ep != 1:
        raise NotImplementedError(
            f"memory plans at tp={tp}, ep={ep} need the multi-GPU port, which "
            "is not done (ROADMAP A6); the port plans one GPU (tp = ep = 1)"
        )


def _card_memory_bytes() -> int:
    """The card's whole memory, from ``torch.cuda.mem_get_info``."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass hbm_bytes to plan for one")
    _free, total = torch.cuda.mem_get_info()
    return int(total)


@dataclass
class MemoryPlan:
    """Byte budget of one engine on one card."""

    param_bytes: int
    kv_bytes: int
    scratch_bytes: int
    reserve_bytes: int
    hbm_bytes: int
    num_pages: int
    bytes_per_page: int
    detail: Dict[str, int] = field(default_factory=dict)
    # the port's int8 dequantization transient (0 unquantized)
    dequant_bytes: int = 0

    @property
    def total_bytes(self) -> int:
        return (self.param_bytes + self.kv_bytes + self.scratch_bytes
                + self.reserve_bytes + self.dequant_bytes)

    @property
    def fits(self) -> bool:
        return self.total_bytes <= self.hbm_bytes

    @property
    def headroom_bytes(self) -> int:
        return self.hbm_bytes - self.total_bytes

    def assert_fits(self) -> "MemoryPlan":
        if not self.fits:
            gib = 1024**3
            raise ValueError(
                f"memory plan exceeds the card: params {self.param_bytes/gib:.2f} "
                f"+ kv {self.kv_bytes/gib:.2f} + scratch "
                f"{self.scratch_bytes/gib:.2f} + dequant "
                f"{self.dequant_bytes/gib:.2f} + reserve "
                f"{self.reserve_bytes/gib:.2f} = {self.total_bytes/gib:.2f} "
                f"GiB > {self.hbm_bytes/gib:.2f} GiB "
                f"(quantize, or shrink the page budget)"
            )
        return self


def plan_memory(
    cfg: ModelConfig,
    *,
    tp: int = 1,
    ep: int = 1,
    quantize: Optional[str] = None,
    page_size: int = 16,
    num_pages: int = 512,
    max_batch_size: int = 8,
    prefill_bucket: int = 2048,
    hbm_bytes: Optional[int] = None,
    reserve_fraction: float = DEFAULT_RESERVE_FRACTION,
) -> MemoryPlan:
    """Byte-exact params and KV, a bounded scratch estimate, on one card
    (``hbm_bytes``, or the card's own memory when None)."""
    _refuse_sharding(tp, ep)
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize={quantize!r} (int8 only)")
    if hbm_bytes is None:
        hbm_bytes = _card_memory_bytes()
    wbytes = _dtype_bytes(cfg.dtype)
    detail: Dict[str, int] = {}
    pbytes = 0
    dequant = 0
    for path, shape in _param_shapes(cfg).items():
        n = math.prod(shape)
        if quantize == "int8" and path in _QUANT_PATHS:
            # int8 body + one scale per output channel (the contracted
            # axis -2 reduced to 1)
            b = n + (n // shape[-2]) * wbytes
            # one layer's slice in the compute dtype at its point of use
            per_use = n // shape[0] if path.startswith("layers/") else n
            dequant = max(dequant, 2 * per_use * wbytes)
        else:
            b = n * wbytes
        detail[path] = b
        pbytes += b

    # KV pages [L, 2, pages, page, Hkv, D]
    bytes_per_page = (
        cfg.num_layers * 2 * page_size * cfg.num_kv_heads * cfg.head_dim * wbytes
    )
    kv_bytes = bytes_per_page * num_pages

    # Scratch bound, the JAX plan's: ~6 hidden-width activation copies
    # plus q/k/v at head width over the prefill bucket, plus full-width
    # logits in f32 at the sampled positions
    B, T, H = max_batch_size, prefill_bucket, cfg.hidden_size
    act = 6 * B * T * H * wbytes
    heads = B * T * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim * wbytes
    logits = B * cfg.vocab_size * 4 * 2  # f32 logits + softmax workspace
    scratch = act + heads + logits

    return MemoryPlan(
        param_bytes=pbytes,
        kv_bytes=kv_bytes,
        scratch_bytes=scratch,
        reserve_bytes=int(hbm_bytes * reserve_fraction),
        hbm_bytes=hbm_bytes,
        num_pages=num_pages,
        bytes_per_page=bytes_per_page,
        detail=detail,
        dequant_bytes=dequant,
    )


def max_kv_pages(
    cfg: ModelConfig,
    *,
    tp: int = 1,
    ep: int = 1,
    quantize: Optional[str] = None,
    page_size: int = 16,
    max_batch_size: int = 8,
    prefill_bucket: int = 2048,
    hbm_bytes: Optional[int] = None,
    reserve_fraction: float = DEFAULT_RESERVE_FRACTION,
) -> int:
    """Largest page budget that still fits the card."""
    base = plan_memory(
        cfg, tp=tp, ep=ep, quantize=quantize, page_size=page_size,
        num_pages=0, max_batch_size=max_batch_size,
        prefill_bucket=prefill_bucket, hbm_bytes=hbm_bytes,
        reserve_fraction=reserve_fraction,
    )
    free = base.hbm_bytes - base.total_bytes
    if free <= 0:
        return 0
    return free // base.bytes_per_page


def llama3_70b_config(dtype: str = "bfloat16") -> ModelConfig:
    """Real Llama-3-70B geometry (HF config.json: 80 layers, 64 q heads,
    8 kv heads, ffn 28672, vocab 128256), the JAX plan's north-star model
    shape, in ``dtype``."""
    return ModelConfig.llama3_70b(dtype=dtype)
