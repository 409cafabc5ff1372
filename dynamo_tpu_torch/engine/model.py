"""Llama-family transformer as plain functions over a stacked-params dict.

The parameters keep the JAX package's layout (``engine/model.py`` there):
weights are stored ``[in, out]`` so the forward is ``x @ W``, and every
per-layer weight carries a leading ``[num_layers, ...]`` axis.  The layer
loop is a Python loop over views of those stacks.

The KV pool ``[L, 2, num_pages, page, Hkv, D]`` (a tensor, or the int8
pool's ``QuantKV`` pair) is updated IN PLACE by the attention callback
(the writers in ``attention.py`` scatter into it at the layer index).  This replaces the JAX package's buffer donation: there the
pool rides the ``lax.scan`` carry and XLA aliases it; here the one tensor
is simply mutated, so no step ever copies the cache.

Each matmul weight is taken through ``quant.mat`` where it is used, as the
JAX trunk does: a weight-only int8 leaf (``quant.QuantizedTensor``) is
dequantized there, a plain tensor passes as it is.

Activations run on a flat token axis (``[T, H]``): every dispatch of the
port's main path (packed unified step, decode step) is token-flat, so the
JAX package's ``[B, T, H]`` batch axis has nothing to carry here.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .kv_cache import KVPool, torch_dtype
from .quant import mat

Params = Dict[str, Any]

# (q [T, Hq, D], k [T, Hkv, D], v [T, Hkv, D], kv_pages, layer) -> [T, Hq, D];
# the callback writes the fresh K/V into kv_pages in place
AttnFn = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor, KVPool, int], torch.Tensor
]


def layer_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Per-layer parameter shapes (without the leading layer axis)."""
    H, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    shapes = {
        "wq": (H, Hq * D),
        "wk": (H, Hkv * D),
        "wv": (H, Hkv * D),
        "wo": (Hq * D, H),
        "input_norm": (H,),
        "post_norm": (H,),
        "w_gate": (H, I),
        "w_up": (H, I),
        "w_down": (I, H),
    }
    if cfg.attention_bias:
        shapes.update(bq=(Hq * D,), bk=(Hkv * D,), bv=(Hkv * D,))
    if cfg.qk_norm:
        shapes.update(q_norm=(D,), k_norm=(D,))
    return shapes


def check_supported(cfg: ModelConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(
            "the PyTorch engine serves dense models only (MoE is not ported)"
        )


def init_params(
    cfg: ModelConfig,
    seed: int,
    device: torch.device,
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """Random parameters made on ``device`` from ``seed`` (normal, scaled
    by 1/sqrt(fan_in) like the JAX package's ``init_params``; norms are
    ones).  Filled one layer at a time in the target dtype, so a full-width
    model never holds an f32 copy of itself."""
    check_supported(cfg)
    dtype = dtype or torch_dtype(cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L = cfg.num_layers

    def normal(shape, std):
        t = torch.empty(shape, dtype=dtype, device=device)
        # a stacked [L, ...] weight fills layer by layer
        for part in t if len(shape) == 3 else [t]:
            part.normal_(0.0, std, generator=gen)
        return t

    layers: Params = {}
    for name, shape in layer_shapes(cfg).items():
        if len(shape) == 1:
            fill = 0.0 if name.startswith("b") else 1.0
            layers[name] = torch.full((L,) + shape, fill, dtype=dtype, device=device)
        else:
            layers[name] = normal((L,) + shape, 1.0 / math.sqrt(shape[0]))
    params: Params = {
        "embed": normal((cfg.vocab_size, cfg.hidden_size), 0.02),
        "layers": layers,
        "final_norm": torch.ones(cfg.hidden_size, dtype=dtype, device=device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal(
            (cfg.hidden_size, cfg.vocab_size), 1.0 / math.sqrt(cfg.hidden_size)
        )
    return params


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float, offset: bool = False
) -> torch.Tensor:
    """RMSNorm in f32; ``offset=True`` multiplies by (1 + w) (Gemma)."""
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    w = weight.float()
    if offset:
        w = 1.0 + w
    return (xf * w).to(dt)


def _activate(x: torch.Tensor, hidden_act: str) -> torch.Tensor:
    if hidden_act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def rope_cos_sin(
    positions: torch.Tensor,
    head_dim: int,
    theta: float,
    scaling: Optional[tuple] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF convention: inv_freq over even dims, angles ``pos * inv_freq``,
    cos/sin tiled as [freqs, freqs]; ``scaling`` applies Llama-3.1's
    frequency-dependent stretch."""
    dev = positions.device
    inv_freq = 1.0 / (
        theta
        ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim)
    )
    if scaling is not None:
        kind, factor, low_f, high_f, orig_max = scaling
        if kind != "llama3":
            raise ValueError(f"unknown rope scaling {kind!r}")
        wavelen = 2.0 * math.pi / inv_freq
        low_wavelen = orig_max / low_f
        high_wavelen = orig_max / high_f
        smooth = (orig_max / wavelen - low_f) / (high_f - low_f)
        smoothed = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = torch.where(
            wavelen > low_wavelen,
            inv_freq / factor,
            torch.where(wavelen < high_wavelen, inv_freq, smoothed),
        )
    angles = positions[..., None].float() * inv_freq  # [..., D/2]
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [T, heads, D]; cos/sin: [T, D] (broadcast over heads)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


def _dense_mlp(lp: Params, x: torch.Tensor, hidden_act: str) -> torch.Tensor:
    gate = _activate(x @ mat(lp["w_gate"]), hidden_act)
    return (gate * (x @ mat(lp["w_up"]))) @ mat(lp["w_down"])


# ---------------------------------------------------------------------------
# transformer trunk
# ---------------------------------------------------------------------------


def transformer_layer(
    lp: Params,
    x: torch.Tensor,  # [T, H]
    cos: torch.Tensor,  # [T, D]
    sin: torch.Tensor,
    cfg: ModelConfig,
    attn_fn: AttnFn,
    kv_pages: KVPool,  # [L, 2, num_pages, page, Hkv, D], updated in place
    layer: int,
) -> torch.Tensor:
    """One decoder layer (norm -> attention -> norm -> MLP, residuals)."""
    T = x.shape[0]
    D = cfg.head_dim
    h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps, cfg.rms_norm_offset)
    q = h @ mat(lp["wq"])
    k = h @ mat(lp["wk"])
    v = h @ mat(lp["wv"])
    if "bq" in lp:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = q.view(T, cfg.num_heads, D)
    k = k.view(T, cfg.num_kv_heads, D)
    v = v.view(T, cfg.num_kv_heads, D)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attn_fn(q, k, v, kv_pages, layer)
    x = x + attn.reshape(T, cfg.num_heads * D) @ mat(lp["wo"])
    h2 = rms_norm(x, lp["post_norm"], cfg.rms_norm_eps, cfg.rms_norm_offset)
    return x + _dense_mlp(lp, h2, cfg.hidden_act)


def transformer(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [T] int64
    positions: torch.Tensor,  # [T]
    kv_pages: KVPool,
    attn_fn: AttnFn,
    mm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Run the trunk over a flat token axis; returns hidden [T, H] after
    the final norm.  ``kv_pages`` is written in place.

    ``mm = (mm_embeds [B, M, H], mm_len [B])`` injects a llava-style soft
    prompt into a flat axis of B lanes of equal width (row ``b * W + t``
    is lane b's position t, the prefill layout): lane b's first
    ``min(mm_len[b], M, W)`` positions take rows of ``mm_embeds``, cast to
    the model's dtype, instead of the token-embedding lookup.  The rows
    land after Gemma's embedding scale, so they are not scaled."""
    x = params["embed"][tokens]
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype, device=x.device)
    if mm is not None:
        mm_embeds, mm_len = mm
        B, M = mm_embeds.shape[:2]
        W = x.shape[0] // B
        k = min(M, W)
        # x is this call's own gather: the leading rows of each lane are
        # overwritten in place, with no host sync on the mask
        head = x.view(B, W, -1)[:, :k]
        take = torch.arange(k, device=x.device)[None, :] < mm_len.clamp(max=k)[:, None]
        head.copy_(torch.where(take[:, :, None], mm_embeds[:, :k].to(x.dtype), head))
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    layers = params["layers"]
    for i in range(cfg.num_layers):
        lp = {name: w[i] for name, w in layers.items()}
        x = transformer_layer(lp, x, cos, sin, cfg, attn_fn, kv_pages, i)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps, cfg.rms_norm_offset)


def lm_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_word_embeddings else mat(params["lm_head"])
    return (hidden @ w).float()
