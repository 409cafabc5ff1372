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

Tensor and expert parallelism (``parallel/``): a rank's params
(``parallel.sharding.RankParams``) carry the mesh, and the trunk runs the
collectives where the JAX package's shardings put them.  The embedding is
split over the hidden axis, so its lookup is followed by an all-gather;
q/k/v are column-parallel (a rank holds ``Hq/tp`` query and ``Hkv/tp`` kv
heads, read off the weights' shapes), ``wo`` and the dense ``w_down`` are
row-parallel and each followed by an all-reduce; the head is split over
the vocabulary and its logits all-gathered (a tied head, split over the
hidden axis with the embedding, all-reduces its partial logits).  An MoE
layer's experts are split over ``ep`` (and each expert's columns and rows
over ``tp``): every rank routes and slots all rows, so drops are those of
one card, runs only its own experts' capacity slots and sums the layer's
output over the whole grid with one all-reduce.  A plain params dict runs
none of this.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .kv_cache import KVPool, torch_dtype
from .quant import QUANT_KEYS, QuantizedTensor, mat, quantize_tensor

Params = Dict[str, Any]

# (q [T, Hq, D], k [T, Hkv, D], v [T, Hkv, D], kv_pages, layer) -> [T, Hq, D];
# the callback writes the fresh K/V into kv_pages in place
AttnFn = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor, KVPool, int], torch.Tensor
]


def layer_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Per-layer parameter shapes (without the leading layer axis).  An
    MoE layer holds a router ``[H, E]`` and expert stacks ``[E, H, I]``,
    ``[E, I, H]`` in place of the dense MLP."""
    H, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    shapes = {
        "wq": (H, Hq * D),
        "wk": (H, Hkv * D),
        "wv": (H, Hkv * D),
        "wo": (Hq * D, H),
        "input_norm": (H,),
        "post_norm": (H,),
    }
    if cfg.is_moe:
        E = cfg.num_experts
        shapes.update(router=(H, E), w_gate=(E, H, I), w_up=(E, H, I), w_down=(E, I, H))
    else:
        shapes.update(w_gate=(H, I), w_up=(H, I), w_down=(I, H))
    if cfg.attention_bias:
        shapes.update(bq=(Hq * D,), bk=(Hkv * D,), bv=(Hkv * D,))
    if cfg.qk_norm:
        shapes.update(q_norm=(D,), k_norm=(D,))
    return shapes


def init_params(
    cfg: ModelConfig,
    seed: int,
    device: torch.device,
    dtype: Optional[torch.dtype] = None,
    quantize: Optional[str] = None,
    shard: Optional[Any] = None,
) -> Params:
    """Random parameters made on ``device`` from ``seed`` (normal, scaled
    by 1/sqrt(fan_in) like the JAX package's ``init_params``; norms are
    ones).  Filled one layer at a time in the target dtype, so a full-width
    model never holds an f32 copy of itself.

    ``quantize="int8"`` makes the weights that ``quant.quantize_params``
    quantizes as ``quant.QuantizedTensor`` leaves, each layer quantized as
    soon as it is drawn: the model never exists in ``dtype`` as a whole
    (Mixtral-8x7B holds about 93 GB in bf16 and 47 GB in int8).  The
    values are those of ``quantize_params(init_params(...))``.

    ``shard`` (a ``parallel.sharding.LeafSharder``) keeps one rank's
    slice of every leaf: each layer is drawn whole, from the same stream,
    (quantized whole,) and sliced, so a rank holds its shard and one
    layer's transient."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize={quantize!r} (int8 only)")
    dtype = dtype or torch_dtype(cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L = cfg.num_layers

    def draw(shape, std) -> torch.Tensor:
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(0.0, std, generator=gen)

    def cut(path: str, x: Any, layer: bool = True) -> Any:
        return x if shard is None else shard.take(path, x, layer=layer)

    def normal(path: str, shape, std, quantized: bool = False):
        if len(shape) < 3:
            w = draw(shape, std)
            return cut(path, quantize_tensor(w, dtype) if quantized else w, layer=False)
        # a stacked [L, ...] weight fills layer by layer into its (shard's)
        # stack: one layer's whole draw is the only transient
        out: Any = None
        for i in range(shape[0]):
            w = draw(shape[1:], std)
            part = cut(path, quantize_tensor(w, dtype) if quantized else w)
            pieces = (part.q, part.s) if quantized else (part,)
            if out is None:
                out = [p.new_empty((shape[0],) + tuple(p.shape)) for p in pieces]
            for dst, src in zip(out, pieces):
                dst[i].copy_(src)
        return QuantizedTensor(*out) if quantized else out[0]

    quantized = quantize == "int8"
    layers: Params = {}
    for name, shape in layer_shapes(cfg).items():
        path = f"layers/{name}"
        if len(shape) == 1:
            fill = 0.0 if name.startswith("b") else 1.0
            layers[name] = cut(
                path, torch.full((L,) + shape, fill, dtype=dtype, device=device), layer=False
            )
        else:
            layers[name] = normal(
                path, (L,) + shape, 1.0 / math.sqrt(shape[-2]), quantized and name in QUANT_KEYS
            )
    params: Params = {
        "embed": normal("embed", (cfg.vocab_size, cfg.hidden_size), 0.02),
        "layers": layers,
        "final_norm": torch.ones(cfg.hidden_size, dtype=dtype, device=device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal(
            "lm_head", (cfg.hidden_size, cfg.vocab_size), 1.0 / math.sqrt(cfg.hidden_size),
            quantized,
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


def mesh_of(params: Params) -> Optional[Any]:
    """The ``parallel.mesh.ParallelMesh`` a rank's params carry, or None."""
    return getattr(params, "mesh", None)


def _dense_mlp(lp: Params, x: torch.Tensor, hidden_act: str, mesh=None) -> torch.Tensor:
    gate = _activate(x @ mat(lp["w_gate"]), hidden_act)
    out = (gate * (x @ mat(lp["w_up"]))) @ mat(lp["w_down"])
    return out if mesh is None else mesh.all_reduce(out, over="tp")


def _route(lp: Params, xf: torch.Tensor, K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``K`` experts of each row and their softmaxed weights.  The
    router runs in the activation dtype and is then cast to f32, as the
    JAX package's does.  ``jax.lax.top_k`` breaks ties by the lower index,
    which a stable descending sort gives (a constant row ties on every
    expert); ``torch.topk`` promises no order among equals."""
    logits = (xf @ lp["router"]).float()  # [N, E]
    topw, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :K], topi[:, :K]
    return torch.softmax(topw, dim=-1).to(xf.dtype), topi  # [N, K]


def _moe_mlp_dense(lp: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Dense-dispatch MoE: every expert computes every row, weighted
    combine.  O(E*N) work, kept only as the ground truth the sparse
    dispatch is held against (the JAX package's ``_moe_mlp_dense``)."""
    H = x.shape[-1]
    xf = x.reshape(-1, H)  # [N, H]
    topw, topi = _route(lp, xf, cfg.num_experts_per_tok)
    one_hot = F.one_hot(topi, cfg.num_experts).to(x.dtype)  # [N, K, E]
    combine = torch.einsum("nk,nke->ne", topw, one_hot)  # [N, E]
    gate = F.silu(torch.einsum("nh,ehi->eni", xf, mat(lp["w_gate"])))
    up = torch.einsum("nh,ehi->eni", xf, mat(lp["w_up"]))
    down = torch.einsum("eni,eih->enh", gate * up, mat(lp["w_down"]))  # [E, N, H]
    return torch.einsum("enh,ne->nh", down, combine).reshape(x.shape)


# MoE assignments and dropped assignments by device: a device pair each
# capacity dispatch adds to (no host sync; made before a graph captures
# it, at the eager warm-up), read and reset with :func:`moe_counts`
_MOE_COUNTS: Dict[str, torch.Tensor] = {}


def _counts_key(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def moe_counts(device: torch.device, reset: bool = False) -> Tuple[int, int]:
    """``(assignments, dropped)``: the capacity dispatch's token-expert
    assignments on ``device`` so far, and those past capacity."""
    t = _MOE_COUNTS.get(_counts_key(device))
    n = (0, 0) if t is None else tuple(int(v) for v in t.tolist())
    if reset and t is not None:
        t.zero_()
    return n


def moe_capacity(n: int, cfg: ModelConfig) -> int:
    """Rows per expert buffer for a dispatch of ``n`` flat rows (pad rows
    included): perfect balance ``n*K/E`` times the capacity factor,
    rounded up, at most ``n*K`` -- the JAX package's rule, to the bit."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    C = int(max(1, -(-n * K * cfg.moe_capacity_factor // E)))
    return min(C, n * K)


def _moe_mlp(lp: Params, x: torch.Tensor, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """Capacity-based sparse MoE dispatch (GShard/Switch), the JAX
    package's ``_moe_mlp`` assignment for assignment.

    Rows are routed top-k and packed into fixed ``[E, C, H]`` expert
    buffers; each expert runs a batched product over its buffer, and the
    combine weights each result by the router.  An assignment's slot is
    its rank among the assignments to its expert in the flat ``[N*K]``
    order (row-major over rows, then their K choices); one whose slot is
    past ``C`` is dropped and adds nothing.  So drops depend on every row
    of the dispatch, pad rows too.

    JAX's out-of-range scatter (``mode="drop"``) has no torch form: the
    buffer carries one trash row at ``E*C`` that dropped assignments
    write, and the gather clamps as JAX's does.  The combine sums each
    row's K contiguous assignments (``segment_sum`` over ``arange(N*K)
    // K``) with a reshape, not an atomic ``index_add_``, so it is the same
    sum in every run.  ``C`` is a Python int of the static row count and
    nothing here reads the device, so the dispatch captures in a CUDA
    graph.  The expert products are library batched matmuls, as the JAX
    package's are XLA einsums.

    On a mesh the rank holds experts ``[e0, e0 + E/ep)`` (each split over
    tp): it routes and slots every row as one card would, runs its own
    experts' ``C`` slots only, combines the assignments that went to
    them, and the all-reduce over the grid sums the rest in."""
    H = x.shape[-1]
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    xf = x.reshape(-1, H)  # [N, H]
    N = xf.shape[0]
    topw, topi = _route(lp, xf, K)
    C = moe_capacity(N, cfg)

    flat_expert = topi.reshape(-1)  # [N*K] expert of each assignment
    flat_w = topw.reshape(-1)  # [N*K]
    # slot of each assignment within its expert's buffer (stable order)
    onehot = F.one_hot(flat_expert, E)  # [N*K, E]
    slot = onehot.cumsum(0).gather(1, flat_expert[:, None])[:, 0] - 1
    keep = slot < C
    counts = _MOE_COUNTS.get(_counts_key(xf.device))
    if counts is None:
        # a normal tensor, not an inference one: it counts calls made
        # under the engine's inference mode and outside it alike
        with torch.inference_mode(False):
            counts = _MOE_COUNTS[_counts_key(xf.device)] = torch.zeros(
                2, dtype=torch.int64, device=xf.device
            )
    counts[0].add_(N * K)
    counts[1].add_((~keep).sum())
    dispatch = torch.where(keep, flat_expert * C + slot, torch.full_like(slot, E * C))

    buf = xf.new_zeros((E * C + 1, H))  # row E*C: the trash row
    buf.index_copy_(0, dispatch, xf.repeat_interleave(K, dim=0))
    buf = buf[: E * C].view(E, C, H)
    El, e0 = E, 0
    if mesh is not None:
        El = lp["w_gate"].shape[0]
        e0 = mesh.coords["ep"] * El
        buf = buf[e0 : e0 + El]
        keep = keep & (flat_expert >= e0) & (flat_expert < e0 + El)

    gate = F.silu(torch.bmm(buf, mat(lp["w_gate"])))  # [El, C, I]
    up = torch.bmm(buf, mat(lp["w_up"]))
    down = torch.bmm(gate * up, mat(lp["w_down"])).view(El * C, H)  # [El*C, H]

    local = (dispatch - e0 * C).clamp(0, El * C - 1)
    per_assign = down[local]  # [N*K, H]
    per_assign = per_assign * (flat_w * keep.to(flat_w.dtype))[:, None]
    out = per_assign.view(N, K, H).sum(dim=1).reshape(x.shape)
    return out if mesh is None else mesh.all_reduce(out, over="world")


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
    mesh: Optional[Any] = None,
) -> torch.Tensor:
    """One decoder layer (norm -> attention -> norm -> MLP, residuals).
    The head counts are the rank's: its weights' widths over the head
    dim."""
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
    q = q.view(T, -1, D)
    k = k.view(T, -1, D)
    v = v.view(T, -1, D)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attn_fn(q, k, v, kv_pages, layer)
    o = attn.reshape(T, -1) @ mat(lp["wo"])
    x = x + (o if mesh is None else mesh.all_reduce(o, over="tp"))
    h2 = rms_norm(x, lp["post_norm"], cfg.rms_norm_eps, cfg.rms_norm_offset)
    if cfg.is_moe:
        return x + _moe_mlp(lp, h2, cfg, mesh)
    return x + _dense_mlp(lp, h2, cfg.hidden_act, mesh)


def embed_tokens(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The trunk's input rows of ``tokens [T]``: the embedding lookup
    (gathered over tp on a mesh, whose table is split over the hidden
    axis) and Gemma's scale."""
    mesh = mesh_of(params)
    x = params["embed"][tokens]
    if mesh is not None:
        x = mesh.all_gather(x, dim=-1, over="tp")
    if cfg.scale_embeddings:
        # sqrt(hidden) rounded to the embed dtype, as the JAX trunk's; a
        # Python scalar, not a device tensor: a host-to-device copy inside
        # a CUDA-graph capture fails it
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype).item()
    return x


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
    mesh = mesh_of(params)
    x = embed_tokens(params, cfg, tokens)
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
        x = transformer_layer(lp, x, cos, sin, cfg, attn_fn, kv_pages, i, mesh)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps, cfg.rms_norm_offset)


def lm_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """f32 logits of ``hidden [..., H]``.  On a mesh the head's vocabulary
    slices all-gather over tp; a tied head (the embedding, split over the
    hidden axis) sums the rank's partial products over tp instead."""
    mesh = mesh_of(params)
    if cfg.tie_word_embeddings:
        w = params["embed"]
        if mesh is not None and w.shape[1] != hidden.shape[-1]:
            h0 = mesh.coords["tp"] * w.shape[1]
            part = (hidden[..., h0 : h0 + w.shape[1]] @ w.T).float()
            return mesh.all_reduce(part, over="tp")
        return (hidden @ w.T).float()
    logits = (hidden @ mat(params["lm_head"])).float()
    return logits if mesh is None else mesh.all_gather(logits, dim=-1, over="tp")
