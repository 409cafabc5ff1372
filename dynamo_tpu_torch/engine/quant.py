"""Weight-only int8 quantization for the serving engine.

Decode at small batch is memory-bound: every step streams the full weight
set, so halving the weight bytes is a decode-throughput lever once the
dequantization fuses into the matmul's operand read.  Per-output-channel
symmetric int8, the scale applied at the point of use -- ``x @ (q * s)``.

What quantizes: the per-layer matmul weights (attention projections and
MLP weights, or an MoE layer's expert stacks ``[E, in, out]`` with one
scale per expert and output channel, ``[L, E, 1, out]``) and an untied
``lm_head``; an MoE router stays in the compute dtype, as in the JAX
package.  What stays in the compute dtype:
the embedding table (decode gathers B rows per step, not the whole
matrix), norms and biases (tiny), and a tied lm_head (shared with the
embedding).

The JAX package's ``engine/quant.py`` rule, bit for bit: the scale is the
channel's ``amax / 127`` in f32 (1 for an all-zero channel), the weight
divided by it in f32 and rounded half to even, clipped to [-127, 127]; the
scale is then stored in the compute dtype.  There XLA fuses the convert
into the consuming matmul; here :func:`mat` runs as plain torch, which
writes the dequantized weight out before the product (a fused W8A16 GEMM
is a later kernel).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

Params = Dict[str, Any]

# per-layer matmul weights that quantize; the contraction axis is -2 ("in")
# in every one of them, so the scale lives on the output channel
QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclass
class QuantizedTensor:
    """int8 weight + broadcastable per-output-channel scale.  Indexing
    takes a leading slice of both (one layer of a stacked ``[L, ...]``
    weight, an ``[E, in, out]`` expert stack with its ``[E, 1, out]``
    scales for an MoE layer), as the trunk's layer loop does."""

    q: torch.Tensor  # int8, the original weight's shape
    s: torch.Tensor  # compute dtype, shape [..., 1, out]

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def __getitem__(self, i) -> "QuantizedTensor":
        return QuantizedTensor(self.q[i], self.s[i])


def mat(w: Any) -> torch.Tensor:
    """A weight at its point of use: a :class:`QuantizedTensor`
    dequantized to its scale's dtype, a plain tensor as it is."""
    if isinstance(w, QuantizedTensor):
        return w.q.to(w.s.dtype) * w.s
    return w


def _quantize_slice(w: torch.Tensor, dtype: torch.dtype) -> QuantizedTensor:
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return QuantizedTensor(q=q, s=s.to(dtype))


# output channels a 2-D weight quantizes at a time: each channel's scale is
# its own, so the slices give the whole weight's bytes, and the f32 upcast
# peaks at H x QUANT_COLUMNS (Llama-3-70B's lm_head whole: 4.2 GB)
QUANT_COLUMNS = 8192


def quantize_tensor(w: torch.Tensor, dtype: torch.dtype) -> QuantizedTensor:
    """Symmetric per-output-channel int8 over the contraction axis (-2), on
    ``w``'s device.  A stacked ``[L, ...]`` weight quantizes one leading
    slice at a time into preallocated int8 and scale tensors, and a 2-D one
    QUANT_COLUMNS output channels at a time, so the f32 upcast the rounding
    needs peaks at one layer's size: an 8B model must not hold an f32 copy
    of a whole stack, nor a 70B model one of its vocab-wide head."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(
        w.shape[:-2] + (1, w.shape[-1]), dtype=dtype, device=w.device
    )
    if w.dim() == 2:
        for c in range(0, w.shape[-1], QUANT_COLUMNS):
            cols = slice(c, c + QUANT_COLUMNS)
            part = _quantize_slice(w[:, cols], dtype)
            q[:, cols].copy_(part.q)
            s[:, cols].copy_(part.s)
        return QuantizedTensor(q=q, s=s)
    for i in range(w.shape[0]):
        part = quantize_tensor(w[i], dtype)
        q[i].copy_(part.q)
        s[i].copy_(part.s)
    return QuantizedTensor(q=q, s=s)


def quantize_params(params: Params, dtype: torch.dtype) -> Params:
    """The params with their streaming-dominant weights quantized (a new
    dict; the given one is not changed).  Leaves already quantized stay as
    they are."""

    def quant(w: Any) -> Any:
        return w if isinstance(w, QuantizedTensor) else quantize_tensor(w, dtype)

    out = dict(params)
    layers = dict(params["layers"])
    for k in QUANT_KEYS:
        if k in layers:
            layers[k] = quant(layers[k])
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"] = quant(params["lm_head"])
    return out


def weight_bytes(params: Params) -> int:
    """Bytes the parameters hold on their device (int8 data and scales for
    quantized leaves)."""

    def size(w: Any) -> int:
        if isinstance(w, QuantizedTensor):
            return size(w.q) + size(w.s)
        if isinstance(w, dict):
            return sum(size(v) for v in w.values())
        return w.numel() * w.element_size()

    return size(params)
