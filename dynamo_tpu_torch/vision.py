"""Vision encoder: a CLIP-class ViT trunk and multimodal projector, in
plain PyTorch.

The encode stage of the E-P-D multimodal graph, rewritten from the JAX
package's ``vision.py``: patchify -> linear patch embedding + learned
positions -> pre-LN transformer blocks with full bidirectional attention
-> final LN -> linear projector into the LLM's hidden space.  The output
rows are a llava-style soft prompt (``PreprocessedRequest.mm_embeds``),
injected over the leading prompt positions by
``engine/step.py prefill_mm_and_sample``.  The JAX package runs this
attention as XLA einsums, not as a Pallas kernel; here it is the same
einsums in torch, on whatever device the parameters and images live on.

The parameters keep the JAX layout: weights ``[in, out]`` (the forward is
``x @ W``), a list of per-layer dicts; ``engine/weights.py
vision_params_from_numpy`` carries the JAX pytree across.
"""

from __future__ import annotations

import base64
import io
import logging
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from .device import resolve_device

logger = logging.getLogger("dynamo.vision")

Params = Dict[str, Any]


@dataclass(frozen=True)
class VisionConfig:
    image_size: int = 32
    patch_size: int = 8
    hidden_size: int = 64
    num_layers: int = 2
    num_heads: int = 4
    mlp_size: int = 128
    out_dim: int = 64  # the LLM's hidden size (projector target)
    eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def tiny(cls, out_dim: int = 64) -> "VisionConfig":
        return cls(out_dim=out_dim)


def init_vision_params(
    cfg: VisionConfig,
    seed: int,
    device: Optional[Union[str, torch.device]] = None,
) -> Params:
    """Random f32 parameters made on ``device`` from ``seed`` (normal with
    std 0.02, zero biases, unit LN gains: the JAX ``init_vision_params``
    distribution, not its draws)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    H, P = cfg.hidden_size, cfg.patch_size

    def w(*shape):
        return torch.randn(shape, generator=gen, device=device) * 0.02

    def zeros(n):
        return torch.zeros((n,), device=device)

    def ones(n):
        return torch.ones((n,), device=device)

    params: Params = {
        "patch_w": w(P * P * 3, H),
        "patch_b": zeros(H),
        "pos": w(cfg.num_patches, H),
        "final_ln_g": ones(H),
        "final_ln_b": zeros(H),
        "proj": w(H, cfg.out_dim),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append(
            {
                "ln1_g": ones(H), "ln1_b": zeros(H),
                "ln2_g": ones(H), "ln2_b": zeros(H),
                "wqkv": w(H, 3 * H),
                "wo": w(H, H),
                "w1": w(H, cfg.mlp_size), "b1": zeros(cfg.mlp_size),
                "w2": w(cfg.mlp_size, H), "b2": zeros(H),
            }
        )
    return params


def encode_image(
    params: Params,
    cfg: VisionConfig,
    images: torch.Tensor,  # [B, image_size, image_size, 3] f32 in [0, 1]
) -> torch.Tensor:
    """Images -> soft-prompt rows ``[B, num_patches, out_dim]`` f32."""
    B = images.shape[0]
    P, H, nH = cfg.patch_size, cfg.hidden_size, cfg.num_heads
    g = cfg.image_size // P
    # patchify: [B, g, P, g, P, 3] -> [B, g*g, P*P*3]
    x = images.float().reshape(B, g, P, g, P, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, g * g, P * P * 3)
    x = x @ params["patch_w"] + params["patch_b"] + params["pos"]

    D = H // nH
    scale = 1.0 / D ** 0.5
    for lp in params["layers"]:
        h = F.layer_norm(x, (H,), lp["ln1_g"], lp["ln1_b"], cfg.eps)
        qkv = (h @ lp["wqkv"]).reshape(B, -1, 3, nH, D)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, -1, H)
        x = x + o @ lp["wo"]
        h = F.layer_norm(x, (H,), lp["ln2_g"], lp["ln2_b"], cfg.eps)
        x = x + F.gelu(h @ lp["w1"] + lp["b1"], approximate="tanh") @ lp["w2"] + lp["b2"]

    x = F.layer_norm(x, (H,), params["final_ln_g"], params["final_ln_b"], cfg.eps)
    return x @ params["proj"]


def decode_image_payload(
    payload: Any,
    image_size: int,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """Image decode for the encode worker's wire payload, as a ``[image_size,
    image_size, 3]`` f32 tensor on ``device`` (cropped or zero-padded).

    Accepts a nested list/array ``[H, W, 3]`` (already-decoded pixels), or
    raw bytes / base64 text decoded through PIL when it is installed.  An
    undecodable byte payload RAISES: a real JPEG silently turning into
    deterministic noise would generate from garbage with no error."""
    device = resolve_device(device)
    if isinstance(payload, (list, tuple)) or (
        isinstance(payload, np.ndarray) and payload.ndim == 3
    ):
        arr = np.asarray(payload, np.float32)
    else:
        if isinstance(payload, str):
            try:
                payload = base64.b64decode(payload)
            except Exception:
                logger.debug("image payload is not base64; treating as raw bytes")
                payload = payload.encode()
        try:
            from PIL import Image  # noqa: PLC0415 - optional dependency
        except ImportError as exc:
            raise ValueError(
                "image payload is raw bytes but no image decoder is "
                "available (install PIL, or pass decoded [H, W, 3] pixels)"
            ) from exc
        try:
            img = Image.open(io.BytesIO(bytes(payload))).convert("RGB")
        except Exception as exc:
            raise ValueError(f"undecodable image payload: {exc}") from exc
        arr = np.asarray(img, np.float32) / 255.0
    out = np.zeros((image_size, image_size, 3), np.float32)
    h = min(image_size, arr.shape[0])
    w = min(image_size, arr.shape[1])
    out[:h, :w] = arr[:h, :w, :3]
    return torch.from_numpy(out).to(device)
