"""Carry a parameter pytree across from the JAX package.

``params_from_numpy`` takes the JAX package's parameter dict (``init_params``
or the safetensors loader there, converted leaf by leaf to numpy) and
returns the port's parameters: the same nested dict, the same ``[in, out]``
stacked layout, as tensors on ``device`` in ``dtype``.  bfloat16 arrays
(numpy's ``ml_dtypes`` extension type) cross byte-exactly through a 16-bit
integer view.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from .config import ModelConfig
from .kv_cache import torch_dtype
from .model import Params, check_supported, layer_shapes


def _tensor(arr: Any, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    a = np.ascontiguousarray(arr)
    if not a.flags.writeable:  # a JAX array's numpy view is read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(
    params: Mapping[str, Any],
    cfg: ModelConfig,
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
) -> Params:
    check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    H, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers

    def take(arr: Any, shape, name: str) -> torch.Tensor:
        got = tuple(np.shape(arr))
        if got != tuple(shape):
            raise ValueError(f"param {name}: shape {got}, expected {tuple(shape)}")
        return _tensor(arr, device, dtype)

    src_layers = params["layers"]
    layers: Dict[str, torch.Tensor] = {}
    for name, shape in layer_shapes(cfg).items():
        if name not in src_layers:
            raise ValueError(f"param layers.{name} is missing")
        layers[name] = take(src_layers[name], (L,) + shape, f"layers.{name}")
    out: Params = {
        "embed": take(params["embed"], (V, H), "embed"),
        "layers": layers,
        "final_norm": take(params["final_norm"], (H,), "final_norm"),
    }
    if not cfg.tie_word_embeddings:
        out["lm_head"] = take(params["lm_head"], (H, V), "lm_head")
    return out
