"""Parameters from a checkpoint directory, or from the JAX package.

``params_from_numpy`` takes the JAX package's parameter dict (``init_params``
or the safetensors loader there, converted leaf by leaf to numpy) and
returns the port's parameters: the same nested dict, the same ``[in, out]``
stacked layout, as tensors on ``device`` in ``dtype``.  A matmul weight of
the JAX package's weight-only int8 tree (``quantize_params``) arrives as a
``(q, s)`` pair of numpy arrays and becomes a ``quant.QuantizedTensor``:
int8 data as it is, scales in ``dtype``.  bfloat16 arrays
(numpy's ``ml_dtypes`` extension type) cross byte-exactly through a 16-bit
integer view.

``vision_params_from_numpy`` does the same for the vision encoder's
parameters (``vision.py``).

``load_checkpoint_params`` loads a checkpoint as serving does: its
safetensors files when it has any, else its GGUF file (``llm/gguf.py``,
through ``assemble_params``).  ``load_safetensors_params`` reads a
HuggingFace checkpoint's
``*.safetensors`` files with the port's own reader (the card's machine has
no ``safetensors`` package): an 8-byte little-endian header length, a JSON
header, and raw tensors by ``dtype``/``shape``/``data_offsets``, read as
views of a copy-on-write memory map of the file.  ``assemble_params`` turns
the HF names into the stacked pytree as the JAX package's loader does (the
``[out, in]`` -> ``[in, out]`` transpose, one ``[L, ...]`` leaf per
weight, Phi-3's fused projections split, Mixtral's router and experts
stacked ``[L, E, ...]``), one layer at a time: each layer's
tensor goes from the mapped file to the device as it is, and is transposed
and cast there into its slot of the leaf, so the host never holds a copy of
the checkpoint.
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from .config import ModelConfig
from .kv_cache import torch_dtype
from .model import Params, layer_shapes
from .quant import QUANT_KEYS, QuantizedTensor, quantize_tensor


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
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    H, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers

    def check(arr: Any, shape, name: str) -> None:
        got = tuple(np.shape(arr))
        if got != tuple(shape):
            raise ValueError(f"param {name}: shape {got}, expected {tuple(shape)}")

    def take(arr: Any, shape, name: str) -> torch.Tensor:
        check(arr, shape, name)
        return _tensor(arr, device, dtype)

    def take_weight(arr: Any, shape, name: str) -> Any:
        """A matmul weight, or its JAX quantized form as a ``(q, s)``
        pair: int8 data of the weight's shape, scales ``[..., 1, out]``."""
        if not isinstance(arr, (tuple, list)):
            return take(arr, shape, name)
        q, scales = arr
        check(q, shape, name)
        if np.asarray(q).dtype != np.int8:
            raise ValueError(f"param {name}: quantized data must be int8")
        return QuantizedTensor(
            _tensor(q, device, torch.int8),
            take(scales, tuple(shape[:-2]) + (1, shape[-1]), f"{name} scales"),
        )

    src_layers = params["layers"]
    layers: Dict[str, Any] = {}
    for name, shape in layer_shapes(cfg).items():
        if name not in src_layers:
            raise ValueError(f"param layers.{name} is missing")
        grab = take_weight if name in QUANT_KEYS else take
        layers[name] = grab(src_layers[name], (L,) + shape, f"layers.{name}")
    out: Params = {
        "embed": take(params["embed"], (V, H), "embed"),
        "layers": layers,
        "final_norm": take(params["final_norm"], (H,), "final_norm"),
    }
    if not cfg.tie_word_embeddings:
        out["lm_head"] = take_weight(params["lm_head"], (H, V), "lm_head")
    return out


def vision_params_from_numpy(
    params: Mapping[str, Any],
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, Any]:
    """The vision encoder's parameters (``vision.py``) from the JAX
    package's ``init_vision_params`` pytree, converted leaf by leaf to
    numpy: the same dict and list of per-layer dicts, f32 tensors on
    ``device``."""
    device = resolve_device(device)
    out: Dict[str, Any] = {
        k: _tensor(v, device, torch.float32) for k, v in params.items() if k != "layers"
    }
    out["layers"] = [
        {k: _tensor(v, device, torch.float32) for k, v in lp.items()}
        for lp in params["layers"]
    ]
    return out


# safetensors dtype -> (numpy element type of the raw bytes, torch dtype)
SAFETENSORS_DTYPES = {
    "BF16": (np.uint16, torch.bfloat16),
    "F16": (np.float16, torch.float16),
    "F32": (np.float32, torch.float32),
}


class SafetensorsFile:
    """One ``.safetensors`` file, memory-mapped: ``get(name)`` is a CPU
    tensor viewing the file's bytes (copy-on-write, so the file is never
    written)."""

    def __init__(self, path: str) -> None:
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self.path = path
        self.entries: Dict[str, Dict[str, Any]] = header
        self._base = 8 + n
        self._map = np.memmap(path, dtype=np.uint8, mode="c")

    def keys(self) -> List[str]:
        return list(self.entries)

    def get(self, name: str) -> torch.Tensor:
        e = self.entries[name]
        kind = e["dtype"]
        if kind not in SAFETENSORS_DTYPES:
            raise ValueError(f"{self.path}: tensor {name} has unsupported dtype {kind}")
        np_type, t_type = SAFETENSORS_DTYPES[kind]
        shape = tuple(e["shape"])
        begin, end = e["data_offsets"]
        if end - begin != math.prod(shape) * np.dtype(np_type).itemsize:
            raise ValueError(f"{self.path}: tensor {name} has {end - begin} bytes for {shape}")
        arr = self._map[self._base + begin:self._base + end].view(np_type).reshape(shape)
        t = torch.from_numpy(arr)
        return t.view(torch.bfloat16) if t_type is torch.bfloat16 else t


class SafetensorsIndex:
    """Name -> tensor over every ``.safetensors`` file of a directory."""

    def __init__(self, files: Sequence[str]) -> None:
        self._where: Dict[str, SafetensorsFile] = {}
        for path in files:
            f = SafetensorsFile(path)
            for name in f.keys():
                self._where[name] = f

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._where[name].get(name)

    def keys(self) -> List[str]:
        return list(self._where)


def load_safetensors_params(
    model_path: str,
    cfg: ModelConfig,
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
    quantize: Optional[str] = None,
    shard: Optional[Any] = None,
) -> Params:
    """Load all ``*.safetensors`` files under ``model_path`` (``quantize``
    as :func:`assemble_params` takes it)."""
    files = sorted(
        os.path.join(model_path, f)
        for f in os.listdir(model_path)
        if f.endswith(".safetensors")
    )
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {model_path}")
    return assemble_params(SafetensorsIndex(files), cfg, device, dtype, quantize, shard)


def load_checkpoint_params(
    model_path: str,
    cfg: ModelConfig,
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
    quantize: Optional[str] = None,
    shard: Optional[Any] = None,
) -> Params:
    """A checkpoint's weights as serving loads them: the ``*.safetensors``
    files of a directory when it has any, else its GGUF file (``model_path``
    a ``.gguf`` file or a directory holding one), dequantized on load
    (``llm/gguf.py``).  ``shard`` as :func:`assemble_params` takes it."""
    if os.path.isdir(model_path) and any(
        f.endswith(".safetensors") for f in os.listdir(model_path)
    ):
        return load_safetensors_params(model_path, cfg, device, dtype, quantize, shard)
    from ..llm.gguf import find_gguf_file, load_gguf_params

    gguf = find_gguf_file(model_path)
    if gguf is None:
        raise FileNotFoundError(f"{model_path}: no .safetensors and no .gguf weights")
    return load_gguf_params(gguf, cfg, device, dtype, quantize, shard)


def assemble_params(
    raw: Any,
    cfg: ModelConfig,
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
    quantize: Optional[str] = None,
    shard: Optional[Any] = None,
) -> Params:
    """The stacked parameter dict on ``device`` from a flat HF name ->
    CPU tensor mapping (a dict, or :class:`SafetensorsIndex`).

    ``shard`` (a ``parallel.sharding.LeafSharder``) keeps one rank's
    slice of every leaf: a layer's tensor is sliced where it is read (a
    view of the mapped file; a rank of an expert-parallel grid stacks only
    its experts), then copied to the device; a weight that quantizes lands
    whole, is quantized (a row-parallel weight's scales are its whole
    rows') and then sliced.

    ``quantize="int8"`` quantizes each layer's matmul weights as the layer
    lands (``quant.quantize_tensor``'s values), so a model that fits the
    card only in int8 (Mixtral-8x7B) never stands there in ``dtype``; the
    weights that are not stacked per layer (Phi-3's fused projections,
    ``lm_head``) are left to the engine's ``quantize_params``."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize={quantize!r} (int8 only)")
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    L = cfg.num_layers
    pre = "model."
    want = layer_shapes(cfg)

    def get(name: str) -> torch.Tensor:
        if name not in raw:
            raise KeyError(f"missing weight {name}")
        # one card: the whole tensor goes to the device (transposes run
        # there); a rank slices the mapped view first
        return raw[name].to(device) if shard is None else raw[name]

    def cut(path: str, x: Any, layer: bool = True, done: Tuple[str, ...] = ()) -> Any:
        return x if shard is None else shard.take(path, x, layer=layer, done=done)

    def shape_of(path: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return tuple(shape) if shard is None else shard.shape(path, shape)

    def check(key: str, got: Tuple[int, ...], shape: Tuple[int, ...]) -> None:
        if tuple(got) != tuple(shape):
            raise ValueError(f"param {key}: shape {tuple(got)}, expected {tuple(shape)}")

    def stack(key: str, layer_fn: Callable[[int], torch.Tensor],
              done: Tuple[str, ...] = ()) -> Any:
        """One ``[L, ...]`` leaf, a layer at a time (``done``: axes
        ``layer_fn`` already took this rank's part of)."""
        path = f"layers/{key}"
        quantized = quantize == "int8" and key in QUANT_KEYS
        out: Any = None
        for i in range(L):
            w = layer_fn(i)
            full = want[key]
            if shard is not None and done:
                full = shard.shape(path, full, layer=True, only=done)
            check(f"layers.{key}", w.shape, full)
            if quantized:
                part = cut(path, quantize_tensor(w.to(device=device, dtype=dtype), dtype),
                           done=done)
                pieces = (part.q, part.s)
            else:
                pieces = (cut(path, w, done=done),)
            if out is None:
                out = [torch.empty((L,) + tuple(p.shape), dtype=torch.int8 if j == 0 and quantized
                                   else dtype, device=device) for j, p in enumerate(pieces)]
            for dst, src in zip(out, pieces):
                dst[i].copy_(src)
        return QuantizedTensor(*out) if quantized else out[0]

    def linear(name: str) -> torch.Tensor:
        return get(name).T  # [out, in] -> [in, out]

    layers: Dict[str, torch.Tensor] = {}

    def split_fused(suffix: str, splits: Sequence[Tuple[str, int]]) -> None:
        """One fused ``[sum(rows), H]`` tensor per layer -> several stacked
        ``[L, H, rows]`` leaves, one read per layer."""
        for key, _ in splits:
            layers[key] = torch.empty(
                (L,) + shape_of(f"layers/{key}", (L,) + want[key])[1:], dtype=dtype, device=device
            )
        for i in range(L):
            w = get(f"{pre}layers.{i}.{suffix}")
            lo = 0
            for key, rows in splits:
                part = w[lo:lo + rows].T
                check(f"layers.{key}", part.shape, want[key])
                layers[key][i].copy_(cut(f"layers/{key}", part))
                lo += rows

    if f"{pre}layers.0.self_attn.qkv_proj.weight" in raw:
        # Phi-3: fused qkv_proj rows are [q | k | v]
        q_rows = cfg.num_heads * cfg.head_dim
        kv_rows = cfg.num_kv_heads * cfg.head_dim
        split_fused(
            "self_attn.qkv_proj.weight",
            [("wq", q_rows), ("wk", kv_rows), ("wv", kv_rows)],
        )
        layers["wo"] = stack(
            "wo", lambda i: linear(f"{pre}layers.{i}.self_attn.o_proj.weight")
        )
    else:
        for key, proj in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                          ("wo", "o_proj")):
            layers[key] = stack(
                key, lambda i, p=proj: linear(f"{pre}layers.{i}.self_attn.{p}.weight")
            )
    if cfg.attention_bias:
        for key, proj in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            layers[key] = stack(
                key, lambda i, p=proj: get(f"{pre}layers.{i}.self_attn.{p}.bias")
            )
    if cfg.qk_norm:
        for key in ("q_norm", "k_norm"):
            layers[key] = stack(
                key, lambda i, k=key: get(f"{pre}layers.{i}.self_attn.{k}.weight")
            )
    layers["input_norm"] = stack(
        "input_norm", lambda i: get(f"{pre}layers.{i}.input_layernorm.weight")
    )
    layers["post_norm"] = stack(
        "post_norm", lambda i: get(f"{pre}layers.{i}.post_attention_layernorm.weight")
    )
    if cfg.is_moe:
        moe = "block_sparse_moe"
        layers["router"] = stack(
            "router", lambda i: linear(f"{pre}layers.{i}.{moe}.gate.weight")
        )
        # Mixtral: w1 = gate, w3 = up, w2 = down, each layer's experts
        # stacked [E, in, out] (an expert-parallel rank's own experts)
        e_lo, e_hi = (0, cfg.num_experts) if shard is None else shard.expert_range(cfg)
        for key, w in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2")):
            layers[key] = stack(key, lambda i, w=w: torch.stack([
                linear(f"{pre}layers.{i}.{moe}.experts.{e}.{w}.weight")
                for e in range(e_lo, e_hi)
            ]), done=("ep",))
    elif f"{pre}layers.0.mlp.gate_up_proj.weight" in raw:
        # Phi-3: fused gate_up_proj rows are [gate | up]
        inter = cfg.intermediate_size
        split_fused("mlp.gate_up_proj.weight", [("w_gate", inter), ("w_up", inter)])
        layers["w_down"] = stack(
            "w_down", lambda i: linear(f"{pre}layers.{i}.mlp.down_proj.weight")
        )
    else:
        for key, proj in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                          ("w_down", "down_proj")):
            layers[key] = stack(
                key, lambda i, p=proj: linear(f"{pre}layers.{i}.mlp.{p}.weight")
            )

    H, V = cfg.hidden_size, cfg.vocab_size

    def whole(key: str, w: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
        check(key, w.shape, shape)
        w = cut(key, w, layer=False)
        out = torch.empty(w.shape, dtype=dtype, device=device)
        out.copy_(w)
        return out

    params: Params = {
        "embed": whole("embed", get(f"{pre}embed_tokens.weight"), (V, H)),
        "layers": layers,
        "final_norm": whole("final_norm", get(f"{pre}norm.weight"), (H,)),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = whole("lm_head", linear("lm_head.weight"), (H, V))
    return params
