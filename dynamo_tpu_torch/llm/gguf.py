"""GGUF checkpoints: metadata, the tokenizer, and weights dequantized on load.

The port of the JAX package's ``llm/gguf.py`` (reference
``lib/llm/src/gguf``).  A llama.cpp-ecosystem model ships as one ``.gguf``
file: a little-endian header (magic, version 2 or later, tensor and
key/value counts), the metadata key/values, the tensor infos (name, ggml
dims with the contiguous one first, ggml type, offset), and the tensor data
from the next ``general.alignment`` boundary.

* The tokenizer comes from the metadata: ``llama``/``replit`` files become
  a Unigram model (SentencePiece semantics: byte fallback, ``▁`` word
  boundaries), ``gpt2`` files byte-level BPE, as the JAX package converts
  them to the Rust ``tokenizers`` core.  The card's machine has no
  ``tokenizers`` package, so :func:`gguf_tokenizer_spec` writes the same
  pipeline as a ``tokenizer.json`` document, which the port's own
  ``llm/tokenizer.py`` reads.
* The model config comes from the ``llama.*`` keys (:func:`gguf_model_config`).
* The weights (llama architecture) load first-party: F32, F16 and BF16 as
  they are, Q8_0 and Q4_0 dequantized in f32 (f16 scale times int8 or
  nibble) with torch on the target device, one tensor at a time, its raw
  block bytes read from a memory map of the file.  q/k rows un-permute from
  llama.cpp's interleaved-rope layout back to the HF order the engine's
  RoPE uses, and ``engine/weights.py``'s ``assemble_params`` stacks them
  under their HF names (:class:`_GgufHFView`).  K-quants and other
  architectures are refused by name.
"""

from __future__ import annotations

import logging
import math
import os
import struct
from typing import Any, BinaryIO, Dict, Optional, Tuple, Union

import numpy as np
import torch

logger = logging.getLogger("dynamo.torch.gguf")

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian

# metadata value types (gguf spec / gguf_metadata.rs)
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32 = 0, 1, 2, 3, 4, 5
_T_F32, _T_BOOL, _T_STRING, _T_ARRAY, _T_U64, _T_I64, _T_F64 = (
    6, 7, 8, 9, 10, 11, 12,
)

_SCALAR_FMT = {
    _T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
    _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_U64: "<Q",
    _T_I64: "<q", _T_F64: "<d",
}


def _read_scalar(f: BinaryIO, vtype: int) -> Any:
    if vtype == _T_BOOL:
        return struct.unpack("<B", f.read(1))[0] != 0
    if vtype == _T_STRING:
        (n,) = struct.unpack("<Q", f.read(8))
        return f.read(n).decode("utf-8", errors="replace")
    fmt = _SCALAR_FMT.get(vtype)
    if fmt is None:
        raise ValueError(f"unsupported GGUF value type {vtype}")
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))[0]


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype == _T_ARRAY:
        (etype,) = struct.unpack("<I", f.read(4))
        (count,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, etype) for _ in range(count)]
    return _read_scalar(f, vtype)


def _read_header(f: BinaryIO, path: str) -> Tuple[int, Dict[str, Any]]:
    """Magic/version check and the metadata section: ``(tensor_count,
    metadata)``, with ``f`` left at the tensor infos."""
    magic, version = struct.unpack("<II", f.read(8))
    if magic != GGUF_MAGIC:
        raise ValueError(f"{path}: not a GGUF file (magic {magic:#x})")
    if version < 2:
        raise ValueError(f"{path}: GGUF version {version} unsupported")
    tensor_count, kv_count = struct.unpack("<QQ", f.read(16))
    meta: Dict[str, Any] = {}
    for _ in range(kv_count):
        (klen,) = struct.unpack("<Q", f.read(8))
        key = f.read(klen).decode("utf-8", errors="replace")
        (vtype,) = struct.unpack("<I", f.read(4))
        meta[key] = _read_value(f, vtype)
    return tensor_count, meta


def read_gguf_metadata(path: str) -> Dict[str, Any]:
    """A GGUF file's metadata key/values (tensors skipped)."""
    with open(path, "rb") as f:
        return _read_header(f, path)[1]


def find_gguf_file(model_path: str) -> Optional[str]:
    """``model.gguf`` itself, or the first ``.gguf`` (by name) inside a
    directory; None if there is none."""
    if model_path.endswith(".gguf") and os.path.isfile(model_path):
        return model_path
    if os.path.isdir(model_path):
        ggufs = sorted(f for f in os.listdir(model_path) if f.endswith(".gguf"))
        if ggufs:
            return os.path.join(model_path, ggufs[0])
    return None


# ---------------------------------------------------------------------------
# the tokenizer
# ---------------------------------------------------------------------------


def _added(tid: int, content: str) -> Dict[str, Any]:
    return {"id": tid, "content": content, "single_word": False, "lstrip": False,
            "rstrip": False, "normalized": False, "special": True}


def gguf_tokenizer_spec(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The ``tokenizer.json`` document of a GGUF file's tokenizer, and its
    info (bos/eos/unk ids, ``add_bos_token``, the chat template, the ggml
    model name): the pipeline the JAX package's ``gguf_tokenizer`` builds
    in the Rust core, as that core serializes it.

    ``llama``/``replit``: Unigram over ``tokens`` and ``scores`` with byte
    fallback and the unknown id (0 when the file names none), behind the
    normalizers ``Prepend("▁")`` and ``Replace(" ", "▁")``, with the
    decoders ``Replace("▁", " ")``, ``ByteFallback``, ``Fuse`` and
    ``Strip(" ", 1, 0)``.  ``gpt2``: byte-level BPE over ``tokens`` and
    ``merges`` (``"a b"`` strings).  bos, eos and unk are special added
    tokens; ``add_bos_token`` (default true for the SentencePiece models,
    false for BPE) installs a ``TemplateProcessing`` that prepends bos."""
    meta = read_gguf_metadata(path)

    def g(key: str, required: bool = False) -> Any:
        v = meta.get(f"tokenizer.ggml.{key}")
        if v is None and required:
            raise ValueError(f"{path}: missing tokenizer.ggml.{key}")
        return v

    model = g("model", required=True)
    tokens = g("tokens", required=True)
    bos = int(g("bos_token_id", required=True))
    eos = int(g("eos_token_id", required=True))
    unk = g("unknown_token_id")
    unk = int(unk) if unk is not None else None

    spec: Dict[str, Any] = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": [],
        "normalizer": None, "pre_tokenizer": None, "post_processor": None,
        "decoder": None,
    }
    if model in ("llama", "replit"):
        scores = g("scores")
        if scores is None:
            raise ValueError(
                f"{path}: `llama` unigram tokenizer requires tokenizer.ggml.scores"
            )
        spec["normalizer"] = {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"},
        ]}
        spec["decoder"] = {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"},
            {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0},
        ]}
        spec["model"] = {
            "type": "Unigram", "unk_id": unk if unk is not None else 0,
            "vocab": [[t, float(s)] for t, s in zip(tokens, scores)],
            "byte_fallback": True,
        }
    elif model == "gpt2":
        merges = g("merges")
        if merges is None:
            raise ValueError(f"{path}: BPE tokenizer requires merges")
        spec["pre_tokenizer"] = {"type": "ByteLevel", "add_prefix_space": False,
                                 "trim_offsets": True, "use_regex": True}
        spec["decoder"] = {"type": "ByteLevel", "add_prefix_space": True,
                           "trim_offsets": True, "use_regex": True}
        spec["model"] = {
            "type": "BPE", "dropout": None,
            "unk_token": tokens[unk] if unk is not None else None,
            "continuing_subword_prefix": None, "end_of_word_suffix": None,
            "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
            "vocab": {t: i for i, t in enumerate(tokens)},
            "merges": [list(m.partition(" ")[::2]) for m in merges],
        }
    else:
        raise ValueError(f"{path}: tokenizer model {model!r} not supported")

    specials = [bos, eos] + ([unk] if unk is not None else [])
    # the Rust core adds each content once, at the id the vocabulary gives it
    seen = set()
    for tid in specials:
        if tokens[tid] not in seen:
            seen.add(tokens[tid])
            spec["added_tokens"].append(_added(tid, tokens[tid]))
    spec["added_tokens"].sort(key=lambda d: d["id"])

    # llama.cpp's convention: add_bos defaults to true for the SentencePiece
    # models, false for BPE
    add_bos = bool(meta.get("tokenizer.ggml.add_bos_token", model in ("llama", "replit")))
    if add_bos:
        bos_tok = tokens[bos]
        seq = lambda name, type_id: {"Sequence": {"id": name, "type_id": type_id}}  # noqa: E731
        special = {"SpecialToken": {"id": bos_tok, "type_id": 0}}
        spec["post_processor"] = {
            "type": "TemplateProcessing",
            "single": [special, seq("A", 0)],
            "pair": [special, seq("A", 0), special, seq("B", 0)],
            "special_tokens": {bos_tok: {"id": bos_tok, "ids": [bos], "tokens": [bos_tok]}},
        }
    info = {
        "bos_token_id": bos,
        "eos_token_id": eos,
        "unk_token_id": unk,
        "add_bos_token": add_bos,
        "chat_template": meta.get("tokenizer.chat_template"),
        "model": model,
    }
    logger.info("gguf tokenizer: model=%s tokens=%d bos=%d eos=%d",
                model, len(tokens), bos, eos)
    return spec, info


def gguf_tokenizer(path: str):
    """``(Tokenizer, info)`` of a GGUF file: the port's tokenizer over
    :func:`gguf_tokenizer_spec`'s document, carrying the file's chat
    template and its bos and eos tokens."""
    from .tokenizer import Tokenizer, _Core

    spec, info = gguf_tokenizer_spec(path)
    core = _Core(spec)
    tok = Tokenizer(
        core,
        chat_template=info["chat_template"],
        eos_token=core.id_to_token(info["eos_token_id"]),
        bos_token=core.id_to_token(info["bos_token_id"]),
    )
    return tok, info


# ---------------------------------------------------------------------------
# weights (llama architecture)
# ---------------------------------------------------------------------------

# ggml tensor types (ggml.h)
GGML_F32, GGML_F16, GGML_Q4_0, GGML_Q8_0, GGML_BF16 = 0, 1, 2, 8, 30

_GGML_BLOCK = {  # type -> (elements per block, bytes per block)
    GGML_Q4_0: (32, 18),  # f16 scale + 16 nibble bytes
    GGML_Q8_0: (32, 34),  # f16 scale + 32 int8
}
_GGML_PLAIN = {GGML_F32: torch.float32, GGML_F16: torch.float16, GGML_BF16: torch.bfloat16}


def _unsupported_type(gtype: int) -> ValueError:
    return ValueError(
        f"unsupported ggml tensor type {gtype} (supported: F32/F16/BF16/"
        f"Q8_0/Q4_0; re-export K-quants via llama.cpp or use safetensors)"
    )


def read_gguf_tensors(path: str):
    """Header and tensor infos: ``(metadata, tensors, data_start)``, where
    ``tensors`` maps name -> ``(ggml_type, shape, offset)`` (the shape
    reversed from ggml's ``ne``, so the contiguous dim is last; the offset
    relative to ``data_start``)."""
    with open(path, "rb") as f:
        tensor_count, meta = _read_header(f, path)
        tensors: Dict[str, Tuple[int, Tuple[int, ...], int]] = {}
        for _ in range(tensor_count):
            (nlen,) = struct.unpack("<Q", f.read(8))
            name = f.read(nlen).decode("utf-8", errors="replace")
            (n_dims,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
            gtype, offset = struct.unpack("<IQ", f.read(4 + 8))
            tensors[name] = (gtype, tuple(reversed(dims)), offset)
        align = int(meta.get("general.alignment", 32) or 32)
        pos = f.tell()
        data_start = (pos + align - 1) // align * align
        return meta, tensors, data_start


def ggml_nbytes(gtype: int, shape: Tuple[int, ...]) -> int:
    """The bytes a tensor of ``gtype`` and ``shape`` takes in the file."""
    n = math.prod(shape)
    if gtype in _GGML_BLOCK:
        per, nbytes = _GGML_BLOCK[gtype]
        return n // per * nbytes
    if gtype in _GGML_PLAIN:
        return n * _GGML_PLAIN[gtype].itemsize
    raise _unsupported_type(gtype)


def dequantize_ggml(
    buf: Union[bytes, bytearray, memoryview, np.ndarray, torch.Tensor],
    gtype: int,
    shape: Tuple[int, ...],
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """A tensor's raw bytes -> a tensor of ``shape`` on ``device`` (the
    bytes' own device when None): F32, F16 and BF16 as they are, Q8_0 and
    Q4_0 in f32.  The product of the f16 scale and the int8 (Q8_0) or the
    nibble less 8 (Q4_0; byte j holds element j low and j + 16 high) is
    taken in f32, as the JAX package's numpy product is."""
    if gtype not in _GGML_BLOCK and gtype not in _GGML_PLAIN:
        raise _unsupported_type(gtype)
    if not isinstance(buf, torch.Tensor):
        arr = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) else buf
        if not arr.flags.writeable:
            arr = arr.copy()
        buf = torch.from_numpy(arr)
    raw = buf.view(torch.uint8).reshape(-1)
    if device is not None:
        raw = raw.to(device)
    size = ggml_nbytes(gtype, shape)
    raw = raw[:size]
    if gtype in _GGML_PLAIN:
        return raw.view(_GGML_PLAIN[gtype]).reshape(shape)
    per, nbytes = _GGML_BLOCK[gtype]
    blocks = raw.view(-1, nbytes)
    d = blocks[:, :2].contiguous().view(torch.float16).float()  # [B, 1]
    if gtype == GGML_Q8_0:
        q = blocks[:, 2:].contiguous().view(torch.int8).float()  # [B, 32]
    else:
        qs = blocks[:, 2:]  # [B, 16] nibble pairs
        q = torch.cat([qs & 0x0F, qs >> 4], dim=1).float() - 8.0  # [B, 32]
    return (q * d).reshape(shape)


def _unpermute_rope(w: torch.Tensor, n_head: int) -> torch.Tensor:
    """Invert convert_hf_to_gguf's q/k permutation (interleaved-rope rows
    back to HF rotate_half order).  ``w`` is [out, in]."""
    out, inn = w.shape
    return (
        w.reshape(n_head, out // n_head // 2, 2, inn)
        .transpose(1, 2)
        .reshape(out, inn)
    )


def _require_llama_arch(meta: Dict[str, Any], path: str) -> None:
    """First-party GGUF weights are llama-only: other architectures may
    share the ``blk.N`` tensor names but not llama.cpp's q/k rope
    permutation, so loading them would scramble attention silently."""
    arch = meta.get("general.architecture", "llama")
    if arch != "llama":
        raise ValueError(
            f"{path}: GGUF architecture {arch!r} unsupported for "
            f"first-party weights (llama only); use safetensors"
        )


class _GgufHFView:
    """A GGUF file's tensors under their HF names, each read from a memory
    map of the file and dequantized on ``device`` when asked for, so
    ``engine.weights.assemble_params`` consumes GGUF files unchanged."""

    _STATIC = {
        "token_embd.weight": "model.embed_tokens.weight",
        "output_norm.weight": "model.norm.weight",
        "output.weight": "lm_head.weight",
    }
    _BLK = {
        "attn_q.weight": "self_attn.q_proj.weight",
        "attn_k.weight": "self_attn.k_proj.weight",
        "attn_v.weight": "self_attn.v_proj.weight",
        "attn_output.weight": "self_attn.o_proj.weight",
        "ffn_gate.weight": "mlp.gate_proj.weight",
        "ffn_up.weight": "mlp.up_proj.weight",
        "ffn_down.weight": "mlp.down_proj.weight",
        "attn_norm.weight": "input_layernorm.weight",
        "ffn_norm.weight": "post_attention_layernorm.weight",
    }

    def __init__(self, path: str, n_head: int, n_kv_head: int, device: torch.device) -> None:
        self.path = path
        self.meta, self.tensors, self.data_start = read_gguf_tensors(path)
        _require_llama_arch(self.meta, path)
        self.n_head = n_head
        self.n_kv_head = n_kv_head
        self.device = device
        self._map = np.memmap(path, dtype=np.uint8, mode="c")
        self._by_hf: Dict[str, str] = {}
        for gname in self.tensors:
            hf = self._hf_name(gname)
            if hf is not None:
                self._by_hf[hf] = gname

    def _hf_name(self, gname: str) -> Optional[str]:
        if gname in self._STATIC:
            return self._STATIC[gname]
        if gname.startswith("blk."):
            _, idx, rest = gname.split(".", 2)
            mapped = self._BLK.get(rest)
            if mapped is not None:
                return f"model.layers.{idx}.{mapped}"
        return None

    def __contains__(self, hf_name: str) -> bool:
        return hf_name in self._by_hf

    def __getitem__(self, hf_name: str) -> torch.Tensor:
        gname = self._by_hf[hf_name]
        gtype, shape, offset = self.tensors[gname]
        start = self.data_start + offset
        raw = torch.from_numpy(self._map[start:start + ggml_nbytes(gtype, shape)])
        w = dequantize_ggml(raw, gtype, shape, self.device)
        if hf_name.endswith("q_proj.weight"):
            w = _unpermute_rope(w, self.n_head)
        elif hf_name.endswith("k_proj.weight"):
            w = _unpermute_rope(w, self.n_kv_head)
        return w


def gguf_model_config(path: str):
    """The ``ModelConfig`` of a GGUF file's metadata (llama architecture)."""
    from ..engine.config import ModelConfig

    meta, tensors, _ = read_gguf_tensors(path)
    _require_llama_arch(meta, path)
    p = "llama."
    n_head = int(meta[p + "attention.head_count"])
    n_kv = int(meta.get(p + "attention.head_count_kv", n_head))
    hidden = int(meta[p + "embedding_length"])
    vocab = meta.get(p + "vocab_size")
    if vocab is None:
        vocab = len(meta.get("tokenizer.ggml.tokens") or [])
    return ModelConfig(
        vocab_size=int(vocab),
        hidden_size=hidden,
        intermediate_size=int(meta[p + "feed_forward_length"]),
        num_layers=int(meta[p + "block_count"]),
        num_heads=n_head,
        num_kv_heads=n_kv,
        head_dim=int(meta.get(p + "attention.key_length", hidden // n_head)),
        rope_theta=float(meta.get(p + "rope.freq_base", 10000.0)),
        rms_norm_eps=float(meta.get(p + "attention.layer_norm_rms_epsilon", 1e-5)),
        max_position=int(meta.get(p + "context_length", 4096)),
        tie_word_embeddings="output.weight" not in tensors,
        dtype="bfloat16",
    )


def load_gguf_params(
    path: str,
    cfg,
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
    quantize: Optional[str] = None,
):
    """The engine's stacked parameters on ``device`` straight from a GGUF
    file, each tensor dequantized there as its layer lands (``quantize``
    as ``engine.weights.assemble_params`` takes it)."""
    from ..device import resolve_device
    from ..engine.weights import assemble_params

    device = resolve_device(device)
    view = _GgufHFView(path, cfg.num_heads, cfg.num_kv_heads, device)
    return assemble_params(view, cfg, device, dtype, quantize)
