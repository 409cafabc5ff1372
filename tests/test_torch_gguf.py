"""The port's GGUF reader and loader (``dynamo_tpu_torch/llm/gguf.py``)
against the JAX package's ``llm/gguf.py``.

Every file is written here from seeded weights (``tests/test_gguf.py``'s
spec-conformant v3 writer and its llama.cpp Q8_0/Q4_0 quantizers and q/k
rope permutation): the tiny JAX model's ``init_params`` weights, each kind
of tensor in another ggml type, so one file carries F32, F16, BF16, Q8_0
and Q4_0 tensors.  Held exactly (bit for bit, no tolerance):

* metadata of every value type, and the bad-magic and old-version errors;
* ``dequantize_ggml`` of each of the five types;
* ``gguf_model_config``, field for field;
* ``load_gguf_params`` against the JAX loader's pytree through
  ``params_from_numpy``, in f32 and bf16, with and without ``output``
  (tied embeddings); its int8 load against ``quantize_params`` of the
  plain load, and its int8 data against the JAX ``quantize_params``;
* a K-quant tensor, a non-llama architecture and a missing key refused
  with the JAX messages;
* the GGUF draft leg of ``load_draft_model``, and ``resolve_model_path``
  taking a ``.gguf`` file;
* ``TorchEngine.from_pretrained`` on a GGUF-only directory: the JAX
  engine's greedy streams in f32 (both given the f32 config), and in the
  file's own bf16 the streams of the port's engine over the JAX loader's
  parameters.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import struct

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.model import init_params as jax_init_params
from dynamo_tpu.engine.quant import quantize_params as jax_quantize_params
from dynamo_tpu.llm import gguf as jax_gguf
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.quant import QUANT_KEYS, QuantizedTensor, quantize_params
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm import gguf
from dynamo_tpu_torch.spec.model_drafter import load_draft_model
from tests.test_gguf import (
    _T_ARRAY, _T_BOOL, _T_F32, _T_STRING, _T_U32, _kv, _permute_rope, _quant_q4_0,
    _quant_q8_0, _s, _write_gguf, _write_gguf_tensors,
)
from tests.test_torch_ops import _free_compiled_programs  # noqa: F401 (autouse)
from tests.test_torch_spec import collect, request, streams

F32, F16, Q4_0, Q8_0, BF16 = 0, 1, 2, 8, 30
# each tensor kind in another type: the five between them
TYPES = {
    "token_embd": F16, "output": Q8_0, "output_norm": F32,
    "attn_q": Q8_0, "attn_k": Q4_0, "attn_v": BF16, "attn_output": F32,
    "ffn_gate": Q4_0, "ffn_up": Q8_0, "ffn_down": F16,
    "attn_norm": F32, "ffn_norm": F32,
}
ENGINE = dict(max_batch_size=4, max_seq_len=96, page_size=4, num_pages=64,
              mixed_token_budget=16)
WAIT_S = 60
RUN_S = 180  # bound on any one asyncio.run: a hang fails its test, not the run

# a SentencePiece-style vocabulary for the tiny model's 256 ids: the
# specials, the ASCII byte pieces, then word pieces with scores
PIECES = (
    ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(128)]
    + ["▁"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]
    + ["▁" + chr(c) for c in range(ord("a"), ord("z") + 1)]
    + ["▁the", "▁fox", "▁hello", "▁world", "he", "llo", "or", "ld", "▁jumps",
       "▁over", "▁lazy", "▁dog", "▁quick", "▁brown", "▁a", "er", "in", "on"]
)


def tokenizer_meta(vocab: int) -> dict:
    pieces = PIECES + [f"▁w{i}" for i in range(vocab - len(PIECES))]
    scores = [0.0] * 3 + [-20.0] * 128 + [-float(len(p)) * 0.5 - i * 1e-3
                                         for i, p in enumerate(pieces[131:])]
    return {
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": pieces[:vocab],
        "tokenizer.ggml.scores": [float(s) for s in scores[:vocab]],
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.ggml.unknown_token_id": 0,
    }


def raw_bytes(arr: np.ndarray, gtype: int) -> bytes:
    arr = np.ascontiguousarray(arr, np.float32)
    if gtype == F32:
        return arr.tobytes()
    if gtype == F16:
        return arr.astype(np.float16).tobytes()
    if gtype == BF16:
        return arr.astype(ml_dtypes.bfloat16).view(np.uint16).tobytes()
    if gtype == Q8_0:
        return _quant_q8_0(arr)[0]
    if gtype == Q4_0:
        return _quant_q4_0(arr)[0]
    raise AssertionError(gtype)


def write_model_gguf(path: str, cfg, np_params, tied: bool = False, types=TYPES,
                     extra_meta=None) -> str:
    """A llama GGUF of the JAX parameter pytree (``[in, out]`` stacked
    leaves): HF ``[out, in]`` rows, q/k permuted as convert_hf_to_gguf
    does, each tensor in ``types[kind]``; with the tokenizer metadata."""
    lay = np_params["layers"]
    tensors = []

    def add(name, kind, arr):
        arr = np.ascontiguousarray(np.asarray(arr, np.float32))
        tensors.append((name, arr.shape, types[kind], raw_bytes(arr, types[kind])))

    add("token_embd.weight", "token_embd", np_params["embed"])
    add("output_norm.weight", "output_norm", np_params["final_norm"])
    if not tied:
        add("output.weight", "output", np.asarray(np_params["lm_head"]).T)
    for i in range(cfg.num_layers):
        add(f"blk.{i}.attn_q.weight", "attn_q",
            _permute_rope(np.asarray(lay["wq"][i]).T, cfg.num_heads))
        add(f"blk.{i}.attn_k.weight", "attn_k",
            _permute_rope(np.asarray(lay["wk"][i]).T, cfg.num_kv_heads))
        add(f"blk.{i}.attn_v.weight", "attn_v", np.asarray(lay["wv"][i]).T)
        add(f"blk.{i}.attn_output.weight", "attn_output", np.asarray(lay["wo"][i]).T)
        add(f"blk.{i}.ffn_gate.weight", "ffn_gate", np.asarray(lay["w_gate"][i]).T)
        add(f"blk.{i}.ffn_up.weight", "ffn_up", np.asarray(lay["w_up"][i]).T)
        add(f"blk.{i}.ffn_down.weight", "ffn_down", np.asarray(lay["w_down"][i]).T)
        add(f"blk.{i}.attn_norm.weight", "attn_norm", lay["input_norm"][i])
        add(f"blk.{i}.ffn_norm.weight", "ffn_norm", lay["post_norm"][i])
    meta = {
        "general.architecture": "llama",
        "general.alignment": 32,
        "llama.embedding_length": cfg.hidden_size,
        "llama.feed_forward_length": cfg.intermediate_size,
        "llama.block_count": cfg.num_layers,
        "llama.attention.head_count": cfg.num_heads,
        "llama.attention.head_count_kv": cfg.num_kv_heads,
        "llama.attention.key_length": cfg.head_dim,
        "llama.attention.layer_norm_rms_epsilon": cfg.rms_norm_eps,
        "llama.context_length": cfg.max_position,
        "llama.rope.freq_base": cfg.rope_theta,
        "llama.vocab_size": cfg.vocab_size,
        **tokenizer_meta(cfg.vocab_size),
        **(extra_meta or {}),
    }
    _write_gguf_tensors(path, meta, tensors)
    return path


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig.tiny()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def files(weights, tmp_path_factory):
    """An untied and a tied GGUF-only directory of the tiny model."""
    jcfg, np_params = weights
    out = {}
    for tied in (False, True):
        d = tmp_path_factory.mktemp("tied" if tied else "untied")
        out[tied] = write_model_gguf(str(d / "model.gguf"), jcfg, np_params, tied)
    return out


def _bits(a) -> np.ndarray:
    """Exact bits of a numpy array or a torch tensor, by dtype width."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        a = a.view(np.int16)
    return a.view({2: np.int16, 4: np.int32, 1: np.int8}[a.dtype.itemsize])


def _assert_leaf_equal(g, t, key) -> None:
    if isinstance(t, QuantizedTensor):
        assert isinstance(g, QuantizedTensor), key
        assert torch.equal(g.q, t.q) and torch.equal(g.s, t.s), key
    else:
        assert g.dtype == t.dtype and torch.equal(g, t), key


def _assert_params_equal(got, want):
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    for key in [k for k in want if k != "layers"]:
        _assert_leaf_equal(got[key], want[key], key)
    for key, t in want["layers"].items():
        _assert_leaf_equal(got["layers"][key], t, key)


# -- metadata -----------------------------------------------------------------


def test_metadata_round_trip_matches_jax(tmp_path):
    """Every scalar type, strings, arrays (nested too) and bools."""
    path = tmp_path / "meta.gguf"
    kvs = [
        _kv("general.architecture", _T_STRING, _s("llama")),
        _kv("u8", 0, struct.pack("<B", 200)),
        _kv("i8", 1, struct.pack("<b", -5)),
        _kv("u16", 2, struct.pack("<H", 65000)),
        _kv("i16", 3, struct.pack("<h", -300)),
        _kv("u32", _T_U32, struct.pack("<I", 4_000_000_000)),
        _kv("i32", 5, struct.pack("<i", -70000)),
        _kv("f32", _T_F32, struct.pack("<f", 0.1)),
        _kv("bool", _T_BOOL, b"\x00"),
        _kv("u64", 10, struct.pack("<Q", 2**40 + 3)),
        _kv("i64", 11, struct.pack("<q", -(2**40))),
        _kv("f64", 12, struct.pack("<d", 1e-300)),
        _kv("text", _T_STRING, _s("héllo ▁ 日本")),
        _kv("ints", _T_ARRAY, struct.pack("<IQ", _T_U32, 3) + struct.pack("<3I", 1, 2, 3)),
        _kv("nested", _T_ARRAY, struct.pack("<IQ", _T_ARRAY, 2)
            + struct.pack("<IQ", _T_STRING, 1) + _s("a")
            + struct.pack("<IQ", _T_F32, 2) + struct.pack("<2f", 1.5, -2.0)),
    ]
    _write_gguf(path, kvs)
    got = gguf.read_gguf_metadata(str(path))
    assert got == jax_gguf.read_gguf_metadata(str(path))
    assert got["u32"] == 4_000_000_000 and got["bool"] is False
    assert got["nested"] == [["a"], [1.5, -2.0]]


@pytest.mark.parametrize("blob, match", [
    (b"NOPE" + b"\x00" * 32, "not a GGUF file"),
    (struct.pack("<IIQQ", 0x46554747, 1, 0, 0), "GGUF version 1 unsupported"),
])
def test_bad_header_refused_as_jax(tmp_path, blob, match):
    p = tmp_path / "bad.gguf"
    p.write_bytes(blob)
    for mod in (gguf, jax_gguf):
        with pytest.raises(ValueError, match=match):
            mod.read_gguf_metadata(str(p))


def test_find_gguf_file(files, tmp_path):
    path = files[False]
    for arg in (path, os.path.dirname(path), str(tmp_path), str(tmp_path / "x.gguf")):
        assert gguf.find_gguf_file(arg) == jax_gguf.find_gguf_file(arg)
    assert gguf.find_gguf_file(os.path.dirname(path)) == path


# -- dequantization -----------------------------------------------------------


@pytest.mark.parametrize("gtype", [F32, F16, BF16, Q8_0, Q4_0],
                         ids=["F32", "F16", "BF16", "Q8_0", "Q4_0"])
def test_dequantize_matches_jax_bit_for_bit(gtype):
    rs = np.random.RandomState(gtype)
    w = rs.randn(6, 96).astype(np.float32) * np.float32(3.0)
    w[1, :32] = 0.0  # an all-zero block: scale 0
    w[2, 32:64] *= np.float32(1e-6)  # tiny scales
    raw = raw_bytes(w, gtype)
    want = jax_gguf.dequantize_ggml(raw, gtype, w.shape)
    got = gguf.dequantize_ggml(raw, gtype, w.shape)
    assert got.shape == want.shape
    if gtype == BF16:  # the JAX reader widens bf16 to f32 exactly
        got = got.float()
    assert np.array_equal(_bits(got), _bits(want))
    # from a tensor as from bytes
    t = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    assert torch.equal(gguf.dequantize_ggml(t, gtype, w.shape).float(),
                       torch.from_numpy(np.array(want, np.float32)))


def test_k_quant_refused_as_jax(tmp_path, weights):
    jcfg, np_params = weights
    for mod in (gguf, jax_gguf):
        with pytest.raises(ValueError, match="unsupported ggml tensor type 12"):
            mod.dequantize_ggml(b"\x00" * 144, 12, (1, 256))
    # a file whose ffn_down is Q4_K (type 12): refused by name at load
    path = write_model_gguf(str(tmp_path / "k.gguf"), jcfg, np_params)
    with open(path, "r+b") as f:
        data = f.read()
        name = b"blk.0.ffn_down.weight"
        at = data.index(name) + len(name) + 4 + 8 * 2  # n_dims, two dims
        f.seek(at)
        f.write(struct.pack("<I", 12))
    cfg = ModelConfig.from_pretrained(path)
    with pytest.raises(ValueError, match="unsupported ggml tensor type 12"):
        gguf.load_gguf_params(path, cfg, "cpu")


def test_other_architecture_and_missing_key_refused(tmp_path, weights):
    jcfg, np_params = weights
    path = write_model_gguf(str(tmp_path / "qwen.gguf"), jcfg, np_params,
                            extra_meta={"general.architecture": "qwen2"})
    for load in (gguf.gguf_model_config, jax_gguf.gguf_model_config):
        with pytest.raises(ValueError, match="GGUF architecture 'qwen2' unsupported"):
            load(path)
    with pytest.raises(ValueError, match="GGUF architecture 'qwen2' unsupported"):
        gguf.load_gguf_params(path, ModelConfig.tiny(), "cpu")
    # a file without llama.embedding_length: KeyError naming it, in both
    path = str(tmp_path / "nokey.gguf")
    write_model_gguf(path, jcfg, np_params)
    blob = open(path, "rb").read().replace(b"llama.embedding_length", b"llama.embedding_lengtX")
    open(path, "wb").write(blob)
    for load in (gguf.gguf_model_config, jax_gguf.gguf_model_config):
        with pytest.raises(KeyError, match="llama.embedding_length"):
            load(path)


# -- config and params ----------------------------------------------------------


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_model_config_matches_jax(files, tied):
    path = files[tied]
    got = gguf.gguf_model_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_gguf.gguf_model_config(path))
    assert got.tie_word_embeddings is tied and got.dtype == "bfloat16"
    # from the directory and from the file, through from_pretrained
    for arg in (path, os.path.dirname(path)):
        assert ModelConfig.from_pretrained(arg) == got


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_params_matches_jax_bit_for_bit(files, tied, dtype):
    path = files[tied]
    cfg = dataclasses.replace(gguf.gguf_model_config(path), dtype=dtype)
    jcfg = dataclasses.replace(jax_gguf.gguf_model_config(path), dtype=dtype)
    want = params_from_numpy(
        jax.tree.map(np.asarray, jax_gguf.load_gguf_params(path, jcfg)), cfg, device="cpu"
    )
    got = gguf.load_gguf_params(path, cfg, "cpu")
    assert ("lm_head" in got) is not tied
    _assert_params_equal(got, want)


def test_int8_load_matches_quantize_params(files):
    """``quantize="int8"`` quantizes each layer as it lands: the engine's
    ``quantize_params`` over it equals ``quantize_params`` over the plain
    load exactly, and the int8 data equals the JAX ``quantize_params`` over
    the JAX load (the bf16 scales within one bf16 step: each package takes
    ``amax / 127`` in its own f32 arithmetic)."""
    path = files[False]
    cfg = gguf.gguf_model_config(path)
    dtype = torch.bfloat16
    got = quantize_params(gguf.load_gguf_params(path, cfg, "cpu", quantize="int8"), dtype)
    assert isinstance(got["layers"]["wq"], QuantizedTensor)
    _assert_params_equal(got, quantize_params(gguf.load_gguf_params(path, cfg, "cpu"), dtype))
    jcfg = jax_gguf.gguf_model_config(path)
    jq = jax_quantize_params(jax_gguf.load_gguf_params(path, jcfg), jcfg)
    for key in QUANT_KEYS:
        want = jq["layers"][key]
        assert np.array_equal(got["layers"][key].q.numpy(), np.asarray(want.q)), key
        torch.testing.assert_close(
            got["layers"][key].s.float(),
            torch.from_numpy(np.asarray(want.s, np.float32)), atol=0, rtol=2.0**-8,
        )


# -- the draft leg and the engine ------------------------------------------------


def test_gguf_draft_loads(files):
    path = files[False]
    for arg in (path, os.path.dirname(path)):
        dcfg, dparams = load_draft_model(arg, "cpu")
        assert dcfg == gguf.gguf_model_config(path)
        _assert_params_equal(dparams, gguf.load_gguf_params(path, dcfg, "cpu"))


def serve(engine, reqs):
    async def run():
        try:
            return await asyncio.wait_for(
                asyncio.gather(*[collect(engine, r) for r in reqs]), WAIT_S
            )
        finally:
            await engine.stop()

    return asyncio.run(asyncio.wait_for(run(), RUN_S))


def test_from_pretrained_streams_match_jax(files):
    """A GGUF-only directory through both engines' ``from_pretrained``,
    each given the f32 config: the same greedy streams."""
    d = os.path.dirname(files[False])
    cfg = dataclasses.replace(ModelConfig.from_pretrained(d), dtype="float32")
    jcfg = dataclasses.replace(JaxModelConfig.from_pretrained(d), dtype="float32")
    rs = np.random.default_rng(5)
    reqs = [request(rs.integers(1, 256, n).tolist(), 8) for n in (5, 19, 33)]
    port = serve(TorchEngine.from_pretrained(
        d, EngineConfig(**ENGINE), device="cpu", model_cfg=cfg), reqs)
    ref = serve(JaxEngine.from_pretrained(d, JaxEngineConfig(**ENGINE), model_cfg=jcfg), reqs)
    assert streams(port) == streams(ref)
    assert [len(r["tokens"]) for r in port] == [8, 8, 8]


def test_from_pretrained_file_config_serves_jax_weights(files):
    """The file's own bf16 config (``--model-path M.gguf``): the port's
    engine from the file streams what it streams from the JAX loader's
    parameters.  (The two packages' bf16 trunks score in other precisions,
    ROADMAP's known mismatches, so bf16 streams are held within the port.)"""
    path = files[False]
    cfg = ModelConfig.from_pretrained(path)
    assert cfg.dtype == "bfloat16"
    want = params_from_numpy(jax.tree.map(np.asarray, jax_gguf.load_gguf_params(
        path, jax_gguf.gguf_model_config(path))), cfg, device="cpu")
    rs = np.random.default_rng(6)
    reqs = [request(rs.integers(1, 256, n).tolist(), 8) for n in (7, 30)]
    got = serve(TorchEngine.from_pretrained(path, EngineConfig(**ENGINE), device="cpu"), reqs)
    ref = serve(TorchEngine(cfg, want, EngineConfig(**ENGINE), device="cpu"), reqs)
    assert streams(got) == streams(ref)


def test_resolve_model_path_takes_a_gguf_file(files, tmp_path):
    """A ``.gguf`` file is returned unchanged, as the JAX package's
    ``resolve_model_path`` returns it; another file is refused by name."""
    from dynamo_tpu.llm.local_model import resolve_model_path as jax_resolve
    from dynamo_tpu_torch.llm.local_model import resolve_model_path

    path = files[False]
    assert resolve_model_path(path) == jax_resolve(path) == path
    other = tmp_path / "weights.bin"
    other.write_bytes(b"\0")
    for resolve in (resolve_model_path, jax_resolve):
        with pytest.raises(SystemExit, match="is a file but not a .gguf"):
            resolve(str(other))
