"""The port's Unigram model and GGUF tokenizers (``llm/tokenizer.py``,
``llm/gguf.py``) against the Rust ``tokenizers`` core, through the JAX
package's ``gguf_tokenizer`` on the same files.

* A ``llama`` (SentencePiece) GGUF tokenizer of pieces and scores drawn
  from a corpus, with the 256 ``<0xNN>`` byte pieces, ``unk``, a chat
  template and bos; and one without byte pieces and without an unknown-id
  key (unknown characters fuse into id 0) and without bos.  The port's
  ``tokenizer.json`` document of each equals the one the Rust core
  serializes.
* A ``gpt2`` GGUF tokenizer: a trained byte-level BPE's tokens and merges.
* ``tokenizer.json`` files whose model is ``Unigram`` (with and without
  byte fallback) behind a ``Metaspace`` pre-tokenizer and decoder.

For each, over a fixed corpus (unknown characters, emoji, CJK, runs of
spaces, leading spaces, specials in the text) and a ``hypothesis``
strategy: encode ids with and without special tokens, decode with and
without ``skip_special_tokens`` and the ``DecodeStream`` deltas token by
token must be equal exactly.  A long prompt over a 32000-piece vocabulary
encodes like the Rust core's, in well under a second.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import string
import time

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import Tokenizer as HFTokenizer
from tokenizers import decoders, models, pre_tokenizers

from dynamo_tpu.llm import gguf as jax_gguf
from dynamo_tpu.llm.tokenizer import Tokenizer as JaxTokenizer
from dynamo_tpu_torch.llm import gguf
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from tests.test_gguf import _write_gguf_tensors
from tests.test_torch_tokenizer import ALPHABET, CORPUS, _check_sp, _train

UNIGRAM_CORPUS = CORPUS + [
    "  two  spaces ",
    "    four leading",
    "trailing    ",
    "a<s>b </s> c <unk> d",
    "▁already▁metaspaced",
    "héllo wörld 😀 ß",
    "中文字符 and 日本語",
    "quickbrownfox" * 5,
    "\x00\x01 control \x7f",
]
TEMPLATE = "{% for m in messages %}[INST] {{ m['content'] }} [/INST]{% endfor %}"


def _pieces(corpus, byte_pieces: bool, limit: int):
    """SentencePiece-style pieces of the corpus: the specials, the byte
    pieces, ``▁``, every character, then ``▁``-led word prefixes and
    in-word substrings by frequency, scored by log frequency."""
    counts = {}
    for text in corpus:
        for word in text.split():
            w = "▁" + word
            for i in range(len(w)):
                for j in range(i + 2, min(len(w), i + 7) + 1):
                    counts[w[i:j]] = counts.get(w[i:j], 0) + 1
    chars = sorted({c for text in corpus for c in text if not c.isspace()} - set("😀👍🏽"))
    # (the emoji stay out of the single characters: byte fallback for them)
    pieces = ["<unk>", "<s>", "</s>"]
    if byte_pieces:
        pieces += [f"<0x{b:02X}>" for b in range(256)]
    scores = [0.0] * len(pieces)
    for c in ["▁"] + chars:
        if c not in pieces:
            pieces.append(c)
            scores.append(-12.0)
    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    seen = set(pieces)
    for piece, n in ranked[: limit - len(pieces)]:
        if piece not in seen:
            seen.add(piece)
            pieces.append(piece)
            scores.append(math.log(n) - len(piece) * 0.25 - 8.0)
    # past the corpus's own: letter pairs and triples, ``▁``-led and not
    letters = string.ascii_lowercase
    extra = ("".join(p) for k in (2, 3) for p in itertools.product(letters, repeat=k))
    for piece in (w for e in extra for w in ("▁" + e, e)):
        if len(pieces) >= limit:
            break
        if piece not in seen:
            seen.add(piece)
            pieces.append(piece)
            scores.append(-len(piece) * 0.75 - 10.0 - len(pieces) * 1e-6)
    return pieces, scores


def _llama_gguf(path: str, byte_pieces: bool = True, unk: bool = True,
                add_bos=None, limit: int = 3000) -> str:
    pieces, scores = _pieces(UNIGRAM_CORPUS * 2, byte_pieces, limit)
    meta = {
        "general.architecture": "llama",
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": pieces,
        "tokenizer.ggml.scores": scores,
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.chat_template": TEMPLATE,
    }
    if unk:
        meta["tokenizer.ggml.unknown_token_id"] = 0
    if add_bos is not None:
        meta["tokenizer.ggml.add_bos_token"] = add_bos
    _write_gguf_tensors(path, meta, [])
    return path


def _gpt2_gguf(path: str) -> str:
    hf = _train(pre_tokenizers.ByteLevel(add_prefix_space=False), ["<|bos|>", "<|eos|>"], 500)
    spec = json.loads(hf.to_str())
    vocab = spec["model"]["vocab"]
    tokens = [t for t, _ in sorted(vocab.items(), key=lambda kv: kv[1])]
    merges = [m if isinstance(m, str) else " ".join(m) for m in spec["model"]["merges"]]
    meta = {
        "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.merges": merges,
        "tokenizer.ggml.bos_token_id": vocab["<|bos|>"],
        "tokenizer.ggml.eos_token_id": vocab["<|eos|>"],
    }
    _write_gguf_tensors(path, meta, [])
    return path


def _unigram_json(byte_fallback: bool) -> str:
    pieces, scores = _pieces(UNIGRAM_CORPUS, True, 2000)
    hf = HFTokenizer(models.Unigram(list(zip(pieces, scores)), unk_id=0,
                                    byte_fallback=byte_fallback))
    hf.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="first")
    hf.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="first")
    hf.add_special_tokens(["<s>", "</s>"])
    return hf.to_str()


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """name -> (the Rust core's tokenizer, the port's)."""
    out = {}
    for name, write in (
        ("llama", _llama_gguf),
        ("llama-nobytes-nounk", lambda p: _llama_gguf(p, False, False, False)),
        ("gpt2", _gpt2_gguf),
    ):
        path = write(str(tmp_path_factory.mktemp(name) / "model.gguf"))
        out[name] = (jax_gguf.gguf_tokenizer(path)[0], gguf.gguf_tokenizer(path)[0], path)
    for fb in (True, False):
        doc = _unigram_json(fb)
        out[f"json-fallback-{fb}"] = (HFTokenizer.from_str(doc), Tokenizer.from_str(doc), None)
    return out


NAMES = ["llama", "llama-nobytes-nounk", "gpt2", "json-fallback-True", "json-fallback-False"]
GGUF_NAMES = NAMES[:3]


@pytest.mark.parametrize("name", GGUF_NAMES)
def test_document_equals_the_rust_cores(pairs, name):
    hf, _, path = pairs[name]
    spec, info = gguf.gguf_tokenizer_spec(path)
    assert spec == json.loads(hf.to_str())
    assert info == jax_gguf.gguf_tokenizer(path)[1]


@pytest.mark.parametrize("name", NAMES)
def test_corpus_matches_rust_core(pairs, name):
    hf, mine, _ = pairs[name]
    assert mine.vocab_size == hf.get_vocab_size()
    for text in UNIGRAM_CORPUS:
        _check_sp(hf, mine, text)


@pytest.mark.parametrize("name", NAMES)
def test_random_text_matches_rust_core(pairs, name):
    hf, mine, _ = pairs[name]

    @settings(max_examples=120, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(st.lists(ALPHABET, max_size=40).map("".join))
    def check(text):
        _check_sp(hf, mine, text)

    check()


def test_byte_fallback_and_fused_unknowns(pairs):
    _, mine, _ = pairs["llama"]
    # a character no piece holds
    ids = mine.encode("🦀", add_special_tokens=False)
    assert [mine._core.id_to_token(i) for i in ids][-4:] == [
        f"<0x{b:02X}>" for b in "🦀".encode("utf-8")
    ]
    _, bare, _ = pairs["llama-nobytes-nounk"]
    # no byte pieces: a run of unknown characters is one id 0; no bos
    assert bare.encode("a🦀🦀b") == bare.encode("a🦀b")
    assert bare.encode("🦀🦀🦀").count(0) == 1 and bare.encode("x")[0] != 1


def test_model_dir_and_file_carry_gguf_specials(pairs, tmp_path):
    _, _, path = pairs["llama"]
    for arg in (path, os.path.dirname(path)):
        tok = Tokenizer.from_model_dir(arg)
        ref = JaxTokenizer.from_model_dir(arg)
        assert (tok.eos_token, tok.bos_token) == (ref.eos_token, ref.bos_token) == ("</s>", "<s>")
        assert tok.eos_token_ids == ref.eos_token_ids == [2]
        assert tok.chat_template == ref.chat_template == TEMPLATE
        text = "the quick brown fox 😀"
        assert tok.encode(text) == ref.encode(text) and tok.encode(text)[0] == 1
    with pytest.raises(Exception, match="no tokenizer.json or .gguf"):
        Tokenizer.from_model_dir(str(tmp_path))


def test_long_prompt_over_32000_pieces_is_fast(tmp_path):
    """A 32000-piece vocabulary (Llama 2's and Mistral's size): a prompt of
    some 12000 characters encodes as the Rust core does, in well under a
    second once the piece map is built."""
    path = _llama_gguf(str(tmp_path / "big.gguf"), limit=32000)
    hf = jax_gguf.gguf_tokenizer(path)[0]
    mine = gguf.gguf_tokenizer(path)[0]
    assert mine.vocab_size == hf.get_vocab_size() and mine.vocab_size > 20000
    mine.encode("warm up")
    text = " ".join(UNIGRAM_CORPUS) * 8
    t0 = time.perf_counter()
    ids = mine.encode(text)
    assert time.perf_counter() - t0 < 1.0
    assert ids == hf.encode(text).ids
