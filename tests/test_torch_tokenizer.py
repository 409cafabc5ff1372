"""The port's pure-Python tokenizer against the Rust ``tokenizers`` core.

Byte-level BPE: three ``tokenizer.json`` files, the ``model_dir`` fixture's (a trained
byte-level BPE with ``<unk>``/``<s>``/``</s>`` specials), a Llama-3 shaped
one built here (``Sequence[Split(pattern, Isolated),
ByteLevel(use_regex=False)]``, ``ignore_merges``, merges written as
``[a, b]`` pairs, specials at the top of the vocabulary, a
``TemplateProcessing`` BOS), and the first with an NFC normalizer,
ByteLevel's prefix space, ``"a b"`` merges and added tokens with
``lstrip``/``rstrip``/``single_word``.  For every text of a fixed corpus and of a
``hypothesis`` strategy, encode ids, decode (with and without
``skip_special_tokens``) and the ``DecodeStream`` deltas, token by token,
must be equal exactly.

SentencePiece-style BPE (Llama 2, Mistral, Mixtral): a BPE made here,
its vocabulary laid out as those models' is (``<unk>``, ``<s>``, ``</s>``,
then the 256 ``<0xNN>`` byte tokens) with ``byte_fallback`` and
``fuse_unk``, a ``<s>`` template, and a small alphabet so that other text
falls back to bytes; written in the
older form (normalizer ``Sequence[Prepend("▁"), Replace(" ", "▁")]``, no
pre-tokenizer, decoder ``Sequence[Replace("▁", " "), ByteFallback, Fuse,
Strip(" ", 1, 0)]``) and in the newer one (pre-tokenizer and decoder
``Metaspace`` under each ``prepend_scheme``).  Encode, decode and the
stream are held to the Rust core the same way, where a stream that the
Rust core refuses (a byte run that rewrites its prefix) must be refused
too.

An unsupported component raises ``TokenizerError``.
"""

from __future__ import annotations

import json
import os
import string

import pytest
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st
from tokenizers import Regex
from tokenizers import Tokenizer as HFTokenizer
from tokenizers import decoders, models, pre_tokenizers, trainers
from tokenizers.decoders import DecodeStream as HFDecodeStream

from dynamo_tpu_torch.llm.tokenizer import Tokenizer, TokenizerError, translate_pattern

LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
LLAMA3_SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>"]

CORPUS = [
    "hello world",
    "Hello World! How are you doing today?",
    "don't you'll I'M they've she'd we're IT'S",
    "1 12 123 1234 12345 3.14159 1,000,000 x2y",
    "   leading spaces and trailing   ",
    "tabs\tand\nnew\n\nlines\r\n\r\nend",
    "café naïve résumé Ünïcödé façade",
    "日本語のテキストと中文字符",
    "emoji 😀👍🏽 family 👨‍👩‍👧 flags 🇫🇷",
    "mixed123abc ABC_def-ghi.jkl",
    "special <s>inside</s> text<unk>",
    "<|begin_of_text|>the start<|eot_id|> and <|end_of_text|>",
    "Ω≈ç√∫˜µ≤≥÷ ¡™£¢∞§¶•ªº–≠",
    " nbsp em　ideo",
    "",
    " ",
    "\n",
    "a",
    "٣٤٥ ¼½ Ⅷ",
    "the fox, foxes and a fox_ <mask>  x  <mask>y cafe\u0301! e\u0301!",
]

# Text drawn from scripts whose Unicode classes are old and stable (the
# Rust regex engine and Python's unicodedata may be on different Unicode
# versions for characters assigned recently).
ALPHABET = st.one_of(
    st.characters(min_codepoint=0x20, max_codepoint=0x7E),
    st.sampled_from(list("\t\n\r   　")),
    st.characters(min_codepoint=0xC0, max_codepoint=0x24F),
    st.characters(min_codepoint=0x391, max_codepoint=0x3C9),
    st.characters(min_codepoint=0x410, max_codepoint=0x44F),
    st.characters(min_codepoint=0x4E00, max_codepoint=0x4FFF),
    st.characters(min_codepoint=0x3040, max_codepoint=0x309F),
    st.characters(min_codepoint=0x1F600, max_codepoint=0x1F64F),
    st.sampled_from(["<s>", "</s>", "<unk>", "'s", "'LL", "123456", " <mask> ",
                     "fox", "e\u0301", "<|eot_id|>"]),
)


def _train(pre_tokenizer, specials, vocab_size):
    tok = HFTokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizer
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size,
        special_tokens=specials,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False,
    )
    tok.train_from_iterator(CORPUS * 3, trainer)
    return tok


@pytest.fixture(scope="module")
def llama3_json(tmp_path_factory) -> str:
    """A Llama-3 shaped tokenizer.json: ordinary tokens first, the
    specials at the top of the vocabulary, a BOS template."""
    split = pre_tokenizers.Split(
        pattern=Regex(LLAMA3_PATTERN),
        behavior="isolated",
    )
    pre = pre_tokenizers.Sequence(
        [split, pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)]
    )
    tok = _train(pre, [], 600)
    spec = json.loads(tok.to_str())
    vocab = spec["model"]["vocab"]
    top = max(vocab.values()) + 1
    spec["added_tokens"] = [
        {
            "id": top + i, "content": s, "single_word": False, "lstrip": False,
            "rstrip": False, "normalized": False, "special": True,
        }
        for i, s in enumerate(LLAMA3_SPECIALS)
    ]
    spec["model"]["ignore_merges"] = True
    spec["model"]["merges"] = [
        m.split(" ", 1) if isinstance(m, str) else m for m in spec["model"]["merges"]
    ]
    bos = LLAMA3_SPECIALS[0]
    spec["post_processor"] = {
        "type": "Sequence",
        "processors": [
            {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
             "use_regex": True},
            {
                "type": "TemplateProcessing",
                "single": [
                    {"SpecialToken": {"id": bos, "type_id": 0}},
                    {"Sequence": {"id": "A", "type_id": 0}},
                ],
                "pair": [
                    {"SpecialToken": {"id": bos, "type_id": 0}},
                    {"Sequence": {"id": "A", "type_id": 0}},
                    {"SpecialToken": {"id": bos, "type_id": 1}},
                    {"Sequence": {"id": "B", "type_id": 1}},
                ],
                "special_tokens": {bos: {"id": bos, "ids": [top], "tokens": [bos]}},
            },
        ],
    }
    path = tmp_path_factory.mktemp("llama3-tok") / "tokenizer.json"
    path.write_text(json.dumps(spec))
    return str(path)


@pytest.fixture(scope="module")
def flags_json(model_dir, tmp_path_factory) -> str:
    """The model_dir file with the options the other two leave out: an NFC
    normalizer, ByteLevel's prefix space, merges as ``"a b"`` strings, and
    added tokens with ``lstrip``/``rstrip`` and ``single_word``."""
    with open(os.path.join(model_dir, "tokenizer.json")) as f:
        spec = json.load(f)
    spec["normalizer"] = {"type": "NFC"}
    spec["pre_tokenizer"]["add_prefix_space"] = True
    spec["model"]["merges"] = [
        m if isinstance(m, str) else " ".join(m) for m in spec["model"]["merges"]
    ]
    top = max(spec["model"]["vocab"].values()) + 1
    spec["added_tokens"] += [
        {"id": top, "content": "<mask>", "single_word": False, "lstrip": True,
         "rstrip": True, "normalized": False, "special": True},
        {"id": top + 1, "content": "fox", "single_word": True, "lstrip": False,
         "rstrip": False, "normalized": True, "special": False},
        {"id": top + 2, "content": "é!", "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": True, "special": False},
    ]
    path = tmp_path_factory.mktemp("flags-tok") / "tokenizer.json"
    path.write_text(json.dumps(spec))
    return str(path)


FILES = ["model_dir", "llama3", "flags"]


@pytest.fixture(scope="module")
def pairs(model_dir, llama3_json, flags_json):
    """(name, HF tokenizer, port tokenizer) for each file."""
    out = []
    for name, path in (
        ("model_dir", os.path.join(model_dir, "tokenizer.json")),
        ("llama3", llama3_json),
        ("flags", flags_json),
    ):
        out.append((name, HFTokenizer.from_file(path), Tokenizer.from_file(path)))
    return out


def _check(hf: HFTokenizer, mine: Tokenizer, text: str) -> None:
    for add in (True, False):
        ids = hf.encode(text, add_special_tokens=add).ids
        assert mine.encode(text, add_special_tokens=add) == ids, (text, add)
    for skip in (True, False):
        assert mine.decode(ids, skip_special_tokens=skip) == hf.decode(
            ids, skip_special_tokens=skip
        ), (text, skip)
        ref = HFDecodeStream(skip_special_tokens=skip)
        got = mine.decode_stream(skip_special_tokens=skip)
        for tid in ids:
            assert got.step(tid) == ref.step(hf, tid), (text, skip, tid)


@pytest.mark.parametrize("which", FILES)
def test_corpus_matches_hf(pairs, which):
    _name, hf, mine = next(p for p in pairs if p[0] == which)
    assert mine.vocab_size == hf.get_vocab_size()
    for text in CORPUS:
        _check(hf, mine, text)


@pytest.mark.parametrize("which", FILES)
def test_random_text_matches_hf(pairs, which):
    _name, hf, mine = next(p for p in pairs if p[0] == which)

    @settings(max_examples=150, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(st.lists(ALPHABET, max_size=40).map("".join))
    @example("\u3099fox")
    def check(text):
        _check(hf, mine, text)

    check()


# ``single_word`` boundaries next to characters where Unicode's word class
# (the Rust core's ``\w``) and Python's ``isalnum`` differ: marks (Mn), the
# zero-width joiner, a connector (Pc), and digits of category No, before and
# after the token; the Rust core's ids on the ``flags`` file
BOUNDARY_CASES = [
    ("\u3099fox", [83, 0, 0, 0, 58, 179]),
    ("\u0301fox", [83, 0, 0, 58, 179]),
    ("\u200dfox", [83, 0, 0, 0, 58, 179]),
    ("\u203ffox", [83, 0, 0, 0, 58, 179]),
    ("\u00b2fox", [83, 0, 0, 284]),
    ("\u00bcfox", [83, 0, 0, 284]),
    ("fox\u00b2", [284, 83, 0, 0]),
]


@pytest.mark.parametrize("text,ids", BOUNDARY_CASES)
def test_single_word_boundaries_match_hf(pairs, text, ids):
    _name, hf, mine = next(p for p in pairs if p[0] == "flags")
    assert hf.encode(text, add_special_tokens=False).ids == ids
    assert mine.encode(text, add_special_tokens=False) == ids
    _check(hf, mine, text)


@pytest.mark.parametrize("which", FILES)
def test_random_ids_decode_like_hf(pairs, which):
    """Any id sequence, out-of-vocabulary ids and byte-partial pieces
    included, decodes and streams as the Rust core does."""
    _name, hf, mine = next(p for p in pairs if p[0] == which)
    n = hf.get_vocab_size()

    @settings(max_examples=150, deadline=None)
    @given(st.lists(st.integers(0, n + 5), max_size=30))
    def check(ids):
        for skip in (True, False):
            assert mine.decode(ids, skip_special_tokens=skip) == hf.decode(
                ids, skip_special_tokens=skip
            )
            ref = HFDecodeStream(skip_special_tokens=skip)
            got = mine.decode_stream(skip_special_tokens=skip)
            for tid in ids:
                assert got.step(tid) == ref.step(hf, tid)

    check()


def test_token_lookup_and_model_dir(model_dir):
    hf = HFTokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))
    mine = Tokenizer.from_model_dir(model_dir)
    for tok in ("<s>", "</s>", "<unk>", "the", "Ġthe", "nope-not-a-token"):
        assert mine.token_to_id(tok) == hf.token_to_id(tok)
    assert mine.eos_token == "</s>" and mine.bos_token == "<s>"
    assert mine.eos_token_ids == [hf.token_to_id("</s>")]
    assert "message" in mine.chat_template


def test_translated_classes():
    """The translated patterns split as the ``regex`` package (which has
    the property classes natively) does, and ``\\s`` is the Unicode
    White_Space set."""
    import re

    import regex

    text = "aé日 ٣4  x!? don't\tDON'T 12345\r\n\r\n ½ Ⅷ"
    for pattern in (LLAMA3_PATTERN, r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                    r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"):
        assert re.findall(translate_pattern(pattern), text) == regex.findall(pattern, text)
    # \x1c is whitespace to Python's str.isspace but not to Unicode's
    # White_Space property, which the Rust engine's \s follows
    assert not re.fullmatch(translate_pattern(r"\s"), "\x1c")


# -- the SentencePiece-style family ------------------------------------------

SP_FORMS = ["legacy", "first", "always", "never"]


def sentencepiece_json(form: str) -> str:
    """A SentencePiece-style ``tokenizer.json``: ``legacy`` is the older
    form, the others the newer form under that ``prepend_scheme``.  Made
    by hand, so every call gives the same file: the specials, the 256
    byte tokens, ``▁`` and a small alphabet (letters, digits and a little
    punctuation: anything else falls back to bytes), then each corpus
    word merged character by character."""
    specials = ("<unk>", "<s>", "</s>")
    vocab = {s: i for i, s in enumerate(specials)}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    alphabet = ["\u2581"] + sorted(set(string.ascii_letters + string.digits + ".,!?'"))
    for c in alphabet:
        vocab[c] = len(vocab)
    merges = []
    for text in CORPUS:
        for word in text.split():
            w = "\u2581" + word
            if not set(w) <= set(alphabet):
                continue
            for k in range(1, len(w)):
                a, b = w[:k], w[k]
                if a + b not in vocab:
                    merges.append([a, b])
                    vocab[a + b] = len(vocab)
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }
    spec["added_tokens"] = [
        {"id": vocab[s], "content": s, "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": False, "special": True}
        for s in specials
    ]
    bos = {"SpecialToken": {"id": "<s>", "type_id": 0}}
    spec["post_processor"] = {
        "type": "TemplateProcessing",
        "single": [bos, {"Sequence": {"id": "A", "type_id": 0}}],
        "pair": [bos, {"Sequence": {"id": "A", "type_id": 0}}, bos,
                 {"Sequence": {"id": "B", "type_id": 1}}],
        "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}},
    }
    if form == "legacy":
        spec["normalizer"] = {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "\u2581"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "\u2581"},
        ]}
        spec["pre_tokenizer"] = None
        spec["decoder"] = {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "\u2581"}, "content": " "},
            {"type": "ByteFallback"},
            {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0},
        ]}
    else:
        meta = {"type": "Metaspace", "replacement": "\u2581", "prepend_scheme": form,
                "split": True}
        spec["normalizer"] = None
        spec["pre_tokenizer"] = meta
        spec["decoder"] = meta
    return json.dumps(spec)


@pytest.fixture(scope="module")
def sp_pairs():
    """(HF tokenizer, port tokenizer) for each SentencePiece-style form."""
    return {
        form: (HFTokenizer.from_str(sentencepiece_json(form)),
               Tokenizer.from_str(sentencepiece_json(form)))
        for form in SP_FORMS
    }


def _stream_step(step):
    """A stream step's delta, or the marker that it refused."""
    try:
        return step()
    except Exception:
        return "<refused>"


def _check_sp(hf: HFTokenizer, mine: Tokenizer, text: str, ids=None) -> None:
    """As ``_check``, for ids that may not form text (byte runs cut
    short): where the Rust stream refuses a step, the port's refuses too,
    and both streams end there."""
    if ids is None:
        for add in (True, False):
            ids = hf.encode(text, add_special_tokens=add).ids
            assert mine.encode(text, add_special_tokens=add) == ids, (text, add)
    for skip in (True, False):
        assert mine.decode(ids, skip_special_tokens=skip) == hf.decode(
            ids, skip_special_tokens=skip
        ), (text, ids, skip)
        ref = HFDecodeStream(skip_special_tokens=skip)
        got = mine.decode_stream(skip_special_tokens=skip)
        for tid in ids:
            want = _stream_step(lambda: ref.step(hf, tid))
            assert _stream_step(lambda: got.step(tid)) == want, (text, ids, skip, tid)
            if want == "<refused>":
                break


SP_CORPUS = CORPUS + [
    "a<s>b </s> c",
    "  two  spaces ",
    "héllo wörld 😀",
    "<unk>z and ß",
    "\u2581already\u2581metaspaced",
]


@pytest.mark.parametrize("form", SP_FORMS)
def test_sentencepiece_corpus_matches_hf(sp_pairs, form):
    hf, mine = sp_pairs[form]
    assert mine.vocab_size == hf.get_vocab_size()
    for text in SP_CORPUS:
        _check_sp(hf, mine, text)
    # byte fallback fires: a character outside the alphabet is its bytes
    assert mine.encode("😀", add_special_tokens=False)[-4:] == [
        3 + b for b in "😀".encode("utf-8")
    ]


@pytest.mark.parametrize("form", SP_FORMS)
def test_sentencepiece_random_text_matches_hf(sp_pairs, form):
    hf, mine = sp_pairs[form]

    @settings(max_examples=150, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(st.lists(ALPHABET, max_size=40).map("".join))
    def check(text):
        _check_sp(hf, mine, text)

    check()


@pytest.mark.parametrize("form", SP_FORMS)
def test_sentencepiece_random_ids_decode_like_hf(sp_pairs, form):
    """Any id sequence, byte tokens that form no character included."""
    hf, mine = sp_pairs[form]
    n = hf.get_vocab_size()

    @settings(max_examples=150, deadline=None)
    @given(st.lists(st.one_of(st.integers(0, n + 5), st.integers(3, 258)), max_size=30))
    def check(ids):
        _check_sp(hf, mine, "", ids)

    check()


def test_sentencepiece_long_text_merges_fast(sp_pairs):
    """The older form hands the BPE model the whole text as one word: a
    prompt of thousands of characters must still encode as the Rust core
    does, and in well under a second."""
    import time

    hf, mine = sp_pairs["legacy"]
    text = " ".join(CORPUS[:10]) * 12
    t0 = time.perf_counter()
    ids = mine.encode(text)
    assert time.perf_counter() - t0 < 2.0
    assert ids == hf.encode(text).ids


@pytest.mark.parametrize(
    "edit, name",
    [
        (lambda s: s.__setitem__("normalizer", {"type": "NFKC"}), "NFKC"),
        (lambda s: s.__setitem__("pre_tokenizer", {"type": "Metaspace", "replacement": "▁",
                                                   "prepend_scheme": "sometimes"}), "Metaspace"),
        (lambda s: s["model"].__setitem__("byte_fallback", "yes"), "byte_fallback"),
        (lambda s: s["model"].__setitem__("type", "WordPiece"), "WordPiece"),
        (lambda s: s.__setitem__("decoder", {"type": "CTC"}), "CTC"),
        (lambda s: s.__setitem__("decoder", {"type": "Metaspace", "replacement": "▁▁"}), "Metaspace"),
        (lambda s: s.__setitem__("post_processor", {"type": "BertProcessing"}), "BertProcessing"),
    ],
)
def test_unsupported_component_raises(model_dir, edit, name):
    with open(os.path.join(model_dir, "tokenizer.json")) as f:
        spec = json.load(f)
    edit(spec)
    with pytest.raises(TokenizerError, match=name):
        Tokenizer.from_str(json.dumps(spec))
