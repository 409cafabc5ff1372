"""Tokenizer: the JAX package's ``Tokenizer``/``DecodeStream`` interface,
read from ``tokenizer.json`` (or a GGUF file's metadata) in pure Python.

The JAX package runs the Rust ``tokenizers`` core; the card's machine has
neither that package nor ``regex``, so the port reads the same artifact
itself.  It covers the byte-level BPE family (GPT-2, Llama 3, Qwen) and
the SentencePiece-style BPE family (Llama 2, Mistral, Mixtral) in both of
its published forms:

* ``added_tokens``, cut out of the text before pre-tokenization (the
  non-normalized ones first, then the normalized ones), leftmost-longest,
  with their ``single_word``, ``lstrip`` and ``rstrip`` flags;
* the normalizers none, ``NFC``, ``Prepend``, ``Replace`` (string
  patterns) and ``Sequence``, applied to each stretch of text between
  non-normalized added tokens, as the Rust core does;
* the pre-tokenizers ``ByteLevel`` (``add_prefix_space``, ``use_regex``),
  ``Split`` (a string or regex pattern, behaviours ``Isolated`` and
  ``Removed``, ``invert``), ``Metaspace`` (``replacement``,
  ``prepend_scheme`` first/always/never, ``split``) and ``Sequence``;
* the ``BPE`` model, with merges as ``"a b"`` strings or ``[a, b]`` pairs,
  ``ignore_merges``, ``unk_token``, ``fuse_unk`` and ``byte_fallback``
  (a character outside the vocabulary becomes its UTF-8 bytes as
  ``<0xNN>`` tokens);
* the ``Unigram`` model (``vocab`` as ``[piece, score]`` pairs, ``unk_id``,
  ``byte_fallback``): the SentencePiece models of GGUF files
  (``llm/gguf.py`` writes their pipeline as this document);
* the post-processors ``TemplateProcessing``, ``ByteLevel`` and
  ``Sequence``;
* the decoders ``ByteLevel``, ``Metaspace``, ``Replace``,
  ``ByteFallback``, ``Fuse``, ``Strip`` and ``Sequence``,
  ``skip_special_tokens``, and the incremental ``DecodeStream`` of
  ``tokenizers.decoders``.

Any other component raises :class:`TokenizerError` naming it, so a file
this reader does not cover never tokenizes differently without saying so.

The split patterns use Unicode property classes (``\\p{L}``, ``\\p{N}``),
which Python's ``re`` lacks: :func:`translate_pattern` expands them, and
``\\s``/``\\S``, into explicit code-point classes built from
``unicodedata`` (the Unicode White_Space set for ``\\s``, as the Rust
core's regex engine has it, not Python's ``str.isspace``).
"""

from __future__ import annotations

import functools
import heapq
import json
import math
import os
import re
import sys
import unicodedata
from typing import Any, Dict, List, Optional, Sequence, Tuple


class TokenizerError(RuntimeError):
    pass


# -- byte-level alphabet -----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _byte_maps() -> Tuple[Dict[int, str], Dict[str, int]]:
    """GPT-2's reversible byte <-> printable character map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    to_char = {b: chr(c) for b, c in zip(bs, cs)}
    return to_char, {c: b for b, c in to_char.items()}


def _to_byte_level(text: str) -> str:
    to_char = _byte_maps()[0]
    return "".join(to_char[b] for b in text.encode("utf-8"))


# -- Unicode property classes for Python's re --------------------------------

# the Unicode White_Space property
_WHITESPACE = (
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005"
    "\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000"
)


@functools.lru_cache(maxsize=None)
def _category_ranges(prefix: str) -> str:
    """Class body (``a-b`` ranges, escaped) of every code point whose
    general category starts with ``prefix`` (``L`` letters, ``N``
    numbers, ``Lu`` ...)."""
    parts: List[str] = []
    start = prev = -1
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp)).startswith(prefix):
            if start < 0:
                start = cp
            prev = cp
        elif start >= 0:
            parts.append(_range(start, prev))
            start = -1
    if start >= 0:
        parts.append(_range(start, prev))
    return "".join(parts)


def _range(lo: int, hi: int) -> str:
    if lo == hi:
        return re.escape(chr(lo))
    return f"{re.escape(chr(lo))}-{re.escape(chr(hi))}"


def _ws_body() -> str:
    return "".join(re.escape(c) for c in _WHITESPACE)


def translate_pattern(pattern: str) -> str:
    """An Oniguruma-dialect split pattern (as ``tokenizer.json`` carries
    it) as a Python ``re`` pattern: ``\\p{X}``/``\\P{X}`` and ``\\s``/``\\S``
    expand to explicit classes, inside character classes and out."""
    out: List[str] = []
    i, n = 0, len(pattern)
    in_class = False
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            nxt = pattern[i + 1]
            if nxt in "pP" and i + 2 < n and pattern[i + 2] == "{":
                end = pattern.index("}", i + 3)
                prop = pattern[i + 3:end]
                if prop.startswith("Is") or "=" in prop or not prop[:1].isupper():
                    raise TokenizerError(f"unsupported regex property \\p{{{prop}}}")
                body = _category_ranges(prop)
                if not body:
                    raise TokenizerError(f"unsupported regex property \\p{{{prop}}}")
                if nxt == "P":
                    if in_class:
                        raise TokenizerError("\\P{...} inside a class is not supported")
                    out.append(f"[^{body}]")
                else:
                    out.append(body if in_class else f"[{body}]")
                i = end + 1
                continue
            if nxt in "sS":
                if nxt == "S" and in_class:
                    raise TokenizerError("\\S inside a class is not supported")
                body = _ws_body()
                if in_class:
                    out.append(body)
                else:
                    out.append(f"[{body}]" if nxt == "s" else f"[^{body}]")
                i += 2
                continue
            if nxt in "dDwWbB":
                raise TokenizerError(f"unsupported regex escape \\{nxt}")
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            i += 1
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            if i < n and pattern[i] == "]":  # a leading ] is literal
                out.append(r"\]")
                i += 1
            continue
        if c == "[" and in_class:
            raise TokenizerError("nested character classes are not supported")
        if c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    return "".join(out)


# -- pre-tokenizers ----------------------------------------------------------

# GPT-2's split pattern, the one ByteLevel(use_regex=True) applies
GPT2_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)


@functools.lru_cache(maxsize=None)
def _compiled(pattern: str) -> "re.Pattern[str]":
    return re.compile(translate_pattern(pattern))


def _split(text: str, regex: "re.Pattern[str]", behavior: str, invert: bool) -> List[str]:
    pieces: List[Tuple[str, bool]] = []
    prev = 0
    for m in regex.finditer(text):
        s, e = m.span()
        if s == e:
            continue
        if prev != s:
            pieces.append((text[prev:s], False))
        pieces.append((text[s:e], True))
        prev = e
    if prev != len(text):
        pieces.append((text[prev:], False))
    if invert:
        pieces = [(p, not hit) for p, hit in pieces]
    if behavior == "Isolated":
        return [p for p, _ in pieces if p]
    # Removed
    return [p for p, hit in pieces if p and not hit]


_PREPEND_SCHEMES = ("first", "always", "never")


def _metaspace(spec: Dict[str, Any], what: str) -> Tuple[str, str]:
    """A ``Metaspace`` component's replacement character and prepend
    scheme (the older files' ``add_prefix_space`` maps onto the scheme as
    the Rust core reads it)."""
    rep = spec.get("replacement", "\u2581")
    if not isinstance(rep, str) or len(rep) != 1:
        raise TokenizerError(f"unsupported Metaspace {what} replacement {rep!r}")
    scheme = spec.get("prepend_scheme")
    if scheme is None:
        scheme = "always" if spec.get("add_prefix_space", True) else "never"
    if scheme not in _PREPEND_SCHEMES:
        raise TokenizerError(f"unsupported Metaspace {what} prepend_scheme {scheme!r}")
    return rep, scheme


def _split_merged_with_next(text: str, delim: str) -> List[str]:
    """``text`` split before each ``delim`` (the delimiter opens the next
    piece: the Rust core's ``MergedWithNext``)."""
    out: List[str] = []
    start = 0
    for i, c in enumerate(text):
        if c == delim and i > start:
            out.append(text[start:i])
            start = i
    if start < len(text):
        out.append(text[start:])
    return out


class _PreTokenizer:
    """The ``pre_tokenizer`` of ``tokenizer.json`` as a list of steps:
    ``apply`` takes one added-token-free stretch of text and gives its
    pieces, mapped to the byte-level alphabet where a ByteLevel step says
    so.  ``at_start`` says whether the stretch begins the input text
    (Metaspace's ``first`` scheme prepends only there)."""

    def __init__(self, spec: Optional[Dict[str, Any]]) -> None:
        self.steps: List[Dict[str, Any]] = []
        self._flatten(spec)

    def _flatten(self, spec: Optional[Dict[str, Any]]) -> None:
        if spec is None:
            return
        kind = spec.get("type")
        if kind == "Sequence":
            for sub in spec.get("pretokenizers") or []:
                self._flatten(sub)
        elif kind == "ByteLevel":
            self.steps.append(spec)
            if spec.get("use_regex", True):
                # build the Unicode classes now, not on the first request
                _compiled(GPT2_PATTERN)
        elif kind == "Metaspace":
            rep, scheme = _metaspace(spec, "pre_tokenizer")
            self.steps.append(dict(spec, _rep=rep, _scheme=scheme))
        elif kind == "Split":
            behavior = spec.get("behavior")
            if behavior not in ("Isolated", "Removed"):
                raise TokenizerError(f"unsupported Split behavior {behavior!r}")
            pat = spec.get("pattern") or {}
            if "Regex" in pat:
                spec = dict(spec, _re=_compiled(pat["Regex"]))
            elif "String" in pat:
                spec = dict(spec, _re=re.compile(re.escape(pat["String"])))
            else:
                raise TokenizerError(f"unsupported Split pattern {pat!r}")
            self.steps.append(spec)
        else:
            raise TokenizerError(f"unsupported pre_tokenizer {kind!r}")

    def apply(self, text: str, at_start: bool = False) -> List[str]:
        # (piece, whether it begins the input text)
        pieces = [(text, at_start)]
        for step in self.steps:
            nxt: List[Tuple[str, bool]] = []
            kind = step["type"]
            for p, first in pieces:
                if kind == "ByteLevel":
                    if step.get("add_prefix_space", True) and not p.startswith(" "):
                        p = " " + p
                    subs = (
                        _split(p, _compiled(GPT2_PATTERN), "Isolated", False)
                        if step.get("use_regex", True)
                        else [p]
                    )
                    subs = [_to_byte_level(q) for q in subs]
                elif kind == "Metaspace":
                    rep, scheme = step["_rep"], step["_scheme"]
                    p = p.replace(" ", rep)
                    if not p.startswith(rep) and (
                        scheme == "always" or (scheme == "first" and first)
                    ):
                        p = rep + p
                    subs = _split_merged_with_next(p, rep) if step.get("split", True) else [p]
                else:
                    subs = _split(p, step["_re"], step["behavior"], bool(step.get("invert")))
                nxt.extend((q, first and k == 0) for k, q in enumerate(subs))
            pieces = nxt
        return [p for p, _ in pieces]


# -- BPE model ---------------------------------------------------------------


class _BPE:
    def __init__(self, spec: Dict[str, Any]) -> None:
        kind = spec.get("type")
        if kind != "BPE":
            raise TokenizerError(f"unsupported model {kind!r}")
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key):
                raise TokenizerError(f"unsupported BPE option {key}={spec[key]!r}")
        byte_fallback = spec.get("byte_fallback", False)
        if not isinstance(byte_fallback, bool):
            raise TokenizerError(f"unsupported BPE option byte_fallback={byte_fallback!r}")
        self.vocab: Dict[str, int] = dict(spec.get("vocab") or {})
        self.id_to_token: Dict[int, str] = {i: t for t, i in self.vocab.items()}
        self.unk_token: Optional[str] = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        # byte -> the id of its ``<0xNN>`` token, where the vocabulary has it
        self.byte_ids: Optional[Dict[int, int]] = None
        if byte_fallback:
            self.byte_ids = {
                b: self.vocab[f"<0x{b:02X}>"] for b in range(256) if f"<0x{b:02X}>" in self.vocab
            }
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges") or []):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            try:
                pair = (self.vocab[a], self.vocab[b])
                new = self.vocab[a + b]
            except KeyError as e:
                raise TokenizerError(f"merge {a!r} {b!r}: {e} is not in the vocabulary")
            self.merges.setdefault(pair, (rank, new))
        self._cache: Dict[str, List[int]] = {}

    def tokenize(self, word: str) -> List[int]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        if self.ignore_merges and word in self.vocab:
            out = [self.vocab[word]]
        else:
            out = self._merge(word)
        # the SentencePiece form's words are whole texts: cache short ones
        if len(self._cache) < 65536 and len(word) <= 256:
            self._cache[word] = out
        return out

    def _symbols(self, word: str) -> List[int]:
        """The word's characters as ids, before any merge: a character
        outside the vocabulary becomes its ``<0xNN>`` byte tokens (byte
        fallback, when every byte has one) or the unknown token, fused
        with the unknown characters next to it under ``fuse_unk``.  A
        pending unknown token waits past byte-fallback characters, as the
        Rust core's does."""
        ids: List[int] = []
        unk: Optional[int] = None
        for ch in word:
            tid = self.vocab.get(ch)
            if tid is not None:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(tid)
                continue
            if self.byte_ids is not None:
                raw = ch.encode("utf-8")
                if all(b in self.byte_ids for b in raw):
                    ids.extend(self.byte_ids[b] for b in raw)
                    continue
            if self.unk_token is not None:
                if self.unk_token not in self.vocab:
                    raise TokenizerError(f"unk_token {self.unk_token!r} is not in the vocabulary")
                if unk is not None and not self.fuse_unk:
                    ids.append(unk)
                unk = self.vocab[self.unk_token]
        if unk is not None:
            ids.append(unk)
        return ids

    def _merge(self, word: str) -> List[int]:
        """Apply the merges lowest rank first, the leftmost among equal
        ranks: the Rust core's priority queue over a linked list of
        symbols, so a whole-text word of thousands of characters merges
        in O(n log n)."""
        ids = self._symbols(word)
        n = len(ids)
        if n < 2:
            return ids
        merges = self.merges
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap: List[Tuple[int, int, int]] = []
        for i in range(n - 1):
            m = merges.get((ids[i], ids[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, i, new = heapq.heappop(heap)
            if not alive[i] or nxt[i] >= n:
                continue
            j = nxt[i]
            m = merges.get((ids[i], ids[j]))
            if m is None or m[1] != new:
                continue  # an expired entry
            ids[i] = new
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] < n:
                prv[nxt[j]] = i
            if prv[i] >= 0:
                m = merges.get((ids[prv[i]], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[i], m[1]))
            if nxt[i] < n:
                m = merges.get((new, ids[nxt[i]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], i, m[1]))
        return [t for t, a in zip(ids, alive) if a]


# -- Unigram model -----------------------------------------------------------

# the Rust core's penalty below the lowest piece score for an unknown
# character (K_UNK_PENALTY)
_UNK_PENALTY = 10.0
_MISSING = object()


class _Unigram:
    """The ``Unigram`` model (SentencePiece's, as the Rust core runs it):
    the segmentation of highest total score by Viterbi over the pieces
    that start at each character, found through a map of every piece's
    prefixes, so a long text costs its length times the longest match.  A
    character that begins no one-character piece also takes an unknown
    node scored ``min(scores) - 10``; consecutive unknown nodes fuse into
    one piece (the Rust core always fuses, whatever the file says).  A
    piece outside the vocabulary becomes its UTF-8 bytes as ``<0xNN>``
    pieces under ``byte_fallback`` when each byte has one, else
    ``unk_id``.  Duplicate pieces take their last id, as the core's map."""

    def __init__(self, spec: Dict[str, Any]) -> None:
        pairs = spec.get("vocab") or []
        pieces = [p for p, _ in pairs]
        self.scores: List[float] = [float(s) for _, s in pairs]
        self.vocab: Dict[str, int] = {p: i for i, p in enumerate(pieces)}
        self.id_to_token: Dict[int, str] = dict(enumerate(pieces))
        self.unk_id: Optional[int] = spec.get("unk_id")
        if self.unk_id is not None:
            if not pairs:
                raise TokenizerError("Unigram: the vocabulary is empty")
            if not 0 <= self.unk_id < len(pairs):
                raise TokenizerError(f"Unigram: unk_id {self.unk_id} is not in the vocabulary")
        byte_fallback = spec.get("byte_fallback", False)
        if not isinstance(byte_fallback, bool):
            raise TokenizerError(f"unsupported Unigram option byte_fallback={byte_fallback!r}")
        self.byte_fallback = byte_fallback
        self.unk_score = min(self.scores, default=math.inf) - _UNK_PENALTY
        self._prefixes: Optional[Dict[str, Optional[Tuple[int, float]]]] = None

    def _prefix_map(self) -> Dict[str, Optional[Tuple[int, float]]]:
        """Every proper prefix of a piece -> None, every piece -> its (id,
        score); built at the first encode."""
        if self._prefixes is None:
            pm: Dict[str, Optional[Tuple[int, float]]] = {}
            for p in self.vocab:
                for k in range(1, len(p)):
                    pm.setdefault(p[:k], None)
            for p, i in self.vocab.items():
                if p:
                    pm[p] = (i, self.scores[i])
            self._prefixes = pm
        return self._prefixes

    def _segment(self, text: str) -> List[str]:
        n = len(text)
        pm = self._prefix_map()
        best = [0.0] * (n + 1)
        start = [-1] * (n + 1)
        ids = [0] * (n + 1)
        for i in range(n):
            base = best[i]
            single = False
            j = i + 1
            while j <= n:
                hit = pm.get(text[i:j], _MISSING)
                if hit is _MISSING:
                    break
                if hit is not None:
                    cand = hit[1] + base
                    if start[j] < 0 or cand > best[j]:
                        best[j], start[j], ids[j] = cand, i, hit[0]
                    single = single or j == i + 1
                j += 1
            if not single:
                if self.unk_id is None:
                    raise TokenizerError("Unigram: an unknown character and no unk_id")
                cand = self.unk_score + base
                if start[i + 1] < 0 or cand > best[i + 1]:
                    best[i + 1], start[i + 1], ids[i + 1] = cand, i, self.unk_id
        out: List[str] = []
        fused: List[str] = []
        end = n
        while end > 0:
            s = start[end]
            if ids[end] == self.unk_id:
                fused.append(text[s:end])
            else:
                if fused:
                    out.append("".join(reversed(fused)))
                    fused = []
                out.append(text[s:end])
            end = s
        if fused:
            out.append("".join(reversed(fused)))
        out.reverse()
        return out

    def tokenize(self, word: str) -> List[int]:
        out: List[int] = []
        for piece in self._segment(word) if word else []:
            tid = self.vocab.get(piece)
            if tid is not None:
                out.append(tid)
                continue
            if self.byte_fallback:
                raw = [self.vocab.get(f"<0x{b:02X}>") for b in piece.encode("utf-8")]
                if all(t is not None for t in raw):
                    out.extend(raw)
                    continue
            if self.unk_id is None:
                raise TokenizerError(f"Unigram: piece {piece!r} is unknown and there is no unk_id")
            out.append(self.unk_id)
        return out


# -- added tokens ------------------------------------------------------------


# Other_Alphabetic code points outside the marks (the circled and squared
# Latin letters, category So): Alphabetic is L*, Nl and Other_Alphabetic
_OTHER_ALPHABETIC_SO = (
    (0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169), (0x1F170, 0x1F189),
)
_JOIN_CONTROL = "\u200c\u200d"


def _is_word_char(c: str) -> bool:
    """The Rust core's ``\\w``, which decides ``single_word`` boundaries:
    Unicode's word class (Alphabetic, every mark, Nd, Pc, Join_Control),
    not Python's ``isalnum`` (which takes No and leaves marks out)."""
    cat = unicodedata.category(c)
    if cat[0] in "LM" or cat in ("Nd", "Nl", "Pc") or c in _JOIN_CONTROL:
        return True
    if cat == "So":
        cp = ord(c)
        return any(lo <= cp <= hi for lo, hi in _OTHER_ALPHABETIC_SO)
    return False


class _AddedToken:
    __slots__ = ("id", "content", "special", "single_word", "lstrip", "rstrip", "normalized")

    def __init__(self, d: Dict[str, Any]) -> None:
        self.id = int(d["id"])
        self.content = d["content"]
        self.special = bool(d.get("special", False))
        self.single_word = bool(d.get("single_word", False))
        self.lstrip = bool(d.get("lstrip", False))
        self.rstrip = bool(d.get("rstrip", False))
        self.normalized = bool(d.get("normalized", not self.special))


class _AddedMatcher:
    """Leftmost-longest matching of a set of added tokens in a text."""

    def __init__(self, tokens: Sequence[_AddedToken]) -> None:
        self.by_content = {t.content: t for t in tokens}
        alts = sorted(self.by_content, key=len, reverse=True)
        self.regex = re.compile("|".join(re.escape(a) for a in alts)) if alts else None

    def split(self, text: str) -> List[Tuple[str, Optional[int]]]:
        """``text`` as pieces ``(text, None)`` and ``(token, id)``."""
        if self.regex is None or not text:
            return [(text, None)]
        out: List[Tuple[str, Optional[int]]] = []
        offset = 0
        for m in self.regex.finditer(text):
            start, stop = m.span()
            tok = self.by_content[m.group(0)]
            if tok.single_word:
                before = start > 0 and _is_word_char(text[start - 1])
                after = stop < len(text) and _is_word_char(text[stop])
                if before or after:
                    continue
            if tok.lstrip:
                j = start
                while j > 0 and text[j - 1].isspace():
                    j -= 1
                start = max(j, offset)
            if tok.rstrip:
                while stop < len(text) and text[stop].isspace():
                    stop += 1
            if offset < start:
                out.append((text[offset:start], None))
            out.append((text[start:stop], tok.id))
            offset = stop
        if offset != len(text):
            out.append((text[offset:], None))
        return out


# -- the tokenizer -----------------------------------------------------------


class _Core:
    """The parsed ``tokenizer.json``: encode and decode."""

    def __init__(self, spec: Dict[str, Any]) -> None:
        self.normalizers = _parse_normalizer(spec.get("normalizer"))
        self.pre = _PreTokenizer(spec.get("pre_tokenizer"))
        model = spec.get("model") or {}
        self.model = _Unigram(model) if model.get("type") == "Unigram" else _BPE(model)
        self.decoders = _parse_decoder(spec.get("decoder"))
        self.template = self._parse_post(spec.get("post_processor"))
        added = [_AddedToken(d) for d in spec.get("added_tokens") or []]
        self.added_by_id = {t.id: t for t in added}
        self.added_by_content = {t.content: t for t in added}
        self.special = {t.content for t in added if t.special}
        self.raw_matcher = _AddedMatcher([t for t in added if not t.normalized])
        self.norm_matcher = _AddedMatcher(
            [_normalized_copy(t, self.normalize) for t in added if t.normalized]
        )
        vocab = set(self.model.vocab) | set(self.added_by_content)
        self.vocab_size = len(vocab)

    def normalize(self, text: str) -> str:
        for step in self.normalizers:
            text = step(text)
        return text

    @staticmethod
    def _parse_post(spec: Optional[Dict[str, Any]]) -> Optional[List[Any]]:
        """The single-sequence template as a list of id lists and the
        marker ``None`` for the sequence itself (None: no template)."""
        if spec is None:
            return None
        kind = spec.get("type")
        if kind == "ByteLevel":
            return None
        if kind == "Sequence":
            found = None
            for sub in spec.get("processors") or []:
                t = _Core._parse_post(sub)
                if t is not None:
                    if found is not None:
                        raise TokenizerError("more than one TemplateProcessing")
                    found = t
            return found
        if kind != "TemplateProcessing":
            raise TokenizerError(f"unsupported post_processor {kind!r}")
        specials = spec.get("special_tokens") or {}
        out: List[Any] = []
        for piece in spec.get("single") or []:
            if "SpecialToken" in piece:
                out.append(list(specials[piece["SpecialToken"]["id"]]["ids"]))
            elif "Sequence" in piece:
                if piece["Sequence"]["id"] != "A":
                    raise TokenizerError("a single-sequence template may only use A")
                out.append(None)
            else:
                raise TokenizerError(f"unsupported template piece {piece!r}")
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        for k, (piece, tid) in enumerate(self.raw_matcher.split(text)):
            if tid is not None:
                ids.append(tid)
                continue
            # Metaspace's "first" scheme: only a stretch at offset 0
            at_start = k == 0
            piece = self.normalize(piece)
            for n, (sub, sid) in enumerate(self.norm_matcher.split(piece)):
                if sid is not None:
                    ids.append(sid)
                elif sub:
                    for word in self.pre.apply(sub, at_start and n == 0):
                        ids.extend(self.model.tokenize(word))
        if add_special_tokens and self.template is not None:
            out: List[int] = []
            for part in self.template:
                out.extend(ids if part is None else part)
            return out
        return ids

    def id_to_token(self, tid: int) -> Optional[str]:
        tok = self.added_by_id.get(tid)
        if tok is not None:
            return tok.content
        return self.model.id_to_token.get(tid)

    def token_to_id(self, token: str) -> Optional[int]:
        tok = self.added_by_content.get(token)
        if tok is not None:
            return tok.id
        return self.model.vocab.get(token)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        tokens: List[str] = []
        for tid in ids:
            tok = self.id_to_token(int(tid))
            if tok is None or (skip_special_tokens and tok in self.special):
                continue
            tokens.append(tok)
        for step in self.decoders:
            tokens = step(tokens)
        return "".join(tokens)


# -- normalizers and decoders ------------------------------------------------


def _parse_normalizer(spec: Optional[Dict[str, Any]]) -> List[Any]:
    """The ``normalizer`` as a list of str -> str steps."""
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [f for sub in spec.get("normalizers") or [] for f in _parse_normalizer(sub)]
    if kind == "NFC":
        return [functools.partial(unicodedata.normalize, "NFC")]
    if kind == "Prepend":
        prefix = spec["prepend"]
        return [lambda t: prefix + t if t else t]
    if kind == "Replace":
        old, new = _replace_pattern(spec, "normalizer"), spec["content"]
        return [lambda t: t.replace(old, new)]
    raise TokenizerError(f"unsupported normalizer {kind!r}")


def _replace_pattern(spec: Dict[str, Any], what: str) -> str:
    pat = spec.get("pattern") or {}
    if "String" not in pat:
        raise TokenizerError(f"unsupported Replace {what} pattern {pat!r}")
    return pat["String"]


def _byte_fallback(tokens: List[str]) -> List[str]:
    """Runs of ``<0xNN>`` tokens become the text of their bytes, or one
    U+FFFD per byte where the run is not valid UTF-8 (the Rust core's
    ``ByteFallback`` decoder)."""
    out: List[str] = []
    run = bytearray()

    def flush() -> None:
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("\ufffd" for _ in run)
            run.clear()

    for tok in tokens:
        byte = None
        if len(tok.encode("utf-8")) == 6 and tok.startswith("<0x") and tok.endswith(">"):
            digits = tok[3:5]
            if all(c in "0123456789abcdefABCDEF" for c in digits):
                byte = int(digits, 16)
        if byte is None:
            flush()
            out.append(tok)
        else:
            run.append(byte)
    flush()
    return out


def _byte_level_decode(tokens: List[str]) -> List[str]:
    from_char = _byte_maps()[1]
    buf = bytearray()
    for tok in tokens:
        try:
            buf.extend(from_char[c] for c in tok)
        except KeyError:
            buf.extend(tok.encode("utf-8"))
    return [buf.decode("utf-8", errors="replace")]


def _strip(content: str, start: int, stop: int):
    def step(tokens: List[str]) -> List[str]:
        out = []
        for tok in tokens:
            lo, hi = 0, len(tok)
            while lo < min(start, len(tok)) and tok[lo] == content:
                lo += 1
            while len(tok) - hi < stop and hi > lo and tok[hi - 1] == content:
                hi -= 1
            out.append(tok[lo:hi])
        return out

    return step


def _metaspace_decode(rep: str, scheme: str):
    def step(tokens: List[str]) -> List[str]:
        # the first token loses every replacement character, the others
        # turn them into spaces (unless nothing was ever prepended)
        return [
            tok.replace(rep, "" if i == 0 and scheme != "never" else " ")
            for i, tok in enumerate(tokens)
        ]

    return step


def _parse_decoder(spec: Optional[Dict[str, Any]]) -> List[Any]:
    """The ``decoder`` as a list of token-list -> token-list steps."""
    kind = None if spec is None else spec.get("type")
    if kind == "Sequence":
        return [f for sub in spec.get("decoders") or [] for f in _parse_decoder(sub)]
    if kind == "ByteLevel":
        return [_byte_level_decode]
    if kind == "ByteFallback":
        return [_byte_fallback]
    if kind == "Fuse":
        return [lambda tokens: ["".join(tokens)]]
    if kind == "Replace":
        old, new = _replace_pattern(spec, "decoder"), spec["content"]
        return [lambda tokens: [t.replace(old, new) for t in tokens]]
    if kind == "Strip":
        content = spec.get("content", " ")
        return [_strip(content, int(spec.get("start", 0)), int(spec.get("stop", 0)))]
    if kind == "Metaspace":
        return [_metaspace_decode(*_metaspace(spec, "decoder"))]
    raise TokenizerError(f"unsupported decoder {kind!r}")


def _normalized_copy(tok: _AddedToken, normalize) -> _AddedToken:
    """A normalized added token as the normalized text carries it (the
    Rust core matches the token's own content run through the
    normalizer)."""
    d = {s: getattr(tok, s) for s in _AddedToken.__slots__}
    d["content"] = normalize(tok.content)
    return _AddedToken(d)


class Tokenizer:
    """Encode/decode facade bound to one model's tokenizer artifact.

    Loads ``tokenizer.json`` (plus ``tokenizer_config.json`` for the chat
    template and special tokens) from a model directory or explicit file.
    """

    def __init__(
        self,
        core: _Core,
        *,
        chat_template: Optional[str] = None,
        eos_token: Optional[str] = None,
        bos_token: Optional[str] = None,
    ) -> None:
        self._core = core
        self.chat_template = chat_template
        self.eos_token = eos_token
        self.bos_token = bos_token

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_model_dir(cls, path: str) -> "Tokenizer":
        """``path``'s ``tokenizer.json`` (and ``tokenizer_config.json``),
        or, where there is no ``tokenizer.json`` or ``path`` is a ``.gguf``
        file, the tokenizer of its GGUF metadata (``gguf.gguf_tokenizer``),
        with the file's chat template and bos and eos tokens."""
        tok_file = os.path.join(path, "tokenizer.json") if os.path.isdir(path) else path
        if not os.path.exists(tok_file) or tok_file.endswith(".gguf"):
            from .gguf import find_gguf_file, gguf_tokenizer

            gguf_path = find_gguf_file(path)
            if gguf_path is not None:
                return gguf_tokenizer(gguf_path)[0]
            raise TokenizerError(f"no tokenizer.json or .gguf under {path}")
        with open(tok_file, encoding="utf-8") as f:
            core = _Core(json.load(f))
        chat_template = eos = bos = None
        cfg_file = os.path.join(path, "tokenizer_config.json")
        if os.path.isdir(path) and os.path.exists(cfg_file):
            with open(cfg_file, encoding="utf-8") as f:
                cfg = json.load(f)
            chat_template = cfg.get("chat_template")
            eos = _token_str(cfg.get("eos_token"))
            bos = _token_str(cfg.get("bos_token"))
        return cls(core, chat_template=chat_template, eos_token=eos, bos_token=bos)

    @classmethod
    def from_file(cls, tokenizer_json: str) -> "Tokenizer":
        with open(tokenizer_json, encoding="utf-8") as f:
            return cls(_Core(json.load(f)))

    @classmethod
    def from_str(cls, tokenizer_json: str) -> "Tokenizer":
        return cls(_Core(json.loads(tokenizer_json)))

    @classmethod
    def from_blobs(cls, tokenizer_json, config: Optional[dict] = None) -> "Tokenizer":
        """Build from in-memory artifacts (model-card transport: the card
        carries tokenizer.json and tokenizer_config.json through the hub's
        object store, no filesystem involved)."""
        if isinstance(tokenizer_json, bytes):
            tokenizer_json = tokenizer_json.decode()
        cfg = config or {}
        return cls(
            _Core(json.loads(tokenizer_json)),
            chat_template=cfg.get("chat_template"),
            eos_token=_token_str(cfg.get("eos_token")),
            bos_token=_token_str(cfg.get("bos_token")),
        )

    # -- special tokens ------------------------------------------------------

    @property
    def eos_token_ids(self) -> List[int]:
        if self.eos_token is None:
            return []
        tid = self._core.token_to_id(self.eos_token)
        return [tid] if tid is not None else []

    def token_to_id(self, token: str) -> Optional[int]:
        return self._core.token_to_id(token)

    @property
    def vocab_size(self) -> int:
        return self._core.vocab_size

    # -- encode/decode -------------------------------------------------------

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return self._core.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids: List[int], skip_special_tokens: bool = True) -> str:
        return self._core.decode(ids, skip_special_tokens=skip_special_tokens)

    def decode_stream(self, skip_special_tokens: bool = True) -> "DecodeStream":
        return DecodeStream(self._core, skip_special_tokens=skip_special_tokens)


class DecodeStream:
    """Incremental detokenizer: feed token ids one at a time, get back the
    text delta each id completes, or None while the text decoded so far
    ends in an incomplete UTF-8 sequence (the rule of
    ``tokenizers.decoders.DecodeStream``: a held prefix, the ids since it,
    and lengths compared in UTF-8 bytes)."""

    def __init__(self, core: _Core, skip_special_tokens: bool = True) -> None:
        self._core = core
        self._skip = skip_special_tokens
        self._ids: List[int] = []
        self._prefix = ""
        self._prefix_index = 0

    def step(self, token_id: int) -> Optional[str]:
        decode = self._core.decode
        if not self._prefix and self._ids:
            new_prefix = decode(self._ids, self._skip)
            if not new_prefix.endswith("�"):
                self._prefix = new_prefix
                self._prefix_index = len(self._ids)
        self._ids.append(int(token_id))
        text = decode(self._ids, self._skip)
        if len(text.encode("utf-8")) > len(self._prefix.encode("utf-8")) and not text.endswith("�"):
            if not text.startswith(self._prefix):
                raise TokenizerError("decode stream: the text no longer starts with its prefix")
            new_text = text[len(self._prefix):]
            new_index = len(self._ids) - self._prefix_index
            self._ids = self._ids[self._prefix_index:]
            self._prefix = decode(self._ids, self._skip)
            self._prefix_index = new_index
            return new_text
        return None


def _token_str(t) -> Optional[str]:
    """tokenizer_config.json encodes special tokens either as strings or as
    AddedToken dicts ({"content": ...})."""
    if t is None:
        return None
    if isinstance(t, str):
        return t
    if isinstance(t, dict):
        return t.get("content")
    return None
