"""CLIP byte-pair-encoding tokenizer (rs_ov/text/tokenizer.py), pure Python.

Reads the JAX package's ``bpe_simple_vocab_16e6.txt.gz`` merge table by
path (vocab 49408, context 77). Cleaning is one of ``get_clean_fn``'s
'lower' (the default), 'whitespace' and 'canonicalize'; ftfy repairs the
text first where it is installed, as in the JAX package. Overlong sequences
are cut to the context with EOT forced into the last slot, or reduced by one
of the token-dropping masks 'simple', 'random', 'shuffle' and 'syntax'
(nltk, imported when used), which draw from an explicit
``np.random.RandomState``.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import string

import numpy as np

try:
    import regex as _re  # \p{L} / \p{N} classes
except ImportError:  # the ASCII classes give the same tokens on ASCII text
    _re = None

try:
    import ftfy as _ftfy
except ImportError:
    _ftfy = None

__all__ = ["SimpleTokenizer", "tokenize", "BPE_PATH", "DEFAULT_CONTEXT_LENGTH",
           "get_clean_fn", "get_reduction_mask_fn", "random_mask_tokenize",
           "simple_mask_tokenize", "syntax_mask_tokenize"]

DEFAULT_CONTEXT_LENGTH = 77
BPE_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "rs_ov", "text", "bpe_simple_vocab_16e6.txt.gz")


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> dict:
    """Reversible byte -> printable-unicode mapping (GPT-2 scheme)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    if _ftfy is not None:
        text = _ftfy.fix_text(text)
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _canonicalize_text(text: str) -> str:
    """big_vision's canonicalisation: underscores to spaces, punctuation
    dropped, lower case, whitespace collapsed."""
    text = text.replace("_", " ").translate(str.maketrans("", "", string.punctuation))
    return _whitespace_clean(text.lower())


def get_clean_fn(kind: str):
    """'lower' | 'whitespace' | 'canonicalize' (rs_ov/text/tokenizer.py:92-101)."""
    if kind == "lower":
        return lambda t: _whitespace_clean(_basic_clean(t)).lower()
    if kind == "whitespace":
        return lambda t: _whitespace_clean(_basic_clean(t))
    if kind == "canonicalize":
        return lambda t: _canonicalize_text(_basic_clean(t))
    raise ValueError(f"Invalid clean function '{kind}'")


def random_mask_tokenize(encode_fn, texts, context_length, sot, eot, rng,
                         shuffle: bool = False) -> np.ndarray:
    """Keep a random subset of an overlong text's tokens, in order unless
    ``shuffle`` (rs_ov/text/tokenizer.py:94-113)."""
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = np.asarray(encode_fn(text), dtype=np.int32)
        if len(tokens) > context_length - 2:
            indices = rng.permutation(len(tokens))[:context_length - 2]
            if not shuffle:
                indices = np.sort(indices)
            tokens = tokens[indices]
        n = len(tokens)
        result[i, 0] = sot
        result[i, 1:n + 1] = tokens
        result[i, n + 1] = eot
    return result


def simple_mask_tokenize(encode_fn, texts, context_length, sot, eot, rng) -> np.ndarray:
    """Keep a random contiguous block of an overlong text's tokens."""
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = list(encode_fn(text))
        if len(tokens) > context_length - 2:
            num_keep = context_length - 2
            start = int(rng.randint(0, len(tokens) - num_keep + 1))
            tokens = tokens[start:start + num_keep]
        toks = [sot] + tokens + [eot]
        result[i, :len(toks)] = toks
    return result


def syntax_mask_tokenize(encode_fn, texts, context_length, sot, eot, rng=None) -> np.ndarray:
    """Keep words by part of speech, nouns first, then adjectives, verbs and
    the rest (nltk and its tagger data, imported here)."""
    del rng
    try:
        import nltk
    except ImportError as e:
        raise ImportError("syntax reduction masking needs nltk; use 'simple', 'random' "
                          "or 'shuffle' instead") from e

    def order(tag):
        for rank, prefix in enumerate(("NN", "JJ", "VB"), 1):
            if tag.startswith(prefix):
                return rank
        return 4

    new_texts = []
    for text in texts:
        words = nltk.tokenize.word_tokenize(text)
        tags = [order(t) for _, t in nltk.pos_tag(words)]
        keep = sorted(np.argsort(np.asarray(tags), kind="stable")[:context_length - 2])
        new_texts.append(" ".join(words[j] for j in keep))
    result = np.zeros((len(new_texts), context_length), dtype=np.int32)
    for i, text in enumerate(new_texts):
        toks = [sot] + list(encode_fn(text)) + [eot]
        if len(toks) > context_length:  # a word can give several BPE tokens
            toks = toks[:context_length]
            toks[-1] = eot
        result[i, :len(toks)] = toks
    return result


def get_reduction_mask_fn(kind: str):
    """Token-dropping strategy by name: 'simple', 'random', 'shuffle', 'syntax'."""
    if kind == "simple":
        return simple_mask_tokenize
    if kind == "random":
        return random_mask_tokenize
    if kind == "shuffle":
        return functools.partial(random_mask_tokenize, shuffle=True)
    if kind == "syntax":
        return syntax_mask_tokenize
    raise ValueError(f"Invalid reduction mask '{kind}' (known: simple, random, shuffle, syntax)")


class SimpleTokenizer:
    """``clean`` names the cleaning function, ``reduction_mask`` a
    token-dropping mask for overlong texts ('' cuts them); the masks draw
    from ``rng`` (a ``np.random.RandomState``, seeded 0 by default)."""

    def __init__(self, bpe_path: str = BPE_PATH,
                 context_length: int = DEFAULT_CONTEXT_LENGTH,
                 clean: str = "lower", reduction_mask: str = "",
                 rng: np.random.RandomState | None = None):
        self.byte_encoder = bytes_to_unicode()
        with gzip.open(bpe_path) as f:
            merges = f.read().decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        specials = ["<start_of_text>", "<end_of_text>"]
        vocab += specials
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._cache = {t: t for t in specials}
        words = r"[\p{L}]+|[\p{N}]" if _re is not None else r"[a-zA-Z]+|[0-9]"
        other = r"[^\s\p{L}\p{N}]+" if _re is not None else r"[^\sa-zA-Z0-9]+"
        self.pat = (_re or re).compile(
            "|".join(specials) + r"""|'s|'t|'re|'ve|'m|'ll|'d|""" + words + "|" + other,
            (_re or re).IGNORECASE)
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.vocab_size = len(self.encoder)
        self.sot_token_id = self.encoder["<start_of_text>"]
        self.eot_token_id = self.encoder["<end_of_text>"]
        self.context_length = context_length
        self.clean_fn = get_clean_fn(clean)
        self.reduction_fn = get_reduction_mask_fn(reduction_mask) if reduction_mask else None
        self.rng = rng if rng is not None else np.random.RandomState(0)

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda pr: self.bpe_ranks.get(pr, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        result = " ".join(word)
        self._cache[token] = result
        return result

    def encode(self, text: str) -> list[int]:
        tokens = []
        for token in self.pat.findall(self.clean_fn(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (bytearray(self.byte_decoder[c] for c in text)
                .decode("utf-8", errors="replace").replace("</w>", " "))

    def __call__(self, texts, context_length: int | None = None) -> np.ndarray:
        """int32 [n_texts, context_length], 0-padded."""
        if isinstance(texts, str):
            texts = [texts]
        n = context_length or self.context_length
        if self.reduction_fn is not None:
            return self.reduction_fn(self.encode, texts, n, self.sot_token_id,
                                     self.eot_token_id, rng=self.rng)
        result = np.zeros((len(texts), n), dtype=np.int32)
        for i, text in enumerate(texts):
            toks = [self.sot_token_id] + self.encode(text) + [self.eot_token_id]
            if len(toks) > n:
                toks = toks[:n]
                toks[-1] = self.eot_token_id
            result[i, :len(toks)] = toks
        return result


@functools.lru_cache(maxsize=1)
def _default_tokenizer() -> SimpleTokenizer:
    return SimpleTokenizer()


def tokenize(texts, context_length: int = DEFAULT_CONTEXT_LENGTH) -> np.ndarray:
    return _default_tokenizer()(texts, context_length)
