"""CLIP byte-pair-encoding tokenizer (rs_ov/text/tokenizer.py), pure Python.

Reads the JAX package's ``bpe_simple_vocab_16e6.txt.gz`` merge table by
path (vocab 49408, context 77). Cleaning is HTML-unescape, whitespace
collapse and lower-casing; overlong sequences are cut to the context with
EOT forced into the last slot.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re

import numpy as np

try:
    import regex as _re  # \p{L} / \p{N} classes
except ImportError:  # the ASCII classes give the same tokens on ASCII text
    _re = None

__all__ = ["SimpleTokenizer", "tokenize", "BPE_PATH"]

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


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text)).strip()
    return re.sub(r"\s+", " ", text).strip().lower()


class SimpleTokenizer:
    def __init__(self, bpe_path: str = BPE_PATH, context_length: int = 77):
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
        self.sot_token_id = self.encoder["<start_of_text>"]
        self.eot_token_id = self.encoder["<end_of_text>"]
        self.context_length = context_length

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
        for token in self.pat.findall(_clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return tokens

    def __call__(self, texts, context_length: int | None = None) -> np.ndarray:
        """int32 [n_texts, context_length], 0-padded."""
        if isinstance(texts, str):
            texts = [texts]
        n = context_length or self.context_length
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


def tokenize(texts, context_length: int = 77) -> np.ndarray:
    return _default_tokenizer()(texts, context_length)
