"""BERT WordPiece tokenizer for the BLIP text tower (a copy of
rs_ov/text/wordpiece.py, which the port keeps so that it imports nothing of
the JAX package).

bert-base-uncased tokenization from a local ``vocab.txt``: basic
tokenization (lowercase, accent strip, punctuation and CJK split), then
greedy longest-match WordPiece with '##' continuations, padded or cut to
``max_length`` with [CLS] and [SEP]. No network, no transformers import.
"""

from __future__ import annotations

import unicodedata
from typing import List, Union

import numpy as np

__all__ = ["WordPieceTokenizer", "write_synthetic_vocab"]


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0xF900 <= cp <= 0xFAFF)


class WordPieceTokenizer:
    def __init__(self, vocab_path: str, do_lower_case: bool = True,
                 unk_token: str = "[UNK]", max_input_chars_per_word: int = 100):
        with open(vocab_path, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f]
        self.vocab = {t: i for i, t in enumerate(tokens)}
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.max_chars = max_input_chars_per_word
        self.cls_token_id = self.vocab.get("[CLS]", 101)
        self.sep_token_id = self.vocab.get("[SEP]", 102)
        self.pad_token_id = self.vocab.get("[PAD]", 0)
        # BLIP special tokens (reference blip.py:186-191 init_tokenizer):
        # '[DEC]' bos appended after the base vocab, then '[ENC]' — ids
        # 30522/30523 for bert-base-uncased, matching the MED vocab of 30524
        for i, tok in enumerate(("[DEC]", "[ENC]")):
            if tok not in self.vocab:
                tid = len(self.vocab)
                self.vocab[tok] = tid
                self.ids_to_tokens[tid] = tok
        self.bos_token_id = self.vocab["[DEC]"]
        self.enc_token_id = self.vocab["[ENC]"]

    # ---- basic tokenization ----
    def _basic(self, text: str) -> List[str]:
        text = unicodedata.normalize("NFC", text)
        out_chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
                continue
            if _is_cjk(cp):
                out_chars.append(f" {ch} ")
            elif ch.isspace():
                out_chars.append(" ")
            else:
                out_chars.append(ch)
        tokens = "".join(out_chars).split()
        result: List[str] = []
        for tok in tokens:
            if self.do_lower_case:
                tok = tok.lower()
                tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                              if unicodedata.category(c) != "Mn")
            # split on punctuation
            current = []
            for ch in tok:
                if _is_punct(ch):
                    if current:
                        result.append("".join(current))
                        current = []
                    result.append(ch)
                else:
                    current.append(ch)
            if current:
                result.append("".join(current))
        return result

    # ---- wordpiece ----
    def _wordpiece(self, token: str) -> List[str]:
        if len(token) > self.max_chars:
            return [self.unk_token]
        start = 0
        pieces: List[str] = []
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        return [p for tok in self._basic(text) for p in self._wordpiece(tok)]

    def encode(self, text: str) -> List[int]:
        return [self.vocab.get(t, self.vocab[self.unk_token])
                for t in self.tokenize(text)]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        """Token ids -> text (##-piece joining; HF BertTokenizer.decode
        semantics for the generate paths, reference blip.py:167)."""
        special = {self.cls_token_id, self.sep_token_id, self.pad_token_id,
                   self.bos_token_id, self.enc_token_id}
        out = []
        for i in (int(x) for x in ids):
            if skip_special_tokens and i in special:
                continue
            tok = self.ids_to_tokens.get(i, self.unk_token)
            if tok.startswith("##") and out:
                out[-1] += tok[2:]
            else:
                out.append(tok)
        return " ".join(out)

    def __call__(self, texts: Union[str, List[str]], max_length: int = 35):
        """Returns dict(input_ids, attention_mask) int32 [N, max_length]."""
        if isinstance(texts, str):
            texts = [texts]
        ids = np.full((len(texts), max_length), self.pad_token_id, np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, text in enumerate(texts):
            body = self.encode(text)[: max_length - 2]
            seq = [self.cls_token_id] + body + [self.sep_token_id]
            ids[i, : len(seq)] = seq
            mask[i, : len(seq)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def write_synthetic_vocab(path: str, size: int = 30522) -> str:
    """A ``vocab.txt`` of ``size`` entries for runs on random weights, where
    no vocabulary file is at hand: the special tokens, "a", "picture", "of",
    then "w0", "w1", ... With bert-base-uncased's 30522 the tokenizer's
    [DEC] and [ENC] take ids 30522 and 30523 (BLIP's 30524-token decoder)."""
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "picture", "of"]
    words += [f"w{i}" for i in range(size - len(words))]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(words))
    return path
