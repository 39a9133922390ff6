"""HF-backed tokenizers, HFTokenizer and SigLipTokenizer
(rs_ov/text/hf_tokenizers.py).

Both load LOCAL tokenizer assets only (a saved tokenizer directory, a
``tokenizer.json`` fast-tokenizer file, or a sentencepiece ``.model``) and
never download; ``transformers`` is imported when one is built. They return
int32 numpy arrays, as the BPE tokenizer does.

SigLIP's semantics as in the JAX package: canonicalize cleaning, pad and eos
forced to id 1, truncate and pad to the context length.
"""

from __future__ import annotations

import os
from typing import List, Optional, Union

import numpy as np

from rs_ov_torch.text.tokenizer import DEFAULT_CONTEXT_LENGTH, get_clean_fn

__all__ = ["HFTokenizer", "SigLipTokenizer"]


def _load_fast_tokenizer(name_or_path: str, cls_name: str = "AutoTokenizer"):
    """Resolve a local tokenizer asset. Raises with the canonical source when
    the asset is absent: nothing is downloaded."""
    from transformers import AutoTokenizer, PreTrainedTokenizerFast

    if os.path.isdir(name_or_path):
        return AutoTokenizer.from_pretrained(name_or_path)
    if os.path.isfile(name_or_path):
        if name_or_path.endswith(".json"):
            return PreTrainedTokenizerFast(tokenizer_file=name_or_path)
        if name_or_path.endswith(".model"):  # sentencepiece vocab
            try:
                from transformers import T5TokenizerFast

                return T5TokenizerFast(vocab_file=name_or_path, legacy=False)
            except Exception as e:  # sentencepiece is not installed
                raise NotImplementedError(
                    f"loading a raw sentencepiece vocab ({name_or_path}) "
                    "needs the `sentencepiece` package; convert it to a "
                    "fast-tokenizer tokenizer.json instead") from e
    raise FileNotFoundError(
        f"No implicit downloads: '{name_or_path}' is not "
        "a local tokenizer directory / tokenizer.json / sentencepiece "
        ".model. Fetch the tokenizer with "
        f"`AutoTokenizer.from_pretrained({name_or_path!r}).save_pretrained("
        "local_dir)` on a connected machine and pass local_dir.")


class HFTokenizer:
    """HuggingFace tokenizer wrapper (rs_ov/text/hf_tokenizers.py:54-110)."""

    def __init__(self, tokenizer_name: str,
                 context_length: Optional[int] = DEFAULT_CONTEXT_LENGTH,
                 clean: str = "whitespace", strip_sep_token: bool = False,
                 language: Optional[str] = None):
        self.tokenizer = _load_fast_tokenizer(tokenizer_name)
        set_lang_fn = getattr(self.tokenizer, "set_src_lang_special_tokens",
                              None)
        if callable(set_lang_fn):
            self.set_lang_fn = set_lang_fn
        if language is not None:
            self.set_language(language)
        if self.tokenizer.pad_token_id is None:
            # raw tokenizer.json assets carry no pad token; CLIP-style
            # contexts 0-pad
            self.tokenizer.pad_token_id = 0
        self.context_length = context_length
        self.clean_fn = get_clean_fn(clean)
        self.strip_sep_token = strip_sep_token

    def save_pretrained(self, dest):
        self.tokenizer.save_pretrained(dest)

    def __call__(self, texts: Union[str, List[str]],
                 context_length: Optional[int] = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        context_length = context_length or self.context_length
        assert context_length, "set a context length in init or call"
        texts = [self.clean_fn(t) for t in texts]
        ids = self.tokenizer.batch_encode_plus(
            texts, return_tensors="np", max_length=context_length,
            padding="max_length", truncation=True).input_ids.astype(np.int32)
        if self.strip_sep_token:
            ids = np.where(ids == self.tokenizer.sep_token_id, 0, ids)
        return ids

    def set_language(self, src_lang):
        if hasattr(self, "set_lang_fn"):
            self.set_lang_fn(src_lang)
        else:
            import warnings

            warnings.warn("Cannot set language for the tokenizer.")


class SigLipTokenizer:
    """SigLIP T5-compatible sentencepiece tokenizer
    (rs_ov/text/hf_tokenizers.py:113-146)."""

    # canonical vocab sources, named in the refusal
    VOCAB_FILES = {
        # english, vocab_size=32_000
        "c4-en": "http://storage.googleapis.com/t5-data/vocabs/cc_en.32000/"
                 "sentencepiece.model",
        # multilingual (mT5, PaLI), vocab_size=250_000
        "mc4": "http://storage.googleapis.com/t5-data/vocabs/"
               "mc4.250000.100extra/sentencepiece.model",
    }

    def __init__(self, tokenizer_name: str,
                 context_length: Optional[int] = 64):
        if tokenizer_name in self.VOCAB_FILES:
            raise FileNotFoundError(
                f"No implicit downloads. Fetch "
                f"{self.VOCAB_FILES[tokenizer_name]} and pass its local "
                "path (or a saved tokenizer dir / tokenizer.json).")
        self.tokenizer = _load_fast_tokenizer(tokenizer_name)
        # SigLIP convention: pad == eos == 1
        self.tokenizer.pad_token_id = 1
        self.tokenizer.eos_token_id = 1
        self.context_length = context_length
        self._clean = get_clean_fn("canonicalize")

    def save_pretrained(self, dest):
        self.tokenizer.save_pretrained(dest)

    def __call__(self, texts: Union[str, List[str]],
                 context_length: Optional[int] = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        context_length = context_length or self.context_length
        assert context_length, "set a context length in init or call"
        texts = [self._clean(t) for t in texts]
        out = self.tokenizer(texts, return_tensors="np",
                             max_length=context_length,
                             padding="max_length", truncation=True)
        return out.input_ids.astype(np.int32)
