"""Prompt-ensemble text classifier (rs_ov/text/classifier.py): per query word,
encode every template, L2-normalise per prompt, average, L2-normalise again."""

from __future__ import annotations

import torch

from rs_ov.core.config import TextConfig
from rs_ov_torch.text.encoder import text_forward
from rs_ov_torch.text.templates import OPENAI_IMAGENET_TEMPLATES
from rs_ov_torch.text.tokenizer import tokenize

__all__ = ["build_text_classifier", "get_cls_idx"]


def get_cls_idx(path: str):
    """Parse a cls_*.txt vocabulary: one class per line, comma-separated
    synonyms. Returns (query_words, query_idx)."""
    with open(path) as f:
        name_sets = f.readlines()
    class_names, class_indices = [], []
    for idx, line in enumerate(name_sets):
        names = line.split(",")
        class_names += names
        class_indices += [idx] * len(names)
    return [n.replace("\n", "") for n in class_names], class_indices


@torch.no_grad()
def build_text_classifier(text_params, query_words: list[str], cfg: TextConfig, *,
                          quick_gelu: bool = False,
                          templates=OPENAI_IMAGENET_TEMPLATES,
                          batch_size: int = 512) -> torch.Tensor:
    """-> query_features [Q, output_dim] fp32, L2-normalised, on the
    weights' device."""
    prompts = [t.format(w) for w in query_words for t in templates]
    ids = torch.from_numpy(tokenize(prompts)).long().to(text_params.token_embedding.device)
    feats = torch.cat([
        text_forward(text_params, ids[i:i + batch_size], cfg,
                     quick_gelu_act=quick_gelu, normalize=True)
        for i in range(0, ids.shape[0], batch_size)])
    mean = feats.reshape(len(query_words), len(templates), -1).float().mean(1)
    return mean / mean.norm(dim=-1, keepdim=True).clamp_min(1e-12)
