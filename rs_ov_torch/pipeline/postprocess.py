"""Logit post-processing (rs_ov/pipeline/postprocess.py): scale, softmax over
queries, synonym merge, argmax, threshold."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["postprocess_logits", "query_onehot"]


def query_onehot(query_idx: list[int]) -> np.ndarray:
    """[num_cls, num_queries] one-hot map of query -> class."""
    onehot = np.zeros((max(query_idx) + 1, len(query_idx)), np.float32)
    for q, c in enumerate(query_idx):
        onehot[c, q] = 1.0
    return onehot


def postprocess_logits(seg_logits: torch.Tensor, onehot: torch.Tensor, *,
                       logit_scale: float, prob_thd: float, bg_idx: int,
                       pred_dtype: torch.dtype = torch.int32):
    """seg_logits [Q, H, W] -> (probs [C, H, W] fp32, seg_pred [1, H, W] in
    pred_dtype: int32 by default, as the JAX package; uint8 where the labels
    and bg_idx fit)."""
    x = torch.softmax(seg_logits.float() * logit_scale, dim=0)
    num_cls, num_queries = onehot.shape
    if num_cls != num_queries:
        # per class, the max over its synonyms (probs >= 0, so the one-hot
        # product + max is exact)
        x = (x[None] * onehot[:, :, None, None]).amax(1)
    seg_pred = x.argmax(0, keepdim=True).to(pred_dtype)
    return x, torch.where(x.amax(0, keepdim=True) < prob_thd,
                          torch.full_like(seg_pred, bg_idx), seg_pred)
