"""Similarity-weighted global CLS debiasing (rs_ov/decontam/global_debias.py):
x_i <- x_i - cos(x_i, cls) * factor * cls."""

from __future__ import annotations

import torch

__all__ = ["global_debias"]


def global_debias(patch_features: torch.Tensor, cls_token: torch.Tensor,
                  factor: float) -> torch.Tensor:
    """patch_features [B, N, C]; cls_token [B, C] (L2-normalised by the
    caller). Computed in fp32, returned in the features' dtype."""
    if factor == 0.0:
        return patch_features
    f32 = patch_features.float()
    c32 = cls_token.float()
    f_n = f32 / f32.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    c_n = c32 / c32.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    similarity = (f_n * c_n[:, None, :]).sum(-1)
    out = f32 - c32[:, None, :] * (similarity[..., None] * factor)
    return out.to(patch_features.dtype)
