"""Attention layer fusion (rs_ov/decontam/layer_fusion.py:24-49): an EMA
over the front blocks' head-averaged attention maps, then outlier-masked
re-weighting of the custom-attention output.

    A <- lam * A + (1 - lam) * A_new       (the first layer initialises A)
    out = rownorm(A with the top-k outlier columns zeroed) @ output
"""

from __future__ import annotations

import torch

from rs_ov_torch.decontam.outlier import detect_outliers_by_attention

__all__ = ["fuse_attention_ema", "layer_fusion_reweight"]


def fuse_attention_ema(accumulated: torch.Tensor | None, current: torch.Tensor,
                       lam: float) -> torch.Tensor:
    """A <- lam*A + (1-lam)*A_new (rs_ov/decontam/layer_fusion.py:24-29)."""
    if accumulated is None:
        return current
    return lam * accumulated + (1.0 - lam) * current


def layer_fusion_reweight(output: torch.Tensor, fused_attn: torch.Tensor,
                          top_k: int) -> torch.Tensor:
    """output [B, L, D] (CLS at 0); fused_attn [B, L, L] head-averaged
    (rs_ov/decontam/layer_fusion.py:32-49)."""
    b, l, _ = fused_attn.shape
    outlier_idx = detect_outliers_by_attention(fused_attn, l - 1, top_k)  # [B, K]
    mask = torch.ones((b, l), dtype=fused_attn.dtype, device=fused_attn.device)
    mask.scatter_(1, outlier_idx + 1, 0.0)  # +1 for CLS
    masked = fused_attn * mask[:, None, :]
    normalized = masked / (masked.sum(-1, keepdim=True) + 1e-8)
    out = torch.matmul(normalized.float(), output.float())
    return out.to(output.dtype)
