"""Self-attention enhancement for weak-self-attention tokens
(rs_ov/decontam/self_attn_enhance.py).

* ``feature`` mode: the top-k patches with the lowest attention diagonal are
  replaced by the inverse-similarity-weighted mean of their 8 spatial
  neighbours (rs_ov/decontam/self_attn_enhance.py:29-61).
* ``attention`` mode: the diagonal is raised by clamp(threshold - diag, 0) *
  strength (CLS untouched), the rows are L1-renormalised and the features,
  with a zero CLS in front, are re-aggregated with the modified map
  (:62-77).
"""

from __future__ import annotations

import torch

from rs_ov_torch.decontam.outlier import (_gather_tokens, _head_average,
                                          _inverse_sim_weights, _neighbor_geometry)

__all__ = ["self_attention_enhance"]


def _replace_weak_with_neighbors(feats: torch.Tensor, weak_idx: torch.Tensor,
                                 grid_h: int, grid_w: int) -> torch.Tensor:
    """feats [B, P, C]; weak_idx [B, K] -> feats with the weak tokens replaced."""
    _, _, n_flat, _ = _neighbor_geometry(weak_idx, grid_h, grid_w)
    neighbors = _gather_tokens(feats, n_flat)
    _, weights = _inverse_sim_weights(_gather_tokens(feats, weak_idx), neighbors)
    weighted_avg = (neighbors.float() * weights[..., None]).sum(2)
    c = feats.shape[-1]
    return feats.scatter(1, weak_idx[..., None].expand(-1, -1, c),
                         weighted_avg.to(feats.dtype))


def self_attention_enhance(patch_features: torch.Tensor, attn: torch.Tensor,
                           grid_h: int, grid_w: int, *, mode: str = "feature",
                           enhancement_strength: float = 0.1,
                           min_self_attn_threshold: float = 0.15,
                           top_k: int = 10) -> torch.Tensor:
    """patch_features [B, C, H, W] (CLS excluded; the caller re-attaches it);
    attn [B, L, L] or [B, H, L, L] with CLS at index 0."""
    b, c, h, w = patch_features.shape
    p = h * w
    feats = patch_features.reshape(b, c, p).transpose(1, 2)  # [B, P, C]
    attn = _head_average(attn).float()

    if mode == "feature":
        diag = torch.diagonal(attn, dim1=-2, dim2=-1)[:, 1:1 + p]
        weak_idx = torch.topk(-diag, min(top_k, p), dim=-1).indices
        out = _replace_weak_with_neighbors(feats, weak_idx, grid_h, grid_w)
    elif mode == "attention":
        n = attn.shape[1]
        diag = torch.diagonal(attn, dim1=-2, dim2=-1)  # [B, N], CLS included
        boost = (min_self_attn_threshold - diag).clamp_min(0.0) * enhancement_strength
        boost[:, 0] = 0.0  # the CLS diagonal stays
        attn_mod = attn + boost[:, :, None] * torch.eye(n, device=attn.device)
        attn_mod = attn_mod / (attn_mod.sum(-1, keepdim=True) + 1e-8)
        feats_cls = torch.cat([feats.new_zeros(b, 1, c), feats], dim=1)
        out = torch.matmul(attn_mod, feats_cls.float())[:, 1:].to(feats.dtype)
    else:
        raise ValueError(f"mode must be 'feature' or 'attention', got {mode!r}")

    return out.transpose(1, 2).reshape(b, c, h, w)
