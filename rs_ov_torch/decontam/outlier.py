"""Outlier-token suppression (rs_ov/decontam/outlier.py).

Detection: the top-k patches by Attn[cls, i] / Attn[i, i]. Replacement: the
inverse-similarity softmax-weighted mean of the 8 spatial neighbours.
Bidirectional decontamination: each neighbour loses sigma * x_outlier.

Colliding neighbour writes resolve last-write-wins in the JAX package's
(outlier-major, neighbour-minor) order: a scatter-amax of the write order
picks each patch's winning write, then the outliers' replacements overwrite
everything.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["detect_outliers_by_attention", "outlier_suppress"]

# 8-neighbour offsets in the reference's iteration order
_OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


@functools.lru_cache(maxsize=None)
def _offsets(device: torch.device) -> torch.Tensor:
    return torch.tensor(_OFFSETS, device=device)


def detect_outliers_by_attention(attn: torch.Tensor, num_patches: int,
                                 top_k: int = 10) -> torch.Tensor:
    """attn [B, L, L] head-averaged post-softmax weights (CLS at 0) ->
    [B, K] flat patch indices, largest ratio first."""
    attn = attn.float()
    diag = torch.diagonal(attn, dim1=-2, dim2=-1)[:, 1:1 + num_patches]
    ratio = attn[:, 0, 1:1 + num_patches] / (diag + 1e-8)
    return torch.topk(ratio, min(top_k, num_patches), dim=-1).indices


def _gather(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats [B, P, C], idx [B, ...] -> [B, ..., C]."""
    b = feats.shape[0]
    flat = idx.reshape(b, -1)
    out = torch.gather(feats, 1, flat[..., None].expand(-1, -1, feats.shape[-1]))
    return out.reshape(*idx.shape, feats.shape[-1])


def outlier_suppress(feature_map: torch.Tensor, attn: torch.Tensor,
                     grid_h: int, grid_w: int, *, top_k: int = 10,
                     contamination_temp: float = 0.1) -> torch.Tensor:
    """feature_map [B, C, H, W] patch features -> the same, suppressed."""
    b, c, h, w = feature_map.shape
    p = h * w
    idx = detect_outliers_by_attention(attn, p, top_k)       # [B, K]
    k = idx.shape[1]
    feats = feature_map.reshape(b, c, p).transpose(1, 2)     # [B, P, C]

    off = _offsets(idx.device)
    rows, cols = idx // grid_w, idx % grid_w
    n_rows = (rows[..., None] + off[:, 0]).clamp(0, grid_h - 1)
    n_cols = (cols[..., None] + off[:, 1]).clamp(0, grid_w - 1)
    n_flat = n_rows * grid_w + n_cols                        # [B, K, 8]
    is_self = (n_rows == rows[..., None]) & (n_cols == cols[..., None])

    center = _gather(feats, idx).float()                     # [B, K, C]
    neigh = _gather(feats, n_flat).float()                   # [B, K, 8, C]
    c_n = center / center.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    n_n = neigh / neigh.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    sim = (n_n * c_n[:, :, None, :]).sum(-1)                 # [B, K, 8]
    weights = torch.softmax((1.0 - sim).clamp_min(0.0), dim=-1)
    weighted_avg = (neigh * weights[..., None]).sum(2)       # [B, K, C]

    strength = (sim * contamination_temp).clamp(0.0, 1.0)
    clean = neigh - center[:, :, None, :] * strength[..., None]

    n_writes = k * 8
    order = torch.arange(n_writes, device=idx.device).reshape(1, k, 8).expand(b, k, 8)
    order = torch.where(is_self, -1, order)                  # clamped onto self: no write
    winner = torch.full((b, p), -1, dtype=order.dtype, device=idx.device)
    winner = winner.scatter_reduce(1, n_flat.reshape(b, -1), order.reshape(b, -1),
                                   reduce="amax", include_self=True)
    updated = torch.gather(clean.reshape(b, n_writes, c), 1,
                           winner.clamp(0, n_writes - 1)[..., None].expand(-1, -1, c))
    out = torch.where((winner >= 0)[..., None], updated, feats.float())
    out = out.scatter(1, idx[..., None].expand(-1, -1, c), weighted_avg)
    return out.to(feature_map.dtype).transpose(1, 2).reshape(b, c, h, w)
