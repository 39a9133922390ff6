"""Outlier-token suppression (rs_ov/decontam/outlier.py:36-131).

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


def _head_average(attn: torch.Tensor) -> torch.Tensor:
    """[B, H, L, L] -> [B, L, L]; a head-averaged map passes through."""
    return attn.mean(1) if attn.dim() == 4 else attn


def detect_outliers_by_attention(attn: torch.Tensor, num_patches: int,
                                 top_k: int = 10) -> torch.Tensor:
    """attn [B, L, L] or [B, H, L, L] post-softmax weights (CLS at 0) ->
    [B, K] flat patch indices, largest ratio first."""
    attn = _head_average(attn).float()
    diag = torch.diagonal(attn, dim1=-2, dim2=-1)[:, 1:1 + num_patches]
    ratio = attn[:, 0, 1:1 + num_patches] / (diag + 1e-8)
    return torch.topk(ratio, min(top_k, num_patches), dim=-1).indices


def _neighbor_geometry(flat_idx: torch.Tensor, grid_h: int, grid_w: int):
    """flat [B, K] -> (rows, cols, n_flat [B, K, 8], is_self [B, K, 8]): the
    8 neighbours, clamped to the grid (rs_ov/decontam/outlier.py:58-66)."""
    off = _offsets(flat_idx.device)
    rows, cols = flat_idx // grid_w, flat_idx % grid_w
    n_rows = (rows[..., None] + off[:, 0]).clamp(0, grid_h - 1)
    n_cols = (cols[..., None] + off[:, 1]).clamp(0, grid_w - 1)
    is_self = (n_rows == rows[..., None]) & (n_cols == cols[..., None])
    return rows, cols, n_rows * grid_w + n_cols, is_self


def _gather_tokens(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats [B, P, C], idx [B, ...] -> [B, ..., C]."""
    b = feats.shape[0]
    flat = idx.reshape(b, -1)
    out = torch.gather(feats, 1, flat[..., None].expand(-1, -1, feats.shape[-1]))
    return out.reshape(*idx.shape, feats.shape[-1])


def _inverse_sim_weights(center: torch.Tensor, neighbors: torch.Tensor):
    """center [B, K, C], neighbors [B, K, 8, C] -> (cosine similarity,
    softmax(clamp(1 - sim, 0)) weights), both fp32 [B, K, 8]."""
    c = center.float()
    n = neighbors.float()
    c_n = c / c.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    n_n = n / n.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    sim = (n_n * c_n[:, :, None, :]).sum(-1)
    return sim, torch.softmax((1.0 - sim).clamp_min(0.0), dim=-1)


def outlier_suppress(feature_map: torch.Tensor, attn: torch.Tensor,
                     grid_h: int, grid_w: int, *, top_k: int = 10,
                     contamination_temp: float = 0.1) -> torch.Tensor:
    """feature_map [B, C, H, W] patch features -> the same, suppressed."""
    b, c, h, w = feature_map.shape
    p = h * w
    idx = detect_outliers_by_attention(attn, p, top_k)       # [B, K]
    k = idx.shape[1]
    feats = feature_map.reshape(b, c, p).transpose(1, 2)     # [B, P, C]
    _, _, n_flat, is_self = _neighbor_geometry(idx, grid_h, grid_w)

    center = _gather_tokens(feats, idx).float()              # [B, K, C]
    neigh = _gather_tokens(feats, n_flat).float()            # [B, K, 8, C]
    sim, weights = _inverse_sim_weights(center, neigh)
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
