"""Cross-tile semantic fusion over one image's grid of crops
(rs_ov/decontam/cross_tile.py).

Each crop's boundary strips are fused with its top and left neighbours'
strips, row by row in raster order, as the JAX package reproduces the
reference's sequential cache walk (rs_ov/decontam/cross_tile.py:7-22):

* the top strip fuses with the previous row's bottom strips after their own
  fusion;
* left / right strips are read after the row's top write when the
  reference's strips are views (bw == 1 or bw == pw), else from the row as it
  was before; with bw == 1 and pw <= 2 a left write may alias the right
  strip, so the columns are walked one by one.

Fusion modes: ``weighted`` (adaptive cosine threshold mean + unbiased std,
squared-margin weights, or a fixed threshold) and ``attention``
(parameter-free joint attention).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["CrossTileFusionConfig", "fuse_tile_grid"]


@dataclasses.dataclass(frozen=True)
class CrossTileFusionConfig:
    fusion_mode: str = "weighted"  # 'weighted' | 'attention'
    cache_boundary_width: int = 2
    fusion_strength: float = 0.3
    adaptive_fusion: bool = True
    similarity_threshold: float | None = None


def _fuse_attention(current: torch.Tensor, neighbor: torch.Tensor,
                    strength: float) -> torch.Tensor:
    """current [..., Nc, C], neighbor [..., Nn, C] (rs_ov/decontam/cross_tile.py:49-61)."""
    c = current.shape[-1]
    combined = torch.cat([current, neighbor], dim=-2).float()
    cur32 = current.float()
    attn = torch.softmax(torch.matmul(cur32, combined.transpose(-1, -2)) / c ** 0.5, dim=-1)
    fused = torch.matmul(attn, combined)
    return (cur32 * (1 - strength) + fused * strength).to(current.dtype)


def _fuse_weighted(current: torch.Tensor, neighbor: torch.Tensor, *,
                   strength: float, adaptive: bool,
                   threshold: float | None, eps: float = 1e-6) -> torch.Tensor:
    """Similarity-threshold weighted fusion (rs_ov/decontam/cross_tile.py:64-93)."""
    cur32, nb32 = current.float(), neighbor.float()
    cn = cur32 / (cur32.norm(dim=-1, keepdim=True) + eps)
    nn_ = nb32 / (nb32.norm(dim=-1, keepdim=True) + eps)
    sim = torch.matmul(cn, nn_.transpose(-1, -2))  # [..., Nc, Nn]
    if adaptive or threshold is None:
        thr = sim.mean(-1, keepdim=True) + sim.std(-1, keepdim=True)  # unbiased std
        margin = torch.relu(sim - thr)
        raw = margin ** 2
        weights = raw / (raw.sum(-1, keepdim=True) + eps)
        local_strength = margin.mean(-1, keepdim=True).clamp(0.0, 1.0)
    else:
        masked = sim * (sim > threshold).float()
        weights = masked / (masked.sum(-1, keepdim=True) + eps)
        local_strength = torch.ones_like(weights[..., :1])
    agg = torch.matmul(weights, nb32)
    fs = strength * local_strength
    return (cur32 * (1 - fs) + agg * fs).to(current.dtype)


def _fuse(current, neighbor, cfg: CrossTileFusionConfig):
    if cfg.fusion_mode == "attention":
        return _fuse_attention(current, neighbor, cfg.fusion_strength)
    return _fuse_weighted(current, neighbor, strength=cfg.fusion_strength,
                          adaptive=cfg.adaptive_fusion, threshold=cfg.similarity_threshold)


def fuse_tile_grid(tile_features: torch.Tensor, grid_shape: tuple[int, int],
                   patch_hw: tuple[int, int], cfg: CrossTileFusionConfig) -> torch.Tensor:
    """tile_features [T, N, C], T = GH*GW crops in raster order, N = ph*pw
    patches each -> the fused [T, N, C] (rs_ov/decontam/cross_tile.py:104-156)."""
    gh, gw = grid_shape
    ph, pw = patch_hw
    t, n, c = tile_features.shape
    if t != gh * gw or n != ph * pw:
        raise ValueError(f"fuse_tile_grid: {t} tiles of {n} patches do not make a "
                         f"{gh}x{gw} grid of {ph}x{pw}")
    bw = cfg.cache_boundary_width
    grid = tile_features.reshape(gh, gw, ph, pw, c)
    lr_strips_are_views = bw == 1 or bw == pw  # the reference's torch view condition

    prev_bottom = None  # the previous row's bottom strips after fusion [gw, bw*pw, c]
    out_rows = []
    for h in range(gh):
        raw_row = grid[h]          # the row as it came in, never written
        row = raw_row.clone()
        if prev_bottom is not None:
            raw_top = raw_row[:, :bw].reshape(gw, bw * pw, c)
            row[:, :bw] = _fuse(raw_top, prev_bottom, cfg).reshape(gw, bw, pw, c)

        lr_src = row if lr_strips_are_views else raw_row
        if gw > 1 and (not lr_strips_are_views or pw > 2 * bw):
            left_s = lr_src[:, :, :bw].reshape(gw, ph * bw, c)
            right_s = lr_src[:, :, -bw:].reshape(gw, ph * bw, c)
            fused_left = _fuse(left_s[1:], right_s[:-1], cfg)
            row[1:, :, :bw] = fused_left.reshape(gw - 1, ph, bw, c)
        elif gw > 1:
            # bw == 1 with a narrow crop: a left write may alias the right
            # strip, so walk the columns as the reference does
            for w in range(1, gw):
                nb_right = row[w - 1, :, -bw:].reshape(1, ph * bw, c)
                cur_left = row[w, :, :bw].reshape(1, ph * bw, c)
                row[w, :, :bw] = _fuse(cur_left, nb_right, cfg).reshape(ph, bw, c)

        prev_bottom = row[:, -bw:].reshape(gw, bw * pw, c)
        out_rows.append(row)
    return torch.stack(out_rows).reshape(t, n, c)
