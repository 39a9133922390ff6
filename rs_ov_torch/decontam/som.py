"""SOM, the Suppress Outlier Module (rs_ov/decontam/som.py).

* Multi-head consensus: each head votes per detection mode; a patch is an
  outlier when the voting fraction exceeds ``consensus_threshold``.
* Detection modes (rs_ov/decontam/som.py:29-55):
  ``cls_comparison`` Attn[i,i] < Attn[cls,i]; ``self_sufficiency``
  Attn[i,i] < max_{j!=i} Attn[i,j] * ratio; ``both`` their union;
  ``either`` their intersection.
* Replacement: the plain mean of the valid 8 spatial neighbours (border
  patches use their 3 or 5), only where the mask is set (:58-93).
"""

from __future__ import annotations

import torch

__all__ = ["suppress_outlier_module"]

_OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def _detect_votes(attn: torch.Tensor, num_patches: int, mode: str,
                  self_sufficiency_ratio: float) -> torch.Tensor:
    """attn [B, H, N, N] post-softmax -> bool votes [B, H, P]."""
    attn = attn.float()
    n = attn.shape[-1]
    diag = torch.diagonal(attn, dim1=-2, dim2=-1)[..., 1:1 + num_patches]
    cls_to_tok = attn[..., 0, 1:1 + num_patches]

    def cls_comparison():
        return diag < cls_to_tok

    def self_sufficiency():
        rows = attn[..., 1:1 + num_patches, :]  # [B, H, P, N]
        self_col = torch.arange(n, device=attn.device)[None, :] == \
            (torch.arange(num_patches, device=attn.device) + 1)[:, None]
        others = rows.masked_fill(self_col, float("-inf"))
        return diag < others.amax(-1) * self_sufficiency_ratio

    if mode == "cls_comparison":
        return cls_comparison()
    if mode == "self_sufficiency":
        return self_sufficiency()
    if mode == "both":
        return cls_comparison() | self_sufficiency()
    if mode == "either":
        return cls_comparison() & self_sufficiency()
    raise ValueError(f"Unknown detection_mode '{mode}'")


def _valid_neighbor_mean(tokens: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
    """The mean of the existing 8 neighbours at every position. tokens [B, P, C]."""
    b, p, c = tokens.shape
    grid = tokens.reshape(b, grid_h, grid_w, c).float()
    total = torch.zeros_like(grid)
    count = torch.zeros((grid_h, grid_w), device=tokens.device)
    for dy, dx in _OFFSETS:
        ys, ye = max(dy, 0), grid_h + min(dy, 0)
        xs, xe = max(dx, 0), grid_w + min(dx, 0)
        total[:, ys:ye, xs:xe] += grid[:, ys - dy:ye - dy, xs - dx:xe - dx]
        count[ys:ye, xs:xe] += 1.0
    return (total / count[None, :, :, None]).reshape(b, p, c)


def suppress_outlier_module(tokens: torch.Tensor, attn: torch.Tensor,
                            grid_h: int, grid_w: int, *,
                            consensus_threshold: float = 0.5,
                            detection_mode: str = "both",
                            self_sufficiency_ratio: float = 1.0):
    """tokens [B, P, C] patch tokens (no CLS); attn [B, H, N, N] or [B, N, N].
    Returns (purified tokens, outlier mask [B, grid_h, grid_w] bool,
    confidence [B, P] fp32, the per-head voting fraction)."""
    if attn.dim() == 3:
        attn = attn[:, None]
    b, p, _ = tokens.shape
    votes = _detect_votes(attn, p, detection_mode, self_sufficiency_ratio)
    confidence = votes.float().mean(1)
    mask = confidence > consensus_threshold
    neighbor_mean = _valid_neighbor_mean(tokens, grid_h, grid_w)
    purified = torch.where(mask[..., None], neighbor_mean.to(tokens.dtype), tokens)
    return purified, mask.reshape(b, grid_h, grid_w), confidence
