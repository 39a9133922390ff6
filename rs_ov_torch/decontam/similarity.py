"""Mid-layer similarity map (rs_ov/decontam/similarity.py)."""

from __future__ import annotations

import torch

__all__ = ["compute_similarity_map"]


def compute_similarity_map(features: torch.Tensor, *, temperature: float = 1.0,
                           add_self_similarity: bool = True) -> torch.Tensor:
    """Pairwise cosine similarity of patch features [B, P, D] (CLS excluded)
    -> fp32 [B, P, P] / temperature, diagonal zeroed unless
    ``add_self_similarity``."""
    f = features.float()
    f = f / f.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    sim = torch.matmul(f, f.transpose(-1, -2)) / temperature
    if not add_self_similarity:
        sim = sim * (1.0 - torch.eye(sim.shape[1], device=sim.device))
    return sim
