"""2-D sine-cosine positional embeddings (rs_ov/nn/pos_embed.py; the MAE
construction of the reference's open_clip/pos_embed.py:20-96) for
``pos_embed_type='sin_cos_2d'`` vision configs. Plain numpy: the tables are
constants."""

from __future__ import annotations

import numpy as np

__all__ = ["get_2d_sincos_pos_embed"]


def _1d_sincos(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int,
                            cls_token: bool = False) -> np.ndarray:
    """[grid * grid (+1), embed_dim] float32, a zero CLS row first when asked."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)  # w goes first (reference :37)
    grid = np.stack(grid, axis=0).reshape(2, 1, grid_size, grid_size)
    emb_h = _1d_sincos(embed_dim // 2, grid[0])
    emb_w = _1d_sincos(embed_dim // 2, grid[1])
    pos = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        pos = np.concatenate([np.zeros((1, embed_dim)), pos], axis=0)
    return pos.astype(np.float32)
