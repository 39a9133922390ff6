"""Sliding-window tiling (rs_ov/pipeline/tiler.py)."""

from __future__ import annotations

import functools

import torch

__all__ = ["compute_padsize", "tile_grid", "extract_tiles", "stitch"]


def compute_padsize(h: int, w: int, patch_size: int):
    """(left, right, top, bottom) pads up to the next patch multiple."""
    l = r = t = b = 0
    if w % patch_size:
        lr = patch_size - (w % patch_size)
        l, r = lr // 2, lr - lr // 2
    if h % patch_size:
        tb = patch_size - (h % patch_size)
        t, b = tb // 2, tb - tb // 2
    return l, r, t, b


@functools.lru_cache(maxsize=None)
def tile_grid(h_img: int, w_img: int, stride: int, crop: int):
    """The (y1, x1, y2, x2) crops of the overlapping grid, and the grid shape."""
    h_grids = max(h_img - crop + stride - 1, 0) // stride + 1
    w_grids = max(w_img - crop + stride - 1, 0) // stride + 1
    coords = []
    for h_idx in range(h_grids):
        for w_idx in range(w_grids):
            y2 = min(h_idx * stride + crop, h_img)
            x2 = min(w_idx * stride + crop, w_img)
            coords.append((max(y2 - crop, 0), max(x2 - crop, 0), y2, x2))
    return tuple(coords), (h_grids, w_grids)


def extract_tiles(img: torch.Tensor, coords) -> torch.Tensor:
    """img [3, H, W] -> [T, 3, ch, cw]."""
    return torch.stack([img[:, y1:y2, x1:x2] for (y1, x1, y2, x2) in coords])


def stitch(tile_logits: torch.Tensor, coords, h_img: int, w_img: int) -> torch.Tensor:
    """Overlap-average stitching: [T, Q, ch, cw] -> [Q, H, W] fp32."""
    q = tile_logits.shape[1]
    preds = torch.zeros((q, h_img, w_img), dtype=torch.float32, device=tile_logits.device)
    count = torch.zeros((1, h_img, w_img), dtype=torch.float32, device=tile_logits.device)
    for t, (y1, x1, y2, x2) in enumerate(coords):
        preds[:, y1:y2, x1:x2] += tile_logits[t].float()
        count[:, y1:y2, x1:x2] += 1.0
    return preds / count
