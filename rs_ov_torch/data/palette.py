"""Mask colourisation and confidence heatmaps (rs_ov/data/palette.py; the
reference's segmentor.py:568-608)."""

from __future__ import annotations

import colorsys

import numpy as np

__all__ = ["generate_palette", "colorize_mask", "confidence_heatmap", "save_png"]


def save_png(arr: np.ndarray, path: str) -> None:
    """Write an [H, W] or [H, W, 3] uint8 image as PNG."""
    from PIL import Image

    Image.fromarray(arr).save(path)


def generate_palette(n: int, bg_idx: int = 0) -> np.ndarray:
    """Deterministic HSV palette, the background darkened."""
    palette = []
    for idx in range(n):
        h = (idx / max(1, n)) % 1.0
        v = 1.0 if idx != bg_idx else 0.2
        r, g, b = colorsys.hsv_to_rgb(h, 0.75, v)
        palette.append([int(r * 255), int(g * 255), int(b * 255)])
    return np.array(palette, dtype=np.uint8)


def colorize_mask(mask2d: np.ndarray, num_classes: int, bg_idx: int,
                  out_path: str | None = None) -> np.ndarray:
    n = max(int(num_classes), int(mask2d.max()) + 1)
    color = generate_palette(n, bg_idx)[np.clip(mask2d.astype(np.int32), 0, n - 1)]
    if out_path:
        save_png(color, out_path)
    return color


def confidence_heatmap(conf2d: np.ndarray, out_path: str | None = None) -> np.ndarray:
    """JET colour map of [0, 1] confidences where OpenCV is installed, else
    a red-to-blue ramp, as the JAX package does."""
    gray = (np.clip(np.nan_to_num(conf2d.astype(np.float32)), 0.0, 1.0) * 255.0).astype(np.uint8)
    try:
        import cv2

        heat = cv2.cvtColor(cv2.applyColorMap(gray, cv2.COLORMAP_JET), cv2.COLOR_BGR2RGB)
    except ImportError:
        heat = np.stack([gray, np.zeros_like(gray), 255 - gray], axis=-1)
    if out_path:
        save_png(heat, out_path)
    return heat
