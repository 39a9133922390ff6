"""Shared dataset-converter core (offline raw -> mmseg-layout tiles).

The reference ships 14 per-dataset scripts (reference tools/dataset_converters/
*.py, ~1.3k LoC of mmcv/mmengine code) that all follow the same pattern:
tile huge rasters into fixed-size crops with a stride (potsdam.py:35-102) and
map RGB palettes to index masks, either via the matmul trick
(potsdam.py:76-86) or exact color matching (uavid.py:26-34, isaid.py:38-48).
This module is that pattern once, dependency-light (numpy + PIL); the thin
per-dataset entry points live in rs_ov_torch/data/converters/convert.py. The
port's own copy of rs_ov/data/converters/core.py.
"""

from __future__ import annotations

import math
import os

import numpy as np

__all__ = ["clip_boxes", "rgb_to_index_matmul", "convert_from_color",
           "tile_image", "save_png"]


def clip_boxes(h: int, w: int, clip_size: int, stride_size: int) -> np.ndarray:
    """(N, 4) [x1, y1, x2, y2] crop boxes — the reference's grid math
    (potsdam.py:48-73): a clip-size-strided grid whose edge boxes shift
    inward so every crop is exactly clip_size."""
    num_rows = math.ceil((h - clip_size) / stride_size) if math.ceil(
        (h - clip_size) / stride_size) * stride_size + clip_size >= h \
        else math.ceil((h - clip_size) / stride_size) + 1
    num_cols = math.ceil((w - clip_size) / stride_size) if math.ceil(
        (w - clip_size) / stride_size) * stride_size + clip_size >= w \
        else math.ceil((w - clip_size) / stride_size) + 1

    x, y = np.meshgrid(np.arange(num_cols + 1), np.arange(num_rows + 1))
    xmin = (x * clip_size).ravel()
    ymin = (y * clip_size).ravel()
    xmin_offset = np.where(xmin + clip_size > w, w - xmin - clip_size, 0)
    ymin_offset = np.where(ymin + clip_size > h, h - ymin - clip_size, 0)
    return np.stack([
        xmin + xmin_offset, ymin + ymin_offset,
        np.minimum(xmin + clip_size, w), np.minimum(ymin + clip_size, h),
    ], axis=1)


def rgb_to_index_matmul(image: np.ndarray, color_map: np.ndarray) -> np.ndarray:
    """Palette -> index via the reference's matmul hashing trick
    (potsdam.py:76-86). image: [H, W, 3]; color_map: [C, 3] (channel order
    must match the image's)."""
    h, w, c = image.shape
    weights = np.array([2, 3, 4]).reshape(3, 1)
    flatten_v = image.reshape(-1, c).astype(np.int64) @ weights
    out = np.zeros_like(flatten_v)
    for idx, class_color in enumerate(color_map):
        value_idx = class_color.astype(np.int64) @ weights
        out[flatten_v == value_idx] = idx
    return out.reshape(h, w).astype(np.uint8)


def convert_from_color(arr_3d: np.ndarray, palette: dict,
                       remap: dict | None = None) -> np.ndarray:
    """Exact-color matching (uavid.py:26-34 / isaid.py:38-48).
    palette: {class_idx: (r, g, b)}; remap: optional {idx: idx} rewrite
    (e.g. UAVid Moving_Car -> Static_Car)."""
    out = np.zeros(arr_3d.shape[:2], dtype=np.uint8)
    for idx, color in palette.items():
        m = np.all(arr_3d == np.array(color).reshape(1, 1, 3), axis=2)
        out[m] = remap.get(idx, idx) if remap else idx
    return out


def tile_image(image: np.ndarray, out_dir: str, stem: str, clip_size: int,
               stride_size: int, suffix: str = ".png",
               pad_val: int | None = None) -> int:
    """Write overlapping crops named `{stem}_{x1}_{y1}_{x2}_{y2}{suffix}`.

    If the image is smaller than clip_size in a dimension and pad_val is
    given, it is padded (isaid.py:108-124 pads labels with 255)."""
    h, w = image.shape[:2]
    if pad_val is not None and (h < clip_size or w < clip_size):
        ph, pw = max(h, clip_size), max(w, clip_size)
        pad_shape = (ph, pw) + image.shape[2:]
        padded = np.full(pad_shape, pad_val, image.dtype)
        padded[:h, :w] = image
        image, h, w = padded, ph, pw
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for x1, y1, x2, y2 in clip_boxes(h, w, clip_size, stride_size):
        crop = image[y1:y2, x1:x2]
        save_png(crop, os.path.join(out_dir, f"{stem}_{x1}_{y1}_{x2}_{y2}{suffix}"))
        n += 1
    return n


def save_png(arr: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(arr.astype(np.uint8)).save(path)
