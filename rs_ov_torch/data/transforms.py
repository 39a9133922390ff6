"""Image loading and preprocessing (rs_ov/data/transforms.py): the
reference's SegDataPreProcessor mean / std in RGB order (reference
segmentor.py:64-67), decoding with the port's native libpng/libjpeg copy
and PIL for what it refuses, and mmseg's reduce_zero_label.
"""

from __future__ import annotations

import io

import numpy as np

from rs_ov_torch import native

__all__ = ["PREPROC_MEAN", "PREPROC_STD", "preprocess_image", "load_image",
           "load_annotation"]

PREPROC_MEAN = np.array([122.771, 116.746, 104.094], np.float32)
PREPROC_STD = np.array([68.501, 66.632, 70.323], np.float32)


def preprocess_image(img_rgb: np.ndarray) -> np.ndarray:
    """HWC uint8/float RGB -> CHW float32 normalised."""
    return native.normalize_hwc_to_chw(img_rgb, PREPROC_MEAN, PREPROC_STD)


def _pil_open(path: str, data: bytes):
    """PIL's image of ``data``; raises naming the file when PIL is missing."""
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: the native decoder does not take this file "
                           f"and PIL is not installed to decode it") from None
    return Image.open(io.BytesIO(data))


def load_image(path: str) -> np.ndarray:
    """Decoded [H, W, 3] uint8 RGB: the native decoder where it takes the
    file, PIL otherwise (16-bit PNGs, TIFF, exotic color types)."""
    with open(path, "rb") as f:
        data = f.read()
    rgb = native.decode_rgb(data)
    if rgb is not None:
        return rgb
    return np.asarray(_pil_open(path, data).convert("RGB"))


def load_annotation(path: str, reduce_zero_label: bool = False,
                    ignore_index: int = 255) -> np.ndarray:
    """A label map as int64 [H, W] with mmseg's reduce_zero_label: 0 becomes
    ignore_index and every other label drops by one."""
    with open(path, "rb") as f:
        data = f.read()
    label = native.decode_gray(data)
    if label is None:
        label = np.asarray(_pil_open(path, data))
    label = label.astype(np.int64)
    if label.ndim == 3:
        label = label[..., 0]
    if reduce_zero_label:
        label = label.copy()
        label[label == 0] = ignore_index
        label = label - 1
        label[label == ignore_index - 1] = ignore_index
    return label
