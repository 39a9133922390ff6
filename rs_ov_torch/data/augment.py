"""Train-side image augmentation (rs_ov/data/augment.py, the open_clip
AugmentationCfg surface): random-resized crop with scale / ratio sampling,
horizontal flip, colour jitter, random grayscale. numpy and PIL on the host;
every draw comes from one explicit ``np.random.RandomState``."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

__all__ = ["AugmentationCfg", "build_train_transform"]


@dataclasses.dataclass
class AugmentationCfg:
    scale: Tuple[float, float] = (0.9, 1.0)
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    color_jitter: Optional[Tuple[float, float, float]] = None  # (b, c, s)
    gray_scale_prob: float = 0.0
    horizontal_flip_prob: float = 0.0


def _random_resized_crop(rng, img, size, scale, ratio):
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            y = rng.randint(0, h - ch + 1)
            x = rng.randint(0, w - cw + 1)
            crop = img[y:y + ch, x:x + cw]
            break
    else:
        s = min(h, w)
        y, x = (h - s) // 2, (w - s) // 2
        crop = img[y:y + s, x:x + s]
    from PIL import Image

    return np.asarray(Image.fromarray(crop).resize((size, size), Image.BICUBIC))


def _jitter(rng, img, cfg):
    x = img.astype(np.float32)
    if cfg.color_jitter:
        b, c, s = cfg.color_jitter
        x = x * rng.uniform(1 - b, 1 + b)
        mean = x.mean(axis=(0, 1), keepdims=True)
        x = (x - mean) * rng.uniform(1 - c, 1 + c) + mean
        gray = x @ np.array([0.299, 0.587, 0.114], np.float32)
        x = (x - gray[..., None]) * rng.uniform(1 - s, 1 + s) + gray[..., None]
    if cfg.gray_scale_prob and rng.rand() < cfg.gray_scale_prob:
        gray = x @ np.array([0.299, 0.587, 0.114], np.float32)
        x = np.repeat(gray[..., None], 3, axis=-1)
    return np.clip(x, 0, 255)


def build_train_transform(image_size: int = 224,
                          cfg: AugmentationCfg | None = None,
                          mean=None, std=None, seed: int = 0,
                          rng: np.random.RandomState | None = None):
    """HWC uint8 -> normalised CHW float32 with augmentation, drawing from
    ``rng`` (by default ``np.random.RandomState(seed)``)."""
    cfg = cfg or AugmentationCfg()
    rng = rng if rng is not None else np.random.RandomState(seed)
    mean = np.asarray(mean if mean is not None else
                      (0.48145466, 0.4578275, 0.40821073), np.float32) * 255.0
    std = np.asarray(std if std is not None else
                     (0.26862954, 0.26130258, 0.27577711), np.float32) * 255.0

    def transform(img_hwc: np.ndarray) -> np.ndarray:
        x = _random_resized_crop(rng, np.asarray(img_hwc), image_size,
                                 cfg.scale, cfg.ratio)
        if cfg.horizontal_flip_prob and rng.rand() < cfg.horizontal_flip_prob:
            x = x[:, ::-1]
        x = _jitter(rng, x, cfg)
        x = (x - mean) / std
        return np.ascontiguousarray(x.transpose(2, 0, 1))

    return transform
