"""RandomAugment for BLIP training pipelines: a copy of rs_ov/data/randaugment.py
(numpy RandomState and PIL, imported where an op runs), which gives the same
bytes for a seed.

Reference: BLIP/transform/randaugment.py — a cv2 re-implementation of the
PIL ops ("same output as PIL.ImageOps.*" per its own docstrings), used by
BLIP's train scripts as ``RandomAugment(2, 5, isPIL=True, augs=[...])``.
This module implements the same surface directly on PIL/numpy (no cv2):
N ops sampled per image from the requested list, each applied
at magnitude-indexed strength (the reference's ``arg_dict`` level tables,
:245-312).

Ops: Identity, AutoContrast, Equalize, Rotate, Solarize, Color, Contrast,
Brightness, Sharpness, ShearX, ShearY, TranslateX, TranslateY, Posterize.
"""

from __future__ import annotations

import numpy as np

__all__ = ["RandomAugment"]


def _to_pil(img):
    from PIL import Image

    if isinstance(img, Image.Image):
        return img
    return Image.fromarray(np.asarray(img, np.uint8))


# magnitude level -> op argument, matching the reference's arg tables
# (randaugment.py:245-312): level is in [0, 10); translate is a fraction
# of the reference's 32px-based table scaled to the actual image size.
def _level_args(level: float):
    return {
        "Identity": (),
        "AutoContrast": (),
        "Equalize": (),
        "Rotate": (level / 10 * 30,),
        "Solarize": (int(level / 10 * 256),),
        "Color": (1.0 + level / 10 * 0.9,),
        "Contrast": (1.0 + level / 10 * 0.9,),
        "Brightness": (1.0 + level / 10 * 0.9,),
        "Sharpness": (1.0 + level / 10 * 0.9,),
        "ShearX": (level / 10 * 0.3,),
        "ShearY": (level / 10 * 0.3,),
        "TranslateX": (level / 10 * 0.45,),  # fraction of width
        "TranslateY": (level / 10 * 0.45,),
        "Posterize": (int(level / 10 * 4),),
    }


class RandomAugment:
    """``RandomAugment(N, M, isPIL=..., augs=[...])`` — the reference's
    constructor surface. __call__ takes an HWC uint8 array (or PIL image)
    and returns an HWC uint8 array with N randomly-chosen ops applied at
    magnitude M."""

    def __init__(self, N: int = 2, M: int = 10, isPIL: bool = False,
                 augs=None, seed: int | None = None):
        self.n = N
        self.m = M
        self.is_pil = isPIL
        self.augs = list(augs) if augs else list(_level_args(0).keys())
        self.rng = np.random.RandomState(seed)

    def _apply(self, img, name: str, args: tuple):
        from PIL import Image, ImageEnhance, ImageOps

        w, h = img.size
        if name == "Identity":
            return img
        if name == "AutoContrast":
            return ImageOps.autocontrast(img)
        if name == "Equalize":
            return ImageOps.equalize(img)
        if name == "Rotate":
            deg = args[0] * (1 if self.rng.rand() < 0.5 else -1)
            return img.rotate(deg, resample=Image.NEAREST)
        if name == "Solarize":
            return ImageOps.solarize(img, 256 - args[0])
        if name == "Color":
            return ImageEnhance.Color(img).enhance(args[0])
        if name == "Contrast":
            return ImageEnhance.Contrast(img).enhance(args[0])
        if name == "Brightness":
            return ImageEnhance.Brightness(img).enhance(args[0])
        if name == "Sharpness":
            return ImageEnhance.Sharpness(img).enhance(args[0])
        if name == "ShearX":
            s = args[0] * (1 if self.rng.rand() < 0.5 else -1)
            return img.transform((w, h), Image.AFFINE, (1, s, 0, 0, 1, 0))
        if name == "ShearY":
            s = args[0] * (1 if self.rng.rand() < 0.5 else -1)
            return img.transform((w, h), Image.AFFINE, (1, 0, 0, s, 1, 0))
        if name == "TranslateX":
            t = int(args[0] * w) * (1 if self.rng.rand() < 0.5 else -1)
            return img.transform((w, h), Image.AFFINE, (1, 0, t, 0, 1, 0))
        if name == "TranslateY":
            t = int(args[0] * h) * (1 if self.rng.rand() < 0.5 else -1)
            return img.transform((w, h), Image.AFFINE, (1, 0, 0, 0, 1, t))
        if name == "Posterize":
            return ImageOps.posterize(img, max(1, 8 - args[0]))
        raise ValueError(f"unknown augment op {name!r}")

    def __call__(self, img):
        pil = _to_pil(img).convert("RGB")
        names = self.rng.choice(self.augs, self.n, replace=True)
        level = self.m + self.rng.rand()  # reference samples within the bin
        level = min(level, 10.0)
        table = _level_args(level)
        for name in names:
            pil = self._apply(pil, str(name), table[str(name)])
        return np.asarray(pil, np.uint8)
