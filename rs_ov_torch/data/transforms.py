"""Image normalisation constants (rs_ov/data/transforms.py): the reference's
SegDataPreProcessor mean / std, RGB order (reference segmentor.py:64-67)."""

from __future__ import annotations

import numpy as np

__all__ = ["PREPROC_MEAN", "PREPROC_STD"]

PREPROC_MEAN = np.array([122.771, 116.746, 104.094], np.float32)
PREPROC_STD = np.array([68.501, 66.632, 70.323], np.float32)
