"""Directory-walking segmentation dataset in mmseg's layout
(rs_ov/data/loader.py): (image, annotation) pairs under
``data_prefix.img_path`` / ``data_prefix.seg_map_path`` with the dataset's
suffixes, optionally sharded for data-parallel eval.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from rs_ov_torch.data.datasets import DatasetMeta, get_dataset_meta
from rs_ov_torch.data.transforms import load_annotation, load_image, preprocess_image

__all__ = ["SegSample", "SegDataset"]


@dataclass
class SegSample:
    img: np.ndarray            # [3, H, W] float32 normalised, or (raw) [H, W, 3] uint8 RGB
    seg: Optional[np.ndarray]  # [H, W] int64 labels (ignore_index 255) or None
    meta: dict


class SegDataset:
    """Iterable eval dataset. ``shard=(rank, world)`` keeps every world-th
    file from rank on, ``max_samples`` the first of those; ``raw=True``
    yields [H, W, 3] uint8, the ``predict_raw`` contract."""

    def __init__(self, dataset_type: str, img_dir: str, seg_dir: str | None = None,
                 meta: DatasetMeta | None = None, shard: tuple[int, int] = (0, 1),
                 max_samples: int | None = None, raw: bool = False):
        self.raw = raw
        self.meta = meta or get_dataset_meta(dataset_type)
        self.img_dir = img_dir
        self.seg_dir = seg_dir
        suffix = self.meta.img_suffix
        rank, world = shard
        names = sorted(f for f in os.listdir(img_dir) if f.endswith(suffix))[rank::world]
        if max_samples:
            names = names[:max_samples]
        self._stems = [n[: -len(suffix)] for n in names]

    def __len__(self) -> int:
        return len(self._stems)

    def __iter__(self) -> Iterator[SegSample]:
        for stem in self._stems:
            yield self.load(stem)

    def prefetch(self, lookahead: int = 2) -> Iterator[SegSample]:
        """Decode the next ``lookahead`` samples in a thread pool while the
        caller works on the current one."""
        with ThreadPoolExecutor(max_workers=lookahead) as pool:
            futures = [pool.submit(self.load, s) for s in self._stems[:lookahead]]
            for i in range(len(self._stems)):
                nxt = i + lookahead
                if nxt < len(self._stems):
                    futures.append(pool.submit(self.load, self._stems[nxt]))
                yield futures[i].result()
                futures[i] = None  # release the sample

    def load(self, stem: str) -> SegSample:
        img_path = os.path.join(self.img_dir, stem + self.meta.img_suffix)
        rgb = load_image(img_path)
        seg = None
        if self.seg_dir:
            seg_path = os.path.join(self.seg_dir, stem + self.meta.seg_map_suffix)
            if os.path.exists(seg_path):
                seg = load_annotation(seg_path, self.meta.reduce_zero_label,
                                      self.meta.ignore_index)
        return SegSample(img=rgb if self.raw else preprocess_image(rgb), seg=seg,
                         meta={"img_path": img_path, "ori_shape": rgb.shape[:2],
                               "img_shape": rgb.shape[:2]})
