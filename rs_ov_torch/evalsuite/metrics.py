"""IoU metric with mmseg's IoUMetric semantics (rs_ov/evalsuite/metrics.py).

Per class it accumulates (intersect, union, pred_area, label_area) over the
dataset, pixels whose label is ignore_index dropped, then

    IoU_c = intersect_c / union_c    mIoU = mean over classes with union > 0
    Acc_c = intersect_c / label_c    mAcc = mean over classes with label > 0
    aAcc  = sum(intersect) / sum(label).

The state is a plain [4, C] array: shards merge by summing it.
``device_confusion_update`` keeps it on the card as a [4, C] fp32 tensor.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["IoUMetric", "confusion_update", "device_confusion_update"]


def device_confusion_update(state: torch.Tensor, pred: torch.Tensor, label: torch.Tensor,
                            num_classes: int, ignore_index: int = 255) -> torch.Tensor:
    """state [4, C] fp32 plus the histogram of int predictions and labels
    [N, H, W], all on the state's device; returns the new state. Ignored
    pixels, and the intersection of mismatched pixels, count in an extra
    bin C that is sliced off. The three histograms are one ``scatter_add_``
    into int64 bins: ``torch.bincount`` on CUDA reads its input's maximum
    back to the host, a wait on the whole stream."""
    c = num_classes
    p = pred.reshape(-1).long()
    lbl = label.reshape(-1).long()
    valid = lbl != ignore_index
    pv = torch.where(valid, p, c)
    lv = torch.where(valid, lbl, c)
    inter = torch.where(pv == lv, pv, c)
    idx = torch.stack([inter, pv, lv])
    counts = torch.zeros((3, c + 1), dtype=torch.int64, device=idx.device)
    ai, ap, al = counts.scatter_add_(1, idx, torch.ones_like(idx))[:, :c]
    return state + torch.stack([ai, ap + al - ai, ap, al]).to(state.dtype)


def confusion_update(pred: np.ndarray, label: np.ndarray, num_classes: int,
                     ignore_index: int = 255) -> np.ndarray:
    """Per-image [4, C] histogram: intersect, union, pred_area, label_area."""
    mask = label != ignore_index
    pred, label = pred[mask], label[mask]
    inter = pred[pred == label]
    area_inter = np.bincount(inter, minlength=num_classes)[:num_classes]
    area_pred = np.bincount(pred, minlength=num_classes)[:num_classes]
    area_label = np.bincount(label, minlength=num_classes)[:num_classes]
    area_union = area_pred + area_label - area_inter
    return np.stack([area_inter, area_union, area_pred, area_label]).astype(np.float64)


class IoUMetric:
    def __init__(self, num_classes: int, ignore_index: int = 255,
                 class_names: tuple[str, ...] | None = None):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.class_names = class_names
        self.state = np.zeros((4, num_classes), np.float64)

    def process(self, pred: np.ndarray, label: np.ndarray) -> None:
        self.state += confusion_update(pred.reshape(-1).astype(np.int64),
                                       label.reshape(-1).astype(np.int64),
                                       self.num_classes, self.ignore_index)

    def merge(self, state: np.ndarray) -> None:
        """Fold in the state of another shard."""
        self.state += state

    def compute(self) -> dict:
        inter, union, _, label = self.state
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = inter / union
            acc = inter / label
        result = {
            "aAcc": float(np.nansum(inter) / np.nansum(label) * 100.0),
            "mIoU": float(np.nanmean(np.where(union > 0, iou, np.nan)) * 100.0),
            "mAcc": float(np.nanmean(np.where(label > 0, acc, np.nan)) * 100.0),
            "IoU": (iou * 100.0).tolist(),
            "Acc": (acc * 100.0).tolist(),
        }
        if self.class_names:
            result["per_class"] = {n: {"IoU": float(iou[i] * 100.0), "Acc": float(acc[i] * 100.0)}
                                   for i, n in enumerate(self.class_names)}
        return result
