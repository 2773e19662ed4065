"""Semantic segmentation metrics: confusion matrix and per-class / mean
IoU (counterpart of `occuseg_tpu/utils/metrics.py`)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

SCANNET_CLASS_LABELS = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
)

STANFORD_CLASS_LABELS = (
    "ceiling", "floor", "wall", "beam", "column", "window", "door", "table",
    "chair", "sofa", "bookcase", "board", "clutter",
)


def confusion_matrix(pred: torch.Tensor, gt: torch.Tensor,
                     num_classes: int = 20) -> torch.Tensor:
    """[C, C] int64 counts over points with 0 <= gt < num_classes (row =
    gt, column = pred clipped to the class range); other gt values, such
    as -1 padding, are ignored."""
    gt = gt.long()
    valid = (gt >= 0) & (gt < num_classes)
    idx = gt[valid] * num_classes + pred.long()[valid].clamp(0,
                                                             num_classes - 1)
    return torch.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes)


def iou_from_confusion(conf) -> Dict[str, object]:
    conf = np.asarray(conf, np.float64)
    tp = np.diag(conf)
    fp = conf.sum(0) - tp
    fn = conf.sum(1) - tp
    denom = tp + fp + fn
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = tp / denom
    present = denom > 0
    miou = float(iou[present].mean()) if present.any() else 0.0
    return {"iou_per_class": iou, "mean_iou": miou,
            "accuracy": float(tp.sum() / max(conf.sum(), 1))}


def print_iou_table(conf, labels: Sequence[str] = SCANNET_CLASS_LABELS
                    ) -> str:
    """Per-class IoU report, one class per line, then the mean."""
    res = iou_from_confusion(conf)
    lines = ["class            IoU"]
    for name, v in zip(labels, res["iou_per_class"]):
        lines.append(f"{name:16s} {v:.4f}")
    lines.append(f"{'mean':16s} {res['mean_iou']:.4f}")
    return "\n".join(lines)
