"""Segmentation metrics (counterpart of the mIoU half of
dynamic_tuning_tpu/utils/metrics.py; reference mmseg mean_iou), numpy."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def confusion_matrix(pred: np.ndarray, label: np.ndarray,
                     num_classes: int, ignore_index: int = 255) -> np.ndarray:
    """Pixel confusion matrix [label, pred]; ``ignore_index`` pixels are
    left out."""
    mask = label != ignore_index
    pred, label = pred[mask], label[mask]
    idx = label.astype(np.int64) * num_classes + pred.astype(np.int64)
    cm = np.bincount(idx, minlength=num_classes * num_classes)
    return cm.reshape(num_classes, num_classes)


def miou_from_confusion(cm: np.ndarray) -> Tuple[float, np.ndarray]:
    """mIoU (percent) + per-class IoU from an accumulated confusion matrix;
    classes that appear in neither prediction nor label are NaN and left
    out of the mean."""
    inter = np.diag(cm).astype(np.float64)
    union = cm.sum(0) + cm.sum(1) - np.diag(cm)
    iou = np.where(union > 0, inter / np.maximum(union, 1), np.nan)
    return float(np.nanmean(iou) * 100.0), iou * 100.0
