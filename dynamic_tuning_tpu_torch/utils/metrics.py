"""Classification metrics (reference util/metrics.py:4-26) and mIoU for
segmentation (reference mmseg mean_iou), numpy on the host (counterpart of
dynamic_tuning_tpu/utils/metrics.py)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def topk_accuracy(logits, labels, topk: Sequence[int] = (1,)):
    """Top-k accuracy in percent (reference util/metrics.py:4-11).  Ties
    rank as the JAX package ranks them: a stable ascending argsort,
    reversed, so of two equal logits the later class comes first."""
    logits, labels = np.asarray(logits), np.asarray(labels)
    maxk = max(topk)
    pred = np.argsort(logits, axis=-1, kind="stable")[:, ::-1][:, :maxk]
    correct = pred == labels[:, None]
    return [float(np.float32(correct[:, :k].any(axis=1).mean()) * 100.0)
            for k in topk]


def mean_per_class_accuracy(logits, labels, num_classes: int) -> float:
    """Mean per-class recall in percent over all ``num_classes`` (reference
    util/metrics.py:14-26): a class absent from ``labels`` counts 0."""
    pred = np.argmax(np.asarray(logits), axis=-1)
    labels = np.asarray(labels)
    recall = np.zeros(num_classes, dtype=np.float64)
    for c in range(num_classes):
        mask = labels == c
        if mask.any():
            recall[c] = (pred[mask] == c).mean()
    return float(recall.mean() * 100.0)


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
