"""Multi-view, multi-process video test outputs: save and merge
(counterpart of dynamic_tuning_tpu/utils/multiview.py; reference
engine_finetune.py:360-534).

The reference's ``final_test`` writes a text line per (clip, view) and
``merge`` reads every rank's file, averages the softmax probabilities per
clip and scores top-1/top-5.  Here each process writes one ``.npz`` shard
(ids, logits, labels) and ``merge_view_outputs`` averages the probabilities
by id.  Numpy only.
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import numpy as np


def save_view_outputs(output_dir: str, process_index: int, ids: np.ndarray,
                      logits: np.ndarray, labels: np.ndarray,
                      append: bool = True) -> str:
    """Add one process's (clip id, view logits, label) rows to its shard.
    ``append=False`` (an eval's first batch) starts the shard anew, so an
    eval rerun into the same directory does not merge the old logits."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"views_rank{process_index}.npz")
    if append and os.path.exists(path):
        old = np.load(path)
        ids = np.concatenate([old["ids"], ids])
        logits = np.concatenate([old["logits"], logits])
        labels = np.concatenate([old["labels"], labels])
    np.savez(path, ids=ids, logits=logits, labels=labels)
    return path


def merge_view_outputs(output_dir: str) -> Dict[str, float]:
    """Per-clip softmax probabilities averaged over every view and rank ->
    top-1/top-5 (reference merge / compute_video,
    engine_finetune.py:360-426)."""
    ids_all, logits_all, labels_all = [], [], []
    for path in sorted(glob.glob(os.path.join(output_dir,
                                              "views_rank*.npz"))):
        d = np.load(path)
        ids_all.append(d["ids"])
        logits_all.append(d["logits"])
        labels_all.append(d["labels"])
    if not ids_all:
        raise FileNotFoundError(f"no views_rank*.npz under {output_dir}")
    ids = np.concatenate(ids_all)
    logits = np.concatenate(logits_all).astype(np.float64)
    labels = np.concatenate(labels_all)

    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)

    uniq = np.unique(ids)
    merged = np.zeros((len(uniq), probs.shape[-1]))
    merged_labels = np.zeros(len(uniq), np.int64)
    for j, u in enumerate(uniq):
        m = ids == u
        merged[j] = probs[m].mean(0)
        merged_labels[j] = labels[m][0]

    pred = merged.argsort(-1)[:, ::-1]
    top1 = float((pred[:, 0] == merged_labels).mean() * 100)
    top5 = float((pred[:, :5] == merged_labels[:, None]).any(1).mean() * 100)
    return {"acc1": top1, "acc5": top5, "num_clips": int(len(uniq))}
