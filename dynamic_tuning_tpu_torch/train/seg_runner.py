"""Segmentation evaluation runner (counterpart of the evaluation half of
dynamic_tuning_tpu/train/seg_runner.py::SegRunner).

Builds the ``DyTSegmentor``, optionally imports a ``.pth`` backbone
(``--finetune``: the IN21K ViT, its pos-embed interpolated to the crop's
patch grid, as ``import_pretrained`` does) or a whole port segmentor state
dict (``--eval_ckpt``), and evaluates mIoU by slide inference (reference
test_cfg: crop 512, stride 341): per validation image, the normalized image
is slid over, the logits are resized bilinearly to the ground truth's shape
(mmseg's protocol: the prediction goes back to the original resolution,
never the GT down), arg-maxed and counted into a confusion matrix.
Training is a later slice: ``run`` raises.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dynamic_tuning_tpu_torch import paths
from dynamic_tuning_tpu_torch.checkpoint import (load_timm_state_dict,
                                                 load_torch_state_dict)
from dynamic_tuning_tpu_torch.config import (ModelConfig, SelectConfig,
                                             TuningConfig)
from dynamic_tuning_tpu_torch.data.segmentation import (build_seg_dataset,
                                                        seg_normalize)
from dynamic_tuning_tpu_torch.models.upernet import (DyTSegmentor,
                                                     slide_inference)
from dynamic_tuning_tpu_torch.utils.metrics import (confusion_matrix,
                                                    miou_from_confusion)


class SegRunner:
    """The segmentor and its validation set on ``device``, ready to
    ``evaluate``."""

    def __init__(self, model_cfg: ModelConfig, tuning: TuningConfig,
                 select: SelectConfig, *, dataset: str, data_path: str = "",
                 finetune: str = "", seed: int = 0, crop: int = 512,
                 slide_stride: int = 341, tile_batch: int = 1,
                 norm: str = "gn", head_channels: int = 0,
                 dtype=torch.bfloat16, device="cuda", log=print):
        self.crop, self.slide_stride = crop, slide_stride
        self.tile_batch = tile_batch
        self.device = torch.device(device)
        self.log = log
        _, self.val_ds, self.num_classes = build_seg_dataset(
            dataset, data_path, crop)
        self.model = DyTSegmentor(
            model_cfg, num_classes=self.num_classes, tuning=tuning,
            select=select, norm=norm, head_channels=head_channels or None,
            dtype=dtype, generator=torch.Generator().manual_seed(seed))
        if finetune:
            path = finetune
            if not os.path.exists(path):     # a DYT_CLUSTER registry key
                path = paths.checkpoint_path(finetune, fallback=finetune)
            # backbone import (reference seg_train.py:216-221)
            load_timm_state_dict(self.model.backbone,
                                 load_torch_state_dict(path), log=log)
        self.model.to(self.device)

    def load_eval_checkpoint(self, path: str) -> None:
        """A whole port segmentor state dict (``.pth``), strictly."""
        sd = load_torch_state_dict(path)
        self.model.load_state_dict(sd, strict=True)

    def _apply(self, tiles: torch.Tensor) -> torch.Tensor:
        logits, _, _ = self.model(tiles, aux_logits=False)
        return logits

    @torch.no_grad()
    def evaluate(self, max_images: Optional[int] = None) -> Dict[str, float]:
        """mIoU and pixel accuracy (percent) over the first ``max_images``
        validation images (all by default)."""
        nc = self.num_classes
        cm = np.zeros((nc, nc), np.int64)
        n = len(self.val_ds) if max_images is None else min(
            max_images, len(self.val_ds))
        for i in range(n):
            img, ann = self.val_ds[i]
            ann = np.asarray(ann)
            x = seg_normalize(img).to(self.device)
            logits = slide_inference(self._apply, x, num_classes=nc,
                                     crop=self.crop,
                                     stride=self.slide_stride,
                                     tile_batch=self.tile_batch)
            if tuple(logits.shape[:2]) != ann.shape:
                logits = F.interpolate(
                    logits.permute(2, 0, 1)[None], size=ann.shape,
                    mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
            pred = logits.argmax(dim=-1).cpu().numpy()
            cm += confusion_matrix(pred, ann, nc)
        miou, _ = miou_from_confusion(cm)
        acc = float(np.diag(cm).sum() / max(cm.sum(), 1) * 100)
        stats = {"miou": miou, "aAcc": acc, "metric": miou, "images": n}
        self.log("seg eval: " + json.dumps(
            {k: round(float(v), 4) for k, v in stats.items()}))
        return stats

    def run(self):
        raise NotImplementedError("segmentation training is not ported yet "
                                  "(ROADMAP.md, queue 1 item 5); use --eval")
