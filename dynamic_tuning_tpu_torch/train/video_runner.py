"""The video training runner (counterpart of
dynamic_tuning_tpu/train/video_runner.py; reference main_video.py and
engine_finetune.py train_video_one_epoch :109-203, evaluate_video
:282-356).

The image ``Runner`` with clips: the data (``data/video.py``), the model
(``models/video_vit.py``), the freeze rule (the query token and the
attentive pooling train beside adapters, routers and head; ``--fulltune``
trains everything), the clip augmentation on the device
(``data/video_transforms.py``: the draws from a host generator seeded by
(seed, step)) and a multi-view eval.  The train loop, the engine, the
optimizer and its schedule, checkpoints, resume and ``final_checkpoint.msgpack``
are the image runner's.

Eval: the val loader yields ``[B, V, T, H, W, C]`` clips of V views in
batches of half the train batch; the views fold into the batch, each view
is centre-cropped on the device (or only normalized when the dataset cut
it already), the model runs on B * V * T frames, and each clip's logits are
the mean of its views' (engine_finetune.py:302-305).  The keep ratio and
GFLOPs come from the per-frame gates (T rows a clip, one per frame group
with a tubelet stem): GFLOPs a clip are the sum over its frames, each batch
averaged, then the batches averaged (engine_finetune.py:341-352).  With
``save_views_dir`` each view's logits are written for
``utils/multiview.merge_view_outputs``, one file a process, under global
clip ids (rank r's local clip p is clip p * world + r of the strided
shards).  Across processes the image runner's rules hold: the ranks' clips
padded with label -1 and dropped, logits and labels gathered on the host,
the keep ratio and GFLOPs each process's own.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dynamic_tuning_tpu_torch.data.loader import make_loader
from dynamic_tuning_tpu_torch.data.video import build_video_dataset
from dynamic_tuning_tpu_torch.data.video_transforms import augment_clip_batch
from dynamic_tuning_tpu_torch.models.layers import fold_in
from dynamic_tuning_tpu_torch.models.video_vit import VideoVisionTransformer
from dynamic_tuning_tpu_torch.ops.flops import (batch_select_flops,
                                                dense_vit_flops)
from dynamic_tuning_tpu_torch.parallel import mesh as P
from dynamic_tuning_tpu_torch.train import optim
from dynamic_tuning_tpu_torch.train.runner import Runner
from dynamic_tuning_tpu_torch.utils.metrics import topk_accuracy
from dynamic_tuning_tpu_torch.utils.multiview import save_view_outputs


class VideoRunner(Runner):
    """Trains and evaluates one video run on ``device`` (the card unless
    the caller asks for the CPU)."""

    ENTRY = "the video runner"
    MODEL = VideoVisionTransformer

    def _build_data(self) -> None:
        cfg, d = self.cfg, self.cfg.data
        train_ds, val_ds, self.nb_classes = build_video_dataset(
            d.dataset, d.data_path, clip_len=d.num_frames,
            sampling_rate=d.sampling_rate,
            test_num_segment=d.test_num_segment,
            test_num_crop=d.test_num_crop, spatial_size=cfg.model.img_size)
        self.metric_name = "accuracy"
        shards = dict(process_index=self.rank, process_count=self.world)
        self.train_loader = make_loader(
            train_ds, d.batch_size, shuffle=True, drop_last=True,
            seed=cfg.seed, num_workers=d.num_workers, **shards)
        self.val_loader = make_loader(val_ds, max(d.batch_size // 2, 1),
                                      shuffle=False,
                                      num_workers=d.num_workers,
                                      sentinel_pad=True, **shards)

    @staticmethod
    def trainable_predicate(name: str) -> bool:
        # the video additions train too (video_runner.py:142-146)
        return (optim.default_trainable_predicate(name)
                or name.split(".")[0] in ("query_token", "attentive_blocks"))

    def _device_batch(self, clips: np.ndarray, labels: np.ndarray,
                      train: bool, step: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The host clips on the device (one copy), augmented there; eval
        batches [B, V, ...] come back as [B * V, ...]."""
        d, crop = self.cfg.data, self.model_cfg.img_size
        x = torch.from_numpy(clips).to(self.device, non_blocking=True)
        y = torch.from_numpy(labels).to(self.device, torch.int64,
                                        non_blocking=True)
        if not train:
            x = x.reshape(-1, *x.shape[2:])
            return augment_clip_batch(
                None, x, crop=crop, inception=d.inception_norm, train=False,
                pre_cropped=x.shape[2] == crop), y
        gen = torch.Generator().manual_seed(fold_in(self.aug_seed, step))
        return augment_clip_batch(
            gen, x, crop=crop, inception=d.inception_norm, train=True,
            flip=d.mirror, randaug=d.randaug,
            resize_type=d.train_resize_type, min_size=d.jitter_min or 256,
            max_size=d.jitter_max or 320, shard=(self.rank, self.world)), y

    def evaluate(self, save_views_dir: Optional[str] = None
                 ) -> Dict[str, float]:
        mc = self.model_cfg
        T = self.model.frames_per_clip(self.cfg.data.num_frames)
        all_logits, all_labels, gflops, keeps = [], [], [], []
        for clips, labels in self.val_loader:
            B, V = clips.shape[0], clips.shape[1]
            xb, _ = self._device_batch(clips, labels, train=False)
            logits, token_select = self.eval_step(xb)
            valid = labels >= 0            # the shard's sentinel pads
            labels = labels[valid]
            nB = len(labels)
            per_view = logits.float().cpu().numpy().reshape(B, V, -1)[valid]
            if save_views_dir and nB:
                # global clip ids (the strided shards); this rank's first
                # batch starts its file anew
                first = sum(map(len, all_labels))
                ids = np.arange(first, first + nB) * self.world + self.rank
                save_view_outputs(save_views_dir, self.rank,
                                  np.repeat(ids, V),
                                  per_view.reshape(nB * V, -1),
                                  np.repeat(labels, V), append=first > 0)
            all_logits.append(per_view.mean(axis=1))
            all_labels.append(labels)
            if token_select is not None and nB:
                ts = token_select.float().cpu().numpy()   # [B*V*T, L, N-1, 1]
                ts = ts.reshape(B, -1, *ts.shape[1:])[valid]
                ts = ts.reshape(-1, *ts.shape[2:])
                keeps.append(ts.mean())
                g = batch_select_flops(
                    ts, T=mc.seq_len, dim=mc.embed_dim,
                    mlp_ratio=mc.mlp_ratio, bottleneck=self.cfg.tuning.ffn_num,
                    num_classes=self.nb_classes, depth=mc.depth)
                gflops.append(g.reshape(-1, T).sum(-1).mean())
        logits = P.gather_rows(np.concatenate(all_logits))
        labels = P.gather_rows(np.concatenate(all_labels))
        acc1, acc5 = topk_accuracy(logits, labels,
                                   (1, min(5, self.nb_classes)))
        stats = {"acc1": acc1, "acc5": acc5, "metric": acc1}
        if gflops:
            dense = dense_vit_flops(mc.seq_len, mc.depth, mc.embed_dim,
                                    mc.mlp_ratio,
                                    num_classes=self.nb_classes) * T
            stats["gflops_per_clip"] = float(np.mean(gflops))
            stats["flops_ratio_vs_dense"] = stats["gflops_per_clip"] / dense
            stats["keep_ratio"] = float(np.mean(keeps))
        self.logger.info("eval: " + json.dumps(
            {k: round(float(v), 4) for k, v in stats.items()}))
        return stats
