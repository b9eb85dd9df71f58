"""The image training runner: config -> data -> model -> engine -> eval ->
checkpoints (counterpart of dynamic_tuning_tpu/train/runner.py; reference
main_image.py:134-359 and engine_finetune.py).  One runner serves both image
entry points (full datasets and VTAB).

The loop, per train step: the loader yields a uint8 batch on the host, it is
copied to the device once, augmented there (``data/transforms.py``: the
boxes and flips drawn on the host from a generator seeded by (seed, step)),
and the train step (``train/engine.py``) runs on it.  Step i-1's loss parts
are read on the host only after step i is enqueued (``make_tb_flush``), so
one step is always in flight; the step itself reads nothing on the host.
Eval runs the deterministic gate (mask mode, or the capacity dispatch with
``eval_dispatch``), which on the card takes the serving kernels (K3 in every
DyT block; K6 + K4 with int8; K7 with the MoE adapter; K2 without the
adapter), gathers the logits on the host, and reports top-1/5, the
dataset's metric, the keep rate (overall and per layer) and the analytic
GFLOPs a sample against the dense ViT's.

The protocol is the JAX runner's: the freeze rule (adapters, routers and
head train) or ``--fulltune``; the effective batch and ``absolute_lr``; the
warmup-cosine schedule per applied step (``accum_iter``), offset by
``--start_epoch`` when not resuming; resume restores the weights, the
optimizer, the step and the best metric; a checkpoint is saved only when
the metric does not fall; ``final_checkpoint.msgpack`` at the end.  The
files are the JAX runner's (``checkpoint-<epoch>.msgpack``, read and
written by ``train/checkpoint.py``): a JAX run resumes here and a run of
the port resumes in the JAX package; ``--resume`` also takes a ``.pth`` of
earlier port runs.  Every draw
is a function of (seed, step) or (seed, epoch): the loader's permutation,
the crops and flips, the routers' noise and the dropout masks, so a resumed
run continues what an uninterrupted one would have done.

Across processes (``parallel/``; ``torchrun --nproc_per_node=N``), each
process drives one card and computes what one process computes on the
global batch: the loaders shard by rank (strided), the effective batch
counts every process (``absolute_lr`` sees batch x accum x world), the
augmentation's draws and the step's are the global batch's (each rank
keeps its rows), the step reduces over ranks (``train/engine.py``).
Evaluation pads the ranks' shards to equal length with label -1, runs
each rank's share, drops the pads and gathers logits and labels on the
host; the keep ratio and GFLOPs stay each process's own, as in the JAX
runner.  The logger's console, TensorBoard and the checkpoints belong to
rank 0 (the savers wait at a barrier); every rank reads on resume.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dynamic_tuning_tpu_torch.checkpoint import load_timm_state_dict
from dynamic_tuning_tpu_torch.cli import require_card_dtype, resolve_device
from dynamic_tuning_tpu_torch.config import RunConfig
from dynamic_tuning_tpu_torch.data.datasets import build_image_dataset
from dynamic_tuning_tpu_torch.data.loader import decoder_of, make_loader
from dynamic_tuning_tpu_torch.data.transforms import (augment_batch,
                                                      normalize_batch,
                                                      resize_batch)
from dynamic_tuning_tpu_torch.models.layers import fold_in
from dynamic_tuning_tpu_torch.models.vit import VisionTransformer
from dynamic_tuning_tpu_torch.ops.flops import (batch_select_flops,
                                                dense_vit_flops)
from dynamic_tuning_tpu_torch.parallel import mesh as P
from dynamic_tuning_tpu_torch.train import checkpoint as C
from dynamic_tuning_tpu_torch.train import engine, optim
from dynamic_tuning_tpu_torch.utils.logger import (TensorBoardWriter,
                                                   create_logger)
from dynamic_tuning_tpu_torch.utils.meters import MetricLogger
from dynamic_tuning_tpu_torch.utils.metrics import (mean_per_class_accuracy,
                                                    topk_accuracy)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_tb_flush(ml: MetricLogger, writer, steps_per_epoch: int,
                  lr_at=None):
    """The pipelined metric flush of the train loop: reads a finished
    step's loss parts into the meters and, every 20 steps, writes loss (and
    lr, given ``lr_at``) on the reference's epoch_1000x axis
    (engine_finetune.py:95-101)."""

    def flush(parts, step):
        ml.update(**{k: float(v) for k, v in parts.items()})
        if writer is not None and step % 20 == 0:
            e1000 = int((step / max(steps_per_epoch, 1)) * 1000)
            writer.add_scalar("loss", float(parts["loss"]), e1000)
            if lr_at is not None:
                writer.add_scalar("lr", float(lr_at(step)), e1000)

    return flush


class Runner:
    """Trains and evaluates one image run on ``device`` (the card unless
    the caller asks for the CPU).  ``VideoRunner`` shares all but the
    data, the model, the freeze rule, the batch transform and the eval."""

    ENTRY = "the image runner"
    MODEL = VisionTransformer

    def __init__(self, cfg: RunConfig, device=None):
        self.cfg = cfg
        self.device = (torch.device(device) if device is not None
                       else resolve_device(None, self.ENTRY))
        require_card_dtype(cfg.compute_dtype, self.device, self.ENTRY)
        if cfg.resume:
            C.require_checkpoint(cfg.resume)
        self.rank, self.world = P.process_index(), P.process_count()
        self.logger = create_logger(cfg.output_dir, self.rank)
        tb_dir = cfg.log_dir or cfg.output_dir
        self.writer = (TensorBoardWriter(tb_dir)
                       if tb_dir and self.rank == 0 else None)
        self.dtype = _DTYPES[cfg.compute_dtype]

        # data ---------------------------------------------------------------
        self._build_data()
        self.logger.info(f"process {self.rank} of {self.world} on "
                         f"{self.device}; decoder: "
                         f"{decoder_of(self.train_loader)}")

        # model --------------------------------------------------------------
        model_cfg = cfg.model
        if model_cfg.num_classes != self.nb_classes:
            model_cfg = model_cfg.__class__(**{
                **model_cfg.__dict__, "num_classes": self.nb_classes})
        self.model_cfg = model_cfg
        self.model = self.MODEL(
            model_cfg, tuning=cfg.tuning, select=cfg.select,
            dtype=self.dtype,
            generator=torch.Generator().manual_seed(cfg.seed))
        # pretrained import (a timm .pth, or a .msgpack param tree as the
        # JAX runner takes it), then the head re-drawn (main_image.py:219-247)
        if cfg.finetune:
            missing, _ = load_timm_state_dict(
                self.model, C.load_params(cfg.finetune),
                log=self.logger.info)
            self.logger.info(f"missing (stay at init): {missing}")
            C.reinit_head(self.model, torch.Generator().manual_seed(
                fold_in(cfg.seed, 1)))
        self.model.to(self.device)
        # --fulltune trains the whole backbone (main_image.py:254); else the
        # reference freeze rule: adapters, routers and head
        named = optim.freeze(self.model, (lambda _: True) if cfg.fulltune
                             else self.trainable_predicate)
        frozen = [(n, p) for n, p in self.model.named_parameters()
                  if not p.requires_grad]
        self.logger.info(
            f"trainable params (M): {optim.count_params(named) / 1e6:.2f}; "
            "frozen (M): "
            f"{optim.count_params(frozen, exclude_head=False) / 1e6:.2f}")

        # optimizer ----------------------------------------------------------
        accum = max(cfg.accum_iter, 1)
        eff_batch = cfg.data.batch_size * accum * self.world
        self.lr = lr = cfg.optim.absolute_lr(eff_batch)
        self.logger.info(f"effective batch {eff_batch}; actual lr {lr:.2e}")
        self.steps_per_epoch = len(self.train_loader)
        # the schedule advances once per applied step
        applied_per_epoch = max(self.steps_per_epoch // accum, 1)
        # --start_epoch without --resume fast-forwards the schedule (the
        # reference's lr follows the absolute epoch); a resume restores the
        # optimizer's count instead
        sched_offset = (cfg.start_epoch * applied_per_epoch
                        if cfg.start_epoch else 0)
        if cfg.resume and cfg.start_epoch:
            self.logger.warning(
                "--resume with --start_epoch: the LR schedule offset "
                f"({cfg.start_epoch} epochs) is applied on top of the "
                "restored optimizer count; pass --start_epoch here only if "
                "the resumed run itself was started with it")
        opt = optim.make_optimizer(
            named, lr, min_lr=cfg.optim.min_lr, epochs=cfg.optim.epochs,
            warmup_epochs=cfg.optim.warmup_epochs,
            steps_per_epoch=applied_per_epoch,
            weight_decay=cfg.optim.weight_decay, betas=cfg.optim.betas,
            clip_grad=cfg.optim.clip_grad, start_step=sched_offset,
            accum_iter=cfg.accum_iter)
        base_sched = optim.warmup_cosine_schedule(
            lr, cfg.optim.min_lr, cfg.optim.epochs, cfg.optim.warmup_epochs,
            applied_per_epoch)
        self.lr_at = lambda step: base_sched(step // accum + sched_offset)
        self.state = engine.TrainState(opt, seed=fold_in(cfg.seed, 2))

        self.start_epoch = cfg.start_epoch
        self.max_metric = 0.0
        if cfg.resume:
            last_epoch, extra = C.load_checkpoint(cfg.resume, self.model,
                                                  self.state)
            self.start_epoch = last_epoch + 1
            # checkpoints are saved only on improvement: the stored metric
            # is the best so far
            self.max_metric = float(extra.get("metric", 0.0))
            self.logger.info(f"resumed from {cfg.resume} at epoch "
                             f"{self.start_epoch} (best metric "
                             f"{self.max_metric:.2f})")

        self.train_step = engine.make_train_step(self.model, cfg.select)
        self.eval_step = engine.make_eval_step(self.model,
                                               dispatch=cfg.eval_dispatch)
        self.aug_seed = fold_in(cfg.seed, 3)

    # ------------------------------------------------------------------
    def _build_data(self) -> None:
        """The loaders, ``nb_classes`` and ``metric_name``."""
        cfg = self.cfg
        train_ds, val_ds, self.nb_classes, self.metric_name = \
            build_image_dataset(cfg.data.dataset, cfg.data.data_path,
                                no_aug=cfg.data.no_aug,
                                canvas=cfg.data.canvas or 0)
        shards = dict(process_index=self.rank, process_count=self.world)
        self.train_loader = make_loader(
            train_ds, cfg.data.batch_size, shuffle=True, drop_last=True,
            seed=cfg.seed, num_workers=cfg.data.num_workers, **shards)
        self.val_loader = make_loader(val_ds, cfg.data.batch_size,
                                      shuffle=False,
                                      num_workers=cfg.data.num_workers,
                                      sentinel_pad=True, **shards)

    @staticmethod
    def trainable_predicate(name: str) -> bool:
        return optim.default_trainable_predicate(name)

    def _device_batch(self, imgs: np.ndarray, labels: np.ndarray,
                      train: bool, step: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The host batch on the device (one copy), augmented there."""
        x = torch.from_numpy(imgs).to(self.device, non_blocking=True)
        y = torch.from_numpy(labels).to(self.device, torch.int64,
                                        non_blocking=True)
        s = self.model_cfg.img_size
        inception = self.cfg.data.inception_norm
        if self.cfg.data.no_aug:
            if x.shape[1] != s:   # canvas != model resolution: cubic resize
                x = resize_batch(x, s)
            return normalize_batch(x, inception), y
        gen = (torch.Generator().manual_seed(fold_in(self.aug_seed, step))
               if train else None)
        return augment_batch(gen, x, out_size=s, inception=inception,
                             train=train, shard=(self.rank, self.world)), y

    def train_one_epoch(self, epoch: int) -> Dict[str, float]:
        self.train_loader.set_epoch(epoch)
        ml = MetricLogger(logger=self.logger)
        header = f"Epoch: [{epoch}]"
        # step i-1's parts are read after step i is enqueued: one step in
        # flight; the meters run one step stale, the epoch averages exact
        step0 = self.state.step
        pending: Optional[Tuple[Dict, int]] = None
        i = 0
        flush = make_tb_flush(ml, self.writer, self.steps_per_epoch,
                              self.lr_at)
        for imgs, labels in ml.log_every(self.train_loader, 20, header):
            xb, yb = self._device_batch(imgs, labels, train=True,
                                        step=self.state.step)
            parts = self.train_step(self.state, xb, yb)
            if pending is not None:
                flush(*pending)
            i += 1
            pending = (parts, step0 + i)
        if pending is not None:
            flush(*pending)
        return {k: m.global_avg for k, m in ml.meters.items()}

    def load_eval_checkpoint(self, path: str) -> None:
        """Weights of a checkpoint for ``--eval_ckpt`` (no optimizer)."""
        C.load_checkpoint(path, self.model)

    def evaluate(self) -> Dict[str, float]:
        cfg, mc = self.cfg, self.model_cfg
        all_logits, all_labels = [], []
        keep_sum, keep_n = 0.0, 0
        layer_keep, layer_n = None, 0
        gflops_sum, gflops_n = 0.0, 0
        for imgs, labels in self.val_loader:
            xb, _ = self._device_batch(imgs, labels, train=False)
            logits, token_select = self.eval_step(xb)
            valid = labels >= 0            # the shard's sentinel pads
            all_logits.append(logits.float().cpu().numpy()[valid])
            all_labels.append(labels[valid])
            if token_select is not None and valid.any():
                layer_n += 1
                ts = token_select.float().cpu().numpy().astype(
                    np.float64)[valid]
                keep_sum += ts.sum()
                keep_n += ts.size
                per_layer = ts.mean(axis=(0, 2, 3))   # [L]
                layer_keep = (per_layer if layer_keep is None
                              else layer_keep + per_layer)
                g = batch_select_flops(
                    ts, T=mc.seq_len, dim=mc.embed_dim,
                    mlp_ratio=mc.mlp_ratio, bottleneck=cfg.tuning.ffn_num,
                    num_classes=self.nb_classes, depth=mc.depth)
                gflops_sum += g.sum()
                gflops_n += len(g)
        # every rank's rows (the JAX runner's process_allgather)
        logits = P.gather_rows(np.concatenate(all_logits))
        labels = P.gather_rows(np.concatenate(all_labels))
        acc1, acc5 = topk_accuracy(logits, labels,
                                   (1, min(5, self.nb_classes)))
        stats = {"acc1": acc1, "acc5": acc5}
        stats["metric"] = (mean_per_class_accuracy(logits, labels,
                                                   self.nb_classes)
                           if self.metric_name == "mean_per_class_acc"
                           else acc1)
        if keep_n:
            stats["keep_ratio"] = keep_sum / keep_n
            gf = gflops_sum / max(gflops_n, 1)
            dense = dense_vit_flops(mc.seq_len, mc.depth, mc.embed_dim,
                                    mc.mlp_ratio, self.nb_classes)
            stats["gflops"] = gf
            stats["flops_ratio_vs_dense"] = gf / dense
            self.logger.info(f"eval GFLOPs/sample {gf:.2f} "
                             f"({100 * gf / dense:.1f}% of dense)")
            rates = layer_keep / layer_n
            self.logger.info("per-layer keep rates: "
                             + " ".join(f"{r:.3f}" for r in rates))
        self.logger.info("eval: " + json.dumps(
            {k: round(float(v), 4) for k, v in stats.items()}))
        return stats

    def run(self) -> Dict[str, float]:
        cfg = self.cfg
        max_metric = self.max_metric
        t0 = time.time()
        for epoch in range(self.start_epoch, cfg.optim.epochs):
            train_stats = self.train_one_epoch(epoch)
            self.logger.info(f"epoch {epoch} train: " + json.dumps(
                {k: round(v, 4) for k, v in train_stats.items()}))
            if ((epoch + 1) % cfg.eval_freq == 0
                    or (epoch + 1) == cfg.optim.epochs):
                stats = self.evaluate()
                if cfg.output_dir and stats["metric"] >= max_metric:
                    C.save_checkpoint(cfg.output_dir, self.model, self.state,
                                      epoch,
                                      extra={"metric": stats["metric"]},
                                      auto_remove=cfg.auto_remove)
                max_metric = max(max_metric, stats["metric"])
                self.logger.info(f"Max metric: {max_metric:.2f}%")
        if cfg.output_dir:
            C.save_params(os.path.join(cfg.output_dir,
                                       "final_checkpoint.msgpack"),
                          self.model)
        self.logger.info(f"Training time {time.time() - t0:.0f}s; "
                         f"max metric {max_metric:.2f}")
        return {"max_metric": max_metric}
