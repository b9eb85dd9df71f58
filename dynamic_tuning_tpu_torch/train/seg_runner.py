"""The segmentation runner (counterpart of
dynamic_tuning_tpu/train/seg_runner.py::SegRunner): iteration-based
training on the poly schedule and mIoU evaluation by slide inference.

Reference recipe (configs/beit/upernet/our_vit.py, mmcv_custom/train_api.py):
AdamW lr 1e-3, weight decay 0.05 on every trainable tensor (no mask), poly
power 1 after a 1500-iteration linear warmup from lr * 1e-6, 160k
iterations at batch 2 of 512^2 crops, slide evaluation (crop 512, stride
341) every ``eval_interval`` iterations and at the end; a checkpoint when
the mIoU is at least the best so far.  The loss is CE(main) + 0.4 CE(aux)
+ the token budget loss (``models/upernet.py::seg_loss``).

Training is the module path (no hand kernel) with bf16 matmuls on fp32
master parameters; the freeze rule trains the adapters, routers,
relative-position tables, FPN necks and both heads
(``seg_trainable_predicate``).  With ``--seg_norm bn`` the heads' BatchNorm
normalises by batch statistics and carries its running statistics, which
go beside the checkpoint in the JAX runner's sidecar
(``aux-batch_stats-<iter>.msgpack``, restored on a resume; a ``.pth``
checkpoint of earlier runs holds them inside).  Per step, the loader's
uint8 batch is copied to the device once and normalized there; step i-1's loss parts are read on the
host after step i is enqueued.  Every draw is a function of (seed,
iteration): the loader's permutation and crops by epoch, the routers'
noise and the dropout masks by step, so a run resumed from a checkpoint
(its iteration from the optimizer's step; the epoch and the batch within
it from that) continues what an uninterrupted run would have done, bit for
bit: the step's convolutions take cuDNN's deterministic algorithms, and
the heads' resizes and pooling and the relative-position gather have
gradients summed in a fixed order (``models/upernet.py``,
``models/layers.py``).  The JAX runner restarts its data at epoch 0 on a
resume.

Evaluation: per validation image, the normalized image is slid over, the
logits are resized bilinearly to the ground truth's shape (mmseg's
protocol: the prediction goes back to the original resolution, never the
GT down), arg-maxed and counted into a confusion matrix.  ``--eval_ckpt``
takes a checkpoint of ``run`` (with its sidecar) or a whole segmentor's
weights (a ``.msgpack`` param tree or a state dict).

Across processes (``parallel/``): the loader shards by rank, the step's
draws, ``seg_loss`` and the BatchNorm statistics are the global batch's
and the gradients are summed over ranks, as in the image engine.
Evaluation strides the images by rank (rank r takes images r, r + R, ...)
and sums the ranks' confusion matrices on the host; its forwards run no
collective, so ranks may slide over different numbers of crops.  Rank 0
logs to the console and writes the checkpoints.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dynamic_tuning_tpu_torch import serialization
from dynamic_tuning_tpu_torch.checkpoint import (load_timm_state_dict,
                                                 load_torch_state_dict)
from dynamic_tuning_tpu_torch.cli import require_card_dtype, resolve_device
from dynamic_tuning_tpu_torch.config import RunConfig
from dynamic_tuning_tpu_torch.data.loader import decoder_of, make_loader
from dynamic_tuning_tpu_torch.data.segmentation import (build_seg_dataset,
                                                        seg_normalize)
from dynamic_tuning_tpu_torch.models.layers import fold_in
from dynamic_tuning_tpu_torch.models.upernet import (DyTSegmentor, seg_loss,
                                                     slide_inference)
from dynamic_tuning_tpu_torch.parallel import mesh as P
from dynamic_tuning_tpu_torch.train import checkpoint as C
from dynamic_tuning_tpu_torch.train import engine, optim
from dynamic_tuning_tpu_torch.utils.logger import create_logger
from dynamic_tuning_tpu_torch.utils.meters import MetricLogger
from dynamic_tuning_tpu_torch.utils.metrics import (confusion_matrix,
                                                    miou_from_confusion)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: trainable-name parts (besides both heads and the FPN necks)
SEG_TRAINABLE_KEYWORDS = ("adaptmlp", "mlp_token_select",
                          "relative_position_bias_table")
LOG_EVERY = 50


def poly_schedule(base_lr: float, total_iters: int, warmup_iters: int = 1500,
                  warmup_ratio: float = 1e-6, power: float = 1.0,
                  min_lr: float = 0.0) -> Callable[[int], float]:
    """mmcv's poly schedule with a linear warmup, at an update count:

    lr(s) = base * (ratio + (1 - ratio) * s / warmup)        for s < warmup
    lr(s) = (base - min) * (1 - min(s / total, 1)) ** power + min

    in float32 with the JAX schedule's operations in its order (optax
    evaluates it at the count before the increment: step 0 trains at
    ``base * ratio``)."""
    f32 = np.float32

    def sched(step: int) -> float:
        s = f32(step)
        if step < warmup_iters:
            warm = f32(1 - warmup_ratio) * s / f32(max(warmup_iters, 1))
            return float(f32(base_lr) * (f32(warmup_ratio) + warm))
        prog = np.clip(s / f32(max(total_iters, 1)), f32(0), f32(1))
        return float(f32(base_lr - min_lr)
                     * np.power(f32(1) - prog, f32(power)) + f32(min_lr))

    return sched


def seg_trainable_predicate(name: str) -> bool:
    """The segmentation freeze rule on the port's names: both heads, the
    FPN necks (``backbone.fpn*``), and every adapter, router and
    relative-position table train; the pretrained backbone is frozen (the
    reference freezes all but the keys the pretrained checkpoint lacks,
    seg_train.py:226-230)."""
    parts = name.split(".")
    if parts[0] in ("decode_head", "auxiliary_head"):
        return True
    if any(k in parts for k in SEG_TRAINABLE_KEYWORDS):
        return True
    return len(parts) > 1 and parts[1].startswith("fpn")


def _deterministic_cudnn():
    """cuDNN's deterministic convolution algorithms, the other settings as
    they are: a conv's weight gradient then sums in one order on every
    run, so a resumed run can equal an uninterrupted one bit for bit."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=False,
                   benchmark_limit=c.benchmark_limit, deterministic=True,
                   allow_tf32=c.allow_tf32)


def _bn_buffers(model: torch.nn.Module):
    """The names of the BatchNorm running statistics (none with GN)."""
    return [n for n, _ in model.named_buffers()
            if n.endswith((".running_mean", ".running_var"))]


class SegRunner:
    """Trains and evaluates the DyT segmentor on ``device`` (the card
    unless the caller asks for the CPU)."""

    def __init__(self, cfg: RunConfig, *, total_iters: int = 160_000,
                 eval_interval: int = 16_000, crop: int = 512,
                 slide_stride: int = 341, tile_batch: int = 1,
                 norm: str = "gn", head_channels: int = 0, device=None,
                 log: Optional[Callable[[str], None]] = None):
        self.cfg = cfg
        self.total_iters, self.eval_interval = total_iters, eval_interval
        self.crop, self.slide_stride = crop, slide_stride
        self.tile_batch = tile_batch
        self.device = (torch.device(device) if device is not None
                       else resolve_device(None, "seg_train.py"))
        require_card_dtype(cfg.compute_dtype, self.device, "seg_train.py")
        if cfg.resume:
            C.require_checkpoint(cfg.resume)
        self.rank, self.world = P.process_index(), P.process_count()
        self.logger = create_logger(cfg.output_dir, self.rank)
        self.log = log or self.logger.info
        self.dtype = _DTYPES[cfg.compute_dtype]

        train_ds, self.val_ds, self.num_classes = build_seg_dataset(
            cfg.data.dataset, cfg.data.data_path, crop)
        self.train_loader = make_loader(
            train_ds, cfg.data.batch_size, shuffle=True, drop_last=True,
            seed=cfg.seed, num_workers=cfg.data.num_workers,
            process_index=self.rank, process_count=self.world)
        self.log(f"process {self.rank} of {self.world} on {self.device}; "
                 f"decoder: {decoder_of(self.train_loader)}")

        self.model = DyTSegmentor(
            cfg.model, num_classes=self.num_classes, tuning=cfg.tuning,
            select=cfg.select, norm=norm, head_channels=head_channels or None,
            dtype=self.dtype, generator=torch.Generator().manual_seed(
                cfg.seed))
        if cfg.finetune.endswith(".msgpack"):
            # a whole segmentor's param tree, as the JAX runner takes it
            load_timm_state_dict(self.model, C.load_params(cfg.finetune),
                                 log=self.log)
        elif cfg.finetune:
            # backbone import (reference seg_train.py:216-221)
            load_timm_state_dict(self.model.backbone,
                                 load_torch_state_dict(cfg.finetune),
                                 log=self.log)
        self.model.to(self.device)
        named = optim.freeze(self.model, seg_trainable_predicate)
        self.log(f"seg trainable (M): "
                 f"{optim.count_params(named, False) / 1e6:.2f}")
        self.buffers = _bn_buffers(self.model)

        # optax.adamw(poly, weight_decay) with no mask, after the optional
        # global-norm clip (JAX seg_runner.py:113-118)
        self.lr_at = poly_schedule(cfg.optim.lr or 1e-3, total_iters)
        rule = optim.AdamW([p for _, p in named], self.lr_at,
                           b1=cfg.optim.betas[0], b2=cfg.optim.betas[1],
                           eps=1e-8, weight_decay=cfg.optim.weight_decay)
        opt = optim.Optimizer(named, rule, clip_grad=cfg.optim.clip_grad)
        self.state = engine.TrainState(opt, seed=fold_in(cfg.seed, 2))
        self.start_iter = 0
        self.max_miou = 0.0
        if cfg.resume:
            it, extra = C.load_checkpoint(cfg.resume, self.model, self.state)
            C.restore_aux_state(cfg.resume, self.model, self.buffers, it)
            self.start_iter = self.state.step
            # saved only on improvement: the stored mIoU is the best so far
            self.max_miou = float(extra.get("miou", 0.0))
            self.log(f"resumed from {cfg.resume} at iteration "
                     f"{self.start_iter} (best mIoU {self.max_miou:.2f})")

    # ------------------------------------------------------------------
    def train_step(self, images: torch.Tensor, labels: torch.Tensor,
                   gate_noise: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """One iteration on a normalized NHWC batch and its [B, H, W]
        labels: the training forward, ``seg_loss``, the gradients of the
        trainable tensors, the optimizer update (the BatchNorm running
        statistics moved by the forward).  Returns the loss parts
        (``loss``, ``decode_loss``, ``aux_loss``, ``token_loss``,
        ``keep_ratio`` with routers) as detached device scalars."""
        state = self.state
        draws, _ = engine.step_draws(state.seed, state.step, images.device)
        opt = state.optimizer
        with _deterministic_cudnn():
            logits, aux_logits, aux = self.model(images, training=True,
                                                 draws=draws,
                                                 gate_noise=gate_noise)
            total, parts = seg_loss(logits, aux_logits, labels, aux["loss"])
            grads = torch.autograd.grad(total, opt.params,
                                        allow_unused=True)
        parts["loss"] = total
        if aux["token_select"] is not None:
            with torch.no_grad():
                parts["keep_ratio"] = P.global_mean(
                    aux["token_select"].float())
        opt.step(P.all_reduce_grads([torch.zeros_like(p) if g is None else g
                                     for g, p in zip(grads, opt.params)]))
        state.step += 1
        return {k: v.detach() for k, v in parts.items()}

    def _device_batch(self, imgs: np.ndarray, anns: np.ndarray):
        x = torch.from_numpy(imgs).to(self.device, non_blocking=True)
        y = torch.from_numpy(anns).to(self.device, torch.int64,
                                      non_blocking=True)
        return seg_normalize(x), y

    def load_eval_checkpoint(self, path: str) -> None:
        """A checkpoint of ``run`` (its parameters and BatchNorm
        statistics) or a whole segmentor's weights, strictly."""
        C.require_checkpoint(path)
        if path.endswith(".msgpack"):
            is_ckpt = "opt_state" in serialization.read_file(path)
        else:
            blob = torch.load(path, map_location="cpu", weights_only=True)
            is_ckpt = isinstance(blob, dict) and "optimizer" in blob
        if is_ckpt:
            it, _ = C.load_checkpoint(path, self.model)
            C.restore_aux_state(path, self.model, self.buffers, it)
        else:
            self.model.load_state_dict(C.load_params(path), strict=True)

    def _apply(self, tiles: torch.Tensor) -> torch.Tensor:
        logits, _, _ = self.model(tiles, aux_logits=False)
        return logits

    @torch.no_grad()
    def evaluate(self, max_images: Optional[int] = None) -> Dict[str, float]:
        """mIoU and pixel accuracy (percent) over the first ``max_images``
        validation images (all by default), each rank sliding over its
        share."""
        nc = self.num_classes
        cm = np.zeros((nc, nc), np.int64)
        n = len(self.val_ds) if max_images is None else min(
            max_images, len(self.val_ds))
        for i in range(self.rank, n, self.world):
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
        cm = np.sum(P.gather_host(cm), axis=0)
        miou, _ = miou_from_confusion(cm)
        acc = float(np.diag(cm).sum() / max(cm.sum(), 1) * 100)
        stats = {"miou": miou, "aAcc": acc, "metric": miou, "images": n}
        self.log("seg eval: " + json.dumps(
            {k: round(float(v), 4) for k, v in stats.items()}))
        return stats

    def _save(self, it: int, miou: float) -> None:
        """The checkpoint of iteration ``it`` and the BatchNorm statistics
        in their sidecar (JAX ``seg_runner.py:277-287``)."""
        cfg = self.cfg
        C.save_checkpoint(cfg.output_dir, self.model, self.state, it,
                          extra={"miou": miou}, auto_remove=cfg.auto_remove)
        own = dict(self.model.named_buffers())
        C.save_aux_state(cfg.output_dir, "batch_stats",
                         {n: own[n] for n in self.buffers}, it,
                         auto_remove=cfg.auto_remove)

    def run(self) -> Dict[str, float]:
        """Train from ``start_iter`` to ``total_iters``; returns
        ``{"max_miou": ...}``."""
        cfg = self.cfg
        ml = MetricLogger(logger=self.logger)
        it = self.start_iter
        max_miou, t0 = self.max_miou, time.time()
        per_epoch = len(self.train_loader)
        epoch, skip = divmod(it, per_epoch)
        # step i-1's parts are read after step i is enqueued: one step in
        # flight; the iteration-50 log runs one step stale, the eval and
        # checkpoint boundaries are exact
        pending = None
        while it < self.total_iters:
            self.train_loader.set_epoch(epoch)
            for imgs, anns in self.train_loader.iter_from(skip):
                xb, yb = self._device_batch(imgs, anns)
                parts = self.train_step(xb, yb)
                if pending is not None:
                    ml.update(**{k: float(v) for k, v in pending.items()})
                pending = parts
                it += 1
                if it % LOG_EVERY == 0:
                    self.log(f"iter {it}/{self.total_iters} "
                             f"lr {self.lr_at(it - 1):.3e} {ml}")
                if it % self.eval_interval == 0 or it == self.total_iters:
                    ml.update(**{k: float(v) for k, v in pending.items()})
                    pending = None
                    stats = self.evaluate()
                    if cfg.output_dir and stats["metric"] >= max_miou:
                        self._save(it, stats["metric"])
                    max_miou = max(max_miou, stats["metric"])
                if it >= self.total_iters:
                    break
            epoch, skip = epoch + 1, 0
        self.log(f"seg training done in {time.time() - t0:.0f}s; max mIoU "
                 f"{max_miou:.2f}")
        return {"max_miou": max_miou}
