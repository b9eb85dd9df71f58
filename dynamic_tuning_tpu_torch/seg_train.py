"""Semantic-segmentation entry point of the port (counterpart of the
repository's seg_train.py: ADE20K, UperNet + DyT ViT, the our_vit.py
recipe): training and evaluation.

    python -m dynamic_tuning_tpu_torch.seg_train --dataset synthetic \
        --crop_size 512 --total_iters 16 --eval_interval 8
    python -m dynamic_tuning_tpu_torch.seg_train --data_path ADE \
        --finetune vit_base_patch16_224_in21k.pth
    python -m dynamic_tuning_tpu_torch.seg_train --eval --data_path ADE \
        --eval_ckpt output_dir/checkpoint-16000.msgpack

Same flags and defaults as ``seg_train.py``: crop 512, AdamW 1e-3 weight
decay 0.05, poly LR with a 1500-iteration warmup, 160k iterations at batch
2, drop path 0.1, a slide evaluation (crop ``--crop_size``, stride
``--slide_stride``) every ``--eval_interval`` iterations and at the end,
``checkpoint-{iter}.msgpack`` (with ``--seg_norm bn`` and its
``aux-batch_stats-{iter}.msgpack``, the JAX runner's files) in
``--output_dir`` when the mIoU is at least the best so far; ``--resume``
continues from one (or from a ``.pth`` of earlier port runs).  ``--eval``
only evaluates (``--eval_ckpt``: such a checkpoint or a whole segmentor's
weights).
``--seg_norm bn`` trains the heads' BatchNorm; ``--quant int8`` trains in
bf16 and evaluates in int8; ``--remat`` recomputes each block in the
backward.  Weights are random from ``--seed`` unless ``--finetune`` names
a ``.pth`` backbone or a ``.msgpack`` segmentor.  Runs on the CUDA
device and raises when there is none; ``--device cpu`` runs it on the CPU
(fp32 or bf16, plain versions of the kernels), e.g. at a toy crop:

    python -m dynamic_tuning_tpu_torch.seg_train --dataset synthetic \
        --crop_size 32 --device cpu --compute_dtype float32 \
        --total_iters 4 --eval_interval 2 --output_dir /tmp/seg

``torchrun --nproc_per_node=N -m dynamic_tuning_tpu_torch.seg_train ...``
trains on N cards, ``--batch_size`` crops each (``parallel/``; the heads'
BatchNorm normalises over the global batch).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

from dynamic_tuning_tpu_torch.cli import (add_common_args, args_to_config,
                                          resolve_device)
from dynamic_tuning_tpu_torch.parallel.multihost import \
    maybe_initialize_distributed
from dynamic_tuning_tpu_torch.train.seg_runner import SegRunner


def get_args_parser():
    p = argparse.ArgumentParser("DyT segmentation (PyTorch/CUDA)",
                                add_help=False)
    p = add_common_args(p)
    # the reference CLI is an mmcv config-file front-end; our defaults ARE
    # our_vit.py's values, so the recipe config needs no interpretation
    p.add_argument("config", nargs="?", default="",
                   help="mmcv config path (reference CLI compatibility); "
                        "our_vit.py's values are the built-in defaults -- "
                        "other config files are not read (warned)")
    p.add_argument("--launcher", default="none",
                   help="ignored (the topology comes from the environment)")
    p.set_defaults(dataset="ade20k", batch_size=2, lr=1e-3, weight_decay=0.05,
                   drop_path=0.1)
    p.add_argument("--crop_size", type=int, default=512)
    p.add_argument("--total_iters", type=int, default=160_000)
    p.add_argument("--eval_interval", type=int, default=16_000)
    p.add_argument("--slide_stride", type=int, default=341)
    p.add_argument("--slide_tile_batch", type=int, default=1,
                   help="window tiles per forward (default 1 = the "
                        "reference's one-at-a-time cadence)")
    p.add_argument("--seg_norm", default="gn", choices=["gn", "bn"],
                   help="head norm: gn, or bn (batch statistics in "
                        "training, running statistics in eval)")
    p.add_argument("--seg_head_channels", type=int, default=0,
                   help="opt-in narrower UPerHead width; 0 = reference "
                        "parity (embed_dim)")
    return p


def build_runner(args, log=None) -> SegRunner:
    device = resolve_device(args.device, "seg_train.py")
    cfg = args_to_config(args)
    # extend the flags' ModelConfig, as seg_train.py does
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, img_size=args.crop_size, drop_path_rate=args.drop_path))
    return SegRunner(cfg, total_iters=args.total_iters,
                     eval_interval=args.eval_interval, crop=args.crop_size,
                     slide_stride=args.slide_stride,
                     tile_batch=args.slide_tile_batch, norm=args.seg_norm,
                     head_channels=args.seg_head_channels, device=device,
                     log=log)


def main(args):
    maybe_initialize_distributed(args.device)
    if args.config and not args.config.endswith("our_vit.py"):
        logging.getLogger("dynamic_tuning_tpu_torch").warning(
            "config file %r is NOT read: the built-in defaults are "
            "our_vit.py's values", args.config)
    runner = build_runner(args)
    if args.eval:
        if args.eval_ckpt:
            runner.load_eval_checkpoint(args.eval_ckpt)
        return runner.evaluate()
    return runner.run()


if __name__ == "__main__":
    main(get_args_parser().parse_args())
