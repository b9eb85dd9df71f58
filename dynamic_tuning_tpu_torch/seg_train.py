"""Semantic-segmentation entry point of the port (counterpart of the
repository's seg_train.py: ADE20K, UperNet + DyT ViT, the our_vit.py
recipe), evaluation only.

    python -m dynamic_tuning_tpu_torch.seg_train --eval --dataset synthetic \
        --crop_size 512
    python -m dynamic_tuning_tpu_torch.seg_train --eval --data_path ADE \
        --finetune vit_base_patch16_224_in21k.pth

Same flags and defaults as ``seg_train.py``.  ``--eval`` runs slide
inference (crop ``--crop_size``, stride ``--slide_stride``) over the
validation split and prints mIoU and pixel accuracy; without ``--eval`` it
raises (training is a later slice).  Weights are random from ``--seed``
unless ``--finetune`` names a ``.pth`` backbone or ``--eval_ckpt`` a port
segmentor state dict.  Runs on the CUDA device and raises when there is
none; ``--device cpu`` runs it on the CPU (fp32 or bf16, plain versions of
the kernels).
"""

from __future__ import annotations

import argparse
import logging

import torch

from dynamic_tuning_tpu_torch.cli import add_common_args, resolve_device
from dynamic_tuning_tpu_torch.config import (ModelConfig, SelectConfig,
                                             TuningConfig)
from dynamic_tuning_tpu_torch.train.seg_runner import SegRunner

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    p.add_argument("--launcher", default="none", help="ignored (no launcher)")
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
                   help="head norm: gn, or bn (running statistics)")
    p.add_argument("--seg_head_channels", type=int, default=0,
                   help="opt-in narrower UPerHead width; 0 = reference "
                        "parity (embed_dim)")
    return p


def build_runner(args, log=print) -> SegRunner:
    device = resolve_device(args.device, "seg_train.py")
    dtype = _DTYPES[args.compute_dtype]
    if device.type == "cuda" and dtype != torch.bfloat16:
        raise NotImplementedError("--compute_dtype float32 runs on the CPU "
                                  "only: the kernels take bf16")
    model = ModelConfig(img_size=args.crop_size, num_classes=args.nb_classes,
                        drop_path_rate=args.drop_path,
                        gelu_approx=args.gelu_approx,
                        residual_dtype=args.residual_dtype, quant=args.quant)
    tuning = TuningConfig(ffn_adapt=args.ffn_adapt, ffn_num=args.ffn_num,
                          ffn_adapter_scalar=args.adapter_scalar,
                          moe_experts=args.moe_experts)
    select = SelectConfig(open=not args.no_select,
                          keep_layers=args.keep_layers,
                          token_target_ratio=args.token_target_ratio,
                          token_loss_ratio=args.token_loss_ratio,
                          capacity_ratio=args.capacity_ratio)
    return SegRunner(model, tuning, select, dataset=args.dataset,
                     data_path=args.data_path, finetune=args.finetune,
                     seed=args.seed, crop=args.crop_size,
                     slide_stride=args.slide_stride,
                     tile_batch=args.slide_tile_batch, norm=args.seg_norm,
                     head_channels=args.seg_head_channels, dtype=dtype,
                     device=device, log=log)


def main(args):
    if not args.eval:
        raise NotImplementedError("segmentation training is not ported yet "
                                  "(ROADMAP.md, queue 1 item 5); pass --eval")
    if args.config and not args.config.endswith("our_vit.py"):
        logging.getLogger("dynamic_tuning_tpu_torch").warning(
            "config file %r is NOT read: the built-in defaults are "
            "our_vit.py's values", args.config)
    runner = build_runner(args)
    if args.eval_ckpt:
        runner.load_eval_checkpoint(args.eval_ckpt)
    return runner.evaluate()


if __name__ == "__main__":
    main(get_args_parser().parse_args())
