"""Video-recognition fine-tuning entry point of the port (counterpart of the
root main_video.py; reference main_video.py, train_video.sh).

    python -m dynamic_tuning_tpu_torch.main_video --dataset synthetic
    python -m dynamic_tuning_tpu_torch.main_video --dataset synthetic --device cpu
    python -m dynamic_tuning_tpu_torch.main_video --eval --eval_ckpt out/checkpoint-0.pth

The reference flag surface and recipe defaults (train_video.sh: batch 16
clips, blr 1e-3, K400 12 epochs, warmup 2, 8 frames at stride 16, eval 3
temporal x 1 spatial views).  K400 trains with a short-side scale jitter
over [1.0, 1.15] x the crop and a flip; SSv2 (``--dataset ssv2``) with
the random resized crop, RandAugment "rand-m7-n4-mstd0.5-inc1" and no
flip (its labels name directions).  Runs on the card unless
``--device cpu``.  ``--eval`` evaluates (the weights of ``--eval_ckpt``
when given) instead of training.  ``torchrun --nproc_per_node=N -m
dynamic_tuning_tpu_torch.main_video ...`` trains on N cards
(``parallel/``).
"""

import argparse
import dataclasses

from dynamic_tuning_tpu_torch.cli import (add_common_args, args_to_config,
                                          resolve_device)
from dynamic_tuning_tpu_torch.config import DataConfig
from dynamic_tuning_tpu_torch.parallel.multihost import \
    maybe_initialize_distributed
from dynamic_tuning_tpu_torch.train.checkpoint import require_pth
from dynamic_tuning_tpu_torch.train.video_runner import VideoRunner


def get_args_parser():
    parser = argparse.ArgumentParser("DyT video fine-tuning", add_help=False)
    parser = add_common_args(parser)
    parser.set_defaults(batch_size=16, warmup_epochs=2, epochs=12,
                        dataset="k400")
    a = parser.add_argument
    a("--num_frames", type=int, default=8)
    a("--tubelet_size", type=int, default=1,
      help=">1 = VideoMAE-style 3-D tubelet patch stem")
    a("--sampling_rate", type=int, default=16)
    a("--test_num_segment", type=int, default=3)
    a("--test_num_crop", type=int, default=1)
    a("--train_resize_type", type=str, default=None,
      choices=["random_resized_crop", "random_short_side_scale_jitter"],
      help="default per dataset as the reference recipes: K400 jitter "
           "[1.0, 1.15] x crop, SSv2 random_resized_crop")
    # declared by the reference (main_video.py:117-141) and never read:
    # accepted so its launch scripts run, warned when not at the default
    dead = "declared by the reference and never read; accepted and warned"
    a("--linprob", default=True, help=dead)
    a("--use_mean_pooling", default=True, help=dead)
    a("--drop", type=float, default=0.0, help=dead)
    a("--attn_drop_rate", type=float, default=0.0, help=dead)
    a("--init_scale", type=float, default=0.001, help=dead)
    a("--num_segments", type=int, default=1, help=dead)
    a("--num_sample", type=int, default=1, help=dead)
    a("--crop_pct", type=float, default=None, help=dead)
    a("--short_side_size", type=int, default=224, help=dead)
    a("--input_size", type=int, default=224, help=dead)
    return parser


def build_config(args):
    """The parsed flags -> ``RunConfig`` with the per-dataset recipe
    defaults (the root main_video.py's ``build_config``)."""
    cfg = args_to_config(args)
    is_ssv2 = args.dataset.lower() in ("ssv2", "sthv2")
    resize_type = args.train_resize_type or (
        "random_resized_crop" if is_ssv2
        else "random_short_side_scale_jitter")
    crop = cfg.model.img_size
    return cfg.replace(
        model=dataclasses.replace(cfg.model, num_frames=args.num_frames,
                                  tubelet_size=args.tubelet_size),
        data=DataConfig(dataset=args.dataset, data_path=args.data_path,
                        batch_size=args.batch_size,
                        num_workers=args.num_workers,
                        inception_norm=args.inception,
                        num_frames=args.num_frames,
                        sampling_rate=args.sampling_rate,
                        test_num_segment=args.test_num_segment,
                        test_num_crop=args.test_num_crop,
                        randaug=("rand-m7-n4-mstd0.5-inc1"
                                 if is_ssv2 else None),
                        mirror=not is_ssv2,
                        train_resize_type=resize_type,
                        jitter_min=round(crop * 1.0),
                        jitter_max=round(crop * 1.15)))


def main(args):
    maybe_initialize_distributed(args.device)
    device = resolve_device(args.device, "main_video")
    if args.eval_ckpt:
        require_pth(args.eval_ckpt)
    runner = VideoRunner(build_config(args), device)
    if args.eval:
        if args.eval_ckpt:
            runner.load_eval_checkpoint(args.eval_ckpt)
        stats = runner.evaluate()
        print(f"Accuracy on the val set: {stats['acc1']:.1f}%")
        return stats
    return runner.run()


if __name__ == "__main__":
    main(get_args_parser().parse_args())
