"""Image-classification fine-tuning entry point of the port (counterpart of
the root main_image.py; reference main_image.py).

    python -m dynamic_tuning_tpu_torch.main_image --dataset synthetic
    python -m dynamic_tuning_tpu_torch.main_image --dataset synthetic --device cpu
    python -m dynamic_tuning_tpu_torch.main_image --eval --eval_ckpt out/checkpoint-0.msgpack
    torchrun --nproc_per_node=4 -m dynamic_tuning_tpu_torch.main_image \
        --dataset synthetic

The reference flag surface and recipe defaults (train_IN21K.sh: blr 1e-3,
wd 0.01, 100 epochs, warmup 20, batch 128).  Runs on the card unless
``--device cpu``.  ``--eval`` evaluates (the weights of ``--eval_ckpt``
when given) instead of training.  Under a launcher (torchrun, OpenMPI,
SLURM: ``parallel/multihost.py``) each process trains on its card
(``cuda:LOCAL_RANK``) with ``--batch_size`` images of the global batch.
"""

import argparse

from dynamic_tuning_tpu_torch.cli import (add_common_args, args_to_config,
                                          resolve_device)
from dynamic_tuning_tpu_torch.parallel.multihost import \
    maybe_initialize_distributed
from dynamic_tuning_tpu_torch.train.checkpoint import require_checkpoint
from dynamic_tuning_tpu_torch.train.runner import Runner


def get_args_parser():
    parser = argparse.ArgumentParser("DyT image fine-tuning", add_help=False)
    return add_common_args(parser)


def main(args):
    maybe_initialize_distributed(args.device)
    device = resolve_device(args.device, "main_image")
    if args.eval_ckpt:
        require_checkpoint(args.eval_ckpt)
    runner = Runner(args_to_config(args), device)
    if args.eval:
        if args.eval_ckpt:
            runner.load_eval_checkpoint(args.eval_ckpt)
        stats = runner.evaluate()
        print(f"Accuracy on the val set: {stats['acc1']:.1f}%")
        return stats
    return runner.run()


if __name__ == "__main__":
    main(get_args_parser().parse_args())
