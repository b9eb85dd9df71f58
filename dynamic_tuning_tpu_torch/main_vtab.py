"""VTAB-1K fine-tuning entry point of the port (counterpart of the root
main_vtab.py; reference main_vtab.py:269,350-352 / train_vtab.sh).

    python -m dynamic_tuning_tpu_torch.main_vtab --task synthetic --epochs 1
    python -m dynamic_tuning_tpu_torch.main_vtab --task all --data_path /data/vtab

The recipe: lr 1e-3 absolute, weight decay 1e-4, 100 epochs, warmup 10,
adapter 16 at scale 1.0, batch 64, no augmentation.  ``--task`` is a task,
a comma-separated list or ``all`` (the 19 tasks); ``--dataset <task>`` also
works (the reference script's spelling).  Prints each task's best top-1
and, for several, their mean.  Runs on the card unless ``--device cpu``;
``torchrun --nproc_per_node=N -m dynamic_tuning_tpu_torch.main_vtab ...``
trains on N cards (``parallel/``).
"""

import argparse
import json

from dynamic_tuning_tpu_torch.cli import (add_common_args, args_to_config,
                                          resolve_device)
from dynamic_tuning_tpu_torch.data.vtab import VTAB_TASKS
from dynamic_tuning_tpu_torch.parallel.multihost import \
    maybe_initialize_distributed
from dynamic_tuning_tpu_torch.train.checkpoint import require_pth
from dynamic_tuning_tpu_torch.train.runner import Runner


def get_args_parser():
    parser = argparse.ArgumentParser("DyT VTAB-1K fine-tuning",
                                     add_help=False)
    parser = add_common_args(parser)
    parser.set_defaults(lr=1e-3, weight_decay=1e-4, warmup_epochs=10,
                        batch_size=64, ffn_num=16, adapter_scalar="1.0",
                        dataset="")
    parser.add_argument("--task", default="",
                        help="VTAB task name, 'all' for the 19-task sweep, "
                             "or a comma-separated subset; --dataset <task> "
                             "also works; default cifar_vtab")
    return parser


def run_task(args, task: str, device):
    args.dataset = task
    cfg = args_to_config(args, no_aug=True)
    cfg = cfg.replace(output_dir=f"{args.output_dir}/{task}")
    runner = Runner(cfg, device)
    if args.eval:
        if args.eval_ckpt:
            runner.load_eval_checkpoint(args.eval_ckpt)
        return runner.evaluate()
    return runner.run()


def main(args):
    maybe_initialize_distributed(args.device)
    device = resolve_device(args.device, "main_vtab")
    if args.eval_ckpt:
        require_pth(args.eval_ckpt)
    task = args.task or args.dataset or "cifar_vtab"
    tasks = (list(VTAB_TASKS) if task == "all"
             else [t for t in task.split(",") if t])
    results = {t: run_task(args, t, device) for t in tasks}
    # per-task best top-1 and the sweep mean (the VTAB-1K score)
    summary = {t: float(r.get("max_metric", r.get("metric")))
               for t, r in results.items()}
    if len(tasks) > 1:
        summary["mean_top1"] = sum(summary.values()) / len(tasks)
    print(json.dumps(summary, indent=2))
    return results


if __name__ == "__main__":
    main(get_args_parser().parse_args())
