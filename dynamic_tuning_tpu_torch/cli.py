"""The reference's CLI surface for the port's entry points (counterpart of
``add_common_args`` and ``add_reference_compat_args`` in
dynamic_tuning_tpu/cli.py).

``add_common_args`` is the training entry points' shared flag set, with the
JAX package's names and defaults; an entry point reads the flags its slice
runs and accepts the rest.  The reference's launch scripts pass launcher and
DDP flags to every entry point; ``add_reference_compat_args`` accepts them
so those scripts run unchanged.  ``--model`` and ``--log_dir`` keep their
meaning, ``--device`` is read by the entry points that can run on the CPU;
the rest are accepted and do nothing here.
"""

from __future__ import annotations

import argparse

import torch


def add_common_args(parser: argparse.ArgumentParser):
    """The flags every training entry point shares (the JAX package's
    ``add_common_args``), then ``add_reference_compat_args``."""
    a = parser.add_argument
    a("--batch_size", default=128, type=int, help="Batch size per process")
    a("--epochs", default=100, type=int)
    a("--accum_iter", default=1, type=int)
    a("--weight_decay", type=float, default=0.01)
    a("--clip_grad", type=float, default=None)
    a("--lr", type=float, default=None)
    a("--blr", type=float, default=1e-3)
    a("--min_lr", type=float, default=0.0)
    a("--warmup_epochs", type=float, default=20)
    a("--finetune", default="", help="pretrained ckpt path")
    a("--dataset", default="cifar100")
    a("--data_path", default="")
    a("--nb_classes", default=1000, type=int)
    a("--output_dir", default="./output_dir")
    a("--seed", default=0, type=int)
    a("--resume", default="")
    a("--ckpt_backend", default="msgpack", choices=["msgpack", "orbax"])
    a("--auto_remove", action="store_true", default=True)
    a("--no_auto_remove", dest="auto_remove", action="store_false")
    a("--eval", action="store_true")
    a("--eval_ckpt", type=str, default="")
    a("--num_workers", default=4, type=int)
    a("--eval_freq", default=1, type=int)
    a("--save_freq", default=1, type=int)
    a("--drop_path", type=float, default=0.0)
    a("--inception", action="store_true")
    a("--canvas", type=int, default=None)
    a("--fulltune", action="store_true")
    a("--ffn_adapt", action="store_true", default=True)
    a("--ffn_num", default=64, type=int)
    a("--adapter_scalar", default="0.1", type=str)
    a("--moe_experts", default=0, type=int,
      help="N>1 enables the MoE-enhanced adapter")
    a("--token_target_ratio", type=float, default=0.5)
    a("--token_loss_ratio", type=float, default=2.0)
    a("--keep_layers", type=int, default=0)
    a("--no_select", action="store_true",
      help="disable the token dispatcher")
    a("--capacity_ratio", type=float, default=None)
    a("--eval_dispatch", action="store_true")
    a("--model_parallel", type=int, default=1)
    a("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    a("--gelu_approx", action="store_true", help="tanh GELU")
    a("--residual_dtype", default="float32", choices=["float32", "bfloat16"],
      help="residual-stream dtype (bfloat16 = fast)")
    a("--remat", nargs="?", const="full", default=False,
      choices=["full", "scores"], help="training option")
    a("--quant", default="none", choices=["none", "int8", "int8_attn"],
      help="int8 = W8A8 serving matmuls (eval paths only)")
    add_reference_compat_args(parser)
    return parser


def add_reference_compat_args(parser: argparse.ArgumentParser):
    """Accept the rest of the reference CLI surface (main_image.py:40-131,
    main_video.py:40-150, speed.py, main_vtab.py)."""
    g = parser.add_argument_group("reference compatibility")
    g.add_argument("--model", default="vit_base_patch16_224_in21k",
                   help="model name (the reference ships this family)")
    g.add_argument("--log_dir", default="",
                   help="TensorBoard event dir (default: output_dir)")
    g.add_argument("--start_epoch", default=0, type=int,
                   help="first epoch index when not resuming")
    g.add_argument("--cls_token", action="store_true", default=True,
                   help="satisfied: CLS pooling is the live mode")
    g.add_argument("--dist_eval", action="store_true",
                   help="accepted; no effect here")
    g.add_argument("--pin_mem", action="store_true", default=True,
                   help="accepted; no effect here")
    g.add_argument("--no_pin_mem", action="store_false", dest="pin_mem")
    g.add_argument("--device", default=None,
                   help="cuda (the default) or cpu, for the entry points "
                        "that can run on the CPU (seg_train.py, "
                        "predict.py); speed.py "
                        "runs on the current CUDA device")
    g.add_argument("--world_size", default=None, type=int,
                   help="ignored (no launcher)")
    g.add_argument("--local_rank", default=None, type=int,
                   help="ignored (no launcher)")
    g.add_argument("--dist_on_itp", action="store_true",
                   help="ignored (no launcher)")
    g.add_argument("--dist_url", default=None, help="ignored (no launcher)")
    g.add_argument("--global_pool", action="store_true",
                   help="declared but never read by the reference; accepted")
    g.add_argument("--vpt", action="store_true",
                   help="declared but never read by the reference; accepted")
    g.add_argument("--vpt_num", default=1, type=int, help="see --vpt")
    return parser


def resolve_device(name, entry: str) -> torch.device:
    """``--device``: CUDA unless the caller asks for the CPU; raises when
    CUDA is asked for and there is no card."""
    dev = torch.device(name or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{entry} runs on the GPU and found no CUDA "
                           "device (pass --device cpu to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: cuda or cpu")
    return dev
