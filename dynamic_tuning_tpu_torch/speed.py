"""Serving throughput on the GPU (counterpart of the repository's speed.py).

    python -m dynamic_tuning_tpu_torch.speed --mode dispatch
    python -m dynamic_tuning_tpu_torch.speed --quant int8 --mode dispatch
    python -m dynamic_tuning_tpu_torch.speed --moe_experts 4 --mode dispatch

The flags and defaults of ``speed.py``: ViT-B/16 at 224^2, batch 128, bf16
compute and residual stream (``--compute_dtype float32`` for fp32 compute:
the hand kernels' fp32 forms), tanh GELU, ``--mode dispatch|mask|dense|plain``
(capacity dispatch; eval mask; the DyT model in complete_model mode; the
plain ViT without adapter or router), ``--quant none|int8|int8_attn`` (W8A8
serving in every mode, the plain ViT included), ``--moe_experts N`` (the
MoE-enhanced adapter of N experts of width ``--ffn_num``, router
temperature ``--moe_router_tau``; no effect in plain mode), ``--num_heads``
(ViT-B/16's 768 channels in 12 heads of 64, or 4 of 192, a head dim the
JAX package fuses too).  Weights are random from
``--seed`` unless ``--ckpt``/``--finetune`` names a ``.pth``.  Prints the
same JSON line as ``speed.py``; the card it ran on goes to stderr.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from dynamic_tuning_tpu_torch import paths
from dynamic_tuning_tpu_torch.cli import (add_reference_compat_args,
                                          fp32_on_card)
from dynamic_tuning_tpu_torch.checkpoint import (load_timm_state_dict,
                                                 load_torch_state_dict)
from dynamic_tuning_tpu_torch.config import (ModelConfig, SelectConfig,
                                             TuningConfig)
from dynamic_tuning_tpu_torch.models.vit import VisionTransformer
from dynamic_tuning_tpu_torch.utils.profiling import (forwards_run,
                                                      scan_throughput)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def get_args_parser():
    p = argparse.ArgumentParser("DyT speed test (PyTorch/CUDA)",
                                add_help=False)
    p.add_argument("--batch_size", default=128, type=int)
    p.add_argument("--nb_classes", default=100, type=int)
    p.add_argument("--ffn_num", default=64, type=int)
    p.add_argument("--num_heads", default=12, type=int)
    p.add_argument("--moe_experts", default=0, type=int,
                   help="MoE adapter of N experts when N > 1 (ignored in "
                        "plain mode)")
    p.add_argument("--moe_router_tau", default=1.0, type=float)
    p.add_argument("--token_target_ratio", type=float, default=0.5)
    p.add_argument("--capacity_ratio", type=float, default=None)
    p.add_argument("--mode", default="dispatch",
                   choices=["dispatch", "mask", "dense", "plain"])
    p.add_argument("--ckpt", default="", help="optional trained .pth")
    p.add_argument("--warmup", default=5, type=int)
    p.add_argument("--iters", default=15, type=int)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--residual_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--gelu_approx", action="store_true", default=True)
    p.add_argument("--gelu_exact", dest="gelu_approx", action="store_false")
    p.add_argument("--quant", default="none",
                   choices=["none", "int8", "int8_attn"],
                   help="int8 = W8A8 serving matmuls and stem; int8_attn "
                        "also an int8 QK^T (every mode, plain included)")
    # the reference's speed.py reuses main_image's training parser, so its
    # measure_speed.sh passes training flags; accept them as no-ops
    p.add_argument("--eval_ckpt", dest="ckpt", default=argparse.SUPPRESS,
                   help="alias of --ckpt")
    p.add_argument("--finetune", default="",
                   help="pretrained ckpt (path or DYT_CLUSTER registry key); "
                        "used when --ckpt/--eval_ckpt not given")
    add_reference_compat_args(p)
    noop = "accepted for reference-script compatibility; no-op here"
    p.add_argument("--epochs", default=100, type=int, help=noop)
    p.add_argument("--accum_iter", default=1, type=int, help=noop)
    p.add_argument("--weight_decay", default=0.01, type=float, help=noop)
    p.add_argument("--lr", default=None, type=float, help=noop)
    p.add_argument("--blr", default=1e-3, type=float, help=noop)
    p.add_argument("--min_lr", default=0.0, type=float, help=noop)
    p.add_argument("--warmup_epochs", default=20, type=float, help=noop)
    p.add_argument("--output_dir", default="", help=noop)
    p.add_argument("--seed", default=0, type=int,
                   help="seed of the random weights and input")
    p.add_argument("--resume", default="", help=noop)
    p.add_argument("--eval", action="store_true", help=noop)
    p.add_argument("--num_workers", default=4, type=int, help=noop)
    p.add_argument("--save_freq", default=1, type=int, help=noop)
    p.add_argument("--auto_remove", action="store_true", help=noop)
    p.add_argument("--eval_freq", default=1, type=int, help=noop)
    p.add_argument("--dataset", default="cifar100", help=noop)
    p.add_argument("--drop_path", default=0.0, type=float, help=noop)
    p.add_argument("--inception", action="store_true", help=noop)
    p.add_argument("--ffn_adapt", action="store_true", default=True,
                   help=noop)
    p.add_argument("--fulltune", action="store_true", help=noop)
    return p


def build_model(args, device, state_dict=None) -> VisionTransformer:
    """The model ``--mode`` measures, on ``device``, eval mode, in
    ``--compute_dtype`` (bfloat16 or float32)."""
    sel = SelectConfig(token_target_ratio=args.token_target_ratio,
                       capacity_ratio=args.capacity_ratio)
    if args.mode == "plain":
        # the reference's dense baseline: the original ViT, no adapter and
        # no router
        sel = SelectConfig(open=False)
        tuning = TuningConfig(ffn_adapt=False)
    else:
        tuning = TuningConfig(ffn_num=args.ffn_num,
                              moe_experts=args.moe_experts,
                              moe_router_tau=args.moe_router_tau)
    model = VisionTransformer(
        ModelConfig(num_classes=args.nb_classes, num_heads=args.num_heads,
                    gelu_approx=args.gelu_approx,
                    residual_dtype=args.residual_dtype, quant=args.quant),
        tuning=tuning, select=sel, dtype=_DTYPES[args.compute_dtype],
        generator=torch.Generator().manual_seed(args.seed + 1))
    if state_dict is None:
        state_dict = _checkpoint(args)
    if state_dict is not None:
        load_timm_state_dict(model, state_dict)
    return model.to(device)


def _checkpoint(args):
    ckpt = args.ckpt or args.finetune
    if not ckpt:
        return None
    if not os.path.exists(ckpt):
        resolved = paths.checkpoint_path(ckpt, fallback="")
        if not resolved:
            print(f"WARNING: checkpoint {ckpt!r} not found (no file, no "
                  "DYT_CLUSTER registry entry) -- timing with random weights",
                  file=sys.stderr)
            return None
        ckpt = resolved
    return load_torch_state_dict(ckpt)


def main(args, state_dict=None) -> dict:
    """Time ``--mode`` on the card.  Returns the printed fields plus
    ``forwards`` (how many forwards ran), and the model, input and outputs
    of the first forward for checks by the caller."""
    if not torch.cuda.is_available():
        raise RuntimeError("speed.py measures the GPU and found no CUDA "
                           "device")
    device = torch.device("cuda")
    model = build_model(args, device, state_dict)
    g = torch.Generator(device=device).manual_seed(args.seed)
    x = torch.randn((args.batch_size, 224, 224, 3), generator=g,
                    device=device)
    kwargs = dict(complete_model=args.mode == "dense",
                  dispatch=args.mode == "dispatch")
    with fp32_on_card(args.compute_dtype, device), torch.inference_mode():
        logits, aux = model(x, **kwargs)      # builds the kernels if needed
        ips = scan_throughput(lambda: model(x, **kwargs),
                              batch=args.batch_size, iters=args.iters,
                              warmup_iters=args.warmup)
    result = {"mode": args.mode, "throughput_img_s": round(ips, 2),
              "batch_size": args.batch_size}
    print(json.dumps(result))
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})", file=sys.stderr)
    result.update(forwards=1 + forwards_run(args.iters,
                                            warmup_iters=args.warmup),
                  model=model, x=x, logits=logits, aux=aux)
    return result


if __name__ == "__main__":
    main(get_args_parser().parse_args())
