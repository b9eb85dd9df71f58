"""The reference's CLI surface for the port's entry points (counterpart of
dynamic_tuning_tpu/cli.py).

``add_common_args`` is the training entry points' shared flag set, with the
JAX package's names and defaults; ``args_to_config`` maps it onto the
port's ``RunConfig`` field for field as the JAX package's does, with the
``paths.py`` registry lookups for ``--finetune`` and ``--data_path``.  The
reference's launch scripts pass launcher and DDP flags to every entry
point; ``add_reference_compat_args`` accepts them so those scripts run
unchanged.  ``--model``, ``--log_dir`` and ``--start_epoch`` keep their
meaning, ``--device`` is read by the entry points (``resolve_device``); the
rest are accepted and do nothing here.  The launcher flags
(``--world_size``, ``--local_rank``, ``--dist_url``) are warned about: the
process topology is discovered from the launcher's environment
(``parallel/multihost.py``; ``torchrun`` sets it).

Refused at the edges of the port: ``--model_parallel`` other than 1
(tensor parallelism is not ported yet: ``parallel.mesh.make_mesh``) and
``--ckpt_backend orbax`` (orbax and tensorstore are not installed on the
card's machine; the port writes the JAX package's ``.msgpack`` files, the
default backend).  ``--compute_dtype float32`` runs on the card as on the
CPU: the hand kernels have fp32 forms, and ``fp32_on_card`` turns TF32 off
for the run.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import logging
import os

import torch

from dynamic_tuning_tpu_torch import paths
from dynamic_tuning_tpu_torch.config import (DataConfig, ModelConfig,
                                             OptimConfig, RunConfig,
                                             SelectConfig, TuningConfig)
from dynamic_tuning_tpu_torch.parallel.mesh import make_mesh
from dynamic_tuning_tpu_torch.parallel.multihost import local_device


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
                        "that can run on the CPU (main_image.py, "
                        "main_vtab.py, main_video.py, seg_train.py, "
                        "predict.py); speed.py runs on the current CUDA "
                        "device")
    g.add_argument("--world_size", default=None, type=int,
                   help="ignored (topology discovered)")
    g.add_argument("--local_rank", default=None, type=int,
                   help="ignored (LOCAL_RANK from the launcher)")
    g.add_argument("--dist_on_itp", action="store_true",
                   help="ignored (topology discovered)")
    g.add_argument("--dist_url", default=None,
                   help="ignored (rendezvous from the launcher)")
    g.add_argument("--global_pool", action="store_true",
                   help="declared but never read by the reference; accepted")
    g.add_argument("--vpt", action="store_true",
                   help="declared but never read by the reference; accepted")
    g.add_argument("--vpt_num", default=1, type=int, help="see --vpt")
    return parser


#: the one model family the reference ships, in its spellings
KNOWN_MODELS = ("vit_base_patch16_224_in21k", "vit_base_patch16",
                "vit_base_patch16_224")
#: flags the reference declares but never reads
_DEAD_IN_REFERENCE = ("global_pool", "vpt")
#: main_video's flags the reference declares but never reads, with their
#: defaults (reference main_video.py:117-141): warned when given otherwise
_DEAD_NONDEFAULT = {
    "drop": 0.0, "attn_drop_rate": 0.0, "init_scale": 0.001,
    "num_segments": 1, "num_sample": 1, "crop_pct": None,
    "short_side_size": 224, "input_size": 224, "linprob": True,
    "use_mean_pooling": True,
}
#: launcher flags with no meaning for one process: warned when given
_IGNORED_NONDEFAULT = {
    "world_size": (None, "process topology is discovered, not declared "
                         "(parallel/multihost.py)"),
    "local_rank": (None, "the card comes from the launcher's LOCAL_RANK "
                         "(parallel/multihost.py)"),
    "dist_url": (None, "rendezvous comes from the launcher's environment "
                       "(MASTER_ADDR/MASTER_PORT)"),
}


def check_compat_args(args) -> None:
    """Validate ``--model`` and warn on the flags that do nothing here."""
    log = logging.getLogger("dynamic_tuning_tpu_torch")
    model = getattr(args, "model", KNOWN_MODELS[0])
    if model not in KNOWN_MODELS:
        raise ValueError(f"--model {model!r}: unknown model; the reference "
                         f"ships {KNOWN_MODELS}")
    for flag in _DEAD_IN_REFERENCE:
        if getattr(args, flag, False):
            log.warning("--%s is declared but never read by the reference; "
                        "it does nothing here either", flag)
    for flag, (default, why) in _IGNORED_NONDEFAULT.items():
        if getattr(args, flag, default) != default:
            log.warning("--%s is ignored: %s", flag, why)
    for flag, default in _DEAD_NONDEFAULT.items():
        if getattr(args, flag, default) != default:
            log.warning("--%s=%s has no effect: the reference declares it "
                        "but never reads it", flag, getattr(args, flag))


def _registry_data_path(name: str) -> str:
    """The registry's data path of a dataset: the bare lowercase name, the
    recipe spelling or the name without ``_full``."""
    for key in (name, name.lower(), name.lower().removesuffix("_full")):
        p = paths.dataset_path(key, "")
        if p:
            return p
    return ""


def args_to_config(args, *, no_aug: bool = False) -> RunConfig:
    """The parsed flags -> ``RunConfig`` (the JAX package's
    ``args_to_config`` without the mesh)."""
    check_compat_args(args)
    make_mesh(args.model_parallel)
    if args.ckpt_backend == "orbax":
        raise ValueError("--ckpt_backend orbax: the port has no orbax or "
                         "tensorstore (the card's machine lacks both); it "
                         "writes the JAX package's .msgpack files (the "
                         "default backend)")
    finetune = args.finetune
    if finetune and not os.path.exists(finetune):
        finetune = paths.checkpoint_path(finetune, fallback=finetune)
    data_path = args.data_path or _registry_data_path(args.dataset)
    tuning = TuningConfig(ffn_adapt=args.ffn_adapt, ffn_num=args.ffn_num,
                          ffn_adapter_scalar=args.adapter_scalar,
                          moe_experts=args.moe_experts)
    select = SelectConfig(open=not args.no_select,
                          keep_layers=args.keep_layers,
                          token_target_ratio=args.token_target_ratio,
                          token_loss_ratio=args.token_loss_ratio,
                          capacity_ratio=args.capacity_ratio)
    optim = OptimConfig(blr=args.blr, lr=args.lr, min_lr=args.min_lr,
                        weight_decay=args.weight_decay,
                        clip_grad=args.clip_grad,
                        warmup_epochs=args.warmup_epochs, epochs=args.epochs)
    data = DataConfig(dataset=args.dataset, data_path=data_path,
                      batch_size=args.batch_size, num_workers=args.num_workers,
                      inception_norm=args.inception, no_aug=no_aug,
                      canvas=getattr(args, "canvas", None))
    model = ModelConfig(num_classes=args.nb_classes,
                        drop_path_rate=args.drop_path,
                        gelu_approx=args.gelu_approx,
                        residual_dtype=args.residual_dtype,
                        remat=args.remat, quant=args.quant)
    return RunConfig(model=model, tuning=tuning, select=select, optim=optim,
                     data=data, seed=args.seed, output_dir=args.output_dir,
                     eval_dispatch=args.eval_dispatch,
                     eval_freq=args.eval_freq, save_freq=args.save_freq,
                     resume=args.resume, finetune=finetune,
                     fulltune=args.fulltune, accum_iter=args.accum_iter,
                     compute_dtype=args.compute_dtype,
                     ckpt_backend=args.ckpt_backend,
                     auto_remove=args.auto_remove,
                     log_dir=getattr(args, "log_dir", ""),
                     start_epoch=getattr(args, "start_epoch", 0))


@contextlib.contextmanager
def fp32_on_card(compute_dtype: str, device: torch.device):
    """Inside, fp32 compute on the card is fp32 throughout: torch's float32
    matmuls (the MLP, the head; ``torch.backends.cuda.matmul.allow_tf32``,
    False by default) and cuDNN's float32 convolutions (the patch
    embedding, the seg heads; ``torch.backends.cudnn.allow_tf32``, True by
    default) run without TF32, whose 10-bit mantissa the JAX package's
    fp32 does not have.  Both flags are restored on the way out.  The hand
    kernels' fp32 forms never use TF32.  Nothing changes for bf16 or on the
    CPU."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    before = m.allow_tf32, c.allow_tf32
    if device.type == "cuda" and compute_dtype == "float32":
        m.allow_tf32 = c.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = before


def fp32_scoped(method):
    """A runner method run inside ``fp32_on_card`` of the runner's
    ``cfg.compute_dtype`` and ``device``."""
    @functools.wraps(method)
    def scoped(self, *args, **kwargs):
        with fp32_on_card(self.cfg.compute_dtype, self.device):
            return method(self, *args, **kwargs)
    return scoped


def resolve_device(name, entry: str) -> torch.device:
    """``--device``: CUDA unless the caller asks for the CPU; raises when
    CUDA is asked for and there is no card.  Under a launcher, CUDA is this
    process's card, ``cuda:LOCAL_RANK``."""
    dev = torch.device(name or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{entry} runs on the GPU and found no CUDA "
                           "device (pass --device cpu to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: cuda or cpu")
    return local_device(dev)
