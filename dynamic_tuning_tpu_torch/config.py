"""Configuration dataclasses of the port (counterpart of
dynamic_tuning_tpu/config.py).

The same field names and defaults as the JAX package's ``TuningConfig``,
``SelectConfig``, ``ModelConfig``, ``OptimConfig``, ``DataConfig`` (image
and video fields) and ``RunConfig``, so a config built for one package
describes the same run in the other.  ``RunConfig`` has no mesh: the port
trains on one device.  The port keeps its own copy: it imports nothing of
the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union


@dataclass(frozen=True)
class TuningConfig:
    """Adapter ("AdaptFormer"-style) settings."""

    ffn_adapt: bool = True
    ffn_option: str = "parallel"            # adapter beside the MLP
    ffn_adapter_layernorm_option: str = "none"  # "none" | "in" | "out"
    ffn_adapter_init_option: str = "lora"   # kaiming-uniform down, zero up
    ffn_adapter_scalar: str = "0.1"         # "0.1"|"1.0"|"learnable_scalar"
    ffn_num: int = 64                       # bottleneck width
    d_model: int = 768
    dropout: float = 0.1                    # adapter dropout (training only)
    moe_experts: int = 0                    # 0 disables MoE; N>1 = N experts
    moe_router_tau: float = 1.0


@dataclass(frozen=True)
class SelectConfig:
    """Token-dispatcher settings."""

    open: bool = True
    keep_layers: int = 0                    # first blocks without router
    token_target_ratio: float = 0.5         # budget: mean keep-rate target
    token_loss_ratio: float = 2.0           # weight of the squared budget loss
    token_minimal: float = 0.0
    token_minimal_weight: float = 0.0
    tau: float = 5.0                        # gumbel-sigmoid temperature
    threshold: float = 0.5                  # hard gate threshold
    capacity_ratio: Optional[float] = None  # dispatch capacity; None -> target


@dataclass(frozen=True)
class ModelConfig:
    """ViT backbone architecture (ViT-B/16 defaults)."""

    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    num_classes: int = 1000
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0                  # head dropout
    pos_drop_rate: float = 0.0
    proj_drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    global_pool: str = "token"              # "token" | "avg"
    class_token: bool = True
    gelu_approx: bool = False               # tanh GELU vs exact erf
    residual_dtype: str = "float32"         # or "bfloat16"
    remat: Union[bool, str] = False         # training option
    quant: str = "none"                     # "int8" | "int8_attn": W8A8
    num_frames: int = 1                     # >1 enables the video path
    tubelet_size: int = 1

    @property
    def grid_size(self) -> Tuple[int, int]:
        return (self.img_size // self.patch_size,
                self.img_size // self.patch_size)

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid_size
        return gh * gw

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.class_token else 0)


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer + LR schedule (reference train_IN21K.sh, util/lr_sched.py)."""

    blr: float = 1e-3                       # lr = blr * eff_batch / 256
    lr: Optional[float] = None              # absolute lr, overrides blr
    min_lr: float = 0.0
    weight_decay: float = 0.01
    warmup_epochs: float = 20.0
    epochs: int = 100
    clip_grad: Optional[float] = None
    betas: Tuple[float, float] = (0.9, 0.999)

    def absolute_lr(self, eff_batch_size: int) -> float:
        if self.lr is not None:
            return self.lr
        return self.blr * eff_batch_size / 256.0


@dataclass(frozen=True)
class DataConfig:
    """The data settings of the image and video runs."""

    dataset: str = "cifar100"
    data_path: str = ""
    batch_size: int = 128
    num_workers: int = 4
    inception_norm: bool = False            # inception mean/std
    no_aug: bool = False                    # VTAB-1K: no augmentation
    canvas: Optional[int] = None            # decode canvas (224 / 256)
    # video (reference video_datasets.py):
    num_frames: int = 8
    sampling_rate: int = 16                 # 0: TSN segment sampling (SSv2)
    test_num_segment: int = 3               # eval views: temporal ...
    test_num_crop: int = 1                  # ... x spatial
    randaug: Optional[str] = None           # e.g. "rand-m7-n4-mstd0.5-inc1"
    # train resize: "random_resized_crop" (SSv2) or
    # "random_short_side_scale_jitter" (K400)
    train_resize_type: str = "random_resized_crop"
    jitter_min: Optional[int] = None        # short-side jitter bounds
    jitter_max: Optional[int] = None        # (None: 256 / 320)
    mirror: bool = True                     # horizontal flip (not SSv2)


@dataclass(frozen=True)
class RunConfig:
    """Top-level run configuration."""

    model: ModelConfig = field(default_factory=ModelConfig)
    tuning: TuningConfig = field(default_factory=TuningConfig)
    select: SelectConfig = field(default_factory=SelectConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    seed: int = 0
    output_dir: str = "./output_dir"
    eval_dispatch: bool = False             # evaluate on the dispatch path
    eval_freq: int = 1
    save_freq: int = 1
    resume: str = ""
    finetune: str = ""                      # pretrained .pth or .msgpack
    fulltune: bool = False                  # train the whole backbone
    accum_iter: int = 1
    compute_dtype: str = "bfloat16"
    ckpt_backend: str = "msgpack"           # the single-file backend
    auto_remove: bool = True                # prune older epoch checkpoints
    log_dir: str = ""                       # TensorBoard dir; "" = output_dir
    start_epoch: int = 0                    # first epoch when not resuming

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


def vtab_config(task: str, data_path: str = "") -> RunConfig:
    """The VTAB-1K recipe (reference main_vtab.py:350-352, train_vtab.sh)."""
    return RunConfig(
        tuning=TuningConfig(ffn_num=16, ffn_adapter_scalar="1.0"),
        optim=OptimConfig(lr=1e-3, weight_decay=1e-4, warmup_epochs=10,
                          epochs=100),
        data=DataConfig(dataset=task, data_path=data_path, batch_size=64,
                        no_aug=True))


def image_config(dataset: str = "cifar100", data_path: str = "") -> RunConfig:
    """The full-dataset image recipe (reference train_IN21K.sh)."""
    return RunConfig(data=DataConfig(dataset=dataset, data_path=data_path,
                                     batch_size=128))
