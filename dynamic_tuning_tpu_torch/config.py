"""Configuration dataclasses of the port (the image-serving subset of
dynamic_tuning_tpu/config.py).

The same field names and defaults as the JAX package's ``TuningConfig``,
``SelectConfig`` and ``ModelConfig``, so a config built for one package
describes the same model in the other.  The port keeps its own copy: it
imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
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
