"""DyT VisionTransformer in PyTorch (counterpart of
dynamic_tuning_tpu/models/vit.py), serving forward.

Images go in as NHWC ``[B, H, W, 3]`` floats, as in the JAX package.  Patch
embedding is a stride-p convolution in the compute dtype (left to cuDNN, as
the JAX package left it to XLA); the residual stream is kept in
``cfg.residual_dtype``; the final LayerNorm and the head are fp32.
``forward`` returns ``(logits, {"token_select": [B, L, T, 1] or None,
"token_logits": [B, L, T, 1] or None})`` with CLS stripped from both.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dynamic_tuning_tpu.config import ModelConfig, SelectConfig, TuningConfig
from dynamic_tuning_tpu_torch.models.layers import (LN_EPS, Block,
                                                     trunc_normal_02)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class PatchEmbed(nn.Module):
    """p x p non-overlapping patches -> [B, T, C] in the compute dtype."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 generator: torch.Generator, *, dtype=torch.bfloat16):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size)
        with torch.no_grad():
            trunc_normal_02(self.proj.weight, generator)
            self.proj.bias.zero_()
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)            # NHWC -> NCHW
        y = F.conv2d(x, self.proj.weight.to(self.dtype),
                     stride=self.proj.stride)
        y = y + self.proj.bias.to(self.dtype)[:, None, None]
        return y.flatten(2).transpose(1, 2)


class VisionTransformer(nn.Module):
    """DyT ViT, serving forward.  Weights are drawn from ``generator`` (a
    CPU ``torch.Generator``; seed 0 when omitted) and then moved to
    ``device``."""

    def __init__(self, cfg: ModelConfig, tuning: TuningConfig = TuningConfig(),
                 select: SelectConfig = SelectConfig(),
                 dtype=torch.bfloat16, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.num_frames > 1:
            raise NotImplementedError("video comes with its own slice")
        if cfg.remat:
            raise NotImplementedError("remat is a training option")
        if select.open and not cfg.class_token:
            raise ValueError("token routing (select.open=True) requires "
                             "class_token=True")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg, self.tuning, self.select_cfg = cfg, tuning, select
        self.dtype = dtype
        self.residual_dtype = _DTYPES[cfg.residual_dtype]
        C = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, C,
                                      generator, dtype=dtype)
        if cfg.class_token:
            self.cls_token = nn.Parameter(
                torch.randn(1, 1, C, generator=generator) * 1e-6)
        self.pos_embed = nn.Parameter(
            torch.randn(1, cfg.seq_len, C, generator=generator) * 0.02)
        self.blocks = nn.ModuleList([
            Block(C, cfg.num_heads, generator, mlp_ratio=cfg.mlp_ratio,
                  qkv_bias=cfg.qkv_bias, attn_drop=cfg.attn_drop_rate,
                  drop_path=cfg.drop_path_rate * i / max(cfg.depth - 1, 1),
                  select=select.open and i >= select.keep_layers,
                  gelu_approx=cfg.gelu_approx, quant=cfg.quant,
                  tuning=tuning, select_cfg=select, dtype=dtype)
            for i in range(cfg.depth)])
        self.norm = nn.LayerNorm(C, eps=LN_EPS)
        self.head = nn.Linear(C, cfg.num_classes)
        with torch.no_grad():
            trunc_normal_02(self.head.weight, generator)
            self.head.bias.zero_()
        self.eval()
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, *, training: bool = False,
                complete_model: bool = False, dispatch: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, Optional[torch.Tensor]]]:
        if training:
            raise NotImplementedError("training comes with its own slice")
        cfg = self.cfg
        B = x.shape[0]
        x = self.patch_embed(x).float()
        if cfg.class_token:
            x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)
        x = (x + self.pos_embed).to(self.residual_dtype)

        gates, logits_all = [], []
        for blk in self.blocks:
            x, gate, logits = blk(x, complete_model, dispatch)
            if gate is not None:
                gates.append(gate)
                logits_all.append(logits)

        x = F.layer_norm(x.float(), (cfg.embed_dim,), self.norm.weight,
                         self.norm.bias, LN_EPS)
        if cfg.global_pool == "avg":
            pooled = x[:, 1 if cfg.class_token else 0:].mean(dim=1)
        else:
            pooled = x[:, 0]
        logits = F.linear(pooled, self.head.weight, self.head.bias)
        if gates:
            token_select = torch.stack(gates, dim=1)[:, :, 1:, :]
            token_logits = torch.stack(logits_all, dim=1)
        else:
            token_select = token_logits = None
        return logits, {"token_select": token_select,
                        "token_logits": token_logits}


def vit_base_patch16_224_in21k(num_classes: int = 1000,
                               tuning: TuningConfig = TuningConfig(),
                               select: SelectConfig = SelectConfig(),
                               dtype=torch.bfloat16, *, device=None,
                               generator: Optional[torch.Generator] = None,
                               **overrides) -> VisionTransformer:
    """ViT-B/16 factory (the JAX package's vit_base_patch16_224_in21k)."""
    cfg = ModelConfig(num_classes=num_classes, **overrides)
    return VisionTransformer(cfg, tuning=tuning, select=select, dtype=dtype,
                             device=device, generator=generator)
