"""Video DyT VisionTransformer in PyTorch (counterpart of
dynamic_tuning_tpu/models/video_vit.py; reference
video_models/video_vision_transformer_IN21K.py).

Clips go in as ``[B, T, H, W, 3]`` floats, as in the JAX package.  Time
folds into the batch before the patch embedding, so every DyT block runs
per frame with the image model's ``PatchEmbed`` (the int8 stem in eval
under ``cfg.quant``) and ``Block`` (K3, K2 or K6 + K4 in eval, under the
same predicate as the image model: every frame has N = 197 <= 512).  With
``cfg.tubelet_size`` t > 1 the stem is ``TubeletEmbed``, one Conv3d over
(t, p, p) in the compute dtype whatever ``cfg.quant`` says (as the JAX
package's), and the blocks run per group of t frames.  After the final
LayerNorm the tokens of a clip's T frames unfold into one sequence of T * N
tokens, a zero-initialised ``query_token`` cross-attends over them
(``AttentiveBlock``), and the pooled query goes to the fp32 head.

``forward`` returns ``(logits, {"token_select": [B * T, L, N - 1, 1] or
None, "token_logits": ...})``: gates are per frame (per frame group with a
tubelet stem).  Training and eval forms, dropout draws, ``gate_noise``
([B * T, L, N - 1, 1]) and ``cfg.remat`` as the image model's.

The cross-attention is plain torch (the JAX package runs it in XLA): the
q/k/v/proj Dense layers round as flax's do (``layers._dense``: the product,
then the bias), k has no bias, q and v add fp32 biases rounded to the
compute dtype, q is scaled by the scale rounded to its dtype
(``ms.weak_scale``), the scores are fp32 products of compute-dtype
operands, the softmax is fp32 and max-subtracted, its probabilities are
rounded to the compute dtype before the product with v.  The three
LayerNorms are fp32 (eps 1e-6) and feed the compute dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dynamic_tuning_tpu_torch.config import (ModelConfig, SelectConfig,
                                             TuningConfig)
from dynamic_tuning_tpu_torch.models.layers import (LN_EPS, Draws,
                                                     _dense, _layer_norm,
                                                     _linear, _WeightCache,
                                                     dropout,
                                                     trunc_normal_02)
from dynamic_tuning_tpu_torch.models.vit import (_DTYPES, PatchEmbed,
                                                 check_config, make_blocks,
                                                 run_blocks)
from dynamic_tuning_tpu_torch.ops import mha_serving as ms


class TubeletEmbed(nn.Module):
    """The VideoMAE-style tubelet stem: one Conv3d over (tubelet, p, p) at
    that stride, in the compute dtype (the product rounded, then the bias
    rounded and added, as flax's Conv).  ``[B, T, H, W, C]`` ->
    ``[B, T // tubelet, gh * gw, D]``.  The weight is torch's OIDHW (the
    flax kernel is DHWIO)."""

    def __init__(self, patch_size: int, tubelet_size: int, in_chans: int,
                 embed_dim: int, generator: torch.Generator, *,
                 dtype=torch.bfloat16):
        super().__init__()
        k = (tubelet_size, patch_size, patch_size)
        self.proj = nn.Conv3d(in_chans, embed_dim, k, stride=k)
        with torch.no_grad():
            trunc_normal_02(self.proj.weight, generator)
            self.proj.bias.zero_()
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3).to(self.dtype)       # -> [B, C, T, H, W]
        y = F.conv3d(x, self.proj.weight.to(self.dtype),
                     stride=self.proj.stride)
        y = y + self.proj.bias.to(self.dtype)[:, None, None, None]
        B, D, tg = y.shape[:3]
        return y.reshape(B, D, tg, -1).permute(0, 2, 3, 1)


class CrossAttention(nn.Module):
    """Query cross-attention with separate q/k/v projections (reference
    CrossAttention, :52-110): with ``qkv_bias``, fp32 ``q_bias`` and
    ``v_bias`` [C] (zeros at init), k without a bias."""

    def __init__(self, dim: int, num_heads: int, generator: torch.Generator,
                 *, qkv_bias: bool = True, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, dtype=torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.q = _linear(dim, dim, generator, bias=False)
        self.k = _linear(dim, dim, generator, bias=False)
        self.v = _linear(dim, dim, generator, bias=False)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(dim))
            self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = _linear(dim, dim, generator)
        self.dtype = dtype
        self._w = _WeightCache()

    def forward(self, q_in: torch.Tensor, k_in: torch.Tensor,
                v_in: torch.Tensor, *, training: bool = False,
                draws: Optional[Draws] = None) -> torch.Tensor:
        B, Nq, C = q_in.shape
        Nk = k_in.shape[1]
        H, hd, dt = self.num_heads, C // self.num_heads, self.dtype
        q = _dense(q_in, self.q, self._w, dt)
        k = _dense(k_in, self.k, self._w, dt)
        v = _dense(v_in, self.v, self._w, dt)
        if hasattr(self, "q_bias"):
            q = q + self._w.get(self.q_bias, dt)
            v = v + self._w.get(self.v_bias, dt)
        q = q.reshape(B, Nq, H, hd).transpose(1, 2)
        k = k.reshape(B, Nk, H, hd).transpose(1, 2)
        v = v.reshape(B, Nk, H, hd).transpose(1, 2)
        s = torch.matmul((q * ms.weak_scale(q, hd)).float(),
                         k.float().transpose(-1, -2))
        p = dropout(torch.softmax(s, dim=-1),
                    self.attn_drop if training else 0.0, draws)
        out = torch.matmul(p.to(dt), v).transpose(1, 2).reshape(B, Nq, C)
        out = _dense(out, self.proj, self._w, dt)
        return dropout(out, self.proj_drop if training else 0.0, draws)


class AttentiveBlock(nn.Module):
    """norm_q / norm_k / norm_v (fp32) + cross-attention (reference
    AttentiveBlock, :27-49)."""

    def __init__(self, dim: int, num_heads: int, generator: torch.Generator,
                 *, qkv_bias: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0, dtype=torch.bfloat16):
        super().__init__()
        self.norm_q = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm_k = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm_v = nn.LayerNorm(dim, eps=LN_EPS)
        self.cross_attn = CrossAttention(dim, num_heads, generator,
                                         qkv_bias=qkv_bias,
                                         attn_drop=attn_drop, proj_drop=drop,
                                         dtype=dtype)
        self.dtype = dtype

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor, *,
                training: bool = False,
                draws: Optional[Draws] = None) -> torch.Tensor:
        dt = self.dtype
        return self.cross_attn(_layer_norm(x_q, self.norm_q).to(dt),
                               _layer_norm(x_kv, self.norm_k).to(dt),
                               _layer_norm(x_kv, self.norm_v).to(dt),
                               training=training, draws=draws)


class VideoVisionTransformer(nn.Module):
    """Per-frame DyT ViT + attentive pooling head, serving and training
    forwards.  Weights are drawn from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when omitted) and then moved to
    ``device``."""

    def __init__(self, cfg: ModelConfig, tuning: TuningConfig = TuningConfig(),
                 select: SelectConfig = SelectConfig(),
                 dtype=torch.bfloat16, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_config(cfg, select)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg, self.tuning, self.select_cfg = cfg, tuning, select
        self.dtype = dtype
        self.residual_dtype = _DTYPES[cfg.residual_dtype]
        C = cfg.embed_dim
        if cfg.tubelet_size > 1:
            self.patch_embed = TubeletEmbed(cfg.patch_size, cfg.tubelet_size,
                                            cfg.in_chans, C, generator,
                                            dtype=dtype)
        else:
            self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, C,
                                          generator, dtype=dtype,
                                          quant=cfg.quant)
        if cfg.class_token:
            self.cls_token = nn.Parameter(
                torch.randn(1, 1, C, generator=generator) * 1e-6)
        self.pos_embed = nn.Parameter(
            torch.randn(1, cfg.seq_len, C, generator=generator) * 0.02)
        self.blocks = make_blocks(cfg, tuning, select, generator, dtype)
        self.norm = nn.LayerNorm(C, eps=LN_EPS)
        self.query_token = nn.Parameter(torch.zeros(1, 1, C))
        self.attentive_blocks = AttentiveBlock(
            C, cfg.num_heads, generator, qkv_bias=cfg.qkv_bias,
            drop=cfg.drop_rate, attn_drop=cfg.attn_drop_rate, dtype=dtype)
        self.head = nn.Linear(C, cfg.num_classes)
        with torch.no_grad():
            trunc_normal_02(self.head.weight, generator)
            self.head.bias.zero_()
        self.eval()
        if device is not None:
            self.to(device)

    def frames_per_clip(self, num_frames: int) -> int:
        """Rows of ``token_select`` a clip of ``num_frames`` frames gets
        (frame groups with a tubelet stem)."""
        return num_frames // max(self.cfg.tubelet_size, 1)

    def forward(self, x: torch.Tensor, *, training: bool = False,
                complete_model: bool = False, dispatch: bool = False,
                draws: Optional[Draws] = None,
                gate_noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Optional[torch.Tensor]]]:
        if training:
            return self._forward(x, True, complete_model, False, draws,
                                 gate_noise)
        with torch.no_grad():
            return self._forward(x, False, complete_model, dispatch, None,
                                 None)

    def _forward(self, x, training, complete_model, dispatch, draws,
                 gate_noise):
        cfg = self.cfg
        B, T, C = x.shape[0], x.shape[1], cfg.embed_dim
        top = draws.fold(cfg.depth) if draws is not None else None
        if cfg.tubelet_size > 1:
            x = self.patch_embed(x)
            T = x.shape[1]
            x = x.reshape(B * T, x.shape[2], C)
        else:
            x = self.patch_embed(x.reshape(B * T, *x.shape[2:]), training)
        x = x.float()
        if cfg.class_token:
            x = torch.cat([self.cls_token.expand(B * T, -1, -1), x], dim=1)
        x = x + self.pos_embed
        if training:
            x = dropout(x, cfg.pos_drop_rate, top)
        x = x.to(self.residual_dtype)

        x, aux = run_blocks(self.blocks, x, remat=cfg.remat,
                            training=training, complete_model=complete_model,
                            dispatch=dispatch, draws=draws,
                            gate_noise=gate_noise)
        x = F.layer_norm(x.float(), (C,), self.norm.weight, self.norm.bias,
                         LN_EPS)
        if training:
            x = dropout(x, cfg.drop_rate, top)
        # unfold time: the query attends over every frame's tokens
        x = x.reshape(B, T * x.shape[1], C)
        pooled = self.attentive_blocks(self.query_token.expand(B, 1, C), x,
                                       training=training, draws=top)[:, 0]
        return F.linear(pooled.float(), self.head.weight, self.head.bias), aux


def video_vit_base_patch16_224_in21k(num_classes: int = 400,
                                     num_frames: int = 8,
                                     tuning: TuningConfig = TuningConfig(),
                                     select: SelectConfig = SelectConfig(),
                                     dtype=torch.bfloat16, *, device=None,
                                     generator: Optional[
                                         torch.Generator] = None,
                                     **overrides) -> VideoVisionTransformer:
    """Video ViT-B/16 factory (the JAX package's
    video_vit_base_patch16_224_in21k; reference :512)."""
    cfg = ModelConfig(num_classes=num_classes, num_frames=num_frames,
                      **overrides)
    return VideoVisionTransformer(cfg, tuning=tuning, select=select,
                                  dtype=dtype, device=device,
                                  generator=generator)
