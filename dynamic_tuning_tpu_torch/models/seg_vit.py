"""DyT segmentation backbone in PyTorch (counterpart of
dynamic_tuning_tpu/models/seg_vit.py), serving and training forwards: ViT
features + simpleFPN pyramid.

* DyT blocks with the windowed relative-position bias over the whole patch
  grid + CLS (``window_size = (hp, wp)``): in eval each block runs the
  module path and its Attention takes K9
  (``ops/mha_serving.py::mha_windowed_fused``); with ``cfg.quant`` int8 the
  stem is the int8 stem and each block's MLP takes K4 (``q8_ln_mlp``, on
  the kept rows under dispatch) while its attention stays bf16 on K9, as
  the JAX Block gives a windowed block the int8 MLP without the fused
  sublayer;
* features tapped at ``default_out_indices`` ((3, 5, 7, 11) at depth 12) as
  2-D maps;
* simpleFPN necks: fpn1 = two 2x2/2 transposed convs with exact GELU between
  them (4x up), fpn2 = one (2x up), fpn3 = identity, fpn4 = 2x2 max-pool;
* the token budget loss is computed inside the backbone and returned with
  the features.

``training=True`` records the graph on the module path (no hand kernel, no
int8), as the image model's training forward (``models/vit.py``): dropout
at ``pos_drop_rate``, stochastic depth, the gumbel gate drawn from
``draws`` or given as ``gate_noise`` [B, L, T, 1], ``cfg.remat``; the
relative-position tables, adapters, routers and FPN deconvs that require
grad are cast live, so their gradients flow.  The eval forward runs
without autograd.

Images go in as NHWC ``[B, H, W, 3]`` and features come out NHWC in fp32,
as in the JAX package.  The patch grid, and with it the position embedding
and the windows, is fixed at construction from ``cfg.img_size`` (the crop).

The JAX package's knobs are here too: ``use_rel_pos_bias=False`` drops the
windows (the blocks' Attention then takes K1, ``mha_serving_fused``, at
N <= 512), ``use_abs_pos_embed=False`` the absolute position embedding,
``init_values`` adds LayerScale and ``qv_bias_only`` BEiT's q/v-only
attention biases; ``beit_backbone`` sets all four as the reference's BEiT
backbone does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dynamic_tuning_tpu_torch.config import (ModelConfig, SelectConfig,
                                             TuningConfig)
from dynamic_tuning_tpu_torch.models.layers import (Block, Draws,
                                                     _WeightCache, dropout,
                                                     trunc_normal_02)
from dynamic_tuning_tpu_torch.models.vit import (_DTYPES, PatchEmbed,
                                                 check_config, run_blocks)
from dynamic_tuning_tpu_torch.train.losses import token_budget_loss


def default_out_indices(depth: int) -> Tuple[int, ...]:
    """(3, 5, 7, 11) at depth 12 (reference :342); other depths tap the
    quarter points of the full depth."""
    if depth < 4:
        raise ValueError(
            f"segmentation backbone needs >=4 blocks for the 4 FPN taps "
            f"(got depth={depth})")
    if depth == 12:
        return (3, 5, 7, 11)
    idx = tuple(sorted({max(0, depth * (k + 1) // 4 - 1) for k in range(4)}))
    return idx if len(idx) == 4 else tuple(range(max(0, depth - 4), depth))


def _deconv(dim: int, generator: torch.Generator) -> nn.ConvTranspose2d:
    """A 2x2 stride-2 transposed conv, weight [in, out, 2, 2]."""
    m = nn.ConvTranspose2d(dim, dim, 2, stride=2)
    with torch.no_grad():
        trunc_normal_02(m.weight, generator)
        m.bias.zero_()
    return m


class SegVisionTransformer(nn.Module):
    """Backbone forward: NHWC image -> 4 NHWC fp32 feature maps (strides
    4/8/16/32 of the image) + a dict with the gates and the budget loss."""

    def __init__(self, cfg: ModelConfig, tuning: TuningConfig = TuningConfig(),
                 select: SelectConfig = SelectConfig(), *,
                 use_rel_pos_bias: bool = True,
                 use_abs_pos_embed: bool = True,
                 init_values: Optional[float] = None,
                 qv_bias_only: bool = False, dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_config(cfg, select)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg, self.select_cfg = cfg, select
        self.dtype = dtype
        self.residual_dtype = _DTYPES[cfg.residual_dtype]
        self.grid = cfg.grid_size
        self.out_indices = default_out_indices(cfg.depth)
        C = cfg.embed_dim
        hp, wp = self.grid
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, C,
                                      generator, dtype=dtype,
                                      quant=cfg.quant)
        self.cls_token = nn.Parameter(
            torch.randn(1, 1, C, generator=generator) * 1e-6)
        if use_abs_pos_embed:
            self.pos_embed = nn.Parameter(
                torch.randn(1, hp * wp + 1, C, generator=generator) * 0.02)
        self.blocks = nn.ModuleList([
            Block(C, cfg.num_heads, generator, mlp_ratio=cfg.mlp_ratio,
                  qkv_bias=cfg.qkv_bias, proj_drop=cfg.proj_drop_rate,
                  attn_drop=cfg.attn_drop_rate,
                  drop_path=cfg.drop_path_rate * i / max(cfg.depth - 1, 1),
                  select=select.open and i >= select.keep_layers,
                  window_size=(hp, wp) if use_rel_pos_bias else None,
                  gelu_approx=cfg.gelu_approx, init_values=init_values,
                  qv_bias_only=qv_bias_only, quant=cfg.quant, tuning=tuning,
                  select_cfg=select, dtype=dtype)
            for i in range(cfg.depth)])
        self.fpn1_deconv1 = _deconv(C, generator)
        self.fpn1_deconv2 = _deconv(C, generator)
        self.fpn2_deconv = _deconv(C, generator)
        self._w = _WeightCache()

    def _up(self, x: torch.Tensor, m: nn.ConvTranspose2d) -> torch.Tensor:
        """The transposed conv in the compute dtype, its bias added after
        the rounding as flax adds it."""
        dt = self.dtype
        y = F.conv_transpose2d(x.to(dt), self._w.get(m.weight, dt), stride=2)
        return y + self._w.get(m.bias, dt)[:, None, None]

    def forward(self, x: torch.Tensor, *, training: bool = False,
                complete_model: bool = False, dispatch: bool = False,
                draws: Optional[Draws] = None,
                gate_noise: Optional[torch.Tensor] = None
                ) -> Tuple[Tuple[torch.Tensor, ...],
                           Dict[str, Optional[torch.Tensor]]]:
        if training:
            return self._forward(x, True, complete_model, False, draws,
                                 gate_noise)
        with torch.no_grad():
            return self._forward(x, False, complete_model, dispatch, None,
                                 None)

    def _forward(self, x, training, complete_model, dispatch, draws,
                 gate_noise):
        cfg = self.cfg
        B, H, W, _ = x.shape
        hp, wp = H // cfg.patch_size, W // cfg.patch_size
        if (hp, wp) != self.grid:
            raise ValueError(f"a {H}x{W} input gives a {hp}x{wp} patch grid; "
                             f"this backbone was built for {self.grid}")
        x = self.patch_embed(x, training).float()
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)
        if hasattr(self, "pos_embed"):
            x = x + self.pos_embed
        if training:
            top = draws.fold(cfg.depth) if draws is not None else None
            x = dropout(x, cfg.pos_drop_rate, top)
        x = x.to(self.residual_dtype)

        taps = []
        x, aux = run_blocks(self.blocks, x, remat=cfg.remat,
                            training=training, complete_model=complete_model,
                            dispatch=dispatch, draws=draws,
                            gate_noise=gate_noise, taps=taps,
                            tap_at=self.out_indices)
        # NCHW views of the NHWC token maps
        feats = [t[:, 1:, :].reshape(B, hp, wp, -1).permute(0, 3, 1, 2)
                 for t in taps]

        f1 = self._up(F.gelu(self._up(feats[0], self.fpn1_deconv1)),
                      self.fpn1_deconv2)
        f2 = self._up(feats[1], self.fpn2_deconv)
        f3 = feats[2]
        f4 = F.max_pool2d(feats[3], 2, stride=2)

        if aux["token_select"] is not None:
            loss = self.select_cfg.token_loss_ratio * token_budget_loss(
                aux["token_select"], self.select_cfg, global_batch=training)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = dict(aux, loss=loss)
        return tuple(f.float().permute(0, 2, 3, 1)
                     for f in (f1, f2, f3, f4)), aux


def beit_backbone(cfg: ModelConfig, tuning: TuningConfig = TuningConfig(),
                  select: SelectConfig = SelectConfig(), *,
                  dtype=torch.bfloat16,
                  generator: Optional[torch.Generator] = None
                  ) -> SegVisionTransformer:
    """The BEiT-style segmentation backbone (reference
    dense_tasks/Segmentation/backbone/beit.py): rel-pos-bias attention with
    q/v-only biases, LayerScale (init 0.1), no absolute pos-embed."""
    return SegVisionTransformer(cfg, tuning, select, use_rel_pos_bias=True,
                                use_abs_pos_embed=False, init_values=0.1,
                                qv_bias_only=True, dtype=dtype,
                                generator=generator)
