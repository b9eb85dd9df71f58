"""DyT segmentation backbone in PyTorch (counterpart of
dynamic_tuning_tpu/models/seg_vit.py), serving forward: ViT features +
simpleFPN pyramid.

* DyT blocks with the windowed relative-position bias over the whole patch
  grid + CLS (``window_size = (hp, wp)``): each block runs the module path
  and its Attention takes K9 (``ops/mha_serving.py::mha_windowed_fused``);
* features tapped at ``default_out_indices`` ((3, 5, 7, 11) at depth 12) as
  2-D maps;
* simpleFPN necks: fpn1 = two 2x2/2 transposed convs with exact GELU between
  them (4x up), fpn2 = one (2x up), fpn3 = identity, fpn4 = 2x2 max-pool;
* the token budget loss is computed inside the backbone and returned with
  the features.

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

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dynamic_tuning_tpu_torch.config import (ModelConfig, SelectConfig,
                                             TuningConfig)
from dynamic_tuning_tpu_torch.models.layers import (Block, _WeightCache,
                                                     trunc_normal_02)
from dynamic_tuning_tpu_torch.models.vit import _DTYPES, PatchEmbed
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
        if cfg.quant != "none":
            raise NotImplementedError("int8 segmentation is not ported yet "
                                      "(ROADMAP.md, queue 1 item 5)")
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
                                      generator, dtype=dtype)
        self.cls_token = nn.Parameter(
            torch.randn(1, 1, C, generator=generator) * 1e-6)
        if use_abs_pos_embed:
            self.pos_embed = nn.Parameter(
                torch.randn(1, hp * wp + 1, C, generator=generator) * 0.02)
        self.blocks = nn.ModuleList([
            Block(C, cfg.num_heads, generator, mlp_ratio=cfg.mlp_ratio,
                  qkv_bias=cfg.qkv_bias, attn_drop=cfg.attn_drop_rate,
                  drop_path=cfg.drop_path_rate * i / max(cfg.depth - 1, 1),
                  select=select.open and i >= select.keep_layers,
                  window_size=(hp, wp) if use_rel_pos_bias else None,
                  gelu_approx=cfg.gelu_approx, init_values=init_values,
                  qv_bias_only=qv_bias_only, tuning=tuning,
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

    @torch.no_grad()
    def forward(self, x: torch.Tensor, *, training: bool = False,
                complete_model: bool = False, dispatch: bool = False
                ) -> Tuple[Tuple[torch.Tensor, ...],
                           Dict[str, Optional[torch.Tensor]]]:
        if training:
            raise NotImplementedError("segmentation training is not ported "
                                      "yet (ROADMAP.md, queue 1 item 5)")
        cfg = self.cfg
        B, H, W, _ = x.shape
        hp, wp = H // cfg.patch_size, W // cfg.patch_size
        if (hp, wp) != self.grid:
            raise ValueError(f"a {H}x{W} input gives a {hp}x{wp} patch grid; "
                             f"this backbone was built for {self.grid}")
        x = self.patch_embed(x).float()
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)
        if hasattr(self, "pos_embed"):
            x = x + self.pos_embed
        x = x.to(self.residual_dtype)

        feats: List[torch.Tensor] = []
        gates, logits_all = [], []
        for i, blk in enumerate(self.blocks):
            x, gate, logits = blk(x, complete_model, dispatch)
            if gate is not None:
                gates.append(gate)
                logits_all.append(logits)
            if i in self.out_indices:
                # NCHW view of the NHWC token map
                feats.append(x[:, 1:, :].reshape(B, hp, wp, -1)
                             .permute(0, 3, 1, 2))

        f1 = self._up(F.gelu(self._up(feats[0], self.fpn1_deconv1)),
                      self.fpn1_deconv2)
        f2 = self._up(feats[1], self.fpn2_deconv)
        f3 = feats[2]
        f4 = F.max_pool2d(feats[3], 2, stride=2)

        if gates:
            token_select = torch.stack(gates, dim=1)[:, :, 1:, :]
            token_logits = torch.stack(logits_all, dim=1)
            loss = self.select_cfg.token_loss_ratio * token_budget_loss(
                token_select, self.select_cfg)
        else:
            token_select = token_logits = None
            loss = torch.zeros((), dtype=torch.float32)
        aux = dict(token_select=token_select, token_logits=token_logits,
                   loss=loss)
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
