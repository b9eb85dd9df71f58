"""UPerNet decode head + FCN auxiliary head + DyT segmentor in PyTorch
(counterpart of dynamic_tuning_tpu/models/upernet.py), serving forward, and
sliding-window inference.

* ``ConvModule``: a SAME-padded conv in the compute dtype (no bias), then
  GroupNorm (32 groups, eps 1e-6) -- or, with ``norm="bn"``, BatchNorm on
  its running statistics (eps 1e-5) -- in fp32 on an fp32 copy, then ReLU;
  its output is fp32.
* ``UPerHead``: PSP pyramid pooling on the stride-32 map, FPN top-down
  fusion, a 3x3 bottleneck over the four resized levels and an fp32 1x1
  classifier with bias.  ``FCNHead``: one ConvModule and an fp32 1x1
  classifier.
* ``DyTSegmentor``: ``SegVisionTransformer`` + both heads, logits resized to
  the input size.

The convolutions are cuDNN's (the JAX package leaves them to XLA, not to a
Pallas kernel); the 1x1 classifiers are fp32 matmuls, so no TF32 setting
reaches them.  Resizes are torch's ``F.interpolate(mode="bilinear",
align_corners=False)`` and pooling ``F.adaptive_avg_pool2d``: the semantics
the JAX package reproduces (its ``_resize`` and ``_adaptive_avg_pool``).
Public functions take and return NHWC, as in the JAX package; inside, the
heads work on NCHW views.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dynamic_tuning_tpu_torch.config import (ModelConfig, SelectConfig,
                                             TuningConfig)
from dynamic_tuning_tpu_torch.models.layers import _WeightCache
from dynamic_tuning_tpu_torch.models.seg_vit import SegVisionTransformer

GN_EPS = 1e-6        # flax GroupNorm's default
BN_EPS = 1e-5
AUX_INDEX = 2        # the FCN head reads the stride-16 map
POOL_SCALES = (1, 2, 3, 6)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _resize(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NCHW map, torch's align_corners=False without
    antialiasing (the reference's mmseg resize)."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=False)


def _conv_init(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's lecun_normal: truncated normal of variance 1/fan_in."""
    std = math.sqrt(1.0 / w[0].numel())
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class _BatchNormEval(nn.Module):
    """BatchNorm in eval: ``weight``, ``bias`` and the running statistics
    ``running_mean`` / ``running_var`` (the flax tree's batch_stats)."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=BN_EPS)


class ConvModule(nn.Module):
    """conv (compute dtype, SAME, no bias) -> GN or eval BN (fp32) ->
    ReLU; NCHW in, fp32 NCHW out."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 generator: torch.Generator, *, norm: str = "gn",
                 dtype=torch.bfloat16):
        super().__init__()
        if norm not in ("gn", "bn"):
            raise ValueError(f"norm={norm!r}: gn or bn")
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2,
                              bias=False)
        with torch.no_grad():
            _conv_init(self.conv.weight, generator)
        if norm == "bn":
            self.bn = _BatchNormEval(out_ch)
        else:
            self.gn = nn.GroupNorm(32, out_ch, eps=GN_EPS)
        self.dtype = dtype
        self._w = _WeightCache()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv2d(x.to(dt), self._w.get(self.conv.weight, dt),
                     padding=self.conv.padding).float()
        y = self.bn(y) if hasattr(self, "bn") else self.gn(y)
        return torch.relu(y)


class _Classifier(nn.Module):
    """The fp32 1x1 conv with bias that ends both heads, as an fp32 matmul
    over the channel axis (``weight`` [classes, in, 1, 1] as nn.Conv2d)."""

    def __init__(self, in_ch: int, classes: int, generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(classes, in_ch, 1, 1))
        self.bias = nn.Parameter(torch.zeros(classes))
        with torch.no_grad():
            _conv_init(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW in (any dtype), fp32 NHWC out."""
        return F.linear(_nhwc(x.float()), self.weight.flatten(1), self.bias)


class PSPModule(nn.Module):
    """Pyramid pooling over the stride-32 map (UPerHead's PSP part)."""

    def __init__(self, in_ch: int, channels: int, generator: torch.Generator,
                 *, norm: str = "gn", dtype=torch.bfloat16):
        super().__init__()
        for i in range(len(POOL_SCALES)):
            self.add_module(f"pool_{i}", ConvModule(
                in_ch, channels, 1, generator, norm=norm, dtype=dtype))
        self.bottleneck = ConvModule(in_ch + len(POOL_SCALES) * channels,
                                     channels, 3, generator, norm=norm,
                                     dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = x.shape[2:]
        outs = [x]
        for i, s in enumerate(POOL_SCALES):
            pooled = getattr(self, f"pool_{i}")(F.adaptive_avg_pool2d(x, s))
            outs.append(_resize(pooled, hw))
        return self.bottleneck(torch.cat(outs, dim=1))


class UPerHead(nn.Module):
    """UPerNet decode head (mmseg UPerHead semantics): 4 NHWC fp32 maps ->
    NHWC fp32 logits at the stride-4 resolution."""

    def __init__(self, in_ch: int, num_classes: int,
                 generator: torch.Generator, *, channels: int = 768,
                 norm: str = "gn", dtype=torch.bfloat16):
        super().__init__()
        self.psp = PSPModule(in_ch, channels, generator, norm=norm,
                             dtype=dtype)
        for i in range(3):
            self.add_module(f"lateral_{i}", ConvModule(
                in_ch, channels, 1, generator, norm=norm, dtype=dtype))
        for i in range(3):
            self.add_module(f"fpn_{i}", ConvModule(
                channels, channels, 3, generator, norm=norm, dtype=dtype))
        self.fpn_bottleneck = ConvModule(4 * channels, channels, 3, generator,
                                         norm=norm, dtype=dtype)
        self.conv_seg = _Classifier(channels, num_classes, generator)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        feats = [_nchw(f) for f in feats]
        laterals = [getattr(self, f"lateral_{i}")(f)
                    for i, f in enumerate(feats[:-1])]
        laterals.append(self.psp(feats[-1]))
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _resize(
                laterals[i], laterals[i - 1].shape[2:])
        outs = [getattr(self, f"fpn_{i}")(laterals[i])
                for i in range(len(laterals) - 1)]
        outs.append(laterals[-1])
        hw0 = outs[0].shape[2:]
        fused = self.fpn_bottleneck(torch.cat([_resize(o, hw0) for o in outs],
                                              dim=1))
        return self.conv_seg(fused)          # dropout: the identity in eval


class FCNHead(nn.Module):
    """1-conv FCN auxiliary head (mmseg FCNHead): NHWC fp32 map -> NHWC fp32
    logits."""

    def __init__(self, in_ch: int, num_classes: int,
                 generator: torch.Generator, *, channels: int = 256,
                 norm: str = "gn", dtype=torch.bfloat16):
        super().__init__()
        self.conv0 = ConvModule(in_ch, channels, 3, generator, norm=norm,
                                dtype=dtype)
        self.conv_seg = _Classifier(channels, num_classes, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_seg(self.conv0(_nchw(x)))


class DyTSegmentor(nn.Module):
    """Backbone + UPerHead + auxiliary FCN (reference our_vit.py: head
    channels = embed_dim, aux on feature 2, 150 ADE20K classes), serving
    forward.  Weights are drawn from ``generator`` (seed 0 when omitted),
    then moved to ``device``.  int8 (``cfg.quant``) is not ported for
    segmentation and raises."""

    def __init__(self, cfg: ModelConfig, num_classes: int = 150,
                 tuning: TuningConfig = TuningConfig(),
                 select: SelectConfig = SelectConfig(), *, norm: str = "gn",
                 head_channels: Optional[int] = None, dtype=torch.bfloat16,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.quant != "none":
            raise NotImplementedError(
                "int8 segmentation (the UPerHead int8 convs) is not ported "
                "yet: ROADMAP.md, queue 1 item 5")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        C = cfg.embed_dim
        self.backbone = SegVisionTransformer(cfg, tuning=tuning,
                                             select=select, dtype=dtype,
                                             generator=generator)
        self.decode_head = UPerHead(C, num_classes, generator,
                                    channels=head_channels or C, norm=norm,
                                    dtype=dtype)
        self.auxiliary_head = FCNHead(C, num_classes, generator, norm=norm,
                                      dtype=dtype)
        self.eval()
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, *, training: bool = False,
                complete_model: bool = False, dispatch: bool = False,
                aux_logits: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Dict]:
        """NHWC image [B, H, W, 3] -> (logits [B, H, W, classes] fp32,
        auxiliary logits of the same shape or None when ``aux_logits`` is
        False, backbone aux dict).  Serving callers that read only the
        logits pass ``aux_logits=False``: the JAX package's compiled
        evaluation drops the unused auxiliary head the same way."""
        feats, aux = self.backbone(x, training=training,
                                   complete_model=complete_model,
                                   dispatch=dispatch)
        hw = x.shape[1:3]
        logits = _nhwc(_resize(_nchw(self.decode_head(feats)), hw))
        aux_out = None
        if aux_logits:
            aux_out = _nhwc(_resize(
                _nchw(self.auxiliary_head(feats[AUX_INDEX])), hw))
        return logits, aux_out, aux


def slide_inference(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                    image: torch.Tensor, *, num_classes: int,
                    crop: int = 512, stride: int = 341,
                    tile_batch: int = 1) -> torch.Tensor:
    """Sliding-window whole-image inference (reference
    encoder_decoder.py:180-199; test_cfg crop 512 / stride 341).

    ``image`` [H, W, 3] normalized; ``apply_fn(tiles [n, crop, crop, 3]) ->
    logits [n, crop, crop, classes]``.  Returns [H, W, classes] fp32 logits:
    the window logits summed where windows overlap, divided by the count.
    ``tile_batch`` windows go through one call (clamped to the window
    count); the last call is padded by repeating its last window with
    weight 0, so the result does not depend on it."""
    H, W = image.shape[0], image.shape[1]
    pad_h, pad_w = max(crop - H, 0), max(crop - W, 0)
    img = F.pad(image, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w

    logits = torch.zeros((Hp, Wp, num_classes), dtype=torch.float32,
                         device=image.device)
    count = torch.zeros((Hp, Wp, 1), dtype=torch.float32, device=image.device)
    ys = list(range(0, max(Hp - crop, 0) + 1, stride))
    xs = list(range(0, max(Wp - crop, 0) + 1, stride))
    if ys[-1] + crop < Hp:
        ys.append(Hp - crop)
    if xs[-1] + crop < Wp:
        xs.append(Wp - crop)
    coords = [(y, x0) for y in ys for x0 in xs]
    tb = max(1, min(int(tile_batch), len(coords)))
    weights = [1.0] * len(coords)
    while len(coords) % tb:
        coords.append(coords[-1])
        weights.append(0.0)

    for c0 in range(0, len(coords), tb):
        chunk = coords[c0:c0 + tb]
        tiles = torch.stack([img[y:y + crop, x0:x0 + crop]
                             for y, x0 in chunk])
        outs = apply_fn(tiles)
        for j, (y, x0) in enumerate(chunk):
            wgt = weights[c0 + j]
            logits[y:y + crop, x0:x0 + crop] += outs[j] * wgt
            count[y:y + crop, x0:x0 + crop] += wgt
    return (logits / torch.clamp_min(count, 1.0))[:H, :W]
