"""UPerNet decode head + FCN auxiliary head + DyT segmentor in PyTorch
(counterpart of dynamic_tuning_tpu/models/upernet.py), serving and training
forwards, the segmentation loss, and sliding-window inference.

* ``ConvModule``: a SAME-padded conv in the compute dtype (no bias) -- or,
  with ``quant`` int8 and not training, ``ops/quant.py::q8_conv_codes``
  (int8 weights per output channel, int8 activations per sample, int32
  sums) -- then GroupNorm (32 groups, eps 1e-6) or, with ``norm="bn"``,
  flax's BatchNorm (eps 1e-5: in training the batch statistics, folded
  into the running ones at momentum 0.9; in eval the running ones) in fp32
  on an fp32 copy, then ReLU; its output is fp32.
* ``UPerHead``: PSP pyramid pooling on the stride-32 map, FPN top-down
  fusion, a 3x3 bottleneck over the four resized levels, dropout 0.1 in
  training and an fp32 1x1 classifier with bias.  ``FCNHead``: one
  ConvModule, dropout 0.1 in training and an fp32 1x1 classifier.
* ``DyTSegmentor``: ``SegVisionTransformer`` + both heads, logits resized to
  the input size.  ``training=True`` records the graph; dropout draws come
  from ``draws`` (``models.layers.Draws``), the routers' noise from it or
  from ``gate_noise``.  The eval forward runs without autograd.
* ``seg_loss``: CE(main) + 0.4 CE(aux) + the token budget loss, each CE
  averaged over every pixel, ignored ones included.

The convolutions are cuDNN's (the JAX package leaves them to XLA, not to a
Pallas kernel); the 1x1 classifiers are fp32 matmuls, so no TF32 setting
reaches them.  Resizes are torch's bilinear (align_corners=False, no
antialiasing) and pooling torch's adaptive average: the semantics the JAX
package reproduces (its ``_resize`` and ``_adaptive_avg_pool``).  On a
tensor that requires grad they are products with fixed [out, in] matrices
on each spatial axis, as the JAX package writes its downscaling: their
gradients are matrix products, which a card sums in the same order every
time, where ``F.interpolate`` and ``F.adaptive_avg_pool2d`` add theirs
with atomics.  Public functions take and return NHWC, as in the JAX
package; inside, the heads work on NCHW views.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dynamic_tuning_tpu_torch.config import (ModelConfig, SelectConfig,
                                             TuningConfig)
from dynamic_tuning_tpu_torch.models.layers import (Draws, _WeightCache,
                                                     dropout)
from dynamic_tuning_tpu_torch.models.seg_vit import SegVisionTransformer
from dynamic_tuning_tpu_torch.ops import quant as qt
from dynamic_tuning_tpu_torch.parallel.mesh import (global_sum,
                                                    process_count, sync_sum)

GN_EPS = 1e-6        # flax GroupNorm's default
BN_EPS = 1e-5
BN_MOMENTUM = 0.9    # flax's: running = 0.9 * running + 0.1 * batch
HEAD_DROPOUT = 0.1
AUX_INDEX = 2        # the FCN head reads the stride-16 map
AUX_WEIGHT = 0.4
IGNORE_INDEX = 255
POOL_SCALES = (1, 2, 3, 6)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


_MATRICES = {}


def _axis_matrix(kind: str, n_in: int, n_out: int, like: torch.Tensor
                 ) -> torch.Tensor:
    """[n_out, n_in] fp32 matrix of one axis, cached per device.
    ``bilinear``: torch's ``F.interpolate(mode="bilinear",
    align_corners=False, antialias=False)``, half-pixel source coordinates,
    two taps, clamped at the edges.  ``pool``: ``AdaptiveAvgPool``'s
    windows, output i averaging inputs [floor(i n / o), ceil((i+1) n / o))."""
    key = (kind, n_in, n_out, str(like.device))
    m = _MATRICES.get(key)
    if m is None:
        m = torch.zeros((n_out, n_in), dtype=torch.float64)
        for i in range(n_out):
            if kind == "pool":
                lo, hi = (i * n_in) // n_out, -(-(i + 1) * n_in // n_out)
                m[i, lo:hi] = 1.0 / (hi - lo)
                continue
            x = (i + 0.5) * n_in / n_out - 0.5
            x0 = math.floor(x)
            w1 = x - x0
            m[i, min(max(x0, 0), n_in - 1)] += 1.0 - w1
            m[i, min(max(x0 + 1, 0), n_in - 1)] += w1
        with torch.inference_mode(False):      # usable outside it too
            m = m.float().to(like.device)
        _MATRICES[key] = m
    return m


def _contract(x: torch.Tensor, kind: str, hw: Tuple[int, int]
              ) -> torch.Tensor:
    """An fp32 NCHW map through the ``kind`` matrix of each spatial axis."""
    (H, W), (h, w) = x.shape[2:], tuple(hw)
    x = torch.matmul(x, _axis_matrix(kind, W, w, x).t())
    return torch.matmul(_axis_matrix(kind, H, h, x), x)


def _resize(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NCHW map, torch's align_corners=False without
    antialiasing (the reference's mmseg resize); the matrix products when
    ``x`` requires grad."""
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    if x.requires_grad:
        return _contract(x, "bilinear", hw)
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=False)


def _adaptive_avg_pool(x: torch.Tensor, out: int) -> torch.Tensor:
    """``AdaptiveAvgPool2d(out)`` of an NCHW map; when ``x`` requires grad,
    a mean over equal windows where ``out`` divides both sides, else the
    window matrices."""
    if not x.requires_grad:
        return F.adaptive_avg_pool2d(x, out)
    B, C, H, W = x.shape
    if H % out == 0 and W % out == 0:
        return x.reshape(B, C, out, H // out, out, W // out).mean(dim=(3, 5))
    return _contract(x, "pool", (out, out))


def _conv_init(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's lecun_normal: truncated normal of variance 1/fan_in."""
    std = math.sqrt(1.0 / w[0].numel())
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class _BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)``:
    ``weight``, ``bias`` and the running statistics ``running_mean`` /
    ``running_var`` (the flax tree's batch_stats).  In training it
    normalises by the batch statistics over (N, H, W) in fp32 -- the
    variance ``max(E[x^2] - E[x]^2, 0)``, flax's fast biased form -- and
    folds both into the running statistics in place
    (``F.batch_norm(training=True)`` would store the unbiased variance).
    Under a process group the statistics are the global batch's, as under
    the JAX package's mesh (SyncBN): each channel's sum, sum of squares and
    count summed over ranks (``parallel.mesh.sync_sum``, whose backward
    sums the ranks' gradients)."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor, training: bool = False
                ) -> torch.Tensor:
        if not training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=BN_EPS)
        C = x.shape[1]
        stats = sync_sum(torch.cat([
            x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)),
            x.new_full((1,), float(x.numel() // C))]))
        mean, sq = stats[:C] / stats[-1], stats[C:2 * C] / stats[-1]
        var = torch.clamp_min(sq - mean * mean, 0.0)
        with torch.no_grad():
            for stat, batch in ((self.running_mean, mean),
                                (self.running_var, var)):
                stat.copy_(BN_MOMENTUM * stat
                           + (1.0 - BN_MOMENTUM) * batch.detach())
        # flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class ConvModule(nn.Module):
    """conv (compute dtype, SAME, no bias; ``q8_conv_codes`` in eval with
    ``quant``) -> GN or BN (fp32) -> ReLU; NCHW in, fp32 NCHW out."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 generator: torch.Generator, *, norm: str = "gn",
                 quant: str = "none", dtype=torch.bfloat16):
        super().__init__()
        if norm not in ("gn", "bn"):
            raise ValueError(f"norm={norm!r}: gn or bn")
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2,
                              bias=False)
        with torch.no_grad():
            _conv_init(self.conv.weight, generator)
        if norm == "bn":
            self.bn = _BatchNorm(out_ch)
        else:
            self.gn = nn.GroupNorm(32, out_ch, eps=GN_EPS)
        self.quant = quant
        self.dtype = dtype
        self._w = _WeightCache()

    def forward(self, x: torch.Tensor, training: bool = False
                ) -> torch.Tensor:
        if self.quant != "none" and not training:
            # the JAX package's q8_conv on the fp32 input
            wq, ws = self._w.int8(self.conv.weight, qt.quantize_conv_weight)
            y = _nchw(qt.q8_conv_codes(_nhwc(x), wq, ws,
                                       kernel=self.conv.kernel_size[0]))
        else:
            dt = self.dtype
            y = F.conv2d(x.to(dt), self._w.get(self.conv.weight, dt),
                         padding=self.conv.padding).float()
        y = self.bn(y, training) if hasattr(self, "bn") else self.gn(y)
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
                 *, norm: str = "gn", quant: str = "none",
                 dtype=torch.bfloat16):
        super().__init__()
        kw = dict(norm=norm, quant=quant, dtype=dtype)
        for i in range(len(POOL_SCALES)):
            self.add_module(f"pool_{i}", ConvModule(
                in_ch, channels, 1, generator, **kw))
        self.bottleneck = ConvModule(in_ch + len(POOL_SCALES) * channels,
                                     channels, 3, generator, **kw)

    def forward(self, x: torch.Tensor, training: bool = False
                ) -> torch.Tensor:
        hw = x.shape[2:]
        outs = [x]
        for i, s in enumerate(POOL_SCALES):
            pooled = getattr(self, f"pool_{i}")(_adaptive_avg_pool(x, s),
                                                training)
            outs.append(_resize(pooled, hw))
        return self.bottleneck(torch.cat(outs, dim=1), training)


class UPerHead(nn.Module):
    """UPerNet decode head (mmseg UPerHead semantics): 4 NHWC fp32 maps ->
    NHWC fp32 logits at the stride-4 resolution."""

    def __init__(self, in_ch: int, num_classes: int,
                 generator: torch.Generator, *, channels: int = 768,
                 norm: str = "gn", quant: str = "none",
                 dtype=torch.bfloat16):
        super().__init__()
        kw = dict(norm=norm, quant=quant, dtype=dtype)
        self.psp = PSPModule(in_ch, channels, generator, **kw)
        for i in range(3):
            self.add_module(f"lateral_{i}", ConvModule(
                in_ch, channels, 1, generator, **kw))
        for i in range(3):
            self.add_module(f"fpn_{i}", ConvModule(
                channels, channels, 3, generator, **kw))
        self.fpn_bottleneck = ConvModule(4 * channels, channels, 3, generator,
                                         **kw)
        self.dropout = HEAD_DROPOUT
        self.conv_seg = _Classifier(channels, num_classes, generator)

    def forward(self, feats: Sequence[torch.Tensor], training: bool = False,
                draws: Optional[Draws] = None) -> torch.Tensor:
        feats = [_nchw(f) for f in feats]
        laterals = [getattr(self, f"lateral_{i}")(f, training)
                    for i, f in enumerate(feats[:-1])]
        laterals.append(self.psp(feats[-1], training))
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _resize(
                laterals[i], laterals[i - 1].shape[2:])
        outs = [getattr(self, f"fpn_{i}")(laterals[i], training)
                for i in range(len(laterals) - 1)]
        outs.append(laterals[-1])
        hw0 = outs[0].shape[2:]
        fused = self.fpn_bottleneck(torch.cat([_resize(o, hw0) for o in outs],
                                              dim=1), training)
        fused = dropout(fused, self.dropout if training else 0.0, draws)
        return self.conv_seg(fused)


class FCNHead(nn.Module):
    """1-conv FCN auxiliary head (mmseg FCNHead): NHWC fp32 map -> NHWC fp32
    logits."""

    def __init__(self, in_ch: int, num_classes: int,
                 generator: torch.Generator, *, channels: int = 256,
                 norm: str = "gn", quant: str = "none",
                 dtype=torch.bfloat16):
        super().__init__()
        self.conv0 = ConvModule(in_ch, channels, 3, generator, norm=norm,
                                quant=quant, dtype=dtype)
        self.dropout = HEAD_DROPOUT
        self.conv_seg = _Classifier(channels, num_classes, generator)

    def forward(self, x: torch.Tensor, training: bool = False,
                draws: Optional[Draws] = None) -> torch.Tensor:
        x = self.conv0(_nchw(x), training)
        return self.conv_seg(dropout(x, self.dropout if training else 0.0,
                                     draws))


class DyTSegmentor(nn.Module):
    """Backbone + UPerHead + auxiliary FCN (reference our_vit.py: head
    channels = embed_dim, aux on feature 2, 150 ADE20K classes).  Weights
    are drawn from ``generator`` (seed 0 when omitted), then moved to
    ``device``.  With ``cfg.quant`` int8 the eval forward serves int8: the
    stem, K4 for every block's MLP (attention stays bf16 on K9) and
    ``q8_conv_codes`` in every ConvModule; training runs bf16 all the
    same."""

    def __init__(self, cfg: ModelConfig, num_classes: int = 150,
                 tuning: TuningConfig = TuningConfig(),
                 select: SelectConfig = SelectConfig(), *, norm: str = "gn",
                 head_channels: Optional[int] = None, dtype=torch.bfloat16,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        C = cfg.embed_dim
        self.depth = cfg.depth
        self.backbone = SegVisionTransformer(cfg, tuning=tuning,
                                             select=select, dtype=dtype,
                                             generator=generator)
        self.decode_head = UPerHead(C, num_classes, generator,
                                    channels=head_channels or C, norm=norm,
                                    quant=cfg.quant, dtype=dtype)
        self.auxiliary_head = FCNHead(C, num_classes, generator, norm=norm,
                                      quant=cfg.quant, dtype=dtype)
        self.eval()
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor, *, training: bool = False,
                complete_model: bool = False, dispatch: bool = False,
                aux_logits: bool = True, draws: Optional[Draws] = None,
                gate_noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Dict]:
        """NHWC image [B, H, W, 3] -> (logits [B, H, W, classes] fp32,
        auxiliary logits of the same shape or None when ``aux_logits`` is
        False, backbone aux dict).  Serving callers that read only the
        logits pass ``aux_logits=False``: the JAX package's compiled
        evaluation drops the unused auxiliary head the same way.  Training
        (mask-multiply gates, no dispatch) draws from ``draws``: the
        backbone folds in its block indices, the heads fold ``depth + 1``
        and ``depth + 2``."""
        if training:
            return self._forward(x, True, complete_model, False, aux_logits,
                                 draws, gate_noise)
        with torch.no_grad():
            return self._forward(x, False, complete_model, dispatch,
                                 aux_logits, None, None)

    def _forward(self, x, training, complete_model, dispatch, aux_logits,
                 draws, gate_noise):
        feats, aux = self.backbone(x, training=training,
                                   complete_model=complete_model,
                                   dispatch=dispatch, draws=draws,
                                   gate_noise=gate_noise)

        def head_draws(i):
            return draws.fold(self.depth + i) if draws is not None else None

        hw = x.shape[1:3]
        logits = _nhwc(_resize(_nchw(self.decode_head(
            feats, training, head_draws(1))), hw))
        aux_out = None
        if aux_logits:
            aux_out = _nhwc(_resize(_nchw(self.auxiliary_head(
                feats[AUX_INDEX], training, head_draws(2))), hw))
        return logits, aux_out, aux


def seg_loss(logits: torch.Tensor, aux_logits: torch.Tensor,
             labels: torch.Tensor, token_loss: torch.Tensor,
             aux_weight: float = AUX_WEIGHT,
             ignore_index: int = IGNORE_INDEX
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CE(main) + ``aux_weight`` CE(aux) + the token budget loss -> (total,
    {decode_loss, aux_loss, token_loss}).  logits [B, H, W, classes],
    labels [B, H, W] with ``ignore_index`` for unlabelled pixels.  Each CE
    is the reference's executed mean: ignored pixels add 0 to the sum but
    count in the denominator, ``labels.numel()`` (the global batch's under
    a process group, ``parallel/mesh.py``)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()

    def ce(lg):
        logp = F.log_softmax(lg.float(), dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        return (global_sum((nll * valid).sum())
                / (labels.numel() * process_count()))

    main = ce(logits)
    aux = ce(aux_logits)
    total = main + aux_weight * aux + token_loss
    return total, dict(decode_loss=main, aux_loss=aux, token_loss=token_loss)


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
