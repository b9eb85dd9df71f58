"""Clip augmentation on the device of the clips (counterpart of
dynamic_tuning_tpu/data/video_transforms.py; reference
video_datasets/transform.py).

The host ships fixed-size uint8 clip canvases ``[B, T, H, W, C]``; the
crops, resamples, flips and normalization run on their device, one draw
per clip shared by its frames (the reference's temporal consistency).
Every draw is made on the host from a given ``torch.Generator``
(``sample_*``), so a run that seeds it from (seed, step) draws the same
crops after a resume; each transform takes its draws as tensors (a test
can give it the JAX package's) and builds its weights on the clips'
device.

Resampling is ``jax.image.scale_and_translate(method="cubic")`` as the JAX
package calls it: Keys' cubic (a = -0.5), the kernel widened by 1 / scale
when minifying (antialias), each output sample's weights normalized to
sum to 1, samples outside the input zero (``transforms.weight_mats``), one
[crop, H] and one [crop, W] matrix per clip, applied as two float32
products with TF32 off.  No clamp, as the JAX package (the reference
resizes normalized floats): weights sum to 1, so the resample commutes
with the affine normalization.

* train, ``resize_type="random_short_side_scale_jitter"`` (K400): a short
  side uniform in [min_size, max_size), then a crop at a uniform position
  (``clip_scale_jitter_crop``, transform.py:49,125);
* train, ``"random_resized_crop"`` (SSv2, the default): torchvision's
  10-candidate box (``_sample_crop_box_10try``, transform.py:504-540) and
  its resample (``clip_random_resized_crop``, :546-585);
* a horizontal flip per clip with ``flip`` (``clip_hflip``, :161);
* eval: the short side to ``min_size`` and the centre crop
  (``clip_uniform_crop``, :196-240), or nothing when the dataset already
  cut the view (``pre_cropped``);
* ``randaug`` (SSv2: "rand-m7-n4-mstd0.5-inc1") applies RandAugment
  (``data/randaugment.py``) to each clip before the crop, the same ops on
  every frame;
* ``clip_color_jitter`` and ``clip_lighting_jitter`` (:321-460), which the
  recipes do not call.
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import torch

from dynamic_tuning_tpu_torch.data.transforms import (_fp32_products,
                                                      normalize, weight_mats)

F32 = torch.float32


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform(minval=lo, maxval=hi)`` of the [0, 1) draws
    ``u``: u * (hi - lo) + lo in float32, at least lo."""
    lo_t, hi_t = torch.tensor(lo, dtype=F32), torch.tensor(hi, dtype=F32)
    return torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t)


def _resample(clips: torch.Tensor, wy: torch.Tensor,
              wx: torch.Tensor) -> torch.Tensor:
    """clips [B, T, H, W, C] through each clip's [out, H] and [out, W]
    matrices (``wy``, ``wx``: [B or 1, out, in], on the clips' device) ->
    float32 [B, T, out, out, C]."""
    B = clips.shape[0]
    x = clips.to(F32)
    wy, wx = wy.expand(B, -1, -1), wx.expand(B, -1, -1)
    with _fp32_products():
        rows = torch.einsum("boh,bthwc->btowc", wy, x)
        return torch.einsum("bpw,btowc->btopc", wx, rows)


# --- draws -------------------------------------------------------------------

def sample_scale_jitter(generator: torch.Generator, n: int, min_size: int,
                        max_size: int) -> Tuple[torch.Tensor, ...]:
    """(short side [n], top and left fractions [n]), float32 on the host,
    for ``clip_scale_jitter_crop``."""
    u = torch.rand((n, 3), generator=generator, dtype=F32)
    return (_uniform(u[:, 0], float(min_size), float(max_size)),
            u[:, 1].contiguous(), u[:, 2].contiguous())


def crop_box_10try(u_area: torch.Tensor, u_ratio: torch.Tensor,
                   u_top: torch.Tensor, u_left: torch.Tensor, h: int, w: int,
                   scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)
                   ) -> Tuple[torch.Tensor, ...]:
    """(top, left, crop_h, crop_w), float32 [n], integer-valued, from the
    [0, 1) draws ``u_area``, ``u_ratio`` [n, 10] and ``u_top``, ``u_left``
    [n]: ten (area, aspect) candidates with rounded sides, the first that
    fits wins, its position integer-uniform (inclusive); none fits -> the
    ratio-clamped centre crop (the video reference's
    _get_param_spatial_crop, transform.py:504-540)."""
    target = (h * w) * _uniform(u_area, scale[0], scale[1])
    log_r = torch.log(torch.tensor(ratio, dtype=F32))
    aspect = torch.exp(_uniform(u_ratio, float(log_r[0]), float(log_r[1])))
    cw = torch.round(torch.sqrt(target * aspect))
    ch = torch.round(torch.sqrt(target / aspect))
    valid = (cw > 0) & (cw <= w) & (ch > 0) & (ch <= h)
    first = valid.to(torch.uint8).argmax(dim=1, keepdim=True)
    ok = valid.any(dim=1)
    in_ratio = w / h
    if in_ratio < min(ratio):
        fw, fh = w, int(round(w / min(ratio)))
    elif in_ratio > max(ratio):
        fh, fw = h, int(round(h * max(ratio)))
    else:
        fw, fh = w, h
    cw = torch.where(ok, cw.gather(1, first)[:, 0], float(fw))
    ch = torch.where(ok, ch.gather(1, first)[:, 0], float(fh))
    top = torch.where(ok, torch.floor(u_top * (h - ch + 1)),
                      float((h - fh) // 2))
    left = torch.where(ok, torch.floor(u_left * (w - cw + 1)),
                       float((w - fw) // 2))
    return top, left, ch, cw


def _sample_crop_box_10try(generator: torch.Generator, n: int, h: int,
                           w: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)
                           ) -> Tuple[torch.Tensor, ...]:
    """``crop_box_10try`` of n clips, its draws made on the host from
    ``generator``."""
    u = torch.rand((n, 22), generator=generator, dtype=F32)
    return crop_box_10try(u[:, :10], u[:, 10:20], u[:, 20], u[:, 21], h, w,
                          scale, ratio)


def sample_flips(generator: torch.Generator, n: int) -> torch.Tensor:
    """A fair coin per clip: bool [n] on the host."""
    return torch.rand((n,), generator=generator) < 0.5


# --- geometric transforms ----------------------------------------------------

def clip_scale_jitter_crop(clips: torch.Tensor, size: torch.Tensor,
                           top_frac: torch.Tensor, left_frac: torch.Tensor,
                           *, crop: int) -> torch.Tensor:
    """Each clip's short side scaled to ``size``, then the crop^2 at
    ``top_frac`` / ``left_frac`` of the slack: [B, T, H, W, C] -> float32
    [B, T, crop, crop, C]."""
    H, W = clips.shape[2], clips.shape[3]
    size, top_frac, left_frac = (t.to(clips.device)
                                 for t in (size, top_frac, left_frac))
    scale = size / min(H, W)
    top = top_frac * torch.clamp(H * scale - crop, min=0.0)
    left = left_frac * torch.clamp(W * scale - crop, min=0.0)
    return _resample(clips, weight_mats(H, crop, scale, -top),
                     weight_mats(W, crop, scale, -left))


def clip_uniform_crop(clips: torch.Tensor, *, resize_to: int, crop: int,
                      spatial_idx: int, num_crops: int = 3) -> torch.Tensor:
    """The eval crop: the short side to ``resize_to``, then the centre
    crop (one crop) or the left/centre/right (top/centre/bottom) crop
    ``spatial_idx`` along the long side (transform.py:196-240)."""
    H, W = clips.shape[2], clips.shape[3]
    scale = resize_to / min(H, W)
    nh, nw = H * scale, W * scale
    if num_crops == 1:
        top, left = (nh - crop) / 2.0, (nw - crop) / 2.0
    else:
        frac = {0: 0.0, 1: 0.5, 2: 1.0}[spatial_idx]
        if W >= H:
            top, left = (nh - crop) / 2.0, frac * (nw - crop)
        else:
            top, left = frac * (nh - crop), (nw - crop) / 2.0
    s, ty, tx = torch.tensor([[scale], [-top], [-left]], dtype=F32,
                             device=clips.device)
    return _resample(clips, weight_mats(H, crop, s, ty),
                     weight_mats(W, crop, s, tx))


def clip_random_resized_crop(clips: torch.Tensor, top: torch.Tensor,
                             left: torch.Tensor, ch: torch.Tensor,
                             cw: torch.Tensor, *, crop: int) -> torch.Tensor:
    """Each clip's box (float32 [B] each) resampled to crop^2, one box for
    all its frames: [B, T, H, W, C] -> float32 [B, T, crop, crop, C]."""
    H, W = clips.shape[2], clips.shape[3]
    top, left, ch, cw = (t.to(clips.device) for t in (top, left, ch, cw))
    sy, sx = crop / ch, crop / cw
    return _resample(clips, weight_mats(H, crop, sy, -top * sy),
                     weight_mats(W, crop, sx, -left * sx))


def clip_hflip(clips: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """Mirror the clips [B, T, H, W, C] whose ``flips`` (bool [B]) is
    set."""
    return torch.where(flips.to(clips.device)[:, None, None, None, None],
                       clips.flip(3), clips)


# --- photometric transforms (transform.py:281-460) ---------------------------

def _grayscale(x: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma of RGB [..., 3], broadcast over the channels."""
    gray = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    return gray[..., None].expand(x.shape)


_ORDERS = list(itertools.permutations(range(3)))


def clip_color_jitter(clips: torch.Tensor, alphas: torch.Tensor,
                      order: torch.Tensor, *, brightness: float = 0.0,
                      contrast: float = 0.0,
                      saturation: float = 0.0) -> torch.Tensor:
    """Brightness, contrast and saturation jitter of float clips
    [B, T, H, W, 3] in each clip's order (reference color_jitter,
    transform.py:321-352): brightness scales the pixels, contrast blends
    with the clip's mean luma, saturation with each pixel's luma; a
    strength of 0 leaves its step out.  -> float32."""
    x = clips.to(F32)
    B = x.shape[0]
    a = alphas.to(x.device)[:, :, None, None, None, None]     # [B, 3, 1...]

    def step(fn: int, x: torch.Tensor) -> torch.Tensor:
        al = a[:, fn]
        if fn == 0:
            return x * al if brightness else x
        if fn == 1:
            if not contrast:
                return x
            ref = _grayscale(x).reshape(B, -1).mean(dim=1)[:, None, None,
                                                           None, None]
            return x * al + ref * (1.0 - al)
        if not saturation:
            return x
        return x * al + _grayscale(x) * (1.0 - al)

    perm = torch.tensor(_ORDERS, device=x.device)[order.to(x.device)]
    for pos in range(3):
        steps = [step(fn, x) for fn in range(3)]
        pick = perm[:, pos][:, None, None, None, None]
        x = torch.where(pick == 0, steps[0],
                        torch.where(pick == 1, steps[1], steps[2]))
    return x


def clip_lighting_jitter(clips: torch.Tensor, alpha: Optional[torch.Tensor],
                         *, eigval, eigvec) -> torch.Tensor:
    """AlexNet-style PCA lighting noise (reference lighting_jitter,
    transform.py:413-460): each clip plus eigvec @ (alpha * eigval), alpha
    [B, 3] (alphastd * N(0, 1) draws; None = no noise)."""
    x = clips.to(F32)
    if alpha is None:
        return x
    eigval = torch.as_tensor(eigval, dtype=F32, device=x.device).reshape(
        1, 1, 3)
    eigvec = torch.as_tensor(eigvec, dtype=F32, device=x.device)
    rgb = ((eigvec[None] * alpha.to(x.device)[:, None, :]) * eigval).sum(-1)
    return x + rgb[:, None, None, None, :]


# --- the batch ---------------------------------------------------------------

def augment_clip_batch(generator, clips: torch.Tensor, *, crop: int = 224,
                       min_size: int = 256, max_size: int = 320,
                       train: bool = True, inception: bool = False,
                       flip: bool = True, randaug: Optional[str] = None,
                       pre_cropped: bool = False,
                       resize_type: str = "random_resized_crop",
                       scale_min: float = 0.08,
                       scale_max: float = 1.0) -> torch.Tensor:
    """[B, T, H, W, C] uint8 -> [B, T, crop, crop, C] normalized float32 on
    the clips' device.  Train draws from ``generator`` (a host
    ``torch.Generator``), in this order: RandAugment's (with ``randaug``),
    the crops', the flips'; eval uses none."""
    if train:
        if not isinstance(generator, torch.Generator):
            raise ValueError("train augmentation draws from a "
                             "torch.Generator (no global RNG is used); got "
                             f"{generator!r}")
        n, H, W = clips.shape[0], clips.shape[2], clips.shape[3]
        if randaug is not None:
            from dynamic_tuning_tpu_torch.data.randaugment import \
                rand_augment_clips
            clips = rand_augment_clips(generator, clips, randaug)
        if resize_type == "random_resized_crop":
            box = _sample_crop_box_10try(generator, n, H, W,
                                         (scale_min, scale_max))
            out = clip_random_resized_crop(clips, *box, crop=crop)
        elif resize_type == "random_short_side_scale_jitter":
            draws = sample_scale_jitter(generator, n, min_size, max_size)
            out = clip_scale_jitter_crop(clips, *draws, crop=crop)
        else:
            raise ValueError(f"resize_type={resize_type!r}")
        if flip:
            out = clip_hflip(out, sample_flips(generator, n))
    elif pre_cropped:
        out = clips.to(F32)
    else:
        out = clip_uniform_crop(clips, resize_to=min_size, crop=crop,
                                spatial_idx=1, num_crops=1)
    return normalize(out, inception)
