"""Image transforms on the device of the images (counterpart of
dynamic_tuning_tpu/data/transforms.py).

The host decodes each image to a fixed-size uint8 canvas (short side to the
canvas, centre crop); ``augment_batch`` then crops, resamples, flips and
normalizes on the canvases' device.

Train (``augment_batch(generator, ..., train=True)``): the reference's
single-draw BYOL RandomResizedCrop (util/crop.py:16-45) and a horizontal
flip.  The boxes and flips are drawn on the host from the given
``torch.Generator`` (``sample_train_draws``: one (area, aspect) draw per
image, the crop's sides rounded then clamped to the canvas, an
integer-uniform position, a fair coin), so a run that seeds the generator
from (seed, step) draws the same boxes after a resume.
``_pil_resized_crop`` is PIL's ``crop().resize(BICUBIC)``: a horizontal
pass, ``floor(x + 0.5)`` and a clip to [0, 255] (PIL's 8-bit intermediate),
then the vertical pass, rounded and clipped again; each pass is a batched
fp32 product (``torch.bmm``, TF32 off) with a resample matrix whose taps
outside the crop are dropped and the rest renormalized
(``_pil_resample_matrix``, PIL's Resample.c).  An fp32 product summed in
another order than the JAX package's can land on the other side of a .5,
so the two agree within one count.

``center_crop_resize`` is ``jax.image.scale_and_translate(method="cubic")``
as the JAX package calls it: separable [out, in] weight matrices of the Keys
cubic (a = -0.5), antialiased when minifying, normalized per output sample,
zero for samples outside the input; the result clamped to [0, 255].  At
256 -> 224 the offset is a whole pixel and the weights pick an exact crop;
where ``canvas - crop`` is odd the crop sits on a half pixel and the cubic
taps mix four neighbours.

``resize_batch`` is the no-augmentation resize of a canvas that is not the
model's size (``jax.image.resize(method="cubic")``, the same weights with
no translation); ``normalize_batch`` the normalization alone.
"""

from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INCEPTION_MEAN = (0.5, 0.5, 0.5)
INCEPTION_STD = (0.5, 0.5, 0.5)


def normalize(x: torch.Tensor, inception: bool = False) -> torch.Tensor:
    """uint8 (or float) [..., 3] in [0, 255] -> normalized float32."""
    mean = torch.tensor(INCEPTION_MEAN if inception else IMAGENET_MEAN,
                        device=x.device)
    std = torch.tensor(INCEPTION_STD if inception else IMAGENET_STD,
                       device=x.device)
    return (x.float() / 255.0 - mean) / std


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel (a = -0.5) on |distance| x."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def weight_mats(in_size: int, out_size: int, scale: torch.Tensor,
                translation: torch.Tensor) -> torch.Tensor:
    """[n, out, in] float32 resampling weights of ``scale_and_translate``
    along one axis (output = input * scale + translation), one matrix per
    element of ``scale`` and ``translation`` (float32 [n]), on their
    device."""
    f32, dev = torch.float32, scale.device
    inv = 1.0 / scale[:, None, None]
    kernel_scale = torch.clamp(inv, min=1.0)       # antialias when minifying
    sample = ((torch.arange(out_size, dtype=f32, device=dev) + 0.5) * inv
              - translation[:, None, None] * inv - 0.5)       # [n, 1, out]
    dist = (sample - torch.arange(in_size, dtype=f32,
                                  device=dev)[:, None]).abs()
    w = _keys_cubic(dist / kernel_scale)                      # [n, in, out]
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = torch.where(inside, w, torch.zeros_like(w))
    return w.transpose(1, 2).contiguous()


def _weight_mat(in_size: int, out_size: int, scale: float,
                translation: float, device) -> torch.Tensor:
    """``weight_mats`` of one Python-float scale and translation, [out,
    in]."""
    f32 = torch.float32
    return weight_mats(in_size, out_size, torch.tensor([scale], dtype=f32),
                       torch.tensor([translation], dtype=f32))[0].to(device)


def center_crop_resize(images: torch.Tensor, resize_to: int = 256,
                       crop: int = 224) -> torch.Tensor:
    """Eval transform: resize the shorter side to ``resize_to``, centre crop
    ``crop`` (reference image_datasets.py:22-24), as one cubic resample of
    the canvas.  images [B, H, W, C] (any dtype) -> float32
    [B, crop, crop, C] in [0, 255]."""
    h, w = images.shape[1], images.shape[2]
    scale = resize_to / min(h, w)
    top = (h * scale - crop) / 2.0 / scale
    left = (w * scale - crop) / 2.0 / scale
    box = crop / scale
    # translation maps input coordinate `top` to output 0
    wy = _weight_mat(h, crop, crop / box, -top * (crop / box), images.device)
    wx = _weight_mat(w, crop, crop / box, -left * (crop / box),
                     images.device)
    x = images.float()
    rows = torch.einsum("oh,bhwc->bowc", wy, x)
    out = torch.einsum("pw,bowc->bopc", wx, rows)
    return out.clamp(0.0, 255.0)


def resize_batch(images: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, C] -> float32 [B, size, size, C]: the cubic resize of the
    no-augmentation path (reference image_datasets_noaug.py:16-23, PIL
    bicubic), clamped to [0, 255]."""
    h, w = images.shape[1], images.shape[2]
    wy = _weight_mat(h, size, size / h, 0.0, images.device)
    wx = _weight_mat(w, size, size / w, 0.0, images.device)
    rows = torch.einsum("oh,bhwc->bowc", wy, images.float())
    return torch.einsum("pw,bowc->bopc", wx, rows).clamp(0.0, 255.0)


def normalize_batch(images: torch.Tensor, inception: bool = False
                    ) -> torch.Tensor:
    """The no-augmentation path: canvases of the model's size, normalized."""
    return normalize(images, inception)


# --- train augmentation ------------------------------------------------------

def _sample_crop_box(generator: torch.Generator, n: int, h: int, w: int,
                     scale: Tuple[float, float] = (0.08, 1.0),
                     ratio: Tuple[float, float] = (3 / 4, 4 / 3)
                     ) -> Tuple[torch.Tensor, ...]:
    """(top, left, crop_h, crop_w), float32 [n] on the host, integer-valued:
    the reference's single-draw RandomResizedCrop (util/crop.py:16-45), not
    torchvision's 10-try loop.  One (area, aspect) draw; the crop's sides
    rounded, then clamped to the canvas; an integer-uniform position."""
    u = torch.rand((n, 4), generator=generator, dtype=torch.float32)
    target = h * w * (scale[0] + u[:, 0] * (scale[1] - scale[0]))
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = torch.exp(lo + u[:, 1] * (hi - lo))
    cw = torch.clamp(torch.round(torch.sqrt(target * aspect)), max=w)
    ch = torch.clamp(torch.round(torch.sqrt(target / aspect)), max=h)
    top = torch.floor(u[:, 2] * (h - ch + 1))
    left = torch.floor(u[:, 3] * (w - cw + 1))
    return top, left, ch, cw


def sample_train_draws(generator: torch.Generator, n: int, h: int, w: int
                       ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """The boxes (``_sample_crop_box``) and flips (bool [n]) of one train
    batch of n canvases of h x w, all drawn on the host from
    ``generator``."""
    boxes = _sample_crop_box(generator, n, h, w)
    flips = torch.rand((n,), generator=generator) < 0.5
    return boxes, flips


def _pil_bicubic_kernel(x: torch.Tensor) -> torch.Tensor:
    """PIL's BICUBIC resize kernel (Keys cubic, a = -0.5)."""
    a = -0.5
    ax = x.abs()
    near = ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
    far = (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a
    return torch.where(ax < 1.0, near,
                       torch.where(ax < 2.0, far, torch.zeros_like(ax)))


def _pil_resample_matrix(origin: torch.Tensor, size: torch.Tensor,
                         out_size: int, full: int) -> torch.Tensor:
    """[n, out_size, full] resample matrices reproducing PIL's
    ``crop((origin, origin + size)).resize(out_size, BICUBIC)`` along one
    axis, for n boxes (``origin``, ``size``: float32 [n], integer-valued).

    PIL (Resample.c precompute_coeffs) widens the kernel by the scale when
    minifying, drops taps that fall outside the crop and renormalizes the
    rest.  Every canvas column is a candidate tap: those beyond the
    kernel's support weigh 0, so the matrix equals PIL's windowed one."""
    dev = origin.device
    scale = size / out_size
    fs = torch.clamp(scale, min=1.0)            # PIL's filterscale
    center = ((torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5)
              [None, :] * scale[:, None])        # crop-local coordinates
    taps = (torch.arange(full, dtype=torch.float32, device=dev)[None, None, :]
            - origin[:, None, None])             # crop-local tap of a column
    wgt = _pil_bicubic_kernel((taps - center[:, :, None] + 0.5)
                              / fs[:, None, None])
    inside = (taps >= 0.0) & (taps < size[:, None, None])
    wgt = torch.where(inside, wgt, torch.zeros_like(wgt))
    return wgt / wgt.sum(dim=2, keepdim=True)


@contextlib.contextmanager
def _fp32_products():
    """fp32 products without TF32 on the card (TF32 rounds the operands to
    10 mantissa bits, enough to move a pixel across a .5)."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _round_pixels(x: torch.Tensor) -> torch.Tensor:
    """PIL's 8-bit store: round half up, clip to [0, 255]."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def _pil_resized_crop(images: torch.Tensor, top: torch.Tensor,
                      left: torch.Tensor, ch: torch.Tensor,
                      cw: torch.Tensor, out_size: int) -> torch.Tensor:
    """PIL's crop-then-resize (BICUBIC) of each canvas of [B, H, W, C] to its
    box (float32 [B] each, on any device), as two batched fp32 products,
    each pass rounded and clipped; -> float32 [B, out, out, C] of integer
    values in [0, 255]."""
    B, H, W, C = images.shape
    dev = images.device
    ay = _pil_resample_matrix(top.to(dev), ch.to(dev), out_size, H)
    ax = _pil_resample_matrix(left.to(dev), cw.to(dev), out_size, W)
    f = images.float()
    with _fp32_products():
        # horizontal pass: [B, W, H*C] -> [B, out, H*C]
        tmp = torch.bmm(ax, f.permute(0, 2, 1, 3).reshape(B, W, H * C))
        tmp = _round_pixels(tmp).view(B, out_size, H, C)
        # vertical pass: [B, H, out*C] -> [B, out, out*C]
        out = torch.bmm(ay, tmp.permute(0, 2, 1, 3).reshape(
            B, H, out_size * C))
    return _round_pixels(out).view(B, out_size, out_size, C)


def hflip(images: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """Mirror the images [B, H, W, C] whose ``flips`` (bool [B]) is set."""
    return torch.where(flips.to(images.device)[:, None, None, None],
                       images.flip(2), images)


def augment_batch(generator, images: torch.Tensor, *, out_size: int = 224,
                  inception: bool = False, train: bool = True
                  ) -> torch.Tensor:
    """[B, H, W, C] uint8 canvases -> [B, out, out, C] normalized float32 on
    the canvases' device.

    Train: per-image RandomResizedCrop + flip + normalize, the boxes and
    flips drawn from ``generator`` (a host ``torch.Generator``).  Eval:
    resize-256/centre-crop-224 (scaled with ``out_size``) + normalize;
    ``generator`` is unused there."""
    if train:
        if not isinstance(generator, torch.Generator):
            raise ValueError("train augmentation draws its boxes and flips "
                             "from a torch.Generator (no global RNG is "
                             f"used); got {generator!r}")
        (top, left, ch, cw), flips = sample_train_draws(
            generator, images.shape[0], images.shape[1], images.shape[2])
        out = hflip(_pil_resized_crop(images, top, left, ch, cw, out_size),
                    flips)
    else:
        out = center_crop_resize(images, resize_to=int(out_size * 256 / 224),
                                 crop=out_size)
    return normalize(out, inception)
