"""Eval image transforms on the device of the images (counterpart of the eval
half of dynamic_tuning_tpu/data/transforms.py).

The host decodes each image to a fixed-size uint8 canvas (short side to the
canvas, centre crop); ``augment_batch(..., train=False)`` then resamples the
canvases' centre to ``out_size`` and normalizes, on the canvases' device.

``center_crop_resize`` is ``jax.image.scale_and_translate(method="cubic")``
as the JAX package calls it: separable [out, in] weight matrices of the Keys
cubic (a = -0.5), antialiased when minifying, normalized per output sample,
zero for samples outside the input; the result clamped to [0, 255].  At
256 -> 224 the offset is a whole pixel and the weights pick an exact crop;
where ``canvas - crop`` is odd the crop sits on a half pixel and the cubic
taps mix four neighbours.

The train half (the PIL-exact RandomResizedCrop and the flip) comes with the
training slice: ``train=True`` raises.
"""

from __future__ import annotations

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


def _weight_mat(in_size: int, out_size: int, scale: float,
                translation: float, device) -> torch.Tensor:
    """[out, in] resampling weights of ``scale_and_translate`` along one
    axis (output = input * scale + translation), in float32."""
    f32 = torch.float32
    scale_t = torch.tensor(scale, dtype=f32)
    inv = 1.0 / scale_t
    kernel_scale = torch.clamp(inv, min=1.0)       # antialias when minifying
    sample = ((torch.arange(out_size, dtype=f32) + 0.5) * inv
              - torch.tensor(translation, dtype=f32) * inv - 0.5)
    dist = (sample[None, :] - torch.arange(in_size, dtype=f32)[:, None]).abs()
    w = _keys_cubic(dist / kernel_scale)                       # [in, out]
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.t().contiguous().to(device)


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


def augment_batch(rng, images: torch.Tensor, *, out_size: int = 224,
                  inception: bool = False, train: bool = False
                  ) -> torch.Tensor:
    """[B, H, W, C] uint8 canvases -> [B, out, out, C] normalized float32 on
    the canvases' device.  Eval: resize-256/centre-crop-224 (scaled with
    ``out_size``) + normalize; ``rng`` is unused there."""
    if train:
        raise NotImplementedError(
            "train augmentation (PIL-exact RandomResizedCrop + flip) comes "
            "with the training slice; ROADMAP.md")
    out = center_crop_resize(images, resize_to=int(out_size * 256 / 224),
                             crop=out_size)
    return normalize(out, inception)
