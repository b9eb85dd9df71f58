"""RandAugment on the device of the frames (counterpart of
dynamic_tuning_tpu/data/randaugment.py; reference
video_datasets/rand_augment.py), the SSv2 recipe's
"rand-m7-n4-mstd0.5-inc1".

Every op is a tensor function of float frames ``[T, H, W, 3]`` in
[0, 255], applied to all frames of a clip with the clip's draws (the
reference's per-clip transform instance, transform.py:628-662); statistics
(auto-contrast, equalize, contrast) are per frame.  The geometric ops are
one inverse affine warp each with the video recipe's bicubic
(interpolation='bicubic', k400.py:133: Pillow's ``transform(...,
BICUBIC)``, a non-normalized a = -1 cubic over 4 x 4 taps,
``_pil_transform_cubic``, clamped to [0, 255] as Pillow stores it);
samples outside the frame take the fill 128.  (The JAX package's
bilinear warp, ``rand_augment_batch`` and ``random_erasing`` have no
caller there and are not ported.)

Draws (``sample_rand_augment``, on the host from a ``torch.Generator``):
per clip and op position, the op (uniform over the 15), the level noise
(normal), the sign coin and the apply coin; an op applies with
probability 0.5 (the reference builds every op with prob 0.5 and skips it
when random() > prob, rand_augment.py:371,463), at level magnitude + mstd
* noise clipped to [0, 10], mapped per op as timm's (the
increasing-severity mappings with "inc", else the originals;
``op_value``).
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

_MAX_LEVEL = 10.0
FILL = 128.0
F32 = torch.float32

OPS = ("AutoContrast", "Equalize", "Invert", "Rotate", "Posterize",
       "Solarize", "SolarizeAdd", "Color", "Contrast", "Brightness",
       "Sharpness", "ShearX", "ShearY", "TranslateX", "TranslateY")


# --- geometric ops (one affine warp) -----------------------------------------

def _pil_transform_cubic(t: torch.Tensor) -> torch.Tensor:
    """Pillow Geometry.c's bicubic weights (a = -1) of the 4 taps at
    offsets -1, 0, 1, 2 of fractional coordinate t in [0, 1)."""
    a = -1.0
    d = torch.stack([t + 1.0, t, 1.0 - t, 2.0 - t])
    d2 = d * d
    d3 = d2 * d
    near = (a + 2.0) * d3 - (a + 3.0) * d2 + 1.0            # |x| < 1
    far = a * (d3 - 5.0 * d2 + 8.0 * d - 4.0)               # 1 <= |x| < 2
    return torch.stack([far[0], near[1], near[2], far[3]])


def _affine(img: torch.Tensor, mat: Sequence[torch.Tensor],
            centered: bool = True) -> torch.Tensor:
    """The inverse affine ``mat`` (2 x 3 float32 scalars) applied to frames
    [T, H, W, C] with PIL's bicubic: about the centre (PIL ``rotate``) or,
    not ``centered``, about the pixel-centre origin (PIL
    ``transform(AFFINE)``); fill 128 outside."""
    T, h, w = img.shape[:3]
    dev = img.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=F32, device=dev),
                            torch.arange(w, dtype=F32, device=dev),
                            indexing="ij")
    cx, cy = ((w - 1) / 2.0, (h - 1) / 2.0) if centered else (-0.5, -0.5)
    xs, ys = xx - cx, yy - cy
    m = [v.to(dev) for v in mat]
    src_x = m[0] * xs + m[1] * ys + m[2] + cx
    src_y = m[3] * xs + m[4] * ys + m[5] + cy
    inside = ((src_x >= 0) & (src_x <= w - 1) & (src_y >= 0)
              & (src_y <= h - 1))
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    xi, yi = x0.to(torch.int64), y0.to(torch.int64)
    wx = _pil_transform_cubic(src_x - x0)                   # [4, H, W]
    wy = _pil_transform_cubic(src_y - y0)
    out = torch.zeros_like(img, dtype=F32)
    for dy in range(-1, 3):
        row = torch.clamp(yi + dy, 0, h - 1)
        for dx in range(-1, 3):
            col = torch.clamp(xi + dx, 0, w - 1)
            wgt = (wy[dy + 1] * wx[dx + 1])[None, ..., None]
            out = out + wgt * img[:, row, col].to(F32)
    out = torch.clamp(out, 0.0, 255.0)       # PIL's store of the lobes
    return torch.where(inside[None, ..., None], out,
                       torch.full((), FILL, device=dev))


def _mat(a=1.0, b=0.0, c=0.0, d=0.0, e=1.0, f=0.0) -> List[torch.Tensor]:
    return [v if isinstance(v, torch.Tensor) else torch.tensor(v, dtype=F32)
            for v in (a, b, c, d, e, f)]


def shear_x(img, v):
    # PIL coefficients (1, v, 0, 0, 1, 0) about the origin: the reference's
    # shears are not centre shears (rand_augment.py:70-74)
    return _affine(img, _mat(b=v), centered=False)


def shear_y(img, v):
    return _affine(img, _mat(d=v), centered=False)


def translate_x(img, v):
    return _affine(img, _mat(c=v))


def translate_y(img, v):
    return _affine(img, _mat(f=v))


def rotate(img, deg):
    rad = deg * math.pi / 180.0
    c, s = torch.cos(rad), torch.sin(rad)
    return _affine(img, _mat(a=c, b=-s, d=s, e=c))


# --- photometric ops -------------------------------------------------------

def _blend(a, b, factor):
    return torch.clamp(b + (a - b) * factor, 0.0, 255.0)


def _gray(img):
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def auto_contrast(img, _v):
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    scale = 255.0 / torch.clamp(hi - lo, min=1e-5)
    return torch.where(hi > lo, (img - lo) * scale, img)


def equalize(img, _v):
    """Per frame and channel, PIL's histogram equalization."""
    T, H, W, C = img.shape
    flat = img.permute(0, 3, 1, 2).reshape(T * C, H * W).to(torch.int64)
    ok = (flat >= 0) & (flat < 256)
    hist = torch.zeros((T * C, 256), dtype=torch.int64, device=img.device)
    hist.scatter_add_(1, flat.clamp(0, 255), ok.to(torch.int64))
    nonzero = hist > 0
    last_nz = 255 - nonzero.flip(1).to(torch.uint8).argmax(dim=1)
    step = (hist.sum(1) - hist.gather(1, last_nz[:, None])[:, 0]) // 255
    cum = hist.cumsum(1)
    lut = torch.clamp(((cum - hist) + (step // 2)[:, None])
                      // torch.clamp(step, min=1)[:, None], 0, 255)
    eq = lut.gather(1, flat.clamp(0, 255)).to(img.dtype)
    out = torch.where((step == 0)[:, None], img.permute(0, 3, 1, 2).reshape(
        T * C, H * W), eq)
    return out.reshape(T, C, H, W).permute(0, 2, 3, 1)


def invert(img, _v):
    return 255.0 - img


def posterize(img, bits):
    bits = int(torch.clamp(bits.to(torch.int32), 0, 8))
    if bits >= 8:
        return img
    shift = 8 - bits
    return ((img.to(torch.int32) >> shift) << shift).to(F32)


def solarize(img, thresh):
    return torch.where(img >= thresh.to(img.device), 255.0 - img, img)


def solarize_add(img, add):
    return torch.where(img < 128.0,
                       torch.clamp(img + add.to(img.device), 0, 255), img)


def color(img, factor):
    return _blend(img, _gray(img)[..., None], factor.to(img.device))


def contrast(img, factor):
    mean = _gray(img).mean(dim=(1, 2))[:, None, None, None]
    return _blend(img, mean, factor.to(img.device))


def brightness(img, factor):
    return _blend(img, 0.0, factor.to(img.device))


def sharpness(img, factor):
    k = torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]], dtype=F32,
                     device=img.device) / 13.0
    T, H, W, C = img.shape
    x = img.permute(0, 3, 1, 2).reshape(T * C, 1, H, W)
    smoothed = F.conv2d(x, k[None, None], padding=1).reshape(
        T, C, H, W).permute(0, 2, 3, 1).clone()
    # PIL keeps the border unsmoothed
    smoothed[:, 0], smoothed[:, -1] = img[:, 0], img[:, -1]
    smoothed[:, :, 0], smoothed[:, :, -1] = img[:, :, 0], img[:, :, -1]
    return _blend(img, smoothed, factor.to(img.device))


_FNS = {"AutoContrast": auto_contrast, "Equalize": equalize,
        "Invert": invert, "Rotate": rotate, "Posterize": posterize,
        "Solarize": solarize, "SolarizeAdd": solarize_add, "Color": color,
        "Contrast": contrast, "Brightness": brightness,
        "Sharpness": sharpness, "ShearX": shear_x, "ShearY": shear_y,
        "TranslateX": translate_x, "TranslateY": translate_y}


def apply_op(name: str, frames: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """The op ``name`` at value ``v`` (``op_value``'s) on float frames
    [T, H, W, 3]."""
    return _FNS[name](frames, v)


# --- magnitudes, configs, the augmentation -----------------------------------

def op_value(name: str, level: torch.Tensor, sign: bool, img_size: int,
             increasing: bool = True) -> torch.Tensor:
    """timm's value of op ``name`` at ``level`` (float32), ``sign`` the
    coin of the signed ops: the increasing-severity mappings, or the
    original ones where Posterize and Solarize weaken with the level and
    the enhance ops sweep 0.1-1.9 unsigned (rand_augment.py:213-262); the
    reference's int() truncations as floors."""
    frac = level.to(F32) / _MAX_LEVEL

    def signed(v):
        return v if sign else -v

    if name in ("AutoContrast", "Equalize", "Invert"):
        return torch.tensor(0.0)
    if name == "Rotate":
        return signed(frac * 30.0)
    if name == "Posterize":
        bits = torch.floor(frac * 4.0)
        return 4.0 - bits if increasing else bits
    if name == "Solarize":
        thresh = torch.floor(frac * 256.0)
        return 256.0 - thresh if increasing else thresh
    if name == "SolarizeAdd":
        return torch.floor(frac * 110.0)
    if name in ("Color", "Contrast", "Brightness", "Sharpness"):
        if increasing:
            return 1.0 + signed(frac * 0.9)
        return frac * 1.8 + 0.1
    if name in ("ShearX", "ShearY"):
        return signed(frac * 0.3)
    if name in ("TranslateX", "TranslateY"):
        return signed(frac * 0.45 * img_size)
    raise KeyError(name)


def parse_config(config: str) -> Tuple[float, int, float, bool]:
    """'rand-m7-n4-mstd0.5-inc1' -> (magnitude, num_ops, mstd,
    increasing), as the reference's parser executes it
    (rand_augment.py:505-533): any 'inc' token, 'inc0' too, selects the
    increasing mappings; op weights ('w') are refused."""
    m, n, mstd, inc = 10.0, 2, 0.0, False
    for tok in config.split("-")[1:]:
        if tok.startswith("mstd"):
            mstd = float(tok[4:])
        elif tok.startswith("inc"):
            inc = True
        elif tok.startswith("w"):
            raise NotImplementedError(
                f"rand-augment op-choice weights ('{tok}') not supported")
        elif tok.startswith("m"):
            m = float(re.sub("[^0-9.]", "", tok))
        elif tok.startswith("n"):
            n = int(re.sub("[^0-9]", "", tok))
    return m, n, mstd, inc


def sample_rand_augment(generator: torch.Generator, n: int, num_ops: int
                        ) -> List[Dict[str, list]]:
    """Per clip, per op position: the op index, the level noise, the sign
    and apply coins, drawn on the host."""
    op = torch.randint(0, len(OPS), (n, num_ops), generator=generator)
    normal = torch.randn((n, num_ops), generator=generator, dtype=F32)
    sign = torch.rand((n, num_ops), generator=generator) < 0.5
    u_prob = torch.rand((n, num_ops), generator=generator, dtype=F32)
    return [{"op": op[i].tolist(), "normal": normal[i].tolist(),
             "sign": sign[i].tolist(), "u_prob": u_prob[i].tolist()}
            for i in range(n)]


def rand_augment(frames: torch.Tensor, draws: Dict[str, list], *,
                 magnitude: float = 9.0, mstd: float = 0.5,
                 prob: float = 0.5, increasing: bool = True
                 ) -> torch.Tensor:
    """One clip's RandAugment: float frames [T, H, W, 3] in [0, 255] ->
    float32 in [0, 255], each op of ``draws`` applied with probability
    ``prob``."""
    img = frames.to(F32)
    for op, noise, sign, u in zip(draws["op"], draws["normal"],
                                  draws["sign"], draws["u_prob"]):
        if u <= prob:
            level = torch.clamp(
                magnitude + mstd * torch.tensor(noise, dtype=F32), 0.0,
                _MAX_LEVEL)
            v = op_value(OPS[op], level, sign, img.shape[2], increasing)
            img = apply_op(OPS[op], img, v)
    return torch.clamp(img, 0.0, 255.0)


def rand_augment_clips(generator: torch.Generator, clips: torch.Tensor,
                       config: str) -> torch.Tensor:
    """uint8 clips [B, T, H, W, 3] -> uint8, each clip's frames through
    one draw of ``config``, the draws from ``generator``."""
    m, n, mstd, inc = parse_config(config)
    draws = sample_rand_augment(generator, clips.shape[0], n)
    out = [rand_augment(c, d, magnitude=m, mstd=mstd, increasing=inc)
           for c, d in zip(clips, draws)]
    return torch.stack(out).to(torch.uint8)
