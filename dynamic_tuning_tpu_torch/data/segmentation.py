"""ADE20K-style semantic-segmentation data (counterpart of
dynamic_tuning_tpu/data/segmentation.py).

Replaces the reference's mmseg dataset/pipeline stack
(configs/beit/upernet/our_vit.py): LoadAnnotations with
``reduce_zero_label``, Resize img_scale=(2048, 512) ratio_range=(0.5, 2.0),
RandomCrop 512 with cat_max_ratio 0.75, RandomFlip 0.5,
PhotoMetricDistortion, and Normalize(mean=std=127.5) (``seg_normalize``, in
torch on the device).  Geometry runs on the host in numpy/PIL; the model
gets uint8 images and uint8 labels with 255 as ignore.  The port keeps its
own copy of the JAX package's readers (it imports nothing of that package).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch


def _imread(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


def _annread(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path), np.uint8)


def _rgb_to_hsv_u8(img: np.ndarray):
    """cv2-equivalent uint8 RGB->HSV (H in [0,180), S/V in [0,255]) —
    mmcv's bgr2hsv is cv2 on uint8; pure numpy so no cv2 install needed."""
    f = img.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    v = f.max(axis=-1)
    diff = v - f.min(axis=-1)
    s = np.where(v > 0, diff * 255.0 / np.maximum(v, 1e-12), 0.0)
    d = np.maximum(diff, 1e-12)
    h = np.select(
        [(v == r) & (diff > 0), (v == g) & (diff > 0), diff > 0],
        [60.0 * (g - b) / d, 120.0 + 60.0 * (b - r) / d,
         240.0 + 60.0 * (r - g) / d], 0.0)
    h = np.where(h < 0, h + 360.0, h) / 2.0
    return (np.round(h).astype(np.int32) % 180).astype(np.uint8), \
        np.round(s).astype(np.uint8), v.astype(np.uint8)


def _hsv_to_rgb_u8(h: np.ndarray, s: np.ndarray, v: np.ndarray) -> np.ndarray:
    """cv2-equivalent uint8 HSV->RGB inverse of ``_rgb_to_hsv_u8``."""
    hf = h.astype(np.float32) * 2.0
    sf = s.astype(np.float32) / 255.0
    vf = v.astype(np.float32)
    c = vf * sf
    x = c * (1.0 - np.abs((hf / 60.0) % 2.0 - 1.0))
    m = vf - c
    z = np.zeros_like(c)
    sector = (hf // 60.0).astype(np.int32) % 6
    r = np.choose(sector, [c, x, z, z, x, c])
    g = np.choose(sector, [x, c, c, x, z, z])
    b = np.choose(sector, [z, z, x, c, c, x])
    out = np.stack([r + m, g + m, b + m], axis=-1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def _resize(img: np.ndarray, scale: float, nearest: bool = False) -> np.ndarray:
    """cv2-exact resize — mmseg resizes with mmcv.imresize = cv2.resize
    (INTER_LINEAR for images: half-pixel-centered POINT-SAMPLED 2x2, no
    antialiasing even on downscale; INTER_NEAREST for masks: truncated
    source index with NO half-pixel offset, a known cv2 quirk).  Pure
    numpy so the pipeline needs no cv2 install; pinned against cv2 in
    tests/test_ade20k.py."""
    h, w = img.shape[:2]
    nh = max(int(h * scale + 0.5), 1)
    nw = max(int(w * scale + 0.5), 1)
    if nearest:
        # cv2's exact arithmetic: ifx = 1.0 / (dst/src) — the double
        # reciprocal-of-reciprocal lands just BELOW exact integers, so
        # boundary pixels floor one index lower than a naive src/dst ratio
        ys = np.arange(nh) * (1.0 / (nh / h))
        xs = np.arange(nw) * (1.0 / (nw / w))
        ys = np.minimum(np.floor(ys).astype(np.int64), h - 1)
        xs = np.minimum(np.floor(xs).astype(np.int64), w - 1)
        return img[ys[:, None], xs[None, :]]
    ys = (np.arange(nh) + 0.5) * (h / nh) - 0.5
    xs = (np.arange(nw) + 0.5) * (w / nw) - 0.5
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    if img.ndim == 3:
        fy, fx = fy[..., None], fx[..., None]
    p = img.astype(np.float32)
    v = ((1 - fy) * ((1 - fx) * p[y0[:, None], x0[None, :]]
                     + fx * p[y0[:, None], x1[None, :]])
         + fy * ((1 - fx) * p[y1[:, None], x0[None, :]]
                 + fx * p[y1[:, None], x1[None, :]]))
    return (v + 0.5).astype(img.dtype)


class ADE20KDataset:
    """images/{split} jpg + annotations/{split} png, label 0 = background
    dropped via reduce_zero_label (label-1; 0 and 255 -> 255 ignore)."""

    NUM_CLASSES = 150

    def __init__(self, root: str, split: str = "training", *, crop: int = 512,
                 train: bool = True, base_scale: Tuple[int, int] = (2048, 512),
                 ratio_range: Tuple[float, float] = (0.5, 2.0),
                 cat_max_ratio: float = 0.75, seed: int = 0):
        img_dir = os.path.join(root, "images", split)
        ann_dir = os.path.join(root, "annotations", split)
        self.items: List[Tuple[str, str]] = []
        for fn in sorted(os.listdir(img_dir)):
            if fn.endswith((".jpg", ".png")):
                ann = os.path.splitext(fn)[0] + ".png"
                self.items.append((os.path.join(img_dir, fn),
                                   os.path.join(ann_dir, ann)))
        self.crop = crop
        self.train = train
        self.base_scale = base_scale
        self.ratio_range = ratio_range
        self.cat_max_ratio = cat_max_ratio
        self.num_classes = self.NUM_CLASSES
        self.metric = "miou"
        self._seed = seed
        self._epoch = 0

    def __len__(self):
        return len(self.items)

    def _reduce_zero(self, ann: np.ndarray) -> np.ndarray:
        out = ann.astype(np.int16) - 1
        out[ann == 0] = 255
        out[ann == 255] = 255
        return out.astype(np.uint8)

    def set_epoch(self, epoch: int):
        """Per-epoch augmentation seed (forwarded by DataLoader.set_epoch);
        per-call RandomStates keep draws thread-safe under the loader's
        worker pool AND reproducible."""
        self._epoch = epoch

    def _call_rs(self, i: int) -> np.random.RandomState:
        # SeedSequence mixes (seed, epoch, index) collision-resistantly — a
        # linear hash with a small epoch stride reuses streams across epochs
        # for datasets larger than the stride
        return np.random.RandomState(np.random.SeedSequence(
            [self._seed, self._epoch, i]).generate_state(1)[0])

    def _rand_crop(self, rs, img, ann):
        """RandomCrop with cat_max_ratio: retry up to 10 crops so one class
        doesn't fill >75% of the crop (mmseg RandomCrop semantics)."""
        c = self.crop
        h, w = img.shape[:2]
        best = None
        for _ in range(10):
            top = rs.randint(0, max(h - c, 0) + 1)
            left = rs.randint(0, max(w - c, 0) + 1)
            a = ann[top:top + c, left:left + c]
            labels, counts = np.unique(a[a != 255], return_counts=True)
            best = (top, left)
            if len(counts) == 0:
                continue
            if counts.max() / counts.sum() < self.cat_max_ratio:
                break
        top, left = best
        return (img[top:top + c, left:left + c],
                ann[top:top + c, left:left + c])

    def _photometric(self, rs, img: np.ndarray) -> np.ndarray:
        """mmseg PhotoMetricDistortion semantics (reference pipeline
        transforms.py:835-932): brightness(+-32) -> contrast(0.5-1.5)
        randomly BEFORE or AFTER the color ops (contrast_mode) ->
        saturation (HSV S * 0.5-1.5) -> hue (H +- 18 mod 180), each op
        applied with prob 0.5 and per-op uint8 clipping."""

        def convert(x, alpha=1.0, beta=0.0):
            return np.clip(x.astype(np.float32) * alpha + beta,
                           0, 255).astype(np.uint8)

        def contrast(x):
            if rs.randint(2):
                return convert(x, alpha=rs.uniform(0.5, 1.5))
            return x

        if rs.randint(2):
            img = convert(img, beta=rs.uniform(-32, 32))
        mode = rs.randint(2)
        if mode == 1:
            img = contrast(img)
        if rs.randint(2):  # saturation, in HSV like mmcv
            h, s, v = _rgb_to_hsv_u8(img)
            s = convert(s, alpha=rs.uniform(0.5, 1.5))
            img = _hsv_to_rgb_u8(h, s, v)
        if rs.randint(2):  # hue
            h, s, v = _rgb_to_hsv_u8(img)
            h = ((h.astype(np.int32) + rs.randint(-18, 18)) % 180
                 ).astype(np.uint8)
            img = _hsv_to_rgb_u8(h, s, v)
        if mode == 0:
            img = contrast(img)
        return img

    def __getitem__(self, i):
        img_path, ann_path = self.items[i]
        img = _imread(img_path)
        ann = self._reduce_zero(_annread(ann_path))
        c = self.crop

        if self.train:
            rs = self._call_rs(i)
            # Resize: fit (2048, 512) keep-ratio then random ratio 0.5-2.0
            h, w = img.shape[:2]
            base = min(max(self.base_scale) / max(h, w),
                       min(self.base_scale) / min(h, w))
            scale = base * rs.uniform(*self.ratio_range)
            img = _resize(img, scale)
            ann = _resize(ann, scale, nearest=True)
            # pad to at least crop, then random crop + flip + photometric
            ph = max(c - img.shape[0], 0)
            pw = max(c - img.shape[1], 0)
            if ph or pw:
                img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
                ann = np.pad(ann, ((0, ph), (0, pw)), constant_values=255)
            img, ann = self._rand_crop(rs, img, ann)
            if rs.rand() < 0.5:
                img, ann = img[:, ::-1], ann[:, ::-1]
            img = self._photometric(rs, img)
            return np.ascontiguousarray(img), np.ascontiguousarray(ann)
        # eval: keep-ratio resize so short side ~512, return whole image
        h, w = img.shape[:2]
        scale = min(max(self.base_scale) / max(h, w),
                    min(self.base_scale) / min(h, w))
        img = _resize(img, scale)
        # the annotation stays at ORIGINAL resolution: mmseg scores mIoU
        # against the original GT (predictions are resized back to
        # ori_shape, encoder_decoder.py whole/slide inference) — a
        # downscaled GT deletes thin structures before scoring
        return img, ann


class SyntheticSegDataset:
    """Fixed random crops for pipeline tests (DummyDataset analogue)."""

    def __init__(self, n: int = 64, crop: int = 64, num_classes: int = 150,
                 train: bool = True, seed: int = 0):
        self.n, self.crop = n, crop
        self.num_classes = num_classes
        self.train = train
        self.metric = "miou"
        rs = np.random.RandomState(seed)
        self._img = rs.randint(0, 256, (8, crop, crop, 3), np.uint8)
        self._ann = rs.randint(0, num_classes, (8, crop, crop)).astype(np.uint8)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self._img[i % 8], self._ann[i % 8]


def build_seg_dataset(dataset: str, data_path: str, crop: int = 512,
                      num_classes: int = 150):
    if dataset.startswith("synthetic"):
        return (SyntheticSegDataset(64, crop, num_classes, train=True),
                SyntheticSegDataset(16, crop, num_classes, train=False, seed=1),
                num_classes)
    if dataset == "ade20k":
        return (ADE20KDataset(data_path, "training", crop=crop, train=True),
                ADE20KDataset(data_path, "validation", crop=crop, train=False),
                ADE20KDataset.NUM_CLASSES)
    raise KeyError(f"unknown segmentation dataset {dataset}")


def seg_normalize(img) -> torch.Tensor:
    """mean/std 127.5 (reference our_vit.py img_norm_cfg): uint8 (tensor
    or array) -> fp32 in [-1, 1]."""
    t = img if isinstance(img, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(img))
    return (t.float() - 127.5) / 127.5
