"""Video datasets: K400/SSv2-style clip lists, frame sampling, multi-view
eval (counterpart of dynamic_tuning_tpu/data/video.py; reference
video_datasets/k400.py, sthv2_dataset.py, video_datasets.py).

* a list file of ``path label`` lines per split, decoded on the host;
* train sampling: a random segment at ``sampling_rate`` stride, or TSN
  segment sampling when the rate is 0 (SSv2) (k400.py:305-320);
* eval: ``test_num_segment`` temporal x ``test_num_crop`` spatial views,
  stacked so the runner averages their logits (engine_finetune.py:302-305);
* ``DummyVideoDataset``: seeded random clips (k400.py:323-339).

Decoding picks the port's native libav decoder (``data/native_video.py``)
when it builds, then decord, PyAV and OpenCV, each tried on import
(override with ``DYT_VIDEO_BACKEND=native|decord|av|cv2``); sampled frames
are resized on the host to a fixed canvas (``_bicubic_resize``: torch's
bicubic kernel, A = -0.75, as 4 taps a sample, in C when the native
library loads, ``DYT_NATIVE_RESIZE=0`` for numpy), and every augmentation
runs on the device (``data/video_transforms.py``).  Numpy only.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np

BACKENDS = ("native", "decord", "av", "cv2")


def decode_backend() -> str:
    """The first frame-decode backend that loads: the native decoder
    (``native/dyt_video.cpp``) when it builds, decord (the reference's K400
    decoder, k400.py:115), PyAV (its SSv2 decoder, sthv2_dataset.py:115),
    OpenCV; ``DYT_VIDEO_BACKEND`` forces one (raising, with the build's
    error, when it cannot load)."""
    forced = os.environ.get("DYT_VIDEO_BACKEND")
    for name in [forced] if forced else BACKENDS:
        try:
            if name == "native":
                from dynamic_tuning_tpu_torch.data import native_video
                if not native_video.available():
                    raise ImportError("native video decoder unavailable: "
                                      + native_video.why_unavailable())
            elif name == "decord":
                import decord  # noqa: F401
            elif name == "av":
                import av  # noqa: F401
            elif name == "cv2":
                import cv2  # noqa: F401
            else:
                raise ImportError(f"DYT_VIDEO_BACKEND={name}: one of "
                                  f"{BACKENDS}")
            return name
        except ImportError:
            if forced:
                raise
    raise ImportError("no video decode backend (native/decord/av/cv2) "
                      "available")


def _read_frames_native(path: str, want: List[int]):
    from dynamic_tuning_tpu_torch.data import native_video

    return native_video.read_frames(path, want)


def _read_frames_decord(path: str, want: List[int]):
    """-> {index: RGB uint8 HxWx3}, full-resolution frames."""
    import decord

    vr = decord.VideoReader(path, num_threads=1)
    batch = vr.get_batch(want).asnumpy()         # [n, H, W, 3] RGB
    return {i: batch[j] for j, i in enumerate(want)}


def _read_frames_av(path: str, want: List[int]):
    import av

    frames = {}
    want_set = set(want)
    with av.open(path) as container:
        for i, frame in enumerate(container.decode(video=0)):
            if i in want_set:
                frames[i] = frame.to_rgb().to_ndarray()
            if len(frames) == len(want_set) or i > max(want_set):
                break
    return frames


def _read_frames_cv2(path: str, want: List[int]):
    import cv2

    cap = cv2.VideoCapture(path)
    frames = {}
    pos = -1
    for i in want:
        if i != pos + 1:
            cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        ok, frame = cap.read()
        if ok:
            frames[i] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            pos = i
        else:
            pos = -2   # the decoder's position is unknown: seek next time
    cap.release()
    return frames


_READERS = {"native": _read_frames_native, "decord": _read_frames_decord,
            "av": _read_frames_av, "cv2": _read_frames_cv2}


def sample_indices_random(num_frames: int, clip_len: int, rate: int,
                          rs: np.random.RandomState) -> np.ndarray:
    """A random segment at stride ``rate`` (k400.py:305-320): the window is
    rate * (clip_len - 1) + 1 frames, its start uniform over num_frames -
    rate * (clip_len - 1) positions; a short video takes the stride from 0
    and repeats its last valid frame."""
    if rate * (clip_len - 1) + 1 >= num_frames:
        idx: List[int] = []
        for i in range(clip_len):
            p = i * rate
            idx.append(p if p < num_frames else idx[-1])
        return np.asarray(idx, np.int64)
    start = rs.randint(num_frames - rate * (clip_len - 1))
    return (start + np.arange(clip_len) * rate).astype(np.int64)


def sample_indices_tsn(num_frames: int, clip_len: int,
                       rs: Optional[np.random.RandomState]) -> np.ndarray:
    """TSN segment sampling (SSv2, rate 0): segments of (num_frames - 1) /
    clip_len frames with Python-``round`` edges; train picks
    randint(start, end + 1) (k400.py:308-312), eval (start + end) // 2
    (k400.py:230-234)."""
    seg = (num_frames - 1) / clip_len
    picks = []
    for i in range(clip_len):
        start, end = round(seg * i), round(seg * (i + 1))
        picks.append(rs.randint(start, end + 1) if rs is not None
                     else (start + end) // 2)
    return np.asarray(picks, np.int64)


def sample_indices_test(num_frames: int, clip_len: int, rate: int,
                        segment_idx: int, num_segments: int) -> np.ndarray:
    """The temporal view ``segment_idx`` of ``num_segments`` for eval
    (k400.py:225-248): window rate * (clip_len - 1) + 1, view starts at
    round(slide / (V - 1) * i) (slide // 2 for one view), indices clamped
    to the last frame."""
    if rate <= 0:
        return sample_indices_tsn(num_frames, clip_len, None)
    seg_len = (clip_len - 1) * rate + 1
    slide = max(num_frames - seg_len, 0)
    st = (slide // 2 if num_segments == 1
          else round(slide / (num_segments - 1) * segment_idx))
    idx = [min(p + st, num_frames - 1)
           for p in range(0, clip_len * rate, rate)]
    return np.asarray(idx, np.int64)


class VideoDataset:
    """A dataset of video files from a list file.

    List lines: ``relative/path.mp4 label`` (space or comma separated).
    Train: ``([T, canvas, canvas, 3] uint8, label)``.  Eval (``test_mode``):
    ``([V, T, h, w, 3] uint8, label)`` with V = test_num_segment *
    test_num_crop views; with ``spatial_size`` the views are real spatial
    crops of frames whose short side was resized to it (k400.py:281-300),
    else copies of the canvas.
    """

    def __init__(self, root: str, listfile: str, *, clip_len: int = 8,
                 sampling_rate: int = 16, canvas: int = 320,
                 test_mode: bool = False, test_num_segment: int = 3,
                 test_num_crop: int = 1, num_classes: int = 400,
                 seed: int = 0, spatial_size: Optional[int] = None):
        self.backend = decode_backend()
        self.root = root
        self.items: List[Tuple[str, int]] = []
        with open(listfile) as f:
            for line in f:
                line = line.strip().replace(",", " ")
                if not line:
                    continue
                path, lab = line.rsplit(" ", 1)
                self.items.append((path, int(lab)))
        self.clip_len = clip_len
        self.rate = sampling_rate
        self.canvas = canvas
        self.test_mode = test_mode
        if test_mode and sampling_rate <= 0 and test_num_segment > 1:
            # the reference asserts this (k400.py:227-229): TSN sampling has
            # no sliding window, so more temporal views would be copies
            raise ValueError(
                "TSN (sampling_rate<=0) eval supports test_num_segment=1 "
                f"only, got {test_num_segment}")
        self.test_num_segment = test_num_segment
        self.test_num_crop = test_num_crop
        self.num_classes = num_classes
        self.metric = "accuracy"
        self.spatial_size = spatial_size
        self._seed = seed
        self._epoch = 0

    def __len__(self):
        return len(self.items)

    def _decode(self, path: str, indices: np.ndarray) -> np.ndarray:
        want = sorted(set(int(i) for i in indices))
        raw = _READERS[self.backend](os.path.join(self.root, path), want)
        frames = {}
        for i in want:
            if i in raw:
                frames[i] = _resize_short_side(raw[i], self.canvas)
            else:
                frames[i] = np.zeros((self.canvas, self.canvas, 3), np.uint8)
        return np.stack([frames[int(i)] for i in indices])

    def _decode_aspect(self, path: str, indices: np.ndarray,
                       short_side: int) -> np.ndarray:
        """Frames with the short side resized to ``short_side``, the aspect
        kept (no crop): the input of the spatial multi-crop eval."""
        want = sorted(set(int(i) for i in indices))
        raw = _READERS[self.backend](os.path.join(self.root, path), want)
        frames = {}
        shape = None
        for i in want:
            frame = raw.get(i)
            if frame is not None:
                h, w = frame.shape[:2]
                # the reference's eval sizes (k400.py:195-199): the short
                # side exact, the long side floored
                if h <= w:
                    nh, nw = short_side, max(w * short_side // h, short_side)
                else:
                    nh, nw = max(h * short_side // w, short_side), short_side
                frame = _bicubic_resize(frame, nw, nh)
                shape = frame.shape
            frames[i] = frame
        if shape is None:
            shape = (short_side, short_side, 3)
        out = [frames[int(i)] if frames[int(i)] is not None
               else np.zeros(shape, np.uint8) for i in indices]
        return np.stack(out)

    @staticmethod
    def spatial_crops(frames: np.ndarray, size: int, num_crops: int
                      ) -> List[np.ndarray]:
        """The reference's eval crops (k400.py:281-300): one crop is the
        centre; three are at offsets (0, margin // 2, margin) along the
        long axis."""
        if num_crops not in (1, 3):
            raise ValueError(
                f"test_num_crop must be 1 or 3 (reference protocols), got "
                f"{num_crops}")
        h, w = frames.shape[1:3]
        if num_crops == 1:
            ht, wt = (h - size) // 2, (w - size) // 2
            return [frames[:, ht:ht + size, wt:wt + size]]
        margin = max(h, w) - size
        outs = []
        for st in (0, margin // 2, margin):
            if h > w:
                outs.append(frames[:, st:st + size, :size] if w == size
                            else frames[:, st:st + size, (w - size) // 2:
                                        (w - size) // 2 + size])
            else:
                outs.append(frames[:, :size, st:st + size] if h == size
                            else frames[:, (h - size) // 2:
                                        (h - size) // 2 + size, st:st + size])
        return outs

    def _num_frames(self, path: str) -> int:
        full = os.path.join(self.root, path)
        if self.backend == "native":
            from dynamic_tuning_tpu_torch.data import native_video

            return max(native_video.probe(full)[0], 1)
        if self.backend == "decord":
            import decord

            return max(len(decord.VideoReader(full, num_threads=1)), 1)
        if self.backend == "av":
            import av

            with av.open(full) as c:
                n = c.streams.video[0].frames
                if not n:   # no frame count in the container: count packets
                    n = sum(1 for _ in c.demux(video=0))
            return max(n, 1)
        import cv2

        cap = cv2.VideoCapture(full)
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        return max(n, 1)

    def set_epoch(self, epoch: int):
        """The epoch of the sampling draws (the loader forwards it); each
        sample draws from its own RandomState of (seed, epoch, index), so
        the loader's threads share no random state."""
        self._epoch = epoch

    def __getitem__(self, i):
        path, label = self.items[i]
        n = self._num_frames(path)
        if not self.test_mode:
            rs = np.random.RandomState(np.random.SeedSequence(
                [self._seed, self._epoch, i]).generate_state(1)[0])
            idx = (sample_indices_random(n, self.clip_len, self.rate, rs)
                   if self.rate > 0 else
                   sample_indices_tsn(n, self.clip_len, rs))
            return self._decode(path, idx), label
        # the union of every view's frames, decoded in one pass
        seg_idx = [sample_indices_test(n, self.clip_len, self.rate, seg,
                                       self.test_num_segment)
                   for seg in range(self.test_num_segment)]
        union = sorted({int(x) for ii in seg_idx for x in ii})
        uarr = np.asarray(union, np.int64)
        frames = (self._decode_aspect(path, uarr, self.spatial_size)
                  if self.spatial_size is not None else
                  self._decode(path, uarr))
        lut = {f: j for j, f in enumerate(union)}
        views = []
        for idx in seg_idx:
            clip = frames[[lut[int(x)] for x in idx]]
            if self.spatial_size is not None:
                views.extend(self.spatial_crops(clip, self.spatial_size,
                                                self.test_num_crop))
            else:
                views.extend([clip] * self.test_num_crop)
        return np.stack(views), label


def _bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] float64 matrix of torch's ``upsample_bicubic2d`` along
    one axis: half-pixel source coordinates, the cubic convolution with
    A = -0.75, border taps clamped (replicated)."""
    A = -0.75

    def w(d):
        d = abs(d)
        if d <= 1.0:
            return (A + 2.0) * d ** 3 - (A + 3.0) * d ** 2 + 1.0
        if d < 2.0:
            return A * d ** 3 - 5.0 * A * d ** 2 + 8.0 * A * d - 4.0 * A
        return 0.0

    scale = n_in / n_out
    m = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        t = x - x0
        for k in range(-1, 3):
            m[i, min(max(x0 + k, 0), n_in - 1)] += w(t - k)
    return m


@lru_cache(maxsize=256)
def _tb_matrix(n_in: int, n_out: int) -> np.ndarray:
    """float32 torch-bicubic axis matrix (A = -0.75, align_corners=False):
    the kernel the reference resizes video with (k400.py:203)."""
    return _bicubic_matrix(n_in, n_out).astype(np.float32)


@lru_cache(maxsize=256)
def _tb_taps(n_in: int, n_out: int):
    """(indices [n_out, 4] int32, weights [n_out, 4] float32): each row of
    ``_tb_matrix`` as its at most 4 nonzero taps (clamping at the borders
    only merges taps), so a resize is a 4-tap gather per sample."""
    m = _tb_matrix(n_in, n_out)
    idx = np.zeros((n_out, 4), np.int32)
    wts = np.zeros((n_out, 4), np.float32)
    for i in range(n_out):
        nz = np.nonzero(m[i])[0]
        if len(nz) > 4:
            raise AssertionError((n_in, n_out, i, len(nz)))
        idx[i, :len(nz)] = nz
        wts[i, :len(nz)] = m[i, nz]
    idx.setflags(write=False)
    wts.setflags(write=False)
    return idx, wts


def _bicubic_resize(img: np.ndarray, nw: int, nh: int) -> np.ndarray:
    """uint8 HWC resize with the reference's kernel (torch bicubic,
    A = -0.75, half-pixel coordinates): rows, then columns, in float32,
    rounded half up and clipped to uint8.  The reference resizes after
    normalizing, without a clamp; the weights sum to 1, so the two differ
    only by this rounding (<= 1 level but at overshooting edges).

    Where the native library loads (and ``DYT_NATIVE_RESIZE`` is not
    ``0``) a uint8 RGB frame is resized in C (``native_video.
    resize_bicubic``: the same taps and float32 pair order, the GIL
    released, so loader threads resize concurrently).  A C call that fails
    raises; only an unavailable library means the numpy form."""
    ih, wh = _tb_taps(img.shape[0], nh)
    iw, ww = _tb_taps(img.shape[1], nw)
    if (img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
            and os.environ.get("DYT_NATIVE_RESIZE", "1") != "0"):
        from dynamic_tuning_tpu_torch.data import native_video

        out = native_video.resize_bicubic(img, nh, nw, ih, wh, iw, ww)
        if out is not None:
            return out
    out = img.astype(np.float32)
    out = (out[ih] * wh[:, :, None, None]).sum(axis=1)         # [nh, w, c]
    out = (out[:, iw] * ww[None, :, :, None]).sum(axis=2)      # [nh, nw, c]
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def _resize_short_side(img: np.ndarray, target: int) -> np.ndarray:
    """The short side to ``target``, then the centre square (the
    reference's eval sizes: the long side floored, k400.py:195-199)."""
    h, w = img.shape[:2]
    if h <= w:
        nh, nw = target, w * target // h
    else:
        nh, nw = h * target // w, target
    img = _bicubic_resize(img, nw, nh)
    top = (nh - target) // 2
    left = (nw - target) // 2
    return img[top:top + target, left:left + target]


class DummyVideoDataset:
    """Seeded random clips (reference DummyDataset, k400.py:323-339): 8
    distinct clips in turn, label ``i % num_classes``."""

    def __init__(self, n: int = 256, clip_len: int = 8, canvas: int = 256,
                 num_classes: int = 400, test_mode: bool = False,
                 num_views: int = 3, seed: int = 0):
        self.n, self.clip_len, self.canvas = n, clip_len, canvas
        self.num_classes = num_classes
        self.test_mode = test_mode
        self.num_views = num_views
        self.metric = "accuracy"
        rs = np.random.RandomState(seed)
        self._clip = rs.randint(0, 256, (8, clip_len, canvas, canvas, 3),
                                np.uint8)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        clip = self._clip[i % 8]
        label = i % self.num_classes
        if self.test_mode:
            return np.stack([clip] * self.num_views), label
        return clip, label


def build_video_dataset(dataset: str, data_path: str, *, clip_len: int = 8,
                        sampling_rate: int = 16, test_num_segment: int = 3,
                        test_num_crop: int = 1, spatial_size: int = 224):
    """-> (train_ds, val_ds, num_classes) (reference build_dataset,
    video_datasets.py:10-87: K400 at rate 16, eval 3 temporal x 1 spatial
    views; SSv2 TSN (rate 0), eval 1 x 3).  Names are case-insensitive
    (the recipes spell them K400 / SSV2); ``synthetic*`` gives 256 train
    and 64 eval clips of 256^2 canvases, 400 classes."""
    dataset = dataset.lower()
    if dataset.startswith("synthetic"):
        nc = 400
        return (DummyVideoDataset(256, clip_len, 256, nc),
                DummyVideoDataset(64, clip_len, 256, nc, test_mode=True,
                                  num_views=test_num_segment * test_num_crop),
                nc)
    if dataset == "k400":
        nc, rate = 400, sampling_rate
    elif dataset in ("ssv2", "sthv2"):
        nc, rate = 174, 0
        test_num_segment, test_num_crop = 1, 3
    else:
        raise KeyError(f"unknown video dataset {dataset}")
    train = VideoDataset(data_path, os.path.join(data_path, "train.csv"),
                         clip_len=clip_len, sampling_rate=rate,
                         num_classes=nc)
    val = VideoDataset(data_path, os.path.join(data_path, "val.csv"),
                       clip_len=clip_len, sampling_rate=rate, canvas=256,
                       test_mode=True, test_num_segment=test_num_segment,
                       test_num_crop=test_num_crop, num_classes=nc,
                       spatial_size=spatial_size)
    return train, val, nc
