"""Batched prefetching data loader (counterpart of
dynamic_tuning_tpu/data/loader.py).

Replaces torch DataLoader + DistributedSampler (reference main_image.py:169-183):
  * train: per-epoch shuffled (``RandomState(seed + epoch)``), per-process
    strided shard, drop-last;
  * eval: rank-strided Subset semantics (main_image.py:178);
  * a background thread pool decodes samples and a prefetch queue keeps the
    device fed; ``make_loader`` takes the native C++ decode pipeline
    (``data/native_loader.py``) for file-backed datasets when it builds,
    as the JAX package does.

Each process's shard is strided (rank r holds samples r, r + R, ...), and
the shards are padded to equal length so every process runs as many
batches: by repeating leading samples (training, DistributedSampler's
rule), or with ``sentinel_pad`` by the last sample under label -1, which
evaluation drops (``parallel.mesh.pad_eval_batch``), so that R processes
evaluate exactly the samples one process does.

Batches are plain numpy (uint8 canvases + int32 labels); the runner copies
each batch to the device once and augments it there.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np

from dynamic_tuning_tpu_torch.parallel.mesh import (eval_pad_count,
                                                    pad_eval_batch)


class DataLoader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_workers: int = 4,
                 prefetch: int = 4, process_index: int = 0,
                 process_count: int = 1, sentinel_pad: bool = False):
        self.ds = dataset
        self.sentinel_pad = sentinel_pad
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Reshuffle seed per epoch (DistributedSampler.set_epoch semantics,
        reference main_image.py:328).  Forwarded to the dataset when it
        draws per-sample randomness (video frame sampling, seg crops) so
        those draws stay epoch-varying AND thread-safe."""
        self.epoch = epoch
        if hasattr(self.ds, "set_epoch"):
            self.ds.set_epoch(epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.ds)
        if self.shuffle:
            rs = np.random.RandomState(self.seed + self.epoch)
            idx = rs.permutation(n)
        else:
            idx = np.arange(n)
        # Pad to a multiple of process_count (torch DistributedSampler
        # semantics: repeat leading indices) so every process iterates the
        # same number of samples and batches (a one-batch mismatch across
        # processes deadlocks their collectives).
        pad = eval_pad_count(n, self.process_count)
        if pad:
            idx = np.concatenate([idx, np.full(pad, -1, idx.dtype)
                                  if self.sentinel_pad else idx[:pad]])
        # strided per-process shard (reference main_image.py:178)
        return idx[self.process_index::self.process_count]

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, start: int) -> Iterator[Tuple[np.ndarray,
                                                      np.ndarray]]:
        """The epoch's batches from batch ``start`` on (a run resumed
        within an epoch); the ones before are not loaded."""
        idx = self._indices()
        nb = len(self)
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(start, nb)]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        stop = threading.Event()

        def make_batch(bidx):
            real = bidx[bidx >= 0]       # sentinel pads close a shard
            samples = list(pool.map(self.ds.__getitem__, real))
            imgs = (np.stack([s[0] for s in samples]) if samples
                    else np.zeros((0,), np.uint8))
            labels = np.asarray([s[1] for s in samples], np.int32)
            if len(real) < len(bidx):
                imgs, labels = pad_eval_batch(
                    imgs, labels, len(bidx) - len(real),
                    fill=self.ds[len(self.ds) - 1][0])
                labels = labels.astype(np.int32)
            return imgs, labels

        def put(item) -> bool:
            """Bounded-queue put that aborts when the consumer is gone —
            a plain q.put would block forever if the caller breaks out of
            the epoch early (leaking the thread + prefetched batches)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    if not put(make_batch(b)):
                        return
            except BaseException as e:   # surface decode errors, don't
                put(e)                   # truncate the epoch silently
                return
            put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False)


def make_loader(dataset, batch_size: int, *, shuffle: bool = False,
                drop_last: bool = False, seed: int = 0, num_workers: int = 4,
                process_index: int = 0, process_count: int = 1,
                sentinel_pad: bool = False):
    """The loader of ``dataset``, in the JAX package's order: the native
    C++ decode pipeline for file-backed datasets (ImageFolder,
    ImageFilelist) when its library builds, else the Python threaded
    ``DataLoader`` (in-memory arrays, synthetic data, video, and any
    dataset when the library is missing).  Both decoders give the same
    batch order; the native resampler reproduces PIL's to +-1.
    ``decoder_of`` names the one a loader runs."""
    samples = None
    canvas = getattr(dataset, "canvas", None)
    if hasattr(dataset, "clip_len"):           # video: the C++ JPEG loader
        samples = None                         # cannot decode mp4 frames
    elif hasattr(dataset, "samples"):          # ImageFolder: (abs_path, label)
        samples = list(dataset.samples)
    elif hasattr(dataset, "items") and hasattr(dataset, "root"):
        samples = [(os.path.join(dataset.root, rel), lab)
                   for rel, lab in dataset.items]
    if samples is not None and canvas is not None:
        from dynamic_tuning_tpu_torch.data import native_loader
        if native_loader.available():
            return native_loader.NativeDataLoader(
                samples, batch_size, canvas=canvas, shuffle=shuffle,
                drop_last=drop_last, seed=seed, num_workers=num_workers,
                process_index=process_index, process_count=process_count,
                square=getattr(dataset, "square", False),
                sentinel_pad=sentinel_pad)
    return DataLoader(dataset, batch_size, shuffle=shuffle,
                      drop_last=drop_last, seed=seed, num_workers=num_workers,
                      process_index=process_index, process_count=process_count,
                      sentinel_pad=sentinel_pad)


def decoder_of(loader) -> str:
    """Which decoder ``loader`` runs, for the runners' logs."""
    from dynamic_tuning_tpu_torch.data import native_loader
    if isinstance(loader, native_loader.NativeDataLoader):
        return f"native C++ (libjpeg/libpng, {native_loader.library_path()})"
    ds = getattr(loader, "ds", None)
    if hasattr(ds, "clip_len"):
        return f"the video frames of {type(ds).__name__} (no JPEG decode)"
    if hasattr(ds, "samples") or (hasattr(ds, "items")
                                  and hasattr(ds, "root")):
        why = native_loader.why_unavailable().splitlines()
        return ("PIL (the native loader is unavailable: "
                f"{why[0] if why else 'unknown'})")
    return f"none: {type(ds).__name__} holds decoded arrays"
