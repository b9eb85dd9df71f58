"""Batched prefetching data loader (counterpart of
dynamic_tuning_tpu/data/loader.py).

Replaces torch DataLoader + DistributedSampler (reference main_image.py:169-183):
  * train: per-epoch shuffled (``RandomState(seed + epoch)``), per-process
    strided shard, drop-last;
  * eval: rank-strided Subset semantics (main_image.py:178);
  * a background thread pool decodes samples and a prefetch queue keeps the
    device fed.

Batches are plain numpy (uint8 canvases + int32 labels); the runner copies
each batch to the device once and augments it there.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_workers: int = 4,
                 prefetch: int = 4, process_index: int = 0,
                 process_count: int = 1):
        self.ds = dataset
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
        if self.process_count > 1:
            total = -(-n // self.process_count) * self.process_count
            if total > n:
                idx = np.concatenate([idx, idx[:total - n]])
        # strided per-process shard (reference main_image.py:178)
        return idx[self.process_index::self.process_count]

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = self._indices()
        nb = len(self)
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        stop = threading.Event()

        def make_batch(bidx):
            samples = list(pool.map(self.ds.__getitem__, bidx))
            imgs = np.stack([s[0] for s in samples])
            labels = np.asarray([s[1] for s in samples], np.int32)
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
                process_index: int = 0, process_count: int = 1):
    """The loader of ``dataset``: the Python threaded ``DataLoader`` for
    every dataset.  The JAX package's ``make_loader`` takes its native C++
    decode pipeline for file-backed datasets (ImageFolder, ImageFilelist)
    when that library builds; it reproduces PIL's resampler to +-1
    (dynamic_tuning_tpu/data/datasets.py:34), so the two packages may decode
    a JPEG differently by that much.  Both give the same batch order."""
    return DataLoader(dataset, batch_size, shuffle=shuffle,
                      drop_last=drop_last, seed=seed, num_workers=num_workers,
                      process_index=process_index, process_count=process_count)
