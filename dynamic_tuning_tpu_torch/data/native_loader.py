"""ctypes bindings of the port's native C++ data loader
(``dynamic_tuning_tpu_torch/native/dyt_loader.cpp``, a copy of the
repository's ``native/dyt_loader.cpp``; counterpart of
dynamic_tuning_tpu/data/native_loader.py).

JPEG/PNG decode and resize run in a C++ worker pool behind a bounded
prefetch queue, in place of the Python loader's threads, for file-list
datasets (ImageFolder, VTAB filelists).  ``available()`` is False when the
library cannot be built or loaded (no ``g++``, no libjpeg/libpng headers);
``why_unavailable()`` says why, and callers keep the Python loader and
PIL.  Decoding is host code, not a kernel.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Iterator, List, Optional, Tuple

import numpy as np

from dynamic_tuning_tpu_torch.data import _native_build

_SRC = str(_native_build.NATIVE_DIR / "dyt_loader.cpp")
_SO = str(_native_build.BUILD_DIR / "libdyt_loader.so")
_LIB = None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = _native_build.build_and_load(_SRC, _SO,
                                       ["-ljpeg", "-lpng", "-lpthread"])
    if lib is None:
        return None
    lib.dyt_loader_create.restype = ctypes.c_void_p
    lib.dyt_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.dyt_loader_num_batches.restype = ctypes.c_int64
    lib.dyt_loader_num_batches.argtypes = [ctypes.c_void_p]
    lib.dyt_loader_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dyt_loader_next.restype = ctypes.c_int
    lib.dyt_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32)]
    lib.dyt_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.dyt_loader_decode_failures.restype = ctypes.c_int64
    lib.dyt_loader_decode_failures.argtypes = [ctypes.c_void_p]
    lib.dyt_loader_error.restype = ctypes.c_int
    lib.dyt_loader_error.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int]
    lib.dyt_decode_resize.restype = ctypes.c_int
    lib.dyt_decode_resize.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_uint8)]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def why_unavailable() -> str:
    """'' when the library loads, else the build's or the load's error."""
    return "" if available() else (_native_build.build_error
                                   or "the library did not build")


def library_path() -> str:
    return _SO


def decode_resize(path: str, canvas: int,
                  square: bool = False) -> Optional[np.ndarray]:
    """One file decoded to a uint8 [canvas, canvas, 3] canvas: short side
    to ``canvas`` then the centre crop, or with ``square`` a stretch to the
    square; None when the library is missing or the file does not
    decode."""
    lib = _load()
    if lib is None:
        return None
    out = np.zeros((canvas, canvas, 3), np.uint8)
    ok = lib.dyt_decode_resize(
        path.encode(), canvas, int(square),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if ok else None


class NativeDataLoader:
    """File-list batch loader on the C++ worker pool, with the protocol of
    ``data.loader.DataLoader``: ``set_epoch``, ``__len__``, ``__iter__``
    yielding (uint8 [B, canvas, canvas, 3], int32 [B]).  The library's
    shuffle (``mt19937_64(seed + epoch)``), its strided per-process shards
    padded to equal length by repeating leading samples, and its square
    mode are the JAX package's.  With ``sentinel_pad`` the padded samples
    (the last ones of a shard) carry label -1, which evaluation drops
    (``parallel.mesh.pad_eval_batch``)."""

    def __init__(self, samples: List[Tuple[str, int]], batch_size: int, *,
                 canvas: int = 256, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_workers: int = 4,
                 prefetch: int = 4, process_index: int = 0,
                 process_count: int = 1, square: bool = False,
                 sentinel_pad: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable: "
                               + why_unavailable())
        self._lib = lib
        self.batch_size = batch_size
        self.canvas = canvas
        self.epoch = 0
        self._real = (len(range(process_index, len(samples), process_count))
                      if sentinel_pad else None)
        paths = (ctypes.c_char_p * len(samples))(
            *[s[0].encode() for s in samples])
        labels = np.asarray([s[1] for s in samples], np.int32)
        self._handle = lib.dyt_loader_create(
            paths, labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(samples), batch_size, canvas, num_workers, prefetch,
            int(shuffle), int(drop_last), seed, process_index, process_count,
            int(square))
        self._nb = lib.dyt_loader_num_batches(self._handle)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        return int(self._nb)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        self._lib.dyt_loader_start_epoch(self._handle, self.epoch)
        imgs = np.zeros((self.batch_size, self.canvas, self.canvas, 3),
                        np.uint8)
        labels = np.zeros((self.batch_size,), np.int32)
        fails0 = self._lib.dyt_loader_decode_failures(self._handle)
        seen = 0
        while True:
            n = self._lib.dyt_loader_next(
                self._handle,
                imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if n < 0:  # a worker thread died on a C++ exception
                buf = ctypes.create_string_buffer(512)
                self._lib.dyt_loader_error(self._handle, buf, 512)
                raise RuntimeError(
                    f"native loader worker failed: {buf.value.decode()}")
            if n == 0:
                fails = self._lib.dyt_loader_decode_failures(self._handle)
                if fails > fails0:
                    logging.getLogger("dyt_torch").warning(
                        "native loader zero-filled %d undecodable image(s) "
                        "this epoch", fails - fails0)
                return
            out = labels[:n].copy()
            if self._real is not None:
                out[max(self._real - seen, 0):] = -1
            seen += n
            yield imgs[:n].copy(), out

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.dyt_loader_destroy(self._handle)
            self._handle = None
