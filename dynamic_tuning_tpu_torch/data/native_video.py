"""ctypes bindings of the port's native C++ video decoder
(``dynamic_tuning_tpu_torch/native/dyt_video.cpp``, a copy of the
repository's ``native/dyt_video.cpp``; counterpart of
dynamic_tuning_tpu/data/native_video.py).

The reference decodes video with decord (K400, k400.py:115-117) and PyAV
(SSv2, sthv2_dataset.py:115-121), Python wrappers around libav.  This is a
native layer over the same libraries (demux, decode, swscale to RGB24,
frame by frame without seeking), and ``data/video.py`` takes it before
decord, PyAV and OpenCV.  It also holds the C form of the clip resize
(``resize_bicubic``), which releases the GIL so loader threads resize
concurrently.

The library compiles on first use, with ``g++ -lavformat -lavcodec
-lavutil -lswscale``, into ``build/dyt_native/`` (``_native_build``).
``available()`` is False when it cannot be built or loaded (no ``g++``,
no libav headers); ``why_unavailable()`` says why, and the Python
backends take over.  Decoding is host code, not a kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np

from dynamic_tuning_tpu_torch.data import _native_build

_SRC = str(_native_build.NATIVE_DIR / "dyt_video.cpp")
_SO = str(_native_build.BUILD_DIR / "libdyt_video.so")
_LIB = None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = _native_build.build_and_load(
        _SRC, _SO, ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"])
    if lib is None:
        return None
    lib.dyt_video_probe.restype = ctypes.c_int
    lib.dyt_video_probe.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.dyt_video_decode.restype = ctypes.c_int
    lib.dyt_video_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
    lib.dyt_resize_bicubic.restype = ctypes.c_int
    lib.dyt_resize_bicubic.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
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


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native video decoder unavailable: "
                           + why_unavailable())
    return lib


# A clip is probed once for its frame count and again inside read_frames
# for its size; a container without frame metadata is demuxed whole to
# count packets, so each path is probed once per process.
_PROBE_CACHE: Dict[str, Tuple[int, int, int]] = {}
_PROBE_CACHE_MAX = 65536


def probe(path: str) -> Tuple[int, int, int]:
    """-> (num_frames, height, width); raises on an unreadable file."""
    hit = _PROBE_CACHE.get(path)
    if hit is not None:
        return hit
    lib = _require()
    n, h, w = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.dyt_video_probe(path.encode(), ctypes.byref(n), ctypes.byref(h),
                           ctypes.byref(w)) != 0:
        raise IOError(f"cannot probe video: {path}")
    if len(_PROBE_CACHE) >= _PROBE_CACHE_MAX:
        _PROBE_CACHE.clear()
    _PROBE_CACHE[path] = (n.value, h.value, w.value)
    return _PROBE_CACHE[path]


def read_frames(path: str, want: List[int]) -> Dict[int, np.ndarray]:
    """-> {index: RGB uint8 HxWx3} at full resolution, the contract of the
    decord/av/cv2 readers in ``data/video.py``.  Indices past the real end
    of the stream come back as the last decoded frame (clamped in C++); a
    stream with no decodable frame gives {} (the dataset zero-fills); an
    unopenable file raises."""
    lib = _require()
    _, h, w = probe(path)
    order = sorted(set(int(i) for i in want))
    buf = np.empty((len(order), h, w, 3), np.uint8)
    idx = (ctypes.c_int * len(order))(*order)
    filled = lib.dyt_video_decode(
        path.encode(), idx, len(order),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w)
    if filled < 0:
        raise IOError(f"cannot decode video: {path}")
    return {i: buf[j] for j, i in enumerate(order[:filled])}


def _check_taps(name: str, a: np.ndarray, dtype, rows: int) -> None:
    """The C loop reads ``rows`` x 4 values of ``dtype`` in row order from
    the pointer it is given: anything else would read the wrong memory."""
    if (a.dtype != dtype or not a.flags.c_contiguous
            or a.shape != (rows, 4)):
        raise ValueError(f"{name}: C-contiguous {np.dtype(dtype).name} "
                         f"[{rows}, 4] taps needed, got {a.dtype} "
                         f"{a.shape} (contiguous: {a.flags.c_contiguous})")


def resize_bicubic(img: np.ndarray, nh: int, nw: int,
                   idx_h: np.ndarray, wts_h: np.ndarray,
                   idx_w: np.ndarray, wts_w: np.ndarray
                   ) -> Optional[np.ndarray]:
    """The 4-tap separable resize of an HxWx3 uint8 frame in C, with the
    tap tables of ``data/video.py::_tb_taps`` (the torch-bicubic kernel),
    the same float32 pair-order arithmetic as the numpy form.  None when
    the library is unavailable; raises on taps of another dtype or layout,
    and when the C call fails."""
    lib = _load()
    if lib is None:
        return None
    _check_taps("idx_h", idx_h, np.int32, nh)
    _check_taps("wts_h", wts_h, np.float32, nh)
    _check_taps("idx_w", idx_w, np.int32, nw)
    _check_taps("wts_w", wts_w, np.float32, nw)
    img = np.ascontiguousarray(img)
    out = np.empty((nh, nw, 3), np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i32 = ctypes.POINTER(ctypes.c_int32)
    f32 = ctypes.POINTER(ctypes.c_float)
    rc = lib.dyt_resize_bicubic(
        img.ctypes.data_as(u8), img.shape[0], img.shape[1],
        idx_h.ctypes.data_as(i32), wts_h.ctypes.data_as(f32), nh,
        idx_w.ctypes.data_as(i32), wts_w.ctypes.data_as(f32), nw,
        out.ctypes.data_as(u8))
    if rc != 0:
        raise RuntimeError(f"dyt_resize_bicubic failed ({rc}) on a "
                           f"{img.shape} frame to {nh}x{nw}")
    return out
