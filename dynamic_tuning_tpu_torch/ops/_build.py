"""Build and bind the package's hand-written CUDA kernels.

``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, and loaded with ``ctypes``.  The library lands in
``build/dyt_torch_kernels/`` at the checkout root (git-ignored), named by a
hash of the sources and flags, so a change to any source rebuilds and an
unchanged tree reuses the last build.  Nothing here runs at import time: the
first call of a kernel wrapper on a CUDA tensor builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dyt_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None      # wall time of this process's build
build_log: str = ""                     # nvcc's output (ptxas register use)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "dyt_attention_sublayer": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _I, _I, _I, _I, _F, _P],
    "dyt_adapter_router": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                           _I, _P],
    "dyt_attn_core_smem_bytes": [_I, _I],
    "dyt_adapter_width_supported": [_I],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "dynamic_tuning_tpu_torch/csrc on first use and need "
                       "the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source tree has no library yet; return
    its path."""
    global build_seconds, build_log
    lib_path = BUILD_DIR / f"libdyt_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.dyt_error_string.argtypes = [ctypes.c_int]
            lib.dyt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.dyt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
