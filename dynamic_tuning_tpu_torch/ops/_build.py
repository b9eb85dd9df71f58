"""Build and bind the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a``, all of
them at once, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``.  The library lands in
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    "dyt_attention_sublayer_q8": [_P, _I] + [_P] * 15 + [_I, _I, _I, _I, _F,
                                                         _I, _P],
    "dyt_q8_ln_mlp": [_P, _I] + [_P] * 13 + [_I, _I, _I, _I, _P],
    "dyt_attn_core_q8": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "dyt_attn_core_q8_smem_bytes": [_I, _I],
    "dyt_q8_stem_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    "dyt_q8_dispatch_mlp": [_P, _I] + [_P] * 17 + [_I] * 6 + [_P],
    "dyt_gemm_s8_s32": [_P, _P, _I, _I, _I, _P, _P],
    "dyt_gemm_bf16_f32": [_P, _P, _I, _I, _I, _P, _P],
    "dyt_moe_adapter_router": [_P, _I, _I] + [_P] * 9 + [_I, _P, _I, _I, _F,
                                                         _P],
    "dyt_moe_width_supported": [_I, _I],
    "dyt_moe_smem_bytes": [_I, _I],
    "dyt_mha_windowed": [_P, _P, _P, _I, _I, _I, _I, ctypes.c_longlong, _I,
                         _F, _P],
    "dyt_fused_ln_mlp": [_P, _I] + [_P] * 10 + [_I, _I, _I, _I, _P],
    "dyt_mha_core": [_P] * 5 + [_I, _I, _I, _I, _F, _I, _P],
    "dyt_mha_softmax": [_P] * 6 + [ctypes.c_longlong] * 2
                       + [_I, _I, _I, _I, _F, _I, _P],
}


def strides_arg(*tensors) -> ctypes.Array:
    """The (batch, head, row) element strides of each [B, H, N, hd] tensor,
    in order, as the C array the strided attention entry points take."""
    vals = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


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
    digest = _digest()
    lib_path = BUILD_DIR / f"libdyt_kernels_{digest}.so"
    if lib_path.exists():
        return lib_path
    obj_dir = BUILD_DIR / f"obj_{digest}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = obj_dir / (src.stem + ".o")
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"--- {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *(str(obj) for _, obj, _ in jobs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append("link")
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    shutil.rmtree(obj_dir, ignore_errors=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
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
