"""Build and load the port's native C++ data loader (counterpart of
dynamic_tuning_tpu/data/_native_build.py).

The library compiles on first use, with ``g++``, from the port's own
source (``dynamic_tuning_tpu_torch/native/``) into ``build/dyt_native/``
at the checkout root (git-ignored), never beside the source.  The build
goes to a per-process temporary path published with an atomic rename:
concurrent processes (the ranks of one host) may all trigger the build,
and racing writes to one ``.so`` path make loads fail at random.  Why a
build failed is kept in ``build_error`` (the callers print which decoder
ran and why).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import List, Optional

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dyt_native"

#: why the last build or load failed ("" when it did not)
build_error: str = ""


def build_and_load(src: str, so: str,
                   link_libs: List[str]) -> Optional[ctypes.CDLL]:
    """Compile ``src`` to ``so`` (when missing or older than ``src``) and
    load it; a library that does not load (built on another machine) is
    built again.  None when the toolchain or the libraries are missing,
    the reason in ``build_error``."""
    stale = not os.path.exists(so) or (
        os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(so))
    if not stale:
        lib = _load(so)
        if lib is not None:
            return lib
    if not _build(src, so, link_libs):
        return None
    return _load(so)


def _load(so: str) -> Optional[ctypes.CDLL]:
    global build_error
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        build_error = str(e)
        return None
    build_error = ""
    return lib


def _build(src: str, so: str, link_libs: List[str]) -> bool:
    """g++ ``src`` into a per-process temporary file renamed to ``so``."""
    global build_error
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    # -march=native vectorizes the resample and decode loops; plain -O3 on
    # toolchains that refuse it
    for extra in (["-march=native"], []):
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", *extra, src,
                            "-o", tmp] + link_libs,
                           check=True, capture_output=True, text=True)
            os.replace(tmp, so)
            return True
        except subprocess.CalledProcessError as e:
            build_error = (e.stderr or e.stdout or str(e)).strip()
        except OSError as e:
            build_error = str(e)
    if os.path.exists(tmp):
        try:
            os.remove(tmp)
        except OSError:
            pass
    return False
