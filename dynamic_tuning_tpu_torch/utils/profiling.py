"""Throughput timing on the card (counterpart of
dynamic_tuning_tpu/utils/profiling.py::scan_throughput).

The JAX package serializes iterations inside one device program with a scan.
The PyTorch forward is eager: iterations issued on one stream already run one
after another, so ``scan_throughput`` issues them in a loop between two CUDA
events and reads the device time between the events (host launch gaps
included, since the eager forward pays them).
"""

from __future__ import annotations

import subprocess
from typing import Callable

import torch

# NVIDIA's H100 SXM data sheet: HBM bytes/s and dense peak ops/s per type
HBM = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


def scan_throughput(apply_once: Callable[[], object], *, batch: int,
                    iters: int = 50, repeats: int = 3,
                    warmup_iters: int | None = None) -> float:
    """img/s of ``apply_once()`` (one forward of ``batch`` images on the
    current CUDA device): best of ``repeats`` runs of ``iters`` calls, after
    ``warmup_iters`` untimed calls (default ``iters``).  Raises without a
    card: a measurement never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("scan_throughput times CUDA work and needs a GPU")
    for _ in range(iters if warmup_iters is None else warmup_iters):
        apply_once()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            apply_once()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return batch * iters / best


def forwards_run(iters: int, repeats: int = 3,
                 warmup_iters: int | None = None) -> int:
    """How many times ``scan_throughput`` calls ``apply_once``."""
    return (iters if warmup_iters is None else warmup_iters) + repeats * iters


def time_ms(fn: Callable[[], object], iters: int = 20,
            warmup: int = 3) -> float:
    """Mean ms of ``fn()`` on the card: ``iters`` calls between two CUDA
    events, after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(bytes_moved: int, ops: dict) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card needs, the
    larger of the bytes over the memory rate and the operations ({type:
    count}) over their type's peak rate."""
    t_bytes = bytes_moved / HBM * 1e3
    t_ops = sum(n / PEAK[kind] for kind, n in ops.items()) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
