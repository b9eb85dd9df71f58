"""Throughput timing on the card (counterpart of
dynamic_tuning_tpu/utils/profiling.py::scan_throughput).

The JAX package serializes iterations inside one device program with a scan.
The PyTorch forward is eager: iterations issued on one stream already run one
after another, so ``scan_throughput`` issues them in a loop between two CUDA
events and reads the device time between the events (host launch gaps
included, since the eager forward pays them).
"""

from __future__ import annotations

from typing import Callable

import torch


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
