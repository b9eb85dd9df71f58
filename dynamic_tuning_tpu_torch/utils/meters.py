"""Windowed metric meters + training-loop logger (a copy of
dynamic_tuning_tpu/utils/meters.py).

Reference behavior (misc.py:24-168): ``SmoothedValue`` tracks a deque window
plus global count/total; ``MetricLogger.log_every`` wraps an iterable and
prints window-median/avg meters, iteration ETA, data-vs-step time.  The
port trains in one process, so the cross-process sync is a no-op.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Iterable, Iterator, Optional

import numpy as np


class SmoothedValue:
    """Track a series over a sliding window + global average."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.window = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.window.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(self.window)) if self.window else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.window)) if self.window else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def value(self) -> float:
        return self.window[-1] if self.window else 0.0

    def sync(self):
        """Cross-process count/total sync: one process, nothing to sync."""
        return self

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  ", logger=None):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.logger = logger

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, name):
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def _log(self, msg: str):
        (self.logger.info if self.logger else print)(msg)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: Optional[int] = None) -> Iterator:
        total = total if total is not None else _maybe_len(iterable)
        i = 0
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                    self._log(f"{header} [{i}/{total}] eta: {eta_str} {self} "
                              f"time: {iter_time} data: {data_time}")
                else:
                    self._log(f"{header} [{i}] {self} time: {iter_time} data: {data_time}")
            i += 1
            end = time.time()
        elapsed = time.time() - start
        self._log(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))} "
                  f"({elapsed / max(i, 1):.4f} s / it)")

    def synchronize_between_processes(self):
        for m in self.meters.values():
            m.sync()


def _maybe_len(it) -> Optional[int]:
    try:
        return len(it)
    except TypeError:
        return None
