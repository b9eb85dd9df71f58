"""Process-aware console + file logger (reference util/logger.py:9-34:
colored console on rank 0, per-rank ``log_rank{N}.txt`` files), and the
TensorBoard scalar writer; a copy of dynamic_tuning_tpu/utils/logger.py
under its own logger name."""

from __future__ import annotations

import logging
import os
import sys


def create_logger(output_dir: str = "", dist_rank: int = 0,
                  name: str = "dyt_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    # sequential Runners in one process (main_vtab --task all builds 19)
    # share this named logger: tear down the previous config instead of
    # stacking handlers (duplicate console lines, logs appended into
    # earlier tasks' files)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        try:
            h.close()
        except OSError:
            pass

    fmt = "[%(asctime)s %(name)s] (%(filename)s %(lineno)d): %(levelname)s %(message)s"

    if dist_rank == 0:
        console = logging.StreamHandler(sys.stdout)
        console.setLevel(logging.DEBUG)
        console.setFormatter(logging.Formatter(fmt, datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(console)

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, f"log_rank{dist_rank}.txt"),
                                 mode="a")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(fmt, datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(fh)

    return logger


class TensorBoardWriter:
    """Scalar logger mirroring the reference's rank-0 SummaryWriter usage
    (engine_finetune.py:95-101) with the same epoch_1000x axis convention.

    Writes BOTH a grep-friendly ``scalars.tsv`` and a real TensorBoard
    ``events.out.tfevents.*`` file (utils/tb_writer.py hand-encodes the
    protobuf — no tensorflow/tensorboard dependency), so runs are loadable
    in stock TensorBoard exactly like the reference's."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "scalars.tsv")
        self._fh = open(self.path, "a")
        from dynamic_tuning_tpu_torch.utils.tb_writer import EventFileWriter
        self._events = EventFileWriter(log_dir)

    def add_scalar(self, tag: str, value: float, step: int):
        self._fh.write(f"{tag}\t{step}\t{value}\n")
        self._fh.flush()
        self._events.add_scalar(tag, value, step)

    def close(self):
        self._fh.close()
        self._events.close()
