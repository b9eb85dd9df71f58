"""Data parallelism over processes (counterpart of the data axis of
dynamic_tuning_tpu/parallel/mesh.py).

The JAX package shards the batch over a ``data`` mesh axis and XLA reduces
what the global batch needs.  Here each process (one per card) holds its
rows of the global batch and the reductions are explicit
``torch.distributed`` collectives, so a run of R processes computes what one
process computes on the global batch, up to reduction order:

* the global batch interleaves the ranks' batches: its row g lies on rank
  g % R, the order of the loaders' strided shards (``data/loader.py``), so
  a random draw of the global shape keeps this rank's rows
  (``rank_rows``) and a run of R processes draws what a run of one draws;
* the losses are global means through ``global_sum``, whose result every
  rank then uses whole (the loss): the gradient each rank receives is
  already the global one, so it passes back unchanged;
* BatchNorm's statistics go through ``sync_sum``, whose result feeds each
  rank's own rows: its gradient is the sum of the ranks' gradients;
* ``all_reduce_grads`` then sums the per-rank parameter gradients (one flat
  fp32 bucket), which together make the global gradient;
* evaluation pads each rank's shard to equal length with label -1
  (``eval_pad_count``/``pad_eval_batch``), and the host gathers the
  results (``gather_host``, the role of ``process_allgather``).

No ``DistributedDataParallel``: its reducer hooks ``.backward()``, where
the engine takes ``torch.autograd.grad`` of the trainable list, and its
averaged gradients get the budget loss (nonlinear in the batch mean) and
BatchNorm wrong.

The JAX package's placement helpers have no meaning here: ``shard_batch``
and ``shard_state`` (each process already holds its rows and a full copy
of the parameters), ``localize_tree`` (parameters are never sharded) and
``host_local_rows`` (outputs are already process-local).  Tensor
parallelism (its ``model`` axis and rules) is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dynamic_tuning_tpu_torch.parallel.multihost import (process_count,
                                                         process_index)


def group_active() -> bool:
    """Whether a process group runs (collectives then run even at world 1)."""
    return dist.is_available() and dist.is_initialized()


def make_mesh(model_parallel: int = 1) -> int:
    """The data axis's size (every process); ``model_parallel`` other than
    1 is refused (tensor parallelism is not ported yet)."""
    if model_parallel != 1:
        raise ValueError(f"--model_parallel {model_parallel}: tensor "
                         "parallelism (the model axis) is not ported yet; "
                         "the port trains data-parallel, one process per "
                         "card")
    return process_count()


# --- rows of the global batch ----------------------------------------------

def rank_rows(rows, rank: Optional[int] = None,
              world: Optional[int] = None):
    """This rank's rows of the global batch's ``rows`` (a tensor, array or
    list along the batch): rows rank::world, the loaders' strided shard.
    The one statement of that layout: the draws (``models.layers.Draws``,
    the augmentations' ``shard``) keep their rows through it."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    return rows if world == 1 else rows[rank::world]


# --- differentiable reductions ---------------------------------------------

class _SumWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g


class _SumSynced(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``x``, for a value every rank then uses whole
    (a loss term): each rank's gradient passes back unchanged, and the
    parameter gradients summed by ``all_reduce_grads`` make the global
    one.  ``x`` itself without a process group."""
    return _SumWhole.apply(x) if group_active() else x


def sync_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``x``, for a value that feeds each rank's own
    rows (BatchNorm's statistics): its gradient is the sum over ranks of
    theirs.  ``x`` itself without a process group."""
    return _SumSynced.apply(x) if group_active() else x


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The differentiable mean of ``x`` over the global batch; every rank
    holds as many elements (the train loaders' equal shards)."""
    return global_sum(x.sum()) / (x.numel() * process_count())


def all_reduce_grads(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The per-rank gradients summed over ranks, through one flat fp32
    bucket (one collective a step).  Unchanged without a process group."""
    grads = list(grads)
    if not group_active():
        return grads
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    out, off = [], 0
    for g in grads:
        n = g.numel()
        out.append(flat[off:off + n].view(g.shape).to(g.dtype))
        off += n
    return out


def all_reduce_bytes(tensors: Sequence[torch.Tensor]) -> int:
    """The size of ``all_reduce_grads``' bucket for ``tensors``."""
    return 4 * sum(t.numel() for t in tensors)


# --- the host ---------------------------------------------------------------

def gather_host(x) -> list:
    """Every rank's ``x`` (any picklable value: numpy arrays, numbers), in
    rank order; ``[x]`` without a process group.  All ranks call it
    together."""
    if not group_active():
        return [x]
    out = [None] * process_count()
    dist.all_gather_object(out, x)
    return out


def gather_rows(x: np.ndarray) -> np.ndarray:
    """The ranks' row blocks of ``x`` concatenated in rank order."""
    return np.concatenate(gather_host(np.asarray(x)))


def barrier() -> None:
    if group_active():
        dist.barrier()


def is_main() -> bool:
    return process_index() == 0


# --- evaluation padding ------------------------------------------------------

def eval_pad_count(n_items: int, world: Optional[int] = None) -> int:
    """Items to append to ``n_items`` so that every one of ``world`` ranks
    holds as many (the loaders' strided shards)."""
    world = process_count() if world is None else world
    return (-n_items) % world


def pad_eval_batch(items: np.ndarray, labels, count: int,
                   fill: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Append ``count`` copies of the last item (of ``fill`` when the batch
    has none) under the sentinel label -1, which callers drop; labels come
    back int64 so the sentinel cannot wrap."""
    labels = np.asarray(labels).astype(np.int64)
    if count:
        last = items[-1:] if len(items) else np.asarray(fill)[None]
        items = (np.concatenate([items, np.repeat(last, count, axis=0)])
                 if len(items) else np.repeat(last, count, axis=0))
        labels = np.concatenate([labels, np.full(count, -1, np.int64)])
    return items, labels
