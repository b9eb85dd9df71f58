"""Training checkpoints: save, resume, the final weights, the head re-init
(counterpart of the save/resume half of dynamic_tuning_tpu/train/checkpoint.py).

Reference behaviour (misc.py:296-352, main_image.py:219-258, 357-358): a
checkpoint per epoch on the best metric, written by the main process, with
``auto_remove`` pruning the older ones; the final weights as
``final_checkpoint.pth``; after a pretrained load the head is re-drawn
(``trunc_normal_(std=0.01)``, bias 0).

Format: one ``.pth`` written with ``torch.save``, a dict of

* ``model``: the trainable tensors under their timm names (the frozen ones
  come back from ``--finetune`` or the seeded init, as the run's flags
  give them);
* ``optimizer``: ``Optimizer.state_dict()`` (moments, count, accumulation);
* ``step``, ``seed`` (the ``TrainState``'s), ``epoch`` (the segmentation
  runner's iteration) and ``extra`` (the best metric);
* ``buffers``, when the caller names some: the segmentor's BatchNorm
  running statistics, which the JAX package writes as a ``.msgpack``
  sidecar and a torch state dict carries beside its parameters.

Writes go to a temporary file that ``os.replace`` renames, so a crash never
leaves a truncated checkpoint under the final name.  Under a process group
every rank calls the savers together: rank 0 writes (the ranks hold the
same parameters and optimizer state) and the others wait at a barrier, so
no rank reads a checkpoint before it is whole; every rank reads on a
resume.  The JAX package's
``.msgpack`` trees are refused (its pytrees hold flax paths and optax
states; ``checkpoint.from_flax_train_state`` converts a JAX run's state).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from dynamic_tuning_tpu_torch.parallel.mesh import barrier, is_main
from dynamic_tuning_tpu_torch.train.engine import TrainState


def require_pth(path: str) -> None:
    """Refuse anything but a ``.pth``/``.pt`` checkpoint."""
    if not path.endswith((".pth", ".pt")):
        raise NotImplementedError(f"{path}: only .pth checkpoints load here")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def _atomic_save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(output_dir: str, model: nn.Module, state: TrainState,
                    epoch: int, *, tag: Optional[str] = None,
                    extra: Optional[dict] = None,
                    auto_remove: bool = False,
                    buffers: Sequence[str] = ()) -> str:
    """Write ``checkpoint-{epoch}.pth`` (or ``{tag}.pth``), with the model
    buffers named in ``buffers``; with ``auto_remove`` delete the epoch
    checkpoints before ``epoch``.  Rank 0 writes, the others wait."""
    path = os.path.join(output_dir, f"{tag or f'checkpoint-{epoch}'}.pth")
    if is_main():
        _write_checkpoint(path, model, state, epoch, extra, auto_remove,
                          tag, buffers)
    barrier()
    return path


def _write_checkpoint(path, model, state, epoch, extra, auto_remove, tag,
                      buffers) -> None:
    output_dir = os.path.dirname(path)
    os.makedirs(output_dir, exist_ok=True)
    params = dict(model.named_parameters())
    own = dict(model.named_buffers())
    payload = {
        "model": {n: params[n] for n in state.optimizer.names},
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "seed": int(state.seed),
        "epoch": int(epoch),
        "extra": dict(extra or {}),
    }
    if buffers:
        payload["buffers"] = {n: own[n] for n in buffers}
    _atomic_save(_to_cpu(payload), path)
    if auto_remove and tag is None:
        for old in glob.glob(os.path.join(output_dir, "checkpoint-*.pth")):
            m = re.search(r"checkpoint-(\d+)\.pth$", old)
            if m and int(m.group(1)) < epoch:
                os.remove(old)


@torch.no_grad()
def _copy_params(model: nn.Module, tensors: dict, buffers: bool = False
                 ) -> None:
    params = dict(model.named_buffers() if buffers
                  else model.named_parameters())
    unknown = sorted(set(tensors) - set(params))
    if unknown:
        raise KeyError(f"checkpoint tensors the model lacks: {unknown[:8]}")
    for name, value in tensors.items():
        p = params[name]
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{name}: checkpoint {tuple(value.shape)}, "
                             f"model {tuple(p.shape)}")
        p.copy_(value)


def load_checkpoint(path: str, model: nn.Module,
                    state: Optional[TrainState] = None) -> Tuple[int, dict]:
    """Restore a checkpoint of ``save_checkpoint`` into ``model`` (copies
    into its parameters and saved buffers, so an optimizer over them stays
    valid) and, given ``state``, the optimizer, step and seed.  Returns
    (epoch, extra)."""
    require_pth(path)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if state is not None and set(blob["model"]) != set(
            state.optimizer.names):
        raise KeyError(f"{path} holds {len(blob['model'])} trainable "
                       f"tensors, the run trains {len(state.optimizer.names)}"
                       " (another freeze rule: --fulltune?)")
    _copy_params(model, blob["model"])
    _copy_params(model, blob.get("buffers", {}), buffers=True)
    if state is not None:
        state.optimizer.load_state_dict(blob["optimizer"])
        state.step = int(blob["step"])
        state.seed = int(blob["seed"])
    return int(blob["epoch"]), dict(blob["extra"])


def save_params(path: str, model: nn.Module) -> None:
    """The final weights (reference ``final_checkpoint.pth``,
    main_image.py:357-358): every parameter under its timm name, loadable
    by ``checkpoint.load_timm_state_dict`` and by the JAX package's
    ``load_torch_state_dict`` + ``import_pretrained``.  Rank 0 writes, the
    others wait."""
    if is_main():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _atomic_save(_to_cpu(dict(model.state_dict())), path)
    barrier()


@torch.no_grad()
def reinit_head(model: nn.Module, generator: torch.Generator,
                std: float = 0.01) -> None:
    """``trunc_normal_(head.weight, std=0.01)`` (cut at two standard
    deviations) and a zero bias, after a pretrained load (reference
    main_image.py:247), drawn from ``generator``."""
    head = model.head
    w = torch.empty(head.weight.shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    head.weight.copy_(w)
    head.bias.zero_()
