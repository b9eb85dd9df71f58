"""Training checkpoints: save, resume, the final weights, the BatchNorm
sidecar, the head re-init (counterpart of the save/resume half of
dynamic_tuning_tpu/train/checkpoint.py).

Reference behaviour (misc.py:296-352, main_image.py:219-258, 357-358): a
checkpoint per epoch on the best metric, written by the main process, with
``auto_remove`` pruning the older ones; the final weights; after a
pretrained load the head is re-drawn (``trunc_normal_(std=0.01)``, bias 0).

The files are the JAX package's own ``.msgpack`` (read and written with
``serialization.py``).  A checkpoint, ``checkpoint-<epoch>.msgpack``, is
``{trainable, frozen, opt_state, step, epoch, extra}``: the parameters
nested by flax path in the flax layout (``checkpoint.to_flax_params``),
``opt_state`` the ``to_state_dict`` form of the optax chain the JAX package
builds for the same flags (``checkpoint.to_flax_opt_state``).  The JAX
package's ``load_checkpoint`` resumes a file the port wrote, and the port
resumes one the JAX package wrote; the payload has no seed, so a resumed
run takes its seed from ``--seed``, as in JAX.  The segmentor's BatchNorm
running statistics go to a sidecar, ``aux-batch_stats-<step>.msgpack``
(``save_aux_state``); the final weights are the nested param tree
(``save_params``; a ``.pth`` path gets a state dict under the port's
names, for the PyTorch world).  The ``.pth`` checkpoints of earlier port
runs (``model``: the trainable tensors, ``optimizer``, ``step``, ``seed``,
``epoch``, ``extra``, the segmentor's ``buffers``) still load.

Writes go to a temporary file that ``os.replace`` renames, so a crash never
leaves a truncated checkpoint under the final name.  ``blocking=False``
copies the tensors to the host at once and writes on a background thread
(at most one save in flight; ``wait_for_async_saves`` joins it, and so
does the interpreter's exit).  Under a process group every rank calls the
savers together: rank 0 writes (the ranks hold the same parameters and
optimizer state) and the others wait at a barrier; every rank reads on a
resume.
"""

from __future__ import annotations

import atexit
import glob
import os
import re
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from dynamic_tuning_tpu_torch import serialization
from dynamic_tuning_tpu_torch.checkpoint import (_flatten,
                                                 flax_path_to_port,
                                                 from_flax_params,
                                                 from_flax_train_state,
                                                 load_torch_state_dict,
                                                 to_flax_opt_state,
                                                 to_flax_params)
from dynamic_tuning_tpu_torch.parallel.mesh import barrier, is_main
from dynamic_tuning_tpu_torch.train.engine import TrainState


def require_checkpoint(path: str) -> None:
    """Refuse a file that is neither a ``.msgpack`` nor a ``.pth``/``.pt``."""
    if not path.endswith((".msgpack", ".pth", ".pt")):
        raise NotImplementedError(
            f"{path}: a checkpoint is a .msgpack (the JAX package's) or a "
            ".pth/.pt")


def _atomic_write(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _prune(output_dir: str, prefix: str, suffix: str, keep_from: int
           ) -> None:
    """Delete ``{prefix}<n>{suffix}`` for every n below ``keep_from``."""
    for old in glob.glob(os.path.join(output_dir, f"{prefix}*{suffix}")):
        m = re.search(rf"{re.escape(prefix)}(\d+){re.escape(suffix)}$", old)
        if m and int(m.group(1)) < keep_from:
            os.remove(old)


# --- the non-blocking save ---------------------------------------------------

_ASYNC_SAVER: Optional[threading.Thread] = None
_ASYNC_ERROR: list = []
_ATEXIT_REGISTERED = False


def _run_save(write, blocking: bool) -> None:
    """``write()`` now, or on a background thread with at most one save in
    flight (joined at the interpreter's exit)."""
    global _ASYNC_SAVER, _ATEXIT_REGISTERED
    if blocking:
        write()
        return
    wait_for_async_saves()
    if not _ATEXIT_REGISTERED:
        atexit.register(wait_for_async_saves)
        _ATEXIT_REGISTERED = True

    def guarded():
        try:
            write()
        except BaseException as e:      # raised again by the next wait
            _ASYNC_ERROR.append(e)

    _ASYNC_SAVER = threading.Thread(target=guarded, daemon=True)
    _ASYNC_SAVER.start()


def wait_for_async_saves() -> None:
    """Block until an in-flight non-blocking save has finished; raise what
    it raised."""
    global _ASYNC_SAVER
    if _ASYNC_SAVER is not None:
        _ASYNC_SAVER.join()
        _ASYNC_SAVER = None
    if _ASYNC_ERROR:
        raise _ASYNC_ERROR.pop()


# --- checkpoints -------------------------------------------------------------

def save_checkpoint(output_dir: str, model: nn.Module, state: TrainState,
                    epoch: int, *, tag: Optional[str] = None,
                    extra: Optional[dict] = None,
                    auto_remove: bool = False, blocking: bool = True) -> str:
    """Write ``checkpoint-{epoch}.msgpack`` (or ``{tag}.msgpack``); with
    ``auto_remove`` delete the epoch checkpoints before ``epoch``.  Rank 0
    writes, the others wait."""
    path = os.path.join(output_dir,
                        f"{tag or f'checkpoint-{epoch}'}.msgpack")
    if is_main():
        os.makedirs(output_dir, exist_ok=True)
        params = dict(model.named_parameters())
        names = set(state.optimizer.names)
        # host copies (to_flax_params copies), taken before a non-blocking
        # save returns
        payload = {
            "trainable": to_flax_params({n: p for n, p in params.items()
                                         if n in names})[0],
            "frozen": to_flax_params({n: p for n, p in params.items()
                                      if n not in names})[0],
            "opt_state": to_flax_opt_state(state.optimizer),
            "step": int(state.step), "epoch": int(epoch),
            "extra": dict(extra or {})}

        def write():
            _atomic_write(path, lambda tmp: serialization.write_file(
                tmp, payload))
            if auto_remove and tag is None:
                _prune(output_dir, "checkpoint-", ".msgpack", epoch)

        _run_save(write, blocking)
    barrier()
    return path


@torch.no_grad()
def _copy_params(model: nn.Module, tensors: Mapping, buffers: bool = False
                 ) -> None:
    params = dict(model.named_buffers() if buffers
                  else model.named_parameters())
    unknown = sorted(set(tensors) - set(params))
    if unknown:
        raise KeyError(f"checkpoint tensors the model lacks: {unknown[:8]}")
    for name, value in tensors.items():
        p = params[name]
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{name}: checkpoint {tuple(value.shape)}, "
                             f"model {tuple(p.shape)}")
        p.copy_(value)


def _check_trainable(path: str, saved, state: TrainState) -> None:
    if set(saved) != set(state.optimizer.names):
        raise KeyError(f"{path} holds {len(saved)} trainable tensors, the "
                       f"run trains {len(state.optimizer.names)} (another "
                       "freeze rule: --fulltune?)")


def load_checkpoint(path: str, model: nn.Module,
                    state: Optional[TrainState] = None) -> Tuple[int, dict]:
    """Restore a checkpoint of ``save_checkpoint`` (or of the JAX package's,
    or a ``.pth`` of earlier port runs) into ``model`` (copies into its
    parameters, and a ``.pth``'s saved buffers, so an optimizer over them
    stays valid) and, given ``state``, the optimizer and step (and a
    ``.pth``'s seed).  A ``.msgpack`` restores the frozen parameters too,
    as JAX's ``load_checkpoint`` does.  Returns (epoch, extra)."""
    require_checkpoint(path)
    if path.endswith(".msgpack"):
        blob = serialization.read_file(path)
        if state is not None:
            _check_trainable(path, [flax_path_to_port(p) for p, _ in
                                    _flatten(blob["trainable"])], state)
        bridged = from_flax_train_state(blob["trainable"], blob["frozen"],
                                        blob["opt_state"], blob["step"])
        _copy_params(model, bridged["model"])
        if state is not None:
            state.optimizer.load_state_dict(bridged["optimizer"])
            state.step = bridged["step"]
        return int(blob["epoch"]), {k: (v.item() if hasattr(v, "item")
                                        else v)
                                    for k, v in blob["extra"].items()}
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if state is not None:
        _check_trainable(path, blob["model"], state)
    _copy_params(model, blob["model"])
    _copy_params(model, blob.get("buffers", {}), buffers=True)
    if state is not None:
        state.optimizer.load_state_dict(blob["optimizer"])
        state.step = int(blob["step"])
        state.seed = int(blob["seed"])
    return int(blob["epoch"]), dict(blob["extra"])


# --- the BatchNorm sidecar ---------------------------------------------------

def save_aux_state(output_dir: str, name: str, tensors: Mapping, step: int,
                   *, auto_remove: bool = False) -> str:
    """``aux-{name}-{step}.msgpack``: model buffers (the segmentor's
    BatchNorm running statistics, under their port names) as the JAX
    package's ``batch_stats`` tree, which lives outside its TrainState.
    With ``auto_remove`` the older sidecars of ``name`` go.  Rank 0
    writes, the others wait; nothing is written for no tensors."""
    if not tensors:
        return ""
    path = os.path.join(output_dir, f"aux-{name}-{step}.msgpack")
    if is_main():
        os.makedirs(output_dir, exist_ok=True)
        tree = to_flax_params(tensors)[1]
        _atomic_write(path, lambda tmp: serialization.write_file(tmp, tree))
        if auto_remove:
            _prune(output_dir, f"aux-{name}-", ".msgpack", step)
    barrier()
    return path


def load_aux_state(output_dir: str, name: str,
                   step: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The latest (or the given step's) sidecar of ``save_aux_state`` (the
    JAX package's or the port's) as port-named tensors; {} when there is
    none (a GroupNorm run)."""
    found = {}
    for p in glob.glob(os.path.join(output_dir, f"aux-{name}-*.msgpack")):
        m = re.search(rf"aux-{re.escape(name)}-(\d+)\.msgpack$", p)
        if m:
            found[int(m.group(1))] = p
    if not found:
        return {}
    pick = step if step in found else max(found)
    stats = from_flax_params({}, serialization.read_file(found[pick]))
    return {k: torch.as_tensor(v) for k, v in stats.items()}


def restore_aux_state(checkpoint: str, model: nn.Module,
                      names: Sequence[str], step: int) -> None:
    """After loading ``checkpoint`` (of iteration ``step``), the BatchNorm
    statistics ``names`` from the sidecar beside it (JAX
    ``seg_runner.py:134-140``): the one of ``step``, else the newest (JAX
    takes the newest; with ``auto_remove`` that is the same file); a
    ``.pth`` carried them inside."""
    if names and checkpoint.endswith(".msgpack"):
        root = os.path.dirname(checkpoint) or "."
        _copy_params(model, load_aux_state(root, "batch_stats", step),
                     buffers=True)


# --- the final weights -------------------------------------------------------

def save_params(path: str, model: nn.Module) -> None:
    """The final weights (reference ``final_checkpoint.pth``,
    main_image.py:357-358): a ``.msgpack`` path gets every parameter as
    the JAX package's nested param tree (its ``load_params`` reads it);
    a ``.pth`` path every parameter and buffer under its port name
    (``checkpoint.load_timm_state_dict`` and the JAX package's
    ``load_torch_state_dict`` + ``import_pretrained`` read it).  Rank 0
    writes, the others wait."""
    require_checkpoint(path)
    if is_main():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if path.endswith(".msgpack"):
            tree = to_flax_params(dict(model.named_parameters()))[0]
            _atomic_write(path, lambda tmp: serialization.write_file(
                tmp, tree))
        else:
            sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
            _atomic_write(path, lambda tmp: torch.save(sd, tmp))
    barrier()


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """A weights file as a port state dict: a ``.msgpack`` param tree (the
    JAX package's ``save_params``, or the port's) through
    ``from_flax_params``, or a ``.pth``/``.pt`` state dict."""
    require_checkpoint(path)
    if path.endswith(".msgpack"):
        tree = serialization.read_file(path)
        tree = tree.get("params", tree)      # a variables dict, as predict.py
        return {k: torch.as_tensor(v) for k, v in
                from_flax_params(tree).items()}
    return dict(load_torch_state_dict(path))


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
