"""Training and eval steps (counterpart of
dynamic_tuning_tpu/train/engine.py).

Reference behaviour (engine_finetune.py:16-106): per step, the student
forward (gates as a mask-multiply) and the teacher forward (complete_model:
router skipped, its own dropout draws), the four-term loss (AdaLoss CE +
budget, teacher CE, distillation KL), the backward, the grad norm, and the
optimizer step on the trainable parameters with the per-iteration lr.

The step is eager PyTorch on the module path: bf16 matmuls on fp32 master
parameters (the model's ``dtype``), no loss scaler (bf16 has fp32's
exponent range), gradients only for the trainable parameters
(``optim.freeze``).  It returns its loss parts as device tensors and never
reads one on the host, so a timed loop of steps does not wait on the card.

Randomness: each step derives three seeds from (``TrainState.seed``,
step), one per purpose -- the student's router noise, the student's
dropout, the teacher's dropout -- in the manner of the JAX engine's
``fold_in`` and ``split``; every block folds its index into them
(``models.layers.Draws``).  Tests give the routers' noise instead
(``gate_noise``).

Under a process group (``parallel/``), each rank holds its rows of the
global batch and a full copy of the parameters: the draws are the global
batch's (each rank keeps its rows), the losses are global means, and the
gradients are summed over ranks in one flat bucket
(``parallel.mesh.all_reduce_grads``) before the grad norm, the clip and the
optimizer, so every rank takes the same update and the returned parts are
the global batch's.  No ``DistributedDataParallel``: its reducer hooks
``.backward()``, and this step takes ``torch.autograd.grad``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from dynamic_tuning_tpu_torch.config import SelectConfig
from dynamic_tuning_tpu_torch.models.layers import Draws, fold_in
from dynamic_tuning_tpu_torch.parallel.mesh import (all_reduce_grads,
                                                    global_mean,
                                                    process_count,
                                                    process_index)
from dynamic_tuning_tpu_torch.train import losses as L
from dynamic_tuning_tpu_torch.train.optim import Optimizer, global_norm

PHASES = ("student", "teacher", "backward", "optimizer")


@dataclass
class TrainState:
    """What changes during training besides the parameters: the step (calls
    of the train step so far), the optimizer (its moments and update
    count) and the seed every step's random streams derive from."""

    optimizer: Optimizer
    seed: int = 0
    step: int = 0


def step_draws(seed: int, step: int, device) -> Tuple[Draws, Draws]:
    """(student, teacher) random streams of step ``step``, this rank's
    rows of the global batch's."""
    s = fold_in(seed, step)
    rows = (process_index(), process_count())
    return (Draws(device, rows, gate=fold_in(s, 0), dropout=fold_in(s, 1)),
            Draws(device, rows, dropout=fold_in(s, 2)))


def make_train_step(model: torch.nn.Module, select_cfg: SelectConfig,
                    distill: bool = True) -> Callable:
    """The train step of ``model`` (a ``VisionTransformer`` whose trainable
    parameters the state's optimizer holds):

    ``train_step(state, images, labels, gate_noise=None, timer=None)`` ->
    parts (``loss``, ``base_loss``, ``token_loss``, ``teacher_loss``,
    ``distillation_loss`` with ``distill``, ``keep_ratio`` with routers,
    ``grad_norm`` before any clipping), each a detached device scalar.
    ``timer(phase)``, when given, is called after each of ``PHASES``."""

    def mark(timer, phase):
        if timer is not None:
            timer(phase)

    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor,
                   gate_noise: Optional[torch.Tensor] = None,
                   timer: Optional[Callable[[str], None]] = None
                   ) -> Dict[str, torch.Tensor]:
        student, teacher = step_draws(state.seed, state.step, images.device)
        logits, aux = model(images, training=True, draws=student,
                            gate_noise=gate_noise)
        token_select = aux["token_select"]
        mark(timer, "student")
        if distill:
            # the teacher: the same parameters with the mask bypassed and
            # the router skipped; its own dropout draws, and gradients
            t_logits, _ = model(images, training=True, complete_model=True,
                                draws=teacher)
            mark(timer, "teacher")
            total, parts = L.dyt_total_loss(logits, t_logits, labels,
                                            token_select, select_cfg)
        else:
            total, parts = L.ada_loss(logits, labels, token_select,
                                      select_cfg)
            mark(timer, "teacher")
        parts["loss"] = total
        if token_select is not None:
            with torch.no_grad():
                parts["keep_ratio"] = global_mean(token_select.float())
        opt = state.optimizer
        grads = torch.autograd.grad(total, opt.params, allow_unused=True)
        grads = all_reduce_grads([torch.zeros_like(p) if g is None else g
                                  for g, p in zip(grads, opt.params)])
        mark(timer, "backward")
        parts["grad_norm"] = global_norm(grads)
        opt.step(grads)
        state.step += 1
        mark(timer, "optimizer")
        return {k: v.detach() for k, v in parts.items()}

    return train_step


def make_eval_step(model: torch.nn.Module, dispatch: bool = False
                   ) -> Callable:
    """``eval_step(images) -> (logits, token_select)``: the deterministic
    gate as a mask-multiply, or with ``dispatch`` the capacity dispatch,
    which on the card runs the serving kernels (engine_finetune.py:229-248:
    the gate stack is what the FLOPs accounting reads)."""

    def eval_step(images: torch.Tensor
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        with torch.inference_mode():
            logits, aux = model(images, dispatch=dispatch)
        return logits, aux["token_select"]

    return eval_step
