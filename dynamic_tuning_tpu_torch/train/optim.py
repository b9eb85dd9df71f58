"""Optimizer, LR schedule and parameter freezing (counterpart of
dynamic_tuning_tpu/train/optim.py), with optax's semantics.

Reference behaviour:
  * LR schedule: linear warmup then half-cosine, evaluated at
    fractional-epoch granularity every iteration (util/lr_sched.py:9-21).
  * Optimizer: AdamW over the trainable parameters only (main_image.py:285),
    uniform decoupled weight decay.
  * Freezing: adapters, routers and the classifier head train; the
    pretrained backbone is frozen (main_image.py:249-256).

Freezing sets ``requires_grad``: frozen weights get no weight gradient and
no optimizer state.  The update chain is optax's: optional
``clip_by_global_norm``, then AdamW (``p - lr * (m_hat / (sqrt(v_hat) + eps)
+ wd * p)``, eps 1e-8, the lr read at the update count before its
increment) or LARS, then the optional layer decay, which scales the whole
update; ``accum_iter > 1`` wraps the chain in ``optax.MultiSteps``: the
running mean of ``accum_iter`` gradients is applied once every
``accum_iter`` calls, and the other calls change nothing.  Every update
runs on the parameters' device with no host synchronisation.

``state_dict()`` / ``load_state_dict()`` carry the state a resumed run
needs, keyed by the parameters' names: AdamW's ``mu``, ``nu`` and
``count`` (LARS's momentum ``trace``), the accumulation buffer and
``mini_step``.  A load copies into the existing tensors, which stay on
their device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

TRAINABLE_KEYWORDS = ("adaptmlp", "mlp_token_select")

Named = Sequence[Tuple[str, torch.Tensor]]


def default_trainable_predicate(name: str) -> bool:
    """The reference freeze rule on timm names: ``blocks.*.adaptmlp.*``,
    ``blocks.*.mlp_token_select.*`` and ``head.*`` train."""
    parts = name.split(".")
    return (any(k in parts for k in TRAINABLE_KEYWORDS)
            or parts[0] == "head")


def freeze(model: nn.Module,
           predicate: Callable[[str], bool] = default_trainable_predicate
           ) -> List[Tuple[str, nn.Parameter]]:
    """Set ``requires_grad`` by ``predicate``; returns the trainable
    (name, parameter) pairs."""
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(predicate(name))
        if p.requires_grad:
            trainable.append((name, p))
    return trainable


def count_params(named: Named, exclude_head: bool = True) -> int:
    """Elements of the (name, tensor) pairs, the head's left out."""
    return sum(p.numel() for name, p in named
               if not (exclude_head and "head" in name.split(".")))


def warmup_cosine_schedule(base_lr: float, min_lr: float, epochs: float,
                           warmup_epochs: float, steps_per_epoch: int
                           ) -> Callable[[int], float]:
    """Per-iteration fractional-epoch warmup + half-cosine:

    lr(e) = base * e / warmup                      for e < warmup
    lr(e) = min + (base-min) * 0.5*(1+cos(pi*(e-warmup)/(epochs-warmup)))
    """

    def schedule(step: int) -> float:
        e = step / steps_per_epoch
        if e < warmup_epochs:
            return base_lr * e / max(warmup_epochs, 1e-8)
        prog = (e - warmup_epochs) / max(epochs - warmup_epochs, 1e-8)
        return min_lr + (base_lr - min_lr) * 0.5 * (1.0 + math.cos(
            math.pi * prog))

    return schedule


def layerwise_lr_decay_scales(names: Sequence[str], *, num_layers: int = 12,
                              decay_rate: float = 0.65) -> Dict[str, float]:
    """Per-parameter update multipliers with layer-wise decay (reference
    util/lr_decay.py): the stem, CLS and pos-embed get decay^(L+1), block i
    decay^(L-i), everything after the blocks 1."""

    def scale_for(name: str) -> float:
        top = name.split(".")
        if top[0] in ("cls_token", "pos_embed", "patch_embed"):
            layer = 0
        elif top[0] == "blocks":
            layer = int(top[1]) + 1
        else:
            layer = num_layers + 1
        return decay_rate ** (num_layers + 1 - layer)

    return {n: scale_for(n) for n in names}


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (a device scalar)."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(list(tensors))))


@torch.no_grad()
def _copy_named(dst: Sequence[torch.Tensor], src: Dict[str, torch.Tensor],
                names: Sequence[str]) -> None:
    """Copy ``src[name]`` into each of ``dst`` (in ``names`` order)."""
    if set(src) != set(names):
        raise KeyError(f"optimizer state for {sorted(set(src) ^ set(names))}"
                       " does not match the trainable parameters")
    for t, name in zip(dst, names):
        v = torch.as_tensor(src[name])
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"optimizer state {name}: shape "
                             f"{tuple(v.shape)}, parameter {tuple(t.shape)}")
        t.copy_(v)


class AdamW:
    """optax.adamw's update: ``-lr(count) * (m_hat / (sqrt(v_hat) + eps) +
    wd * p)``."""

    def __init__(self, params: Sequence[torch.Tensor],
                 lr: Callable[[int], float], *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def state_dict(self, names: Sequence[str]) -> dict:
        return {"mu": dict(zip(names, self.mu)),
                "nu": dict(zip(names, self.nu)), "count": self.count}

    def load_state_dict(self, state: dict, names: Sequence[str]) -> None:
        _copy_named(self.mu, state["mu"], names)
        _copy_named(self.nu, state["nu"], names)
        self.count = int(state["count"])

    def updates(self, grads, params) -> List[torch.Tensor]:
        b1, b2 = self.b1, self.b2
        lr = self.lr(self.count)
        self.count += 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        mu_hat = torch._foreach_div(self.mu, 1 - b1 ** self.count)
        den = torch._foreach_sqrt(torch._foreach_div(
            self.nu, 1 - b2 ** self.count))
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(mu_hat, den)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(params,
                                                      self.weight_decay))
        torch._foreach_mul_(u, -lr)
        return u


class Lars:
    """LARS (reference util/lars.py, the JAX package's ``lars``): each
    matrix's gradient plus ``weight_decay * p``, scaled by ``trust * |p| /
    |g + wd p|`` (1 where either norm is 0); 1-D parameters skip both; then
    SGD momentum (optax.trace) and ``-lr``.  ``lr`` is a float."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, *,
                 weight_decay: float = 0.0, momentum: float = 0.9,
                 trust_coefficient: float = 0.001):
        if callable(lr):
            raise ValueError("Lars takes a float lr")
        self.lr, self.weight_decay = lr, weight_decay
        self.momentum, self.trust = momentum, trust_coefficient
        self.trace = [torch.zeros_like(p) for p in params]

    def state_dict(self, names: Sequence[str]) -> dict:
        return {"trace": dict(zip(names, self.trace))}

    def load_state_dict(self, state: dict, names: Sequence[str]) -> None:
        _copy_named(self.trace, state["trace"], names)

    def updates(self, grads, params) -> List[torch.Tensor]:
        out = []
        for g, p, t in zip(grads, params, self.trace):
            if p.ndim > 1:
                g = g + self.weight_decay * p
                pn, gn = torch.linalg.vector_norm(p), torch.linalg.vector_norm(g)
                ratio = torch.where((pn > 0) & (gn > 0),
                                    self.trust * pn / gn, 1.0)
                g = g * ratio
            t.mul_(self.momentum).add_(g)
            out.append(-self.lr * t)
        return out


class Optimizer:
    """The chain on ``named`` (trainable name, parameter) pairs: optional
    global-norm clip, ``rule`` (AdamW or Lars), optional layer-decay
    multipliers, optionally accumulated over ``accum_iter`` calls."""

    def __init__(self, named: Named, rule, *,
                 clip_grad: Optional[float] = None,
                 layer_scales: Optional[Dict[str, float]] = None,
                 accum_iter: int = 1):
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.rule = rule
        self.clip_grad = clip_grad
        self.scales = (None if layer_scales is None
                       else [layer_scales[n] for n in self.names])
        self.accum_iter = accum_iter
        self.mini_step = 0
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if accum_iter > 1 else None)

    @property
    def count(self) -> int:
        """Applied updates so far (the rule's count; LARS keeps none)."""
        return getattr(self.rule, "count", 0)

    def state_dict(self) -> dict:
        """The state as tensors keyed by parameter name (shared with the
        optimizer, not copied: ``torch.save`` it)."""
        return {"rule": self.rule.state_dict(self.names),
                "acc": (None if self.acc is None
                        else dict(zip(self.names, self.acc))),
                "mini_step": self.mini_step}

    def load_state_dict(self, state: dict) -> None:
        self.rule.load_state_dict(state["rule"], self.names)
        if (state["acc"] is None) != (self.acc is None):
            raise ValueError("the saved optimizer and this one differ in "
                             "accum_iter (accumulation buffer)")
        if self.acc is not None:
            _copy_named(self.acc, state["acc"], self.names)
        self.mini_step = int(state["mini_step"])

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> bool:
        """Take one call's gradients (one per parameter, in order); returns
        whether the parameters were updated."""
        grads = list(grads)
        if self.acc is not None:
            n = self.mini_step
            torch._foreach_add_(self.acc, torch._foreach_div(
                torch._foreach_sub(grads, self.acc), n + 1))
            if n < self.accum_iter - 1:
                self.mini_step += 1
                return False
            grads, self.mini_step = self.acc, 0
        if self.clip_grad is not None:
            norm = global_norm(grads)
            keep = norm < self.clip_grad
            grads = [torch.where(keep, g, g / norm * self.clip_grad)
                     for g in grads]
        updates = self.rule.updates(grads, self.params)
        if self.scales is not None:
            torch._foreach_mul_(updates, self.scales)
        torch._foreach_add_(self.params, updates)
        if self.acc is not None:
            self.acc = [torch.zeros_like(p) for p in self.params]
        return True


def make_optimizer(named: Named, base_lr: float, *, min_lr: float = 0.0,
                   epochs: float = 100, warmup_epochs: float = 20,
                   steps_per_epoch: int = 1, weight_decay: float = 0.01,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   clip_grad: Optional[float] = None,
                   layer_decay: Optional[float] = None,
                   num_layers: int = 12, start_step: int = 0,
                   accum_iter: int = 1) -> Optimizer:
    """AdamW on the warmup-cosine schedule, as the JAX package's
    ``make_optimizer`` (+ ``with_grad_accumulation``).  ``start_step``
    fast-forwards the schedule (a run started at a later epoch without a
    resume), as the reference computes the lr from the absolute epoch."""
    base = warmup_cosine_schedule(base_lr, min_lr, epochs, warmup_epochs,
                                  steps_per_epoch)
    rule = AdamW([p for _, p in named],
                 lambda step: base(step + start_step), b1=betas[0],
                 b2=betas[1], eps=1e-8, weight_decay=weight_decay)
    scales = (None if layer_decay is None else layerwise_lr_decay_scales(
        [n for n, _ in named], num_layers=num_layers,
        decay_rate=layer_decay))
    return Optimizer(named, rule, clip_grad=clip_grad, layer_scales=scales,
                     accum_iter=accum_iter)
