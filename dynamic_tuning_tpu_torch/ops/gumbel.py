"""Gumbel-sigmoid gate (counterpart of dynamic_tuning_tpu/ops/gumbel.py).

* eval: ``sigmoid(logits)``, no noise, no temperature;
* train: ``sigmoid((logits + noise) / tau)`` where ``noise`` is one
  Logistic(0, 1) draw per logit -- the difference of two Gumbel(0, 1) draws,
  as in the JAX package.  The noise is either given (``noise=``, so a test can
  feed both frameworks the same numbers) or drawn from an explicit
  ``torch.Generator``; global RNG state is never used;
* ``hard=True``: straight-through -- the forward value is
  ``1[y_soft > threshold]``, the gradient is the soft one.
"""

from __future__ import annotations

import torch


def logistic_noise(shape, generator: torch.Generator, *,
                   dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
    """Logistic(0, 1) samples: log(u) - log(1 - u), u ~ U(0, 1)."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    tiny = torch.finfo(dtype).tiny
    u = u.clamp(tiny, 1.0 - torch.finfo(dtype).eps)
    return torch.log(u) - torch.log1p(-u)


def gumbel_sigmoid(logits: torch.Tensor, *, tau: float = 1.0,
                   hard: bool = False, threshold: float = 0.5,
                   training: bool = True,
                   noise: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """Binary gate with the shape and dtype of ``logits``."""
    if training:
        if noise is None:
            if generator is None:
                raise ValueError("gumbel_sigmoid(training=True) needs noise= "
                                 "or generator=")
            noise = logistic_noise(logits.shape, generator,
                                   dtype=logits.dtype, device=logits.device)
        y_soft = torch.sigmoid((logits + noise) / tau)
    else:
        y_soft = torch.sigmoid(logits)
    if hard:
        y_hard = (y_soft > threshold).to(y_soft.dtype)
        return y_soft + (y_hard - y_soft).detach()
    return y_soft
