"""Capacity-bounded token dispatch (counterpart of
dynamic_tuning_tpu/ops/dispatch.py).

Each block runs its MLP on only the K = ``capacity_for(T, ratio)`` tokens
with the highest router scores (CLS forced in with a +inf score); slots whose
score is at or below the threshold contribute zero.  The JAX package writes
the gather and scatter as one-hot matmuls for the TPU's matrix unit; here
they are index gathers and scatters, with the same result.

Selection order matters at the capacity boundary: saturated sigmoids give
exact ties, and which of the tied tokens fill the last slots decides which
tokens run the MLP.  ``jax.lax.top_k`` keeps the lower index first; a stable
descending sort does the same on every device, while ``torch.topk`` on CUDA
promises no order among ties.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch


def capacity_for(num_tokens: int, ratio: float) -> int:
    """Static per-block capacity: ceil(ratio * T) + 1 for CLS, clamped to the
    sequence length T + 1 (K = 99 at T = 196, ratio 0.5)."""
    return min(math.ceil(ratio * num_tokens) + 1, num_tokens + 1)


def select_topk(scores: torch.Tensor, capacity: int, threshold: float = 0.5
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``capacity`` token indices per example, ties to the lower index.

    scores: [B, N] keep-probabilities (CLS already +inf).  Returns
    (idx [B, K] int64, keep [B, K] bool) where keep drops slots whose score
    is at or below ``threshold``."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :capacity], idx[:, :capacity]
    return idx, vals > threshold


def gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, C], idx [B, K] -> [B, K, C]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def scatter_tokens(template: torch.Tensor, idx: torch.Tensor,
                   values: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Masked ``values`` [B, K, C] into a zeros-like of ``template`` at
    ``idx`` (indices are unique per row, so the scatter is exact)."""
    values = (values * keep[..., None].to(values.dtype)).to(template.dtype)
    out = torch.zeros_like(template)
    return out.scatter_(1, idx[..., None].expand(-1, -1, template.shape[-1]),
                        values)


def dispatch_mlp(x: torch.Tensor, scores: torch.Tensor, capacity: int,
                 mlp_fn: Callable[[torch.Tensor], torch.Tensor],
                 threshold: float = 0.5
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``mlp_fn`` on the top-``capacity`` rows of ``x`` only.

    The semantics of ``onehot_dispatch_mlp``: returns (contribution [B, N, C]
    in x's dtype, zero at skipped tokens; effective gate [B, N] in x's dtype,
    1 where the MLP output was kept)."""
    idx, keep = select_topk(scores, capacity, threshold)
    yg = mlp_fn(gather_tokens(x, idx))
    out = scatter_tokens(x, idx, yg, keep)
    gate = torch.zeros(scores.shape, dtype=x.dtype, device=x.device)
    gate.scatter_(1, idx, keep.to(x.dtype))
    return out, gate
