"""Loss functions the serving slices need (counterpart of part of
dynamic_tuning_tpu/train/losses.py): the FLOPs-budget loss, which the
segmentation backbone returns beside its features."""

from __future__ import annotations

from typing import Optional

import torch

from dynamic_tuning_tpu_torch.config import SelectConfig


def token_budget_loss(token_select: Optional[torch.Tensor],
                      cfg: SelectConfig) -> torch.Tensor:
    """The FLOPs-budget loss on gate activations (reference
    models/losses.py:63-84): ``(mean(gates) - target)^2`` plus, with
    ``token_minimal_weight``, the clamped shortfall of each (sample, layer)
    keep rate below ``token_minimal``.

    token_select: [B, L, T, 1] gate values (CLS already stripped)."""
    if token_select is None:
        return torch.zeros((), dtype=torch.float32)
    ts = token_select.float()
    loss = (ts.mean() - cfg.token_target_ratio) ** 2
    if cfg.token_minimal_weight > 0:
        per_layer_rate = ts.mean(dim=(2, 3))
        minimal = torch.clamp_min(cfg.token_minimal - per_layer_rate,
                                  0.0).sum()
        loss = loss + cfg.token_minimal_weight * minimal
    return loss
