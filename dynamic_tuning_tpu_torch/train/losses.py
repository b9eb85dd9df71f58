"""Loss functions (counterpart of dynamic_tuning_tpu/train/losses.py):
AdaLoss (cross-entropy plus the FLOPs-budget loss) and self-distillation.

Reference behaviour:
  * AdaLoss           models/losses.py:15-84
      loss = CE + token_loss_ratio * token_loss
      token_loss = (mean(token_select) - target)^2
                   + minimal_weight * sum(clamp(minimal - per_token_mean, 0))
  * self-distillation engine_finetune.py:47-65
      kl  = KL(log_softmax(student) || log_softmax(teacher.detach()),
               batchmean, log_target=True)
      total = AdaLoss + CE(teacher, y) + kl

All reductions run in fp32.  Only the teacher's log-probabilities inside
the KL are detached: the teacher's own cross-entropy back-propagates.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from dynamic_tuning_tpu_torch.config import SelectConfig


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None].long())[:, 0].mean()


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


def ada_loss(logits: torch.Tensor, labels: torch.Tensor,
             token_select: Optional[torch.Tensor], cfg: SelectConfig
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Base CE + the weighted budget loss (losses.py:48-61)."""
    base = cross_entropy(logits, labels)
    tok = cfg.token_loss_ratio * token_budget_loss(token_select, cfg).to(
        base.device)
    return base + tok, dict(base_loss=base, token_loss=tok)


def distillation_kl(student_logits: torch.Tensor,
                    teacher_logits: torch.Tensor) -> torch.Tensor:
    """KL(student || teacher.detach()), batchmean with a log target
    (engine_finetune.py:52-57): ``sum(exp(lt) * (lt - ls)) / batch``."""
    ls = F.log_softmax(student_logits.float(), dim=-1)
    lt = F.log_softmax(teacher_logits.detach().float(), dim=-1)
    return (torch.exp(lt) * (lt - ls)).sum() / student_logits.shape[0]


def dyt_total_loss(student_logits: torch.Tensor,
                   teacher_logits: torch.Tensor, labels: torch.Tensor,
                   token_select: Optional[torch.Tensor], cfg: SelectConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The four-term DyT training loss (engine_finetune.py:47-65)."""
    loss, parts = ada_loss(student_logits, labels, token_select, cfg)
    teacher_loss = cross_entropy(teacher_logits, labels)
    kl = distillation_kl(student_logits, teacher_logits)
    parts.update(teacher_loss=teacher_loss, distillation_loss=kl)
    return loss + teacher_loss + kl, parts
