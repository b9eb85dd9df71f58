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

Under a process group every reduction is over the global batch, as the JAX
package's mean over a batch sharded on its mesh: the means and sums go
through ``parallel.mesh.global_mean``/``global_sum`` and divide by the
global count.  The budget term ``(mean(gates) - target)^2`` is not linear
in the batch, so averaging per-rank gradients (``DistributedDataParallel``)
would give ``mean_r 2(m_r - t) grad m_r`` where the global batch gives
``2(m - t) mean_r grad m_r``; through the global mean it gives the latter.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from dynamic_tuning_tpu_torch.config import SelectConfig
from dynamic_tuning_tpu_torch.parallel.mesh import (global_mean, global_sum,
                                                    process_count)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels (over the global
    batch)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return global_mean(-logp.gather(-1, labels[:, None].long())[:, 0])


def token_budget_loss(token_select: Optional[torch.Tensor],
                      cfg: SelectConfig, global_batch: bool = True
                      ) -> torch.Tensor:
    """The FLOPs-budget loss on gate activations (reference
    models/losses.py:63-84): ``(mean(gates) - target)^2`` plus, with
    ``token_minimal_weight``, the clamped shortfall of each (sample, layer)
    keep rate below ``token_minimal``; over the global batch, or with
    ``global_batch=False`` over this rank's rows (an eval forward, which
    runs no collective).

    token_select: [B, L, T, 1] gate values (CLS already stripped)."""
    if token_select is None:
        return torch.zeros((), dtype=torch.float32)
    mean, total = ((global_mean, global_sum) if global_batch
                   else (torch.mean, lambda t: t))
    ts = token_select.float()
    loss = (mean(ts) - cfg.token_target_ratio) ** 2
    if cfg.token_minimal_weight > 0:
        per_layer_rate = ts.mean(dim=(2, 3))
        minimal = total(torch.clamp_min(
            cfg.token_minimal - per_layer_rate, 0.0).sum())
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
    (engine_finetune.py:52-57): ``sum(exp(lt) * (lt - ls)) / batch``, the
    global batch's."""
    ls = F.log_softmax(student_logits.float(), dim=-1)
    lt = F.log_softmax(teacher_logits.detach().float(), dim=-1)
    return (global_sum((torch.exp(lt) * (lt - ls)).sum())
            / (student_logits.shape[0] * process_count()))


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
