"""Mixup / CutMix on the device (counterpart of
dynamic_tuning_tpu/data/mixup.py).

The reference's train loops expose a ``mixup_fn`` hook that every recipe
leaves None (engine_finetune.py:44: timm's Mixup imported, never enabled);
as in the JAX package, this function makes the hook real and no runner
calls it.

The batch mixes with its reversal ``images[::-1]``.  Under the JAX
package's mesh the batch is the global one, so the flip partner of global
row g is row B - 1 - g, which may lie on another process; this function
mixes the batch it is given, so a caller under a process group gives it the
global batch to get the JAX package's pairs.

Randomness: the draws (``MixupDraws``) come from an explicit
``torch.Generator`` (``sample_draws``) or are given, so a test can pass the
JAX function's own.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class MixupDraws(NamedTuple):
    """One batch's draws: the mixup weight ``lam``, the branch
    ``use_cutmix``, the CutMix area draw ``lam_c`` and the box centre
    (``cy``, ``cx``)."""

    lam: float
    use_cutmix: bool
    lam_c: float
    cy: int
    cx: int


def sample_draws(generator: torch.Generator, height: int, width: int, *,
                 alpha: float = 0.8, cutmix_alpha: float = 1.0
                 ) -> MixupDraws:
    """The draws of one batch from ``generator``: one 63-bit seed drawn
    from it feeds numpy's Beta sampler (torch's takes no generator)."""
    seed = int(torch.randint(0, 2 ** 63 - 1, (1,), generator=generator))
    rs = np.random.default_rng(seed)
    return MixupDraws(lam=float(np.float32(rs.beta(alpha, alpha))),
                      use_cutmix=bool(rs.random() < 0.5),
                      lam_c=float(np.float32(rs.beta(cutmix_alpha,
                                                     cutmix_alpha))),
                      cy=int(rs.integers(0, height)),
                      cx=int(rs.integers(0, width)))


def mixup_cutmix(images: torch.Tensor, labels: torch.Tensor, *,
                 num_classes: int, alpha: float = 0.8,
                 cutmix_alpha: float = 1.0, smoothing: float = 0.1,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[MixupDraws] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mix the batch with its reversal: mixup or CutMix, one branch a batch.

    images [B, H, W, C] float, labels [B] int -> the mixed images and
    [B, num_classes] soft labels (label smoothing ``smoothing``).  The draws
    come from ``draws`` or else from ``generator``."""
    B, H, W, _ = images.shape
    if draws is None:
        if generator is None:
            raise ValueError("mixup_cutmix needs generator= or draws= (no "
                             "global RNG is used)")
        draws = sample_draws(generator, H, W, alpha=alpha,
                             cutmix_alpha=cutmix_alpha)
    dev, f32 = images.device, torch.float32
    flipped = images.flip(0)
    lam = torch.tensor(draws.lam, dtype=f32, device=dev)
    if draws.use_cutmix:
        cut = torch.sqrt(1.0 - torch.tensor(draws.lam_c, dtype=f32))
        ch, cw = int(cut * H), int(cut * W)
        y0 = min(max(draws.cy - ch // 2, 0), H)
        x0 = min(max(draws.cx - cw // 2, 0), W)
        y1 = min(max(draws.cy + ch // 2, 0), H)
        x1 = min(max(draws.cx + cw // 2, 0), W)
        out = images.clone()
        out[:, y0:y1, x0:x1] = flipped[:, y0:y1, x0:x1]
        lam = 1.0 - torch.tensor((y1 - y0) * (x1 - x0), dtype=f32,
                                 device=dev) / (H * W)
    else:
        out = lam * images + (1 - lam) * flipped
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    y1h = F.one_hot(labels.long(), num_classes).to(f32) * (on - off) + off
    y2h = (F.one_hot(labels.flip(0).long(), num_classes).to(f32)
           * (on - off) + off)
    return out, lam * y1h + (1 - lam) * y2h


def soft_cross_entropy(logits: torch.Tensor,
                       soft_labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy against soft labels."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -(soft_labels * logp).sum(-1).mean()
