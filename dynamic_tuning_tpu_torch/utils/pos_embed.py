"""Position-embedding grid interpolation (counterpart of
dynamic_tuning_tpu/utils/pos_embed.py::interpolate_pos_embed; reference
util/pos_embed.py:106-127).

A checkpoint's learnable pos-embed for one patch grid (224^2 / 16 = 14x14 for
IN21K ViT-B/16) is resized bicubically to another (512^2 crops: 32x32) when
it is loaded.  The JAX package reproduces torch's ``F.interpolate(
mode="bicubic", align_corners=False)``; here it is that call, in float64.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def interpolate_pos_embed(pos_embed, new_num_patches: int,
                          num_prefix_tokens: int = 1) -> np.ndarray:
    """Resize a [1, T_old, D] pos-embed (numpy array or tensor) to a square
    grid of ``new_num_patches`` patches; the prefix (CLS) rows pass
    through.  Returns a numpy array of the input's dtype."""
    pe = (pos_embed.detach().cpu().numpy()
          if isinstance(pos_embed, torch.Tensor) else np.asarray(pos_embed))
    _, t_old, dim = pe.shape
    old_patches = t_old - num_prefix_tokens
    if old_patches == new_num_patches:
        return pe
    gs_old = int(round(old_patches ** 0.5))
    gs_new = int(round(new_num_patches ** 0.5))
    grid = torch.from_numpy(pe[:, num_prefix_tokens:].astype(np.float64))
    grid = grid.reshape(1, gs_old, gs_old, dim).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gs_new, gs_new), mode="bicubic",
                         align_corners=False)
    grid = grid.permute(0, 2, 3, 1).reshape(1, gs_new * gs_new, dim)
    return np.concatenate([pe[:, :num_prefix_tokens],
                           grid.numpy().astype(pe.dtype)], axis=1)
