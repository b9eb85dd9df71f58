"""Analytic per-token FLOPs accounting (the port's copy of
dynamic_tuning_tpu/ops/flops.py; numpy only).

The reference builds a token-count -> GFLOPs lookup table by running fvcore on
a single block with the MLP truncated to the first t tokens
(block_flops_dict.py:33-83) and sums table lookups per sample in a Python
loop.  Everything fvcore measures there is matmul MACs, so we compute the
table in closed form (f(t) is affine in t) and vectorize the per-sample sum —
no tracing, no loops.

Convention: 1 MAC = 1 FLOP, matching fvcore and the reference's "17.6 GFLOPs
for ViT-B" denominator (engine_finetune.py:345).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

GIGA = 1e9


def attn_flops(T: int, dim: int) -> int:
    """qkv + scores + weighted-sum + proj for one attention over T tokens."""
    return 4 * T * dim * dim + 2 * T * T * dim


def mlp_flops_per_token(dim: int, mlp_ratio: float = 4.0) -> int:
    hidden = int(dim * mlp_ratio)
    return 2 * dim * hidden


def block_flops(T: int, t: int, dim: int = 768, mlp_ratio: float = 4.0,
                bottleneck: int = 64, with_router: bool = True,
                with_adapter: bool = True) -> int:
    """One DyT block: dense attention over T tokens, MLP over t kept tokens,
    router and adapter over all tokens (reference forward_count_flops,
    vision_transformer_IN21K.py:167-185)."""
    f = attn_flops(T, dim)
    if with_router:
        f += (T - 1) * dim
    if with_adapter:
        f += 2 * T * dim * bottleneck
    f += t * mlp_flops_per_token(dim, mlp_ratio)
    return f


def base_flops(num_classes: int, dim: int = 768, num_patches: int = 196,
               patch_size: int = 16, in_chans: int = 3) -> int:
    """Stem + head FLOPs (reference get_base_flops, block_flops_dict.py:209-227)."""
    conv = num_patches * dim * (in_chans * patch_size * patch_size)
    head = dim * num_classes
    return conv + head


def get_block_flops(T: int = 197, dim: int = 768, mlp_ratio: float = 4.0,
                    bottleneck: int = 64) -> Dict[int, float]:
    """token-count -> GFLOPs table (reference get_block_flops keys 1..T)."""
    return {t: block_flops(T, t, dim, mlp_ratio, bottleneck) / GIGA
            for t in range(T + 1)}


def dense_vit_flops(T: int = 197, depth: int = 12, dim: int = 768,
                    mlp_ratio: float = 4.0, num_classes: int = 1000) -> float:
    """Vanilla ViT (no adapter/router) GFLOPs — the 17.6 G denominator."""
    per_block = attn_flops(T, dim) + T * mlp_flops_per_token(dim, mlp_ratio)
    return (depth * per_block + base_flops(num_classes, dim, T - 1)) / GIGA


def batch_select_flops(token_select: np.ndarray, *, T: int = 197,
                       dim: int = 768, mlp_ratio: float = 4.0,
                       bottleneck: int = 64, num_classes: int = 1000,
                       keep_layers: int = 0, depth: int = 12) -> np.ndarray:
    """Per-sample GFLOPs from the gate stack (reference batch_select_flops,
    block_flops_dict.py:74-83 — vectorized; +1 per routed block for the
    always-on CLS token).

    token_select: [B, L_routed, T-1, 1] binary gates (CLS stripped).
    Returns [B] GFLOPs.
    """
    ts = np.asarray(token_select)
    if keep_layers and depth - ts.shape[1] != keep_layers:
        raise ValueError(
            f"gate stack has {ts.shape[1]} routed layers but depth "
            f"{depth} - keep_layers {keep_layers} expects "
            f"{depth - keep_layers}")
    counts = ts.reshape(ts.shape[0], ts.shape[1], -1).sum(-1) + 1  # +CLS
    fixed_routed = block_flops(T, 0, dim, mlp_ratio, bottleneck)
    per_tok = mlp_flops_per_token(dim, mlp_ratio)
    routed = fixed_routed * ts.shape[1] + per_tok * counts.sum(-1)
    unrouted = (depth - ts.shape[1]) * block_flops(
        T, T, dim, mlp_ratio, bottleneck, with_router=False)
    return (routed + unrouted + base_flops(num_classes, dim, T - 1)) / GIGA
