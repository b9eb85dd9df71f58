"""Max-subtracted softmax attention on the raw qkv buffer (counterpart of
dynamic_tuning_tpu/ops/packed_attention.py, TPU kernel K14).

``packed_attention(qkv, num_heads=H)``: the fused projection output
``[B, N, 3C]`` (columns ``[q|k|v] x head x hd``) -> ``[B, N, C]`` in qkv's
dtype, with K13's numerics per head (``ops/flash_attention.py``).  The TPU
kernel packs 4 heads into one block-diagonal matmul pair and pads N to 256:
answers to the TPU's matrix unit that the H100 port drops, keeping the
contract they set (``num_heads % 4 == 0``, ``N <= 256``), which raises
ValueError on every device.

Given CPU tensors the wrapper computes the plain version; given CUDA tensors
it launches K13's kernel (``csrc/softmax_attention.cu``, its register-resident
form: N <= 256) on strided views of the buffer, writing ``[B, N, C]``
directly, or raises.
"""

from __future__ import annotations

import torch

from dynamic_tuning_tpu_torch.ops import flash_attention as fa

G = 4          # the TPU kernel's heads per packed group
NP = 256       # the TPU kernel's padded sequence length


def _split(qkv: torch.Tensor, num_heads: int):
    """q, k, v ``[B, H, N, hd]`` views of a raw ``[B, N, 3C]`` buffer."""
    B, N, C3 = qkv.shape
    return qkv.view(B, N, 3, num_heads, C3 // 3 // num_heads).permute(
        2, 0, 3, 1, 4)


def packed_attention_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of K14: K13's plain version per head."""
    B, N, C3 = qkv.shape
    out = fa.flash_attention_plain(*_split(qkv, num_heads))
    return out.transpose(1, 2).reshape(B, N, C3 // 3)


def packed_attention_reference(qkv: torch.Tensor,
                               num_heads: int) -> torch.Tensor:
    """fp32 oracle (no bf16 rounding), in qkv's dtype."""
    B, N, C3 = qkv.shape
    out = fa.attention_reference(*_split(qkv, num_heads))
    return out.transpose(1, 2).reshape(B, N, C3 // 3)


def packed_attention(qkv: torch.Tensor, *, num_heads: int) -> torch.Tensor:
    """K14: qkv ``[B, N, 3C]`` -> ``[B, N, C]`` in qkv's dtype.  Requires
    ``num_heads % 4 == 0`` and ``N <= 256``; on CUDA qkv must be fp32 or
    bf16 and contiguous, head_dim 64 or 128."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be [B, N, 3C] with C a multiple of "
                         f"num_heads={num_heads}, got {tuple(qkv.shape)}")
    B, N, C3 = qkv.shape
    if num_heads % G:
        raise ValueError(f"num_heads={num_heads} must be divisible by {G}")
    if N > NP:
        raise ValueError(f"N={N} tokens: the kernel takes N <= {NP}")
    if qkv.device.type == "cpu":
        return packed_attention_plain(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"qkv is on {qkv.device}: the kernels take CPU "
                         "tensors (plain version) or CUDA tensors")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    out = torch.empty((B, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    hd = C3 // 3 // num_heads
    fa.launch_softmax(*_split(qkv, num_heads), out.view(
        B, N, num_heads, hd).transpose(1, 2))
    packed_attention.launches += 1
    return out


packed_attention.launches = 0


def reset_launch_counts() -> None:
    packed_attention.launches = 0
