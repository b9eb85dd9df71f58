"""Fused LayerNorm + MLP (counterpart of dynamic_tuning_tpu/ops/fused_mlp.py,
TPU kernel K11): ``out = gate * fc2(gelu(fc1(LN(x))))`` on token rows.

The speed-test forward (``models/fast_inference.py``) runs it once per block
with ``use_kernel=True``.  A wrapper given CPU tensors computes the plain
version ``ln_mlp_plain``; given CUDA tensors it launches the kernels of
``csrc/fused_mlp.cu`` or raises.  There is no other path.  Each launch adds
one to ``fused_ln_mlp.launches``.

The rounding points are the TPU kernel's (not those of its jnp oracle
``ln_mlp_reference``):

* LN in fp32, eps 1e-6 (mean, then the mean of the centred squares), then
  the fp32 affine; ``xn`` rounded once to bf16;
* fc1 with fp32 accumulation, + b1 in fp32; GELU in fp32, the A&S erf of
  the TPU kernels or the tanh form; ``h`` rounded once to bf16;
* fc2 with fp32 accumulation, + b2; times the row's gate in fp32 when there
  is one; one rounding to x's dtype.

Weights come in torch's ``[out, in]`` layout: w1 ``[H, C]`` and w2 ``[C, H]``
in bf16, cast once per model load by the caller; LN scale and bias, b1 and
b2 fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

from dynamic_tuning_tpu_torch.ops import _build
from dynamic_tuning_tpu_torch.ops import mha_serving as ms
from dynamic_tuning_tpu_torch.ops.mha_serving import _ptr, _require
from dynamic_tuning_tpu_torch.ops.quant import gelu_f32

BF, F32 = torch.bfloat16, torch.float32


def ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, gate=None, *,
                 gelu_approx: bool = False) -> torch.Tensor:
    """Plain version of K11: x [M, C] -> [M, C] in x's dtype; gate [M, 1]
    or None."""
    xn = ms.layernorm_f32(x.float(), ln_scale, ln_bias).to(BF)
    h = gelu_f32(ms._mm(xn, w1) + b1, gelu_approx)
    y = ms._mm(h.to(BF), w2) + b2
    if gate is not None:
        y = y * gate.float()
    return y.to(x.dtype)


def fused_ln_mlp(x: torch.Tensor, ln_scale: torch.Tensor,
                 ln_bias: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor,
                 gate: Optional[torch.Tensor] = None, *,
                 gelu_approx: bool = False) -> torch.Tensor:
    """K11: x [M, C] (bf16 or fp32) -> ``gate * fc2(gelu(fc1(LN(x))))`` in
    x's dtype; gate [M, 1] (any float dtype) or None."""
    if x.device.type == "cpu":
        return ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, gate,
                            gelu_approx=gelu_approx)
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}: the kernels take CPU tensors "
                         "(plain version) or CUDA tensors")
    if x.dim() != 2:
        raise ValueError(f"x must be [M, C], got {tuple(x.shape)}")
    M, C = x.shape
    H = w1.shape[0]
    dev = x.device
    _require(x, "x", (M, C), (F32, BF), dev)
    for name, t, shape in (("ln_scale", ln_scale, (C,)),
                           ("ln_bias", ln_bias, (C,)), ("b1", b1, (H,)),
                           ("b2", b2, (C,))):
        _require(t, name, shape, (F32,), dev)
    _require(w1, "w1", (H, C), (BF,), dev)
    _require(w2, "w2", (C, H), (BF,), dev)
    if C % 8 or H % 8:
        raise ValueError(f"C={C} and H={H} must be multiples of 8")
    if w1.data_ptr() % 16 or w2.data_ptr() % 16:
        raise ValueError("w1 and w2 must start on 16 bytes")
    if gate is not None:
        if tuple(gate.shape) != (M, 1) or gate.device != dev:
            raise ValueError(f"gate has shape {tuple(gate.shape)} on "
                             f"{gate.device}, want {(M, 1)} on {dev}")
        gate = gate.reshape(M).to(F32).contiguous()
    lib = _build.library()
    with torch.cuda.device(dev):
        out = torch.empty_like(x)
        if M == 0:
            return out
        ln_buf = torch.empty((M, C), dtype=BF, device=dev)
        h_buf = torch.empty((M, H), dtype=BF, device=dev)
        err = lib.dyt_fused_ln_mlp(
            _ptr(x), int(x.dtype == F32), _ptr(ln_scale), _ptr(ln_bias),
            _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), _ptr(gate), _ptr(out),
            _ptr(ln_buf), _ptr(h_buf), M, C, H, int(gelu_approx),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, err, "fused LN+MLP kernels")
    fused_ln_mlp.launches += 1
    return out


fused_ln_mlp.launches = 0


def reset_launch_counts() -> None:
    fused_ln_mlp.launches = 0
