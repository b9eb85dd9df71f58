"""Max-subtracted softmax attention (counterpart of
dynamic_tuning_tpu/ops/flash_attention.py, TPU kernel K13).

``flash_attention(q, k, v, bias=None)``: ``softmax(q k^T / sqrt(D) + bias)
v`` on ``[B, H, N, D]`` q, k, v with an optional fp32 ``[H, N, N]`` bias
shared over the batch, returned ``[B, H, N, D]`` in q's dtype.  The numerics
are the TPU kernel's, not its fp32 oracle's: q, k, v rounded to bf16, fp32
scores times the scale (then the bias), the row max subtracted, ``p =
bf16(exp(s - m) / l)`` normalised before its rounding, fp32 accumulation of
``p @ v``.  The TPU kernel pads N to 128 and masks the padded keys; here
keys past N are never visited, and the output is never padded.

Given CPU tensors the wrapper computes the plain version
(``flash_attention_plain``); given CUDA tensors it launches the kernel of
``csrc/softmax_attention.cu`` (``dyt_mha_softmax``: score rows in registers
for N <= 256, in a shared-memory slab up to ~1.3k, recomputed beyond) or
raises.  ``attention_reference`` is the JAX package's fp32 oracle;
``ulp_share`` is the check that holds a kernel to this contract.
"""

from __future__ import annotations

import torch

from dynamic_tuning_tpu_torch.ops import _build
from dynamic_tuning_tpu_torch.ops.mha_serving import _mm64, _ptr


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K13 (and, on split heads, of K14).  Scores, ``l``
    and the AV products are summed in float64 and rounded once to fp32."""
    bf = torch.bfloat16
    s = _mm64(q.to(bf), k.to(bf)) * q.shape[-1] ** -0.5
    if bias is not None:
        s = s + bias.float()
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.double().sum(dim=-1, keepdim=True).float()).to(bf)
    return _mm64(p, v.to(bf).transpose(-1, -2)).to(q.dtype)


# Share of outputs a kernel must hold within one bf16 ulp of the plain
# version's own value (``ulp_share``).  The plain version against itself
# with fp32 sums scores 0.9998-1.0; one that rounds exp(s - m) to bf16
# before dividing by l (p rounded twice) 0.73-0.93 on the same inputs.
ULP_SHARE = 0.99


def ulp_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """The share of elements of ``got`` within one bf16 ulp of ``want``'s
    own magnitude (``2**(floor(log2 |want|) - 7)``).  Sums taken in another
    order move an output by less; p rounded at another point moves a large
    share of them by more."""
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
                     - 7)
    return ((got.float() - w).abs() <= ulp).float().mean().item()


def attention_reference(q, k, v, bias=None) -> torch.Tensor:
    """fp32 oracle: ``softmax(q k^T / sqrt(D) + bias) v`` with no bf16
    rounding, in q's dtype."""
    s = torch.matmul(q.float() * q.shape[-1] ** -0.5,
                     k.float().transpose(-1, -2))
    if bias is not None:
        s = s + bias.float()
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def launch_softmax(q, k, v, out, bias=None) -> None:
    """The softmax-attention kernel on q, k, v ``[B, H, N, hd]`` (fp32 or
    bf16, the same for all four) into ``out``; each must have unit stride
    along hd and rows on 16 bytes.  Shared with K14."""
    B, H, N, hd = q.shape
    if hd not in (64, 128):
        raise ValueError(f"head_dim {hd} not supported (64 or 128)")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.dtype != q.dtype or t.dtype not in (torch.float32,
                                                 torch.bfloat16):
            raise TypeError(f"{name} is {t.dtype}: q, k, v must share one "
                            "dtype, float32 or bfloat16")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        align = 16 // t.element_size()
        if (t.stride(-1) != 1 or any(st % align for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} (strides {t.stride()}) must have unit "
                             "stride along hd and rows on 16 bytes")
    if bias is not None:
        if tuple(bias.shape) != (H, N, N) or bias.device != q.device:
            raise ValueError(f"bias has shape {tuple(bias.shape)} on "
                             f"{bias.device}, want {(H, N, N)} on {q.device}")
        if bias.dtype != torch.float32:
            raise TypeError(f"bias is {bias.dtype}, want torch.float32")
        if bias.stride(-1) != 1:
            raise ValueError("bias must have unit column stride")
        if bias.data_ptr() % 16:
            # the kernel copies bias rows in 16-byte chunks from their
            # start rounded down, which must stay inside the tensor
            bias = bias.clone()
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.dyt_mha_softmax(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out),
            _build.strides_arg(q, k, v, out), _ptr(bias),
            0 if bias is None else bias.stride(0),
            0 if bias is None else bias.stride(1), B, N, H, hd, hd ** -0.5,
            int(q.dtype == torch.float32),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, err, "softmax attention kernel")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """K13: q, k, v ``[B, H, N, D]`` (+ bias ``[H, N, N]``) -> ``[B, H, N,
    D]`` in q's dtype.  On CUDA: fp32 or bf16 q, k, v of one dtype (fp32 is
    rounded to bf16 as it is read), head_dim 64 or 128, rows on 16 bytes; an
    fp32 bias with unit column stride."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"q is on {q.device}: the kernels take CPU tensors "
                         "(plain version) or CUDA tensors")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [B, H, N, D] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    launch_softmax(q, k, v, out, bias)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def reset_launch_counts() -> None:
    flash_attention.launches = 0
