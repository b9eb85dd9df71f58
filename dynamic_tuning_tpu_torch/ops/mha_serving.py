"""Serving-path attention sublayer and DyT prologue (counterpart of the main-
path part of dynamic_tuning_tpu/ops/mha_serving.py).

Two kernels, each a wrapper with its plain PyTorch version beside it:

* ``attention_sublayer_serving`` (TPU kernel K2):
  ``x + proj(core(qkv(LN(x))))`` -- the sublayer of the plain dense ViT;
* ``dyt_prologue_serving`` (TPU kernel K3): K2's ``x_mid`` plus the parallel
  adapter ``up(relu(down(x_mid))) * scale`` and the fp32 router logits
  ``x_mid @ wsel + bsel`` -- every DyT block.

A wrapper given CPU tensors computes the plain version.  Given CUDA tensors it
launches the hand-written kernels of ``csrc/`` (built by ``_build`` on first
use) or raises: on an unsupported shape, dtype or layout, or on a failed build
or launch.  There is no other path.  Each launch adds one to the wrapper's
``launches`` count.

Weights are in torch's ``[out, in]`` layout; the kernels want them in the
compute dtype (bf16), cast once by the caller.  The numerics follow the TPU
kernels, not the unfused XLA branch of the JAX Attention module:

* LN in fp32, eps 1e-6: mean, then the mean of the centred squares;
* qkv rounded to the compute dtype after the fp32 bias add;
* q scaled in fp32 and rounded before QK^T;
* ``e = exp(clip(s, -60, 80) - 20)`` in fp32 with no row max, ``l`` the sum
  of the fp32 ``e``; AV uses the rounded ``e`` with fp32 accumulation, times
  ``1 / l``, then one rounding;
* the adapter reads the rounded fp32 ``x_mid``, the router the fp32 ``x_mid``
  with fp32 ``wsel``; logits come for all N rows (the caller strips CLS).
"""

from __future__ import annotations

import torch

from dynamic_tuning_tpu_torch.ops import _build

LN_EPS = 1e-6
SMEM_PER_BLOCK = 232448          # H100: 227 KB of dynamic shared memory


# --- plain versions ----------------------------------------------------------

def layernorm_f32(xf: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor) -> torch.Tensor:
    """fp32 LayerNorm over the last axis, as the TPU kernels compute it."""
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + LN_EPS) * gamma + beta


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T with the operands' values (already in the compute dtype) and
    fp32 accumulation -- the tensor-core contract, for any operand dtype."""
    return torch.matmul(a.float(), w.float().t())


def attn_core_pairs(qkv: torch.Tensor, *, heads: int) -> torch.Tensor:
    """Serving attention core on raw qkv ``[B, N, 3C]`` (columns
    ``[q|k|v] x head x hd``) -> ``[B, N, C]`` in qkv's dtype."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // heads
    dtype = qkv.dtype
    q, k, v = qkv.reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q = (q.float() * hd ** -0.5).to(dtype)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    e = torch.exp(s.clamp(-60.0, 80.0) - 20.0)
    l = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e.to(dtype).float(), v.float()) * (1.0 / l)
    return o.to(dtype).transpose(1, 2).reshape(B, N, C)


def _sublayer_f32(x, gamma, beta, wqkv, bqkv, wproj, bproj, heads):
    """fp32 x_mid = x + proj(core(qkv(LN(x)))) + b."""
    dtype = wqkv.dtype
    xf = x.float()
    ln = layernorm_f32(xf, gamma, beta).to(dtype)
    qkv = (_mm(ln, wqkv) + bqkv).to(dtype)
    out = attn_core_pairs(qkv, heads=heads)
    return xf + _mm(out, wproj) + bproj


def attention_sublayer_plain(x, gamma, beta, wqkv, bqkv, wproj, bproj, *,
                             heads: int) -> torch.Tensor:
    """Plain version of K2: x [B, N, C] -> x_mid in x's dtype."""
    return _sublayer_f32(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                         heads).to(x.dtype)


def dyt_prologue_plain(x, gamma, beta, wqkv, bqkv, wproj, bproj, wdown,
                       bdown, wup, bup, adapter_scale, wsel, bsel, *,
                       heads: int, with_select: bool = True):
    """Plain version of K3: (x_mid, adapt, logits [B, N, 1] fp32), or
    (x_mid, adapt) without the router."""
    xm = _sublayer_f32(x, gamma, beta, wqkv, bqkv, wproj, bproj, heads)
    dtype = wdown.dtype
    down = torch.clamp_min(_mm(xm.to(dtype), wdown) + bdown, 0.0).to(dtype)
    adapt = ((_mm(down, wup) + bup) * adapter_scale).to(x.dtype)
    if not with_select:
        return xm.to(x.dtype), adapt
    logits = torch.matmul(xm, wsel.float().reshape(-1, 1)) + bsel
    return xm.to(x.dtype), adapt, logits


# --- CUDA wrappers -----------------------------------------------------------

def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _require(t: torch.Tensor, name: str, shape, dtypes, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"want {tuple(shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} is {t.dtype}, want one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_sublayer(x, gamma, beta, wqkv, bqkv, wproj, bproj, heads):
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}: the kernels take CPU tensors "
                         "(plain version) or CUDA tensors")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, C], got {tuple(x.shape)}")
    B, N, C = x.shape
    dev = x.device
    f32, bf = (torch.float32,), (torch.bfloat16,)
    _require(x, "x", (B, N, C), (torch.float32, torch.bfloat16), dev)
    for name, t, shape in (("gamma", gamma, (C,)), ("beta", beta, (C,)),
                           ("bqkv", bqkv, (3 * C,)), ("bproj", bproj, (C,))):
        _require(t, name, shape, f32, dev)
    _require(wqkv, "wqkv", (3 * C, C), bf, dev)
    _require(wproj, "wproj", (C, C), bf, dev)
    if C % heads:
        raise ValueError(f"C={C} is not a multiple of heads={heads}")
    hd = C // heads
    lib = _build.library()
    smem = lib.dyt_attn_core_smem_bytes(N, hd)
    if smem == 0:
        raise ValueError(f"head_dim {hd} not supported (64 or 128)")
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"N={N}, head_dim={hd} needs {smem} B of shared "
                         f"memory per block (limit {SMEM_PER_BLOCK})")
    return lib


def _launch_sublayer(lib, x, gamma, beta, wqkv, bqkv, wproj, bproj, heads,
                     xm32):
    B, N, C = x.shape
    M = B * N
    out = torch.empty_like(x)
    ln_buf = torch.empty((M, C), dtype=torch.bfloat16, device=x.device)
    qkv_buf = torch.empty((M, 3 * C), dtype=torch.bfloat16, device=x.device)
    attn_buf = torch.empty((M, C), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.dyt_attention_sublayer(
        _ptr(x), int(x.dtype == torch.float32), _ptr(gamma), _ptr(beta),
        _ptr(wqkv), _ptr(bqkv), _ptr(wproj), _ptr(bproj), _ptr(out),
        _ptr(xm32), _ptr(ln_buf), _ptr(qkv_buf), _ptr(attn_buf), B, N, C,
        heads, (C // heads) ** -0.5, stream)
    _build.check(lib, err, "attention sublayer kernels")
    return out


def attention_sublayer_serving(x, gamma, beta, wqkv, bqkv, wproj, bproj, *,
                               heads: int) -> torch.Tensor:
    """K2: x [B, N, C] (bf16 or fp32) -> x + proj(core(qkv(LN(x)))).

    gamma/beta/bqkv/bproj fp32; wqkv [3C, C] and wproj [C, C] in the compute
    dtype (bf16 on CUDA)."""
    if x.device.type == "cpu":
        return attention_sublayer_plain(x, gamma, beta, wqkv, bqkv, wproj,
                                        bproj, heads=heads)
    lib = _check_sublayer(x, gamma, beta, wqkv, bqkv, wproj, bproj, heads)
    with torch.cuda.device(x.device):
        out = _launch_sublayer(lib, x, gamma, beta, wqkv, bqkv, wproj, bproj,
                               heads, None)
    attention_sublayer_serving.launches += 1
    return out


attention_sublayer_serving.launches = 0


def dyt_prologue_serving(x, gamma, beta, wqkv, bqkv, wproj, bproj, wdown,
                         bdown, wup, bup, adapter_scale, wsel, bsel, *,
                         heads: int, with_select: bool = True):
    """K3: (x_mid, adapt, logits [B, N, 1] fp32), or (x_mid, adapt) when
    ``with_select`` is False (teacher / dense mode; wsel and bsel unused).

    wdown [F, C] and wup [C, F] in the compute dtype; bdown [F], bup [C],
    adapter_scale [1], wsel [1, C] and bsel [1] fp32."""
    if x.device.type == "cpu":
        return dyt_prologue_plain(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                                  wdown, bdown, wup, bup, adapter_scale, wsel,
                                  bsel, heads=heads, with_select=with_select)
    lib = _check_sublayer(x, gamma, beta, wqkv, bqkv, wproj, bproj, heads)
    B, N, C = x.shape
    F = wdown.shape[0]
    dev, f32 = x.device, (torch.float32,)
    _require(wdown, "wdown", (F, C), (torch.bfloat16,), dev)
    _require(wup, "wup", (C, F), (torch.bfloat16,), dev)
    _require(bdown, "bdown", (F,), f32, dev)
    _require(bup, "bup", (C,), f32, dev)
    _require(adapter_scale, "adapter_scale", (1,), f32, dev)
    if with_select:
        _require(wsel, "wsel", (1, C), f32, dev)
        _require(bsel, "bsel", (1,), f32, dev)
    if not lib.dyt_adapter_width_supported(F):
        raise ValueError(f"adapter width {F} not supported "
                         "(16, 32, 48, 64, 96 or 128)")
    if C % 64:
        raise ValueError(f"C={C} must be a multiple of 64")
    with torch.cuda.device(dev):
        xm32 = torch.empty((B, N, C), dtype=torch.float32, device=dev)
        x_mid = _launch_sublayer(lib, x, gamma, beta, wqkv, bqkv, wproj,
                                 bproj, heads, xm32)
        adapt = torch.empty_like(x)
        logits = (torch.empty((B, N, 1), dtype=torch.float32, device=dev)
                  if with_select else None)
        err = lib.dyt_adapter_router(
            _ptr(xm32), B * N, C, _ptr(wdown), _ptr(bdown), _ptr(wup),
            _ptr(bup), _ptr(adapter_scale),
            _ptr(wsel) if with_select else None,
            _ptr(bsel) if with_select else None, _ptr(adapt),
            int(x.dtype == torch.float32), _ptr(logits), F,
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, err, "adapter/router kernel")
    dyt_prologue_serving.launches += 1
    return (x_mid, adapt, logits) if with_select else (x_mid, adapt)


dyt_prologue_serving.launches = 0


def reset_launch_counts() -> None:
    attention_sublayer_serving.launches = 0
    dyt_prologue_serving.launches = 0
