"""Serving-path attention sublayer and DyT prologue (counterpart of the main-
path part of dynamic_tuning_tpu/ops/mha_serving.py).

Three kernels, each a wrapper with its plain PyTorch version beside it:

* ``attention_sublayer_serving`` (TPU kernel K2):
  ``x + proj(core(qkv(LN(x))))`` -- the sublayer of the plain dense ViT;
* ``dyt_prologue_serving`` (TPU kernel K3): K2's ``x_mid`` plus the parallel
  adapter ``up(relu(down(x_mid))) * scale`` and the fp32 router logits
  ``x_mid @ wsel + bsel`` -- every DyT block;
* ``dyt_prologue_serving_moe`` (TPU kernel K7): K2's ``x_mid`` plus the
  MoE-enhanced adapter (E experts blended per token by a softmax router) and
  the router logits -- every DyT block with ``moe_experts > 1``.

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
  with fp32 ``wsel``; logits come for all N rows (the caller strips CLS);
* the MoE mixture (``moe_adapter_rows`` of the TPU kernels): expert gates
  ``softmax((x_mid @ wr) * fp32(1/tau))`` with the row max subtracted; the
  experts' bottleneck ``relu(bf16(x_mid) @ down + bd)`` stays fp32 through
  the gate multiply and is rounded once; the up bias enters as the fp32
  ``gates @ up_bias``, added before ``* scale``.

Where a sum decides a rounding that later steps amplify (the attention
core's scores, ``l`` and AV; every product of the MoE tail; its router and
token-router dots), the plain versions sum in float64 and round once.  The
MoE tail kernel adds each tensor-core step's product with a round-to-nearest
add and sums its dots in float64, so it lands near those exact sums and the
bf16 roundings downstream mostly agree.
"""

from __future__ import annotations

import torch

from dynamic_tuning_tpu_torch.ops import _build

LN_EPS = 1e-6
SMEM_PER_BLOCK = 232448          # H100: 227 KB of dynamic shared memory


# --- plain versions ----------------------------------------------------------

def layernorm_f32(xf: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor) -> torch.Tensor:
    """fp32 LayerNorm over the last axis, as the TPU kernels compute it.

    The two means (of x, then of the fp32 squares of x - mean) are summed
    in float64 and divided by C before one rounding to fp32: the result
    does not depend on the order of the sum, so the int8 LN kernel, which
    sums the same way, gives the same LN bit for bit -- and the same int8
    codes downstream."""
    C = xf.shape[-1]
    mu = (xf.double().sum(dim=-1, keepdim=True) / C).float()
    xc = xf - mu
    var = ((xc * xc).double().sum(dim=-1, keepdim=True) / C).float()
    return xc * torch.rsqrt(var + LN_EPS) * gamma + beta


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T with the operands' values (already in the compute dtype) and
    fp32 accumulation -- the tensor-core contract, for any operand dtype."""
    return torch.matmul(a.float(), w.float().t())


def _mm64(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T (batched over leading axes) with the operands' values,
    summed in float64 and rounded once to fp32: the exact sum, whatever
    order a kernel sums in."""
    return torch.matmul(a.double(), w.double().transpose(-1, -2)).float()


def attn_core_pairs(qkv: torch.Tensor, *, heads: int) -> torch.Tensor:
    """Serving attention core on raw qkv ``[B, N, 3C]`` (columns
    ``[q|k|v] x head x hd``) -> ``[B, N, C]`` in qkv's dtype.  Scores, l and
    the AV products are summed in float64 and rounded once to fp32."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // heads
    dtype = qkv.dtype
    q, k, v = qkv.reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q = (q.float() * hd ** -0.5).to(dtype)
    s = _mm64(q, k)
    e = torch.exp(s.clamp(-60.0, 80.0) - 20.0)
    l = e.double().sum(dim=-1, keepdim=True).float()
    o = _mm64(e.to(dtype), v.transpose(-1, -2)) * (1.0 / l)
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
    return adapter_router_plain(xm, x.dtype, wdown, bdown, wup, bup,
                                adapter_scale, wsel, bsel,
                                with_select=with_select)


def adapter_router_plain(xm, out_dtype, wdown, bdown, wup, bup, adapter_scale,
                         wsel, bsel, *, with_select: bool):
    """The prologue's tail on the fp32 x_mid ``xm``: (x_mid, adapt[,
    logits]) with x_mid and adapt in ``out_dtype``."""
    dtype = wdown.dtype
    down = torch.clamp_min(_mm(xm.to(dtype), wdown) + bdown, 0.0).to(dtype)
    adapt = ((_mm(down, wup) + bup) * adapter_scale).to(out_dtype)
    if not with_select:
        return xm.to(out_dtype), adapt
    logits = torch.matmul(xm, wsel.float().reshape(-1, 1)) + bsel
    return xm.to(out_dtype), adapt, logits


def moe_kernel_weights(down_kernel, down_bias, up_kernel, dtype):
    """The expert stacks in the layout of the MoE tail: (wdown2d [E*b, C]
    in ``dtype``, row e*b+j = down_kernel[e, :, j]; bdown2d fp32 [E*b];
    wup2d [C, E*b] in ``dtype``) from down_kernel [E, C, b], down_bias
    [E, b] and up_kernel [E, b, C]."""
    E, C, b = down_kernel.shape
    wdown2d = down_kernel.transpose(1, 2).reshape(E * b, C)
    wup2d = up_kernel.reshape(E * b, C).t()
    return (wdown2d.to(dtype).contiguous(),
            down_bias.reshape(E * b).float().contiguous(),
            wup2d.to(dtype).contiguous())


def moe_adapter_router_plain(xm, out_dtype, wrouter, wdown2d, bdown2d, wup2d,
                             bup, adapter_scale, wsel, bsel, *, experts: int,
                             bneck: int, tau: float, with_select: bool):
    """The MoE prologue's tail on the fp32 x_mid ``xm``: (x_mid, adapt[,
    logits]) with x_mid and adapt in ``out_dtype``.  wrouter [E, C] fp32,
    wdown2d [E*b, C] and wup2d [C, E*b] in the compute dtype, bdown2d [E*b]
    and bup [E, C] fp32 (``moe_kernel_weights``)."""
    if tuple(wrouter.shape[:1]) + tuple(wdown2d.shape[:1]) != (
            experts, experts * bneck):
        raise ValueError(f"wrouter {tuple(wrouter.shape)} and wdown2d "
                         f"{tuple(wdown2d.shape)} do not hold {experts} "
                         f"experts of width {bneck}")
    # the router dots summed in float64 and rounded once, as the kernel
    # does; 1/tau as an fp32 multiplier, as the TPU kernel scales them
    r = _mm64(xm, wrouter) * torch.tensor(1.0 / tau, dtype=torch.float32)
    eg = torch.exp(r - r.amax(dim=-1, keepdim=True))
    gates = eg / eg.sum(dim=-1, keepdim=True)                   # [.., E]
    h = torch.clamp_min(_mm64(xm.to(wdown2d.dtype), wdown2d) + bdown2d, 0.0)
    hg = (h * gates.repeat_interleave(bneck, dim=-1)).to(wup2d.dtype)
    up = _mm64(hg, wup2d)
    upb = _mm64(gates, bup.t())                                 # gates . Bu
    adapt = ((up + upb) * adapter_scale).to(out_dtype)
    if not with_select:
        return xm.to(out_dtype), adapt
    return xm.to(out_dtype), adapt, _mm64(xm, wsel) + bsel


def _moe_dims(wrouter, wdown2d):
    E = wrouter.shape[0]
    return E, wdown2d.shape[0] // E


def dyt_prologue_moe_plain(x, gamma, beta, wqkv, bqkv, wproj, bproj, wrouter,
                           wdown2d, bdown2d, wup2d, bup, adapter_scale, wsel,
                           bsel, *, heads: int, tau: float,
                           with_select: bool = True):
    """Plain version of K7: (x_mid, adapt, logits [B, N, 1] fp32), or
    (x_mid, adapt) without the router."""
    xm = _sublayer_f32(x, gamma, beta, wqkv, bqkv, wproj, bproj, heads)
    E, b = _moe_dims(wrouter, wdown2d)
    return moe_adapter_router_plain(
        xm, x.dtype, wrouter, wdown2d, bdown2d, wup2d, bup, adapter_scale,
        wsel, bsel, experts=E, bneck=b, tau=tau, with_select=with_select)


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
    check_adapter_router(lib, x, wdown, bdown, wup, bup, adapter_scale, wsel,
                         bsel, with_select)
    with torch.cuda.device(x.device):
        xm32 = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        x_mid = _launch_sublayer(lib, x, gamma, beta, wqkv, bqkv, wproj,
                                 bproj, heads, xm32)
        outs = launch_adapter_router(lib, x_mid, xm32, wdown, bdown, wup, bup,
                                     adapter_scale, wsel, bsel, with_select)
    dyt_prologue_serving.launches += 1
    return outs


dyt_prologue_serving.launches = 0


def check_adapter_router(lib, x, wdown, bdown, wup, bup, adapter_scale, wsel,
                         bsel, with_select: bool) -> None:
    """Raise on adapter/router arguments the CUDA kernel does not take."""
    C = x.shape[-1]
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


def launch_adapter_router(lib, x_mid, xm32, wdown, bdown, wup, bup,
                          adapter_scale, wsel, bsel, with_select: bool):
    """The adapter/router kernel on the fp32 copy ``xm32`` of ``x_mid``:
    (x_mid, adapt[, logits])."""
    B, N, C = x_mid.shape
    dev = x_mid.device
    adapt = torch.empty_like(x_mid)
    logits = (torch.empty((B, N, 1), dtype=torch.float32, device=dev)
              if with_select else None)
    err = lib.dyt_adapter_router(
        _ptr(xm32), B * N, C, _ptr(wdown), _ptr(bdown), _ptr(wup),
        _ptr(bup), _ptr(adapter_scale),
        _ptr(wsel) if with_select else None,
        _ptr(bsel) if with_select else None, _ptr(adapt),
        int(x_mid.dtype == torch.float32), _ptr(logits), wdown.shape[0],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "adapter/router kernel")
    return (x_mid, adapt, logits) if with_select else (x_mid, adapt)


def dyt_prologue_serving_moe(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                             wrouter, wdown2d, bdown2d, wup2d, bup,
                             adapter_scale, wsel, bsel, *, heads: int,
                             tau: float, with_select: bool = True):
    """K7: (x_mid, adapt, logits [B, N, 1] fp32), or (x_mid, adapt) when
    ``with_select`` is False (wsel and bsel unused).

    Sublayer weights as for ``dyt_prologue_serving``; the experts as
    ``moe_kernel_weights`` lays them out (wdown2d [E*b, C], wup2d [C, E*b]
    in the compute dtype), wrouter [E, C], bdown2d [E*b], bup [E, C],
    adapter_scale [1], wsel [1, C] and bsel [1] fp32."""
    if x.device.type == "cpu":
        return dyt_prologue_moe_plain(
            x, gamma, beta, wqkv, bqkv, wproj, bproj, wrouter, wdown2d,
            bdown2d, wup2d, bup, adapter_scale, wsel, bsel, heads=heads,
            tau=tau, with_select=with_select)
    lib = _check_sublayer(x, gamma, beta, wqkv, bqkv, wproj, bproj, heads)
    check_moe_adapter_router(lib, x, wrouter, wdown2d, bdown2d, wup2d, bup,
                             adapter_scale, wsel, bsel, with_select)
    with torch.cuda.device(x.device):
        xm32 = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        x_mid = _launch_sublayer(lib, x, gamma, beta, wqkv, bqkv, wproj,
                                 bproj, heads, xm32)
        outs = launch_moe_adapter_router(
            lib, x_mid, xm32, wrouter, wdown2d, bdown2d, wup2d, bup,
            adapter_scale, wsel, bsel, tau, with_select)
    dyt_prologue_serving_moe.launches += 1
    return outs


dyt_prologue_serving_moe.launches = 0


def check_moe_adapter_router(lib, x, wrouter, wdown2d, bdown2d, wup2d, bup,
                             adapter_scale, wsel, bsel,
                             with_select: bool) -> None:
    """Raise on MoE adapter/router arguments the CUDA kernel does not take."""
    C = x.shape[-1]
    if wrouter.dim() != 2 or wdown2d.dim() != 2:
        raise ValueError("wrouter and wdown2d must be 2-D")
    E, W = wrouter.shape[0], wdown2d.shape[0]
    if E < 2 or W % E or not lib.dyt_moe_width_supported(E, W // E):
        raise ValueError(f"MoE width {E} experts x {W / E:g} not supported "
                         "(E >= 2, E*b a multiple of 16 and at most 512)")
    dev, f32 = x.device, (torch.float32,)
    _require(wrouter, "wrouter", (E, C), f32, dev)
    _require(wdown2d, "wdown2d", (W, C), (torch.bfloat16,), dev)
    _require(wup2d, "wup2d", (C, W), (torch.bfloat16,), dev)
    _require(bdown2d, "bdown2d", (W,), f32, dev)
    _require(bup, "bup", (E, C), f32, dev)
    _require(adapter_scale, "adapter_scale", (1,), f32, dev)
    if with_select:
        _require(wsel, "wsel", (1, C), f32, dev)
        _require(bsel, "bsel", (1,), f32, dev)
    if C % 64:
        raise ValueError(f"C={C} must be a multiple of 64")
    smem = lib.dyt_moe_smem_bytes(E, W // E)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"MoE kernel at {E} experts x {W // E} needs {smem} "
                         f"B of shared memory per block (limit "
                         f"{SMEM_PER_BLOCK})")


def launch_moe_adapter_router(lib, x_mid, xm32, wrouter, wdown2d, bdown2d,
                              wup2d, bup, adapter_scale, wsel, bsel,
                              tau: float, with_select: bool):
    """The MoE adapter/router kernel on the fp32 copy ``xm32`` of
    ``x_mid``: (x_mid, adapt[, logits])."""
    B, N, C = x_mid.shape
    dev = x_mid.device
    E, b = _moe_dims(wrouter, wdown2d)
    adapt = torch.empty_like(x_mid)
    logits = (torch.empty((B, N, 1), dtype=torch.float32, device=dev)
              if with_select else None)
    err = lib.dyt_moe_adapter_router(
        _ptr(xm32), B * N, C, _ptr(wrouter), _ptr(wdown2d), _ptr(bdown2d),
        _ptr(wup2d), _ptr(bup), _ptr(adapter_scale),
        _ptr(wsel) if with_select else None,
        _ptr(bsel) if with_select else None, _ptr(adapt),
        int(x_mid.dtype == torch.float32), _ptr(logits), E, b, 1.0 / tau,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "MoE adapter/router kernel")
    return (x_mid, adapt, logits) if with_select else (x_mid, adapt)


def reset_launch_counts() -> None:
    attention_sublayer_serving.launches = 0
    dyt_prologue_serving.launches = 0
    dyt_prologue_serving_moe.launches = 0
