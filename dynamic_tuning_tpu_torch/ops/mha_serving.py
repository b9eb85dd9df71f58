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
  the router logits -- every DyT block with ``moe_experts > 1``;
* ``mha_windowed_fused`` (TPU kernel K9): the attention core on raw qkv
  with an additive ``[H, N, N]`` relative-position bias, rounded to bf16 --
  the windowed attention of every segmentation-backbone block;
* ``mha_serving_fused`` (TPU kernel K1): the core alone on raw qkv -- the
  ``Attention`` of a block that does not fuse its sublayer (LayerScale or
  BEiT q/v biases) at N <= 512 with no window;
* ``mha_serving`` (TPU kernel K15): the core on pre-split ``[B, H, N, hd]``
  q, k, v with the rounding of the unfused XLA branch (the scale rounded to
  q's dtype before ``q * scale``, ``l`` summed over the rounded ``p``, a
  true division by ``l``) -- the attention of the speed-test forward.

A wrapper given CPU tensors computes the plain version.  Given CUDA tensors it
launches the hand-written kernels of ``csrc/`` (built by ``_build`` on first
use) or raises: on an unsupported shape, dtype or layout, or on a failed build
or launch.  There is no other path.  Each launch adds one to the wrapper's
``launches`` count and one to ``forms[form]``, the form it took (``form_of``):
"bf16" (the wgmma kernels), "fp32" (fp32 weights or qkv: the fp32 GEMM of
``csrc/gemm_f32.cuh``, the register-tiled fp32 core of
``csrc/f32_core.cu``, the float64 DMMA tail of ``csrc/f64_tail.cu``; in
K6 and K8 the exact core of ``csrc/exact_core.cu``),
"fp32+q8_exact" (fp32 K10, and K6/K8 with fp32 adapters and int8 scores,
on the exact core's int8-score mode: IMMA scores, DMMA P V),
"bf16+wide_heads" (bf16 at head dims 192 and 256 on the wgmma kernels),
"bf16+past_256" and "fp32+past_256" (past head dim 256, up to 768, on the
wgmma core and the fp32 core that take hd at run time), "bf16+q8_ring"
(bf16 K10, and K5/K6/K8 with int8 scores, on ``csrc/q8_ring.cu``'s wgmma
key ring: past head dim 256 up to 768, and at head dims 64 to 256 past the
N whose codes and V fit the staged int8-score core), "bf16+simt_core"
(bf16 past head dim 768: the SIMT core, which walks any head dim in
64-column slices), "+wide_tail" (a bf16 adapter past width 128 on the
MoE tail's wgmma kernel, gate-free) and "+simt_tail" (a bf16 adapter or MoE
tail at a width the wgmma tails do not take, on the SIMT tail).
``core_of`` is the one table of which attention core each wrapper runs;
each wrapper calls the entry of that core, and the one C entry with a
choice of cores (the int8 chain's) follows the route the wrapper passes
it.

Weights are in torch's ``[out, in]`` layout, in the compute dtype (bf16 or
fp32), cast once by the caller; the form follows their dtype, as the JAX
kernels run their products in the weights' dtype.  The numerics follow the
TPU kernels, not the unfused XLA branch of the JAX Attention module:

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
token-router dots; in fp32 the adapter's products, router dots and the
expert gates' sum too),
the plain versions sum in float64 and round once.  The
MoE tail kernel adds each tensor-core step's product with a round-to-nearest
add and sums its dots in float64, so it lands near those exact sums and the
bf16 roundings downstream mostly agree.
"""

from __future__ import annotations

import torch

from dynamic_tuning_tpu_torch.ops import _build

LN_EPS = 1e-6
SMEM_PER_BLOCK = 232448          # H100: 227 KB of dynamic shared memory
BF, F32 = torch.bfloat16, torch.float32
Q8_MAX_HD = 256                  # K10's staged int8-score wgmma core's
#                                  largest head dim; past it the key ring
WIDE_MAX_HD = 768                # the wgmma and fp32 cores' largest head
#                                  dim (csrc's XW_MAX_HD, FX_MAX_HD); past it
#                                  every core is the SIMT core's
AR_WIDTHS = (16, 32, 48, 64, 96, 128)    # the wgmma adapter/router kernel's F
#                                  (csrc's dyt_adapter_width_supported)
MOE_MAX_W = 1024                 # the wgmma MoE tail's largest E * b, and
#                                  the largest bf16 adapter width it takes
#                                  gate-free
EXACT_MAX_HD = 256               # the DMMA exact core's largest head dim
#                                  (exact_core.cu); past it the SIMT slices
#                                  kernel's exact form


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


def attn_core_pairs(qkv: torch.Tensor, *, heads: int,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """Serving attention core on raw qkv ``[B, N, 3C]`` (columns
    ``[q|k|v] x head x hd``) -> ``[B, N, C]`` in qkv's dtype.  Scores, l and
    the AV products are summed in float64 and rounded once to fp32; an
    fp32 ``bias`` ``[H, N, N]`` is added to the fp32 scores."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // heads
    dtype = qkv.dtype
    q, k, v = qkv.reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q = (q.float() * hd ** -0.5).to(dtype)
    s = _mm64(q, k)
    if bias is not None:
        s = s + bias
    e = torch.exp(s.clamp(-60.0, 80.0) - 20.0)
    l = e.double().sum(dim=-1, keepdim=True).float()
    o = _mm64(e.to(dtype), v.transpose(-1, -2)) * (1.0 / l)
    return o.to(dtype).transpose(1, 2).reshape(B, N, C)


def mha_windowed_plain(qkv: torch.Tensor, bias: torch.Tensor, *,
                       heads: int) -> torch.Tensor:
    """Plain version of K9: qkv ``[B, N, 3C]`` and bias ``[H, N, N]`` ->
    ``[B, N, C]`` in qkv's dtype.  The bias is rounded to bf16 whatever its
    dtype (the TPU kernel takes it in bf16, even in an fp32 model), then
    added to the fp32 scores."""
    return attn_core_pairs(qkv, heads=heads,
                           bias=bias.to(torch.bfloat16).float())


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
    logits]) with x_mid and adapt in ``out_dtype``.  With fp32 weights the
    two products and the router dots are summed in float64 and rounded
    once (no bf16 rounding absorbs a sum's order there, and in K6 an int8
    quantization of the next block amplifies it)."""
    dtype = wdown.dtype
    mm = _mm64 if dtype == F32 else _mm
    down = torch.clamp_min(mm(xm.to(dtype), wdown) + bdown, 0.0).to(dtype)
    adapt = ((mm(down, wup) + bup) * adapter_scale).to(out_dtype)
    if not with_select:
        return xm.to(out_dtype), adapt
    if dtype == F32:
        logits = _mm64(xm, wsel.reshape(1, -1)) + bsel
    else:
        logits = torch.matmul(xm, wsel.float().reshape(-1, 1)) + bsel
    return xm.to(out_dtype), adapt, logits


def adapter_kernel_width(F: int, dtype) -> int:
    """The width the kernels take a bf16 adapter of bottleneck ``F`` at: up
    to 128, the next width the wgmma adapter/router kernel is built for
    (``AR_WIDTHS``); past it up to ``MOE_MAX_W``, the next multiple of 16
    (the MoE tail's wgmma kernel, gate-free); past that, and in fp32, ``F``
    itself (the SIMT tail, and with fp32 weights the float64 tail, take any
    width)."""
    if dtype == BF and F <= AR_WIDTHS[-1]:
        return next(w for w in AR_WIDTHS if w >= F)
    if dtype == BF and F <= MOE_MAX_W:
        return -(-F // 16) * 16
    return F


def pad_adapter_weights(wdown, bdown, wup, width: int):
    """wdown [F, C], bdown [F] and wup [C, F] with zero rows, entries and
    columns up to ``width``.  Exact: a padded unit's bottleneck is
    relu(0 + 0) = 0, and its zero column of wup adds nothing to the up
    product."""
    pad = width - wdown.shape[0]
    if pad == 0:
        return wdown, bdown, wup
    return (torch.cat([wdown, wdown.new_zeros((pad, wdown.shape[1]))]),
            torch.cat([bdown, bdown.new_zeros((pad,))]),
            torch.cat([wup, wup.new_zeros((wup.shape[0], pad))], dim=1))


def moe_kernel_bneck(E: int, b: int, dtype) -> int:
    """The expert width the kernels take E bf16 experts of width ``b`` at:
    the least b' >= b with E * b' a multiple of 16, where E * b' <=
    ``MOE_MAX_W`` = 1024 (the wgmma MoE tail's domain); else ``b`` (the SIMT
    tail takes any E * b, and fp32 experts take the float64 tail at any
    width)."""
    if dtype != BF or E < 2:
        return b
    bp = b
    while (E * bp) % 16:
        bp += 1
    return bp if E * bp <= MOE_MAX_W else b


def moe_kernel_weights(down_kernel, down_bias, up_kernel, dtype):
    """The expert stacks in the layout of the MoE tail: (wdown2d [E*b, C]
    in ``dtype``, row e*b+j = down_kernel[e, :, j]; bdown2d fp32 [E*b];
    wup2d [C, E*b] in ``dtype``) from down_kernel [E, C, b], down_bias
    [E, b] and up_kernel [E, b, C], each expert zero-padded to
    ``moe_kernel_bneck`` (exact, as ``pad_adapter_weights``)."""
    E, C, b = down_kernel.shape
    bp = moe_kernel_bneck(E, b, dtype)
    if bp != b:
        down_kernel = torch.cat(
            [down_kernel, down_kernel.new_zeros((E, C, bp - b))], dim=2)
        down_bias = torch.cat([down_bias, down_bias.new_zeros((E, bp - b))],
                              dim=1)
        up_kernel = torch.cat(
            [up_kernel, up_kernel.new_zeros((E, bp - b, C))], dim=1)
        b = bp
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
    if wdown2d.dtype == F32:
        # the sum over the experts in float64, rounded once, as the float64
        # tail sums it: with fp32 experts no bf16 rounding absorbs its order
        gates = eg / eg.double().sum(dim=-1, keepdim=True).float()
    else:
        gates = eg / eg.sum(dim=-1, keepdim=True)               # [.., E]
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


def compute_dtype(*weights: torch.Tensor) -> torch.dtype:
    """The dtype of the weights, which picks the form: bf16 or fp32, the
    same for all of them."""
    dt = weights[0].dtype
    if dt not in (BF, F32) or any(w.dtype != dt for w in weights):
        raise TypeError("the weights must be all bf16 or all fp32, got "
                        f"{[w.dtype for w in weights]}")
    return dt


CORE_KERNELS = ("K1", "K2", "K3", "K5", "K6", "K7", "K8", "K9", "K10",
                "K15")


def core_of(kernel: str, dtype, hd: int, *, heads: int,
            attn_q8: bool = False, q8_fits: bool = True) -> str:
    """The attention core that a launch of ``kernel`` runs on operands
    (q, k, v) of ``dtype`` at head dim ``hd`` in ``heads`` heads: the
    wrappers route by this table alone and pass the route to the C entry
    points, which follow it.  The one place a head dim or head count is
    refused: the cores take every head dim the JAX package fuses ((2 hd) %
    128 == 0, on an even head count; K15, whose TPU kernel pairs no heads,
    on any head count) and raise ValueError on the rest, as its asserts do.

    * "wgmma": ``attention_sublayer.cu``'s core (staged, or its ring past
      the staged N; past head dim 256 ``attn_core_xwide_kernel``) -- bf16
      K1, K15 and the cores of K2, K3, K7 and of K5, K6, K8 without int8
      scores, at head dims up to ``WIDE_MAX_HD``;
    * "windowed": bf16 K9 up to ``WIDE_MAX_HD`` (``windowed_attention.cu``
      at 64 and 128, the wgmma cores with the bias blocks past 128);
    * "q8": ``quant.cu``'s staged int8-score wgmma core -- bf16 K10 (and
      K5, K6, K8 with ``attn_q8``) up to ``Q8_MAX_HD`` where its layout fits
      a block (``q8_fits``);
    * "q8_ring": ``q8_ring.cu``'s int8-score wgmma key ring -- bf16 K10
      (and K5, K6, K8 with ``attn_q8``) past the staged core's N at head dims
      64 to ``Q8_MAX_HD`` and past it up to ``WIDE_MAX_HD``;
    * "q8_exact": the exact core's int8-score mode (``exact_core.cu``: the
      codes' int32 scores on IMMA, P V in float64 on DMMA) -- fp32 K10
      (and K6, K8 with an fp32 qkv scratch and ``attn_q8``) up to
      ``EXACT_MAX_HD``;
    * "simt_q8": the SIMT core's int8-score form -- the rest of K10's: fp32
      qkv past ``EXACT_MAX_HD``, and bf16 past ``WIDE_MAX_HD``;
    * "f32": ``f32_core.cu``'s register-tiled fp32 cores -- fp32 K1, K9 and
      the cores of K2, K3, K7 up to ``WIDE_MAX_HD``;
    * "f32_exact": the exact core with float64 sums on DMMA
      (``exact_core.cu``) -- K6, K8 with an fp32 qkv scratch (fp32
      adapters), whose core output is requantized, up to ``EXACT_MAX_HD``;
    * "simt_exact": the same sums on ``simt_core.cu``'s slices kernel --
      K6, K8 with an fp32 qkv scratch past ``EXACT_MAX_HD``;
    * "simt": ``simt_core.cu`` in the operands' dtype -- every other core
      past ``WIDE_MAX_HD`` (K15 in its own rounding, K9 with its bias): the
      q tile and two stages of K of the wgmma and fp32 cores no longer fit
      a block's shared memory there.

    ``dtype`` is the core's: qkv's, the weights' for K2/K3/K7, the qkv
    scratch's for K5/K6/K8.  K15 takes bf16 only, and so does K5, whose
    scratch is bf16 whatever x's dtype (the TPU kernel's)."""
    if kernel not in CORE_KERNELS:
        raise ValueError(f"{kernel} runs no attention core")
    if hd <= 0 or (2 * hd) % 128:
        raise ValueError(f"head_dim {hd} not supported: (2 * head_dim) % "
                         "128 must be 0, as the JAX kernels ask")
    if heads % 2 and kernel != "K15":
        raise ValueError(f"{heads} heads not supported: the {kernel} core "
                         "takes pairs of heads, as the JAX kernels do")
    if dtype not in (BF, F32) or (kernel in ("K5", "K15") and dtype != BF):
        raise TypeError(f"{kernel} takes no {dtype} on the card")
    if kernel == "K10" or (attn_q8 and kernel in ("K5", "K6", "K8")):
        if dtype == F32:
            return "q8_exact" if hd <= EXACT_MAX_HD else "simt_q8"
        if hd > WIDE_MAX_HD:
            return "simt_q8"
        return "q8" if hd <= Q8_MAX_HD and q8_fits else "q8_ring"
    if dtype == F32 and kernel in ("K6", "K8"):
        return "f32_exact" if hd <= EXACT_MAX_HD else "simt_exact"
    if hd > WIDE_MAX_HD:
        return "simt"
    if kernel == "K9":
        return "f32" if dtype == F32 else "windowed"
    return "f32" if dtype == F32 else "wgmma"


def form_of(dtype, hd: int | None = None, tail: str = "",
            core: str = "wgmma") -> str:
    """The form a wrapper takes (its ``forms`` key): "fp32" ("fp32+past_256"
    on the fp32 core past head dim 256, "fp32+q8_exact" on the exact core's
    int8-score mode), or "bf16" with "+wide_heads" at head dims 192 and 256
    and "+past_256" past them on the wgmma cores ("+simt_core" where
    ``core`` is the SIMT core's past head dim 128, past ``WIDE_MAX_HD``;
    "+q8_ring" at any head dim where ``core`` is the int8-score key ring),
    then "+simt_tail" for a ``tail`` on the SIMT form ("simt") and
    "+wide_tail" for an adapter on the MoE tail's kernel ("wide")."""
    past = hd is not None and hd > 256
    if dtype == F32:
        if core == "q8_exact":
            return "fp32+q8_exact"
        return "fp32+past_256" if past and core == "f32" else "fp32"
    form = "bf16"
    if core == "q8_ring":
        form += "+q8_ring"
    elif core in ("simt", "simt_q8") and hd is not None and hd > 128:
        form += "+simt_core"
    elif past:
        form += "+past_256"
    elif hd is not None and hd > 128:
        form += "+wide_heads"
    return form + {"simt": "+simt_tail", "wide": "+wide_tail"}.get(tail, "")


def counted(fn, form: str) -> None:
    """One launch of wrapper ``fn`` in ``form``."""
    fn.launches += 1
    fn.forms[form] = fn.forms.get(form, 0) + 1


def _check_sublayer(x, gamma, beta, wqkv, bqkv, wproj, bproj, heads,
                    kernel):
    """Raise on sublayer arguments the kernels do not take; return the
    library and the core ``kernel`` runs (``core_of``)."""
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}: the kernels take CPU tensors "
                         "(plain version) or CUDA tensors")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, C], got {tuple(x.shape)}")
    B, N, C = x.shape
    dev = x.device
    f32 = (F32,)
    _require(x, "x", (B, N, C), (F32, BF), dev)
    for name, t, shape in (("gamma", gamma, (C,)), ("beta", beta, (C,)),
                           ("bqkv", bqkv, (3 * C,)), ("bproj", bproj, (C,))):
        _require(t, name, shape, f32, dev)
    wd = (compute_dtype(wqkv, wproj),)
    _require(wqkv, "wqkv", (3 * C, C), wd, dev)
    _require(wproj, "wproj", (C, C), wd, dev)
    if C % heads:
        raise ValueError(f"C={C} is not a multiple of heads={heads}")
    core = core_of(kernel, wd[0], C // heads, heads=heads)
    return _build.library(), core


def _launch_sublayer(lib, x, gamma, beta, wqkv, bqkv, wproj, bproj, heads,
                     xm32, core):
    """The sublayer chain in the weights' dtype: the bf16 chain of
    ``attention_sublayer.cu`` or the fp32 chain of ``simt_chain.cu``, its
    core the SIMT core where ``core`` says so (past ``WIDE_MAX_HD``)."""
    B, N, C = x.shape
    M = B * N
    out = torch.empty_like(x)
    dt = wqkv.dtype
    ln_buf = torch.empty((M, C), dtype=dt, device=x.device)
    qkv_buf = torch.empty((M, 3 * C), dtype=dt, device=x.device)
    attn_buf = torch.empty((M, C), dtype=dt, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (_ptr(x), int(x.dtype == F32), _ptr(gamma), _ptr(beta),
            _ptr(wqkv), _ptr(bqkv), _ptr(wproj), _ptr(bproj), _ptr(out),
            _ptr(xm32), _ptr(ln_buf), _ptr(qkv_buf), _ptr(attn_buf), B, N,
            C, heads, (C // heads) ** -0.5, int(core == "simt"), stream)
    if dt == F32:
        err = lib.dyt_attention_sublayer_f32(*args)
    else:
        err = lib.dyt_attention_sublayer(*args)
    _build.check(lib, err, "attention sublayer kernels")
    return out


def _xm32(x):
    """The fp32 copy of x_mid the tails read: none needed (None) when the
    residual is fp32 already, x_mid itself then."""
    if x.dtype == F32:
        return None
    return torch.empty(x.shape, dtype=F32, device=x.device)


def attention_sublayer_serving(x, gamma, beta, wqkv, bqkv, wproj, bproj, *,
                               heads: int) -> torch.Tensor:
    """K2: x [B, N, C] (bf16 or fp32) -> x + proj(core(qkv(LN(x)))).

    gamma/beta/bqkv/bproj fp32; wqkv [3C, C] and wproj [C, C] in the compute
    dtype (bf16 or fp32)."""
    if x.device.type == "cpu":
        return attention_sublayer_plain(x, gamma, beta, wqkv, bqkv, wproj,
                                        bproj, heads=heads)
    lib, core = _check_sublayer(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                                heads, "K2")
    with torch.cuda.device(x.device):
        out = _launch_sublayer(lib, x, gamma, beta, wqkv, bqkv, wproj, bproj,
                               heads, None, core)
    counted(attention_sublayer_serving,
            form_of(wqkv.dtype, x.shape[-1] // heads, core=core))
    return out


def dyt_prologue_serving(x, gamma, beta, wqkv, bqkv, wproj, bproj, wdown,
                         bdown, wup, bup, adapter_scale, wsel, bsel, *,
                         heads: int, with_select: bool = True):
    """K3: (x_mid, adapt, logits [B, N, 1] fp32), or (x_mid, adapt) when
    ``with_select`` is False (teacher / dense mode; wsel and bsel unused).

    wdown [F, C] and wup [C, F] in the compute dtype (that of wqkv); bdown
    [F], bup [C], adapter_scale [1], wsel [1, C] and bsel [1] fp32.  A bf16
    F of ``AR_WIDTHS`` takes the wgmma tail (``adapter_kernel_width`` pads
    the others up to one), a bf16 F past 128 up to ``MOE_MAX_W`` that is a
    multiple of 16 the MoE tail's wgmma kernel gate-free (padded likewise),
    any other bf16 F the SIMT tail, fp32 weights the float64 tail on
    DMMA."""
    if x.device.type == "cpu":
        return dyt_prologue_plain(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                                  wdown, bdown, wup, bup, adapter_scale, wsel,
                                  bsel, heads=heads, with_select=with_select)
    lib, core = _check_sublayer(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                                heads, "K3")
    check_adapter_router(lib, x, wdown, bdown, wup, bup, adapter_scale, wsel,
                         bsel, with_select)
    compute_dtype(wqkv, wdown)
    with torch.cuda.device(x.device):
        xm32 = _xm32(x)
        x_mid = _launch_sublayer(lib, x, gamma, beta, wqkv, bqkv, wproj,
                                 bproj, heads, xm32, core)
        outs = launch_adapter_router(lib, x_mid,
                                     x_mid if xm32 is None else xm32, wdown,
                                     bdown, wup, bup, adapter_scale, wsel,
                                     bsel, with_select)
    counted(dyt_prologue_serving,
            form_of(wqkv.dtype, x.shape[-1] // heads, _adapter_tail(wdown),
                    core))
    return outs


def _adapter_tail(wdown) -> str:
    """"f64" for fp32 weights (the float64 tail on DMMA), "wgmma" for a bf16
    adapter width the wgmma kernel is built for, "wide" for a bf16 width
    past it up to ``MOE_MAX_W``, a multiple of 16, at C % 64 == 0 (the MoE
    tail's wgmma kernel, gate-free), else "simt"."""
    if wdown.dtype == F32:
        return "f64"
    F, C = wdown.shape
    if F in AR_WIDTHS:
        return "wgmma"
    if AR_WIDTHS[-1] < F <= MOE_MAX_W and F % 16 == 0 and C % 64 == 0:
        return "wide"
    return "simt"


def check_adapter_router(lib, x, wdown, bdown, wup, bup, adapter_scale, wsel,
                         bsel, with_select: bool) -> None:
    """Raise on adapter/router arguments the CUDA kernels do not take."""
    C = x.shape[-1]
    F = wdown.shape[0]
    dev, f32 = x.device, (F32,)
    wd = (compute_dtype(wdown, wup),)
    _require(wdown, "wdown", (F, C), wd, dev)
    _require(wup, "wup", (C, F), wd, dev)
    _require(bdown, "bdown", (F,), f32, dev)
    _require(bup, "bup", (C,), f32, dev)
    _require(adapter_scale, "adapter_scale", (1,), f32, dev)
    if with_select:
        _require(wsel, "wsel", (1, C), f32, dev)
        _require(bsel, "bsel", (1,), f32, dev)
    tail = _adapter_tail(wdown)
    if tail == "wgmma" and C % 64:
        raise ValueError(f"C={C} must be a multiple of 64")
    if tail == "wide":
        for name, t in (("wdown", wdown), ("wup", wup), ("bup", bup),
                        ("wsel", wsel if with_select else None)):
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f"{name} must start on 16 bytes")


def launch_adapter_router(lib, x_mid, xm32, wdown, bdown, wup, bup,
                          adapter_scale, wsel, bsel, with_select: bool):
    """The adapter/router tail on the fp32 copy ``xm32`` of ``x_mid`` (the
    wgmma kernel for a bf16 width of ``AR_WIDTHS``, the MoE tail's wgmma
    kernel gate-free past it up to ``MOE_MAX_W``, the SIMT tail for other
    bf16 widths, the float64 DMMA tail for fp32 weights): (x_mid, adapt[,
    logits])."""
    B, N, C = x_mid.shape
    dev = x_mid.device
    F = wdown.shape[0]
    adapt = torch.empty_like(x_mid)
    logits = (torch.empty((B, N, 1), dtype=F32, device=dev)
              if with_select else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sel = ((_ptr(wsel), _ptr(bsel)) if with_select else (None, None))
    tail = _adapter_tail(wdown)
    args = (_ptr(xm32), B * N, C, None, _ptr(wdown), _ptr(bdown), _ptr(wup),
            _ptr(bup), _ptr(adapter_scale), *sel, _ptr(adapt),
            int(x_mid.dtype == F32), _ptr(logits), F, 0, 1, 1.0)
    if tail == "wgmma":
        err = lib.dyt_adapter_router(
            _ptr(xm32), B * N, C, _ptr(wdown), _ptr(bdown), _ptr(wup),
            _ptr(bup), _ptr(adapter_scale), *sel, _ptr(adapt),
            int(x_mid.dtype == F32), _ptr(logits), F, stream)
    elif tail == "wide":
        err = lib.dyt_moe_adapter_router(
            _ptr(xm32), B * N, C, None, _ptr(wdown), _ptr(bdown), _ptr(wup),
            _ptr(bup), _ptr(adapter_scale), *sel, _ptr(adapt),
            int(x_mid.dtype == F32), _ptr(logits), 1, F, 1.0, stream)
    else:
        fn = lib.dyt_tail_f64 if tail == "f64" else lib.dyt_tail_simt
        h = torch.empty((B * N, F), dtype=F32 if tail == "f64" else BF,
                        device=dev)
        err = fn(*args, _ptr(h), None, stream)
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
    adapter_scale [1], wsel [1, C] and bsel [1] fp32.  A bf16 E * b that is
    a multiple of 16 and at most ``MOE_MAX_W`` takes the wgmma tail
    (``moe_kernel_bneck`` pads the others up to one where it can), any other
    bf16 width the SIMT tail, fp32 experts the float64 tail on DMMA."""
    if x.device.type == "cpu":
        return dyt_prologue_moe_plain(
            x, gamma, beta, wqkv, bqkv, wproj, bproj, wrouter, wdown2d,
            bdown2d, wup2d, bup, adapter_scale, wsel, bsel, heads=heads,
            tau=tau, with_select=with_select)
    lib, core = _check_sublayer(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                                heads, "K7")
    tail = check_moe_adapter_router(lib, x, wrouter, wdown2d, bdown2d, wup2d,
                                    bup, adapter_scale, wsel, bsel,
                                    with_select)
    compute_dtype(wqkv, wdown2d)
    with torch.cuda.device(x.device):
        xm32 = _xm32(x)
        x_mid = _launch_sublayer(lib, x, gamma, beta, wqkv, bqkv, wproj,
                                 bproj, heads, xm32, core)
        outs = launch_moe_adapter_router(
            lib, x_mid, x_mid if xm32 is None else xm32, wrouter, wdown2d,
            bdown2d, wup2d, bup, adapter_scale, wsel, bsel, tau, with_select)
    counted(dyt_prologue_serving_moe,
            form_of(wqkv.dtype, x.shape[-1] // heads, tail, core))
    return outs


def _moe_tail(lib, E, W, C, wdown2d) -> str:
    """"f64" for fp32 experts (the float64 tail on DMMA); "wgmma" where the
    wgmma MoE tail takes the bf16 experts (E >= 2, E * b a multiple of 16
    and at most ``MOE_MAX_W``, C a multiple of 64, its layout within a
    block's shared memory), else "simt"."""
    if wdown2d.dtype == F32:
        return "f64"
    if (E >= 2 and W % E == 0 and C % 64 == 0
            and lib.dyt_moe_width_supported(E, W // E)
            and lib.dyt_moe_smem_bytes(E, W // E) <= SMEM_PER_BLOCK):
        return "wgmma"
    return "simt"


def check_moe_adapter_router(lib, x, wrouter, wdown2d, bdown2d, wup2d, bup,
                             adapter_scale, wsel, bsel,
                             with_select: bool) -> str:
    """Raise on MoE adapter/router arguments the CUDA kernels do not take;
    return the tail that takes them ("wgmma", "simt" or "f64")."""
    C = x.shape[-1]
    if wrouter.dim() != 2 or wdown2d.dim() != 2:
        raise ValueError("wrouter and wdown2d must be 2-D")
    E, W = wrouter.shape[0], wdown2d.shape[0]
    if E < 1 or W % E:
        raise ValueError(f"MoE width {E} experts x {W / max(E, 1):g} not "
                         "supported (E >= 1 experts of one width)")
    dev, f32 = x.device, (F32,)
    wd = (compute_dtype(wdown2d, wup2d),)
    _require(wrouter, "wrouter", (E, C), f32, dev)
    _require(wdown2d, "wdown2d", (W, C), wd, dev)
    _require(wup2d, "wup2d", (C, W), wd, dev)
    _require(bdown2d, "bdown2d", (W,), f32, dev)
    _require(bup, "bup", (E, C), f32, dev)
    _require(adapter_scale, "adapter_scale", (1,), f32, dev)
    if with_select:
        _require(wsel, "wsel", (1, C), f32, dev)
        _require(bsel, "bsel", (1,), f32, dev)
    tail = _moe_tail(lib, E, W, C, wdown2d)
    if tail == "wgmma":
        for name, t in (("wrouter", wrouter), ("wdown2d", wdown2d),
                        ("wup2d", wup2d), ("bup", bup),
                        ("wsel", wsel if with_select else None)):
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f"{name} must start on 16 bytes")
    return tail


def launch_moe_adapter_router(lib, x_mid, xm32, wrouter, wdown2d, bdown2d,
                              wup2d, bup, adapter_scale, wsel, bsel,
                              tau: float, with_select: bool):
    """The MoE adapter/router tail on the fp32 copy ``xm32`` of ``x_mid``
    (the wgmma kernel where it takes the bf16 experts, else the SIMT tail;
    the float64 DMMA tail for fp32 experts): (x_mid, adapt[, logits])."""
    B, N, C = x_mid.shape
    dev = x_mid.device
    E, b = _moe_dims(wrouter, wdown2d)
    adapt = torch.empty_like(x_mid)
    logits = (torch.empty((B, N, 1), dtype=F32, device=dev)
              if with_select else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sel = ((_ptr(wsel), _ptr(bsel)) if with_select else (None, None))
    tail = _moe_tail(lib, E, E * b, C, wdown2d)
    args = (_ptr(xm32), B * N, C, _ptr(wrouter), _ptr(wdown2d),
            _ptr(bdown2d), _ptr(wup2d), _ptr(bup), _ptr(adapter_scale), *sel,
            _ptr(adapt), int(x_mid.dtype == F32), _ptr(logits), E * b, E, b,
            1.0 / tau)
    if tail == "wgmma":
        err = lib.dyt_moe_adapter_router(
            _ptr(xm32), B * N, C, _ptr(wrouter), _ptr(wdown2d),
            _ptr(bdown2d), _ptr(wup2d), _ptr(bup), _ptr(adapter_scale), *sel,
            _ptr(adapt), int(x_mid.dtype == F32), _ptr(logits), E, b,
            1.0 / tau, stream)
    else:
        fn = lib.dyt_tail_f64 if tail == "f64" else lib.dyt_tail_simt
        h = torch.empty((B * N, E * b), dtype=F32 if tail == "f64" else BF,
                        device=dev)
        gates = torch.empty((B * N, E), dtype=F32, device=dev)
        err = fn(*args, _ptr(h), _ptr(gates), stream)
    _build.check(lib, err, "MoE adapter/router kernel")
    return (x_mid, adapt, logits) if with_select else (x_mid, adapt)


def bias_row_stride(N: int) -> int:
    """The row stride (elements) K9 takes its bias with: N rounded up to 8,
    so every bias row starts on 16 bytes."""
    return -(-N // 8) * 8


def _windowed_bias(bias: torch.Tensor, H: int, N: int) -> torch.Tensor:
    """``bias`` [H, N, N] as the kernel reads it: bf16, unit column stride,
    row and head strides multiples of 8 with rows covering
    ``bias_row_stride(N)`` columns of their storage.  Returned as it is when
    it already is so (the layer builds it that way), else as a padded bf16
    copy -- the rounding to bf16 is K9's contract either way."""
    ld = bias_row_stride(N)
    st = bias.stride()
    room = (bias.untyped_storage().nbytes() // 2 - bias.storage_offset()
            - (H - 1) * st[0] - (N - 1) * st[1])
    if (bias.dtype == torch.bfloat16 and st[2] == 1 and st[1] % 8 == 0
            and st[0] % 8 == 0 and st[1] >= ld and room >= ld
            and bias.data_ptr() % 16 == 0):
        return bias
    padded = torch.zeros((H, N, ld), dtype=torch.bfloat16,
                         device=bias.device)
    padded[:, :, :N] = bias
    return padded[:, :, :N]


def mha_windowed_fused(qkv: torch.Tensor, bias: torch.Tensor, *,
                       heads: int) -> torch.Tensor:
    """K9: qkv [B, N, 3C] + bias [H, N, N] -> [B, N, C] in qkv's dtype.

    The bias may be fp32 or bf16 (it is rounded to bf16 either way); on
    CUDA qkv is bf16 or fp32 and contiguous, any head dim ``core_of``
    takes: bf16 on the wgmma kernels and fp32 on the fp32 cores up to
    ``WIDE_MAX_HD``, past it on the SIMT core, the bf16 bias upcast at the
    score add (``core_of``)."""
    if qkv.device.type == "cpu":
        return mha_windowed_plain(qkv, bias, heads=heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"qkv is on {qkv.device}: the kernels take CPU "
                         "tensors (plain version) or CUDA tensors")
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, N, 3C], got {tuple(qkv.shape)}")
    B, N, C3 = qkv.shape
    C = C3 // 3
    if C % heads:
        raise ValueError(f"C={C} is not a multiple of heads={heads}")
    hd = C // heads
    _require(qkv, "qkv", (B, N, C3), (BF, F32), qkv.device)
    core = core_of("K9", qkv.dtype, hd, heads=heads)
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must start on 16 bytes")
    if tuple(bias.shape) != (heads, N, N) or bias.device != qkv.device:
        raise ValueError(f"bias has shape {tuple(bias.shape)} on "
                         f"{bias.device}, want {(heads, N, N)} on "
                         f"{qkv.device}")
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        bias = _windowed_bias(bias, heads, N)
        out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
        if core == "windowed":
            err = lib.dyt_mha_windowed(
                _ptr(qkv), _ptr(bias), _ptr(out), B, N, C, heads,
                bias.stride(0), bias.stride(1), hd ** -0.5,
                torch.cuda.current_stream(qkv.device).cuda_stream)
            _build.check(lib, err, "windowed attention kernel")
        else:
            q, k, v = qkv.view(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
            o = out.view(B, N, heads, hd).transpose(1, 2)
            launch = _launch_f32_core if core == "f32" else _launch_simt_core
            launch(q, k, v, o, bias)
    counted(mha_windowed_fused, form_of(qkv.dtype, hd, core=core))
    return out


# --- K1 and K15: the core alone ------------------------------------------------

def weak_scale(t: torch.Tensor, hd: int) -> torch.Tensor:
    """``hd ** -0.5`` as XLA applies a weak-typed Python float to an array:
    rounded to the array's dtype first (bf16 at hd = 128 rounds it; 0.125
    at hd = 64 is exact in any dtype)."""
    return torch.tensor(hd ** -0.5, dtype=t.dtype, device=t.device)


def mha_serving_plain(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Plain version of K15: q, k, v ``[B, H, N, hd]`` -> ``[B, H, N, hd]``
    in q's dtype.  ``q * scale`` in q's dtype, fp32 scores, ``p =
    exp(clip(s, -60, 80) - 20)`` rounded to q's dtype, ``l`` the sum of the
    rounded ``p``, ``o = (p @ v) / l``; scores, ``l`` and the AV products
    summed in float64 and rounded once to fp32."""
    dtype = q.dtype
    s = _mm64(q * weak_scale(q, q.shape[-1]), k)
    p = torch.exp(s.clamp(-60.0, 80.0) - 20.0).to(dtype)
    l = p.double().sum(dim=-1, keepdim=True).float()
    return (_mm64(p, v.transpose(-1, -2)) / l).to(dtype)


def mha_fused_reference(qkv: torch.Tensor, *, heads: int) -> torch.Tensor:
    """The plain path K1 replaces in the JAX package: raw qkv ``[B, N, 3C]``
    transposed to q, k, v, K15's plain core, transposed back to
    ``[B, N, C]``."""
    B, N, C3 = qkv.shape
    q, k, v = qkv.reshape(B, N, 3, heads, C3 // 3 // heads).permute(
        2, 0, 3, 1, 4)
    return mha_serving_plain(q, k, v).transpose(1, 2).reshape(B, N, C3 // 3)


def _check_core_operand(t: torch.Tensor, name: str, device,
                        dtypes=(BF,)) -> None:
    """Raise unless ``t`` is a ``[B, H, N, hd]`` tensor of ``dtypes`` on
    ``device`` that the strided cores read: unit stride along hd, every
    other stride a multiple of 8 elements, data on 16 bytes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} is {t.dtype}, want one of {dtypes}")
    if (t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:3])
            or t.data_ptr() % 16):
        raise ValueError(f"{name} (strides {t.stride()}) must have unit "
                         "stride along hd and rows on 16 bytes")


def _launch_core(q, k, v, out, *, k15: bool) -> None:
    """The strided core on bf16 q, k, v [B, H, N, hd] into ``out``: the
    wgmma core at head dims up to ``WIDE_MAX_HD`` (``core_of``).  Every
    core takes any N: past the N whose keys and values fit a block's shared
    memory the wgmma core walks them through a ring of tiles, the SIMT and
    fp32 cores always walk them in tiles."""
    B, H, N, hd = q.shape
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.dyt_mha_core(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out),
            _build.strides_arg(q, k, v, out), B, N, H, hd, hd ** -0.5,
            int(k15), torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, err, "attention core kernel")


def _bias_args(bias):
    return (_ptr(bias), 0 if bias is None else bias.stride(0),
            0 if bias is None else bias.stride(1))


def _launch_simt_core(q, k, v, out, bias=None, *, k15: bool = False) -> None:
    """The SIMT core on strided bf16 or fp32 q, k, v [B, H, N, hd] into
    ``out`` (K1's rounding, or K15's), with an optional bf16 ``bias`` [H, N,
    N] of unit column stride: every core past ``WIDE_MAX_HD``."""
    B, H, N, hd = q.shape
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.dyt_simt_core(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out),
            _build.strides_arg(q, k, v, out), B, N, H, hd, hd ** -0.5,
            *_bias_args(bias), int(q.dtype == F32), int(k15),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, err, "SIMT attention core")


def _launch_f32_core(q, k, v, out, bias=None) -> None:
    """The register-tiled fp32 core (K1's rounding) on strided fp32 q, k, v
    [B, H, N, hd] into ``out``, with an optional bf16 ``bias`` [H, N, N] of
    unit column stride."""
    B, H, N, hd = q.shape
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.dyt_f32_core(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out),
            _build.strides_arg(q, k, v, out), B, N, H, hd, hd ** -0.5,
            *_bias_args(bias), torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, err, "fp32 attention core")


def _cuda_only(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}: the kernels take CPU "
                         "tensors (plain version) or CUDA tensors")


def mha_serving(q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """K15: q, k, v ``[B, H, N, hd]`` -> ``[B, H, N, hd]`` in q's dtype.

    On CUDA: bf16, any head dim ``core_of`` takes (the wgmma core up to
    ``WIDE_MAX_HD``, the SIMT core past it), any views
    with unit stride along hd and rows on 16 bytes (such as the q, k, v
    views of a raw ``[B, N, 3C]`` qkv buffer).  The output is allocated
    ``[B, N, H, hd]`` and returned as its ``[B, H, N, hd]`` view, so
    ``.transpose(1, 2).reshape(B, N, C)`` copies nothing."""
    if q.device.type == "cpu":
        return mha_serving_plain(q, k, v)
    _cuda_only(q, "q")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, N, hd], got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q "
                             f"{tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_core_operand(t, name, q.device)
    B, H, N, hd = q.shape
    core = core_of("K15", q.dtype, hd, heads=H)
    out = torch.empty((B, N, H, hd), dtype=torch.bfloat16,
                      device=q.device).transpose(1, 2)
    if core == "simt":
        _launch_simt_core(q, k, v, out, k15=True)
    else:
        _launch_core(q, k, v, out, k15=True)
    counted(mha_serving, form_of(BF, hd, core=core))
    return out


def mha_serving_fused(qkv: torch.Tensor, *, heads: int,
                      group: int = 2) -> torch.Tensor:
    """K1: raw qkv ``[B, N, 3C]`` -> ``[B, N, C]`` in qkv's dtype.

    ``group`` is the TPU kernel's number of heads per matmul pair; its
    contract (``group`` divides ``heads``, ``group * hd`` a multiple of 128)
    raises ValueError here too, and one kernel runs whatever the group.  On
    CUDA qkv is bf16 or fp32 and contiguous, any head dim ``core_of``
    takes: up to ``WIDE_MAX_HD`` bf16 on the wgmma core and fp32 on the
    fp32 core, past it the SIMT core (``core_of``)."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, N, 3C], got {tuple(qkv.shape)}")
    B, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // heads
    if heads % group or hd * heads != C:
        raise ValueError(f"heads={heads}, group={group}, C={C}: group must "
                         "divide heads and heads divide C")
    if (group * hd) % 128:
        raise ValueError(f"group * head_dim = {group * hd} must be a "
                         "multiple of 128")
    if qkv.device.type == "cpu":
        return attn_core_pairs(qkv, heads=heads)
    _cuda_only(qkv, "qkv")
    _require(qkv, "qkv", (B, N, C3), (BF, F32), qkv.device)
    core = core_of("K1", qkv.dtype, hd, heads=heads)
    q, k, v = qkv.view(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    _check_core_operand(q, "qkv", qkv.device, (BF, F32))
    o = out.view(B, N, heads, hd).transpose(1, 2)
    launch = {"f32": _launch_f32_core, "simt": _launch_simt_core}.get(core)
    if launch is None:
        _launch_core(q, k, v, o, k15=False)
    else:
        launch(q, k, v, o)
    counted(mha_serving_fused, form_of(qkv.dtype, hd, core=core))
    return out


_WRAPPERS = (attention_sublayer_serving, dyt_prologue_serving,
             dyt_prologue_serving_moe, mha_windowed_fused, mha_serving_fused,
             mha_serving)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0
        fn.forms = {}


reset_launch_counts()
