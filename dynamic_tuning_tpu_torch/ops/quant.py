"""Int8 (W8A8) serving (counterpart of dynamic_tuning_tpu/ops/quant.py).

Symmetric per-output-channel int8 weights times dynamic per-row int8
activations:

    out[m, n] = (sum_k qa[m, k] * qw[n, k]) * row_scale[m] * col_scale[n]

Six kernels, each a wrapper with its plain PyTorch version beside it:

* ``q8_ln_mlp`` (TPU kernel K4): LN -> int8 fc1 -> GELU -> int8 fc2 on rows;
* ``attention_sublayer_serving_q8`` (K5): K2 with int8 qkv and proj;
* ``dyt_prologue_serving_q8`` (K6): K3 with int8 qkv and proj, the adapter
  and the router unchanged;
* ``dyt_prologue_serving_q8_moe`` (K8): K7 with int8 qkv and proj, the MoE
  mixture and the router unchanged (bf16/fp32);
* ``attn_core_pairs_q8`` (K10, ``--quant int8_attn``): the attention core
  with an int8 QK^T, reached alone or inside K5/K6 with ``attn_q8=True``;
* ``q8_dispatch_mlp`` (K12): capacity dispatch around K4 -- the top-K rows
  of each sample gathered, LN and the int8 MLP on them, the kept rows
  scattered back to their tokens -- with the effective gate.  No serving
  path calls it, in either package: the Block keeps ``D.dispatch_mlp``
  around ``q8_ln_mlp``, as the JAX Block does.

Besides them, ``q8_patch_embed`` is the int8 stem (the JAX package's XLA
``q8_conv`` at stride = kernel, a patch matmul) on the same int8 GEMM.

A wrapper given CPU tensors computes the plain version.  Given CUDA tensors
it launches the kernels of ``csrc/quant.cu`` or raises; there is no other
path.  Each launch adds one to the wrapper's ``launches`` count.

Weights arrive quantized (``quantize_weight`` on the fp32 master weights,
once per load by the caller) in torch's ``[out, in]`` layout.  The numerics
are those of the TPU kernels:

* round half to even, clip to +-127; ``inv = 127 / amax`` as an IEEE
  division (a zero row gives codes 0 and scale 0); the row scale is
  ``amax * (1/127)``, the weight scale ``amax / 127``;
* int32 sums exact (the plain versions form them in float64, exact past
  2**24), then ``(acc * row_scale) * col_scale``, then the bias;
* K5's qkv and core output are rounded to bf16 whatever x's dtype; K6's
  and K8's follow the adapter dtype; ``x_mid = (x + proj) + b``;
* K10: q scaled in fp32 and quantized per head row; k centred by its lane
  mean over the N tokens and quantized per row of a HEAD PAIR (the TPU's
  128-lane row), so one k scale covers heads 2p and 2p+1.
"""

from __future__ import annotations

import math

import torch

from dynamic_tuning_tpu_torch.ops import _build
from dynamic_tuning_tpu_torch.ops import dispatch as D
from dynamic_tuning_tpu_torch.ops import mha_serving as ms
from dynamic_tuning_tpu_torch.ops.mha_serving import _ptr, _require

I8, BF, F32 = torch.int8, torch.bfloat16, torch.float32
SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


# --- plain versions ----------------------------------------------------------

def _inv127(amax: torch.Tensor) -> torch.Tensor:
    """where(amax > 0, 127 / amax, 0) with an IEEE division (a Python
    number over a tensor would be a reciprocal times 127 in torch)."""
    inv = torch.full_like(amax, 127.0) / amax
    return torch.where(amax > 0, inv, torch.zeros_like(amax))


def _codes(xf: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf * inv), -127, 127).to(I8)


def quantize_weight(w: torch.Tensor):
    """[out, in] float -> (int8 [out, in], fp32 col_scale [out]):
    symmetric per output channel, scale = amax / 127."""
    wf = w.float()
    amax = wf.abs().amax(dim=1, keepdim=True)
    return _codes(wf, _inv127(amax)), (amax / 127.0).reshape(-1)


def row_quant(xf: torch.Tensor):
    """fp32 [..., K] -> (int8 [..., K], fp32 row_scale [..., 1])."""
    amax = xf.abs().amax(dim=-1, keepdim=True)
    return _codes(xf, _inv127(amax)), amax * (1.0 / 127.0)


def int_matmul(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Exact int8 products qa @ qb.T over the last axis, as fp32 (the
    int32 sum rounded once).  float64 holds every sum exactly."""
    return torch.matmul(qa.double(), qb.double().transpose(-1, -2)).float()


def q8_matmul(xf: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor
              ) -> torch.Tensor:
    """fp32 [..., K] x int8 [N, K] -> fp32 [..., N] via dynamic row quant."""
    qa, rs = row_quant(xf)
    return int_matmul(qa, wq) * rs * ws


def erf_f32(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.26 erf (max error 1.5e-7), as the kernels."""
    a = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-a * a))


def gelu_f32(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    """GELU in fp32: tanh form (jax.nn.gelu(approximate=True)) or the A&S
    erf form."""
    if approximate:
        inner = SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))
        return x * (0.5 * (1.0 + torch.tanh(inner)))
    return 0.5 * x * (1.0 + erf_f32(x * 0.7071067811865476))


def q8_ln_mlp_plain(x, gamma, beta, w1q, s1, b1, w2q, s2, b2, *,
                    gelu_approx: bool = False) -> torch.Tensor:
    """Plain version of K4: x [..., C] -> MLP output in x's dtype."""
    h = q8_matmul(ms.layernorm_f32(x.float(), gamma, beta), w1q, s1) + b1
    h = gelu_f32(h, gelu_approx)
    return (q8_matmul(h, w2q, s2) + b2).to(x.dtype)


def q8_dispatch_mlp_plain(x, scores, gamma, beta, w1q, s1, b1, w2q, s2, b2,
                          *, capacity: int, gelu_approx: bool = False,
                          threshold: float = 0.5):
    """Plain version of K12: x [B, N, C], scores [B, N] (CLS already +inf)
    -> (out [B, N, C], gate [B, N]), both in x's dtype.  The JAX kernel's
    steps: the top-``capacity`` selection, the rows gathered (zero rows at
    slots at or under the threshold, as its one-hot gives), K4's plain
    version on them, the kept rows scattered to their tokens."""
    idx, keep = D.select_topk(scores, capacity, threshold)
    rows = D.gather_tokens(x, idx) * keep[..., None].to(x.dtype)
    y = q8_ln_mlp_plain(rows, gamma, beta, w1q, s1, b1, w2q, s2, b2,
                        gelu_approx=gelu_approx)
    gate = torch.zeros(scores.shape, dtype=x.dtype, device=x.device)
    return (D.scatter_tokens(x, idx, y, keep),
            gate.scatter_(1, idx, keep.to(x.dtype)))


def attn_core_pairs_q8_plain(qkv: torch.Tensor, *, heads: int
                             ) -> torch.Tensor:
    """Plain version of K10 on raw qkv [B, N, 3C] -> [B, N, C] in qkv's
    dtype."""
    B, N, C3 = qkv.shape
    hd = C3 // 3 // heads
    dtype = qkv.dtype
    q, k, v = qkv.reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    qq, qs = row_quant(q.float() * hd ** -0.5)            # per head row
    # k of each head pair as one 2*hd-lane row, centred per lane
    kp = k.float().reshape(B, heads // 2, 2, N, hd).transpose(2, 3)
    kp = kp.reshape(B, heads // 2, N, 2 * hd)
    # the lane mean summed in float64 and rounded once, as the kernel does
    mean = (kp.double().sum(dim=2, keepdim=True) / N).float()
    kq, ks = row_quant(kp - mean)
    kq = kq.reshape(B, heads // 2, N, 2, hd).transpose(2, 3)
    kq = kq.reshape(B, heads, N, hd)
    ks = ks.repeat_interleave(2, dim=1)                   # [B, H, N, 1]
    s = int_matmul(qq, kq) * qs * ks.transpose(-1, -2)
    e = torch.exp(s.clamp(-60.0, 80.0) - 20.0)
    l = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e.to(dtype).float(), v.float()) * (1.0 / l)
    return o.to(dtype).transpose(1, 2).reshape(B, N, heads * hd)


def _sublayer_q8_f32(x, gamma, beta, wqkv_q, sqkv, bqkv, wproj_q, sproj,
                     bproj, heads, attn_q8, scratch_dtype):
    """fp32 x_mid = (x + proj(core(qkv(LN(x))))) + b on int8 qkv/proj."""
    xf = x.float()
    ln = ms.layernorm_f32(xf, gamma, beta)
    qkv = (q8_matmul(ln, wqkv_q, sqkv) + bqkv).to(scratch_dtype)
    core = attn_core_pairs_q8_plain if attn_q8 else ms.attn_core_pairs
    out = core(qkv, heads=heads)
    return xf + q8_matmul(out.float(), wproj_q, sproj) + bproj


def attention_sublayer_q8_plain(x, gamma, beta, wqkv_q, sqkv, bqkv, wproj_q,
                                sproj, bproj, *, heads: int,
                                attn_q8: bool = False) -> torch.Tensor:
    """Plain version of K5: x [B, N, C] -> x_mid in x's dtype (qkv and the
    core output rounded to bf16)."""
    return _sublayer_q8_f32(x, gamma, beta, wqkv_q, sqkv, bqkv, wproj_q,
                            sproj, bproj, heads, attn_q8, BF).to(x.dtype)


def dyt_prologue_q8_plain(x, gamma, beta, wqkv_q, sqkv, bqkv, wproj_q, sproj,
                          bproj, wdown, bdown, wup, bup, adapter_scale, wsel,
                          bsel, *, heads: int, with_select: bool = True,
                          attn_q8: bool = False):
    """Plain version of K6: (x_mid, adapt[, logits]) as K3's."""
    xm = _sublayer_q8_f32(x, gamma, beta, wqkv_q, sqkv, bqkv, wproj_q, sproj,
                          bproj, heads, attn_q8, wdown.dtype)
    return ms.adapter_router_plain(xm, x.dtype, wdown, bdown, wup, bup,
                                   adapter_scale, wsel, bsel,
                                   with_select=with_select)


def dyt_prologue_q8_moe_plain(x, gamma, beta, wqkv_q, sqkv, bqkv, wproj_q,
                              sproj, bproj, wrouter, wdown2d, bdown2d, wup2d,
                              bup, adapter_scale, wsel, bsel, *, heads: int,
                              tau: float, with_select: bool = True,
                              attn_q8: bool = False):
    """Plain version of K8: (x_mid, adapt[, logits]) as K7's."""
    xm = _sublayer_q8_f32(x, gamma, beta, wqkv_q, sqkv, bqkv, wproj_q, sproj,
                          bproj, heads, attn_q8, wdown2d.dtype)
    E, b = ms._moe_dims(wrouter, wdown2d)
    return ms.moe_adapter_router_plain(
        xm, x.dtype, wrouter, wdown2d, bdown2d, wup2d, bup, adapter_scale,
        wsel, bsel, experts=E, bneck=b, tau=tau, with_select=with_select)


def quantize_conv_weight(w: torch.Tensor):
    """OIHW conv weight -> (int8 [O, kh*kw*I] in (kh, kw, in) order, fp32
    scale [O]), the per-output-channel weights of ``q8_conv``."""
    return quantize_weight(w.permute(0, 2, 3, 1).reshape(w.shape[0], -1))


def sample_quant(x: torch.Tensor):
    """[B, ...] -> (int8 codes, fp32 per-sample scale [B] = amax / 127):
    the stem's activations, one scale per image."""
    xf = x.float()
    amax = xf.abs().amax(dim=tuple(range(1, x.dim())), keepdim=True)
    return _codes(xf, _inv127(amax)), (amax / 127.0).reshape(-1)


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC [B, H, W, c] -> [B * T, patch * patch * c] rows of
    non-overlapping patches, (kh, kw, c) order, patches row-major."""
    B, H, W, c = x.shape
    gh, gw = H // patch, W // patch
    x = x.reshape(B, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * gh * gw, patch * patch * c)


def q8_conv(x: torch.Tensor, w: torch.Tensor, *, patch: int) -> torch.Tensor:
    """The JAX package's ``q8_conv`` at stride = kernel = ``patch``, VALID:
    NHWC x, OIHW w -> fp32 [B, H/p, W/p, O] (no bias)."""
    B, H, W, _ = x.shape
    wq, ws = quantize_conv_weight(w)
    xq, sa = sample_quant(x)
    acc = int_matmul(patchify(xq, patch), wq)
    T = (H // patch) * (W // patch)
    out = acc * (sa.repeat_interleave(T)[:, None] * ws)
    return out.reshape(B, H // patch, W // patch, -1)


def q8_patch_embed_plain(x, wq, ws, bias, *, patch: int,
                         dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the int8 stem: NHWC x -> [B, T, O] in ``dtype``,
    ``acc * (sample_scale * col_scale) + bias``."""
    B, H, W, _ = x.shape
    xq, sa = sample_quant(x)
    T = (H // patch) * (W // patch)
    acc = int_matmul(patchify(xq, patch), wq)
    out = acc * (sa.repeat_interleave(T)[:, None] * ws) + bias
    return out.to(dtype).reshape(B, T, -1)


# --- CUDA wrappers -----------------------------------------------------------

def _cuda_lib(x: torch.Tensor):
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}: the kernels take CPU tensors "
                         "(plain version) or CUDA tensors")
    return _build.library()


def _require_q8(wq, ws, b, name, n_out, n_in, dev) -> None:
    _require(wq, name, (n_out, n_in), (I8,), dev)
    _require(ws, name + " scale", (n_out,), (F32,), dev)
    _require(b, name + " bias", (n_out,), (F32,), dev)
    if n_in % 16 or n_out % 8:
        raise ValueError(f"{name}: int8 GEMM needs in % 16 == 0 and "
                         f"out % 8 == 0, got [{n_out}, {n_in}]")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def q8_ln_mlp(x, gamma, beta, w1q, s1, b1, w2q, s2, b2, *,
              gelu_approx: bool = False) -> torch.Tensor:
    """K4: x [..., C] (bf16 or fp32) -> LN -> int8 fc1 -> GELU -> int8 fc2,
    in x's dtype (no residual).  w1q [Hd, C], w2q [C, Hd] int8 with fp32
    scales and biases."""
    if x.device.type == "cpu":
        return q8_ln_mlp_plain(x, gamma, beta, w1q, s1, b1, w2q, s2, b2,
                               gelu_approx=gelu_approx)
    lib = _cuda_lib(x)
    C = x.shape[-1]
    Hd = w1q.shape[0]
    M = x.numel() // C
    dev = x.device
    _require(x, "x", x.shape, (F32, BF), dev)
    _require(gamma, "gamma", (C,), (F32,), dev)
    _require(beta, "beta", (C,), (F32,), dev)
    _require_q8(w1q, s1, b1, "fc1", Hd, C, dev)
    _require_q8(w2q, s2, b2, "fc2", C, Hd, dev)
    with torch.cuda.device(dev):
        out = torch.empty_like(x)
        a8 = torch.empty((M, max(C, Hd)), dtype=I8, device=dev)
        rs = torch.empty((M,), dtype=F32, device=dev)
        h = torch.empty((M, Hd), dtype=F32, device=dev)
        hmax = torch.empty((M,), dtype=F32, device=dev)
        err = lib.dyt_q8_ln_mlp(
            _ptr(x), int(x.dtype == F32), _ptr(gamma), _ptr(beta), _ptr(w1q),
            _ptr(s1), _ptr(b1), _ptr(w2q), _ptr(s2), _ptr(b2), _ptr(out),
            _ptr(a8), _ptr(rs), _ptr(h), _ptr(hmax), M, C, Hd,
            int(gelu_approx), _stream(dev))
        _build.check(lib, err, "int8 LN+MLP kernels")
    q8_ln_mlp.launches += 1
    return out


q8_ln_mlp.launches = 0


def q8_dispatch_mlp(x, scores, gamma, beta, w1q, s1, b1, w2q, s2, b2, *,
                    capacity: int, gelu_approx: bool = False,
                    threshold: float = 0.5):
    """K12: x [B, N, C] (bf16 or fp32), scores [B, N] keep probabilities
    (CLS already +inf) -> (out [B, N, C], gate [B, N]) in x's dtype: LN and
    the int8 MLP of K4 on the top-``capacity`` tokens of each sample, each
    kept row at its token, zeros elsewhere; the gate 1 where a row was
    kept.  Weights as for ``q8_ln_mlp``.  The selection is the port's
    stable sort (``D.select_topk``), outside the kernels as in the JAX
    package; the gather, the gate and the scatter are in them."""
    if x.device.type == "cpu":
        return q8_dispatch_mlp_plain(x, scores, gamma, beta, w1q, s1, b1, w2q,
                                     s2, b2, capacity=capacity,
                                     gelu_approx=gelu_approx,
                                     threshold=threshold)
    lib = _cuda_lib(x)
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, C], got {tuple(x.shape)}")
    B, N, C = x.shape
    Hd = w1q.shape[0]
    dev = x.device
    _require(x, "x", (B, N, C), (F32, BF), dev)
    _require(scores, "scores", (B, N), (F32, BF), dev)
    _require(gamma, "gamma", (C,), (F32,), dev)
    _require(beta, "beta", (C,), (F32,), dev)
    _require_q8(w1q, s1, b1, "fc1", Hd, C, dev)
    _require_q8(w2q, s2, b2, "fc2", C, Hd, dev)
    if not 0 < capacity <= N:
        raise ValueError(f"capacity {capacity} out of (0, {N}]")
    M = B * capacity
    with torch.cuda.device(dev):
        idx, keep = D.select_topk(scores, capacity, threshold)
        idx, keep = idx.contiguous(), keep.contiguous()
        out = torch.empty_like(x)
        gate = torch.empty((B, N), dtype=x.dtype, device=dev)
        a8 = torch.empty((M, max(C, Hd)), dtype=I8, device=dev)
        rs = torch.empty((M,), dtype=F32, device=dev)
        h = torch.empty((M, Hd), dtype=F32, device=dev)
        hmax = torch.empty((M,), dtype=F32, device=dev)
        row_map = torch.empty((M,), dtype=torch.int32, device=dev)
        err = lib.dyt_q8_dispatch_mlp(
            _ptr(x), int(x.dtype == F32), _ptr(idx), _ptr(keep), _ptr(gamma),
            _ptr(beta), _ptr(w1q), _ptr(s1), _ptr(b1), _ptr(w2q), _ptr(s2),
            _ptr(b2), _ptr(out), _ptr(gate), _ptr(a8), _ptr(rs), _ptr(h),
            _ptr(hmax), _ptr(row_map), B, N, capacity, C, Hd,
            int(gelu_approx), _stream(dev))
        _build.check(lib, err, "int8 dispatch MLP kernels")
    q8_dispatch_mlp.launches += 1
    return out, gate


q8_dispatch_mlp.launches = 0


def _check_core_q8(lib, N, C, heads) -> None:
    hd = C // heads
    smem = lib.dyt_attn_core_q8_smem_bytes(N, hd)
    if heads % 2 or smem == 0:
        raise ValueError(f"int8 attention core: head_dim {hd} with {heads} "
                         "heads not supported (pairs of heads of 64 or 128)")
    if smem > ms.SMEM_PER_BLOCK:
        raise ValueError(f"N={N}, head_dim={hd} needs {smem} B of shared "
                         f"memory per block (limit {ms.SMEM_PER_BLOCK})")


def attn_core_pairs_q8(qkv: torch.Tensor, *, heads: int) -> torch.Tensor:
    """K10: raw qkv [B, N, 3C] bf16 -> [B, N, C] bf16 through the int8
    QK^T core."""
    if qkv.device.type == "cpu":
        return attn_core_pairs_q8_plain(qkv, heads=heads)
    lib = _cuda_lib(qkv)
    B, N, C3 = qkv.shape
    _require(qkv, "qkv", (B, N, C3), (BF,), qkv.device)
    _check_core_q8(lib, N, C3 // 3, heads)
    dev = qkv.device
    with torch.cuda.device(dev):
        out = torch.empty((B, N, C3 // 3), dtype=BF, device=dev)
        kq = torch.empty((B * N, C3 // 3), dtype=I8, device=dev)
        ks = torch.empty((B * N, heads // 2), dtype=F32, device=dev)
        err = lib.dyt_attn_core_q8(_ptr(qkv), _ptr(out), _ptr(kq), _ptr(ks),
                                   B, N, C3 // 3, heads,
                                   (C3 // 3 // heads) ** -0.5, _stream(dev))
        _build.check(lib, err, "int8 attention core")
    attn_core_pairs_q8.launches += 1
    return out


attn_core_pairs_q8.launches = 0


def _check_sublayer_q8(x, gamma, beta, wqkv_q, sqkv, bqkv, wproj_q, sproj,
                       bproj, heads, attn_q8):
    lib = _cuda_lib(x)
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, C], got {tuple(x.shape)}")
    B, N, C = x.shape
    dev = x.device
    _require(x, "x", (B, N, C), (F32, BF), dev)
    _require(gamma, "gamma", (C,), (F32,), dev)
    _require(beta, "beta", (C,), (F32,), dev)
    _require_q8(wqkv_q, sqkv, bqkv, "qkv", 3 * C, C, dev)
    _require_q8(wproj_q, sproj, bproj, "proj", C, C, dev)
    if C % heads:
        raise ValueError(f"C={C} is not a multiple of heads={heads}")
    if attn_q8:
        _check_core_q8(lib, N, C, heads)
    else:
        smem = lib.dyt_attn_core_smem_bytes(N, C // heads)
        if smem == 0 or smem > ms.SMEM_PER_BLOCK:
            raise ValueError(f"attention core: N={N}, head_dim {C // heads}"
                             " not supported")
    return lib


def _launch_sublayer_q8(lib, x, gamma, beta, wqkv_q, sqkv, bqkv, wproj_q,
                        sproj, bproj, heads, attn_q8, xm32):
    B, N, C = x.shape
    M, dev = B * N, x.device
    out = torch.empty_like(x)
    a8 = torch.empty((M, C), dtype=I8, device=dev)
    rs = torch.empty((M,), dtype=F32, device=dev)
    qkv = torch.empty((M, 3 * C), dtype=BF, device=dev)
    attn = torch.empty((M, C), dtype=BF, device=dev)
    kscale = (torch.empty((M, heads // 2), dtype=F32, device=dev)
              if attn_q8 else None)
    err = lib.dyt_attention_sublayer_q8(
        _ptr(x), int(x.dtype == F32), _ptr(gamma), _ptr(beta), _ptr(wqkv_q),
        _ptr(sqkv), _ptr(bqkv), _ptr(wproj_q), _ptr(sproj), _ptr(bproj),
        _ptr(out), _ptr(xm32), _ptr(a8), _ptr(rs), _ptr(qkv), _ptr(attn),
        _ptr(kscale), B, N, C, heads, (C // heads) ** -0.5, int(attn_q8),
        _stream(dev))
    _build.check(lib, err, "int8 attention sublayer kernels")
    if attn_q8:
        attn_core_pairs_q8.launches += 1
    return out


def attention_sublayer_serving_q8(x, gamma, beta, wqkv_q, sqkv, bqkv,
                                  wproj_q, sproj, bproj, *, heads: int,
                                  attn_q8: bool = False) -> torch.Tensor:
    """K5: x [B, N, C] (bf16 or fp32) -> x + proj(core(qkv(LN(x)))) with
    qkv [3C, C] and proj [C, C] int8 (fp32 scales and biases); the core is
    K10 when ``attn_q8``."""
    if x.device.type == "cpu":
        return attention_sublayer_q8_plain(x, gamma, beta, wqkv_q, sqkv,
                                           bqkv, wproj_q, sproj, bproj,
                                           heads=heads, attn_q8=attn_q8)
    lib = _check_sublayer_q8(x, gamma, beta, wqkv_q, sqkv, bqkv, wproj_q,
                             sproj, bproj, heads, attn_q8)
    with torch.cuda.device(x.device):
        out = _launch_sublayer_q8(lib, x, gamma, beta, wqkv_q, sqkv, bqkv,
                                  wproj_q, sproj, bproj, heads, attn_q8, None)
    attention_sublayer_serving_q8.launches += 1
    return out


attention_sublayer_serving_q8.launches = 0


def dyt_prologue_serving_q8(x, gamma, beta, wqkv_q, sqkv, bqkv, wproj_q,
                            sproj, bproj, wdown, bdown, wup, bup,
                            adapter_scale, wsel, bsel, *, heads: int,
                            with_select: bool = True, attn_q8: bool = False):
    """K6: K5's x_mid, then K3's adapter/router kernel on its fp32 copy:
    (x_mid, adapt, logits [B, N, 1] fp32), or (x_mid, adapt) without the
    router.  Adapter weights as for ``dyt_prologue_serving``."""
    if x.device.type == "cpu":
        return dyt_prologue_q8_plain(
            x, gamma, beta, wqkv_q, sqkv, bqkv, wproj_q, sproj, bproj, wdown,
            bdown, wup, bup, adapter_scale, wsel, bsel, heads=heads,
            with_select=with_select, attn_q8=attn_q8)
    lib = _check_sublayer_q8(x, gamma, beta, wqkv_q, sqkv, bqkv, wproj_q,
                             sproj, bproj, heads, attn_q8)
    ms.check_adapter_router(lib, x, wdown, bdown, wup, bup, adapter_scale,
                            wsel, bsel, with_select)
    with torch.cuda.device(x.device):
        xm32 = torch.empty(x.shape, dtype=F32, device=x.device)
        x_mid = _launch_sublayer_q8(lib, x, gamma, beta, wqkv_q, sqkv, bqkv,
                                    wproj_q, sproj, bproj, heads, attn_q8,
                                    xm32)
        outs = ms.launch_adapter_router(lib, x_mid, xm32, wdown, bdown, wup,
                                        bup, adapter_scale, wsel, bsel,
                                        with_select)
    dyt_prologue_serving_q8.launches += 1
    return outs


dyt_prologue_serving_q8.launches = 0


def dyt_prologue_serving_q8_moe(x, gamma, beta, wqkv_q, sqkv, bqkv, wproj_q,
                                sproj, bproj, wrouter, wdown2d, bdown2d,
                                wup2d, bup, adapter_scale, wsel, bsel, *,
                                heads: int, tau: float,
                                with_select: bool = True,
                                attn_q8: bool = False):
    """K8: K5's x_mid, then K7's MoE adapter/router kernel on its fp32 copy:
    (x_mid, adapt, logits [B, N, 1] fp32), or (x_mid, adapt) without the
    router.  Expert weights as for ``dyt_prologue_serving_moe``."""
    if x.device.type == "cpu":
        return dyt_prologue_q8_moe_plain(
            x, gamma, beta, wqkv_q, sqkv, bqkv, wproj_q, sproj, bproj,
            wrouter, wdown2d, bdown2d, wup2d, bup, adapter_scale, wsel, bsel,
            heads=heads, tau=tau, with_select=with_select, attn_q8=attn_q8)
    lib = _check_sublayer_q8(x, gamma, beta, wqkv_q, sqkv, bqkv, wproj_q,
                             sproj, bproj, heads, attn_q8)
    ms.check_moe_adapter_router(lib, x, wrouter, wdown2d, bdown2d, wup2d,
                                bup, adapter_scale, wsel, bsel, with_select)
    with torch.cuda.device(x.device):
        xm32 = torch.empty(x.shape, dtype=F32, device=x.device)
        x_mid = _launch_sublayer_q8(lib, x, gamma, beta, wqkv_q, sqkv, bqkv,
                                    wproj_q, sproj, bproj, heads, attn_q8,
                                    xm32)
        outs = ms.launch_moe_adapter_router(
            lib, x_mid, xm32, wrouter, wdown2d, bdown2d, wup2d, bup,
            adapter_scale, wsel, bsel, tau, with_select)
    dyt_prologue_serving_q8_moe.launches += 1
    return outs


dyt_prologue_serving_q8_moe.launches = 0


def q8_patch_embed(x, wq, ws, bias, *, patch: int,
                   dtype: torch.dtype = BF) -> torch.Tensor:
    """The int8 stem: NHWC images [B, H, W, c] -> [B, T, O] in ``dtype``
    (bf16 on CUDA).  wq [O, p*p*c] int8 and ws [O] from
    ``quantize_conv_weight``, bias [O] fp32.  The per-image activation
    quantization and the patch gather are plain tensor code (XLA in the JAX
    package); the int8 GEMM is the hand kernel."""
    if x.device.type == "cpu":
        return q8_patch_embed_plain(x, wq, ws, bias, patch=patch, dtype=dtype)
    lib = _cuda_lib(x)
    B, H, W, c = x.shape
    O, K = wq.shape
    if dtype != BF or K != patch * patch * c or H % patch or W % patch:
        raise ValueError(f"int8 stem: bf16 output and a {patch}x{patch} "
                         f"patch grid expected, got {dtype}, {tuple(x.shape)}"
                         f" against weights {tuple(wq.shape)}")
    _require_q8(wq, ws, bias, "patch_embed", O, K, x.device)
    xq, sa = sample_quant(x)
    T = (H // patch) * (W // patch)
    rows = patchify(xq, patch).contiguous()
    rs = sa.repeat_interleave(T).contiguous()
    with torch.cuda.device(x.device):
        out = torch.empty((B * T, O), dtype=BF, device=x.device)
        err = lib.dyt_q8_stem_gemm(_ptr(rows), _ptr(wq), _ptr(rs), _ptr(ws),
                                   _ptr(bias), B * T, O, K, _ptr(out),
                                   _stream(x.device))
        _build.check(lib, err, "int8 stem GEMM")
    q8_patch_embed.launches += 1
    return out.reshape(B, T, O)


q8_patch_embed.launches = 0


def reset_launch_counts() -> None:
    for fn in (q8_ln_mlp, attn_core_pairs_q8, attention_sublayer_serving_q8,
               dyt_prologue_serving_q8, dyt_prologue_serving_q8_moe,
               q8_patch_embed, q8_dispatch_mlp):
        fn.launches = 0
