"""Serving attention on the card: K1 against the plain path it replaces,
K13 and K14, each beside SDPA (counterpart of
scripts/profile_attention.py), and the cores at head dims 192 and 256 and
in fp32.

    python -m dynamic_tuning_tpu_torch.utils.profile_attention \
        [--part all|serving|cores|past256|exact|q8ring|moetail|q8tail]

At ViT-B/16 serving shape (B=128, N=197, 12 heads of 64, bf16 raw qkv
``[B, N, 3C]`` from a seed) it times, with CUDA events over 20 calls after
3 warm-up ones:

* K1, ``ops/mha_serving.mha_serving_fused`` (one kernel whatever the
  group: the TPU script's loop over ``group`` has no Hopper counterpart);
* ``mha_fused_reference``, the plain path K1 replaces: q, k, v transposed
  out of the buffer, the plain core (float64 sums), transposed back;
* K13, ``ops/flash_attention.flash_attention`` on the transposed q, k, v,
  and K14, ``ops/packed_attention.packed_attention`` on the raw buffer;
* ``F.scaled_dot_product_attention`` on the transposed q, k, v (a
  library's time for the max-subtracted softmax: a yardstick, never
  called by the port);
* K13 at the segmentation shape, B=1, N=1025, 12 heads of 64 with an fp32
  [12, 1025, 1025] bias, beside SDPA with the bias (in bf16) as its mask;
* K9, ``ops/mha_serving.mha_windowed_fused``, at the segmentation shape
  with B=1 and 2 and the layer's padded bf16 bias: the launch through its
  C entry alone (the kernel's time: at B=1 the wrapper's host checks take
  longer than the kernel), the wrapper, and the host's time a wrapper call
  (200 calls on the host's clock, the card idle first), beside SDPA with
  the bias as its mask;
* a 4096^3 bf16 matmul, the calibration anchor of the TPU script.

With ``--part cores`` (or ``all``) it times the cores that serve head dims
192 and 256 in bf16 and the fp32 forms, through their public wrappers:
each wrapper's device time a call (``torch.profiler``: the sum of its
kernels' times over 20 calls, so the wrapper's host checks, which outlast
a kernel of a few tens of microseconds, do not count) and its time on CUDA
events (host work included), beside its bound
(``utils/profiling.py::bound_ms``) and, where one PyTorch call computes the
same function, SDPA's device time:

* K15 and K1 in bf16 at B=32, N=197, C=768 in 4 heads of 192 and C=1024 in
  4 heads of 256 (K15 on views of the raw qkv, SDPA on contiguous q, k,
  v), and K3 (F = 64) and K10 (the int8-score wgmma core) there, and K10
  at C=768 in 12 heads of 64 (the same products); K9 in bf16 at head dims
  192 and 256 (B=1 and 2, N=1025, 4 heads) beside SDPA with its bias as
  the mask;
* past head dim 256 (``--part past256`` times these alone): K15, K1, K10,
  K2, K3 and K7 (4 experts of 64) in bf16 and K1, K2, K3 and K7 in fp32
  at B=32, N=197, C=768 in 2 heads of 384, and K9 in bf16 at B=1 and 2
  and in fp32 at B=1, N=1025 there (a tree that refuses the head dim
  prints so); then, end to end in 2 heads of 384, ``speed.main --mode
  dispatch`` at batch 128 in bf16 and fp32 (ViT-B/16 weights from a seed)
  and ``predict.serve`` on 512 synthetic 256^2 canvases at batch 128
  (img/s, best of 4 on the host's clock);
* K1 in fp32 at ViT-B/16 rows (B=32, N=197, 12 heads of 64) beside SDPA in
  fp32 with TF32 off, and K10 there (the int8-score form, float64 sums); K9 in fp32 at the seg crop (B=1, N=1025) with its
  bf16 bias, beside SDPA with the bias as its mask;
* K2, K3 and K7 (4 experts of 64) with fp32 weights at B=32;
* the host's time a call of the bf16 core's C entry (``dyt_mha_core``, K1
  mode, B=32, N=197) at head dims 64 (the staged kernel: no tensor map)
  and 192 (the wide kernel: three maps encoded a call), 200 calls on the
  host's clock from an idle card (trees whose entry takes that form).

With ``--part exact`` (alone) it splits the exact fp32 route: K6 and K8
with fp32 adapters and experts at B=32, N=197, C=768, 12 heads of 64,
F=64 and 4 experts of 64, each launch inside them by its kernel's name
(device time a call, torch.profiler: LN and quantization, the int8
GEMMs, the exact core, the router, the tail's products), the wholes; the
exact core alone through its C entry at head dims 64, 128, 192 and 256
(C=768 in 12, 6 and 4 heads, C=1024 in 4); the fp32 tails alone (adapter
F=64 and MoE 4 x 64, both with the token router); K3 and K7 with fp32
weights; then ``speed.main --compute_dtype float32 --residual_dtype
float32 --mode dispatch --quant int8`` with and without ``--moe_experts
4`` at batch 128 (img/s; ViT-B/16 weights from a seed).

With ``--part q8ring`` (alone) it times K10's int8-score core where the
wgmma key ring (``csrc/q8_ring.cu``) serves it: K10 and K6 (F = 64, with
int8 scores) at B=32, N=197, C=768 in 2 heads of 384, K10 at head dim 192
with N = 320 and at 256 with N = 300 (past the staged core's layout), each
with its kernels' split (the two code kernels, the ring), beside its bound;
then ``predict.serve --num_heads 2 --quant int8_attn`` on 512 synthetic
256^2 canvases at batch 128 (img/s, best of 4); then, on a tree that has
the ring, at N = 197 and head dims 64, 128, 192 and 256 (C = 768 in 12, 6
and 4 heads, C = 1024 in 4), where the staged core serves K10, the ring
through its C entry beside it.  With ``--part moetail`` (alone) it times
the bf16 MoE tail at 4 experts of 192 (E * b = 768): the tail alone on
ViT-B/16 rows (B=32) with the router, K7 and K8 (the int8 chain) there,
each beside its bound; the tail alone at 3 x 256, 4 x 256, 8 x 128 and
16 x 64 where the tree's wgmma tail takes them; then ``speed.main --mode
dispatch --moe_experts 4 --ffn_num 192`` at batch 32, bf16 and ``--quant int8`` (img/s; ViT-B/16 weights from a seed).

With ``--part q8tail`` (alone) it times K10's int8 scores on fp32 qkv
and the bf16 adapter tail past width 128, each by kernel beside its
bound: K10 on fp32 qkv at B=32, N=197, C=768 in 12, 6 and 4 heads and
C=1024 in 4 (head dims 64 to 256); K6 with fp32 adapters and int8 scores
(12 heads of 64, F=64); K3 and K6 (int8) in bf16 at F=256 and the
adapter/router tail alone there (bf16 out, with the router) and at
F=1024; then ``speed.main --compute_dtype float32 --residual_dtype
float32 --mode dispatch --quant int8_attn`` and ``speed.main --mode
dispatch --ffn_num 256`` in bf16 and ``--quant int8``, at batch 128
(img/s; ViT-B/16 weights from a seed).

Every case touches only the wrappers and C entries that every tree of the
port since its fp32 forms has, so this script can time an older tree
(``PYTHONPATH=<tree> python <this file>``; run the two in turns, other,
this, this, other, in one call to compare them on one card).  Prints the
card's name and power limit first and, with ``--part cores``, one JSON
line of its numbers last.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import time

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import dynamic_tuning_tpu_torch as pkg
from dynamic_tuning_tpu_torch.ops import _build
from dynamic_tuning_tpu_torch.ops import flash_attention as fa
from dynamic_tuning_tpu_torch.ops import mha_serving as ms
from dynamic_tuning_tpu_torch.ops import packed_attention as pa
from dynamic_tuning_tpu_torch.ops import quant as qt
from dynamic_tuning_tpu_torch.utils.profiling import (PEAK, bound_ms,
                                                      card_line, time_ms)

B, N, H, HD = 128, 197, 12, 64
C = H * HD
SEG_N = 1025
CORES_B, F_ADAPT, E = 32, 64, 4
BF, F32 = torch.bfloat16, torch.float32


def main(args) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_attention times the GPU and found no "
                           "CUDA device")
    print(f"card: {card_line()}; package: "
          f"{os.path.dirname(os.path.abspath(pkg.__file__))}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    times = serving(g) if args.part in ("all", "serving") else {}
    if args.part in ("all", "cores", "past256"):
        out = cores(g, past_only=args.part == "past256")
        print(json.dumps(out))
        times.update(out)
    if args.part in ("exact", "q8ring", "moetail", "q8tail"):
        out = {"exact": exact, "q8ring": q8ring, "moetail": moetail,
               "q8tail": q8tail}[args.part](g)
        print(json.dumps(out))
        times.update(out)
    return times


def serving(g) -> dict:
    """K1, its plain path, K13, K14 and SDPA at ViT-B/16 serving shape, K13
    and K9 at the segmentation shape, and the matmul anchor."""
    qkv = torch.randn((B, N, 3 * C), generator=g, device="cuda").to(
        torch.bfloat16)
    q, k, v = (t.contiguous() for t in
               qkv.view(B, N, 3, H, HD).permute(2, 0, 3, 1, 4))
    bias = torch.randn((H, SEG_N, SEG_N), generator=g, device="cuda")
    mask = bias.to(torch.bfloat16)[None]
    sq, sk, sv = (torch.randn((1, H, SEG_N, HD), generator=g, device="cuda")
                  .to(torch.bfloat16) for _ in range(3))
    times = {
        "k1": time_ms(lambda: ms.mha_serving_fused(qkv, heads=H)),
        "plain": time_ms(lambda: ms.mha_fused_reference(qkv, heads=H)),
        "k13": time_ms(lambda: fa.flash_attention(q, k, v)),
        "k14": time_ms(lambda: pa.packed_attention(qkv, num_heads=H)),
        "sdpa": time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
        "k13_bias": time_ms(lambda: fa.flash_attention(sq, sk, sv, bias)),
        "sdpa_bias": time_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=mask)),
    }
    print(f"transpose + plain core : {times['plain']:8.4f} ms")
    print(f"K1 mha_serving_fused   : {times['k1']:8.4f} ms (one kernel for "
          "any group)")
    print(f"K13 flash_attention    : {times['k13']:8.4f} ms")
    print(f"K14 packed_attention   : {times['k14']:8.4f} ms")
    print(f"SDPA (reference only)  : {times['sdpa']:8.4f} ms")
    print(f"K13, N={SEG_N}, fp32 bias: {times['k13_bias']:8.4f} ms")
    print(f"SDPA, the bias as mask : {times['sdpa_bias']:8.4f} ms")
    times.update(time_k9(g))
    a = torch.randn((4096, 4096), generator=g, device="cuda").to(
        torch.bfloat16)
    b = torch.randn((4096, 4096), generator=g, device="cuda").to(
        torch.bfloat16)
    t = time_ms(lambda: torch.matmul(a, b))
    print(f"matmul 4096^3          : {t:8.4f} ms "
          f"{2 * 4096 ** 3 / t / 1e9:6.1f} TFLOP/s")
    return times


def time_k9(g) -> dict:
    """K9 at B=1 and 2, N=1025, 12 heads of 64, the padded bf16 bias."""
    lib = _build.library()
    ld = ms.bias_row_stride(SEG_N)
    bias = (torch.randn((H, SEG_N, ld), generator=g, device="cuda")
            .to(torch.bfloat16)[:, :, :SEG_N])
    mask = bias.contiguous()[None]
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for batch in (1, 2):
        qkv = torch.randn((batch, SEG_N, 3 * C), generator=g,
                          device="cuda").to(torch.bfloat16)
        out = torch.empty((batch, SEG_N, C), dtype=torch.bfloat16,
                          device="cuda")
        q, k, v = (t.contiguous() for t in qkv.view(
            batch, SEG_N, 3, H, HD).permute(2, 0, 3, 1, 4))
        wrapper = lambda: ms.mha_windowed_fused(qkv, bias, heads=H)

        def launch():
            _build.check(lib, lib.dyt_mha_windowed(
                qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), batch,
                SEG_N, C, H, bias.stride(0), bias.stride(1), HD ** -0.5,
                stream), "windowed attention kernel")

        t = {"k9": time_ms(launch, iters=100),
             "k9_wrapper": time_ms(wrapper, iters=100),
             "k9_sdpa": time_ms(lambda: F.scaled_dot_product_attention(
                 q, k, v, attn_mask=mask))}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            wrapper()
        t["k9_host"] = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
        print(f"K9, B={batch}, N={SEG_N}: kernel {t['k9']:.4f} ms, through "
              f"the wrapper {t['k9_wrapper']:.4f} ms, host {t['k9_host']:.4f}"
              f" ms a wrapper call; SDPA, the bias as mask "
              f"{t['k9_sdpa']:.4f} ms")
        times.update({f"{k}_b{batch}": val for k, val in t.items()})
    return times


def device_ms(fn, iters: int = 20) -> float:
    """Device ms a call of ``fn``: the kernels' summed time over ``iters``
    calls (after one untimed call), from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if not us:
        raise RuntimeError("the trace holds no device activity")
    return us / iters / 1e3


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _line(out, name, fn, inputs, ops, library=None) -> None:
    """``fn``'s device ms and event ms beside its bound and ``library``'s
    device ms."""
    result = fn()
    result = result if isinstance(result, tuple) else (result,)
    ms_k, ms_e = device_ms(fn), time_ms(fn)
    lib = None if library is None else device_ms(library)
    b, by = bound_ms(_nbytes(*inputs) + _nbytes(*result), ops)
    out[name] = dict(ms=round(ms_k, 4), event_ms=round(ms_e, 4),
                     bound_ms=round(b, 4), bound_by=by,
                     library_ms=None if lib is None else round(lib, 4))
    txt = "" if lib is None else f", SDPA {lib:.4f} ms"
    print(f"{name}: {ms_k:.4f} ms on the device ({ms_e:.4f} on events)"
          f"{txt}; bound {b:.4f} ms ({by}, {100 * b / ms_k:.0f}%)",
          flush=True)


def _qkv(g, batch, tokens, width, dtype):
    qkv = torch.randn((batch, tokens, 3 * width), generator=g,
                      device="cuda")
    qkv[..., width:2 * width] += 1.0               # keys with a lane offset
    return qkv.to(dtype)


def _split(qkv, heads):
    Bq, Nq, C3 = qkv.shape
    return qkv.view(Bq, Nq, 3, heads, C3 // 3 // heads).permute(2, 0, 3, 1,
                                                                 4)


def _weights(g, width, dtype):
    r = lambda *s, sc=1.0: torch.randn(  # noqa: E731
        s, generator=g, device="cuda") * sc
    sub = (r(width, sc=0.05) + 1.0, r(width, sc=0.02),
           r(3 * width, width, sc=0.03).to(dtype), r(3 * width, sc=0.02),
           r(width, width, sc=0.03).to(dtype), r(width, sc=0.02))
    ad = (r(F_ADAPT, width, sc=0.03).to(dtype), r(F_ADAPT, sc=0.02),
          r(width, F_ADAPT, sc=0.02).to(dtype), r(width, sc=0.01),
          torch.full((1,), 0.1, device="cuda"),
          r(1, width, sc=25.0 / width ** 0.5), r(1, sc=0.1))
    moe = (r(E, width, sc=2.0 / width ** 0.5),
           *ms.moe_kernel_weights(r(E, width, F_ADAPT, sc=0.03),
                                  r(E, F_ADAPT, sc=0.02),
                                  r(E, F_ADAPT, width, sc=0.02), dtype),
           r(E, width, sc=0.01), ad[4])
    return sub, ad, moe


def cores(g, past_only: bool = False) -> dict:
    """The bf16 cores at head dims 192 and 256 and the fp32 forms (the
    module docstring's list), or with ``past_only`` those past head dim
    256 alone, with TF32 off for the fp32 ones."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        if past_only:
            out = {}
            _past_256_all(out, g)
            return out
        return _cores(g)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _cores(g) -> dict:
    out = {}
    for width, heads in ((768, 4), (1024, 4)):
        hd = width // heads
        qkv = _qkv(g, CORES_B, N, width, BF)
        q, k, v = _split(qkv, heads)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qc, kc, vc)  # noqa
        ops = {"bf16": 4 * CORES_B * heads * N * N * hd}
        _line(out, f"K15 bf16 hd {hd}", lambda: ms.mha_serving(q, k, v),
              (qkv,), ops, sdpa)
        _line(out, f"K1 bf16 hd {hd}",
              lambda: ms.mha_serving_fused(qkv, heads=heads), (qkv,), ops,
              sdpa)
        x = torch.randn((CORES_B, N, width), generator=g,
                        device="cuda").to(BF)
        sub, ad, _ = _weights(g, width, BF)
        M = CORES_B * N
        _line(out, f"K3 bf16 hd {hd}",
              lambda: ms.dyt_prologue_serving(x, *sub, *ad, heads=heads),
              (x, *sub, *ad),
              {"bf16": 8 * M * width * width
               + 4 * CORES_B * heads * N * N * hd
               + 4 * M * width * F_ADAPT, "fp32": 2 * M * width})
        _line(out, f"K10 bf16 hd {hd}",
              lambda: qt.attn_core_pairs_q8(qkv, heads=heads), (qkv,),
              {"int8": ops["bf16"] // 2, "bf16": ops["bf16"] // 2})
    qkv = _qkv(g, CORES_B, N, 768, BF)
    _line(out, "K10 bf16 hd 64 (12 heads, C=768)",
          lambda: qt.attn_core_pairs_q8(qkv, heads=12), (qkv,),
          {"int8": 2 * CORES_B * 768 * N * N,
           "bf16": 2 * CORES_B * 768 * N * N})
    for width in (768, 1024):
        for batch in (1, 2):
            _k9(out, g, width, 4, batch)
    _past_256_all(out, g)
    qkv = _qkv(g, CORES_B, N, C, F32)
    q, k, v = (t.contiguous() for t in _split(qkv, H))
    attn = 4 * CORES_B * H * N * N * HD
    _line(out, "K1 fp32", lambda: ms.mha_serving_fused(qkv, heads=H),
          (qkv,), {"fp32": attn},
          lambda: F.scaled_dot_product_attention(q, k, v))
    _line(out, "K10 fp32", lambda: qt.attn_core_pairs_q8(qkv, heads=H),
          (qkv,), {"int8": attn // 2, "fp32": attn // 2})
    sq = _qkv(g, 1, SEG_N, C, F32)
    ld = ms.bias_row_stride(SEG_N)
    bias = (torch.randn((H, SEG_N, ld), generator=g, device="cuda")
            .to(BF)[:, :, :SEG_N])
    q9, k9, v9 = (t.contiguous() for t in _split(sq, H))
    mask = bias.float().contiguous()[None]
    _line(out, "K9 fp32", lambda: ms.mha_windowed_fused(sq, bias, heads=H),
          (sq, bias.contiguous()), {"fp32": 4 * H * SEG_N * SEG_N * HD},
          lambda: F.scaled_dot_product_attention(q9, k9, v9, attn_mask=mask))
    x = torch.randn((CORES_B, N, C), generator=g, device="cuda")
    sub, ad, moe = _weights(g, C, F32)
    M = CORES_B * N
    gemm = 8 * M * C * C
    for name, call, ins, ops in (
            ("K2 fp32", lambda: ms.attention_sublayer_serving(x, *sub,
                                                              heads=H),
             (x, *sub), gemm + attn),
            ("K3 fp32", lambda: ms.dyt_prologue_serving(x, *sub, *ad,
                                                        heads=H),
             (x, *sub, *ad), gemm + attn + 4 * M * C * F_ADAPT + 2 * M * C),
            ("K7 fp32 (4 x 64)", lambda: ms.dyt_prologue_serving_moe(
                x, *sub, *moe, *ad[5:], heads=H, tau=1.0),
             (x, *sub, *moe, *ad[5:]),
             gemm + attn + 4 * M * C * E * F_ADAPT + 2 * M * C * (E + 1))):
        _line(out, name, call, ins, {"fp32": ops})
    if len(_build._SIGNATURES["dyt_mha_core"]) == 12:
        for width, heads in ((768, 12), (768, 4)):
            qkv = _qkv(g, CORES_B, N, width, BF)
            hd = width // heads
            us = entry_host_us(*_split(qkv, heads))
            out[f"dyt_mha_core host us, hd {hd}"] = round(us, 2)
            print(f"dyt_mha_core, hd {hd}: {us:.2f} us of host time a call",
                  flush=True)
    return out


def kernel_split(fn, iters: int = 20) -> dict:
    """Device ms a call of ``fn`` by kernel name (torch.profiler over
    ``iters`` calls, after one untimed call), in the order first seen."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            split[e.name] = split.get(e.name, 0.0) + e.time_range.elapsed_us()
    return {k: v / iters / 1e3 for k, v in split.items()}


def _exact_core_entry(lib):
    """The exact core's C entry: ``dyt_exact_core``, or on a tree before
    it the SIMT core's ``dyt_simt_core_exact`` (the same arguments)."""
    try:
        return lib.dyt_exact_core
    except AttributeError:
        return lib.dyt_simt_core_exact


def exact(g) -> dict:
    """The ``--part exact`` list of the module docstring, TF32 off."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _exact(g)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _exact(g) -> dict:
    # float64 products at the FP64 tensor peak ("fp64"; a tree before that
    # key counts them under "fp32", the same rate)
    f64 = "fp64" if "fp64" in PEAK else "fp32"
    out = {}
    M = CORES_B * N
    gemm = 8 * M * C * C
    attn = 4 * CORES_B * H * N * N * HD
    adapter = 4 * M * C * F_ADAPT
    experts = 4 * M * C * E * F_ADAPT
    x = torch.randn((CORES_B, N, C), generator=g, device="cuda")
    sub, ad, moe = _weights(g, C, F32)
    qsub = (*sub[:2], *qt.quantize_weight(sub[2]), sub[3],
            *qt.quantize_weight(sub[4]), sub[5])
    for name, call, ins, ops in (
            ("K6 fp32", lambda: qt.dyt_prologue_serving_q8(x, *qsub, *ad,
                                                           heads=H),
             (x, *qsub, *ad),
             {"int8": gemm, f64: attn + adapter + 2 * M * C}),
            ("K8 fp32 (4 x 64)", lambda: qt.dyt_prologue_serving_q8_moe(
                x, *qsub, *moe, *ad[5:], heads=H, tau=1.0),
             (x, *qsub, *moe, *ad[5:]),
             {"int8": gemm,
              f64: attn + experts + 2 * M * C * (E + 1)})):
        _line(out, name, call, ins, ops)
        for kernel, t in kernel_split(call).items():
            out[f"{name} / {kernel[:60]}"] = round(t, 4)
            print(f"  {kernel[:100]}: {t:.4f} ms", flush=True)
    lib = _build.library()
    entry = _exact_core_entry(lib)
    for width, heads in ((768, 12), (768, 6), (768, 4), (1024, 4)):
        hd = width // heads
        qkv = _qkv(g, CORES_B, N, width, F32)
        o = torch.empty((CORES_B, N, width), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def core(qkv=qkv, o=o, heads=heads, width=width, hd=hd):
            _build.check(lib, entry(qkv.data_ptr(), o.data_ptr(), CORES_B, N,
                                    width, heads, hd ** -0.5, stream),
                         "exact core")
            return o
        core()
        if not torch.equal(core(), ms.attn_core_pairs(qkv, heads=heads)):
            print(f"exact core hd {hd}: NOT bit-identical to the plain "
                  "version", flush=True)
        _line(out, f"exact core hd {hd}", core, (qkv,),
              {f64: 4 * CORES_B * heads * N * N * hd})
    x_mid = torch.randn((CORES_B, N, C), generator=g, device="cuda")
    _line(out, "fp32 adapter tail (F=64, router)",
          lambda: ms.launch_adapter_router(lib, x_mid, x_mid, *ad[:5],
                                           *ad[5:], True)[1:],
          (x_mid, *ad), {f64: adapter + 2 * M * C})
    _line(out, "fp32 MoE tail (4 x 64, router)",
          lambda: ms.launch_moe_adapter_router(lib, x_mid, x_mid, *moe,
                                               *ad[5:], 1.0, True)[1:],
          (x_mid, *moe, *ad[5:]), {f64: experts + 2 * M * C * (E + 1)})
    for name, call, ins, ops in (
            ("K3 fp32", lambda: ms.dyt_prologue_serving(x, *sub, *ad,
                                                        heads=H),
             (x, *sub, *ad),
             _ops(("fp32", gemm + attn), (f64, adapter + 2 * M * C))),
            ("K7 fp32 (4 x 64)", lambda: ms.dyt_prologue_serving_moe(
                x, *sub, *moe, *ad[5:], heads=H, tau=1.0),
             (x, *sub, *moe, *ad[5:]),
             _ops(("fp32", gemm + attn),
                  (f64, experts + 2 * M * C * (E + 1))))):
        _line(out, name, call, ins, ops)
    _exact_forwards(out)
    return out


def _ops(*pairs) -> dict:
    """{type: operations} from (type, count) pairs, a type's counts added."""
    ops = {}
    for kind, n in pairs:
        ops[kind] = ops.get(kind, 0) + n
    return ops


def _exact_forwards(out) -> None:
    """img/s of the fp32 int8 dispatch forward (ViT-B/16, batch 128), with
    adapters and with 4 experts of 64."""
    from unittest import mock

    import numpy as np

    from dynamic_tuning_tpu_torch import speed
    from dynamic_tuning_tpu_torch.checkpoint import make_vit_state_dict
    for moe in (0, E):
        sd = {k: torch.from_numpy(v) for k, v in make_vit_state_dict(
            np.random.RandomState(0), depth=12, dim=C, ffn=F_ADAPT,
            classes=100, img=224, patch=16, router_scale=25.0,
            moe_experts=moe).items()}
        flags = ["--compute_dtype", "float32", "--residual_dtype", "float32",
                 "--mode", "dispatch", "--quant", "int8"]
        if moe:
            flags += ["--moe_experts", str(moe)]
        args = speed.get_args_parser().parse_args(flags)
        with contextlib.redirect_stdout(io.StringIO()), mock.patch.object(
                torch.nn.init, "trunc_normal_", lambda t, *a, **k: t):
            ips = speed.main(args, state_dict=sd)["throughput_img_s"]
        key = f"speed fp32 int8 dispatch{' moe4' if moe else ''} img/s"
        out[key] = ips
        print(f"speed {' '.join(flags)} (batch 128): {ips} img/s",
              flush=True)
        del sd
        torch.cuda.empty_cache()


def _k9(out, g, width, heads, batch=1, dtype=BF) -> None:
    """K9 at B=``batch``, N=SEG_N in ``heads`` heads of ``width``, bf16 or
    fp32 qkv with the bf16 bias, beside SDPA with the bias as the mask."""
    hd = width // heads
    sq = _qkv(g, batch, SEG_N, width, dtype)
    ld = ms.bias_row_stride(SEG_N)
    bias = (torch.randn((heads, SEG_N, ld), generator=g, device="cuda")
            .to(BF)[:, :, :SEG_N])
    q9, k9, v9 = (t.contiguous() for t in _split(sq, heads))
    mask = bias.to(dtype).contiguous()[None]
    kind = "bf16" if dtype == BF else "fp32"
    _line(out, f"K9 {kind} hd {hd}" + (f" B={batch}" if batch > 1 else ""),
          lambda: ms.mha_windowed_fused(sq, bias, heads=heads),
          (sq, bias.contiguous()),
          {kind: 4 * batch * heads * SEG_N * SEG_N * hd},
          lambda: F.scaled_dot_product_attention(q9, k9, v9, attn_mask=mask))


def _past_256_all(out, g) -> None:
    """The cores past head dim 256 (2 heads of 384) and the forwards that
    run them, or the refusal of a tree that does not take the head dim."""
    for name, fn in (
            ("hd 384", _past_256),
            ("K9 bf16 hd 384", lambda o, g_: _k9(o, g_, 768, 2)),
            ("K9 bf16 hd 384 B=2", lambda o, g_: _k9(o, g_, 768, 2, 2)),
            ("K9 fp32 hd 384", lambda o, g_: _k9(o, g_, 768, 2, 1, F32)),
            ("forwards hd 384", _past_256_forwards)):
        try:
            fn(out, g)
        except ValueError as e:               # a tree that refuses hd 384
            print(f"{name}: refused ({e})", flush=True)


def _past_256_forwards(out, g) -> None:
    """img/s of ViT-B/16 in 2 heads of 384: speed.main (dispatch, batch
    128, bf16 and fp32) and predict.serve (512 canvases, batch 128, best of
    4)."""
    from unittest import mock

    import numpy as np

    from dynamic_tuning_tpu_torch import predict, speed
    from dynamic_tuning_tpu_torch.checkpoint import make_vit_state_dict
    sd = {k: torch.from_numpy(v) for k, v in make_vit_state_dict(
        np.random.RandomState(0), depth=12, dim=C, ffn=F_ADAPT,
        classes=100, img=224, patch=16, router_scale=25.0).items()}
    for kind, flags in (("bf16", []),
                        ("fp32", ["--compute_dtype", "float32",
                                  "--residual_dtype", "float32"])):
        args = speed.get_args_parser().parse_args(
            ["--num_heads", "2", "--mode", "dispatch"] + flags)
        # every parameter comes from the state dict: the init draws skipped
        with contextlib.redirect_stdout(io.StringIO()), mock.patch.object(
                torch.nn.init, "trunc_normal_", lambda t, *a, **k: t):
            ips = speed.main(args, state_dict=sd)["throughput_img_s"]
        out[f"speed {kind} hd 384 img/s"] = ips
        print(f"speed --num_heads 2 --mode dispatch {kind} (batch 128): "
              f"{ips} img/s", flush=True)
        torch.cuda.empty_cache()
    canv = torch.randint(0, 256, (512, 256, 256, 3), generator=g,
                         device="cuda", dtype=torch.uint8)
    a = predict.get_args_parser().parse_args(
        ["--ckpt", "unused", "--images", "unused", "--num_heads", "2",
         "--batch_size", "128"])
    params = predict.load_params(a, torch.device("cuda"), state_dict=sd)
    best = 0.0
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            predict.serve(a, canv, params)
        torch.cuda.synchronize()
        best = max(best, canv.shape[0] / (time.perf_counter() - t0))
    out["predict.serve hd 384 img/s"] = round(best, 2)
    print(f"predict.serve --num_heads 2 (512 canvases, batch 128): "
          f"{best:.2f} img/s", flush=True)


def _past_256(out, g) -> None:
    """The cores and sublayers at B=32, N=197, C=768 in 2 heads of 384."""
    width, heads = 768, 2
    hd = width // heads
    qkv = _qkv(g, CORES_B, N, width, BF)
    q, k, v = _split(qkv, heads)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qc, kc, vc)  # noqa
    attn = 4 * CORES_B * heads * N * N * hd
    ops = {"bf16": attn}
    _line(out, f"K15 bf16 hd {hd}", lambda: ms.mha_serving(q, k, v),
          (qkv,), ops, sdpa)
    _line(out, f"K1 bf16 hd {hd}",
          lambda: ms.mha_serving_fused(qkv, heads=heads), (qkv,), ops, sdpa)
    _line(out, f"K10 bf16 hd {hd}",
          lambda: qt.attn_core_pairs_q8(qkv, heads=heads), (qkv,),
          {"int8": attn // 2, "bf16": attn // 2})
    qf = qkv.float()
    qfc, kfc, vfc = (t.contiguous() for t in _split(qf, heads))
    _line(out, f"K1 fp32 hd {hd}",
          lambda: ms.mha_serving_fused(qf, heads=heads), (qf,),
          {"fp32": attn},
          lambda: F.scaled_dot_product_attention(qfc, kfc, vfc))
    M = CORES_B * N
    gemm = 8 * M * width * width
    for dtype, kind in ((BF, "bf16"), (F32, "fp32")):
        x = torch.randn((CORES_B, N, width), generator=g,
                        device="cuda").to(dtype)
        sub, ad, moe = _weights(g, width, dtype)
        # a bf16 form's products at the bf16 tensor rate, its router and
        # the MoE gates in fp32; an fp32 form's all in fp32
        for name, call, ins, prod, f32_ops in (
                ("K2", lambda: ms.attention_sublayer_serving(
                    x, *sub, heads=heads), (x, *sub), gemm + attn, 0),
                ("K3", lambda: ms.dyt_prologue_serving(
                    x, *sub, *ad, heads=heads), (x, *sub, *ad),
                 gemm + attn + 4 * M * width * F_ADAPT, 2 * M * width),
                ("K7", lambda: ms.dyt_prologue_serving_moe(
                    x, *sub, *moe, *ad[5:], heads=heads, tau=1.0),
                 (x, *sub, *moe, *ad[5:]),
                 gemm + attn + 4 * M * width * E * F_ADAPT,
                 2 * M * width * (E + 1))):
            ops_ = ({"bf16": prod, "fp32": f32_ops} if dtype == BF
                    else {"fp32": prod + f32_ops})
            _line(out, f"{name} {kind} hd {hd}" + (
                f" ({E} x {F_ADAPT})" if name == "K7" else ""), call, ins,
                ops_)


def _split_line(out, name, fn) -> None:
    """``fn``'s device ms by kernel, under ``name / kernel``."""
    for kernel, t in kernel_split(fn).items():
        out[f"{name} / {kernel[:60]}"] = round(t, 4)
        print(f"  {kernel[:100]}: {t:.4f} ms", flush=True)


def q8ring(g) -> dict:
    """The ``--part q8ring`` list of the module docstring."""
    out = {}
    width = 768
    for heads, hd, tokens in ((2, 384, N), (2, 192, 320), (2, 256, 300)):
        qkv = _qkv(g, CORES_B, tokens, heads * hd, BF)
        attn = 4 * CORES_B * heads * tokens * tokens * hd
        name = f"K10 bf16 hd {hd} N={tokens}"

        def call(qkv=qkv, heads=heads):
            return qt.attn_core_pairs_q8(qkv, heads=heads)
        _line(out, name, call, (qkv,), {"int8": attn // 2, "bf16": attn // 2})
        _split_line(out, name, call)
    heads, hd = 2, 384
    M = CORES_B * N
    attn = 4 * CORES_B * heads * N * N * hd
    x = torch.randn((CORES_B, N, width), generator=g, device="cuda").to(BF)
    sub, ad, _ = _weights(g, width, BF)
    qsub = (*sub[:2], *qt.quantize_weight(sub[2].float()), sub[3],
            *qt.quantize_weight(sub[4].float()), sub[5])

    def k6():
        return qt.dyt_prologue_serving_q8(x, *qsub, *ad, heads=heads,
                                          attn_q8=True)
    _line(out, f"K6 bf16 hd {hd} int8 scores", k6, (x, *qsub, *ad),
          {"int8": 8 * M * width * width + attn // 2,
           "bf16": attn // 2 + 4 * M * width * F_ADAPT,
           "fp32": 2 * M * width})
    _split_line(out, f"K6 bf16 hd {hd} int8 scores", k6)
    _serve_forward(out, g, ["--num_heads", "2", "--quant", "int8_attn"],
                   "predict.serve hd 384 int8_attn img/s")
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    for hs, cw in ((12, 768), (6, 768), (4, 768), (4, 1024)):
        if not hasattr(lib, "dyt_attn_core_q8_ring"):
            break
        hd_ = cw // hs
        qkv = _qkv(g, CORES_B, N, cw, BF)
        ops = {"int8": 2 * CORES_B * hs * N * N * hd_,
               "bf16": 2 * CORES_B * hs * N * N * hd_}
        _line(out, f"K10 bf16 hd {hd_} N={N} staged", lambda qkv=qkv, h=hs:
              qt.attn_core_pairs_q8(qkv, heads=h), (qkv,), ops)
        ring_out = torch.empty((CORES_B, N, cw), dtype=BF, device="cuda")
        scratch = torch.empty((lib.dyt_simt_core_q8_scratch_bytes(
            CORES_B, N, cw, hs),), dtype=torch.uint8, device="cuda")

        def ring(qkv=qkv, h=hs, o=ring_out, s=scratch, w=cw):
            _build.check(lib, lib.dyt_attn_core_q8_ring(
                qkv.data_ptr(), o.data_ptr(), s.data_ptr(), CORES_B, N, w, h,
                (w // h) ** -0.5, stream), "int8-score key ring")
            return o
        _line(out, f"K10 bf16 hd {hd_} N={N} ring", ring, (qkv,), ops)
    return out


def _serve_forward(out, g, flags, key) -> None:
    """img/s of ``predict.serve`` with ``flags`` on 512 synthetic canvases at
    batch 128 (ViT-B/16 weights from a seed; best of 4)."""
    import numpy as np

    from dynamic_tuning_tpu_torch import predict
    from dynamic_tuning_tpu_torch.checkpoint import make_vit_state_dict
    sd = {k: torch.from_numpy(v) for k, v in make_vit_state_dict(
        np.random.RandomState(0), depth=12, dim=C, ffn=F_ADAPT,
        classes=100, img=224, patch=16, router_scale=25.0).items()}
    canv = torch.randint(0, 256, (512, 256, 256, 3), generator=g,
                         device="cuda", dtype=torch.uint8)
    a = predict.get_args_parser().parse_args(
        ["--ckpt", "unused", "--images", "unused", "--batch_size", "128"]
        + flags)
    params = predict.load_params(a, torch.device("cuda"), state_dict=sd)
    best = 0.0
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            predict.serve(a, canv, params)
        torch.cuda.synchronize()
        best = max(best, canv.shape[0] / (time.perf_counter() - t0))
    out[key] = round(best, 2)
    print(f"predict.serve {' '.join(flags)} (512 canvases, batch 128): "
          f"{best:.2f} img/s", flush=True)
    del params
    torch.cuda.empty_cache()


def moetail(g) -> dict:
    """The ``--part moetail`` list of the module docstring."""
    from unittest import mock

    from dynamic_tuning_tpu_torch import speed
    out = {}
    lib = _build.library()
    M = CORES_B * N
    E_, b_ = 4, 192
    W = E_ * b_
    x = torch.randn((CORES_B, N, C), generator=g, device="cuda").to(BF)
    x_mid = torch.randn((CORES_B, N, C), generator=g, device="cuda")
    x_mid_bf = x_mid.to(BF)
    sub, ad, _ = _weights(g, C, BF)
    r = lambda *s_, sc=1.0: torch.randn(  # noqa: E731
        s_, generator=g, device="cuda") * sc

    def experts(E, b):
        return (r(E, C, sc=2.0 / C ** 0.5),
                *ms.moe_kernel_weights(r(E, C, b, sc=0.03), r(E, b, sc=0.02),
                                       r(E, b, C, sc=0.02), BF),
                r(E, C, sc=0.01), ad[4])
    moe = experts(E_, b_)
    tail_ops = {"bf16": 4 * M * C * W, "fp32": 2 * M * C * (E_ + 1)}
    _line(out, f"MoE tail bf16 {E_} x {b_} (router)",
          lambda: ms.launch_moe_adapter_router(lib, x_mid_bf, x_mid, *moe,
                                               *ad[5:], 1.0, True)[1:],
          (x_mid, *moe, *ad[5:]), tail_ops)
    qsub = (*sub[:2], *qt.quantize_weight(sub[2].float()), sub[3],
            *qt.quantize_weight(sub[4].float()), sub[5])
    attn = 4 * CORES_B * H * N * N * HD
    gemm = 8 * M * C * C
    for name, call, ins, ops in (
            ("K7", lambda: ms.dyt_prologue_serving_moe(
                x, *sub, *moe, *ad[5:], heads=H, tau=1.0),
             (x, *sub, *moe, *ad[5:]),
             {"bf16": gemm + attn + tail_ops["bf16"],
              "fp32": tail_ops["fp32"]}),
            ("K8", lambda: qt.dyt_prologue_serving_q8_moe(
                x, *qsub, *moe, *ad[5:], heads=H, tau=1.0),
             (x, *qsub, *moe, *ad[5:]),
             {"int8": gemm, "bf16": attn + tail_ops["bf16"],
              "fp32": tail_ops["fp32"]})):
        _line(out, f"{name} bf16 {E_} x {b_}", call, ins, ops)
        _split_line(out, f"{name} bf16 {E_} x {b_}", call)
    for E, b in ((3, 256), (4, 256), (8, 128), (16, 64)):
        ex = experts(E, b)
        if ms.check_moe_adapter_router(lib, x_mid_bf, *ex, *ad[5:],
                                       True) != "wgmma":
            print(f"MoE tail {E} x {b}: not on the wgmma tail", flush=True)
            continue
        _line(out, f"MoE tail bf16 {E} x {b} (router)",
              lambda ex=ex: ms.launch_moe_adapter_router(
                  lib, x_mid_bf, x_mid, *ex, *ad[5:], 1.0, True)[1:],
              (x_mid, *ex, *ad[5:]),
              {"bf16": 4 * M * C * E * b, "fp32": 2 * M * C * (E + 1)})
    import numpy as np

    from dynamic_tuning_tpu_torch.checkpoint import make_vit_state_dict
    sd = {k: torch.from_numpy(v) for k, v in make_vit_state_dict(
        np.random.RandomState(0), depth=12, dim=C, ffn=b_, classes=100,
        img=224, patch=16, router_scale=25.0, moe_experts=E_).items()}
    for flags in ([], ["--quant", "int8"]):
        args = speed.get_args_parser().parse_args(
            ["--mode", "dispatch", "--moe_experts", str(E_), "--ffn_num",
             str(b_), "--batch_size", "32"] + flags)
        # every parameter comes from the state dict: the init draws skipped
        with contextlib.redirect_stdout(io.StringIO()), mock.patch.object(
                torch.nn.init, "trunc_normal_", lambda t, *a, **k: t):
            ips = speed.main(args, state_dict=sd)["throughput_img_s"]
        key = f"speed moe 4 x 192{' int8' if flags else ''} img/s"
        out[key] = ips
        print(f"speed --mode dispatch --moe_experts 4 --ffn_num 192 "
              f"{' '.join(flags)} (batch 32): {ips} img/s", flush=True)
        torch.cuda.empty_cache()
    return out


def q8tail(g) -> dict:
    """The ``--part q8tail`` list of the module docstring, TF32 off."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _q8tail(g)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _q8tail(g) -> dict:
    from unittest import mock

    import numpy as np

    from dynamic_tuning_tpu_torch import speed
    from dynamic_tuning_tpu_torch.checkpoint import make_vit_state_dict
    f64 = "fp64" if "fp64" in PEAK else "fp32"
    out = {}
    lib = _build.library()
    M = CORES_B * N
    for width, heads in ((768, 12), (768, 6), (768, 4), (1024, 4)):
        hd = width // heads
        qkv = _qkv(g, CORES_B, N, width, F32)
        name = f"K10 fp32 hd {hd}"

        def call(qkv=qkv, heads=heads):
            return qt.attn_core_pairs_q8(qkv, heads=heads)
        # the int8 scores at the int8 peak, the float64 P V at the FP64
        # tensor peak
        _line(out, name, call, (qkv,),
              {"int8": 2 * CORES_B * heads * N * N * hd,
               f64: 2 * CORES_B * heads * N * N * hd})
        _split_line(out, name, call)
    gemm = 8 * M * C * C
    attn = 2 * CORES_B * H * N * N * HD
    x = torch.randn((CORES_B, N, C), generator=g, device="cuda")
    sub, ad, _ = _weights(g, C, F32)
    qsub = (*sub[:2], *qt.quantize_weight(sub[2]), sub[3],
            *qt.quantize_weight(sub[4]), sub[5])

    def k6():
        return qt.dyt_prologue_serving_q8(x, *qsub, *ad, heads=H,
                                          attn_q8=True)
    _line(out, "K6 fp32 int8 scores", k6, (x, *qsub, *ad),
          {"int8": gemm + attn,
           f64: attn + 4 * M * C * F_ADAPT + 2 * M * C})
    _split_line(out, "K6 fp32 int8 scores", k6)
    # bf16 at F = 256 (the weights at their kernel width: 256 is one)
    wide = 256
    r = lambda *s_, sc=1.0: torch.randn(  # noqa: E731
        s_, generator=g, device="cuda") * sc
    xb = x.to(BF)
    sub_b, _, _ = _weights(g, C, BF)
    qsub_b = (*sub_b[:2], *qt.quantize_weight(sub_b[2].float()), sub_b[3],
              *qt.quantize_weight(sub_b[4].float()), sub_b[5])
    x_mid = torch.randn((CORES_B, N, C), generator=g, device="cuda")
    x_mid_bf = x_mid.to(BF)
    for F in (wide, 1024):
        ad_b = (r(F, C, sc=0.03).to(BF), r(F, sc=0.02),
                r(C, F, sc=0.02).to(BF), r(C, sc=0.01), ad[4], ad[5], ad[6])
        tail = 4 * M * C * F
        _line(out, f"adapter tail bf16 F={F} (router)",
              lambda ad_b=ad_b: ms.launch_adapter_router(
                  lib, x_mid_bf, x_mid, *ad_b, True)[1:],
              (x_mid, *ad_b), {"bf16": tail, "fp32": 2 * M * C})
        if F != wide:
            continue
        for name, call, ins, ops in (
                (f"K3 bf16 F={F}", lambda: ms.dyt_prologue_serving(
                    xb, *sub_b, *ad_b, heads=H), (xb, *sub_b, *ad_b),
                 {"bf16": gemm + 2 * attn + tail, "fp32": 2 * M * C}),
                (f"K6 bf16 F={F}", lambda: qt.dyt_prologue_serving_q8(
                    xb, *qsub_b, *ad_b, heads=H), (xb, *qsub_b, *ad_b),
                 {"int8": gemm, "bf16": 2 * attn + tail,
                  "fp32": 2 * M * C})):
            _line(out, name, call, ins, ops)
            _split_line(out, name, call)
    for ffn, flags in (
            (F_ADAPT, ["--compute_dtype", "float32", "--residual_dtype",
                       "float32", "--quant", "int8_attn"]),
            (wide, ["--ffn_num", str(wide)]),
            (wide, ["--ffn_num", str(wide), "--quant", "int8"])):
        sd = {k: torch.from_numpy(v) for k, v in make_vit_state_dict(
            np.random.RandomState(0), depth=12, dim=C, ffn=ffn, classes=100,
            img=224, patch=16, router_scale=25.0).items()}
        args = speed.get_args_parser().parse_args(["--mode", "dispatch"]
                                                  + flags)
        with contextlib.redirect_stdout(io.StringIO()), mock.patch.object(
                torch.nn.init, "trunc_normal_", lambda t, *a, **k: t):
            ips = speed.main(args, state_dict=sd)["throughput_img_s"]
        key = f"speed {' '.join(flags)} img/s"
        out[key] = ips
        print(f"speed --mode dispatch {' '.join(flags)} (batch 128): {ips} "
              "img/s", flush=True)
        del sd
        torch.cuda.empty_cache()
    return out


def entry_host_us(q, k, v, calls: int = 200) -> float:
    """Host microseconds a call of ``dyt_mha_core`` (K1 mode) on strided
    bf16 q, k, v, from an idle card."""
    lib = _build.library()
    Bq, Hq, Nq, hd = q.shape
    o = torch.empty((Bq, Nq, Hq, hd), dtype=BF, device="cuda").transpose(1, 2)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _build.strides_arg(q, k, v, o), Bq, Nq, Hq, hd, hd ** -0.5, 0,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, lib.dyt_mha_core(*args), "attention core")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        _build.check(lib, lib.dyt_mha_core(*args), "attention core")
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--part", default="all",
                   choices=("all", "serving", "cores", "past256",
                            "exact", "q8ring", "moetail", "q8tail"))
    return p


if __name__ == "__main__":
    main(get_args_parser().parse_args())
