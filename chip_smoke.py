#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  1. build the CUDA kernels from dynamic_tuning_tpu_torch/csrc with nvcc;
  2. each kernel wrapper against its plain PyTorch version on the card at
     ViT-B/16 serving shapes (B=128, N=197, C=768, 12 heads, adapter 64,
     MLP 3072), with both times and the card's bound for the same work:
     K2 attention_sublayer_serving, K3 dyt_prologue_serving (with and
     without the router), K4 q8_ln_mlp (dense and dispatch rows), K5
     attention_sublayer_serving_q8, K6 dyt_prologue_serving_q8 (with and
     without the router), K10 attn_core_pairs_q8, K7
     dyt_prologue_serving_moe (4 experts of 64; with and without the
     router), K8 dyt_prologue_serving_q8_moe (with and without the router,
     and with the K10 core); then the hand int8 GEMM beside torch._int_mm
     and cuBLAS bf16 at the int8 path's GEMM shapes (reference times, not
     used by the port); then K9 mha_windowed_fused at the segmentation
     path's shape (N = 1025 tokens of a 512^2 crop, 12 heads of 64, a bf16
     bias in the layer's padded layout) at batch 1 and 2, beside
     F.scaled_dot_product_attention with the bias as its mask (a reference
     time only), and the time of the bias build that feeds it; then K11
     fused_ln_mlp at the speed-test path's rows (dispatch 128*99 without a
     gate, mask 128*197 with one, tanh GELU; a small ragged erf shape),
     beside the cuBLAS chain of fast_vit_forward(use_kernel=False)'s MLP (a
     reference time only); then the attention kernels at B=128, N=197,
     12 heads of 64, each beside F.scaled_dot_product_attention on the same
     q, k, v (a reference time only): K1 mha_serving_fused on raw qkv, K15
     mha_serving on contiguous q, k, v and on views of the raw qkv, K13
     flash_attention (and at B=1, N=1025 with an fp32 bias), K14
     packed_attention; K13 and K14, which only tests call, are first run
     once each as their own path with the counts set to 0; then K12
     q8_dispatch_mlp at the int8 dispatch path's shape (B=128, N=197,
     C=768, MLP 3072, K=99, tanh GELU) with seeded router scores of which
     about a tenth of the top K fall under the threshold, beside the
     Block's unfused chain (dispatch_mlp around q8_ln_mlp, a reference
     time) and whether the two agree bit for bit; then K16, the matmul
     probe utils/profile_int8.make_mm, at the probe's five shapes in int8
     (exact) and bf16 (within 2**-16 of the largest |output| of the
     float64 product: fp32 sums), each beside one library call (torch._int_mm,
     torch.mm(out_dtype=float32); reference times only); K12 and K16,
     which no serving path calls, each run once first as their own path
     with the counts set to 0;
  3. the serving main path through dynamic_tuning_tpu_torch.speed.main:
     ViT-B/16 at 224^2, 12 blocks, batch 128, seeded synthetic weights;
     bf16 dispatch, dense and plain, int8 dispatch, dense and plain,
     int8_attn dispatch, and with the MoE adapter (4 experts) bf16, int8
     and int8_attn dispatch.  Per run, with every launch count set to 0
     just before it: finite logits, 12 launches per forward of each of the
     run's kernels and none of the others, img/s; for the dispatch runs,
     logits and gates against the same forward on the plain versions and
     the mean keep ratio;
  4. segmentation serving through dynamic_tuning_tpu_torch.bench.seg_family:
     the DyT segmentor (ViT-B/16 backbone at 512^2, UPerHead 768, 150
     classes, seeded synthetic weights) in dispatch and the dense
     comparator, batch-1 crops; with the counts set to 0 just before: 12 K9
     launches per forward and none of the image kernels, finite logits,
     crops/s; each first forward against the same forward on the plain
     versions -- for dispatch, its gates against the free-running
     plain-version forward's, and its logits against the plain-version
     forward given the kernel forward's dispatch decisions (per-pixel
     logits: a gate that flips near 0 rewrites its own patch's logits,
     whatever the kernels' error);
  5. slide inference (dispatch) over one 512x683 image (two windows at
     stride 341), the strip only the first window covers held against that
     window's own forward; then SegRunner.evaluate (seg_train.py --eval)
     on 2 synthetic 512^2 images, with K9's launches counted;
  6. the segmentation backbone without windows, with LayerScale and BEiT
     q/v biases (SegVisionTransformer(use_rel_pos_bias=False,
     init_values=0.1, qv_bias_only=True), ViT-B/16 width and depth, seeded
     weights) at 256^2 (257 tokens), batch 8, in dispatch and dense
     (complete_model): 12 K1 launches per forward and none of the others,
     finite features, gate agreement with the plain-version forward and
     the features against it given the same dispatch decisions, img/s;
     then beit_backbone on one 512^2 crop in dispatch, K9 in every block,
     held the same way;
  7. the speed-test path: models/fast_inference.fast_vit_forward on
     ViT-B/16 at 224^2, batch 128, phase 3's weights, in dispatch, mask and
     dense with use_kernel=True; per mode, with the counts set to 0 just
     before it: 12 K11 and 12 K15 launches per forward and none of the
     others, finite logits, gates and logits against the same forward on the plain
     versions, img/s, and img/s with use_kernel=False beside it; then
     predict.serve (the port's predict.py without decoding) on 130
     synthetic uint8 canvases, one chunk of 128 and a tail of 2, in
     dispatch, auto and int8 dispatch: well-formed results, keep ratios in
     [0, 1], and the launches of K15 (bf16) or of the int8 kernels;
  8. the wall time, the card's name and power limit (nvidia-smi), a JSON
     line of the kernels, and last the JSON result line.
Needs no network and imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
B, N, C, H, FFN = 128, 197, 768, 12, 64
HID = 4 * C
MOE = 4                         # MoE adapter: 4 experts of width FFN
TAU = 1.0                       # the expert router's temperature (default)
DEPTH = 12
K_DISPATCH = 99                 # capacity_for(196, 0.5): rows kept per image
SRC = "dynamic_tuning_tpu_torch/csrc"
JAX_OPS = "dynamic_tuning_tpu/ops"
# name -> (module of the wrapper, JSON fields)
KERNELS = {
    "attention_sublayer_serving": ("ms", dict(
        route="cuda", source=f"{SRC}/attention_sublayer.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:465")),
    "dyt_prologue_serving": ("ms", dict(
        route="cuda", source=f"{SRC}/dyt_prologue.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:581")),
    "q8_ln_mlp": ("qt", dict(
        route="cuda", source=f"{SRC}/quant.cu",
        replaces=f"{JAX_OPS}/quant.py:152")),
    "attention_sublayer_serving_q8": ("qt", dict(
        route="cuda", source=f"{SRC}/quant.cu",
        replaces=f"{JAX_OPS}/quant.py:406")),
    "dyt_prologue_serving_q8": ("qt", dict(
        route="cuda", source=f"{SRC}/quant.cu",
        replaces=f"{JAX_OPS}/quant.py:531")),
    "attn_core_pairs_q8": ("qt", dict(
        route="cuda", source=f"{SRC}/quant.cu",
        replaces=f"{JAX_OPS}/quant.py:309")),
    "dyt_prologue_serving_moe": ("ms", dict(
        route="cuda", source=f"{SRC}/moe_adapter.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:763")),
    "dyt_prologue_serving_q8_moe": ("qt", dict(
        route="cuda", source=f"{SRC}/moe_adapter.cu",
        replaces=f"{JAX_OPS}/quant.py:674")),
    "mha_windowed_fused": ("ms", dict(
        route="cuda", source=f"{SRC}/windowed_attention.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:321")),
    "fused_ln_mlp": ("fm", dict(
        route="cuda", source=f"{SRC}/fused_mlp.cu",
        replaces=f"{JAX_OPS}/fused_mlp.py:53")),
    "mha_serving_fused": ("ms", dict(
        route="cuda", source=f"{SRC}/attention_sublayer.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:219")),
    "flash_attention": ("fa", dict(
        route="cuda", source=f"{SRC}/windowed_attention.cu",
        replaces=f"{JAX_OPS}/flash_attention.py:73")),
    "packed_attention": ("pa", dict(
        route="cuda", source=f"{SRC}/windowed_attention.cu",
        replaces=f"{JAX_OPS}/packed_attention.py:86")),
    "mha_serving": ("ms", dict(
        route="cuda", source=f"{SRC}/attention_sublayer.cu",
        replaces=f"{JAX_OPS}/mha_serving.py:49")),
    "q8_dispatch_mlp": ("qt", dict(
        route="cuda", source=f"{SRC}/quant.cu",
        replaces=f"{JAX_OPS}/quant.py:272")),
    "make_mm": ("pi", dict(
        route="cuda", source=f"{SRC}/quant.cu",
        replaces="scripts/profile_int8.py:24")),
}
# the segmentation path: 512^2 crops of 16^2 patches -> 32x32 + CLS tokens
SEG_GRID = 32
SEG_N = SEG_GRID * SEG_GRID + 1
SEG_CLASSES = 150
# the LayerScale / q-v-bias backbone without windows: 256^2 crops of 16^2
# patches -> 16x16 + CLS = 257 tokens, so every block's Attention takes K1
LS_IMG, LS_BATCH = 256, 8
# (quant, mode, MoE experts, kernels launched once per block of each forward)
RUNS = [
    ("none", "dispatch", 0, ("dyt_prologue_serving",)),
    ("none", "dense", 0, ("dyt_prologue_serving",)),
    ("none", "plain", 0, ("attention_sublayer_serving",)),
    ("int8", "dispatch", 0, ("dyt_prologue_serving_q8", "q8_ln_mlp")),
    ("int8", "dense", 0, ("dyt_prologue_serving_q8", "q8_ln_mlp")),
    ("int8", "plain", 0, ("attention_sublayer_serving_q8", "q8_ln_mlp")),
    ("int8_attn", "dispatch", 0, ("dyt_prologue_serving_q8", "q8_ln_mlp",
                                  "attn_core_pairs_q8")),
    ("none", "dispatch", MOE, ("dyt_prologue_serving_moe",)),
    ("int8", "dispatch", MOE, ("dyt_prologue_serving_q8_moe", "q8_ln_mlp")),
    ("int8_attn", "dispatch", MOE, ("dyt_prologue_serving_q8_moe",
                                    "q8_ln_mlp", "attn_core_pairs_q8")),
]
# Kernel vs plain version on the card: the same rounding points, sums in
# another order, so a bf16 output may move by one ulp on a boundary, and an
# int8 activation on a rounding boundary may take the neighbouring code (one
# code step moves an output by ~|w| * amax / 127, a few 1e-3 of its range):
# every output within 2 bf16 ulps of its largest magnitude.  Router logits
# (fp32): 2e-3 of the largest |logit|; a gate may differ only within that
# distance of 0.
BF16_REL = 2 * 2.0 ** -8
# K16's bf16 product is summed in fp32 and stored as fp32: against the
# float64 product within 2**-16 of its largest |output| (sums in another
# order); a kernel that rounded its sums or its output to bf16 (2**-9 of an
# output) fails.
FP32_SUM_REL = 2.0 ** -16
LOGIT_REL = 2e-3
# Whole-model dispatch logits, kernels vs plain versions: the per-kernel
# differences above, carried through 12 blocks, and a gate may flip where a
# router logit sits within noise of 0 (about 1 in 1000 tokens).
MODEL_REL = 0.05
GATE_AGREE = 0.995
FAST_ITERS = 5                  # timed forwards per run of the fast path
SERVE_N = 130                   # predict.serve canvases: a chunk of 128 + 2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def attn_ops(batch=B, tokens=N):
    """QK^T and PV of the attention core: each 2 * B * H * N * N * hd."""
    return 2 * batch * H * tokens * tokens * (C // H)


def kernel_inputs(torch, ms):
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def r(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device="cuda") * s).to(dtype)

    x = r(B, N, C, dtype=bf)
    sub = (r(C, s=0.05) + 1.0, r(C, s=0.02), r(3 * C, C, s=0.03, dtype=bf),
           r(3 * C, s=0.02), r(C, C, s=0.03, dtype=bf), r(C, s=0.02))
    ad = (r(FFN, C, s=0.03, dtype=bf), r(FFN, s=0.02),
          r(C, FFN, s=0.02, dtype=bf), r(C, s=0.01),
          torch.full((1,), 0.1, device="cuda"), r(1, C, s=25.0 / C ** 0.5),
          r(1, s=0.1))
    mlp = (r(C, s=0.05) + 1.0, r(C, s=0.02), r(HID, C, s=0.03),
           r(HID, s=0.02), r(C, HID, s=0.03), r(C, s=0.02))
    qkv = r(B, N, 3 * C)
    qkv[..., C:2 * C] += 1.0                       # keys with a lane offset
    # MoE experts in the tail's layout; router logits of a few units, so
    # the gates differ per token
    moe = (r(MOE, C, s=2.0 / C ** 0.5),
           *ms.moe_kernel_weights(r(MOE, C, FFN, s=0.03), r(MOE, FFN, s=0.02),
                                  r(MOE, FFN, C, s=0.02), bf),
           r(MOE, C, s=0.01), ad[4])
    return x, sub, ad, mlp, qkv.to(bf), moe


def rel_err(got, want) -> tuple[float, float]:
    err = (got.float() - want.float()).abs().max().item()
    return err, want.float().abs().max().item()


def check_close(what, got, want, rel=BF16_REL) -> float:
    err, mag = rel_err(got, want)
    if not err <= rel * mag:
        fail(f"{what}: max |err| {err} > {rel * mag}")
    return err


def check_logits(what, got, want) -> float:
    lerr, lmag = rel_err(got, want)
    tol = LOGIT_REL * lmag
    sure = want.abs() > tol
    flips = int(((got > 0) != (want > 0))[sure].sum())
    if lerr > tol or flips:
        fail(f"{what} logits: max |err| {lerr} (tol {tol}), {flips} gate "
             "flips beyond the tolerance")
    print(f"{what} router logits: max|err| {lerr:.6g} (tol {tol:.6g}), "
          "gates identical where |logit| > tol")
    return lerr


def measure(name, call, plain, outputs, inputs, ops) -> dict:
    """Check ``call()`` against ``plain()`` output by output and time both.
    ``outputs`` names each output ("logits" for router logits)."""
    import torch
    got, want = call(), plain()
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    worst = 0.0
    for out_name, a, b in zip(outputs, got, want):
        if out_name == "logits":
            worst = max(worst, check_logits(name, a, b))
        else:
            worst = max(worst, check_close(f"{name} {out_name}", a, b))
    ms_k, ms_p = time_ms(call), time_ms(plain)
    b_ms, b_by = bound(nbytes(*inputs) + nbytes(*got), ops)
    print(f"{name}: max|err| {worst:.6g}; kernel {ms_k:.4f} ms, plain "
          f"{ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=worst, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def phase_kernels(torch, ms, qt) -> dict:
    """Each wrapper against its plain version at the main path's shapes."""
    x, sub, ad, mlp, qkv, moe = kernel_inputs(torch, ms)
    qsub = (*sub[:2], *qt.quantize_weight(sub[2].float()), sub[3],
            *qt.quantize_weight(sub[4].float()), sub[5])
    qmlp = (*mlp[:2], *qt.quantize_weight(mlp[2]), mlp[3],
            *qt.quantize_weight(mlp[4]), mlp[5])
    M = B * N
    gemm = 2 * M * C * 4 * C                       # qkv + proj
    adapter = 4 * M * C * FFN
    out = {}

    out["attention_sublayer_serving"] = measure(
        "K2 attention_sublayer_serving",
        lambda: ms.attention_sublayer_serving(x, *sub, heads=H),
        lambda: ms.attention_sublayer_plain(x, *sub, heads=H),
        ("x_mid",), (x, *sub), {"bf16": gemm + 2 * attn_ops()})
    for s in (True, False):
        res = measure(
            f"K3 dyt_prologue_serving(with_select={s})",
            lambda s=s: ms.dyt_prologue_serving(x, *sub, *ad, heads=H,
                                                with_select=s),
            lambda s=s: ms.dyt_prologue_plain(x, *sub, *ad, heads=H,
                                              with_select=s),
            ("x_mid", "adapt", "logits"), (x, *sub, *(ad if s else ad[:5])),
            {"bf16": gemm + 2 * attn_ops() + adapter,
             "fp32": 2 * M * C * s})
        if s:
            out["dyt_prologue_serving"] = res

    for rows, tag in ((B * N, "dense"), (B * K_DISPATCH, "dispatch")):
        xr = x[:, :rows // B].contiguous()
        res = measure(
            f"K4 q8_ln_mlp({tag}, {rows} rows)",
            lambda xr=xr: qt.q8_ln_mlp(xr, *qmlp, gelu_approx=True),
            lambda xr=xr: qt.q8_ln_mlp_plain(xr, *qmlp, gelu_approx=True),
            ("mlp",), (xr, *qmlp), {"int8": 4 * rows * C * HID})
        if tag == "dense":
            out["q8_ln_mlp"] = res

    out["attention_sublayer_serving_q8"] = measure(
        "K5 attention_sublayer_serving_q8",
        lambda: qt.attention_sublayer_serving_q8(x, *qsub, heads=H),
        lambda: qt.attention_sublayer_q8_plain(x, *qsub, heads=H),
        ("x_mid",), (x, *qsub), {"int8": gemm, "bf16": 2 * attn_ops()})
    for s in (True, False):
        res = measure(
            f"K6 dyt_prologue_serving_q8(with_select={s})",
            lambda s=s: qt.dyt_prologue_serving_q8(x, *qsub, *ad, heads=H,
                                                   with_select=s),
            lambda s=s: qt.dyt_prologue_q8_plain(x, *qsub, *ad, heads=H,
                                                 with_select=s),
            ("x_mid", "adapt", "logits"),
            (x, *qsub, *(ad if s else ad[:5])),
            {"int8": gemm, "bf16": 2 * attn_ops() + adapter,
             "fp32": 2 * M * C * s})
        if s:
            out["dyt_prologue_serving_q8"] = res

    out["attn_core_pairs_q8"] = measure(
        "K10 attn_core_pairs_q8",
        lambda: qt.attn_core_pairs_q8(qkv, heads=H),
        lambda: qt.attn_core_pairs_q8_plain(qkv, heads=H),
        ("core",), (qkv,), {"int8": attn_ops(), "bf16": attn_ops()})
    # K10 inside K5: the sublayer with the int8 core, for the PERF table
    measure("K5 attention_sublayer_serving_q8(attn_q8=True)",
            lambda: qt.attention_sublayer_serving_q8(x, *qsub, heads=H,
                                                     attn_q8=True),
            lambda: qt.attention_sublayer_q8_plain(x, *qsub, heads=H,
                                                   attn_q8=True),
            ("x_mid",), (x, *qsub), {"int8": gemm + attn_ops(),
                                     "bf16": attn_ops()})

    # the MoE prologues: the router dots (E experts + the token router) are
    # fp32 work, the two expert products bf16 tensor work
    experts = 4 * M * C * MOE * FFN
    for s in (True, False):
        res = measure(
            f"K7 dyt_prologue_serving_moe(with_select={s})",
            lambda s=s: ms.dyt_prologue_serving_moe(
                x, *sub, *moe, *ad[5:], heads=H, tau=TAU, with_select=s),
            lambda s=s: ms.dyt_prologue_moe_plain(
                x, *sub, *moe, *ad[5:], heads=H, tau=TAU, with_select=s),
            ("x_mid", "adapt", "logits"),
            (x, *sub, *moe, *(ad[5:] if s else ())),
            {"bf16": gemm + 2 * attn_ops() + experts,
             "fp32": 2 * M * C * (MOE + s)})
        if s:
            out["dyt_prologue_serving_moe"] = res
    for s, aq in ((True, False), (False, False), (True, True)):
        res = measure(
            f"K8 dyt_prologue_serving_q8_moe(with_select={s}, attn_q8={aq})",
            lambda s=s, aq=aq: qt.dyt_prologue_serving_q8_moe(
                x, *qsub, *moe, *ad[5:], heads=H, tau=TAU, with_select=s,
                attn_q8=aq),
            lambda s=s, aq=aq: qt.dyt_prologue_q8_moe_plain(
                x, *qsub, *moe, *ad[5:], heads=H, tau=TAU, with_select=s,
                attn_q8=aq),
            ("x_mid", "adapt", "logits"),
            (x, *qsub, *moe, *(ad[5:] if s else ())),
            {"int8": gemm + aq * attn_ops(),
             "bf16": (2 - aq) * attn_ops() + experts,
             "fp32": 2 * M * C * (MOE + s)})
        if s and not aq:
            out["dyt_prologue_serving_q8_moe"] = res
    return out


def phase_gemm_reference(torch, _build) -> None:
    """The hand int8 GEMM (through the stem's entry point, bf16 out) beside
    torch._int_mm and cuBLAS bf16 at the int8 path's GEMM shapes.  Reference
    times only: the port calls neither library."""
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    for name, M, Nn, K in (("qkv", B * N, 3 * C, C), ("proj", B * N, C, C),
                           ("fc1", B * N, HID, C), ("fc2", B * N, C, HID),
                           ("fc1 dispatch", B * K_DISPATCH, HID, C)):
        a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device="cuda")
        w = torch.randint(-127, 128, (Nn, K), dtype=torch.int8,
                          device="cuda")
        ones_m = torch.ones(M, device="cuda")
        ones_n = torch.ones(Nn, device="cuda")
        zeros = torch.zeros(Nn, device="cuda")
        out = torch.empty((M, Nn), dtype=torch.bfloat16, device="cuda")

        def hand():
            _build.check(lib, lib.dyt_q8_stem_gemm(
                a.data_ptr(), w.data_ptr(), ones_m.data_ptr(),
                ones_n.data_ptr(), zeros.data_ptr(), M, Nn, K,
                out.data_ptr(), stream), "int8 GEMM")

        hand()
        ref = torch.matmul(a.double(), w.double().t())      # exact
        check_close(f"hand int8 GEMM ({name})", out, ref)
        ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
        ops = 2 * M * Nn * K
        t_hand = time_ms(hand)
        line = (f"GEMM {name} [{M}x{K}]x[{K}x{Nn}]: hand int8 {t_hand:.4f} "
                f"ms ({ops / t_hand / 1e9:.1f} TOPS)")
        try:
            t_int = time_ms(lambda: torch._int_mm(a, w.t()))
            line += (f", torch._int_mm {t_int:.4f} ms "
                     f"({ops / t_int / 1e9:.1f})")
        except RuntimeError as e:          # a reference only
            line += f", torch._int_mm refused: {str(e).splitlines()[0]}"
        t_bf = time_ms(lambda: torch.matmul(ab, wb.t()))
        print(line + f", cuBLAS bf16 {t_bf:.4f} ms "
              f"({ops / t_bf / 1e9:.1f} TFLOP/s)")


def phase_windowed(torch, ms, layers) -> dict:
    """K9 against its plain version at the segmentation path's shape, with
    SDPA (the bias as its additive mask) as the library's time for the same
    function (max-subtracted softmax: the same up to the clamp)."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(1)
    ld = ms.bias_row_stride(SEG_N)
    # the bias in the layout the layer builds: rows padded to 16 bytes
    bias = (torch.randn((H, SEG_N, ld), generator=g, device="cuda")
            .to(torch.bfloat16)[:, :, :SEG_N])
    out = {}
    for batch in (1, 2):
        qkv = torch.randn((batch, SEG_N, 3 * C), generator=g,
                          device="cuda").to(torch.bfloat16)
        res = measure(
            f"K9 mha_windowed_fused(B={batch}, N={SEG_N})",
            lambda: ms.mha_windowed_fused(qkv, bias, heads=H),
            lambda: ms.mha_windowed_plain(qkv, bias, heads=H),
            ("core",), (qkv, bias.contiguous()),
            {"bf16": 2 * attn_ops(batch, SEG_N)})
        q, k, v = (t.contiguous() for t in qkv.reshape(
            batch, SEG_N, 3, H, C // H).permute(2, 0, 3, 1, 4))
        mask = bias.contiguous()[None]
        res["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        print(f"  SDPA with the bias as mask (reference only): "
              f"{res['library_ms']:.4f} ms")
        if batch == 1:
            out["mha_windowed_fused"] = res
    table = torch.randn(((2 * SEG_GRID - 1) ** 2 + 3, H), generator=g,
                        device="cuda").to(torch.bfloat16)
    t_bias = time_ms(lambda: layers._rel_pos_bias_from_table(
        table, SEG_GRID, SEG_GRID, row_stride=ld))
    print(f"rel-pos bias build [{H}, {SEG_N}, {SEG_N}] bf16 (one gather, "
          f"per block per forward): {t_bias:.4f} ms")
    return out


def phase_k11(torch, fm, fast) -> dict:
    """K11 against its plain version at the speed-test path's rows, with
    the cuBLAS chain of fast_vit_forward(use_kernel=False)'s MLP (folded
    LN -> fc1 -> GELU -> fc2 -> gate) beside it: a reference time, since no
    single PyTorch call computes the function."""
    g = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16

    def r(*shape, s=1.0):
        return torch.randn(shape, generator=g, device="cuda") * s

    out = {}
    for tag, rows, gated, approx, c, hid in (
            ("dispatch", B * K_DISPATCH, False, True, C, HID),
            ("mask", B * N, True, True, C, HID),
            ("ragged, erf", 77, True, False, 128, 512)):
        ln = (r(c, s=0.05) + 1.0, r(c, s=0.02))
        w1, b1 = r(hid, c, s=0.03), r(hid, s=0.02)
        w2, b2 = r(c, hid, s=0.03), r(c, s=0.02)
        mlp = (*ln, w1.to(bf), b1, w2.to(bf), b2)
        x = r(rows, c).to(bf)
        gate = ((torch.rand((rows, 1), generator=g, device="cuda") > 0.5)
                .to(bf) if gated else None)
        res = measure(
            f"K11 fused_ln_mlp({tag}, {rows} rows{', gate' if gated else ''})",
            lambda: fm.fused_ln_mlp(x, *mlp, gate, gelu_approx=approx),
            lambda: fm.ln_mlp_plain(x, *mlp, gate, gelu_approx=approx),
            ("mlp",), (x, *mlp, gate), {"bf16": 4 * rows * c * hid})
        if gated:
            got = fm.fused_ln_mlp(x, *mlp, gate, gelu_approx=approx)
            if not bool((got[gate[:, 0] == 0] == 0).all()):
                fail(f"K11 ({tag}): a gated-off row is not 0")
        folded = fast._folded(*ln, w1, b1)
        t_chain = time_ms(lambda: fast._mlp_cublas(
            x, gate, *folded, mlp[4], b2, approx))
        print(f"  cuBLAS chain of use_kernel=False (reference only): "
              f"{t_chain:.4f} ms")
        if tag == "dispatch":
            out["fused_ln_mlp"] = res
    return out


def phase_attention(torch, ms, qt, fm) -> dict:
    """K1, K15, K13 and K14 against their plain versions, each beside SDPA
    on the same q, k, v (the max-subtracted softmax: the same function up
    to the serving clamp and the rounding points; a library's time only).
    K13 and K14 have no caller beyond tests in either package: their path
    is one call of each entry point at the shapes below, with every count
    set to 0 just before; the launches of the comparisons are not counted.
    """
    import torch.nn.functional as F
    from dynamic_tuning_tpu_torch.ops import flash_attention as fa
    from dynamic_tuning_tpu_torch.ops import packed_attention as pa

    g = torch.Generator(device="cuda").manual_seed(5)
    hd = C // H
    qkv = torch.randn((B, N, 3 * C), generator=g, device="cuda").to(
        torch.bfloat16)
    views = qkv.view(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    q, k, v = (t.contiguous() for t in views)
    bias = torch.randn((H, SEG_N, SEG_N), generator=g, device="cuda")
    sq, sk, sv = (torch.randn((1, H, SEG_N, hd), generator=g, device="cuda")
                  .to(torch.bfloat16) for _ in range(3))
    ops = {"bf16": 2 * attn_ops()}

    reset_counts(ms, qt, fm)
    fa.flash_attention(q, k, v)
    fa.flash_attention(sq, sk, sv, bias)
    pa.packed_attention(qkv, num_heads=H)
    torch.cuda.synchronize()
    path = read_counts(ms, qt, fm)

    def sdpa(what, *args, **kw):
        t = time_ms(lambda: F.scaled_dot_product_attention(*args, **kw))
        print(f"  SDPA {what} (reference only): {t:.4f} ms")
        return t

    out = {}
    out["mha_serving_fused"] = measure(
        "K1 mha_serving_fused", lambda: ms.mha_serving_fused(qkv, heads=H),
        lambda: ms.attn_core_pairs(qkv, heads=H), ("core",), (qkv,), ops)
    out["mha_serving_fused"]["library_ms"] = sdpa("on q, k, v", q, k, v)
    measure("K15 mha_serving (contiguous q, k, v)",
            lambda: ms.mha_serving(q, k, v),
            lambda: ms.mha_serving_plain(q, k, v), ("core",), (q, k, v),
            ops)
    out["mha_serving"] = measure(
        "K15 mha_serving (views of the raw qkv)",
        lambda: ms.mha_serving(*views),
        lambda: ms.mha_serving_plain(*views), ("core",), (qkv,), ops)
    out["mha_serving"]["library_ms"] = out["mha_serving_fused"]["library_ms"]
    out["flash_attention"] = measure(
        "K13 flash_attention", lambda: fa.flash_attention(q, k, v),
        lambda: fa.flash_attention_plain(q, k, v), ("attention",),
        (q, k, v), ops)
    out["flash_attention"]["library_ms"] = sdpa("on q, k, v", q, k, v)
    measure(f"K13 flash_attention(B=1, N={SEG_N}, fp32 bias)",
            lambda: fa.flash_attention(sq, sk, sv, bias),
            lambda: fa.flash_attention_plain(sq, sk, sv, bias),
            ("attention",), (sq, sk, sv, bias),
            {"bf16": 2 * attn_ops(1, SEG_N)})
    sdpa("with the bias as mask", sq, sk, sv,
         attn_mask=bias.to(torch.bfloat16)[None])
    out["packed_attention"] = measure(
        "K14 packed_attention", lambda: pa.packed_attention(qkv, num_heads=H),
        lambda: pa.packed_attention_plain(qkv, H), ("attention",), (qkv,),
        ops)
    out["packed_attention"]["library_ms"] = out["flash_attention"][
        "library_ms"]
    torch.cuda.empty_cache()
    return out, {k: path[k] for k in ("flash_attention", "packed_attention")}


def phase_k12(torch, ms, qt, fm, D) -> tuple:
    """K12 against its plain version at the int8 dispatch path's shape,
    beside the Block's unfused chain for the same function (dispatch_mlp
    around K4; a reference time, no single PyTorch call computes it).  Its
    path is one call with every count set to 0 just before."""
    g = torch.Generator(device="cuda").manual_seed(7)

    def r(*shape, s=1.0):
        return torch.randn(shape, generator=g, device="cuda") * s

    x = r(B, N, C).to(torch.bfloat16)
    qmlp = (r(C, s=0.05) + 1.0, r(C, s=0.02),
            *qt.quantize_weight(r(HID, C, s=0.03)), r(HID, s=0.02),
            *qt.quantize_weight(r(C, HID, s=0.03)), r(C, s=0.02))
    # uniform in [0, 0.917): about a tenth of the top K at or under 0.5
    scores = torch.rand((B, N), generator=g, device="cuda") * 0.917
    scores[:, 0] = float("inf")
    call = lambda: qt.q8_dispatch_mlp(x, scores, *qmlp, capacity=K_DISPATCH,
                                      gelu_approx=True)
    reset_counts(ms, qt, fm)
    out, gate = call()
    torch.cuda.synchronize()
    path = read_counts(ms, qt, fm)
    if path != {k: int(k == "q8_dispatch_mlp") for k in KERNELS}:
        fail(f"K12 path: kernel launches {path}")
    masked = 1.0 - gate.float().sum().item() / (B * K_DISPATCH)
    res = measure(
        f"K12 q8_dispatch_mlp(B={B}, N={N}, K={K_DISPATCH}; "
        f"{masked:.4f} of the slots masked)", call,
        lambda: qt.q8_dispatch_mlp_plain(x, scores, *qmlp,
                                         capacity=K_DISPATCH,
                                         gelu_approx=True),
        ("out", "gate"), (x, scores, *qmlp),
        {"int8": 4 * B * K_DISPATCH * C * HID})
    chain = lambda: D.dispatch_mlp(
        x, scores, K_DISPATCH,
        lambda rows: qt.q8_ln_mlp(rows, *qmlp, gelu_approx=True))
    c_out, c_gate = chain()
    torch.cuda.synchronize()
    same_bits = torch.equal(out.view(torch.int16), c_out.view(torch.int16))
    same = torch.equal(out, c_out) and torch.equal(gate, c_gate)
    why = ("bit-identical" if same_bits and same else
           "equal in value, the bits differ only in the sign of zeros (the "
           "chain multiplies a dropped row by 0, K12 never writes it)"
           if same else "NOT equal: max|diff| "
           f"{(out.float() - c_out.float()).abs().max().item():.6g}")
    print(f"  the Block's unfused chain (dispatch_mlp around q8_ln_mlp; "
          f"reference only): {time_ms(chain):.4f} ms; K12 against it: {why}")
    return {"q8_dispatch_mlp": res}, {"q8_dispatch_mlp": path[
        "q8_dispatch_mlp"]}


def phase_k16(torch, ms, qt, fm, pi) -> tuple:
    """K16, the matmul probe, at its five shapes in bf16 and int8 (each
    beside one library call, a reference time).  Its path is one call of
    make_mm's product at the dispatch MLP's shape, with every count set to
    0 just before; the row of the kernels line is that shape in int8."""
    Mx, Kx, Nx = pi.SHAPES[-1]
    a = torch.randint(-127, 127, (Mx, Kx), dtype=torch.int8, device="cuda")
    b = torch.randint(-127, 127, (Kx, Nx), dtype=torch.int8, device="cuda")
    reset_counts(ms, qt, fm)
    pi.make_mm(Mx, Kx, Nx, torch.int8, torch.int32)(a, b)
    torch.cuda.synchronize()
    path = read_counts(ms, qt, fm)
    if path != {k: int(k == "make_mm") for k in KERNELS}:
        fail(f"K16 path: kernel launches {path}")
    del a, b
    out = {}
    for M, K, Nn in pi.SHAPES:
        for dtype, kind in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
            res = pi.bench(M, K, Nn, dtype, pi.OUT[dtype],
                           f"K16 make_mm {kind} {(M, K, Nn)}")
            tol = 0.0 if kind == "int8" else FP32_SUM_REL * res["ref_max"]
            if not res["max_abs_err"] <= tol:
                fail(f"K16 {kind} {(M, K, Nn)}: max |err| "
                     f"{res['max_abs_err']} > {tol}")
            if kind == "int8" and (M, K, Nn) == (Mx, Kx, Nx):
                out["make_mm"] = {k: res[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}
    torch.cuda.empty_cache()
    return out, {"make_mm": path["make_mm"]}


def phase_layerscale(torch, ms, qt, fm, D, seg_vit, make_seg_state_dict,
                     config, np) -> dict:
    """The LayerScale / q-v-bias backbone without windows at ViT-B width
    (K1 in every block), batch 8 at 256^2, in dispatch and dense
    (complete_model); then the BEiT backbone (K9 in every block) on one
    512^2 crop.  Returns the launches of K1 and K9."""
    launches = {"mha_serving_fused": 0, "mha_windowed_fused": 0}
    g = torch.Generator(device="cuda").manual_seed(6)
    beit = dict(use_abs_pos_embed=False, init_values=0.1, qv_bias_only=True)
    for name, img, batch, knobs, kernel in (
            ("no-window LayerScale backbone", LS_IMG, LS_BATCH,
             dict(use_rel_pos_bias=False, init_values=0.1,
                  qv_bias_only=True), "mha_serving_fused"),
            ("beit_backbone", 512, 1, beit, "mha_windowed_fused")):
        cfg = config.ModelConfig(img_size=img, gelu_approx=True,
                                 residual_dtype="bfloat16")
        build = (seg_vit.beit_backbone if knobs is beit else
                 lambda *a, **kw: seg_vit.SegVisionTransformer(
                     *a, **knobs, **kw))
        model = build(cfg, config.TuningConfig(),
                      config.SelectConfig(token_target_ratio=0.5),
                      dtype=torch.bfloat16)
        sd = make_seg_state_dict(np.random.RandomState(0), depth=DEPTH,
                                 dim=C, ffn=FFN, img=img, patch=16,
                                 num_classes=SEG_CLASSES, head_channels=64,
                                 **knobs)
        model.load_state_dict({k[len("backbone."):]: torch.from_numpy(v)
                               for k, v in sd.items()
                               if k.startswith("backbone.")}, strict=True)
        model = model.to("cuda")
        x = torch.randn((batch, img, img, 3), generator=g, device="cuda")
        modes = (("dispatch", {"dispatch": True}),
                 ("dense", {"complete_model": True}))
        for mode, kw in modes[:2 if kernel == "mha_serving_fused" else 1]:
            reset_counts(ms, qt, fm)
            scores = []
            with routing(D, record=scores), torch.inference_mode():
                feats, aux = model(x, **kw)
            torch.cuda.synchronize()
            counts = read_counts(ms, qt, fm)
            want = {k: DEPTH if k == kernel else 0 for k in KERNELS}
            if counts != want:
                fail(f"{name} {mode}: kernel launches {counts}, want {want}")
            launches[kernel] += counts[kernel]
            if not all(torch.isfinite(f).all() for f in feats):
                fail(f"{name} {mode}: features not finite")
            with plain_versions(ms, qt, fm), torch.inference_mode():
                _, free_aux = model(x, **kw)
            with (routing(D, replay=scores), plain_versions(ms, qt, fm),
                  torch.inference_mode()):
                ref, _ = model(x, **kw)
            agree = (1.0 if aux["token_select"] is None else
                     (aux["token_select"] == free_aux["token_select"])
                     .float().mean().item())
            worst = 0.0
            for f, r in zip(feats, ref):
                err, mag = rel_err(f, r)
                worst = max(worst, err / mag)
            t = time_ms(lambda: model(x, **kw), iters=5, warmup=1)
            print(f"{name} {mode} ({img}^2, batch {batch}): {DEPTH} "
                  f"{kernel} launches per forward; {batch / t * 1e3:.2f} "
                  f"img/s; gate agreement with the plain-version forward "
                  f"{agree:.6f}; features vs plain versions on the same "
                  f"dispatch: max|err| {worst:.6g} of the largest (tol "
                  f"{MODEL_REL:g})")
            if worst > MODEL_REL or agree < GATE_AGREE:
                fail(f"{name} {mode} disagrees with the plain-version "
                     "forward")
        del model
        torch.cuda.empty_cache()
    return launches


def phase_fast(torch, ms, qt, fm, fast, predict, scan_throughput,
               forwards_run, sd) -> int:
    """The speed-test path: fast_vit_forward per mode with use_kernel=True
    (and its img/s with use_kernel=False), then predict.serve.  Returns
    K11's and K15's launches."""
    cuda = torch.device("cuda")
    args = predict.get_args_parser().parse_args(
        ["--ckpt", "synthetic.pth", "--images", "-"])
    cfg, tuning, sel = predict.configs(args)
    params = predict.load_params(args, cuda, state_dict=sd)
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((B, 224, 224, 3), generator=g, device="cuda")
    launches = {"fused_ln_mlp": 0, "mha_serving": 0}
    for mode in ("dispatch", "mask", "dense"):
        def fwd(use_kernel, mode=mode):
            return fast.fast_vit_forward(params, x, cfg=cfg, tuning=tuning,
                                         select=sel, mode=mode,
                                         use_kernel=use_kernel)
        reset_counts(ms, qt, fm)
        with torch.inference_mode():
            logits, gates = fwd(True)
            ips = scan_throughput(lambda: fwd(True), batch=B,
                                  iters=FAST_ITERS, warmup_iters=2)
        torch.cuda.synchronize()
        n_fwd = 1 + forwards_run(FAST_ITERS, warmup_iters=2)
        counts = read_counts(ms, qt, fm)
        want = {k: DEPTH * n_fwd if k in ("fused_ln_mlp", "mha_serving")
                else 0 for k in KERNELS}
        if counts != want:
            fail(f"fast {mode}: kernel launches {counts}, want {want}")
        for k in launches:
            launches[k] += counts[k]
        if logits.shape != (B, 100) or not torch.isfinite(logits).all():
            fail(f"fast {mode}: logits {tuple(logits.shape)} not "
                 "finite/shaped")
        if (gates is None) != (mode == "dense") or (
                gates is not None and gates.shape != (B, DEPTH, N)):
            fail(f"fast {mode}: gates "
                 f"{None if gates is None else tuple(gates.shape)}")
        with plain_versions(ms, qt, fm), torch.inference_mode():
            ref, ref_gates = fwd(True)
        err, mag = rel_err(logits, ref)
        agree = (1.0 if gates is None
                 else (gates == ref_gates).float().mean().item())
        with torch.inference_mode():
            ips_cublas = scan_throughput(lambda: fwd(False), batch=B,
                                         iters=FAST_ITERS, warmup_iters=2)
        keep = "" if gates is None else (
            f", mean keep ratio {gates[:, :, 1:].mean().item():.4f}")
        print(f"fast {mode}: {ips:.2f} img/s with K11, {ips_cublas:.2f} "
              f"img/s with the cuBLAS chain, at batch {B}; {DEPTH} K11 and "
              f"{DEPTH} K15 launches per forward; vs plain versions: logits "
              f"max|err| "
              f"{err:.6g} (tol {MODEL_REL * mag:.6g}), gate agreement "
              f"{agree:.6f}{keep}")
        if err > MODEL_REL * mag or agree < GATE_AGREE:
            fail(f"fast {mode} forward disagrees with the plain-version "
                 "forward")
        torch.cuda.empty_cache()

    canvases = torch.randint(0, 256, (SERVE_N, 256, 256, 3), generator=g,
                             device="cuda", dtype=torch.uint8)
    chunks = -(-SERVE_N // 128)
    for mode, quant in (("dispatch", "none"), ("auto", "none"),
                        ("dispatch", "int8")):
        a = predict.get_args_parser().parse_args(
            ["--ckpt", "synthetic.pth", "--images", "-", "--mode", mode,
             "--quant", quant, "--batch_size", str(SERVE_N)])
        p = params if quant == "none" else predict.load_params(
            a, cuda, state_dict=sd)
        reset_counts(ms, qt, fm)
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            results = predict.serve(a, canvases, p)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts(ms, qt, fm)
        served = (("dyt_prologue_serving_q8", "q8_ln_mlp") if quant != "none"
                  else ("mha_serving",))
        want = {k: DEPTH * chunks if k in served else 0 for k in KERNELS}
        run = f"predict.serve {mode} quant={quant}"
        if counts != want:
            fail(f"{run}: kernel launches {counts}, want {want}")
        ok = (len(results) == SERVE_N
              and len(printed.getvalue().splitlines()) == SERVE_N
              and all(0 <= r["label"] < 100 and 0.0 <= r["prob"] <= 1.0
                      and 0.0 <= r["keep_ratio"] <= 1.0 for r in results))
        if not ok:
            fail(f"{run}: malformed results {results[:2]}")
        # every run here dispatches (auto too: 130 >= its minimum batch)
        keep = sum(r["keep_ratio"] for r in results) / SERVE_N
        if not keep < 1.0:
            fail(f"{run}: mean keep ratio {keep}")
        print(f"{run}: {SERVE_N} canvases in {chunks} chunks, "
              f"{secs:.2f} s (first call), mean keep ratio {keep:.4f}")
        launches["mha_serving"] += counts["mha_serving"]
        del p
        torch.cuda.empty_cache()
    return launches


def count_modules(ms, qt, fm) -> dict:
    """The wrappers' modules by their KERNELS tag."""
    from dynamic_tuning_tpu_torch.ops import flash_attention as fa
    from dynamic_tuning_tpu_torch.ops import packed_attention as pa
    from dynamic_tuning_tpu_torch.utils import profile_int8 as pi
    return {"ms": ms, "qt": qt, "fm": fm, "fa": fa, "pa": pa, "pi": pi}


def reset_counts(ms, qt, fm) -> None:
    for mod in count_modules(ms, qt, fm).values():
        mod.reset_launch_counts()


def read_counts(ms, qt, fm) -> dict:
    mods = count_modules(ms, qt, fm)
    return {k: getattr(mods[m], k).launches for k, (m, _) in KERNELS.items()}


def phase_model(torch, ms, qt, fm, speed, sds) -> dict:
    """The serving main path, through speed.main, per mode and quant."""
    launches = {name: 0 for name in KERNELS}
    for quant, mode, moe, kernels in RUNS:
        args = speed.get_args_parser().parse_args(
            ["--mode", mode, "--quant", quant, "--moe_experts", str(moe),
             "--moe_router_tau", str(TAU), "--warmup", "3", "--iters", "10"])
        reset_counts(ms, qt, fm)
        res = speed.main(args, state_dict=sds[moe])
        counts = read_counts(ms, qt, fm)
        stem = qt.q8_patch_embed.launches
        fwd = res["forwards"]
        run = f"quant={quant} {mode}" + (f" moe{moe}" if moe else "")
        want = {k: DEPTH * fwd if k in kernels else 0 for k in KERNELS}
        if counts != want:
            fail(f"{run}: kernel launches {counts}, want {want}")
        if stem != (fwd if quant != "none" else 0):
            fail(f"{run}: {stem} int8 stem launches for {fwd} forwards")
        for k in KERNELS:
            launches[k] += counts[k]
        logits = res["logits"]
        if logits.shape != (B, 100) or not torch.isfinite(logits).all():
            fail(f"{run}: logits {tuple(logits.shape)} not finite/shaped")
        line = (f"model {run}: {res['throughput_img_s']} "
                f"img/s at batch {B}; launches per forward: "
                + ", ".join(f"{k} {counts[k] // fwd}" for k in kernels))
        if mode == "dispatch":
            keep = res["aux"]["token_select"].float().mean().item()
            line += f"; mean keep ratio {keep:.4f}"
            compare_with_plain(torch, ms, qt, fm, res, run)
        print(line)
        del res
        torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def plain_versions(ms, qt, fm):
    """Every wrapper swapped for its plain version (calls made inside are
    not counted: the wrappers are not called)."""
    plain = {(fm, "fused_ln_mlp"): fm.ln_mlp_plain,
             (ms, "dyt_prologue_serving"): ms.dyt_prologue_plain,
             (ms, "attention_sublayer_serving"): ms.attention_sublayer_plain,
             (ms, "dyt_prologue_serving_moe"): ms.dyt_prologue_moe_plain,
             (ms, "mha_windowed_fused"): ms.mha_windowed_plain,
             (ms, "mha_serving_fused"): ms.attn_core_pairs,
             (ms, "mha_serving"): ms.mha_serving_plain,
             (qt, "dyt_prologue_serving_q8"): qt.dyt_prologue_q8_plain,
             (qt, "attention_sublayer_serving_q8"):
                 qt.attention_sublayer_q8_plain,
             (qt, "dyt_prologue_serving_q8_moe"):
                 qt.dyt_prologue_q8_moe_plain,
             (qt, "q8_ln_mlp"): qt.q8_ln_mlp_plain,
             (qt, "q8_patch_embed"): qt.q8_patch_embed_plain}
    with contextlib.ExitStack() as stack:
        for (m, name), fn in plain.items():
            stack.enter_context(mock.patch.object(m, name, fn))
        yield


@contextlib.contextmanager
def routing(D, *, record=None, replay=None):
    """Record the token scores each dispatch gets, in call order, or feed
    recorded ones back in their place."""
    real = D.dispatch_mlp
    calls = iter(replay or ())

    def dispatch_mlp(x, scores, *args, **kwargs):
        if record is not None:
            record.append(scores.clone())
        return real(x, next(calls) if replay else scores, *args, **kwargs)

    with mock.patch.object(D, "dispatch_mlp", dispatch_mlp):
        yield


def compare_with_plain(torch, ms, qt, fm, res, run) -> None:
    """The dispatch forward again on the plain versions."""
    model, x = res["model"], res["x"]
    with plain_versions(ms, qt, fm), torch.inference_mode():
        ref, ref_aux = model(x, dispatch=True)
    err, mag = rel_err(res["logits"], ref)
    agree = (res["aux"]["token_select"] == ref_aux["token_select"]
             ).float().mean().item()
    print(f"{run} logits vs plain versions: max|err| {err:.6g} (tol "
          f"{MODEL_REL * mag:.6g}), gate agreement {agree:.6f}")
    if err > MODEL_REL * mag or agree < GATE_AGREE:
        fail(f"{run} forward disagrees with the plain-version forward")


def check_counts(ms, qt, fm, what, want_k9) -> None:
    counts = read_counts(ms, qt, fm)
    want = {k: want_k9 if k == "mha_windowed_fused" else 0 for k in KERNELS}
    if counts != want:
        fail(f"{what}: kernel launches {counts}, want {want}")


def phase_seg(torch, ms, qt, fm, D, bench, sd):
    """Segmentation serving through bench.seg_family: dispatch and dense.
    Returns K9's launches and the dispatch model."""
    reset_counts(ms, qt, fm)
    fields, runs = bench.seg_family("cuda", state_dict=sd)
    fwd = sum(r["forwards"] for r in runs.values())
    check_counts(ms, qt, fm, "seg family", DEPTH * fwd)
    for mode, r in runs.items():
        logits = r["logits"]
        if (logits.shape != (1, 512, 512, SEG_CLASSES)
                or not torch.isfinite(logits).all()):
            fail(f"seg {mode}: logits {tuple(logits.shape)} not "
                 "finite/shaped")
        model, x, kw = r["model"], r["x"], bench.seg_kwargs(mode)
        crops = fields["seg_crops_s" if mode == "dispatch"
                       else "seg_dense_crops_s"]
        line = f"seg {mode}: {crops} crops/s over {r['forwards']} forwards"
        with plain_versions(ms, qt, fm), torch.inference_mode():
            free, _, free_aux = model(x, **kw)
        if mode == "dispatch":
            # the kernel forward's dispatch decisions, replayed in the
            # plain-version forward: what is left is the kernels' numerics
            # (a gate that flips near 0 changes its own 16x16-pixel patch's
            # logits outright, beside any kernel error)
            scores = []
            with routing(D, record=scores), torch.inference_mode():
                model(x, **kw)
            with (routing(D, replay=scores), plain_versions(ms, qt, fm),
                  torch.inference_mode()):
                ref, _, _ = model(x, **kw)
            agree = (r["aux"]["token_select"] == free_aux["token_select"]
                     ).float().mean().item()
            keep = r["aux"]["token_select"].float().mean().item()
            ferr, fmag = rel_err(logits, free)
            past = ((logits - free).abs() > MODEL_REL * fmag).float().mean()
            line += (f"; gate agreement with the plain-version forward "
                     f"{agree:.6f} (its logits: max|err| {ferr:.6g} of "
                     f"{fmag:.6g}, a share {past.item():.6f} past "
                     f"{MODEL_REL:g} of it), mean keep ratio {keep:.4f}")
        else:
            ref, agree = free, 1.0
        err, mag = rel_err(logits, ref)
        line += (f"; logits vs plain versions"
                 f"{' on the same dispatch' if mode == 'dispatch' else ''}: "
                 f"max|err| {err:.6g} (tol {MODEL_REL * mag:.6g})")
        print(line)
        if err > MODEL_REL * mag or agree < GATE_AGREE:
            fail(f"seg {mode} forward disagrees with the plain-version "
                 "forward")
    print("seg family: " + json.dumps(fields))
    model = runs["dispatch"]["model"]
    del runs
    torch.cuda.empty_cache()
    return DEPTH * fwd, model


def phase_slide(torch, ms, qt, fm, bench, seg_train, upernet, model,
                sd) -> int:
    """Slide inference over one ADE20K-shaped image, then the evaluation
    entry point on 2 synthetic images."""
    g = torch.Generator(device="cuda").manual_seed(2)
    img = torch.randn((512, 683, 3), generator=g, device="cuda")
    kw = bench.seg_kwargs("dispatch")
    apply = lambda tiles: model(tiles, **kw)[0]
    reset_counts(ms, qt, fm)
    with torch.inference_mode():
        out = upernet.slide_inference(apply, img, num_classes=SEG_CLASSES,
                                      crop=512, stride=341)
        torch.cuda.synchronize()
        check_counts(ms, qt, fm, "slide inference", 2 * DEPTH)
        # columns [0, 171) lie in the first window only
        first = apply(img[None, :, :512])[0]
    if out.shape != (512, 683, SEG_CLASSES) or not torch.isfinite(out).all():
        fail(f"slide inference: {tuple(out.shape)} not finite/shaped")
    err, mag = rel_err(out[:, :171], first[:, :171])
    print(f"slide inference 512x683: 2 windows, {2 * DEPTH} K9 launches; "
          f"first-window strip vs its own forward: max|err| {err:.6g} "
          f"(of {mag:.6g})")
    if err > 1e-3 * mag:
        fail("slide inference does not reproduce its window's logits")

    args = seg_train.get_args_parser().parse_args(
        ["--eval", "--dataset", "synthetic", "--crop_size", "512",
         "--residual_dtype", "bfloat16", "--gelu_approx"])
    runner = seg_train.build_runner(args, log=lambda m: print("  " + m))
    runner.model.load_state_dict({k: torch.from_numpy(v)
                                  for k, v in sd.items()}, strict=True)
    reset_counts(ms, qt, fm)
    stats = runner.evaluate(max_images=2)
    torch.cuda.synchronize()
    check_counts(ms, qt, fm, "SegRunner.evaluate", 2 * DEPTH)
    if not (0.0 <= stats["aAcc"] <= 100.0 and stats["miou"] == stats["miou"]
            and stats["images"] == 2):
        fail(f"SegRunner.evaluate: {stats}")
    return 4 * DEPTH


def main() -> None:
    # the port's timing, bound and card helpers serve every phase
    global bound, card_line, time_ms
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, REPO)
    try:
        import numpy as np

        from dynamic_tuning_tpu_torch import (bench, config, predict,
                                              seg_train, speed)
        from dynamic_tuning_tpu_torch.checkpoint import (make_seg_state_dict,
                                                         make_vit_state_dict)
        from dynamic_tuning_tpu_torch.models import fast_inference as fast
        from dynamic_tuning_tpu_torch.models import layers, seg_vit, upernet
        from dynamic_tuning_tpu_torch.ops import _build
        from dynamic_tuning_tpu_torch.ops import dispatch as D
        from dynamic_tuning_tpu_torch.ops import fused_mlp as fm
        from dynamic_tuning_tpu_torch.ops import mha_serving as ms
        from dynamic_tuning_tpu_torch.ops import quant as qt
        from dynamic_tuning_tpu_torch.utils import profile_int8 as pi
        from dynamic_tuning_tpu_torch.utils.profiling import (
            bound_ms as bound, card_line, forwards_run, scan_throughput,
            time_ms)
    except ImportError as e:
        fail(f"the port is not here: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds} s)")
    for ln in _build.build_log.splitlines():
        if "registers" in ln or "spill" in ln:
            print("  ptxas:", ln.strip(), file=sys.stderr)

    measured = phase_kernels(torch, ms, qt)
    phase_gemm_reference(torch, _build)
    measured.update(phase_windowed(torch, ms, layers))
    measured.update(phase_k11(torch, fm, fast))
    attention, attention_path = phase_attention(torch, ms, qt, fm)
    measured.update(attention)
    k12, k12_path = phase_k12(torch, ms, qt, fm, D)
    measured.update(k12)
    k16, k16_path = phase_k16(torch, ms, qt, fm, pi)
    measured.update(k16)

    t0 = time.perf_counter()
    sds = {moe: make_vit_state_dict(np.random.RandomState(0), depth=DEPTH,
                                    dim=C, ffn=FFN, classes=100, img=224,
                                    patch=16, router_scale=25.0,
                                    moe_experts=moe)
           for moe in (0, MOE)}
    print(f"synthetic ViT-B/16 weights: {time.perf_counter() - t0:.1f} s")
    launches = phase_model(torch, ms, qt, fm, speed, sds)

    t0 = time.perf_counter()
    seg_sd = bench.seg_state_dict(0)
    print(f"synthetic seg weights: {time.perf_counter() - t0:.1f} s")
    k9, seg_model = phase_seg(torch, ms, qt, fm, D, bench, seg_sd)
    k9 += phase_slide(torch, ms, qt, fm, bench, seg_train, upernet,
                      seg_model, seg_sd)
    launches["mha_windowed_fused"] = k9
    del seg_model
    torch.cuda.empty_cache()
    for k, n in phase_layerscale(torch, ms, qt, fm, D, seg_vit,
                                 make_seg_state_dict, config, np).items():
        launches[k] += n
    launches.update(phase_fast(torch, ms, qt, fm, fast, predict,
                               scan_throughput, forwards_run, sds[0]))
    launches.update(attention_path)
    launches.update(k12_path)
    launches.update(k16_path)
    if not all(launches.values()):
        fail(f"a kernel never ran on the main path: {launches}")

    print(f"wall time: {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": [
        dict(name=name, **fields, launches=launches[name], **measured[name])
        for name, (_, fields) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
