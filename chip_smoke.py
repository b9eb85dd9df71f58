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
     used by the port);
  3. the serving main path through dynamic_tuning_tpu_torch.speed.main:
     ViT-B/16 at 224^2, 12 blocks, batch 128, seeded synthetic weights;
     bf16 dispatch, dense and plain, int8 dispatch, dense and plain,
     int8_attn dispatch, and with the MoE adapter (4 experts) bf16, int8
     and int8_attn dispatch.  Per run, with every launch count set to 0
     just before it: finite logits, 12 launches per forward of each of the
     run's kernels and none of the others, img/s; for the dispatch runs,
     logits and gates against the same forward on the plain versions and
     the mean keep ratio;
  4. the wall time, the card's name and power limit (nvidia-smi), a JSON
     line of the kernels, and last the JSON result line.
Needs no network and imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
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
}
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
# NVIDIA's H100 SXM data sheet: HBM bytes/s and dense peak ops/s per type
HBM = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
# Kernel vs plain version on the card: the same rounding points, sums in
# another order, so a bf16 output may move by one ulp on a boundary, and an
# int8 activation on a rounding boundary may take the neighbouring code (one
# code step moves an output by ~|w| * amax / 127, a few 1e-3 of its range):
# every output within 2 bf16 ulps of its largest magnitude.  Router logits
# (fp32): 2e-3 of the largest |logit|; a gate may differ only within that
# distance of 0.
BF16_REL = 2 * 2.0 ** -8
LOGIT_REL = 2e-3
# Whole-model dispatch logits, kernels vs plain versions: the per-kernel
# differences above, carried through 12 blocks, and a gate may flip where a
# router logit sits within noise of 0 (about 1 in 1000 tokens).
MODEL_REL = 0.05
GATE_AGREE = 0.995


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters=20, warmup=3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(bytes_moved: int, ops: dict) -> tuple[float, str]:
    """The least time (ms) the card needs: the larger of the bytes over the
    memory rate and the operations over their type's peak rate."""
    t_bytes = bytes_moved / HBM * 1e3
    t_ops = sum(n / PEAK[kind] for kind, n in ops.items()) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attn_ops(batch=B):
    """QK^T and PV of the attention core: each 2 * B * H * N * N * hd."""
    return 2 * batch * H * N * N * (C // H)


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


def reset_counts(ms, qt) -> None:
    ms.reset_launch_counts()
    qt.reset_launch_counts()


def read_counts(ms, qt) -> dict:
    mods = {"ms": ms, "qt": qt}
    return {k: getattr(mods[m], k).launches for k, (m, _) in KERNELS.items()}


def phase_model(torch, ms, qt, speed, make_vit_state_dict) -> dict:
    """The serving main path, through speed.main, per mode and quant."""
    import numpy as np

    t0 = time.perf_counter()
    sds = {moe: make_vit_state_dict(np.random.RandomState(0), depth=DEPTH,
                                    dim=C, ffn=FFN, classes=100, img=224,
                                    patch=16, router_scale=25.0,
                                    moe_experts=moe)
           for moe in (0, MOE)}
    print(f"synthetic ViT-B/16 weights: {time.perf_counter() - t0:.1f} s")
    launches = {name: 0 for name in KERNELS}
    for quant, mode, moe, kernels in RUNS:
        args = speed.get_args_parser().parse_args(
            ["--mode", mode, "--quant", quant, "--moe_experts", str(moe),
             "--moe_router_tau", str(TAU), "--warmup", "3", "--iters", "10"])
        reset_counts(ms, qt)
        res = speed.main(args, state_dict=sds[moe])
        counts = read_counts(ms, qt)
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
            compare_with_plain(torch, ms, qt, res, run)
        print(line)
        del res
        torch.cuda.empty_cache()
    if not all(launches.values()):
        fail(f"a kernel never ran on the main path: {launches}")
    return launches


def compare_with_plain(torch, ms, qt, res, run) -> None:
    """The dispatch forward again with every wrapper swapped for its plain
    version (not counted: the wrappers are not called)."""
    model, x = res["model"], res["x"]
    plain = {(ms, "dyt_prologue_serving"): ms.dyt_prologue_plain,
             (ms, "attention_sublayer_serving"): ms.attention_sublayer_plain,
             (ms, "dyt_prologue_serving_moe"): ms.dyt_prologue_moe_plain,
             (qt, "dyt_prologue_serving_q8"): qt.dyt_prologue_q8_plain,
             (qt, "attention_sublayer_serving_q8"):
                 qt.attention_sublayer_q8_plain,
             (qt, "dyt_prologue_serving_q8_moe"):
                 qt.dyt_prologue_q8_moe_plain,
             (qt, "q8_ln_mlp"): qt.q8_ln_mlp_plain,
             (qt, "q8_patch_embed"): qt.q8_patch_embed_plain}
    patches = [mock.patch.object(m, name, fn)
               for (m, name), fn in plain.items()]
    for p in patches:
        p.start()
    try:
        with torch.inference_mode():
            ref, ref_aux = model(x, dispatch=True)
    finally:
        for p in patches:
            p.stop()
    err, mag = rel_err(res["logits"], ref)
    agree = (res["aux"]["token_select"] == ref_aux["token_select"]
             ).float().mean().item()
    print(f"{run} logits vs plain versions: max|err| {err:.6g} (tol "
          f"{MODEL_REL * mag:.6g}), gate agreement {agree:.6f}")
    if err > MODEL_REL * mag or agree < GATE_AGREE:
        fail(f"{run} forward disagrees with the plain-version forward")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, REPO)
    try:
        from dynamic_tuning_tpu_torch import speed
        from dynamic_tuning_tpu_torch.checkpoint import make_vit_state_dict
        from dynamic_tuning_tpu_torch.ops import _build
        from dynamic_tuning_tpu_torch.ops import mha_serving as ms
        from dynamic_tuning_tpu_torch.ops import quant as qt
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
    launches = phase_model(torch, ms, qt, speed, make_vit_state_dict)

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
