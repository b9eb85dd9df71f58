#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  1. build the CUDA kernels from dynamic_tuning_tpu_torch/csrc with nvcc;
  2. each kernel wrapper (K2 attention_sublayer_serving, K3
     dyt_prologue_serving with and without the router) against its plain
     PyTorch version on the card at ViT-B/16 serving shapes (B=128, N=197,
     C=768, 12 heads, adapter 64), with both times;
  3. the serving main path through dynamic_tuning_tpu_torch.speed.main:
     ViT-B/16 at 224^2, 12 blocks, batch 128, seeded synthetic weights, modes
     dispatch, dense and plain; finite logits, launch counts (12 per forward
     of each mode's kernel), dispatch logits against the same forward on the
     plain versions, img/s per mode and the mean keep ratio;
  4. the card's name and power limit (nvidia-smi), a JSON line of the
     kernels, and last the JSON result line.
Needs no network and imports nothing of JAX.
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
DEPTH = 12
SRC = "dynamic_tuning_tpu_torch/csrc"
KERNELS = {
    "attention_sublayer_serving": dict(
        route="cuda", source=f"{SRC}/attention_sublayer.cu",
        replaces="dynamic_tuning_tpu/ops/mha_serving.py:465"),
    "dyt_prologue_serving": dict(
        route="cuda", source=f"{SRC}/dyt_prologue.cu",
        replaces="dynamic_tuning_tpu/ops/mha_serving.py:581"),
}
# Kernel vs plain version on the card: the same rounding points, fp32 sums
# in another order, so a bf16 output may move by one ulp on a boundary:
# 2 bf16 ulps of the largest magnitude.  Router logits (fp32): 2e-3 of the
# largest |logit|; a gate may differ only within that distance of 0.
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


def kernel_inputs(torch, with_adapter=True):
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
    return x, sub, ad


def rel_err(got, want) -> tuple[float, float]:
    err = (got.float() - want.float()).abs().max().item()
    return err, want.float().abs().max().item()


def phase_kernels(torch, ms) -> dict:
    """Each wrapper against its plain version at the main path's shapes."""
    x, sub, ad = kernel_inputs(torch)
    out = {}

    got = ms.attention_sublayer_serving(x, *sub, heads=H)
    want = ms.attention_sublayer_plain(x, *sub, heads=H)
    torch.cuda.synchronize()
    err, mag = rel_err(got, want)
    if not err <= BF16_REL * mag:
        fail(f"K2 x_mid: max |err| {err} > {BF16_REL * mag}")
    ms_k = time_ms(lambda: ms.attention_sublayer_serving(x, *sub, heads=H))
    ms_p = time_ms(lambda: ms.attention_sublayer_plain(x, *sub, heads=H))
    print(f"K2 attention_sublayer_serving: max|err| {err:.6g} "
          f"(tol {BF16_REL * mag:.6g}); kernel {ms_k:.4f} ms, "
          f"plain {ms_p:.4f} ms")
    out["attention_sublayer_serving"] = dict(max_abs_err=err, ms=ms_k,
                                             plain_ms=ms_p)

    worst = 0.0
    for with_select in (True, False):
        got = ms.dyt_prologue_serving(x, *sub, *ad, heads=H,
                                      with_select=with_select)
        want = ms.dyt_prologue_plain(x, *sub, *ad, heads=H,
                                     with_select=with_select)
        torch.cuda.synchronize()
        for name, a, b in zip(("x_mid", "adapt"), got, want):
            err, mag = rel_err(a, b)
            if not err <= BF16_REL * mag:
                fail(f"K3 {name} (with_select={with_select}): max |err| "
                     f"{err} > {BF16_REL * mag}")
            worst = max(worst, err)
        if with_select:
            lerr, lmag = rel_err(got[2], want[2])
            tol = LOGIT_REL * lmag
            sure = want[2].abs() > tol
            flips = int(((got[2] > 0) != (want[2] > 0))[sure].sum())
            if lerr > tol or flips:
                fail(f"K3 logits: max |err| {lerr} (tol {tol}), "
                     f"{flips} gate flips beyond the tolerance")
            worst = max(worst, lerr)
            print(f"K3 router logits: max|err| {lerr:.6g} (tol {tol:.6g}), "
                  f"gates identical where |logit| > tol")
        call = (lambda s=with_select: ms.dyt_prologue_serving(
            x, *sub, *ad, heads=H, with_select=s))
        plain = (lambda s=with_select: ms.dyt_prologue_plain(
            x, *sub, *ad, heads=H, with_select=s))
        ms_k, ms_p = time_ms(call), time_ms(plain)
        print(f"K3 dyt_prologue_serving(with_select={with_select}): "
              f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms")
        if with_select:
            out["dyt_prologue_serving"] = dict(ms=ms_k, plain_ms=ms_p)
    out["dyt_prologue_serving"]["max_abs_err"] = worst
    print(f"K3 dyt_prologue_serving: max|err| over outputs {worst:.6g}")
    return out


def phase_model(torch, ms, speed, make_vit_state_dict) -> dict:
    """The serving main path, through speed.main, per mode."""
    import numpy as np

    t0 = time.perf_counter()
    sd = make_vit_state_dict(np.random.RandomState(0), depth=DEPTH, dim=C,
                             ffn=FFN, classes=100, img=224, patch=16,
                             router_scale=25.0)
    print(f"synthetic ViT-B/16 weights: {time.perf_counter() - t0:.1f} s")
    ms.reset_launch_counts()
    launches = {name: 0 for name in KERNELS}
    for mode, kernel in (("dispatch", "dyt_prologue_serving"),
                         ("dense", "dyt_prologue_serving"),
                         ("plain", "attention_sublayer_serving")):
        args = speed.get_args_parser().parse_args(
            ["--mode", mode, "--warmup", "3", "--iters", "10"])
        before = {k: getattr(ms, k).launches for k in KERNELS}
        res = speed.main(args, state_dict=sd)
        counts = {k: getattr(ms, k).launches - before[k] for k in KERNELS}
        want = {k: DEPTH * res["forwards"] if k == kernel else 0
                for k in KERNELS}
        if counts != want:
            fail(f"{mode}: kernel launches {counts}, want {want}")
        for k in KERNELS:
            launches[k] += counts[k]
        logits = res["logits"]
        if logits.shape != (B, 100) or not torch.isfinite(logits).all():
            fail(f"{mode}: logits {tuple(logits.shape)} not finite/shaped")
        line = (f"model {mode}: {res['throughput_img_s']} img/s at batch "
                f"{B}; {counts[kernel] // res['forwards']} {kernel} "
                f"launches per forward")
        if mode == "dispatch":
            keep = res["aux"]["token_select"].float().mean().item()
            line += f"; mean keep ratio {keep:.4f}"
            compare_with_plain(torch, ms, res)
        print(line)
    final = {k: getattr(ms, k).launches for k in KERNELS}
    if final != launches or not all(final.values()):
        fail(f"launch counts {final} != per-mode sums {launches}")
    return final


def compare_with_plain(torch, ms, res) -> None:
    """The dispatch forward again with every wrapper swapped for its plain
    version (not counted: the wrappers are not called)."""
    model, x = res["model"], res["x"]
    with mock.patch.object(ms, "dyt_prologue_serving",
                           ms.dyt_prologue_plain), \
            mock.patch.object(ms, "attention_sublayer_serving",
                              ms.attention_sublayer_plain), \
            torch.inference_mode():
        ref, ref_aux = model(x, dispatch=True)
    err, mag = rel_err(res["logits"], ref)
    agree = (res["aux"]["token_select"] == ref_aux["token_select"]
             ).float().mean().item()
    print(f"dispatch logits vs plain versions: max|err| {err:.6g} "
          f"(tol {MODEL_REL * mag:.6g}), gate agreement {agree:.6f}")
    if err > MODEL_REL * mag or agree < GATE_AGREE:
        fail("dispatch forward disagrees with the plain-version forward")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        from dynamic_tuning_tpu_torch import speed
        from dynamic_tuning_tpu_torch.ops import _build
        from dynamic_tuning_tpu_torch.ops import mha_serving as ms
        from torch_oracle import make_vit_state_dict
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

    measured = phase_kernels(torch, ms)
    launches = phase_model(torch, ms, speed, make_vit_state_dict)

    print(card_line())
    print(json.dumps({"kernels": [
        dict(name=name, **KERNELS[name], launches=launches[name],
             **measured[name]) for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
