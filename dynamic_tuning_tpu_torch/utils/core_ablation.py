"""Where the serving attention core's and the bf16 GEMM's time goes: the
kernels with one phase taken out or one choice changed.

    python -m dynamic_tuning_tpu_torch.utils.core_ablation

The package is copied once per variant into ``build/core_ablation/
<variant>/``, and the copy's ``csrc/attention_sublayer.cu`` (the core) or
``csrc/gemm.cuh`` (the bf16 GEMM) is edited: one phase cut out, the core's
exp swapped for ``ex2.approx`` of x log2 e, one GEMM tile width used at
every N (``GEMM_WIDE_N``), or the GEMM's launch and then also its two TMA
tensor maps taken out of its host function.  The copies are built in
parallel and each, in its own process, times with CUDA events over 20
calls after 3 warm-up ones: K1 (``mha_serving_fused``: the core alone) and
K2 (``attention_sublayer_serving``: LN, the qkv GEMM, the core, the proj
GEMM) at ViT-B/16 serving shapes (B=128, N=197, C=768, 12 heads of 64),
and the bf16 GEMM (K16's entry, fp32 out) at the proj, qkv and dispatch
fc1 shapes; and on the host's clock one GEMM call through ctypes (M=128,
768 x 768): the median and range over 21 runs of 200 calls.  The two
no-launch variants' host times differ by the cost of encoding the two
tensor maps.  A variant's output is wrong by construction (``ex2 exp`` and
the tile widths excepted): the times only say how much of the kernels'
time each phase holds on its own.  Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
from pathlib import Path

import statistics
import time

from dynamic_tuning_tpu_torch.utils.ablation import (PKG, build_all,
                                                     copy_variant,
                                                     run_in_copy)

OUT = PKG.parent / "build" / "core_ablation"
CORE = Path("csrc") / "attention_sublayer.cu"
GEMM = Path("csrc") / "gemm.cuh"
CLAMPED = "fminf(fmaxf(s[4 * j + e], -60.f), 80.f)"
EXP = f"float p = expf({CLAMPED} - 20.f);"
NO_EXP = (CORE, EXP, f"float p = {CLAMPED};")
NO_QK = (CORE, "auto qk = [&](float (&s)[NS], int kc) {",
         "auto qk = [&](float (&s)[NS], int kc) { return;")
NO_PV = (CORE, "        if (r < np)\n          wgmma_rs<HD, true>",
         "        if (r < 0)\n          wgmma_rs<HD, true>")
WIDE_N = "constexpr int GEMM_WIDE_N = 2048;"
NO_LAUNCH = (GEMM, "  gemm_nt_kernel<BN, EPI, TX><<<grid, GEMM_THREADS, "
                   "T::SMEM, s>>>(\n      map_a, map_w, bias, M, N, K, "
                   "out_bf16, resid, out_x, out_f32, gate);", "  (void)grid;")
NO_MAPS = (GEMM, "  cudaError_t err = tensor_map_bf16(&map_a, A, M, K, T::BM);"
           "\n  if (err != cudaSuccess) return err;\n  err = tensor_map_bf16("
           "&map_w, W, N, K, BN);\n  if (err != cudaSuccess) return err;",
           "  cudaError_t err = cudaSuccess;")
# variant -> [(source, text, its replacement)]
VARIANTS = {
    "full": [],
    "ex2 exp": [(CORE, EXP,
                 f"float p = ex2(fmaf({CLAMPED}, LOG2E, -20.f * LOG2E));")],
    "no clamp": [(CORE, EXP, "float p = expf(s[4 * j + e] - 20.f);")],
    "no exp": [NO_EXP],
    "no Q K^T": [NO_QK],
    "no P V": [NO_PV],
    "no core math": [NO_EXP, NO_QK, NO_PV],
    "no GEMM stores": [(GEMM, "    if (row0 + r < M && col0 + c < N)",
                        "    if (row0 + r < 0)")],
    "GEMM 128x128 only": [(GEMM, WIDE_N,
                           "constexpr int GEMM_WIDE_N = 1 << 30;")],
    "GEMM 128x256 only": [(GEMM, WIDE_N, "constexpr int GEMM_WIDE_N = 0;")],
    "no GEMM launch": [NO_LAUNCH],
    "no launch or maps": [NO_LAUNCH, NO_MAPS],
}
GEMMS = {"proj": (25216, 768, 768), "qkv": (25216, 768, 2304),
         "fc1 dispatch": (12672, 768, 3072)}       # (M, K, N)


def time_variant() -> list[float]:
    """This package's K1 and K2 ms, the bf16 GEMM's ms at each of
    ``GEMMS``, and the host µs of one GEMM call: median, least, most."""
    import torch

    from dynamic_tuning_tpu_torch.ops import _build
    from dynamic_tuning_tpu_torch.ops import mha_serving as ms
    from dynamic_tuning_tpu_torch.utils.profile_int8 import make_mm
    from dynamic_tuning_tpu_torch.utils.profiling import time_ms

    g = torch.Generator(device="cuda").manual_seed(0)
    r = lambda *s, sc=1.0: torch.randn(s, generator=g, device="cuda") * sc
    B, N, C, H = 128, 197, 768, 12
    bf = torch.bfloat16
    qkv = r(B, N, 3 * C).to(bf)
    x = r(B, N, C).to(bf)
    sub = (r(C, sc=0.05) + 1.0, r(C, sc=0.02), r(3 * C, C, sc=0.03).to(bf),
           r(3 * C, sc=0.02), r(C, C, sc=0.03).to(bf), r(C, sc=0.02))
    out = [time_ms(lambda: ms.mha_serving_fused(qkv, heads=H)),
           time_ms(lambda: ms.attention_sublayer_serving(x, *sub, heads=H))]
    for M, K, Nn in GEMMS.values():
        a, bt = r(M, K).to(bf), r(Nn, K, sc=0.03).to(bf)
        mm = make_mm(M, K, Nn, bf, torch.float32)
        out.append(time_ms(lambda: mm.nt(a, bt)))
    del qkv, x, a, bt
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    a, w = r(128, C).to(bf), r(C, C).to(bf)
    o = torch.empty((128, C), device="cuda")
    call = lambda: lib.dyt_gemm_bf16_f32(a.data_ptr(), w.data_ptr(), 128, C,
                                         C, o.data_ptr(), stream)
    runs = []
    for _ in range(21):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            call()
        runs.append((time.perf_counter() - t0) / 200 * 1e6)
    torch.cuda.synchronize()
    return out + [statistics.median(runs), min(runs), max(runs)]


def main() -> None:
    roots = {name: copy_variant(OUT, name, edits)
             for name, edits in VARIANTS.items()}
    build_all(roots.values())
    print(f"{'variant':>18}  K1 ms   K2 ms   GEMM ms ("
          f"{', '.join(f'{k} {v}' for k, v in GEMMS.items())})   host µs "
          "a GEMM call: median (least-most)")
    for name, root in roots.items():
        p = run_in_copy(root, "from dynamic_tuning_tpu_torch.utils."
                              "core_ablation import time_variant; "
                              "print(*time_variant())",
                        stdout=subprocess.PIPE, text=True)
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"variant {name!r} failed")
        *ms_, med, lo, hi = map(float, out.split())
        print(f"{name:>18}  " + "  ".join(f"{v:.4f}" for v in ms_)
              + f"   {med:.3f} ({lo:.3f}-{hi:.3f})")


if __name__ == "__main__":
    main()
