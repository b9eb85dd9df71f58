"""Where the serving attention core's, the GEMM's, the windowed
attention's, the int8 core's and the dense adapter/router's time goes: the
kernels with one phase taken out or one choice changed.

    python -m dynamic_tuning_tpu_torch.utils.core_ablation [VARIANT ...]

The package is copied once per variant into ``build/core_ablation/
<variant>/``, and the copy's ``csrc/attention_sublayer.cu`` (the core),
``csrc/gemm.cuh`` (the bf16 / int8 GEMM), ``csrc/windowed_attention.cu``
(K9), ``csrc/quant.cu`` (K10) or ``csrc/dyt_prologue.cu`` (the adapter/
router) is edited: one phase cut out, the core's exp swapped for
``ex2.approx`` of x log2 e, one GEMM tile width used at every N for one
operand type (``GemmOperand<T>::WIDE_N``), the GEMM's launch and then also
its two TMA tensor maps taken out of its host function, K9 without its bias
tile (no TMA load, a zero bias), without its exp, or with a ring of three
or four stages (three or two blocks an SM at hd 64, where two stages fit
four); K10 with its k pass alone (the k and V staging, the lane means, the
row amaxes traded in the cluster and the key codes; no query tile), without
its k pass (the loads kept, the sums, amaxes and codes not made), without
its cluster (each block takes its own lanes' amax), without its exp, or
without P V; the adapter/router without its router dots, its down or up
product, its output stores or its x_mid loads (the producer brings the
weights only).  The copies are built in parallel and
each, in its own process, times with CUDA events over 20 calls after 3
warm-up ones: K1 (``mha_serving_fused``: the core alone) and K2
(``attention_sublayer_serving``: LN, the qkv GEMM, the core, the proj GEMM)
at ViT-B/16 serving shapes (B=128, N=197, C=768, 12 heads of 64); the
bf16 GEMM (K16's entry, fp32 out) and the int8 GEMM (the stem's entry: the
dequantizing bf16 store of the serving epilogues, unit scales) at the
proj, qkv and dispatch fc1 shapes; K9 through its C entry at B=1 and 2
(N=1025, 12 heads of 64, the layer's padded bf16 bias); K10 through its C
entry at B=128, N=197, 12 heads of 64; the adapter/router through its C
entry at 128 x 197 rows of width 768, F = 64, bf16 out, with the router,
beside one library call that moves its bytes (x_mid copied to bf16); and on
the host's
clock one bf16 GEMM call through ctypes (M=128, 768 x 768): the median and
range over 21 runs of 200 calls.  The two no-launch variants' host times
differ by the cost of encoding the two tensor maps.  A variant's output is
wrong by construction (``ex2 exp`` and the tile widths excepted): the times
only say how much of the kernels' time each phase holds on its own.  Named
variants run alone (with ``full`` always).  Needs a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from dynamic_tuning_tpu_torch.utils.ablation import (PKG, build_all,
                                                     copy_variant,
                                                     run_in_copy)

OUT = PKG.parent / "build" / "core_ablation"
CORE = Path("csrc") / "attention_sublayer.cu"
GEMM = Path("csrc") / "gemm.cuh"
WIN = Path("csrc") / "windowed_attention.cu"
QUANT = Path("csrc") / "quant.cu"
AR = Path("csrc") / "dyt_prologue.cu"
CLAMPED = "fminf(fmaxf(s[4 * j + e], -60.f), 80.f)"
EXP = f"float p = expf({CLAMPED} - 20.f);"
NO_EXP = (CORE, EXP, f"float p = {CLAMPED};")
NO_QK = (CORE, "auto qk = [&](float (&s)[NS], int kc) {",
         "auto qk = [&](float (&s)[NS], int kc) { return;")
NO_PV = (CORE, "        if (r < np)\n          wgmma_rs<HD, true>",
         "        if (r < 0)\n          wgmma_rs<HD, true>")


def wide_n(tma_type: str, n: str) -> tuple:
    """The GEMM of one operand type with 128 x 256 tiles from N = ``n``."""
    return (GEMM, f"      {tma_type};\n  static constexpr int WIDE_N = 2048;",
            f"      {tma_type};\n  static constexpr int WIDE_N = {n};")


def k9_stages(stages: int, blocks: int) -> list:
    """K9's ring of ``stages`` stages, ``blocks`` blocks an SM at hd 64."""
    return [(WIN, "  static constexpr int STAGES = 2;",
             f"  static constexpr int STAGES = {stages};"),
            (WIN, "  static constexpr int BLOCKS = HD == 64 ? 4 : 2;",
             f"  static constexpr int BLOCKS = HD == 64 ? {blocks} : 2;")]


BF16_MAP = "CU_TENSOR_MAP_DATA_TYPE_BFLOAT16"
INT8_MAP = "CU_TENSOR_MAP_DATA_TYPE_UINT8"
NO_LAUNCH = (GEMM, "  gemm_nt_kernel<T, BN, Epi><<<grid, GEMM_THREADS, "
                   "Tl::SMEM, s>>>(\n      map_a, map_w, M, N, K, epi);",
             "  (void)grid;")
NO_MAPS = (GEMM, "  cudaError_t err = tensor_map_rows(&map_a, A, M, K, "
                 "Tl::BM);\n  if (err != cudaSuccess) return err;\n  err = "
                 "tensor_map_rows(&map_w, W, N, K, BN);\n  if (err != "
                 "cudaSuccess) return err;",
           "  cudaError_t err = cudaSuccess;")
WIN_EXP = ("          float p =\n              expf(fminf(fmaxf(s[4 * j + e] "
           "+ bv[e], -60.f), 80.f) - 20.f);")
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
    "no GEMM stores": [(GEMM, "    if (row0 + r < M && col0 + c < N) {",
                        "    if (row0 + r < 0) {")],
    "GEMM 128x128 only": [wide_n(BF16_MAP, "1 << 30")],
    "GEMM 128x256 only": [wide_n(BF16_MAP, "0")],
    "int8 GEMM 128x128 only": [wide_n(INT8_MAP, "1 << 30")],
    "int8 GEMM 128x256 only": [wide_n(INT8_MAP, "0")],
    "no GEMM launch": [NO_LAUNCH],
    "no launch or maps": [NO_LAUNCH, NO_MAPS],
    "K9 no bias tile": [
        (WIN, "    mbar_expect_tx(&full[st], L::STAGE);",
         "    mbar_expect_tx(&full[st], 2 * L::KV);"),
        (WIN, "    tma_load_3d(dst + 2 * L::KV, &map_bias, &full[st], k0, q0, "
              "h);\n", ""),
        (WIN, "        const float2 b_lo = load2(brow), b_hi = load2(brow + 8 "
              "* 64);",
         "        const float2 b_lo = make_float2(0.f, 0.f), b_hi = b_lo;\n"
         "        (void)brow;")],
    "K9 no exp": [(WIN, WIN_EXP, "          float p = fminf(fmaxf(s[4 * j + "
                                 "e] + bv[e], -60.f), 80.f) - 20.f;")],
    "K9 3 stages": k9_stages(3, 3),
    "K9 4 stages": k9_stages(4, 2),
    "K10 k pass only": [(QUANT, "  for (int qt = 0; qt < nq; ++qt) {",
                         "  for (int qt = 0; qt < 0; ++qt) {")],
    "K10 no exp": [(QUANT, "float p = expf(fminf(fmaxf(sv, -60.f), 80.f) - "
                           "20.f);",
                    "float p = fminf(fmaxf(sv, -60.f), 80.f);")],
    "K10 no P V": [(QUANT, NO_PV[1], NO_PV[2])],
    "K10 no k pass": [
        (QUANT, "    for (int n = rg; n < N; n += RG) {\n      float v[8];\n      load8(Kraw",
         "    for (int n = rg; n < 0; n += RG) {\n      float v[8];\n      load8(Kraw"),
        (QUANT, "  for (int n0 = 0; n0 < N; n0 += RG) {", "  for (int n0 = 0; n0 < 0; n0 += RG) {"),
        (QUANT, "  for (int n = tid; n < N; n += Q8C_THREADS) {\n    const float amax",
         "  for (int n = tid; n < 0; n += Q8C_THREADS) {\n    const float amax"),
        (QUANT, "  for (int n = rg; n < N; n += RG) {\n    float v[8];\n    centred(n, v);",
         "  for (int n = rg; n < 0; n += RG) {\n    float v[8];\n    centred(n, v);")],
    "K10 no cluster": [
        (QUANT, "__global__ void __cluster_dims__(2, 1, 1)\n", "__global__ void\n"),
        (QUANT, "fmaxf(ramax[n], ld_cluster(ramax + n, hh ^ 1))", "ramax[n]"),
        (QUANT, '  asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: "memory");', ""),
        (QUANT, '  asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");', "")],
    "adapter no router": [(AR, "const bool router = wsel != nullptr;",
                           "const bool router = false;")],
    "adapter no up product": [(AR, "for (int s = 0; s < F / 16; ++s)",
                               "for (int s = 0; s < 0; ++s)")],
    "adapter no stores": [(AR, "      gemm_store_chunk<TO>(v, adapt,",
                           "      if (M < 0) gemm_store_chunk<TO>(v, adapt,")],
    "adapter no down product": [
        (AR, "for (int kk = 0; kk < 4; ++kk)\n        wgmma_rs<FH, false>(",
         "for (int kk = 0; kk < 0; ++kk)\n        wgmma_rs<FH, false>(")],
    "adapter no x loads": [
        (AR, "          tma_load_2d(st, &map_x, &full[stage], k * AR_CHUNK, "
             "m0);\n          tma_load_2d(st + AR_XBOX, &map_x, &full[stage], "
             "k * AR_CHUNK + 32,\n                      m0);\n", ""),
        (AR, "slot(L::STAGE)", "slot(L::STAGE - 2 * AR_XBOX)")],
}
GEMMS = {"proj": (25216, 768, 768), "qkv": (25216, 768, 2304),
         "fc1 dispatch": (12672, 768, 3072)}       # (M, K, N)


def time_variant() -> dict:
    """This package's ms: K1, K2, the bf16 and int8 GEMMs at each of
    ``GEMMS``, K9 at B=1 and 2, K10, the adapter/router; and the host µs of
    one bf16 GEMM call: median, least, most."""
    import torch

    from dynamic_tuning_tpu_torch.ops import _build
    from dynamic_tuning_tpu_torch.ops import mha_serving as ms
    from dynamic_tuning_tpu_torch.utils.profile_int8 import make_mm
    from dynamic_tuning_tpu_torch.utils.profiling import time_ms

    g = torch.Generator(device="cuda").manual_seed(0)
    r = lambda *s, sc=1.0: torch.randn(s, generator=g, device="cuda") * sc
    B, N, C, H = 128, 197, 768, 12
    bf = torch.bfloat16
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    qkv = r(B, N, 3 * C).to(bf)
    x = r(B, N, C).to(bf)
    sub = (r(C, sc=0.05) + 1.0, r(C, sc=0.02), r(3 * C, C, sc=0.03).to(bf),
           r(3 * C, sc=0.02), r(C, C, sc=0.03).to(bf), r(C, sc=0.02))
    out = {"K1": time_ms(lambda: ms.mha_serving_fused(qkv, heads=H)),
           "K2": time_ms(lambda: ms.attention_sublayer_serving(x, *sub,
                                                               heads=H))}
    del qkv, x
    for name, (M, K, Nn) in GEMMS.items():
        a, bt = r(M, K).to(bf), r(Nn, K, sc=0.03).to(bf)
        mm = make_mm(M, K, Nn, bf, torch.float32)
        out[f"bf16 {name}"] = time_ms(lambda: mm.nt(a, bt))
        a8 = torch.randint(-127, 128, (M, K), dtype=torch.int8,
                           device="cuda")
        w8 = torch.randint(-127, 128, (Nn, K), dtype=torch.int8,
                           device="cuda")
        ones_m, ones_n = torch.ones(M, device="cuda"), torch.ones(
            Nn, device="cuda")
        zeros = torch.zeros(Nn, device="cuda")
        o8 = torch.empty((M, Nn), dtype=bf, device="cuda")
        out[f"int8 {name}"] = time_ms(lambda: lib.dyt_q8_stem_gemm(
            a8.data_ptr(), w8.data_ptr(), ones_m.data_ptr(),
            ones_n.data_ptr(), zeros.data_ptr(), M, Nn, K, o8.data_ptr(), 0,
            stream))
        del a, bt, a8, w8, o8
    sn = 1025
    ld = ms.bias_row_stride(sn)
    bias = r(H, sn, ld).to(bf)[:, :, :sn]
    for batch in (1, 2):
        sq = r(batch, sn, 3 * C).to(bf)
        so = torch.empty((batch, sn, C), dtype=bf, device="cuda")
        out[f"K9 B={batch}"] = time_ms(lambda: lib.dyt_mha_windowed(
            sq.data_ptr(), bias.data_ptr(), so.data_ptr(), batch, sn, C, H,
            bias.stride(0), bias.stride(1), 0.125, stream))
    q8 = r(B, N, 3 * C).to(bf)
    o8 = torch.empty((B, N, C), dtype=bf, device="cuda")
    out["K10"] = time_ms(lambda: lib.dyt_attn_core_q8(
        q8.data_ptr(), o8.data_ptr(), B, N, C, H, 0.125, stream))
    M, F = B * N, 64
    xm = r(M, C)
    ad = (r(F, C, sc=0.03).to(bf), r(F, sc=0.02), r(C, F, sc=0.02).to(bf),
          r(C, sc=0.01), torch.full((1,), 0.1, device="cuda"),
          r(C, sc=0.9), r(1, sc=0.1))
    adapt = torch.empty((M, C), dtype=bf, device="cuda")
    lg = torch.empty((M,), device="cuda")
    out["adapter"] = time_ms(lambda: lib.dyt_adapter_router(
        xm.data_ptr(), M, C, *(t.data_ptr() for t in ad), adapt.data_ptr(),
        0, lg.data_ptr(), F, stream))
    # the same bytes through one library call: x_mid read, a bf16 copy
    # written
    out["x_mid to bf16"] = time_ms(lambda: adapt.copy_(xm))
    del q8, o8, xm, adapt
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
    out.update({"host us": statistics.median(runs), "least": min(runs),
                "most": max(runs)})
    return out


def main(names) -> None:
    chosen = {n: e for n, e in VARIANTS.items()
              if not names or n in names or n == "full"}
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; have "
                         f"{list(VARIANTS)}")
    roots = {name: copy_variant(OUT, name, edits)
             for name, edits in chosen.items()}
    build_all(roots.values())
    print(f"ms; GEMM shapes (M, K, N): {GEMMS}; host µs a bf16 GEMM call: "
          "median (least-most)")
    for name, root in roots.items():
        p = run_in_copy(root, "import json; from dynamic_tuning_tpu_torch."
                              "utils.core_ablation import time_variant; "
                              "print(json.dumps(time_variant()))",
                        stdout=subprocess.PIPE, text=True)
        res, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"variant {name!r} failed")
        t = json.loads(res.strip().splitlines()[-1])
        print(f"{name:>22}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()
            if k not in ("host us", "least", "most"))
            + f"; host {t['host us']:.3f} ({t['least']:.3f}-{t['most']:.3f})",
            flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
