"""Where the MoE tail kernel's time goes: the kernel with one phase taken out.

    python -m dynamic_tuning_tpu_torch.utils.moe_tail_ablation

``csrc/moe_adapter.cu`` is copied once per variant into
``build/moe_tail_ablation/<variant>/`` (with the rest of the package), one
phase is cut out of the copy's source (the router dots, the down product's
wgmma, the round-to-nearest adds of both products' partials, the H tile
build, the up product's wgmma, its epilogue), the copies are built in
parallel and each is timed in its own process at ViT-B/16 serving shapes
(128 x 197 rows, C 768, 4 experts of 64, with the router head), with CUDA
events over 20 launches, best of 3.  A variant's output is wrong by
construction: the times only say how much of the kernel's time each phase
holds on its own.  Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
from pathlib import Path

from dynamic_tuning_tpu_torch.utils.ablation import (PKG, build_all,
                                                     copy_variant,
                                                     run_in_copy)

OUT = PKG.parent / "build" / "moe_tail_ablation"
CU = Path("csrc") / "moe_adapter.cu"
# variant -> (text in the kernel source, its replacement), one per phase
VARIANTS = {
    "full": [],
    "no router dots": [("        if (p == 0) dots();\n", "")],
    "no down wgmma": [("          for (int q = 0; q < 2; ++q)\n"
                       "            wgmma_rs<64, false>(",
                       "          for (int q = 0; q < 0; ++q)\n"
                       "            wgmma_rs<64, false>(")],
    "no rn adds": [("acc[e] = __fadd_rn(acc[e], p[e]);", "acc[e] = p[e];")],
    "no H build": [("if (P >= npiece) continue;", "continue;")],
    "no up wgmma": [("          for (int i = 0; i < 4; ++i) {\n"
                     "            const int s = s0 + i, ks = ks0 + s;",
                     "          for (int i = 0; i < 0; ++i) {\n"
                     "            const int s = s0 + i, ks = ks0 + s;")],
    "no epilogue": [("      gemm_store_chunk<TO>(v, adapt,",
                     "      if (false) gemm_store_chunk<TO>(v, adapt,")],
}


def time_tail(E: int = 4, b: int = 64, iters: int = 20) -> float:
    """Best-of-3 ms per launch of this package's MoE tail kernel."""
    import torch

    from dynamic_tuning_tpu_torch.ops import _build
    from dynamic_tuning_tpu_torch.ops import mha_serving as ms

    lib = _build.library()
    g = torch.Generator(device="cuda").manual_seed(0)
    C = 768
    r = lambda *s, sc: torch.randn(s, generator=g, device="cuda") * sc
    xm = r(128, 197, C, sc=1.0)
    x_mid = xm.to(torch.bfloat16)
    moe = (r(E, C, sc=2.0 / C ** 0.5),
           *ms.moe_kernel_weights(r(E, C, b, sc=0.03), r(E, b, sc=0.02),
                                  r(E, b, C, sc=0.02), torch.bfloat16),
           r(E, C, sc=0.01), torch.full((1,), 0.1, device="cuda"))
    sel = (r(1, C, sc=25.0 / C ** 0.5), r(1, sc=0.1))

    def launch():
        ms.launch_moe_adapter_router(lib, x_mid, xm, *moe, *sel, 1.0, True)

    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            launch()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def main() -> None:
    roots = {name: copy_variant(OUT, name, [(CU, *e) for e in edits])
             for name, edits in VARIANTS.items()}
    build_all(roots.values())
    for name, root in roots.items():
        p = run_in_copy(root, "from dynamic_tuning_tpu_torch.utils."
                              "moe_tail_ablation import time_tail; "
                              "print(time_tail())",
                        stdout=subprocess.PIPE, text=True)
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"variant {name!r} failed")
        print(f"{name:>18}: {float(out) * 1e3:8.1f} us")


if __name__ == "__main__":
    main()
