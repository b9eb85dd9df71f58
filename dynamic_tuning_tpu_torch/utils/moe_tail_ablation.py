"""Where the MoE tail kernel's time goes: the kernel with one phase taken out.

    python -m dynamic_tuning_tpu_torch.utils.moe_tail_ablation

``csrc/moe_adapter.cu`` is copied once per variant into
``build/moe_tail_ablation/<variant>/`` (with the rest of the package), one
phase is cut out of the copy's source, the copies are built in parallel and
each is timed in its own process at ViT-B/16 serving shapes (128 x 197 rows,
C 768, 4 experts of 64, with the router head), with CUDA events over 20
launches, best of 3.  A variant's output is wrong by construction: the
times only say how much of the kernel's time each phase holds on its own.
Needs a CUDA device.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
OUT = PKG.parent / "build" / "moe_tail_ablation"
CU = Path("csrc") / "moe_adapter.cu"
ROUTER = "for (int e = 0; e < NR; ++e) {\n        const float* w"
# variant -> (text in the kernel source, its replacement)
VARIANTS = {
    "full": [],
    "no router dots": [(ROUTER, ROUTER.replace("e < NR", "e < 0"))],
    "no down products": [("for (int kk = 0; kk < MOE_CHUNK; kk += 16) {",
                          "for (int kk = 0; kk < 0; kk += 16) {")],
    "no up products": [("for (int kk = 0; kk < W; kk += 16) {",
                        "for (int kk = 0; kk < 0; kk += 16) {")],
    "no Wd staging": [("i < W * (MOE_CHUNK / 8); i += MOE_THREADS) {",
                       "i < 0; i += MOE_THREADS) {")],
    "no Wu staging": [("i < MOE_CHUNK * (W / 8); i += MOE_THREADS) {",
                       "i < 0; i += MOE_THREADS) {")],
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


def _copy(name: str, edits) -> Path:
    root = OUT / name.replace(" ", "_")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, root / PKG.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = root / PKG.name / CU
    text = src.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name!r}: {old!r} is not in {CU}")
        text = text.replace(old, new)
    src.write_text(text)
    return root


def _run(root: Path, code: str, **kw) -> subprocess.Popen:
    # run from the copy: ``python -c`` puts the working directory first on
    # the import path, ahead of PYTHONPATH
    env = dict(os.environ, PYTHONPATH=str(root))
    return subprocess.Popen([sys.executable, "-c", code], cwd=root, env=env,
                            **kw)


def main() -> None:
    roots = {name: _copy(name, edits) for name, edits in VARIANTS.items()}
    builds = [_run(root, "from dynamic_tuning_tpu_torch.ops import _build; "
                         "_build.library()") for root in roots.values()]
    if any(p.wait() for p in builds):
        raise RuntimeError("a variant did not build")
    for name, root in roots.items():
        p = _run(root, "from dynamic_tuning_tpu_torch.utils.moe_tail_ablation "
                       "import time_tail; print(time_tail())",
                 stdout=subprocess.PIPE, text=True)
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"variant {name!r} failed")
        print(f"{name:>18}: {float(out) * 1e3:8.1f} us")


if __name__ == "__main__":
    main()
