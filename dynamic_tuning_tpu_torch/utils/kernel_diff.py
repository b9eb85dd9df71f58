"""The bf16 attention core (K1, K15) and the windowed core (K9) at head dims
64 to 256, the fp32 core, the int8 attention core (K10), the dense
adapter/router kernel and the MoE tail of this tree against the same
kernels of another checkout, bit for bit.

    python -m dynamic_tuning_tpu_torch.utils.kernel_diff OTHER_TREE

OTHER_TREE is the root of another checkout of the repository (the parent
commit unpacked with ``git archive``, say).  Its kernels are built from its
own sources by its own ``ops/_build.py`` and called through their C entries
(K10's with or without the k-code scratch of the earlier form, the core's
with or without the earlier form's SIMT flag, as that tree's signature
table says); this tree's through its wrappers (the core through its C
entry, ``dyt_mha_core``, in both).  Over the cases below,
which ``tests/test_torch_port_cuda.py`` also holds against the plain
versions -- the core in both modes at every shape of ``CORE`` (the staged
kernel whole-row and in 64-key chunks, the ring past the staged N; at head
dims 192 and 256 the wide kernel and its ring), K9 at every shape of
``WINDOWED`` with a padded bf16 bias, the fp32 core (``dyt_f32_core``) at
every shape of ``F32_CORE`` with and without K9's bias, the exact fp32
core (``dyt_exact_core``, on trees that have it) at every shape of
``EXACT_CORE``, K10 at
every N of ``CORE_Q8_N`` at head dims 64 and 128
and on the adversarial head pair, the adapter/router at every M x C x F of
``AR_M``, ``AR_C``, ``AR_F`` in bf16 and fp32 out, with and without the
router, the bf16 MoE tail at every E x b, M x C of ``MOE_TAIL`` (E * b up to
512, the widths every tree since the tail's takes; those of ``MOE_WIDE``,
up to 1024, where the other tree's tail takes them too), bf16 out, with
and without the router -- it prints, per kernel, how many output elements
differ and by how many ulps of their type at most, and the largest
|difference| of the router logits.  Then it times both trees' kernels through their C entries
at the main path's shapes (``TIMED``: K10 at B=128, N=197, 12 heads of 64
and at B=32, N=512 in 12 heads of 64 and 6 of 128; the adapter/router at
128 x 197 rows of ViT-B/16, F = 64, bf16 out, with the router), in turns
(other, this, this, other; CUDA events, 20 calls after 3 warm-up ones),
beside the bound of the bytes each moves.  Needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import torch

CORE = ((2, 19, 2, 64), (32, 197, 12, 64), (2, 197, 2, 128),
        (2, 256, 2, 64), (2, 209, 2, 128), (2, 300, 2, 64), (1, 864, 2, 64),
        (1, 865, 2, 64), (1, 417, 2, 128), (2, 901, 12, 64),
        (8, 197, 4, 192), (2, 300, 2, 192), (8, 197, 4, 256),
        (2, 240, 2, 256))
WINDOWED = ((1, 1025, 12, 64), (2, 197, 4, 128), (3, 19, 2, 64),
            (2, 129, 2, 128), (1, 1025, 4, 192), (2, 129, 2, 192),
            (1, 1025, 2, 256), (3, 19, 2, 256))
F32_CORE = ((32, 197, 12, 64), (3, 19, 2, 64), (2, 129, 2, 64),
            (2, 50, 2, 128), (2, 97, 2, 192), (2, 33, 2, 256),
            (1, 1025, 2, 64))
EXACT_CORE = ((32, 197, 12, 64), (3, 19, 2, 64), (2, 65, 6, 128),
              (3, 197, 4, 192), (2, 197, 4, 256))
CORE_Q8_N = (1, 17, 64, 65, 197, 256, 257, 442, 511, 512)
AR_M = (1, 63, 64, 129, 25216)
AR_C = (64, 128, 768, 1024)
AR_F = (16, 32, 48, 64, 96, 128)
# (E, b, M, C) of the MoE tail
MOE_TAIL = ((4, 64, 6304, 768), (4, 64, 25216, 768), (2, 16, 129, 64),
            (4, 8, 1, 768), (8, 64, 1000, 768), (2, 256, 63, 768),
            (4, 128, 6304, 768), (4, 80, 200, 128))
MOE_WIDE = ((4, 192, 6304, 768), (3, 256, 129, 768), (4, 256, 63, 768),
            (16, 64, 200, 768))
# (kernel, B, N, heads) for K10, (kernel, M, C, F) for the adapter/router
TIMED = (("K10", 128, 197, 12), ("K10", 32, 512, 12), ("K10", 32, 512, 6),
         ("adapter/router", 128 * 197, 768, 64))


def core_q8_qkv(B, N, C, H, *, seed=5, pair=False) -> torch.Tensor:
    """Raw qkv [B, N, 3C] bf16 on the card.  Serving-like scales: keys with
    a common offset, head 1 of each pair at twice head 0's range.  With
    ``pair`` the adversarial head pair of tests/test_torch_port_quant.py:
    head 0's keys at half range, head 1's at 10x, every key lane offset by
    3."""
    hd = C // H
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((B, N, 3 * C), generator=g, device="cuda")
    k = qkv[..., C:2 * C].view(B, N, H // 2, 2, hd)
    if pair:
        k[..., 0, :] *= 0.5
        k[..., 1, :] *= 10.0
        k += 3.0
    else:
        k[..., 1, :] *= 2.0
        k += 1.0
    return qkv.to(torch.bfloat16)


def core_q8_cases():
    """(name, qkv, heads): two samples of width 256 per head dim and N, then
    the adversarial pair at N = 17 and 197."""
    for hd in (64, 128):
        H = 256 // hd
        for n in CORE_Q8_N:
            yield f"hd {hd}, N {n}", core_q8_qkv(2, n, 256, H), H
        for n in (17, 197):
            yield (f"hd {hd}, N {n}, adversarial pair",
                   core_q8_qkv(2, n, 256, H, pair=True), H)


def adapter_inputs(M, C, F, *, seed=23):
    """(xm [1, M, C] fp32, (wdown, bdown, wup, bup, adapter_scale), (wsel,
    bsel)) on the card at serving scales."""
    g = torch.Generator(device="cuda").manual_seed(seed + F)
    r = lambda *s, sc=1.0: torch.randn(s, generator=g, device="cuda") * sc
    bf = torch.bfloat16
    xm = r(1, M, C)
    ad = (r(F, C, sc=0.03).to(bf), r(F, sc=0.02), r(C, F, sc=0.02).to(bf),
          r(C, sc=0.01), torch.full((1,), 0.1, device="cuda"))
    return xm, ad, (r(1, C, sc=25.0 / C ** 0.5), r(1, sc=0.1))


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units in the last place of their type (bf16 or fp32),
    counted across zero."""
    itype = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    sign = 0x7FFF if itype == torch.int16 else 0x7FFFFFFF

    def ordered(x):
        i = x.contiguous().view(itype).long()
        return torch.where(i < 0, -(i & sign), i)

    return (ordered(a) - ordered(b)).abs()


def _other_library(root: Path):
    """The other tree's kernel library, built by its own ``_build``, and
    its ctypes signature table."""
    path = root / "dynamic_tuning_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location("other_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library(), mod._SIGNATURES


def other_core_q8(other, sigs, qkv, out, H, stream) -> int:
    """The other tree's K10 through its C entry; its error code.  The
    earlier form of the entry took k-code scratch ([B*N, C] int8 and
    [B*N, H/2] fp32) after ``out``."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    scratch = ()
    if len(sigs["dyt_attn_core_q8"]) == 10:
        scratch = (torch.empty((B * N, C), dtype=torch.int8, device="cuda"),
                   torch.empty((B * N, H // 2), device="cuda"))
    return other.dyt_attn_core_q8(
        qkv.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in scratch), B,
        N, C, H, (C // H) ** -0.5, stream)


def core_mode(sigs, k15) -> tuple:
    """``dyt_mha_core``'s arguments after the scale: the mode, then the
    earlier form's SIMT flag (0, the wgmma core) where the entry takes it."""
    return (k15, 0) if len(sigs["dyt_mha_core"]) == 13 else (k15,)


class Tally:
    def __init__(self):
        self.cases = self.elements = self.differ = self.max_ulps = 0
        self.logit_err = 0.0

    def add(self, got, want, logits=None):
        d = ulps(got, want)
        self.cases += 1
        self.elements += d.numel()
        self.differ += int((d > 0).sum())
        self.max_ulps = max(self.max_ulps, int(d.max()))
        if logits is not None:
            self.logit_err = max(self.logit_err,
                                 (logits[0] - logits[1]).abs().max().item())

    def line(self, name):
        return (f"{name}: {self.cases} cases, {self.differ} of "
                f"{self.elements} output elements differ, at most "
                f"{self.max_ulps} ulps; router logits max |diff| "
                f"{self.logit_err:.6g}")


def main(argv) -> None:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_diff needs a CUDA device")
    from dynamic_tuning_tpu_torch.ops import _build
    from dynamic_tuning_tpu_torch.ops import mha_serving as ms
    from dynamic_tuning_tpu_torch.ops import quant as qt

    lib = _build.library()
    other, sigs = _other_library(Path(argv[0]).resolve())
    stream = torch.cuda.current_stream().cuda_stream
    p = lambda t: None if t is None else t.data_ptr()

    for k15 in (0, 1):
        bf16_core = Tally()
        for B, N, H, hd in CORE:
            qkv = core_q8_qkv(B, N, H * hd, H, seed=N)
            q, k, v = qkv.view(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
            outs = []
            for which, table in ((lib, _build._SIGNATURES),
                                 (other, sigs)):
                o = torch.empty((B, N, H, hd), dtype=torch.bfloat16,
                                device="cuda").transpose(1, 2)
                _build.check(which, which.dyt_mha_core(
                    p(q), p(k), p(v), p(o), _build.strides_arg(q, k, v, o),
                    B, N, H, hd, hd ** -0.5, *core_mode(table, k15),
                    stream), "core")
                outs.append(o)
            torch.cuda.synchronize()
            bf16_core.add(*outs)
        print(bf16_core.line(f"bf16 core, {'K15' if k15 else 'K1'} mode"),
              flush=True)

    windowed = Tally()
    for B, N, H, hd in WINDOWED:
        qkv = core_q8_qkv(B, N, H * hd, H, seed=N + 1)
        ld = ms.bias_row_stride(N)
        g = torch.Generator(device="cuda").manual_seed(N)
        bias = torch.randn((H, N, ld), generator=g, device="cuda").to(
            torch.bfloat16)[:, :, :N]
        outs = []
        for which in (lib, other):
            o = torch.empty((B, N, H * hd), dtype=torch.bfloat16,
                            device="cuda")
            _build.check(which, which.dyt_mha_windowed(
                p(qkv), p(bias), p(o), B, N, H * hd, H, bias.stride(0),
                bias.stride(1), hd ** -0.5, stream), "K9")
            outs.append(o)
        torch.cuda.synchronize()
        windowed.add(*outs)
    print(windowed.line("K9 mha_windowed_fused"), flush=True)

    for with_bias in (False, True):
        f32_core = Tally()
        for B, N, H, hd in F32_CORE:
            qkv = core_q8_qkv(B, N, H * hd, H, seed=N + 2).float()
            q, k, v = qkv.view(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
            g = torch.Generator(device="cuda").manual_seed(N)
            b = (ms._windowed_bias(torch.randn((H, N, N), generator=g,
                                               device="cuda").to(
                torch.bfloat16), H, N) if with_bias else None)
            outs = []
            for which in (lib, other):
                o = torch.empty((B, N, H, hd), device="cuda").transpose(1, 2)
                _build.check(which, which.dyt_f32_core(
                    p(q), p(k), p(v), p(o), _build.strides_arg(q, k, v, o),
                    B, N, H, hd, hd ** -0.5, p(b),
                    0 if b is None else b.stride(0),
                    0 if b is None else b.stride(1), stream), "fp32 core")
                outs.append(o)
            torch.cuda.synchronize()
            f32_core.add(*outs)
        print(f32_core.line("fp32 core" + (", K9's bias" if with_bias
                                           else "")), flush=True)

    if "dyt_exact_core" in sigs:
        exact = Tally()
        for B, N, H, hd in EXACT_CORE:
            qkv = core_q8_qkv(B, N, H * hd, H, seed=N + 3).float()
            outs = []
            for which in (lib, other):
                o = torch.empty((B, N, H * hd), device="cuda")
                _build.check(which, which.dyt_exact_core(
                    p(qkv), p(o), B, N, H * hd, H, hd ** -0.5, stream),
                    "exact core")
                outs.append(o)
            torch.cuda.synchronize()
            exact.add(*outs)
        print(exact.line("exact fp32 core"), flush=True)

    core = Tally()
    for _, qkv, H in core_q8_cases():
        got = qt.attn_core_pairs_q8(qkv, heads=H)
        want = torch.empty_like(got)
        _build.check(other, other_core_q8(other, sigs, qkv, want, H, stream),
                     "other tree's K10")
        torch.cuda.synchronize()
        core.add(got, want)
    print(core.line("K10 attn_core_pairs_q8"), flush=True)

    adapter = Tally()
    for M in AR_M:
        for C in AR_C:
            for F in AR_F:
                xm, ad, sel = adapter_inputs(M, C, F)
                for dtype in (torch.bfloat16, torch.float32):
                    x_mid = xm.to(dtype)
                    for router in (True, False):
                        ms.check_adapter_router(lib, x_mid, *ad, *sel, router)
                        got = ms.launch_adapter_router(lib, x_mid, xm, *ad,
                                                       *sel, router)
                        want = torch.empty_like(x_mid)
                        lw = torch.empty((1, M, 1), device="cuda")
                        _build.check(other, other.dyt_adapter_router(
                            p(xm), M, C, p(ad[0]), p(ad[1]), p(ad[2]),
                            p(ad[3]), p(ad[4]), p(sel[0]) if router else None,
                            p(sel[1]) if router else None, p(want),
                            int(dtype == torch.float32), p(lw), F, stream),
                            "other tree's adapter/router")
                        torch.cuda.synchronize()
                        adapter.add(got[1], want,
                                    (got[2], lw) if router else None)
    print(adapter.line("adapter/router"), flush=True)

    tail = Tally()
    wide = tuple(c for c in MOE_WIDE
                 if other.dyt_moe_width_supported(c[0], c[1]))
    for E, b, M, C in MOE_TAIL + wide:
        g = torch.Generator(device="cuda").manual_seed(E * b + M)
        r = lambda *s, sc=1.0: torch.randn(s, generator=g,  # noqa: E731
                                           device="cuda") * sc
        bf = torch.bfloat16
        xm = r(1, M, C)
        moe = (r(E, C, sc=2.0 / C ** 0.5),
               *ms.moe_kernel_weights(r(E, C, b, sc=0.03), r(E, b, sc=0.02),
                                      r(E, b, C, sc=0.02), bf),
               r(E, C, sc=0.01), torch.full((1,), 0.1, device="cuda"))
        sel = (r(1, C, sc=25.0 / C ** 0.5), r(1, sc=0.1))
        for router in (True, False):
            outs = []
            for which in (lib, other):
                adapt = torch.empty((1, M, C), dtype=bf, device="cuda")
                lw = torch.empty((1, M, 1), device="cuda")
                _build.check(which, which.dyt_moe_adapter_router(
                    p(xm), M, C, *(p(t) for t in moe),
                    p(sel[0]) if router else None,
                    p(sel[1]) if router else None, p(adapt), 0, p(lw), E, b,
                    1.0 / 0.7, stream), "MoE tail")
                outs.append((adapt, lw))
            torch.cuda.synchronize()
            tail.add(outs[0][0], outs[1][0],
                     (outs[0][1], outs[1][1]) if router else None)
    print(tail.line(f"MoE tail (E * b <= {512 if not wide else 1024})"),
          flush=True)

    from dynamic_tuning_tpu_torch.utils.profiling import (bound_ms,
                                                          card_line, time_ms)
    print(card_line())
    for kernel, *shape in TIMED:
        if kernel == "K10":
            B, N, H = shape
            C = 768
            qkv = core_q8_qkv(B, N, C, H)
            out = torch.empty((B, N, C), dtype=torch.bfloat16, device="cuda")
            mine = lambda: lib.dyt_attn_core_q8(
                p(qkv), p(out), B, N, C, H, (C // H) ** -0.5, stream)
            theirs = lambda: other_core_q8(other, sigs, qkv, out, H, stream)
            moved = 4 * B * N * C * 2           # q, k, v read; out written
            ops = {"int8": 2 * B * N * N * C, "bf16": 2 * B * N * N * C}
            tag = f"K10 B={B}, N={N}, {H} heads of {C // H}"
        else:
            M, C, F = shape
            xm, ad, sel = adapter_inputs(M, C, F)
            adapt = torch.empty((1, M, C), dtype=torch.bfloat16,
                                device="cuda")
            lw = torch.empty((1, M, 1), device="cuda")
            args = lambda: (p(xm), M, C, *(p(t) for t in ad), p(sel[0]),
                            p(sel[1]), p(adapt), 0, p(lw), F, stream)
            mine = lambda: lib.dyt_adapter_router(*args())
            theirs = lambda: other.dyt_adapter_router(*args())
            moved = M * C * 4 + M * C * 2 + M * 4   # x_mid, adapt, logits
            ops = {"bf16": 4 * M * C * F, "fp32": 2 * M * C}
            tag = f"adapter/router M={M}, C={C}, F={F}"
        t = [time_ms(f) for f in (theirs, mine, mine, theirs)]
        b, by = bound_ms(moved, ops)
        print(f"{tag}: other tree {t[0]:.4f} / {t[3]:.4f} ms, this tree "
              f"{t[1]:.4f} / {t[2]:.4f} ms; bound {b:.4f} ms ({by})",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
