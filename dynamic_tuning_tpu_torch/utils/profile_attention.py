"""Serving attention on the card: K1 against the plain path it replaces,
K13 and K14, each beside SDPA (counterpart of
scripts/profile_attention.py).

    python -m dynamic_tuning_tpu_torch.utils.profile_attention

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

K9 touches only the C entry and wrapper that every tree of the port has,
so this script can time an older tree's K9 (``PYTHONPATH=<tree> python
<this file>``).  Prints the card's name and power limit first.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

from dynamic_tuning_tpu_torch.ops import _build
from dynamic_tuning_tpu_torch.ops import flash_attention as fa
from dynamic_tuning_tpu_torch.ops import mha_serving as ms
from dynamic_tuning_tpu_torch.ops import packed_attention as pa
from dynamic_tuning_tpu_torch.utils.profiling import card_line, time_ms

B, N, H, HD = 128, 197, 12, 64
C = H * HD
SEG_N = 1025


def main(args) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_attention times the GPU and found no "
                           "CUDA device")
    print(f"card: {card_line()}")
    g = torch.Generator(device="cuda").manual_seed(args.seed)
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


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    return p


if __name__ == "__main__":
    main(get_args_parser().parse_args())
