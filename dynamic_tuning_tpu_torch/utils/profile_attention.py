"""Serving attention on the card: K1 against the plain path it replaces and
SDPA (counterpart of scripts/profile_attention.py).

    python -m dynamic_tuning_tpu_torch.utils.profile_attention

At ViT-B/16 serving shape (B=128, N=197, 12 heads of 64, bf16 raw qkv
``[B, N, 3C]`` from a seed) it times, with CUDA events over 20 calls after
3 warm-up ones:

* K1, ``ops/mha_serving.mha_serving_fused`` (one kernel whatever the
  group: the TPU script's loop over ``group`` has no Hopper counterpart);
* ``mha_fused_reference``, the plain path K1 replaces: q, k, v transposed
  out of the buffer, the plain core (float64 sums), transposed back;
* ``F.scaled_dot_product_attention`` on the transposed q, k, v (a
  library's time for the max-subtracted softmax: a yardstick, never
  called by the port);
* a 4096^3 bf16 matmul, the calibration anchor of the TPU script.

Prints the card's name and power limit first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from dynamic_tuning_tpu_torch.ops import mha_serving as ms
from dynamic_tuning_tpu_torch.utils.profiling import card_line, time_ms

B, N, H, HD = 128, 197, 12, 64
C = H * HD


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
    times = {
        "k1": time_ms(lambda: ms.mha_serving_fused(qkv, heads=H)),
        "plain": time_ms(lambda: ms.mha_fused_reference(qkv, heads=H)),
        "sdpa": time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
    }
    print(f"transpose + plain core : {times['plain']:8.4f} ms")
    print(f"K1 mha_serving_fused   : {times['k1']:8.4f} ms (one kernel for "
          "any group)")
    print(f"SDPA (reference only)  : {times['sdpa']:8.4f} ms")
    a = torch.randn((4096, 4096), generator=g, device="cuda").to(
        torch.bfloat16)
    b = torch.randn((4096, 4096), generator=g, device="cuda").to(
        torch.bfloat16)
    t = time_ms(lambda: torch.matmul(a, b))
    print(f"matmul 4096^3          : {t:8.4f} ms "
          f"{2 * 4096 ** 3 / t / 1e9:6.1f} TFLOP/s")
    return times


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    return p


if __name__ == "__main__":
    main(get_args_parser().parse_args())
