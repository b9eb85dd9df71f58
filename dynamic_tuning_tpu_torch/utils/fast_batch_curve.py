"""img/s of the speed-test forward per batch size, dispatch against dense, on
the card: where ``--mode auto`` of ``predict.py`` should switch
(``predict.AUTO_DISPATCH_MIN_BATCH``).

    python -m dynamic_tuning_tpu_torch.utils.fast_batch_curve \\
        [--batches 1 8 32 64 128] [--use_kernel]

ViT-B/16 at 224^2 with seeded synthetic weights (router head x25), bf16
residual stream, tanh GELU, keep ratio 0.5: the model ``predict.py`` serves.
``fast_vit_forward`` with ``use_kernel=False`` (what ``predict.py`` runs)
unless ``--use_kernel``.  Per batch the modes run in turns (dense,
dispatch, dispatch, dense), each best of 3 runs after warm-up; prints one
JSON line per batch with both readings of each mode and the ratio of their
means.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from dynamic_tuning_tpu_torch import predict
from dynamic_tuning_tpu_torch.checkpoint import make_vit_state_dict
from dynamic_tuning_tpu_torch.models.fast_inference import fast_vit_forward
from dynamic_tuning_tpu_torch.utils.profiling import scan_throughput


def main(argv=None) -> list:
    p = argparse.ArgumentParser("fast_vit_forward batch curve")
    p.add_argument("--batches", type=int, nargs="+",
                   default=[1, 8, 32, 64, 128])
    p.add_argument("--use_kernel", action="store_true")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the batch curve times the GPU and found no CUDA "
                           "device")
    args = predict.get_args_parser().parse_args(
        ["--ckpt", "synthetic.pth", "--images", "-"])
    cfg, tuning, sel = predict.configs(args)
    sd = make_vit_state_dict(np.random.RandomState(a.seed), depth=cfg.depth,
                             dim=cfg.embed_dim, ffn=tuning.ffn_num,
                             classes=cfg.num_classes, img=cfg.img_size,
                             patch=cfg.patch_size, router_scale=25.0)
    params = predict.load_params(args, torch.device("cuda"), state_dict=sd)
    g = torch.Generator(device="cuda").manual_seed(a.seed)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    rows = []
    for batch in a.batches:
        x = torch.randn((batch, cfg.img_size, cfg.img_size, 3), generator=g,
                        device="cuda")
        ips = {"dense": [], "dispatch": []}
        for mode in ("dense", "dispatch", "dispatch", "dense"):
            def fwd(mode=mode):
                return fast_vit_forward(params, x, cfg=cfg, tuning=tuning,
                                        select=sel, mode=mode,
                                        use_kernel=a.use_kernel)
            with torch.inference_mode():
                ips[mode].append(scan_throughput(fwd, batch=batch,
                                                 iters=a.iters,
                                                 warmup_iters=3))
        row = {"batch": batch, "use_kernel": a.use_kernel,
               "dense_img_s": ips["dense"], "dispatch_img_s": ips["dispatch"],
               "dispatch_vs_dense": float(np.mean(ips["dispatch"])
                                          / np.mean(ips["dense"])),
               "card": card}
        print(json.dumps(row))
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
