"""Where a serving forward's device time goes, by kernel (torch.profiler).

    python -m dynamic_tuning_tpu_torch.utils.profile_forward --quant int8 \
        --mode dispatch --warmup 5 --iters 3
    python -m dynamic_tuning_tpu_torch.utils.profile_forward --task seg \
        --mode dispatch --warmup 5 --iters 3
    python -m dynamic_tuning_tpu_torch.utils.profile_forward --task fast \
        --mode dispatch [--use_kernel] --warmup 5 --iters 3

Takes ``speed.py``'s flags and model (``--compute_dtype float32
--residual_dtype float32``: the fp32 forward, TF32 off); ``--task seg``
takes the seg bench's
segmentor instead (``bench.build_segmentor``: one 512^2 crop, ``--mode
dispatch``, ``mask`` or ``dense``, with ``--quant int8`` the int8 model in
dispatch, the auxiliary head left out); ``--task
fast`` serves ``speed.py``'s model through the speed-test forward
(``models/fast_inference.fast_vit_forward``, K11 with ``--use_kernel``,
else the cuBLAS MLP chain; ``--mode dispatch``, ``mask`` or ``dense``).
After ``--warmup`` forwards it traces ``--iters`` forwards on the card and
prints, per kernel name, the device
time per forward and the calls per forward, then the device window, the
kernel-busy time and the idle share of the window, and the host's time to
enqueue one forward (timed apart from an idle card, without the profiler).
Needs a CUDA device.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dynamic_tuning_tpu_torch import bench, speed
from dynamic_tuning_tpu_torch.cli import fp32_on_card
from dynamic_tuning_tpu_torch.models import fast_inference as fast


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def main(args) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_forward traces the GPU and found no "
                           "CUDA device")
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(args.seed)
    task = getattr(args, "task", "image")
    if task == "seg":
        mode = "dense" if args.mode == "plain" else args.mode
        if args.quant != "none":
            if mode != "dispatch":
                raise ValueError("--task seg --quant int8 profiles the "
                                 "bench's int8 model, in dispatch")
            mode = "q8"
        model = bench.build_segmentor(mode, device, seed=args.seed)
        batch, img = 1, bench.SEG_CROP
        kwargs = bench.seg_kwargs(mode)
    elif task == "fast":
        vit = speed.build_model(args, device)
        params = fast.serving_params(vit)
        batch, img, kwargs = args.batch_size, 224, {}

        def model(x):
            return fast.fast_vit_forward(
                params, x, cfg=vit.cfg, tuning=vit.tuning,
                select=vit.select_cfg, mode=args.mode,
                use_kernel=args.use_kernel)
    else:
        model = speed.build_model(args, device)
        batch, img = args.batch_size, 224
        kwargs = dict(complete_model=args.mode == "dense",
                      dispatch=args.mode == "dispatch")
    x = torch.randn((batch, img, img, 3), generator=g, device=device)
    # --compute_dtype float32 runs with TF32 off, as speed.main does
    with fp32_on_card(args.compute_dtype, device), torch.inference_mode():
        for _ in range(args.warmup):
            model(x, **kwargs)
        torch.cuda.synchronize()
        # host time to enqueue one forward, from an idle card (so a full
        # launch queue cannot stall the host)
        host_s = 0.0
        for _ in range(args.iters):
            t0 = time.perf_counter()
            model(x, **kwargs)
            host_s += time.perf_counter() - t0
            torch.cuda.synchronize()
        host_ms = host_s * 1e3 / args.iters
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                model(x, **kwargs)
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the trace holds no device activity")
    per_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        per_name[e.name][0] += e.time_range.elapsed_us()
        per_name[e.name][1] += 1
    window = (max(e.time_range.end for e in kernels)
              - min(e.time_range.start for e in kernels))
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    n = args.iters
    print(f"task={task} quant={args.quant} mode={args.mode} "
          f"batch={batch}: {n} forwards traced on "
          f"{torch.cuda.get_device_name(0)}")
    print(f"{'us/forward':>12} {'calls/fwd':>9}  kernel")
    for name, (us, calls) in sorted(per_name.items(),
                                    key=lambda kv: -kv[1][0]):
        print(f"{us / n:12.1f} {calls / n:9.1f}  {name[:110]}")
    idle = 1.0 - busy / window
    print(f"device window {window / n / 1e3:.3f} ms/forward, kernel-busy "
          f"{busy / n / 1e3:.3f} ms/forward, idle share {idle:.4f}; host "
          f"enqueue {host_ms:.3f} ms/forward")
    return {"window_us": window, "busy_us": busy, "idle_share": idle,
            "host_ms": host_ms,
            "per_kernel_us": {k: v[0] / n for k, v in per_name.items()}}


def get_args_parser():
    p = speed.get_args_parser()
    p.add_argument("--task", default="image",
                   choices=["image", "seg", "fast"])
    p.add_argument("--use_kernel", action="store_true",
                   help="--task fast: the MLP as K11")
    return p


if __name__ == "__main__":
    main(get_args_parser().parse_args())
