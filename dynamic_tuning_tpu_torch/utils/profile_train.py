"""Where a train step's time goes (the bench's train family).

    python -m dynamic_tuning_tpu_torch.utils.profile_train --warmup 3 --iters 5

Builds the train family's model and step (``bench.build_train``: ViT-B/16,
batch 64, bf16 compute on fp32 master parameters, AdamW) and, after
``--warmup`` steps:

* times ``--iters`` steps with a CUDA event after each of the step's
  phases (``train.engine.PHASES``: the student forward, the teacher
  forward, the backward, the optimizer) and prints each phase's mean ms;
  the events make the host wait for none of them;
* traces ``--iters`` steps with ``torch.profiler`` and prints the kernels by
  device time per step, the device window, the kernel-busy time, the idle
  share of the traced window (the profiler slows the host, so this share
  is an upper bound) and the idle share of the event-timed step (one less
  kernel-busy over the step's time without the profiler);
* prints the peak memory of one step and the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dynamic_tuning_tpu_torch import bench
from dynamic_tuning_tpu_torch.train.engine import PHASES
from dynamic_tuning_tpu_torch.utils.profile_forward import _busy_us
from dynamic_tuning_tpu_torch.utils.profiling import card_line


def main(args) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train traces the GPU and found no CUDA "
                           "device")
    _, state, step, x, y = bench.build_train("cuda", seed=args.seed)
    for _ in range(args.warmup):
        step(state, x, y)
    torch.cuda.synchronize()

    # phases: an event at the start of each step and after each phase
    marks = []

    def timer(phase):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[-1].append(ev)

    torch.cuda.reset_peak_memory_stats()
    for _ in range(args.iters):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        marks.append([start])
        step(state, x, y, timer=timer)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    phase_ms = {p: sum(m[i].elapsed_time(m[i + 1]) for m in marks)
                / args.iters for i, p in enumerate(PHASES)}
    step_ms = sum(m[0].elapsed_time(m[-1]) for m in marks) / args.iters

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.iters):
            step(state, x, y)
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
    print(f"train step, batch {bench.TRAIN_BATCH}: {step_ms:.3f} ms "
          "(CUDA events); " + ", ".join(f"{p} {ms:.3f} ms"
                                        for p, ms in phase_ms.items()))
    print(f"{'us/step':>12} {'calls/step':>10}  kernel")
    for name, (us, calls) in sorted(per_name.items(),
                                    key=lambda kv: -kv[1][0])[:args.top]:
        print(f"{us / n:12.1f} {calls / n:10.1f}  {name[:100]}")
    idle = 1.0 - busy / window
    idle_step = 1.0 - busy / n / 1e3 / step_ms
    print(f"device window {window / n / 1e3:.3f} ms/step, kernel-busy "
          f"{busy / n / 1e3:.3f} ms/step, idle share {idle:.4f} of the "
          f"traced window, {idle_step:.4f} of the event-timed step, "
          f"{len(kernels) / n:.0f} kernels a step; peak memory "
          f"{peak / 2**30:.2f} GiB")
    print(card_line())
    return {"step_ms": step_ms, "phase_ms": phase_ms, "idle_share": idle,
            "idle_share_step": idle_step, "window_us": window / n,
            "busy_us": busy / n, "peak_bytes": peak}


def get_args_parser():
    p = argparse.ArgumentParser("profile the train step", add_help=True)
    p.add_argument("--warmup", default=3, type=int)
    p.add_argument("--iters", default=5, type=int)
    p.add_argument("--top", default=25, type=int,
                   help="kernels listed, by device time")
    p.add_argument("--seed", default=0, type=int)
    return p


if __name__ == "__main__":
    main(get_args_parser().parse_args())
