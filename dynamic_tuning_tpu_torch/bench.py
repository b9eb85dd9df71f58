"""Benchmark families of the port on the card (counterpart of the
repository's bench.py; so far its seg family).

    python -m dynamic_tuning_tpu_torch.bench

Seg family (bench.py:379-441): the full ``DyTSegmentor`` (ViT-B/16 at 512^2
crops, UPerHead of 768 channels, 150 classes, bf16 compute and residual
stream, tanh GELU, keep ratio 0.5), batch-1 crops -- the shipping slide
cadence (tile_batch 1).  ``dispatch`` is the DyT model with capacity
dispatch; ``dense`` the comparator without adapter or router
(``TuningConfig(ffn_adapt=False)``, ``SelectConfig(open=False)``), which
still runs K9 in every block.  Each is timed as the best of 3 runs of 12
forwards between CUDA events, after 2 untimed forwards; the auxiliary head,
whose output the timed forward does not use,
is left out as the JAX bench's compiled program leaves it out.  Weights are
seeded synthetic (``checkpoint.make_seg_state_dict``).  int8 segmentation is
not ported: its fields are null.  Prints one JSON line.  Needs a CUDA
device.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from dynamic_tuning_tpu_torch.checkpoint import make_seg_state_dict
from dynamic_tuning_tpu_torch.config import (ModelConfig, SelectConfig,
                                             TuningConfig)
from dynamic_tuning_tpu_torch.models.upernet import DyTSegmentor
from dynamic_tuning_tpu_torch.utils.profiling import (forwards_run,
                                                      scan_throughput)

SEG_CROP, SEG_CLASSES = 512, 150
SEG_MODES = ("dispatch", "dense")
SEG_ITERS, SEG_REPEATS, SEG_WARMUP = 12, 3, 2


def seg_state_dict(seed: int = 0):
    """The seg family's synthetic ViT-B/16 segmentor weights."""
    return make_seg_state_dict(np.random.RandomState(seed), depth=12,
                               dim=768, ffn=64, img=SEG_CROP, patch=16,
                               num_classes=SEG_CLASSES)


def build_segmentor(mode: str, device, *, state_dict=None,
                    seed: int = 0) -> DyTSegmentor:
    """The seg family's model for ``mode`` (``dispatch``/``mask``: DyT;
    ``dense``: no adapter, no router) on ``device`` with the synthetic
    weights of ``seed`` (or ``state_dict``; keys the model lacks are
    skipped)."""
    if mode == "dense":
        tuning, select = TuningConfig(ffn_adapt=False), SelectConfig(open=False)
    else:
        tuning, select = TuningConfig(), SelectConfig(token_target_ratio=0.5)
    cfg = ModelConfig(img_size=SEG_CROP, gelu_approx=True,
                      residual_dtype="bfloat16")
    model = DyTSegmentor(cfg, num_classes=SEG_CLASSES, tuning=tuning,
                         select=select, dtype=torch.bfloat16)
    if state_dict is None:
        state_dict = seg_state_dict(seed)
    own = model.state_dict()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict.items() if k in own}, strict=True)
    return model.to(device)


def seg_kwargs(mode: str) -> dict:
    return dict(dispatch=mode == "dispatch", aux_logits=False)


def seg_family(device="cuda", *, seed: int = 0, state_dict=None):
    """(fields, runs): the bench's seg fields, and per mode the model, its
    input, the outputs of its first forward and the number of forwards
    run."""
    if not torch.cuda.is_available():
        raise RuntimeError("the seg bench times the GPU and found no CUDA "
                           "device")
    if state_dict is None:
        state_dict = seg_state_dict(seed)
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((1, SEG_CROP, SEG_CROP, 3), generator=g, device=device)
    runs, crops_s = {}, {}
    for mode in SEG_MODES:
        # built outside inference mode: its parameters stay normal tensors
        model = build_segmentor(mode, device, state_dict=state_dict)
        kw = seg_kwargs(mode)
        with torch.inference_mode():
            logits, _, aux = model(x, **kw)
            # scan_throughput's timing with a batch of one crop
            crops_s[mode] = scan_throughput(
                lambda: model(x, **kw), batch=1, iters=SEG_ITERS,
                repeats=SEG_REPEATS, warmup_iters=SEG_WARMUP)
            runs[mode] = dict(model=model, x=x, logits=logits, aux=aux,
                              forwards=1 + forwards_run(
                                  SEG_ITERS, SEG_REPEATS, SEG_WARMUP))
    fields = {
        "seg_crops_s": round(crops_s["dispatch"], 2),
        "seg_dense_crops_s": round(crops_s["dense"], 2),
        "seg_vs_dense": round(crops_s["dispatch"] / crops_s["dense"], 4),
        "seg_int8_crops_s": None,
        "seg_int8_vs_dense": None,
        "seg_protocol": "shipping default: dispatch, head 768, bf16, "
                        "batch-1 tiles == slide tile_batch=1",
    }
    return fields, runs


def main() -> dict:
    fields, _ = seg_family()
    print(json.dumps(fields))
    print(f"device: {torch.cuda.get_device_name(0)}", file=sys.stderr)
    return fields


if __name__ == "__main__":
    main()
