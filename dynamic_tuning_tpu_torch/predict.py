"""Batch inference entry point of the port (counterpart of the repository's
predict.py): classify images with a DyT checkpoint through the speed-test
forward.

    python -m dynamic_tuning_tpu_torch.predict --ckpt model.pth \\
        --images dir_or_file [--nb_classes 100] [--mode dispatch] \\
        [--batch_size 64] [--quant none|int8|int8_attn] [--device cuda|cpu]

Same flags and output as ``predict.py`` (one JSON line per image:
``{"path", "label", "prob", "keep_ratio"}``), plus ``--device``: the CUDA
device unless ``--device cpu`` is given; without a card it raises.

* ``--quant none`` serves through ``models/fast_inference.fast_vit_forward``
  with ``use_kernel=False`` (the cuBLAS MLP chain), as ``predict.py`` passes
  ``use_pallas=False``; ``--quant int8|int8_attn`` through the port
  ``VisionTransformer``'s forward (the int8 kernels), which reads the int8
  config where the fast forward would not.
* Batches larger than 128 run as chained 128-image chunks
  (``chunked_serving``).
* Checkpoints: a ``.pth``/``.pt`` state dict (timm/DyT names), or the JAX
  package's ``final_checkpoint.msgpack`` (a flax param tree, read by
  ``train/checkpoint.load_params`` through ``from_flax_params``), loads
  through ``load_timm_state_dict`` into the same tensors; what follows the
  load does not know which file it came from.

The work splits into ``load_canvases`` (decode to uint8 canvases on the
host) and ``serve`` (transforms and forwards on the device), so a caller
can serve canvases it made itself.  Decoding takes the port's native
loader (``data/native_loader.decode_resize``) when it builds, as
``predict.py`` takes the repository's, else PIL (imported inside
``load_canvases``), both with the same geometry: short side to the
canvas, bilinear, centre crop.  ``main`` prints which decoder ran on
stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from dynamic_tuning_tpu_torch.checkpoint import load_timm_state_dict
from dynamic_tuning_tpu_torch.cli import resolve_device
from dynamic_tuning_tpu_torch.config import (ModelConfig, SelectConfig,
                                             TuningConfig)
from dynamic_tuning_tpu_torch.data import native_loader
from dynamic_tuning_tpu_torch.data.transforms import augment_batch
from dynamic_tuning_tpu_torch.models.fast_inference import (chunked_serving,
                                                            fast_vit_forward,
                                                            serving_params)
from dynamic_tuning_tpu_torch.models.vit import VisionTransformer
from dynamic_tuning_tpu_torch.train import checkpoint as C

# Carried over from the JAX package (its TPU batch curve put the dispatch
# crossover at ~8): below this batch --mode auto serves dense.  Not yet
# measured on the H100; PERF.md holds this card's batch curve.
AUTO_DISPATCH_MIN_BATCH = 8


def get_args_parser():
    p = argparse.ArgumentParser("DyT inference (PyTorch/CUDA)",
                                add_help=False)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--images", required=True, help="image file or directory")
    p.add_argument("--nb_classes", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--mode", default="dispatch",
                   choices=["dispatch", "mask", "dense", "auto"],
                   help="auto = dense below AUTO_DISPATCH_MIN_BATCH images, "
                        "dispatch at or above it")
    p.add_argument("--ffn_num", type=int, default=64)
    p.add_argument("--token_target_ratio", type=float, default=0.5)
    p.add_argument("--capacity_ratio", type=float, default=None)
    p.add_argument("--inception", action="store_true")
    # architecture overrides (default ViT-B/16 @ 224)
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--embed_dim", type=int, default=768)
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--num_heads", type=int, default=12)
    p.add_argument("--quant", default="none",
                   choices=["none", "int8", "int8_attn"],
                   help="int8 = W8A8 serving matmuls (ops/quant.py)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p


def configs(args):
    """(ModelConfig, TuningConfig, SelectConfig) of ``predict.py``: bf16
    residual stream, tanh GELU."""
    cfg = ModelConfig(num_classes=args.nb_classes, gelu_approx=True,
                      residual_dtype="bfloat16", img_size=args.img_size,
                      patch_size=args.patch_size, embed_dim=args.embed_dim,
                      depth=args.depth, num_heads=args.num_heads,
                      quant=args.quant)
    tuning = TuningConfig(ffn_num=args.ffn_num, d_model=args.embed_dim)
    sel = SelectConfig(token_target_ratio=args.token_target_ratio,
                       capacity_ratio=args.capacity_ratio)
    return cfg, tuning, sel


def load_params(args, device, state_dict=None):
    """What ``serve`` serves: the fast forward's tensors
    (``serving_params``) with ``--quant none``, else the port
    ``VisionTransformer``.  Weights from ``state_dict`` when given, else
    from ``--ckpt``."""
    cfg, tuning, sel = configs(args)
    model = VisionTransformer(cfg, tuning=tuning, select=sel,
                              dtype=torch.bfloat16)
    if state_dict is None:
        state_dict = C.load_params(args.ckpt)
    load_timm_state_dict(model, state_dict, log=lambda m: None)
    model = model.to(device)
    return serving_params(model) if args.quant == "none" else model


def _list_images(path):
    if os.path.isfile(path):
        return [path]
    exts = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
    return [os.path.join(path, f) for f in sorted(os.listdir(path))
            if f.lower().endswith(exts)]


def decoder() -> str:
    """The decoder ``load_canvases`` takes: native or PIL (and why)."""
    if native_loader.available():
        return "native"
    return f"PIL ({native_loader.why_unavailable().splitlines()[0]})"


def load_canvases(paths, canvas: int) -> np.ndarray:
    """Decode ``paths`` to uint8 canvases [n, canvas, canvas, 3]: short side
    resized to ``canvas`` (bilinear), then the centre crop; through the
    native loader when it builds (a file it cannot decode falls to PIL)."""
    out = np.empty((len(paths), canvas, canvas, 3), np.uint8)
    native = native_loader.available()
    for i, path in enumerate(paths):
        img = native_loader.decode_resize(path, canvas) if native else None
        if img is not None:
            out[i] = img
            continue
        from PIL import Image

        with Image.open(path) as im:
            img = im.convert("RGB")
        w, h = img.size
        scale = canvas / min(w, h)
        img = img.resize((max(round(w * scale), canvas),
                          max(round(h * scale), canvas)), Image.BILINEAR)
        w, h = img.size
        left, top = (w - canvas) // 2, (h - canvas) // 2
        out[i] = np.asarray(img.crop((left, top, left + canvas,
                                      top + canvas)), np.uint8)
    return out


def serve(args, canvases, params, paths=None) -> list:
    """Classify uint8 canvases [n, canvas, canvas, 3] (numpy or a tensor)
    in batches of ``--batch_size``; print and return one result per canvas.
    ``params`` is what ``load_params`` returns; ``paths`` name the results
    (default: the canvases' indices)."""
    cfg, tuning, sel = configs(args)
    quant = args.quant != "none"
    device = (next(params.parameters()).device if quant
              else params["pos_embed"].device)
    images = torch.as_tensor(canvases)
    names = paths if paths is not None else [str(i)
                                             for i in range(len(images))]
    results = []
    for i in range(0, len(images), args.batch_size):
        batch = images[i:i + args.batch_size].to(device)
        xb = augment_batch(None, batch, out_size=args.img_size,
                           inception=args.inception, train=False)
        mode = args.mode
        if mode == "auto":
            mode = ("dense" if len(batch) < AUTO_DISPATCH_MIN_BATCH
                    else "dispatch")
        def fwd(c, mode=mode):
            if quant:
                return _model_forward(params, c, mode)
            return fast_vit_forward(params, c, cfg=cfg, tuning=tuning,
                                    select=sel, mode=mode, use_kernel=False)

        with torch.inference_mode():
            logits, sel_out = chunked_serving(fwd)(xb)
        if sel_out is None:
            keep = torch.ones(len(batch))
        else:
            keep = sel_out.float().mean(dim=tuple(range(1, sel_out.dim())))
        logits, keep = logits.float().cpu(), keep.cpu()
        probs = torch.softmax(logits, dim=-1)
        for j in range(len(batch)):
            r = {"path": names[i + j], "label": int(logits[j].argmax()),
                 "prob": round(float(probs[j].max()), 4),
                 "keep_ratio": round(float(keep[j]), 3)}
            results.append(r)
            print(json.dumps(r))
    return results


def _model_forward(model, x, mode):
    """The int8 model's (logits, token_select [B, L, T, 1] or None)."""
    logits, aux = model(x, complete_model=mode == "dense",
                        dispatch=mode == "dispatch")
    return logits, aux["token_select"]


def main(args):
    device = resolve_device(args.device, "predict.py")
    params = load_params(args, device)
    paths = _list_images(args.images)
    canvas = max(int(args.img_size * 256 / 224), args.img_size)
    print(f"decoder: {decoder()}", file=sys.stderr)
    results = []
    for i in range(0, len(paths), args.batch_size):
        chunk = paths[i:i + args.batch_size]
        results += serve(args, load_canvases(chunk, canvas), params, chunk)
    return results


if __name__ == "__main__":
    main(get_args_parser().parse_args())
