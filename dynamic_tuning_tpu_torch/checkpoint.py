"""Weight bridge (counterpart of the .pth parts of
dynamic_tuning_tpu/train/checkpoint.py).

* ``from_flax_params``: a JAX-package param tree (nested dicts of arrays) ->
  a timm-named state dict of numpy arrays, with the conversions of
  ``export_torch_state_dict``: Dense kernels ``[in, out]`` -> Linear
  ``[out, in]``, conv kernels HWIO -> OIHW.  Numpy only.
* ``load_timm_state_dict``: a timm/DyT state dict into a port model with
  the rules of ``import_pretrained``: ``pre_logits.*`` dropped, a head of
  another width dropped (head surgery), unknown keys reported and ignored,
  keys the checkpoint lacks (adapters and routers of an IN21K backbone)
  left at their init and returned as missing;
* ``make_vit_state_dict``: a seeded synthetic timm+DyT state dict, for runs
  on random weights (``chip_smoke.py``) and the tests.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

# flax path (inside a block, or at the top) -> timm key
_FLAX_TO_TIMM = {
    ("cls_token",): "cls_token",
    ("pos_embed",): "pos_embed",
    ("patch_embed", "proj", "kernel"): "patch_embed.proj.weight",
    ("patch_embed", "proj", "bias"): "patch_embed.proj.bias",
    ("norm", "scale"): "norm.weight",
    ("norm", "bias"): "norm.bias",
    ("head", "kernel"): "head.weight",
    ("head", "bias"): "head.bias",
    ("norm1", "scale"): "norm1.weight",
    ("norm1", "bias"): "norm1.bias",
    ("norm2", "scale"): "norm2.weight",
    ("norm2", "bias"): "norm2.bias",
    ("attn", "qkv", "kernel"): "attn.qkv.weight",
    ("attn", "qkv", "bias"): "attn.qkv.bias",
    ("attn", "proj", "kernel"): "attn.proj.weight",
    ("attn", "proj", "bias"): "attn.proj.bias",
    ("mlp", "fc1", "kernel"): "mlp.fc1.weight",
    ("mlp", "fc1", "bias"): "mlp.fc1.bias",
    ("mlp", "fc2", "kernel"): "mlp.fc2.weight",
    ("mlp", "fc2", "bias"): "mlp.fc2.bias",
    ("adaptmlp", "down_proj", "kernel"): "adaptmlp.down_proj.weight",
    ("adaptmlp", "down_proj", "bias"): "adaptmlp.down_proj.bias",
    ("adaptmlp", "up_proj", "kernel"): "adaptmlp.up_proj.weight",
    ("adaptmlp", "up_proj", "bias"): "adaptmlp.up_proj.bias",
    ("adaptmlp", "scale"): "adaptmlp.scale",
    ("mlp_token_select", "mlp_head", "kernel"):
        "mlp_token_select.mlp_head.weight",
    ("mlp_token_select", "mlp_head", "bias"):
        "mlp_token_select.mlp_head.bias",
}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_path_to_timm(path: Tuple[str, ...]) -> str:
    """``("blocks_3", "attn", "qkv", "kernel")`` ->
    ``blocks.3.attn.qkv.weight``."""
    m = re.fullmatch(r"blocks_(\d+)", path[0])
    prefix, rest = (f"blocks.{m.group(1)}.", path[1:]) if m else ("", path)
    key = _FLAX_TO_TIMM.get(tuple(rest))
    if key is None:
        raise ValueError(f"no timm name for flax param {'/'.join(path)} "
                         "(not part of the ported image model)")
    return prefix + key


def _to_torch_layout(path: Tuple[str, ...], w: np.ndarray) -> np.ndarray:
    if path[-1] == "kernel":
        if w.ndim == 2:
            return np.ascontiguousarray(w.T)             # [in,out] -> [out,in]
        if w.ndim == 4:
            return np.ascontiguousarray(w.transpose(3, 2, 0, 1))  # -> OIHW
    return w


def from_flax_params(params: Mapping) -> Dict[str, np.ndarray]:
    """JAX-package param tree -> timm-named numpy state dict."""
    return {flax_path_to_timm(p): _to_torch_layout(p, np.array(w))
            for p, w in _flatten(params)}


def make_vit_state_dict(rs: np.random.RandomState, *, depth: int, dim: int,
                        ffn: int, classes: int, img: int, patch: int,
                        router_scale: float = 25.0,
                        in_chans: int = 3) -> Dict[str, np.ndarray]:
    """Random timm+DyT state dict at IN21K-like weight scales (trunc-normal
    .02-class weights, LN scales near 1, small biases), drawn from ``rs`` in
    a fixed order so one seed always gives the same values.  The router head
    is scaled by ``router_scale`` so hard sigmoid > 0.5 gates have margin
    against float noise."""
    grid = img // patch
    T = grid * grid + 1

    def w(*shape, s=0.03):
        return np.clip(rs.randn(*shape) * s, -2 * s, 2 * s).astype(np.float32)

    sd = {
        "cls_token": w(1, 1, dim, s=0.02),
        "pos_embed": w(1, T, dim, s=0.02),
        "patch_embed.proj.weight": w(dim, in_chans, patch, patch, s=0.06),
        "patch_embed.proj.bias": w(dim, s=0.02),
        "norm.weight": 1.0 + w(dim, s=0.05),
        "norm.bias": w(dim, s=0.02),
        "head.weight": w(classes, dim, s=0.02),
        "head.bias": w(classes, s=0.01),
    }
    for i in range(depth):
        p = f"blocks.{i}."
        sd.update({
            p + "norm1.weight": 1.0 + w(dim, s=0.05),
            p + "norm1.bias": w(dim, s=0.02),
            p + "attn.qkv.weight": w(3 * dim, dim),
            p + "attn.qkv.bias": w(3 * dim, s=0.02),
            p + "attn.proj.weight": w(dim, dim),
            p + "attn.proj.bias": w(dim, s=0.02),
            p + "norm2.weight": 1.0 + w(dim, s=0.05),
            p + "norm2.bias": w(dim, s=0.02),
            p + "mlp.fc1.weight": w(4 * dim, dim),
            p + "mlp.fc1.bias": w(4 * dim, s=0.02),
            p + "mlp.fc2.weight": w(dim, 4 * dim),
            p + "mlp.fc2.bias": w(dim, s=0.02),
            p + "adaptmlp.down_proj.weight": w(ffn, dim),
            p + "adaptmlp.down_proj.bias": w(ffn, s=0.02),
            p + "adaptmlp.up_proj.weight": w(dim, ffn, s=0.02),
            p + "adaptmlp.up_proj.bias": w(dim, s=0.01),
            p + "mlp_token_select.mlp_head.weight":
                (rs.randn(1, dim) * router_scale / np.sqrt(dim)
                 ).astype(np.float32),
            p + "mlp_token_select.mlp_head.bias": w(1, s=0.1),
        })
    return sd


def load_timm_state_dict(model: torch.nn.Module, state_dict: Mapping,
                         log=print) -> Tuple[List[str], List[str]]:
    """Load a timm/DyT state dict (numpy arrays or tensors) into ``model``.

    Returns (missing, unexpected) key lists.  Raises on a shape mismatch
    other than the head's; a pos-embed of another grid raises
    NotImplementedError (interpolation comes with a later slice)."""
    own = model.state_dict()
    to_load, unexpected = {}, []
    for key, value in state_dict.items():
        if key.startswith("pre_logits."):
            log(f"Removing key {key} from pretrained checkpoint (pre_logits)")
            continue
        if key not in own:
            unexpected.append(key)
            continue
        t = (value.detach().cpu() if isinstance(value, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(value)))
        want = tuple(own[key].shape)
        if tuple(t.shape) != want:
            if key.startswith("head."):
                log(f"Removing key {key} from pretrained checkpoint "
                    f"(shape {tuple(t.shape)} != {want})")
                continue
            if key == "pos_embed":
                raise NotImplementedError(
                    f"pos_embed {tuple(t.shape)} -> {want} needs grid "
                    "interpolation, which is not ported yet")
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{tuple(t.shape)} vs model {want}")
        to_load[key] = t.to(own[key].dtype)
    model.load_state_dict(to_load, strict=False)
    missing = [k for k in own if k not in to_load]
    if unexpected:
        log(f"unexpected keys (ignored): {unexpected[:8]}"
            + (" ..." if len(unexpected) > 8 else ""))
    log(f"loaded {len(to_load)} tensors; {len(missing)} missing")
    return missing, unexpected
