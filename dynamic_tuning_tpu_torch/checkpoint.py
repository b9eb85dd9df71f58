"""Weight bridge (counterpart of the .pth parts of
dynamic_tuning_tpu/train/checkpoint.py).

* ``from_flax_params``: a JAX-package param tree (nested dicts of arrays) ->
  a timm-named state dict of numpy arrays, with the conversions of
  ``export_torch_state_dict``: Dense kernels ``[in, out]`` -> Linear
  ``[out, in]``, conv kernels HWIO -> OIHW.  Numpy only.  The MoE adapter
  (a paper feature with no reference ``.pth`` names, whose params the JAX
  package's ``export_torch_state_dict`` leaves out) gets the port's own
  names, mirroring the flax tree: ``adaptmlp.router.weight`` [E, C] (the
  router Dense kernel, transposed), ``adaptmlp.down_kernel`` [E, C, b],
  ``adaptmlp.down_bias`` [E, b], ``adaptmlp.up_kernel`` [E, b, C] and
  ``adaptmlp.up_bias`` [E, C] (the stacks in the flax layout).  A
  ``DyTSegmentor`` tree (``backbone/...``, ``decode_head/...``,
  ``auxiliary_head/...``) maps to the port segmentor's names: the backbone
  as the image model under ``backbone.`` plus
  ``attn.relative_position_bias_table`` (unchanged), BEiT's
  ``attn/q_bias``, ``attn/v_bias``, ``ls1_gamma`` and ``ls2_gamma``
  (``attn.q_bias``, ``attn.v_bias``, ``gamma_1``, ``gamma_2``, the
  reference BEiT backbone's names) and the FPN transposed
  convs, whose flax kernels [kh, kw, in, out] are flipped in both spatial
  axes and laid out [in, out, kh, kw] (flax's ConvTranspose does not flip
  its kernel, torch's does); the heads mirror the flax tree (``kernel`` ->
  ``weight``, GroupNorm/BatchNorm ``scale`` -> ``weight``, batch_stats
  ``mean``/``var`` -> ``running_mean``/``running_var``).
* ``load_timm_state_dict``: a timm/DyT state dict into a port model with
  the rules of ``import_pretrained``: ``pre_logits.*`` dropped, a head of
  another width dropped (head surgery), a pos-embed of another patch grid
  interpolated bicubically, unknown keys reported and ignored, keys the
  checkpoint lacks (adapters and routers of an IN21K backbone) left at
  their init and returned as missing;
* ``make_vit_state_dict`` / ``make_seg_state_dict``: seeded synthetic
  state dicts of the image model and of the segmentor, for runs on random
  weights (``chip_smoke.py``, the bench) and the tests.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from dynamic_tuning_tpu_torch.utils.pos_embed import interpolate_pos_embed

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
    ("attn", "relative_position_bias_table"):
        "attn.relative_position_bias_table",
    # BEiT: q/v-only attention biases and LayerScale, under the reference
    # BEiT backbone's names
    ("attn", "q_bias"): "attn.q_bias",
    ("attn", "v_bias"): "attn.v_bias",
    ("ls1_gamma",): "gamma_1",
    ("ls2_gamma",): "gamma_2",
    ("mlp", "fc1", "kernel"): "mlp.fc1.weight",
    ("mlp", "fc1", "bias"): "mlp.fc1.bias",
    ("mlp", "fc2", "kernel"): "mlp.fc2.weight",
    ("mlp", "fc2", "bias"): "mlp.fc2.bias",
    ("adaptmlp", "down_proj", "kernel"): "adaptmlp.down_proj.weight",
    ("adaptmlp", "down_proj", "bias"): "adaptmlp.down_proj.bias",
    ("adaptmlp", "up_proj", "kernel"): "adaptmlp.up_proj.weight",
    ("adaptmlp", "up_proj", "bias"): "adaptmlp.up_proj.bias",
    ("adaptmlp", "scale"): "adaptmlp.scale",
    # the adapter's in/out LayerNorm (the reference adapter's name)
    ("adaptmlp", "ln", "scale"): "adaptmlp.adapter_layer_norm_before.weight",
    ("adaptmlp", "ln", "bias"): "adaptmlp.adapter_layer_norm_before.bias",
    # the MoE adapter: the port's own names, mirroring the flax tree
    ("adaptmlp", "router", "kernel"): "adaptmlp.router.weight",
    ("adaptmlp", "down_kernel"): "adaptmlp.down_kernel",
    ("adaptmlp", "down_bias"): "adaptmlp.down_bias",
    ("adaptmlp", "up_kernel"): "adaptmlp.up_kernel",
    ("adaptmlp", "up_bias"): "adaptmlp.up_bias",
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


_SEG_TOPS = ("backbone", "decode_head", "auxiliary_head")
_HEAD_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
              "mean": "running_mean", "var": "running_var"}


def _is_deconv(path: Tuple[str, ...]) -> bool:
    return len(path) >= 2 and re.fullmatch(r"fpn\d_deconv\d?", path[-2]) is not None


def flax_path_to_port(path: Tuple[str, ...]) -> str:
    """A flax param path -> the port's state-dict key: timm names for the
    image model (``flax_path_to_timm``), the segmentor's names for a
    ``DyTSegmentor`` tree."""
    if path[0] not in _SEG_TOPS:
        return flax_path_to_timm(path)
    top, rest = path[0], path[1:]
    if top == "backbone" and not _is_deconv(path):
        return "backbone." + flax_path_to_timm(rest)
    if rest[-1] not in _HEAD_LEAF:
        raise ValueError(f"no port name for flax param {'/'.join(path)}")
    return ".".join((top,) + rest[:-1] + (_HEAD_LEAF[rest[-1]],))


def _to_torch_layout(path: Tuple[str, ...], w: np.ndarray) -> np.ndarray:
    if path[-1] == "kernel":
        if w.ndim == 2:
            return np.ascontiguousarray(w.T)             # [in,out] -> [out,in]
        if w.ndim == 4 and _is_deconv(path):
            # flip, then [kh, kw, in, out] -> [in, out, kh, kw]
            return np.ascontiguousarray(w[::-1, ::-1].transpose(2, 3, 0, 1))
        if w.ndim == 4:
            return np.ascontiguousarray(w.transpose(3, 2, 0, 1))  # -> OIHW
    return w


def from_flax_params(params: Mapping, batch_stats: Mapping | None = None
                     ) -> Dict[str, np.ndarray]:
    """JAX-package param tree (and, for a BatchNorm segmentor, its
    ``batch_stats`` tree) -> the port's numpy state dict."""
    trees = [params] + ([batch_stats] if batch_stats else [])
    return {flax_path_to_port(p): _to_torch_layout(p, np.array(w))
            for tree in trees for p, w in _flatten(tree)}


def make_vit_state_dict(rs: np.random.RandomState, *, depth: int, dim: int,
                        ffn: int, classes: int, img: int, patch: int,
                        router_scale: float = 25.0, in_chans: int = 3,
                        moe_experts: int = 0) -> Dict[str, np.ndarray]:
    """Random timm+DyT state dict at IN21K-like weight scales (trunc-normal
    .02-class weights, LN scales near 1, small biases), drawn from ``rs`` in
    a fixed order so one seed always gives the same values.  The router head
    is scaled by ``router_scale`` so hard sigmoid > 0.5 gates have margin
    against float noise.

    With ``moe_experts`` E > 1 the adapters are MoE adapters of E experts of
    width ``ffn``, drawn after every other tensor (so the rest is the same
    as without): expert router and up kernels nonzero, so the gates differ
    per token and the mixture is not zero."""
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
    if moe_experts > 1:
        E = moe_experts
        for i in range(depth):
            p = f"blocks.{i}.adaptmlp."
            for name in ("down_proj.weight", "down_proj.bias",
                         "up_proj.weight", "up_proj.bias"):
                del sd[p + name]
            sd.update({
                # router logits of a few units: gates far from uniform
                p + "router.weight": w(E, dim, s=2.0 / np.sqrt(dim)),
                p + "down_kernel": w(E, dim, ffn),
                p + "down_bias": w(E, ffn, s=0.02),
                p + "up_kernel": w(E, ffn, dim, s=0.02),
                p + "up_bias": w(E, dim, s=0.01),
            })
    return sd


def make_seg_state_dict(rs: np.random.RandomState, *, depth: int, dim: int,
                        ffn: int, img: int, patch: int, num_classes: int,
                        head_channels: int | None = None, norm: str = "gn",
                        use_rel_pos_bias: bool = True,
                        use_abs_pos_embed: bool = True,
                        init_values: float | None = None,
                        qv_bias_only: bool = False
                        ) -> Dict[str, np.ndarray]:
    """Random state dict of the port's ``DyTSegmentor`` (ViT backbone of
    heads of 64 with windowed attention over an ``img`` / ``patch`` grid,
    simpleFPN, UPerHead of ``head_channels`` (default ``dim``), FCN of
    256), drawn from ``rs`` in a fixed order.  The backbone is
    ``make_vit_state_dict``'s (router head scaled x25) under ``backbone.``;
    the relative-position tables are nonzero (~1, the size of the scores)
    so the bias matters; conv kernels have variance 1/fan_in, norm scales
    near 1.  With ``norm="bn"`` the heads carry running statistics instead
    of GroupNorm affines.

    The backbone knobs of ``SegVisionTransformer`` shape the backbone's
    entries: no tables without ``use_rel_pos_bias``, no ``pos_embed``
    without ``use_abs_pos_embed``; with ``qv_bias_only`` the qkv bias
    gives way to ``attn.q_bias`` and ``attn.v_bias`` (~0.3, a few tenths
    of q and v), and ``init_values`` adds ``gamma_1`` and ``gamma_2``
    near it, all drawn after everything else."""
    def w(*shape, s=0.03):
        return np.clip(rs.randn(*shape) * s, -2 * s, 2 * s).astype(np.float32)

    vit = make_vit_state_dict(rs, depth=depth, dim=dim, ffn=ffn, classes=1,
                              img=img, patch=patch)
    sd = {"backbone." + k: v for k, v in vit.items()
          if not k.startswith(("norm.", "head."))}
    grid = img // patch
    table = (2 * grid - 1) ** 2 + 3
    heads = dim // 64
    for i in range(depth):
        sd[f"backbone.blocks.{i}.attn.relative_position_bias_table"] = w(
            table, heads, s=1.0)
    for name in ("fpn1_deconv1", "fpn1_deconv2", "fpn2_deconv"):
        sd[f"backbone.{name}.weight"] = w(dim, dim, 2, 2, s=0.03)
        sd[f"backbone.{name}.bias"] = w(dim, s=0.02)

    def conv_module(prefix, cin, cout, k):
        sd[prefix + ".conv.weight"] = w(cout, cin, k, k,
                                        s=(cin * k * k) ** -0.5)
        if norm == "bn":
            sd[prefix + ".bn.weight"] = 1.0 + w(cout, s=0.05)
            sd[prefix + ".bn.bias"] = w(cout, s=0.02)
            sd[prefix + ".bn.running_mean"] = w(cout, s=0.1)
            sd[prefix + ".bn.running_var"] = 1.0 + np.abs(w(cout, s=0.2))
        else:
            sd[prefix + ".gn.weight"] = 1.0 + w(cout, s=0.05)
            sd[prefix + ".gn.bias"] = w(cout, s=0.02)

    ch = head_channels or dim
    for i in range(4):
        conv_module(f"decode_head.psp.pool_{i}", dim, ch, 1)
    conv_module("decode_head.psp.bottleneck", dim + 4 * ch, ch, 3)
    for i in range(3):
        conv_module(f"decode_head.lateral_{i}", dim, ch, 1)
    for i in range(3):
        conv_module(f"decode_head.fpn_{i}", ch, ch, 3)
    conv_module("decode_head.fpn_bottleneck", 4 * ch, ch, 3)
    sd["decode_head.conv_seg.weight"] = w(num_classes, ch, 1, 1,
                                          s=ch ** -0.5)
    sd["decode_head.conv_seg.bias"] = w(num_classes, s=0.02)
    conv_module("auxiliary_head.conv0", dim, 256, 3)
    sd["auxiliary_head.conv_seg.weight"] = w(num_classes, 256, 1, 1,
                                             s=256 ** -0.5)
    sd["auxiliary_head.conv_seg.bias"] = w(num_classes, s=0.02)
    for i in range(depth):
        p = f"backbone.blocks.{i}."
        if not use_rel_pos_bias:
            del sd[p + "attn.relative_position_bias_table"]
        if qv_bias_only:
            del sd[p + "attn.qkv.bias"]
            sd[p + "attn.q_bias"] = w(dim, s=0.3)
            sd[p + "attn.v_bias"] = w(dim, s=0.3)
        if init_values is not None:
            sd[p + "gamma_1"] = init_values * (1.0 + w(dim, s=0.1))
            sd[p + "gamma_2"] = init_values * (1.0 + w(dim, s=0.1))
    if not use_abs_pos_embed:
        del sd["backbone.pos_embed"]
    return sd


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth``/``.pt`` checkpoint's state dict (its ``model`` entry when
    it has one), on the CPU."""
    if not path.endswith((".pth", ".pt")):
        raise NotImplementedError(f"{path}: only .pth checkpoints load here")
    blob = torch.load(path, map_location="cpu", weights_only=False)
    return blob.get("model", blob) if isinstance(blob, dict) else blob


def load_timm_state_dict(model: torch.nn.Module, state_dict: Mapping,
                         log=print) -> Tuple[List[str], List[str]]:
    """Load a timm/DyT state dict (numpy arrays or tensors) into ``model``
    (an image model, or a segmentor's ``backbone``).

    Returns (missing, unexpected) key lists.  A pos-embed of another patch
    grid is interpolated to the model's (``interpolate_pos_embed``, as
    ``import_pretrained`` does); raises on any other shape mismatch than
    the head's."""
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
        if key == "pos_embed" and tuple(t.shape) != want:
            log(f"Interpolating pos_embed {tuple(t.shape)} -> {want}")
            t = torch.from_numpy(interpolate_pos_embed(t, want[1] - 1, 1))
        if tuple(t.shape) != want:
            if key.startswith("head."):
                log(f"Removing key {key} from pretrained checkpoint "
                    f"(shape {tuple(t.shape)} != {want})")
                continue
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
