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
  ``mean``/``var`` -> ``running_mean``/``running_var``).  The video
  model's tree adds ``query_token`` and ``attentive_blocks/...``
  (``attentive_blocks.norm_q.weight``, ``attentive_blocks.cross_attn.q.
  weight``, ``...cross_attn.q_bias``, the reference video model's names),
  and its tubelet stem's 5-D kernel goes DHWIO -> OIDHW.
* ``load_timm_state_dict``: a timm/DyT state dict into a port model with
  the rules of ``import_pretrained``: ``pre_logits.*`` dropped, a head of
  another width dropped (head surgery), a pos-embed of another patch grid
  interpolated bicubically, unknown keys reported and ignored, keys the
  checkpoint lacks (adapters and routers of an IN21K backbone) left at
  their init and returned as missing;
* ``from_flax_train_state``: a JAX-package ``TrainState``'s parts (numpy
  trees: the flat trainable and frozen dicts, optax's state, the step) ->
  the port's model state dict, ``Optimizer.state_dict()`` and step, so a
  run started in the JAX package continues in the port;
* ``make_vit_state_dict`` / ``make_seg_state_dict``: seeded synthetic
  state dicts of the image model and of the segmentor, for runs on random
  weights (``chip_smoke.py``, the bench) and the tests.
"""

from __future__ import annotations

import ast
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
    # the video model's attentive pooling (the reference video model's
    # names, video_vision_transformer_IN21K.py:27-110,408-413)
    ("query_token",): "query_token",
    ("attentive_blocks", "norm_q", "scale"): "attentive_blocks.norm_q.weight",
    ("attentive_blocks", "norm_q", "bias"): "attentive_blocks.norm_q.bias",
    ("attentive_blocks", "norm_k", "scale"): "attentive_blocks.norm_k.weight",
    ("attentive_blocks", "norm_k", "bias"): "attentive_blocks.norm_k.bias",
    ("attentive_blocks", "norm_v", "scale"): "attentive_blocks.norm_v.weight",
    ("attentive_blocks", "norm_v", "bias"): "attentive_blocks.norm_v.bias",
    ("attentive_blocks", "cross_attn", "q", "kernel"):
        "attentive_blocks.cross_attn.q.weight",
    ("attentive_blocks", "cross_attn", "k", "kernel"):
        "attentive_blocks.cross_attn.k.weight",
    ("attentive_blocks", "cross_attn", "v", "kernel"):
        "attentive_blocks.cross_attn.v.weight",
    ("attentive_blocks", "cross_attn", "q_bias"):
        "attentive_blocks.cross_attn.q_bias",
    ("attentive_blocks", "cross_attn", "v_bias"):
        "attentive_blocks.cross_attn.v_bias",
    ("attentive_blocks", "cross_attn", "proj", "kernel"):
        "attentive_blocks.cross_attn.proj.weight",
    ("attentive_blocks", "cross_attn", "proj", "bias"):
        "attentive_blocks.cross_attn.proj.bias",
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
                         "(not part of the ported image and video models)")
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
        if w.ndim == 5:
            # the tubelet stem's Conv3d: DHWIO -> OIDHW
            return np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2))
    return w


def _relayout(fn, path: Tuple[str, ...], w):
    """``fn(path, array)`` as an array of its own (a transpose copies once;
    a leaf kept as it is, a view of a file's buffer, is copied); a bf16
    tensor (numpy has no bfloat16) goes through its bits and comes back a
    bf16 tensor."""
    if isinstance(w, torch.Tensor):
        bf16 = w.dtype == torch.bfloat16
        out = fn(path, _host(w))
        return torch.from_numpy(out).view(torch.bfloat16) if bf16 else out
    out = fn(path, np.asarray(w))
    return out if out.flags.owndata else out.copy()


def from_flax_params(params: Mapping, batch_stats: Mapping | None = None
                     ) -> Dict[str, np.ndarray]:
    """JAX-package param tree (and, for a BatchNorm segmentor, its
    ``batch_stats`` tree) -> the port's numpy state dict (a bf16 leaf, as a
    ``.msgpack`` gives it, as a bf16 tensor)."""
    trees = [params] + ([batch_stats] if batch_stats else [])
    return {flax_path_to_port(p): _relayout(_to_torch_layout, p, w)
            for tree in trees for p, w in _flatten(tree)}


_TIMM_TO_FLAX = {v: k for k, v in _FLAX_TO_TIMM.items()}
_LEAF_OF = {"bias": "bias", "running_mean": "mean", "running_var": "var"}


def port_name_to_flax_path(name: str, ndim: int) -> Tuple[str, Tuple[str, ...]]:
    """The inverse of ``flax_path_to_port``: a port state-dict key (and its
    tensor's rank, which tells a Dense/Conv ``kernel`` from a norm's
    ``scale``) -> (flax collection, flax path).  The collection is
    ``"params"``, or ``"batch_stats"`` for BatchNorm running statistics."""
    parts = name.split(".")
    if parts[0] in _SEG_TOPS:
        top, rest = parts[0], parts[1:]
        if top == "backbone" and not re.fullmatch(r"fpn\d_deconv\d?",
                                                  rest[0]):
            return "params", ("backbone",) + port_name_to_flax_path(
                ".".join(rest), ndim)[1]
        leaf = rest[-1]
        if leaf == "weight":
            leaf = "kernel" if ndim > 1 else "scale"
        elif leaf in _LEAF_OF:
            leaf = _LEAF_OF[leaf]
        else:
            raise ValueError(f"no flax path for port tensor {name}")
        coll = "batch_stats" if leaf in ("mean", "var") else "params"
        return coll, (top,) + tuple(rest[:-1]) + (leaf,)
    m = re.fullmatch(r"blocks\.(\d+)\.(.*)", name)
    prefix, key = ((f"blocks_{m.group(1)}",), m.group(2)) if m else ((),
                                                                    name)
    path = _TIMM_TO_FLAX.get(key)
    if path is None:
        raise ValueError(f"no flax path for port tensor {name}")
    return "params", prefix + path


def _to_flax_layout(path: Tuple[str, ...], w: np.ndarray) -> np.ndarray:
    """The inverse of ``_to_torch_layout``."""
    if path[-1] == "kernel":
        if w.ndim == 2:
            return np.ascontiguousarray(w.T)             # [out,in] -> [in,out]
        if w.ndim == 4 and _is_deconv(path):
            # [in, out, kh, kw] -> [kh, kw, in, out], then unflip
            return np.ascontiguousarray(w.transpose(2, 3, 0, 1)[::-1, ::-1])
        if w.ndim == 4:
            return np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # -> HWIO
        if w.ndim == 5:
            return np.ascontiguousarray(w.transpose(2, 3, 4, 1, 0))  # DHWIO
    return w


def _host(t) -> np.ndarray:
    """A tensor or array as a numpy array on the host, always a copy (a
    bf16 tensor as its bits, int16: numpy has no bfloat16)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.array(t)


def nest(flat: Mapping[Tuple[str, ...], object]) -> dict:
    """``{path tuple: leaf}`` -> nested dicts (flax's ``unflatten_dict``)."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def to_flax_flat(state_dict: Mapping) -> Dict[str, Dict[Tuple[str, ...],
                                                          np.ndarray]]:
    """A port state dict (tensors or arrays) -> ``{collection: {flax path:
    array in the flax layout}}``, the inverse of ``from_flax_params``."""
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for name, t in state_dict.items():
        coll, path = port_name_to_flax_path(name, t.ndim)
        out[coll][path] = _relayout(_to_flax_layout, path, t)
    return out


def to_flax_params(state_dict: Mapping) -> Tuple[dict, dict]:
    """A port state dict (tensors or arrays, always copied) -> (the JAX
    package's nested param tree, its ``batch_stats`` tree, empty without
    BatchNorm)."""
    flat = to_flax_flat(state_dict)
    return nest(flat["params"]), nest(flat["batch_stats"])


def _path_key(key) -> Tuple[str, ...]:
    """An optax moment's key: a flax path tuple, or its string form as
    ``flax.serialization.to_state_dict`` writes it."""
    if isinstance(key, tuple):
        return key
    path = ast.literal_eval(key)
    if not isinstance(path, tuple):
        raise ValueError(f"optimizer state key {key!r} is not a flax path")
    return path


def _flat_tree(tree: Mapping) -> Dict[Tuple[str, ...], np.ndarray]:
    """A flat ``{path tuple: array}`` dict (the JAX ``TrainState``'s form),
    its serialized form (``{"('blocks_0', ...)": array}``) or a nested one
    -> the flat form."""
    if not tree:
        return {}
    first = next(iter(tree))
    if isinstance(first, tuple) or (isinstance(first, str)
                                    and first.startswith("(")):
        return {_path_key(k): v for k, v in tree.items()}
    return dict(_flatten(tree))


def _timm_tree(tree: Mapping) -> Dict[str, np.ndarray]:
    return {flax_path_to_port(p): _relayout(_to_torch_layout, p, w)
            for p, w in _flat_tree(tree).items()}


def _field(node, name):
    return node[name] if isinstance(node, Mapping) else getattr(node, name)


def _find_states(node, out: dict) -> dict:
    """Walk an optax state by duck typing, as named tuples or as the dicts
    of its serialized form (``{'0': ..., '1': ...}`` for a chain): the adam
    moments (``mu``, ``nu``, ``count``) and MultiSteps' accumulation
    (``mini_step``, ``acc_grads``)."""
    def has(*names):
        return all((k in node) if isinstance(node, Mapping)
                   else hasattr(node, k) for k in names)

    if has("mu", "nu"):
        out["adam"] = node
    elif has("acc_grads", "mini_step"):
        out["multi"] = node
        _find_states(_field(node, "inner_opt_state"), out)
    elif isinstance(node, (tuple, list)):
        for child in node:
            _find_states(child, out)
    elif isinstance(node, Mapping):
        for child in node.values():
            _find_states(child, out)
    return out


def from_flax_train_state(trainable: Mapping, frozen: Mapping, opt_state,
                          step) -> dict:
    """The parts of a JAX-package ``TrainState`` (host numpy trees) ->
    ``{"model": the port's numpy state dict of every parameter,
    "optimizer": the port's Optimizer.state_dict() (numpy), "step": int}``.

    Reads optax adamw's ``mu``/``nu``/``count`` (laid out as the port's
    tensors: Dense kernels transposed) and, with ``accum_iter > 1``,
    ``MultiSteps``' running-mean buffer and ``mini_step``, from optax's
    named tuples or from their ``to_state_dict`` form (a ``.msgpack``
    checkpoint's ``opt_state``).  Load with ``model.load_state_dict``,
    ``optimizer.load_state_dict`` and ``TrainState.step``."""
    found = _find_states(opt_state, {})
    if "adam" not in found:
        raise ValueError("no adamw state (mu, nu, count) in the optax state")
    adam = found["adam"]
    rule = {"mu": _timm_tree(_field(adam, "mu")),
            "nu": _timm_tree(_field(adam, "nu")),
            "count": int(np.asarray(_field(adam, "count")))}
    multi = found.get("multi")
    optimizer = {"rule": rule,
                 "acc": None if multi is None else _timm_tree(
                     _field(multi, "acc_grads")),
                 "mini_step": (0 if multi is None else int(np.asarray(
                     _field(multi, "mini_step"))))}
    model = {**_timm_tree(frozen), **_timm_tree(trainable)}
    return {"model": model, "optimizer": optimizer,
            "step": int(np.asarray(step))}


def to_flax_opt_state(optimizer) -> dict:
    """The port's ``Optimizer`` (AdamW) -> the ``to_state_dict`` form of the
    optax state that the JAX package's ``make_optimizer`` +
    ``with_grad_accumulation`` build for the same flags, which its
    ``load_checkpoint`` restores: adamw is the chain (``scale_by_adam``,
    ``add_decayed_weights``, the schedule's count); ``clip_grad`` puts an
    empty state before it and layer decay one after it, as chain entries
    ``'0'``, ``'1'``, ...; ``accum_iter > 1`` wraps it in ``MultiSteps``.
    The moments are keyed by the string form of their flax path."""
    if not hasattr(optimizer.rule, "mu"):
        raise ValueError("only the AdamW optimizer state has an optax form")

    def paths(tensors):
        flat = to_flax_flat(dict(zip(optimizer.names, tensors)))["params"]
        return {str(p): w for p, w in flat.items()}

    count = np.asarray(optimizer.count, np.int32)
    adamw = {"0": {"count": count, "mu": paths(optimizer.rule.mu),
                   "nu": paths(optimizer.rule.nu)},
             "1": {}, "2": {"count": count}}
    chain = ([{}] if optimizer.clip_grad is not None else []) + [adamw] + (
        [{}] if optimizer.scales is not None else [])
    inner = adamw if len(chain) == 1 else {str(i): c
                                           for i, c in enumerate(chain)}
    if optimizer.acc is None:
        return inner
    return {"mini_step": np.asarray(optimizer.mini_step, np.int32),
            "gradient_step": count, "inner_opt_state": inner,
            "acc_grads": paths(optimizer.acc), "skip_state": {}}


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
