"""The speed-test model: DyT ViT serving as one function over prepared
tensors (counterpart of dynamic_tuning_tpu/models/fast_inference.py, the
JAX package's ``fast_vit_forward``, itself the counterpart of the
reference's ``model_speed_test.py``).

``serving_params(model)`` takes the tensors once from a port
``VisionTransformer`` (timm names, so a model filled by
``load_timm_state_dict`` or from ``from_flax_params`` serves here): LN
affines folded into the qkv and fc1 weights, bf16 weight copies, fp32 biases.
``fast_vit_forward(params, x, ...)`` then runs

* the patch embedding as one matmul of (ph, pw, c)-ordered patch rows;
* a bf16 residual stream;
* attention with the LN folded into the qkv matmul, then K15
  (``ops/mha_serving.mha_serving``) on views of the qkv buffer: q times
  the bf16-rounded scale, the clamped no-max softmax, ``l`` summed over the
  bf16-rounded exponentials;
* the router on bf16 weights, the MLP on every row (``mask``, ``dense``) or
  on the top-K rows per image (``dispatch``, ``ops/dispatch.py``);
* the MLP as K11 (``ops/fused_mlp.fused_ln_mlp``) with ``use_kernel=True``,
  else as the folded-LN cuBLAS chain.

Every product takes bf16 operands with fp32 accumulation and an fp32
result, as XLA's ``preferred_element_type=float32`` does, then rounds where
the JAX function rounds.  ``chunked_serving`` runs a batch-leading serving
function over chunks of the batch.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from dynamic_tuning_tpu_torch.config import (ModelConfig, SelectConfig,
                                             TuningConfig)
from dynamic_tuning_tpu_torch.ops import dispatch as D
from dynamic_tuning_tpu_torch.ops import fused_mlp as fm
from dynamic_tuning_tpu_torch.ops import mha_serving as ms
from dynamic_tuning_tpu_torch.ops.quant import patchify

BF, F32 = torch.bfloat16, torch.float32
LN_EPS = 1e-6


def _normalized_bf16(x: torch.Tensor) -> torch.Tensor:
    """LN without its affine (folded into the next matmul), rounded to
    bf16."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + LN_EPS)).to(BF)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x [..., K] @ bf16 w [N, K].T summed in fp32, + the fp32 bias
    (the JAX ``_dense``): on the card one cuBLAS call with an fp32 output
    and the bias added in its epilogue; on the CPU fp32 products."""
    if x.device.type == "cuda":
        out = torch.addmm(b, x.reshape(-1, x.shape[-1]).to(BF), w.t(),
                          out_dtype=F32)
        return out.reshape(*x.shape[:-1], w.shape[0])
    return torch.matmul(x.to(BF).float(), w.float().t()) + b


def _folded(ln_w, ln_b, w, b):
    """dense(LN(x)) == normalize(x) @ (scale * W) + (bias @ W + b): the
    folded weight in bf16 and bias in fp32, from fp32 [out, in] W."""
    w = w.float()
    return ((w * ln_w[None, :]).to(BF).contiguous(),
            (b + w @ ln_b).float().contiguous())


def serving_params(model) -> Dict:
    """The tensors ``fast_vit_forward`` reads, taken once from a port
    ``VisionTransformer`` on its device."""
    sd = {k: v.detach() for k, v in model.state_dict().items()}

    def bf(key):
        return sd[key].to(BF).contiguous()

    def f32(key):
        return sd[key].float().contiguous()

    w = sd["patch_embed.proj.weight"]              # [C, 3, ps, ps]
    params = {
        # (ph, pw, c) column order, as the patch rows
        "patch_embed": (w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
                        .to(BF).contiguous(), f32("patch_embed.proj.bias")),
        "cls_token": f32("cls_token"),
        "pos_embed": f32("pos_embed"),
        "norm": (f32("norm.weight"), f32("norm.bias")),
        "head": (f32("head.weight"), f32("head.bias")),
        "blocks": [],
    }
    for i in range(len(model.blocks)):
        p = f"blocks.{i}."
        n1 = (sd[p + "norm1.weight"], sd[p + "norm1.bias"])
        n2 = (f32(p + "norm2.weight"), f32(p + "norm2.bias"))
        blk = {
            "qkv": _folded(*n1, sd[p + "attn.qkv.weight"],
                           sd[p + "attn.qkv.bias"]),
            "proj": (bf(p + "attn.proj.weight"), f32(p + "attn.proj.bias")),
            # the cuBLAS chain (use_kernel=False): norm2 folded into fc1
            "fc1_folded": _folded(*n2, sd[p + "mlp.fc1.weight"],
                                  sd[p + "mlp.fc1.bias"]),
            # K11 (use_kernel=True): LN affine, w1, b1, w2, b2
            "mlp": (*n2, bf(p + "mlp.fc1.weight"), f32(p + "mlp.fc1.bias"),
                    bf(p + "mlp.fc2.weight"), f32(p + "mlp.fc2.bias")),
        }
        if p + "mlp_token_select.mlp_head.weight" in sd:
            blk["router"] = (bf(p + "mlp_token_select.mlp_head.weight"),
                             f32(p + "mlp_token_select.mlp_head.bias"))
        if p + "adaptmlp.down_proj.weight" in sd:
            blk["adapter"] = (
                bf(p + "adaptmlp.down_proj.weight"),
                f32(p + "adaptmlp.down_proj.bias"),
                bf(p + "adaptmlp.up_proj.weight"),
                f32(p + "adaptmlp.up_proj.bias"))
            if p + "adaptmlp.scale" in sd:
                blk["adapter_scale"] = f32(p + "adaptmlp.scale")
        params["blocks"].append(blk)
    return params


def _attention(x: torch.Tensor, p: Dict, heads: int) -> torch.Tensor:
    B, N, C = x.shape
    qkv = _dense(_normalized_bf16(x), *p["qkv"]).to(BF)
    # K15 on [B, H, N, hd] views of the qkv buffer (no copies): q times the
    # bf16-rounded scale, the clamped no-max softmax with l over the
    # bf16-rounded exponentials, one division by l; its [B, N, H, hd]
    # output is the projection's [B, N, C] input as it lies
    q, k, v = qkv.view(B, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    out = ms.mha_serving(q, k, v).transpose(1, 2).reshape(B, N, C)
    return _dense(out, *p["proj"]).to(BF)


def _adapter(x: torch.Tensor, p: Dict, scale) -> torch.Tensor:
    wd, bd, wu, bu = p["adapter"]
    down = torch.relu(_dense(x, wd, bd))
    return (_dense(down.to(BF), wu, bu) * scale).to(BF)


def _mlp_cublas(rows, gate2d, w1f, b1f, w2, b2, gelu_approx):
    """The JAX function's unfused MLP: LN folded into fc1 -> GELU -> fc2
    (-> gate), each product on cuBLAS."""
    h = _dense(_normalized_bf16(rows), w1f, b1f)
    h = F.gelu(h, approximate="tanh" if gelu_approx else "none")
    y = _dense(h.to(BF), w2, b2)
    if gate2d is not None:
        y = y * gate2d.float()
    return y.to(rows.dtype)


def _block(x: torch.Tensor, p: Dict, *, heads: int, tuning: TuningConfig,
           select: SelectConfig, mode: str, use_kernel: bool,
           gelu_approx: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    B, N, C = x.shape
    x = x + _attention(x, p, heads)

    gate = scores = None
    routed = "router" in p and select.open and mode != "dense"
    if routed:
        logits = _dense(x[:, 1:], *p["router"])[..., 0]
        scores = torch.sigmoid(logits)
        gate = torch.cat([torch.ones((B, 1), dtype=F32, device=x.device),
                          (scores > select.threshold).float()], dim=1)

    adapt = None
    if "adapter" in p:
        if tuning.ffn_adapter_scalar == "learnable_scalar":
            scale = p["adapter_scale"].to(BF).float()
        else:
            scale = float(tuning.ffn_adapter_scalar)
        adapt = _adapter(x, p, scale)

    def run_mlp(rows, gate2d):
        if use_kernel:
            return fm.fused_ln_mlp(rows, *p["mlp"], gate2d,
                                   gelu_approx=gelu_approx)
        return _mlp_cublas(rows, gate2d, *p["fc1_folded"], *p["mlp"][4:],
                           gelu_approx)

    if routed and mode == "dispatch":
        ratio = (select.capacity_ratio if select.capacity_ratio is not None
                 else select.token_target_ratio)
        K = D.capacity_for(N - 1, ratio)
        scores_full = torch.cat(
            [torch.full((B, 1), math.inf, dtype=F32, device=x.device),
             scores], dim=1)
        mlp_out, gate = D.dispatch_mlp(
            x, scores_full, K,
            lambda rows: run_mlp(rows.reshape(-1, C), None).reshape(B, K, C),
            select.threshold)
    else:
        g2d = None if gate is None else gate.reshape(B * N, 1).to(x.dtype)
        mlp_out = run_mlp(x.reshape(B * N, C), g2d).reshape(B, N, C)

    x = x + mlp_out.to(x.dtype)
    if adapt is not None:
        x = x + adapt
    return x, gate


@torch.no_grad()
def fast_vit_forward(params: Dict, x: torch.Tensor, *, cfg: ModelConfig,
                     tuning: TuningConfig = TuningConfig(),
                     select: SelectConfig = SelectConfig(),
                     mode: str = "dispatch", use_kernel: bool = False
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """NHWC images [B, H, W, 3] -> (logits [B, classes] fp32, gates
    [B, L, N] fp32 or None in dense mode).

    mode: "dispatch" (capacity top-k) | "mask" (dense masked) | "dense"
    (complete model).  ``use_kernel`` is the counterpart of the JAX
    function's ``use_pallas``: the MLP runs as K11 (``fused_ln_mlp``)
    instead of the cuBLAS chain."""
    if tuning.ffn_adapt and tuning.ffn_adapter_layernorm_option != "none":
        raise ValueError(
            "fast_vit_forward supports ffn_adapter_layernorm_option='none' "
            "only (the in/out adapter LayerNorm params would be silently "
            "dropped); use the model's forward for that config")
    if tuning.moe_experts and tuning.moe_experts > 1:
        raise ValueError(
            "fast_vit_forward does not implement the MoE adapter; "
            "use the model's forward for moe_experts > 1")
    B = x.shape[0]
    C = cfg.embed_dim
    w, b = params["patch_embed"]
    tokens = _dense(patchify(x.to(BF), cfg.patch_size), w, b)
    cls = params["cls_token"].expand(B, 1, C)
    h = (torch.cat([cls, tokens.reshape(B, -1, C)], dim=1)
         + params["pos_embed"]).to(BF)

    gates = []        # fp32: bf16 sums saturate at 256 in accounting
    for i in range(cfg.depth):
        h, gate = _block(h, params["blocks"][i], heads=cfg.num_heads,
                         tuning=tuning, select=select, mode=mode,
                         use_kernel=use_kernel, gelu_approx=cfg.gelu_approx)
        if gate is not None:
            gates.append(gate.float())

    pooled = F.layer_norm(h[:, 0].float(), (C,), *params["norm"], LN_EPS)
    logits = F.linear(pooled, *params["head"])
    return logits, (torch.stack(gates, dim=1) if gates else None)


def _concat(outs):
    """Batch-concatenate a list of equally structured outputs (tensors,
    tuples, lists, dicts; None stays None)."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat(outs, dim=0)
    if isinstance(first, dict):
        return {k: _concat([o[k] for o in outs]) for k in first}
    return type(first)(_concat(list(parts)) for parts in zip(*outs))


def chunked_serving(fn: Callable, chunk: int = 128) -> Callable:
    """Wrap a batch-leading serving ``fn`` to run ``chunk`` images at a
    time: equal chunks and one tail, outputs concatenated on the batch
    dimension.  ``fn`` maps ``[B, ...]`` to tensors, tuples, lists or dicts
    of batch-leading tensors, or None, and the wrapper returns the same
    structure.  It bounds the scratch memory of one forward (the
    [B, H, N, N] scores, the MLP hidden) at large batches."""
    def wrapped(x, *args, **kwargs):
        B = x.shape[0]
        if chunk <= 0 or B <= chunk:
            return fn(x, *args, **kwargs)
        return _concat([fn(x[i:i + chunk], *args, **kwargs)
                        for i in range(0, B, chunk)])
    return wrapped
