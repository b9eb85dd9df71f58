"""DyT VisionTransformer in PyTorch (counterpart of
dynamic_tuning_tpu/models/vit.py), serving and training forwards.

Images go in as NHWC ``[B, H, W, 3]`` floats, as in the JAX package.  Patch
embedding is a stride-p convolution in the compute dtype (left to cuDNN, as
the JAX package left it to XLA), or in eval under ``cfg.quant`` int8 the
int8 stem on the hand int8 GEMM; the residual stream is kept in
``cfg.residual_dtype``; the final LayerNorm and the head are fp32.
``forward`` returns ``(logits, {"token_select": [B, L, T, 1] or None,
"token_logits": [B, L, T, 1] or None})`` with CLS stripped from both.

The eval forward runs without autograd.  ``training=True`` records the
graph: the module path of every block (no hand kernel), the mask-multiply
gate, dropout at ``pos_drop_rate``, ``drop_rate`` (the head) and the
blocks' rates, stochastic depth, all drawn from ``draws``; the routers'
gumbel noise drawn from it too, or given as ``gate_noise`` [B, L, T, 1].
``cfg.remat`` (training only): ``True``/"full" recomputes each block in the
backward (``torch.utils.checkpoint``), "scores" keeps each block's qkv,
post-projection and fc1 outputs and recomputes the rest (a selective
checkpoint, the JAX package's save-list policy).  A recomputed block folds
its random streams anew, so it draws what its forward drew.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from dynamic_tuning_tpu_torch.config import (ModelConfig, SelectConfig,
                                             TuningConfig)
from dynamic_tuning_tpu_torch.models.layers import (LN_EPS, Block, Draws,
                                                     _WeightCache, dropout,
                                                     remat_save_op,
                                                     trunc_normal_02)
from dynamic_tuning_tpu_torch.ops import quant as qt

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class PatchEmbed(nn.Module):
    """p x p non-overlapping patches -> [B, T, C] in the compute dtype.

    With ``quant`` int8, in eval, the stem is the JAX package's
    ``q8_conv``: int8 weights per output channel times int8 activations per
    image, as a patch matmul on the int8 GEMM
    (``ops/quant.py::q8_patch_embed``)."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 generator: torch.Generator, *, dtype=torch.bfloat16,
                 quant: str = "none"):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size)
        with torch.no_grad():
            trunc_normal_02(self.proj.weight, generator)
            self.proj.bias.zero_()
        self.dtype = dtype
        self.quant = quant
        self._w = _WeightCache()

    def forward(self, x: torch.Tensor, training: bool = False
                ) -> torch.Tensor:
        if self.quant != "none" and not training:
            return qt.q8_patch_embed(
                x.to(self.dtype),
                *self._w.int8(self.proj.weight, qt.quantize_conv_weight),
                self.proj.bias.detach(), patch=self.proj.stride[0],
                dtype=self.dtype)
        x = x.permute(0, 3, 1, 2).to(self.dtype)            # NHWC -> NCHW
        y = F.conv2d(x, self.proj.weight.to(self.dtype),
                     stride=self.proj.stride)
        y = y + self.proj.bias.to(self.dtype)[:, None, None]
        return y.flatten(2).transpose(1, 2)


class VisionTransformer(nn.Module):
    """DyT ViT, serving forward.  Weights are drawn from ``generator`` (a
    CPU ``torch.Generator``; seed 0 when omitted) and then moved to
    ``device``."""

    def __init__(self, cfg: ModelConfig, tuning: TuningConfig = TuningConfig(),
                 select: SelectConfig = SelectConfig(),
                 dtype=torch.bfloat16, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.num_frames > 1:
            raise NotImplementedError(
                f"num_frames={cfg.num_frames}: clips go to "
                "models/video_vit.py::VideoVisionTransformer")
        check_config(cfg, select)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg, self.tuning, self.select_cfg = cfg, tuning, select
        self.dtype = dtype
        self.residual_dtype = _DTYPES[cfg.residual_dtype]
        C = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, C,
                                      generator, dtype=dtype,
                                      quant=cfg.quant)
        if cfg.class_token:
            self.cls_token = nn.Parameter(
                torch.randn(1, 1, C, generator=generator) * 1e-6)
        self.pos_embed = nn.Parameter(
            torch.randn(1, cfg.seq_len, C, generator=generator) * 0.02)
        self.blocks = make_blocks(cfg, tuning, select, generator, dtype)
        self.norm = nn.LayerNorm(C, eps=LN_EPS)
        self.head = nn.Linear(C, cfg.num_classes)
        with torch.no_grad():
            trunc_normal_02(self.head.weight, generator)
            self.head.bias.zero_()
        self.eval()
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor, *, training: bool = False,
                complete_model: bool = False, dispatch: bool = False,
                draws: Optional[Draws] = None,
                gate_noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Optional[torch.Tensor]]]:
        if training:
            return self._forward(x, True, complete_model, False, draws,
                                 gate_noise)
        with torch.no_grad():
            return self._forward(x, False, complete_model, dispatch, None,
                                 None)

    def _forward(self, x, training, complete_model, dispatch, draws,
                 gate_noise):
        cfg = self.cfg
        B = x.shape[0]
        top = draws.fold(cfg.depth) if draws is not None else None
        x = self.patch_embed(x, training).float()
        if cfg.class_token:
            x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)
        x = x + self.pos_embed
        if training:
            x = dropout(x, cfg.pos_drop_rate, top)
        x = x.to(self.residual_dtype)

        x, aux = run_blocks(self.blocks, x, remat=cfg.remat,
                            training=training, complete_model=complete_model,
                            dispatch=dispatch, draws=draws,
                            gate_noise=gate_noise)
        x = F.layer_norm(x.float(), (cfg.embed_dim,), self.norm.weight,
                         self.norm.bias, LN_EPS)
        if cfg.global_pool == "avg":
            pooled = x[:, 1 if cfg.class_token else 0:].mean(dim=1)
        else:
            pooled = x[:, 0]
        if training:
            pooled = dropout(pooled, cfg.drop_rate, top)
        return F.linear(pooled, self.head.weight, self.head.bias), aux


def check_config(cfg: ModelConfig, select: SelectConfig) -> None:
    """The refusals every ViT of the port shares."""
    if cfg.remat not in (False, True, "full", "scores"):
        raise ValueError(f"remat={cfg.remat!r}: False, True, 'full' or "
                         "'scores'")
    if select.open and not cfg.class_token:
        raise ValueError("token routing (select.open=True) requires "
                         "class_token=True")


def make_blocks(cfg: ModelConfig, tuning: TuningConfig, select: SelectConfig,
                generator: torch.Generator, dtype) -> nn.ModuleList:
    """The ``cfg.depth`` DyT blocks of a ViT (a router from block
    ``select.keep_layers`` on, stochastic depth rising linearly)."""
    return nn.ModuleList([
        Block(cfg.embed_dim, cfg.num_heads, generator,
              mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
              proj_drop=cfg.proj_drop_rate, attn_drop=cfg.attn_drop_rate,
              drop_path=cfg.drop_path_rate * i / max(cfg.depth - 1, 1),
              select=select.open and i >= select.keep_layers,
              gelu_approx=cfg.gelu_approx, quant=cfg.quant, tuning=tuning,
              select_cfg=select, dtype=dtype)
        for i in range(cfg.depth)])


def run_blocks(blocks: nn.ModuleList, x: torch.Tensor, *, remat,
               training: bool, complete_model: bool, dispatch: bool,
               draws: Optional[Draws], gate_noise: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, Optional[torch.Tensor]]]:
    """The residual stream ``x`` [B, N, C] through ``blocks`` ->
    (x, {"token_select": [B, L, N - 1, 1], "token_logits": [B, L, N - 1,
    1]}, both None without routers); ``remat`` recomputes each block in
    the training backward."""
    gates, logits_all = [], []
    for i, blk in enumerate(blocks):
        noise = (gate_noise[:, len(gates)]
                 if gate_noise is not None and blk.select
                 and not complete_model else None)
        run = functools.partial(
            _run_block, blk, complete_model=complete_model,
            dispatch=dispatch, training=training, draws=draws, index=i,
            noise=noise)
        if training and remat:
            x, gate, logits = _checkpointed(run, x, remat)
        else:
            x, gate, logits = run(x)
        if gate is not None:
            gates.append(gate)
            logits_all.append(logits)
    if not gates:
        return x, {"token_select": None, "token_logits": None}
    return x, {"token_select": torch.stack(gates, dim=1)[:, :, 1:, :],
               "token_logits": torch.stack(logits_all, dim=1)}


def _run_block(blk, x, *, complete_model, dispatch, training, draws, index,
               noise, tags=False):
    """One block; its random streams are folded here, inside any
    checkpointed region, so a recompute starts them afresh."""
    return blk(x, complete_model, dispatch, training=training,
               draws=draws.fold(index) if draws is not None else None,
               noise=noise, tags=tags)


def _save_tagged(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op == remat_save_op()
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpointed(run, x, remat):
    """``run(x)`` recomputed in the backward: whole (``True``/"full"), or
    all but the tagged outputs ("scores").  The global RNG is not used, so
    its state is not saved."""
    if remat == "scores":
        return checkpoint(
            functools.partial(run, tags=True), x, use_reentrant=False,
            preserve_rng_state=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_tagged))
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


def vit_base_patch16_224_in21k(num_classes: int = 1000,
                               tuning: TuningConfig = TuningConfig(),
                               select: SelectConfig = SelectConfig(),
                               dtype=torch.bfloat16, *, device=None,
                               generator: Optional[torch.Generator] = None,
                               **overrides) -> VisionTransformer:
    """ViT-B/16 factory (the JAX package's vit_base_patch16_224_in21k)."""
    cfg = ModelConfig(num_classes=num_classes, **overrides)
    return VisionTransformer(cfg, tuning=tuning, select=select, dtype=dtype,
                             device=device, generator=generator)
