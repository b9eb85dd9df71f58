"""DyT layers in PyTorch (counterpart of dynamic_tuning_tpu/models/layers.py):
Mlp, Attention, Adapter, TokenSelect, DropPath and Block, serving forms.

Parameters are fp32 and carry timm's names (``attn.qkv.weight``,
``mlp.fc1.bias``, ``adaptmlp.down_proj.weight``,
``mlp_token_select.mlp_head.weight``, ...) so a timm/DyT ``.pth`` loads with
``load_state_dict``.  Matmuls run in the compute ``dtype`` with fp32
LayerNorms, router head and softmax, like the JAX package.  The compute-dtype
copies of the weights are made once per parameter value (``_WeightCache``),
not on every call as the JAX package casts them.

``Block`` takes the fused serving kernels of ``ops/mha_serving.py`` under the
same applicability predicate as the JAX Block (``_attention_fusable`` plus
N <= 512); otherwise it runs the module path (Attention, TokenSelect,
Adapter).  With ``quant="int8"`` or ``"int8_attn"`` it takes the int8
kernels of ``ops/quant.py`` instead (K6/K5 for the sublayer, K4 for the MLP
on every path), with int8 weights quantized once per load from the fp32
parameters.  Training, MoE adapters, adapter in/out LayerNorm, LayerScale,
BEiT q/v biases and windowed attention belong to later slices and raise
NotImplementedError.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dynamic_tuning_tpu_torch.config import SelectConfig, TuningConfig
from dynamic_tuning_tpu_torch.ops import dispatch as D
from dynamic_tuning_tpu_torch.ops import mha_serving as ms
from dynamic_tuning_tpu_torch.ops import quant as qt
from dynamic_tuning_tpu_torch.ops.gumbel import gumbel_sigmoid

LN_EPS = 1e-6


# --- initialisation (all draws from an explicit generator) -------------------

def trunc_normal_02(t: torch.Tensor, generator: torch.Generator) -> None:
    """Truncated normal, std 0.02, cut at two standard deviations."""
    nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)


def kaiming_uniform_lora(t: torch.Tensor, generator: torch.Generator) -> None:
    """torch Linear's default init (bound 1/sqrt(fan_in)): the adapter's
    "lora" down projection."""
    nn.init.kaiming_uniform_(t, a=math.sqrt(5), generator=generator)


def _linear(n_in: int, n_out: int, generator: torch.Generator, *,
            bias: bool = True, init=trunc_normal_02) -> nn.Linear:
    lin = nn.Linear(n_in, n_out, bias=bias)
    with torch.no_grad():
        init(lin.weight, generator)
        if bias:
            lin.bias.zero_()
    return lin


# --- compute-dtype weight copies ---------------------------------------------

class _WeightCache:
    """Compute-dtype contiguous copies and int8 quantizations of fp32
    parameters, keyed on the parameter's storage and version so a
    load_state_dict or .to() refreshes them."""

    def __init__(self):
        self._entries = {}

    def _cached(self, p: torch.Tensor, tag, make):
        key = (id(p), tag)
        stamp = (p.data_ptr(), p._version, p.device)
        hit = self._entries.get(key)
        if hit is None or hit[0] != stamp:
            with torch.inference_mode(False), torch.no_grad():
                hit = (stamp, make(p.detach()))
            self._entries[key] = hit
        return hit[1]

    def get(self, p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if p.dtype == dtype:
            return p.detach()
        return self._cached(p, dtype, lambda t: t.to(dtype).contiguous())

    def int8(self, p: torch.Tensor, quantize=qt.quantize_weight):
        """(int8 codes, fp32 per-channel scales) of the fp32 master weight
        ``p`` -- never of a rounded copy, whose codes differ."""
        return self._cached(p, ("int8", quantize), quantize)


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """fp32 LayerNorm of any-dtype input (flax LayerNorm(dtype=float32))."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, LN_EPS)


# --- modules -----------------------------------------------------------------

class DropPath(nn.Module):
    """Stochastic depth; the identity in eval (every recipe runs rate 0)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.rate > 0.0:
            raise NotImplementedError("stochastic depth trains in the "
                                      "training slice")
        return x


class Mlp(nn.Module):
    """fc1 -> GELU (erf, or tanh with ``gelu_approx``) -> fc2 in ``dtype``."""

    def __init__(self, dim: int, hidden: int, generator: torch.Generator, *,
                 gelu_approx: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.fc1 = _linear(dim, hidden, generator)
        self.fc2 = _linear(hidden, dim, generator)
        self.gelu = "tanh" if gelu_approx else "none"
        self.dtype = dtype
        self._w = _WeightCache()

    def q8_weights(self):
        """(w1q, s1, b1, w2q, s2, b2) for the int8 MLP kernel (K4)."""
        return (*self._w.int8(self.fc1.weight), self.fc1.bias.detach(),
                *self._w.int8(self.fc2.weight), self.fc2.bias.detach())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self._w.get
        h = F.linear(x.to(self.dtype), w(self.fc1.weight, self.dtype),
                     w(self.fc1.bias, self.dtype))
        h = F.gelu(h, approximate=self.gelu)
        return F.linear(h, w(self.fc2.weight, self.dtype),
                        w(self.fc2.bias, self.dtype))


class Attention(nn.Module):
    """Multi-head self-attention, module path (the JAX Attention's unfused
    branches): the serving clamp form when deterministic with no attention
    dropout, else the max-subtracted softmax."""

    def __init__(self, dim: int, num_heads: int, generator: torch.Generator,
                 *, qkv_bias: bool = True, attn_drop: float = 0.0,
                 dtype=torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.qkv = _linear(dim, 3 * dim, generator, bias=qkv_bias)
        self.proj = _linear(dim, dim, generator)
        self.dtype = dtype
        self._w = _WeightCache()

    def _bqkv(self) -> torch.Tensor:
        if self.qkv.bias is not None:
            return self.qkv.bias.detach()
        return torch.zeros(3 * self.proj.in_features,
                           device=self.qkv.weight.device)

    def kernel_weights(self):
        """(wqkv [3C, C], bqkv fp32 [3C], wproj [C, C], bproj fp32 [C])."""
        w = self._w.get
        return (w(self.qkv.weight, self.dtype), self._bqkv(),
                w(self.proj.weight, self.dtype), self.proj.bias.detach())

    def q8_weights(self):
        """(wqkv_q, sqkv, bqkv, wproj_q, sproj, bproj) for the int8 kernels
        (K5, K6)."""
        return (*self._w.int8(self.qkv.weight), self._bqkv(),
                *self._w.int8(self.proj.weight), self.proj.bias.detach())

    def _dense(self, x, lin):
        w = self._w.get
        b = None if lin.bias is None else w(lin.bias, self.dtype)
        return F.linear(x.to(self.dtype), w(lin.weight, self.dtype), b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        hd = C // self.num_heads
        dt = self.dtype
        qkv = self._dense(x, self.qkv)
        q, k, v = qkv.reshape(B, N, 3, self.num_heads, hd).permute(
            2, 0, 3, 1, 4)
        s = torch.matmul((q * hd ** -0.5).float(), k.float().transpose(-1, -2))
        if self.attn_drop == 0.0:
            # serving form: no row max, normalisation after AV; l sums the
            # rounded p as the XLA branch does (layers.py:309-314)
            p = torch.exp(s.clamp(-60.0, 80.0) - 20.0).to(dt)
            out = torch.matmul(p.float(), v.float())
            out = (out / p.float().sum(dim=-1, keepdim=True)).to(dt)
        else:
            # eval: attention dropout is the identity
            out = torch.matmul(torch.softmax(s, dim=-1).to(dt), v)
        out = out.transpose(1, 2).reshape(B, N, C)
        return self._dense(out, self.proj)


class Adapter(nn.Module):
    """AdaptFormer parallel bottleneck: down -> ReLU -> up -> * scale."""

    def __init__(self, cfg: TuningConfig, dim: int,
                 generator: torch.Generator, *, dtype=torch.bfloat16):
        super().__init__()
        if cfg.moe_experts and cfg.moe_experts > 1:
            raise NotImplementedError("the MoE adapter comes with the MoE "
                                      "slice")
        if cfg.ffn_adapter_layernorm_option != "none":
            raise NotImplementedError("adapter in/out LayerNorm comes with a "
                                      "later slice")
        lora = cfg.ffn_adapter_init_option == "lora"
        self.down_proj = _linear(dim, cfg.ffn_num, generator,
                                 init=kaiming_uniform_lora if lora
                                 else trunc_normal_02)
        self.up_proj = _linear(cfg.ffn_num, dim, generator)
        if lora:
            with torch.no_grad():
                self.up_proj.weight.zero_()
        if cfg.ffn_adapter_scalar == "learnable_scalar":
            self.scale = nn.Parameter(torch.ones(1))
        else:
            self.register_buffer(
                "_scale", torch.full((1,), float(cfg.ffn_adapter_scalar)),
                persistent=False)
        self.dtype = dtype
        self._w = _WeightCache()

    def scale_tensor(self) -> torch.Tensor:
        """The adapter scale as an fp32 [1] tensor."""
        return (self.scale if hasattr(self, "scale") else self._scale).detach()

    def kernel_weights(self):
        """(wdown [F, C], bdown fp32, wup [C, F], bup fp32, scale fp32 [1])."""
        w = self._w.get
        return (w(self.down_proj.weight, self.dtype),
                self.down_proj.bias.detach(),
                w(self.up_proj.weight, self.dtype),
                self.up_proj.bias.detach(), self.scale_tensor())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, dt = self._w.get, self.dtype
        down = F.linear(x.to(dt), w(self.down_proj.weight, dt),
                        w(self.down_proj.bias, dt))
        up = F.linear(torch.relu(down), w(self.up_proj.weight, dt),
                      w(self.up_proj.bias, dt))
        return up * self.scale_tensor().to(up.dtype)


class TokenSelect(nn.Module):
    """Router: an fp32 1-unit head on the non-CLS tokens; the eval gate is
    ``sigmoid(logits) > threshold``, CLS forced on."""

    def __init__(self, dim: int, generator: torch.Generator, *,
                 threshold: float = 0.5):
        super().__init__()
        self.mlp_head = _linear(dim, 1, generator)
        self.threshold = threshold

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = F.linear(x[:, 1:, :].float(), self.mlp_head.weight,
                          self.mlp_head.bias)
        return gate_with_cls(logits, self.threshold), logits


def gate_with_cls(logits: torch.Tensor, threshold: float) -> torch.Tensor:
    """Eval hard gate [B, T, 1] from CLS-stripped logits, CLS prepended."""
    gate = gumbel_sigmoid(logits, hard=True, threshold=threshold,
                          training=False)
    cls_on = torch.ones((logits.shape[0], 1, 1), dtype=gate.dtype,
                        device=gate.device)
    return torch.cat([cls_on, gate], dim=1)


def _attention_fusable(attn_drop: float, num_heads: int,
                       head_dim: int) -> bool:
    """The JAX Block's predicate for the fused serving kernels, in eval.
    (The JAX form also asks for a TPU backend or interpret mode; here the
    wrappers serve both devices.)"""
    return (attn_drop == 0.0 and num_heads % 2 == 0
            and (2 * head_dim) % 128 == 0)


class Block(nn.Module):
    """DyT transformer block, serving forward.  ``forward`` returns
    ``(x, gate, logits)``; gate and logits are None without a router."""

    def __init__(self, dim: int, num_heads: int, generator: torch.Generator,
                 *, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 select: bool = True, window_size=None,
                 gelu_approx: bool = False, init_values=None,
                 qv_bias_only: bool = False, quant: str = "none",
                 tuning: TuningConfig = TuningConfig(),
                 select_cfg: SelectConfig = SelectConfig(),
                 dtype=torch.bfloat16):
        super().__init__()
        if window_size is not None:
            raise NotImplementedError("windowed attention comes with the "
                                      "segmentation slice")
        if init_values is not None:
            raise NotImplementedError("LayerScale comes with a later slice")
        if qv_bias_only:
            raise NotImplementedError("BEiT q/v biases come with the "
                                      "segmentation slice")
        if quant not in ("none", "int8", "int8_attn"):
            raise ValueError(f"quant={quant!r}: none, int8 or int8_attn")
        self.quant = quant
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.select = select
        self.tuning, self.select_cfg = tuning, select_cfg
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, generator, qkv_bias=qkv_bias,
                              attn_drop=attn_drop, dtype=dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), generator,
                       gelu_approx=gelu_approx, dtype=dtype)
        if select:
            self.mlp_token_select = TokenSelect(
                dim, generator, threshold=select_cfg.threshold)
        if tuning.ffn_adapt:
            self.adaptmlp = Adapter(tuning, dim, generator, dtype=dtype)

    def _mlp_rows(self, rows: torch.Tensor) -> torch.Tensor:
        if self.quant != "none":
            return qt.q8_ln_mlp(rows, self.norm2.weight.detach(),
                                self.norm2.bias.detach(),
                                *self.mlp.q8_weights(),
                                gelu_approx=self.mlp.gelu == "tanh")
        return self.mlp(_layer_norm(rows, self.norm2).to(self.dtype))

    def forward(self, x: torch.Tensor, complete_model: bool = False,
                dispatch: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                           Optional[torch.Tensor]]:
        B, N, C = x.shape
        fuse = (_attention_fusable(self.attn_drop, self.num_heads,
                                   C // self.num_heads) and N <= 512)
        with_select = self.select and not complete_model
        thr = self.select_cfg.threshold
        gate = logits = adapt_x = None
        # int8: K6/K5 for the sublayer where the kernels apply, K4 for the
        # MLP always -- on CUDA tensors the kernels run or raise, never bf16
        q8 = self.quant != "none"
        attn_q8 = self.quant == "int8_attn"

        if fuse:
            attn_w = (self.attn.q8_weights() if q8
                      else self.attn.kernel_weights())
            g1, b1 = self.norm1.weight.detach(), self.norm1.bias.detach()
        if fuse and self.tuning.ffn_adapt:
            head = self.mlp_token_select.mlp_head if with_select else None
            sel_w = ((head.weight.detach(), head.bias.detach())
                     if head is not None else (None, None))
            if q8:
                outs = qt.dyt_prologue_serving_q8(
                    x, g1, b1, *attn_w, *self.adaptmlp.kernel_weights(),
                    *sel_w, heads=self.num_heads, with_select=with_select,
                    attn_q8=attn_q8)
            else:
                outs = ms.dyt_prologue_serving(
                    x, g1, b1, *attn_w, *self.adaptmlp.kernel_weights(),
                    *sel_w, heads=self.num_heads, with_select=with_select)
            if with_select:
                x, adapt_x, sel = outs
                logits = sel[:, 1:, :]                  # strip the CLS row
                gate = gate_with_cls(logits, thr)
            else:
                x, adapt_x = outs
        else:
            if fuse and q8:
                x = qt.attention_sublayer_serving_q8(
                    x, g1, b1, *attn_w, heads=self.num_heads,
                    attn_q8=attn_q8)
            elif fuse:
                x = ms.attention_sublayer_serving(x, g1, b1, *attn_w,
                                                  heads=self.num_heads)
            else:
                h = self.attn(_layer_norm(x, self.norm1).to(self.dtype))
                x = x + self.drop_path(h)
            if with_select:
                gate, logits = self.mlp_token_select(x)
            if self.tuning.ffn_adapt:
                adapt_x = self.adaptmlp(x.to(self.dtype))

        if dispatch and gate is not None:
            ratio = (self.select_cfg.capacity_ratio
                     if self.select_cfg.capacity_ratio is not None
                     else self.select_cfg.token_target_ratio)
            K = D.capacity_for(N - 1, ratio)
            scores = torch.cat(
                [torch.full((B, 1), math.inf, dtype=torch.float32,
                            device=x.device),
                 torch.sigmoid(logits[..., 0].float())], dim=1)
            mlp_x, eff_gate = D.dispatch_mlp(x, scores, K, self._mlp_rows,
                                             thr)
            # the gate actually applied, fp32 for keep-ratio accounting
            gate = eff_gate[..., None].float()
        else:
            mlp_x = self.drop_path(self._mlp_rows(x))
            if gate is not None:
                mlp_x = gate.to(mlp_x.dtype) * mlp_x

        x = x + mlp_x.to(x.dtype)
        if adapt_x is not None:
            x = x + adapt_x.to(x.dtype)
        return x, gate, logits
