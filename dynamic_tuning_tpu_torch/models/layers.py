"""DyT layers in PyTorch (counterpart of dynamic_tuning_tpu/models/layers.py):
Mlp, Attention (with the windowed relative-position bias of the segmentation
backbone), Adapter, MoEAdapter, TokenSelect, DropPath and Block, serving
forms.

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
parameters.  A block with ``moe_experts > 1`` takes the MoE prologues
instead of K3/K6: K7 (bf16) or K8 (int8).  A block with ``window_size``
(the segmentation backbone) runs the module path, as the JAX Block does,
and its Attention takes K9 (``ms.mha_windowed_fused``) where the JAX
Attention would.  So does a block with LayerScale (``init_values``, the
parameters ``gamma_1``/``gamma_2``) or BEiT q/v biases (``qv_bias_only``,
the parameters ``attn.q_bias``/``attn.v_bias``), whose Attention takes K1
(``ms.mha_serving_fused``) with no window at N <= 512.  Training and the
adapter's in/out LayerNorm belong to later slices and raise
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

    def cached(self, params, tag, make):
        """``make(*params)`` (detached), made again when any of ``params``
        (a tensor or a tuple of them) has changed."""
        params = params if isinstance(params, tuple) else (params,)
        key = (tuple(map(id, params)), tag)
        stamp = tuple((p.data_ptr(), p._version, p.device) for p in params)
        hit = self._entries.get(key)
        if hit is None or hit[0] != stamp:
            with torch.inference_mode(False), torch.no_grad():
                hit = (stamp, make(*(p.detach() for p in params)))
            self._entries[key] = hit
        return hit[1]

    def get(self, p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if p.dtype == dtype:
            return p.detach()
        return self.cached(p, dtype, lambda t: t.to(dtype).contiguous())

    def int8(self, p: torch.Tensor, quantize=qt.quantize_weight):
        """(int8 codes, fp32 per-channel scales) of the fp32 master weight
        ``p`` -- never of a rounded copy, whose codes differ."""
        return self.cached(p, ("int8", quantize), quantize)


def _dense(x: torch.Tensor, lin: nn.Linear, cache: _WeightCache,
           dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: the product rounded to ``dtype``, then
    the bias rounded to ``dtype`` added -- two roundings, where
    ``F.linear`` with a bias rounds once (the same arithmetic in fp32)."""
    y = F.linear(x.to(dtype), cache.get(lin.weight, dtype))
    return y if lin.bias is None else y + cache.get(lin.bias, dtype)


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
        h = _dense(x, self.fc1, self._w, self.dtype)
        h = F.gelu(h, approximate=self.gelu)
        return _dense(h, self.fc2, self._w, self.dtype)


# --- relative-position bias (the segmentation backbone) ----------------------

def _relative_position_index(wh: int, ww: int):
    """BEiT-style relative-position index over a (wh, ww) grid + CLS: an
    int32 [n+1, n+1] index (n = wh * ww) into a bias table of size
    (2wh-1)(2ww-1)+3, whose last 3 slots are cls->cls, cls->token and
    token->cls.  Returns (index, table size)."""
    n = wh * ww
    coords = torch.stack(torch.meshgrid(torch.arange(wh), torch.arange(ww),
                                        indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    num_rel = (2 * wh - 1) * (2 * ww - 1)
    idx = torch.zeros((n + 1, n + 1), dtype=torch.int64)
    idx[1:, 1:] = (rel[..., 0] + wh - 1) * (2 * ww - 1) + rel[..., 1] + ww - 1
    idx[0, 0:] = num_rel + 1          # cls -> token
    idx[0:, 0] = num_rel + 2          # token -> cls
    idx[0, 0] = num_rel               # cls -> cls
    return idx.to(torch.int32), num_rel + 3


def _rel_pos_table_size(wh: int, ww: int) -> int:
    """Bias-table length for ``_relative_position_index``: (2wh-1)(2ww-1)
    relative offsets + 3 CLS slots."""
    return (2 * wh - 1) * (2 * ww - 1) + 3


_REL_POS_INDEX = {}


def _rel_pos_gather_index(wh: int, ww: int, row_stride: int,
                          device) -> torch.Tensor:
    """Flat int32 gather index [N * row_stride] (N = wh*ww + 1): row i
    holds ``_relative_position_index`` row i, then ``row_stride - N`` pad
    entries pointing at slot 0.  Cached per (grid, stride, device)."""
    key = (wh, ww, row_stride, str(device))
    idx = _REL_POS_INDEX.get(key)
    if idx is None:
        rel, _ = _relative_position_index(wh, ww)
        N = rel.shape[0]
        padded = torch.zeros((N, row_stride), dtype=torch.int32)
        padded[:, :N] = rel
        idx = padded.reshape(-1).to(device)
        _REL_POS_INDEX[key] = idx
    return idx


def _rel_pos_bias_from_table(table: torch.Tensor, wh: int, ww: int, *,
                             row_stride: Optional[int] = None
                             ) -> torch.Tensor:
    """[table_size, H] -> [H, N, N] bias with ``bias[h, i, j] =
    table[index[i, j], h]``: one gather through a cached index (the JAX
    package's Kronecker form exists because XLA gathers are slow; the
    values are the same).  With ``row_stride`` the bias is a view of an
    [H, N, row_stride] buffer whose rows are padded (K9 reads 16-byte
    rows)."""
    N = wh * ww + 1
    ld = N if row_stride is None else row_stride
    idx = _rel_pos_gather_index(wh, ww, ld, table.device)
    flat = torch.index_select(table.t(), 1, idx)          # [H, N * ld]
    return flat.view(table.shape[1], N, ld)[:, :, :N]


class Attention(nn.Module):
    """Multi-head self-attention, on the JAX Attention's branches: with no
    window, K1 (``ms.mha_serving_fused``) where the fused-kernel predicate
    holds and N <= 512; otherwise the unfused branch, the serving clamp form
    when there is no attention dropout, else the max-subtracted softmax.

    ``window_size=(wh, ww)`` adds the learnable BEiT-style relative-position
    bias over the patch grid + CLS (the fp32 parameter
    ``relative_position_bias_table`` [(2wh-1)(2ww-1)+3, H]).  Where the JAX
    Attention takes its windowed kernel (the fused-kernel predicate and
    N = wh*ww + 1) this one takes K9, with the table rounded to bf16 before
    the bias is built; otherwise the unfused branch adds the fp32 bias.

    ``qv_bias_only`` (BEiT): the qkv projection has no bias; fp32 ``q_bias``
    and ``v_bias`` [C] (zeros at init), with k's fixed at zero, are rounded
    to the compute dtype and added to the rounded qkv."""

    def __init__(self, dim: int, num_heads: int, generator: torch.Generator,
                 *, qkv_bias: bool = True, attn_drop: float = 0.0,
                 window_size: Optional[Tuple[int, int]] = None,
                 qv_bias_only: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.qkv = _linear(dim, 3 * dim, generator,
                           bias=qkv_bias and not qv_bias_only)
        if qkv_bias and qv_bias_only:
            self.q_bias = nn.Parameter(torch.zeros(dim))
            self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = _linear(dim, dim, generator)
        self.window_size = (None if window_size is None
                            else tuple(window_size))
        if window_size is not None:
            # zeros, as the JAX module initialises it
            self.relative_position_bias_table = nn.Parameter(torch.zeros(
                _rel_pos_table_size(*window_size), num_heads))
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
        return _dense(x, lin, self._w, self.dtype)

    def _bias(self, dtype, row_stride=None) -> torch.Tensor:
        return _rel_pos_bias_from_table(
            self._w.get(self.relative_position_bias_table, dtype),
            *self.window_size, row_stride=row_stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        hd = C // self.num_heads
        dt = self.dtype
        qkv = self._dense(x, self.qkv)
        if hasattr(self, "q_bias"):
            # two roundings, as the JAX module: the Dense output, then the
            # add of the bias rounded to the compute dtype
            qkv = qkv + torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                                   self.v_bias]).to(dt)
        win = self.window_size
        fusable = _attention_fusable(self.attn_drop, self.num_heads, hd)
        if fusable and win is None and N <= 512:
            out = ms.mha_serving_fused(qkv, heads=self.num_heads)      # K1
            return self._dense(out, self.proj)
        if fusable and win is not None and win[0] * win[1] + 1 == N:
            # K9; the bias is built from the bf16-rounded table, with rows
            # padded for the kernel's 16-byte reads
            bias = self._bias(torch.bfloat16, ms.bias_row_stride(N))
            out = ms.mha_windowed_fused(qkv, bias, heads=self.num_heads)
            return self._dense(out, self.proj)
        q, k, v = qkv.reshape(B, N, 3, self.num_heads, hd).permute(
            2, 0, 3, 1, 4)
        # q times the scale rounded to q's dtype, as XLA applies the JAX
        # module's Python-float scale
        s = torch.matmul((q * ms.weak_scale(q, hd)).float(),
                         k.float().transpose(-1, -2))
        if win is not None:
            s = s + self._bias(torch.float32)
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


def _adapter_scale(module: nn.Module, cfg: TuningConfig) -> None:
    """The adapter's scale: a learnable fp32 [1] parameter ``scale`` or a
    fixed buffer."""
    if cfg.ffn_adapter_scalar == "learnable_scalar":
        module.scale = nn.Parameter(torch.ones(1))
    else:
        module.register_buffer(
            "_scale", torch.full((1,), float(cfg.ffn_adapter_scalar)),
            persistent=False)


class Adapter(nn.Module):
    """AdaptFormer parallel bottleneck: down -> ReLU -> up -> * scale."""

    def __init__(self, cfg: TuningConfig, dim: int,
                 generator: torch.Generator, *, dtype=torch.bfloat16):
        super().__init__()
        lora = cfg.ffn_adapter_init_option == "lora"
        self.down_proj = _linear(dim, cfg.ffn_num, generator,
                                 init=kaiming_uniform_lora if lora
                                 else trunc_normal_02)
        self.up_proj = _linear(cfg.ffn_num, dim, generator)
        if lora:
            with torch.no_grad():
                self.up_proj.weight.zero_()
        _adapter_scale(self, cfg)
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
        down = _dense(x, self.down_proj, self._w, self.dtype)
        up = _dense(torch.relu(down), self.up_proj, self._w, self.dtype)
        return up * self.scale_tensor().to(up.dtype)


class MoEAdapter(nn.Module):
    """MoE-enhanced adapter: E parallel bottleneck experts blended per token
    by a softmax router (the JAX package's MoEAdapter, a paper feature).

    Parameters mirror the flax tree: ``router.weight`` [E, C] (no bias),
    ``down_kernel`` [E, C, b], ``down_bias`` [E, b], ``up_kernel`` [E, b, C],
    ``up_bias`` [E, C] and, when learnable, ``scale``.  Init as the JAX
    module: router zeros, each expert's down kernel kaiming-uniform (bound
    1/sqrt(C)), up kernel and biases zeros.

    ``forward`` is the module path (blocks the fused kernels do not take),
    with the JAX module's own rounding: an fp32 router on fp32 x, bf16
    expert products with bf16 biases, a bf16 blend with bf16 gates.  The
    fused path (K7/K8) takes ``kernel_weights`` instead."""

    def __init__(self, cfg: TuningConfig, dim: int,
                 generator: torch.Generator, *, dtype=torch.bfloat16):
        super().__init__()
        E, b = cfg.moe_experts, cfg.ffn_num
        self.experts, self.bneck, self.tau = E, b, cfg.moe_router_tau
        self.router = _linear(dim, E, generator, bias=False,
                              init=lambda t, g: t.zero_())
        self.down_kernel = nn.Parameter(torch.empty(E, dim, b))
        with torch.no_grad():
            bound = 1.0 / math.sqrt(dim)
            for e in range(E):
                self.down_kernel[e].uniform_(-bound, bound,
                                             generator=generator)
        self.down_bias = nn.Parameter(torch.zeros(E, b))
        self.up_kernel = nn.Parameter(torch.zeros(E, b, dim))
        self.up_bias = nn.Parameter(torch.zeros(E, dim))
        _adapter_scale(self, cfg)
        self.dtype = dtype
        self._w = _WeightCache()

    scale_tensor = Adapter.scale_tensor

    def kernel_weights(self):
        """(wrouter fp32 [E, C], wdown2d [E*b, C], bdown2d fp32 [E*b],
        wup2d [C, E*b], bup fp32 [E, C], scale fp32 [1]) for K7/K8, the
        expert stacks laid out once per load (``ms.moe_kernel_weights``)."""
        down, bdown, up = self._w.cached(
            (self.down_kernel, self.down_bias, self.up_kernel),
            ("moe", self.dtype),
            lambda d, bd, u: ms.moe_kernel_weights(d, bd, u, self.dtype))
        return (self.router.weight.detach(), down, bdown, up,
                self.up_bias.detach(), self.scale_tensor())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, dt = self._w.get, self.dtype
        gates = torch.softmax(F.linear(x.float(), self.router.weight)
                              / self.tau, dim=-1)               # [..., E]
        h = torch.einsum("...d,edb->...eb", x.to(dt),
                         w(self.down_kernel, dt)) + w(self.down_bias, dt)
        up = torch.einsum("...eb,ebd->...ed", torch.relu(h),
                          w(self.up_kernel, dt)) + w(self.up_bias, dt)
        out = torch.einsum("...ed,...e->...d", up, gates.to(dt))
        return out * self.scale_tensor().to(out.dtype)


def make_adapter(cfg: TuningConfig, dim: int, generator: torch.Generator, *,
                 dtype=torch.bfloat16) -> nn.Module:
    """The block's adapter: ``MoEAdapter`` when ``moe_experts > 1``, else
    ``Adapter``."""
    if cfg.ffn_adapter_layernorm_option != "none":
        raise NotImplementedError("adapter in/out LayerNorm comes with a "
                                  "later slice")
    if cfg.moe_experts and cfg.moe_experts > 1:
        return MoEAdapter(cfg, dim, generator, dtype=dtype)
    return Adapter(cfg, dim, generator, dtype=dtype)


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
        if quant not in ("none", "int8", "int8_attn"):
            raise ValueError(f"quant={quant!r}: none, int8 or int8_attn")
        self.quant = quant
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.select = select
        self.tuning, self.select_cfg = tuning, select_cfg
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.window_size = window_size
        self.attn = Attention(dim, num_heads, generator, qkv_bias=qkv_bias,
                              attn_drop=attn_drop, window_size=window_size,
                              qv_bias_only=qv_bias_only, dtype=dtype)
        # LayerScale (BEiT): fp32 [C], constant init_values at init
        self.init_values, self.qv_bias_only = init_values, qv_bias_only
        if init_values is not None:
            self.gamma_1 = nn.Parameter(torch.full((dim,), init_values))
            self.gamma_2 = nn.Parameter(torch.full((dim,), init_values))
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), generator,
                       gelu_approx=gelu_approx, dtype=dtype)
        if select:
            self.mlp_token_select = TokenSelect(
                dim, generator, threshold=select_cfg.threshold)
        if tuning.ffn_adapt:
            self.adaptmlp = make_adapter(tuning, dim, generator, dtype=dtype)

    def _layer_scale(self, gamma: str, x: torch.Tensor) -> torch.Tensor:
        """``x * gamma`` with gamma rounded to x's dtype first; x without
        LayerScale."""
        if self.init_values is None:
            return x
        return x * getattr(self, gamma).to(x.dtype)

    def _mlp_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """LN + MLP of ``rows`` (K4 with int8), LayerScale'd: the JAX
        Block's ``mlp_rows``, before any gate."""
        if self.quant != "none":
            out = qt.q8_ln_mlp(rows, self.norm2.weight.detach(),
                               self.norm2.bias.detach(),
                               *self.mlp.q8_weights(),
                               gelu_approx=self.mlp.gelu == "tanh")
        else:
            out = self.mlp(_layer_norm(rows, self.norm2).to(self.dtype))
        return self._layer_scale("gamma_2", out)

    def forward(self, x: torch.Tensor, complete_model: bool = False,
                dispatch: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                           Optional[torch.Tensor]]:
        B, N, C = x.shape
        # a windowed block never fuses its sublayer (its Attention takes
        # K9), nor does one with LayerScale or q/v biases (its Attention
        # takes K1)
        fuse = (_attention_fusable(self.attn_drop, self.num_heads,
                                   C // self.num_heads) and N <= 512
                and self.window_size is None and self.init_values is None
                and not self.qv_bias_only)
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
            # K3/K6 for the adapter, K7/K8 for the MoE adapter
            adapter_w = self.adaptmlp.kernel_weights()
            moe = isinstance(self.adaptmlp, MoEAdapter)
            if moe and q8:
                outs = qt.dyt_prologue_serving_q8_moe(
                    x, g1, b1, *attn_w, *adapter_w, *sel_w,
                    heads=self.num_heads, tau=self.adaptmlp.tau,
                    with_select=with_select, attn_q8=attn_q8)
            elif moe:
                outs = ms.dyt_prologue_serving_moe(
                    x, g1, b1, *attn_w, *adapter_w, *sel_w,
                    heads=self.num_heads, tau=self.adaptmlp.tau,
                    with_select=with_select)
            elif q8:
                outs = qt.dyt_prologue_serving_q8(
                    x, g1, b1, *attn_w, *adapter_w, *sel_w,
                    heads=self.num_heads, with_select=with_select,
                    attn_q8=attn_q8)
            else:
                outs = ms.dyt_prologue_serving(
                    x, g1, b1, *attn_w, *adapter_w, *sel_w,
                    heads=self.num_heads, with_select=with_select)
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
                x = x + self.drop_path(self._layer_scale("gamma_1", h))
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
