"""The port's MoE-adapter serving path against the JAX package's, on the CPU.

* the MoE tail's plain version against the TPU kernels' shared tail
  ``moe_adapter_rows``, called directly on jnp arrays;
* K7 ``dyt_prologue_serving_moe`` and K8 ``dyt_prologue_serving_q8_moe``
  against the JAX ops in interpret mode (``interpret=True``);
* the ``MoEAdapter`` module (the module path) against the JAX module;
* whole MoE ViTs against the JAX model (``DYT_FUSED_ATTN=interpret``, or
  JAX on the CPU takes its unfused branch) in mask, dispatch and
  complete_model, bf16 and int8, and on the module path at head_dim 32;
* the weight bridge on an MoE tree, the synthetic MoE state dict and the
  speed entry point's wiring.

The port's wrappers take their plain versions for CPU tensors.  Inputs are
made with numpy from a seed and handed to both sides.  The router and up
kernels start at zero, which would make the gates uniform and the mixture
zero and hide every bug in it: every MoE param tree is perturbed off its
init before a comparison (as tests/test_mha_serving.py does).

Tolerances.  fp32: the two sides round at the same points and differ in the
order of fp32 sums only (the port sums in float64): the tail to 1e-6 of its
largest magnitude, the prologues and models to 1e-5 as the dense-adapter
tests.  bf16: a value near a bf16 rounding boundary may round the other way,
two bf16 ulps (2 * 2**-8) of the largest magnitude.  int8: as
tests/test_torch_port_quant.py (1e-4 of the largest magnitude in fp32) and
the int8 model test of tests/test_torch_port_model.py (1e-2, identical
gates).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_tuning_tpu.config import ModelConfig, SelectConfig, TuningConfig
from dynamic_tuning_tpu.models.layers import MoEAdapter as JaxMoEAdapter
from dynamic_tuning_tpu.models.vit import VisionTransformer as JaxViT
from dynamic_tuning_tpu.ops import mha_serving as jms
from dynamic_tuning_tpu.ops import quant as jq
from dynamic_tuning_tpu.train.checkpoint import (export_torch_state_dict,
                                                 import_pretrained)
from dynamic_tuning_tpu_torch import config as tcfg
from dynamic_tuning_tpu_torch import speed
from dynamic_tuning_tpu_torch.checkpoint import (from_flax_params,
                                                 load_timm_state_dict,
                                                 make_vit_state_dict)
from dynamic_tuning_tpu_torch.models.layers import (Adapter, MoEAdapter,
                                                     make_adapter)
from dynamic_tuning_tpu_torch.models.vit import VisionTransformer
from dynamic_tuning_tpu_torch.ops import mha_serving as tms
from dynamic_tuning_tpu_torch.ops import quant as tq
from torch_oracle import make_vit_state_dict as oracle_state_dict

B, N, C, H = 2, 19, 128, 2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
WIDTHS = [(2, 8), (2, 16), (4, 8), (4, 16)]          # (experts, bottleneck)
TAUS = [1.0, 0.7]           # 0.7: multiplying by fp32(1/tau) != dividing


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype, fp32_rel):
    """Within ``fp32_rel`` (fp32) or two bf16 ulps (bf16) of the largest
    magnitude of ``want``."""
    rel = fp32_rel if dtype == "float32" else 2 * 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _moe(rs, E, b):
    """MoE weights in the flax layout: router logits of order 1, so the
    gates differ per token."""
    f = lambda *s, sc: (rs.randn(*s) * sc).astype(np.float32)
    return dict(wr=f(C, E, sc=2.0 / np.sqrt(C)), dk=f(E, C, b, sc=0.05),
                db=f(E, b, sc=0.05), uk=f(E, b, C, sc=0.05),
                ub=f(E, C, sc=0.05), asc=np.array([0.1], np.float32))


def _jmoe(m, jdt):
    """moe_adapter_rows' refs: wr [C, E], down2d [C, E*b] and up2d [E*b, C]
    in ``jdt``, bd [1, E*b], bu [E, C], scale [1, 1]."""
    E, _, b = m["dk"].shape
    down2d = jnp.asarray(m["dk"]).transpose(1, 0, 2).reshape(C, E * b)
    up2d = jnp.asarray(m["uk"]).reshape(E * b, C)
    return (jnp.asarray(m["wr"]), down2d.astype(jdt),
            jnp.asarray(m["db"]).reshape(1, E * b), up2d.astype(jdt),
            jnp.asarray(m["ub"]), jnp.asarray(m["asc"]).reshape(1, 1))


def _tmoe(m, tdt):
    """The port's expert arguments: (wrouter, wdown2d, bdown2d, wup2d, bup,
    adapter_scale)."""
    return (_t(m["wr"].T), *tms.moe_kernel_weights(_t(m["dk"]), _t(m["db"]),
                                                   _t(m["uk"]), tdt),
            _t(m["ub"]), _t(m["asc"]))


def _weights(seed):
    rs = np.random.RandomState(seed)
    f = lambda *s, sc=1.0: (rs.randn(*s) * sc).astype(np.float32)
    return rs, dict(x=f(B, N, C), g=1 + f(C, sc=0.1), b=f(C, sc=0.1),
                    wqkv=f(C, 3 * C, sc=0.05), bqkv=f(3 * C, sc=0.05),
                    wproj=f(C, C, sc=0.05), bproj=f(C, sc=0.05),
                    wsel=f(C, 1, sc=0.1), bsel=f(1, sc=0.1))


# --- the MoE tail --------------------------------------------------------------

@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("E,b", WIDTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_tail_matches_jax_moe_adapter_rows(dtype, E, b, tau):
    jdt, tdt = DTYPES[dtype]
    rs = np.random.RandomState(E * 100 + b)
    xm = (rs.randn(B * N, C) * 2).astype(np.float32)
    m = _moe(rs, E, b)
    want = jms.moe_adapter_rows(jnp.asarray(xm), *_jmoe(m, jdt), experts=E,
                                bneck=b, tau=tau)
    x_mid, got = tms.moe_adapter_router_plain(
        _t(xm), tdt, *_tmoe(m, tdt), None, None, experts=E, bneck=b,
        tau=tau, with_select=False)
    assert got.dtype == tdt and got.shape == (B * N, C)
    assert torch.equal(x_mid, _t(xm).to(tdt))
    _close(got, _np(want.astype(jdt)), dtype, 1e-6)


def test_moe_kernel_weights_layout():
    """Row e*b+j of wdown2d is expert e's down column j; column e*b+j of
    wup2d is expert e's up row j (the TPU kernel's lane-concatenated
    down2d and stacked up2d, in torch's [out, in] layout)."""
    m = _moe(np.random.RandomState(1), 3, 16)
    wd, bd, wu = tms.moe_kernel_weights(_t(m["dk"]), _t(m["db"]),
                                        _t(m["uk"]), torch.float32)
    assert wd.shape == (48, C) and bd.shape == (48,) and wu.shape == (C, 48)
    for e in range(3):
        for j in (0, 7, 15):
            assert torch.equal(wd[e * 16 + j], _t(m["dk"][e, :, j]))
            assert torch.equal(wu[:, e * 16 + j], _t(m["uk"][e, j]))
            assert bd[e * 16 + j] == float(m["db"][e, j])


def test_moe_tail_gates_are_a_softmax_over_experts():
    """No bottleneck activation (relu(down + bd) = 0), expert e's up bias
    set to e + 1, scale 1: the adapter returns each row's gate-weighted mean
    of 1..E, which the router and tau alone decide."""
    E, b = 4, 8
    rs = np.random.RandomState(2)
    xm = rs.randn(6, C).astype(np.float32)
    m = _moe(rs, E, b)
    m["db"][:] = -1e3                      # relu(down + bd) = 0
    m["ub"][:] = np.arange(1, E + 1, dtype=np.float32)[:, None]
    m["asc"][:] = 1.0
    for tau in TAUS:
        r = (xm.astype(np.float64) @ m["wr"].astype(np.float64))
        r = r.astype(np.float32) * np.float32(1.0 / tau)
        g = np.exp(r - r.max(axis=1, keepdims=True))
        g /= g.sum(axis=1, keepdims=True)
        want = g @ np.arange(1, E + 1)
        _, got = tms.moe_adapter_router_plain(
            _t(xm), torch.float32, *_tmoe(m, torch.float32), None, None,
            experts=E, bneck=b, tau=tau, with_select=False)
        np.testing.assert_allclose(got.numpy(), np.repeat(want[:, None], C, 1),
                                   rtol=1e-6)


def test_moe_tail_rejects_mismatched_widths():
    m = _moe(np.random.RandomState(3), 4, 8)
    with pytest.raises(ValueError, match="experts"):
        tms.moe_adapter_router_plain(
            _t(np.zeros((2, C), np.float32)), torch.float32,
            *_tmoe(m, torch.float32), None, None, experts=4, bneck=16,
            tau=1.0, with_select=False)


# --- K7, K8 --------------------------------------------------------------------

def _jsub(w, jdt, cast=True):
    c = (lambda a: jnp.asarray(a).astype(jdt)) if cast else (lambda a: a)
    return (w["g"], w["b"], c(w["wqkv"]), w["bqkv"], c(w["wproj"]),
            w["bproj"])


def _tsub(w, tdt):
    c = lambda a: _t(a.T).to(tdt)
    return (_t(w["g"]), _t(w["b"]), c(w["wqkv"]), _t(w["bqkv"]),
            c(w["wproj"]), _t(w["bproj"]))


def _tsub_q8(w):
    wq, sq = tq.quantize_weight(_t(w["wqkv"].T))
    wp, sp = tq.quantize_weight(_t(w["wproj"].T))
    return (_t(w["g"]), _t(w["b"]), wq, sq, _t(w["bqkv"]), wp, sp,
            _t(w["bproj"]))


def _check_prologue(got, want, dtype, with_select, fp32_rel):
    assert len(got) == len(want) == (3 if with_select else 2)
    assert got[0].shape == got[1].shape == (B, N, C)
    _close(got[0], _np(want[0]), dtype, fp32_rel)
    _close(got[1], _np(want[1]), dtype, fp32_rel)
    if with_select:
        # router logits are fp32 from the fp32 x_mid on both sides
        assert got[2].dtype == torch.float32 and got[2].shape == (B, N, 1)
        _close(got[2], _np(want[2]), "float32", fp32_rel)


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("with_select", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dyt_prologue_moe_matches_jax_kernel(dtype, with_select, tau):
    jdt, tdt = DTYPES[dtype]
    rs, w = _weights(10)
    m = _moe(rs, 4, 16)
    want = jms.dyt_prologue_serving_moe(
        jnp.asarray(w["x"]).astype(jdt), *_jsub(w, jdt), m["wr"], m["dk"],
        m["db"], m["uk"], m["ub"], m["asc"], w["wsel"], w["bsel"], heads=H,
        tau=tau, with_select=with_select, interpret=True)
    got = tms.dyt_prologue_serving_moe(
        _t(w["x"]).to(tdt), *_tsub(w, tdt), *_tmoe(m, tdt), _t(w["wsel"].T),
        _t(w["bsel"]), heads=H, tau=tau, with_select=with_select)
    assert got[0].dtype == got[1].dtype == tdt
    _check_prologue(got, want, dtype, with_select, 1e-5)


@pytest.mark.parametrize("attn_q8", [False, True], ids=["core", "int8_attn"])
@pytest.mark.parametrize("with_select", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dyt_prologue_q8_moe_matches_jax_kernel(dtype, with_select, attn_q8):
    jdt, tdt = DTYPES[dtype]
    rs, w = _weights(11)
    m = _moe(rs, 4, 16)
    c = lambda a: jnp.asarray(a).astype(jdt)
    # the JAX Block hands K8 its expert stacks in the compute dtype
    want = jq.dyt_prologue_serving_q8_moe(
        c(w["x"]), *_jsub(w, jdt, cast=False), m["wr"], c(m["dk"]), m["db"],
        c(m["uk"]), m["ub"], m["asc"], w["wsel"], w["bsel"], heads=H,
        tau=0.7, with_select=with_select, attn_q8=attn_q8, interpret=True)
    got = tq.dyt_prologue_serving_q8_moe(
        _t(w["x"]).to(tdt), *_tsub_q8(w), *_tmoe(m, tdt), _t(w["wsel"].T),
        _t(w["bsel"]), heads=H, tau=0.7, with_select=with_select,
        attn_q8=attn_q8)
    _check_prologue(got, want, dtype, with_select, 1e-4)


def test_moe_wrappers_refuse_other_devices():
    """A non-CPU tensor never reaches the plain version."""
    rs, w = _weights(12)
    m = _moe(rs, 4, 16)
    meta = _t(w["x"]).to("meta")
    sel = (_t(w["wsel"].T), _t(w["bsel"]))
    with pytest.raises(ValueError, match="CPU tensors"):
        tms.dyt_prologue_serving_moe(meta, *_tsub(w, torch.bfloat16),
                                     *_tmoe(m, torch.bfloat16), *sel,
                                     heads=H, tau=1.0)
    with pytest.raises(ValueError, match="CPU tensors"):
        tq.dyt_prologue_serving_q8_moe(meta, *_tsub_q8(w),
                                       *_tmoe(m, torch.bfloat16), *sel,
                                       heads=H, tau=1.0)


# --- the MoEAdapter module -----------------------------------------------------

def _perturb(tree, rs, scale=0.05):
    """Every leaf moved off its init by ``scale`` * N(0, 1) (numpy seeded)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return jax.tree_util.tree_unflatten(treedef, [
        l + (scale * rs.randn(*l.shape)).astype(np.float32) for l in leaves])


def port_cfg(cfg):
    """The port's own config object with the fields of a JAX-package one."""
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("scalar", ["0.1", "learnable_scalar"])
@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_adapter_module_matches_jax(dtype, tau, scalar):
    """The module path: fp32 router on fp32 x, expert products and blend in
    the compute dtype, as the JAX module."""
    jdt, tdt = DTYPES[dtype]
    cfg = TuningConfig(ffn_num=8, d_model=C, moe_experts=4,
                       moe_router_tau=tau, ffn_adapter_scalar=scalar)
    rs = np.random.RandomState(20)
    x = (rs.randn(B, N, C) * 2).astype(np.float32)
    jmod = JaxMoEAdapter(cfg, dtype=jdt)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = _perturb(params, rs)
    want = jmod.apply({"params": params}, jnp.asarray(x).astype(jdt))
    tmod = MoEAdapter(port_cfg(cfg), C, torch.Generator().manual_seed(0),
                      dtype=tdt)
    sd = {"router.weight": _t(np.array(params["router"]["kernel"]).T)}
    sd.update({k: _t(np.array(params[k])) for k in
               ("down_kernel", "down_bias", "up_kernel", "up_bias")})
    if scalar == "learnable_scalar":
        sd["scale"] = _t(np.array(params["scale"]))
    tmod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tmod(_t(x).to(tdt))
    assert got.dtype == tdt and got.shape == (B, N, C)
    _close(got, _np(want), dtype, 1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_moe_adapter_module_bf16_adds_biases_after_rounding(seed):
    """MoEAdapter's module path in bf16 with nonzero down/up biases (~0.1):
    like flax, it adds each bias rounded to bf16 to the einsum's bf16
    product (two roundings, as flax's Dense does).  All outputs within one
    bf16 ulp of the largest, at most a tenth further than 1e-5 of it (met
    over 4 seeds; an einsum that took its bias into the fp32 sum moves
    40-44% past 1e-5)."""
    cfg = TuningConfig(ffn_num=8, d_model=C, moe_experts=4)
    rs = np.random.RandomState(30 + seed)
    x = rs.randn(B, N, C).astype(np.float32)
    jmod = JaxMoEAdapter(cfg, dtype=jnp.bfloat16)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + ((0.1 if "bias" in jax.tree_util.keystr(p) else 0.05)
                          * rs.randn(*a.shape)).astype(np.float32), params)
    want = _np(jmod.apply({"params": params},
                          jnp.asarray(x).astype(jnp.bfloat16)))
    tmod = MoEAdapter(port_cfg(cfg), C, torch.Generator(),
                      dtype=torch.bfloat16)
    sd = {"router.weight": _t(np.array(params["router"]["kernel"]).T)}
    sd.update({k: _t(np.array(params[k])) for k in
               ("down_kernel", "down_bias", "up_kernel", "up_bias")})
    tmod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tmod(_t(x).to(torch.bfloat16)).float().numpy()
    err, scale = np.abs(got - want), np.abs(want).max()
    assert err.max() <= 2.0 ** -7 * scale
    assert (err > 1e-5 * scale).mean() <= 0.1, (err > 1e-5 * scale).mean()


def test_moe_adapter_init_matches_jax():
    """Router, up kernel and biases zero; each expert's down kernel uniform
    in +-1/sqrt(C); the scale a buffer or a learnable 1."""
    cfg = tcfg.TuningConfig(ffn_num=16, moe_experts=4)
    mod = make_adapter(cfg, 512, torch.Generator().manual_seed(0))
    assert isinstance(mod, MoEAdapter)
    assert mod.router.weight.shape == (4, 512) and mod.router.bias is None
    for p in (mod.router.weight, mod.down_bias, mod.up_kernel, mod.up_bias):
        assert not p.any()
    dk = mod.down_kernel
    assert dk.shape == (4, 512, 16)
    assert dk.abs().max() <= 512 ** -0.5 and dk.abs().max() > 0.9 * 512 ** -0.5
    assert not torch.equal(dk[0], dk[1])
    assert float(mod.scale_tensor()) == pytest.approx(0.1)
    learn = make_adapter(dataclasses.replace(
        cfg, ffn_adapter_scalar="learnable_scalar"), 512,
        torch.Generator().manual_seed(0))
    assert isinstance(learn.scale, torch.nn.Parameter)
    assert isinstance(make_adapter(tcfg.TuningConfig(moe_experts=1), 64,
                                   torch.Generator()), Adapter)
    with pytest.raises(NotImplementedError, match="LayerNorm"):
        make_adapter(dataclasses.replace(cfg,
                                         ffn_adapter_layernorm_option="in"),
                     64, torch.Generator())


# --- whole MoE ViTs ------------------------------------------------------------

DIM, DEPTH, HEADS, FFN, IMG, PATCH, CLASSES = 128, 2, 2, 8, 64, 16, 10
MODES = {"mask": {}, "dispatch": {"dispatch": True},
         "complete_model": {"complete_model": True}}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _Quiet:
    def info(self, *a):
        pass


def _perturb_adapters(params, rs):
    """Each block's MoE adapter moved off its init; the rest as imported."""
    return {k: ({**v, "adaptmlp": _perturb(v["adaptmlp"], rs)}
                if k.startswith("blocks_") else v)
            for k, v in params.items()}


def _pair(monkeypatch, dtype="float32", experts=4, tau=0.7, **model):
    """(jax model, jax params, port model, input) with identical weights:
    the oracle's state dict imported into the JAX tree, the MoE adapters
    perturbed, the tree carried to the port through the bridge."""
    monkeypatch.setenv("DYT_FUSED_ATTN", "interpret")
    model = {"num_heads": HEADS, **model}
    mc = ModelConfig(img_size=IMG, patch_size=PATCH, embed_dim=DIM,
                     depth=DEPTH, num_classes=CLASSES, residual_dtype=dtype,
                     **model)
    tuning = TuningConfig(ffn_num=FFN, d_model=DIM, moe_experts=experts,
                          moe_router_tau=tau)
    sel = SelectConfig(token_target_ratio=0.5)
    rs = np.random.RandomState(0)
    sd = oracle_state_dict(rs, depth=DEPTH, dim=DIM, ffn=FFN,
                           classes=CLASSES, img=IMG, patch=PATCH)
    x = rs.randn(3, IMG, IMG, 3).astype(np.float32)
    jm = JaxViT(mc, tuning=tuning, select=sel, dtype=JDT[dtype])
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]
    params, _ = import_pretrained(params, sd, logger=_Quiet())
    params = _perturb_adapters(params, rs)
    tm = VisionTransformer(port_cfg(mc), tuning=port_cfg(tuning),
                           select=port_cfg(sel), dtype=TDT[dtype])
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        from_flax_params(params).items()}, strict=True)
    assert all(isinstance(blk.adaptmlp, MoEAdapter) for blk in tm.blocks)
    return jm, params, tm, x


def _run_both(jm, params, tm, x, kwargs):
    jl, jaux = jm.apply({"params": params}, jnp.asarray(x), **kwargs)
    tl, taux = tm(torch.from_numpy(x), **kwargs)
    return jl, jaux, tl, taux


@pytest.mark.parametrize("mode", list(MODES))
def test_moe_model_matches_jax_fp32(monkeypatch, mode):
    """K7 in every block on both sides: logits to 1e-5, every gate
    identical."""
    jm, params, tm, x = _pair(monkeypatch)
    jl, jaux, tl, taux = _run_both(jm, params, tm, x, MODES[mode])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    if mode == "complete_model":
        assert taux["token_select"] is None and jaux["token_select"] is None
        return
    np.testing.assert_array_equal(taux["token_select"].numpy(),
                                  np.asarray(jaux["token_select"]))
    want_tok = np.asarray(jaux["token_logits"])
    np.testing.assert_allclose(taux["token_logits"].numpy(), want_tok,
                               rtol=0, atol=1e-5 * np.abs(want_tok).max())


def test_moe_model_experts_contribute(monkeypatch):
    """The experts contribute: the same model with its adapters' up kernels
    and biases zeroed gives other logits."""
    _, _, tm, x = _pair(monkeypatch)
    a = tm(torch.from_numpy(x))[0]
    with torch.no_grad():
        for blk in tm.blocks:
            blk.adaptmlp.up_kernel.zero_()
            blk.adaptmlp.up_bias.zero_()
    b = tm(torch.from_numpy(x))[0]
    assert (a - b).abs().max() > 1e-3 * b.abs().max()


def test_moe_model_matches_jax_bf16(monkeypatch):
    """bf16 compute and residual stream in dispatch mode, as the dense bf16
    model test: over 8 seeds the logits differ by 0.45-0.75% of their
    largest magnitude (with one rounding per Dense, 0.69-0.98% over 4);
    held to 1%, gates identical but where a router logit is within that
    noise of 0."""
    jm, params, tm, x = _pair(monkeypatch, dtype="bfloat16")
    jl, jaux, tl, taux = _run_both(jm, params, tm, x, MODES["dispatch"])
    want = np.asarray(jl.astype(jnp.float32))
    np.testing.assert_allclose(tl.float().numpy(), want, rtol=0,
                               atol=0.01 * np.abs(want).max())
    jl_tok = np.asarray(jaux["token_logits"])
    near = np.abs(jl_tok) < 0.05 * np.abs(jl_tok).max()
    same = taux["token_select"].numpy() == np.asarray(jaux["token_select"])
    assert (same | near).all()


@pytest.mark.parametrize("mode", ["dispatch", "mask", "complete_model"])
@pytest.mark.parametrize("quant", ["int8", "int8_attn"])
def test_moe_int8_model_matches_jax_fp32(monkeypatch, quant, mode):
    """K8 (with the K10 core under int8_attn) and K4 in every block, the
    int8 stem: as the dense int8 model test, 1e-2 of the largest logit and
    every gate identical."""
    jm, params, tm, x = _pair(monkeypatch, quant=quant)
    jl, jaux, tl, taux = _run_both(jm, params, tm, x, MODES[mode])
    want = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), want, rtol=0,
                               atol=1e-2 * np.abs(want).max())
    if mode != "complete_model":
        np.testing.assert_array_equal(taux["token_select"].numpy(),
                                      np.asarray(jaux["token_select"]))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("model", [dict(num_heads=4),
                                   dict(attn_drop_rate=0.1)],
                         ids=["head_dim_32", "attn_drop"])
def test_moe_module_path_matches_jax_fp32(monkeypatch, mode, model):
    """Blocks the fused kernels do not take run the module path with the
    MoEAdapter module, on both sides."""
    jm, params, tm, x = _pair(monkeypatch, **model)
    jl, jaux, tl, taux = _run_both(jm, params, tm, x, MODES[mode])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    if mode != "complete_model":
        np.testing.assert_array_equal(taux["token_select"].numpy(),
                                      np.asarray(jaux["token_select"]))


# --- weights -------------------------------------------------------------------

def _moe_params(**tuning):
    mc = ModelConfig(img_size=32, patch_size=16, embed_dim=DIM, depth=2,
                     num_heads=HEADS, num_classes=CLASSES)
    tuning = TuningConfig(ffn_num=FFN, d_model=DIM, moe_experts=4, **tuning)
    m = JaxViT(mc, tuning=tuning, select=SelectConfig(), dtype=jnp.float32)
    params = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    return mc, tuning, _perturb_adapters(params["params"],
                                         np.random.RandomState(5))


def test_moe_bridge_names_layouts_and_strict_load(tmp_path):
    """The router kernel crosses transposed ([C, E] -> [E, C]), the expert
    stacks in the flax layout; the port loads the whole tree strictly.  The
    JAX package's own .pth export has no names for these params."""
    mc, tuning, params = _moe_params()
    sd = from_flax_params(params)
    flax = params["blocks_1"]["adaptmlp"]
    p = "blocks.1.adaptmlp."
    np.testing.assert_array_equal(sd[p + "router.weight"],
                                  np.asarray(flax["router"]["kernel"]).T)
    assert sd[p + "router.weight"].shape == (4, DIM)
    for name, shape in (("down_kernel", (4, DIM, FFN)),
                        ("down_bias", (4, FFN)), ("up_kernel", (4, FFN, DIM)),
                        ("up_bias", (4, DIM))):
        assert sd[p + name].shape == shape, name
        np.testing.assert_array_equal(sd[p + name], np.asarray(flax[name]))
    assert not [k for k in sd if "down_proj" in k or "up_proj" in k]
    model = VisionTransformer(port_cfg(mc), tuning=port_cfg(tuning),
                              select=tcfg.SelectConfig(),
                              dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    assert torch.equal(model.blocks[1].adaptmlp.up_kernel,
                       torch.from_numpy(sd[p + "up_kernel"]))
    path = str(tmp_path / "export.pth")
    export_torch_state_dict(params, path)
    exported = torch.load(path, weights_only=False)["model"]
    assert not [k for k in exported if "adaptmlp" in k]


def test_moe_learnable_scale_crosses_the_bridge():
    mc, tuning, params = _moe_params(ffn_adapter_scalar="learnable_scalar")
    sd = from_flax_params(params)
    assert sd["blocks.0.adaptmlp.scale"].shape == (1,)
    model = VisionTransformer(port_cfg(mc), tuning=port_cfg(tuning),
                              select=tcfg.SelectConfig(),
                              dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)


def test_make_vit_state_dict_moe():
    """moe_experts draws the MoE adapters after every other tensor: the rest
    is the default dict value for value; the MoE dict loads into a port MoE
    model with no key missing or left over; router and up kernels are
    nonzero."""
    kw = dict(depth=2, dim=DIM, ffn=FFN, classes=CLASSES, img=32, patch=16)
    dense = make_vit_state_dict(np.random.RandomState(3), **kw)
    moe = make_vit_state_dict(np.random.RandomState(3), moe_experts=4, **kw)
    for k, v in dense.items():
        if "down_proj" in k or "up_proj" in k:
            assert k not in moe
        else:
            np.testing.assert_array_equal(moe[k], v, err_msg=k)
    p = "blocks.0.adaptmlp."
    assert moe[p + "router.weight"].shape == (4, DIM)
    assert moe[p + "down_kernel"].shape == (4, DIM, FFN)
    assert np.abs(moe[p + "router.weight"]).max() > 0
    assert np.abs(moe[p + "up_kernel"]).max() > 0
    model = VisionTransformer(
        tcfg.ModelConfig(img_size=32, patch_size=16, embed_dim=DIM, depth=2,
                         num_heads=HEADS, num_classes=CLASSES),
        tuning=tcfg.TuningConfig(ffn_num=FFN, moe_experts=4),
        dtype=torch.float32)
    missing, unexpected = load_timm_state_dict(model, moe,
                                               log=lambda *a: None)
    assert missing == [] and unexpected == []


# --- the entry point -----------------------------------------------------------

def test_speed_builds_the_moe_model():
    """--moe_experts/--moe_router_tau reach every block's adapter; plain
    mode has no adapter, as in the JAX package."""
    args = speed.get_args_parser().parse_args(
        ["--moe_experts", "4", "--moe_router_tau", "0.7", "--quant", "int8"])
    model = speed.build_model(args, torch.device("cpu"))
    assert len(model.blocks) == 12 and model.cfg.quant == "int8"
    for blk in model.blocks:
        assert isinstance(blk.adaptmlp, MoEAdapter)
        assert (blk.adaptmlp.experts, blk.adaptmlp.bneck,
                blk.adaptmlp.tau) == (4, 64, 0.7)
    plain = speed.build_model(speed.get_args_parser().parse_args(
        ["--moe_experts", "4", "--mode", "plain"]), torch.device("cpu"))
    assert not any(hasattr(blk, "adaptmlp") for blk in plain.blocks)
