"""Adapter widths, MoE widths and head dims the JAX kernels take and the
port's wgmma kernels are not built for, on the CPU.

* the padding that takes a bf16 adapter of bottleneck F <= 128 to the next
  width the wgmma adapter/router kernel is built for
  (``ms.adapter_kernel_width``, ``ms.pad_adapter_weights``, done once per
  load by ``Adapter.kernel_weights``) and a bf16 MoE adapter to an E * b
  that is a multiple of 16 (``ms.moe_kernel_bneck`` in
  ``ms.moe_kernel_weights``) is exact: the plain version on the padded
  weights equals the one on the unpadded weights (fp32 within 1e-6 of the
  largest output; the wrapper too at F = 8, 24 and 100);
* whole DyT ViTs against the JAX model in interpret mode
  (``DYT_FUSED_ATTN=interpret``): bf16 at ``ffn_num`` 8, 24 and 256
  (padded to 16 and 32 by the port; 256 on the SIMT tail) in dense and
  dispatch mode; MoE at 2 experts of 4 (padded to 2 x 8 in bf16), fp32 and bf16;
  head dims 192 (C = 384 in 2 heads) and 256 (C = 512 in 2 heads), fp32
  and bf16 dispatch, and int8_attn at fp32 compute; head dims 320, 384
  and 512 (C = 2 hd in 2 heads, past 256), fp32 and bf16 dispatch, and
  their K9 (with a bias), K10 and K15 against the JAX kernels;
* the route table (``ms.core_of``): which attention core each kernel's
  wrapper runs, by dtype, head dim and int8 scores, and the head dims and
  head counts it refuses; ``speed --num_heads``.

Tolerances: fp32 logits within 1e-5 of their largest magnitude, every gate
identical (int8: 1e-2, as tests/test_torch_port_model.py); bf16 as the
bf16 model tests of tests/test_torch_port_model.py and
tests/test_torch_port_moe.py (1.2% and 1% of the largest logit; a gate may
differ only where its router logit is within 5% of the largest of 0).

Size: depth 2, 32x32 images of 16x16 patches (5 tokens), 2 images.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_tuning_tpu.config import ModelConfig, SelectConfig, TuningConfig
from dynamic_tuning_tpu.models.vit import VisionTransformer as JaxViT
from dynamic_tuning_tpu.train.checkpoint import import_pretrained
from dynamic_tuning_tpu_torch import config as tcfg
from dynamic_tuning_tpu_torch.checkpoint import from_flax_params
from dynamic_tuning_tpu_torch.models.layers import MoEAdapter
from dynamic_tuning_tpu_torch.models.vit import VisionTransformer
from dynamic_tuning_tpu_torch.ops import mha_serving as ms
from torch_oracle import make_vit_state_dict

DEPTH, IMG, PATCH, CLASSES = 2, 32, 16, 10
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF = torch.bfloat16


class _Quiet:
    def info(self, *a):
        pass


def port_cfg(cfg):
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _perturb(tree, rs, scale=0.05):
    """Every leaf moved off its init (MoE routers and up kernels start at
    zero, which would make the gates uniform and the mixture zero)."""
    return jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rs.randn(*a.shape) * scale, a.dtype), tree)


def _pair(monkeypatch, *, dtype, ffn, dim=128, heads=2, experts=0,
          quant="none", seed=0):
    """(jax model, jax params, port model, input) with identical weights."""
    mc = ModelConfig(img_size=IMG, patch_size=PATCH, embed_dim=dim,
                     depth=DEPTH, num_heads=heads, num_classes=CLASSES,
                     residual_dtype=dtype, quant=quant)
    tuning = TuningConfig(ffn_num=ffn, d_model=dim, moe_experts=experts,
                          moe_router_tau=0.7)
    sel = SelectConfig(token_target_ratio=0.5)
    rs = np.random.RandomState(seed)
    sd = make_vit_state_dict(rs, depth=DEPTH, dim=dim, ffn=ffn,
                             classes=CLASSES, img=IMG, patch=PATCH)
    for i in range(DEPTH):
        k = f"blocks.{i}.adaptmlp.up_proj.weight"
        sd[k] = (rs.randn(*sd[k].shape) * 0.05).astype(np.float32)
    x = rs.randn(2, IMG, IMG, 3).astype(np.float32)
    jm = JaxViT(mc, tuning=tuning, select=sel, dtype=JDT[dtype])
    # the tree's shapes only (an eager init takes ~10 s here), every leaf
    # then taken from the state dict (the MoE adapters from the
    # perturbation below); applied in interpret mode
    monkeypatch.setenv("DYT_FUSED_ATTN", "interpret")
    # the port's own init draws are all replaced by the strict load below
    # (torch's truncated normal takes ~1.5 s a model here)
    monkeypatch.setattr(torch.nn.init, "trunc_normal_",
                        lambda t, *a, **k: t)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.asarray(x[:1]))["params"]
    params = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                    shapes)
    params, _ = import_pretrained(params, sd, logger=_Quiet())
    if experts:
        params = {k: ({**v, "adaptmlp": _perturb(v["adaptmlp"], rs)}
                      if k.startswith("blocks_") else v)
                  for k, v in params.items()}
    tm = VisionTransformer(port_cfg(mc), tuning=port_cfg(tuning),
                           select=port_cfg(sel), dtype=TDT[dtype])
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        from_flax_params(params).items()}, strict=True)
    return jm, params, tm, x


def _check(jm, params, tm, x, kwargs, dtype, *, rel=None):
    jl, jaux = jax.jit(lambda p, a: jm.apply({"params": p}, a, **kwargs))(
        params, jnp.asarray(x))
    with torch.no_grad():
        tl, taux = tm(torch.from_numpy(x), **kwargs)
    want = np.asarray(jl.astype(jnp.float32))
    rel = rel or (1e-5 if dtype == "float32" else 0.012)
    np.testing.assert_allclose(tl.float().numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())
    if jaux.get("token_select") is None:
        assert taux["token_select"] is None
        return
    same = taux["token_select"].numpy() == np.asarray(jaux["token_select"])
    if dtype == "float32":
        assert same.all()
        return
    jl_tok = np.asarray(jaux["token_logits"])
    assert (same | (np.abs(jl_tok) < 0.05 * np.abs(jl_tok).max())).all()


# --- padding ------------------------------------------------------------------

def test_kernel_widths():
    # up to 128 the wgmma adapter/router kernel's widths; past it up to
    # ms.MOE_MAX_W = 1024 the next multiple of 16 (the MoE tail's wgmma
    # kernel, gate-free); past 1024 the SIMT tail at F itself
    assert [ms.adapter_kernel_width(f, BF) for f in (1, 8, 16, 24, 33, 100,
                                                     128, 129, 200, 256,
                                                     1024, 1025)] == [
        16, 16, 16, 32, 48, 128, 128, 144, 208, 256, 1024, 1025]
    assert ms.adapter_kernel_width(8, torch.float32) == 8
    assert ms.adapter_kernel_width(200, torch.float32) == 200
    tail = lambda F, C=768, dt=BF: ms._adapter_tail(  # noqa: E731
        torch.empty((F, C), dtype=dt))
    assert [tail(F) for F in (16, 128, 144, 208, 256, 1024, 1025)] == [
        "wgmma", "wgmma", "wide", "wide", "wide", "wide", "simt"]
    assert tail(200) == "simt"            # unpadded: not a multiple of 16
    assert tail(256, C=96) == "simt"      # C % 64 != 0
    assert tail(256, dt=torch.float32) == "f64"
    assert ms.moe_kernel_bneck(2, 4, BF) == 8
    assert ms.moe_kernel_bneck(3, 5, BF) == 16          # 48
    assert ms.moe_kernel_bneck(4, 64, BF) == 64
    # up to ms.MOE_MAX_W = 1024 the wgmma tail (padded to a multiple of 16);
    # past 1024 the SIMT tail
    assert ms.MOE_MAX_W == 1024
    assert ms.moe_kernel_bneck(4, 192, BF) == 192       # 768
    assert ms.moe_kernel_bneck(3, 250, BF) == 256       # 750 -> 768
    assert ms.moe_kernel_bneck(2, 509, BF) == 512       # 1018 -> 1024
    assert ms.moe_kernel_bneck(5, 200, BF) == 200       # 1040: SIMT
    assert ms.moe_kernel_bneck(4, 257, BF) == 257       # 1028: SIMT
    assert ms.moe_kernel_bneck(2, 4, torch.float32) == 4
    assert ms.form_of(torch.float32, 64) == "fp32"
    assert ms.form_of(BF, 64) == "bf16"
    assert ms.form_of(BF, 192, "simt") == "bf16+wide_heads+simt_tail"
    # a tail that is not SIMT is not reported as one
    assert ms.form_of(BF, 64, "wide") == "bf16+wide_tail"
    assert ms.form_of(BF, 64, "wgmma") == "bf16"
    assert ms.form_of(torch.float32, 64, "f64") == "fp32"


def _adapter(rs, F, C=128):
    t = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (rs.randn(*s) * sc).astype(np.float32))
    return (t(F, C, sc=0.05), t(F, sc=0.05), t(C, F, sc=0.05), t(C, sc=0.02),
            torch.full((1,), 0.1), t(1, C, sc=0.3), t(1, sc=0.1))


@pytest.mark.parametrize("F", [8, 24, 100, 200])
def test_padded_adapter_is_exact(F):
    rs = np.random.RandomState(F)
    wd, bd, wu, bu, sc, ws, bs = _adapter(rs, F)
    xm = torch.from_numpy(rs.randn(2, 9, 128).astype(np.float32))
    width = ms.adapter_kernel_width(F, BF)
    assert width > F
    pd, pb, pu = ms.pad_adapter_weights(wd, bd, wu, width)
    assert pd.shape == (width, 128) and pu.shape == (128, width)
    assert not pd[F:].any() and not pb[F:].any() and not pu[:, F:].any()
    want = ms.adapter_router_plain(xm, torch.float32, wd, bd, wu, bu, sc, ws,
                                   bs, with_select=True)
    got = ms.adapter_router_plain(xm, torch.float32, pd, pb, pu, bu, sc, ws,
                                  bs, with_select=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 * w.abs().max().item())
    # the wrapper (its plain version on the CPU) with the padded weights
    rs2 = np.random.RandomState(7)
    C, H = 128, 2
    t = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (rs2.randn(*s) * sc).astype(np.float32))
    sub = (1.0 + t(C, sc=0.05), t(C, sc=0.02), t(3 * C, C, sc=0.03),
           t(3 * C, sc=0.02), t(C, C, sc=0.03), t(C, sc=0.02))
    x = t(2, 9, C)
    want = ms.dyt_prologue_plain(x, *sub, wd, bd, wu, bu, sc, ws, bs,
                                 heads=H)
    got = ms.dyt_prologue_serving(x, *sub, pd, pb, pu, bu, sc, ws, bs,
                                  heads=H)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 * w.abs().max().item())


@pytest.mark.parametrize("E,b", [(2, 4), (3, 5), (3, 250), (2, 509)])
def test_padded_moe_is_exact(E, b):
    """The padded bf16 expert stacks give the unpadded ones' outputs (the
    plain version sums in float64: zero columns add nothing), up to the
    wgmma tail's cap (3 x 250 -> 3 x 256, 2 x 509 -> 2 x 512 = 1024)."""
    rs = np.random.RandomState(E * b)
    C = 128
    t = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (rs.randn(*s) * sc).astype(np.float32))
    dk, db, uk = t(E, C, b, sc=0.05), t(E, b, sc=0.05), t(E, b, C, sc=0.05)
    wr, bu = t(E, C, sc=0.1), t(E, C, sc=0.02)
    sc, ws, bs = torch.full((1,), 0.1), t(1, C, sc=0.3), t(1, sc=0.1)
    padded = ms.moe_kernel_weights(dk, db, uk, BF)
    bp = ms.moe_kernel_bneck(E, b, BF)
    assert padded[0].shape == (E * bp, C) and (E * bp) % 16 == 0
    unpadded = (dk.transpose(1, 2).reshape(E * b, C).to(BF), db.reshape(-1),
                uk.reshape(E * b, C).t().contiguous().to(BF))
    xm = t(2, 9, C)
    kw = dict(experts=E, tau=0.7, with_select=True)
    want = ms.moe_adapter_router_plain(xm, torch.float32, wr, *unpadded, bu,
                                       sc, ws, bs, bneck=b, **kw)
    got = ms.moe_adapter_router_plain(xm, torch.float32, wr, *padded, bu, sc,
                                      ws, bs, bneck=bp, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 * w.abs().max().item())


# --- whole models against JAX ---------------------------------------------------

MODES = {"dispatch": {"dispatch": True}, "dense": {"complete_model": True}}


@pytest.mark.parametrize("ffn,mode", [(8, "dense"), (24, "dispatch"),
                                      (256, "dense"), (200, "dispatch")])
def test_bf16_adapter_widths_match_jax(monkeypatch, ffn, mode):
    """bf16 at adapter widths padded to the wgmma tail's (8 -> 16, 24 ->
    32) and past it (256, and 200 padded to 208: the MoE tail's wgmma
    kernel, gate-free); each width in one mode (the fp32 file takes the
    other pairings; the plain ViT, which has no adapter, is
    tests/test_torch_port_model.py::test_model_matches_jax_bf16[plain])."""
    jm, params, tm, x = _pair(monkeypatch, dtype="bfloat16", ffn=ffn)
    wd = tm.blocks[0].adaptmlp.kernel_weights()[0]
    assert wd.shape[0] == ms.adapter_kernel_width(ffn, BF)
    _check(jm, params, tm, x, MODES[mode], "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_2x4_matches_jax(monkeypatch, dtype):
    jm, params, tm, x = _pair(monkeypatch, dtype=dtype, ffn=4, experts=2)
    assert isinstance(tm.blocks[0].adaptmlp, MoEAdapter)
    wd = tm.blocks[0].adaptmlp.kernel_weights()[1]
    assert wd.shape[0] == (16 if dtype == "bfloat16" else 8)
    _check(jm, params, tm, x, {"dispatch": True}, dtype,
           rel=None if dtype == "float32" else 0.01)


@pytest.mark.parametrize(
    "dtype,hd", [("float32", 192), ("bfloat16", 192), ("float32", 256),
                 ("bfloat16", 256)],
    ids=["float32", "bfloat16", "float32-hd256", "bfloat16-hd256"])
def test_head_dim_192_matches_jax(monkeypatch, dtype, hd):
    """K3 at head dims 192 and 256 (2 heads): the wgmma core in bf16 on the
    card, the fp32 core in fp32; dispatch."""
    jm, params, tm, x = _pair(monkeypatch, dtype=dtype, ffn=64, dim=2 * hd,
                              heads=2)
    _check(jm, params, tm, x, MODES["dispatch"], dtype)


@pytest.mark.parametrize(
    "dtype,hd", [("float32", 320), ("bfloat16", 320), ("float32", 384),
                 ("bfloat16", 384), ("float32", 512), ("bfloat16", 512)],
    ids=["float32", "bfloat16", "float32-hd384", "bfloat16-hd384",
         "float32-hd512", "bfloat16-hd512"])
def test_head_dim_320_matches_jax(monkeypatch, dtype, hd):
    """A DyT ViT (K3 in every Block forward) at head dims 320, 384 and 512
    (C = 2 hd in 2 heads), which JAX fuses and the card serves on the
    wgmma core past 256 (bf16) and the fp32 core's; dispatch."""
    jm, params, tm, x = _pair(monkeypatch, dtype=dtype, ffn=64, dim=2 * hd,
                              heads=2)
    assert ms.core_of("K3", TDT[dtype], hd, heads=2) == (
        "f32" if dtype == "float32" else "wgmma")
    _check(jm, params, tm, x, MODES["dispatch"], dtype)


def _close_rel(got, want, dtype):
    """Within 1e-5 (fp32) or 0.012 (bf16) of the largest |want|: the
    model tolerances of ``_check``."""
    want = np.asarray(want, np.float32)
    rel = 1e-5 if dtype == "float32" else 0.012
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


_KERNELS_320 = [("K9", "float32"), ("K9", "bfloat16"), ("K10", "float32"),
                ("K10", "bfloat16"), ("K15", "bfloat16")]


@pytest.mark.parametrize(
    "kernel,dtype,hd,N",
    [(k, d, 320, 13) for k, d in _KERNELS_320]
    + [(k, d, hd, 13) for hd in (384, 512) for k, d in _KERNELS_320]
    + [("K10", "bfloat16", 192, 320)],
    ids=[f"{k}-{d}" for k, d in _KERNELS_320]
    + [f"{k}-{d}-hd{hd}" for hd in (384, 512) for k, d in _KERNELS_320]
    + ["K10-bfloat16-hd192-N320"])
def test_head_dim_320_kernels_match_jax(kernel, dtype, hd, N):
    """K9 (with a bias), K10 and K15 at 2 heads of 320, 384 and 512 against
    the JAX kernels in interpret mode (K15 takes bf16 only), each routed to
    its core past 256: K9 and K15 to the wgmma core's and the fp32 core's,
    K10 in bf16 to the int8-score key ring (in fp32 to the SIMT core's
    int8-score form); and K10 at head dim 192 with N = 320, past the N of the
    staged int8-score core's layout (304), on the ring."""
    from dynamic_tuning_tpu.ops import mha_serving as jms
    from dynamic_tuning_tpu.ops import quant as jq
    from dynamic_tuning_tpu_torch.ops import quant as tq
    H, B = 2, 2
    C = H * hd
    rs = np.random.RandomState(32)
    qkv = rs.randn(B, N, 3 * C).astype(np.float32)
    qkv[..., C:2 * C] += 1.0
    jdt, tdt = JDT[dtype], TDT[dtype]
    if kernel == "K9":
        bias = rs.randn(H, N, N).astype(np.float32)
        want = jms.mha_windowed_fused(jnp.asarray(qkv, jdt),
                                      jnp.asarray(bias, jnp.bfloat16),
                                      heads=H, interpret=True)
        got = ms.mha_windowed_fused(torch.from_numpy(qkv).to(tdt),
                                    torch.from_numpy(bias), heads=H)
        assert ms.core_of("K9", tdt, hd, heads=H) == (
            "f32" if dtype == "float32" else "windowed")
    elif kernel == "K10":
        outs = []
        for smp in qkv:
            out = np.zeros((N, C), jdt)
            jq.attn_core_pairs_q8(jnp.asarray(smp, jdt), out, heads=H,
                                  hd=hd, scale=hd ** -0.5)
            outs.append(out.astype(np.float32))
        want = np.stack(outs)
        got = tq.attn_core_pairs_q8(torch.from_numpy(qkv).to(tdt), heads=H)
        assert ms.core_of("K10", tdt, hd, heads=H, q8_fits=False) == (
            "simt_q8" if dtype == "float32" else "q8_ring")
    else:
        q, k, v = (a.astype(np.float32) for a in np.asarray(
            jnp.asarray(qkv, jnp.bfloat16)).reshape(B, N, 3, H, hd)
                   .transpose(2, 0, 3, 1, 4))
        want = jms.mha_serving(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in (q, k, v)), interpret=True)
        got = ms.mha_serving(*(torch.from_numpy(np.ascontiguousarray(a))
                               .to(BF) for a in (q, k, v)))
        assert ms.core_of("K15", BF, hd, heads=H) == "wgmma"
    _close_rel(got, np.asarray(jnp.asarray(want, jnp.float32)), dtype)


def test_head_dim_192_int8_attn_fp32_matches_jax(monkeypatch):
    jm, params, tm, x = _pair(monkeypatch, dtype="float32", ffn=24, dim=384,
                              heads=2, quant="int8_attn")
    _check(jm, params, tm, x, {"dispatch": True}, "float32", rel=1e-2)


# --- the route table --------------------------------------------------------

F32 = torch.float32
# kernel -> {(dtype, head dim, int8 scores, K10's layout fits): core}
WIDE = (320, 384, 512, 640, 768)       # past 256, up to ms.WIDE_MAX_HD
PAST = (832, 1024)                     # past ms.WIDE_MAX_HD
ROUTES = {
    "K1": {(BF, 64, 0, 1): "wgmma", (BF, 128, 0, 1): "wgmma",
           (BF, 192, 0, 1): "wgmma", (BF, 256, 0, 1): "wgmma",
           (F32, 64, 0, 1): "f32", (F32, 256, 0, 1): "f32"},
    "K15": {(BF, 64, 0, 1): "wgmma", (BF, 192, 0, 1): "wgmma",
            (BF, 256, 0, 1): "wgmma"},
    "K2": {(BF, 64, 0, 1): "wgmma", (BF, 192, 0, 1): "wgmma",
           (F32, 64, 0, 1): "f32", (F32, 192, 0, 1): "f32"},
    "K3": {(BF, 128, 0, 1): "wgmma", (BF, 256, 0, 1): "wgmma",
           (F32, 64, 0, 1): "f32"},
    "K7": {(BF, 64, 0, 1): "wgmma", (BF, 192, 0, 1): "wgmma",
           (F32, 128, 0, 1): "f32"},
    "K5": {(BF, 64, 0, 1): "wgmma", (BF, 192, 0, 1): "wgmma",
           (BF, 64, 1, 1): "q8", (BF, 64, 1, 0): "q8_ring",
           (BF, 192, 1, 1): "q8", (BF, 256, 1, 0): "q8_ring"},
    "K6": {(BF, 256, 0, 1): "wgmma", (BF, 128, 1, 1): "q8",
           (BF, 256, 1, 1): "q8", (F32, 64, 0, 1): "f32_exact",
           (F32, 64, 1, 1): "q8_exact", (F32, 128, 1, 1): "q8_exact",
           (F32, 256, 1, 0): "q8_exact", (F32, 192, 0, 1): "f32_exact"},
    "K8": {(BF, 192, 0, 1): "wgmma", (BF, 64, 1, 1): "q8",
           (BF, 128, 1, 0): "q8_ring",
           (F32, 64, 0, 1): "f32_exact", (F32, 64, 1, 1): "q8_exact",
           (F32, 192, 1, 1): "q8_exact"},
    "K9": {(BF, 64, 0, 1): "windowed", (BF, 128, 0, 1): "windowed",
           (BF, 192, 0, 1): "windowed", (BF, 256, 0, 1): "windowed",
           (F32, 64, 0, 1): "f32", (F32, 256, 0, 1): "f32"},
    "K10": {(BF, 64, 0, 1): "q8", (BF, 128, 0, 1): "q8",
            (BF, 128, 0, 0): "q8_ring", (BF, 192, 0, 1): "q8",
            (BF, 256, 0, 1): "q8", (BF, 192, 0, 0): "q8_ring",
            (BF, 64, 0, 0): "q8_ring", (F32, 64, 0, 1): "q8_exact",
            (F32, 128, 0, 1): "q8_exact", (F32, 192, 0, 0): "q8_exact",
            (F32, 256, 0, 1): "q8_exact"},
}
# past head dim 256, up to WIDE_MAX_HD: bf16 K1, K15, K9 and the cores
# without int8 scores on the wgmma core past 256, fp32 K1, K9 and the cores
# of K2, K3, K7 on the fp32 core's, bf16 K10 and the int8-score cores on
# the int8-score key ring (whatever the staged core's layout); past
# WIDE_MAX_HD (the ceiling: the q tile and two stages of K no longer fit a
# block) the SIMT core's slices and the SIMT int8-score form; fp32 K10 and
# int8-score cores on the SIMT int8-score form, fp32 K6 and K8 on the
# slices kernel's exact form (the DMMA exact core and its int8-score mode
# stop at ms.EXACT_MAX_HD)
for _hd in WIDE + PAST:
    _past = _hd in PAST
    for _k in ("K1", "K2", "K3", "K7"):
        ROUTES[_k].update({(BF, _hd, 0, 1): "simt" if _past else "wgmma",
                           (F32, _hd, 0, 1): "simt" if _past else "f32"})
    ROUTES["K9"].update({(BF, _hd, 0, 1): "simt" if _past else "windowed",
                         (F32, _hd, 0, 1): "simt" if _past else "f32"})
    ROUTES["K15"][(BF, _hd, 0, 1)] = "simt" if _past else "wgmma"
    _q8 = "simt_q8" if _past else "q8_ring"
    for _k in ("K5", "K6", "K8"):
        ROUTES[_k].update({(BF, _hd, 0, 1): "simt" if _past else "wgmma",
                           (BF, _hd, 1, 1): _q8, (BF, _hd, 1, 0): _q8})
    for _k in ("K6", "K8"):
        ROUTES[_k].update({(F32, _hd, 0, 1): "simt_exact",
                           (F32, _hd, 1, 1): "simt_q8"})
    ROUTES["K10"].update({(BF, _hd, 0, 1): _q8, (BF, _hd, 0, 0): _q8,
                          (F32, _hd, 0, 1): "simt_q8"})


@pytest.mark.parametrize("kernel", sorted(ROUTES))
def test_core_routes(kernel):
    """The attention core each wrapper runs (``ms.core_of``, the one table
    the wrappers route by): up to head dim 768 (``ms.WIDE_MAX_HD``), bf16
    K1, K15 and the cores of K2, K3, K7 and of K5, K6, K8 without int8
    scores on the wgmma core, K9 on its wgmma kernels, fp32 K1, K2, K3, K7,
    K9 on the fp32 core; bf16 K10 (and K5, K6, K8 with int8 scores) on the
    staged int8-score core up to 256 where its layout fits, on the
    int8-score key ring where it does not and past 256 up to 768, fp32 K10
    (and K6, K8 with int8 scores) on the exact core's int8-score mode up to
    256 and on the SIMT core's int8-score form past it; fp32 K6, K8 on the
    exact core up to 256 and on the SIMT core's exact form past it; past
    768 every core on
    the SIMT core; K5 and K15 in fp32 on none (K5's scratch is bf16); and
    the forms the counts are kept under (past 256 "+past_256" on the wgmma
    and fp32 cores, "+q8_ring" on the key ring at any head dim,
    "fp32+q8_exact" on the exact core's int8-score mode, "+simt_core" on
    the SIMT core's).  Head dims JAX does not fuse,
    and odd head counts (but for K15, which pairs no heads), raise here
    alone."""
    for (dtype, hd, q8, fits), core in ROUTES[kernel].items():
        got = ms.core_of(kernel, dtype, hd, heads=2, attn_q8=bool(q8),
                         q8_fits=bool(fits))
        assert got == core, (kernel, dtype, hd, q8, fits, got)
        want = ("fp32+past_256" if dtype == F32 and core == "f32"
                and hd > 256 else
                "fp32+q8_exact" if core == "q8_exact" else
                "fp32" if dtype == F32 else
                "bf16+q8_ring" if core == "q8_ring" else
                "bf16" if hd in (64, 128) else
                "bf16+simt_core" if core.startswith("simt") else
                "bf16+past_256" if hd > 256 else
                "bf16+wide_heads")
        assert ms.form_of(dtype, hd, core=core) == want
    for hd in (96, 160, 0, 32):
        with pytest.raises(ValueError, match="head_dim"):
            ms.core_of(kernel, BF, hd, heads=2)
    if kernel == "K15":
        assert ms.core_of(kernel, BF, 320, heads=3) == "wgmma"
        assert ms.core_of(kernel, BF, 832, heads=3) == "simt"
    else:
        for hd in (64, 320):
            with pytest.raises(ValueError, match="heads"):
                ms.core_of(kernel, BF, hd, heads=3)
    if kernel in ("K5", "K15"):
        with pytest.raises(TypeError):
            ms.core_of(kernel, F32, 64, heads=2)


def test_speed_builds_head_dim_192():
    """``speed --num_heads 4`` builds ViT-B/16 in 4 heads of 192 (the
    forward PERF.md times at that head dim), whose sublayers the wrappers
    send to the wgmma core."""
    from dynamic_tuning_tpu_torch import speed
    args = speed.get_args_parser().parse_args(["--num_heads", "4"])
    model = speed.build_model(args, torch.device("cpu"))
    assert len(model.blocks) == 12
    assert {blk.num_heads for blk in model.blocks} == {4}
    assert {blk.attn.num_heads for blk in model.blocks} == {4}
    assert ms.core_of("K3", BF, model.cfg.embed_dim // 4, heads=4) == "wgmma"


def test_speed_builds_head_dim_384():
    """``speed --num_heads 2`` builds ViT-B/16 in 2 heads of 384 (the
    forward PERF.md times past head dim 256), whose sublayers the wrappers
    send to the wgmma core past 256 (bf16) and the fp32 core's."""
    from dynamic_tuning_tpu_torch import speed
    args = speed.get_args_parser().parse_args(["--num_heads", "2"])
    model = speed.build_model(args, torch.device("cpu"))
    assert len(model.blocks) == 12
    assert {blk.num_heads for blk in model.blocks} == {2}
    assert {blk.attn.num_heads for blk in model.blocks} == {2}
    hd = model.cfg.embed_dim // 2
    assert hd == 384
    assert ms.core_of("K3", BF, hd, heads=2) == "wgmma"
    assert ms.core_of("K3", F32, hd, heads=2) == "f32"
    assert ms.form_of(BF, hd, core="wgmma") == "bf16+past_256"
    assert ms.form_of(F32, hd, core="f32") == "fp32+past_256"
