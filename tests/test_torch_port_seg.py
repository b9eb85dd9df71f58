"""The PyTorch port's segmentation path against the JAX package's, on the CPU.

K9's plain version against the TPU kernel in interpret mode, the
relative-position bias, the windowed Attention and Block, the backbone, the
UPerNet and FCN heads, the whole DyTSegmentor, slide inference, the resize,
the metrics, the data readers, the weight bridge and the evaluation runner.
The JAX side runs with DYT_FUSED_ATTN=interpret, so its windowed blocks take
the Pallas kernel in interpret mode as the port's take K9 (its plain version
on the CPU); without that JAX on the CPU takes its unfused branch.

Weights: the JAX model is initialised (with the unfused branch, which has the
same param tree and compiles faster), then made to matter everywhere --
nonzero relative-position tables of the size of the scores, router heads
scaled so hard gates have margin, nonzero adapter ups, perturbed norm
affines -- and crosses to the port through ``from_flax_params`` with
``load_state_dict(strict=True)``.

Size: embed 128, 2 heads of 64 (so K9 applies), depth 4, 64x64 images of
16x16 patches (N = 17 tokens), head channels 64, 7 classes.  Tolerances are
stated where used: fp32 differs by summation order only.
"""

import dataclasses
import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from dynamic_tuning_tpu.config import ModelConfig, SelectConfig, TuningConfig
from dynamic_tuning_tpu.data import segmentation as jseg_data
from dynamic_tuning_tpu.models import layers as jlayers
from dynamic_tuning_tpu.models import upernet as jup
from dynamic_tuning_tpu.models.seg_vit import SegVisionTransformer as JSegViT
from dynamic_tuning_tpu.ops import mha_serving as jms
from dynamic_tuning_tpu.train import losses as jlosses
from dynamic_tuning_tpu.train.checkpoint import import_pretrained
from dynamic_tuning_tpu.utils import metrics as jmetrics
from dynamic_tuning_tpu.utils import pos_embed as jpos
from dynamic_tuning_tpu_torch import config as tcfg
from dynamic_tuning_tpu_torch import seg_train
from dynamic_tuning_tpu_torch.checkpoint import (from_flax_params,
                                                 load_timm_state_dict,
                                                 make_seg_state_dict,
                                                 make_vit_state_dict)
from dynamic_tuning_tpu_torch.data import segmentation as tseg_data
from dynamic_tuning_tpu_torch.models import layers as tlayers
from dynamic_tuning_tpu_torch.models import upernet as tup
from dynamic_tuning_tpu_torch.models.seg_vit import SegVisionTransformer
from dynamic_tuning_tpu_torch.ops import mha_serving as tms
from dynamic_tuning_tpu_torch.train import losses as tlosses
from dynamic_tuning_tpu_torch.train.seg_runner import SegRunner
from dynamic_tuning_tpu_torch.utils import metrics as tmetrics
from dynamic_tuning_tpu_torch.utils import pos_embed as tpos

DIM, DEPTH, HEADS, FFN, IMG, PATCH, HEAD_CH, NC = 128, 4, 2, 8, 64, 16, 64, 7
GRID = IMG // PATCH                      # 4x4 patches + CLS = 17 tokens
TUNING = TuningConfig(ffn_num=FFN, d_model=DIM)
SELECT = SelectConfig(token_target_ratio=0.5)
MODES = {"mask": {}, "dispatch": {"dispatch": True},
         "complete_model": {"complete_model": True}}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Toy-size ops (and the CLI's 32^2 crops) gain little from many
    intra-op threads, and beside other test processes those threads wait
    on each other (tests/test_torch_port_runner.py does the same)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _eval_only():
    """The port's serving forwards: no autograd."""
    with torch.no_grad():
        yield


def port_cfg(cfg):
    """The port's own config object with the fields of a JAX-package one."""
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def model_cfg(dtype="float32"):
    return ModelConfig(img_size=IMG, patch_size=PATCH, embed_dim=DIM,
                       depth=DEPTH, num_heads=HEADS, num_classes=NC,
                       residual_dtype=dtype)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _matter(tree, seed=0):
    """Make every parameter count: nonzero rel-pos tables (~1, the scale of
    the scores) and adapter ups, router heads x50 (hard gates with margin),
    perturbed norm affines and running statistics."""
    rs = np.random.RandomState(seed)

    def f(path, a):
        key = jax.tree_util.keystr(path)
        a = np.asarray(a)
        r = lambda s: (rs.randn(*a.shape) * s).astype(np.float32)
        if "relative_position_bias_table" in key:
            return a + r(1.0)
        if "mlp_token_select" in key and "kernel" in key:
            return a * 50.0
        if "up_proj" in key:
            return a + r(0.05)
        if ("'gn'" in key or "'bn'" in key) and "scale" in key:
            return a + r(0.05)
        if ("'gn'" in key or "'bn'" in key) and "bias" in key:
            return a + r(0.02)
        if key.endswith("['mean']"):
            return a + r(0.1)
        if key.endswith("['var']"):
            return a + np.abs(r(0.2))
        return a

    return jax.tree_util.tree_map_with_path(f, tree)


def _init(module, *args):
    """JAX variables of ``module`` (initialised with the unfused branch)."""
    with mock.patch.dict(os.environ, {"DYT_FUSED_ATTN": "0"}):
        return jax.jit(module.init)(jax.random.PRNGKey(0), *args)


@functools.lru_cache(maxsize=None)
def _seg_variables(norm="gn", head_channels=HEAD_CH):
    jm = jup.DyTSegmentor(model_cfg(), num_classes=NC, tuning=TUNING,
                          select=SELECT, head_channels=head_channels,
                          norm=norm, dtype=jnp.float32)
    v = _init(jm, jnp.zeros((1, IMG, IMG, 3)))
    return _matter(v["params"]), _matter(v.get("batch_stats", {}), 1)


def _pair(monkeypatch, dtype="float32", norm="gn", head_channels=HEAD_CH):
    """(jax segmentor, variables, port segmentor) with the same weights."""
    monkeypatch.setenv("DYT_FUSED_ATTN", "interpret")
    params, stats = _seg_variables(norm, head_channels)
    jm = jup.DyTSegmentor(model_cfg(dtype), num_classes=NC, tuning=TUNING,
                          select=SELECT, head_channels=head_channels,
                          norm=norm, dtype=JDT[dtype])
    tm = tup.DyTSegmentor(port_cfg(model_cfg(dtype)), num_classes=NC,
                          tuning=port_cfg(TUNING), select=port_cfg(SELECT),
                          head_channels=head_channels, norm=norm,
                          dtype=TDT[dtype])
    tm.load_state_dict({k: _t(v) for k, v in
                        from_flax_params(params, stats).items()}, strict=True)
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    return jm, variables, tm


def _image(n=2, seed=1, h=IMG, w=IMG):
    return np.random.RandomState(seed).randn(n, h, w, 3).astype(np.float32)


# --- K9 ----------------------------------------------------------------------

@pytest.mark.parametrize("bias_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [17, 50])
def test_windowed_plain_matches_jax_kernel(N, dtype, bias_dtype):
    """K9's plain version against the TPU kernel in interpret mode: fp32 at
    fp32 resolution (1e-5, summation order only), bf16 at one bf16 ulp of
    the output's magnitude (2**-7).  An fp32 bias is rounded to bf16 on
    both sides."""
    rs = np.random.RandomState(N)
    qkv = rs.randn(2, N, 3 * DIM).astype(np.float32)
    bias = rs.randn(HEADS, N, N).astype(np.float32)
    jq = jnp.asarray(qkv).astype(JDT[dtype])
    jb = jnp.asarray(bias).astype(JDT[bias_dtype])
    want = _np(jms.mha_windowed_fused(jq, jb, heads=HEADS, interpret=True))
    got = tms.mha_windowed_fused(_t(qkv).to(TDT[dtype]),
                                 _t(bias).to(TDT[bias_dtype]), heads=HEADS)
    assert got.dtype == TDT[dtype] and got.shape == (2, N, DIM)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_windowed_plain_rounds_the_bias_to_bf16():
    rs = np.random.RandomState(3)
    qkv = _t(rs.randn(1, 17, 3 * DIM).astype(np.float32))
    bias = _t(rs.randn(HEADS, 17, 17).astype(np.float32))
    a = tms.mha_windowed_plain(qkv, bias, heads=HEADS)
    b = tms.attn_core_pairs(qkv, heads=HEADS,
                            bias=bias.to(torch.bfloat16).float())
    assert torch.equal(a, b)
    assert not torch.equal(a, tms.attn_core_pairs(qkv, heads=HEADS,
                                                  bias=bias))


def test_windowed_wrapper_refuses_other_devices():
    qkv = torch.zeros((1, 17, 3 * DIM), device="meta")
    with pytest.raises(ValueError, match="CPU tensors"):
        tms.mha_windowed_fused(qkv, torch.zeros((HEADS, 17, 17),
                                                device="meta"), heads=HEADS)


# --- relative-position bias -----------------------------------------------------

@pytest.mark.parametrize("wh,ww", [(4, 4), (3, 5), (8, 8)])
def test_relative_position_index_matches_jax(wh, ww):
    want, size = jlayers._relative_position_index(wh, ww)
    got, tsize = tlayers._relative_position_index(wh, ww)
    assert tsize == size == tlayers._rel_pos_table_size(wh, ww)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("row_stride", [None, 24])
@pytest.mark.parametrize("wh,ww", [(4, 4), (3, 5)])
def test_rel_pos_bias_from_table_matches_jax(wh, ww, row_stride):
    """Exact: a gather through the index gives the values of the JAX
    package's Kronecker construction."""
    size = tlayers._rel_pos_table_size(wh, ww)
    table = np.random.RandomState(4).randn(size, 3).astype(np.float32)
    want = np.asarray(jlayers._rel_pos_bias_from_table(jnp.asarray(table),
                                                       wh, ww))
    got = tlayers._rel_pos_bias_from_table(_t(table), wh, ww,
                                           row_stride=row_stride)
    if row_stride is not None:
        assert got.stride(1) == row_stride
    np.testing.assert_array_equal(got.numpy(), want)


# --- windowed Attention and Block ------------------------------------------------

@pytest.mark.parametrize("heads", [2, 4], ids=["k9", "unfused_head_dim_32"])
def test_windowed_attention_matches_jax(monkeypatch, heads):
    """heads=2 (head_dim 64): both sides take the windowed kernel, the bias
    built from the bf16-rounded table; heads=4 (head_dim 32): both take the
    unfused branch with the fp32 bias.  fp32, 1e-5."""
    x = np.random.RandomState(5).randn(2, GRID * GRID + 1, DIM).astype(
        np.float32)
    ja = jlayers.Attention(heads, window_size=(GRID, GRID), dtype=jnp.float32)
    params = _matter(_init(ja, jnp.asarray(x))["params"])
    monkeypatch.setenv("DYT_FUSED_ATTN", "interpret")
    want = np.asarray(ja.apply({"params": params}, jnp.asarray(x)))
    ta = tlayers.Attention(DIM, heads, torch.Generator(),
                           window_size=(GRID, GRID), dtype=torch.float32)
    sd = from_flax_params({"attn": params})
    ta.load_state_dict({k[len("attn."):]: _t(v) for k, v in sd.items()},
                       strict=True)
    with mock.patch.object(tms, "mha_windowed_fused",
                           wraps=tms.mha_windowed_fused) as k9:
        got = ta(_t(x))
    assert k9.call_count == (1 if heads == 2 else 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["mask", "dispatch"])
def test_windowed_block_matches_jax(monkeypatch, mode):
    """A windowed DyT block runs the module path on both sides (LN ->
    windowed Attention -> residual, router, adapter, dispatch or mask)."""
    x = np.random.RandomState(6).randn(3, GRID * GRID + 1, DIM).astype(
        np.float32)
    jb = jlayers.Block(HEADS, window_size=(GRID, GRID), tuning=TUNING,
                       select_cfg=SELECT, dtype=jnp.float32)
    params = _matter(_init(jb, jnp.asarray(x))["params"])
    monkeypatch.setenv("DYT_FUSED_ATTN", "interpret")
    dispatch = mode == "dispatch"
    jx, jgate, jlog = jb.apply({"params": params}, jnp.asarray(x), False,
                               False, dispatch)
    tb = tlayers.Block(DIM, HEADS, torch.Generator(),
                       window_size=(GRID, GRID), tuning=port_cfg(TUNING),
                       select_cfg=port_cfg(SELECT), dtype=torch.float32)
    tb.load_state_dict({k: _t(v) for k, v in
                        from_flax_params(params).items()}, strict=True)
    tx, tgate, tlog = tb(_t(x), False, dispatch)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tgate.numpy(), np.asarray(jgate))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jlog)).max())
    if dispatch:
        assert tgate[:, 1:].sum(dim=1).max() <= 8        # K = 8 of 16


def test_block_beit_options_raise():
    """The BEiT options build (LayerScale gammas, q/v biases in place of the
    qkv bias), in int8 too, and train; what the backbone refuses raises: an
    input of another patch grid, an unknown remat."""
    g = torch.Generator()
    blk = tlayers.Block(DIM, HEADS, g, window_size=(GRID, GRID),
                        init_values=0.1, qv_bias_only=True)
    assert torch.equal(blk.gamma_1, torch.full((DIM,), 0.1))
    assert blk.attn.qkv.bias is None and blk.attn.q_bias.shape == (DIM,)
    mc = port_cfg(dataclasses.replace(model_cfg(), quant="int8"))
    q8 = SegVisionTransformer(mc, init_values=0.1, qv_bias_only=True)
    assert all(b.quant == "int8" for b in q8.blocks)
    assert q8.patch_embed.quant == "int8"
    tb = SegVisionTransformer(port_cfg(model_cfg()), init_values=0.1,
                              qv_bias_only=True, dtype=torch.float32)
    with torch.enable_grad():
        feats, _ = tb(torch.zeros((1, IMG, IMG, 3)), training=True,
                      draws=tlayers.Draws("cpu", gate=0, dropout=1))
        feats[0].sum().backward()
    assert tb.blocks[0].attn.relative_position_bias_table.grad is not None
    with pytest.raises(ValueError, match="patch grid"):
        tb(torch.zeros((1, IMG + PATCH, IMG, 3)))
    with pytest.raises(ValueError, match="remat"):
        SegVisionTransformer(port_cfg(dataclasses.replace(model_cfg(),
                                                          remat="blocks")))


# --- backbone and heads --------------------------------------------------------

@pytest.mark.parametrize("mode", ["mask", "dispatch"])
def test_seg_backbone_features_match_jax(monkeypatch, mode):
    """The four NHWC fp32 maps (strides 4/8/16/32: 16x16, 8x8, 4x4, 2x2 at
    this size), the gates and the budget loss."""
    jm, variables, tm = _pair(monkeypatch)
    jb = JSegViT(model_cfg(), tuning=TUNING, select=SELECT,
                 dtype=jnp.float32)
    x = _image()
    jf, jaux = jb.apply({"params": variables["params"]["backbone"]},
                        jnp.asarray(x), **MODES[mode])
    tf, taux = tm.backbone(_t(x), **MODES[mode])
    for a, b, s in zip(tf, jf, (16, 8, 4, 2)):
        assert a.shape == (2, s, s, DIM) and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(b)).max())
    np.testing.assert_array_equal(taux["token_select"].numpy(),
                                  np.asarray(jaux["token_select"]))
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=1e-6, atol=1e-7)


def _head_feats(seed=7):
    rs = np.random.RandomState(seed)
    return [rs.randn(2, s, s, DIM).astype(np.float32) for s in (16, 8, 4, 2)]


@pytest.mark.parametrize("norm", ["gn", "bn"])
def test_uperhead_matches_jax(norm):
    """PSP pooling (scales 3 and 6 pool a 2x2 map UP, then resize DOWN),
    FPN fusion, GroupNorm or eval BatchNorm, the fp32 classifier.  fp32,
    1e-4 of the largest logit: flax's GroupNorm takes the variance as
    E[x^2] - E[x]^2, torch's from the centred values, which differ by
    ~1e-5 relative on groups of 2 channels x 4 pixels."""
    feats = _head_feats()
    jh = jup.UPerHead(NC, channels=HEAD_CH, norm=norm, dtype=jnp.float32)
    v = _init(jh, [jnp.asarray(f) for f in feats])
    params, stats = _matter(v["params"]), _matter(v.get("batch_stats", {}),
                                                  1)
    want = np.asarray(jh.apply({"params": params,
                                **({"batch_stats": stats} if stats else {})},
                               [jnp.asarray(f) for f in feats]))
    th = tup.UPerHead(DIM, NC, torch.Generator(), channels=HEAD_CH,
                      norm=norm, dtype=torch.float32)
    sd = from_flax_params({"decode_head": params},
                          {"decode_head": stats} if stats else None)
    th.load_state_dict({k[len("decode_head."):]: _t(v)
                        for k, v in sd.items()}, strict=True)
    got = th([_t(f) for f in feats])
    assert got.shape == (2, 16, 16, NC)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_fcnhead_matches_jax():
    f = _head_feats(8)[2]
    jh = jup.FCNHead(NC, dtype=jnp.float32)
    params = _matter(_init(jh, jnp.asarray(f))["params"])
    want = np.asarray(jh.apply({"params": params}, jnp.asarray(f)))
    th = tup.FCNHead(DIM, NC, torch.Generator(), dtype=torch.float32)
    sd = from_flax_params({"auxiliary_head": params})
    th.load_state_dict({k[len("auxiliary_head."):]: _t(v)
                        for k, v in sd.items()}, strict=True)
    np.testing.assert_allclose(th(_t(f)).numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


# --- the segmentor --------------------------------------------------------------

@pytest.mark.parametrize("mode,norm", [("mask", "gn"), ("dispatch", "gn"),
                                       ("complete_model", "gn"),
                                       ("mask", "bn")])
def test_segmentor_matches_jax_fp32(monkeypatch, mode, norm):
    """fp32 logits (and auxiliary logits) within 1e-4 of the largest |logit|,
    every gate decision identical."""
    jm, variables, tm = _pair(monkeypatch, norm=norm)
    x = _image()
    jl, ja, jaux = jm.apply(variables, jnp.asarray(x), **MODES[mode])
    tl, ta, taux = tm(_t(x), **MODES[mode])
    assert tl.shape == (2, IMG, IMG, NC) and tl.dtype == torch.float32
    for got, want in ((tl, jl), (ta, ja)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    if mode == "complete_model":
        assert taux["token_select"] is None and jaux["token_select"] is None
    else:
        np.testing.assert_array_equal(taux["token_select"].numpy(),
                                      np.asarray(jaux["token_select"]))
    _, no_aux, _ = tm(_t(x), aux_logits=False, **MODES[mode])
    assert no_aux is None


@pytest.mark.parametrize("mode", ["mask", "dispatch"])
def test_segmentor_matches_jax_bf16(monkeypatch, mode):
    """bf16 compute and residual stream: both sides round at the same
    points, but the layers outside the kernels (convs, GELU, GroupNorm
    inputs, jax.nn.gelu on bf16) round through different library code, a
    bf16 ulp (2**-8) here and there; over 8 seeds the logits differ by
    0.39-0.70% of their largest magnitude (with one rounding per Dense,
    0.43-1.45% over 4), held to 1%.

    Unlike the image model's pooled logits, a segmentor's logits are per
    pixel: a token whose gate flips (a router logit within noise of 0, or
    two scores within noise of each other at the dispatch capacity) rewrites
    its own 16x16 patch.  So the logits are held with the JAX model's gate
    decisions replayed (its router scores fed to the port's dispatch; in
    mask mode the gates already agree), and the free-running gates agree on
    at least 95% of tokens (128 gates per forward at this size).  The
    head is 256 channels wide here: GroupNorm's 32 groups then hold 8
    channels (the real head's hold 24), where at 64 a group on the PSP's
    1x1 map holds 2 values, whose normalised sign bf16 noise can flip."""
    jm, variables, tm = _pair(monkeypatch, dtype="bfloat16",
                              head_channels=256)
    x = _image()
    jl, _, jaux = jm.apply(variables, jnp.asarray(x), **MODES[mode])
    tl, _, taux = tm(_t(x), aux_logits=False, **MODES[mode])
    same = taux["token_select"].numpy() == np.asarray(jaux["token_select"])
    assert same.mean() >= 0.95
    if mode == "dispatch":
        jl_tok = _t(_np(jaux["token_logits"]))
        scores = iter([torch.cat([torch.full((2, 1), float("inf")),
                                  torch.sigmoid(jl_tok[:, i, :, 0])], dim=1)
                       for i in range(DEPTH)])
        real = tlayers.D.dispatch_mlp
        replay = lambda x, s, *a: real(x, next(scores), *a)
        with mock.patch.object(tlayers.D, "dispatch_mlp", replay):
            tl, _, taux = tm(_t(x), aux_logits=False, **MODES[mode])
        np.testing.assert_array_equal(taux["token_select"].numpy(),
                                      _np(jaux["token_select"]))
    want = _np(jl)
    np.testing.assert_allclose(tl.float().numpy(), want, rtol=0,
                               atol=0.01 * np.abs(want).max())


def test_segmentor_int8_serves_int8():
    """An int8 segmentor quantizes where JAX does: the stem, every block's
    MLP (K4's plain version; attention stays on K9), every ConvModule
    (q8_conv); the fp32 classifiers stay fp32.  Its logits move away from
    the fp32 model's by more than the int8 tolerance (1e-2 of the largest
    logit); training runs the fp32 path, the same as the fp32 model's."""
    params, stats = _seg_variables()
    sd = {k: _t(v) for k, v in from_flax_params(params, stats).items()}
    models = {}
    for quant in ("none", "int8"):
        mc = port_cfg(dataclasses.replace(model_cfg(), quant=quant))
        m = tup.DyTSegmentor(mc, num_classes=NC, tuning=port_cfg(TUNING),
                             select=port_cfg(SELECT), head_channels=HEAD_CH,
                             dtype=torch.float32)
        m.load_state_dict(sd, strict=True)
        m.decode_head.dropout = m.auxiliary_head.dropout = 0.0
        models[quant] = m
    q8 = models["int8"]
    assert q8.decode_head.fpn_bottleneck.quant == "int8"
    assert q8.auxiliary_head.conv0.quant == "int8"
    x = _t(_image())
    f32, _, _ = models["none"](x)
    got, _, _ = q8(x)
    assert (got - f32).abs().max() > 1e-2 * f32.abs().max()
    noise = torch.from_numpy(np.random.RandomState(3).logistic(
        size=(2, DEPTH, GRID * GRID, 1)).astype(np.float32))
    with torch.enable_grad():
        train = [m(x, training=True, gate_noise=noise,
                   draws=tlayers.Draws("cpu", gate=0, dropout=1))[0]
                 for m in models.values()]
    assert torch.equal(train[0], train[1])


# --- slide inference ------------------------------------------------------------

def test_slide_inference_matches_jax(monkeypatch):
    """An 80x96 image at crop 64 / stride 43 (four overlapping windows),
    through the whole segmentor on both sides.  fp32, 1e-4."""
    jm, variables, tm = _pair(monkeypatch)
    img = _image(1, seed=9, h=80, w=96)[0]
    apply_j = jax.jit(lambda v, t: jm.apply(v, t)[0])
    want = np.asarray(jup.slide_inference(apply_j, variables,
                                          jnp.asarray(img), num_classes=NC,
                                          crop=64, stride=43))
    calls = []

    def apply_t(tiles):
        calls.append(tiles.shape[0])
        return tm(tiles, aux_logits=False)[0]

    got = tup.slide_inference(apply_t, _t(img), num_classes=NC, crop=64,
                              stride=43)
    assert got.shape == (80, 96, NC) and calls == [1, 1, 1, 1]
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("tile_batch", [2, 3, 7, 50])
def test_slide_inference_tile_batch_identical(tile_batch):
    """Window tiles batched per call give the one-at-a-time result, the
    weight-0 padding tiles included (12 windows on a 40x56 image)."""
    rs = np.random.RandomState(0)
    img = _t(rs.randn(40, 56, 3).astype(np.float32))
    w = _t(rs.randn(3, 8).astype(np.float32))
    fn = lambda tiles: torch.tanh(tiles @ w)[..., :5]
    ref = tup.slide_inference(fn, img, num_classes=5, crop=16, stride=11)
    got = tup.slide_inference(fn, img, num_classes=5, crop=16, stride=11,
                              tile_batch=tile_batch)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)
    want = jup.slide_inference(lambda p, t: jnp.tanh(t @ p)[..., :5],
                               jnp.asarray(w.numpy()), jnp.asarray(img.numpy()),
                               num_classes=5, crop=16, stride=11)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# --- resize and pooling -----------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((4, 6), (16, 16)), ((16, 16), (5, 3)),
                                     ((6, 6), (2, 9)), ((3, 3), (64, 64))])
def test_resize_matches_jax(src, dst):
    """The port's bilinear (align_corners=False, no antialias), in eval and
    on a tensor that requires grad, against the JAX package's _resize,
    upscaling and downscaling."""
    x = np.random.RandomState(10).randn(2, *src, 5).astype(np.float32)
    want = np.asarray(jup._resize(jnp.asarray(x), dst))
    for grad in (False, True):      # F.interpolate; the axis matrices
        xt = _t(x).permute(0, 3, 1, 2).requires_grad_(grad)
        got = tup._resize(xt, dst).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("hw,out", [(16, 3), (16, 6), (2, 3), (2, 6), (7, 5)])
def test_adaptive_pool_matches_jax(hw, out):
    """The port's pooling, in eval (torch's AdaptiveAvgPool2d) and on a
    tensor that requires grad (the window matrices), against the JAX
    package's."""
    x = np.random.RandomState(11).randn(2, hw, hw, 4).astype(np.float32)
    want = np.asarray(jup._adaptive_avg_pool(jnp.asarray(x), out))
    for grad in (False, True):
        xt = _t(x).permute(0, 3, 1, 2).requires_grad_(grad)
        got = tup._adaptive_avg_pool(xt, out).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-6)


# --- loss, metrics, data --------------------------------------------------------

@pytest.mark.parametrize("minimal_weight", [0.0, 1.5])
def test_token_budget_loss_matches_jax(minimal_weight):
    ts = np.random.RandomState(12).rand(2, 4, 16, 1).astype(np.float32)
    cfg = SelectConfig(token_minimal=0.6, token_minimal_weight=minimal_weight)
    want = float(jlosses.token_budget_loss(jnp.asarray(ts), cfg))
    got = float(tlosses.token_budget_loss(_t(ts), port_cfg(cfg)))
    # the mean over 128 gates in another order: ~1e-9 off a 0.498 mean
    assert got == pytest.approx(want, rel=1e-6, abs=1e-8)
    assert float(tlosses.token_budget_loss(None, port_cfg(cfg))) == 0.0


def test_metrics_match_jax():
    rs = np.random.RandomState(13)
    pred = rs.randint(0, 6, (40, 50))
    label = rs.randint(0, 5, (40, 50)).astype(np.uint8)   # class 5 absent
    label[:7] = 255
    want = jmetrics.confusion_matrix(pred, label, 6)
    got = tmetrics.confusion_matrix(pred, label, 6)
    np.testing.assert_array_equal(got, want)
    (wm, wc), (gm, gc) = (jmetrics.miou_from_confusion(want),
                          tmetrics.miou_from_confusion(got))
    assert gm == wm
    np.testing.assert_array_equal(gc, wc)


def test_synthetic_dataset_and_normalize_match_jax():
    for train, seed in ((True, 0), (False, 1)):
        a = jseg_data.SyntheticSegDataset(5, 32, 150, train=train, seed=seed)
        b = tseg_data.SyntheticSegDataset(5, 32, 150, train=train, seed=seed)
        for i in range(5):
            np.testing.assert_array_equal(a[i][0], b[i][0])
            np.testing.assert_array_equal(a[i][1], b[i][1])
    img = a[0][0]
    np.testing.assert_array_equal(tseg_data.seg_normalize(img).numpy(),
                                  np.asarray(jseg_data.seg_normalize(img)))
    with pytest.raises(KeyError):
        tseg_data.build_seg_dataset("cityscapes", "")


def test_ade20k_reader_matches_jax(tmp_path):
    """The ADE20K reader on two small images: the same training crops
    (resize, crop, flip, photometric distortion from the per-item seed) and
    the same evaluation images and original-resolution labels."""
    from PIL import Image
    rs = np.random.RandomState(14)
    for split in ("training", "validation"):
        (tmp_path / "images" / split).mkdir(parents=True)
        (tmp_path / "annotations" / split).mkdir(parents=True)
        for i, (h, w) in enumerate(((40, 60), (70, 50))):
            Image.fromarray(rs.randint(0, 256, (h, w, 3), np.uint8)).save(
                tmp_path / "images" / split / f"im{i}.jpg")
            Image.fromarray(rs.randint(0, 151, (h, w)).astype(np.uint8)).save(
                tmp_path / "annotations" / split / f"im{i}.png")
    a = jseg_data.build_seg_dataset("ade20k", str(tmp_path), crop=32)
    b = tseg_data.build_seg_dataset("ade20k", str(tmp_path), crop=32)
    assert a[2] == b[2] == 150
    for ja, tb in ((a[0], b[0]), (a[1], b[1])):
        assert len(ja) == len(tb) == 2
        for i in range(2):
            for u, v in zip(ja[i], tb[i]):
                np.testing.assert_array_equal(u, v)


# --- weights --------------------------------------------------------------------

def test_seg_bridge_round_trip():
    """Every flax param (and BatchNorm statistic) of a segmentor reaches a
    port parameter or buffer with the same values; the port loads them
    strictly and its own state dict gives them back."""
    params, stats = _seg_variables("bn")
    sd = from_flax_params(params, stats)
    n_flax = (len(jax.tree_util.tree_leaves(params))
              + len(jax.tree_util.tree_leaves(stats)))
    assert len(sd) == n_flax
    tm = tup.DyTSegmentor(port_cfg(model_cfg()), num_classes=NC,
                          tuning=port_cfg(TUNING), select=port_cfg(SELECT),
                          head_channels=HEAD_CH, norm="bn",
                          dtype=torch.float32)
    tm.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    own = tm.state_dict()
    assert sorted(own) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(own[k], _t(v)), k
    table = params["backbone"]["blocks_1"]["attn"][
        "relative_position_bias_table"]
    np.testing.assert_array_equal(
        sd["backbone.blocks.1.attn.relative_position_bias_table"], table)
    assert sd["decode_head.psp.pool_0.bn.running_var"].shape == (HEAD_CH,)


def test_deconv_bridge_flips_the_kernel():
    """flax's ConvTranspose does not flip its kernel and torch's does: the
    bridged kernel reproduces flax's output exactly."""
    x = np.random.RandomState(15).randn(2, 3, 5, 6).astype(np.float32)
    m = fnn.ConvTranspose(4, (2, 2), strides=(2, 2))
    p = m.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    p = {"kernel": np.random.RandomState(16).randn(2, 2, 6, 4).astype(
        np.float32), "bias": np.asarray(p["bias"]) + 0.5}
    want = np.asarray(m.apply({"params": p}, jnp.asarray(x)))
    sd = from_flax_params({"backbone": {"fpn2_deconv": p}})
    w, b = _t(sd["backbone.fpn2_deconv.weight"]), _t(
        sd["backbone.fpn2_deconv.bias"])
    assert w.shape == (6, 4, 2, 2)
    got = torch.nn.functional.conv_transpose2d(
        _t(x).permute(0, 3, 1, 2), w, b, stride=2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("old,new", [(196, 16), (16, 1024), (196, 1024)])
def test_interpolate_pos_embed_matches_jax(old, new):
    pe = np.random.RandomState(17).randn(1, old + 1, 32).astype(np.float32)
    want = jpos.interpolate_pos_embed(pe, new, 1)
    got = tpos.interpolate_pos_embed(pe, new, 1)
    assert got.shape == want.shape == (1, new + 1, 32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_load_timm_into_seg_backbone_interpolates_pos_embed():
    """An IN21K-shaped (224^2, 197-token) state dict into the 64^2 seg
    backbone: the pos-embed is interpolated as import_pretrained does, the
    rel-pos tables, FPN and DyT parts stay missing, head and norm are
    unexpected."""
    sd = make_vit_state_dict(np.random.RandomState(18), depth=DEPTH, dim=DIM,
                             ffn=FFN, classes=1000, img=224, patch=PATCH)
    tb = SegVisionTransformer(port_cfg(model_cfg()), port_cfg(TUNING),
                              port_cfg(SELECT), dtype=torch.float32)
    missing, unexpected = load_timm_state_dict(tb, sd, log=lambda *a: None)
    assert sorted(unexpected) == ["head.bias", "head.weight", "norm.bias",
                                  "norm.weight"]
    assert "blocks.0.attn.relative_position_bias_table" in missing
    assert "fpn1_deconv1.weight" in missing
    assert "pos_embed" not in missing
    jb = JSegViT(model_cfg(), tuning=TUNING, select=SELECT,
                 dtype=jnp.float32)
    jparams = _init(jb, jnp.zeros((1, IMG, IMG, 3)))["params"]
    jparams, _ = import_pretrained(jparams, sd, logger=_Quiet())
    np.testing.assert_allclose(tb.pos_embed.detach().numpy(),
                               np.asarray(jparams["pos_embed"]), rtol=1e-6,
                               atol=1e-6)


class _Quiet:
    def info(self, *a):
        pass


def test_make_seg_state_dict_loads_strictly():
    for norm in ("gn", "bn"):
        sd = make_seg_state_dict(np.random.RandomState(19), depth=DEPTH,
                                 dim=DIM, ffn=FFN, img=IMG, patch=PATCH,
                                 num_classes=NC, head_channels=HEAD_CH,
                                 norm=norm)
        tm = tup.DyTSegmentor(port_cfg(model_cfg()), num_classes=NC,
                              tuning=port_cfg(TUNING),
                              select=port_cfg(SELECT), head_channels=HEAD_CH,
                              norm=norm, dtype=torch.float32)
        tm.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
        assert np.abs(sd["backbone.blocks.0.attn.relative_position_bias_table"]
                      ).max() > 0.5


# --- the evaluation runner and its CLI -------------------------------------------

def test_seg_runner_evaluate_matches_jax_pipeline(monkeypatch):
    """SegRunner.evaluate (normalize -> slide -> argmax -> confusion ->
    mIoU, aAcc) on 2 synthetic images against the same pipeline on the JAX
    side (seg_normalize, slide_inference, the JAX segmentor, the JAX
    metrics).  The runner's model and data are swapped for the test's
    7-class ones."""
    jm, variables, tm = _pair(monkeypatch)
    cfg = tcfg.RunConfig(model=port_cfg(model_cfg()), tuning=port_cfg(TUNING),
                         select=port_cfg(SELECT),
                         data=tcfg.DataConfig(dataset="synthetic"),
                         compute_dtype="float32", output_dir="")
    runner = SegRunner(cfg, crop=IMG, slide_stride=43,
                       head_channels=HEAD_CH, device="cpu",
                       log=lambda m: None)
    ds = tseg_data.SyntheticSegDataset(4, IMG, NC, train=False, seed=1)
    runner.model, runner.val_ds, runner.num_classes = tm, ds, NC
    got = runner.evaluate(max_images=2)
    apply_j = jax.jit(lambda v, t: jm.apply(v, t)[0])
    cm = np.zeros((NC, NC), np.int64)
    for i in range(2):
        img, ann = ds[i]
        logits = jup.slide_inference(apply_j, variables,
                                     jseg_data.seg_normalize(jnp.asarray(img)),
                                     num_classes=NC, crop=IMG, stride=43)
        cm += jmetrics.confusion_matrix(np.asarray(jnp.argmax(logits, -1)),
                                        ann, NC)
    miou, _ = jmetrics.miou_from_confusion(cm)
    assert got["images"] == 2
    assert got["miou"] == pytest.approx(miou, abs=1e-9)
    assert got["aAcc"] == pytest.approx(np.diag(cm).sum() / cm.sum() * 100)


def test_seg_train_cli(tmp_path):
    """The reference's seg_train.py defaults; the entry point wants a card
    unless asked for the CPU; --device cpu trains (ViT-B at a 32^2 crop, 4
    iterations, evaluations of the 16 synthetic images at 2 and 4) and
    saves; a run resumed from the iteration-2 checkpoint ends the same;
    its runner evaluates that checkpoint (--eval_ckpt)."""
    p = seg_train.get_args_parser()
    args = p.parse_args(["--dataset", "synthetic", "--crop_size", "32",
                         "--device", "cpu", "--compute_dtype", "float32"])
    assert (args.batch_size, args.lr, args.weight_decay, args.drop_path,
            args.slide_stride, args.seg_norm, args.total_iters,
            args.eval_interval) == (2, 1e-3, 0.05, 0.1, 341, "gn", 160_000,
                                    16_000)
    assert p.parse_args([]).dataset == "ade20k"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            seg_train.build_runner(p.parse_args(["--eval"]))

    train = ["--dataset", "synthetic", "--crop_size", "32", "--device", "cpu",
             "--compute_dtype", "float32", "--total_iters", "4",
             "--eval_interval", "2", "--num_workers", "1",
             "--no_auto_remove"]
    a, c = tmp_path / "a", tmp_path / "c"
    with torch.enable_grad():
        out = seg_train.main(p.parse_args(train + ["--output_dir", str(a)]))
        assert set(out) == {"max_miou"} and out["max_miou"] >= 0.0
        assert (a / "checkpoint-2.pth").exists()
        runner = seg_train.build_runner(p.parse_args(train + [
            "--output_dir", str(c), "--resume", str(a / "checkpoint-2.pth")]),
            log=lambda m: None)
        assert runner.device.type == "cpu" and runner.num_classes == 150
        assert runner.start_iter == 2
        assert runner.run() == out
    runner.load_eval_checkpoint(str(a / "checkpoint-2.pth"))
    stats = runner.evaluate(max_images=1)
    assert stats["images"] == 1 and 0.0 <= stats["aAcc"] <= 100.0
