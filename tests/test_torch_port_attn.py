"""The port's attention kernels K1, K13, K14 and K15 (plain versions, on the
CPU) against the JAX package's Pallas kernels in interpret mode, and the
paths that reach them: the speed-test attention (K15), the unfused
Attention, the LayerScale / BEiT q/v-bias Block and the segmentation
backbones without windows (K1) or with them (``beit_backbone``, K9).

Inputs come from numpy with a fixed seed and go to both sides.  The JAX
side runs its kernels as its own tests do: ``interpret=True`` on an op,
``DYT_FUSED_ATTN=interpret`` for modules.

Tolerances, stated where used:

* bf16 outputs of K1 and K15 within one bf16 ulp of the largest |output|
  (2**-7 relative): both sides round at the same points; only the order of
  an fp32 sum differs, which can move one rounding by one ulp.
* K1 in fp32 at 1e-5 (summation order only).
* K13/K14 with fp32 I/O: 99% of outputs within 1e-5 of the largest
  |output|, all within two bf16 ulps.  The kernels round the normalised
  ``p = exp(s - m) / l`` to bf16; XLA on the CPU and torch sum the scores
  and ``l`` in other orders and take exp with other code, so an fp32 ``p``
  that sits on a bf16 rounding boundary may round the other way, and moves
  the outputs that read it by up to 2**-8 * p * |v|.  bf16 I/O within two
  bf16 ulps.
"""

import dataclasses
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_tuning_tpu.config import ModelConfig, SelectConfig, TuningConfig
from dynamic_tuning_tpu.models import fast_inference as jfast
from dynamic_tuning_tpu.models import layers as jlayers
from dynamic_tuning_tpu.models import seg_vit as jseg
from dynamic_tuning_tpu.ops import flash_attention as jfa
from dynamic_tuning_tpu.ops import mha_serving as jms
from dynamic_tuning_tpu.ops import packed_attention as jpa
from dynamic_tuning_tpu_torch import config as tcfg
from dynamic_tuning_tpu_torch.checkpoint import (from_flax_params,
                                                 make_seg_state_dict)
from dynamic_tuning_tpu_torch.models import fast_inference as pfast
from dynamic_tuning_tpu_torch.models import layers as tlayers
from dynamic_tuning_tpu_torch.models import seg_vit as tseg
from dynamic_tuning_tpu_torch.ops import flash_attention as tfa
from dynamic_tuning_tpu_torch.ops import mha_serving as tms
from dynamic_tuning_tpu_torch.ops import packed_attention as tpa

BF16_ULP = 2.0 ** -7            # one bf16 ulp, relative to the magnitude
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _eval_only():
    with torch.no_grad():
        yield


def port_cfg(cfg):
    """The port's own config object with the fields of a JAX-package one."""
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(TDT[dtype])


def _j(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, dtype=np.float32)).astype(JDT[dtype])


def _within_ulps(got, want, ulps=1):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ulps * BF16_ULP * np.abs(want).max())


def _softmax_close(got, want, dtype):
    """K13/K14 outputs (see the module docstring)."""
    got = got.float().numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert err.max() <= 2 * BF16_ULP * scale, err.max() / scale
    if dtype == "float32":
        assert (err <= 1e-5 * scale).mean() >= 0.99, (
            (err > 1e-5 * scale).mean())


# --- K15 ----------------------------------------------------------------------

@pytest.mark.parametrize("N", [37, 197])
@pytest.mark.parametrize("hd", [64, 128])
def test_mha_serving_plain_matches_jax_kernel(hd, N):
    rs = np.random.RandomState(hd + N)
    q, k, v = (rs.randn(2, 2, N, hd) for _ in range(3))
    want = _np(jms.mha_serving(*(_j(a, "bfloat16") for a in (q, k, v)),
                               interpret=True))
    before = tms.mha_serving.launches
    got = tms.mha_serving(*(_t(a, "bfloat16") for a in (q, k, v)))
    assert tms.mha_serving.launches == before          # the CPU: no launch
    assert got.dtype == torch.bfloat16 and got.shape == (2, 2, N, hd)
    _within_ulps(got, want)


@pytest.mark.parametrize("hd", [64, 128])
def test_mha_serving_plain_on_views_of_raw_qkv(hd):
    """q, k, v as strided views of one [B, N, 3C] buffer, as the speed-test
    attention passes them."""
    B, N, H = 2, 50, 2
    qkv = np.random.RandomState(hd).randn(B, N, 3 * H * hd)
    split = lambda a: a.reshape(B, N, 3, H, hd).transpose(2, 0, 3, 1, 4)
    want = _np(jms.mha_serving(*split(_j(qkv, "bfloat16")), interpret=True))
    views = _t(qkv, "bfloat16").view(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    assert not views[0].is_contiguous()
    _within_ulps(tms.mha_serving(*views), want)


# --- K1 -----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("group", [2, 4])
def test_mha_serving_fused_plain_matches_jax_kernel(group, hd, dtype):
    qkv = np.random.RandomState(group + hd).randn(2, 29, 3 * 4 * hd)
    want = _np(jms.mha_serving_fused(_j(qkv, dtype), heads=4, group=group,
                                     interpret=True))
    before = tms.mha_serving_fused.launches
    got = tms.mha_serving_fused(_t(qkv, dtype), heads=4, group=group)
    assert tms.mha_serving_fused.launches == before
    assert got.dtype == TDT[dtype] and got.shape == (2, 29, 4 * hd)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        _within_ulps(got, want)


def test_mha_serving_fused_keeps_the_group_contract():
    qkv = torch.zeros((1, 9, 3 * 4 * 64))
    with pytest.raises(ValueError, match="divide"):
        tms.mha_serving_fused(qkv, heads=4, group=3)
    with pytest.raises(ValueError, match="multiple of 128"):
        tms.mha_serving_fused(torch.zeros((1, 9, 3 * 4 * 32)), heads=4,
                              group=2)


def test_mha_fused_reference_matches_jax():
    qkv = np.random.RandomState(1).randn(2, 17, 3 * 256)
    want = _np(jms.mha_fused_reference(_j(qkv), heads=4))
    got = tms.mha_fused_reference(_t(qkv), heads=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# --- K13 ----------------------------------------------------------------------

def _flash_inputs(B=2, H=3, N=37, D=16):
    rs = np.random.RandomState(N)
    return tuple(rs.randn(B, H, N, D) for _ in range(3))


# the six cases of tests/test_flash_attention.py
FLASH_CASES = {
    "unaligned": (dict(N=37), "float32", False),
    "aligned": (dict(N=128), "float32", False),
    "padding_mask": (dict(N=5), "float32", False),
    "bf16_io": (dict(N=64), "bfloat16", False),
    "long_seq": (dict(B=1, H=2, N=300), "float32", False),
    "relpos_bias": (dict(B=2, H=2, N=300), "float32", True),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_plain_matches_jax_kernel(case):
    shape, dtype, with_bias = FLASH_CASES[case]
    q, k, v = _flash_inputs(**shape)
    N = q.shape[2]
    bias = (np.random.RandomState(7).randn(q.shape[1], N, N)
            if with_bias else None)
    want = _np(jfa.flash_attention(
        *(_j(a, dtype) for a in (q, k, v)),
        None if bias is None else _j(bias), interpret=True))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(*(_t(a, dtype) for a in (q, k, v)),
                              None if bias is None else _t(bias))
    assert tfa.flash_attention.launches == before
    assert got.shape == q.shape and got.dtype == TDT[dtype]   # unpadded
    _softmax_close(got, want, dtype)


def test_attention_references_match_jax():
    """The fp32 oracles of K13 and K14."""
    q, k, v = _flash_inputs(N=23)
    bias = np.random.RandomState(8).randn(3, 23, 23)
    want = _np(jfa.attention_reference(*map(_j, (q, k, v)), _j(bias)))
    got = tfa.attention_reference(*map(_t, (q, k, v)), _t(bias))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    qkv = np.random.RandomState(9).randn(2, 19, 3 * 64)
    want = _np(jpa.packed_attention_reference(_j(qkv), num_heads=4))
    got = tpa.packed_attention_reference(_t(qkv), num_heads=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# --- K14 ----------------------------------------------------------------------

# the three cases of tests/test_packed_attention.py
PACKED_CASES = {
    "unaligned": ((2, 197, 3 * 256), 4, "float32"),
    "multi_group": ((2, 64, 3 * 128), 8, "float32"),
    "bf16": ((1, 197, 3 * 256), 4, "bfloat16"),
}


@pytest.mark.parametrize("case", list(PACKED_CASES))
def test_packed_attention_plain_matches_jax_kernel(case):
    shape, heads, dtype = PACKED_CASES[case]
    qkv = np.random.RandomState(len(case)).randn(*shape)
    want = _np(jpa.packed_attention(_j(qkv, dtype), num_heads=heads,
                                    interpret=True))
    before = tpa.packed_attention.launches
    got = tpa.packed_attention(_t(qkv, dtype), num_heads=heads)
    assert tpa.packed_attention.launches == before
    assert got.shape == shape[:2] + (shape[2] // 3,)
    assert got.dtype == TDT[dtype]
    _softmax_close(got, want, dtype)


@pytest.mark.parametrize("heads,N", [(6, 64), (4, 257)],
                         ids=["heads_6", "n_257"])
def test_packed_attention_keeps_its_contract(heads, N):
    with pytest.raises(ValueError, match="divisible by 4|N <= 256"):
        tpa.packed_attention(torch.zeros((1, N, 3 * 64 * heads)),
                             num_heads=heads)


@pytest.mark.parametrize("call", [
    lambda t: tms.mha_serving(t, t, t),
    lambda t: tms.mha_serving_fused(t.reshape(1, 9, -1), heads=2),
    lambda t: tfa.flash_attention(t, t, t),
    lambda t: tpa.packed_attention(t.reshape(1, 9, -1), num_heads=4)],
    ids=["k15", "k1", "k13", "k14"])
def test_wrappers_refuse_other_devices(call):
    with pytest.raises(ValueError, match="CPU tensors"):
        call(torch.zeros((1, 2, 9, 192), device="meta"))


# --- fault 1: the scale at head dim 128 ---------------------------------------

@pytest.mark.parametrize("hd", [64, 128])
def test_weak_scale_rounds_like_jax(hd):
    """bf16 q * hd ** -0.5: JAX rounds the weak-typed Python float to bf16
    first, and so does ``ms.weak_scale``; the fp32 scale gives other
    products at hd = 128 (those of 4096 seeded values), none at hd = 64."""
    q = np.random.RandomState(0).randn(4096).astype(np.float32)
    want = _np(_j(q, "bfloat16") * hd ** -0.5)
    tq = _t(q, "bfloat16")
    got = (tq * tms.weak_scale(tq, hd)).float().numpy()
    np.testing.assert_array_equal(got, want)
    fp32_scale = (tq * hd ** -0.5).float().numpy()
    assert ((fp32_scale != want).sum() > 0) == (hd == 128)


FAST_DIM, FAST_HEADS = 256, 2               # head dim 128


@pytest.mark.parametrize("N", [17, 33])
def test_fast_attention_head_dim_128_matches_jax(N):
    """The speed-test forward's attention sublayer (folded LN -> qkv -> K15
    -> proj) at head dim 128, where bf16(128 ** -0.5) != fp32's: XLA
    multiplies q by the bf16-rounded scale.  All outputs within one bf16
    ulp of the largest |output|, and at most a tenth of them further than
    1e-5 from it: a bf16 rounding of the qkv products that sits on a
    boundary may round the other way (about 1 in 1000 here), and a k or v
    that moves by an ulp moves its head's outputs in every row (0-8% of
    them over these and other seeds); scaling q by the fp32 scale moves
    35-45%."""
    C, H = FAST_DIM, FAST_HEADS
    rs = np.random.RandomState(100 * N)
    x = rs.randn(3, N, C).astype(np.float32)
    wqkv, bqkv = rs.randn(C, 3 * C) * 0.05, rs.randn(3 * C) * 0.02
    wp, bp = rs.randn(C, C) * 0.05, rs.randn(C) * 0.02
    g, b = 1 + 0.05 * rs.randn(C), 0.02 * rs.randn(C)
    jp = jax.tree_util.tree_map(_j, {
        "norm1": {"scale": g, "bias": b},
        "attn": {"qkv": {"kernel": wqkv, "bias": bqkv},
                 "proj": {"kernel": wp, "bias": bp}}})
    want = _np(jfast._attention(_j(x, "bfloat16"), jp, H))
    tp = {"qkv": pfast._folded(_t(g), _t(b), _t(wqkv.T), _t(bqkv)),
          "proj": (_t(wp.T, "bfloat16"), _t(bp))}
    with mock.patch.object(tms, "mha_serving",
                           wraps=tms.mha_serving) as k15:
        got = pfast._attention(_t(x, "bfloat16"), tp, H)
    assert k15.call_count == 1
    err = np.abs(got.float().numpy() - want)
    scale = np.abs(want).max()
    assert err.max() <= BF16_ULP * scale
    assert (err > 1e-5 * scale).mean() <= 0.1, (err > 1e-5 * scale).mean()


class _Quiet:
    def info(self, *a):
        pass


@pytest.mark.parametrize("mode", ["dispatch", "mask", "dense"])
def test_fast_vit_forward_head_dim_128_matches_jax(mode):
    """The whole speed-test forward at head dim 128: identical gates, logits
    within 2e-2 of the largest (the bound of tests/test_torch_port_fast.py:
    the LNs and GELUs outside the attention round their fp32 sums through
    other library code, a bf16 ulp here and there, ~5e-3 of the logits at
    this size), and K15 once per block."""
    from dynamic_tuning_tpu.models.vit import VisionTransformer as JaxViT
    from dynamic_tuning_tpu.train.checkpoint import import_pretrained
    from dynamic_tuning_tpu_torch.checkpoint import make_vit_state_dict
    from dynamic_tuning_tpu_torch.models.vit import VisionTransformer

    img, patch, depth, ffn, classes = 32, 8, 2, 8, 10
    cfg = ModelConfig(img_size=img, patch_size=patch, num_classes=classes,
                      embed_dim=FAST_DIM, depth=depth, num_heads=FAST_HEADS)
    tuning = TuningConfig(ffn_num=ffn, d_model=FAST_DIM, dropout=0.0)
    sel = SelectConfig()
    rs = np.random.RandomState(0)
    sd = make_vit_state_dict(rs, depth=depth, dim=FAST_DIM, ffn=ffn,
                             classes=classes, img=img, patch=patch,
                             router_scale=1.0)
    x = rs.randn(3, img, img, 3).astype(np.float32)
    jm = JaxViT(cfg, tuning=tuning, select=sel, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x[:1]))["params"]
    params, _ = import_pretrained(params, sd, logger=_Quiet())
    for i in range(depth):
        head = params[f"blocks_{i}"]["mlp_token_select"]["mlp_head"]
        head["kernel"] = head["kernel"] * 60
    tm = VisionTransformer(port_cfg(cfg), tuning=port_cfg(tuning),
                           select=port_cfg(sel), dtype=torch.bfloat16)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        from_flax_params(params).items()}, strict=True)
    jl, jg = jfast.fast_vit_forward(params, jnp.asarray(x), cfg=cfg,
                                    tuning=tuning, select=sel, mode=mode)
    with mock.patch.object(tms, "mha_serving",
                           wraps=tms.mha_serving) as k15:
        tl, tg = pfast.fast_vit_forward(
            pfast.serving_params(tm), torch.from_numpy(x),
            cfg=port_cfg(cfg), tuning=port_cfg(tuning),
            select=port_cfg(sel), mode=mode)
    assert k15.call_count == depth
    if mode == "dense":
        assert jg is None and tg is None
    else:
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=2e-2 * np.abs(jl).max())


def _unfused_attention_128(monkeypatch, dense_bias: float):
    """(port output, JAX output) of Attention on its unfused branch, bf16,
    3 heads of 128 (the fused-kernel predicate wants an even head count),
    with the qkv and proj Dense biases drawn at ``dense_bias`` * N(0, 1)."""
    C, H, N = 384, 3, 19
    rs = np.random.RandomState(100 * N)
    x = rs.randn(2, N, C).astype(np.float32)
    ja = jlayers.Attention(H, dtype=jnp.bfloat16)
    monkeypatch.setenv("DYT_FUSED_ATTN", "0")
    params = ja.init(jax.random.PRNGKey(0), _j(x, "bfloat16"))["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + (dense_bias * rs.randn(*a.shape)).astype(np.float32)
        if "bias" in jax.tree_util.keystr(p) else a, params)
    want = _np(ja.apply({"params": params}, _j(x, "bfloat16")))
    ta = tlayers.Attention(C, H, torch.Generator(), dtype=torch.bfloat16)
    sd = from_flax_params({"attn": params})
    ta.load_state_dict({k[len("attn."):]: torch.from_numpy(v)
                        for k, v in sd.items()}, strict=True)
    with mock.patch.object(tms, "mha_serving_fused",
                           wraps=tms.mha_serving_fused) as k1:
        got = ta(_t(x, "bfloat16"))
    assert k1.call_count == 0
    return got.float().numpy(), want


def _within_one_ulp_mostly_exact(got, want):
    """All outputs within one bf16 ulp of the largest |output|, at most a
    tenth further than 1e-5 of it from the JAX module's."""
    err = np.abs(got - want)
    scale = np.abs(want).max()
    assert err.max() <= BF16_ULP * scale
    assert (err > 1e-5 * scale).mean() <= 0.1, (err > 1e-5 * scale).mean()


def test_unfused_attention_head_dim_128_matches_jax(monkeypatch):
    """The port's unfused Attention against the JAX module's, zero Dense
    biases: q times the bf16-rounded scale.  0-4% of outputs past 1e-5 of
    the largest over seeds; scaling q by the fp32 scale moves 18-27%."""
    _within_one_ulp_mostly_exact(*_unfused_attention_128(monkeypatch, 0.0))


def test_unfused_attention_head_dim_128_with_dense_biases_matches_jax(
        monkeypatch):
    """As above with qkv and proj biases of ~0.1: flax's Dense rounds the
    product to bf16, then adds the bias rounded to bf16, and so does the
    port's module path.  0-0.7% of outputs past 1e-5 of the largest over 4
    seeds; one rounding (``F.linear`` with its bias) moves 37-41%."""
    _within_one_ulp_mostly_exact(*_unfused_attention_128(monkeypatch, 0.1))


# --- LayerScale / q-v-bias blocks and models ------------------------------------

DIM, HEADS, FFN, IMG, PATCH, DEPTH = 128, 2, 8, 64, 16, 4
GRID = IMG // PATCH                          # 4x4 patches + CLS = 17 tokens
TUNING = TuningConfig(ffn_num=FFN, d_model=DIM)
SELECT = SelectConfig(token_target_ratio=0.5)
BLOCK_MODES = {"dispatch": (False, True), "mask": (False, False),
               "dense": (True, False)}    # (complete_model, dispatch)
SEG_MODES = {"mask": {}, "dispatch": {"dispatch": True},
             "complete_model": {"complete_model": True}}


def _matter(tree, seed=0):
    """Make every parameter count: q/v biases of a few tenths, LayerScale
    gammas spread around their init, nonzero rel-pos tables (~1) and
    adapter ups, router heads x50 (hard gates with margin)."""
    rs = np.random.RandomState(seed)

    def f(path, a):
        key = jax.tree_util.keystr(path)
        a = np.asarray(a)
        r = lambda s: (rs.randn(*a.shape) * s).astype(np.float32)
        if "q_bias" in key or "v_bias" in key:
            return a + r(0.3)
        if "_gamma" in key:
            return a * (1.0 + r(0.3))
        if "relative_position_bias_table" in key:
            return a + r(1.0)
        if "mlp_token_select" in key and "kernel" in key:
            return a * 50.0
        if "up_proj" in key:
            return a + r(0.05)
        return a

    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("mode", list(BLOCK_MODES))
def test_layerscale_qv_bias_block_matches_jax(monkeypatch, mode, quant):
    """A bf16 block with LayerScale and BEiT q/v biases and no window at
    N = 17: its Attention takes K1 on both sides (the Block does not fuse
    its sublayer), int8 its MLP on K4.  Gates identical, router logits
    within 1e-5 of the largest, block outputs within two bf16 ulps of the
    largest (the dense layers round fp32 sums of another order)."""
    monkeypatch.setenv("DYT_FUSED_ATTN", "interpret")
    x = np.random.RandomState(11).randn(3, GRID * GRID + 1, DIM)
    jb = jlayers.Block(HEADS, init_values=0.1, qv_bias_only=True,
                       quant=quant, tuning=TUNING, select_cfg=SELECT,
                       dtype=jnp.bfloat16)
    params = _matter(jb.init(jax.random.PRNGKey(0), _j(x, "bfloat16"))[
        "params"])
    complete, dispatch = BLOCK_MODES[mode]
    jx, jgate, jlog = jb.apply({"params": params}, _j(x, "bfloat16"), False,
                               complete, dispatch)
    tb = tlayers.Block(DIM, HEADS, torch.Generator(), init_values=0.1,
                       qv_bias_only=True, quant=quant,
                       tuning=port_cfg(TUNING), select_cfg=port_cfg(SELECT),
                       dtype=torch.bfloat16)
    tb.load_state_dict({k: torch.from_numpy(v) for k, v in
                        from_flax_params(params).items()}, strict=True)
    assert tb.attn.qkv.bias is None and "gamma_1" in dict(
        tb.named_parameters())
    with mock.patch.object(tms, "mha_serving_fused",
                           wraps=tms.mha_serving_fused) as k1:
        tx, tgate, tlog = tb(_t(x, "bfloat16"), complete, dispatch)
    assert k1.call_count == 1
    _within_ulps(tx, _np(jx), ulps=2)
    if mode == "dense":
        assert tgate is None and jgate is None
        return
    np.testing.assert_array_equal(tgate.numpy(), _np(jgate))
    want = _np(jlog)
    np.testing.assert_allclose(tlog.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _seg_pair(monkeypatch, make_jax, make_port, dtype="float32"):
    """(jax backbone, params, port backbone) with the same weights."""
    cfg = ModelConfig(img_size=IMG, patch_size=PATCH, embed_dim=DIM,
                      depth=DEPTH, num_heads=HEADS, residual_dtype=dtype)
    jm = make_jax(cfg, JDT[dtype])
    monkeypatch.setenv("DYT_FUSED_ATTN", "0")
    params = _matter(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                      jnp.zeros((1, IMG, IMG, 3)))["params"])
    monkeypatch.setenv("DYT_FUSED_ATTN", "interpret")
    tm = make_port(port_cfg(cfg), TDT[dtype])
    tm.load_state_dict(_backbone_sd(params), strict=True)
    return jm, params, tm


def _backbone_sd(params):
    """The port backbone's state dict from a flax backbone tree (the bridge
    maps the FPN transposed convs under a segmentor's ``backbone``)."""
    sd = from_flax_params({"backbone": params})
    return {k[len("backbone."):]: torch.from_numpy(v) for k, v in sd.items()}


def _check_features(tf, jf, taux, jaux):
    for a, b, s in zip(tf, jf, (16, 8, 4, 2)):
        assert a.shape == (2, s, s, DIM) and a.dtype == torch.float32
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())
    if jaux["token_select"] is None:
        assert taux["token_select"] is None
    else:
        np.testing.assert_array_equal(taux["token_select"].numpy(),
                                      np.asarray(jaux["token_select"]))
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=1e-6, atol=1e-7)


def _no_window_jax(cfg, dtype):
    return jseg.SegVisionTransformer(cfg, tuning=TUNING, select=SELECT,
                                     use_rel_pos_bias=False, init_values=0.1,
                                     qv_bias_only=True, dtype=dtype)


def _no_window_port(cfg, dtype):
    return tseg.SegVisionTransformer(cfg, port_cfg(TUNING),
                                     port_cfg(SELECT), use_rel_pos_bias=False,
                                     init_values=0.1, qv_bias_only=True,
                                     dtype=dtype)


@pytest.mark.parametrize("mode", list(SEG_MODES))
def test_no_window_layerscale_backbone_matches_jax(monkeypatch, mode):
    """SegVisionTransformer(use_rel_pos_bias=False, init_values=0.1,
    qv_bias_only=True), fp32: K1 in every block; the four feature maps
    within 1e-5, gates identical, the budget loss."""
    jm, params, tm = _seg_pair(monkeypatch, _no_window_jax, _no_window_port)
    x = np.random.RandomState(12).randn(2, IMG, IMG, 3).astype(np.float32)
    jf, jaux = jm.apply({"params": params}, jnp.asarray(x), **SEG_MODES[mode])
    with mock.patch.object(tms, "mha_serving_fused",
                           wraps=tms.mha_serving_fused) as k1:
        tf, taux = tm(torch.from_numpy(x), **SEG_MODES[mode])
    assert k1.call_count == DEPTH
    _check_features(tf, jf, taux, jaux)


def _beit_jax(cfg, dtype):
    return jseg.beit_backbone(cfg, tuning=TUNING, select=SELECT, dtype=dtype)


def _beit_port(cfg, dtype):
    return tseg.beit_backbone(cfg, port_cfg(TUNING), port_cfg(SELECT),
                              dtype=dtype)


@pytest.mark.parametrize("mode", ["mask", "dispatch"])
def test_beit_backbone_matches_jax(monkeypatch, mode):
    """beit_backbone, fp32: K9 in every block with LayerScale and q/v
    biases on the module path, no absolute pos-embed."""
    jm, params, tm = _seg_pair(monkeypatch, _beit_jax, _beit_port)
    assert not hasattr(tm, "pos_embed")
    x = np.random.RandomState(13).randn(2, IMG, IMG, 3).astype(np.float32)
    jf, jaux = jm.apply({"params": params}, jnp.asarray(x), **SEG_MODES[mode])
    with mock.patch.object(tms, "mha_windowed_fused",
                           wraps=tms.mha_windowed_fused) as k9:
        tf, taux = tm(torch.from_numpy(x), **SEG_MODES[mode])
    assert k9.call_count == DEPTH
    _check_features(tf, jf, taux, jaux)


def test_beit_backbone_bf16_given_the_same_dispatch(monkeypatch):
    """bf16 dispatch: the JAX model's router scores replayed into the port's
    dispatch (a gate that flips near 0 changes its token's features
    outright), then the features within 2% of the largest, as
    tests/test_torch_port_seg.py holds the bf16 segmentor; the free-running
    gates agree on at least 95% of tokens."""
    jm, params, tm = _seg_pair(monkeypatch, _beit_jax, _beit_port,
                               "bfloat16")
    x = np.random.RandomState(14).randn(2, IMG, IMG, 3).astype(np.float32)
    jf, jaux = jm.apply({"params": params}, jnp.asarray(x), dispatch=True)
    _, taux = tm(torch.from_numpy(x), dispatch=True)
    same = taux["token_select"].numpy() == _np(jaux["token_select"])
    assert same.mean() >= 0.95
    jl_tok = torch.from_numpy(_np(jaux["token_logits"]).copy())
    scores = iter([torch.cat([torch.full((2, 1), float("inf")),
                              torch.sigmoid(jl_tok[:, i, :, 0])], dim=1)
                   for i in range(DEPTH)])
    real = tlayers.D.dispatch_mlp
    with mock.patch.object(tlayers.D, "dispatch_mlp",
                           lambda x, s, *a: real(x, next(scores), *a)):
        tf, taux = tm(torch.from_numpy(x), dispatch=True)
    np.testing.assert_array_equal(taux["token_select"].numpy(),
                                  _np(jaux["token_select"]))
    for a, b in zip(tf, jf):
        b = _np(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=0.02 * np.abs(b).max())


def test_beit_weight_bridge_round_trip(monkeypatch):
    """q_bias, v_bias, ls1_gamma and ls2_gamma cross to attn.q_bias,
    attn.v_bias, gamma_1 and gamma_2; the port loads them strictly and its
    state dict gives them back.  The seeded segmentor weights with the BEiT
    knobs load strictly into the BEiT backbone."""
    jm, params, tm = _seg_pair(monkeypatch, _beit_jax, _beit_port)
    sd = _backbone_sd(params)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    own = tm.state_dict()
    assert sorted(own) == sorted(sd)
    blk = params["blocks_2"]
    for flax_val, key in ((blk["attn"]["q_bias"], "blocks.2.attn.q_bias"),
                          (blk["attn"]["v_bias"], "blocks.2.attn.v_bias"),
                          (blk["ls1_gamma"], "blocks.2.gamma_1"),
                          (blk["ls2_gamma"], "blocks.2.gamma_2")):
        np.testing.assert_array_equal(own[key].numpy(), np.asarray(flax_val))
    assert "blocks.0.attn.qkv.bias" not in own
    seeded = make_seg_state_dict(
        np.random.RandomState(0), depth=DEPTH, dim=DIM, ffn=FFN, img=IMG,
        patch=PATCH, num_classes=7, use_abs_pos_embed=False,
        init_values=0.1, qv_bias_only=True)
    bb = {k[len("backbone."):]: torch.from_numpy(v) for k, v in
          seeded.items() if k.startswith("backbone.")}
    tm.load_state_dict(bb, strict=True)
    assert abs(float(bb["blocks.1.gamma_2"].mean()) - 0.1) < 0.01
