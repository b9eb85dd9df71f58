"""The port's speed-test inference path against the JAX package, on the CPU:
K11 (``ops/fused_mlp.fused_ln_mlp``, here its plain version), the fast
forward ``fast_vit_forward`` in dense, mask and dispatch, ``chunked_serving``,
the eval transforms and the ``predict`` entry point.

Size: img 32, patch 8 (17 tokens), width 64, 4 heads, depth 2, MLP 256,
adapter 8; inputs from a numpy seed.  The JAX side runs its Pallas kernel
in interpret mode (``use_pallas=True, interpret=True``) where the port runs
K11's plain version, and its unfused jnp MLP where the port runs the cuBLAS
chain (``use_kernel=False``).

Tolerances.  K11: both sides round at the same points; only the order of
the fp32 sums differs, which can move a bf16 rounding of h or of the output
by one ulp, so outputs agree to two bf16 ulps of the largest |output|, and
gated-off rows are exactly 0.  The forward: gates identical (the router
heads are scaled x60, as tests/test_fast_inference.py does, so no logit sits
near the threshold) and logits within 2e-2 of the largest |logit|, the bound
the JAX package holds its own Pallas-vs-jnp forward to.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import predict as jax_predict
from dynamic_tuning_tpu.config import ModelConfig, SelectConfig, TuningConfig
from dynamic_tuning_tpu.data import transforms as jax_transforms
from dynamic_tuning_tpu.models import fast_inference as jfast
from dynamic_tuning_tpu.models.vit import VisionTransformer as JaxViT
from dynamic_tuning_tpu.ops.fused_mlp import fused_ln_mlp as jax_fused_ln_mlp
from dynamic_tuning_tpu.train.checkpoint import import_pretrained
from dynamic_tuning_tpu_torch import config as tcfg
from dynamic_tuning_tpu_torch import predict as port_predict
from dynamic_tuning_tpu_torch.checkpoint import (from_flax_params,
                                                 make_vit_state_dict)
from dynamic_tuning_tpu_torch.data import transforms as port_transforms
from dynamic_tuning_tpu_torch.models import fast_inference as pfast
from dynamic_tuning_tpu_torch.models.vit import VisionTransformer
from dynamic_tuning_tpu_torch.ops import fused_mlp as fm

IMG, PATCH, DIM, HEADS, DEPTH, FFN, CLASSES = 32, 8, 64, 4, 2, 8, 10
BF16_REL = 2 * 2.0 ** -8
LOGIT_REL = 2e-2
MODES = ("dense", "mask", "dispatch")


def port_cfg(cfg):
    """The port's own config object with the fields of a JAX-package one."""
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


class _Quiet:
    def info(self, *a):
        pass


# --- K11 ---------------------------------------------------------------------

def _mlp_inputs(M=40, C=64, H=256, seed=0):
    rs = np.random.RandomState(seed)
    r = lambda *s, sc=1.0: (rs.randn(*s) * sc).astype(np.float32)
    x = r(M, C)
    return (x, 1.0 + r(C, sc=0.1), r(C, sc=0.1), r(C, H, sc=0.05),
            r(H, sc=0.1), r(H, C, sc=0.05), r(C, sc=0.1),
            (rs.rand(M, 1) > 0.5).astype(np.float32))


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gelu_approx", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("gated", [False, True], ids=["no_gate", "gate"])
def test_fused_ln_mlp_matches_jax_kernel(gated, gelu_approx, xdtype):
    x, g, b, w1, b1, w2, b2, gate = _mlp_inputs()
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[xdtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[xdtype]
    want = np.asarray(jax_fused_ln_mlp(
        jnp.asarray(x).astype(jdt), jnp.asarray(g), jnp.asarray(b),
        jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(b2),
        jnp.asarray(gate).astype(jdt) if gated else None,
        gelu_approx=gelu_approx, tile_m=16, interpret=True)
        .astype(jnp.float32))
    t = torch.from_numpy
    before = fm.fused_ln_mlp.launches
    got = fm.fused_ln_mlp(
        t(x).to(tdt), t(g), t(b), t(w1.T.copy()).to(torch.bfloat16), t(b1),
        t(w2.T.copy()).to(torch.bfloat16), t(b2),
        t(gate).to(tdt) if gated else None, gelu_approx=gelu_approx)
    assert fm.fused_ln_mlp.launches == before          # the CPU: no launch
    assert got.dtype == tdt and got.shape == x.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_REL * np.abs(want).max())
    if gated:
        off = gate[:, 0] == 0
        assert off.any()
        np.testing.assert_array_equal(got[off], 0.0)


# --- fast_vit_forward --------------------------------------------------------

def _configs(**tuning):
    cfg = ModelConfig(img_size=IMG, patch_size=PATCH, num_classes=CLASSES,
                      embed_dim=DIM, depth=DEPTH, num_heads=HEADS)
    return (cfg, TuningConfig(ffn_num=FFN, d_model=DIM, dropout=0.0,
                              **tuning), SelectConfig())


def _pair(seed=0, batch=3, **tuning):
    """(jax params, port serving params, x, configs): the same weights on
    both sides, through the weight bridge."""
    cfg, tuning_cfg, sel = _configs(**tuning)
    rs = np.random.RandomState(seed)
    sd = make_vit_state_dict(rs, depth=DEPTH, dim=DIM, ffn=FFN,
                             classes=CLASSES, img=IMG, patch=PATCH,
                             router_scale=1.0)
    x = rs.randn(batch, IMG, IMG, 3).astype(np.float32)
    jm = JaxViT(cfg, tuning=tuning_cfg, select=sel, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x[:1]))["params"]
    params, _ = import_pretrained(params, sd, logger=_Quiet())
    for i in range(DEPTH):
        blk = params[f"blocks_{i}"]
        head = blk["mlp_token_select"]["mlp_head"]
        head["kernel"] = head["kernel"] * 60
        if "scale" in blk["adaptmlp"]:
            blk["adaptmlp"]["scale"] = jnp.full((1,), 0.7)
    tm = VisionTransformer(port_cfg(cfg), tuning=port_cfg(tuning_cfg),
                           select=port_cfg(sel), dtype=torch.bfloat16)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        from_flax_params(params).items()}, strict=True)
    return params, pfast.serving_params(tm), x, (cfg, tuning_cfg, sel)


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _check(jax_out, port_out, mode):
    jl, jg = (np.asarray(a) if a is not None else None for a in jax_out)
    tl, tg = port_out
    if mode == "dense":
        assert jg is None and tg is None
    else:
        assert tg.dtype == torch.float32
        np.testing.assert_array_equal(tg.numpy(), jg)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=LOGIT_REL * np.abs(jl).max())


@pytest.mark.parametrize("kernel", [False, True], ids=["cublas", "k11"])
@pytest.mark.parametrize("mode", MODES)
def test_fast_vit_forward_matches_jax(pair, mode, kernel):
    params, tparams, x, (cfg, tuning, sel) = pair
    want = jfast.fast_vit_forward(params, jnp.asarray(x), cfg=cfg,
                                  tuning=tuning, select=sel, mode=mode,
                                  use_pallas=kernel, interpret=kernel)
    got = pfast.fast_vit_forward(tparams, torch.from_numpy(x),
                                 cfg=port_cfg(cfg), tuning=port_cfg(tuning),
                                 select=port_cfg(sel), mode=mode,
                                 use_kernel=kernel)
    _check(want, got, mode)
    if mode == "dispatch":
        # capacity K = 9 of 17 slots: the dispatch really cuts tokens
        assert got[1][:, :, 1:].sum(dim=2).max() <= 8


def test_fast_vit_forward_learnable_scalar():
    params, tparams, x, (cfg, tuning, sel) = _pair(
        seed=1, ffn_adapter_scalar="learnable_scalar")
    assert "adapter_scale" in tparams["blocks"][0]
    kw = dict(mode="mask")
    want = jfast.fast_vit_forward(params, jnp.asarray(x), cfg=cfg,
                                  tuning=tuning, select=sel, **kw)
    got = pfast.fast_vit_forward(tparams, torch.from_numpy(x),
                                 cfg=port_cfg(cfg), tuning=port_cfg(tuning),
                                 select=port_cfg(sel), **kw)
    _check(want, got, "mask")
    # the scale matters
    for blk in tparams["blocks"]:
        blk["adapter_scale"] = torch.zeros(1)
    got0 = pfast.fast_vit_forward(tparams, torch.from_numpy(x),
                                  cfg=port_cfg(cfg), tuning=port_cfg(tuning),
                                  select=port_cfg(sel), **kw)
    assert (got0[0] - got[0]).abs().max() > 1e-3


@pytest.mark.parametrize("tuning,match", [
    (dict(ffn_adapter_layernorm_option="in"), "layernorm_option"),
    (dict(moe_experts=4), "MoE")])
def test_fast_vit_forward_refuses_like_jax(tuning, match):
    cfg, tuning_cfg, sel = _configs(**tuning)
    x = np.zeros((1, IMG, IMG, 3), np.float32)
    with pytest.raises(ValueError, match=match):
        jfast.fast_vit_forward({}, jnp.asarray(x), cfg=cfg,
                               tuning=tuning_cfg, select=sel, mode="dense")
    with pytest.raises(ValueError, match=match):
        pfast.fast_vit_forward({}, torch.from_numpy(x), cfg=port_cfg(cfg),
                               tuning=port_cfg(tuning_cfg),
                               select=port_cfg(sel), mode="dense")


def test_chunked_serving_matches_monolithic():
    _, tparams, x, (cfg, tuning, sel) = _pair(seed=2, batch=10)
    x = torch.from_numpy(x)
    kw = dict(cfg=port_cfg(cfg), tuning=port_cfg(tuning),
              select=port_cfg(sel))

    def fwd(c, mode="dispatch"):
        return pfast.fast_vit_forward(tparams, c, mode=mode, **kw)

    ref_logits, ref_gates = fwd(x)
    for chunk in (4, 5, 16):   # remainder, divisible, degenerate (B<chunk)
        got_logits, got_gates = pfast.chunked_serving(fwd, chunk)(x)
        np.testing.assert_allclose(got_logits.numpy(), ref_logits.numpy(),
                                   rtol=2e-5, atol=2e-5)
        assert torch.equal(got_gates, ref_gates)
    # dense mode returns gates=None: the None leaf survives chunking
    dl, dg = pfast.chunked_serving(lambda c: fwd(c, "dense"), 4)(x)
    assert dg is None and dl.shape == (10, CLASSES)


# --- eval transforms ---------------------------------------------------------

@pytest.mark.parametrize("inception", [False, True])
@pytest.mark.parametrize("out_size,canvas", [(224, 256), (40, 45)])
def test_eval_augment_matches_jax(out_size, canvas, inception):
    rs = np.random.RandomState(out_size + inception)
    imgs = rs.randint(0, 256, (2, canvas, canvas, 3)).astype(np.uint8)
    want = np.asarray(jax_transforms.augment_batch(
        jax.random.PRNGKey(0), jnp.asarray(imgs), out_size=out_size,
        inception=inception, train=False))
    got = port_transforms.augment_batch(None, torch.from_numpy(imgs),
                                        out_size=out_size,
                                        inception=inception, train=False)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    if out_size == 224:
        # whole-pixel offset: an exact crop of the canvas
        crop = port_transforms.center_crop_resize(torch.from_numpy(imgs))
        assert torch.equal(crop, torch.from_numpy(
            imgs[:, 16:240, 16:240].astype(np.float32)))


def test_train_augment_raises():
    # train augmentation draws from an explicit generator, never the global
    # RNG (tests/test_torch_port_data.py holds it against the JAX package)
    with pytest.raises(ValueError, match="torch.Generator"):
        port_transforms.augment_batch(None, torch.zeros((1, 8, 8, 3),
                                                        dtype=torch.uint8),
                                      out_size=8, train=True)


# --- predict -----------------------------------------------------------------

ARCH = ["--img_size", str(IMG), "--patch_size", str(PATCH), "--embed_dim",
        str(DIM), "--depth", str(DEPTH), "--num_heads", str(HEADS),
        "--ffn_num", str(FFN), "--nb_classes", str(CLASSES)]


@pytest.fixture(scope="module")
def predict_setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("predict")
    rs = np.random.RandomState(0)
    for i, (h, w) in enumerate(((50, 70), (40, 40), (64, 48))):
        Image.fromarray(rs.randint(0, 256, (h, w, 3), np.uint8)).save(
            d / f"img{i}.png")
    sd = make_vit_state_dict(np.random.RandomState(1), depth=DEPTH, dim=DIM,
                             ffn=FFN, classes=CLASSES, img=IMG, patch=PATCH)
    sd["head.weight"] = sd["head.weight"] * 50      # labels with margin
    ckpt = str(d / "model.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    return str(d), ckpt


@pytest.mark.parametrize("mode,quant", [("dispatch", "none"),
                                        ("auto", "none"),
                                        ("dispatch", "int8")])
def test_predict_matches_jax(predict_setup, monkeypatch, mode, quant):
    from dynamic_tuning_tpu.data import native_loader
    from dynamic_tuning_tpu_torch.data import native_loader as port_native

    images, ckpt = predict_setup
    # both CLIs' PIL branch (each takes its native decoder when it builds;
    # tests/test_torch_port_native_loader.py holds the native canvases)
    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(port_native, "available", lambda: False)
    monkeypatch.setenv("DYT_FUSED_ATTN", "interpret")
    flags = ["--ckpt", ckpt, "--images", images, "--mode", mode,
             "--batch_size", "2", "--quant", quant] + ARCH
    want = jax_predict.main(jax_predict.get_args_parser().parse_args(flags))
    got = port_predict.main(port_predict.get_args_parser().parse_args(
        flags + ["--device", "cpu"]))
    assert [r["path"] for r in got] == [r["path"] for r in want]
    assert [r["label"] for r in got] == [r["label"] for r in want]
    assert [r["keep_ratio"] for r in got] == [r["keep_ratio"] for r in want]
    np.testing.assert_allclose([r["prob"] for r in got],
                               [r["prob"] for r in want], atol=1e-2)
    if mode == "auto":                     # batches of 2 < 8: dense
        assert all(r["keep_ratio"] == 1.0 for r in got)
    else:
        assert all(r["keep_ratio"] < 1.0 for r in got)


def test_predict_refuses_msgpack_and_missing_card(predict_setup):
    images, _ = predict_setup
    p = port_predict.get_args_parser()
    args = p.parse_args(["--ckpt", "model.msgpack", "--images", images,
                         "--device", "cpu"] + ARCH)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_predict.main(args)
    if not torch.cuda.is_available():
        args = p.parse_args(["--ckpt", "m.pth", "--images", images] + ARCH)
        with pytest.raises(RuntimeError, match="--device cpu"):
            port_predict.main(args)
