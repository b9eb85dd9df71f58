"""fp32 compute in the port against the JAX package, on the CPU, and the
entry points' fp32 route.

* whole DyT ViTs with fp32 weights and residual stream in dispatch and
  dense (complete_model) mode, at adapter widths 8, 24 and 256 (each
  width in one of the modes; the plain ViT in fp32, K2, is
  tests/test_torch_port_model.py::test_plain_model_matches_jax_fp32), and
  with ``--quant int8`` / ``int8_attn`` at fp32 compute (K6's scratch in
  the adapters' fp32), against the JAX model with its Pallas kernels in
  interpret mode (``DYT_FUSED_ATTN=interpret``; without it JAX on the CPU
  takes its unfused XLA branch, and turns int8 off);
* ``speed.build_model`` and the image, video and seg runners build an fp32
  model for a CUDA device from their flags, with the card's presence
  stubbed and ``Module.to`` kept on the CPU: nothing refuses fp32 any more;
  the fp32 route turns TF32 off for torch's matmuls and cuDNN inside the
  runners' training and evaluation methods and ``speed.main``, and
  restores both flags after them.

On the CPU the port's kernel wrappers compute their plain versions, which
the card's fp32 forms are held to (tests/test_torch_port_cuda.py,
chip_smoke.py).

Tolerances.  fp32: both sides round at the same points and differ in the
order of fp32 sums only (the port sums scores, l and the products of the
attention core in float64): logits within 1e-5 of their largest magnitude,
every gate identical, router logits within 1e-5 of theirs.  int8 at fp32
compute: as the int8 model test of tests/test_torch_port_model.py (1e-2 of
the largest logit, gates identical): a last-bit difference of an fp32 sum
may move one activation across an int8 rounding boundary.

Size: embed 128 in 2 heads of 64, depth 2, 32x32 images of 16x16 patches
(5 tokens), 2 images.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_tuning_tpu.config import ModelConfig, SelectConfig, TuningConfig
from dynamic_tuning_tpu.models.vit import VisionTransformer as JaxViT
from dynamic_tuning_tpu.train.checkpoint import import_pretrained
from dynamic_tuning_tpu_torch import cli
from dynamic_tuning_tpu_torch import config as tcfg
from dynamic_tuning_tpu_torch import main_image, main_video, seg_train, speed
from dynamic_tuning_tpu_torch.checkpoint import from_flax_params
from dynamic_tuning_tpu_torch.models.vit import VisionTransformer
from dynamic_tuning_tpu_torch.train import runner as trunner
from dynamic_tuning_tpu_torch.train import seg_runner as tseg
from dynamic_tuning_tpu_torch.train import video_runner as tvideo
from torch_oracle import make_vit_state_dict

DIM, DEPTH, HEADS, IMG, PATCH, CLASSES = 128, 2, 2, 32, 16, 10
MODES = {"dispatch": {"dispatch": True},
         "dense": {"complete_model": True}}


class _Quiet:
    def info(self, *a):
        pass


def port_cfg(cfg):
    """The port's own config object with the fields of a JAX-package one."""
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _pair(monkeypatch, *, ffn, quant="none", seed=0):
    """(jax model, jax params, port model, input): fp32, identical weights
    (a seeded timm state dict imported into the JAX tree, carried to the
    port through the weight bridge)."""
    mc = ModelConfig(img_size=IMG, patch_size=PATCH, embed_dim=DIM,
                     depth=DEPTH, num_heads=HEADS, num_classes=CLASSES,
                     residual_dtype="float32", quant=quant)
    tuning = TuningConfig(ffn_num=ffn, d_model=DIM)
    sel = SelectConfig(token_target_ratio=0.5)
    rs = np.random.RandomState(seed)
    sd = make_vit_state_dict(rs, depth=DEPTH, dim=DIM, ffn=ffn,
                             classes=CLASSES, img=IMG, patch=PATCH)
    # a live adapter: the lora init's up projection is zero
    for i in range(DEPTH):
        k = f"blocks.{i}.adaptmlp.up_proj.weight"
        sd[k] = (rs.randn(*sd[k].shape) * 0.05).astype(np.float32)
    x = rs.randn(2, IMG, IMG, 3).astype(np.float32)
    jm = JaxViT(mc, tuning=tuning, select=sel, dtype=jnp.float32)
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
    tm = VisionTransformer(port_cfg(mc), tuning=port_cfg(tuning),
                           select=port_cfg(sel), dtype=torch.float32)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        from_flax_params(params).items()}, strict=True)
    return jm, params, tm, x


def _check(jm, params, tm, x, kwargs, rel=1e-5):
    jl, jaux = jax.jit(lambda p, a: jm.apply({"params": p}, a, **kwargs))(
        params, jnp.asarray(x))
    with torch.no_grad():
        tl, taux = tm(torch.from_numpy(x), **kwargs)
    assert tl.dtype == torch.float32
    want = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())
    if jaux.get("token_select") is None:
        assert taux["token_select"] is None
        return
    np.testing.assert_array_equal(taux["token_select"].numpy(),
                                  np.asarray(jaux["token_select"]))
    want_tok = np.asarray(jaux["token_logits"])
    np.testing.assert_allclose(taux["token_logits"].numpy(), want_tok,
                               rtol=0, atol=rel * np.abs(want_tok).max())


@pytest.mark.parametrize("ffn,mode", [(8, "dispatch"), (24, "dense"),
                                      (256, "dispatch")])
def test_fp32_model_matches_jax(monkeypatch, ffn, mode):
    """K3 in fp32 in every block, at adapter widths the bf16 wgmma tail
    takes after padding (8, 24) and past it (256); each width in one mode
    and each mode at one width or more (a JAX compile per configuration
    keeps the file short)."""
    jm, params, tm, x = _pair(monkeypatch, ffn=ffn)
    assert tm.blocks[0].adaptmlp.kernel_weights()[0].shape == (ffn, DIM)
    _check(jm, params, tm, x, MODES[mode])


@pytest.mark.parametrize("quant", ["int8", "int8_attn"])
def test_fp32_int8_model_matches_jax(monkeypatch, quant):
    """K6 with fp32 adapters (an fp32 qkv scratch), K10 under int8_attn, K4
    on fp32 rows, the int8 stem storing fp32: dispatch."""
    jm, params, tm, x = _pair(monkeypatch, ffn=24, quant=quant)
    _check(jm, params, tm, x, MODES["dispatch"], rel=1e-2)


# --- the entry points' fp32 route --------------------------------------------

TOY = dict(embed_dim=64, depth=1, num_heads=1)


@pytest.fixture
def no_card(monkeypatch):
    """The card's presence stubbed, modules kept on the CPU, the TF32
    flags on (building leaves them as they are); yields the models
    built."""
    built = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.nn.Module, "to", lambda self, *a, **k: self)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.nn.init, "trunc_normal_",
                        lambda t, *a, **k: t)
    yield built
    assert built, "no model was built"
    for m in built:
        assert all(p.dtype == torch.float32 for p in m.parameters())
        dtypes = {getattr(mod, "dtype", torch.float32)
                  for mod in m.modules()}
        assert dtypes == {torch.float32}, dtypes
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32


def _toy(built, cls, **toy):
    """``cls`` built at a toy width from the config its caller gives."""
    def make(cfg, **kw):
        m = cls(dataclasses.replace(cfg, **{**TOY, **toy}), **kw)
        built.append(m)
        return m
    return make


def test_speed_builds_fp32_on_cuda(no_card):
    args = speed.get_args_parser().parse_args(
        ["--compute_dtype", "float32", "--mode", "dispatch"])
    with mock.patch.object(speed, "VisionTransformer",
                           _toy(no_card, VisionTransformer)):
        model = speed.build_model(args, "cuda")
    assert model.dtype == torch.float32


def test_image_runner_builds_fp32_on_cuda(no_card, tmp_path):
    args = main_image.get_args_parser().parse_args(
        ["--dataset", "synthetic", "--compute_dtype", "float32",
         "--batch_size", "4", "--num_workers", "0", "--output_dir",
         str(tmp_path)])
    with mock.patch.object(trunner.Runner, "MODEL",
                           staticmethod(_toy(no_card, VisionTransformer))), \
            mock.patch.object(trunner.Runner, "run", lambda self: self):
        runner = main_image.main(args)
    assert runner.device.type == "cuda" and runner.dtype == torch.float32


def test_video_runner_builds_fp32_on_cuda(no_card, tmp_path):
    args = main_video.get_args_parser().parse_args(
        ["--dataset", "synthetic", "--compute_dtype", "float32",
         "--batch_size", "2", "--num_workers", "0", "--output_dir",
         str(tmp_path)])
    with mock.patch.object(
            tvideo.VideoRunner, "MODEL",
            staticmethod(_toy(no_card, tvideo.VideoRunner.MODEL))), \
            mock.patch.object(tvideo.VideoRunner, "run", lambda self: self):
        runner = main_video.main(args)
    assert runner.device.type == "cuda" and runner.dtype == torch.float32


def test_seg_runner_builds_fp32_on_cuda(no_card, tmp_path):
    args = seg_train.get_args_parser().parse_args(
        ["--dataset", "synthetic", "--crop_size", "32", "--compute_dtype",
         "float32", "--num_workers", "0", "--output_dir", str(tmp_path)])
    with mock.patch.object(tseg, "DyTSegmentor",
                           _toy(no_card, tseg.DyTSegmentor, depth=4)):
        runner = seg_train.build_runner(args)
    assert runner.device.type == "cuda" and runner.dtype == torch.float32


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize("method", [
    trunner.Runner.train_one_epoch, trunner.Runner.evaluate,
    tvideo.VideoRunner.evaluate, tseg.SegRunner.train_step,
    tseg.SegRunner.evaluate])
def test_runner_methods_run_fp32_scoped(method):
    """Each runner method that computes is an ``fp32_scoped`` wrapper (all
    of them share its code)."""
    assert method.__code__ is cli.fp32_scoped(lambda self: None).__code__
    assert callable(method.__wrapped__)


def test_fp32_scope_sets_and_restores_tf32(monkeypatch):
    """``fp32_scoped``: TF32 off inside in fp32 on the card, the flags as
    they were in bf16 and on the CPU, and restored on the way out, also
    when the method raises."""
    from types import SimpleNamespace
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = []

    @cli.fp32_scoped
    def method(self, fail=False):
        seen.append(_flags())
        if fail:
            raise RuntimeError("inside")

    for dtype, dev, want in (("float32", "cuda", (False, False)),
                             ("bfloat16", "cuda", (True, True)),
                             ("float32", "cpu", (True, True))):
        runner = SimpleNamespace(cfg=SimpleNamespace(compute_dtype=dtype),
                                 device=torch.device(dev))
        seen.clear()
        method(runner)
        with pytest.raises(RuntimeError):
            method(runner, fail=True)
        assert seen == [want, want]
        assert _flags() == (True, True)
