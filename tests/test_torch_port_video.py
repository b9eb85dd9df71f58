"""The port's video model, weight bridge, runner and entry point against the
JAX package's, on the CPU.

Toy size: clips of 2 frames (4 with the tubelet-2 stem) of 32x32 images in
8x8 patches (16 tokens + CLS), width 128 in 2 heads of 64, depth 2,
adapter 8, 10 classes.  The JAX side gets seeded IN21K-like weights
(``tests/torch_oracle.make_vit_state_dict`` through ``import_pretrained``,
router heads x25) plus a nonzero query token and attentive-pool biases;
the port gets the same tree through ``from_flax_params``.  The JAX model
applies with ``DYT_FUSED_ATTN=interpret`` (its Pallas kernels in interpret
mode, as the port's blocks take the plain versions of K3/K2/K6 + K4).

* The model: fp32 mask, dispatch, complete_model and tubelet-2 logits to
  1e-5 of the largest with every gate identical; bf16 to
  ``test_torch_port_model.py``'s 1.2% of the largest logit, gates
  identical; int8 (W8A8) to 1e-2, gates identical, and off the fp32
  model by more than 1e-3.
* ``CrossAttention`` / ``AttentiveBlock`` alone in bf16 at head dim 64 and
  128, every parameter moved off its init: every output within one bf16
  ulp of the largest, at most a tenth further than 1e-5 of it; the same
  module with q scaled by the fp32 scale fails that at head dim 128.
* The weight bridge: a JAX video tree (tubelet stem included) round-trips
  through the port; a timm ViT ``.pth`` loads as the JAX runner loads it.
* ``VideoRunner`` against the JAX ``VideoRunner`` on ``--dataset
  synthetic`` (both augmentations patched to the same deterministic centre
  crop, both packages' router noise to the same arrays): ``evaluate`` in
  mask and dispatch modes equal (GFLOPs to 1e-6), one epoch's loss parts
  and end weights at ``test_torch_port_train.py``'s tolerance; resume
  bit-identical; ``main_video`` on the CPU; ``build_config`` field for
  field; the refusals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main_video as jmain_video
from dynamic_tuning_tpu import config as jc
from dynamic_tuning_tpu.models import video_vit as jvv
from dynamic_tuning_tpu.parallel import mesh as M
from dynamic_tuning_tpu.train import checkpoint as jckpt
from dynamic_tuning_tpu.train import optim as joptim
from dynamic_tuning_tpu.train import video_runner as jvr
from dynamic_tuning_tpu.train.engine import make_eval_step
from dynamic_tuning_tpu_torch import config as tc
from dynamic_tuning_tpu_torch import main_video
from dynamic_tuning_tpu_torch.checkpoint import (flax_path_to_timm,
                                                 from_flax_params,
                                                 load_timm_state_dict,
                                                 load_torch_state_dict)
from dynamic_tuning_tpu_torch.cli import args_to_config
from dynamic_tuning_tpu_torch.models import layers as tlayers
from dynamic_tuning_tpu_torch.models import video_vit as tvv
from dynamic_tuning_tpu_torch.ops import mha_serving as ms
from dynamic_tuning_tpu_torch.train import checkpoint as C
from dynamic_tuning_tpu_torch.train import engine
from dynamic_tuning_tpu_torch.train import video_runner as tvr
from dynamic_tuning_tpu_torch.utils.multiview import merge_view_outputs
from torch_oracle import make_vit_state_dict

DIM, HEADS, DEPTH, FFN, IMG, PATCH, CLASSES = 128, 2, 2, 8, 32, 8, 10
N1 = (IMG // PATCH) ** 2                     # tokens a frame, CLS left out
PART_TOL = dict(rel=1e-3, abs=2e-5)          # tests/test_torch_port_train.py
PARAM_TOL = dict(rtol=2e-3, atol=5e-5)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def port_cfg(cfg):
    """The port's own config object with the fields of a JAX-package one
    (the fields the port has: the JAX RunConfig's mesh has none)."""
    cls = getattr(tc, type(cfg).__name__)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{f.name: (port_cfg(getattr(cfg, f.name))
                           if dataclasses.is_dataclass(getattr(cfg, f.name))
                           else getattr(cfg, f.name))
                  for f in dataclasses.fields(cfg) if f.name in names})


class _Quiet:
    def info(self, *a):
        pass


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _video_extras(rs, flat, dim):
    """A nonzero query token and attentive-pool biases (all zero at
    init), so the pool is not a plain mean."""
    out = dict(flat)
    out[("query_token",)] = rs.randn(1, 1, dim).astype(np.float32) * 0.5
    for name in ("q_bias", "v_bias"):
        out[("attentive_blocks", "cross_attn", name)] = (
            rs.randn(dim).astype(np.float32) * 0.1)
    for name in ("norm_q", "norm_k", "norm_v"):
        k = ("attentive_blocks", name, "bias")
        out[k] = rs.randn(dim).astype(np.float32) * 0.1
    return out


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return tree


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _jax_video_params(jm, x, rs, tubelet):
    """Seeded IN21K-like image weights through import_pretrained (the
    tubelet stem keeps its init), plus the video extras."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DYT_FUSED_ATTN", "0")           # init: same tree, faster
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]
    sd = make_vit_state_dict(rs, depth=DEPTH, dim=DIM, ffn=FFN,
                             classes=CLASSES, img=IMG, patch=PATCH)
    if tubelet > 1:
        del sd["patch_embed.proj.weight"], sd["patch_embed.proj.bias"]
    params, _ = jckpt.import_pretrained(params, sd, logger=_Quiet())
    flat = _video_extras(rs, dict(_flatten(params)), DIM)
    return _unflatten(flat)


_PAIRS = {}


def _pair(dtype="float32", quant="none", tubelet=1):
    """(jax model, its params, port model, clips [2, T, 32, 32, 3]) with the
    same weights; built once per configuration."""
    key = (dtype, quant, tubelet)
    if key not in _PAIRS:
        frames = 2 * tubelet
        mc = jc.ModelConfig(img_size=IMG, patch_size=PATCH, embed_dim=DIM,
                            depth=DEPTH, num_heads=HEADS,
                            num_classes=CLASSES, num_frames=frames,
                            tubelet_size=tubelet, residual_dtype=dtype,
                            quant=quant)
        tuning = jc.TuningConfig(ffn_num=FFN, d_model=DIM)
        sel = jc.SelectConfig(token_target_ratio=0.5)
        rs = np.random.RandomState(0)
        x = rs.randn(2, frames, IMG, IMG, 3).astype(np.float32)
        jm = jvv.VideoVisionTransformer(mc, tuning=tuning, select=sel,
                                        dtype=JDT[dtype])
        params = _jax_video_params(jm, x, rs, tubelet)
        tm = tvv.VideoVisionTransformer(
            port_cfg(mc), tuning=port_cfg(tuning), select=port_cfg(sel),
            dtype=TDT[dtype])
        tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                            from_flax_params(params).items()}, strict=True)
        _PAIRS[key] = (jm, params, tm, x)
    return _PAIRS[key]


def _run_both(monkeypatch, pair, kwargs):
    jm, params, tm, x = pair
    monkeypatch.setenv("DYT_FUSED_ATTN", "interpret")
    jl, jaux = jm.apply({"params": params}, jnp.asarray(x), **kwargs)
    tl, taux = tm(torch.from_numpy(x), **kwargs)
    return (np.asarray(jl.astype(jnp.float32)), jaux, tl.float().numpy(),
            taux)


MODES = {"mask": ({}, 1), "dispatch": ({"dispatch": True}, 1),
         "complete_model": ({"complete_model": True}, 1),
         "tubelet2": ({"dispatch": True}, 2)}


@pytest.mark.parametrize("mode", list(MODES))
def test_video_model_matches_jax_fp32(monkeypatch, mode):
    kwargs, tubelet = MODES[mode]
    jl, jaux, tl, taux = _run_both(monkeypatch, _pair(tubelet=tubelet),
                                   kwargs)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5 * np.abs(jl).max())
    if mode == "complete_model":
        assert taux["token_select"] is None and jaux["token_select"] is None
        return
    ts = taux["token_select"]
    # per frame (frame group): [B * T, L, N - 1, 1]
    assert ts.shape == (2 * 2, DEPTH, N1, 1)
    np.testing.assert_array_equal(ts.numpy(),
                                  np.asarray(jaux["token_select"]))
    if mode != "mask":
        assert ts.sum(dim=2).max() <= 8      # capacity 9 of 17 slots


@pytest.mark.parametrize("mode", ["mask", "dispatch"])
def test_video_model_matches_jax_bf16(monkeypatch, mode):
    """bf16 compute and residual stream: the tolerance of
    test_torch_port_model.py's bf16 test (1.2% of the largest logit; the
    frameworks' bf16 GELU and the dense layers outside the kernels sum and
    round in other orders), every gate identical."""
    jl, jaux, tl, taux = _run_both(monkeypatch, _pair("bfloat16"),
                                   MODES[mode][0])
    np.testing.assert_allclose(tl, jl, rtol=0, atol=0.012 * np.abs(jl).max())
    np.testing.assert_array_equal(taux["token_select"].numpy(),
                                  np.asarray(jaux["token_select"]))


@pytest.mark.parametrize("mode", ["mask", "dispatch"])
def test_video_model_matches_jax_int8(monkeypatch, mode):
    """W8A8 serving (the int8 stem, K6, K4): the JAX Pallas kernels in
    interpret mode, the port's plain versions; test_torch_port_model.py's
    int8 tolerance (1e-2 of the largest logit), every gate identical."""
    jl, jaux, tl, taux = _run_both(monkeypatch, _pair(quant="int8"),
                                   MODES[mode][0])
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-2 * np.abs(jl).max())
    np.testing.assert_array_equal(taux["token_select"].numpy(),
                                  np.asarray(jaux["token_select"]))
    _, _, t32, x = _pair()
    # the int8 path really quantizes: off the fp32 model by more than the
    # fp32 parity tolerance
    assert np.abs(tl - t32(torch.from_numpy(x))[0].numpy()).max() > \
        1e-3 * np.abs(jl).max()


# --- CrossAttention / AttentiveBlock in bf16 ---------------------------------

def _module_pair(jmod, tmod, prefix, dim, seed, fp32_scale=False):
    """(port output, JAX output) of a flax module and its port in bf16,
    every parameter moved off its init (biases by ~0.1, kernels ~0.05)."""
    rs = np.random.RandomState(seed)
    xq = rs.randn(2, 1, dim).astype(np.float32)
    xkv = rs.randn(2, 40, dim).astype(np.float32)
    args = [jnp.asarray(a).astype(jnp.bfloat16) for a in (xq, xkv)]
    if prefix.endswith("cross_attn"):
        args = args[:1] + args[1:] * 2
    params = jmod.init(jax.random.PRNGKey(0), *args)["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + ((0.1 if "bias" in jax.tree_util.keystr(p) else 0.05)
                          * rs.randn(*a.shape)).astype(np.float32), params)
    want = jmod.apply({"params": params}, *args)
    tree = {"attentive_blocks": params} if prefix == "attentive_blocks" \
        else {"attentive_blocks": {"cross_attn": params}}
    tmod.load_state_dict({k[len(prefix) + 1:]: torch.from_numpy(v) for k, v
                          in from_flax_params(tree).items()}, strict=True)
    targs = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in args]
    with pytest.MonkeyPatch.context() as mp:
        if fp32_scale:
            mp.setattr(ms, "weak_scale", lambda t, hd: torch.tensor(
                hd ** -0.5, dtype=torch.float32))
        with torch.no_grad():
            got = tmod(*targs)
    assert got.dtype == torch.bfloat16
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


def _within_one_ulp_mostly_exact(got, want):
    err = np.abs(got - want)
    scale = np.abs(want).max()
    return (err.max() <= 2.0 ** -7 * scale
            and (err > 1e-5 * scale).mean() <= 0.1)


@pytest.mark.parametrize("dim", [128, 256], ids=["hd64", "hd128"])
@pytest.mark.parametrize("module", ["cross_attn", "attentive_block"])
def test_cross_attention_bf16_rounds_like_flax(module, dim):
    """CrossAttention (and AttentiveBlock around it) in bf16 against flax:
    each Dense rounds its product then adds its rounded bias, q and v add
    their rounded fp32 biases, q is scaled by the scale rounded to bf16,
    fp32 scores and softmax, p rounded before P.V.  Within one ulp, mostly
    exact; at head dim 128 the fp32 scale (0.0883883 against bf16's
    0.0883789) breaks that."""
    g = torch.Generator().manual_seed(0)
    if module == "cross_attn":
        make = (lambda: jvv.CrossAttention(HEADS, dtype=jnp.bfloat16),
                lambda: tvv.CrossAttention(dim, HEADS, g,
                                           dtype=torch.bfloat16),
                "attentive_blocks.cross_attn")
    else:
        make = (lambda: jvv.AttentiveBlock(HEADS, dtype=jnp.bfloat16),
                lambda: tvv.AttentiveBlock(dim, HEADS, g,
                                           dtype=torch.bfloat16),
                "attentive_blocks")
    for seed in (0, 1):
        got, want = _module_pair(make[0](), make[1](), make[2], dim, seed)
        assert _within_one_ulp_mostly_exact(got, want), seed
    got, want = _module_pair(make[0](), make[1](), make[2], dim, 0,
                             fp32_scale=True)
    assert _within_one_ulp_mostly_exact(got, want) == (dim == 128)


# --- the weight bridge -------------------------------------------------------

def _to_flax_layout(path, w):
    """The inverse of the bridge's layout change (the test's own)."""
    if path[-1] == "kernel" and w.ndim == 2:
        return w.T
    if path[-1] == "kernel" and w.ndim == 5:
        return w.transpose(2, 3, 4, 1, 0)           # OIDHW -> DHWIO
    if path[-1] == "kernel" and w.ndim == 4:
        return w.transpose(2, 3, 1, 0)              # OIHW -> HWIO
    return w


@pytest.mark.parametrize("tubelet", [1, 2])
def test_video_tree_round_trips_through_the_port(tubelet):
    _, params, tm, _ = _pair(tubelet=tubelet)
    own = {k: v.numpy() for k, v in tm.state_dict().items()}
    flat = dict(_flatten(params))
    assert len(own) == len(flat)
    for path, w in flat.items():
        key = flax_path_to_timm(path)
        np.testing.assert_array_equal(_to_flax_layout(path, own[key]), w,
                                      err_msg=key)
    assert own["patch_embed.proj.weight"].ndim == 3 + (tubelet > 1) + 1
    assert "attentive_blocks.cross_attn.q_bias" in own


def test_timm_vit_pth_loads_into_the_video_model(tmp_path):
    """An IN21K-like image checkpoint (no adapters or routers, a head of
    another width) into the video model, as the JAX VideoRunner loads it
    (load_torch_state_dict + import_pretrained, then the head re-drawn):
    the same tensors loaded, the same keys left at their init (adapters,
    routers, the query token, the attentive pool, the head)."""
    sd = make_vit_state_dict(np.random.RandomState(3), depth=DEPTH, dim=DIM,
                             ffn=FFN, classes=7, img=IMG, patch=PATCH)
    sd = {k: v for k, v in sd.items()
          if "adaptmlp" not in k and "mlp_token_select" not in k}
    path = str(tmp_path / "in21k.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    jm, _, _, x = _pair()
    jparams = jm.init(jax.random.PRNGKey(1), jnp.asarray(x[:1]))["params"]
    jparams, jmissing = jckpt.import_pretrained(
        jparams, jckpt.load_torch_state_dict(path), logger=_Quiet())
    tm = tvv.VideoVisionTransformer(
        port_cfg(jm.cfg), tuning=port_cfg(jm.tuning),
        select=port_cfg(jm.select), dtype=torch.float32)
    missing, unexpected = load_timm_state_dict(
        tm, load_torch_state_dict(path), log=lambda *a: None)
    C.reinit_head(tm, torch.Generator().manual_seed(0))
    assert unexpected == []
    assert sorted(missing) == sorted(flax_path_to_timm(p) for p in jmissing)
    assert {k.split(".")[0] for k in missing} >= {"query_token",
                                                  "attentive_blocks", "head"}
    own = tm.state_dict()
    want = from_flax_params(jparams)
    for k in sd:
        if not k.startswith("head."):
            np.testing.assert_array_equal(own[k].numpy(), want[k],
                                          err_msg=k)
    assert torch.equal(own["query_token"], torch.zeros(1, 1, DIM))
    assert torch.equal(own["head.bias"], torch.zeros(CLASSES))
    assert 0.005 < own["head.weight"].std() < 0.01


# --- VideoRunner against the JAX VideoRunner ---------------------------------

def run_cfg(out, *, batch=64, epochs=2, dropout=0.0, frames=2, **kw):
    """The toy run (the JAX package's RunConfig, whose port_cfg is the
    port's): synthetic clips at batch ``batch``, K400's train resize."""
    return jc.RunConfig(
        model=jc.ModelConfig(img_size=IMG, patch_size=PATCH, embed_dim=DIM,
                             depth=DEPTH, num_heads=HEADS, num_classes=400,
                             num_frames=frames, drop_path_rate=dropout),
        tuning=jc.TuningConfig(ffn_num=FFN, d_model=DIM, dropout=dropout),
        optim=jc.OptimConfig(lr=1e-3, warmup_epochs=1, epochs=epochs),
        data=jc.DataConfig(dataset="synthetic", batch_size=batch,
                           num_workers=2, num_frames=frames,
                           train_resize_type="random_short_side_scale_jitter",
                           jitter_min=32, jitter_max=37),
        output_dir=str(out), compute_dtype="float32", **kw)


def _centre_crop_only(mp):
    """Both runners' train augmentation replaced by their eval transform
    (a deterministic centre crop of each clip)."""
    jreal, treal = jvr.augment_clip_batch, tvr.augment_clip_batch
    mp.setattr(jvr, "augment_clip_batch",
               lambda rng, clips, **kw: jreal(rng, clips, **{
                   k: v for k, v in kw.items()
                   if k in ("crop", "inception")}, train=False))
    mp.setattr(tvr, "augment_clip_batch",
               lambda gen, clips, **kw: treal(None, clips, **{
                   k: v for k, v in kw.items()
                   if k in ("crop", "inception")}, train=False))


def _patch_noise(mp, arrays):
    """Both packages' router noise returns ``arrays`` in turn (cycling)."""
    calls = {"j": 0, "t": 0}

    def jax_logistic(key, shape=(), dtype=jnp.float32):
        a = arrays[calls["j"] % len(arrays)]
        calls["j"] += 1
        assert a.shape == tuple(shape), (a.shape, shape)
        return jnp.asarray(a, dtype)

    def port_logistic(shape, generator, *, dtype=torch.float32, device=None):
        a = arrays[calls["t"] % len(arrays)]
        calls["t"] += 1
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.from_numpy(a).to(dtype=dtype, device=device)

    mp.setattr(jax.random, "logistic", jax_logistic)
    mp.setattr(tlayers, "logistic_noise", port_logistic)


def _record(runner, jax_side):
    parts, step = [], runner.train_step

    def recorded(state, x, y):
        out = step(state, x, y)
        p = out[1] if jax_side else out
        parts.append({k: float(v) for k, v in p.items()})
        return out

    runner.train_step = recorded
    return parts


def _live(trainable, rs):
    """Router heads x60, live adapters, the video extras."""
    out = _video_extras(rs, trainable, DIM)
    for i in range(DEPTH):
        k = (f"blocks_{i}", "mlp_token_select", "mlp_head", "kernel")
        out[k] = jnp.asarray(np.asarray(out[k]) * 60.0)
        k = (f"blocks_{i}", "adaptmlp", "up_proj", "kernel")
        out[k] = jnp.asarray(rs.randn(*out[k].shape).astype(np.float32)
                             * 0.05)
    return {k: jnp.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def vparity(tmp_path_factory):
    jcfg = run_cfg(tmp_path_factory.mktemp("jax"))
    rs = np.random.RandomState(0)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _centre_crop_only(mp)
        jr = jvr.VideoRunner(jcfg)
        jr.state = M.shard_state(jr.mesh, jr.state._replace(
            trainable=_live(jr.state.trainable, rs)))
        params = jax.tree_util.tree_map(np.asarray, joptim.merge_params(
            jr.state.trainable, jr.state.frozen))
        pr = tvr.VideoRunner(port_cfg(jcfg).replace(
            output_dir=str(tmp_path_factory.mktemp("port"))), "cpu")
        pr.model.load_state_dict({k: torch.from_numpy(v) for k, v in
                                  from_flax_params(params).items()},
                                 strict=True)
        out["mask"] = (jr.evaluate(), pr.evaluate())
        jmask, pmask = jr.eval_step, pr.eval_step
        jr.eval_step = jax.jit(make_eval_step(jr.apply_fn, dispatch=True))
        pr.eval_step = engine.make_eval_step(pr.model, dispatch=True)
        out["dispatch"] = (jr.evaluate(), pr.evaluate())
        jr.eval_step, pr.eval_step = jmask, pmask
        frames = jcfg.data.batch_size * jcfg.data.num_frames
        _patch_noise(mp, [rs.logistic(size=(frames, N1, 1)).astype(
            np.float32) for _ in range(DEPTH)])
        jparts, pparts = _record(jr, True), _record(pr, False)
        jr.train_one_epoch(0)
        pr.train_one_epoch(0)
    return dict(out, jparts=jparts, pparts=pparts, jr=jr, pr=pr)


@pytest.mark.parametrize("mode", ["mask", "dispatch"])
def test_video_runner_evaluate_matches_jax(vparity, mode):
    js, ps = vparity[mode]
    for k in ("acc1", "acc5", "metric", "keep_ratio"):
        assert js[k] == ps[k], (k, js[k], ps[k])
    for k in ("gflops_per_clip", "flops_ratio_vs_dense"):
        assert ps[k] == pytest.approx(js[k], rel=1e-6)
    assert 0.2 < ps["keep_ratio"] < 0.8


def test_video_runner_epoch_matches_jax(vparity):
    jparts, pparts = vparity["jparts"], vparity["pparts"]
    assert len(pparts) == vparity["pr"].steps_per_epoch == 4
    for i, (jp, tp) in enumerate(zip(jparts, pparts)):
        assert set(jp) == set(tp)
        assert jp["keep_ratio"] == pytest.approx(tp["keep_ratio"], abs=1e-6)
        for k in jp:
            assert jp[k] == pytest.approx(tp[k], **PART_TOL), (i, k)
    own = dict(vparity["pr"].model.named_parameters())
    want = from_flax_params(joptim.merge_params(jax.tree_util.tree_map(
        np.asarray, vparity["jr"].state.trainable), {}))
    assert {"query_token", "attentive_blocks.cross_attn.q.weight"} <= set(
        want) == set(vparity["pr"].state.optimizer.names)
    for name, w in want.items():
        np.testing.assert_allclose(own[name].detach().numpy(), w,
                                   err_msg=name, **PARAM_TOL)


def test_video_runner_saves_views_for_the_merge(vparity, tmp_path):
    pr = vparity["pr"]
    stats = pr.evaluate(save_views_dir=str(tmp_path))
    merged = merge_view_outputs(str(tmp_path))
    # three identical views (synthetic): the merge's argmax is the mean's
    assert merged["num_clips"] == 64 and merged["acc1"] == stats["acc1"]
    d = np.load(tmp_path / "views_rank0.npz")
    assert d["logits"].shape == (64 * 3, 400)


def test_video_resume_is_bit_identical(tmp_path, monkeypatch):
    """Two epochs with the train augmentation (jitter, crop, flip) and
    dropout on, then a run resumed from the epoch-0 checkpoint with the same
    flags: the same final weights and optimizer moments, bit for bit."""
    cfg = port_cfg(run_cfg(tmp_path / "a", batch=128, dropout=0.1)).replace(
        auto_remove=False)
    a = tvr.VideoRunner(cfg, "cpu")
    a.run()
    c = tvr.VideoRunner(cfg.replace(
        resume=str(tmp_path / "a" / "checkpoint-0.msgpack"),
        output_dir=str(tmp_path / "c")), "cpu")
    assert c.start_epoch == 1 and c.state.step == 2
    c.run()
    fa = C.load_params(str(tmp_path / "a" / "final_checkpoint.msgpack"))
    fc = C.load_params(str(tmp_path / "c" / "final_checkpoint.msgpack"))
    assert fa.keys() == fc.keys() and "query_token" in fa
    for k in fa:
        assert torch.equal(fa[k], fc[k]), k
    sa, sc = a.state.optimizer.state_dict(), c.state.optimizer.state_dict()
    for part in ("mu", "nu"):
        for k in sa["rule"][part]:
            assert torch.equal(sa["rule"][part][k], sc["rule"][part][k]), k


def test_video_trainable_set(tmp_path):
    r = tvr.VideoRunner(port_cfg(run_cfg(tmp_path)), "cpu")
    names = set(r.state.optimizer.names)
    assert {"query_token", "attentive_blocks.norm_k.weight",
            "attentive_blocks.cross_attn.v_bias", "head.weight",
            "blocks.1.adaptmlp.up_proj.weight",
            "blocks.0.mlp_token_select.mlp_head.bias"} <= names
    assert not any(n.startswith(("blocks.0.attn", "patch_embed", "norm."))
                   for n in names)
    full = tvr.VideoRunner(port_cfg(run_cfg(tmp_path)).replace(
        fulltune=True), "cpu")
    assert len(full.state.optimizer.names) == len(
        list(full.model.parameters()))


# --- the entry point ---------------------------------------------------------

def _shrink(monkeypatch):
    real = main_video.args_to_config

    def toy(args, **kw):
        cfg = real(args, **kw)
        return cfg.replace(
            model=dataclasses.replace(cfg.model, img_size=IMG,
                                      patch_size=PATCH, embed_dim=DIM,
                                      depth=DEPTH, num_heads=HEADS),
            tuning=dataclasses.replace(cfg.tuning, d_model=DIM))

    monkeypatch.setattr(main_video, "args_to_config", toy)


def test_main_video_trains_and_evaluates_on_the_cpu(tmp_path, monkeypatch,
                                                    capsys):
    _shrink(monkeypatch)
    flags = ["--dataset", "synthetic", "--device", "cpu", "--epochs", "1",
             "--warmup_epochs", "1", "--batch_size", "128", "--num_frames",
             "2", "--compute_dtype", "float32", "--output_dir",
             str(tmp_path)]
    parse = main_video.get_args_parser().parse_args
    out = main_video.main(parse(flags))
    assert (tmp_path / "final_checkpoint.msgpack").exists()
    stats = main_video.main(parse(flags + [
        "--eval", "--eval_ckpt", str(tmp_path / "checkpoint-0.msgpack")]))
    assert stats["metric"] == out["max_metric"]
    assert stats["gflops_per_clip"] > 0
    assert "Accuracy on the val set" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    [], ["--dataset", "SSV2"], ["--dataset", "k400", "--train_resize_type",
                                "random_resized_crop", "--num_frames", "16",
                                "--tubelet_size", "2", "--inception"]],
    ids=["k400", "ssv2", "explicit"])
def test_build_config_matches_jax(flags):
    """main_video's recipe defaults resolve as the root main_video.py's,
    field for field."""
    want = port_cfg(jmain_video.build_config(
        jmain_video.get_args_parser().parse_args(flags)))
    got = main_video.build_config(main_video.get_args_parser().parse_args(
        flags))
    assert got == want


def test_video_refusals_and_the_card_default(tmp_path):
    parse = main_video.get_args_parser().parse_args
    with pytest.raises(ValueError, match="orbax"):
        args_to_config(parse(["--ckpt_backend", "orbax"]))
    with pytest.raises(ValueError, match="model_parallel"):
        args_to_config(parse(["--model_parallel", "2"]))
    cfg = port_cfg(run_cfg(tmp_path))
    with pytest.raises(ValueError, match="compute_dtype float32"):
        tvr.VideoRunner(cfg, torch.device("cuda"))
    # a checkpoint is a .msgpack or a .pth/.pt
    for bad in (dict(resume=str(tmp_path / "checkpoint-0.ckpt")),
                dict(finetune=str(tmp_path / "x.ckpt"))):
        with pytest.raises(NotImplementedError, match="a checkpoint is"):
            tvr.VideoRunner(cfg.replace(**bad), "cpu")
    with pytest.raises(NotImplementedError, match="a checkpoint is"):
        main_video.main(parse(["--device", "cpu", "--eval", "--eval_ckpt",
                               str(tmp_path / "final.ckpt")]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            main_video.main(parse(["--dataset", "synthetic"]))
    with pytest.raises(NotImplementedError, match="video_vit.py"):
        from dynamic_tuning_tpu_torch.models.vit import VisionTransformer
        VisionTransformer(tc.ModelConfig(num_frames=8))
