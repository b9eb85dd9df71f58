"""The port's segmentation training and int8 segmentation against the JAX
package's, on the CPU.

* ``seg_loss`` (255-bordered labels), ``poly_schedule`` at the warmup and
  total boundaries, the freeze rule through ``flax_path_to_port``, the
  BatchNorm ``ConvModule`` in training against flax with
  ``mutable=["batch_stats"]``;
* the segmentor's training forward and gradients against ``jax.grad`` in
  fp32, with GroupNorm and with BatchNorm;
* six ``SegRunner`` steps against the JAX ``SegRunner``'s train step on the
  same weights, data and gumbel noise: ``jax.random.logistic`` returns the
  test's arrays (one per routed block, read once: the JAX step is jitted)
  and the port takes them as ``gate_noise``; dropout is 0 on both sides
  (flax's ``nn.Dropout`` patched to the identity, the port's heads at rate
  0); both schedules warm up over 2 steps (``poly_schedule`` patched).
  Each step is also taken from the JAX runner's state before it, and the
  free-running gap is traced to the step whose head ReLU inputs change
  side;
* a resume: 4 iterations with evaluations at 2 and 4 against a run resumed
  from the iteration-2 checkpoint, bit for bit; the draws of remat'ed
  windowed blocks; the serving copies after optimizer steps;
* int8: ``q8_conv`` at kernels 1 and 3 (codes and int32 sums identical,
  fp32 within one ulp) and the int8 segmentor in mask and dispatch against
  JAX with ``DYT_FUSED_ATTN=interpret``.

Size: embed 128, 2 heads of 64, depth 4, 64x64 images of 16x16 patches
(N = 17 tokens), head channels 64, adapter 8, fp32.
"""

import dataclasses
import functools
import os
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from dynamic_tuning_tpu import config as jc
from dynamic_tuning_tpu.models import upernet as jup
from dynamic_tuning_tpu.ops import quant as jq
from dynamic_tuning_tpu.train import optim as joptim
from dynamic_tuning_tpu.train import seg_runner as jsr
from dynamic_tuning_tpu.train.engine import create_train_state
from dynamic_tuning_tpu_torch import config as tc
from dynamic_tuning_tpu_torch.checkpoint import (_find_states,
                                                 _to_torch_layout,
                                                 flax_path_to_port,
                                                 from_flax_params)
from dynamic_tuning_tpu_torch.models import layers as tlayers
from dynamic_tuning_tpu_torch.models import upernet as tup
from dynamic_tuning_tpu_torch.ops import quant as tq
from dynamic_tuning_tpu_torch.train import seg_runner as tsr

DIM, DEPTH, HEADS, FFN, IMG, PATCH, HEAD_CH = 128, 4, 2, 8, 64, 16, 64
NC = 150                      # the synthetic split's classes
T = (IMG // PATCH) ** 2       # 16 tokens + CLS
B, STEPS, WARMUP = 2, 6, 2
# the trajectory's batch: its BatchNorm normalises the PSP's 1x1 pooled map
# over the batch alone, and flax's fast variance E[x^2] - E[x]^2 of 2 values
# cancels so badly that fp32 summation order moves it by percents
TRAJ_B = 8
TRAJ_NORM, TRAJ_HEAD = "bn", HEAD_CH
PART_TOL = dict(rel=1e-3, abs=2e-5)          # tests/test_torch_port_train.py
PARAM_TOL = dict(rtol=2e-3, atol=5e-5)
# a head ReLU input this near 0 may fall on either side of it in two runs
# whose post-norm activations (order 1) agree to ~1e-5
KINK = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Toy-size ops (and the CLI's 32^2 crops) gain little from many
    intra-op threads, and beside other test processes those threads wait
    on each other (tests/test_torch_port_runner.py does the same)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def port_cfg(cfg):
    """The port's own config object with the fields of a JAX-package one
    (the JAX RunConfig's mesh has no counterpart)."""
    cls = getattr(tc, type(cfg).__name__)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{f.name: (port_cfg(getattr(cfg, f.name))
                           if dataclasses.is_dataclass(getattr(cfg, f.name))
                           else getattr(cfg, f.name))
                  for f in dataclasses.fields(cfg) if f.name in names})


def model_cfg(**kw):
    return jc.ModelConfig(img_size=IMG, patch_size=PATCH, embed_dim=DIM,
                          depth=DEPTH, num_heads=HEADS, **kw)


TUNING = jc.TuningConfig(ffn_num=FFN, d_model=DIM, dropout=0.0)
SELECT = jc.SelectConfig(token_target_ratio=0.5)


def run_cfg(out, batch=B, **kw):
    return jc.RunConfig(model=model_cfg(), tuning=TUNING, select=SELECT,
                        optim=jc.OptimConfig(lr=1e-3, weight_decay=0.05),
                        data=jc.DataConfig(dataset="synthetic",
                                           batch_size=batch, num_workers=1),
                        output_dir=str(out), compute_dtype="float32", **kw)


def _t(a):
    return torch.from_numpy(np.array(a))


def _live(flat, rs):
    """Every part of a flat {path: array} tree counts: nonzero rel-pos
    tables, live adapters, router heads x50 (hard gates with margin)."""
    out = {}
    for k, a in flat.items():
        a = np.asarray(a)
        if "relative_position_bias_table" in k:
            a = a + rs.randn(*a.shape).astype(np.float32)
        elif "up_proj" in k:
            a = a + rs.randn(*a.shape).astype(np.float32) * 0.05
        elif "mlp_token_select" in k and k[-1] == "kernel":
            a = a * 50.0
        out[k] = a
    return out


def _data(seed, n=1, batch=B):
    """n batches of normalized images and labels with 255 borders."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rs.randn(batch, IMG, IMG, 3).astype(np.float32)
        y = rs.randint(0, NC, (batch, IMG, IMG)).astype(np.int32)
        y[:, :5] = 255
        y[:, :, -3:] = 255
        out.append((x, y))
    return out


def _noise(seed, batch=B):
    rs = np.random.RandomState(seed)
    return [rs.logistic(size=(batch, T, 1)).astype(np.float32)
            for _ in range(DEPTH)]


def _patch_jax(mp, noise):
    """jax.random.logistic returns ``noise`` in turn (cycling); flax's
    Dropout is the identity."""
    calls = [0]

    def logistic(key, shape=(), dtype=jnp.float32):
        a = noise[calls[0] % len(noise)]
        calls[0] += 1
        assert a.shape == tuple(shape), (a.shape, shape)
        return jnp.asarray(a, dtype)

    class NoDropout:
        def __init__(self, rate, *a, **kw):
            pass

        def __call__(self, x, *a, **kw):
            return x

    mp.setattr(jax.random, "logistic", logistic)
    mp.setattr(fnn, "Dropout", NoDropout)


# Under BatchNorm heads these biases have no gradient: each adds a constant
# per channel to a map that only a 1x1 ConvModule reads, whose BatchNorm
# subtracts the batch mean.  Their gradients are rounding noise, which Adam
# scales to steps of the lr, each package its own, and the lateral
# BatchNorms' running means carry them; the trajectory freezes them on both
# sides (``_frozen_too``).
NO_GRADIENT = ("backbone.fpn1_deconv2.bias", "backbone.fpn2_deconv.bias")


def _frozen_too(mp):
    """Both packages' seg freeze rule, less ``NO_GRADIENT``."""
    jrule, trule = jsr.seg_trainable_predicate, tsr.seg_trainable_predicate
    mp.setattr(jsr, "seg_trainable_predicate", lambda path: jrule(path) and
               flax_path_to_port(path) not in NO_GRADIENT)
    mp.setattr(tsr, "seg_trainable_predicate",
               lambda name: trule(name) and name not in NO_GRADIENT)


def _port_segmentor(norm, params, stats, **kw):
    tm = tup.DyTSegmentor(port_cfg(model_cfg(**kw)), num_classes=NC,
                          tuning=port_cfg(TUNING), select=port_cfg(SELECT),
                          norm=norm, head_channels=HEAD_CH,
                          dtype=torch.float32)
    tm.load_state_dict({k: _t(v) for k, v in
                        from_flax_params(params, stats).items()}, strict=True)
    tm.decode_head.dropout = tm.auxiliary_head.dropout = 0.0
    return tm


@functools.lru_cache(maxsize=None)
def _variables(norm):
    jm = jup.DyTSegmentor(model_cfg(), num_classes=NC, tuning=TUNING,
                          select=SELECT, norm=norm, head_channels=HEAD_CH,
                          dtype=jnp.float32)
    with mock.patch.dict(os.environ, {"DYT_FUSED_ATTN": "0"}):
        v = jax.jit(jm.init)(jax.random.PRNGKey(0),
                             jnp.zeros((1, IMG, IMG, 3)))
    flat = _live(traverse_util.flatten_dict(
        jax.tree_util.tree_map(np.asarray, v["params"])),
        np.random.RandomState(1))
    return (traverse_util.unflatten_dict(flat),
            jax.tree_util.tree_map(np.asarray, v.get("batch_stats", {})))


# --- the pieces ----------------------------------------------------------------

def test_seg_loss_matches_jax():
    rs = np.random.RandomState(2)
    lg = rs.randn(2, 12, 10, 7).astype(np.float32) * 3
    alg = rs.randn(2, 12, 10, 7).astype(np.float32)
    y = rs.randint(0, 7, (2, 12, 10)).astype(np.int32)
    y[:, :3] = 255
    y[:, :, -2:] = 255
    want_total, want = jup.seg_loss(jnp.asarray(lg), jnp.asarray(alg),
                                    jnp.asarray(y), jnp.float32(0.25))
    total, got = tup.seg_loss(_t(lg), _t(alg), _t(y).long(),
                              torch.tensor(0.25))
    assert set(got) == set(want) == {"decode_loss", "aux_loss", "token_loss"}
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), abs=1e-6), k
    assert float(total) == pytest.approx(float(want_total), abs=1e-6)
    # the mean counts the ignored pixels: dividing by the valid ones differs
    valid = (y != 255).mean()
    assert valid < 0.8 and float(got["decode_loss"]) != pytest.approx(
        float(got["decode_loss"]) / valid, rel=1e-3)


TOTAL = 160_000


@pytest.mark.parametrize("step", [0, 1, 1499, 1500, 1501, TOTAL - 1, TOTAL])
def test_poly_schedule_matches_jax(step):
    want = float(jsr.poly_schedule(1e-3, TOTAL)(jnp.int32(step)))
    got = tsr.poly_schedule(1e-3, TOTAL)(step)
    assert got == pytest.approx(want, rel=1e-7, abs=0)
    if step == 0:
        assert got == pytest.approx(1e-3 * 1e-6, rel=1e-6)


def test_trainable_set_matches_jax():
    params, stats = _variables("bn")
    flat = traverse_util.flatten_dict(params)
    want = {flax_path_to_port(p) for p in flat
            if jsr.seg_trainable_predicate(p)}
    tm = _port_segmentor("bn", params, stats)
    got = {n for n, _ in tm.named_parameters()
           if tsr.seg_trainable_predicate(n)}
    assert got == want
    assert any("relative_position_bias_table" in n for n in got)
    assert "backbone.fpn1_deconv1.weight" in got
    assert "backbone.blocks.0.attn.qkv.weight" not in got
    assert "backbone.pos_embed" not in got


def test_bn_conv_module_training_matches_flax():
    """Output, and running statistics after one step (momentum 0.9, the
    biased fast variance), within 1e-6."""
    rs = np.random.RandomState(3)
    x = rs.randn(3, 6, 5, 16).astype(np.float32)
    jm = jup.ConvModule(32, 3, norm="bn", dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rs.randn(*a.shape).astype(np.float32)
        * 0.1, v["params"])
    stats = {"bn": {"mean": rs.randn(32).astype(np.float32) * 0.1,
                    "var": 1 + np.abs(rs.randn(32)).astype(np.float32)}}
    want, mut = jm.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x), training=True,
                         mutable=["batch_stats"])
    tm = tup.ConvModule(16, 32, 3, torch.Generator(), norm="bn",
                        dtype=torch.float32)
    sd = from_flax_params({"decode_head": {"m": params}},
                          {"decode_head": {"m": stats}})
    tm.load_state_dict({k[len("decode_head.m."):]: _t(a)
                        for k, a in sd.items()}, strict=True)
    got = tm(_t(x).permute(0, 3, 1, 2), training=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    new = mut["batch_stats"]["bn"]
    np.testing.assert_allclose(tm.bn.running_mean.numpy(),
                               np.asarray(new["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.bn.running_var.numpy(),
                               np.asarray(new["var"]), rtol=0, atol=1e-6)
    assert not np.allclose(np.asarray(new["var"]), stats["bn"]["var"])


@pytest.mark.parametrize("norm", ["gn", "bn"])
def test_segmentor_training_forward_and_grads_match_jax(monkeypatch, norm):
    """The training forward (N = 17, the max-subtracted softmax with the
    fp32 bias), seg_loss and every parameter's gradient, fp32.  Logits
    within 1e-4 of their largest magnitude (flax's GroupNorm variance is
    E[x^2] - E[x]^2), gates identical, gradients within 1e-4 relative."""
    params, stats = _variables(norm)
    (x, y), = _data(4)
    noise = _noise(5)
    _patch_jax(monkeypatch, noise)
    jm = jup.DyTSegmentor(model_cfg(), num_classes=NC, tuning=TUNING,
                          select=SELECT, norm=norm, head_channels=HEAD_CH,
                          dtype=jnp.float32)

    def f(p):
        v = {"params": p, **({"batch_stats": stats} if stats else {})}
        (lg, alg, aux), _ = jm.apply(
            v, jnp.asarray(x), training=True, mutable=["batch_stats"],
            rngs={"gate": jax.random.PRNGKey(0),
                  "dropout": jax.random.PRNGKey(1)})
        total, _ = jup.seg_loss(lg, alg, jnp.asarray(y), aux["loss"])
        return total, (lg, aux["token_select"])

    (jl, (jlogits, jts)), gp = jax.jit(jax.value_and_grad(
        f, has_aux=True))(params)
    tm = _port_segmentor(norm, params, stats)
    gate_noise = torch.stack([_t(a) for a in noise], dim=1)
    logits, aux_logits, aux = tm(_t(x), training=True,
                                 gate_noise=gate_noise)
    total, _ = tup.seg_loss(logits, aux_logits, _t(y).long(), aux["loss"])
    total.backward()
    assert float(total.detach()) == pytest.approx(float(jl), rel=1e-5)
    np.testing.assert_array_equal(aux["token_select"].detach().numpy(),
                                  np.asarray(jts))
    want = np.asarray(jlogits)
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    own = dict(tm.named_parameters())
    for name, g in from_flax_params(
            jax.tree_util.tree_map(np.asarray, gp)).items():
        p = own[name]
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), g, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(g).max()),
                                   err_msg=name)


# --- the runner against the JAX runner --------------------------------------

def _port_state(runner):
    """A runner's state dict (every parameter and buffer), Adam moments
    (port names, numpy copies) and Adam count."""
    opt = runner.state.optimizer
    sd = {k: v.detach().numpy().copy()
          for k, v in runner.model.state_dict().items()}
    return (sd, {n: m.numpy().copy() for n, m in zip(opt.names, opt.rule.mu)},
            {n: m.numpy().copy() for n, m in zip(opt.names, opt.rule.nu)},
            opt.rule.count)


def _jax_state(jr):
    """The JAX runner's state in the form of ``_port_state``."""
    host = functools.partial(jax.tree_util.tree_map, np.asarray)
    adam = _find_states(jr.state.opt_state, {})["adam"]
    return (from_flax_params(joptim.merge_params(host(jr.state.trainable),
                                                 host(jr.state.frozen)),
                             host(jr.batch_stats)),
            from_flax_params(joptim.merge_params(host(adam.mu), {})),
            from_flax_params(joptim.merge_params(host(adam.nu), {})),
            int(adam.count))


def _load_port(runner, state, step):
    sd, mu, nu, count = state
    runner.model.load_state_dict({k: _t(v) for k, v in sd.items()},
                                 strict=True)
    opt = runner.state.optimizer
    opt.rule.load_state_dict({"mu": {n: _t(mu[n]) for n in opt.names},
                              "nu": {n: _t(nu[n]) for n in opt.names},
                              "count": count}, opt.names)
    runner.state.step = step


def _to_flax_layout(path, v, shape):
    """``_to_torch_layout`` undone: it only permutes (transposes, flips)."""
    idx = np.arange(int(np.prod(shape))).reshape(shape)
    out = np.empty(idx.size, np.float32)
    out[_to_torch_layout(path, idx).ravel()] = np.asarray(v).ravel()
    return out.reshape(shape)


def _with_adam(node, mu, nu):
    if hasattr(node, "mu") and hasattr(node, "nu"):
        return node._replace(mu=mu, nu=nu)
    if isinstance(node, tuple):
        parts = [_with_adam(c, mu, nu) for c in node]
        return type(node)(*parts) if hasattr(node, "_fields") else tuple(parts)
    return node


def _load_jax(jr, snapshot, state):
    """Put a ``_port_state`` into the JAX runner, on a host ``snapshot`` of
    its (state, batch_stats) after the same step for the rest (counts,
    rng, frozen tensors); fresh arrays, as its train step donates them."""
    sd, mu, nu, _ = state
    jstate, stats = jax.tree_util.tree_map(jnp.asarray, snapshot)

    def tree(src):
        return {k: jnp.asarray(_to_flax_layout(k, src[flax_path_to_port(k)],
                                               np.shape(v)))
                for k, v in jstate.trainable.items()}

    jr.state = jstate._replace(trainable=tree(sd), opt_state=_with_adam(
        jstate.opt_state, tree(mu), tree(nu)))
    jr.batch_stats = traverse_util.unflatten_dict({
        k: jnp.asarray(sd[flax_path_to_port(k)])
        for k in traverse_util.flatten_dict(stats)})


def _off(got, want):
    """Elements of ``got`` outside ``PARAM_TOL`` of ``want`` (shared keys),
    and the largest difference."""
    off, worst = 0, 0.0
    for k, w in want.items():
        g = got[k]
        off += int((~np.isclose(g, w, **PARAM_TOL)).sum())
        worst = max(worst, float(np.abs(g - w).max()))
    return off, worst


@pytest.fixture(scope="module")
def trajectory(tmp_path_factory):
    """Six steps of the JAX SegRunner (BatchNorm heads, batch 8) and of the
    port's, from the same weights, data and noise: the port running free,
    and a second port runner that takes each step from the JAX runner's
    state before it.  Each step's head ReLU inputs are compared between
    the two port runners (``kinks``); the JAX runner is then run again
    from the free port's state after the first step whose signs differ."""
    data = _data(6, STEPS, TRAJ_B)
    noise = _noise(7, TRAJ_B)
    relu_in = []
    with pytest.MonkeyPatch.context() as mp:
        _patch_jax(mp, noise)
        for mod in (jsr, tsr):
            mp.setattr(mod, "poly_schedule", functools.partial(
                mod.poly_schedule, warmup_iters=WARMUP))
        _frozen_too(mp)
        relu = torch.relu
        mp.setattr(torch, "relu",
                   lambda x: relu_in.append(x.detach().clone()) or relu(x))
        jcfg = run_cfg(tmp_path_factory.mktemp("jax"), TRAJ_B)
        jr = jsr.SegRunner(jcfg, total_iters=STEPS, eval_interval=STEPS,
                           crop=IMG, norm=TRAJ_NORM, head_channels=TRAJ_HEAD)
        flat = _live({**jr.state.trainable, **jr.state.frozen},
                     np.random.RandomState(8))
        trainable, frozen = joptim.partition_params(
            traverse_util.unflatten_dict(flat), jsr.seg_trainable_predicate)
        jr.state = create_train_state(trainable, frozen, jr.tx, jr.state.rng)
        params = traverse_util.unflatten_dict(flat)
        stats = jax.tree_util.tree_map(np.asarray, jr.batch_stats)
        pr, tf = (tsr.SegRunner(port_cfg(jcfg).replace(
            output_dir=str(tmp_path_factory.mktemp("port"))),
            total_iters=STEPS, eval_interval=STEPS, crop=IMG, norm=TRAJ_NORM,
            head_channels=TRAJ_HEAD, device="cpu", log=lambda m: None)
            for _ in range(2))
        for r in (pr, tf):
            r.model.load_state_dict({k: _t(v) for k, v in from_flax_params(
                params, stats).items()}, strict=True)
            r.model.decode_head.dropout = 0.0
            r.model.auxiliary_head.dropout = 0.0
        gate_noise = torch.stack([_t(a) for a in noise], dim=1)
        jparts, pparts, forced, free, kinks, after, snaps = ([] for _ in
                                                            range(7))
        for step, (x, y) in enumerate(data):
            before = _jax_state(jr)
            jr.state, jr.batch_stats, p = jr.train_step(
                jr.state, jr.batch_stats, jnp.asarray(x), jnp.asarray(y))
            jparts.append({k: float(v) for k, v in p.items()})
            snaps.append(jax.tree_util.tree_map(
                np.array, (jr.state, jr.batch_stats)))
            want = _jax_state(jr)[0]
            del relu_in[:]
            p = pr.train_step(_t(x), _t(y).long(), gate_noise=gate_noise)
            pparts.append({k: float(v) for k, v in p.items()})
            after.append(_port_state(pr))
            free.append(_off(after[-1][0], want))
            n_free = len(relu_in)
            _load_port(tf, before, step)
            tf.train_step(_t(x), _t(y).long(), gate_noise=gate_noise)
            forced.append(_off(_port_state(tf)[0], want))
            a, b = relu_in[:n_free], relu_in[n_free:]
            assert len(a) == len(b) > 0
            u, v = (torch.cat([t.flatten() for t in ts]) for ts in (a, b))
            flip = (u > 0) != (v > 0)
            kinks.append(list(zip(u[flip].tolist(), v[flip].tolist())))
        first = next((i for i, k in enumerate(kinks) if k), None)
        final = _jax_state(jr)[0]
        rerun = None
        if first is not None:
            _load_jax(jr, snaps[first], after[first])
            for x, y in data[first + 1:]:
                jr.state, jr.batch_stats, _ = jr.train_step(
                    jr.state, jr.batch_stats, jnp.asarray(x), jnp.asarray(y))
            rerun = _jax_state(jr)[0]
    return dict(pr=pr, jparts=jparts, pparts=pparts, forced=forced,
                free=free, kinks=kinks, first=first, final=final,
                rerun=rerun, names=pr.state.optimizer.names)


def test_seg_trajectory_loss_parts_match_jax(trajectory):
    jp_all, tp_all = trajectory["jparts"], trajectory["pparts"]
    assert len(jp_all) == len(tp_all) == STEPS
    for i, (jp, tp) in enumerate(zip(jp_all, tp_all)):
        assert set(jp) == set(tp) == {"loss", "decode_loss", "aux_loss",
                                      "token_loss", "keep_ratio"}
        assert jp["keep_ratio"] == tp["keep_ratio"], f"step {i}"
        for k in jp:
            assert tp[k] == pytest.approx(jp[k], **PART_TOL), (i, k)
    assert abs(jp_all[-1]["loss"] - jp_all[0]["loss"]) > 1e-3


def test_seg_trajectory_steps_match_jax(trajectory):
    """Each step taken from the JAX runner's state before it (weights,
    BatchNorm statistics, Adam moments and count) lands on the JAX
    runner's weights and statistics after it within rtol 2e-3 / atol 5e-5
    on every element."""
    forced = trajectory["forced"]
    assert len(forced) == STEPS
    for step, (off, worst) in enumerate(forced):
        assert off == 0, (step, off, worst)


def test_seg_trajectory_final_weights_match_jax(trajectory):
    """The free-running port's final trainable weights and BatchNorm
    statistics within rtol 2e-3 / atol 5e-5 of the JAX runner's on every
    element -- or, where a step's head ReLU input lies on the other side
    of 0 from the same step taken from the JAX runner's state (a kink: the
    gradient through that unit passes in one run and not in the other),
    of the JAX runner run again from the port's state after the first such
    step.  Up to that step the two runs agree at the same tolerance, and
    that step's kinks are units within ``KINK`` of 0 in both forwards (the
    later steps' follow from the gap it opens)."""
    pr, first = trajectory["pr"], trajectory["first"]
    got = _port_state(pr)[0]
    assert set(trajectory["names"]) <= set(trajectory["final"])
    want = trajectory["final"] if first is None else trajectory["rerun"]
    assert _off(got, want)[0] == 0, _off(got, want)
    for step, (off, worst) in enumerate(trajectory["free"][:first]):
        assert off == 0, (step, off, worst)
    if first is not None:
        kink = trajectory["kinks"][first]
        assert all(abs(u) < KINK and abs(v) < KINK for u, v in kink), kink


def test_seg_bn_fpn_biases_have_no_gradient():
    """Why the trajectory freezes ``NO_GRADIENT``: their gradient is
    rounding noise."""
    params, stats = _variables("bn")
    (x, y), = _data(13, batch=TRAJ_B)
    tm = _port_segmentor("bn", params, stats)
    logits, alg, aux = tm(_t(x), training=True,
                          gate_noise=torch.stack(
                              [_t(a) for a in _noise(14, TRAJ_B)], dim=1))
    tup.seg_loss(logits, alg, _t(y).long(), aux["loss"])[0].backward()
    own = dict(tm.named_parameters())
    scale = own["backbone.fpn1_deconv1.bias"].grad.abs().max()
    for name in NO_GRADIENT:
        assert own[name].grad.abs().max() < 1e-5 * scale, name


def test_seg_trajectory_bn_running_stats_match_jax(trajectory):
    pr = trajectory["pr"]
    own = dict(pr.model.named_buffers())
    want = {k: v for k, v in trajectory["final"].items()
            if k.endswith((".running_mean", ".running_var"))}
    assert len(want) == len(tsr._bn_buffers(pr.model)) > 0
    for name, w in want.items():
        np.testing.assert_allclose(own[name].numpy(), w, err_msg=name,
                                   **PARAM_TOL)


# --- resume, remat, serving after training ----------------------------------

def _port_run(out, **kw):
    cfg = port_cfg(run_cfg(out, auto_remove=False, **kw))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                drop_path_rate=0.1))
    return tsr.SegRunner(cfg, total_iters=4, eval_interval=2, crop=IMG,
                         norm="bn", head_channels=HEAD_CH, device="cpu",
                         log=lambda m: None)


def test_seg_resume_is_bit_identical(tmp_path):
    """4 iterations (evaluations at 2 and 4, drop path and head dropout
    on), then a run resumed from the iteration-2 checkpoint: trainable
    tensors, moments and BatchNorm buffers bit-identical."""
    a = _port_run(tmp_path / "a")
    a.val_ds.n = 2
    a.run()
    assert "checkpoint-2.pth" in os.listdir(tmp_path / "a")
    c = _port_run(tmp_path / "c",
                  resume=str(tmp_path / "a" / "checkpoint-2.pth"))
    c.val_ds.n = 2
    assert c.start_iter == 2
    c.run()
    oa, oc = a.state.optimizer, c.state.optimizer
    assert (a.state.step, oa.count) == (c.state.step, oc.count) == (4, 4)
    pa, pc = dict(a.model.named_parameters()), dict(c.model.named_parameters())
    for n in oa.names:
        assert torch.equal(pa[n], pc[n]), n
    sa, sc = oa.state_dict()["rule"], oc.state_dict()["rule"]
    for part in ("mu", "nu"):
        for n in oa.names:
            assert torch.equal(sa[part][n], sc[part][n]), (part, n)
    ba, bc = dict(a.model.named_buffers()), dict(c.model.named_buffers())
    for n in a.buffers:
        assert torch.equal(ba[n], bc[n]), n
    path = str(tmp_path / "a" / "checkpoint-2.pth")
    blob = torch.load(path)
    assert set(blob["buffers"]) == set(a.buffers) and blob["step"] == 2
    # --eval_ckpt takes it: the BatchNorm statistics come back too
    fresh = _port_run(tmp_path / "e")
    fresh.load_eval_checkpoint(path)
    bf = dict(fresh.model.named_buffers())
    for n in a.buffers:
        assert torch.equal(bf[n], blob["buffers"][n]), n
        assert not torch.equal(bf[n], ba[n]), n


@pytest.mark.parametrize("remat", [True, "scores"])
def test_seg_remat_gradients_are_bit_identical(remat):
    """Windowed blocks recomputed in the backward draw what their forward
    drew: with drop path, head dropout and adapter dropout on and the noise
    drawn from the gate stream, every gradient equals the one without
    remat bit for bit."""
    params, stats = _variables("gn")
    (x, y), = _data(9)
    tuning = dataclasses.replace(TUNING, dropout=0.1)
    grads = []
    for r in (False, remat):
        tm = tup.DyTSegmentor(
            port_cfg(model_cfg(remat=r, drop_path_rate=0.2)), num_classes=NC,
            tuning=port_cfg(tuning), select=port_cfg(SELECT),
            head_channels=HEAD_CH, dtype=torch.float32)
        tm.load_state_dict({k: _t(v) for k, v in
                            from_flax_params(params, stats).items()})
        logits, alg, aux = tm(_t(x), training=True,
                              draws=tlayers.Draws("cpu", gate=3, dropout=4))
        tup.seg_loss(logits, alg, _t(y).long(), aux["loss"])[0].backward()
        grads.append({n: p.grad for n, p in tm.named_parameters()})
    for n, g in grads[0].items():
        assert g is not None and torch.equal(g, grads[1][n]), n


def test_seg_serving_copies_follow_optimizer_steps(tmp_path):
    """After training steps, the eval forward (which serves cached copies
    of the weights, the rel-pos tables among them) equals a fresh model
    loaded with the trained state dict."""
    r = _port_run(tmp_path)
    (x, y), = _data(10)
    with torch.no_grad():
        before, _, _ = r.model(_t(x))
    for _ in range(2):
        r.train_step(_t(x), _t(y).long())
    with torch.no_grad():
        after, _, _ = r.model(_t(x))
    fresh = tup.DyTSegmentor(r.cfg.model, num_classes=NC,
                             tuning=r.cfg.tuning, select=r.cfg.select,
                             norm="bn", head_channels=HEAD_CH,
                             dtype=torch.float32)
    fresh.load_state_dict(r.model.state_dict())
    with torch.no_grad():
        again, _, _ = fresh(_t(x))
    assert not torch.equal(after, before)
    assert torch.equal(after, again)


# --- int8 ----------------------------------------------------------------------

@pytest.mark.parametrize("kernel", [1, 3])
def test_q8_conv_matches_jax(kernel):
    """The head's int8 conv (stride 1, SAME): codes and int32 sums equal to
    JAX's, the fp32 output within one ulp.  One sample is all zeros (its
    codes and scale 0)."""
    rs = np.random.RandomState(11 + kernel)
    x = rs.randn(3, 7, 9, 24).astype(np.float32) * 2
    x[1] = 0.0
    w = rs.randn(kernel, kernel, 24, 40).astype(np.float32) * 0.1
    want = np.asarray(jq.q8_conv(jnp.asarray(x), jnp.asarray(w),
                                 strides=(1, 1), padding="SAME"))
    # JAX's codes and int32 sums (ops/quant.py:729-738)
    wmax = jnp.max(jnp.abs(w), axis=(0, 1, 2))
    jwq = jnp.clip(jnp.round(w * jnp.where(wmax > 0, 127.0 / wmax, 0.0)),
                   -127, 127).astype(jnp.int8)
    amax = jnp.max(jnp.abs(x), axis=(1, 2, 3), keepdims=True)
    jxq = jnp.clip(jnp.round(x * jnp.where(amax > 0, 127.0 / amax, 0.0)),
                   -127, 127).astype(jnp.int8)
    jacc = jax.lax.conv_general_dilated(
        jxq, jwq, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    wt = _t(w.transpose(3, 2, 0, 1))
    wq, ws = tq.quantize_conv_weight(wt)
    xq, _ = tq.sample_quant(_t(x))
    np.testing.assert_array_equal(
        wq.reshape(40, kernel, kernel, 24).permute(1, 2, 3, 0).numpy(),
        np.asarray(jwq))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    acc = tq.int_matmul(tq.im2col(xq, kernel), wq).reshape(3, 7, 9, 40)
    np.testing.assert_array_equal(acc.numpy(),
                                  np.asarray(jacc).astype(np.float32))
    got = tq.q8_conv(_t(x), wt)
    assert got.shape == (3, 7, 9, 40)
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
    assert not got[1].any()


@pytest.mark.parametrize("mode", ["mask", "dispatch"])
def test_int8_segmentor_matches_jax(monkeypatch, mode):
    """int8 serving: the int8 stem, K4 on every block's MLP rows (the
    attention stays on K9), q8_conv in every ConvModule.  The JAX model
    runs its Pallas kernels in interpret mode (without it JAX on the CPU
    turns int8 off).  The rule of the image int8 tests
    (test_torch_port_model.py): logits within 1e-2 of their largest
    magnitude (a last-bit difference of an fp32 sum can move one
    activation across an int8 rounding boundary), every gate identical."""
    params, stats = _variables("gn")
    monkeypatch.setenv("DYT_FUSED_ATTN", "interpret")
    jm = jup.DyTSegmentor(model_cfg(quant="int8"), num_classes=NC,
                          tuning=TUNING, select=SELECT,
                          head_channels=HEAD_CH, dtype=jnp.float32)
    tm = _port_segmentor("gn", params, stats, quant="int8")
    assert all(b.quant == "int8" for b in tm.backbone.blocks)
    (x, _), = _data(12)
    kw = {"dispatch": True} if mode == "dispatch" else {}
    jl, ja, jaux = jm.apply({"params": params}, jnp.asarray(x), **kw)
    tl, ta, taux = tm(_t(x), **kw)
    for got, want in ((tl, jl), (ta, ja)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-2 * np.abs(want).max())
    np.testing.assert_array_equal(taux["token_select"].numpy(),
                                  np.asarray(jaux["token_select"]))
    # and it is int8: the fp32 model's logits lie farther away
    f32 = _port_segmentor("gn", params, stats)
    fl, _, _ = f32(_t(x), **kw)
    assert (fl - tl).abs().max() > 1e-2 * tl.abs().max()
