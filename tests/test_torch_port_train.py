"""The port's training path against the JAX package's, on the CPU.

Toy size, as tests/test_train_parity.py: width 64, 4 heads, depth 2,
adapter 8, 32x32 images of 8x8 patches (16 tokens + CLS), batch 8, fp32.
Weights cross from the JAX param tree through checkpoint.from_flax_params.
The routers' gumbel noise is the same numpy array on both sides:
jax.random.logistic is patched to return it, and the port takes it as
``gate_noise``/``noise``.  Dropout draws cannot match across the two
packages' generators, so every comparison with JAX runs at dropout 0; the
port's own draws are held to their seeds (remat, masks).

* the 12-step AdamW warmup-cosine trajectory (the JAX engine jitted once,
  so the noise is one array per block for every step): every loss part
  within rtol 1e-3 / atol 2e-5 per step, keep_ratio equal, the final
  trainable parameters within rtol 2e-3 / atol 5e-5 and the gates of a
  training forward on them identical; the port's trajectory with
  ``remat=True`` and ``remat="scores"``, dropout on, bit-identical to its
  trajectory without remat;
* Block and VisionTransformer training forwards and gradients against
  ``jax.grad`` (attention dropout 0, so the softmax branch), the Attention
  module in bf16 training against JAX's;
* the losses term by term, the optimizer pieces against optax, flops.py
  exactly, the adapter's in/out LayerNorm in eval and training, the
  dropout and stochastic-depth masks, the freeze rule, the serving copies
  of the weights after optimizer steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dynamic_tuning_tpu.config import ModelConfig, SelectConfig, TuningConfig
from dynamic_tuning_tpu.models import layers as jlayers
from dynamic_tuning_tpu.models.vit import VisionTransformer as JaxViT
from dynamic_tuning_tpu.ops import flops as jflops
from dynamic_tuning_tpu.train import losses as jlosses
from dynamic_tuning_tpu.train import optim as joptim
from dynamic_tuning_tpu.train.engine import (create_train_state,
                                             make_train_step, model_apply_fn)
from dynamic_tuning_tpu_torch import config as tcfg
from dynamic_tuning_tpu_torch.checkpoint import from_flax_params
from dynamic_tuning_tpu_torch.models import layers as tlayers
from dynamic_tuning_tpu_torch.models.vit import VisionTransformer
from dynamic_tuning_tpu_torch.ops import flops as tflops
from dynamic_tuning_tpu_torch.train import engine, optim
from dynamic_tuning_tpu_torch.train import losses as tlosses

DIM, HEADS, DEPTH, FFN, CLASSES = 64, 4, 2, 8, 10
IMG, PATCH, B = 32, 8, 8
T = (IMG // PATCH) ** 2
STEPS, SPE = 12, 4          # 3 "epochs" of 4 steps: warmup + cosine both hit
BASE_LR, WD = 5e-3, 0.01
SEL = SelectConfig()        # target 0.5, ratio 2.0, tau 5
DROPS = dict(drop_path_rate=0.1, attn_drop_rate=0.1, proj_drop_rate=0.1,
             pos_drop_rate=0.1, drop_rate=0.1)


def port_cfg(cfg, **overrides):
    """The port's own config object with the fields of a JAX-package one."""
    fields = {**dataclasses.asdict(cfg), **overrides}
    return getattr(tcfg, type(cfg).__name__)(**fields)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _patch_noise(mp, arrays):
    """jax.random.logistic returns ``arrays`` in turn (cycling): the router
    noise of each routed block, in call order."""
    calls = [0]

    def logistic(key, shape=(), dtype=jnp.float32):
        a = arrays[calls[0] % len(arrays)]
        calls[0] += 1
        assert a.shape == tuple(shape), (a.shape, shape)
        return jnp.asarray(a, dtype)

    mp.setattr(jax.random, "logistic", logistic)


def _setup():
    mc = ModelConfig(img_size=IMG, patch_size=PATCH, embed_dim=DIM,
                     depth=DEPTH, num_heads=HEADS, num_classes=CLASSES)
    tuning = TuningConfig(ffn_num=FFN, d_model=DIM, dropout=0.0)
    model = JaxViT(mc, tuning=tuning, select=SEL, dtype=jnp.float32)
    rs = np.random.RandomState(3)
    x0 = jnp.asarray(rs.randn(B, IMG, IMG, 3).astype(np.float32))
    params = model.init(jax.random.PRNGKey(1), x0)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    for i in range(DEPTH):
        blk = params[f"blocks_{i}"]
        # hard gates with margin; a live adapter from the first step
        blk["mlp_token_select"]["mlp_head"]["kernel"] = (
            blk["mlp_token_select"]["mlp_head"]["kernel"] * 60.0)
        blk["adaptmlp"]["up_proj"]["kernel"] = (
            rs.randn(FFN, DIM).astype(np.float32) * 0.05)
    data = [(rs.randn(B, IMG, IMG, 3).astype(np.float32),
             rs.randint(0, CLASSES, (B,)).astype(np.int64))
            for _ in range(STEPS)]
    noise = [rs.logistic(size=(B, T, 1)).astype(np.float32)
             for _ in range(DEPTH)]
    return mc, tuning, model, params, data, noise


def _port_model(mc, tuning, params, **model_overrides):
    tm = VisionTransformer(port_cfg(mc, **model_overrides),
                           tuning=port_cfg(tuning), select=port_cfg(SEL),
                           dtype=torch.float32)
    tm.load_state_dict({k: _t(v) for k, v in
                        from_flax_params(params).items()}, strict=True)
    return tm


def _port_trajectory(mc, tuning, params, data, noise, **model_overrides):
    tm = _port_model(mc, tuning, params, **model_overrides)
    named = optim.freeze(tm)
    opt = optim.make_optimizer(named, BASE_LR, epochs=STEPS / SPE,
                               warmup_epochs=1.0, steps_per_epoch=SPE,
                               weight_decay=WD)
    state = engine.TrainState(opt, seed=5)
    step = engine.make_train_step(tm, SEL)
    gate_noise = (None if noise is None
                  else torch.stack([_t(a) for a in noise], dim=1))
    parts = [step(state, _t(x), _t(y), gate_noise=gate_noise)
             for x, y in data]
    return tm, parts, gate_noise


@pytest.fixture(scope="module")
def trajectory():
    """The JAX engine's 12 steps (jitted) and the port's from the same
    weights, data and noise."""
    mc, tuning, model, params, data, noise = _setup()
    with pytest.MonkeyPatch.context() as mp:
        _patch_noise(mp, noise)
        trainable, frozen = joptim.partition_params(params)
        tx = joptim.make_optimizer(BASE_LR, epochs=STEPS / SPE,
                                   warmup_epochs=1.0, steps_per_epoch=SPE,
                                   weight_decay=WD)
        state = create_train_state(trainable, frozen, tx,
                                   jax.random.PRNGKey(7))
        step = jax.jit(make_train_step(model_apply_fn(model), tx, SEL))
        jax_parts = []
        for x, y in data:
            state, parts = step(state, jnp.asarray(x), jnp.asarray(y))
            jax_parts.append({k: float(v) for k, v in parts.items()})
        final = joptim.merge_params(state.trainable, state.frozen)
        _, jaux = model.apply({"params": final}, jnp.asarray(data[0][0]),
                              training=True,
                              rngs={"gate": jax.random.PRNGKey(0),
                                    "dropout": jax.random.PRNGKey(0)})
    tm, port_parts, gate_noise = _port_trajectory(mc, tuning, params, data,
                                                  noise)
    return dict(mc=mc, tuning=tuning, params=params, data=data, noise=noise,
                jax_parts=jax_parts, jax_trainable=state.trainable,
                jax_gates=np.asarray(jaux["token_select"]), port=tm,
                port_parts=port_parts, gate_noise=gate_noise)


def test_trajectory_loss_parts_match_jax(trajectory):
    jp_all, tp_all = trajectory["jax_parts"], trajectory["port_parts"]
    for i, (jp, tp) in enumerate(zip(jp_all, tp_all)):
        assert set(jp) == set(tp), (set(jp), set(tp))
        # one gate flipped moves the keep ratio by 1/256; identical gates
        # summed in another order, by an fp32 rounding at most
        assert jp["keep_ratio"] == pytest.approx(float(tp["keep_ratio"]),
                                                 abs=1e-6), \
            f"step {i}: gate sets diverged"
        for key in ("loss", "base_loss", "token_loss", "teacher_loss",
                    "distillation_loss", "grad_norm"):
            assert jp[key] == pytest.approx(float(tp[key]), rel=1e-3,
                                            abs=2e-5), \
                f"step {i} {key}: jax {jp[key]} port {float(tp[key])}"
    assert abs(jp_all[-1]["loss"] - jp_all[0]["loss"]) > 1e-3


def test_trajectory_final_params_and_gates_match_jax(trajectory):
    tm = trajectory["port"]
    own = dict(tm.named_parameters())
    want = from_flax_params(joptim.merge_params(trajectory["jax_trainable"],
                                                {}))
    assert len(want) == len(trajectory["jax_trainable"])
    for name, w in want.items():
        np.testing.assert_allclose(own[name].detach().numpy(), w,
                                   rtol=2e-3, atol=5e-5, err_msg=name)
    x = _t(trajectory["data"][0][0])
    with torch.no_grad():
        _, aux = tm(x, training=True, gate_noise=trajectory["gate_noise"])
    np.testing.assert_array_equal(aux["token_select"].numpy(),
                                  trajectory["jax_gates"])


@pytest.mark.parametrize("remat", [True, "scores"])
def test_remat_trajectory_is_bit_identical(trajectory, remat):
    """With every dropout on and the gumbel noise drawn from the gate
    stream, the port's remat trajectories equal its trajectory without
    remat bit for bit: a recomputed block draws what its forward drew."""
    t = trajectory
    tuning = dataclasses.replace(t["tuning"], dropout=0.1)
    runs = [_port_trajectory(t["mc"], tuning, t["params"], t["data"][:6],
                             None, remat=r, **DROPS)
            for r in (False, remat)]
    (m0, p0, _), (m1, p1, _) = runs
    for i, (a, b) in enumerate(zip(p0, p1)):
        for k in a:
            assert torch.equal(a[k], b[k]), f"step {i} {k}: {a[k]} {b[k]}"
    for (n, a), (_, b) in zip(m0.named_parameters(), m1.named_parameters()):
        assert torch.equal(a, b), n
    assert not torch.equal(p0[0]["loss"], p0[1]["loss"])


@pytest.mark.parametrize("remat", [True, "scores"])
def test_remat_gradients_are_bit_identical(trajectory, remat):
    """One training forward and backward, every dropout on, the noise drawn
    from the gate stream: every parameter's gradient (all of them train)
    equals the one without remat bit for bit."""
    t = trajectory
    tuning = dataclasses.replace(t["tuning"], dropout=0.1)
    x, y = (_t(a) for a in t["data"][0])
    grads = []
    for r in (False, remat):
        tm = _port_model(t["mc"], tuning, t["params"], remat=r, **DROPS)
        logits, aux = tm(x, training=True,
                         draws=tlayers.Draws("cpu", gate=3, dropout=4))
        loss, _ = tlosses.ada_loss(logits, y, aux["token_select"], SEL)
        loss.backward()
        grads.append({n: p.grad for n, p in tm.named_parameters()})
    for n, g in grads[0].items():
        assert g is not None and torch.equal(g, grads[1][n]), n


# --- forwards and gradients against jax.grad --------------------------------

def _block_pair(monkeypatch, *, dim=DIM, heads=HEADS, ln="none", moe=0,
                dtype="float32"):
    monkeypatch.setenv("DYT_FUSED_ATTN", "interpret")
    tuning = TuningConfig(ffn_num=FFN, d_model=dim, dropout=0.0,
                          ffn_adapter_layernorm_option=ln, moe_experts=moe)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jb = jlayers.Block(heads, tuning=tuning, select_cfg=SEL, dtype=jdt)
    rs = np.random.RandomState(11)
    x = rs.randn(3, T + 1, dim).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jb.init(
        {"params": jax.random.PRNGKey(2), "gate": jax.random.PRNGKey(3)},
        jnp.asarray(x), True)["params"])
    # nonzero everywhere: a live adapter, margin on the gates, LN affine
    params = jax.tree_util.tree_map(
        lambda a: a + rs.randn(*a.shape).astype(np.float32) * 0.05, params)
    params["mlp_token_select"]["mlp_head"]["kernel"] *= 40.0
    tb = tlayers.Block(dim, heads, torch.Generator(), tuning=port_cfg(tuning),
                       select_cfg=port_cfg(SEL), dtype=tdt)
    sd = from_flax_params({"blocks_0": params})
    tb.load_state_dict({k[len("blocks.0."):]: _t(v) for k, v in sd.items()},
                       strict=True)
    noise = rs.logistic(size=(3, T, 1)).astype(np.float32)
    return jb, params, tb, x, noise, rs


def _jax_block_grads(monkeypatch, jb, params, x, noise, w):
    _patch_noise(monkeypatch, [noise])

    def f(p, xx):
        out, gate, _ = jb.apply({"params": p}, xx, True,
                                rngs={"gate": jax.random.PRNGKey(0)})
        return (out * w).sum() + gate.sum(), (out, gate)

    (_, (out, gate)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return np.asarray(out), np.asarray(gate), gp, np.asarray(gx)


def _port_block_grads(tb, x, noise, w):
    xt = _t(x).requires_grad_(True)
    out, gate, _ = tb(xt, training=True, noise=_t(noise))
    ((out * _t(w)).sum() + gate.sum()).backward()
    return out.detach().numpy(), gate.detach().numpy(), xt.grad.numpy()


def _check_param_grads(gp, tb, prefix="", rtol=1e-4, atol=1e-5):
    flat = from_flax_params(jax.tree_util.tree_map(np.asarray, gp))
    own = dict(tb.named_parameters())
    for name, want in flat.items():
        p = own[name[len(prefix):]]
        got = (p.grad if p.grad is not None else torch.zeros_like(p))
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                                   atol=atol * max(1.0, np.abs(want).max()),
                                   err_msg=name)


@pytest.mark.parametrize("case", [
    dict(), dict(dim=128, heads=2), dict(ln="in"), dict(ln="out"),
    dict(moe=4)], ids=["plain", "fusable_shape", "ln_in", "ln_out", "moe4"])
def test_block_training_forward_and_grads_match_jax(monkeypatch, case):
    """Training, attention dropout 0: the softmax branch and the module
    path (a fusable shape too: training never fuses)."""
    jb, params, tb, x, noise, rs = _block_pair(monkeypatch, **case)
    w = rs.randn(*x.shape).astype(np.float32)
    jout, jgate, gp, jgx = _jax_block_grads(monkeypatch, jb, params, x,
                                            noise, w)
    tout, tgate, tgx = _port_block_grads(tb, x, noise, w)
    np.testing.assert_array_equal(tgate, jgate)
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgx, jgx, rtol=1e-4,
                               atol=1e-5 * np.abs(jgx).max())
    _check_param_grads({"blocks_0": gp}, tb, prefix="blocks.0.")


def test_vit_training_forward_and_grads_match_jax(monkeypatch):
    mc, tuning, model, params, data, noise = _setup()
    x, y = data[0]
    _patch_noise(monkeypatch, noise)

    def f(p):
        logits, aux = model.apply({"params": p}, jnp.asarray(x),
                                  training=True,
                                  rngs={"gate": jax.random.PRNGKey(0),
                                        "dropout": jax.random.PRNGKey(1)})
        loss, _ = jlosses.ada_loss(logits, jnp.asarray(y),
                                   aux["token_select"], SEL)
        return loss, (logits, aux["token_select"])

    (jl, (jlogits, jts)), gp = jax.jit(jax.value_and_grad(
        f, has_aux=True))(params)
    tm = _port_model(mc, tuning, params)
    gate_noise = torch.stack([_t(a) for a in noise], dim=1)
    logits, aux = tm(_t(x), training=True, gate_noise=gate_noise)
    loss, _ = tlosses.ada_loss(logits, _t(y), aux["token_select"], SEL)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    np.testing.assert_array_equal(aux["token_select"].detach().numpy(),
                                  np.asarray(jts))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    _check_param_grads(gp, tm)


def test_attention_bf16_training_takes_the_softmax_branch(monkeypatch):
    """bf16, attention dropout 0, training: JAX's softmax, probabilities
    rounded to bf16, bf16 product -- not the serving clamp form, which
    rounds elsewhere (its outputs differ on a few percent of elements)."""
    monkeypatch.setenv("DYT_FUSED_ATTN", "interpret")
    rs = np.random.RandomState(4)
    x = rs.randn(4, 65, 128).astype(np.float32)
    ja = jlayers.Attention(2, dtype=jnp.bfloat16)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * 3.0,
        ja.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.bfloat16))["params"])
    want = np.asarray(ja.apply({"params": params}, jnp.asarray(
        x, jnp.bfloat16), deterministic=False).astype(jnp.float32))
    ta = tlayers.Attention(128, 2, torch.Generator(), dtype=torch.bfloat16)
    sd = from_flax_params({"blocks_0": {"attn": params}})
    ta.load_state_dict({k[len("blocks.0.attn."):]: _t(v)
                        for k, v in sd.items()}, strict=True)
    xb = _t(x).to(torch.bfloat16)
    got = ta(xb, training=True).float().detach().numpy()
    with torch.no_grad():
        serving = ta(xb).float().numpy()
    ulp = 2.0 ** -8 * np.abs(want).max()
    assert np.abs(got - want).max() <= 2 * ulp
    assert np.mean(got == want) >= 0.99
    assert np.mean(serving == want) < np.mean(got == want)


# --- the adapter's in/out LayerNorm -----------------------------------------

@pytest.mark.parametrize("ln", ["in", "out"])
@pytest.mark.parametrize("dispatch", [False, True])
def test_adapter_layernorm_block_eval_matches_jax(monkeypatch, ln, dispatch):
    """Serving: the block runs K2 (its plain version here), then the router
    and the adapter module, as the JAX Block in interpret mode."""
    jb, params, tb, x, _, _ = _block_pair(monkeypatch, dim=128, heads=2,
                                          ln=ln)
    jout, jgate, _ = jb.apply({"params": params}, jnp.asarray(x), False,
                              False, dispatch)
    with torch.no_grad():
        tout, tgate, _ = tb(_t(x), False, dispatch)
    np.testing.assert_array_equal(tgate.numpy(), np.asarray(jgate))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    assert tb.adaptmlp.adapter_layer_norm_before.weight.shape == (128,)


def test_adapter_layernorm_block_takes_the_sublayer_kernel(monkeypatch):
    """An in/out-LN adapter does not fuse into K3: the block's sublayer is
    K2's wrapper, then the module router and adapter."""
    from dynamic_tuning_tpu_torch.ops import mha_serving as ms
    _, _, tb, x, _, _ = _block_pair(monkeypatch, dim=128, heads=2, ln="in")
    calls = []
    real = ms.attention_sublayer_serving
    monkeypatch.setattr(ms, "attention_sublayer_serving",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(ms, "dyt_prologue_serving", None)
    with torch.no_grad():
        tb(_t(x), False, True)
    assert calls == [1]


# --- the losses ---------------------------------------------------------------

def test_losses_match_jax_term_by_term():
    rs = np.random.RandomState(5)
    s = rs.randn(6, CLASSES).astype(np.float32) * 3
    t = rs.randn(6, CLASSES).astype(np.float32) * 3
    y = rs.randint(0, CLASSES, 6)
    ts = (rs.rand(6, 3, 16, 1) > 0.4).astype(np.float32)
    cfg = SelectConfig(token_minimal=0.7, token_minimal_weight=0.5)
    tcf = port_cfg(cfg)
    close = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        float(tlosses.cross_entropy(_t(s), _t(y))),
        float(jlosses.cross_entropy(jnp.asarray(s), jnp.asarray(y))), **close)
    np.testing.assert_allclose(
        float(tlosses.token_budget_loss(_t(ts), tcf)),
        float(jlosses.token_budget_loss(jnp.asarray(ts), cfg)), **close)
    np.testing.assert_allclose(
        float(tlosses.distillation_kl(_t(s), _t(t))),
        float(jlosses.distillation_kl(jnp.asarray(s), jnp.asarray(t))),
        **close)
    jt, jparts = jlosses.dyt_total_loss(jnp.asarray(s), jnp.asarray(t),
                                        jnp.asarray(y), jnp.asarray(ts), cfg)
    tt, tparts = tlosses.dyt_total_loss(_t(s), _t(t), _t(y), _t(ts), tcf)
    np.testing.assert_allclose(float(tt), float(jt), **close)
    assert set(tparts) == set(jparts)
    for k in jparts:
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                   **close)
    assert float(tlosses.token_budget_loss(None, tcf)) == 0.0


def test_total_loss_gradients_match_jax():
    """The teacher's CE back-propagates; only its log-probabilities in the
    KL are detached."""
    rs = np.random.RandomState(6)
    s = rs.randn(5, CLASSES).astype(np.float32)
    t = rs.randn(5, CLASSES).astype(np.float32)
    y = rs.randint(0, CLASSES, 5)
    gs, gt = jax.grad(lambda a, b: jlosses.dyt_total_loss(
        a, b, jnp.asarray(y), None, SEL)[0], argnums=(0, 1))(
        jnp.asarray(s), jnp.asarray(t))
    ts, tt = _t(s).requires_grad_(True), _t(t).requires_grad_(True)
    tlosses.dyt_total_loss(ts, tt, _t(y), None, port_cfg(SEL))[0].backward()
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gs), atol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt), atol=1e-6)
    assert np.abs(np.asarray(gt)).max() > 1e-3


# --- the optimizer against optax ---------------------------------------------

_NAMES = {("cls_token",): "cls_token",
          ("patch_embed", "proj", "kernel"): "patch_embed.proj.weight",
          ("blocks_0", "adaptmlp", "down_proj", "kernel"):
              "blocks.0.adaptmlp.down_proj.weight",
          ("blocks_1", "adaptmlp", "up_proj", "bias"):
              "blocks.1.adaptmlp.up_proj.bias",
          ("blocks_1", "mlp_token_select", "mlp_head", "kernel"):
              "blocks.1.mlp_token_select.mlp_head.weight",
          ("head", "kernel"): "head.weight",
          ("head", "bias"): "head.bias"}


def _opt_case(seed=8, steps=6):
    rs = np.random.RandomState(seed)
    shapes = [(1, 1, 4), (3, 5), (6, 4), (7,), (4, 1), (4, 3), (3,)]
    p0 = {k: rs.randn(*s).astype(np.float32)
          for k, s in zip(_NAMES, shapes)}
    grads = [{k: (rs.randn(*v.shape) * 3).astype(np.float32)
              for k, v in p0.items()} for _ in range(steps)]
    return p0, grads


def _run_optax(tx, p0, grads):
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)

    @jax.jit
    def step(params, state, g):
        upd, state = tx.update(g, state, params)
        return optax.apply_updates(params, upd), state

    for g in grads:
        params, state = step(params, state,
                             {k: jnp.asarray(v) for k, v in g.items()})
    return {k: np.asarray(v) for k, v in params.items()}


def _run_port(make, p0, grads):
    named = [(_NAMES[k], _t(v.copy())) for k, v in p0.items()]
    opt = make(named)
    for g in grads:
        opt.step([_t(g[k]) for k in p0])
    return {k: p.numpy() for k, (_, p) in zip(p0, named)}


@pytest.mark.parametrize("kind", ["adamw", "clip", "layer_decay",
                                  "start_step", "accum", "lars"])
def test_optimizer_matches_optax(kind):
    p0, grads = _opt_case()
    kw = dict(epochs=3, warmup_epochs=1, steps_per_epoch=2,
              weight_decay=0.05)
    if kind == "lars":
        tx = joptim.lars(0.1, weight_decay=0.01)
        make = lambda named: optim.Optimizer(named, optim.Lars(
            [p for _, p in named], 0.1, weight_decay=0.01))
    else:
        extra = {"clip": dict(clip_grad=2.0),
                 "layer_decay": dict(layer_decay=0.65),
                 "start_step": dict(start_step=3)}.get(kind, {})
        tx = joptim.make_optimizer(
            1e-2, **kw, **extra,
            params=p0 if kind == "layer_decay" else None)
        if kind == "accum":
            tx = joptim.with_grad_accumulation(tx, 3)
            extra = dict(accum_iter=3)
        make = lambda named: optim.make_optimizer(named, 1e-2, **kw, **extra)
    want = _run_optax(tx, p0, grads)
    got = _run_port(make, p0, grads)
    for k in p0:
        assert not np.array_equal(got[k], p0[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=f"{kind} {k}")


def test_schedule_and_layer_decay_scales_match_jax():
    j = joptim.warmup_cosine_schedule(1e-3, 1e-5, 10, 2.5, 7)
    t = optim.warmup_cosine_schedule(1e-3, 1e-5, 10, 2.5, 7)
    # the JAX schedule computes in fp32, the port's in float64
    for step in range(0, 80):
        np.testing.assert_allclose(t(step), float(j(step)), rtol=0,
                                   atol=1e-6 * 1e-3)
    jm = joptim.layerwise_lr_decay_mask(
        {k: None for k in _NAMES}, decay_rate=0.65)
    tm = optim.layerwise_lr_decay_scales(list(_NAMES.values()),
                                         decay_rate=0.65)
    assert {_NAMES[k]: v for k, v in jm.items()} == tm


def test_freeze_rule_and_count_match_jax():
    mc, tuning, model, params, _, _ = _setup()
    trainable, frozen = joptim.partition_params(params)
    tm = _port_model(mc, tuning, params)
    named = optim.freeze(tm)
    want = {k for k in from_flax_params(joptim.merge_params(trainable, {}))}
    assert {n for n, _ in named} == want
    assert all(not p.requires_grad for n, p in tm.named_parameters()
               if n not in want)
    assert optim.count_params(named) == joptim.count_params(trainable)
    assert (optim.count_params(named, exclude_head=False)
            == joptim.count_params(trainable, exclude_head=False))


# --- flops.py ------------------------------------------------------------------

def test_flops_match_jax_exactly():
    assert tflops.dense_vit_flops() == jflops.dense_vit_flops()
    assert (tflops.dense_vit_flops(T=50, depth=3, dim=64, num_classes=10)
            == jflops.dense_vit_flops(T=50, depth=3, dim=64, num_classes=10))
    assert tflops.get_block_flops(T=17, dim=64, bottleneck=8) == \
        jflops.get_block_flops(T=17, dim=64, bottleneck=8)
    assert tflops.base_flops(100) == jflops.base_flops(100)
    ts = (np.random.RandomState(0).rand(4, 10, 196, 1) > 0.5)
    np.testing.assert_array_equal(
        tflops.batch_select_flops(ts, keep_layers=2),
        jflops.batch_select_flops(ts, keep_layers=2))
    with pytest.raises(ValueError):
        tflops.batch_select_flops(ts, keep_layers=3)


# --- the port's own draws -------------------------------------------------------

def test_dropout_and_drop_path_masks_follow_their_seed():
    x = torch.ones(64, 50, 8)
    dp = tlayers.DropPath(0.3)

    def draw(seed, i=0):
        d = tlayers.Draws("cpu", dropout=seed).fold(i)
        return tlayers.dropout(x, 0.25, d), dp(x, training=True, draws=d)

    a, b, c = draw(1), draw(1), draw(2)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[1], c[1])
    assert not torch.equal(a[0], draw(1, i=1)[0])
    # inverted scaling and the keep rates
    assert set(a[0].unique().tolist()) <= {0.0, torch.tensor(1 / 0.75).item()}
    assert abs((a[0] != 0).float().mean().item() - 0.75) < 0.02
    per_sample = (a[1] != 0).float().mean(dim=(1, 2))
    assert set(per_sample.tolist()) <= {0.0, 1.0}
    assert torch.equal(dp(x), x) and torch.equal(
        tlayers.dropout(x, 0.0, None), x)
    with pytest.raises(ValueError, match="draws"):
        tlayers.dropout(x, 0.5, None)


def test_training_forward_without_draws_raises():
    mc, tuning, _, params, data, _ = _setup()
    tm = _port_model(mc, tuning, params)
    with pytest.raises(ValueError, match="draws"):
        tm(_t(data[0][0]), training=True)


def test_serving_copies_follow_optimizer_steps():
    """A model that served, trained and serves again gives what a fresh
    copy of the trained weights gives: the compute-dtype weight caches
    refresh after the optimizer's in-place updates."""
    rs = np.random.RandomState(9)
    cfg = tcfg.ModelConfig(img_size=IMG, patch_size=PATCH, embed_dim=128,
                           depth=DEPTH, num_heads=2, num_classes=CLASSES)
    kw = dict(tuning=tcfg.TuningConfig(ffn_num=FFN, d_model=128),
              select=tcfg.SelectConfig(), dtype=torch.bfloat16)
    tm = VisionTransformer(cfg, **kw, generator=torch.Generator().manual_seed(0))
    x = _t(rs.randn(4, IMG, IMG, 3).astype(np.float32))
    before, _ = tm(x, dispatch=True)
    named = optim.freeze(tm)
    opt = optim.make_optimizer(named, 5e-2, warmup_epochs=0)
    step = engine.make_train_step(tm, kw["select"])
    state = engine.TrainState(opt, seed=1)
    for _ in range(3):
        step(state, x, torch.zeros(4, dtype=torch.int64))
    after, _ = tm(x, dispatch=True)
    fresh = VisionTransformer(cfg, **kw)
    fresh.load_state_dict(tm.state_dict())
    want, _ = fresh(x, dispatch=True)
    assert not torch.equal(after, before)
    assert torch.equal(after, want)
