"""The port's image runner, checkpoints and entry points against the JAX
package's, on the CPU.

Toy size: 32x32 images of 8x8 patches (16 tokens + CLS), width 128 in two
heads of 64 (so eval takes the plain version of K3, the function the card
runs), depth 2, adapter 8, fp32, dropout 0 wherever JAX is compared; the
synthetic dataset (1024 train / 256 val canvases, 100 classes) in batches
of 128 (256 where JAX is not compared).

* The JAX ``Runner`` and the port's on the same VTAB-mode data (``no_aug``,
  canvases resized to 32), the JAX runner's initial parameters carried into
  the port's (router heads x60 so the hard gates have margin, adapters
  live): ``evaluate()`` equal in acc1/acc5/metric/keep_ratio and gflops
  within 1e-6, in mask mode and with the dispatch; one epoch of training
  gives the same per-step loss parts (rtol 1e-3, atol 2e-5, the train
  test's) and end weights (rtol 2e-3, atol 5e-5).  The routers' noise is
  the same numpy arrays on both sides: ``jax.random.logistic`` and the
  port's ``models.layers.logistic_noise`` are patched to return them, one
  array per routed block in call order (the JAX step is jitted once, so it
  reads them at trace time; the port reads them every step).
* ``from_flax_train_state``: the JAX engine takes 3 steps, its state crosses
  to the port, both take 3 more (same data and noise): loss parts and final
  trainable parameters as above, with and without ``accum_iter`` 2.
* Resume: two epochs, then a run resumed from the epoch-0 checkpoint with
  the same flags; the resumed end state (weights, optimizer, step) equals
  the uninterrupted one bit for bit, with augmentation and dropout on and
  with them off.
* Train -> eval -> train in bf16 (the serving weight copies are made
  under inference mode between epochs): the second eval equals an eval of
  a fresh model loaded from ``final_checkpoint.msgpack``.
* Checkpoints: save/load bit-exact, ``auto_remove``, ``final_checkpoint.pth``
  into the JAX model through ``load_torch_state_dict`` + ``import_pretrained``
  (eval logits within 1e-5), ``--finetune`` (only the head re-drawn, std
  0.01; the missing keys are what trains), the optimizer's state round
  trip; the entry points on the CPU and the refusals at the slice's edges.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_tuning_tpu import config as jc
from dynamic_tuning_tpu.models.vit import VisionTransformer as JaxViT
from dynamic_tuning_tpu.parallel import mesh as M
from dynamic_tuning_tpu.train import checkpoint as jckpt
from dynamic_tuning_tpu.train import optim as joptim
from dynamic_tuning_tpu.train.engine import (create_train_state,
                                             make_eval_step, make_train_step,
                                             model_apply_fn)
from dynamic_tuning_tpu.train.runner import Runner as JaxRunner
from dynamic_tuning_tpu_torch import config as tc
from dynamic_tuning_tpu_torch import main_image, main_vtab
from dynamic_tuning_tpu_torch.checkpoint import (from_flax_params,
                                                 from_flax_train_state,
                                                 load_timm_state_dict,
                                                 load_torch_state_dict)
from dynamic_tuning_tpu_torch.cli import args_to_config
from dynamic_tuning_tpu_torch.models import layers as tlayers
from dynamic_tuning_tpu_torch.models.vit import VisionTransformer
from dynamic_tuning_tpu_torch.train import checkpoint as C
from dynamic_tuning_tpu_torch.train import engine, optim
from dynamic_tuning_tpu_torch.train.runner import Runner

DIM, HEADS, DEPTH, FFN = 128, 2, 2, 8
IMG, PATCH = 32, 8
T = (IMG // PATCH) ** 2
TINY = dict(img_size=IMG, patch_size=PATCH, embed_dim=DIM, depth=DEPTH,
            num_heads=HEADS, num_classes=100)
PART_TOL = dict(rel=1e-3, abs=2e-5)          # tests/test_torch_port_train.py
PARAM_TOL = dict(rtol=2e-3, atol=5e-5)


def port_cfg(cfg):
    """The port's own config object with the fields of a JAX-package one
    (the fields the port has; the JAX RunConfig's mesh has no counterpart)."""
    cls = getattr(tc, type(cfg).__name__)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{f.name: (port_cfg(getattr(cfg, f.name))
                           if dataclasses.is_dataclass(getattr(cfg, f.name))
                           else getattr(cfg, f.name))
                  for f in dataclasses.fields(cfg) if f.name in names})


def run_cfg(out, *, no_aug=True, dropout=0.0, batch=128, epochs=2,
            dtype="float32", **kw):
    """The toy run of the port's tests (the JAX package's RunConfig, whose
    port_cfg is the port's)."""
    return jc.RunConfig(
        model=jc.ModelConfig(**TINY, drop_path_rate=dropout),
        tuning=jc.TuningConfig(ffn_num=FFN, d_model=DIM, dropout=dropout),
        optim=jc.OptimConfig(lr=1e-3, warmup_epochs=1, epochs=epochs),
        data=jc.DataConfig(dataset="synthetic", batch_size=batch,
                           num_workers=2, no_aug=no_aug),
        output_dir=str(out), compute_dtype=dtype, **kw)


def _live_params(trainable, rs):
    """Router heads x60 (hard gates with margin) and a live adapter."""
    out = dict(trainable)
    for i in range(DEPTH):
        k = (f"blocks_{i}", "mlp_token_select", "mlp_head", "kernel")
        out[k] = jnp.asarray(np.asarray(out[k]) * 60.0)
        k = (f"blocks_{i}", "adaptmlp", "up_proj", "kernel")
        out[k] = jnp.asarray(rs.randn(*out[k].shape).astype(np.float32)
                             * 0.05)
    return out


def _patch_noise(mp, arrays):
    """Both packages' router noise returns ``arrays`` in turn (cycling)."""
    jcalls, tcalls = [0], [0]

    def jax_logistic(key, shape=(), dtype=jnp.float32):
        a = arrays[jcalls[0] % len(arrays)]
        jcalls[0] += 1
        assert a.shape == tuple(shape), (a.shape, shape)
        return jnp.asarray(a, dtype)

    def port_logistic(shape, generator, *, dtype=torch.float32, device=None):
        a = arrays[tcalls[0] % len(arrays)]
        tcalls[0] += 1
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.from_numpy(a).to(dtype=dtype, device=device)

    mp.setattr(jax.random, "logistic", jax_logistic)
    mp.setattr(tlayers, "logistic_noise", port_logistic)
    return jcalls, tcalls


def _record(runner, jax_side):
    """Wrap the runner's train step: its loss parts as host floats, per
    step."""
    parts, step = [], runner.train_step

    def recorded(state, x, y):
        out = step(state, x, y)
        p = out[1] if jax_side else out
        parts.append({k: float(v) for k, v in p.items()})
        return out

    runner.train_step = recorded
    return parts


def _check_parts(jax_parts, port_parts):
    assert len(jax_parts) == len(port_parts) > 0
    for i, (jp, tp) in enumerate(zip(jax_parts, port_parts)):
        assert set(jp) == set(tp)
        assert jp["keep_ratio"] == pytest.approx(tp["keep_ratio"], abs=1e-6)
        for k in jp:
            assert jp[k] == pytest.approx(tp[k], **PART_TOL), (i, k)


def _check_params(model, jax_trainable):
    own = dict(model.named_parameters())
    want = from_flax_params(joptim.merge_params(
        jax.tree_util.tree_map(np.asarray, jax_trainable), {}))
    for name, w in want.items():
        np.testing.assert_allclose(own[name].detach().numpy(), w,
                                   err_msg=name, **PARAM_TOL)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Toy-size ops gain nothing from many intra-op threads, and beside
    other test processes those threads wait on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


# --- the port's runner against the JAX runner --------------------------------

@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    jcfg = run_cfg(tmp_path_factory.mktemp("jax"))
    jr = JaxRunner(jcfg)
    rs = np.random.RandomState(0)
    jr.state = M.shard_state(jr.mesh, jr.state._replace(
        trainable=_live_params(jr.state.trainable, rs)))
    params = jax.tree_util.tree_map(
        np.asarray, joptim.merge_params(jr.state.trainable, jr.state.frozen))
    pr = Runner(port_cfg(jcfg).replace(
        output_dir=str(tmp_path_factory.mktemp("port"))), "cpu")
    pr.model.load_state_dict({k: torch.from_numpy(v) for k, v in
                              from_flax_params(params).items()}, strict=True)
    out = {"mask": (jr.evaluate(), pr.evaluate())}
    jmask, pmask = jr.eval_step, pr.eval_step
    jr.eval_step = jax.jit(make_eval_step(jr.apply_fn, dispatch=True))
    pr.eval_step = engine.make_eval_step(pr.model, dispatch=True)
    out["dispatch"] = (jr.evaluate(), pr.evaluate())
    jr.eval_step, pr.eval_step = jmask, pmask

    noise = [rs.logistic(size=(jcfg.data.batch_size, T, 1)).astype(
        np.float32) for _ in range(DEPTH)]
    with pytest.MonkeyPatch.context() as mp:
        _patch_noise(mp, noise)
        jparts, pparts = _record(jr, True), _record(pr, False)
        jr.train_one_epoch(0)
        pr.train_one_epoch(0)
    out["after"] = (jr.evaluate(), pr.evaluate())
    return dict(out, jparts=jparts, pparts=pparts, jr=jr, pr=pr)


def _same_stats(js, ps):
    for k in ("acc1", "acc5", "metric", "keep_ratio"):
        assert js[k] == ps[k], (k, js[k], ps[k])
    assert ps["gflops"] == pytest.approx(js["gflops"], rel=1e-6)
    assert ps["flops_ratio_vs_dense"] == pytest.approx(
        js["flops_ratio_vs_dense"], rel=1e-6)


@pytest.mark.parametrize("mode", ["mask", "dispatch", "after"])
def test_runner_evaluate_matches_jax(parity, mode):
    _same_stats(*parity[mode])


def test_runner_epoch_loss_parts_match_jax(parity):
    assert len(parity["pparts"]) == parity["pr"].steps_per_epoch == 8
    _check_parts(parity["jparts"], parity["pparts"])


def test_runner_epoch_end_weights_match_jax(parity):
    assert parity["pr"].state.step == int(parity["jr"].state.step) == 8
    assert parity["pr"].state.optimizer.count == 8
    _check_params(parity["pr"].model, parity["jr"].state.trainable)


def test_runner_schedule_matches_jax(parity):
    """lr per raw step, and the schedule offset of --start_epoch with
    accum_iter (the JAX runner's lr_at)."""
    jr, pr = parity["jr"], parity["pr"]
    for s in (0, 5, 16, 31):
        # JAX evaluates the schedule in float32, the port in float64
        assert pr.lr_at(s) == pytest.approx(float(jr.lr_at(s)), rel=1e-5)
    cfg = port_cfg(run_cfg("")).replace(start_epoch=1, accum_iter=2)
    r = Runner(cfg, "cpu")
    base = optim.warmup_cosine_schedule(1e-3, 0.0, 2, 1, 4)
    assert r.lr_at(0) == base(4) and r.lr_at(3) == base(5)
    assert r.state.optimizer.rule.lr(0) == base(4)


# --- a JAX run continued in the port -----------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_from_flax_train_state_continues_a_jax_run(monkeypatch, accum):
    mc = jc.ModelConfig(**TINY)
    tuning = jc.TuningConfig(ffn_num=FFN, d_model=DIM, dropout=0.0)
    sel = jc.SelectConfig()
    model = JaxViT(mc, tuning=tuning, select=sel, dtype=jnp.float32)
    rs = np.random.RandomState(4)
    B = 8
    data = [(rs.randn(B, IMG, IMG, 3).astype(np.float32),
             rs.randint(0, 100, (B,)).astype(np.int64)) for _ in range(6)]
    params = model.init(jax.random.PRNGKey(2), jnp.asarray(data[0][0]))[
        "params"]
    trainable, frozen = joptim.partition_params(params)
    trainable = _live_params(trainable, rs)
    noise = [rs.logistic(size=(B, T, 1)).astype(np.float32)
             for _ in range(DEPTH)]
    _patch_noise(monkeypatch, noise)
    sched = dict(epochs=2, warmup_epochs=1.0, steps_per_epoch=2,
                 weight_decay=0.01)
    tx = joptim.with_grad_accumulation(joptim.make_optimizer(5e-3, **sched),
                                       accum)
    state = create_train_state(trainable, frozen, tx, jax.random.PRNGKey(7))
    step = jax.jit(make_train_step(model_apply_fn(model), tx, sel))
    for x, y in data[:3]:
        state, _ = step(state, jnp.asarray(x), jnp.asarray(y))
    host = jax.tree_util.tree_map(np.asarray, state)
    bridged = from_flax_train_state(host.trainable, host.frozen,
                                    host.opt_state, host.step)
    assert bridged["step"] == 3
    assert bridged["optimizer"]["mini_step"] == (3 % accum if accum > 1
                                                 else 0)

    tm = VisionTransformer(port_cfg(mc), tuning=port_cfg(tuning),
                           select=port_cfg(sel), dtype=torch.float32)
    tm.load_state_dict({k: torch.from_numpy(v)
                        for k, v in bridged["model"].items()}, strict=True)
    opt = optim.make_optimizer(optim.freeze(tm), 5e-3, accum_iter=accum,
                               **sched)
    opt.load_state_dict(bridged["optimizer"])
    tstate = engine.TrainState(opt, seed=5, step=bridged["step"])
    tstep = engine.make_train_step(tm, port_cfg(sel))
    jparts, pparts = [], []
    for x, y in data[3:]:
        state, p = step(state, jnp.asarray(x), jnp.asarray(y))
        jparts.append({k: float(v) for k, v in p.items()})
        p = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y))
        pparts.append({k: float(v) for k, v in p.items()})
    _check_parts(jparts, pparts)
    _check_params(tm, state.trainable)
    host = jax.tree_util.tree_map(np.asarray, state)
    end = from_flax_train_state(host.trainable, host.frozen, host.opt_state,
                                host.step)["optimizer"]
    assert (opt.count, opt.mini_step) == (end["rule"]["count"],
                                          end["mini_step"])


# --- resume, train -> eval -> train -----------------------------------------

def _recorded_evals(runner):
    """Wrap the runner's evaluate and eval step: each eval's stats and its
    logits, per eval."""
    evals, evaluate, eval_step = [], runner.evaluate, runner.eval_step

    def step(x):
        logits, ts = eval_step(x)
        evals[-1]["logits"].append(logits.clone())
        return logits, ts

    def wrapped():
        evals.append({"logits": []})
        evals[-1]["stats"] = evaluate()
        return evals[-1]["stats"]

    runner.eval_step, runner.evaluate = step, wrapped
    return evals


@pytest.mark.parametrize("aug", [False, True])
def test_resume_is_bit_identical(tmp_path, aug):
    """Two epochs, then a run resumed from the epoch-0 checkpoint with the
    same flags: the same end state, bit for bit (augmentation, dropout,
    stochastic depth and the routers' noise all drawn)."""
    cfg = port_cfg(run_cfg(tmp_path / "a", no_aug=not aug, dropout=0.1,
                           batch=256)).replace(auto_remove=False)
    a = Runner(cfg, "cpu")
    a_evals = _recorded_evals(a)
    a.run()
    ckpt = tmp_path / "a" / "checkpoint-0.msgpack"
    assert ckpt.exists()
    c = Runner(cfg.replace(resume=str(ckpt), output_dir=str(tmp_path / "c")),
               "cpu")
    assert c.start_epoch == 1 and c.state.step == 4
    assert c.max_metric == a_evals[0]["stats"]["metric"]
    c.run()
    fa = C.load_params(str(tmp_path / "a" / "final_checkpoint.msgpack"))
    fc = C.load_params(str(tmp_path / "c" / "final_checkpoint.msgpack"))
    assert fa.keys() == fc.keys()
    for k in fa:
        assert torch.equal(fa[k], fc[k]), k
    sa, sc = a.state.optimizer.state_dict(), c.state.optimizer.state_dict()
    assert sa["rule"]["count"] == sc["rule"]["count"] == 8
    for part in ("mu", "nu"):
        for k in sa["rule"][part]:
            assert torch.equal(sa["rule"][part][k], sc["rule"][part][k]), k
    assert (a.state.step, a.state.seed) == (c.state.step, c.state.seed)
    # without the resume the epoch-1 run is another run
    b = Runner(cfg.replace(output_dir=str(tmp_path / "b"), start_epoch=1),
               "cpu")
    b.run()
    fb = C.load_params(str(tmp_path / "b" / "final_checkpoint.msgpack"))
    assert any(not torch.equal(fa[k], fb[k]) for k in fa)


def test_train_eval_train_equals_a_fresh_model(tmp_path):
    """bf16: the eval between epochs makes the serving weight copies under
    inference mode; the next epoch trains, and the eval after it equals
    an eval of a fresh model loaded from final_checkpoint.msgpack."""
    cfg = port_cfg(run_cfg(tmp_path / "a", batch=256, dtype="bfloat16"))
    a = Runner(cfg, "cpu")
    evals = _recorded_evals(a)
    a.run()
    assert len(evals) == 2
    assert not torch.equal(evals[0]["logits"][0], evals[1]["logits"][0])
    fresh = Runner(cfg.replace(output_dir=str(tmp_path / "f")), "cpu")
    load_timm_state_dict(fresh.model, C.load_params(
        str(tmp_path / "a" / "final_checkpoint.msgpack")))
    again = _recorded_evals(fresh)
    fresh.evaluate()
    assert again[0]["stats"] == evals[1]["stats"]
    for got, want in zip(again[0]["logits"], evals[1]["logits"]):
        assert torch.equal(got, want)


# --- checkpoints -------------------------------------------------------------

def _toy_run(tmp_path, **kw):
    return Runner(port_cfg(run_cfg(tmp_path, batch=256)).replace(**kw),
                  "cpu")


def test_checkpoint_save_load_is_bit_exact(tmp_path):
    r = _toy_run(tmp_path / "r", accum_iter=2)
    r.train_one_epoch(0)
    r.train_step(r.state, *r._device_batch(
        *next(iter(r.train_loader)), train=True, step=r.state.step))
    assert r.state.optimizer.mini_step == 1
    path = C.save_checkpoint(str(tmp_path), r.model, r.state, 0,
                             extra={"metric": 1.5})
    s = _toy_run(tmp_path / "s", accum_iter=2)
    epoch, extra = C.load_checkpoint(path, s.model, s.state)
    assert (epoch, extra) == (0, {"metric": 1.5})
    assert (s.state.step, s.state.seed) == (r.state.step, r.state.seed)
    for (n, p), (m, q) in zip(r.model.named_parameters(),
                              s.model.named_parameters()):
        if p.requires_grad:
            assert n == m and torch.equal(p, q), n
    want, got = r.state.optimizer.state_dict(), s.state.optimizer.state_dict()
    assert got["mini_step"] == want["mini_step"] == 1
    assert got["rule"]["count"] == want["rule"]["count"] == 2
    for part in ("mu", "nu"):
        for k, v in want["rule"][part].items():
            assert torch.equal(got["rule"][part][k], v)
    for k, v in want["acc"].items():
        assert torch.equal(got["acc"][k], v)


def test_auto_remove_prunes_older_checkpoints(tmp_path):
    r = _toy_run(tmp_path / "r")
    for epoch in range(3):
        C.save_checkpoint(str(tmp_path), r.model, r.state, epoch,
                          auto_remove=epoch != 1)
    C.save_checkpoint(str(tmp_path), r.model, r.state, 3, tag="best",
                      auto_remove=True)
    names = sorted(p.name for p in tmp_path.iterdir() if p.is_file())
    assert names == ["best.msgpack", "checkpoint-2.msgpack"]
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())


def test_final_checkpoint_loads_into_the_jax_model(tmp_path):
    mc = jc.ModelConfig(**TINY)
    tuning = jc.TuningConfig(ffn_num=FFN, d_model=DIM)
    tm = VisionTransformer(port_cfg(mc), tuning=port_cfg(tuning),
                           dtype=torch.float32,
                           generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for blk in tm.blocks:
            blk.mlp_token_select.mlp_head.weight.mul_(60.0)
            blk.adaptmlp.up_proj.weight.normal_(0, 0.05)
    path = str(tmp_path / "final_checkpoint.pth")
    C.save_params(path, tm)
    jm = JaxViT(mc, tuning=tuning, dtype=jnp.float32)
    x = np.random.RandomState(1).randn(4, IMG, IMG, 3).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params, missing = jckpt.import_pretrained(
        params, jckpt.load_torch_state_dict(path), logger=None)
    assert missing == []
    want, jaux = jm.apply({"params": params}, jnp.asarray(x),
                          training=False)
    got, aux = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(aux["token_select"].numpy(),
                                  np.asarray(jaux["token_select"]))


def _toy_state_dict(tmp_path, *, backbone_only):
    """A .pth of a toy model: whole, or (as an IN21K checkpoint) without
    adapters and routers and with a head of another width."""
    src = VisionTransformer(tc.ModelConfig(**TINY),
                            tuning=tc.TuningConfig(ffn_num=FFN, d_model=DIM),
                            dtype=torch.float32,
                            generator=torch.Generator().manual_seed(9))
    sd = {k: v.clone() for k, v in src.state_dict().items()}
    if backbone_only:
        sd = {k: v for k, v in sd.items()
              if "adaptmlp" not in k and "mlp_token_select" not in k}
        sd["head.weight"] = torch.zeros(21843, DIM)
        sd["head.bias"] = torch.zeros(21843)
    path = str(tmp_path / "pretrained.pth")
    torch.save({"model": sd}, path)
    return sd, path


@pytest.mark.parametrize("backbone_only", [False, True])
def test_finetune_redraws_only_the_head(tmp_path, backbone_only):
    sd, path = _toy_state_dict(tmp_path, backbone_only=backbone_only)
    r = _toy_run(tmp_path / "r", finetune=path)
    own = r.model.state_dict()
    for k, v in sd.items():
        if not k.startswith("head."):
            assert torch.equal(own[k], v), k
    w = own["head.weight"]
    assert torch.equal(own["head.bias"], torch.zeros(100))
    assert w.abs().max() <= 0.02 and 0.006 < w.std() < 0.01
    assert not torch.equal(w, sd["head.weight"][:100])
    trainable = set(r.state.optimizer.names)
    if backbone_only:
        # the keys an IN21K checkpoint lacks (and the resized head) train
        assert trainable == set(own) - (set(sd) - {"head.weight",
                                                   "head.bias"})
    assert trainable == {k for k in own if "adaptmlp" in k
                         or "mlp_token_select" in k or k.startswith("head.")}


def test_fulltune_trains_everything(tmp_path):
    r = _toy_run(tmp_path / "r", fulltune=True)
    assert len(r.state.optimizer.names) == len(list(r.model.parameters()))


@pytest.mark.parametrize("kind", ["adamw", "accum", "lars"])
def test_optimizer_state_round_trip(tmp_path, kind):
    """state_dict -> torch.save -> load_state_dict into a second optimizer on
    a copy of the parameters; the next updates are bit-identical."""
    def build(seed_model):
        model = VisionTransformer(tc.ModelConfig(**TINY),
                                  tuning=tc.TuningConfig(ffn_num=FFN),
                                  dtype=torch.float32,
                                  generator=torch.Generator().manual_seed(1))
        if seed_model is not None:
            model.load_state_dict(seed_model.state_dict())
        named = optim.freeze(model)
        if kind == "lars":
            opt = optim.Optimizer(named, optim.Lars(
                [p for _, p in named], 0.1, weight_decay=0.01))
        else:
            opt = optim.make_optimizer(named, 1e-2, warmup_epochs=0,
                                       accum_iter=2 if kind == "accum" else 1)
        return model, opt

    rs = np.random.RandomState(0)
    m1, o1 = build(None)
    grads = [[torch.from_numpy(rs.randn(*p.shape).astype(np.float32))
              for p in o1.params] for _ in range(6)]
    for g in grads[:3]:
        o1.step(g)
    torch.save(o1.state_dict(), tmp_path / "opt.pth")
    m2, o2 = build(m1)
    o2.load_state_dict(torch.load(tmp_path / "opt.pth"))
    assert (o2.count, o2.mini_step) == (o1.count, o1.mini_step)
    for g in grads[3:]:
        o1.step(g)
        o2.step([t.clone() for t in g])
    for p, q in zip(o1.params, o2.params):
        assert torch.equal(p, q)
    with pytest.raises(KeyError):
        o2.load_state_dict({**o1.state_dict(), "rule": {
            k: ({} if isinstance(v, dict) else v)
            for k, v in o1.state_dict()["rule"].items()}})


# --- entry points and refusals -----------------------------------------------

def _shrink(monkeypatch, module):
    """The entry point's config at the toy size (the program has no size
    flag; the test patches what it builds)."""
    real = module.args_to_config

    def toy(args, **kw):
        cfg = real(args, **kw)
        return cfg.replace(
            model=dataclasses.replace(cfg.model, **{
                k: v for k, v in TINY.items() if k != "num_classes"}),
            tuning=dataclasses.replace(cfg.tuning, d_model=DIM))

    monkeypatch.setattr(module, "args_to_config", toy)


def test_main_image_trains_and_evaluates_on_the_cpu(tmp_path, monkeypatch,
                                                    capsys):
    _shrink(monkeypatch, main_image)
    flags = ["--dataset", "synthetic", "--device", "cpu", "--epochs", "1",
             "--warmup_epochs", "1", "--batch_size", "256",
             "--compute_dtype", "float32", "--output_dir", str(tmp_path)]
    parse = main_image.get_args_parser().parse_args
    out = main_image.main(parse(flags))
    assert out["max_metric"] >= 0.0
    assert (tmp_path / "final_checkpoint.msgpack").exists()
    stats = main_image.main(parse(flags + [
        "--eval", "--eval_ckpt", str(tmp_path / "checkpoint-0.msgpack")]))
    assert stats["metric"] == out["max_metric"]
    assert "Accuracy on the val set" in capsys.readouterr().out


def test_main_vtab_runs_a_task_list_on_the_cpu(tmp_path, monkeypatch,
                                               capsys):
    _shrink(monkeypatch, main_vtab)
    parse = main_vtab.get_args_parser().parse_args
    defaults = parse([])
    assert (defaults.lr, defaults.batch_size, defaults.ffn_num) == (1e-3, 64,
                                                                    16)
    args = parse(["--task", "synthetic,synthetic_b", "--device", "cpu",
                  "--epochs", "1", "--compute_dtype", "float32",
                  "--eval_dispatch", "--batch_size", "256",
                  "--output_dir", str(tmp_path)])
    results = main_vtab.main(args)
    assert set(results) == {"synthetic", "synthetic_b"}
    for task in results:
        assert (tmp_path / task / "final_checkpoint.msgpack").exists()
    printed = capsys.readouterr().out
    assert '"mean_top1"' in printed


def test_entry_points_take_the_card_by_default():
    args = main_image.get_args_parser().parse_args(["--dataset",
                                                    "synthetic"])
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is to use it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main_image.main(args)


def test_refusals_at_the_edges_of_the_slice(tmp_path):
    parse = main_image.get_args_parser().parse_args
    with pytest.raises(ValueError, match="orbax"):
        args_to_config(parse(["--ckpt_backend", "orbax"]))
    with pytest.raises(ValueError, match="model_parallel"):
        args_to_config(parse(["--model_parallel", "2"]))
    # fp32 on the card is refused before anything touches it
    cfg = port_cfg(run_cfg(tmp_path))
    with pytest.raises(ValueError, match="compute_dtype float32"):
        Runner(cfg, torch.device("cuda"))
    # a checkpoint is a .msgpack or a .pth/.pt
    with pytest.raises(NotImplementedError, match="a checkpoint is"):
        Runner(cfg.replace(resume=str(tmp_path / "checkpoint-0.ckpt")),
               "cpu")
    with pytest.raises(NotImplementedError, match="a checkpoint is"):
        main_image.main(parse(["--device", "cpu", "--eval", "--eval_ckpt",
                               str(tmp_path / "final.ckpt")]))
    with pytest.raises(NotImplementedError, match="a checkpoint is"):
        Runner(cfg.replace(finetune=str(tmp_path / "x.ckpt")), "cpu")
