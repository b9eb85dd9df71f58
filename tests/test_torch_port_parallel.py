"""The port's data-parallel training (``parallel/``) against one process and
against the JAX package, on the CPU: two gloo processes launched with
torchrun's variables, as tests/test_multihost.py launches JAX's.

* ``discover`` and ``_first_slurm_node`` against the JAX functions on the
  JAX tests' own cases, one case each; ``LOCAL_RANK``; ``make_mesh``;
  the evaluation padding; ``rank_rows``.
* One launch of two processes (module fixture) runs every case below at
  world 2; the test process runs the same cases at world 1 and the JAX
  references:
  - the image train step, 2 steps, global batch 8 (4 a rank) with the
    routers' noise given: every loss part and every trainable tensor
    within rtol 1e-5 / atol 1e-6 of one process on the global batch and
    of the JAX engine's steps (fp32, dropout 0, the keep ratio far from
    its target); the gradient a per-rank-averaged budget loss would give
    (``DistributedDataParallel``'s) differs from the global one beyond
    that tolerance, so the check can fail;
  - the same step with every dropout on and no noise given: the draws of
    the global batch, each rank its rows, so world 2 equals world 1;
  - a seg step with BatchNorm heads, global batch 8: loss parts, running
    statistics and parameters against one process and the JAX
    ``SegRunner`` step (rtol 1e-5 / atol 1e-6), the summed gradients
    against one process's within 1e-5 of each tensor's largest; the
    parameters where Adam's first step is settled (the gradient at least
    1e-3 of its tensor's largest, 99% of them: below, lr g / (|g| + eps)
    steps a gradient of rounding size by up to the lr);
  - padded, sharded evaluation on odd-sized sets: the image runner (7
    images in batches of 3, a batch of padding alone on rank 1), the
    video runner's multi-view ids (5 clips of 3 views, merged from the
    ranks' files), the seg runner's confusion matrix (3 images);
  - the image runner trained 2 epochs with augmentation and dropout on,
    then resumed from its epoch-0 checkpoint at world 2: bit-identical;
    its effective batch and ``absolute_lr`` against JAX's at world 2.

Run this file as a script (``python tests/test_torch_port_parallel.py
all DIR``) under torchrun's variables to be one process of the world.
"""

import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamic_tuning_tpu_torch import config as tc
from dynamic_tuning_tpu_torch.parallel import mesh as P
from dynamic_tuning_tpu_torch.parallel import multihost as MH

REPO = Path(__file__).resolve().parents[1]
DIM, HEADS, DEPTH, FFN, CLASSES = 64, 4, 2, 8, 10
IMG, PATCH, B = 32, 8, 8                 # B: the global batch
T = (IMG // PATCH) ** 2
STEPS, SPE, BASE_LR, WD = 2, 2, 5e-3, 0.01
TARGET = 0.1                              # keep ratio ~0.5: far from it
TOL = dict(rtol=1e-5, atol=1e-6)
WORLD = 2
# seg: the sizes of tests/test_torch_port_seg_train.py
S_DIM, S_DEPTH, S_HEADS, S_IMG, S_PATCH, S_HEAD = 128, 4, 2, 64, 16, 64
S_NC, S_T = 150, (64 // 16) ** 2
NO_GRADIENT = ("backbone.fpn1_deconv2.bias", "backbone.fpn2_deconv.bias")


# --- discovery, against the JAX package --------------------------------------

ENV_CASES = [
    {},
    {"RANK": "3", "WORLD_SIZE": "8", "MASTER_ADDR": "10.0.0.1",
     "MASTER_PORT": "1234"},
    {"OMPI_COMM_WORLD_SIZE": "4", "OMPI_COMM_WORLD_RANK": "2",
     "MASTER_ADDR": "h0"},
    {"SLURM_NTASKS": "2", "SLURM_PROCID": "1",
     "SLURM_STEP_NODELIST": "node[07-08],node12"},
    {"SLURM_NTASKS": "1", "SLURM_PROCID": "0"},
    {"COORDINATOR_ADDRESS": "c:9", "NUM_PROCESSES": "2", "PROCESS_ID": "1"},
    {"RANK": "0", "WORLD_SIZE": "2"},
    {"SLURM_NTASKS": "4", "SLURM_PROCID": "3", "MASTER_ADDR": "m",
     "MASTER_PORT": "7"},
]


@pytest.mark.parametrize("env", ENV_CASES,
                         ids=[",".join(sorted(e)) or "empty"
                              for e in ENV_CASES])
def test_discover_matches_jax(env):
    from dynamic_tuning_tpu.parallel.multihost import discover
    assert MH.discover(env) == discover(env)


@pytest.mark.parametrize("nodelist", ["compute-a[003-010]", "host1,host2",
                                      "n[1-4],m2", "solo"])
def test_first_slurm_node_matches_jax(nodelist):
    from dynamic_tuning_tpu.parallel.multihost import _first_slurm_node
    assert MH._first_slurm_node(nodelist) == _first_slurm_node(nodelist)


def test_slurm_without_address_raises_like_jax():
    from dynamic_tuning_tpu.parallel.multihost import discover
    env = {"SLURM_NTASKS": "2", "SLURM_PROCID": "0"}
    with pytest.raises(RuntimeError):
        discover(env)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        MH.discover(env)


def test_local_rank_and_single_process(monkeypatch):
    assert MH.local_rank({"LOCAL_RANK": "3"}) == 3
    assert MH.local_rank({"SLURM_LOCALID": "2"}) == 2
    assert MH.local_rank({}) == 0
    assert (MH.process_index(), MH.process_count()) == (0, 1)
    for v in ("RANK", "WORLD_SIZE", "COORDINATOR_ADDRESS",
              "OMPI_COMM_WORLD_SIZE", "SLURM_NTASKS"):
        monkeypatch.delenv(v, raising=False)
    assert MH.maybe_initialize_distributed("cpu") is False
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert MH.maybe_initialize_distributed("cpu") is False   # world 1
    assert MH.local_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "5")
    if not torch.cuda.is_available():
        assert MH.local_device("cpu") == torch.device("cpu")


def test_make_mesh_refuses_tensor_parallelism():
    assert P.make_mesh(1) == 1                  # the data axis: world 1
    with pytest.raises(ValueError, match="tensor parallelism"):
        P.make_mesh(2)


@pytest.mark.parametrize("n,world,want", [(7, 2, 1), (8, 2, 0), (5, 4, 3),
                                          (3, 1, 0)])
def test_eval_pad_count(n, world, want):
    assert P.eval_pad_count(n, world) == want
    assert (n + want) % world == 0


def test_pad_eval_batch_repeats_the_last_item():
    items = np.arange(6).reshape(3, 2)
    got, labels = P.pad_eval_batch(items, np.array([4, 5, 6], np.uint8), 2)
    np.testing.assert_array_equal(got[3:], [[4, 5], [4, 5]])
    assert labels.dtype == np.int64 and labels.tolist() == [4, 5, 6, -1, -1]
    got, labels = P.pad_eval_batch(items[:0], np.array([], np.int32), 1,
                                   fill=np.array([9, 9]))
    np.testing.assert_array_equal(got, [[9, 9]])
    assert labels.tolist() == [-1]


def test_rank_rows_are_the_loaders_strided_shards():
    from dynamic_tuning_tpu_torch.data.loader import DataLoader

    class Range:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return np.full((1,), i, np.uint8), i

    g = torch.arange(8)
    for r in range(2):
        (_, labels), = list(DataLoader(Range(), 4, process_index=r,
                                       process_count=2))
        assert P.rank_rows(g, r, 2).tolist() == labels.tolist()


def test_loader_sentinel_pad_keeps_every_sample_once():
    from dynamic_tuning_tpu_torch.data.loader import DataLoader

    class Range:
        def __len__(self):
            return 7

        def __getitem__(self, i):
            return np.full((2,), i, np.uint8), i

    seen = []
    for r in range(2):
        batches = list(DataLoader(Range(), 3, process_index=r,
                                  process_count=2, sentinel_pad=True))
        assert len(batches) == 2
        for imgs, labels in batches:
            assert len(imgs) == len(labels)
            seen += labels[labels >= 0].tolist()
            if (labels < 0).any():
                np.testing.assert_array_equal(imgs[labels < 0][0], [6, 6])
    assert sorted(seen) == list(range(7))


def test_absolute_lr_matches_jax_at_world_2():
    from dynamic_tuning_tpu import config as jc
    for lr, blr in ((None, 1e-3), (None, 5e-4), (2e-3, 1e-3)):
        j = jc.OptimConfig(lr=lr, blr=blr)
        t = tc.OptimConfig(lr=lr, blr=blr)
        for batch, accum in ((64, 1), (32, 4)):
            # JAX runner.py:126: batch * accum * process_count
            assert (t.absolute_lr(batch * accum * WORLD)
                    == j.absolute_lr(batch * accum * WORLD))


# --- the cases, one process of the world each --------------------------------

def _vit_cfg(**kw):
    return tc.ModelConfig(img_size=IMG, patch_size=PATCH, embed_dim=DIM,
                          depth=DEPTH, num_heads=HEADS, num_classes=CLASSES,
                          **kw)


DROPS = dict(drop_path_rate=0.1, attn_drop_rate=0.1, proj_drop_rate=0.1,
             pos_drop_rate=0.1, drop_rate=0.1)


def _engine_case(inp: dict, drops: bool) -> dict:
    """STEPS train steps of the port engine on this rank's rows of the
    global batches; with ``drops`` every dropout on and the noise drawn."""
    from dynamic_tuning_tpu_torch.models.vit import VisionTransformer
    from dynamic_tuning_tpu_torch.train import engine, optim
    tm = VisionTransformer(_vit_cfg(**(DROPS if drops else {})),
                           tuning=tc.TuningConfig(
                               ffn_num=FFN, d_model=DIM,
                               dropout=0.1 if drops else 0.0),
                           select=tc.SelectConfig(token_target_ratio=TARGET),
                           dtype=torch.float32)
    tm.load_state_dict(inp["sd"], strict=True)
    named = optim.freeze(tm)
    opt = optim.make_optimizer(named, BASE_LR, epochs=STEPS / SPE,
                               warmup_epochs=1.0, steps_per_epoch=SPE,
                               weight_decay=WD)
    state = engine.TrainState(opt, seed=5)
    step = engine.make_train_step(tm, tc.SelectConfig(
        token_target_ratio=TARGET))
    noise = None if drops else P.rank_rows(inp["noise"])
    parts = [{k: float(v) for k, v in step(
        state, P.rank_rows(x), P.rank_rows(y), gate_noise=noise).items()}
        for x, y in inp["data"]]
    return dict(parts=parts, params={n: p.detach().clone()
                                     for n, p in named})


def _seg_runner(out, **kw):
    from dynamic_tuning_tpu_torch.train import seg_runner as tsr
    cfg = tc.RunConfig(
        model=tc.ModelConfig(img_size=S_IMG, patch_size=S_PATCH,
                             embed_dim=S_DIM, depth=S_DEPTH,
                             num_heads=S_HEADS),
        tuning=tc.TuningConfig(ffn_num=FFN, d_model=S_DIM, dropout=0.0),
        select=tc.SelectConfig(token_target_ratio=0.5),
        optim=tc.OptimConfig(lr=1e-3, weight_decay=0.05),
        data=tc.DataConfig(dataset="synthetic", batch_size=B // 2,
                           num_workers=1),
        output_dir=str(out), compute_dtype="float32")
    return tsr.SegRunner(cfg, crop=S_IMG, norm="bn", head_channels=S_HEAD,
                         device="cpu", log=lambda m: None, **kw)


def _seg_case(inp: dict, out) -> dict:
    """One seg step (BatchNorm heads, the poly schedule without warmup) on
    this rank's rows of the global batch."""
    from dynamic_tuning_tpu_torch.train import seg_runner as tsr
    rule, sched = tsr.seg_trainable_predicate, tsr.poly_schedule
    tsr.seg_trainable_predicate = lambda n: rule(n) and n not in NO_GRADIENT
    tsr.poly_schedule = functools.partial(sched, warmup_iters=0)
    try:
        r = _seg_runner(out, total_iters=4, eval_interval=4)
    finally:
        tsr.seg_trainable_predicate, tsr.poly_schedule = rule, sched
    r.model.load_state_dict(inp["sd"], strict=True)
    r.model.decode_head.dropout = r.model.auxiliary_head.dropout = 0.0
    x, y = inp["data"]
    grads, opt = [], r.state.optimizer
    real = opt.step
    opt.step = lambda g: grads.extend(t.clone() for t in g) or real(g)
    parts = {k: float(v) for k, v in r.train_step(
        P.rank_rows(x), P.rank_rows(y), gate_noise=P.rank_rows(
            inp["noise"])).items()}
    named = dict(r.model.named_parameters())
    bufs = dict(r.model.named_buffers())
    return dict(parts=parts, grads=dict(zip(opt.names, grads)),
                params={n: named[n].detach().clone() for n in opt.names},
                buffers={n: bufs[n].clone() for n in r.buffers})


def _image_runner(out, *, batch=3, aug=False, drops=False, **kw):
    from dynamic_tuning_tpu_torch.train.runner import Runner
    cfg = tc.RunConfig(
        model=tc.ModelConfig(img_size=IMG, patch_size=PATCH, embed_dim=DIM,
                             depth=DEPTH, num_heads=HEADS, num_classes=100,
                             drop_path_rate=0.1 if drops else 0.0),
        tuning=tc.TuningConfig(ffn_num=FFN, d_model=DIM,
                               dropout=0.1 if drops else 0.0),
        optim=tc.OptimConfig(blr=1e-3, warmup_epochs=1, epochs=2),
        data=tc.DataConfig(dataset="synthetic", batch_size=batch,
                           num_workers=1, no_aug=not aug, canvas=40),
        output_dir=str(out), compute_dtype="float32", auto_remove=False,
        **kw)
    return Runner(cfg, "cpu")


def _video_runner(out):
    from dynamic_tuning_tpu_torch.train.video_runner import VideoRunner
    cfg = tc.RunConfig(
        model=tc.ModelConfig(img_size=IMG, patch_size=PATCH, embed_dim=128,
                             depth=DEPTH, num_heads=2, num_classes=400,
                             num_frames=2),
        tuning=tc.TuningConfig(ffn_num=FFN, d_model=128),
        optim=tc.OptimConfig(lr=1e-3, warmup_epochs=1, epochs=1),
        data=tc.DataConfig(dataset="synthetic", batch_size=4, num_workers=1,
                           num_frames=2),
        output_dir=str(out), compute_dtype="float32")
    return VideoRunner(cfg, "cpu")


def _eval_case(out) -> dict:
    """The image runner on 7 images in batches of 3, the video runner's
    views of 5 clips, the seg runner on 3 images."""
    from dynamic_tuning_tpu_torch.utils.multiview import merge_view_outputs
    res = {}
    r = _image_runner(out / "img")
    r.val_loader.ds.n = 7
    logits, labels = [], []
    real = r.eval_step

    def step(xb):
        out_ = real(xb)
        logits.append(out_[0].clone())
        return out_

    r.eval_step = step
    res["image"] = r.evaluate()
    res["image_rows"] = sum(len(v) for v in logits)
    v = _video_runner(out / "vid")
    v.val_loader.ds.n = 5
    views = out / "views"
    res["video"] = v.evaluate(save_views_dir=str(views))
    P.barrier()
    res["video_merged"] = merge_view_outputs(str(views))
    rows = [np.load(views / f) for f in sorted(os.listdir(views))]
    ids = np.concatenate([d["ids"] for d in rows])
    order = np.argsort(ids, kind="stable")
    res["video_views"] = dict(
        ids=ids[order], labels=np.concatenate([d["labels"] for d in rows])[
            order], logits=np.concatenate([d["logits"] for d in rows])[order])
    s = _seg_runner(out / "seg", total_iters=2, eval_interval=2)
    s.val_ds.n = 3
    res["seg"] = s.evaluate()
    return res


def _resume_case(out) -> dict:
    """Two epochs with augmentation and dropout on (8 images a step in all,
    64 train images), then a run resumed from the epoch-0 checkpoint."""
    world = MH.process_count()

    def runner(d, **kw):
        r = _image_runner(d, batch=8 // world, aug=True, drops=True, **kw)
        r.train_loader.ds.n = 64
        r.steps_per_epoch = len(r.train_loader)
        r.val_loader.ds.n = 9
        return r

    a = runner(out / "a")
    a.run()
    c = runner(out / "c", resume=str(out / "a" / "checkpoint-0.pth"))
    c.run()
    pa, pc = dict(a.model.named_parameters()), dict(c.model.named_parameters())
    oa, oc = a.state.optimizer, c.state.optimizer
    sa, sc = oa.state_dict()["rule"], oc.state_dict()["rule"]
    return dict(
        lr=a.lr, steps=a.state.step, count=(oa.count, oc.count),
        params={n: pa[n].detach().clone() for n in oa.names},
        differ=[n for n in oa.names if not torch.equal(pa[n], pc[n])]
        + [f"{part} {n}" for part in ("mu", "nu") for n in oa.names
           if not torch.equal(sa[part][n], sc[part][n])],
        files=sorted(os.listdir(out / "a")))


def run_cases(tmp: Path) -> dict:
    """Every case at this process's world size, from the parent's inputs
    in ``tmp``; outputs under ``tmp/w{world}``."""
    world = MH.process_count()
    out = tmp / f"w{world}"
    out.mkdir(exist_ok=True)
    inp = torch.load(tmp / "inputs.pt", weights_only=False)
    return dict(engine=_engine_case(inp["engine"], drops=False),
                engine_drops=_engine_case(inp["engine"], drops=True),
                seg=_seg_case(inp["seg"], out / "segstep"),
                evals=_eval_case(out),
                resume=_resume_case(out / "resume"))


def _worker(tmp: str) -> None:
    torch.set_num_threads(2)
    assert MH.maybe_initialize_distributed("cpu")
    res = run_cases(Path(tmp))
    torch.save(res, Path(tmp) / f"rank{MH.process_index()}.pt")
    MH.shutdown()


# --- the inputs and the JAX references ---------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp: Path) -> list:
    port = _free_port()
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(WORLD),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(tmp)], cwd=str(REPO), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=900)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"rank {r} exit {p.returncode}:\n{log[-3000:]}"
        for r, (p, log) in enumerate(zip(procs, logs)))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_engine(rs):
    """The JAX engine's STEPS steps on the global batches (jitted once, the
    routers' noise patched in) and the port's state dict of its start."""
    import jax
    import jax.numpy as jnp

    from dynamic_tuning_tpu.config import (ModelConfig, SelectConfig,
                                           TuningConfig)
    from dynamic_tuning_tpu.models.vit import VisionTransformer as JaxViT
    from dynamic_tuning_tpu.train import optim as joptim
    from dynamic_tuning_tpu.train.engine import (create_train_state,
                                                 make_train_step,
                                                 model_apply_fn)
    from dynamic_tuning_tpu_torch.checkpoint import from_flax_params
    mc = ModelConfig(img_size=IMG, patch_size=PATCH, embed_dim=DIM,
                     depth=DEPTH, num_heads=HEADS, num_classes=CLASSES)
    sel = SelectConfig(token_target_ratio=TARGET)
    model = JaxViT(mc, tuning=TuningConfig(ffn_num=FFN, d_model=DIM,
                                           dropout=0.0),
                   select=sel, dtype=jnp.float32)
    x0 = rs.randn(B, IMG, IMG, 3).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(1), jnp.asarray(x0))["params"])
    for i in range(DEPTH):
        blk = params[f"blocks_{i}"]
        blk["mlp_token_select"]["mlp_head"]["kernel"] = (
            blk["mlp_token_select"]["mlp_head"]["kernel"] * 60.0)
        blk["adaptmlp"]["up_proj"]["kernel"] = (
            rs.randn(FFN, DIM).astype(np.float32) * 0.05)
    data = [(rs.randn(B, IMG, IMG, 3).astype(np.float32),
             rs.randint(0, CLASSES, (B,)).astype(np.int64))
            for _ in range(STEPS)]
    # rank 0's rows (the even ones) keep more tokens than rank 1's: the
    # ranks' keep ratios differ, so a per-rank budget loss would show
    noise = rs.logistic(size=(B, DEPTH, T, 1)).astype(np.float32)
    noise[0::2] += 2.0
    noise[1::2] -= 2.0
    blocks = [noise[:, i] for i in range(DEPTH)]
    calls = [0]

    def logistic(key, shape=(), dtype=jnp.float32):
        a = blocks[calls[0] % DEPTH]
        calls[0] += 1
        assert a.shape == tuple(shape), (a.shape, shape)
        return jnp.asarray(a, dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "logistic", logistic)
        trainable, frozen = joptim.partition_params(params)
        tx = joptim.make_optimizer(BASE_LR, epochs=STEPS / SPE,
                                   warmup_epochs=1.0, steps_per_epoch=SPE,
                                   weight_decay=WD)
        state = create_train_state(trainable, frozen, tx,
                                   jax.random.PRNGKey(7))
        step = jax.jit(make_train_step(model_apply_fn(model), tx, sel))
        parts = []
        for x, y in data:
            state, p = step(state, jnp.asarray(x), jnp.asarray(y))
            parts.append({k: float(v) for k, v in p.items()})
    want = from_flax_params(joptim.merge_params(state.trainable, {}))
    sd = {k: _t(v) for k, v in from_flax_params(params).items()}
    return (dict(sd=sd, data=[(_t(x), _t(y)) for x, y in data],
                 noise=_t(noise)),
            dict(parts=parts, params={k: np.asarray(v)
                                      for k, v in want.items()}))


def _jax_seg_step(rs, tmp):
    """One step of the JAX SegRunner (BatchNorm heads, no warmup, dropout
    the identity, the routers' noise patched in) on the global batch, and
    the port's state dict of its start."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    from flax import traverse_util

    from dynamic_tuning_tpu import config as jc
    from dynamic_tuning_tpu.train import optim as joptim
    from dynamic_tuning_tpu.train import seg_runner as jsr
    from dynamic_tuning_tpu.train.engine import create_train_state
    from dynamic_tuning_tpu_torch.checkpoint import (flax_path_to_port,
                                                     from_flax_params)
    mcfg = jc.ModelConfig(img_size=S_IMG, patch_size=S_PATCH,
                          embed_dim=S_DIM, depth=S_DEPTH, num_heads=S_HEADS)
    tuning = jc.TuningConfig(ffn_num=FFN, d_model=S_DIM, dropout=0.0)
    select = jc.SelectConfig(token_target_ratio=0.5)
    x = rs.randn(B, S_IMG, S_IMG, 3).astype(np.float32)
    y = rs.randint(0, S_NC, (B, S_IMG, S_IMG)).astype(np.int32)
    y[:, :5] = 255
    noise = rs.logistic(size=(B, S_DEPTH, S_T, 1)).astype(np.float32)
    blocks = [noise[:, i] for i in range(S_DEPTH)]
    calls = [0]

    def logistic(key, shape=(), dtype=jnp.float32):
        a = blocks[calls[0] % S_DEPTH]
        calls[0] += 1
        assert a.shape == tuple(shape), (a.shape, shape)
        return jnp.asarray(a, dtype)

    class NoDropout:
        def __init__(self, rate, *a, **kw):
            pass

        def __call__(self, x, *a, **kw):
            return x

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "logistic", logistic)
        mp.setattr(fnn, "Dropout", NoDropout)
        mp.setattr(jsr, "poly_schedule", functools.partial(
            jsr.poly_schedule, warmup_iters=0))
        rule = jsr.seg_trainable_predicate
        mp.setattr(jsr, "seg_trainable_predicate", lambda path: rule(path)
                   and flax_path_to_port(path) not in NO_GRADIENT)
        mp.setenv("DYT_FUSED_ATTN", "0")
        jcfg = jc.RunConfig(
            model=mcfg, tuning=tuning, select=select,
            optim=jc.OptimConfig(lr=1e-3, weight_decay=0.05),
            data=jc.DataConfig(dataset="synthetic", batch_size=B,
                               num_workers=1),
            output_dir=str(tmp / "jseg"), compute_dtype="float32")
        jr = jsr.SegRunner(jcfg, total_iters=4, eval_interval=4, crop=S_IMG,
                           norm="bn", head_channels=S_HEAD)
        flat = {**jr.state.trainable, **jr.state.frozen}
        live = {}
        for k, a in flat.items():
            a = np.asarray(a)
            if "relative_position_bias_table" in k:
                a = a + rs.randn(*a.shape).astype(np.float32)
            elif "up_proj" in k:
                a = a + rs.randn(*a.shape).astype(np.float32) * 0.05
            elif "mlp_token_select" in k and k[-1] == "kernel":
                a = a * 50.0
            live[k] = a
        params = traverse_util.unflatten_dict(live)
        trainable, frozen = joptim.partition_params(
            params, jsr.seg_trainable_predicate)
        jr.state = create_train_state(trainable, frozen, jr.tx, jr.state.rng)
        stats = jax.tree_util.tree_map(np.asarray, jr.batch_stats)
        sd = {k: _t(v) for k, v in from_flax_params(params, stats).items()}
        jr.state, jr.batch_stats, p = jr.train_step(
            jr.state, jr.batch_stats, jnp.asarray(x), jnp.asarray(y))
        parts = {k: float(v) for k, v in p.items()}
    want = from_flax_params(joptim.merge_params(jr.state.trainable, {}),
                            jax.tree_util.tree_map(np.asarray,
                                                   jr.batch_stats))
    return (dict(sd=sd, data=(_t(x), _t(y).long()), noise=_t(noise)),
            dict(parts=parts, params={k: np.asarray(v)
                                      for k, v in want.items()}))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The inputs, the JAX references, the two processes' results and one
    process's."""
    tmp = tmp_path_factory.mktemp("parallel")
    rs = np.random.RandomState(11)
    engine_in, jax_engine = _jax_engine(rs)
    seg_in, jax_seg = _jax_seg_step(rs, tmp)
    torch.save(dict(engine=engine_in, seg=seg_in), tmp / "inputs.pt")
    ranks = _launch(tmp)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    try:
        one = run_cases(tmp)
    finally:
        torch.set_num_threads(threads)
    return dict(ranks=ranks, one=one, jax_engine=jax_engine,
                jax_seg=jax_seg, inputs=dict(engine=engine_in))


# --- the train step ----------------------------------------------------------

def _close_params(got: dict, want: dict, what: str, tol=TOL):
    assert set(got) <= set(want) or set(want) <= set(got), what
    for n in set(got) & set(want):
        np.testing.assert_allclose(np.asarray(got[n]), np.asarray(want[n]),
                                   err_msg=f"{what}: {n}", **tol)


def _close_parts(got: list, want: list, what: str):
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (what, set(g), set(w))
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=f"{what} step {i}"
                                       f" {k}", **TOL)


@pytest.mark.parametrize("case", ["engine", "engine_drops", "seg"])
def test_ranks_end_identical(worlds, case):
    """Both ranks hold the same parameters and report the same (global)
    loss parts."""
    r0, r1 = (r[case] for r in worlds["ranks"])
    assert r0["parts"] == r1["parts"]
    for n in r0["params"]:
        assert torch.equal(r0["params"][n], r1["params"][n]), n


def test_train_step_world2_matches_world1(worlds):
    got, want = worlds["ranks"][0]["engine"], worlds["one"]["engine"]
    _close_parts(got["parts"], want["parts"], "world 2 vs 1")
    _close_params(got["params"], want["params"], "world 2 vs 1")
    assert set(got["params"]) == set(want["params"])


def test_train_step_world2_matches_jax(worlds):
    got, want = worlds["ranks"][0]["engine"], worlds["jax_engine"]
    _close_parts(got["parts"], want["parts"], "world 2 vs JAX")
    _close_params(got["params"], want["params"], "world 2 vs JAX")
    assert set(got["params"]) == set(want["params"])
    # the ranks keep different shares, far from the target
    keep = got["parts"][0]["keep_ratio"]
    assert abs(keep - TARGET) > 0.2


def test_train_step_with_draws_world2_matches_world1(worlds):
    """Dropout, stochastic depth and the gumbel noise all drawn: each rank
    keeps its rows of the global batch's draws."""
    got, want = (worlds["ranks"][0]["engine_drops"],
                 worlds["one"]["engine_drops"])
    _close_parts(got["parts"], want["parts"], "drops world 2 vs 1")
    _close_params(got["params"], want["params"], "drops world 2 vs 1")
    plain = worlds["one"]["engine"]["params"]
    assert any(not torch.equal(got["params"][n], plain[n]) for n in plain)


def test_per_rank_budget_gradient_would_differ(worlds):
    """The teeth of the checks above: on the same weights and batch, the
    gradient of the budget term averaged over the ranks' own means
    (DistributedDataParallel's) is not the global batch's."""
    from dynamic_tuning_tpu_torch.models.vit import VisionTransformer
    from dynamic_tuning_tpu_torch.train import losses, optim
    inp = worlds["inputs"]["engine"]
    tm = VisionTransformer(_vit_cfg(), tuning=tc.TuningConfig(
        ffn_num=FFN, d_model=DIM, dropout=0.0),
        select=tc.SelectConfig(token_target_ratio=TARGET),
        dtype=torch.float32)
    tm.load_state_dict(inp["sd"], strict=True)
    named = optim.freeze(tm)
    params = [p for _, p in named]
    sel = tc.SelectConfig(token_target_ratio=TARGET)
    x, _ = inp["data"][0]

    def budget_grad(rows):
        _, aux = tm(x[rows], training=True, gate_noise=inp["noise"][rows])
        g = torch.autograd.grad(losses.token_budget_loss(
            aux["token_select"], sel), params, allow_unused=True)
        keep = aux["token_select"].detach().mean()
        return [torch.zeros_like(p) if v is None else v
                for v, p in zip(g, params)], keep

    whole, _ = budget_grad(slice(None))
    halves = [budget_grad(slice(r, None, WORLD)) for r in range(WORLD)]
    assert abs(float(halves[0][1] - halves[1][1])) > 0.2
    ddp = [sum(h[0][i] for h in halves) / WORLD for i in range(len(params))]
    worst = max(float(((a - b).abs() - TOL["atol"]
                       - TOL["rtol"] * b.abs()).max())
                for a, b in zip(ddp, whole))
    assert worst > 0, "a per-rank budget loss would pass the checks"


def _settled(grads: dict, floor=1e-3) -> dict:
    """Per tensor, the elements whose gradient is at least ``floor`` of the
    tensor's largest: where Adam's first step, lr g / (|g| + eps), is not
    the sign of a gradient of rounding size."""
    return {n: g.abs() >= floor * g.abs().max() for n, g in grads.items()}


def test_seg_step_with_batchnorm_world2_matches_world1(worlds):
    """The summed gradients within 1e-5 of each tensor's largest, the loss
    parts, the running statistics and the settled parameters within
    rtol 1e-5 / atol 1e-6."""
    got, want = worlds["ranks"][0]["seg"], worlds["one"]["seg"]
    _close_parts([got["parts"]], [want["parts"]], "seg world 2 vs 1")
    _close_params(got["buffers"], want["buffers"], "seg BN world 2 vs 1")
    assert got["buffers"] and set(got["buffers"]) == set(want["buffers"])
    assert set(got["grads"]) == set(want["grads"]) == set(want["params"])
    for n, g in want["grads"].items():
        err = float((got["grads"][n] - g).abs().max())
        assert err <= 1e-5 * float(g.abs().max()), (n, err)
    keep = _settled(want["grads"])
    assert (sum(int(k.sum()) for k in keep.values())
            > 0.98 * sum(k.numel() for k in keep.values()))
    _close_params({n: p[keep[n]] for n, p in got["params"].items()},
                  {n: p[keep[n]] for n, p in want["params"].items()},
                  "seg world 2 vs 1")


def test_seg_step_with_batchnorm_matches_jax(worlds):
    got, want = worlds["ranks"][0]["seg"], worlds["jax_seg"]
    _close_parts([got["parts"]], [want["parts"]], "seg world 2 vs JAX")
    keep = _settled(got["grads"])
    _close_params({**{n: p[keep[n]] for n, p in got["params"].items()},
                   **got["buffers"]},
                  {**{n: want["params"][n][keep[n].numpy()]
                      for n in got["params"]},
                   **{n: want["params"][n] for n in got["buffers"]}},
                  "seg world 2 vs JAX")


# --- evaluation, resume ------------------------------------------------------

EVAL_KEYS = ("acc1", "acc5", "metric")


def test_image_evaluation_world2_equals_world1(worlds):
    want = worlds["one"]["evals"]
    for r in range(WORLD):
        got = worlds["ranks"][r]["evals"]
        assert {k: got["image"][k] for k in EVAL_KEYS} == \
            {k: want["image"][k] for k in EVAL_KEYS}
        # 7 images: 4 rows a rank, rank 1's fourth the pad (a batch alone)
        assert got["image_rows"] == 4
    assert want["image_rows"] == 7


def test_video_multiview_ids_world2_equal_world1(worlds):
    want = worlds["one"]["evals"]
    for r in range(WORLD):
        got = worlds["ranks"][r]["evals"]
        assert {k: got["video"][k] for k in EVAL_KEYS} == \
            {k: want["video"][k] for k in EVAL_KEYS}
        assert got["video_merged"] == want["video_merged"]
    g, w = worlds["ranks"][0]["evals"]["video_views"], want["video_views"]
    # 5 clips x 3 views; the synthetic clip i has label i
    np.testing.assert_array_equal(w["ids"], np.repeat(np.arange(5), 3))
    np.testing.assert_array_equal(g["ids"], w["ids"])
    np.testing.assert_array_equal(g["labels"], w["ids"])
    np.testing.assert_allclose(g["logits"], w["logits"], **TOL)


def test_seg_confusion_world2_equals_world1(worlds):
    want = worlds["one"]["evals"]["seg"]
    for r in range(WORLD):
        assert worlds["ranks"][r]["evals"]["seg"] == want
    assert want["images"] == 3


def test_world2_resume_is_bit_identical(worlds):
    for r in range(WORLD):
        res = worlds["ranks"][r]["resume"]
        assert res["differ"] == [], res["differ"][:6]
        assert res["count"][0] == res["count"][1] == res["steps"]
    files = worlds["ranks"][0]["resume"]["files"]
    assert "checkpoint-0.pth" in files and "final_checkpoint.pth" in files
    assert "log_rank1.txt" in files and "scalars.tsv" in files


def test_world2_runner_matches_world1(worlds):
    """Two epochs with augmentation, dropout and the routers' noise drawn:
    the draws of the global batch (each rank its rows of the strided
    shards) make world 2 the run of one process on 8 images a step."""
    got, want = worlds["ranks"][0]["resume"], worlds["one"]["resume"]
    assert got["steps"] == want["steps"] == 16
    _close_params(got["params"], want["params"], "runner world 2 vs 1",
                  tol=dict(rtol=1e-4, atol=1e-5))


def test_world2_effective_batch_and_lr_match_jax(worlds):
    from dynamic_tuning_tpu import config as jc
    want = jc.OptimConfig(blr=1e-3).absolute_lr(4 * 1 * WORLD)
    assert worlds["ranks"][0]["resume"]["lr"] == want
    assert worlds["one"]["resume"]["lr"] == jc.OptimConfig(
        blr=1e-3).absolute_lr(8)


if __name__ == "__main__":
    _worker(sys.argv[1])
