"""The port's flax ``.msgpack`` files (``serialization.py``,
``train/checkpoint.py``, ``predict.py``) against the JAX package's, on the
CPU.  Every call into the port's codec runs with ``msgpack`` blocked in
``sys.modules``; a subprocess with ``msgpack``, ``flax``, ``ml_dtypes``
and ``jax`` unimportable decodes and re-encodes the committed fixture.

* Codec: ``packb`` byte for byte against ``flax.serialization.
  msgpack_serialize`` and ``unpackb`` value for value (and dtype) against
  ``msgpack_restore``, over trees of fp32, bf16, fp16, int32, int64, uint8
  and bool arrays, 0-d arrays, numpy scalars, Python ints at every
  encoding boundary, floats, str/bin lengths at theirs, None, nested empty
  dicts, and a chunked array (``MAX_CHUNK_SIZE`` patched small on both
  sides); torch tensors encode as the numpy arrays of the same values.
* ``dynamic_tuning_tpu_torch/fixtures/final_checkpoint.msgpack``, written by
  the JAX package's ``save_params`` (2 blocks, width 128, 2 heads of 64,
  adapter 16, 16x16 images of 4x4 patches, MLP ratio 1; the four backbone
  matrices of each block cast to bf16 to keep it small), made by
  ``PYTHONPATH=. python tests/test_torch_port_msgpack.py``: both readers give the same tree, the
  port's writer gives the file's bytes back, and it loads into the port's
  model with no key left over.
* Cross-resume (toy ViT: 32x32 images of 8x8 patches, width 128 in 2 heads
  of 64, depth 2, adapter 8, fp32, batch 8, both packages' router noise
  patched to the same arrays): the JAX engine takes 2 steps (3 with
  ``accum_iter`` 2, so the file is saved mid-accumulation), writes
  ``save_checkpoint``, the port resumes and takes the next step, which
  agrees with JAX's own uninterrupted step within the trajectory
  tolerances of ``tests/test_torch_port_train.py``; the port takes the
  first steps, writes its checkpoint, and JAX's ``load_checkpoint`` resumes
  it to the same tolerances.  For plain adamw, ``clip_grad``,
  ``layer_decay`` and ``accum_iter=2``.  (The segmentor with its
  BatchNorm sidecar: ``tests/test_torch_port_seg_train.py``.)
* The BatchNorm sidecar: ``save_aux_state``/``load_aux_state`` both ways
  against the JAX package's, and ``auto_remove`` pruning.
* Serving: the port's ``predict`` on the JAX package's
  ``final_checkpoint.msgpack`` equals it on the same weights as the JAX
  package's ``.pth`` export, bit for bit (bf16 and int8).
* Saves: the ``.msgpack`` round trip bit-exact (and a ``.pth`` of earlier
  port runs loads, its seed with it; a ``.msgpack`` leaves the run's own);
  ``blocking=False`` then ``wait_for_async_saves`` leaves the whole file
  and no ``.tmp``.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fs
from flax import traverse_util

from dynamic_tuning_tpu import config as jc
from dynamic_tuning_tpu.models.vit import VisionTransformer as JaxViT
from dynamic_tuning_tpu.train import checkpoint as jckpt
from dynamic_tuning_tpu.train import optim as joptim
from dynamic_tuning_tpu.train.engine import (create_train_state,
                                             make_train_step, model_apply_fn)
from dynamic_tuning_tpu_torch import config as tc
from dynamic_tuning_tpu_torch import predict as port_predict
from dynamic_tuning_tpu_torch import serialization as S
from dynamic_tuning_tpu_torch.checkpoint import (from_flax_params,
                                                 from_flax_train_state,
                                                 load_timm_state_dict)
from dynamic_tuning_tpu_torch.models import layers as tlayers
from dynamic_tuning_tpu_torch.models.vit import VisionTransformer
from dynamic_tuning_tpu_torch.train import checkpoint as C
from dynamic_tuning_tpu_torch.train import engine, optim

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "dynamic_tuning_tpu_torch" / "fixtures" / \
    "final_checkpoint.msgpack"

DIM, HEADS, DEPTH, FFN = 128, 2, 2, 8
IMG, PATCH, B = 32, 8, 8
T = (IMG // PATCH) ** 2
TINY = dict(img_size=IMG, patch_size=PATCH, embed_dim=DIM, depth=DEPTH,
            num_heads=HEADS, num_classes=100)
PART_TOL = dict(rel=1e-3, abs=2e-5)          # tests/test_torch_port_train.py
PARAM_TOL = dict(rtol=2e-3, atol=5e-5)
SCHED = dict(epochs=2, warmup_epochs=1.0, steps_per_epoch=2,
             weight_decay=0.01)


def port_cfg(cfg):
    """The port's config object with the fields of a JAX-package one."""
    cls = getattr(tc, type(cfg).__name__)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{f.name: (port_cfg(getattr(cfg, f.name))
                           if dataclasses.is_dataclass(getattr(cfg, f.name))
                           else getattr(cfg, f.name))
                  for f in dataclasses.fields(cfg) if f.name in names})


@pytest.fixture
def no_msgpack(monkeypatch):
    """The port's side runs with ``msgpack`` unimportable."""
    monkeypatch.setitem(sys.modules, "msgpack", None)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


# --- the codec ----------------------------------------------------------------

def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


_RS = np.random.RandomState(0)
TREES = {
    "float32": {"w": _RS.randn(3, 4).astype(np.float32)},
    "bfloat16": {"w": _bf16(_RS.randn(5, 3)), "b": _bf16(_RS.randn(7))},
    "float16": {"w": _RS.randn(2, 2, 3).astype(np.float16)},
    "int32": {"i": np.arange(-5, 300, dtype=np.int32)},
    "int64": {"i": _RS.randint(-2 ** 40, 2 ** 40, (4,)).astype(np.int64)},
    "uint8": {"u": _RS.randint(0, 256, (6, 2)).astype(np.uint8)},
    "bool": {"m": _RS.rand(9) > 0.5},
    "zero_d": {"a": np.array(3.5, np.float32), "b": np.array(7, np.int32),
               "c": np.zeros((0, 3), np.float32)},
    "np_scalars": {"f": np.float32(2.5), "d": np.float64(-1.25),
                   "i": np.int64(-7), "u": np.uint8(200), "b": np.bool_(True),
                   "h": _bf16(1.5)[()]},
    "python": {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                        2 ** 32, 2 ** 63, 2 ** 64 - 1, -1, -32, -33, -128,
                        -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
                        -2 ** 63],
               "floats": [0.0, 1.25, -3e300, float("inf")],
               "str": ["", "x" * 31, "y" * 32, "z" * 255, "w" * 256,
                       "v" * 70000, "été"],
               "bin": [b"", b"a" * 255, b"b" * 256, b"c" * 70000],
               "none": None, "true": True, "false": False, "c": 1 + 2j},
    "nested": {"b": {}, "a": {"d": {}, "c": {"x": np.ones(2, np.float32)}},
               "many": {str(i): i for i in range(20)},
               "long": list(range(20))},
}


def _same(got, want):
    """Equal trees: the same keys, values and dtypes (bf16 by its bits)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, (np.ndarray, np.generic)):
        if want.dtype == jnp.bfloat16:
            assert isinstance(got, torch.Tensor)
            assert got.dtype == torch.bfloat16
            assert tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
            return
        assert type(got) is type(want) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("name", sorted(TREES))
def test_codec_matches_flax(no_msgpack, name):
    tree = TREES[name]
    flax_bytes = fs.msgpack_serialize(tree)
    assert S.packb(tree) == flax_bytes
    _same(S.unpackb(flax_bytes), fs.msgpack_restore(flax_bytes))


def test_codec_chunks_as_flax(no_msgpack, monkeypatch):
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 48)
    monkeypatch.setattr(S, "MAX_CHUNK_SIZE", 48)
    tree = {"w": _RS.randn(7, 5).astype(np.float32),
            "inner": {"i": np.arange(31), "small": np.ones(3, np.float32)},
            "h": _bf16(_RS.randn(50))}
    flax_bytes = fs.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in flax_bytes
    assert S.packb(tree) == flax_bytes
    _same(S.unpackb(flax_bytes), fs.msgpack_restore(flax_bytes))
    # torch tensors chunk as the numpy arrays of the same values
    as_torch = {"w": torch.from_numpy(tree["w"]),
                "inner": {"i": torch.from_numpy(tree["inner"]["i"]),
                          "small": torch.ones(3)},
                "h": torch.from_numpy(tree["h"].view(np.int16).copy()).view(
                    torch.bfloat16)}
    assert S.packb(as_torch) == flax_bytes


def test_codec_takes_torch_tensors(no_msgpack):
    w = _RS.randn(4, 6).astype(np.float32)
    tree = {"w": torch.from_numpy(w), "t": torch.from_numpy(w).t(),
            "h": torch.from_numpy(w).to(torch.bfloat16),
            "m": torch.tensor([True, False]), "z": torch.tensor(5)}
    want = {"w": w, "t": np.ascontiguousarray(w.T), "h": _bf16(w),
            "m": np.array([True, False]), "z": np.array(5)}
    assert S.packb(tree) == fs.msgpack_serialize(want)


def test_codec_refuses_what_flax_refuses(no_msgpack):
    with pytest.raises(TypeError, match="tuple"):
        S.packb({"a": (1, 2)})
    with pytest.raises(TypeError):
        fs.msgpack_serialize({"a": (1, 2)})
    with pytest.raises(ValueError, match="truncated"):
        S.unpackb(fs.msgpack_serialize({"a": np.ones(4)})[:-3])


# --- the committed JAX file -----------------------------------------------------

FIXTURE_CFG = dict(img_size=16, patch_size=4, embed_dim=128, depth=2,
                   num_heads=2, num_classes=10, mlp_ratio=1.0)
FIXTURE_FFN = 16
BF16_LEAVES = ("qkv", "proj", "fc1", "fc2")


def write_msgpack_fixture(path: Path) -> None:
    """The fixture through the JAX package's ``save_params``."""
    mc = jc.ModelConfig(**FIXTURE_CFG)
    model = JaxViT(mc, tuning=jc.TuningConfig(ffn_num=FIXTURE_FFN,
                                              d_model=128),
                   dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(11),
                                 jnp.zeros((1, 16, 16, 3)))["params"]
    flat = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray,
                                                             params))
    flat = {p: (_bf16(v) if p[-1] == "kernel" and p[-2] in BF16_LEAVES
                else v) for p, v in flat.items()}
    path.parent.mkdir(parents=True, exist_ok=True)
    jckpt.save_params(str(path), traverse_util.unflatten_dict(flat))


def test_jax_written_fixture_reads_and_rewrites(no_msgpack):
    data = FIXTURE.read_bytes()
    assert len(data) <= 500 * 1024
    ours = S.read_file(str(FIXTURE))
    _same(ours, fs.msgpack_restore(data))
    assert S.packb(ours) == data
    kernels = traverse_util.flatten_dict(ours)
    assert any(isinstance(v, torch.Tensor) for v in kernels.values())
    # the port loads every tensor of it
    model = VisionTransformer(tc.ModelConfig(**FIXTURE_CFG),
                              tuning=tc.TuningConfig(ffn_num=FIXTURE_FFN,
                                                     d_model=128),
                              dtype=torch.float32)
    missing, unexpected = load_timm_state_dict(
        model, C.load_params(str(FIXTURE)), log=lambda m: None)
    assert missing == [] and unexpected == []


def test_fixture_decodes_with_no_jax_or_msgpack():
    code = f"""
import sys
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('msgpack', 'flax', 'ml_dtypes', 'jax',
                                  'jaxlib', 'dynamic_tuning_tpu'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Blocker())
from dynamic_tuning_tpu_torch import serialization as S
data = open({str(FIXTURE)!r}, 'rb').read()
tree = S.unpackb(data)
assert S.packb(tree) == data
print(len(data), sum(1 for _ in tree['blocks_0']))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


# --- cross-resume -----------------------------------------------------------------

OPTIMIZERS = {"adamw": {}, "clip": {"clip_grad": 0.05},
              "layer_decay": {"layer_decay": 0.65}, "accum2": {"accum": 2}}


def _patch_noise(mp, arrays):
    """Both packages' router noise returns ``arrays`` in turn (cycling)."""
    calls = {"jax": 0, "port": 0}

    def take(side, shape):
        a = arrays[calls[side] % len(arrays)]
        calls[side] += 1
        assert a.shape == tuple(shape), (a.shape, shape)
        return a

    mp.setattr(jax.random, "logistic", lambda key, shape=(),
               dtype=jnp.float32: jnp.asarray(take("jax", shape), dtype))
    mp.setattr(tlayers, "logistic_noise", lambda shape, generator, *,
               dtype=torch.float32, device=None: torch.from_numpy(
                   take("port", shape)).to(dtype=dtype, device=device))


@pytest.fixture(scope="module")
def toy():
    """The JAX model, its live initial parameters, the data and the
    router noise (patched for the module)."""
    mc = jc.ModelConfig(**TINY)
    tuning = jc.TuningConfig(ffn_num=FFN, d_model=DIM, dropout=0.0)
    sel = jc.SelectConfig()
    model = JaxViT(mc, tuning=tuning, select=sel, dtype=jnp.float32)
    rs = np.random.RandomState(4)
    data = [(rs.randn(B, IMG, IMG, 3).astype(np.float32),
             rs.randint(0, 100, (B,)).astype(np.int64)) for _ in range(4)]
    params = jax.jit(model.init)(jax.random.PRNGKey(2),
                                 jnp.asarray(data[0][0]))["params"]
    trainable, frozen = joptim.partition_params(params)
    for i in range(DEPTH):       # router heads x60, a live adapter
        k = (f"blocks_{i}", "mlp_token_select", "mlp_head", "kernel")
        trainable[k] = trainable[k] * 60.0
        k = (f"blocks_{i}", "adaptmlp", "up_proj", "kernel")
        trainable[k] = jnp.asarray(rs.randn(*trainable[k].shape).astype(
            np.float32) * 0.05)
    noise = [rs.logistic(size=(B, T, 1)).astype(np.float32)
             for _ in range(DEPTH)]
    with pytest.MonkeyPatch.context() as mp:
        _patch_noise(mp, noise)
        yield dict(model=model, mc=mc, tuning=tuning, sel=sel, data=data,
                   trainable=trainable, frozen=frozen, runs={})


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_run(toy, name):
    """JAX's uninterrupted run of ``name``'s optimizer (compiled once per
    file): the state before any step, the state after the steps before the
    save, and the last step's loss parts and state."""
    if name in toy["runs"]:
        return toy["runs"][name]
    kw = dict(OPTIMIZERS[name])
    accum = kw.pop("accum", 1)
    if "layer_decay" in kw:
        kw["params"] = toy["trainable"]
    tx = joptim.with_grad_accumulation(joptim.make_optimizer(
        5e-3, **SCHED, **kw), accum)
    state = create_train_state(toy["trainable"], toy["frozen"], tx,
                               jax.random.PRNGKey(7))
    step = jax.jit(make_train_step(model_apply_fn(toy["model"]), tx,
                                   toy["sel"]))
    pre = 3 if accum > 1 else 2
    out = {"init": state, "pre": pre, "accum": accum, "step": step,
           "kw": OPTIMIZERS[name]}
    for i, (x, y) in enumerate(toy["data"][:pre + 1]):
        if i == pre:
            out["saved"] = state
        state, parts = step(state, jnp.asarray(x), jnp.asarray(y))
    out["end"] = state
    out["parts"] = {k: float(v) for k, v in parts.items()}
    toy["runs"][name] = out
    return out


def _port_side(toy, run):
    """The port's model (the JAX run's initial weights) and TrainState for
    the run's optimizer flags."""
    tm = VisionTransformer(port_cfg(toy["mc"]),
                           tuning=port_cfg(toy["tuning"]),
                           select=port_cfg(toy["sel"]), dtype=torch.float32)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in from_flax_params(
        joptim.merge_params(_host(toy["trainable"]),
                            _host(toy["frozen"]))).items()}, strict=True)
    kw = dict(run["kw"])
    opt = optim.make_optimizer(optim.freeze(tm), 5e-3,
                               accum_iter=kw.pop("accum", 1), **SCHED, **kw)
    return tm, engine.TrainState(opt, seed=5)


def _check_params(model, jax_trainable):
    own = dict(model.named_parameters())
    want = from_flax_params(joptim.merge_params(_host(jax_trainable), {}))
    for name, w in want.items():
        np.testing.assert_allclose(own[name].detach().numpy(), w,
                                   err_msg=name, **PARAM_TOL)


def _check_parts(want, got):
    assert set(want) == set(got)
    for k in want:
        assert got[k] == pytest.approx(want[k], **PART_TOL), k


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_jax_checkpoint_resumes_in_the_port(toy, tmp_path, name):
    run = _jax_run(toy, name)
    path = jckpt.save_checkpoint(str(tmp_path), _host(run["saved"]), 0,
                                 extra={"metric": 12.5})
    tm, tstate = _port_side(toy, run)
    epoch, extra = C.load_checkpoint(path, tm, tstate)
    assert (epoch, extra, tstate.step, tstate.seed) == (
        0, {"metric": 12.5}, run["pre"], 5)
    # the load itself is exact: weights and moments
    want = from_flax_train_state(*(_host(getattr(run["saved"], f)) for f in
                                   ("trainable", "frozen", "opt_state",
                                    "step")))
    for n, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want["model"][n])
    opt = tstate.optimizer
    assert (opt.count, opt.mini_step) == (want["optimizer"]["rule"]["count"],
                                          want["optimizer"]["mini_step"])
    for n, m in zip(opt.names, opt.rule.mu):
        np.testing.assert_array_equal(m.numpy(),
                                      want["optimizer"]["rule"]["mu"][n])
    x, y = toy["data"][run["pre"]]
    parts = engine.make_train_step(tm, port_cfg(toy["sel"]))(
        tstate, torch.from_numpy(x), torch.from_numpy(y))
    _check_parts(run["parts"], {k: float(v) for k, v in parts.items()})
    _check_params(tm, run["end"].trainable)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_port_checkpoint_resumes_in_jax(toy, tmp_path, name):
    run = _jax_run(toy, name)
    tm, tstate = _port_side(toy, run)
    tstep = engine.make_train_step(tm, port_cfg(toy["sel"]))
    for x, y in toy["data"][:run["pre"]]:
        tstep(tstate, torch.from_numpy(x), torch.from_numpy(y))
    path = C.save_checkpoint(str(tmp_path), tm, tstate, 0,
                             extra={"metric": 3.0})
    state, epoch, extra = jckpt.load_checkpoint(path, run["init"])
    assert (epoch, float(extra["metric"]), int(state.step)) == (
        0, 3.0, run["pre"])
    # JAX's restored trees are the port's tensors in the flax layout
    back = from_flax_train_state(_host(state.trainable), _host(state.frozen),
                                 _host(state.opt_state), state.step)
    for n, p in tm.named_parameters():
        np.testing.assert_array_equal(back["model"][n], p.detach().numpy())
    assert back["optimizer"]["mini_step"] == tstate.optimizer.mini_step
    x, y = toy["data"][run["pre"]]
    state, parts = run["step"](state, jnp.asarray(x), jnp.asarray(y))
    _check_parts(run["parts"], {k: float(v) for k, v in parts.items()})
    want = from_flax_params(joptim.merge_params(_host(run["end"].trainable),
                                                {}))
    got = from_flax_params(joptim.merge_params(_host(state.trainable), {}))
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, err_msg=n, **PARAM_TOL)


# --- the sidecar, the saves ------------------------------------------------------

def _bn_stats(seed):
    rs = np.random.RandomState(seed)
    return {f"decode_head.lateral_{i}.bn.running_{s}": torch.from_numpy(
        rs.rand(6).astype(np.float32)) for i in range(2)
        for s in ("mean", "var")}


def test_aux_state_crosses_both_ways_and_prunes(no_msgpack, tmp_path):
    stats = _bn_stats(0)
    for step in (2, 4):
        C.save_aux_state(str(tmp_path), "batch_stats", stats, step,
                         auto_remove=step == 4)
    assert sorted(os.listdir(tmp_path)) == ["aux-batch_stats-4.msgpack"]
    # the JAX package reads it into its template's structure
    template = {"decode_head": {f"lateral_{i}": {"bn": {
        "mean": np.zeros(6, np.float32), "var": np.zeros(6, np.float32)}}
        for i in range(2)}}
    restored = jckpt.load_aux_state(str(tmp_path), "batch_stats", template)
    for i in range(2):
        for s in ("mean", "var"):
            np.testing.assert_array_equal(
                restored["decode_head"][f"lateral_{i}"]["bn"][s],
                stats[f"decode_head.lateral_{i}.bn.running_{s}"].numpy())
    # and the port reads the JAX package's (the newest, or the step's)
    other = tmp_path / "jax"
    for step in (6, 8):
        jckpt.save_aux_state(str(other), "batch_stats", jax.tree_util.
                             tree_map(lambda a: a + step, restored), step)
    got = C.load_aux_state(str(other), "batch_stats")
    assert set(got) == set(stats)
    for n in stats:
        assert torch.equal(got[n], stats[n] + 8), n
    assert torch.equal(C.load_aux_state(str(other), "batch_stats", step=6)[
        "decode_head.lateral_0.bn.running_var"],
        stats["decode_head.lateral_0.bn.running_var"] + 6)
    assert C.load_aux_state(str(tmp_path / "none"), "batch_stats") == {}


def _toy_state(accum=1, seed=1):
    model = VisionTransformer(tc.ModelConfig(**TINY),
                              tuning=tc.TuningConfig(ffn_num=FFN),
                              dtype=torch.float32,
                              generator=torch.Generator().manual_seed(seed))
    opt = optim.make_optimizer(optim.freeze(model), 1e-2, warmup_epochs=0,
                               accum_iter=accum)
    return model, engine.TrainState(opt, seed=9)


@pytest.mark.parametrize("fmt", ["msgpack", "pth"])
def test_checkpoint_round_trip_is_bit_exact(no_msgpack, tmp_path, fmt):
    """save_checkpoint's .msgpack, and the .pth form earlier port runs
    wrote, load bit-exact (a .pth holds the trainable tensors and the
    seed)."""
    model, state = _toy_state(accum=2)
    rs = np.random.RandomState(0)
    for _ in range(3):
        state.optimizer.step([torch.from_numpy(rs.randn(*p.shape).astype(
            np.float32)) for p in state.optimizer.params])
    state.step = 3
    if fmt == "msgpack":
        path = C.save_checkpoint(str(tmp_path), model, state, 1,
                                 extra={"metric": 2.5})
        assert path.endswith("checkpoint-1.msgpack")
    else:
        path = str(tmp_path / "checkpoint-1.pth")
        params = dict(model.named_parameters())
        torch.save({"model": {n: params[n].detach().clone()
                              for n in state.optimizer.names},
                    "optimizer": state.optimizer.state_dict(), "step": 3,
                    "seed": 9, "epoch": 1, "extra": {"metric": 2.5}}, path)
    other, got = _toy_state(accum=2, seed=2)
    got.seed = 4
    assert C.load_checkpoint(path, other, got) == (1, {"metric": 2.5})
    assert (got.step, got.seed) == (3, 4 if fmt == "msgpack" else 9)
    for (n, p), (_, q) in zip(model.named_parameters(),
                              other.named_parameters()):
        if fmt == "msgpack" or p.requires_grad:
            assert torch.equal(p, q), n
    a, b = state.optimizer, got.optimizer
    assert (a.count, a.mini_step) == (b.count, b.mini_step) == (1, 1)
    for x, y in zip(a.rule.mu + a.rule.nu + a.acc,
                    b.rule.mu + b.rule.nu + b.acc):
        assert torch.equal(x, y)


def test_non_blocking_save_leaves_a_whole_file(no_msgpack, tmp_path):
    model, state = _toy_state()
    want = C.save_checkpoint(str(tmp_path / "sync"), model, state, 0)
    path = C.save_checkpoint(str(tmp_path / "async"), model, state, 0,
                             blocking=False)
    with torch.no_grad():        # training goes on while it writes
        for p in model.parameters():
            p.add_(1.0)
    C.wait_for_async_saves()
    assert Path(path).read_bytes() == Path(want).read_bytes()
    assert os.listdir(tmp_path / "async") == ["checkpoint-0.msgpack"]
    # a second save joins the first; auto_remove prunes the older
    C.save_checkpoint(str(tmp_path / "async"), model, state, 1,
                      blocking=False, auto_remove=True)
    C.save_checkpoint(str(tmp_path / "async"), model, state, 2,
                      blocking=False, auto_remove=True)
    C.wait_for_async_saves()
    assert os.listdir(tmp_path / "async") == ["checkpoint-2.msgpack"]


def test_final_weights_load_in_jax(no_msgpack, tmp_path):
    model, _ = _toy_state()
    path = str(tmp_path / "final_checkpoint.msgpack")
    C.save_params(path, model)
    tree = jckpt.load_params(path)
    sd = from_flax_params(tree)
    own = dict(model.named_parameters())
    assert set(sd) == set(own)
    for n, p in own.items():
        np.testing.assert_array_equal(sd[n], p.detach().numpy())
    jm = JaxViT(jc.ModelConfig(**TINY), tuning=jc.TuningConfig(
        ffn_num=FFN, d_model=DIM), dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, IMG, IMG, 3)))["params"]
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(shapes)


# --- serving ------------------------------------------------------------------

ARCH = ["--img_size", str(IMG), "--patch_size", str(PATCH), "--embed_dim",
        str(DIM), "--depth", str(DEPTH), "--num_heads", str(HEADS),
        "--ffn_num", str(FFN), "--nb_classes", "100", "--batch_size", "4",
        "--device", "cpu"]


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_predict_serves_msgpack_as_pth(no_msgpack, toy, tmp_path, quant):
    from PIL import Image

    params = _host(joptim.merge_params(toy["trainable"], toy["frozen"]))
    jckpt.save_params(str(tmp_path / "final_checkpoint.msgpack"), params)
    jckpt.export_torch_state_dict(params, str(tmp_path / "model.pth"))
    rs = np.random.RandomState(3)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i in range(5):
        Image.fromarray(rs.randint(0, 256, (40 + i, 48, 3), np.uint8)).save(
            imgs / f"{i}.png")
    parse = port_predict.get_args_parser().parse_args
    out, served = {}, {}
    for ckpt in ("final_checkpoint.msgpack", "model.pth"):
        args = parse(["--ckpt", str(tmp_path / ckpt), "--images", str(imgs),
                      "--quant", quant] + ARCH)
        served[ckpt] = port_predict.load_params(args, torch.device("cpu"))
        out[ckpt] = port_predict.main(args)
    a, b = served.values()
    flat_a, spec_a = torch.utils._pytree.tree_flatten(
        a if quant == "none" else a.state_dict())
    flat_b, spec_b = torch.utils._pytree.tree_flatten(
        b if quant == "none" else b.state_dict())
    assert spec_a == spec_b
    for x, y in zip(flat_a, flat_b):
        assert type(x) is type(y)
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    assert out["final_checkpoint.msgpack"] == out["model.pth"]
    assert len(out["model.pth"]) == 5
    # the logits themselves, bit for bit
    canvases = port_predict.load_canvases(sorted(
        str(p) for p in imgs.iterdir()), IMG)
    logits = []
    for params in (a, b):
        with torch.inference_mode():
            x = port_predict.augment_batch(None, torch.as_tensor(canvases),
                                           out_size=IMG, inception=False,
                                           train=False)
            if quant == "none":
                cfg, tuning, sel = port_predict.configs(args)
                logits.append(port_predict.fast_vit_forward(
                    params, x, cfg=cfg, tuning=tuning, select=sel,
                    mode="dispatch", use_kernel=False)[0])
            else:
                logits.append(port_predict._model_forward(params, x,
                                                           "dispatch")[0])
    assert torch.equal(*logits)


if __name__ == "__main__":
    write_msgpack_fixture(FIXTURE)
