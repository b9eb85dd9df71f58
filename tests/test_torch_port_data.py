"""The port's data pipeline, metrics, meters, event files and CLI mapping
against the JAX package's, on the CPU.

* ``build_image_dataset`` on folders the test writes (VTAB filelists in the
  no-aug and aug protocols, an ImageFolder tree, the CIFAR-10/100 pickles, a
  fine-grained DTD layout) and the synthetic set: the same lengths, class
  counts, metric names and items (uint8 canvases equal) as the JAX package;
* the loader: the same batches as the JAX ``DataLoader`` for several
  (seed, epoch, process_index, process_count, drop_last, shuffle);
* the train augmentation: given the same boxes, the port's batched
  ``_pil_resized_crop`` against the JAX per-image one within one count (the
  share that is exact printed), and against PIL itself as the JAX test
  holds JAX; the sampler's boxes integer, inside the canvas and within the
  area/aspect bounds; the draws a function of the generator's seed; the
  flip; the no-aug resize within 1e-4 of the full scale (255) and the
  normalization;
* ``topk_accuracy`` (with ties) and ``mean_per_class_accuracy`` equal; an
  event file written by the port read by the JAX package's reader;
* ``args_to_config``: field for field what the JAX package's gives for the
  same argv (``main_image``'s and ``main_vtab``'s defaults, ``--lr`` vs
  ``--blr``, ``--accum_iter 2``, ``--fulltune``, ``--eval_dispatch``, the
  registry lookups).
"""

import argparse
import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import main_vtab as jax_main_vtab
from dynamic_tuning_tpu import cli as jcli
from dynamic_tuning_tpu import paths as jpaths
from dynamic_tuning_tpu.data import datasets as jds
from dynamic_tuning_tpu.data import loader as jloader
from dynamic_tuning_tpu.data import transforms as jT
from dynamic_tuning_tpu.utils import metrics as jmetrics
from dynamic_tuning_tpu.utils.tb_writer import read_event_file
from dynamic_tuning_tpu_torch import cli as tcli
from dynamic_tuning_tpu_torch import main_image as port_main_image
from dynamic_tuning_tpu_torch import main_vtab as port_main_vtab
from dynamic_tuning_tpu_torch import paths as tpaths
from dynamic_tuning_tpu_torch.data import datasets as tds
from dynamic_tuning_tpu_torch.data import loader as tloader
from dynamic_tuning_tpu_torch.data import transforms as tT
from dynamic_tuning_tpu_torch.utils import meters as tmeters
from dynamic_tuning_tpu_torch.utils import metrics as tmetrics
from dynamic_tuning_tpu_torch.utils.logger import TensorBoardWriter


# --- datasets ----------------------------------------------------------------

def _png(path, rs, h, w):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rs.randint(0, 256, (h, w, 3), np.uint8)).save(path)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """VTAB filelists, an ImageFolder tree, CIFAR pickles and a DTD layout,
    images of odd sizes (both orientations) so every canvas resizes."""
    root = tmp_path_factory.mktemp("data")
    rs = np.random.RandomState(0)
    vtab = root / "dtd_vtab"
    lines = {"train800val200.txt": [], "test.txt": []}
    for i in range(9):
        rel = f"images/im{i}.png"
        _png(str(vtab / rel), rs, 40 + 3 * i, 61 - 2 * i)
        lines["test.txt" if i >= 6 else "train800val200.txt"].append(
            f"{rel} {i % 5}")
    for name, ls in lines.items():
        (vtab / name).write_text("\n".join(ls) + "\n")
    for split, n in (("train", 3), ("val", 2)):
        for c in ("b_cls", "a_cls"):
            for i in range(n):
                _png(str(root / "folderset" / split / c / f"{i}.png"), rs,
                     33 + i, 47 - i)
        (root / "folderset" / split / "a_cls" / "notes.txt").write_text("x")
    for name, files, key in (
            ("cifar-10-batches-py",
             [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"],
             "labels"),
            ("cifar-100-python", ["train", "test"], "fine_labels")):
        os.makedirs(root / name)
        for f in files:
            blob = {"data": rs.randint(0, 256, (4, 3072), np.uint8),
                    key: list(rs.randint(0, 10, 4))}
            with open(root / name / f, "wb") as fh:
                pickle.dump(blob, fh)
    dtd = root / "dtd"
    for split in ("train", "test"):
        ls = []
        for c in ("banded", "woven"):
            for i in range(2):
                rel = f"{c}/{split}{i}.png"
                _png(str(dtd / "images" / rel), rs, 30 + i, 44)
                ls.append(rel)
        os.makedirs(dtd / "labels", exist_ok=True)
        (dtd / "labels" / f"{split}1.txt").write_text("\n".join(ls) + "\n")
    return str(root)


@pytest.mark.parametrize("name,no_aug,canvas", [
    ("dtd_vtab", True, 0), ("dtd_vtab", False, 0), ("folderset", False, 0),
    ("folderset", True, 48), ("cifar10", False, 0), ("cifar100_full", True, 0),
    ("dtd_full", False, 0), ("synthetic", True, 0), ("synthetic", False, 64),
])
def test_build_image_dataset_matches_jax(data_root, name, no_aug, canvas):
    want = jds.build_image_dataset(name, data_root, no_aug=no_aug,
                                   canvas=canvas)
    got = tds.build_image_dataset(name, data_root, no_aug=no_aug,
                                  canvas=canvas)
    assert got[2:] == want[2:]                   # classes, metric
    for g, w in zip(got[:2], want[:2]):          # train, val
        assert len(g) == len(w) > 0
        assert type(g).__name__ == type(w).__name__
        assert getattr(g, "square", None) == getattr(w, "square", None)
        for i in sorted({0, len(w) // 2, len(w) - 1}):
            gi, wi = g[i], w[i]
            assert gi[1] == wi[1]
            assert gi[0].dtype == np.uint8
            np.testing.assert_array_equal(gi[0], wi[0])


# --- loader ------------------------------------------------------------------

@pytest.mark.parametrize("seed,epoch,pi,pc,drop_last,shuffle", [
    (0, 0, 0, 1, True, True), (3, 2, 0, 1, False, True),
    (1, 1, 1, 3, True, True), (1, 1, 2, 3, False, True),
    (5, 0, 1, 2, False, False), (0, 4, 0, 4, True, False),
])
def test_loader_batches_match_jax(seed, epoch, pi, pc, drop_last, shuffle):
    rs = np.random.RandomState(seed)
    imgs = rs.randint(0, 256, (37, 6, 5, 3)).astype(np.uint8)
    labels = rs.randint(0, 9, 37)
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=seed,
              num_workers=3, process_index=pi, process_count=pc)
    want = jloader.DataLoader(jds.ArrayDataset(imgs, labels, 9), 4, **kw)
    got = tloader.make_loader(tds.ArrayDataset(imgs, labels, 9), 4, **kw)
    assert isinstance(got, tloader.DataLoader)
    for dl in (want, got):
        dl.set_epoch(epoch)
    assert len(got) == len(want)
    gb, wb = list(got), list(want)
    assert len(gb) == len(wb) == len(want)
    for (gx, gy), (wx, wy) in zip(gb, wb):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert gy.dtype == np.int32


# --- train augmentation ------------------------------------------------------

def _boxes(rs, n, h, w):
    ch = rs.randint(6, h + 1, n)
    cw = rs.randint(6, w + 1, n)
    top = np.array([rs.randint(0, h - c + 1) for c in ch])
    left = np.array([rs.randint(0, w - c + 1) for c in cw])
    return [torch.tensor(v, dtype=torch.float32)
            for v in (top, left, ch, cw)]


@pytest.mark.parametrize("h,w,out", [(64, 64, 48), (48, 72, 96),
                                     (256, 256, 32)])
def test_resized_crop_matches_jax_within_one_count(h, w, out):
    rs = np.random.RandomState(h + w + out)
    n = 6
    imgs = rs.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    top, left, ch, cw = _boxes(rs, n, h, w)
    top[0], left[0], ch[0], cw[0] = 0, 0, h, w               # full canvas
    got = tT._pil_resized_crop(torch.from_numpy(imgs), top, left, ch, cw,
                               out).numpy()
    fn = jax.jit(jT._pil_resized_crop, static_argnames=("out_size",))
    want = np.stack([np.asarray(fn(jnp.asarray(imgs[i]), float(top[i]),
                                   float(left[i]), float(ch[i]),
                                   float(cw[i]), out_size=out))
                     for i in range(n)])
    assert got.shape == want.shape == (n, out, out, 3)
    assert np.array_equal(got, np.round(got)) and got.min() >= 0
    d = np.abs(got - want)
    print(f"port vs JAX resized crop {h}x{w}->{out}: exact share "
          f"{(d == 0).mean():.6f}, max {d.max()}")
    assert d.max() <= 1.0
    assert (d == 0).mean() > 0.99
    # and against PIL itself, as tests/test_transforms_pil_parity.py holds
    # the JAX package (PIL's fixed point: +-1, rarely 2)
    for i in range(2):
        box = Image.fromarray(imgs[i]).crop(
            (int(left[i]), int(top[i]), int(left[i] + cw[i]),
             int(top[i] + ch[i])))
        ref = np.asarray(box.resize((out, out), Image.BICUBIC), np.float32)
        assert np.abs(ref - got[i]).max() <= 2.0


def test_crop_sampler_bounds_and_seed():
    h, w, n = 256, 200, 4000
    top, left, ch, cw = tT._sample_crop_box(
        torch.Generator().manual_seed(3), n, h, w)
    for v in (top, left, ch, cw):
        assert v.dtype == torch.float32 and torch.equal(v, v.round())
    assert (top >= 0).all() and (left >= 0).all()
    assert (top + ch <= h).all() and (left + cw <= w).all()
    assert (ch >= 1).all() and (cw >= 1).all()
    free = (ch < h) & (cw < w)                   # not clamped
    area = (ch * cw / (h * w))[free]
    aspect = (cw / ch)[free]
    # the sides are rounded: a pixel of slack on each
    assert area.min() >= 0.08 * 0.9 and area.max() <= 1.0
    assert aspect.min() >= 0.75 * 0.95 and aspect.max() <= 4 / 3 * 1.05
    assert area.max() > 0.7 and area.min() < 0.12    # the range is used
    # the position is integer-uniform over the free range
    assert top[ch < h / 2].max() > h / 2 and left.min() == 0
    # high-area draws keep their clamped size (single draw, no retry)
    assert ((ch == h) | (cw == w)).any()
    again = tT._sample_crop_box(torch.Generator().manual_seed(3), n, h, w)
    assert all(torch.equal(a, b) for a, b in zip((top, left, ch, cw), again))
    other = tT._sample_crop_box(torch.Generator().manual_seed(4), n, h, w)
    assert not torch.equal(top, other[0])


def test_train_augment_is_the_drawn_crop_and_flip():
    rs = np.random.RandomState(1)
    imgs = torch.from_numpy(rs.randint(0, 256, (8, 64, 64, 3)).astype(
        np.uint8))
    got = tT.augment_batch(torch.Generator().manual_seed(11), imgs,
                           out_size=32, train=True)
    (top, left, ch, cw), flips = tT.sample_train_draws(
        torch.Generator().manual_seed(11), 8, 64, 64)
    assert 0 < flips.sum() < 8
    crop = tT._pil_resized_crop(imgs, top, left, ch, cw, 32)
    want = tT.normalize(torch.where(flips[:, None, None, None],
                                    crop.flip(2), crop))
    assert torch.equal(got, want)
    # the flip is the JAX package's
    jflip = np.stack([np.asarray(jT.hflip(jax.random.PRNGKey(0), jnp.asarray(
        c.numpy()))) for c in crop])
    jnone = crop.numpy()
    for i in range(8):
        mirrored = not np.array_equal(jflip[i], jnone[i])
        np.testing.assert_array_equal(
            tT.hflip(crop[i:i + 1], torch.tensor([mirrored]))[0].numpy(),
            jflip[i])
    inception = tT.augment_batch(torch.Generator().manual_seed(11), imgs,
                                 out_size=32, inception=True, train=True)
    assert torch.allclose(inception, (want * torch.tensor(
        tT.IMAGENET_STD) + torch.tensor(tT.IMAGENET_MEAN) - 0.5) / 0.5,
        atol=1e-5)


@pytest.mark.parametrize("canvas,size", [(224, 32), (256, 224), (224, 224),
                                         (45, 64)])
def test_no_aug_resize_and_normalize_match_jax(canvas, size):
    rs = np.random.RandomState(canvas + size)
    imgs = rs.randint(0, 256, (3, canvas, canvas, 3)).astype(np.uint8)
    want = np.asarray(jnp.clip(jax.image.resize(
        jnp.asarray(imgs, jnp.float32), (3, size, size, 3), "cubic"),
        0, 255))
    got = tT.resize_batch(torch.from_numpy(imgs), size)
    # fp32 sums in another order: within 1e-4 of the full scale, 255
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * 255)
    for inception in (False, True):
        np.testing.assert_allclose(
            tT.normalize_batch(got, inception).numpy(),
            np.asarray(jT.normalize_batch(jnp.asarray(want), inception)),
            rtol=0, atol=1e-5)


# --- metrics, meters, event files ---------------------------------------------

def test_metrics_match_jax():
    rs = np.random.RandomState(0)
    logits = rs.randint(0, 4, (200, 12)).astype(np.float32)   # many ties
    labels = rs.randint(0, 12, 200)
    labels[labels == 7] = 3                                    # class absent
    for topk in ((1,), (1, 5), (2, 3, 12)):
        assert tmetrics.topk_accuracy(logits, labels, topk) == \
            jmetrics.topk_accuracy(jnp.asarray(logits), jnp.asarray(labels),
                                   topk)
    assert tmetrics.mean_per_class_accuracy(logits, labels, 12) == \
        jmetrics.mean_per_class_accuracy(jnp.asarray(logits), labels, 12)


def test_event_file_reads_back_in_the_jax_package(tmp_path):
    w = TensorBoardWriter(str(tmp_path))
    want = [("loss", 2.5, 0), ("lr", 1e-3, 1000), ("loss", -0.25, 2 ** 40)]
    for tag, v, step in want:
        w.add_scalar(tag, v, step)
    w.close()
    events = [p for p in os.listdir(tmp_path) if p.startswith("events")]
    assert len(events) == 1
    got = list(read_event_file(str(tmp_path / events[0])))
    assert [(t, s) for t, _, s in got] == [(t, s) for t, _, s in want]
    for (_, g, _), (_, v, _) in zip(got, want):
        assert g == np.float32(v)
    assert (tmp_path / "scalars.tsv").read_text().count("\n") == 3


def test_metric_logger_averages(capsys):
    ml = tmeters.MetricLogger()
    seen = list(ml.log_every(range(5), 2, header="h"))
    for i in seen:
        ml.update(loss=float(i), acc=torch.tensor(2.0 * i))
    assert seen == list(range(5))
    assert ml.loss.global_avg == 2.0 and ml.acc.value == 8.0
    assert ml.loss.median == 2.0
    assert "Total time" in capsys.readouterr().out


# --- CLI ---------------------------------------------------------------------

def _jax_image_parser():
    return jcli.add_common_args(argparse.ArgumentParser(add_help=False))


def _as_dict(cfg):
    """A config as nested dicts, the port's fields only (the JAX RunConfig's
    mesh and DataConfig's video fields have no counterpart)."""
    d = dataclasses.asdict(cfg)
    d.pop("mesh", None)
    return d


@pytest.mark.parametrize("entry,argv", [
    ("image", []),
    ("vtab", ["--dataset", "dtd_vtab"]),
    ("image", ["--lr", "3e-4", "--blr", "2e-3", "--dataset", "cifar100_full",
               "--finetune", "VIT_BASE_IN21K"]),
    ("image", ["--blr", "2e-3", "--accum_iter", "2", "--batch_size", "64",
               "--clip_grad", "1.0", "--start_epoch", "3", "--log_dir", "tb"]),
    ("image", ["--fulltune", "--no_auto_remove", "--quant", "int8",
               "--remat", "--gelu_approx", "--residual_dtype", "bfloat16"]),
    ("vtab", ["--eval_dispatch", "--capacity_ratio", "0.6", "--no_select",
              "--keep_layers", "2", "--moe_experts", "4", "--inception",
              "--canvas", "256", "--seed", "7"]),
])
def test_args_to_config_matches_jax(monkeypatch, tmp_path, entry, argv):
    monkeypatch.setenv("DYT_COMPILE_CACHE", "0")
    monkeypatch.setenv("DYT_CLUSTER", "test_torch_port_data")
    jpaths.register_cluster("test_torch_port_data",
                            {"cifar100": "/data/c100"},
                            {"VIT_BASE_IN21K": "/ckpt/in21k.pth"})
    tpaths.register_cluster("test_torch_port_data",
                            {"cifar100": "/data/c100"},
                            {"VIT_BASE_IN21K": "/ckpt/in21k.pth"})
    if entry == "image":
        jargs = _jax_image_parser().parse_args(argv)
        targs = port_main_image.get_args_parser().parse_args(argv)
    else:
        jargs = jax_main_vtab.get_args_parser().parse_args(argv)
        targs = port_main_vtab.get_args_parser().parse_args(argv)
    no_aug = entry == "vtab"
    want = jcli.args_to_config(jargs, no_aug=no_aug)
    got = tcli.args_to_config(targs, no_aug=no_aug)
    assert want.mesh.model_parallel == 1
    w, g = _as_dict(want), _as_dict(got)
    for k in set(w["data"]) - set(g["data"]):
        w["data"].pop(k)                         # the video fields
    assert g == w
    if "--finetune" in argv:
        assert got.finetune == "/ckpt/in21k.pth"
        assert got.data.data_path == "/data/c100"
    eff = got.data.batch_size * got.accum_iter
    assert got.optim.absolute_lr(eff) == want.optim.absolute_lr(eff)
