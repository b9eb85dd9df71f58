"""The port's native JPEG/PNG loader (``data/native_loader.py`` on its own
copy of ``native/dyt_loader.cpp``) against the JAX package's, on the CPU.

* the library builds with g++ from the port's source into the git-ignored
  ``build/``, never beside the source; a build that fails returns None
  and says why; the source is the repository's but for its header;
* ``decode_resize`` byte for byte against the JAX package's native decode
  (JPEG, PNG, CMYK JPEG, RGBA PNG; crop and square; two canvases), and
  within one count of PIL (the port's ``decode_canvas``);
* ``NativeDataLoader`` batches equal to the JAX package's (shuffled
  epochs, the two shards of a world of 2, square mode), the sentinel
  padding of an evaluation shard;
* ``make_loader`` takes it for file datasets and names it
  (``decoder_of``); ``predict.load_canvases`` equals the repository
  ``predict.py``'s native canvases;
* ``dynamic_tuning_tpu_torch/native/fixtures``, the JPEGs and PIL canvases
  ``chip_smoke.py`` holds the loader to on a host without PIL, made by
  ``PYTHONPATH=. python tests/test_torch_port_native_loader.py``: PIL
  decodes the JPEGs to the stored canvases, the native loader within one
  count.
"""

import os
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from dynamic_tuning_tpu.data import native_loader as JNL
from dynamic_tuning_tpu_torch.data import _native_build
from dynamic_tuning_tpu_torch.data import native_loader as NL
from dynamic_tuning_tpu_torch.data.datasets import decode_canvas

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "dynamic_tuning_tpu_torch" / "native" / "fixtures"
#: (canvas, square) of the stored PIL canvases
FIXTURE_CANVASES = ((64, False), (64, True))


def _pattern(h, w, seed):
    """A smooth RGB image (gradients and waves, as photographs compress)."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    chans = [127 + 100 * np.sin(xx / rs.uniform(8, 40) + yy / rs.uniform(
        10, 50) + rs.uniform(0, 6)) for _ in range(3)]
    return np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)


def write_jpeg_fixtures(d: Path) -> None:
    """The fixture JPEGs and their PIL canvases (``decode_canvas``)."""
    d.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(23)
    images = {"smooth_500x375": _pattern(375, 500, 1),
              "portrait_333x500": _pattern(500, 333, 2),
              "noise_80x61": rs.randint(0, 256, (61, 80, 3), np.uint8)}
    canvases = {}
    for name, arr in images.items():
        path = d / f"{name}.jpg"
        Image.fromarray(arr).save(path, quality=90)
        for canvas, square in FIXTURE_CANVASES:
            key = f"{name}_{canvas}_{'square' if square else 'crop'}"
            canvases[key] = decode_canvas(str(path), canvas, square=square)
    np.savez_compressed(d / "pil_canvases.npz", **canvases)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """20 files: JPEGs and PNGs of several sizes, a CMYK JPEG, an RGBA
    PNG; labels i % 5."""
    d = tmp_path_factory.mktemp("imgs")
    rs = np.random.RandomState(0)
    samples = []
    for i in range(18):
        arr = rs.randint(0, 256, (60 + 3 * i, 80 - i, 3), np.uint8)
        ext = "jpg" if i % 2 == 0 else "png"
        p = str(d / f"img_{i}.{ext}")
        Image.fromarray(arr).save(p)
        samples.append((p, i % 5))
    p = str(d / "cmyk.jpg")
    Image.fromarray(rs.randint(0, 256, (80, 61, 4), np.uint8),
                    "CMYK").save(p, quality=95)
    samples.append((p, 18 % 5))
    rgba = rs.randint(0, 256, (60, 90, 4), np.uint8)
    rgba[:20, :, 3] = 0
    p = str(d / "rgba.png")
    Image.fromarray(rgba, "RGBA").save(p)
    samples.append((p, 19 % 5))
    return samples


def test_library_builds_into_build_dir():
    assert NL.available(), NL.why_unavailable()
    assert NL.why_unavailable() == ""
    so = Path(NL.library_path())
    assert so.is_file() and so.parent == REPO / "build" / "dyt_native"
    native = REPO / "dynamic_tuning_tpu_torch" / "native"
    assert not [f for _, _, fs in os.walk(native) for f in fs
                if f.endswith((".so", ".tmp"))]


def test_source_is_the_repository_copy():
    mine = (REPO / "dynamic_tuning_tpu_torch" / "native" /
            "dyt_loader.cpp").read_text().splitlines()
    theirs = (REPO / "native" / "dyt_loader.cpp").read_text().splitlines()
    assert len(mine) == len(theirs)
    differ = [i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b]
    assert differ == [0, 9]
    assert all(mine[i].startswith("//") for i in differ)


def test_failed_build_returns_none_and_says_why(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    so = tmp_path / "out" / "libbroken.so"
    assert _native_build.build_and_load(str(src), str(so), []) is None
    assert _native_build.build_error
    assert not so.exists()
    assert not [f for f in os.listdir(so.parent) if f.endswith(".tmp")]
    _native_build.build_error = ""


def _jax_available():
    if not JNL.available():
        pytest.skip("the JAX package's native loader did not load")


@pytest.mark.parametrize("canvas", [32, 64])
@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("which", [0, 1, 6, 18, 19],
                         ids=["jpg", "png", "jpg_tall", "cmyk", "rgba"])
def test_decode_resize_matches_jax_native_byte_for_byte(image_dir, which,
                                                        square, canvas):
    _jax_available()
    path = image_dir[which][0]
    got = NL.decode_resize(path, canvas, square=square)
    want = JNL.decode_resize(path, canvas, square=square)
    assert got is not None and got.shape == (canvas, canvas, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("which", [1, 3, 19], ids=["png", "png2", "rgba"])
def test_decode_resize_within_one_of_pil(image_dir, which, square):
    path = image_dir[which][0]
    got = NL.decode_resize(path, 48, square=square).astype(np.int32)
    want = decode_canvas(path, 48, square=square).astype(np.int32)
    assert np.abs(got - want).max() <= 1


def _batches(loader, epoch=0):
    loader.set_epoch(epoch)
    return list(loader)


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=3, batch_size=6),
    dict(shuffle=False, batch_size=7, drop_last=True),
    dict(shuffle=True, seed=1, batch_size=4, process_index=0,
         process_count=2),
    dict(shuffle=True, seed=1, batch_size=4, process_index=1,
         process_count=2),
    dict(shuffle=False, batch_size=5, square=True),
], ids=["shuffled", "drop_last", "shard0", "shard1", "square"])
def test_native_loader_batches_match_jax(image_dir, kw):
    _jax_available()
    got = NL.NativeDataLoader(image_dir, canvas=24, num_workers=3, **kw)
    want = JNL.NativeDataLoader(image_dir, canvas=24, num_workers=3, **kw)
    assert len(got) == len(want)
    for epoch in (0, 1):
        a, b = _batches(got, epoch), _batches(want, epoch)
        assert len(a) == len(b)
        for (ia, la), (ib, lb) in zip(a, b):
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(la, lb)


def test_native_loader_sentinel_pad(image_dir):
    samples = image_dir[:7]
    labels = []
    for r in range(2):
        dl = NL.NativeDataLoader(samples, 3, canvas=16, process_index=r,
                                 process_count=2, sentinel_pad=True)
        got = np.concatenate([lb for _, lb in _batches(dl)])
        assert len(got) == 4
        labels += got[got >= 0].tolist()
        assert (got < 0).sum() == r          # rank 1 holds the one pad
    assert sorted(labels) == sorted(s[1] for s in samples)


def test_make_loader_takes_the_native_loader(image_dir, tmp_path):
    from dynamic_tuning_tpu_torch.data.datasets import (ImageFolder,
                                                        SyntheticDataset)
    from dynamic_tuning_tpu_torch.data.loader import (DataLoader, decoder_of,
                                                      make_loader)
    for i, (p, lab) in enumerate(image_dir[:6]):
        d = tmp_path / f"class{lab}"
        d.mkdir(exist_ok=True)
        os.symlink(p, d / os.path.basename(p))
    ds = ImageFolder(str(tmp_path), canvas=32)
    dl = make_loader(ds, 4, process_index=0, process_count=1)
    assert isinstance(dl, NL.NativeDataLoader)
    assert decoder_of(dl).startswith("native C++")
    imgs, labels = next(iter(dl))
    for k in range(len(labels)):
        path, lab = ds.samples[k]
        assert labels[k] == lab
        np.testing.assert_array_equal(imgs[k], NL.decode_resize(path, 32))
    syn = make_loader(SyntheticDataset(8, 16), 4)
    assert isinstance(syn, DataLoader)
    assert decoder_of(syn).startswith("none")


def test_predict_canvases_match_the_repository_predict(image_dir):
    _jax_available()
    import importlib.util

    from dynamic_tuning_tpu_torch import predict
    spec = importlib.util.spec_from_file_location("root_predict",
                                                  REPO / "predict.py")
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    paths = [p for p, _ in image_dir[:6]]
    assert predict.decoder() == "native"
    got = predict.load_canvases(paths, 40)
    for k, p in enumerate(paths):
        np.testing.assert_array_equal(got[k], root._load_canvas(p, 40))


def test_jpeg_fixtures_decode_as_stored():
    ref = np.load(FIXTURES / "pil_canvases.npz")
    assert len(ref.files) == 3 * len(FIXTURE_CANVASES)
    for key in ref.files:
        name, canvas, mode = key.rsplit("_", 2)
        path = str(FIXTURES / f"{name}.jpg")
        pil = decode_canvas(path, int(canvas), square=mode == "square")
        np.testing.assert_array_equal(pil, ref[key], err_msg=key)
        got = NL.decode_resize(path, int(canvas), square=mode == "square")
        assert np.abs(got.astype(int) - ref[key].astype(int)).max() <= 1


if __name__ == "__main__":
    write_jpeg_fixtures(FIXTURES)
