"""The port's native video decoder (``data/native_video.py`` on its own copy
of ``native/dyt_video.cpp``) against the JAX package's, on the CPU.

* clips written by ``cv2.VideoWriter`` (as ``tests/test_video_files.py``
  writes them): ``probe`` and ``read_frames`` bit for bit against the JAX
  package's native decoder, indices past the end clamped to the last
  frame as there;
* the C resize bit for bit against the JAX package's C resize, and against
  the numpy form within the JAX package's own bound (one count:
  ``tests/test_video.py::test_native_resize_matches_numpy``); the tap
  checks refuse int64 and non-contiguous taps; a failing C call raises
  through ``_bicubic_resize`` instead of falling back;
* ``decode_backend``: native first, then as the JAX package's order when it
  cannot load; ``DYT_VIDEO_BACKEND=native`` raises with the build's error
  when the source does not compile; ``VideoDataset`` on the native decoder
  and the C resize against the JAX package's;
* ``dynamic_tuning_tpu_torch/native/fixtures/clip_64x48.mp4`` and its
  frames as the JAX decoder gives them (``clip_64x48_frames.npz``, which
  ``chip_smoke.py`` holds the port's decoder to on the card's host), made
  by ``PYTHONPATH=. python tests/test_torch_port_native_video.py``: both
  decoders still give the stored frames.
"""

import os
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from dynamic_tuning_tpu.data import native_video as JNV
from dynamic_tuning_tpu.data import video as jv
from dynamic_tuning_tpu_torch.data import _native_build
from dynamic_tuning_tpu_torch.data import native_video as NV
from dynamic_tuning_tpu_torch.data import video as tv

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "dynamic_tuning_tpu_torch" / "native" / "fixtures"
FIXTURE_CLIP = "clip_64x48.mp4"
FIXTURE_FRAMES = "clip_64x48_frames.npz"


def _write_clip(path: str, frames: int, seed: int, size=(64, 48)) -> None:
    """A gradient clip with a moving ramp and a little noise (mp4v)."""
    w, h = size
    rs = np.random.RandomState(seed)
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, size)
    assert out.isOpened()
    grad = np.linspace(0, 180, w, dtype=np.uint8)[None, :, None]
    for t in range(frames):
        frame = np.broadcast_to(grad, (h, w, 3)).copy()
        frame += np.uint8((seed * 50 + 3 * t) % 60)
        frame[:, :, 1] += rs.randint(0, 8, (h, w), np.uint8)
        out.write(frame)
    out.release()


def write_video_fixtures(d: Path) -> None:
    """The fixture clip and every frame of it as the JAX package's native
    decoder gives them."""
    d.mkdir(parents=True, exist_ok=True)
    path = str(d / FIXTURE_CLIP)
    _write_clip(path, 12, seed=5)
    n, h, w = JNV.probe(path)
    frames = JNV.read_frames(path, list(range(n)))
    np.savez_compressed(d / FIXTURE_FRAMES,
                        frames=np.stack([frames[i] for i in range(n)]),
                        probe=np.array([n, h, w]))


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    if not (NV.available() and JNV.available()):
        pytest.skip("libav or g++ missing: " + NV.why_unavailable())
    d = tmp_path_factory.mktemp("clips")
    out = {}
    for i, (frames, size) in enumerate(((40, (64, 48)), (9, (48, 64)),
                                        (25, (80, 36)))):
        path = str(d / f"clip{i}.mp4")
        _write_clip(path, frames, seed=i, size=size)
        out[i] = path
    lines = [f"clip{i}.mp4 {i % 2}" for i in out]
    (d / "list.csv").write_text("\n".join(lines) + "\n")
    return str(d), out


def test_library_builds_into_build_dir():
    assert NV.available(), NV.why_unavailable()
    assert Path(NV._SO).parent == _native_build.BUILD_DIR
    assert Path(NV._SRC).parent == _native_build.NATIVE_DIR
    # the port's source is the repository's but for its header
    ours = Path(NV._SRC).read_text().splitlines()
    theirs = (REPO / "native" / "dyt_video.cpp").read_text().splitlines()
    assert len(ours) == len(theirs)
    assert [i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b] == [
        0, 8]


@pytest.mark.parametrize("clip", [0, 1, 2])
def test_probe_matches_jax(clips, clip):
    path = clips[1][clip]
    assert NV.probe(path) == JNV.probe(path)


@pytest.mark.parametrize("clip,want", [
    (0, [0, 1, 2, 3]), (0, [39, 5, 17, 5]), (1, [0, 4, 8, 12, 30]),
    (2, list(range(25))), (2, [24, 40, 100])],
    ids=["head", "unsorted", "past_end", "whole", "all_past_end"])
def test_read_frames_matches_jax(clips, clip, want):
    path = clips[1][clip]
    got, ref = NV.read_frames(path, want), JNV.read_frames(path, want)
    assert sorted(got) == sorted(ref) == sorted(set(want))
    for i in ref:
        assert got[i].dtype == np.uint8 and got[i].shape[2] == 3
        np.testing.assert_array_equal(got[i], ref[i])
    n = NV.probe(path)[0]
    past = [i for i in want if i >= n]
    for i in past:       # clamped to the last frame, as the JAX decoder
        np.testing.assert_array_equal(got[i], JNV.read_frames(
            path, [n - 1])[n - 1])


@pytest.mark.parametrize("shape", [(240, 320, 256, 341), (90, 120, 224, 298),
                                   (64, 64, 320, 320), (240, 320, 64, 48),
                                   (7, 13, 29, 31)])
def test_native_resize_matches_jax(monkeypatch, shape):
    h, w, nh, nw = shape
    img = np.random.RandomState(h + w).randint(0, 256, (h, w, 3), np.uint8)
    ih, wh = tv._tb_taps(h, nh)
    iw, ww = tv._tb_taps(w, nw)
    got = NV.resize_bicubic(img, nh, nw, ih, wh, iw, ww)
    ref = JNV.resize_bicubic(img, nh, nw, *jv._tb_taps(h, nh),
                             *jv._tb_taps(w, nw))
    np.testing.assert_array_equal(got, ref)
    # _bicubic_resize takes the C form; DYT_NATIVE_RESIZE=0 the numpy one
    np.testing.assert_array_equal(tv._bicubic_resize(img, nw, nh), got)
    monkeypatch.setenv("DYT_NATIVE_RESIZE", "0")
    plain = tv._bicubic_resize(img, nw, nh)
    np.testing.assert_array_equal(plain, jv._bicubic_resize(img, nw, nh))
    assert np.abs(got.astype(int) - plain.astype(int)).max() <= 1


def test_resize_refuses_taps_of_another_layout():
    img = np.zeros((20, 30, 3), np.uint8)
    ih, wh = tv._tb_taps(20, 10)
    iw, ww = tv._tb_taps(30, 15)
    with pytest.raises(ValueError, match="int32"):
        NV.resize_bicubic(img, 10, 15, ih.astype(np.int64), wh, iw, ww)
    with pytest.raises(ValueError, match="float32"):
        NV.resize_bicubic(img, 10, 15, ih, wh, iw, ww.astype(np.float64))
    strided = np.zeros((15, 8), np.int32)[:, ::2]
    strided[:] = iw
    with pytest.raises(ValueError, match="contiguous"):
        NV.resize_bicubic(img, 10, 15, ih, wh, strided, ww)
    with pytest.raises(ValueError, match=r"\[11, 4\]"):
        NV.resize_bicubic(img, 11, 15, ih, wh, iw, ww)


def test_failing_resize_call_raises(monkeypatch):
    """Unlike the JAX package's ``except Exception: pass``, a C call that
    fails once the library has loaded raises through ``_bicubic_resize``."""
    img = np.zeros((20, 30, 3), np.uint8)
    empty_i, empty_w = np.zeros((0, 4), np.int32), np.zeros((0, 4), np.float32)
    iw, ww = tv._tb_taps(30, 15)
    with pytest.raises(RuntimeError, match="dyt_resize_bicubic failed"):
        NV.resize_bicubic(img, 0, 15, empty_i, empty_w, iw, ww)
    monkeypatch.setattr(tv, "_tb_taps", lambda n_in, n_out: (
        (empty_i, empty_w) if n_out == 0 else (iw, ww)))
    with pytest.raises(RuntimeError, match="dyt_resize_bicubic failed"):
        tv._bicubic_resize(img, 15, 0)


def test_decode_backend_order_matches_jax(monkeypatch):
    monkeypatch.delenv("DYT_VIDEO_BACKEND", raising=False)
    assert tv.BACKENDS[0] == "native"
    assert tv.decode_backend() == jv.decode_backend() == "native"
    monkeypatch.setattr(NV, "available", lambda: False)
    monkeypatch.setattr(JNV, "available", lambda: False)
    assert tv.decode_backend() == jv.decode_backend() != "native"


def test_forced_native_raises_when_the_build_fails(monkeypatch, tmp_path):
    broken = tmp_path / "dyt_video.cpp"
    broken.write_text((REPO / "native" / "dyt_video.cpp").read_text()
                      + "\nthis is not C++;\n")
    monkeypatch.setattr(NV, "_SRC", str(broken))
    monkeypatch.setattr(NV, "_SO", str(tmp_path / "libdyt_video.so"))
    monkeypatch.setattr(NV, "_LIB", None)
    monkeypatch.setenv("DYT_VIDEO_BACKEND", "native")
    with pytest.raises(ImportError, match="native video decoder "
                       "unavailable: .*error"):
        tv.decode_backend()
    assert not (tmp_path / "libdyt_video.so").exists()
    with pytest.raises(RuntimeError, match="unavailable"):
        NV.probe(str(tmp_path / "x.mp4"))


@pytest.mark.parametrize("kw", [
    dict(sampling_rate=4),
    dict(sampling_rate=0, test_mode=True, test_num_segment=1,
         test_num_crop=3, spatial_size=32)], ids=["train", "spatial_crops"])
def test_video_dataset_on_native_matches_jax(monkeypatch, clips, kw):
    root, _ = clips
    monkeypatch.setenv("DYT_VIDEO_BACKEND", "native")
    lf = os.path.join(root, "list.csv")
    kw = dict(clip_len=4, canvas=32, num_classes=2, seed=3, **kw)
    tds, jds = tv.VideoDataset(root, lf, **kw), jv.VideoDataset(root, lf,
                                                                **kw)
    assert tds.backend == jds.backend == "native"
    for i in range(len(jds)):
        (tc, tl), (jc, jl) = tds[i], jds[i]
        assert tl == jl
        np.testing.assert_array_equal(tc, jc)


def test_fixture_frames_still_agree():
    """The committed clip decodes to the committed frames in both
    packages (chip_smoke.py holds the card's host to them)."""
    if not (NV.available() and JNV.available()):
        pytest.skip("libav or g++ missing: " + NV.why_unavailable())
    path = str(FIXTURES / FIXTURE_CLIP)
    assert os.path.getsize(path) <= 20 * 1024
    stored = np.load(FIXTURES / FIXTURE_FRAMES)
    n, h, w = (int(v) for v in stored["probe"])
    assert NV.probe(path) == JNV.probe(path) == (n, h, w)
    want = list(range(n))
    for dec in (NV, JNV):
        got = dec.read_frames(path, want)
        np.testing.assert_array_equal(np.stack([got[i] for i in want]),
                                      stored["frames"])


if __name__ == "__main__":
    write_video_fixtures(FIXTURES)
