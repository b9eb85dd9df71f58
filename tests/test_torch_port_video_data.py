"""The port's video data against the JAX package's, on the CPU.

* The frame samplers (random segment, TSN, the eval views) given the same
  ``RandomState`` seeds, ``_bicubic_resize`` / ``_resize_short_side`` (the
  JAX side on its numpy path, ``DYT_NATIVE_RESIZE=0``), the synthetic
  datasets, ``VideoDataset`` on mp4 files written with OpenCV (train
  clips, temporal views, spatial crops; both packages decode with
  OpenCV), the TSN eval refusal, and ``utils/multiview``: exact.
* The clip transforms given the JAX package's own draws (each reproduced
  with the same ``jax.random`` calls the JAX transform makes), in float32
  on 0-255 clips: scale-jitter crop, uniform crop at ``spatial_idx`` 0/1/2
  on wide and tall clips, random resized crop, flip, colour and lighting
  jitter, normalize and the eval batch.  Both sides build the same
  float32 weight matrices and sum the two products in other orders:
  within 1e-3 (out of 255) everywhere.  The 10-try crop box from the JAX
  sampler's uniforms: identical; the port's sampler by its statistics
  against the JAX sampler's.
* RandAugment: the ops given a magnitude, and whole draws, against JAX on
  uint8 frames: within one count.
"""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_tuning_tpu.data import randaugment as jra
from dynamic_tuning_tpu.data import transforms as jtr
from dynamic_tuning_tpu.data import video as jv
from dynamic_tuning_tpu.data import video_transforms as jvt
from dynamic_tuning_tpu.utils import multiview as jmv
from dynamic_tuning_tpu_torch.data import randaugment as tra
from dynamic_tuning_tpu_torch.data import transforms as ttr
from dynamic_tuning_tpu_torch.data import video as tv
from dynamic_tuning_tpu_torch.data import video_transforms as tvt
from dynamic_tuning_tpu_torch.utils import multiview as tmv

TOL = 1e-3      # float32 on 0-255 values, products summed in other orders


def _clip(seed, shape=(3, 40, 56, 3)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


# --- samplers, resize, datasets ----------------------------------------------

@pytest.mark.parametrize("num_frames,clip_len,rate", [
    (300, 8, 16), (100, 8, 16), (20, 8, 4), (8, 8, 2), (5, 4, 3)])
def test_samplers_match_jax(num_frames, clip_len, rate):
    for seed in range(5):
        np.testing.assert_array_equal(
            tv.sample_indices_random(num_frames, clip_len, rate,
                                     np.random.RandomState(seed)),
            jv.sample_indices_random(num_frames, clip_len, rate,
                                     np.random.RandomState(seed)))
        np.testing.assert_array_equal(
            tv.sample_indices_tsn(num_frames, clip_len,
                                  np.random.RandomState(seed)),
            jv.sample_indices_tsn(num_frames, clip_len,
                                  np.random.RandomState(seed)))
    np.testing.assert_array_equal(tv.sample_indices_tsn(num_frames,
                                                        clip_len, None),
                                  jv.sample_indices_tsn(num_frames,
                                                        clip_len, None))
    for segs, r in itertools.product((1, 2, 3), (rate, 0)):
        for i in range(segs):
            np.testing.assert_array_equal(
                tv.sample_indices_test(num_frames, clip_len, r, i, segs),
                jv.sample_indices_test(num_frames, clip_len, r, i, segs))


@pytest.mark.parametrize("shape,size", [((48, 64), (40, 30)),
                                        ((30, 20), (45, 70)),
                                        ((57, 57), (57, 57))])
def test_bicubic_resize_matches_jax(monkeypatch, shape, size):
    monkeypatch.setenv("DYT_NATIVE_RESIZE", "0")
    img = _clip(1, shape + (3,))
    np.testing.assert_array_equal(tv._bicubic_resize(img, *size),
                                  jv._bicubic_resize(img, *size))
    np.testing.assert_array_equal(tv._tb_matrix(shape[0], size[1]),
                                  jv._tb_matrix(shape[0], size[1]))
    np.testing.assert_array_equal(tv._resize_short_side(img, 32),
                                  jv._resize_short_side(img, 32))


def test_synthetic_datasets_match_jax():
    ttrain, tval, tnc = tv.build_video_dataset("synthetic", "", clip_len=2,
                                               test_num_segment=3)
    jtrain, jval, jnc = jv.build_video_dataset("synthetic", "", clip_len=2,
                                               test_num_segment=3)
    assert (len(ttrain), len(tval), tnc) == (len(jtrain), len(jval), jnc)
    for i in (0, 5, 255):
        for a, b in zip(ttrain[i], jtrain[i]):
            np.testing.assert_array_equal(a, b)
    for i in (0, 63):
        for a, b in zip(tval[i], jval[i]):
            np.testing.assert_array_equal(a, b)
    assert tval[0][0].shape == (3, 2, 256, 256, 3)


@pytest.fixture(scope="module")
def video_root(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("videos")
    lines = []
    for i, (w, h) in enumerate([(64, 48), (40, 56)]):
        path = str(d / f"clip{i}.mp4")
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (w, h))
        assert wr.isOpened()
        for t in range(30):
            grad = np.linspace(0, 200, w, dtype=np.uint8)[None, :, None]
            frame = np.broadcast_to(grad, (h, w, 3)).copy()
            frame += np.uint8((i * 60 + t) % 56)
            wr.write(frame)
        wr.release()
        lines.append(f"clip{i}.mp4 {i}")
    (d / "list.csv").write_text("\n".join(lines) + "\n")
    return str(d)


@pytest.mark.parametrize("kw", [
    dict(sampling_rate=4),
    dict(sampling_rate=0),
    dict(sampling_rate=4, test_mode=True, test_num_segment=3),
    dict(sampling_rate=0, test_mode=True, test_num_segment=1,
         test_num_crop=3, spatial_size=32)],
    ids=["train", "train_tsn", "temporal_views", "spatial_crops"])
def test_video_dataset_matches_jax(monkeypatch, video_root, kw):
    monkeypatch.setenv("DYT_VIDEO_BACKEND", "cv2")
    monkeypatch.setenv("DYT_NATIVE_RESIZE", "0")
    lf = os.path.join(video_root, "list.csv")
    kw = dict(clip_len=4, canvas=32, num_classes=2, seed=3, **kw)
    tds, jds = tv.VideoDataset(video_root, lf, **kw), jv.VideoDataset(
        video_root, lf, **kw)
    assert tds.backend == jds.backend == "cv2"
    for epoch in (0, 1):
        tds.set_epoch(epoch)
        jds.set_epoch(epoch)
        for i in range(len(jds)):
            (tc, tl), (jc, jl) = tds[i], jds[i]
            assert tl == jl and tc.dtype == np.uint8
            np.testing.assert_array_equal(tc, jc)


def test_tsn_eval_multi_segment_fails_loud(tmp_path):
    lf = tmp_path / "list.txt"
    lf.write_text("a.mp4 0\n")
    with pytest.raises(ValueError, match="test_num_segment"):
        tv.VideoDataset(str(tmp_path), str(lf), sampling_rate=0,
                        test_mode=True, test_num_segment=3)
    tv.VideoDataset(str(tmp_path), str(lf), sampling_rate=16,
                    test_mode=True, test_num_segment=3)


def test_decode_backend_order(monkeypatch):
    monkeypatch.delenv("DYT_VIDEO_BACKEND", raising=False)
    monkeypatch.setattr(tv, "BACKENDS", ("no_such_backend",))
    with pytest.raises(ImportError, match="no video decode backend"):
        tv.decode_backend()
    monkeypatch.setenv("DYT_VIDEO_BACKEND", "no_such_backend")
    with pytest.raises(ImportError):
        tv.decode_backend()


def test_multiview_save_merge_matches_jax(tmp_path):
    for mod, d in ((tmv, tmp_path / "t"), (jmv, tmp_path / "j")):
        r = np.random.RandomState(0)
        for rank in (0, 1):
            for batch in range(2):
                ids = np.repeat(np.arange(4) * 2 + rank + 8 * batch, 3)
                mod.save_view_outputs(str(d), rank, ids,
                                      r.randn(12, 7).astype(np.float32),
                                      np.repeat(r.randint(0, 7, 4), 3),
                                      append=batch > 0)
    for name in ("views_rank0.npz", "views_rank1.npz"):
        a, b = np.load(tmp_path / "t" / name), np.load(tmp_path / "j" / name)
        for k in ("ids", "logits", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    assert tmv.merge_view_outputs(str(tmp_path / "t")) == \
        jmv.merge_view_outputs(str(tmp_path / "j"))


# --- clip transforms given the same draws ------------------------------------

def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("shape", [(3, 40, 56, 3), (3, 56, 40, 3)],
                         ids=["wide", "tall"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scale_jitter_crop_matches_jax(shape, seed):
    clip = _clip(seed, shape)
    rng = jax.random.PRNGKey(seed)
    want = jvt.clip_scale_jitter_crop(rng, jnp.asarray(clip), min_size=32,
                                      max_size=48, crop=24)
    k_scale, k_top, k_left = jax.random.split(rng, 3)
    size = jax.random.uniform(k_scale, minval=32.0, maxval=48.0)
    got = tvt.clip_scale_jitter_crop(
        _t(clip)[None], _t(size)[None], _t(jax.random.uniform(k_top))[None],
        _t(jax.random.uniform(k_left))[None], crop=24)[0]
    _close(got, want)


@pytest.mark.parametrize("shape", [(2, 40, 56, 3), (2, 56, 40, 3)],
                         ids=["wide", "tall"])
@pytest.mark.parametrize("spatial_idx", [0, 1, 2])
@pytest.mark.parametrize("num_crops", [1, 3])
def test_uniform_crop_matches_jax(shape, spatial_idx, num_crops):
    clip = _clip(4, shape)
    kw = dict(resize_to=34, crop=30, spatial_idx=spatial_idx,
              num_crops=num_crops)
    _close(tvt.clip_uniform_crop(_t(clip)[None], **kw)[0],
           jvt.clip_uniform_crop(jnp.asarray(clip), **kw))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_resized_crop_matches_jax(seed):
    clip = _clip(seed, (2, 40, 56, 3))
    rng = jax.random.PRNGKey(seed)
    want = jvt.clip_random_resized_crop(rng, jnp.asarray(clip), crop=24)
    box = jvt._sample_crop_box_10try(rng, 40, 56, (0.08, 1.0),
                                     (3 / 4, 4 / 3))
    got = tvt.clip_random_resized_crop(
        _t(clip)[None], *(_t(v)[None] for v in box), crop=24)[0]
    _close(got, want)


@pytest.mark.parametrize("hw", [(40, 56), (56, 40), (8, 200)])
@pytest.mark.parametrize("scale", [(0.08, 1.0), (0.9, 1.0)])
def test_crop_box_from_jax_uniforms_is_jax_box(hw, scale):
    """The port's box selection from the JAX sampler's own [0, 1) draws
    (including the fallback: an 8x200 canvas fits no 3/4-4/3 box of a
    tenth of its area or more)."""
    ratio = (3 / 4, 4 / 3)
    for seed in range(20):
        rng = jax.random.PRNGKey(seed)
        want = jvt._sample_crop_box_10try(rng, *hw, scale, ratio)
        k_area, k_ratio, k_top, k_left = jax.random.split(rng, 4)
        got = tvt.crop_box_10try(
            _t(jax.random.uniform(k_area, (10,)))[None],
            _t(jax.random.uniform(k_ratio, (10,)))[None],
            _t(jax.random.uniform(k_top))[None],
            _t(jax.random.uniform(k_left))[None], *hw, scale, ratio)
        assert [float(g[0]) for g in got] == [float(w) for w in want]


def test_crop_box_sampler_statistics():
    """The port's host sampler against the JAX sampler over 2000 draws
    each: the same fallback share, area and aspect means, positions in
    range."""
    h, w, n = 40, 56, 2000
    top, left, ch, cw = tvt._sample_crop_box_10try(
        torch.Generator().manual_seed(0), n, h, w)
    jbox = jax.vmap(lambda k: jnp.stack(jvt._sample_crop_box_10try(
        k, h, w, (0.08, 1.0), (3 / 4, 4 / 3))))(
        jax.random.split(jax.random.PRNGKey(0), n))
    jtop, jleft, jch, jcw = np.asarray(jbox).T
    assert ((top >= 0) & (top + ch <= h) & (left >= 0)
            & (left + cw <= w)).all()
    top, left, ch, cw = (t.numpy() for t in (top, left, ch, cw))
    area, jarea = ch * cw / (h * w), jch * jcw / (h * w)
    assert abs(area.mean() - jarea.mean()) < 0.03
    assert abs(np.log(cw / ch).mean() - np.log(jcw / jch).mean()) < 0.03
    assert abs((top / (h - ch + 1)).mean()
               - (jtop / (h - jch + 1)).mean()) < 0.03
    assert abs((left / (w - cw + 1)).mean()
               - (jleft / (w - jcw + 1)).mean()) < 0.03
    assert area.min() >= 0.05 and area.max() <= 1.0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_hflip_matches_jax(seed):
    clip = _clip(seed, (2, 8, 10, 3))
    rng = jax.random.PRNGKey(seed)
    flip = bool(jax.random.bernoulli(rng))
    np.testing.assert_array_equal(
        tvt.clip_hflip(_t(clip)[None], torch.tensor([flip]))[0].numpy(),
        np.asarray(jvt.clip_hflip(rng, jnp.asarray(clip))))


@pytest.mark.parametrize("strengths", [(0.4, 0.4, 0.4), (0.0, 0.3, 0.0),
                                       (0.2, 0.0, 0.5)])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_color_jitter_matches_jax(strengths, seed):
    clip = _clip(seed, (2, 6, 7, 3)).astype(np.float32)
    b, c, s = strengths
    rng = jax.random.PRNGKey(seed)
    want = jvt.clip_color_jitter(rng, jnp.asarray(clip), brightness=b,
                                 contrast=c, saturation=s)
    k_perm, k_b, k_c, k_s = jax.random.split(rng, 4)
    alphas = [1.0 + jax.random.uniform(k, minval=-v, maxval=v)
              for k, v in ((k_b, b), (k_c, c), (k_s, s))]
    order = jax.random.randint(k_perm, (), 0, 6)
    got = tvt.clip_color_jitter(
        _t(clip)[None], _t(jnp.stack(alphas))[None],
        torch.tensor([int(order)]), brightness=b, contrast=c,
        saturation=s)[0]
    _close(got, want)


def test_lighting_jitter_matches_jax():
    clip = _clip(0, (2, 6, 7, 3)).astype(np.float32)
    eigval = [0.2175, 0.0188, 0.0045]
    eigvec = [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
              [-0.5836, -0.6948, 0.4203]]
    rng = jax.random.PRNGKey(3)
    want = jvt.clip_lighting_jitter(rng, jnp.asarray(clip), alphastd=0.1,
                                    eigval=eigval, eigvec=eigvec)
    alpha = 0.1 * jax.random.normal(rng, (1, 3))
    got = tvt.clip_lighting_jitter(_t(clip)[None], _t(alpha), eigval=eigval,
                                   eigvec=eigvec)[0]
    _close(got, want)
    assert torch.equal(tvt.clip_lighting_jitter(_t(clip), None,
                                                eigval=eigval,
                                                eigvec=eigvec), _t(clip))


@pytest.mark.parametrize("inception", [False, True])
def test_eval_batch_matches_jax(inception):
    """The eval batch: the centre crop of the short side at min_size, and
    the pre-cropped views (normalize only); normalize alone."""
    clips = _clip(5, (2, 2, 40, 56, 3))
    for kw in (dict(crop=30, min_size=34), dict(crop=40, pre_cropped=True)):
        want = jvt.augment_clip_batch(jax.random.PRNGKey(0),
                                      jnp.asarray(clips), train=False,
                                      inception=inception, **kw)
        got = tvt.augment_clip_batch(None, _t(clips), train=False,
                                     inception=inception, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL / 50)
    np.testing.assert_array_equal(
        ttr.normalize(_t(clips), inception).numpy(),
        np.asarray(jtr.normalize(jnp.asarray(clips), inception)))


@pytest.mark.parametrize("resize_type,randaug", [
    ("random_resized_crop", None), ("random_short_side_scale_jitter", None),
    ("random_resized_crop", "rand-m7-n4-mstd0.5-inc1")],
    ids=["rrc", "jitter", "ssv2_randaug"])
def test_train_batch_is_a_function_of_its_generator(resize_type, randaug):
    """The train batch draws only from its generator: the same seed gives
    the same batch, another seed another; one box (and one RandAugment
    draw) per clip, so identical frames stay identical."""
    frame = _clip(6, (1, 1, 40, 56, 3))
    clips = torch.from_numpy(np.tile(frame, (4, 3, 1, 1, 1)))
    kw = dict(crop=24, min_size=30, max_size=40, resize_type=resize_type,
              randaug=randaug)
    a = tvt.augment_clip_batch(torch.Generator().manual_seed(1), clips, **kw)
    b = tvt.augment_clip_batch(torch.Generator().manual_seed(1), clips, **kw)
    c = tvt.augment_clip_batch(torch.Generator().manual_seed(2), clips, **kw)
    assert a.shape == (4, 3, 24, 24, 3) and torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.equal(a[:, 0], a[:, 2])
    with pytest.raises(ValueError, match="torch.Generator"):
        tvt.augment_clip_batch(None, clips, **kw)


# --- RandAugment -------------------------------------------------------------

RA_OPS = [name for name, _ in jra.OPS]


@pytest.mark.parametrize("name", RA_OPS)
@pytest.mark.parametrize("level", [3.0, 7.0, 10.0])
def test_rand_augment_op_matches_jax(name, level):
    """Each op at a level, both signs, on a batch of frames: within one
    count (the bicubic warp's taps and the blends sum in float32)."""
    frames = _clip(7, (2, 24, 28, 3)).astype(np.float32)
    for sign in (False, True):
        for inc in (True, False):
            v = tra.op_value(name, torch.tensor(level), sign, 28, inc)
            jvv = jra._magnitude(name, jnp.float32(level),
                                 _key_with_bernoulli(sign), 28, inc)
            assert float(v) == pytest.approx(float(jvv), rel=1e-6)
            fn = dict(jra.OPS)[name]
            want = np.stack([np.asarray(
                fn(jnp.asarray(f), jvv, 3) if name in jra._GEOMETRIC
                else fn(jnp.asarray(f), jvv)) for f in frames])
            got = tra.apply_op(name, _t(frames), v)
            err = np.abs(np.clip(got.numpy(), 0, 255)
                         - np.clip(want, 0, 255))
            assert err.max() <= 1.0 + 1e-3, (name, sign, inc, err.max())


def _key_with_bernoulli(value: bool):
    """A PRNG key whose ``jax.random.bernoulli`` draw is ``value``."""
    for seed in range(100):
        k = jax.random.PRNGKey(seed)
        if bool(jax.random.bernoulli(k)) == value:
            return k
    raise AssertionError


def test_rand_augment_parse_config_matches_jax():
    for cfg in ("rand-m7-n4-mstd0.5-inc1", "rand-m9-n2", "rand-m5-inc0"):
        assert tra.parse_config(cfg) == jra.parse_config(cfg)
    with pytest.raises(NotImplementedError):
        tra.parse_config("rand-m9-w0")


@jax.jit
def _jax_rand_augment(rng, frames):
    """The JAX package's SSv2 RandAugment of one clip's frames (one compile
    for every seed)."""
    m, n, mstd, inc = jra.parse_config("rand-m7-n4-mstd0.5-inc1")
    return jax.vmap(lambda f: jra.rand_augment(
        rng, f, magnitude=m, num_ops=n, mstd=mstd, interpolation="bicubic",
        increasing=inc))(frames)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
def test_rand_augment_matches_jax_given_its_draws(seed):
    """rand_augment on a clip's frames with the JAX function's own draws
    (op, level noise, sign, apply coin per op): uint8 within one count of
    the JAX op chain vmapped over the frames, as the SSv2 recipe runs it
    (bicubic, rand-m7-n4-mstd0.5-inc1)."""
    frames = _clip(seed, (2, 24, 28, 3))
    rng = jax.random.PRNGKey(seed)
    m, n, mstd, inc = jra.parse_config("rand-m7-n4-mstd0.5-inc1")
    want = _jax_rand_augment(rng, jnp.asarray(frames))
    draws = {k: [] for k in ("op", "normal", "sign", "u_prob")}
    r = rng
    for _ in range(n):
        r, r_op, r_mag, r_sign, r_prob = jax.random.split(r, 5)
        draws["op"].append(int(jax.random.randint(r_op, (), 0, len(RA_OPS))))
        draws["normal"].append(float(jax.random.normal(r_mag)))
        draws["sign"].append(bool(jax.random.bernoulli(r_sign)))
        draws["u_prob"].append(float(jax.random.uniform(r_prob)))
    got = tra.rand_augment(_t(frames).float(), draws, magnitude=m,
                           mstd=mstd, increasing=inc)
    err = np.abs(got.to(torch.uint8).numpy().astype(int)
                 - np.asarray(want).astype(np.uint8).astype(int))
    assert err.max() <= 1, err.max()


def test_rand_augment_clips_same_ops_on_every_frame():
    frame = _clip(8, (1, 1, 24, 28, 3))
    clips = torch.from_numpy(np.tile(frame, (3, 4, 1, 1, 1)))
    out = tra.rand_augment_clips(torch.Generator().manual_seed(0), clips,
                                 "rand-m7-n4-mstd0.5-inc1")
    assert out.dtype == torch.uint8 and out.shape == clips.shape
    assert torch.equal(out[:, 0], out[:, 3])
    again = tra.rand_augment_clips(torch.Generator().manual_seed(0), clips,
                                   "rand-m7-n4-mstd0.5-inc1")
    assert torch.equal(out, again)
