"""The port's Mixup / CutMix (``data/mixup.py``) against the JAX package's,
on the CPU: the JAX function's own draws (its key splits reproduced here)
given to the port, the mixed images and soft labels compared; the
generator's draws; ``soft_cross_entropy``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_tuning_tpu.data import mixup as jmix
from dynamic_tuning_tpu_torch.data import mixup as tmix

B, H, W, C, NC = 6, 20, 24, 3, 10


def _jax_draws(rng, alpha, cutmix_alpha):
    """The draws jmix.mixup_cutmix makes from ``rng`` (its splits)."""
    k_lam, k_mode, k_box, k_pos = jax.random.split(rng, 4)
    kcy, kcx = jax.random.split(k_pos)
    return tmix.MixupDraws(
        lam=float(jax.random.beta(k_lam, alpha, alpha)),
        use_cutmix=bool(jax.random.bernoulli(k_mode)),
        lam_c=float(jax.random.beta(k_box, cutmix_alpha, cutmix_alpha)),
        cy=int(jax.random.randint(kcy, (), 0, H)),
        cx=int(jax.random.randint(kcx, (), 0, W)))


def _batch(seed):
    rs = np.random.RandomState(seed)
    return (rs.rand(B, H, W, C).astype(np.float32) * 2 - 1,
            rs.randint(0, NC, B).astype(np.int32))


SEEDS = range(8)


@pytest.mark.parametrize("alpha,cutmix_alpha,smoothing",
                         [(0.8, 1.0, 0.1), (0.4, 0.6, 0.0)])
@pytest.mark.parametrize("seed", SEEDS)
def test_mixup_cutmix_with_jax_draws_matches_jax(seed, alpha, cutmix_alpha,
                                                 smoothing):
    x, y = _batch(seed)
    rng = jax.random.PRNGKey(seed)
    want_x, want_y = jmix.mixup_cutmix(
        rng, jnp.asarray(x), jnp.asarray(y), num_classes=NC, alpha=alpha,
        cutmix_alpha=cutmix_alpha, smoothing=smoothing)
    draws = _jax_draws(rng, alpha, cutmix_alpha)
    got_x, got_y = tmix.mixup_cutmix(
        torch.from_numpy(x), torch.from_numpy(y), num_classes=NC,
        alpha=alpha, cutmix_alpha=cutmix_alpha, smoothing=smoothing,
        draws=draws)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=1e-6, atol=1e-7)


def test_seeds_cover_both_branches():
    kinds = {_jax_draws(jax.random.PRNGKey(s), 0.8, 1.0).use_cutmix
             for s in SEEDS}
    assert kinds == {True, False}


def test_cutmix_pastes_the_reversed_batch():
    x, y = _batch(1)
    draws = tmix.MixupDraws(lam=0.3, use_cutmix=True, lam_c=0.75, cy=10,
                            cx=12)
    out, soft = tmix.mixup_cutmix(torch.from_numpy(x), torch.from_numpy(y),
                                  num_classes=NC, smoothing=0.0, draws=draws)
    # cut = sqrt(0.25) = 0.5: a 10 x 12 box centred at (10, 12)
    box = (slice(None), slice(5, 15), slice(6, 18))
    np.testing.assert_array_equal(out.numpy()[box], x[::-1][box])
    outside = np.ones((H, W), bool)
    outside[5:15, 6:18] = False
    np.testing.assert_array_equal(out.numpy()[:, outside], x[:, outside])
    lam = 1 - 120 / (H * W)
    np.testing.assert_allclose(soft.numpy()[np.arange(B), y], np.where(
        y == y[::-1], 1.0, lam), rtol=1e-6)


def test_generator_draws_are_seeded():
    x, y = _batch(2)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    runs = [tmix.mixup_cutmix(xt, yt, num_classes=NC,
                              generator=torch.Generator().manual_seed(s))
            for s in (4, 4, 5)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert not torch.equal(runs[0][1], runs[2][1])
    for _, soft in runs:
        np.testing.assert_allclose(soft.sum(-1).numpy(), 1.0, rtol=1e-6)
    d = tmix.sample_draws(torch.Generator().manual_seed(9), H, W)
    assert 0 <= d.cy < H and 0 <= d.cx < W and 0 < d.lam < 1
    with pytest.raises(ValueError, match="generator"):
        tmix.mixup_cutmix(xt, yt, num_classes=NC)


def test_soft_cross_entropy_matches_jax():
    rs = np.random.RandomState(3)
    logits = rs.randn(B, NC).astype(np.float32) * 3
    soft = rs.dirichlet(np.ones(NC), B).astype(np.float32)
    want = jmix.soft_cross_entropy(jnp.asarray(logits), jnp.asarray(soft))
    got = tmix.soft_cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(soft))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
