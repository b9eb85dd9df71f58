"""The PyTorch port's ops against the JAX package's, on the CPU.

The port's K2/K3 wrappers take their plain versions for CPU tensors; the JAX
side runs its Pallas kernels in interpret mode (``interpret=True``), so the
port is held against the TPU kernels' numerics, not the XLA branch.
Inputs are made with numpy from a seed and handed to both.

Tolerances: fp32 at rtol = atol = 1e-5 (summation order only).  bf16 at one
bf16 ulp of the output's magnitude (2**-7 relative): both sides round at the
same points, so only a last-bit difference of an fp32 sum that sits on a
rounding boundary may show.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_tuning_tpu.ops import dispatch as jdispatch
from dynamic_tuning_tpu.ops import gumbel as jgumbel
from dynamic_tuning_tpu.ops import mha_serving as jms
from dynamic_tuning_tpu_torch.ops import dispatch as tdispatch
from dynamic_tuning_tpu_torch.ops import gumbel as tgumbel
from dynamic_tuning_tpu_torch.ops import mha_serving as tms

B, N, C, H, FFN = 2, 19, 128, 2, 16
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _weights(seed=0, qk_scale=1.0):
    rs = np.random.RandomState(seed)

    def f(*s, sc=1.0):
        return (rs.randn(*s) * sc).astype(np.float32)

    w = dict(x=f(B, N, C), g=1 + f(C, sc=0.1), b=f(C, sc=0.1),
             wqkv=f(C, 3 * C, sc=0.05), bqkv=f(3 * C, sc=0.05),
             wproj=f(C, C, sc=0.05), bproj=f(C, sc=0.05),
             wd=f(C, FFN, sc=0.05), bd=f(FFN, sc=0.05),
             wu=f(FFN, C, sc=0.05), bu=f(C, sc=0.05),
             asc=np.array([0.1], np.float32), wsel=f(C, 1, sc=0.1),
             bsel=f(1, sc=0.1))
    w["wqkv"][:, :2 * C] *= qk_scale
    return w


def _jax_args(w, jdt):
    """JAX kernels: Dense kernels [in, out] in the compute dtype."""
    c = lambda a: jnp.asarray(a).astype(jdt)
    return dict(x=c(w["x"]), sub=(w["g"], w["b"], c(w["wqkv"]), w["bqkv"],
                                  c(w["wproj"]), w["bproj"]),
                ad=(c(w["wd"]), w["bd"], c(w["wu"]), w["bu"], w["asc"],
                    w["wsel"], w["bsel"]))


def _torch_args(w, tdt):
    """Port wrappers: Linear weights [out, in] in the compute dtype."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    c = lambda a: t(a.T).to(tdt)
    return dict(x=t(w["x"]).to(tdt),
                sub=(t(w["g"]), t(w["b"]), c(w["wqkv"]), t(w["bqkv"]),
                     c(w["wproj"]), t(w["bproj"])),
                ad=(c(w["wd"]), t(w["bd"]), c(w["wu"]), t(w["bu"]),
                    t(w["asc"]), t(w["wsel"].T), t(w["bsel"])))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype):
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = 2.0 ** -7 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=ulp)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_sublayer_matches_jax_kernel(dtype):
    jdt, tdt = DTYPES[dtype]
    w = _weights()
    ja, ta = _jax_args(w, jdt), _torch_args(w, tdt)
    want = jms.attention_sublayer_serving(ja["x"], *ja["sub"], heads=H,
                                          interpret=True)
    got = tms.attention_sublayer_serving(ta["x"], *ta["sub"], heads=H)
    assert got.dtype == tdt and got.shape == (B, N, C)
    _close(got, _np(want), dtype)


@pytest.mark.parametrize("with_select", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dyt_prologue_matches_jax_kernel(dtype, with_select):
    jdt, tdt = DTYPES[dtype]
    w = _weights(seed=1)
    ja, ta = _jax_args(w, jdt), _torch_args(w, tdt)
    want = jms.dyt_prologue_serving(ja["x"], *ja["sub"], *ja["ad"], heads=H,
                                    with_select=with_select, interpret=True)
    got = tms.dyt_prologue_serving(ta["x"], *ta["sub"], *ta["ad"], heads=H,
                                   with_select=with_select)
    assert len(got) == len(want) == (3 if with_select else 2)
    _close(got[0], _np(want[0]), dtype)
    _close(got[1], _np(want[1]), dtype)
    if with_select:
        # router logits are fp32 from the fp32 x_mid on both sides
        assert got[2].dtype == torch.float32 and got[2].shape == (B, N, 1)
        np.testing.assert_allclose(got[2].numpy(), _np(want[2]),
                                   rtol=1e-5, atol=1e-5)


def test_attn_core_matches_jax_fused_core():
    """The shared core against K1 (same clamped no-max softmax, l summed
    over the fp32 e) on a raw [B, N, 3C] qkv buffer."""
    rs = np.random.RandomState(2)
    qkv = rs.randn(B, N, 3 * C).astype(np.float32)
    want = jms.mha_serving_fused(jnp.asarray(qkv), heads=H, interpret=True)
    got = tms.attn_core_pairs(torch.from_numpy(qkv), heads=H)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_large_scores_are_clamped_and_finite():
    """Scores far past the clamp (|s| >> 80) stay finite and still match the
    TPU kernel.  Tolerance 1e-4: at |s| ~ 1e3 an fp32 score carries an
    absolute rounding error ~1e-4, which exp turns into a relative one."""
    w = _weights(seed=3, qk_scale=40.0)
    ja, ta = _jax_args(w, jnp.float32), _torch_args(w, torch.float32)
    q = torch.from_numpy(w["x"]) @ torch.from_numpy(w["wqkv"][:, :C])
    assert q.abs().max() > 50          # scores reach well past 80
    want = jms.attention_sublayer_serving(ja["x"], *ja["sub"], heads=H,
                                          interpret=True)
    got = tms.attention_sublayer_serving(ta["x"], *ta["sub"], heads=H)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)


def test_layernorm_f32_matches_jax():
    rs = np.random.RandomState(4)
    x = (rs.randn(5, C) * 3 + 1).astype(np.float32)
    g, b = rs.randn(C).astype(np.float32), rs.randn(C).astype(np.float32)
    want = jms.layernorm_f32(jnp.asarray(x), g, b)
    got = tms.layernorm_f32(torch.from_numpy(x), torch.from_numpy(g),
                            torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_other_devices():
    """A non-CPU tensor never reaches the plain version: the kernel path
    takes CUDA tensors and raises on anything else."""
    ta = _torch_args(_weights(), torch.bfloat16)
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="CPU tensors"):
        tms.attention_sublayer_serving(meta(ta["x"]),
                                       *map(meta, ta["sub"]), heads=H)


# --- dispatch ----------------------------------------------------------------

@pytest.mark.parametrize("tokens,ratio", [(196, 0.5), (196, 0.25), (16, 0.5),
                                          (196, 1.0), (48, 0.7)])
def test_capacity_matches_jax(tokens, ratio):
    assert (tdispatch.capacity_for(tokens, ratio)
            == jdispatch.capacity_for(tokens, ratio))
    assert tdispatch.capacity_for(196, 0.5) == 99


def _tied_scores(seed=5, n=17):
    """Scores with exact ties straddling the capacity boundary (saturated
    sigmoids), CLS forced to +inf."""
    rs = np.random.RandomState(seed)
    s = rs.uniform(0.0, 1.0, (3, n)).astype(np.float32)
    s[:, 3:11] = 1.0                    # 8 tied saturated scores
    s[1, 5:9] = 0.25                    # ties below the threshold too
    s[1, 12:16] = 0.25
    s[:, 0] = np.inf
    return s


def test_select_topk_breaks_ties_like_jax():
    s = _tied_scores()
    K = 6                               # the boundary cuts the tied run
    jv, ji = jax.lax.top_k(jnp.asarray(s), K)
    idx, keep = tdispatch.select_topk(torch.from_numpy(s), K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jv) > 0.5)


@pytest.mark.parametrize("K", [6, 9, 12])
def test_dispatch_mlp_matches_onehot_dispatch(K):
    s = _tied_scores(seed=6)
    rs = np.random.RandomState(7)
    x = rs.randn(3, s.shape[1], 8).astype(np.float32)
    want, want_gate = jdispatch.onehot_dispatch_mlp(
        jnp.asarray(x), jnp.asarray(s), K, lambda r: r * 3.0 - 1.0, 0.5)
    got, got_gate = tdispatch.dispatch_mlp(
        torch.from_numpy(x), torch.from_numpy(s), K,
        lambda r: r * 3.0 - 1.0, 0.5)
    np.testing.assert_array_equal(got_gate.numpy(), np.asarray(want_gate))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- gumbel ------------------------------------------------------------------

def test_gumbel_eval_gate_matches_jax():
    rs = np.random.RandomState(8)
    logits = (rs.randn(4, 16, 1) * 3).astype(np.float32)
    for hard in (True, False):
        want = jgumbel.gumbel_sigmoid(jnp.asarray(logits), None, hard=hard,
                                      training=False)
        got = tgumbel.gumbel_sigmoid(torch.from_numpy(logits), hard=hard,
                                     training=False)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gumbel_train_form_with_injected_noise(monkeypatch):
    rs = np.random.RandomState(9)
    logits = rs.randn(4, 16, 1).astype(np.float32)
    noise = rs.logistic(size=logits.shape).astype(np.float32)
    monkeypatch.setattr(jax.random, "logistic",
                        lambda key, shape, dtype: jnp.asarray(noise))
    want = jgumbel.gumbel_sigmoid(jnp.asarray(logits), jax.random.PRNGKey(0),
                                  tau=5.0, hard=True)
    got = tgumbel.gumbel_sigmoid(torch.from_numpy(logits), tau=5.0,
                                 hard=True, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_gumbel_train_form_uses_the_generator_only():
    logits = torch.zeros(2000)
    a = tgumbel.gumbel_sigmoid(logits, generator=torch.Generator()
                               .manual_seed(3))
    b = tgumbel.gumbel_sigmoid(logits, generator=torch.Generator()
                               .manual_seed(3))
    assert torch.equal(a, b)
    # zero logits + logistic noise: the soft gate is centred on 0.5
    assert abs(a.mean().item() - 0.5) < 0.02
    with pytest.raises(ValueError):
        tgumbel.gumbel_sigmoid(logits)
