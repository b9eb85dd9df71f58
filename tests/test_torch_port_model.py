"""The PyTorch port's ViT against the JAX package's, on the CPU.

Both models get the same weights: a seeded timm-named state dict
(tests/torch_oracle.py::make_vit_state_dict, router head scaled so hard
gates have margin) goes into the JAX model through import_pretrained, and
the JAX param tree crosses to the port through the weight bridge
(checkpoint.from_flax_params + load_state_dict(strict=True)).  The JAX model
runs with DYT_FUSED_ATTN=interpret, so its blocks take the Pallas kernels in
interpret mode, as the port's blocks take K2/K3 (plain versions on the CPU).
Without that JAX on the CPU would take its unfused XLA branch, whose softmax
sums differ.

Size: the golden-fixture configuration (embed 128, 2 heads of 64, depth 2,
64x64 images of 16x16 patches -> 17 tokens, adapter width 8).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_tuning_tpu.config import ModelConfig, SelectConfig, TuningConfig
from dynamic_tuning_tpu.models.vit import VisionTransformer as JaxViT
from dynamic_tuning_tpu.train.checkpoint import import_pretrained
from dynamic_tuning_tpu_torch.checkpoint import (from_flax_params,
                                                 load_timm_state_dict)
from dynamic_tuning_tpu_torch.models.vit import VisionTransformer
from torch_oracle import make_vit_state_dict

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "golden_vit.npz")
DIM, DEPTH, HEADS, FFN, IMG, PATCH, CLASSES = 128, 2, 2, 8, 64, 16, 10
MODES = {"mask": {}, "dispatch": {"dispatch": True},
         "complete_model": {"complete_model": True}}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfg(dtype: str, plain: bool, **model):
    model = {"num_heads": HEADS, **model}
    mc = ModelConfig(img_size=IMG, patch_size=PATCH, embed_dim=DIM,
                     depth=DEPTH, num_classes=CLASSES, residual_dtype=dtype,
                     **model)
    tuning = TuningConfig(ffn_num=FFN, d_model=DIM, ffn_adapt=not plain)
    sel = SelectConfig(open=not plain, token_target_ratio=0.5)
    return mc, tuning, sel


def _pair(monkeypatch, dtype="float32", plain=False, seed=0, **model):
    """(jax model, jax params, port model, input) with identical weights."""
    monkeypatch.setenv("DYT_FUSED_ATTN", "interpret")
    mc, tuning, sel = _cfg(dtype, plain, **model)
    rs = np.random.RandomState(seed)
    sd = make_vit_state_dict(rs, depth=DEPTH, dim=DIM, ffn=FFN,
                             classes=CLASSES, img=IMG, patch=PATCH)
    x = rs.randn(3, IMG, IMG, 3).astype(np.float32)
    jm = JaxViT(mc, tuning=tuning, select=sel, dtype=JDT[dtype])
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]
    params, _ = import_pretrained(params, sd, logger=_Quiet())
    tm = VisionTransformer(mc, tuning=tuning, select=sel, dtype=TDT[dtype])
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        from_flax_params(params).items()}, strict=True)
    return jm, params, tm, x


class _Quiet:
    def info(self, *a):
        pass


def _run_both(jm, params, tm, x, kwargs):
    jl, jaux = jm.apply({"params": params}, jnp.asarray(x), **kwargs)
    tl, taux = tm(torch.from_numpy(x), **kwargs)
    return jl, jaux, tl, taux


@pytest.mark.parametrize("mode", list(MODES))
def test_dyt_model_matches_jax_fp32(monkeypatch, mode):
    jm, params, tm, x = _pair(monkeypatch)
    jl, jaux, tl, taux = _run_both(jm, params, tm, x, MODES[mode])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    if mode == "complete_model":
        assert taux["token_select"] is None and jaux["token_select"] is None
        return
    ts = taux["token_select"]
    assert ts.shape == (3, DEPTH, (IMG // PATCH) ** 2, 1)
    # every gate decision identical
    np.testing.assert_array_equal(ts.numpy(),
                                  np.asarray(jaux["token_select"]))
    # router logits reach |l| ~ 50 (scaled head): 1e-5 of the largest
    want_tok = np.asarray(jaux["token_logits"])
    np.testing.assert_allclose(taux["token_logits"].numpy(), want_tok,
                               rtol=0, atol=1e-5 * np.abs(want_tok).max())
    if mode == "dispatch":
        # capacity K = 9 of 17 slots: the dispatch really cuts tokens
        assert ts.sum(dim=2).max() <= 8


def test_plain_model_matches_jax_fp32(monkeypatch):
    jm, params, tm, x = _pair(monkeypatch, plain=True)
    jl, jaux, tl, taux = _run_both(jm, params, tm, x, {})
    assert taux["token_select"] is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("model", [dict(num_heads=4),
                                   dict(attn_drop_rate=0.1)],
                         ids=["head_dim_32", "attn_drop"])
def test_module_path_matches_jax_fp32(monkeypatch, mode, model):
    """Blocks the fused kernels do not take (head_dim 32; attention dropout,
    the identity in eval) run the module path -- Attention's serving clamp
    or softmax branch, TokenSelect, Adapter -- on both sides."""
    jm, params, tm, x = _pair(monkeypatch, **model)
    jl, jaux, tl, taux = _run_both(jm, params, tm, x, MODES[mode])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    if mode != "complete_model":
        np.testing.assert_array_equal(taux["token_select"].numpy(),
                                      np.asarray(jaux["token_select"]))


@pytest.mark.parametrize("mode", ["mask", "dispatch", "plain"])
def test_model_matches_jax_bf16(monkeypatch, mode):
    """bf16 compute and residual stream.  Both sides round at the same
    points, but the dense layers outside the kernels (patch conv, MLP, GELU)
    round their fp32 accumulations through different library code, so values
    differ by a bf16 ulp (2**-8 relative) per rounding; over two blocks the
    logits agree to 2% of their largest magnitude.  Gate decisions may only
    flip where a router logit is within that noise of 0."""
    jm, params, tm, x = _pair(monkeypatch, dtype="bfloat16",
                              plain=mode == "plain")
    kwargs = {"dispatch": True} if mode == "dispatch" else {}
    jl, jaux, tl, taux = _run_both(jm, params, tm, x, kwargs)
    want = np.asarray(jl.astype(jnp.float32))
    np.testing.assert_allclose(tl.float().numpy(), want, rtol=0,
                               atol=0.02 * np.abs(want).max())
    if mode != "plain":
        jl_tok = np.asarray(jaux["token_logits"])
        near = np.abs(jl_tok) < 0.05 * np.abs(jl_tok).max()
        same = taux["token_select"].numpy() == np.asarray(
            jaux["token_select"])
        assert (same | near).all()


@pytest.mark.parametrize("complete_model,key",
                         [(False, "logits_eval"), (True, "logits_teacher")])
def test_golden_fixture(complete_model, key):
    """tests/fixtures/golden_vit.npz, loaded straight from its timm state
    dict (pre_logits dropped), reproduces at 2e-4 as the JAX model does."""
    data = np.load(FIX)
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd/")}
    mc = ModelConfig(img_size=64, patch_size=16, embed_dim=128, depth=2,
                     num_heads=2, num_classes=10)
    tm = VisionTransformer(mc, tuning=TuningConfig(ffn_num=8, d_model=128),
                           select=SelectConfig(), dtype=torch.float32)
    missing, unexpected = load_timm_state_dict(tm, sd, log=lambda *a: None)
    assert missing == [] and unexpected == []
    logits, aux = tm(torch.from_numpy(data["x"]),
                     complete_model=complete_model)
    np.testing.assert_allclose(logits.numpy(), data[key], rtol=2e-4,
                               atol=2e-4)
    assert (aux["token_select"] is None) == complete_model
