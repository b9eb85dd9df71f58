"""The port at the token counts past the N whose keys and values fit one
block of the bf16 attention core's shared memory (865 and up at head_dim
64, 417 and up at head_dim 128), against the JAX package, on the CPU.

On the card those N take the core's ring of key/value tiles; here every
wrapper computes its plain version, so these tests hold the port's paths
at those shapes (routing, layouts, the speed-test forward's K15 at any N,
the fusable Block's K3/K6 at N <= 512) to the JAX package.

* ``fast_vit_forward`` with 30 x 30 patches (N = 901), dispatch and dense,
  width 64, 4 heads, 2 blocks: the JAX speed-test forward computes its
  attention with XLA at any N, the port runs K15.  Tolerances of
  ``tests/test_torch_port_fast.py``: gates identical (router heads x60),
  logits within 2e-2 of the largest |logit|.
* A fusable DyT ``Block`` with head_dim 128 at N = 442 (2 heads of 128,
  the N of a 336^2 image in 16^2 patches), bf16 and int8, in dispatch: the
  JAX Block takes its Pallas prologue kernel (N <= 512; interpret mode
  here), the port K3 / K6.  Tolerances of the LayerScale Block test in
  ``tests/test_torch_port_attn.py``: gates identical, router logits within
  1e-5 of the largest, outputs within two bf16 ulps of the largest.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_tuning_tpu.config import ModelConfig, SelectConfig, TuningConfig
from dynamic_tuning_tpu.models import fast_inference as jfast
from dynamic_tuning_tpu.models import layers as jlayers
from dynamic_tuning_tpu.models.vit import VisionTransformer as JaxViT
from dynamic_tuning_tpu.train.checkpoint import import_pretrained
from dynamic_tuning_tpu_torch import config as tcfg
from dynamic_tuning_tpu_torch.checkpoint import (from_flax_params,
                                                 make_vit_state_dict)
from dynamic_tuning_tpu_torch.models import fast_inference as pfast
from dynamic_tuning_tpu_torch.models import layers as tlayers
from dynamic_tuning_tpu_torch.models.vit import VisionTransformer
from dynamic_tuning_tpu_torch.ops import mha_serving as tms
from dynamic_tuning_tpu_torch.ops import quant as tqt

LOGIT_REL = 2e-2
BF16_ULP = 2.0 ** -7


def port_cfg(cfg):
    """The port's own config object with the fields of a JAX-package one."""
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


class _Quiet:
    def info(self, *a):
        pass


# --- the speed-test forward at N = 901 ---------------------------------------

PATCH, GRID, DIM, HEADS, DEPTH, FFN, CLASSES = 8, 30, 64, 4, 2, 8, 10
IMG = PATCH * GRID                      # 30 x 30 patches + CLS = 901 tokens


@pytest.fixture(scope="module")
def fast_pair():
    """(jax params, port serving params, x, configs) with the same weights
    on both sides, through the weight bridge."""
    cfg = ModelConfig(img_size=IMG, patch_size=PATCH, num_classes=CLASSES,
                      embed_dim=DIM, depth=DEPTH, num_heads=HEADS)
    tuning, sel = TuningConfig(ffn_num=FFN, d_model=DIM,
                               dropout=0.0), SelectConfig()
    rs = np.random.RandomState(0)
    sd = make_vit_state_dict(rs, depth=DEPTH, dim=DIM, ffn=FFN,
                             classes=CLASSES, img=IMG, patch=PATCH,
                             router_scale=1.0)
    x = rs.randn(2, IMG, IMG, 3).astype(np.float32)
    jm = JaxViT(cfg, tuning=tuning, select=sel, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x[:1]))["params"]
    params, _ = import_pretrained(params, sd, logger=_Quiet())
    for i in range(DEPTH):
        head = params[f"blocks_{i}"]["mlp_token_select"]["mlp_head"]
        head["kernel"] = head["kernel"] * 60
    tm = VisionTransformer(port_cfg(cfg), tuning=port_cfg(tuning),
                           select=port_cfg(sel), dtype=torch.bfloat16)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        from_flax_params(params).items()}, strict=True)
    return params, pfast.serving_params(tm), x, (cfg, tuning, sel)


@pytest.mark.parametrize("mode", ["dispatch", "dense"])
def test_fast_vit_forward_at_901_tokens_matches_jax(fast_pair, mode):
    params, tparams, x, (cfg, tuning, sel) = fast_pair
    want_l, want_g = jfast.fast_vit_forward(
        params, jnp.asarray(x), cfg=cfg, tuning=tuning, select=sel,
        mode=mode)
    with mock.patch.object(tms, "mha_serving",
                           wraps=tms.mha_serving) as k15:
        got_l, got_g = pfast.fast_vit_forward(
            tparams, torch.from_numpy(x), cfg=port_cfg(cfg),
            tuning=port_cfg(tuning), select=port_cfg(sel), mode=mode)
    # K15 in every block, on 901 tokens
    assert k15.call_count == DEPTH
    assert all(c.args[0].shape[2] == GRID * GRID + 1
               for c in k15.call_args_list)
    if mode == "dense":
        assert want_g is None and got_g is None
    else:
        np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
        # capacity 450 of 900 patch slots: the dispatch really cuts tokens
        assert got_g[:, :, 1:].sum(dim=2).max() <= 450
    want_l = np.asarray(want_l)
    assert got_l.dtype == torch.float32 and got_l.shape == want_l.shape
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=0,
                               atol=LOGIT_REL * np.abs(want_l).max())


# --- a head-dim-128 fusable Block at N = 442 ---------------------------------

BDIM, BHEADS, BFFN, BN = 256, 2, 8, 442


def _block_params(jb, x):
    """The Block's init with adapter ups that matter and router heads x50
    (hard gates with margin)."""
    params = jb.init(jax.random.PRNGKey(0), x)["params"]
    rs = np.random.RandomState(3)

    def f(path, a):
        key = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if "mlp_token_select" in key and "kernel" in key:
            return a * 50.0
        if "up_proj" in key:
            return a + (rs.randn(*a.shape) * 0.05).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(f, params)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_head_dim_128_block_at_442_tokens_matches_jax(monkeypatch, quant):
    """Dispatch: K3 (bf16) or K6 (int8) for the fused prologue on both
    sides, then the dispatched MLP (K4 under int8)."""
    monkeypatch.setenv("DYT_FUSED_ATTN", "interpret")
    x = np.random.RandomState(12).randn(2, BN, BDIM)
    tuning = TuningConfig(ffn_num=BFFN, d_model=BDIM)
    select = SelectConfig(token_target_ratio=0.5)
    jx_in = jnp.asarray(x).astype(jnp.bfloat16)
    jb = jlayers.Block(BHEADS, quant=quant, tuning=tuning, select_cfg=select,
                       dtype=jnp.bfloat16)
    params = _block_params(jb, jx_in)
    jx, jgate, jlog = jb.apply({"params": params}, jx_in, False, False, True)
    tb = tlayers.Block(BDIM, BHEADS, torch.Generator(), quant=quant,
                       tuning=port_cfg(tuning), select_cfg=port_cfg(select),
                       dtype=torch.bfloat16)
    tb.load_state_dict({k: torch.from_numpy(v) for k, v in
                        from_flax_params(params).items()}, strict=True)
    mod, name = ((tqt, "dyt_prologue_serving_q8") if quant == "int8"
                 else (tms, "dyt_prologue_serving"))
    with (mock.patch.object(mod, name, wraps=getattr(mod, name)) as pro,
          torch.inference_mode()):
        tx, tgate, tlog = tb(torch.from_numpy(x).to(torch.bfloat16), False,
                             True)
    assert pro.call_count == 1
    want = np.asarray(jx.astype(jnp.float32))
    np.testing.assert_allclose(tx.float().numpy(), want, rtol=0,
                               atol=2 * BF16_ULP * np.abs(want).max())
    np.testing.assert_array_equal(tgate.numpy(), np.asarray(jgate))
    assert 0 < tgate.numpy().mean() < 1
    want = np.asarray(jlog)
    np.testing.assert_allclose(tlog.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
