"""The PyTorch port's weight bridge and package boundary, on the CPU.

* ``from_flax_params`` gives the keys and arrays of the JAX package's own
  ``export_torch_state_dict``, and the port loads them with strict=True;
* ``load_timm_state_dict`` applies ``import_pretrained``'s rules;
* importing the port loads no JAX.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_tuning_tpu.config import ModelConfig, SelectConfig, TuningConfig
from dynamic_tuning_tpu.models.vit import VisionTransformer as JaxViT
from dynamic_tuning_tpu.train.checkpoint import export_torch_state_dict
from dynamic_tuning_tpu_torch import config as tcfg
from dynamic_tuning_tpu_torch.checkpoint import (flax_path_to_timm,
                                                 from_flax_params,
                                                 load_timm_state_dict)
from dynamic_tuning_tpu_torch.models.vit import VisionTransformer
from torch_oracle import make_vit_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MC = ModelConfig(img_size=32, patch_size=16, embed_dim=128, depth=2,
                 num_heads=2, num_classes=10)
CONFIGS = {
    "dyt": (TuningConfig(ffn_num=8, d_model=128), SelectConfig()),
    "plain": (TuningConfig(ffn_adapt=False), SelectConfig(open=False)),
    "keep_layers": (TuningConfig(ffn_num=8, d_model=128),
                    SelectConfig(keep_layers=1)),
}


def _port(cfg):
    """The port's own config object with the fields of a JAX-package one."""
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _port_vit(tuning, select):
    return VisionTransformer(_port(MC), tuning=_port(tuning),
                             select=_port(select), dtype=torch.float32)


def _jax_params(tuning, select):
    m = JaxViT(MC, tuning=tuning, select=select, dtype=jnp.float32)
    return m.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_from_flax_params_equals_export(tmp_path, name):
    tuning, select = CONFIGS[name]
    params = _jax_params(tuning, select)
    path = str(tmp_path / "export.pth")
    export_torch_state_dict(params, path)
    want = torch.load(path, weights_only=False)["model"]
    got = from_flax_params(params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].numpy(), err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_loads_bridged_params_strict(name):
    tuning, select = CONFIGS[name]
    params = _jax_params(tuning, select)
    model = _port_vit(tuning, select)
    sd = {k: torch.from_numpy(v) for k, v in from_flax_params(params).items()}
    model.load_state_dict(sd, strict=True)
    own = model.state_dict()
    for k, v in sd.items():
        assert torch.equal(own[k], v), k


def test_learnable_adapter_scale_crosses_the_bridge():
    tuning = TuningConfig(ffn_num=8, d_model=128,
                          ffn_adapter_scalar="learnable_scalar")
    params = _jax_params(tuning, SelectConfig())
    sd = from_flax_params(params)
    assert sd["blocks.1.adaptmlp.scale"].shape == (1,)
    model = _port_vit(tuning, SelectConfig())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)


def test_unknown_flax_param_raises():
    # the video model's attentive pooling is not ported
    with pytest.raises(ValueError, match="no timm name"):
        flax_path_to_timm(("attentive_blocks", "cross_attn", "q_bias"))


def _timm_sd(classes=10, seed=0):
    return make_vit_state_dict(np.random.RandomState(seed), depth=2, dim=128,
                               ffn=8, classes=classes, img=32, patch=16)


def test_load_timm_full_dyt_state_dict():
    model = _port_vit(CONFIGS["dyt"][0], SelectConfig())
    sd = _timm_sd()
    sd["pre_logits.fc.weight"] = np.zeros((128, 128), np.float32)
    missing, unexpected = load_timm_state_dict(model, sd, log=lambda *a: None)
    assert missing == [] and unexpected == []
    assert torch.equal(model.blocks[1].attn.qkv.weight,
                       torch.from_numpy(sd["blocks.1.attn.qkv.weight"]))


def test_load_timm_head_surgery_and_backbone_only():
    """An IN21K-style backbone with a 1000-class head: the head is dropped
    (stays at init), adapters and routers are missing; DyT keys into a plain
    model are reported as unexpected and ignored."""
    dyt = _port_vit(CONFIGS["dyt"][0], SelectConfig())
    head0 = dyt.head.weight.clone()
    sd = {k: v for k, v in _timm_sd(classes=1000).items()
          if "adaptmlp" not in k and "mlp_token_select" not in k}
    missing, unexpected = load_timm_state_dict(dyt, sd, log=lambda *a: None)
    assert unexpected == []
    assert "head.weight" in missing and "head.bias" in missing
    assert "blocks.0.adaptmlp.down_proj.weight" in missing
    assert "blocks.1.mlp_token_select.mlp_head.bias" in missing
    assert torch.equal(dyt.head.weight, head0)

    plain = _port_vit(CONFIGS["plain"][0], SelectConfig(open=False))
    missing, unexpected = load_timm_state_dict(plain, _timm_sd(),
                                               log=lambda *a: None)
    assert missing == []
    assert "blocks.0.adaptmlp.up_proj.bias" in unexpected


def test_load_timm_rejects_other_grids_and_shapes():
    """A pos-embed of another patch grid is interpolated (here a 4x4 grid
    onto the model's 2x2: CLS passed through, the grid resized); any other
    shape mismatch raises."""
    model = _port_vit(CONFIGS["dyt"][0], SelectConfig())
    sd = _timm_sd()
    sd["pos_embed"] = np.random.RandomState(1).randn(1, 17, 128).astype(
        np.float32)
    load_timm_state_dict(model, sd, log=lambda *a: None)
    assert model.pos_embed.shape == (1, 5, 128)
    np.testing.assert_array_equal(model.pos_embed[0, 0].detach().numpy(),
                                  sd["pos_embed"][0, 0])
    sd = _timm_sd()
    sd["blocks.0.mlp.fc1.weight"] = np.zeros((256, 128), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_timm_state_dict(model, sd, log=lambda *a: None)


def test_import_loads_no_jax():
    """The port runs where no JAX is installed: importing it (and its entry
    point) must not pull jax or flax in, even transitively."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import dynamic_tuning_tpu_torch\n"
        "import dynamic_tuning_tpu_torch.speed\n"
        "import dynamic_tuning_tpu_torch.checkpoint\n"
        "import dynamic_tuning_tpu_torch.models.vit\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not [m for m in sys.modules\n"
        "            if m.startswith(('jax', 'flax'))]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
