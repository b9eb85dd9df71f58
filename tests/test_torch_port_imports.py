"""The port stands alone: it and ``chip_smoke.py`` import nothing of JAX,
of the JAX package or of ``tests/``.

* in a subprocess where ``dynamic_tuning_tpu``, ``jax``, ``jaxlib``,
  ``flax`` and ``torch_oracle`` cannot be imported, every module of
  ``dynamic_tuning_tpu_torch`` imports, and ``chip_smoke.py`` loads as a
  module (its ``main`` not run);
* no port file names the JAX package in an import statement;
* the port's seeded synthetic state dict is the test oracle's, value for
  value.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import dynamic_tuning_tpu_torch
from dynamic_tuning_tpu_torch.checkpoint import make_vit_state_dict
from torch_oracle import make_vit_state_dict as oracle_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "dynamic_tuning_tpu_torch")
BLOCKED = ("dynamic_tuning_tpu", "jax", "jaxlib", "flax", "torch_oracle")
PORT_FILES = sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, files in os.walk(PORT) for f in files if f.endswith(".py")
) + ["chip_smoke.py"]

_BLOCKER = f"""
import sys
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {BLOCKED!r}:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Blocker())
"""


def _run(code: str) -> subprocess.CompletedProcess:
    # the repository root only: tests/ (torch_oracle) is not on the path
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", _BLOCKER + code], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def _port_modules():
    return ["dynamic_tuning_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            dynamic_tuning_tpu_torch.__path__, "dynamic_tuning_tpu_torch.")]


def test_every_port_module_imports_without_jax_package():
    mods = _port_modules()
    assert "dynamic_tuning_tpu_torch.ops.quant" in mods
    code = (
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_loads_without_jax_package_or_tests():
    code = (
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        "'chip_smoke.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert callable(mod.main)\n"
        "import dynamic_tuning_tpu_torch.speed, "
        "dynamic_tuning_tpu_torch.checkpoint\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_names(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_import_names_the_jax_package(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    bad = [n for n in _imported_names(tree)
           if n.split(".")[0] in BLOCKED]
    assert not bad, f"{path} imports {bad}"


def test_make_vit_state_dict_is_the_oracles():
    kw = dict(depth=2, dim=64, ffn=8, classes=10, img=32, patch=16)
    got = make_vit_state_dict(np.random.RandomState(3), **kw)
    want = oracle_state_dict(np.random.RandomState(3), **kw)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
