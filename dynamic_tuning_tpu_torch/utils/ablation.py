"""Copies of the package with a kernel source edited, built and run apart:
the ablation scripts' shared plumbing (``moe_tail_ablation``,
``core_ablation``)."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]


def copy_variant(out: Path, name: str, edits) -> Path:
    """The package copied to ``out/<name>/`` with ``edits``, (source under
    the package, text, replacement) triples, applied; returns the copy's
    root (the directory to run from)."""
    root = out / name.replace(" ", "_")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, root / PKG.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in edits:
        src = root / PKG.name / rel
        text = src.read_text()
        if old not in text:
            raise RuntimeError(f"variant {name!r}: {old!r} is not in {rel}")
        src.write_text(text.replace(old, new))
    return root


def run_in_copy(root: Path, code: str, **kw) -> subprocess.Popen:
    """``python -c code`` against the copy at ``root``."""
    # run from the copy: ``python -c`` puts the working directory first on
    # the import path, ahead of PYTHONPATH
    env = dict(os.environ, PYTHONPATH=str(root))
    return subprocess.Popen([sys.executable, "-c", code], cwd=root, env=env,
                            **kw)


def build_all(roots) -> None:
    """Build every copy's kernels, all at once."""
    builds = [run_in_copy(root, "from dynamic_tuning_tpu_torch.ops import "
                                "_build; _build.library()")
              for root in roots]
    if any(p.wait() for p in builds):
        raise RuntimeError("a variant did not build")
