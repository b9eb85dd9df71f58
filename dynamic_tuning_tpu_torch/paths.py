"""Machine-local checkpoint registry (the checkpoint half of
dynamic_tuning_tpu/paths.py).

Set ``DYT_CLUSTER`` (default "default") and register a machine's paths with
``register_cluster``; ``checkpoint_path("VIT_BASE_IN21K")`` then resolves the
key the way the reference's ``CHECKPOINTS`` dict does.
"""

from __future__ import annotations

import os
from typing import Dict

_REGISTRY: Dict[str, Dict[str, str]] = {
    "default": {
        # e.g. "VIT_BASE_IN21K": "/ckpts/vit_base_patch16_224_in21k.pth",
    },
}


def register_cluster(name: str, checkpoints: Dict[str, str]) -> None:
    _REGISTRY[name] = dict(checkpoints)


def checkpoint_path(name: str, fallback: str = "") -> str:
    cluster = os.environ.get("DYT_CLUSTER", "default")
    return _REGISTRY.get(cluster, {}).get(name, fallback)
