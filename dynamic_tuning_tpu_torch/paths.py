"""Machine-local dataset and checkpoint registry (counterpart of
dynamic_tuning_tpu/paths.py).

The reference switches path sets with a ``CLUSTER`` env var over two dicts
(configs.py:4-34).  Same contract here: set ``DYT_CLUSTER`` (default
"default") and register a machine's paths with ``register_cluster``;
``checkpoint_path("VIT_BASE_IN21K")`` and ``dataset_path("cifar100")`` then
resolve the keys.
"""

from __future__ import annotations

import os
from typing import Dict

_REGISTRY: Dict[str, Dict[str, Dict[str, str]]] = {
    "default": {
        "datasets": {
            # e.g. "cifar100": "/data",
        },
        "checkpoints": {
            # e.g. "VIT_BASE_IN21K": "/ckpts/vit_base_patch16_224_in21k.pth",
        },
    },
}


def register_cluster(name: str, datasets: Dict[str, str],
                     checkpoints: Dict[str, str]) -> None:
    _REGISTRY[name] = {"datasets": dict(datasets),
                       "checkpoints": dict(checkpoints)}


def _cluster() -> str:
    return os.environ.get("DYT_CLUSTER", "default")


def dataset_path(name: str, fallback: str = "") -> str:
    return _REGISTRY.get(_cluster(), {}).get("datasets", {}).get(name,
                                                                 fallback)


def checkpoint_path(name: str, fallback: str = "") -> str:
    return _REGISTRY.get(_cluster(), {}).get("checkpoints", {}).get(
        name, fallback)
