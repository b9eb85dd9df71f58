"""dynamic_tuning_tpu_torch: the DyT serving path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``dynamic_tuning_tpu`` (JAX on a TPU), which stays the reference.
This package imports torch and nothing of JAX or of the JAX package: what it
needs from there (the config dataclasses, the reference CLI flags, the
checkpoint registry) it keeps as its own copy.  See README.md, "The PyTorch
port".
"""

__version__ = "0.2.0"

from dynamic_tuning_tpu_torch.config import (  # noqa: F401
    ModelConfig, SelectConfig, TuningConfig,
)
