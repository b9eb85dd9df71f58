"""dynamic_tuning_tpu_torch: the DyT serving path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``dynamic_tuning_tpu`` (JAX on a TPU), which stays the reference.
This package imports torch and never jax; it shares only the framework-free
``dynamic_tuning_tpu.config``.  See README.md, "The PyTorch port".
"""

__version__ = "0.1.0"

from dynamic_tuning_tpu.config import (  # noqa: F401
    ModelConfig, SelectConfig, TuningConfig,
)
