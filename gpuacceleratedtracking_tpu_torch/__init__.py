"""gpuacceleratedtracking_tpu_torch — the GNSS baseband tracker on PyTorch and CUDA.

A port of `gpuacceleratedtracking_tpu` (JAX/Pallas, the reference) to PyTorch,
with its TPU kernels rewritten by hand for NVIDIA Hopper. The layout mirrors
the reference (`models/`, `ops/`, `tracking/`), one port module per reference
module. This package never imports jax.
"""

__version__ = "0.1.0"

from . import models, ops, tracking

__all__ = ["models", "ops", "tracking", "__version__"]
