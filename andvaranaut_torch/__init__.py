"""PyTorch/CUDA port of the andvaranaut_tpu GP stack for NVIDIA Hopper.

The JAX package `andvaranaut_tpu` stays the reference; this package
imports neither it nor JAX.  Dense large-N linear algebra runs the same
int8-Ozaki slice scheme through hand-written sm_90a CUDA kernels
(`csrc/`), built with nvcc at first use (`_build.py`).
"""

from ._config import DTYPE, default_device, resolve_device
from .gpmcmc import GPMCMC

__all__ = ["DTYPE", "GPMCMC", "default_device", "resolve_device"]
