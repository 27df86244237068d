"""PyTorch/CUDA port of the andvaranaut_tpu GP stack for NVIDIA Hopper.

The JAX package `andvaranaut_tpu` stays the reference; this package
imports neither it nor JAX.  Dense large-N linear algebra runs the same
int8-Ozaki slice scheme through hand-written sm_90a CUDA kernels
(`csrc/`), built with nvcc at first use (`_build.py`).

The public namespace is flat, as the reference's: `dists`, `sampling`,
`timing`, the persistence functions, `LHC`, the ported `transform`
classes and functions, and `GPMCMC`.
"""

from . import dists  # noqa: F401
from . import sampling  # noqa: F401
from . import timing  # noqa: F401
from ._config import DTYPE, default_device, resolve_device  # noqa: F401
from .core import load_object, load_xy, save_object, save_xy  # noqa: F401
from .gpmcmc import GPMCMC  # noqa: F401
from .lhc import LHC  # noqa: F401
from .transform import *  # noqa: F401,F403
