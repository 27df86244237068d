"""Global configuration of the PyTorch/CUDA port.

The reference stack is float64 end to end, and the NLML parity budget
(1e-6 relative at 16k) needs f64 accumulation, so every public function
works on float64 tensors.  Entry points run on the CUDA card unless the
caller asks for the CPU explicitly; with no card and no explicit CPU
request they raise instead of silently running elsewhere.
"""

from __future__ import annotations

import os

import torch

#: working dtype of every public function of the port
DTYPE = torch.float64


def default_device() -> torch.device:
    """The CUDA card, or an error when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "andvaranaut_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means `default_device()`."""
    if device is None:
        return default_device()
    return torch.device(device)


def fast_gram() -> bool:
    """Whether user-facing prediction cross-Grams (`kernels.gram_cross`)
    take the fused f32 tile kernel K9 instead of the exact f64 difference
    form.  Default off: near interpolation (tiny gv) the solve amplifies
    the f32 cross-covariance error to ~1e-4 relative on predictive means.
    Opt in with ANDVARANAUT_FAST_GRAM=1.  The BO acquisition programs use
    K9 on the card regardless (their values tolerate f32 noise)."""
    env = os.environ.get("ANDVARANAUT_FAST_GRAM")
    if env is not None:
        return env not in ("0", "false", "False", "")
    return False
