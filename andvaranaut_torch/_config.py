"""Global configuration of the PyTorch/CUDA port.

The reference stack is float64 end to end, and the NLML parity budget
(1e-6 relative at 16k) needs f64 accumulation, so every public function
works on float64 tensors.  Entry points run on the CUDA card unless the
caller asks for the CPU explicitly; with no card and no explicit CPU
request they raise instead of silently running elsewhere.
"""

from __future__ import annotations

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
