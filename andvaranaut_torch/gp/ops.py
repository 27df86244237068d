"""K9: the fused f32 cross-Gram tile kernel (counterpart of
andvaranaut_tpu/gp/pallas_ops.py).

`gram_tiles` computes one kernel component's Gram over pre-scaled f32
inputs in one pass per output entry: the ARD difference-form r2 summed
over the input dimensions in order, then the kernel value, with the
formulas of `kernels.base_kernel` (`sqrt(r2 + 1e-36)` included) in f32.
For CPU tensors it runs the plain PyTorch version `gram_tiles_plain`;
for CUDA tensors it launches the hand-written kernel of csrc/gram.cu, or
raises.  `gram_tiles.launches` counts the launches.

`gram_component` is the drop-in single-component Gram of the reference:
it divides by the lengthscales in the inputs' own dtype (callers cast to
f32 first, as the reference's fast path does) and runs `gram_tiles`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .kernels import KERNEL_NAMES, kernel_value

#: kernel names; the index of each is csrc/gram.cu's `name` argument
NAMES = KERNEL_NAMES

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"gram_tiles": [_VP] * 4 + [_I] * 4 + [_VP]}


def _lib():
    return _build.library("gram", _SIGS)


def _alpha_f32(alpha, device):
    if isinstance(alpha, torch.Tensor):
        return alpha.to(device=device, dtype=torch.float32).reshape(1)
    return torch.full((1,), float(alpha), dtype=torch.float32, device=device)


def gram_tiles_plain(name: str, Xs, Ys, alpha=1.0):
    """Plain PyTorch version of K9: the same f32 operations in the same
    order (`kernels.kernel_value` on the f32 r2)."""
    r2 = None
    for k in range(Xs.shape[1]):
        diff = Xs[:, k, None] - Ys[None, :, k]
        t = diff * diff
        r2 = t if r2 is None else r2 + t
    return kernel_value(name, r2, _alpha_f32(alpha, Xs.device).reshape(()))


def gram_tiles(name: str, Xs, Ys, alpha=1.0):
    """K9: (n, m) f32 Gram of component `name` over pre-scaled inputs Xs
    (n, d) and Ys (m, d), both f32; alpha (float or tensor) is RatQuad's
    shape.  Row i, column j is k(Xs[i], Ys[j])."""
    if name not in NAMES:
        raise ValueError(f"Unknown kernel {name}")
    if Xs.dtype != torch.float32 or Ys.dtype != torch.float32:
        raise TypeError("gram_tiles takes float32 inputs")
    if Xs.dim() != 2 or Ys.dim() != 2 or Xs.shape[1] != Ys.shape[1]:
        raise ValueError(
            f"bad shapes {tuple(Xs.shape)} and {tuple(Ys.shape)}")
    if Xs.device.type == "cpu" and Ys.device.type == "cpu":
        return gram_tiles_plain(name, Xs, Ys, alpha)
    for t in (Xs, Ys):
        if t.device.type != "cuda":
            raise ValueError(
                f"expected all-CPU or all-CUDA tensors, got {t.device}")
    n, d = Xs.shape
    m = Ys.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=Xs.device)
    if n == 0 or m == 0:
        return out
    xs = Xs.contiguous()
    yt = Ys.T.contiguous()
    a = _alpha_f32(alpha, Xs.device)
    with torch.cuda.device(Xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().gram_tiles(xs.data_ptr(), yt.data_ptr(), a.data_ptr(),
                                out.data_ptr(), n, m, d, NAMES.index(name),
                                stream)
        gram_tiles.launches += 1
    _build.check(err, "gram_tiles")
    return out


gram_tiles.launches = 0


def gram_component(name: str, X, Y, ls, alpha=None):
    """One component's Gram through K9: X / ls and Y / ls in the inputs'
    dtype (f32 on the fast path), then `gram_tiles`."""
    Xs = (X / ls).to(torch.float32)
    Ys = (Y / ls).to(torch.float32)
    return gram_tiles(name, Xs, Ys, 1.0 if alpha is None else alpha)
