"""K3: diagonal-block Cholesky and its inverse in one launch
(counterpart of andvaranaut_tpu/gp/pallas_cholinv.py).

`chol_inv_block(Ajj)` equilibrates the SPD block with exact power-of-two
scales d ~ sqrt(diag), factors the equilibrated block, inverts the
factor and undoes the scaling: L = Ls d, X = Ls^-1 / d.  `ok` is False
when any entry of Ls or Xs is not finite or min diag(Ls) <= 1e-6; the
caller then falls back to f64 (precision._chol_inv_fused).

On a CUDA tensor the factor and inverse come from the hand-written
kernel csrc/cholinv.cu (native f64 where the TPU kernel carried f32
pairs; see the source note), on a CPU tensor from the plain version,
f64 `torch.linalg.cholesky_ex` plus a triangular solve.
`chol_inv_block.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

#: largest block the kernel takes (larger blocks recurse 2x2 above it)
MAX_BLOCK = 512
_GRAIN = 32

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"chol_inv_block": [_VP] * 4 + [_I, _VP]}


def _lib():
    return _build.library("cholinv", _SIGS)


def pow2_sqrt_scales(v):
    """Exact power-of-two scales ~ sqrt(v): 2^((e+1)>>1) from the f32
    exponent field, as the JAX reference builds them."""
    m32 = torch.clamp(v.to(torch.float32), min=1e-30)
    u = m32.view(torch.int32)
    e = ((u >> 23) & 0xFF) - 127
    eh = torch.clamp((e + 1) >> 1, -60, 60)
    return ((eh + 127) << 23).view(torch.float32).to(v.dtype)


def _ok(Ls, Xs):
    return (torch.isfinite(Ls).all() & torch.isfinite(Xs).all()
            & (torch.diagonal(Ls).min() > 1e-6))


def chol_inv_plain(As):
    """Plain PyTorch version of the kernel on an equilibrated block:
    (Ls, Xs = Ls^-1, ok) in f64."""
    Ls, info = torch.linalg.cholesky_ex(As)
    eye = torch.eye(As.shape[0], dtype=As.dtype, device=As.device)
    Xs = torch.linalg.solve_triangular(Ls, eye, upper=False)
    return Ls, Xs, _ok(Ls, Xs) & (info == 0)


def _chol_inv_cuda(As):
    b = As.shape[0]
    if b > MAX_BLOCK or b % _GRAIN:
        raise ValueError(
            f"chol_inv_block takes b <= {MAX_BLOCK}, b % {_GRAIN} == 0; "
            f"got {b}")
    A = As.contiguous()
    Ls = torch.empty_like(A)
    Xs = torch.empty_like(A)
    ok = torch.empty(1, dtype=torch.int32, device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().chol_inv_block(A.data_ptr(), Ls.data_ptr(),
                                    Xs.data_ptr(), ok.data_ptr(), b, stream)
        chol_inv_block.launches += 1
    _build.check(err, "chol_inv_block")
    return Ls, Xs, ok[0] != 0


def chol_inv_block(Ajj):
    """(L, X = L^-1, ok) of an SPD diagonal block (f64, b <= 512)."""
    if Ajj.dtype != torch.float64 or Ajj.dim() != 2 \
            or Ajj.shape[0] != Ajj.shape[1]:
        raise ValueError("chol_inv_block takes a square float64 block")
    d = pow2_sqrt_scales(torch.diagonal(Ajj))
    As = Ajj / d[:, None] / d[None, :]
    if Ajj.device.type == "cpu":
        Ls, Xs, ok = chol_inv_plain(As)
    elif Ajj.device.type == "cuda":
        Ls, Xs, ok = _chol_inv_cuda(As)
    else:
        raise ValueError(f"unsupported device {Ajj.device}")
    return Ls * d[:, None], Xs * (1.0 / d)[None, :], ok


chol_inv_block.launches = 0
