"""Covariance kernels with PyMC semantics (counterpart of
andvaranaut_tpu/gp/kernels.py).

  RBF (ExpQuad):    exp(-0.5 * r2)
  Matern52:         (1 + sqrt(5) r + 5/3 r2) exp(-sqrt(5) r)
  Matern32:         (1 + sqrt(3) r) exp(-sqrt(3) r)
  Exponential:      exp(-0.5 * r)        [PyMC's convention]
  RatQuad:          (1 + r2 / (2 alpha)) ** (-alpha)

with r2 the ARD-scaled squared distance sum_k ((x_k - x'_k)/ls_k)^2, in
the exact f64 difference form (no a^2 + b^2 - 2ab cancellation).  A
composition string such as 'RBF*Matern52+RatQuad' scales each component
by its own variance kv[i] with its own lengthscale block
l[i*nx:(i+1)*nx], applied left to right.
"""

from __future__ import annotations

import math
import re

import torch

KERNEL_NAMES = ("RBF", "Matern52", "Matern32", "Exponential", "RatQuad")


def parse_kernel(kernel: str):
    """Split a kernel composition string into component names and
    operators: (kerns, ops) with len(ops) == len(kerns) - 1."""
    kerns = tuple(re.split(r"[+*]", kernel))
    ops = tuple(re.findall(r"[+*]", kernel))
    for k in kerns:
        if k not in KERNEL_NAMES:
            raise ValueError(
                f"kernel string must contain only {list(KERNEL_NAMES)}")
    if len(ops) != len(kerns) - 1:
        raise ValueError(f"malformed kernel string '{kernel}'")
    return kerns, ops


def _scaled_sqdist(X, X2, ls):
    """ARD-scaled squared distance in the exact difference form, with a
    loop over the (small) input dimension."""
    Xs = X / ls
    X2s = X2 / ls
    r2 = None
    for k in range(X.shape[1]):
        diff = Xs[:, k, None] - X2s[None, :, k]
        term = diff * diff
        r2 = term if r2 is None else r2 + term
    return r2


def base_kernel(name: str, X, X2, ls, alpha=None, diag: bool = False):
    """One unscaled component k(X, X2) (the caller applies the variance)."""
    if diag:
        return torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
    r2 = _scaled_sqdist(X, X2, ls)
    if name == "RBF":
        return torch.exp(-0.5 * r2)
    if name == "RatQuad":
        return torch.pow(1.0 + r2 / (2.0 * alpha), -alpha)
    r = torch.sqrt(r2 + 1e-36)
    if name == "Matern52":
        s5 = math.sqrt(5.0)
        return (1.0 + s5 * r + (5.0 / 3.0) * r2) * torch.exp(-s5 * r)
    if name == "Matern32":
        s3 = math.sqrt(3.0)
        return (1.0 + s3 * r) * torch.exp(-s3 * r)
    if name == "Exponential":
        return torch.exp(-0.5 * r)
    raise ValueError(f"Unknown kernel {name}")


def gram(kerns, ops, X, X2, l_flat, kv, alpha=None, diag: bool = False):
    """Composite Gram matrix (or its diagonal) over converted inputs.

    l_flat: (nkern*nx,) ARD lengthscales, one block per component.
    kv:     (nkern,) per-component variances.
    alpha:  RatQuad shape (scalar; at most one RatQuad)."""
    nx = X.shape[1]
    if X2 is None:
        X2 = X
    out = None
    for i, name in enumerate(kerns):
        ls = l_flat[i * nx:(i + 1) * nx]
        ki = kv[i] * base_kernel(name, X, X2, ls, alpha=alpha, diag=diag)
        if out is None:
            out = ki
        elif ops[i - 1] == "+":
            out = out + ki
        else:
            out = out * ki
    return out
