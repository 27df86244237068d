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

`gram_fast` computes each component through the fused f32 tile kernel
K9 (`ops.gram_tiles`) and widens it to f64; its gradients are those of
the exact f64 form.  `gram_cross` picks it for prediction cross-Grams
when `_config.fast_gram()` opts in.
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


def kernel_value(name: str, r2, alpha=None):
    """The kernel's value at the ARD-scaled squared distance r2, in r2's
    dtype (K9's plain version evaluates it in f32)."""
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


def base_kernel(name: str, X, X2, ls, alpha=None, diag: bool = False):
    """One unscaled component k(X, X2) (the caller applies the variance)."""
    if diag:
        return torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
    return kernel_value(name, _scaled_sqdist(X, X2, ls), alpha)


def gram(kerns, ops, X, X2, l_flat, kv, alpha=None, diag: bool = False,
         component=None):
    """Composite Gram matrix (or its diagonal) over converted inputs.

    l_flat: (nkern*nx,) ARD lengthscales, one block per component.
    kv:     (nkern,) per-component variances.
    alpha:  RatQuad shape (scalar; at most one RatQuad).
    component: per-component evaluator (default `base_kernel`)."""
    nx = X.shape[1]
    if X2 is None:
        X2 = X
    if component is None:
        component = base_kernel
    out = None
    for i, name in enumerate(kerns):
        ls = l_flat[i * nx:(i + 1) * nx]
        ki = kv[i] * component(name, X, X2, ls, alpha=alpha, diag=diag)
        if out is None:
            out = ki
        elif ops[i - 1] == "+":
            out = out + ki
        else:
            out = out * ki
    return out


class _ComponentFast(torch.autograd.Function):
    """One component through K9: X, X2, ls and alpha cast to f32, the
    division by ls in f32, the tile kernel, the result widened to the
    inputs' dtype.  K9 has no backward kernel (the reference's has no AD
    rule either); the backward differentiates the exact f64 `base_kernel`
    by autograd, as the reference's custom JVP does (kernels.py:134-144
    of the JAX package)."""

    @staticmethod
    def forward(ctx, name, X, X2, ls, alpha):
        from . import ops

        ctx.name = name
        ctx.save_for_backward(X, X2, ls, alpha)
        out = ops.gram_component(
            name, X.to(torch.float32), X2.to(torch.float32),
            ls.to(torch.float32), alpha=alpha.to(torch.float32))
        return out.to(X.dtype)

    @staticmethod
    def backward(ctx, ct):
        X, X2, ls, alpha = ctx.saved_tensors
        want = ctx.needs_input_grad[1:]
        ins = [t.detach().requires_grad_(w)
               for t, w in zip((X, X2, ls, alpha), want)]
        with torch.enable_grad():
            ref = base_kernel(ctx.name, ins[0], ins[1], ins[2],
                              alpha=ins[3] if ctx.name == "RatQuad" else None)
            grads = torch.autograd.grad(
                ref, [t for t, w in zip(ins, want) if w], ct,
                allow_unused=True)
        it = iter(grads)
        return (None, *[next(it) if w else None for w in want])


def gram_fast(kerns, ops, X, X2, l_flat, kv, alpha=None):
    """Composite cross-Gram with every component through K9 (f32 grade,
    widened to f64).  Callers own the accuracy trade: see
    `_config.fast_gram`."""
    a = torch.as_tensor(1.0 if alpha is None else alpha, dtype=X.dtype,
                        device=X.device)

    def component(name, X, X2, ls, alpha=None, diag=False):
        return _ComponentFast.apply(name, X, X2, ls, a)

    return gram(kerns, ops, X, X2, l_flat, kv, alpha=alpha,
                component=component)


def gram_cross(kerns, ops, X, X2, l_flat, kv, alpha=None,
               diag: bool = False):
    """Cross-covariance Gram of the user-facing prediction paths: K9
    when opted in (`_config.fast_gram()`), the exact f64 difference form
    otherwise.  Likelihood and fit paths call `gram` directly."""
    from .._config import fast_gram

    if diag or not fast_gram():
        return gram(kerns, ops, X, X2, l_flat, kv, alpha=alpha, diag=diag)
    return gram_fast(kerns, ops, X, X2, l_flat, kv, alpha=alpha)
