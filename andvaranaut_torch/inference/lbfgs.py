"""L-BFGS over a tensor (counterpart of andvaranaut_tpu/inference/lbfgs.py).

The reference runs optax's L-BFGS with a zoom line search inside one
compiled while loop.  Here the loop runs on the host over a flat float64
tensor, which may live on the card: the objective and its autograd
gradient are evaluated where the tensor is, the two-loop recursion
(memory 10, the reference's) and a strong-Wolfe line search (PyTorch's
own, `torch.optim.lbfgs._strong_wolfe`) on the same device.
"""

from __future__ import annotations

import math

import torch
from torch.optim.lbfgs import _strong_wolfe

_HISTORY = 10


def _value_and_grad(fun, z):
    """(float value, gradient) of fun at z; a non-finite value or
    gradient reads as +inf with a zero gradient, which the line search
    treats as a failed trial point."""
    zz = z.detach().requires_grad_()
    with torch.enable_grad():
        f = fun(zz)
        (g,) = torch.autograd.grad(f, zz)
    fv = float(f.detach())
    if not math.isfinite(fv) or not bool(torch.isfinite(g).all()):
        return math.inf, torch.zeros_like(g)
    return fv, g.detach()


def minimize_lbfgs(fun, z0, max_iter: int = 500, tol: float = 1e-8):
    """Minimise fun(z) (a scalar tensor, differentiable by autograd) from
    z0.  Returns (z_opt, value, grad_norm, n_iter).

    Stops, as the reference does, when the gradient's 2-norm falls below
    tol or after max_iter iterations (always after at least one).  It
    also stops when an iteration cannot move: the direction is not a
    descent direction, or the line search ends at a zero step or a
    non-finite value; the reference would repeat the same point until
    max_iter.  Iterates differ from the reference's: optax scales its
    first step by its own rule and runs a zoom line search with other
    interpolation steps, so the two take other paths to the same
    optimum and agree there to the objective's tolerance."""
    z = z0.detach().to(torch.float64).clone()
    f, g = _value_and_grad(fun, z)
    hist = []  # (s, y, 1 / y's)
    n = 0
    while n == 0 or (n < max_iter and float(g.norm()) >= tol):
        q = -g
        coef = []
        for s, y, rho in reversed(hist):
            a = rho * s.dot(q)
            coef.append(a)
            q = q - a * y
        if hist:
            s, y, _ = hist[-1]
            q = q * (s.dot(y) / y.dot(y))
        for (s, y, rho), a in zip(hist, reversed(coef)):
            q = q + s * (a - rho * y.dot(q))
        d = q
        gtd = g.dot(d)
        if not float(gtd) < 0.0:
            break
        t = min(1.0, 1.0 / float(g.abs().sum())) if n == 0 else 1.0
        f_new, g_new, t, _ = _strong_wolfe(
            lambda x, tt, dd: _value_and_grad(fun, x + tt * dd),
            z, t, d, f, g, gtd)
        t = float(t)
        if not math.isfinite(f_new) or not math.isfinite(t) or t == 0.0:
            break
        s = t * d
        y = g_new - g
        ys = float(y.dot(s))
        if ys > 1e-10:
            hist.append((s, y, 1.0 / ys))
            if len(hist) > _HISTORY:
                hist.pop(0)
        z = z + s
        f, g = f_new, g_new
        n += 1
    return z, f, float(g.norm()), n
