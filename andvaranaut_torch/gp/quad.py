"""Gauss-Hermite reversion statistics, vectorised over points
(counterpart of andvaranaut_tpu/gp/quad.py).

Each point's latent Gaussian (mu, var) is pushed through the output
reversion at the deg Gauss-Hermite sigma points; the points form the
rows of one (n, deg) tensor, so the whole quadrature is a few tensor
operations on the points' device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def gh_nodes(deg: int = 8, device=None):
    """Gauss-Hermite nodes and weights as float64 tensors."""
    xi, wi = np.polynomial.hermite.hermgauss(deg)
    return (torch.as_tensor(xi, device=device),
            torch.as_tensor(wi, device=device))


def _as_points(v, like=None):
    if isinstance(v, torch.Tensor):
        return v.to(torch.float64).reshape(-1)
    dev = None if like is None else like.device
    return torch.as_tensor(np.asarray(v, dtype=np.float64),
                           device=dev).reshape(-1)


def gh_stats(rev_fn, mu, var, mean_vals=None, deg: int = 8,
             EI: bool = False, EIopt: str = "min", yopt=0.0,
             normvar: bool = False):
    """Mean and variance (or EI) of the reverted variable.

    rev_fn: elementwise reversion (converted -> original space).
    mu, var: latent GP mean and variance per point, shape (n,).
    mean_vals: mean-function values per point, added after reversion,
    shape (n,) or None.
    Returns (y, yv), shape (n,) each, EI in y when EI=True."""
    mu = _as_points(mu)
    var = _as_points(var, mu)
    xi, wi = gh_nodes(deg, device=mu.device)
    isqrtpi = 1.0 / math.sqrt(math.pi)
    yi = torch.sqrt(2.0 * var)[:, None] * xi[None, :] + mu[:, None]
    yir = rev_fn(yi)
    if mean_vals is not None:
        yir = yir + _as_points(mean_vals, mu)[:, None]
    ymean = isqrtpi * (wi * yir).sum(1)
    ym2 = isqrtpi * (wi * yir ** 2).sum(1)
    if EI:
        ydiff = yir - yopt if EIopt == "max" else yopt - yir
        ydiff = torch.where(ydiff > 0.0, ydiff, 0.0)
        y = isqrtpi * (wi * ydiff).sum(1)
    else:
        y = ymean
    yv = ym2 - ymean ** 2
    if normvar:
        yv = yv / y ** 2
    return y, yv


def gh_var_inv(con_fn, yobs, yvarobs, deg: int = 8):
    """Variance of the converted variable given an observed mean and
    variance per point (the observation-noise mapping of inverse
    problems)."""
    m = _as_points(yobs)
    v = _as_points(yvarobs, m)
    xi, wi = gh_nodes(deg, device=m.device)
    isqrtpi = 1.0 / math.sqrt(math.pi)
    yir = con_fn(torch.sqrt(2.0 * v)[:, None] * xi[None, :] + m[:, None])
    ym = isqrtpi * (wi * yir).sum(1)
    ym2 = isqrtpi * (wi * yir ** 2).sum(1)
    return ym2 - ym ** 2
