"""Unconstrained-space reparameterisation of constrained random variables
(counterpart of andvaranaut_tpu/inference/unconstrained.py).

MAP optimisation runs over an unconstrained flat vector z; each RV
contributes its prior logpdf plus the transform log-Jacobian, as PyMC's
`find_MAP` does on transformed free RVs (this is what makes the MAP
optima match the reference's).

Priors mirror the reference's hyperprior menu (gpmcmc.py:193-264):
halfnormal (log transform), lognormal (log), normal (identity),
truncated normal and uniform (interval / log-odds transform).

Vectors are float64 tensors; `z0` and `pack_values` return them on the
CPU, where the host optimiser keeps z.  Gradients of `log_prior` come
from torch.autograd.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

_LOG_2PI = math.log(2.0 * math.pi)


def _as_f64(v):
    if isinstance(v, torch.Tensor):
        return v.to(torch.float64)
    return torch.tensor(np.asarray(v, dtype=np.float64))


@dataclass(frozen=True)
class RV:
    """One named block of the unconstrained parameter vector.

    prior: ('halfnormal', sigma) | ('lognormal', mu, sigma) |
           ('normal', mu, sigma) | ('truncnormal', mu, sigma, lo, hi) |
           ('uniform', lo, hi)
    The transform is implied by the prior family (log / log / identity /
    interval / interval respectively), matching PyMC defaults.
    """

    name: str
    size: int
    prior: tuple
    initval: float | None = None  # constrained-space start (default: moment)

    # -- transform ------------------------------------------------------
    def forward(self, z):
        """Unconstrained z -> constrained v."""
        kind = self.prior[0]
        if kind in ("halfnormal", "lognormal"):
            return torch.exp(z)
        if kind == "normal":
            return z
        if kind in ("truncnormal", "uniform"):
            lo, hi = self.prior[-2], self.prior[-1]
            return lo + (hi - lo) * torch.sigmoid(z)
        raise ValueError(kind)

    def inverse(self, v):
        v = _as_f64(v)
        kind = self.prior[0]
        if kind in ("halfnormal", "lognormal"):
            return torch.log(v)
        if kind == "normal":
            return v
        if kind in ("truncnormal", "uniform"):
            lo, hi = self.prior[-2], self.prior[-1]
            p = torch.clamp((v - lo) / (hi - lo), 1e-12, 1.0 - 1e-12)
            return torch.log(p) - torch.log1p(-p)
        raise ValueError(kind)

    def log_jac(self, z):
        """log |dv/dz| elementwise."""
        kind = self.prior[0]
        if kind in ("halfnormal", "lognormal"):
            return z
        if kind == "normal":
            return torch.zeros_like(z)
        if kind in ("truncnormal", "uniform"):
            lo, hi = self.prior[-2], self.prior[-1]
            return math.log(hi - lo) + F.logsigmoid(z) + F.logsigmoid(-z)
        raise ValueError(kind)

    # -- prior ----------------------------------------------------------
    def logpdf(self, v):
        kind = self.prior[0]
        if kind == "halfnormal":
            sigma = self.prior[1]
            return (math.log(2.0) - 0.5 * ((v / sigma) ** 2 + _LOG_2PI)
                    - math.log(sigma))
        if kind == "lognormal":
            _, mu, sigma = self.prior
            logv = torch.log(v)
            return (-0.5 * (((logv - mu) / sigma) ** 2 + _LOG_2PI) - logv
                    - math.log(sigma))
        if kind == "normal":
            _, mu, sigma = self.prior
            return (-0.5 * (((v - mu) / sigma) ** 2 + _LOG_2PI)
                    - math.log(sigma))
        if kind == "truncnormal":
            _, mu, sigma, lo, hi = self.prior
            ab = torch.tensor([(lo - mu) / sigma, (hi - mu) / sigma],
                              dtype=torch.float64)
            cdf = torch.special.ndtr(ab)
            lognorm = torch.log(cdf[1] - cdf[0]).to(v.device)
            return (-0.5 * (((v - mu) / sigma) ** 2 + _LOG_2PI)
                    - math.log(sigma) - lognorm)
        if kind == "uniform":
            _, lo, hi = self.prior
            return -math.log(hi - lo) * torch.ones_like(v)
        raise ValueError(kind)

    # -- init -----------------------------------------------------------
    def moment(self):
        """PyMC-style initial point in constrained space."""
        if self.initval is not None:
            return float(self.initval)
        kind = self.prior[0]
        if kind == "halfnormal":
            return self.prior[1] * math.sqrt(2.0 / math.pi)
        if kind == "lognormal":
            _, mu, sigma = self.prior
            return math.exp(mu + 0.5 * sigma * sigma)
        if kind == "normal":
            return self.prior[1]
        if kind == "truncnormal":
            _, mu, sigma, lo, hi = self.prior
            return float(min(max(mu, lo + 1e-3 * (hi - lo)),
                             hi - 1e-3 * (hi - lo)))
        if kind == "uniform":
            _, lo, hi = self.prior
            return 0.5 * (lo + hi)
        raise ValueError(kind)


@dataclass(frozen=True)
class RVPack:
    """A fixed ordering of RVs = a flat unconstrained vector layout."""

    rvs: tuple
    offsets: tuple = field(default=())

    def __post_init__(self):
        offs = []
        c = 0
        for rv in self.rvs:
            offs.append(c)
            c += rv.size
        object.__setattr__(self, "offsets", tuple(offs))
        object.__setattr__(self, "total", c)

    def z0(self):
        """Default start: inverse-transform of each RV's moment."""
        z = torch.zeros(self.total, dtype=torch.float64)
        for rv, off in zip(self.rvs, self.offsets):
            z[off:off + rv.size] = float(rv.inverse(rv.moment()))
        return z

    def unpack(self, z):
        """z -> dict of constrained values."""
        return {rv.name: rv.forward(z[off:off + rv.size])
                for rv, off in zip(self.rvs, self.offsets)}

    def log_prior(self, z):
        """Sum of prior logpdfs + transform Jacobians (the quantity PyMC
        maximises over transformed space in find_MAP)."""
        total = 0.0
        for rv, off in zip(self.rvs, self.offsets):
            zi = z[off:off + rv.size]
            total = total + rv.logpdf(rv.forward(zi)).sum() + \
                rv.log_jac(zi).sum()
        return total

    def pack_values(self, values: dict):
        """Constrained dict -> unconstrained flat vector (e.g. warm starts
        from fitted hypers)."""
        z = torch.zeros(self.total, dtype=torch.float64)
        for rv, off in zip(self.rvs, self.offsets):
            v = np.asarray(values[rv.name], dtype=float).reshape(-1)
            z[off:off + rv.size] = rv.inverse(v)
        return z
