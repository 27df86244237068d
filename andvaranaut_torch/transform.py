"""Input/output warpings (counterpart of the subset of
andvaranaut_tpu/transform.py that the GPMCMC facade's fit, predict and
BO paths use: the affine family, normal, logit_logistic and logarithm).

Every transform has `con` (conversion), `rev` (reversion) and, where the
reference has one, `der` (d con / dy).  They take numpy arrays, floats or
float64 tensors on any device and return float64 tensors (on the input
tensor's device, else the CPU), so one code path serves the host-side
data conversion and the acquisition programs on the card.  Parameters
fitted from data are Python floats.  The clamping constants of the
logit/logistic pair are the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dists

__all__ = ["logit", "logistic", "std_normal", "normal_rev", "cdf_con",
           "cdf_rev", "normal", "logit_logistic", "logarithm", "affine",
           "meanstd", "minshift", "stddev", "stdshift", "maxmin", "uniform"]

_LOGIT_BND = 0.9999999999999999
_LOGISTIC_BND = 36.73680056967710072513000341132283210754394531250


def _arr(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _check_positive(value, name):
    try:
        ok = float(value) > 0.0
    except (TypeError, ValueError, RuntimeError):
        return
    if not ok:
        raise ValueError(f"Parameter {name} must be positive")


# -- free functions ----------------------------------------------------------

def _logit_clamped(x):
    x = torch.clamp(_arr(x), 1.0 - _LOGIT_BND, _LOGIT_BND)
    return torch.log(x) - torch.log1p(-x)


def _logistic_clamped(x):
    x = _arr(x)
    sign = torch.sign(x)
    ex = torch.exp(sign * torch.clamp(x, -_LOGISTIC_BND, _LOGISTIC_BND))
    return 0.5 - sign * 0.5 + sign * ex / (ex + 1.0)


def cdf_con(x, dist):
    dist = dists.from_prior(dist)
    x = _arr(x)
    return torch.where(x < dist.mean(), 1.0 - dist.sf(x), dist.cdf(x))


def cdf_rev(x, dist):
    dist = dists.from_prior(dist)
    x = _arr(x)
    return torch.where(x < 0.5, dist.isf(1.0 - x), dist.ppf(x))


def logit(x, dist):
    return _logit_clamped(cdf_con(x, dist))


def logistic(x, dist):
    return cdf_rev(_logistic_clamped(x), dist)


def std_normal(x, dist):
    dist = dists.from_prior(dist)
    return (_arr(x) - dist.mean()) / dist.std()


def normal_rev(x, dist):
    dist = dists.from_prior(dist)
    return _arr(x) * dist.std() + dist.mean()


# -- classes -----------------------------------------------------------------

class _Transform:
    """Base: subclasses implement con/rev (and der where it exists);
    conmc/revmc/dermc alias them (the reference's API)."""

    def conmc(self, y):
        return self.con(y)

    def revmc(self, y):
        return self.rev(y)

    def dermc(self, y):
        return self.der(y)


class normal(_Transform):
    def __init__(self, dist):
        self.dist = dists.from_prior(dist)

    def con(self, x):
        return std_normal(x, self.dist)

    def rev(self, x):
        return normal_rev(x, self.dist)


class logit_logistic(_Transform):
    def __init__(self, dist):
        self.dist = dists.from_prior(dist)

    def con(self, x):
        return logit(x, self.dist)

    def rev(self, x):
        return logistic(x, self.dist)


class logarithm(_Transform):
    def con(self, y):
        return torch.log(_arr(y))

    def rev(self, y):
        return torch.exp(_arr(y))

    def der(self, y):
        return 1.0 / _arr(y)


class affine(_Transform):
    def __init__(self, a, b):
        self.a = a
        self.b = b
        _check_positive(b, "b")

    def con(self, y):
        return self.a + self.b * _arr(y)

    def rev(self, y):
        return (_arr(y) - self.a) / self.b

    def der(self, y):
        return self.b * torch.ones_like(_arr(y))


def _std(y) -> float:
    return float(torch.std(_arr(y), correction=0))


class meanstd(affine):
    def __init__(self, y, mode="numpy"):
        y = _arr(y)
        mean = float(torch.mean(y))
        std = _std(y)
        self.a = -mean / std
        self.b = 1.0 / std


class minshift(affine):
    def __init__(self, y, mode="numpy", safety=1000):
        self.a = -float(torch.min(_arr(y))) * safety
        self.b = 1.0


class stddev(affine):
    def __init__(self, y, mode="numpy"):
        self.a = 0.0
        self.b = 1.0 / _std(y)


class stdshift(affine):
    def __init__(self, a, y, mode="numpy"):
        self.a = a
        self.b = 1.0 / _std(y)


class maxmin(affine):
    def __init__(self, x, centred=False, safety=0.01, mode="numpy"):
        x = _arr(x)
        xmin = float(torch.min(x))
        xmax = float(torch.max(x))
        xminus = (xmax - xmin) / (1 - 2 * safety)
        xplus = xmax + xmin
        if centred:
            self.a = -xplus / xminus
            self.b = 2.0 / xminus
        else:
            self.a = -xmin / xminus + safety
            self.b = 1.0 / xminus


class uniform(affine):
    def __init__(self, dist, safety=1e-10):
        dist = dists.from_prior(dist)
        lo, hi = (float(v) for v in dist.interval(1.0))
        xminus = (hi - lo) / (1 - 2 * safety)
        self.a = -lo / xminus + safety
        self.b = 1.0 / xminus
