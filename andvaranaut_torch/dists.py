"""Univariate distributions (counterpart of andvaranaut_tpu/dists.py):
Uniform, Normal, TruncNorm, LogNormal and HalfNormal natively, any other
frozen scipy.stats distribution through ScipyDist.

Parameters are Python floats.  ppf/isf/cdf/sf/logpdf/pdf take numpy
arrays, floats or tensors on any device and return float64 tensors (on
the input tensor's device, else the CPU); functions of the parameters
alone are evaluated on the host, so nothing here moves data between the
host and the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Distribution", "Uniform", "Normal", "TruncNorm", "LogNormal",
           "HalfNormal", "ScipyDist", "from_prior", "is_distribution_like"]

_LOG_2PI = math.log(2.0 * math.pi)
_TINY = torch.finfo(torch.float64).tiny
_ndtr = torch.special.ndtr
_ndtri = torch.special.ndtri


def _t(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _host(fn, v: float) -> float:
    return float(fn(torch.tensor(float(v), dtype=torch.float64)))


def _ndtr_c(x):
    """Tail-accurate standard-normal sf via erfc."""
    return 0.5 * torch.special.erfc(x / math.sqrt(2.0))


class Distribution:
    """Common methods; subclasses define ppf, cdf, logpdf, mean and std.
    The API mirrors scipy.stats frozen distributions."""

    def pdf(self, x):
        return torch.exp(self.logpdf(x))

    def sf(self, x):
        return 1.0 - self.cdf(x)

    def isf(self, q):
        return self.ppf(1.0 - _t(q))

    def var(self):
        return self.std() ** 2

    def median(self):
        return self.ppf(0.5)

    def interval(self, alpha=1.0):
        alpha = float(alpha)
        return (self.ppf((1.0 - alpha) / 2.0),
                self.ppf(1.0 - (1.0 - alpha) / 2.0))

    def support(self):
        return self.interval(1.0)

    def rvs(self, size=None, *, generator=None, random_state=None):
        """Draw samples by inverse transform from an explicit
        torch.Generator (drawn on its device), or from a fresh CPU one
        seeded with random_state (default: a seed from np.random)."""
        if generator is None:
            if random_state is None:
                random_state = int(np.random.randint(0, 2**31 - 1))
            generator = torch.Generator().manual_seed(int(random_state))
        shape = () if size is None else (
            (size,) if isinstance(size, int) else tuple(size))
        u = torch.rand(shape, generator=generator, dtype=torch.float64,
                       device=generator.device)
        u = torch.clamp(u, min=torch.finfo(torch.float64).tiny)
        return self.ppf(u).reshape(shape)


@dataclass(frozen=True)
class Uniform(Distribution):
    """Uniform on [loc, loc + scale] (scipy.stats.uniform convention)."""

    loc: float = 0.0
    scale: float = 1.0

    def ppf(self, q):
        return self.loc + self.scale * _t(q)

    def cdf(self, x):
        return torch.clamp((_t(x) - self.loc) / self.scale, 0.0, 1.0)

    def logpdf(self, x):
        x = _t(x)
        inside = (x >= self.loc) & (x <= self.loc + self.scale)
        return torch.full_like(x, -math.log(self.scale)).masked_fill(
            ~inside, -math.inf)

    def mean(self):
        return _t(self.loc + 0.5 * self.scale)

    def std(self):
        return _t(self.scale / math.sqrt(12.0))

    def interval(self, alpha=1.0):
        # exact endpoints
        alpha = float(alpha)
        return (_t(self.loc + self.scale * (1.0 - alpha) / 2.0),
                _t(self.loc + self.scale * (1.0 + alpha) / 2.0))


@dataclass(frozen=True)
class Normal(Distribution):
    loc: float = 0.0
    scale: float = 1.0

    def ppf(self, q):
        return self.loc + self.scale * _ndtri(_t(q))

    def isf(self, q):
        return self.loc - self.scale * _ndtri(_t(q))

    def cdf(self, x):
        return _ndtr((_t(x) - self.loc) / self.scale)

    def sf(self, x):
        return _ndtr(-(_t(x) - self.loc) / self.scale)

    def logpdf(self, x):
        z = (_t(x) - self.loc) / self.scale
        return -0.5 * (z * z + _LOG_2PI) - math.log(self.scale)

    def mean(self):
        return _t(self.loc)

    def std(self):
        return _t(self.scale)

    def interval(self, alpha=1.0):
        if float(alpha) >= 1.0:
            return _t(-math.inf), _t(math.inf)
        return Distribution.interval(self, alpha)


@dataclass(frozen=True)
class TruncNorm(Distribution):
    """scipy.stats.truncnorm convention: a, b in standard units of the
    underlying normal; support [loc + a*scale, loc + b*scale]."""

    a: float = -math.inf
    b: float = math.inf
    loc: float = 0.0
    scale: float = 1.0

    def _z(self, x):
        return (_t(x) - self.loc) / self.scale

    def _norm_const(self):
        return _host(_ndtr, self.b) - _host(_ndtr, self.a)

    def ppf(self, q):
        q = _t(q)
        # tail-stable: work in whichever tail is better conditioned
        if self.a >= 0.0:
            Sa, Sb = _host(_ndtr_c, self.a), _host(_ndtr_c, self.b)
            z = -_ndtri(Sa - q * (Sa - Sb))
        else:
            Fa, Fb = _host(_ndtr, self.a), _host(_ndtr, self.b)
            z = _ndtri(Fa + q * (Fb - Fa))
        return self.loc + self.scale * torch.clamp(z, self.a, self.b)

    def isf(self, q):
        return self.ppf(1.0 - _t(q))

    def cdf(self, x):
        z = torch.clamp(self._z(x), self.a, self.b)
        return (_ndtr(z) - _host(_ndtr, self.a)) / self._norm_const()

    def sf(self, x):
        z = torch.clamp(self._z(x), self.a, self.b)
        return (_ndtr_c(z) - _host(_ndtr_c, self.b)) / self._norm_const()

    def logpdf(self, x):
        z = self._z(x)
        lp = (-0.5 * (z * z + _LOG_2PI) - math.log(self.scale)
              - math.log(self._norm_const()))
        return torch.where((z >= self.a) & (z <= self.b), lp, -math.inf)

    def _phis(self):
        def phi(t):
            if not math.isfinite(t):
                return 0.0
            return math.exp(-0.5 * t * t) / math.sqrt(2.0 * math.pi)

        return phi(self.a), phi(self.b)

    def mean(self):
        pa, pb = self._phis()
        return _t(self.loc + self.scale * (pa - pb) / self._norm_const())

    def std(self):
        Z = self._norm_const()
        pa, pb = self._phis()
        a0 = self.a if math.isfinite(self.a) else 0.0
        b0 = self.b if math.isfinite(self.b) else 0.0
        var = 1.0 + (a0 * pa - b0 * pb) / Z - ((pa - pb) / Z) ** 2
        return _t(self.scale * math.sqrt(var))

    def interval(self, alpha=1.0):
        if float(alpha) >= 1.0:
            return (_t(self.loc + self.scale * self.a),
                    _t(self.loc + self.scale * self.b))
        return Distribution.interval(self, alpha)


@dataclass(frozen=True)
class LogNormal(Distribution):
    """scipy.stats.lognorm convention: s the sigma of the log, scale =
    exp(mu); PyMC's LogNormal(mu, sigma) is `from_mu_sigma(mu, sigma)`."""

    s: float = 1.0
    loc: float = 0.0
    scale: float = 1.0

    @classmethod
    def from_mu_sigma(cls, mu, sigma):
        return cls(s=float(sigma), loc=0.0, scale=math.exp(float(mu)))

    def _z(self, x):
        return (_t(x) - self.loc) / self.scale

    def ppf(self, q):
        return self.loc + self.scale * torch.exp(self.s * _ndtri(_t(q)))

    def cdf(self, x):
        z = self._z(x)
        safe = torch.clamp(z, min=_TINY)
        return torch.where(z > 0, _ndtr(torch.log(safe) / self.s), 0.0)

    def logpdf(self, x):
        z = self._z(x)
        logz = torch.log(torch.clamp(z, min=_TINY))
        lp = (-0.5 * ((logz / self.s) ** 2 + _LOG_2PI) - logz
              - math.log(self.s) - math.log(self.scale))
        return torch.where(z > 0, lp, -math.inf)

    def mean(self):
        return _t(self.loc + self.scale * math.exp(0.5 * self.s * self.s))

    def std(self):
        s2 = self.s * self.s
        return _t(self.scale * math.sqrt((math.exp(s2) - 1.0)
                                         * math.exp(s2)))

    def interval(self, alpha=1.0):
        if float(alpha) >= 1.0:
            return _t(self.loc), _t(math.inf)
        return Distribution.interval(self, alpha)


@dataclass(frozen=True)
class HalfNormal(Distribution):
    """scipy.stats.halfnorm convention: support [loc, inf)."""

    loc: float = 0.0
    scale: float = 1.0

    def _z(self, x):
        return (_t(x) - self.loc) / self.scale

    def ppf(self, q):
        return self.loc + self.scale * _ndtri(0.5 * (1.0 + _t(q)))

    def cdf(self, x):
        z = self._z(x)
        return torch.where(z > 0, torch.special.erf(z / math.sqrt(2.0)),
                           0.0)

    def logpdf(self, x):
        z = self._z(x)
        lp = math.log(2.0) - 0.5 * (z * z + _LOG_2PI) - math.log(self.scale)
        return torch.where(z >= 0, lp, -math.inf)

    def mean(self):
        return _t(self.loc + self.scale * math.sqrt(2.0 / math.pi))

    def std(self):
        return _t(self.scale * math.sqrt(1.0 - 2.0 / math.pi))

    def interval(self, alpha=1.0):
        if float(alpha) >= 1.0:
            return _t(self.loc), _t(math.inf)
        return Distribution.interval(self, alpha)


class ScipyDist(Distribution):
    """Host-side passthrough for any other frozen distribution: every
    method defers to the frozen object on numpy arrays and returns a CPU
    float64 tensor.  It serves the host paths (LHC column mapping, BO
    bounds, random draws); a device-side log density needs a native
    distribution."""

    def __init__(self, frozen):
        for m in ("ppf", "cdf", "rvs"):
            if not callable(getattr(frozen, m, None)):
                raise TypeError(
                    f"{frozen!r} lacks .{m}(); not a frozen distribution")
        self.frozen = frozen

    def __repr__(self):
        return f"ScipyDist({self.frozen!r})"

    def _call(self, method, *args):
        args = [a.cpu().numpy() if isinstance(a, torch.Tensor) else a
                for a in args]
        return _t(getattr(self.frozen, method)(*args))

    def ppf(self, q):
        return self._call("ppf", q)

    def isf(self, q):
        return self._call("isf", q)

    def cdf(self, x):
        return self._call("cdf", x)

    def sf(self, x):
        return self._call("sf", x)

    def logpdf(self, x):
        return self._call("logpdf", x)

    def pdf(self, x):
        return self._call("pdf", x)

    def mean(self):
        return self._call("mean")

    def std(self):
        return self._call("std")

    def interval(self, alpha=1.0):
        lo, hi = self.frozen.interval(float(alpha))
        return _t(lo), _t(hi)

    def rvs(self, size=None, *, generator=None, random_state=None):
        if generator is not None:
            random_state = int(torch.randint(
                0, 2**31 - 1, (), generator=generator,
                device=generator.device))
        return _t(self.frozen.rvs(size=size, random_state=random_state))


def _is_scipy_frozen(obj) -> bool:
    return getattr(type(obj), "__module__", "").startswith("scipy.stats")


def is_distribution_like(obj) -> bool:
    """Our distributions and any object with ppf/cdf/rvs."""
    if isinstance(obj, Distribution):
        return True
    return all(callable(getattr(obj, m, None)) for m in ("ppf", "cdf", "rvs"))


def from_prior(obj) -> Distribution:
    """A prior specification as a Distribution: scipy's uniform, norm,
    truncnorm, lognorm and halfnorm become native distributions; any
    other frozen distribution (or object with ppf/cdf/rvs) is wrapped in
    ScipyDist."""
    if isinstance(obj, Distribution):
        return obj
    if _is_scipy_frozen(obj) and hasattr(obj, "dist"):
        name = obj.dist.name
        shapes, loc, scale = obj.dist._parse_args(*obj.args, **obj.kwds)
        if name == "uniform":
            return Uniform(loc=float(loc), scale=float(scale))
        if name == "norm":
            return Normal(loc=float(loc), scale=float(scale))
        if name == "truncnorm":
            a, b = shapes
            return TruncNorm(a=float(a), b=float(b), loc=float(loc),
                             scale=float(scale))
        if name == "lognorm":
            (s,) = shapes
            return LogNormal(s=float(s), loc=float(loc), scale=float(scale))
        if name == "halfnorm":
            return HalfNormal(loc=float(loc), scale=float(scale))
        return ScipyDist(obj)
    if all(callable(getattr(obj, m, None)) for m in ("ppf", "cdf", "rvs")):
        return ScipyDist(obj)
    raise TypeError(
        f"Cannot interpret {obj!r} as a prior distribution; pass an "
        "andvaranaut_torch.dists.Distribution, a scipy.stats frozen "
        "distribution, or any object with ppf/cdf/rvs methods.")
