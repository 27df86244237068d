"""Input/output warpings (counterpart of andvaranaut_tpu/transform.py).

Every transform has `con` (conversion), `rev` (reversion) and, for the
learnable, wgp-eligible subset, `der` (d con / dy).  They take numpy
arrays, floats or float64 tensors on any device and return float64
tensors (on the input tensor's device, else the CPU), so one code path
serves the host-side data conversion, the acquisition programs on the
card and the learnable warpings inside the fit objectives.  The clamping
constants of the logit/logistic pair are the reference's.

Parameters fitted from data (the affine family's meanstd, minshift,
stddev, stdshift, maxmin and preserve_zero) are computed as tensors from
the data tensor.  Fitted on the card, or on data that carry a gradient,
they stay 0-d tensors (no host sync, and a `wgp` stage fitted against
running warped data that depend on learnable parameters carries their
gradient, as the reference's traced refit does); fitted on host data
they are Python floats, so a fitted facade pickles without tensors.  The preprocessing fits (quantile,
robust, powerT, boxcoxf) run once on the host with numpy/scipy (not
scikit-learn); their con/rev are torch.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dists

__all__ = [
    "logit", "logistic", "std_uniform", "uniform_rev", "std_normal",
    "normal_rev", "log1p_con", "log1p_rev", "log10_con", "log10_rev",
    "nonneg_con", "nonneg_rev", "probit_con", "probit_rev", "cdf_con",
    "cdf_rev", "normalise_con", "normalise_rev", "meanstd_con", "meanstd_rev",
    "quantile_con", "quantile_rev", "robust_con", "robust_rev", "powerT_con",
    "powerT_rev",
    "normal", "logit_logistic", "probit", "cdf", "nonneg", "log1p", "log10",
    "normalise", "quantile", "robust", "powerT", "logarithm", "affine",
    "meanstd", "minshift", "stddev", "stdshift", "maxmin", "uniform",
    "arcsinh", "boxcox", "boxcoxf", "sinharcsinh", "sal", "kumaraswamy",
    "preserve_zero", "wgp",
]

_LOGIT_BND = 0.9999999999999999
_LOGISTIC_BND = 36.73680056967710072513000341132283210754394531250


def _arr(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _check_positive(value, name):
    """Refuse a parameter that is not positive.  A tensor that requires
    grad (a learnable warping's parameter inside an objective) is not
    checked, as the reference skips traced values: reading it would be a
    host sync per stage and evaluation."""
    if isinstance(value, torch.Tensor) and value.requires_grad:
        return
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


def std_uniform(x, dist):
    lo, hi = dists.from_prior(dist).interval(1.0)
    return (_arr(x) - lo) / (hi - lo)


def uniform_rev(x, dist):
    lo, hi = dists.from_prior(dist).interval(1.0)
    return _arr(x) * (hi - lo) + lo


def std_normal(x, dist):
    dist = dists.from_prior(dist)
    return (_arr(x) - dist.mean()) / dist.std()


def normal_rev(x, dist):
    dist = dists.from_prior(dist)
    return _arr(x) * dist.std() + dist.mean()


def log1p_con(y):
    return torch.log1p(_arr(y))


def log1p_rev(y):
    return torch.expm1(_arr(y))


def log10_con(y):
    return torch.log10(_arr(y))


def log10_rev(y):
    return torch.pow(10.0, _arr(y))


def nonneg_con(y):
    y = _arr(y)
    return _logit_clamped(y / (1.0 + y))


def nonneg_rev(y):
    y01 = _logistic_clamped(y)
    return y01 / (1.0 - y01)


def probit_con(x, dist):
    dist = dists.from_prior(dist)
    std_norm = dists.Normal(0.0, 1.0)
    x = _arr(x)
    xcdf = torch.where(x < 0, 1.0 - dist.sf(x), dist.cdf(x))
    return torch.where(xcdf < 0.5, std_norm.isf(1.0 - xcdf),
                       std_norm.ppf(xcdf))


def probit_rev(x, dist):
    dist = dists.from_prior(dist)
    std_norm = dists.Normal(0.0, 1.0)
    x = _arr(x)
    xcdf = torch.where(x < 0, 1.0 - std_norm.sf(x), std_norm.cdf(x))
    return torch.where(xcdf < 0.5, dist.isf(1.0 - xcdf), dist.ppf(xcdf))


def normalise_con(y, fac):
    return _arr(y) / fac


def normalise_rev(y, fac):
    return _arr(y) * fac


def meanstd_con(y, mean, std):
    return (_arr(y) - mean) / std


def meanstd_rev(y, mean, std):
    return _arr(y) * std + mean


# -- data-fitted preprocessing (host fits with numpy/scipy) -----------------
# The fits run once on the host; con/rev are torch, so the transforms
# convert tensors on any device.  Semantics follow scikit-learn's
# Quantile/Robust/PowerTransformer, as the reference's native rebuild does.

_QT_BOUND = 1e-7  # scikit-learn's BOUNDS_THRESHOLD for the normal output


def _interp(x, xp, fp):
    """numpy.interp (constant extrapolation) in the reference's form:
    the right-sided search, and the left value on a zero-width step."""
    xp = xp.to(x.device)
    fp = fp.to(x.device)
    i = torch.clamp(torch.searchsorted(xp, x.reshape(-1).contiguous(),
                                       right=True), 1,
                    xp.shape[0] - 1).reshape(x.shape)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float64).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def quantile_fit(x, n_quantiles=1000):
    """(quantiles, references) grid of an empirical-CDF map, as CPU
    float64 tensors."""
    x = np.asarray(x, dtype=float).reshape(-1)
    nq = max(2, min(int(n_quantiles), len(x)))
    refs = np.linspace(0.0, 1.0, nq)
    quants = np.nanpercentile(x, refs * 100.0)
    return torch.as_tensor(quants), torch.as_tensor(refs)


def quantile_con(y, quants, refs, mode="normal"):
    y = _arr(y)
    quants, refs = _arr(quants), _arr(refs)
    # two-sided interpolation: repeated quantile values as scikit-learn
    p = 0.5 * (_interp(y, quants, refs)
               - _interp(-y, -quants.flip(0), -refs.flip(0)))
    if mode == "normal":
        bound = float(torch.special.ndtri(torch.tensor(_QT_BOUND,
                                                       dtype=torch.float64)))
        return torch.clamp(
            torch.special.ndtri(torch.clamp(p, _QT_BOUND, 1.0 - _QT_BOUND)),
            bound, -bound)
    return p


def quantile_rev(y, quants, refs, mode="normal"):
    y = _arr(y)
    if mode == "normal":
        y = torch.special.ndtr(y)
    return _interp(y, _arr(refs), _arr(quants))


def robust_fit(x):
    """(center, scale) = (median, IQR), a zero IQR read as 1 (as
    scikit-learn)."""
    x = np.asarray(x, dtype=float).reshape(-1)
    center = float(np.median(x))
    q25, q75 = np.percentile(x, [25.0, 75.0])
    scale = float(q75 - q25)
    if scale == 0.0:
        scale = 1.0
    return center, scale


def robust_con(y, center, scale):
    return (_arr(y) - center) / scale


def robust_rev(y, center, scale):
    return _arr(y) * scale + center


def _yeojohnson_con(y, lam):
    """Yeo-Johnson forward for a float lambda; no NaN in the branch not
    taken, so its gradient is finite."""
    y = _arr(y)
    yp = torch.where(y >= 0, y, 0.0)
    yn = torch.where(y < 0, y, 0.0)
    if abs(lam) < 1e-12:
        pos = torch.log1p(yp)
    else:
        pos = ((1.0 + yp) ** lam - 1.0) / lam
    if abs(lam - 2.0) < 1e-12:
        neg = -torch.log1p(-yn)
    else:
        neg = -((1.0 - yn) ** (2.0 - lam) - 1.0) / (2.0 - lam)
    return torch.where(y >= 0, pos, neg)


def _yeojohnson_rev(y, lam):
    y = _arr(y)
    yp = torch.where(y >= 0, y, 0.0)
    yn = torch.where(y < 0, y, 0.0)
    if abs(lam) < 1e-12:
        pos = torch.expm1(yp)
    else:
        pos = (yp * lam + 1.0) ** (1.0 / lam) - 1.0
    if abs(lam - 2.0) < 1e-12:
        neg = -torch.expm1(-yn)
    else:
        neg = 1.0 - (1.0 - (2.0 - lam) * yn) ** (1.0 / (2.0 - lam))
    return torch.where(y >= 0, pos, neg)


def _boxcox_plain_con(y, lam):
    y = _arr(y)
    if abs(lam) < 1e-12:
        return torch.log(y)
    return (y ** lam - 1.0) / lam


def _boxcox_plain_rev(y, lam):
    y = _arr(y)
    if abs(lam) < 1e-12:
        return torch.exp(y)
    return (y * lam + 1.0) ** (1.0 / lam)


def power_fit(x, method="yeo-johnson", standardize=True):
    """(lambda, mean, std) by 1-D profile maximum likelihood
    (scipy.stats' normmax, the optimisation scikit-learn's
    PowerTransformer runs)."""
    import scipy.stats as st

    x = np.asarray(x, dtype=float).reshape(-1)
    if method == "yeo-johnson":
        lam = float(st.yeojohnson_normmax(x))
        xt = st.yeojohnson(x, lmbda=lam)
    elif method == "box-cox":
        lam = float(st.boxcox_normmax(x, method="mle"))
        xt = st.boxcox(x, lmbda=lam)
    else:
        raise Exception(
            "Error: power transform method must be 'yeo-johnson' or "
            "'box-cox'")
    if standardize:
        return lam, float(np.mean(xt)), float(np.std(xt))
    return lam, 0.0, 1.0


def powerT_con(y, lam, mean, std, method="yeo-johnson"):
    f = _yeojohnson_con if method == "yeo-johnson" else _boxcox_plain_con
    return (f(y, lam) - mean) / std


def powerT_rev(y, lam, mean, std, method="yeo-johnson"):
    f = _yeojohnson_rev if method == "yeo-johnson" else _boxcox_plain_rev
    return f(_arr(y) * std + mean, lam)


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


class probit(_Transform):
    def __init__(self, dist):
        self.dist = dists.from_prior(dist)

    def con(self, x):
        return probit_con(x, self.dist)

    def rev(self, x):
        return probit_rev(x, self.dist)


class cdf(_Transform):
    def __init__(self, dist):
        self.dist = dists.from_prior(dist)

    def con(self, x):
        return cdf_con(x, self.dist)

    def rev(self, x):
        return cdf_rev(x, self.dist)


class nonneg(_Transform):
    def con(self, y):
        return nonneg_con(y)

    def rev(self, y):
        return nonneg_rev(y)


class log1p(_Transform):
    def con(self, y):
        return log1p_con(y)

    def rev(self, y):
        return log1p_rev(y)


class log10(_Transform):
    def con(self, y):
        return log10_con(y)

    def rev(self, y):
        return log10_rev(y)


class normalise(_Transform):
    def __init__(self, fac):
        self.fac = fac

    def con(self, y):
        return normalise_con(y, self.fac)

    def rev(self, y):
        return normalise_rev(y, self.fac)


class quantile(_Transform):
    """Empirical-CDF quantile map to a uniform or normal target."""

    def __init__(self, x, mode="normal"):
        self.mode = mode
        self.quants, self.refs = quantile_fit(x)

    def con(self, y):
        return quantile_con(y, self.quants, self.refs, self.mode)

    def rev(self, y):
        return quantile_rev(y, self.quants, self.refs, self.mode)


class robust(_Transform):
    """Median/IQR scaling."""

    def __init__(self, x):
        self.center, self.scale = robust_fit(x)

    def con(self, y):
        return robust_con(y, self.center, self.scale)

    def rev(self, y):
        return robust_rev(y, self.center, self.scale)


class powerT(_Transform):
    """Yeo-Johnson/Box-Cox power transform, lambda by 1-D profile
    maximum likelihood, clamped to [-0.01, 1.0] as in the reference,
    standardised output."""

    def __init__(self, x, method="yeo-johnson"):
        self.method = method
        lam, mean, std = power_fit(x, method=method, standardize=True)
        self.lam = float(np.clip(lam, -0.01, 1.0))
        if self.lam != lam:
            # re-standardise against the clamped lambda
            import scipy.stats as st

            xa = np.asarray(x, dtype=float)
            xt = (st.yeojohnson(xa, lmbda=self.lam)
                  if method == "yeo-johnson"
                  else st.boxcox(xa, lmbda=self.lam))
            mean, std = float(np.mean(xt)), float(np.std(xt))
        self.mean = mean
        self.std = std

    def con(self, y):
        return powerT_con(y, self.lam, self.mean, self.std, self.method)

    def rev(self, y):
        return powerT_rev(y, self.lam, self.mean, self.std, self.method)


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
        self.default_priors = [dists.Normal(), dists.Normal()]

    def con(self, y):
        return self.a + self.b * _arr(y)

    def rev(self, y):
        return (_arr(y) - self.a) / self.b

    def der(self, y):
        return self.b * torch.ones_like(_arr(y))


def _std(y):
    return torch.std(_arr(y), correction=0)


def _fitted(v):
    """A data-fitted parameter: a float where it was computed on the CPU
    and carries no gradient, else the 0-d tensor itself."""
    if isinstance(v, torch.Tensor) and not v.requires_grad \
            and v.device.type == "cpu":
        return float(v)
    return v


class meanstd(affine):
    def __init__(self, y, mode="numpy"):
        y = _arr(y)
        mean = torch.mean(y)
        std = _std(y)
        self.a = _fitted(-mean / std)
        self.b = _fitted(1.0 / std)
        self.default_priors = [dists.Normal(), dists.Normal()]


class minshift(affine):
    def __init__(self, y, mode="numpy", safety=1000):
        self.a = _fitted(-torch.min(_arr(y)) * safety)
        self.b = 1.0
        self.default_priors = [dists.Normal(), dists.Normal()]


class stddev(affine):
    def __init__(self, y, mode="numpy"):
        self.a = 0.0
        self.b = _fitted(1.0 / _std(y))
        self.default_priors = [dists.Normal(), dists.Normal()]


class stdshift(affine):
    def __init__(self, a, y, mode="numpy"):
        self.a = a
        self.b = _fitted(1.0 / _std(y))
        self.default_priors = [dists.Normal()]


class maxmin(affine):
    def __init__(self, x, centred=False, safety=0.01, mode="numpy"):
        x = _arr(x)
        xmin = torch.min(x)
        xmax = torch.max(x)
        xminus = (xmax - xmin) / (1 - 2 * safety)
        xplus = xmax + xmin
        if centred:
            self.a = _fitted(-xplus / xminus)
            self.b = _fitted(2.0 / xminus)
        else:
            self.a = _fitted(-xmin / xminus + safety)
            self.b = _fitted(1.0 / xminus)
        self.default_priors = [dists.Normal(), dists.Normal()]


class uniform(affine):
    def __init__(self, dist, safety=1e-10):
        dist = dists.from_prior(dist)
        lo, hi = (float(v) for v in dist.interval(1.0))
        xminus = (hi - lo) / (1 - 2 * safety)
        self.a = -lo / xminus + safety
        self.b = 1.0 / xminus
        self.default_priors = [dists.Normal(), dists.Normal()]


class arcsinh(_Transform):
    def __init__(self, a, b, c, d):
        self.a, self.b, self.c, self.d = a, b, c, d
        _check_positive(b, "b")
        _check_positive(d, "d")
        self.default_priors = [dists.Normal() for _ in range(4)]

    def con(self, y):
        return self.a + self.b * torch.asinh((_arr(y) - self.c) / self.d)

    def rev(self, y):
        return self.c + self.d * torch.sinh((_arr(y) - self.a) / self.b)

    def der(self, y):
        y = _arr(y)
        return self.b / torch.sqrt(self.d ** 2 + (y - self.c) ** 2)


class boxcox(_Transform):
    """Signed-power Box-Cox shifted so that lamb=0 is (almost) the
    identity."""

    def __init__(self, lamb):
        self.lamb = lamb
        self.default_priors = [dists.Normal(0.0, 1.0)]

    def con(self, y):
        y = _arr(y)
        lambp = self.lamb + 1.0
        return (torch.sign(y) * torch.pow(torch.abs(y), lambp) - 1.0) / lambp

    def rev(self, y):
        y = _arr(y)
        lambp = self.lamb + 1.0
        term = y * lambp + 1.0
        return torch.sign(term) * torch.pow(torch.abs(term), 1.0 / lambp)

    def der(self, y):
        return torch.pow(torch.abs(_arr(y)), self.lamb)


class boxcoxf(boxcox):
    """Box-Cox with lambda fitted by 1-D profile maximum likelihood on the
    host.  Data that carry a gradient are refused: lambda cannot follow a
    learnable warping's parameters."""

    def __init__(self, y):
        if isinstance(y, torch.Tensor) and y.requires_grad:
            raise ValueError(
                "boxcoxf requires concrete data to fit lambda; it cannot be "
                "fitted inside a learnable-warping objective.")
        import scipy.stats as st

        yh = y.cpu().numpy() if isinstance(y, torch.Tensor) else y
        self.lamb = float(st.boxcox_normmax(
            np.asarray(yh, dtype=float).reshape(-1), method="mle"))
        self.default_priors = [dists.Normal(0.0, 1.0)]


class sinharcsinh(_Transform):
    def __init__(self, a, b):
        self.a, self.b = a, b
        _check_positive(b, "b")
        self.default_priors = [dists.Normal(), dists.Normal()]

    def con(self, y):
        return torch.sinh(self.b * torch.asinh(_arr(y)) - self.a)

    def rev(self, y):
        return torch.sinh((torch.asinh(_arr(y)) + self.a) / self.b)

    def der(self, y):
        y = _arr(y)
        return (self.b * torch.cosh(self.b * torch.asinh(y) - self.a)
                / torch.sqrt(1.0 + y ** 2))


class sal(_Transform):
    """sinh-arcsinh with an affine location and scale."""

    def __init__(self, a, b, c, d):
        self.a, self.b, self.c, self.d = a, b, c, d
        _check_positive(b, "b")
        _check_positive(d, "d")
        self.default_priors = [dists.Normal() for _ in range(4)]

    def con(self, y):
        return self.c + self.d * torch.sinh(
            self.b * torch.asinh(_arr(y)) - self.a)

    def rev(self, y):
        return torch.sinh(
            (torch.asinh((_arr(y) - self.c) / self.d) + self.a) / self.b)

    def der(self, y):
        y = _arr(y)
        return (self.b * self.d * torch.cosh(self.b * torch.asinh(y) - self.a)
                / torch.sqrt(1.0 + y ** 2))


class kumaraswamy(_Transform):
    """Input warping on [0, 1]."""

    def __init__(self, a, b):
        self.a, self.b = a, b
        _check_positive(a, "a")
        _check_positive(b, "b")
        self.default_priors = [dists.Normal(), dists.Normal()]

    def con(self, x):
        x = _arr(x)
        return 1.0 - torch.pow(1.0 - torch.pow(x, self.a), self.b)

    def rev(self, x):
        x = _arr(x)
        return torch.pow(1.0 - torch.pow(1.0 - x, 1.0 / self.b),
                         1.0 / self.a)

    def der(self, x):
        x = _arr(x)
        return (self.a * self.b * torch.pow(x, self.a - 1.0)
                * torch.pow(1.0 - torch.pow(x, self.a), self.b - 1.0))


class preserve_zero(affine):
    """Maps a reference yzero to 0 (delta learning)."""

    def __init__(self, y, yzero, mode="numpy"):
        ystd = _std(y)
        self.a = _fitted(-yzero / ystd)
        self.b = _fitted(1.0 / ystd)
        self.default_priors = [dists.Normal(), dists.Normal()]


# -- composite warping -------------------------------------------------------

#: stage name -> (its number of parameters, their positivity mask)
_WGP_PARAMS = {
    "affine": (2, [False, True]),
    "logarithm": (0, []),
    "arcsinh": (4, [False, True, False, True]),
    "boxcox": (1, [False]),
    "sinharcsinh": (2, [False, True]),
    "sal": (4, [False, True, False, True]),
    "kumaraswamy": (2, [True, True]),
    "stdshift": (1, [False]),
    "meanstd": (0, []),
    "minshift": (0, []),
    "stddev": (0, []),
    "boxcoxf": (0, []),
    "uniform": (0, []),
    "maxmin": (0, []),
    "pzero": (0, []),
}

_WGP_ALLOWED = list(_WGP_PARAMS)


class wgp(_Transform):
    """Composite warping over one flat parameter vector.

    `params` is a numpy array or a float64 tensor (which may require grad:
    the learnable iwgp/cwgp path) on any device.  Data-fitted stages are
    fitted against the running warped data, as in the reference, and
    `pzero` tracks the warped image of 0; both carry the parameters'
    gradient when the data are tensors on the parameters' graph.  `y`
    (and so the running data) should lie on the parameters' device."""

    def __init__(self, warpings, params, y=None, xdist=None, mode="numpy"):
        for name in warpings:
            if name not in _WGP_ALLOWED:
                raise ValueError(f"Only {_WGP_ALLOWED} classes allowed")
        self.warping_names = list(warpings)
        self.params = params
        self.warpings = []
        self.pid = np.zeros(len(warpings), dtype=np.int32)
        self.pos = np.zeros(len(params), dtype=np.bool_)
        self.default_priors = []
        pc = 0
        yzero = 0.0
        yc = _arr(y) if y is not None else None

        def need_y(name):
            if yc is None:
                raise ValueError(f"Must supply y array to use {name}")

        for pidc, name in enumerate(warpings):
            arity, posmask = _WGP_PARAMS[name]
            sp = [params[pc + k] for k in range(arity)]
            if name == "affine":
                stage = affine(*sp)
            elif name == "logarithm":
                stage = logarithm()
            elif name == "arcsinh":
                stage = arcsinh(*sp)
            elif name == "boxcox":
                stage = boxcox(lamb=sp[0])
            elif name == "sinharcsinh":
                stage = sinharcsinh(*sp)
            elif name == "sal":
                stage = sal(*sp)
            elif name == "kumaraswamy":
                stage = kumaraswamy(*sp)
            elif name == "stdshift":
                need_y(name)
                stage = stdshift(sp[0], yc)
            elif name == "meanstd":
                need_y(name)
                stage = meanstd(yc)
            elif name == "minshift":
                need_y(name)
                stage = minshift(yc)
            elif name == "stddev":
                need_y(name)
                stage = stddev(yc)
            elif name == "boxcoxf":
                need_y(name)
                stage = boxcoxf(y=yc)
            elif name == "uniform":
                if xdist is None:
                    raise ValueError(
                        "Must supply x distribution to use uniform")
                stage = uniform(xdist)
            elif name == "maxmin":
                need_y(name)
                stage = maxmin(yc)
            else:  # pzero
                need_y(name)
                stage = preserve_zero(yc, yzero)
            self.warpings.append(stage)
            if arity:
                self.pos[pc:pc + arity] = np.array(posmask, dtype=np.bool_)
                self.default_priors.extend(stage.default_priors)
                pc += arity
            self.pid[pidc] = pc
            if yc is not None:
                yc = stage.con(yc)
                yzero = stage.con(yzero)
        self.np = pc

    def con(self, y):
        res = _arr(y)
        for stage in self.warpings:
            res = stage.con(res)
        return res

    def rev(self, y):
        res = _arr(y)
        for stage in reversed(self.warpings):
            res = stage.rev(res)
        return res

    def der(self, y):
        x = _arr(y)
        res = torch.ones_like(x)
        for stage in self.warpings:
            res = res * stage.der(x)
            x = stage.con(x)
        return res

    def log_det_jac(self, y):
        """Sum of log |d con / dy|: the warping's Jacobian term of the
        log likelihood."""
        return torch.sum(torch.log(self.der(y)))
