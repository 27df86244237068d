"""GP conditioning, prediction and the fit configuration's hyperprior
menu (subset of andvaranaut_tpu/gp/engine.py).

Likelihood and prediction semantics match the reference:
- K = kern(xin) + I * (jitter + gv)
- logL = -1/2 y'K^-1 y - sum(log diag L) - n/2 log 2pi
- mean = Ks' K^-1 y, var = kss - |L^-1 Ks|^2 + gv (pred_noise=True)

Data is bucket-padded with phantom rows that form an identity block, so
solves and predictions are those of the real rows.  Above
`gpmcmc.GPState.MIXED_N` rows on the card, conditioning runs the mixed
blocked factorisation (`chol_state_masked_mixed`) and predictions the
blocked substitution (`predict_from_chol_masked_mixed`); below it the
exact f64 path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .._config import DTYPE, resolve_device
from ..inference.unconstrained import RV, RVPack
from . import kernels, precision

_LOG_2PI = math.log(2.0 * math.pi)


@dataclass
class FitConfig:
    """Everything the fit objective needs."""

    kerns: tuple
    ops: tuple
    noise: bool
    truncate: bool
    jitter: float
    iwgp: bool
    cwgp: bool
    priors: list            # input distributions, length nx
    xconrevs: list          # transform objects, length nx
    yconrevs: list          # transform objects, length ny (ny=1 used)
    x: np.ndarray           # (n, nx) raw inputs
    y: np.ndarray           # (n, 1) mean-subtracted raw outputs


def build_rvs(cfg: FitConfig) -> RVPack:
    """Hyperprior menu in reference RV order (gv, l, kv, alpha) —
    gpmcmc.py:193-208, truncate variants included.  The learnable
    warpings (iwgp/cwgp) need `transform.wgp`, which the port does not
    have yet (ROADMAP Queue 1 item 6)."""
    if cfg.iwgp or cfg.cwgp:
        raise NotImplementedError(
            "iwgp/cwgp need transform.wgp, not ported yet "
            "(ROADMAP Queue 1 item 6)")
    nx = cfg.x.shape[1]
    nkern = len(cfg.kerns)
    rvs = []
    if cfg.noise:
        rvs.append(RV("gv", 1, ("truncnormal", 0.0, 1e-3, 1e-15, 1.0)
                      if cfg.truncate else ("halfnormal", 1e-3)))
    rvs.append(RV("l", nx * nkern, ("truncnormal", 0.5, 0.15, 1e-3, 100.0)
                  if cfg.truncate else ("lognormal", 0.0, 1.0)))
    rvs.append(RV("kv", nkern, ("truncnormal", 1.0, 0.15, 1e-1, 100.0)
                  if cfg.truncate else ("lognormal", 0.56, 0.75)))
    if "RatQuad" in cfg.kerns:
        rvs.append(RV("alpha", 1, ("lognormal", 0.56, 0.75)))
    return RVPack(tuple(rvs))


def chol_nlml(K, y):
    """Gaussian log marginal likelihood via exact f64 Cholesky."""
    L = torch.linalg.cholesky(K)
    beta = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    return (-0.5 * (beta @ beta) - torch.log(torch.diagonal(L)).sum()
            - 0.5 * y.shape[0] * _LOG_2PI)


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_data(xin, yin, bucket: int = 32, device=None):
    """Converted data as f64 tensors on `device`, padded to the next
    bucket multiple with phantom rows; returns (xin, yin, valid)."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(xin, dtype=np.float64), device=dev)
    y = torch.as_tensor(np.asarray(yin, dtype=np.float64), device=dev)
    n = x.shape[0]
    npad = round_up(max(n, 1), bucket)
    valid = torch.arange(npad, device=dev) < n
    if npad != n:
        x = torch.cat([x, x.new_zeros((npad - n, x.shape[1]))])
        y = torch.cat([y, y.new_zeros(npad - n)])
    return x, y, valid


def _masked_gram(kerns, ops, xin, valid, l, kv, gv, alpha, jitter):
    K = kernels.gram(kerns, ops, xin, None, l, kv, alpha)
    vv = valid.to(K.dtype)
    K *= vv[:, None] * vv[None, :]
    K.diagonal().add_((1.0 - vv) + vv * (jitter + gv))
    return K


def chol_state_masked(kerns, ops, xin, yin, valid, l, kv, gv, alpha,
                      jitter):
    """Exact conditioning state over padded data: (L, L^-1 y)."""
    K = _masked_gram(kerns, ops, xin, valid, l, kv, gv, alpha, jitter)
    L = torch.linalg.cholesky(K)
    v = torch.linalg.solve_triangular(L, yin[:, None], upper=False)[:, 0]
    return L, v


def predict_from_chol_masked(kerns, ops, xin, valid, L, v, xnew, l, kv,
                             gv, alpha):
    """Predictive mean and variance (pred_noise=True) from the exact
    state."""
    Kxs = kernels.gram(kerns, ops, xin, xnew, l, kv, alpha)
    Kxs = Kxs * valid.to(Kxs.dtype)[:, None]
    A = torch.linalg.solve_triangular(L, Kxs, upper=False)
    mu = A.T @ v
    kss = kernels.gram(kerns, ops, xnew, None, l, kv, alpha, diag=True)
    # the latent variance is >= 0 in exact arithmetic; clamp round-off
    var = torch.clamp(kss - (A * A).sum(0), min=0.0) + gv
    return mu, var


def chol_state_masked_mixed(kerns, ops, xin, yin, valid, l, kv, gv, alpha,
                            jitter, block: int = 1024):
    """Large-N conditioning state through the mixed blocked
    factorisation: (L, alpha = K^-1 y, Dinv).  alpha comes from
    factorisation-preconditioned CG, so predictive means contract the
    exact cross-Gram against an f64-grade solve.  Data must be padded to
    a multiple of `block`."""
    K = _masked_gram(kerns, ops, xin, valid, l, kv, gv, alpha, jitter)
    L, Dinv = precision.blocked_cholesky(K, block=block, return_inv=True)
    av = precision.pcg_solve(K, yin, L, Dinv)
    return L, av, Dinv


def predict_from_chol_masked_mixed(kerns, ops, xin, valid, L, av, Dinv,
                                   xnew, l, kv, gv, alpha):
    """Predictive mean and variance from the mixed state: means from the
    exact cross-Gram and alpha, the variance's whitened solve through
    the blocked substitution (K2 slice products)."""
    Kxs = kernels.gram(kerns, ops, xin, xnew, l, kv, alpha)
    Kxs = Kxs * valid.to(Kxs.dtype)[:, None]
    mu = Kxs.T @ av
    A = precision.solve_lower_linear(L, Kxs, Dinv)
    kss = kernels.gram(kerns, ops, xnew, None, l, kv, alpha, diag=True)
    var = torch.clamp(kss - (A * A).sum(0), min=0.0) + gv
    return mu, var


def hypers_to_args(hypers: dict, noise: bool, device=None):
    """The JAX package's fitted hypers dict (numpy arrays: l, kv, gv,
    alpha, as GPMCMC.hypers and GPState.hypers hold them) -> (l, kv, gv,
    alpha) f64 tensors on `device`; alpha is None without RatQuad."""
    dev = resolve_device(device)

    def t(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64), device=dev)

    l = t(hypers["l"]).reshape(-1)
    kv = t(hypers["kv"]).reshape(-1)
    gv = (t(hypers["gv"]).reshape(()) if noise and "gv" in hypers
          else torch.zeros((), dtype=DTYPE, device=dev))
    alpha = (t(hypers["alpha"]).reshape(())
             if hypers.get("alpha") is not None else None)
    return l, kv, gv, alpha
