"""GP conditioning, prediction and MAP fitting (counterpart of
andvaranaut_tpu/gp/engine.py).

Likelihood and prediction semantics match the reference:
- K = kern(xin) + I * (jitter + gv)
- logL = -1/2 y'K^-1 y - sum(log diag L) - n/2 log 2pi
- mean = Ks' K^-1 y, var = kss - |L^-1 Ks|^2 + gv (pred_noise=True)

Data is bucket-padded with phantom rows that form an identity block, so
solves and predictions are those of the real rows.  Conditioning runs
the exact f64 path (`chol_state_masked`, `predict_from_chol_masked`), or,
under `gpmcmc.FORCE_MIXED`, the mixed blocked factorisation
(`chol_state_masked_mixed`) and the blocked substitution
(`predict_from_chol_masked_mixed`).  `fast=True` takes the prediction cross-Gram through the
fused f32 tile kernel K9 (`kernels.gram_fast`), as the BO acquisitions
do on the card.

`map_fit` is the exact f64 MAP fit: autograd through
`torch.linalg.cholesky` and L-BFGS (`inference.lbfgs`) over the
unconstrained hyperparameters, on bucket-padded data.  With learnable
warpings (iwgp: `transform.wgp` input conversions, cwgp: a `wgp` output
conversion) the objective (`build_objective`) rebuilds the warped inputs
and targets from z at every evaluation, adds the warping's Jacobian term
sum(log der), and is differentiated by autograd through all of it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import transform as tf
from .._config import DTYPE, resolve_device
from ..inference.lbfgs import minimize_lbfgs
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
    """Hyperprior menu in reference RV order (gv, l, kv, alpha, iwgp,
    cwgp_pos, cwgp) — gpmcmc.py:193-264, truncate variants included."""
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
    if cfg.iwgp:
        rc = sum(cr.np for cr in cfg.xconrevs if isinstance(cr, tf.wgp))
        if rc == 0:
            raise Exception(
                "Error: iwgp set to true but none of xconrevs are wgp classes")
        rvs.append(RV("iwgp", rc, ("truncnormal", 1.0, 1.0, 1e-3, 5.0)
                      if cfg.truncate else ("lognormal", 0.0, 0.25)))
    if cfg.cwgp:
        if not isinstance(cfg.yconrevs[0], tf.wgp):
            raise Exception(
                "Error: cwgp set to true but yconrevs class is not wgp")
        npar = cfg.yconrevs[0].np
        if npar == 0:
            raise Exception(
                "Error: cwgp set to true but wgp class has no tuneable "
                "parameters")
        rcpos = int(np.sum(cfg.yconrevs[0].pos))
        rcfree = npar - rcpos
        if rcpos > 0:
            rvs.append(RV("cwgp_pos", rcpos,
                          ("truncnormal", 1.0, 1.0, 1e-3, 5.0)
                          if cfg.truncate else ("lognormal", 0.0, 0.25)))
        if rcfree > 0:
            rvs.append(RV("cwgp", rcfree,
                          ("truncnormal", 0.0, 1.0, -10.0, 10.0)
                          if cfg.truncate else ("normal", 0.0, 1.0)))
    return RVPack(tuple(rvs))


def interleave_cwgp(vals: dict, pos_mask):
    """The cwgp_pos and cwgp blocks merged back into the wgp's parameter
    order by its positivity mask (gpmcmc.py:265-274)."""
    pos_idx = np.cumsum(pos_mask) - 1
    free_idx = np.cumsum(~np.asarray(pos_mask)) - 1
    return torch.stack([
        vals["cwgp_pos"][pos_idx[i]] if pos_mask[i]
        else vals["cwgp"][free_idx[i]] for i in range(len(pos_mask))])


def _iwgp_xin(cfg: FitConfig, vals: dict, fixed_cols: dict, x):
    """Converted inputs at the current iwgp parameters: the wgp columns
    of x (an (n, nx) f64 tensor) warped with their stages fitted against
    the raw column (gpmcmc.py:224-231 through iwgp_set), the other
    columns from fixed_cols, their fixed conversions."""
    cols = []
    rc = 0
    for i, cr in enumerate(cfg.xconrevs):
        if isinstance(cr, tf.wgp):
            w = tf.wgp(cr.warping_names, vals["iwgp"][rc:rc + cr.np],
                       y=x[:, i], xdist=cfg.priors[i])
            cols.append(w.con(x[:, i]))
            rc += cr.np
        else:
            cols.append(fixed_cols[i])
    return torch.stack(cols, dim=1)


class _Warps:
    """The configuration's conversions on a device: the raw x and y
    columns and the fixed conversions as f64 tensors, moved there once;
    `inputs(vals)` and `targets(vals)` give the converted inputs and
    (targets, sum log der) at the unpacked values `vals`, rebuilding the
    learnable warpings from them."""

    def __init__(self, cfg: FitConfig, dev):
        self.cfg = cfg
        self.x = torch.as_tensor(np.asarray(cfg.x, dtype=np.float64),
                                 device=dev)
        self.y = torch.as_tensor(np.asarray(cfg.y[:, 0], dtype=np.float64),
                                 device=dev)
        cols = {i: torch.as_tensor(
            np.asarray(cr.con(cfg.x[:, i]), dtype=np.float64), device=dev)
            for i, cr in enumerate(cfg.xconrevs)
            if not (cfg.iwgp and isinstance(cr, tf.wgp))}
        if cfg.iwgp:
            self.fixed_cols, self.xin = cols, None
        else:
            self.xin = torch.stack([cols[i] for i in range(len(cols))], 1)
        self.yin = (None if cfg.cwgp else torch.as_tensor(
            np.asarray(cfg.yconrevs[0].con(cfg.y[:, 0]), dtype=np.float64),
            device=dev))
        self.pos_mask = (np.asarray(cfg.yconrevs[0].pos) if cfg.cwgp
                         else None)

    def inputs(self, vals):
        if self.cfg.iwgp:
            return _iwgp_xin(self.cfg, vals, self.fixed_cols, self.x)
        return self.xin

    def targets(self, vals):
        if self.cfg.cwgp:
            warper = tf.wgp(self.cfg.yconrevs[0].warping_names,
                            interleave_cwgp(vals, self.pos_mask), y=self.y)
            return warper.con(self.y), warper.log_det_jac(self.y)
        return self.yin, self.yin.new_zeros(())


def chol_nlml(K, y):
    """Gaussian log marginal likelihood via exact f64 Cholesky, of a
    matrix or a batch (..., n, n); NaN where the factorisation fails (the
    value the reference's f64 Cholesky gives there)."""
    L, info = torch.linalg.cholesky_ex(K)
    beta = torch.linalg.solve_triangular(
        L, y.expand(*K.shape[:-1])[..., None], upper=False)[..., 0]
    logl = (-0.5 * (beta * beta).sum(-1)
            - torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
            - 0.5 * y.shape[0] * _LOG_2PI)
    return torch.where(info == 0, logl, math.nan)


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


def _cross_gram(fast):
    return kernels.gram_fast if fast else kernels.gram_cross


def predict_from_chol_masked(kerns, ops, xin, valid, L, v, xnew, l, kv,
                             gv, alpha, fast: bool = False):
    """Predictive mean and variance (pred_noise=True) from the exact
    state."""
    Kxs = _cross_gram(fast)(kerns, ops, xin, xnew, l, kv, alpha)
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
                                   xnew, l, kv, gv, alpha,
                                   fast: bool = False):
    """Predictive mean and variance from the mixed state: means from the
    exact cross-Gram (K9's with fast=True) and alpha, the variance's
    whitened solve through the blocked substitution (K2 slice products),
    differentiable in xnew through `precision.solve_lower_linear`."""
    Kxs = (kernels.gram_fast if fast else kernels.gram)(
        kerns, ops, xin, xnew, l, kv, alpha)
    Kxs = Kxs * valid.to(Kxs.dtype)[:, None]
    mu = Kxs.T @ av
    A = precision.solve_lower_linear(L, Kxs, Dinv)
    kss = kernels.gram(kerns, ops, xnew, None, l, kv, alpha, diag=True)
    var = torch.clamp(kss - (A * A).sum(0), min=0.0) + gv
    return mu, var


def predict_diag(kerns, ops, xin, yin, xnew, l, kv, gv, alpha, jitter):
    """Latent predictive mean and variance with noise (pred_noise=True)
    of unpadded data, conditioned afresh in exact f64 on xin's device."""
    L, v = chol_state(kerns, ops, xin, yin, l, kv, gv, alpha, jitter)
    return predict_from_chol(kerns, ops, xin, L, v, xnew, l, kv, gv, alpha)


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


def chol_state(kerns, ops, xin, yin, l, kv, gv, alpha, jitter):
    """Conditioning state of unpadded data: (L, L^-1 y)."""
    K = kernels.gram(kerns, ops, xin, None, l, kv, alpha)
    K.diagonal().add_(jitter + gv)
    L = torch.linalg.cholesky(K)
    v = torch.linalg.solve_triangular(L, yin[:, None], upper=False)[:, 0]
    return L, v


def predict_from_chol(kerns, ops, xin, L, v, xnew, l, kv, gv, alpha,
                      fast: bool = False):
    """Predictive mean and variance (pred_noise=True) from `chol_state`."""
    Kxs = _cross_gram(fast)(kerns, ops, xin, xnew, l, kv, alpha)
    A = torch.linalg.solve_triangular(L, Kxs, upper=False)
    mu = A.T @ v
    kss = kernels.gram(kerns, ops, xnew, None, l, kv, alpha, diag=True)
    var = torch.clamp(kss - (A * A).sum(0), min=0.0) + gv
    return mu, var


def _converted(cfg: FitConfig):
    """The configuration's converted inputs and outputs (float64 numpy
    arrays)."""
    nx = cfg.x.shape[1]
    xin = np.zeros((cfg.x.shape[0], nx))
    for i in range(nx):
        xin[:, i] = np.asarray(cfg.xconrevs[i].con(cfg.x[:, i]))
    yin = np.asarray(cfg.yconrevs[0].con(cfg.y[:, 0]), dtype=np.float64)
    return xin, yin


def unpack_hypers(rvpack, z, noise, has_alpha):
    """(gv, l, kv, alpha) from the unconstrained vector z."""
    vals = rvpack.unpack(z)
    gv = vals["gv"][0] if noise else z.new_zeros(())
    alpha = vals["alpha"][0] if has_alpha else None
    return gv, vals["l"], vals["kv"], alpha


def build_objective(cfg: FitConfig, device=None):
    """(rvpack, neg_log_post): neg_log_post(z) is minus the log posterior
    of the exact f64 NLML plus the hyperprior menu, differentiable by
    autograd; z lives on `device` (None: the card).  A Gram that is not
    positive definite gives NaN.  With iwgp/cwgp the warped inputs and
    targets are rebuilt from z at every evaluation and the warping's
    Jacobian term sum(log der) joins the likelihood.

    neg_log_post.vec_value_and_grad(Z) evaluates a batch of chains, Z
    (C, dim) array-like -> (values (C,), gradients (C, dim)) numpy f64.
    Unwarped: the C Grams and priors through torch.func.vmap, one batched
    f64 `torch.linalg.cholesky_ex` and triangular solve, and one autograd
    pass for all chains.  Warped: chain by chain (the warpings' data fits
    refit per chain), each by autograd of neg_log_post.
    neg_log_post.replicate(device) builds the same objective on another
    device (the samplers' in-process chain shards)."""
    dev = resolve_device(device)
    if cfg.iwgp or cfg.cwgp:
        return _warped_objective(cfg, dev)
    rvpack = build_rvs(cfg)
    xin, yin = _converted(cfg)
    xin = torch.as_tensor(xin, device=dev)
    yin = torch.as_tensor(yin, device=dev)
    eye = torch.eye(xin.shape[0], dtype=DTYPE, device=dev)

    has_alpha = "RatQuad" in cfg.kerns

    def gram_noise(z):
        gv, l, kv, alpha = unpack_hypers(rvpack, z, cfg.noise, has_alpha)
        K = kernels.gram(cfg.kerns, cfg.ops, xin, None, l, kv, alpha)
        return K + eye * (cfg.jitter + gv)

    def neg_log_post(z):
        return -(chol_nlml(gram_noise(z), yin) + rvpack.log_prior(z))

    def vec_value_and_grad(Z):
        Zt = torch.as_tensor(np.asarray(Z, dtype=np.float64), device=dev)
        Zt = Zt.reshape(-1, rvpack.total).requires_grad_()
        K = torch.func.vmap(gram_noise)(Zt)
        lp = torch.func.vmap(rvpack.log_prior)(Zt)
        u = -(chol_nlml(K, yin) + lp)
        (g,) = torch.autograd.grad(u.sum(), Zt)
        return u.detach().cpu().numpy(), g.cpu().numpy()

    neg_log_post.vec_value_and_grad = vec_value_and_grad
    neg_log_post.replicate = lambda d: build_objective(cfg, device=d)[1]
    return rvpack, neg_log_post


def _warped_objective(cfg: FitConfig, dev):
    """`build_objective` of an iwgp/cwgp configuration on `dev`."""
    rvpack = build_rvs(cfg)
    warps = _Warps(cfg, dev)
    has_alpha = "RatQuad" in cfg.kerns

    def neg_log_post(z):
        vals = rvpack.unpack(z)
        gv, l, kv, alpha = unpack_hypers(rvpack, z, cfg.noise, has_alpha)
        yin, ldj = warps.targets(vals)
        K = kernels.gram(cfg.kerns, cfg.ops, warps.inputs(vals), None, l,
                         kv, alpha)
        K.diagonal().add_(cfg.jitter + gv)
        return -(chol_nlml(K, yin) + ldj + rvpack.log_prior(z))

    def vec_value_and_grad(Z):
        Zt = torch.as_tensor(np.asarray(Z, dtype=np.float64), device=dev)
        us, gs = [], []
        for z in Zt.reshape(-1, rvpack.total):
            zz = z.clone().requires_grad_()
            u = neg_log_post(zz)
            (g,) = torch.autograd.grad(u, zz)
            us.append(u.detach())
            gs.append(g)
        return torch.stack(us).cpu().numpy(), torch.stack(gs).cpu().numpy()

    neg_log_post.vec_value_and_grad = vec_value_and_grad
    neg_log_post.replicate = lambda d: build_objective(cfg, device=d)[1]
    return rvpack, neg_log_post


def make_fit_program(kerns, ops, noise: bool, truncate: bool, jitter: float,
                     nx: int, max_iter: int = 500, tol: float = 1e-8):
    """(rvpack, run) of the plain MAP fit over bucket-padded data:
    run(z0, xin, yin, valid, nreal) -> (z, value) minimises minus the log
    posterior by L-BFGS from z0, on xin's device.  Phantom rows form an
    identity block; the likelihood's constant counts the nreal real rows.
    A factorisation that fails reads as a non-finite value."""
    cfg_rvs = FitConfig(
        kerns=kerns, ops=ops, noise=noise, truncate=truncate, jitter=jitter,
        iwgp=False, cwgp=False, priors=[None] * nx, xconrevs=[None] * nx,
        yconrevs=[None], x=np.zeros((1, nx)), y=np.zeros((1, 1)))
    rvpack = build_rvs(cfg_rvs)

    has_alpha = "RatQuad" in kerns

    def nlp(z, xin, yin, valid, nreal):
        gv, l, kv, alpha = unpack_hypers(rvpack, z, noise, has_alpha)
        K = kernels.gram(kerns, ops, xin, None, l, kv, alpha)
        vv = valid.to(K.dtype)
        K = K * (vv[:, None] * vv[None, :])
        K = K + torch.diag((1.0 - vv) + vv * (jitter + gv))
        L, info = torch.linalg.cholesky_ex(K)
        beta = torch.linalg.solve_triangular(L, yin[:, None],
                                             upper=False)[:, 0]
        logl = (-0.5 * (beta @ beta) - torch.log(torch.diagonal(L)).sum()
                - 0.5 * nreal * _LOG_2PI)
        logl = torch.where(info == 0, logl, math.nan)
        return -(logl + rvpack.log_prior(z))

    def run(z0, xin, yin, valid, nreal):
        z, val, _, _ = minimize_lbfgs(
            lambda z: nlp(z, xin, yin, valid, nreal),
            z0.to(device=xin.device, dtype=DTYPE),
            max_iter=max_iter, tol=tol)
        return z, val

    return rvpack, run


_FIT_PROGRAMS: dict = {}


def get_fit_program(kerns, ops, noise, truncate, jitter, nx,
                    max_iter: int = 500, tol: float = 1e-8):
    """`make_fit_program`, one per model spec (the reference keys its
    compiled programs the same way)."""
    key = (tuple(kerns), tuple(ops), bool(noise), bool(truncate),
           float(jitter), int(nx), int(max_iter), float(tol))
    if key not in _FIT_PROGRAMS:
        _FIT_PROGRAMS[key] = make_fit_program(
            tuple(kerns), tuple(ops), bool(noise), bool(truncate),
            float(jitter), int(nx), max_iter=max_iter, tol=tol)
    return _FIT_PROGRAMS[key]


def map_fit(cfg: FitConfig, start: dict | None = None, restarts: int = 1,
            seed: int = 0, max_iter: int = 500, tol: float = 1e-8,
            device=None):
    """Exact f64 MAP fit with restarts (restarts after the first from
    random unconstrained starts) on `device` (None: the card).  The plain
    fit runs on bucket-padded data (`get_fit_program`); a fit with
    learnable warpings minimises `build_objective`'s.  Returns (hypers
    dict of numpy arrays, iwgp/cwgp blocks included, logpost)."""
    dev = resolve_device(device)
    if cfg.iwgp or cfg.cwgp:
        rvpack, nlp = build_objective(cfg, device=dev)

        def attempt(zr):
            z, val, _, _ = minimize_lbfgs(
                nlp, zr.to(device=dev, dtype=DTYPE), max_iter=max_iter,
                tol=tol)
            return z, val
    else:
        nx = cfg.x.shape[1]
        xin, yin = _converted(cfg)
        xin_p, yin_p, valid = pad_data(xin, yin, device=dev)
        rvpack, run = get_fit_program(
            cfg.kerns, cfg.ops, cfg.noise, cfg.truncate, cfg.jitter, nx,
            max_iter=max_iter, tol=tol)
        nreal = float(cfg.x.shape[0])

        def attempt(zr):
            return run(zr, xin_p, yin_p, valid, nreal)
    z0 = rvpack.z0()
    if start is not None:
        try:
            z0 = rvpack.pack_values(start)
        except (KeyError, TypeError):
            pass
    best_z, best_val = None, np.inf
    rng = np.random.default_rng(seed)
    for r in range(max(1, restarts)):
        zr = z0 if r == 0 else torch.as_tensor(rng.normal(size=rvpack.total))
        z, val = attempt(zr)
        if np.isfinite(val) and val < best_val:
            best_val, best_z = val, z
    if best_z is None:
        raise RuntimeError("MAP optimisation failed from all starts")
    hypers = {k: v.detach().cpu().numpy()
              for k, v in rvpack.unpack(best_z).items()}
    if "gv" in hypers:
        hypers["gv"] = hypers["gv"].reshape(())
    if "alpha" in hypers:
        hypers["alpha"] = hypers["alpha"].reshape(())
    return hypers, -best_val
