"""Large-N MAP fitting through the mixed-precision path (counterpart of
andvaranaut_tpu/gp/bigfit.py).

The gradient is the classical closed form, what the reference's
PyTensor graph computes symbolically (gpmcmc.py:326-346 via
pm.find_MAP):

    d logL / d theta = 1/2 a' (dK/dtheta) a - 1/2 tr(K^-1 dK/dtheta),
    a = K^-1 y

One explicit K^-1 serves every hyperparameter.  It is formed on lower
256-tiles only: L^-1 by the pair-carry identity solve (K4), sliced with
column scales (K5), then K^-1 = L^-T L^-1 (K6); a single-block
factorisation already holds L^-1 and goes straight to K7, and at blocks
off the 256 grain L^-1 comes from the generic identity solve, then K7.
K5-K7 run at 8 slices where the reference ran 6 (slicemm.TN_NSLICES
gives the measured reason: the contraction against dK sums the slice
truncation over all n^2 entries).  The contraction against dK/dtheta
runs over column blocks of the Gram, each differentiated by
torch.autograd with a and K^-1 held fixed, so no factorisation is ever
differentiated and no n^2 autograd buffer exists.

The fit itself is host scipy L-BFGS-B over the unconstrained
hyperparameters, with the reference hyperprior menu (gpmcmc.py:193-208,
truncate variants included) through `engine.build_rvs`.

With learnable warpings (`make_warped_vg`, `big_warped_map_fit`) the
inputs x~(z) and targets y~(z) depend on z.  The factorisation, the
refined solve and K^-1 run as above on the warped data.  The iwgp
gradient flows through the Gram column blocks' autograd, which rebuilds
the warped inputs inside each block (O(n) a block).  The cwgp gradient
needs no factorisation: d(-1/2 y~' K^-1 y~)/dp = -a' dy~/dp with
a = K^-1 y~ held fixed, plus the Jacobian term sum(log der), in one
autograd pass over n-sized tensors.

The MCMC samplers evaluate the objective for a batch of chains at once
(`make_mixed_objective`'s `vec_value_and_grad`, the reference's jax.vmap
of its value+grad).  Where the factorisation is one block (n <= 512),
`_nlml_vg_batched` stacks the chains' Grams and runs ONE batched K3
launch and ONE batched K7 launch for all of them; the O(n^2) solves and
the gradient contraction run per chain through the serial path's own
functions, so each chain's value and gradient equal the serial
`_nlml_vg`'s bit for bit.  Above one block it loops over the chains
through `_nlml_vg` (the reference's lax.map route).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .._config import DTYPE, resolve_device
from ..lhc import _none_conrev
from . import engine, kernels, panel, precision, slicemm

_LOG_2PI = math.log(2.0 * math.pi)

#: refinement sweeps of the L^-1 identity solve inside the gradient
#: pipeline (the reference's ANDVARANAUT_GRAD_INV_ITERS at its default:
#: with 0 sweeps its 16k fit stopped ~13 nats early on gradient noise)
GRAD_INV_ITERS = 1
#: width of the gradient's Gram column blocks
GRAD_COLS = 2048


def _default_rvpack(nx, kerns, noise, truncate=False):
    cfg = engine.FitConfig(
        kerns=tuple(kerns), ops=(), noise=noise, truncate=truncate,
        jitter=0.0, iwgp=False, cwgp=False, priors=[None] * nx,
        xconrevs=[_none_conrev()] * nx, yconrevs=[_none_conrev()],
        x=np.zeros((1, nx)), y=np.zeros((1, 1)))
    return engine.build_rvs(cfg)


def _as_tensor(v, dev):
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=DTYPE)
    return torch.as_tensor(np.asarray(v, dtype=np.float64), device=dev)


def _kinv_lower(L, Dinv, n, inv_iters):
    """K^-1 on lower 256-tiles (strictly-upper tiles exact zeros) from the
    factor L and its diagonal-block inverses, by the reference's routes.
    One block: K7 on tril(Dinv[0]).  Several, at a block on the 256 grain:
    L^-1 as a pair (K4 identity solve), its slices (K5), W^T W (K6); a
    factorisation padded past n (identity rows) pads L the same way,
    which leaves K^-1's leading n x n block exact.  Any other block: L^-1
    by the generic identity solve (`precision.blocked_inv_lower`), then
    K7."""
    if Dinv.shape[0] == 1 and Dinv.shape[1] == n:
        return precision.slice_syrk_tn_lower(torch.tril(Dinv[0]),
                                             w_lower=True)
    block = Dinv.shape[1]
    npad = Dinv.shape[0] * block
    if not precision._use_pair_carry(block, npad):
        Linv = precision.blocked_inv_lower(L, Dinv, solve_iters=inv_iters)
        return precision.slice_syrk_tn_lower(Linv, w_lower=True)
    if npad != n:
        Lp = torch.eye(npad, dtype=L.dtype, device=L.device)
        Lp[:n, :n] = L
        L = Lp
    rhi, rlo = precision.blocked_inv_lower(L, Dinv, solve_iters=inv_iters,
                                           return_pair=True)
    w_sl, sW = panel.pair_to_slices_cols(rhi, rlo)
    del rhi, rlo
    C = slicemm.syrk_tn_lower_presliced(w_sl, sW, w_lower=True)
    return C if npad == n else C[:n, :n]


def _gram_noise(X, z, rvpack, kerns, ops, noise, jitter):
    """K(z) + (jitter + gv) I."""
    gv, l, kv, alpha = engine.unpack_hypers(rvpack, z, noise,
                                            "RatQuad" in kerns)
    K = kernels.gram(kerns, ops, X, None, l, kv, alpha)
    K.diagonal().add_(jitter + gv)
    return K


def _logl_alpha(L, K, y, Dinv):
    """(logL, a = K^-1 y) from the factorisation: refined solve, then
    the quadratic form and the log-determinant."""
    a = precision.refined_chol_solve(L, K, y, Dinv)
    logl = (-0.5 * (y @ a) - torch.log(torch.diagonal(L)).sum()
            - 0.5 * y.shape[0] * _LOG_2PI)
    return logl, a


def _nlml_vg(X, y, z, rvpack, kerns, ops, noise, jitter, block, inv_iters):
    """(logL, d logL / dz) for f64 tensors X (n, nx), y (n,), z on one
    device.  `_nlml_vg.calls` counts the evaluations."""
    _nlml_vg.calls += 1
    n = X.shape[0]
    with torch.no_grad():
        K = _gram_noise(X, z, rvpack, kerns, ops, noise, jitter)
        L, Dinv = precision.blocked_cholesky(K, block=block,
                                             return_inv=True)
        logl, a = _logl_alpha(L, K, y, Dinv)
        del K
        C = _kinv_lower(L, Dinv, n, inv_iters)
        del L, Dinv
    return logl, _grad_from_kinv(X, a, C, z, rvpack, kerns, ops, noise,
                                 jitter)


def _nlml_vg_batched(X, y, Z, rvpack, kerns, ops, noise, jitter, block,
                     inv_iters):
    """(logL (C,), d logL / dz (C, dim)) for the rows of Z (C, dim): each
    chain's `_nlml_vg`, bit for bit.  At one block
    (`precision.single_block_batched`): the C Grams stacked, their
    factorisations in one batched K3 launch
    (`precision.single_block_cholesky_batched`, one host sync for the
    gates), the refined solves per chain, K^-1 = L^-T L^-1 for all chains
    in one batched K7 launch (`slicemm.syrk_tn_lower_batched` on
    tril(Dinv)), the gradient contraction per chain.  Otherwise
    `_nlml_vg` chain by chain.  A chain whose factorisation the f64
    fallback refuses (not positive definite) gets NaN, so that the others
    go on.  `_nlml_vg.calls` counts each chain."""
    n = X.shape[0]
    if not precision.single_block_batched(n, block):
        def one(z):
            try:
                return _nlml_vg(X, y, z, rvpack, kerns, ops, noise, jitter,
                                block, inv_iters)
            except torch.linalg.LinAlgError:
                return z.new_full((), math.nan), torch.full_like(z, math.nan)

        outs = [one(z) for z in Z]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    _nlml_vg.calls += Z.shape[0]
    with torch.no_grad():
        K = torch.stack([_gram_noise(X, z, rvpack, kerns, ops, noise, jitter)
                         for z in Z])
        L, Dinv = precision.single_block_cholesky_batched(K)
        la = [_logl_alpha(L[c], K[c], y, Dinv[c][None])
              for c in range(Z.shape[0])]
        del K
        Cm = slicemm.syrk_tn_lower_batched(torch.tril(Dinv), w_lower=True)
        del L, Dinv
    grads = [_grad_from_kinv(X, a, Cm[c], Z[c], rvpack, kerns, ops, noise,
                             jitter) for c, (_, a) in enumerate(la)]
    return torch.stack([v for v, _ in la]), torch.stack(grads)


def _grad_from_kinv(X, a, C, z, rvpack, kerns, ops, noise, jitter,
                    xin_of=None):
    """d logL / dz from a = K^-1 y and K^-1's lower 256-tiles C:
    d/dz sum(W o K(z)) = (a' dK a - tr(K^-1 dK)) / 2 with
    W = (a a' - K^-1) / 2, column block by column block, by autograd of
    the Gram's columns with a and C held fixed.  K^-1's columns come
    from C's lower tiles: rows in tiles at or below the column's tile
    from C's columns, the rest from C's rows transposed (diagonal tiles
    are computed in full, so either source holds there).  xin_of(vals),
    where given, rebuilds the inputs from the unpacked values inside each
    block (the iwgp warpings), so that the gradient reaches their
    parameters on the row and the column side; X is then unused."""
    n = a.shape[0]
    has_alpha = "RatQuad" in kerns
    tg = slicemm.TILE
    row_tile = torch.arange(n, device=a.device)[:, None] // tg
    grad = torch.zeros_like(z)
    gb = min(GRAD_COLS, n)
    for s in range(0, n, gb):
        e = min(s + gb, n)
        with torch.no_grad():
            col_tile = torch.arange(s, e, device=a.device)[None, :] // tg
            KinvB = torch.where(row_tile >= col_tile, C[:, s:e], C[s:e].T)
            WB = 0.5 * (a[:, None] * a[None, s:e] - KinvB)
            del KinvB
        with torch.enable_grad():
            zz = z.detach().requires_grad_()
            gv, l, kv, alpha = engine.unpack_hypers(rvpack, zz, noise,
                                                    has_alpha)
            if xin_of is not None:
                X = xin_of(rvpack.unpack(zz))
            Kc = kernels.gram(kerns, ops, X, X[s:e], l, kv, alpha)
            # the (jitter + gv) diagonal of these columns, summed apart
            h = (WB * Kc).sum() + (jitter + gv) * WB[s:e].diagonal().sum()
            grad += torch.autograd.grad(h, zz)[0]
    return grad


_nlml_vg.calls = 0


def nlml_value_and_grad(X, y, z, kerns=("RBF",), ops=(), noise=True,
                        jitter=1e-6, block: int = 1024, rvpack=None,
                        device=None):
    """Log marginal likelihood and its gradient with respect to the
    unconstrained z, through the mixed-precision blocked factorisation,
    for the full kernel algebra.  z lives in the rvpack's unconstrained
    space (the default: the plain menu for `kerns`).  Inputs go to
    `device` (None: the CUDA card).  Returns (logl 0-d tensor, grad)."""
    dev = resolve_device(device)
    X = _as_tensor(X, dev)
    y = _as_tensor(y, dev).reshape(-1)
    z = _as_tensor(z, dev)
    if rvpack is None:
        rvpack = _default_rvpack(X.shape[1], kerns, noise)
    return _nlml_vg(X, y, z, rvpack, tuple(kerns), tuple(ops), noise,
                    float(jitter), int(block), GRAD_INV_ITERS)


def make_mixed_objective(X, y, kerns=("RBF",), ops=(), noise=True,
                         truncate=False, jitter=1e-6, block: int = 256,
                         device=None):
    """(rvpack, neg_log_post) with the NLML through the mixed-precision
    factorisation.  neg_log_post(z) is differentiable by torch.autograd:
    its likelihood term is an autograd Function whose forward computes
    value and closed-form gradient together and whose backward returns
    the saved gradient times the incoming cotangent.

    neg_log_post.vec_value_and_grad(Z) evaluates a batch of chains: Z
    (C, dim) array-like -> (values (C,), gradients (C, dim)) numpy f64 of
    neg_log_post, through `_nlml_vg_batched` (one batched K3 and one
    batched K7 launch for all chains at n <= 512).  Each row equals the
    value and autograd gradient of neg_log_post at that row bit for bit;
    a chain whose factorisation the f64 fallback refuses gives NaN.
    neg_log_post.replicate(device) builds the same objective on another
    device (the samplers' in-process chain shards)."""
    dev = resolve_device(device)
    X = _as_tensor(X, dev)
    y1 = _as_tensor(y, dev).reshape(-1)
    kerns = tuple(kerns)
    ops = tuple(ops)
    rvpack = _default_rvpack(X.shape[1], kerns, noise, truncate)

    class _LogL(torch.autograd.Function):
        @staticmethod
        def forward(ctx, z):
            val, grad = nlml_value_and_grad(
                X, y1, z, kerns=kerns, ops=ops, noise=noise, jitter=jitter,
                block=block, rvpack=rvpack, device=dev)
            ctx.save_for_backward(grad.to(z.device))
            return val.to(z.device)

        @staticmethod
        def backward(ctx, ct):
            (grad,) = ctx.saved_tensors
            return ct * grad

    def neg_log_post(z):
        return -(_LogL.apply(z) + rvpack.log_prior(z))

    def vec_value_and_grad(Z):
        Zd = _as_tensor(Z, dev).reshape(-1, rvpack.total)
        logl, g = _nlml_vg_batched(X, y1, Zd, rvpack, kerns, ops, noise,
                                   float(jitter), int(block), GRAD_INV_ITERS)
        us, gs = [], []
        for c, z in enumerate(Zd):
            zz = z.clone().requires_grad_()
            lp = rvpack.log_prior(zz)
            (gp,) = torch.autograd.grad(lp, zz)
            us.append(-(logl[c] + lp.detach()))
            gs.append(-(g[c] + gp))
        return torch.stack(us).cpu().numpy(), torch.stack(gs).cpu().numpy()

    neg_log_post.vec_value_and_grad = vec_value_and_grad
    neg_log_post.replicate = lambda d: make_mixed_objective(
        X, y, kerns, ops, noise, truncate, jitter, block, device=d)[1]
    return rvpack, neg_log_post


def make_warped_vg(cfg, block: int = 1024, device=None):
    """(rvpack, value_and_grad) of an iwgp/cwgp FitConfig through the
    mixed-precision factorisation: value_and_grad(z) -> (logL, d logL /
    dz), logL including the warping's Jacobian term, z array-like or a
    tensor; the data go to `device` (None: the CUDA card) once.

    The kernel hyperparameters' gradient is `_nlml_vg`'s closed form
    (K1-K6 at 16k; K7 at one block), with the warped inputs rebuilt
    inside each Gram column block for iwgp; the cwgp gradient is one
    autograd pass of -a' y~(z) + sum log der(z) with a = K^-1 y~ held.
    The RVs and priors are `engine.build_rvs`'s; data-fitted wgp stages
    refit against the running warped data at every evaluation, as in
    `engine.build_objective`.  `value_and_grad.calls` counts the
    evaluations."""
    dev = resolve_device(device)
    rvpack = engine.build_rvs(cfg)
    n = cfg.x.shape[0]
    kerns, ops = tuple(cfg.kerns), tuple(cfg.ops)
    noise, jitter = cfg.noise, float(cfg.jitter)
    warps = engine._Warps(cfg, dev)
    xin_of = warps.inputs if cfg.iwgp else None

    def value_and_grad(z):
        value_and_grad.calls += 1
        with torch.enable_grad():
            # the warpings' parameters require grad: no positivity check
            # reads them back (transform._check_positive)
            zz = _as_tensor(z, dev).detach().requires_grad_()
            vals = rvpack.unpack(zz)
            yin, ldj = warps.targets(vals)
            xin = warps.inputs(vals)
        with torch.no_grad():
            K = _gram_noise(xin.detach(), zz.detach(), rvpack, kerns, ops,
                            noise, jitter)
            L, Dinv = precision.blocked_cholesky(K, block=block,
                                                 return_inv=True)
            logl, a = _logl_alpha(L, K, yin.detach(), Dinv)
            del K
            C = _kinv_lower(L, Dinv, n, GRAD_INV_ITERS)
            del L, Dinv
        grad = _grad_from_kinv(xin.detach(), a, C, zz.detach(), rvpack,
                               kerns, ops, noise, jitter, xin_of=xin_of)
        del C
        if cfg.cwgp:
            with torch.enable_grad():
                (gw,) = torch.autograd.grad(-(a @ yin) + ldj, zz)
            grad = grad + gw
        return logl + ldj.detach(), grad

    value_and_grad.calls = 0
    return rvpack, value_and_grad


def big_warped_map_fit(cfg, block: int = 1024, maxiter: int = 50,
                       start=None, restarts: int = 1, seed: int = 0,
                       verbose: bool = False, ftol: float = 1e-7,
                       device=None):
    """MAP fit with learnable warpings (iwgp/cwgp) at large N: host scipy
    L-BFGS-B over `make_warped_vg`'s value and gradient plus the
    hyperprior menu.  No log-space box (the reference's: the warping
    parameters are held by their priors); a non-finite evaluation steers
    the line search back as in `big_map_fit`.  The data go to `device`
    (None: the CUDA card) once; z stays on the host.

    Returns (hypers dict of numpy arrays, iwgp/cwgp blocks included, log
    posterior)."""
    rvpack, vg = make_warped_vg(cfg, block=block, device=device)
    return _lbfgsb_restarts(vg, rvpack, start, restarts, seed, None,
                            maxiter, ftol, verbose, "big_warped_map_fit",
                            "mixed-precision warped MAP")


def _lbfgsb_restarts(logl_grad, rvpack, start, restarts, seed, bounds,
                     maxiter, ftol, verbose, who, what):
    """scipy L-BFGS-B on minus the log posterior, logl_grad(z numpy) ->
    (logL, d logL / dz) tensors plus the hyperprior (on the host), from
    `start` (the menu's z0 when None), then from random unconstrained
    starts; the best finite result as (hypers dict of numpy arrays, log
    posterior).  A factorisation that the f64 fallback refuses reads as
    NaN, the value the reference sees there, and a non-finite evaluation
    steers the line search back (1e12, its gradient's non-finite entries
    zeroed)."""
    from scipy.optimize import minimize

    def fun(z_np):
        t0 = time.perf_counter()
        try:
            logl, g = logl_grad(z_np)
            logl, g = float(logl), g.cpu().numpy()
        except torch.linalg.LinAlgError:
            logl, g = math.nan, np.zeros(rvpack.total)
        z = torch.tensor(z_np, dtype=DTYPE, requires_grad=True)
        lp = rvpack.log_prior(z)
        (gp,) = torch.autograd.grad(lp, z)
        val = -(logl + float(lp.detach()))
        grad = -(g + gp.numpy())
        if not np.isfinite(val) or not np.isfinite(grad).all():
            val = 1e12
            grad = np.nan_to_num(grad, nan=0.0, posinf=0.0, neginf=0.0)
        if verbose:
            print(f"  nlp={val:.6f} ({time.perf_counter() - t0:.2f} s)")
        return val, grad

    z0 = (rvpack.pack_values(start) if start is not None
          else rvpack.z0()).numpy()
    rng = np.random.default_rng(seed)
    best = None
    last_err = None
    for r in range(max(1, restarts)):
        zr = z0 if r == 0 else rng.normal(size=rvpack.total)
        try:
            res = minimize(fun, zr, jac=True, method="L-BFGS-B",
                           bounds=bounds,
                           options={"maxiter": maxiter, "ftol": ftol})
        except Exception as e:  # noqa: BLE001 — a start may legitimately
            # fail (line-search collapse at a bad init); keep the error so
            # an all-starts failure names its cause
            last_err = e
            print(f"{who}: start {r} failed: {e!r}")
            continue
        if np.isfinite(res.fun) and (best is None or res.fun < best.fun):
            best = res
    if best is None:
        raise RuntimeError(f"{what} failed from all starts") from last_err
    vals = rvpack.unpack(torch.as_tensor(best.x, dtype=DTYPE))
    hypers = {k: v.numpy() for k, v in vals.items()}
    if "gv" in hypers:
        hypers["gv"] = hypers["gv"].reshape(())
    if "alpha" in hypers:
        hypers["alpha"] = hypers["alpha"].reshape(())
    return hypers, -float(best.fun)


def _log_bounds(nx, kerns, noise):
    """The log-space box of the plain menu: keeps the factorisation in its
    numerical range."""
    nkern = len(kerns)
    bounds = [(np.log(1e-12), np.log(1e2))] if noise else []
    bounds += [(np.log(1e-3), np.log(1e3))] * (nx * nkern)
    bounds += [(np.log(1e-6), np.log(1e6))] * nkern
    if "RatQuad" in kerns:
        bounds.append((np.log(1e-3), np.log(1e3)))
    return bounds


def big_map_fit(X, y, kerns=("RBF",), ops=(), noise: bool = True,
                truncate: bool = False, jitter: float = 1e-6,
                block: int = 1024, maxiter: int = 50, start=None,
                restarts: int = 1, seed: int = 0, verbose: bool = False,
                ftol: float = 1e-7, device=None):
    """MAP fit at large N: host scipy L-BFGS-B over the unconstrained
    hyperparameters with the mixed-precision value and gradient above,
    plus the reference hyperprior menu.  The data go to `device` (None:
    the CUDA card) once; z stays on the host.

    Returns (hypers dict of numpy arrays, log posterior)."""
    dev = resolve_device(device)
    X = np.asarray(X, dtype=np.float64)
    y1 = np.asarray(y, dtype=np.float64).reshape(-1)
    nx = X.shape[1]
    kerns = tuple(kerns)
    ops = tuple(ops)
    rvpack = _default_rvpack(nx, kerns, noise, truncate)
    Xt = _as_tensor(X, dev)
    yt = _as_tensor(y1, dev)

    def logl_grad(z_np):
        return _nlml_vg(Xt, yt, _as_tensor(z_np, dev), rvpack, kerns, ops,
                        noise, float(jitter), int(block), GRAD_INV_ITERS)

    # truncate priors bound the constrained values through their
    # sigmoid-interval transform; z itself is unbounded
    bounds = None if truncate else _log_bounds(nx, kerns, noise)
    return _lbfgsb_restarts(logl_grad, rvpack, start, restarts, seed, bounds,
                            maxiter, ftol, verbose, "big_map_fit",
                            "mixed-precision MAP")
