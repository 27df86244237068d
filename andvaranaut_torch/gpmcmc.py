"""GP surrogate with MAP or MCMC hyperparameter fitting, prediction,
forward UQ, held-out diagnostics, Bayesian optimisation and inverse
problems (counterpart of andvaranaut_tpu/gpmcmc.py: `GPState` and the
`GPMCMC` facade).

A state fitted by the JAX package carries across as its constructor
arguments (kernel spec, converted data and the hypers dict of numpy
arrays), or into a `GPMCMC` through `fit(method='none')` after setting
`hypers`.

Everything runs on the facade's device (`device=None`: the CUDA card, or
an error).  Conditioning, prediction, the BO acquisitions and the
inverse objective compute in exact f64, as the reference does on any
device with f64 (it takes the mixed blocked factorisation only on a
TPU, which has none); the mixed route, with its kernels K1-K3, is taken
when the caller asks for it (`FORCE_MIXED`).  The acquisitions'
cross-Gram runs the fused f32 tile kernel K9 on the card.  The MCMC fits
(`fit(method='mcmc_mean' | 'mcmc_map')`), BO modes (`opt_method=
'mcmc_map' | 'mcmc_mean'`) and `inverse_opt(method='mcmc_*')` run
`inference.nuts` on the facade's device.  The learnable warpings
(`fit(iwgp=True)` on `transform.wgp` input conversions, `cwgp=True` on a
`wgp` output conversion) fit through the same routes and are written
back into the conversions (`iwgp_set`, `cwgp_set`).
`fit(method='map', precision='distributed')` fits row-sharded over a
mesh of a process group's ranks (`gp.sharded`).
"""

from __future__ import annotations

import copy
import math
import types
from collections import OrderedDict

import numpy as np
import torch

from ._config import DTYPE, resolve_device
from .gp import engine, kernels, precision, quad
from .lhc import LHC, _convert_columns, _validated_conrevs
from .transform import wgp

__all__ = ["GPState", "GPMCMC"]

_LOG_2PI = math.log(2.0 * math.pi)

#: route conditioning, prediction and BO acquisitions through the mixed
#: blocked factorisation (K1-K3) at any size and device.  Off by default:
#: the reference takes that route only on a TPU (`is_tpu() and n >=
#: MIXED_N`, andvaranaut_tpu/gpmcmc.py), and exact f64 everywhere else
FORCE_MIXED = False


class GPState:
    """Converted data bound to hyperparameters; conditions once (cached
    per jitter) and predicts in query chunks.

    Data is bucket-padded with phantom identity rows.  Conditioning and
    prediction run the exact f64 path, as the reference does wherever
    there is f64; with FORCE_MIXED set they run the mixed-precision
    blocked factorisation at MIXED_BLOCK, whose kernels (K1-K3) carry the
    O(n^3) work.  The state lives on `device` if given, else on DEVICE:
    None means the CUDA card (an error without one); "cpu" runs the plain
    versions."""

    BUCKET = 32
    MIXED_BLOCK = 1024
    #: query rows per predict call: bounds the (n_train, nq) f64
    #: cross-Gram (2 GB at 16k train rows)
    QCHUNK = 16384
    DEVICE = None

    def __init__(self, kerns, ops, noise, jitter, xin, yin, hypers,
                 device=None):
        if device is not None:
            self.DEVICE = device
        self.kerns = tuple(kerns)
        self.ops = tuple(ops)
        self.noise = noise
        self.jitter = jitter
        self.xin = np.asarray(xin)
        self.yin = np.asarray(yin)
        self.hypers = hypers
        self._cache = {}

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_cache"] = {}
        return d

    @property
    def device(self) -> torch.device:
        return resolve_device(self.DEVICE)

    def _mixed(self):
        """Whether conditioning takes the mixed factorisation: only when
        asked for (FORCE_MIXED).  The reference's rule, `is_tpu() and n >=
        MIXED_N`, never holds off a TPU."""
        return FORCE_MIXED

    def _bucket(self):
        return self.MIXED_BLOCK if self._mixed() else self.BUCKET

    def padded(self):
        return engine.pad_data(self.xin, self.yin, self._bucket(),
                               device=self.device)

    def hyper_args(self):
        return engine.hypers_to_args(self.hypers, self.noise,
                                     device=self.device)

    def chol(self, jitter=None):
        """Cached conditioning state over padded data: (L, v, xin_p,
        valid, Dinv); v is L^-1 y on the exact path and K^-1 y on the
        mixed path, Dinv the diagonal-block inverses (None when exact)."""
        j = self.jitter if jitter is None else jitter
        if j not in self._cache:
            l, kv, gv, alpha = self.hyper_args()
            xin_p, yin_p, valid = self.padded()
            if self._mixed():
                L, v, Dinv = engine.chol_state_masked_mixed(
                    self.kerns, self.ops, xin_p, yin_p, valid, l, kv, gv,
                    alpha, j, block=self.MIXED_BLOCK)
            else:
                L, v = engine.chol_state_masked(
                    self.kerns, self.ops, xin_p, yin_p, valid, l, kv, gv,
                    alpha, j)
                Dinv = None
            self._cache[j] = (L, v, xin_p, valid, Dinv)
        return self._cache[j]

    def predict(self, xnew, jitter=None):
        """Predictive mean and variance (numpy, f64) at xnew (m, nx)."""
        l, kv, gv, alpha = self.hyper_args()
        L, v, xin_p, valid, Dinv = self.chol(jitter)
        xq_all = torch.as_tensor(np.asarray(xnew, dtype=np.float64),
                                 dtype=DTYPE, device=xin_p.device)
        m = xq_all.shape[0]

        def run(xq):
            if Dinv is not None:
                return engine.predict_from_chol_masked_mixed(
                    self.kerns, self.ops, xin_p, valid, L, v, Dinv, xq,
                    l, kv, gv, alpha)
            return engine.predict_from_chol_masked(
                self.kerns, self.ops, xin_p, valid, L, v, xq, l, kv, gv,
                alpha)

        mus, vars_ = [], []
        for lo in range(0, max(m, 1), self.QCHUNK):
            xq = xq_all[lo:lo + self.QCHUNK]
            take = xq.shape[0]
            mpad = engine.round_up(max(take, 1), self.BUCKET)
            if mpad != take:
                xq = torch.cat([xq, xq.new_zeros((mpad - take,
                                                  xq.shape[1]))])
            mu, var = run(xq)
            mus.append(mu[:take].cpu().numpy())
            vars_.append(var[:take].cpu().numpy())
        return np.concatenate(mus), np.concatenate(vars_)


class GPMCMC(LHC):
    """The GP surrogate facade: data (LHC), conversions, kernel model,
    MAP and MCMC fits, prediction with Gauss-Hermite reversion, forward
    UQ, held-out diagnostics, Bayesian optimisation and inverse problems.
    device: where fits, conditioning, acquisitions and the inverse
    objective run (None: the CUDA card, or an error; "cpu" runs the plain
    versions)."""

    def __init__(self, xconrevs=None, yconrevs=None, kernel="RBF",
                 noise=True, mean=0, device=None, **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)
        self.ym = copy.deepcopy(self.y)
        self.__conrev_check(xconrevs, yconrevs)
        self._reconvert()
        self.change_model(kernel, noise, mean)
        self.__scrub_train_test()

    # -- mean function ---------------------------------------------------
    def zero_mean(self, x):
        return np.zeros(self.ny)

    def _mean_vals(self, x):
        """Mean-function values per row (the mean is any user callable)."""
        if self._is_zero_mean():
            return np.zeros(len(x))
        return np.array([np.asarray(self.mean(x[i, :])).reshape(-1)[0]
                         for i in range(len(x))])

    # -- conversion plumbing: yc = ycon(y - ym), rebuilt wholesale -------
    def _reconvert(self):
        self.xc = _convert_columns(self.xconrevs, self.x)
        self.yc = _convert_columns(self.yconrevs, self.y - self.ym)

    def del_samples(self, ndels=None, method="coarse_lhc", idx=None):
        keep = self._LHC__keep_mask(ndels, method, idx)
        for name in ("x", "y", "xc", "yc", "ym"):
            setattr(self, name, getattr(self, name)[keep])
        self.nsamp = len(self.x)
        self.__scrub_train_test()

    def change_conrevs(self, xconrevs=None, yconrevs=None):
        self.__conrev_check(xconrevs, yconrevs)
        self._reconvert()

    def change_xconrevs(self, xconrevs=None):
        self.__conrev_check(xconrevs, yconrevs=self.yconrevs)
        self.xc = _convert_columns(self.xconrevs, self.x)

    def change_yconrevs(self, yconrevs=None):
        self.__conrev_check(self.xconrevs, yconrevs)
        self.yc = _convert_columns(self.yconrevs, self.y - self.ym)

    def __conrev_check(self, xconrevs, yconrevs):
        self.xconrevs = _validated_conrevs(xconrevs, self.nx, "xconrevs")
        self.yconrevs = _validated_conrevs(yconrevs, self.ny, "yconrevs")

    # -- data management -------------------------------------------------
    def _mean_at(self, x):
        xm, ym = self._core__vector_solver(x, self.mean)
        if len(xm) != len(x):
            raise Exception(
                "Mean function not valid at every x point in dataset")
        return ym

    def set_data(self, x, y):
        super().set_data(x, y)
        self.ym = self._mean_at(self.x)
        self._reconvert()
        self.__scrub_train_test()

    def __scrub_train_test(self):
        self.train = None
        self.test = None

    def sample(self, nsamps, seed=None):
        super().sample(nsamps=nsamps, seed=seed)
        self.ym = self._mean_at(self.x)
        self.nsamp = len(self.x)
        self._reconvert()

    def y_dist(self, mode="hist_kde", nsamps=None, return_data=False,
               surrogate=True):
        """Forward UQ through the surrogate: the reverted predictive means
        at a fresh LHC of nsamps prior points (default 1000; the
        reference's None crashes), plotted by `LHC.y_dist`'s plot;
        surrogate=False plots the sampled outputs instead.  return_data
        returns (xsamps, ypreds)."""
        if not isinstance(surrogate, bool):
            raise Exception("Error: surrogate argument must be of type bool")
        if not surrogate:
            super().y_dist(mode)
            return None
        xsamps, ypreds = self._forward_uq(1000 if nsamps is None else nsamps)
        self._LHC__y_dist(ypreds, mode)
        if return_data:
            return xsamps, ypreds
        return None

    def _forward_uq(self, nsamps):
        """The propagation `y_dist` plots: (xsamps, reverted predictive
        means) at a fresh LHC of nsamps prior points, through one
        conditioning and `predict` on the facade's device."""
        xsamps = self._LHC__latin_sample(nsamps)
        return xsamps, self.predict(xsamps)

    # -- model configuration ---------------------------------------------
    def change_model(self, kernel=None, noise=None, mean=None):
        """Set kernel string, noise and mean function; scrubs the fitted
        state."""
        if kernel is None:
            kernel = self.kernel
        if noise is None:
            noise = self.noise
        if mean is not None:
            self.mean = self.zero_mean if (
                isinstance(mean, (int, float)) and mean == 0) else mean
            self.ym = self._mean_at(self.x)
        kerns, ops = kernels.parse_kernel(kernel)
        if not isinstance(noise, bool):
            raise Exception("Error: noise must be of type bool")
        self.kernel = kernel
        self.kerns = list(kerns)
        self.ops = list(ops)
        self.nkern = len(kerns)
        self.noise = noise
        self.m = None
        self.gp = None
        self.hypers = None

    # -- fitting ----------------------------------------------------------
    def fit(self, method="map", return_data=False, iwgp=False, cwgp=False,
            jitter=1e-6, truncate=False, restarts=1, **kwargs):
        """Fit the hyperparameters.  method='map' takes precision='f64'
        (default: exact f64 autograd and L-BFGS, `engine.map_fit`) or
        'mixed' (the mixed-precision value and gradient,
        `bigfit.big_map_fit`, or `bigfit.big_warped_map_fit` with
        learnable warpings) or 'distributed' (the same row-sharded over a
        mesh, `sharded.sharded_big_map_fit` or
        `sharded.sharded_big_warped_map_fit`, with their keywords: mesh,
        block, maxiter, ...; every rank calls fit together);
        method='mcmc_mean' / 'mcmc_map' sample the
        hyperposterior (`nuts.sample_model`, its keywords: draws, tune,
        chains, random_seed, sampler, mixed, ...) and take the posterior
        mean or the highest-lp draw, the latter refined by the exact f64
        MAP fit (kept unrefined if that fails); method='none' binds
        `self.hypers` as they are.  iwgp/cwgp fit the parameters of the
        wgp input conversions / the wgp output conversion with the
        kernel's and write them back into the conversions.
        return_data=True returns the MCMC draws (an arviz InferenceData
        when arviz is importable, else the `nuts.MCMCData` carrier; None
        for the other methods)."""
        self.m, self.gp, self.hypers, data = self.__fit(
            self.x, self.y - self.ym, method, iwgp, cwgp, jitter, truncate,
            restarts, **kwargs)
        if return_data:
            from .inference import nuts

            return nuts.as_inference_data(data)

    def __fit(self, x, y, method, iwgp, cwgp, jitter=1e-6, truncate=False,
              restarts=1, **kwargs):
        cfg = engine.FitConfig(
            kerns=tuple(self.kerns), ops=tuple(self.ops), noise=self.noise,
            truncate=truncate, jitter=jitter, iwgp=iwgp, cwgp=cwgp,
            priors=self.priors, xconrevs=self.xconrevs,
            yconrevs=self.yconrevs, x=np.asarray(x), y=np.asarray(y))
        data = None
        if method == "map":
            start = kwargs.pop("start", None)
            precision_ = kwargs.pop("precision", "f64")
            if precision_ == "distributed":
                # the closed-form gradient pipeline row-sharded over a
                # mesh (gp/sharded.py); mesh=... picks the ranks (default:
                # every rank of the group, or a one-rank group)
                from .gp import sharded

                if iwgp or cwgp:
                    mp, _ = sharded.sharded_big_warped_map_fit(
                        cfg, start=start, device=self.device, **kwargs)
                else:
                    mp, _ = sharded.sharded_big_map_fit(
                        _apply_conrevs(self.xconrevs, x, "con"),
                        np.asarray(self.yconrevs[0].con(y[:, 0])),
                        kerns=tuple(self.kerns), ops=tuple(self.ops),
                        noise=self.noise, truncate=truncate, jitter=jitter,
                        start=start, device=self.device, **kwargs)
            elif precision_ == "mixed":
                from .gp import bigfit

                if iwgp or cwgp:
                    mp, _ = bigfit.big_warped_map_fit(
                        cfg, start=start, restarts=restarts,
                        device=self.device, **kwargs)
                else:
                    mp, _ = bigfit.big_map_fit(
                        _apply_conrevs(self.xconrevs, x, "con"),
                        np.asarray(self.yconrevs[0].con(y[:, 0])),
                        kerns=tuple(self.kerns), ops=tuple(self.ops),
                        noise=self.noise, truncate=truncate, jitter=jitter,
                        start=start, restarts=restarts, device=self.device,
                        **kwargs)
            else:
                mp, _ = engine.map_fit(cfg, start=start, restarts=restarts,
                                       device=self.device, **kwargs)
        elif method == "none":
            mp = self.hypers
            if mp is None:
                raise Exception(
                    "method='none' requires previously fitted hypers")
        elif method in ("mcmc_mean", "mcmc_map"):
            from .inference import nuts

            data = nuts.sample_model(cfg, verbose=self.verbose,
                                     device=self.device, **kwargs)
            if method == "mcmc_mean":
                mp = self.mean_extract(data)
            else:
                mp = self.map_extract(data)
                try:
                    mp, _ = engine.map_fit(cfg, start=mp, restarts=1,
                                           device=self.device)
                except Exception:  # noqa: BLE001 — the reference keeps
                    # the highest-lp draw when the refine fails
                    pass
        else:
            raise Exception(
                "method must be one of map, mcmc_map, or mcmc_mean")
        # the fitted warpings into the conversions (gpmcmc.py:364-382); a
        # one-parameter block of an MCMC fit is a 0-d posterior mean or
        # draw, which the reference's write-back indexes and fails on
        if method != "none":
            if iwgp:
                self.iwgp_set(np.atleast_1d(mp["iwgp"]))
            if cwgp:
                self.cwgp_set(np.asarray(engine.interleave_cwgp(
                    {k: torch.as_tensor(np.atleast_1d(mp[k]))
                     for k in ("cwgp", "cwgp_pos") if k in mp},
                    self.yconrevs[0].pos)))
        xin = _apply_conrevs(self.xconrevs, x, "con")
        yin = np.asarray(self.yconrevs[0].con(y[:, 0]), dtype=np.float64)
        gpstate = GPState(self.kerns, self.ops, self.noise, jitter, xin, yin,
                          mp, device=self.device)
        return gpstate, gpstate, mp, data

    # -- MCMC extraction (reference gpmcmc.py:404-430) ---------------------
    def mean_extract(self, data):
        mean = data.posterior_mean()
        return {k: np.asarray(v) for k, v in mean.items()}

    def map_extract(self, data):
        mp, lpmax = data.max_logp_point()
        if self.verbose:
            print(f"Max log posterior: {lpmax}")
            print(f"Max log posterior sample: {mp}")
        return {k: np.asarray(v) for k, v in mp.items()}

    # -- learnable warping write-back (reference gpmcmc.py:405-430) --------
    def cwgp_set(self, params, mode="numpy", y=None):
        """The output conversion rebuilt as its wgp at `params` (in the
        wgp's own order), its data-fitted stages refitted to y (default:
        the mean-subtracted outputs); mode='numpy' installs it, any other
        mode returns it."""
        if y is None:
            y = self.y - self.ym
        warper = wgp(self.yconrevs[0].warping_names, params, y[:, 0])
        if mode == "numpy":
            self.change_yconrevs([warper])
        else:
            return warper

    def iwgp_set(self, params, mode="numpy", x=None):
        """The wgp input conversions rebuilt at consecutive slices of
        `params`, each refitted to its column of x (default: the inputs);
        mode='numpy' installs them, any other mode returns the list of
        input conversions."""
        if x is None:
            x = self.x
        xconrevs = []
        rc = 0
        for i in range(self.nx):
            cr = self.xconrevs[i]
            if isinstance(cr, wgp):
                xconrevs.append(wgp(cr.warping_names, params[rc:rc + cr.np],
                                    y=x[:, i], xdist=self.priors[i]))
                rc += cr.np
            else:
                xconrevs.append(cr)
        if mode == "numpy":
            self.change_xconrevs(xconrevs=xconrevs)
        else:
            return xconrevs

    # -- train/test -------------------------------------------------------
    def train_test(self, training_frac=0.9):
        """Random train/test index split: a shuffled permutation with
        n_train = floor(frac * n), or an absolute integer count."""
        self.nsamp = len(self.x)
        if isinstance(training_frac, (int, np.integer)) and not isinstance(
                training_frac, bool):
            if not 0 < training_frac < self.nsamp:
                raise Exception(
                    "Error: integer training_frac must be in "
                    f"(0, {self.nsamp})")
            ntrain = int(training_frac)
        else:
            frac = float(training_frac)
            if not 0.0 < frac < 1.0:
                raise Exception(
                    "Error: training_frac must be a fraction in (0, 1) "
                    "or an integer training count")
            ntrain = int(np.floor(self.nsamp * frac))
        perm = np.random.default_rng().permutation(self.nsamp)
        self.train, self.test = perm[:ntrain], perm[ntrain:]

    def test_plots(self, revert=True, yplots=True, xplots=True,
                   logscale=False, iwgp=False, cwgp=False, method="none",
                   errorbars=True, saveyfig=None, xlab=None, ylab=None,
                   returndat=False):
        """Held-out assessment: refit on the train split (`fit`'s methods;
        'none' binds the current hypers), predict the test split, report
        RMSE, MAE, mean percentage error and R^2, and draw the parity and
        per-input scatter plots.  revert=False compares in the converted
        output space.  returndat returns (xtest, ytest, ypred, yvars)."""
        if self.train is None:
            self.train_test()
        tr, te = self.train, self.test
        xtest = self.x[te]

        _, gp, hypers, _ = self.__fit(
            self.x[tr], self.y[tr] - self.ym[tr], method, iwgp, cwgp)
        xctest = _apply_conrevs(self.xconrevs, xtest, "con")
        ypred, yvars = self.__predict(gp, hypers, xctest)

        if revert:
            ypred, yvars = self.__gh_stats(xtest, ypred, yvars,
                                           normvar=False)
            ytest = self.y[te, 0]
            ybar = np.mean(self.y)
        else:
            ytest = np.asarray(
                self.yconrevs[0].con(self.y[te, 0] - self.ym[te, 0]))
            xtest = xctest
            ybar = np.mean(self.yc)
        ypred, yvars = ypred[:, 0], yvars[:, 0]

        metrics = _regression_metrics(ypred, ytest, ybar)
        if self.verbose:
            print(f"RMSE for y is: {metrics['rmse']:0.5e}")
            print(f"Mean absolute error for y is: {metrics['mae']:0.5e}")
            print(f"Mean percentage error for y is: {metrics['mpe']:0.5%}")
            print(f"R^2 for y is: {metrics['r2']:0.5f}")

        if yplots:
            _gp_scatter_plot(
                ytest, ytest, ypred, yvars, logscale=logscale,
                errorbars=errorbars, truth_style="-", truth_label="True",
                points_fmt="x", log_x=True,
                xlabel=("y" if xlab is None else xlab),
                ylabel=("y" if ylab is None else ylab),
                title="y", savefig=saveyfig)
        if xplots:
            for j in range(self.nx):
                _gp_scatter_plot(
                    xtest[:, j], ytest, ypred, yvars, logscale=logscale,
                    errorbars=errorbars, truth_style=".", truth_label="Test",
                    points_fmt="o", log_x=False, xlabel=f"x[{j}]",
                    ylabel="y", title=f"y wrt x[{j}]")

        if returndat:
            return xtest, ytest, ypred, yvars
        return None

    def relative_importances(self, logscale=False):
        """Bar plot of the inverse lengthscales (of the first kernel
        component), log-scaled on request."""
        import matplotlib.pyplot as plt

        vals = 1 / np.asarray(self.hypers["l"])[: self.nx]
        if logscale:
            vals = np.log(vals)
        plt.bar([f"x[{i}]" for i in range(self.nx)], vals)
        plt.ylabel("Relative importance")
        plt.show()

    # -- prediction -------------------------------------------------------
    def predict(self, x, return_var=False, convert=True, revert=True,
                normvar=False, jitter=1e-6, EI=False, EIopt=None, deg=8):
        """Predict at raw x (convert=True) or converted x (convert=False),
        reverting through the output warping by Gauss-Hermite quadrature.
        Returns (n, 1) numpy arrays."""
        x = np.asarray(x)
        if convert:
            xarg = _apply_conrevs(self.xconrevs, x, "con")
            xraw = x
        else:
            xarg = x
            xraw = _apply_conrevs(self.xconrevs, x, "rev")
        y, yv = self.__predict(self.gp, self.hypers, xarg, jitter)
        if revert:
            y, yv = self.__gh_stats(xraw, y, yv, normvar, deg, EI=EI,
                                    EIopt=EIopt)
        if return_var:
            return y, yv
        return y

    def __gh_stats(self, x, y, yv, normvar=True, deg=8, EI=False,
                   EIopt=None):
        yy, yyv = quad.gh_stats(
            self.yconrevs[0].rev, y[:, 0], yv[:, 0], self._mean_vals(x),
            deg=deg, EI=EI, EIopt=(EIopt if EIopt else "min"),
            yopt=float(getattr(self, "yopt", 0.0)), normvar=normvar)
        return (yy.cpu().numpy().reshape(-1, 1),
                yyv.cpu().numpy().reshape(-1, 1))

    def __predict(self, gp, hyps, x, jitter=1e-6):
        if self.verbose:
            print("Predicting...")
        if gp is None:
            raise Exception("Model must be fitted before predicting")
        from . import timing

        with timing.stopwatch("predict", verbose=self.verbose):
            state = GPState(gp.kerns, gp.ops, gp.noise, jitter, gp.xin,
                            gp.yin, hyps, device=self.device)
            y, yv = state.predict(x)
        return y.reshape(-1, 1), yv.reshape(-1, 1)

    # -- Bayesian optimisation ---------------------------------------------
    def _prior_rv(self, k):
        """Prior k as an unconstrained RV (the input point of the refine
        stage)."""
        from . import dists
        from .inference.unconstrained import RV

        d = self.priors[k]
        if isinstance(d, dists.Uniform):
            lo, hi = d.interval(1.0)
            return RV(f"x{k}", 1, ("uniform", float(lo), float(hi)))
        if isinstance(d, dists.Normal):
            return RV(f"x{k}", 1, ("normal", float(d.loc), float(d.scale)))
        if isinstance(d, dists.TruncNorm):
            lo, hi = d.interval(1.0)
            return RV(f"x{k}", 1, ("truncnormal", float(d.loc),
                                   float(d.scale), float(lo), float(hi)))
        raise Exception(
            "Prior distribution conversion not implemented for "
            f"{type(d).__name__}")

    def _is_zero_mean(self):
        mref = getattr(self.mean, "__func__", self.mean)
        return mref is GPMCMC.zero_mean

    def _bo_mixed(self):
        """Whether BO conditioning and acquisition take the mixed blocked
        factorisation: GPState's rule (only under FORCE_MIXED)."""
        return FORCE_MIXED

    def _bo_state_args(self, jitter):
        """Padded conditioning state of the current converted data on the
        facade's device: (state args, has_alpha, mixed)."""
        dev = self.device
        l, kv, gv, alpha = engine.hypers_to_args(self.hypers, self.noise,
                                                 device=dev)
        has_alpha = alpha is not None
        alpha_arg = alpha if has_alpha else torch.zeros((), dtype=DTYPE,
                                                        device=dev)
        kerns, ops = tuple(self.kerns), tuple(self.ops)
        if self._bo_mixed():
            blk = GPState.MIXED_BLOCK
            xin_p, yin_p, valid = engine.pad_data(self.xc, self.yc[:, 0],
                                                  blk, device=dev)
            L, av, Dinv = engine.chol_state_masked_mixed(
                kerns, ops, xin_p, yin_p, valid, l, kv, gv, alpha, jitter,
                block=blk)
            return ((xin_p, valid, L, av, Dinv, l, kv, gv, alpha_arg),
                    has_alpha, True)
        xin_p, yin_p, valid = engine.pad_data(self.xc, self.yc[:, 0],
                                              GPState.BUCKET, device=dev)
        L, v = engine.chol_state_masked(kerns, ops, xin_p, yin_p, valid, l,
                                        kv, gv, alpha, jitter)
        return (xin_p, valid, L, v, l, kv, gv, alpha_arg), has_alpha, False

    def _acq_fn(self, method, opt_type, normvar, has_alpha, mixed=False):
        """Batched acquisition: (X (m, nx) tensor, *state args, yopt) ->
        (m,) values to MINIMISE, on the state's device; closes only over
        the model spec and the transform objects."""
        conrevs = list(self.xconrevs)
        yrev = self.yconrevs[0].rev
        kerns, ops = tuple(self.kerns), tuple(self.ops)
        nx = self.nx
        # acquisition values tolerate f32 noise and are evaluated
        # thousands of times per BO iteration: on the card the cross-Gram
        # runs the fused tile kernel K9
        fast = self.device.type == "cuda"

        def acq(X, *args):
            if mixed:
                xin_p, valid, L, v, Dinv, l, kv, gv, alpha, yopt = args
            else:
                xin_p, valid, L, v, l, kv, gv, alpha, yopt = args
            Xc = torch.stack([conrevs[i].con(X[:, i]) for i in range(nx)],
                             dim=1)
            a = alpha if has_alpha else None
            if mixed:
                mu, var = engine.predict_from_chol_masked_mixed(
                    kerns, ops, xin_p, valid, L, v, Dinv, Xc, l, kv, gv, a,
                    fast=fast)
            else:
                mu, var = engine.predict_from_chol_masked(
                    kerns, ops, xin_p, valid, L, v, Xc, l, kv, gv, a,
                    fast=fast)
            if method in ("eps-RS", "exploit"):
                y, _ = quad.gh_stats(yrev, mu, var)
                return y if opt_type == "min" else -y
            if method == "explore":
                _, yv = quad.gh_stats(yrev, mu, var, normvar=normvar)
                return -yv
            if method == "EI":
                ei, _ = quad.gh_stats(yrev, mu, var, EI=True,
                                      EIopt=opt_type, yopt=yopt)
                return -ei
            raise Exception(
                "method must be one of eps-RS ,EI, exploit, or explore")

        return acq

    _BO_CACHE_MAX = 32

    def _get_bo_program(self, kind, method, opt_type, normvar, has_alpha,
                        mixed=False):
        """BO programs ('batch', 'de', 'refine') cached per (kind,
        acquisition, model spec, transform CONTENT, data bucket) in a
        bounded LRU.  Keys hold transform content, not identity: an id()
        can be reused after garbage collection."""
        bucket = GPState.MIXED_BLOCK if mixed else GPState.BUCKET
        key = (kind, method, opt_type, bool(normvar), self.kernel,
               self.noise,
               tuple(_transform_content_key(c) for c in self.xconrevs),
               _transform_content_key(self.yconrevs[0]),
               engine.round_up(max(len(self.xc), 1), bucket), has_alpha,
               bool(mixed))
        cache = self.__dict__.setdefault("_bo_cache", OrderedDict())
        if key in cache:
            cache.move_to_end(key)
            return cache[key]
        while len(cache) >= self._BO_CACHE_MAX:
            cache.popitem(last=False)
        acq = self._acq_fn(method, opt_type, normvar, has_alpha, mixed)
        if kind == "batch":
            run = torch.no_grad()(acq)
        elif kind == "de":
            from .inference import de as de_mod

            @torch.no_grad()
            def run(gen, lo, hi, *sargs):
                return de_mod.differential_evolution(
                    lambda X: acq(X, *sargs), lo, hi, gen)
        elif kind == "refine":
            from .inference.lbfgs import minimize_lbfgs
            from .inference.unconstrained import RVPack

            rvpack = RVPack(tuple(self._prior_rv(k) for k in range(self.nx)))
            nx, dev = self.nx, self.device

            def refine(z0, *sargs):
                z, val, _, _ = minimize_lbfgs(
                    _point_potential(acq, rvpack, nx, sargs), z0.to(dev))
                return z, val

            run = (refine, rvpack)
        else:
            raise ValueError(f"unknown BO program kind {kind!r}")
        cache[key] = run
        return run

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_bo_cache", None)
        return d

    def _acq_host(self, method, opt_type, normvar):
        """Host-callable acquisition through self.predict (any mean
        function)."""

        def optf(x):
            x = np.asarray(x, dtype=float)
            if x.ndim == 1:
                x = np.array([x])
            if method in ("eps-RS", "exploit"):
                ym = self.predict(x)
                return ym[:, 0] if opt_type == "min" else -ym[:, 0]
            if method == "explore":
                _, yv = self.predict(x, return_var=True, normvar=normvar)
                return -yv[:, 0]
            if method == "EI":
                return -self.predict(x, EI=True, EIopt=opt_type)[:, 0]
            raise Exception(
                "method must be one of eps-RS ,EI, exploit, or explore")

        return optf

    def BO(self, opt_type="min", opt_method="predict", fit_method="map",
           max_iter=16, method="EI", eps=0.1, iwgp=False, cwgp=False,
           jitter=1e-6, conv=0.01, predict_samps=10000, normvar=True,
           refine=True, **kwargs):
        """Bayesian optimisation loop.

        opt_method: 'predict' (the argmin of the acquisition over an LHC
        draw of predict_samps points, refined by L-BFGS when refine=True),
        'DE' (differential evolution on the facade's device), 'map'
        (L-BFGS from a random start) or 'mcmc_map' / 'mcmc_mean' (MCMC
        over the acquisition's posterior, `_refine_nlp`, through
        `nuts.sample_rvpack` with **kwargs: its highest-lp draw or its
        mean).  Each iteration evaluates the target at the chosen point,
        appends it and refits."""
        if self.ny > 1:
            raise Exception(
                "Bayesian minimisation only implemented for single output")
        if opt_type == "max":
            xoptf, yoptf = np.argmax, np.max
        elif opt_type == "min":
            xoptf, yoptf = np.argmin, np.min
        else:
            raise Exception(
                "Error: opt_type argument must be one of max or min")
        self.xopt = self.x[xoptf(self.y[:, 0]), :]
        self.yopt = yoptf(self.y)
        if self.verbose:
            print("Running Bayesian minimisation...")
            print(f"Current optima is {self.yopt} at x point {self.xopt}")
        if self.m is None:
            raise Exception(
                "Model must be fitted before running Bayesian optimisation")
        if method == "exploit":
            eps = 0.0
        dev = self.device
        lbs = np.array([float(p.ppf(1e-8)) for p in self.priors])
        ubs = np.array([float(p.isf(1e-8)) for p in self.priors])

        xsampold = np.array([[1e300 for _ in range(self.nx)]])
        for i in range(max_iter):
            if self.verbose:
                print(f"Iteration {i + 1}")
            xsamp = None
            if opt_method in ("DE", "predict"):
                roll = np.random.rand()
                if method != "eps-RS" or roll > eps:
                    on_device = self._is_zero_mean()
                    if on_device:
                        sargs, has_alpha, mixed = self._bo_state_args(jitter)
                        yopt = float(self.yopt)
                    if opt_method == "DE":
                        if not on_device:
                            from scipy.optimize import (
                                differential_evolution as scipy_de)

                            optf = self._acq_host(method, opt_type, normvar)
                            verb, self.verbose = self.verbose, False
                            res = scipy_de(optf, list(zip(lbs, ubs)))
                            self.verbose = verb
                            xsamp = np.array([res.x])
                            fopt = res.fun
                        else:
                            run = self._get_bo_program(
                                "de", method, opt_type, normvar, has_alpha,
                                mixed)
                            gen = torch.Generator(device=dev).manual_seed(
                                int(np.random.randint(2**31 - 1)))
                            xbest, fopt, _ = run(
                                gen, torch.as_tensor(lbs, device=dev),
                                torch.as_tensor(ubs, device=dev), *sargs,
                                yopt)
                            xsamp = xbest.cpu().numpy()[None, :]
                        if self.verbose:
                            print(f"Function opt is {float(fopt):0.3f}")
                    else:
                        xsamps = self._LHC__latin_sample(predict_samps)
                        if on_device:
                            run = self._get_bo_program(
                                "batch", method, opt_type, normvar,
                                has_alpha, mixed)
                            ysamps = run(torch.as_tensor(xsamps, device=dev),
                                         *sargs, yopt).cpu().numpy()
                        else:
                            ysamps = self._acq_host(
                                method, opt_type, normvar)(xsamps)
                        xsamp = np.array([xsamps[np.argmin(ysamps), :]])
                        if self.verbose:
                            print(f"Function opt is {np.min(ysamps):0.3f}")
                else:
                    xsamp = np.array(
                        [[float(p.rvs()) for p in self.priors]])

            if opt_method not in ("DE", "predict") or (
                    opt_method == "predict" and refine):
                roll = np.random.rand()
                explore = method != "eps-RS" or roll > eps
                if explore and opt_method in ("mcmc_map", "mcmc_mean"):
                    xsamp = self._bo_mcmc_point(opt_method, method,
                                                opt_type, normvar, jitter,
                                                **kwargs)
                elif explore:
                    if opt_method not in ("map", "predict"):
                        raise Exception(
                            "opt_method must be one of predict, DE, map, "
                            "mcmc_map, or mcmc_mean")
                    sargs, has_alpha, mixed = self._bo_state_args(jitter)
                    run, rvpack = self._get_bo_program(
                        "refine", method, opt_type, normvar, has_alpha,
                        mixed)
                    if opt_method == "map":
                        z0 = torch.as_tensor(
                            np.random.normal(size=rvpack.total))
                    else:
                        if self.verbose:
                            print(f"Refining {xsamp[0, :]}")
                        z0 = rvpack.pack_values({
                            f"x{k}": xsamp[0, k] for k in range(self.nx)})
                    z, _ = run(z0, *sargs, float(self.yopt))
                    vals = rvpack.unpack(z)
                    xsamp = np.array([[float(vals[f"x{k}"][0])
                                       for k in range(self.nx)]])
                elif xsamp is None:
                    xsamp = np.array(
                        [[float(p.rvs()) for p in self.priors]])

            # convergence on relative x change
            xdiff = np.sum(
                np.abs(xsamp - xsampold) / np.abs(xsampold)) / self.nx
            if xdiff < conv:
                if self.verbose:
                    print(f"Convergence at relative tolerance {xdiff} "
                          f"achieved with point {xsamp}")
                break
            if self.verbose and i > 0:
                print(f"Relative convergence in sample: {xdiff}")
            xsampold = xsamp

            ypred = self.predict(xsamp)
            if self.verbose:
                print(f"Predicted {ypred} at x point {xsamp}")

            # evaluate target and mean, append to the datasets
            xsamp, ysamp, ym = self._evaluate_append(xsamp)
            if self.verbose:
                print(f"New sample is {ysamp + ym} at x point {xsamp}")
            self.xopt = self.x[xoptf(self.y[:, 0]), :]
            self.yopt = yoptf(self.y)

            # refit: warm start, cold start if that fails
            if fit_method == "map":
                try:
                    self.fit(method=fit_method, iwgp=iwgp, cwgp=cwgp,
                             start=self.hypers)
                except Exception:  # noqa: BLE001 — the reference's fallback
                    self.fit(method=fit_method, iwgp=iwgp, cwgp=cwgp)
            else:
                self.fit(method=fit_method, iwgp=iwgp, cwgp=cwgp)
        return self.xopt, self.yopt

    def _evaluate_append(self, xsamp):
        """Evaluate the target and the mean function at xsamp (1, nx) and
        append the point to every dataset: (xsamp, ysamp, ym) of the
        evaluated rows."""
        xsamp, ysamp = self._core__vector_solver(xsamp)
        xm, ym = self._core__vector_solver(xsamp, self.mean)
        self.x = np.r_[self.x, xsamp]
        self.y = np.r_[self.y, ysamp]
        self.xc = np.r_[self.xc, self.__xconrev__(xsamp)]
        self.yc = np.r_[self.yc, self.__yconrev__(ysamp - ym)]
        self.ym = np.r_[self.ym, ym]
        self.nsamp = len(self.x)
        return xsamp, ysamp, ym

    def _refine_nlp(self, method, opt_type, normvar, jitter):
        """(rvpack, nlp) over the input point for the BO MCMC stage (the
        reference's fixed-hyper pm model, gpmcmc.py:699-860): the refine
        program's potential, `_point_potential` of the batched
        acquisition on the current state, on the facade's device."""
        if not self._is_zero_mean():
            raise Exception(
                "BO refine/map optimisation requires the zero mean function "
                "(the reference's symbolic path has the same restriction)")
        sargs, has_alpha, mixed = self._bo_state_args(jitter)
        _, rvpack = self._get_bo_program("refine", method, opt_type,
                                         normvar, has_alpha, mixed)
        acq = self._acq_fn(method, opt_type, normvar, has_alpha, mixed)
        yopt = float(getattr(self, "yopt", 0.0))
        return rvpack, _point_potential(acq, rvpack, self.nx,
                                        (*sargs, yopt))

    def _bo_mcmc_point(self, opt_method, method, opt_type, normvar, jitter,
                       **kwargs):
        """The next BO point of opt_method 'mcmc_map' / 'mcmc_mean': MCMC
        over `_refine_nlp`'s posterior (`nuts.sample_rvpack`, kwargs
        passed on), its highest-lp draw or its mean, as (1, nx)."""
        from .inference import nuts

        rvpack, nlp = self._refine_nlp(method, opt_type, normvar, jitter)
        data = nuts.sample_rvpack(rvpack, nlp, device=self.device, **kwargs)
        mp = (self.mean_extract(data) if opt_method == "mcmc_mean"
              else self.map_extract(data))
        return np.array([[float(np.asarray(mp[f"x{k}"]))
                          for k in range(self.nx)]])

    # -- inverse Bayesian problem ------------------------------------------
    def inverse_opt(self, yobs, yvarobs=None, method="map",
                    evaluate_opt=False, jitter=1e-6, **kwargs):
        """Posterior over the unknown input x given nobs observed outputs
        yobs at that input (observation variances yvarobs, optional), the
        fitted hypers held: the reference's joint GP over [training xc ;
        x repeated nobs times], evaluated on the conditioned training
        state (`_inverse_nlp`).  method='map' runs L-BFGS from a standard
        normal draw of numpy's global RNG; 'mcmc_mean' / 'mcmc_map' sample
        through `nuts.sample_rvpack` (its keywords in **kwargs) and take
        the posterior mean or the highest-lp draw.  Returns (data, xopt),
        or (data, xopt, ysamp) with evaluate_opt, which evaluates the
        target at xopt and appends it to the datasets; data is the MCMC
        draws (None for 'map')."""
        from .inference.lbfgs import minimize_lbfgs
        from .inference.unconstrained import RVPack

        if self.m is None:
            raise Exception(
                "Model must be fitted before running Bayesian optimisation")
        if self.verbose:
            print("Running Bayesian inverse solver...")
        yobs = np.asarray(yobs, dtype=float).reshape(-1)
        rvpack = RVPack(tuple(self._prior_rv(k) for k in range(self.nx)))
        nlp = self._inverse_nlp(rvpack, yobs, yvarobs, jitter)

        if method == "map":
            z0 = torch.as_tensor(np.random.normal(size=rvpack.total))
            z, val, _, _ = minimize_lbfgs(nlp, z0.to(self.device))
            vals = rvpack.unpack(z)
            mp = {f"x{k}": float(vals[f"x{k}"][0]) for k in range(self.nx)}
            data = None
            if self.verbose:
                print(f"MAP logp: {-float(val)}")
        elif method in ("mcmc_mean", "mcmc_map"):
            from .inference import nuts

            data = nuts.sample_rvpack(rvpack, nlp, device=self.device,
                                      **kwargs)
            mp = (self.mean_extract(data) if method == "mcmc_mean"
                  else self.map_extract(data))
        else:
            raise Exception(
                "method must be one of map, mcmc_map, or mcmc_mean")

        xopt = np.array([[float(np.asarray(mp[f"x{j}"]))
                          for j in range(self.nx)]])
        ypred = self.predict(xopt)
        if self.verbose:
            print(f"Predicted {ypred} at x point {xopt}")
        if evaluate_opt:
            xsamp, ysamp, ym = self._evaluate_append(xopt)
            if self.verbose:
                print(f"Actual evaluation is {ysamp + ym} at x point {xsamp}")
            return data, xopt[0, :], ysamp[0]
        return data, xopt[0, :]

    def _inverse_nlp(self, rvpack, yobs, yvarobs, jitter):
        """Minus the inverse problem's log posterior over the
        unconstrained input z, a torch function on the facade's device.

        The reference factors the joint matrix [[K, k 1^T], [1 k^T, kss
        1 1^T + diag(nv_o)]] on every evaluation (K = kern(xc) + (gv +
        jitter) I, k = kern(xc, x), kss = kern(x, x), nv_o the observation
        variances plus jitter).  Its log density is exactly
            log N(y | 0, K) + log N(y_o | mu 1, s2 1 1^T + diag(nv_o)),
        mu = k^T K^-1 y, s2 = kss - k^T K^-1 k.  The first term does not
        depend on x: it is computed once from the conditioned state at
        `jitter` (phantom rows add nothing to it).  Each evaluation then
        costs one cross-Gram column and one triangular solve against the
        cached factor (the blocked substitution's K2 products on the
        mixed route), plus an nobs x nobs factorisation; autograd flows
        through k(x) and the solve's right-hand side, never through L.

        nlp.vec_value_and_grad(Z (C, dim)) -> (values (C,), gradients
        (C, dim)) numpy f64 evaluates C chains' points as C columns of
        one cross-Gram and one solve (`nuts.potential_fns`)."""
        dev = self.device
        st = self._inverse_state()
        L, v, xin_p, valid, Dinv = st.chol(jitter)
        l, kv, gv, alpha = st.hyper_args()
        kerns, ops = st.kerns, st.ops
        nobs = len(yobs)
        ycon = self.yconrevs[0]

        def dev_t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64),
                                   device=dev)

        yo = dev_t(ycon.con(yobs))
        nv_o = torch.zeros(nobs, dtype=DTYPE, device=dev)
        if yvarobs is not None:
            yvarobs = np.asarray(yvarobs, dtype=float).reshape(-1)
            nv_o = dev_t(quad.gh_var_inv(ycon.con, yobs, yvarobs))
        nv_o = nv_o + jitter
        # the output warping's log-Jacobian: constant in x, kept so the
        # value is the reference's
        yder = np.asarray(ycon.der(np.r_[self.y[:, 0], yobs]))
        ldj = float(np.sum(np.log(yder)))

        # the training block's log density, from the cached state: v is
        # L^-1 y on the exact route and K^-1 y on the mixed one
        n = st.xin.shape[0]
        yy = v @ v if Dinv is None else dev_t(st.yin) @ v[:n]
        const = (-0.5 * yy - torch.log(torch.diagonal(L)).sum()
                 - 0.5 * n * _LOG_2PI + ldj)
        mask = valid.to(DTYPE)[:, None]
        conrevs = list(self.xconrevs)
        blocks = tuple(zip(rvpack.rvs, rvpack.offsets))

        def obs_loglik(Z):
            """log N(y_o | mu 1, s2 1 1^T + diag(nv_o)) at the points of
            the rows of Z (C, dim): (C,)."""
            Xc = torch.stack([conrevs[k].con(rv.forward(Z[:, off]))
                              for k, (rv, off) in enumerate(blocks)], dim=1)
            k = kernels.gram(kerns, ops, xin_p, Xc, l, kv, alpha) * mask
            if Dinv is None:
                A = torch.linalg.solve_triangular(L, k, upper=False)
                mu = A.T @ v
            else:
                mu = k.T @ v
                A = precision.solve_lower_linear(L, k, Dinv)
            kss = kernels.gram(kerns, ops, Xc, None, l, kv, alpha, diag=True)
            s2 = kss - (A * A).sum(0)
            C = s2[:, None, None] + torch.diag(nv_o)
            Lo, info = torch.linalg.cholesky_ex(C)
            r = yo[None, :] - mu[:, None]
            beta = torch.linalg.solve_triangular(Lo, r[:, :, None],
                                                 upper=False)[:, :, 0]
            ll = (-0.5 * (beta * beta).sum(1)
                  - torch.log(torch.diagonal(Lo, dim1=-2, dim2=-1)).sum(1)
                  - 0.5 * nobs * _LOG_2PI)
            return torch.where(info == 0, ll, math.nan)

        def nlp(z):
            return -(obs_loglik(z[None, :])[0] + const + rvpack.log_prior(z))

        def vec_value_and_grad(Z):
            Zt = torch.as_tensor(np.asarray(Z, dtype=np.float64), device=dev)
            Zt = Zt.reshape(-1, rvpack.total).requires_grad_()
            u = -(obs_loglik(Zt) + const
                  + torch.func.vmap(rvpack.log_prior)(Zt))
            (g,) = torch.autograd.grad(u.sum(), Zt)
            return u.detach().cpu().numpy(), g.cpu().numpy()

        nlp.vec_value_and_grad = vec_value_and_grad
        return nlp

    def _inverse_state(self):
        """The conditioning state of the current data: the fitted state
        while it holds the same converted data, else a new one from the
        fitted hypers (the data grew since the fit, e.g. by evaluate_opt),
        as the reference builds its joint GP from the current xc, yc."""
        gp = self.gp
        yin = self.yc[:, 0]
        if gp.xin.shape == self.xc.shape and np.array_equal(
                gp.xin, self.xc) and np.array_equal(gp.yin, yin):
            return gp
        return GPState(self.kerns, self.ops, self.noise, gp.jitter, self.xc,
                       yin, self.hypers, device=self.device)

    # -- conversion shortcuts ---------------------------------------------
    def __yconrev__(self, yin, mode="con"):
        return _apply_conrevs(self.yconrevs, yin, mode)

    def __xconrev__(self, xin, mode="con"):
        return _apply_conrevs(self.xconrevs, xin, mode)


def _point_potential(acq, rvpack, nx, sargs):
    """The BO refine and MCMC potential over the unconstrained input point
    z: the acquisition's value to minimise at x(z) (`GPMCMC._acq_fn` on
    the state args `sargs`, yopt last) minus the input priors' log
    density."""

    def nlp(z):
        vals = rvpack.unpack(z)
        xrow = torch.stack([vals[f"x{k}"][0] for k in range(nx)])
        return acq(xrow[None, :], *sargs)[0] - rvpack.log_prior(z)

    return nlp


def _transform_content_key(cr, depth: int = 6):
    """Hashable content key of a transform object: type plus parameter
    state (recursing into nested stages and distributions), so cached BO
    programs survive refits that rebuild identical transforms and never
    alias different ones.  State that cannot be keyed by content within
    the depth budget falls back to id(), which at worst misses the
    cache."""
    if isinstance(cr, (int, float, str, bool, type(None))):
        return cr
    if isinstance(cr, (list, tuple)):
        if depth <= 0:
            return id(cr)
        return tuple(_transform_content_key(v, depth - 1) for v in cr)
    if isinstance(cr, torch.Tensor):
        cr = cr.detach().cpu().numpy()
    if hasattr(cr, "shape"):
        a = np.asarray(cr)
        return (a.shape, a.dtype.str, a.tobytes())
    if isinstance(cr, (types.FunctionType, types.MethodType,
                       types.BuiltinFunctionType)):
        return id(cr)
    state = getattr(cr, "__dict__", None)
    if depth > 0 and isinstance(state, dict):
        return (type(cr).__qualname__,) + tuple(
            (k, _transform_content_key(state[k], depth - 1))
            for k in sorted(state))
    return id(cr)


def _apply_conrevs(conrevs, arr, mode):
    """Column-wise convert ('con') or revert ('rev') through a conrev
    list, as an (n, d) float64 numpy array."""
    if mode not in ("con", "rev"):
        raise Exception("Error: Mode must be one of con or rev")
    return np.column_stack([
        np.asarray(getattr(cr, mode)(arr[:, i]), dtype=np.float64)
        for i, cr in enumerate(conrevs)])


def _regression_metrics(ypred, ytrue, ybar):
    """Held-out fit metrics: RMSE, MAE, mean percentage error, R^2."""
    err = ypred - ytrue
    return {
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "mae": float(np.mean(np.abs(err))),
        "mpe": float(np.mean(np.abs(err) / np.abs(ytrue))),
        "r2": 1.0 - float(np.sum(err ** 2)) / float(
            np.sum((ytrue - ybar) ** 2)),
    }


def _gp_scatter_plot(xvals, ytrue, ypred, yvars, *, logscale, errorbars,
                     truth_style, truth_label, points_fmt, log_x,
                     xlabel, ylabel, title=None, savefig=None):
    """One GP-against-truth scatter panel: the truth, then the predictions
    as log-log points, error bars or plain markers."""
    import matplotlib.pyplot as plt

    if title is not None and savefig is None:
        plt.title(title)
    plt.plot(xvals, ytrue, truth_style, label=truth_label)
    if logscale:
        plt.plot(xvals, ypred, "o", label="GP")
        if log_x:
            plt.xscale("log")
        plt.yscale("log")
    elif errorbars:
        plt.errorbar(xvals, ypred, fmt="o", yerr=np.sqrt(yvars),
                     label="GP", capsize=3)
    else:
        plt.plot(xvals, ypred, points_fmt, label="GP")
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    plt.legend()
    if savefig is not None:
        plt.tight_layout()
        plt.savefig(savefig, bbox_inches="tight")
    plt.show()
