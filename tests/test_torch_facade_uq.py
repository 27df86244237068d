"""Port parity, the facade's forward UQ and held-out diagnostics:
`GPMCMC.y_dist`, `test_plots` (with `_regression_metrics`),
`relative_importances` and `engine.predict_diag` against the JAX
reference on the same numpy data and hypers (fitted by the reference,
carried across by fit(method='none')); mirrors of the reference's tests
of them (tests/test_gpmcmc.py, tests/test_gpmcmc_variants.py,
tests/test_gp_engine.py); and the golden parity of the port's f64 MAP
objective and fit against an independent numpy/scipy oracle (mirror of
tests/test_golden_parity.py).

The predictive variances of the toy's near-interpolating fits (gv
~1e-7) are kss - |L^-1 k|^2 + gv, which cancels kss to a few 1e-7: they
are held at rtol 1e-9 or at their f64 rounding band gamma_n kss / var
(gamma_n = n eps, the error bound of the length-n dot product), where
that is larger; the means at the stated tolerances.
"""

import math
import re

import numpy as np
import pytest
import scipy.linalg as sla
import scipy.stats as st
from scipy.optimize import minimize

import jax.numpy as jnp
import torch

from andvaranaut_tpu import GPMCMC as JGPMCMC
from andvaranaut_tpu import dists as jdists
from andvaranaut_tpu import gpmcmc as jgpmcmc
from andvaranaut_tpu import transform as jtf
from andvaranaut_tpu.gp import engine as jengine
from andvaranaut_torch import dists, gpmcmc
from andvaranaut_torch import transform as tf
from andvaranaut_torch.gp import engine
from andvaranaut_torch.lhc import _none_conrev

EPS = np.finfo(np.float64).eps
_LOG_2PI = math.log(2.0 * math.pi)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module (the suite's parallel workers
    would oversubscribe a multi-threaded pool).  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_show(monkeypatch):
    """Headless plots: the Agg backend, plt.show a no-op."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    monkeypatch.setattr(plt, "show", lambda: None)
    yield plt
    plt.close("all")


def _toy(x):
    return np.array([x[0] ** 2 - x[0] - x[1] ** 2 * x[0] + x[1]])


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The reference fitted by MAP and a port facade (device='cpu')
    carrying its hypers, on 40 points of the toy (meanstd outputs)."""
    rundir = str(tmp_path_factory.mktemp("runs"))
    rng = np.random.default_rng(3)
    x = np.column_stack([rng.uniform(0, 2, 40), rng.uniform(1, 1.5, 40)])
    y = np.array([_toy(r) for r in x])
    jp = [jdists.Uniform(0.0, 2.0), jdists.Uniform(1.0, 0.5)]
    gj = JGPMCMC(nx=2, ny=1, priors=jp, target=_toy,
                 xconrevs=[jtf.uniform(p) for p in jp], verbose=False,
                 rundir=rundir)
    gj.set_data(x, y)
    gj.change_yconrevs([jtf.meanstd(gj.y[:, 0])])
    gj.fit(method="map")
    pp = [dists.Uniform(0.0, 2.0), dists.Uniform(1.0, 0.5)]
    gp = gpmcmc.GPMCMC(nx=2, ny=1, priors=pp, target=_toy,
                       xconrevs=[tf.uniform(p) for p in pp], verbose=False,
                       rundir=rundir, device="cpu")
    gp.set_data(x, y)
    gp.change_yconrevs([tf.meanstd(gp.y[:, 0])])
    gp.hypers = {k: np.array(v) for k, v in gj.hypers.items()}
    gp.fit(method="none")
    return gj, gp


def _make(tmp_path, n=40, seed=11):
    """tests/test_gpmcmc_variants.py's _make through the port
    (device='cpu'), unfitted."""
    priors = [dists.Uniform(0.0, 2.0), dists.Uniform(1.0, 0.5)]
    g = gpmcmc.GPMCMC(
        nx=2, ny=1, priors=priors, target=_toy,
        xconrevs=[tf.uniform(priors[0]), tf.uniform(priors[1])],
        verbose=False, rundir=str(tmp_path / "runs"), device="cpu")
    g.sample(n, seed=seed)
    g.change_yconrevs([tf.meanstd(g.y[:, 0])])
    return g


# -- y_dist ------------------------------------------------------------------

def test_y_dist_predictions_match_reference(pair, no_show):
    """The port's forward-UQ draws, passed through the reference's
    predict, give the port's propagated outputs to 1e-10, normwise (the
    toy's outputs cross zero)."""
    gj, gp = pair
    xs, ys = gp.y_dist(mode="kde", nsamps=300, return_data=True)
    assert xs.shape == (300, 2) and ys.shape == (300, 1)
    yj = gj.predict(xs)
    assert np.abs(ys - yj).max() <= 1e-10 * np.abs(yj).max()


def test_y_dist_surrogate(tmp_path, monkeypatch, no_show):
    monkeypatch.chdir(tmp_path)
    g = _make(tmp_path, n=40)
    g.fit(method="map")
    xs, ys = g.y_dist(mode="hist_kde", nsamps=200, return_data=True)
    assert xs.shape == (200, 2) and ys.shape == (200, 1)
    ytrue = np.array([_toy(x)[0] for x in xs])
    assert abs(ys.mean() - ytrue.mean()) < 0.05


def test_y_dist_default_nsamps(tmp_path, monkeypatch, no_show):
    """y_dist() with the nsamps default works (the reference's own
    None crashes; 1000 prior samples through the surrogate)."""
    monkeypatch.chdir(tmp_path)
    g = _make(tmp_path, n=25)
    g.fit(method="map")
    xs, ys = g.y_dist(return_data=True)
    assert xs.shape == (1000, 2)
    assert ys.shape[0] == 1000
    assert np.isfinite(ys).all()


def test_y_dist_data_and_refusals(pair, no_show):
    """surrogate=False plots the sampled outputs (LHC.y_dist); a
    non-bool surrogate and an unknown mode raise."""
    _, gp = pair
    assert gp.y_dist(surrogate=False, mode="ecdf") is None
    with pytest.raises(Exception, match="bool"):
        gp.y_dist(surrogate="yes")
    with pytest.raises(Exception, match="mode must be one of"):
        gp.y_dist(mode="violin", nsamps=10)


# -- test_plots --------------------------------------------------------------

def _same_split(gj, gp, seed=1, ntrain=32):
    idx = np.random.default_rng(seed).permutation(len(gj.x))
    for g in (gj, gp):
        g.train, g.test = idx[:ntrain].copy(), idx[ntrain:].copy()


@pytest.mark.parametrize("revert", [True, False])
def test_test_plots_none_matches_reference(pair, revert):
    """method='none' on the same split: test points and targets equal,
    predictions to 1e-9, variances to 1e-9 or their rounding band; the
    metric function is the reference's, and each package's metrics
    differ by no more than their bounds in the predictions' difference
    (the metrics are of errors ~1e-4, so 1e-12 in a prediction is 1e-8
    of an RMSE)."""
    gj, gp = pair
    _same_split(gj, gp)
    kw = dict(revert=revert, yplots=False, xplots=False, method="none",
              returndat=True)
    xj, yj, pj, vj = gj.test_plots(**kw)
    xp, yp, pp, vp = gp.test_plots(**kw)
    np.testing.assert_array_equal(xp, xj)
    np.testing.assert_allclose(yp, yj, rtol=1e-12)
    np.testing.assert_allclose(pp, pj, rtol=1e-9)
    _, var = gj.predict(gj.x[gj.test], return_var=True, revert=False)
    kss = float(np.sum(gj.hypers["kv"]))
    band = len(gj.train) * EPS * kss / var[:, 0]
    assert (np.abs(vp - vj) <= np.maximum(1e-9, band) * np.abs(vj)).all()
    ybar = np.mean(gj.y) if revert else np.mean(gj.yc)
    mp = gpmcmc._regression_metrics(pp, yp, ybar)
    for k, v in jgpmcmc._regression_metrics(pp, yp, ybar).items():
        np.testing.assert_allclose(mp[k], v, rtol=1e-14, err_msg=k)
    mj = jgpmcmc._regression_metrics(pj, yj, ybar)
    dp = np.abs(pp - pj)
    err, ss = pj - yj, float(np.sum((yj - ybar) ** 2))
    bounds = {
        "rmse": dp.max(), "mae": dp.max(),
        "mpe": float(np.mean(dp / np.abs(yj))),
        "r2": (2 * np.linalg.norm(err) * np.linalg.norm(dp)
               + float(dp @ dp)) / ss}
    for k in mj:
        assert abs(mp[k] - mj[k]) <= max(1e-9 * abs(mj[k]),
                                         bounds[k] * (1 + 1e-9)), k


def test_test_plots_map_matches_reference(pair):
    """method='map' refits on the train split in both packages (the port's
    f64 MAP fit against the reference's): predictions within 1e-3, the
    tolerance of the hypers in tests/test_torch_workflow.py::
    test_fit_map_matches_reference."""
    gj, gp = pair
    _same_split(gj, gp, seed=2)
    kw = dict(yplots=False, xplots=False, method="map", returndat=True)
    _, yj, pj, vj = gj.test_plots(**kw)
    _, yp, pp, vp = gp.test_plots(**kw)
    np.testing.assert_allclose(yp, yj, rtol=1e-12)
    np.testing.assert_allclose(pp, pj, rtol=1e-3)
    assert np.isfinite(vp).all() and (vp > 0).all()


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """tests/test_gpmcmc.py's fixture through the port: 100 LHC samples
    of the toy, uniform and meanstd conversions, RBF MAP fit."""
    import os

    tmp = tmp_path_factory.mktemp("runs")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        priors = [dists.Uniform(0.0, 2.0), dists.Uniform(1.0, 0.5)]
        g = gpmcmc.GPMCMC(
            nx=2, ny=1, priors=priors, target=_toy,
            xconrevs=[tf.uniform(priors[0]), tf.uniform(priors[1])],
            yconrevs=None, kernel="RBF", noise=True, verbose=False,
            rundir=str(tmp / "runs"), device="cpu")
        g.sample(100, seed=5)
        g.change_yconrevs([tf.meanstd(g.y[:, 0])])
        g.fit(method="map")
    finally:
        os.chdir(cwd)
    return g


def test_holdout_metrics(fitted):
    g = fitted
    np.random.seed(0)
    g.train_test()
    xt, yt, yp, yv = g.test_plots(yplots=False, xplots=False, returndat=True)
    rmse = float(np.sqrt(np.mean((yp - yt) ** 2)))
    r2 = 1 - np.sum((yp - yt) ** 2) / np.sum((yt - np.mean(g.y)) ** 2)
    assert rmse < 5e-3
    assert r2 > 0.9999
    assert (np.abs(yp - yt) < 5 * np.sqrt(yv) + 1e-4).all()
    g.fit(method="map")


def test_test_plots_with_map_fit(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    np.random.seed(3)
    g = _make(tmp_path, n=60)
    g.fit(method="map")
    g.train_test(training_frac=0.8)
    xtest, ytest, ypred, yvars = g.test_plots(
        yplots=False, xplots=False, method="map", returndat=True)
    assert len(xtest) == len(ytest) == len(ypred) == 12
    r2 = 1 - np.sum((ypred - ytest) ** 2) / np.sum(
        (ytest - np.mean(g.y)) ** 2)
    assert r2 > 0.999


def test_test_plots_unreverted(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    np.random.seed(4)
    g = _make(tmp_path, n=50)
    g.fit(method="map")
    g.train_test()
    xtest, ytest, ypred, yvars = g.test_plots(
        revert=False, yplots=False, xplots=False, method="map",
        returndat=True)
    assert np.abs(ypred - ytest).max() < 0.5


@pytest.mark.parametrize("kw", [{}, {"logscale": True},
                                {"errorbars": False}])
def test_test_plots_draws(pair, no_show, tmp_path, kw):
    """The parity and per-input panels draw headless; saveyfig writes the
    parity figure."""
    gj, gp = pair
    _same_split(gj, gp)
    fname = str(tmp_path / "y.png")
    assert gp.test_plots(saveyfig=fname, **kw) is None
    assert (tmp_path / "y.png").stat().st_size > 0


def test_test_plots_refit_raises_for_warpings(pair):
    """The refit goes through the facade's fit: cwgp on an output
    conversion that is not a wgp raises there as in fit, with the
    reference's error."""
    _, gp = pair
    with pytest.raises(Exception, match="yconrevs class is not wgp"):
        gp.test_plots(yplots=False, xplots=False, method="map", cwgp=True)


# -- relative_importances -----------------------------------------------------

@pytest.mark.parametrize("logscale", [False, True])
def test_relative_importances_matches_reference(pair, no_show, monkeypatch,
                                                logscale):
    """The bars drawn are the reference's: 1 / l, log-scaled on
    request."""
    gj, gp = pair
    seen = []
    real = no_show.bar

    def bar(labels, vals, *a, **k):
        seen.append((list(labels), np.asarray(vals, dtype=float)))
        return real(labels, vals, *a, **k)

    monkeypatch.setattr(no_show, "bar", bar)
    gj.relative_importances(logscale=logscale)
    gp.relative_importances(logscale=logscale)
    (lj, vj), (lp, vp) = seen
    assert lp == lj == ["x[0]", "x[1]"]
    np.testing.assert_array_equal(vp, vj)


# -- engine.predict_diag -------------------------------------------------------

@pytest.mark.parametrize("gv", [0.01, 0.0])
def test_predict_diag_matches_reference(gv):
    """engine.predict_diag (fresh exact f64 conditioning) against the
    reference's, as tests/test_gp_engine.py uses it, to 1e-10 (the
    variance at gv = 0 to its rounding band gamma_n kss, where larger)."""
    rng = np.random.default_rng(4)
    X = rng.uniform(size=(20, 2))
    y = np.sin(3 * X[:, 0]) + X[:, 1]
    xs = rng.uniform(size=(7, 2))
    l, kv, jitter = np.array([0.4, 0.6]), np.array([1.7]), 1e-6
    mu_j, var_j = jengine.predict_diag(
        ("RBF",), (), jnp.asarray(X), jnp.asarray(y), jnp.asarray(xs),
        jnp.asarray(l), jnp.asarray(kv), gv, None, jitter)
    mu, var = engine.predict_diag(
        ("RBF",), (), torch.as_tensor(X), torch.as_tensor(y),
        torch.as_tensor(xs), torch.as_tensor(l), torch.as_tensor(kv), gv,
        None, jitter)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), rtol=1e-10)
    # the latent variance cancels kss: 1e-10 or its rounding band
    var_j = np.asarray(var_j)
    band = len(X) * EPS * float(kv.sum())
    assert (np.abs(var.numpy() - var_j)
            <= np.maximum(1e-10 * var_j, band)).all()


def test_predict_diag_interpolates_noise_free():
    """Mirror of tests/test_gp_engine.py::test_interpolation_noise_free."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(12, 2))
    y = np.sin(3 * X[:, 0]) + X[:, 1]
    Xt = torch.as_tensor(X)
    mu, var = engine.predict_diag(
        ("RBF",), (), Xt, torch.as_tensor(y), Xt,
        torch.tensor([0.5, 0.5], dtype=torch.float64),
        torch.tensor([1.0], dtype=torch.float64), 0.0, None, 1e-10)
    np.testing.assert_allclose(mu.numpy(), y, atol=1e-6)
    assert (var.numpy() < 1e-6).all()


# -- golden parity: an independent numpy/scipy oracle --------------------------

def _dataset(n=40, nx=2, seed=11):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, nx))
    l_true = np.array([0.5, 1.1])
    d = (X[:, None, :] - X[None, :, :]) / l_true
    K = 3.0 * np.exp(-0.5 * np.sum(d * d, axis=-1))
    y = np.linalg.cholesky(K + 1e-10 * np.eye(n)) @ rng.normal(size=n)
    y = y + 1e-3 * rng.normal(size=n)
    return X, y


def _oracle_neg_log_post(z, X, y, jitter=1e-6):
    """The transformed log posterior in numpy and scipy.stats: z = [log
    gv, log l_0.., log kv]; the RBF marginal likelihood by numpy Cholesky
    plus the hyperprior logpdfs and the log transform's Jacobian."""
    n, nx = X.shape
    gv = math.exp(z[0])
    l = np.exp(z[1:1 + nx])
    kv = math.exp(z[1 + nx])
    d = (X[:, None, :] - X[None, :, :]) / l
    K = kv * np.exp(-0.5 * np.sum(d * d, axis=-1)) + (jitter + gv) * np.eye(n)
    L = np.linalg.cholesky(K)
    beta = sla.solve_triangular(L, y, lower=True)
    logl = -0.5 * beta @ beta - np.sum(np.log(np.diag(L))) - 0.5 * n * _LOG_2PI
    logp = float(st.halfnorm(scale=1e-3).logpdf(gv)) + z[0]
    logp += float(np.sum(st.lognorm(s=1.0, scale=1.0).logpdf(l))) + float(
        np.sum(z[1:1 + nx]))
    logp += float(
        st.lognorm(s=0.75, scale=math.exp(0.56)).logpdf(kv)) + z[1 + nx]
    return -(logl + logp)


def _cfg(X, y):
    nx = X.shape[1]
    return engine.FitConfig(
        kerns=("RBF",), ops=(), noise=True, truncate=False, jitter=1e-6,
        iwgp=False, cwgp=False, priors=[None] * nx,
        xconrevs=[_none_conrev()] * nx, yconrevs=[_none_conrev()],
        x=X, y=y.reshape(-1, 1))


def test_log_posterior_matches_oracle_pointwise():
    X, y = _dataset()
    rvpack, nlp = engine.build_objective(_cfg(X, y), device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(5):
        z = rvpack.z0().numpy() + rng.normal(scale=0.3, size=rvpack.total)
        ours = float(nlp(torch.as_tensor(z)))
        assert ours == pytest.approx(_oracle_neg_log_post(z, X, y),
                                     rel=1e-10), z


def test_map_fit_matches_oracle_optimum():
    """engine.map_fit lands on the MAP point scipy L-BFGS-B finds on the
    oracle."""
    X, y = _dataset()
    cfg = _cfg(X, y)
    rvpack, _ = engine.build_objective(cfg, device="cpu")
    res = minimize(
        _oracle_neg_log_post, rvpack.z0().numpy(), args=(X, y),
        method="L-BFGS-B",
        options={"maxiter": 500, "ftol": 1e-14, "gtol": 1e-10})
    nx = X.shape[1]
    hypers, logpost = engine.map_fit(cfg, max_iter=1000, tol=1e-12,
                                     device="cpu")
    assert logpost >= -res.fun - 1e-6
    assert logpost == pytest.approx(-res.fun, abs=1e-3)
    np.testing.assert_allclose(np.asarray(hypers["l"]),
                               np.exp(res.x[1:1 + nx]), rtol=5e-3)
    np.testing.assert_allclose(float(np.asarray(hypers["kv"])[0]),
                               math.exp(res.x[1 + nx]), rtol=5e-3)


def test_nlml_matches_oracle_at_recorded_reference_hypers():
    """At BASELINE.md's reference-fitted hypers (gv 1e-8, K near
    singular: two f64 Choleskys differ ~1e-12 relative)."""
    X, y = _dataset()
    z = np.concatenate([[math.log(1e-8)], np.log([1.1314017, 2.68928595]),
                        [math.log(68.35800214)]])
    _, nlp = engine.build_objective(_cfg(X, y), device="cpu")
    assert float(nlp(torch.as_tensor(z))) == pytest.approx(
        _oracle_neg_log_post(z, X, y), rel=1e-9)


# -- the tutorial ----------------------------------------------------------------

def test_tutorial_runs_on_cpu(no_show, capsys):
    """`python -m andvaranaut_torch.tutorial --device cpu`: the reference
    workflow end to end (examples/tutorial.py, call for call), its
    forward UQ against the true mean and its inverse solution against
    the observation."""
    from andvaranaut_torch import tutorial

    tutorial.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "pickle round-trip OK" in out
    sur, true = map(float, re.search(
        r"surrogate mean (\S+) vs true (\S+)", out).groups())
    assert abs(sur - true) < 0.05
    assert re.search(r"^inverse: x=", out, re.M)
