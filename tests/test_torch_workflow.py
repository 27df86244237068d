"""Port parity, the GPMCMC workflow: fit -> predict -> BO on the toy
problem of tests/test_bo_inverse.py (priors U(0,2) x U(1,1.5), uniform
input conversions, meanstd output conversion), the same numpy data set
into the JAX reference and the port (device="cpu").  The reference's
mixed BO dispatch is forced as tests/test_bo_mixed.py forces it; the
port's at block 256 (40 rows pad to one block)."""

import copy

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from andvaranaut_tpu import GPMCMC as JGPMCMC
from andvaranaut_tpu import dists as jdists
from andvaranaut_tpu import transform as jtf
from andvaranaut_tpu.gp import engine as jengine
from andvaranaut_torch import dists, gpmcmc
from andvaranaut_torch import transform as tf
from andvaranaut_torch.gp import engine

N = 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its MCMC tests run many small
    torch ops in loops, which wait on an oversubscribed intra-op thread
    pool when the suite runs in parallel workers.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy(x):
    return np.array([x[0] ** 2 - x[0] - x[1] ** 2 * x[0] + x[1]])


def _port(x, y, rundir):
    priors = [dists.Uniform(0.0, 2.0), dists.Uniform(1.0, 0.5)]
    g = gpmcmc.GPMCMC(nx=2, ny=1, priors=priors, target=_toy,
                      xconrevs=[tf.uniform(p) for p in priors],
                      verbose=False, rundir=rundir, device="cpu")
    g.set_data(x, y)
    g.change_yconrevs([tf.meanstd(g.y[:, 0])])
    return g


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The reference fitted by MAP, the port fitted by MAP, and a port
    facade carrying the reference's hypers (fit(method='none'))."""
    rundir = str(tmp_path_factory.mktemp("runs"))
    rng = np.random.default_rng(11)
    x = np.column_stack([rng.uniform(0, 2, N), rng.uniform(1, 1.5, N)])
    y = np.array([_toy(r) for r in x])
    jpriors = [jdists.Uniform(0.0, 2.0), jdists.Uniform(1.0, 0.5)]
    gj = JGPMCMC(nx=2, ny=1, priors=jpriors, target=_toy,
                 xconrevs=[jtf.uniform(p) for p in jpriors], verbose=False,
                 rundir=rundir)
    gj.set_data(x, y)
    gj.change_yconrevs([jtf.meanstd(gj.y[:, 0])])
    gj.fit(method="map")
    gp = _port(x, y, rundir)
    gp.fit(method="map")
    gh = _port(x, y, rundir)
    gh.hypers = {k: np.array(v) for k, v in gj.hypers.items()}
    gh.fit(method="none")
    return gj, gp, gh, rng


def _logpost(eng, g, hypers):
    cfg = eng.FitConfig(
        kerns=tuple(g.kerns), ops=tuple(g.ops), noise=g.noise,
        truncate=False, jitter=1e-6, iwgp=False, cwgp=False, priors=g.priors,
        xconrevs=g.xconrevs, yconrevs=g.yconrevs, x=g.x, y=g.y - g.ym)
    if eng is engine:
        rvpack, nlp = eng.build_objective(cfg, device="cpu")
        return -float(nlp(rvpack.pack_values(hypers)))
    rvpack, nlp = eng.build_objective(cfg)
    return -float(nlp(rvpack.pack_values(hypers)))


def test_fit_map_matches_reference(pair):
    """The exact f64 MAP fit (port: autograd and L-BFGS with PyTorch's
    strong-Wolfe line search; reference: optax L-BFGS): hypers to 1e-3,
    the log posterior to 1e-7, each package's objective at its own
    optimum.  Run with -s to see the values."""
    gj, gp, _, _ = pair
    lp_j = _logpost(jengine, gj, gj.hypers)
    lp_p = _logpost(engine, gp, gp.hypers)
    print(f"logpost port {lp_p!r} reference {lp_j!r}; hypers port "
          f"{ {k: np.asarray(v).tolist() for k, v in gp.hypers.items()} } "
          f"reference "
          f"{ {k: np.asarray(v).tolist() for k, v in gj.hypers.items()} }")
    assert abs(lp_p - lp_j) <= 1e-7 * abs(lp_j)
    for k in ("l", "kv", "gv"):
        np.testing.assert_allclose(gp.hypers[k], gj.hypers[k], rtol=1e-3,
                                   err_msg=k)
    # the same objective at the same hypers, across the packages (K is
    # ill-conditioned at gv ~ 1e-7: rounding moves the value ~1e-10)
    np.testing.assert_allclose(_logpost(engine, gp, gj.hypers), lp_j,
                               rtol=1e-9)


@pytest.mark.parametrize("kw", [{}, {"revert": False}, {"convert": False},
                                {"normvar": True}])
def test_facade_predict_with_reference_hypers(pair, kw):
    """The reference's hypers carried across by fit(method='none'):
    predictions (GH reversion included) to 1e-8."""
    gj, _, gh, rng = pair
    q = np.column_stack([rng.uniform(0, 2, 17), rng.uniform(1, 1.5, 17)])
    if kw.get("convert") is False:
        q = np.column_stack([np.asarray(c.con(q[:, i]))
                             for i, c in enumerate(gj.xconrevs)])
    y, yv = gh.predict(q, return_var=True, **kw)
    yj, yvj = gj.predict(q, return_var=True, **kw)
    assert y.shape == yv.shape == (17, 1)
    np.testing.assert_allclose(y, yj, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(yv, yvj, rtol=1e-8, atol=1e-12)


def _acquisitions(g, X, mixed=None):
    if mixed is None:
        sargs, ha, m = g._bo_state_args(1e-6)
    else:
        sargs, ha, m = mixed
    yopt = float(np.min(g.y))
    out = {}
    for meth in ("EI", "explore", "exploit"):
        fn = g._acq_fn(meth, "min", True, ha, m)
        if isinstance(sargs[0], torch.Tensor):
            out[meth] = fn(torch.as_tensor(X), *sargs, yopt).numpy()
        else:
            out[meth] = np.asarray(fn(jnp.asarray(X), *sargs,
                                      jnp.asarray(yopt)))
    return out


@pytest.fixture(scope="module")
def reference_acq(pair):
    gj, _, _, rng = pair
    X = np.column_stack([rng.uniform(0, 2, 13), rng.uniform(1, 1.5, 13)])
    return X, _acquisitions(gj, X)


def test_acq_fn_exact_matches_reference(pair, reference_acq):
    """The batched acquisitions on the exact state, at 1e-9 (atol 1e-10,
    test_bo_mixed.py's: the explore values are latent variances of order
    1e-6 from kss - |L^-1 k*|^2 with kss ~ 55, where f64 rounding through
    the ill-conditioned solve leaves ~1e-11)."""
    _, _, gh, _ = pair
    X, ref = reference_acq
    assert gh._bo_state_args(1e-6)[2] is False
    got = _acquisitions(gh, X)
    for meth, v in ref.items():
        np.testing.assert_allclose(got[meth], v, rtol=1e-9, atol=1e-10,
                                   err_msg=meth)


def _force_mixed(monkeypatch):
    monkeypatch.setattr(gpmcmc.GPMCMC, "_bo_mixed", lambda self: True)
    monkeypatch.setattr(gpmcmc.GPState, "MIXED_BLOCK", 256)


def test_acq_fn_mixed_matches_reference(pair, reference_acq, monkeypatch):
    """Through the mixed conditioning: EI and exploit ride the f64-grade
    alpha (1e-6), the variance acquisition the slice-arithmetic whitened
    solve (1e-2), the grades of test_bo_mixed.py:67."""
    _, _, gh, _ = pair
    X, ref = reference_acq
    _force_mixed(monkeypatch)
    state = gh._bo_state_args(1e-6)
    assert state[2] is True and len(state[0]) == 9  # Dinv threaded through
    got = _acquisitions(gh, X, state)
    tols = {"EI": 1e-6, "exploit": 1e-6, "explore": 1e-2}
    for meth, v in ref.items():
        np.testing.assert_allclose(got[meth], v, rtol=tols[meth], atol=1e-10,
                                   err_msg=meth)


def test_refine_through_mixed_matches_reference(pair, monkeypatch):
    """The refine program differentiates the acquisition in the query
    point through K9's Function and solve_lower_linear's adjoint; its
    optimum value through the mixed state against the reference's exact
    refine, at 1e-4 (test_bo_mixed.py:96)."""
    gj, _, gh, _ = pair
    gj.yopt = gh.yopt = float(np.min(gj.y))
    sj, haj, _ = gj._bo_state_args(1e-6)
    runj, rvj = gj._get_bo_program("refine", "EI", "min", True, haj, False)
    zj, vj = runj(jnp.zeros(rvj.total), *sj, jnp.asarray(gj.yopt))
    _force_mixed(monkeypatch)
    s, ha, mixed = gh._bo_state_args(1e-6)
    run, rv = gh._get_bo_program("refine", "EI", "min", True, ha, mixed)
    z, v = run(torch.zeros(rv.total, dtype=torch.float64), *s, gh.yopt)
    assert mixed and np.isfinite(z.numpy()).all() and np.isfinite(v)
    np.testing.assert_allclose(v, float(vj), rtol=1e-4, atol=1e-6)
    assert gh._get_bo_program("refine", "EI", "min", True, ha, mixed)[0] \
        is run


@pytest.mark.parametrize("mode", [
    {"opt_method": "predict", "refine": True, "predict_samps": 64},
    {"opt_method": "DE", "method": "exploit"}])
def test_bo_iteration(pair, mode, monkeypatch, tmp_path):
    """One BO iteration through the mixed state: a finite point appended,
    a finite refit, and an optimum no worse than the design's."""
    _, gp, _, _ = pair
    g = copy.deepcopy(gp)
    g.rundir = str(tmp_path)
    _force_mixed(monkeypatch)
    np.random.seed(1)
    y0 = float(np.min(g.y))
    xopt, yopt = g.BO(max_iter=1, **mode)
    assert g.nsamp == N + 1 and g.xc.shape == (N + 1, 2)
    assert np.isfinite(xopt).all() and np.isfinite(yopt)
    assert yopt <= y0
    assert all(np.isfinite(np.asarray(v)).all() for v in g.hypers.values())


def test_facade_contract(tmp_path, monkeypatch):
    """The sharded routes refuse a mesh that is not a DeviceMesh, the
    learnable warpings refuse conversions that are not wgp, and the
    rest of the facade runs; the facade needs a device or an explicit
    CPU request."""
    priors = [dists.Uniform(0.0, 2.0), dists.Uniform(1.0, 0.5)]
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError):
            gpmcmc.GPMCMC(nx=2, ny=1, priors=priors, target=_toy,
                          verbose=False, rundir=str(tmp_path))
    g = gpmcmc.GPMCMC(nx=2, ny=1, priors=priors, target=_toy, verbose=False,
                      rundir=str(tmp_path), device="cpu")
    g.sample(12, seed=0)
    assert g.x.shape == (12, 2) and g.yc.shape == (12, 1)
    g.fit(method="map")
    for call in (lambda: g.fit(method="mcmc_mean", mesh=object()),
                 lambda: g.fit(method="map", precision="distributed",
                               mesh=object())):
        with pytest.raises(TypeError, match="DeviceMesh"):
            call()
    # the learnable warpings need wgp conversions (the reference's errors)
    with pytest.raises(Exception, match="none of xconrevs are wgp"):
        g.fit(method="map", iwgp=True)
    with pytest.raises(Exception, match="yconrevs class is not wgp"):
        g.test_plots(cwgp=True, method="map")
    _, xinv = g.inverse_opt(np.array([0.1]))
    assert xinv.shape == (2,) and np.isfinite(xinv).all()
    out = g.test_plots(yplots=False, xplots=False, returndat=True)
    assert all(np.isfinite(a).all() for a in out)
    g.del_samples(2, method="specific", idx=[0, 3])
    assert g.x.shape == (10, 2) and g.ym.shape == (10, 1)
    g.train_test(0.8)
    assert len(g.train) == 8 and len(g.test) == 2


def _mcmc_toy(tmp_path):
    """tests/test_nuts.py::test_gp_hyper_mcmc's toy: 30 LHC samples of the
    target, meanstd output conversion."""
    priors = [dists.Uniform(0.0, 2.0), dists.Uniform(1.0, 0.5)]
    g = gpmcmc.GPMCMC(nx=2, ny=1, priors=priors, target=_toy,
                      xconrevs=[tf.uniform(p) for p in priors],
                      verbose=False, rundir=str(tmp_path / "runs"),
                      device="cpu")
    g.sample(30, seed=5)
    g.change_yconrevs([tf.meanstd(g.y[:, 0])])
    return g


def test_gp_hyper_mcmc(tmp_path):
    """Mirror of tests/test_nuts.py::test_gp_hyper_mcmc: fit by the
    posterior mean of NUTS draws (the MCMCData carrier returned), then
    by mcmc_map plus the exact MAP refine, whose predictions at the
    design points come within 0.05 (shorter runs than the reference
    test's 200 + 200 draws: the host NUTS costs ~2 ms a leapfrog here)."""
    g = _mcmc_toy(tmp_path)
    data = g.fit(method="mcmc_mean", return_data=True, draws=100, tune=100,
                 chains=2, random_seed=1)
    assert g.hypers is not None
    assert set(g.hypers) >= {"gv", "l", "kv"}
    assert np.asarray(g.hypers["l"]).shape == (2,)
    assert (np.asarray(data.sample_stats["lp"]) != 0).any()
    assert data.posterior["l"].shape == (2, 100, 2)
    np.testing.assert_allclose(g.hypers["kv"],
                               data.posterior["kv"].mean(), rtol=1e-12)
    assert g.fit(method="map", return_data=True) is None
    # mcmc_map extraction + refinement path
    g.fit(method="mcmc_map", draws=50, tune=100, chains=2, random_seed=2)
    yhat = g.predict(g.x)
    assert np.abs(yhat[:, 0] - g.y[:, 0]).max() < 0.05


@pytest.mark.parametrize("opt_method", ["mcmc_map", "mcmc_mean"])
def test_bo_iteration_mcmc(tmp_path, opt_method):
    """One BO iteration with opt_method 'mcmc_map' / 'mcmc_mean': NUTS
    over the EI posterior of the input point (the reference's
    _refine_nlp through sample_rvpack), the target evaluated there and
    appended, a finite refit."""
    g = _mcmc_toy(tmp_path)
    g.fit(method="map")
    np.random.seed(0)
    xopt, yopt = g.BO(max_iter=1, opt_method=opt_method, draws=30, tune=30,
                      chains=2, random_seed=0)
    assert g.nsamp == 31 and g.xc.shape == (31, 2)
    x_new = g.x[-1]
    assert 0.0 <= x_new[0] <= 2.0 and 1.0 <= x_new[1] <= 1.5
    assert np.isfinite(xopt).all() and np.isfinite(yopt)
    assert all(np.isfinite(np.asarray(v)).all() for v in g.hypers.values())


def test_refine_nlp_matches_reference(pair):
    """The BO MCMC potential over the input point equals the reference's
    _refine_nlp (exact f64 state, EI through Gauss-Hermite) at the same
    hypers, value and gradient."""
    gj, _, gh, _ = pair
    gh.yopt = gj.yopt = float(np.min(gj.y))
    rvj, nlpj = gj._refine_nlp("EI", "min", True, 1e-6)
    rvp, nlpp = gh._refine_nlp("EI", "min", True, 1e-6)
    import jax

    for z in (np.array([0.3, -0.2]), np.array([-1.0, 0.8])):
        vj, gjr = jax.value_and_grad(nlpj)(jnp.asarray(z))
        zt = torch.tensor(z, requires_grad=True)
        vp = nlpp(zt)
        (gp_,) = torch.autograd.grad(vp, zt)
        np.testing.assert_allclose(float(vp.detach()), float(vj),
                                   rtol=1e-9)
        np.testing.assert_allclose(gp_.numpy(), np.asarray(gjr), rtol=1e-7,
                                   atol=1e-10)
