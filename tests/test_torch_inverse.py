"""Port parity, the inverse problem: `GPMCMC.inverse_opt` and its
objective on the conditioned training state (`GPMCMC._inverse_nlp`)
against the JAX reference's joint-Gram algebra, on the same numpy data
and the hypers the reference fitted (carried across by
fit(method='none')), and mirrors of tests/test_bo_inverse.py's inverse
cases.

Tolerances.  The value is held at rtol 1e-10 and the gradient normwise
at 1e-8, or at the objective's own f64 rounding band where that is
larger.  The toy's fits nearly interpolate (gv ~1e-7, cond(K) ~1e9),
and there the function is not determined to 1e-10 in f64 by any
algorithm: the reference's joint Cholesky and the port's split form
both sit ~3e-8 (absolute) from a 50-digit evaluation of the training
block's log density, and 1e-9 - 1e-8 (relative) from one of the whole
value (`test_nlp_rounding_grade_against_exact`).  The band is the
first-order change of the value under the rounding of its two parts:
  - the training block, K perturbed by eps kss:
    eps kss (tr K^-1 + |K^-1 y|^2);
  - the observations' predictive variance s2 = kss - k^T K^-1 k, a
    length-n dot product that cancels kss to a few 1e-7, perturbed by
    its error bound gamma_n kss (gamma_n = n eps): gamma_n kss |du/ds2|.
The gradient's band is rho = gamma_n kss / (s2 + min nv_o), the relative
change of the observations' covariance.  All are computed in numpy from
the reference's own joint matrix.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from andvaranaut_tpu import GPMCMC as JGPMCMC
from andvaranaut_tpu import dists as jdists
from andvaranaut_tpu import transform as jtf
from andvaranaut_tpu.gp import engine as jengine
from andvaranaut_tpu.gp import kernels as jkernels
from andvaranaut_tpu.gp import quad as jquad
from andvaranaut_tpu.inference.unconstrained import RVPack as JRVPack
from andvaranaut_torch import dists, gpmcmc
from andvaranaut_torch import transform as tf
from andvaranaut_torch.gp import engine, precision
from andvaranaut_torch.inference.unconstrained import RVPack

N = 40
EPS = np.finfo(np.float64).eps
XTRUE = np.array([0.7, 1.2])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module (the suite's parallel workers
    would oversubscribe a multi-threaded pool).  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy(x):
    return np.array([x[0] ** 2 - x[0] - x[1] ** 2 * x[0] + x[1]])


def _pos_toy(x):
    """The toy shifted positive (min 1), so the logarithm warp applies."""
    return _toy(x) + 2.0


def _warp(mod, name, y):
    return mod.meanstd(y) if name == "meanstd" else mod.logarithm()


def _pair(rundir, noise, warp, seed=3, n=N):
    """The reference fitted by MAP and a port facade (device='cpu')
    carrying its hypers, on the same numpy data."""
    rng = np.random.default_rng(seed)
    x = np.column_stack([rng.uniform(0, 2, n), rng.uniform(1, 1.5, n)])
    y = np.array([_pos_toy(r) for r in x])
    jp = [jdists.Uniform(0.0, 2.0), jdists.Uniform(1.0, 0.5)]
    gj = JGPMCMC(nx=2, ny=1, priors=jp, target=_pos_toy,
                 xconrevs=[jtf.uniform(p) for p in jp], noise=noise,
                 verbose=False, rundir=rundir)
    gj.set_data(x, y)
    gj.change_yconrevs([_warp(jtf, warp, gj.y[:, 0])])
    gj.fit(method="map")
    pp = [dists.Uniform(0.0, 2.0), dists.Uniform(1.0, 0.5)]
    gp = gpmcmc.GPMCMC(nx=2, ny=1, priors=pp, target=_pos_toy,
                       xconrevs=[tf.uniform(p) for p in pp], noise=noise,
                       verbose=False, rundir=rundir, device="cpu")
    gp.set_data(x, y)
    gp.change_yconrevs([_warp(tf, warp, gp.y[:, 0])])
    gp.hypers = {k: np.array(v) for k, v in gj.hypers.items()}
    gp.fit(method="none")
    return gj, gp


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    rundir = str(tmp_path_factory.mktemp("runs"))
    return {(noise, warp): _pair(rundir, noise, warp)
            for noise in (True, False) for warp in ("meanstd", "logarithm")}


def _obs(nobs, yvar):
    yobs = _pos_toy(XTRUE)[0] + np.array([0.0, 1e-3, -2e-3])[:nobs]
    return yobs, (np.full(nobs, 1e-4) if yvar else None)


def _ref_joint(gj, yobs, yvarobs, jitter=1e-6):
    """The reference's inverse objective written out from andvaranaut_tpu's
    own pieces (kernels.gram over [xc ; x repeated nobs times],
    engine.chol_nlml, RVPack.log_prior), as gpmcmc.py:1041-1060 builds
    it, jitted with its gradient, and a numpy helper giving the rounding
    bands at a point."""
    nobs = len(yobs)
    rvpack = JRVPack(tuple(gj._prior_rv(k) for k in range(gj.nx)))
    l, kv, _, alpha = jengine.hypers_to_args(gj.hypers, gj.gp.noise)
    xc = jnp.asarray(gj.xc)
    yin = np.concatenate([gj.yc[:, 0],
                          np.asarray(gj.yconrevs[0].con(yobs))])
    nvar = np.zeros(gj.nsamp + nobs)
    if gj.noise:
        nvar[:gj.nsamp] = float(np.asarray(gj.hypers["gv"]))
    if yvarobs is not None:
        nvar[gj.nsamp:] = np.asarray(
            jquad.gh_var_inv(gj.yconrevs[0].con, yobs, yvarobs))
    nvar = nvar + jitter
    ldj = float(np.sum(np.log(np.asarray(
        gj.yconrevs[0].der(np.r_[gj.y[:, 0], yobs])))))

    def joint_gram(z):
        vals = rvpack.unpack(z)
        xrow = jnp.stack([vals[f"x{k}"][0] for k in range(gj.nx)])
        xcrow = jnp.stack([gj.xconrevs[k].con(xrow[k])
                           for k in range(gj.nx)])
        xin = jnp.concatenate([xc, jnp.tile(xcrow, (nobs, 1))], axis=0)
        return (jkernels.gram(gj.gp.kerns, gj.gp.ops, xin, None, l, kv,
                              alpha) + jnp.diag(jnp.asarray(nvar)))

    def nlp(z):
        logl = jengine.chol_nlml(joint_gram(z), jnp.asarray(yin)) + ldj
        return -(logl + rvpack.log_prior(z))

    yo = yin[gj.nsamp:]

    def bands(z):
        """(value band of the training block, of the observations,
        gradient grade rho) at z: see the module docstring."""
        K = np.asarray(joint_gram(jnp.asarray(z)), dtype=np.float64)
        n = gj.nsamp
        kinv = np.linalg.inv(K[:n, :n])
        a = kinv @ yin[:n]
        kvec = K[:n, n]
        kss = K[n, n] - nvar[n]
        s2 = kss - kvec @ kinv @ kvec
        C = s2 + np.diag(nvar[n:])
        Cinv = np.linalg.inv(C)
        r = yo - kvec @ a
        one = np.ones(nobs)
        du = 0.5 * (one @ Cinv @ one - (one @ Cinv @ r) ** 2)
        gamma = n * EPS
        return (EPS * kss * (np.trace(kinv) + a @ a),
                gamma * kss * abs(du),
                gamma * kss / (s2 + nvar[n:].min()))

    return jax.jit(jax.value_and_grad(nlp)), bands


def _port_vg(nlp, z):
    zt = torch.tensor(z, requires_grad=True)
    u = nlp(zt)
    (g,) = torch.autograd.grad(u, zt)
    return float(u.detach()), g.numpy()


def _rvpack(g):
    return RVPack(tuple(g._prior_rv(k) for k in range(g.nx)))


@pytest.mark.parametrize("yvar", [False, True], ids=["novar", "yvarobs"])
@pytest.mark.parametrize("nobs", [1, 3])
@pytest.mark.parametrize("warp", ["meanstd", "logarithm"])
@pytest.mark.parametrize("noise", [True, False], ids=["noise", "nonoise"])
def test_nlp_matches_reference(pairs, noise, warp, nobs, yvar):
    """The port's objective on the conditioned state equals the
    reference's joint-Cholesky objective, value and gradient, at five
    seeded z; its batched form (the C points as C columns of one
    cross-Gram and one solve) equals the serial one."""
    gj, gp = pairs[(noise, warp)]
    yobs, yvarobs = _obs(nobs, yvar)
    ref_vg, bands = _ref_joint(gj, yobs, yvarobs)
    nlp = gp._inverse_nlp(_rvpack(gp), yobs, yvarobs, 1e-6)
    zs = np.random.default_rng(0).normal(size=(5, 2))
    us = []
    for z in zs:
        uj, gjr = ref_vg(jnp.asarray(z))
        uj, gjr = float(uj), np.asarray(gjr)
        up, gpr = _port_vg(nlp, z)
        us.append(up)
        b_train, b_obs, rho = bands(z)
        assert abs(up - uj) <= max(1e-10 * abs(uj), b_train + b_obs), (
            z, up, uj, b_train, b_obs)
        assert (np.abs(gpr - gjr).max()
                <= max(1e-8, rho) * np.abs(gjr).max()), (z, gpr, gjr, rho)
    # the training block's term is shared: only the observations' differ
    V, G = nlp.vec_value_and_grad(zs)
    for i, z in enumerate(zs):
        _, b_obs, rho = bands(z)
        assert abs(V[i] - us[i]) <= max(1e-12 * abs(us[i]), b_obs)
        _, gpr = _port_vg(nlp, z)
        assert (np.abs(G[i] - gpr).max()
                <= max(1e-12, rho) * np.abs(gpr).max())


def test_nlp_rounding_grade_against_exact(pairs):
    """At the toy's fit without observation variances, the port and the
    reference are both within the rounding band of a 50-digit evaluation
    of the same joint density (mpmath, from the same f64 converted
    inputs), which the plain 1e-10 cannot resolve."""
    mp = pytest.importorskip("mpmath")
    mp.mp.dps = 50
    gj, gp = pairs[(True, "meanstd")]
    yobs, _ = _obs(1, False)
    ref_vg, bands = _ref_joint(gj, yobs, None)
    nlp = gp._inverse_nlp(_rvpack(gp), yobs, None, 1e-6)
    rvpack = JRVPack(tuple(gj._prior_rv(k) for k in range(gj.nx)))
    lh = np.asarray(gj.hypers["l"], dtype=float)
    kv = float(np.asarray(gj.hypers["kv"])[0])
    gv = float(np.asarray(gj.hypers["gv"]))
    yin = np.r_[gj.yc[:, 0], np.asarray(gj.yconrevs[0].con(yobs))]
    ldj = float(np.sum(np.log(np.asarray(
        gj.yconrevs[0].der(np.r_[gj.y[:, 0], yobs])))))
    for z in np.random.default_rng(0).normal(size=(3, 2)):
        vals = rvpack.unpack(jnp.asarray(z))
        xc = [float(gj.xconrevs[k].con(vals[f"x{k}"][0])) for k in range(2)]
        X = np.vstack([gj.xc, xc])
        n = len(X)
        K = mp.matrix(n, n)
        for i in range(n):
            for j in range(n):
                r2 = sum((mp.mpf(X[i, d]) / lh[d] - mp.mpf(X[j, d]) / lh[d])
                         ** 2 for d in range(2))
                K[i, j] = kv * mp.exp(-r2 / 2)
            K[i, i] += (gv if i < gj.nsamp else 0.0) + mp.mpf(1e-6)
        L = mp.cholesky(K)
        beta = []
        for i in range(n):
            s = mp.mpf(yin[i]) - sum(L[i, k] * beta[k] for k in range(i))
            beta.append(s / L[i, i])
        logl = (-sum(b * b for b in beta) / 2
                - sum(mp.log(L[i, i]) for i in range(n))
                - n * mp.log(2 * mp.pi) / 2)
        exact = float(-(logl + ldj + float(rvpack.log_prior(jnp.asarray(z)))))
        up, _ = _port_vg(nlp, z)
        uj = float(ref_vg(jnp.asarray(z))[0])
        band = sum(bands(z)[:2])
        assert abs(up - exact) <= band, (up, exact, band)
        assert abs(uj - exact) <= band, (uj, exact, band)


def test_nlp_never_refactors(pairs, monkeypatch):
    """Evaluations of the objective, serial and batched, condition
    nothing: the training block is factored once, when the objective is
    built."""
    _, gp = pairs[(True, "meanstd")]
    yobs, _ = _obs(1, False)
    gp.gp._cache.clear()
    calls = {"exact": 0, "mixed": 0}
    real_exact, real_mixed = (engine.chol_state_masked,
                              engine.chol_state_masked_mixed)

    def exact(*a, **k):
        calls["exact"] += 1
        return real_exact(*a, **k)

    def mixed(*a, **k):
        calls["mixed"] += 1
        return real_mixed(*a, **k)

    monkeypatch.setattr(engine, "chol_state_masked", exact)
    monkeypatch.setattr(engine, "chol_state_masked_mixed", mixed)
    nlp = gp._inverse_nlp(_rvpack(gp), yobs, None, 1e-6)
    assert calls == {"exact": 1, "mixed": 0}
    zs = np.random.default_rng(1).normal(size=(4, 2))
    for z in zs:
        _port_vg(nlp, z)
    nlp.vec_value_and_grad(zs)
    assert calls == {"exact": 1, "mixed": 0}


def _bench_facade(rundir, n, seed=0):
    """bench.py-style data (uniform X, sin(3 x0) + x1^2 + noise) at n rows
    with the bench hypers bound by fit(method='none')."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 2))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 + 0.01 * rng.normal(size=n)
    pp = [dists.Uniform(0.0, 1.0), dists.Uniform(0.0, 1.0)]
    g = gpmcmc.GPMCMC(nx=2, ny=1, priors=pp,
                      target=lambda x: np.array([np.sin(3 * x[0])
                                                 + x[1] ** 2]),
                      xconrevs=[tf.uniform(p) for p in pp], verbose=False,
                      rundir=rundir, device="cpu")
    g.set_data(X, y[:, None])
    g.change_yconrevs([tf.meanstd(g.y[:, 0])])
    g.hypers = {"l": np.array([0.5, 0.7]), "kv": np.array([1.0]),
                "gv": np.array(1e-4)}
    g.fit(method="none")
    return g


def _s2_band(g, rvpack, z, yobs, yvarobs, jitter=1e-6):
    """(s2 + gv) |du/ds2| at z on the exact route: the change of the
    value per unit relative error of the predictive variance s2 + gv,
    which the mixed route holds to 1e-5 (tests/test_torch_engine.py,
    chip_smoke.py's VAR_RTOL)."""
    from andvaranaut_torch.gp import kernels, quad

    st = g._inverse_state()
    L, v, xin_p, valid, _ = st.chol(jitter)
    l, kv, gv, alpha = st.hyper_args()
    zt = torch.as_tensor(z)
    X = torch.stack([g.xconrevs[k].con(rv.forward(zt[off:off + 1]))
                     for k, (rv, off) in enumerate(zip(rvpack.rvs,
                                                       rvpack.offsets))], 1)
    k = kernels.gram(st.kerns, st.ops, xin_p, X, l, kv, alpha)
    A = torch.linalg.solve_triangular(L, k * valid.double()[:, None],
                                      upper=False)
    s2 = float(kv.sum() - (A * A).sum())
    r = np.asarray(g.yconrevs[0].con(yobs)) - float(A[:, 0] @ v)
    nv = np.asarray(quad.gh_var_inv(g.yconrevs[0].con, yobs, yvarobs))
    Cinv = np.linalg.inv(s2 + np.diag(nv + jitter))
    one = np.ones(len(yobs))
    du = 0.5 * (one @ Cinv @ one - (one @ Cinv @ r) ** 2)
    return (s2 + float(gv)) * abs(du)


def test_nlp_mixed_route_matches_f64(tmp_path, monkeypatch):
    """The mixed route (FORCE_MIXED: the state factored by the blocked
    mixed factorisation at block 256, each evaluation's solve through the
    blocked substitution) against the f64 route at n = 512, at the port's
    mixed grades: the value at 1e-6 relative (the mixed NLML's) plus
    1e-5 of the predictive variance s2 + gv (the mixed variance's: s2
    cancels kss through the blocked solve, ~1e-10 kss here) carried
    through du/ds2, the gradient at 1e-4 normwise; batched equal to
    serial at the same grades; no factorisation in any evaluation."""
    monkeypatch.setattr(gpmcmc.GPState, "MIXED_BLOCK", 256)
    g = _bench_facade(str(tmp_path / "runs"), 512)
    yobs = np.full(2, np.sin(3 * 0.4) + 0.6 ** 2)
    yvar = np.full(2, 1e-4)
    rvpack = _rvpack(g)
    zs = np.random.default_rng(2).normal(size=(3, 2))
    nlp64 = g._inverse_nlp(rvpack, yobs, yvar, 1e-6)
    ref = [_port_vg(nlp64, z) for z in zs]
    tols = [1e-6 * abs(u0) + 1e-5 * _s2_band(g, rvpack, z, yobs, yvar)
            for z, (u0, _) in zip(zs, ref)]
    monkeypatch.setattr(gpmcmc, "FORCE_MIXED", True)
    g.gp._cache.clear()
    nlpm = g._inverse_nlp(rvpack, yobs, yvar, 1e-6)
    assert g.gp.chol(1e-6)[4] is not None
    calls = [0]
    real = precision.blocked_cholesky

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(precision, "blocked_cholesky", counted)
    for z, (u0, g0), tol in zip(zs, ref, tols):
        u1, g1 = _port_vg(nlpm, z)
        assert abs(u1 - u0) <= tol, (u1, u0, tol)
        assert np.abs(g1 - g0).max() <= 1e-4 * np.abs(g0).max(), (g1, g0)
    V, G = nlpm.vec_value_and_grad(zs)
    for i, ((u0, g0), tol) in enumerate(zip(ref, tols)):
        assert abs(V[i] - u0) <= tol
        assert np.abs(G[i] - g0).max() <= 1e-4 * np.abs(g0).max()
    assert calls[0] == 0


def test_inverse_map_matches_reference(pairs, tmp_path, monkeypatch):
    """The whole MAP solve from the same np.random.seed draw: the port's
    L-BFGS (PyTorch's strong-Wolfe line search) and the reference's
    (optax) take other iterates to the same optimum, within 1e-5."""
    monkeypatch.chdir(tmp_path)
    gj, gp = pairs[(True, "meanstd")]
    yobs = _pos_toy(XTRUE)
    np.random.seed(6)
    _, xj = gj.inverse_opt(yobs, method="map")
    np.random.seed(6)
    data, xp = gp.inverse_opt(yobs, method="map")
    assert data is None
    np.testing.assert_allclose(xp, xj, atol=1e-5)
    np.testing.assert_allclose(_pos_toy(xp), yobs, atol=0.02)


def _make(tmp_path, n=40, seed=11):
    """tests/test_bo_inverse.py's _make through the port (device='cpu')."""
    priors = [dists.Uniform(0.0, 2.0), dists.Uniform(1.0, 0.5)]
    g = gpmcmc.GPMCMC(
        nx=2, ny=1, priors=priors, target=_toy,
        xconrevs=[tf.uniform(priors[0]), tf.uniform(priors[1])],
        verbose=False, rundir=str(tmp_path / "runs"), device="cpu")
    g.sample(n, seed=seed)
    g.change_yconrevs([tf.meanstd(g.y[:, 0])])
    g.fit(method="map")
    return g


def test_inverse_map(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    np.random.seed(6)
    g = _make(tmp_path, n=60)
    yobs = _toy(XTRUE)
    data, xopt = g.inverse_opt(yobs, method="map")
    np.testing.assert_allclose(_toy(xopt), yobs, atol=0.02)


def _grid_posterior_mean(g, nlp, n0=801, n1=401):
    """The posterior mean of x by quadrature over an (n0, n1) grid of the
    prior box [0, 2] x [1, 1.5] (open ends), through the batched
    objective: p(x) = exp(-u(z(x))) |dz/dx| for the logit maps z(x)."""
    x0 = np.linspace(0.0, 2.0, n0 + 2)[1:-1]
    x1 = np.linspace(1.0, 1.5, n1 + 2)[1:-1]
    X0, X1 = (a.ravel() for a in np.meshgrid(x0, x1, indexing="ij"))
    p0, p1 = X0 / 2.0, (X1 - 1.0) / 0.5
    Z = np.column_stack([np.log(p0) - np.log1p(-p0),
                         np.log(p1) - np.log1p(-p1)])
    U = np.concatenate([nlp.vec_value_and_grad(Z[i:i + 50000])[0]
                        for i in range(0, len(Z), 50000)])
    logp = -U - np.log(p0 * (1 - p0)) - np.log(p1 * (1 - p1))
    w = np.exp(logp - logp.max())
    w /= w.sum()
    return np.array([w @ X0, w @ X1])


def test_inverse_mcmc(tmp_path, monkeypatch):
    """Mirror of tests/test_bo_inverse.py::test_inverse_mcmc (its draws,
    tune, chains and seed; NUTS through the batched objective), held to
    the exact posterior mean by quadrature.  The reference test holds
    the target at the MCMC mean to the observation (atol 0.12), but the
    posterior is a curved band along the level set, and the target at
    its exact mean is -0.148 from the observation: the reference passes
    by its Monte Carlo error.  So the target at the MCMC mean is held
    within the reference's 0.12 of its value at the exact mean."""
    monkeypatch.chdir(tmp_path)
    np.random.seed(7)
    g = _make(tmp_path, n=40)
    yobs = _toy(XTRUE)
    yvarobs = np.array([1e-4])
    data, xopt = g.inverse_opt(
        yobs, yvarobs=yvarobs, method="mcmc_mean", draws=300, tune=300,
        chains=2, random_seed=0)
    assert data is not None
    assert set(data.posterior) == {"x0", "x1"}
    assert data.posterior["x0"].shape == (2, 300)
    mean = _grid_posterior_mean(
        g, g._inverse_nlp(_rvpack(g), yobs, yvarobs, 1e-6))
    np.testing.assert_allclose(_toy(xopt), _toy(mean), atol=0.12)


def test_inverse_evaluate_opt(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    np.random.seed(8)
    g = _make(tmp_path, n=40)
    n0 = g.nsamp
    yobs = _toy(XTRUE)
    data, xopt, ysamp = g.inverse_opt(yobs, method="map", evaluate_opt=True)
    assert g.nsamp == n0 + 1
    np.testing.assert_allclose(g.x[-1], xopt, rtol=1e-12)
    np.testing.assert_allclose(ysamp, _toy(xopt), rtol=1e-12)
    assert g.xc.shape == (n0 + 1, 2) and g.yc.shape == (n0 + 1, 1)
    # the next solve conditions the grown data set at the fitted hypers,
    # as the reference's joint GP over the current xc, yc does
    st = g._inverse_state()
    assert st is not g.gp and st.xin.shape == (n0 + 1, 2)
    np.random.seed(8)
    _, xopt2 = g.inverse_opt(yobs, method="map")
    np.testing.assert_allclose(_toy(xopt2), yobs, atol=0.02)


def test_inverse_requires_fit_and_known_method(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    priors = [dists.Uniform(0.0, 2.0), dists.Uniform(1.0, 0.5)]
    g = gpmcmc.GPMCMC(nx=2, ny=1, priors=priors, target=_toy,
                      verbose=False, rundir=str(tmp_path / "runs"),
                      device="cpu")
    g.sample(5, seed=0)
    with pytest.raises(Exception, match="fitted"):
        g.inverse_opt(_toy(XTRUE))
    g.fit(method="map")
    with pytest.raises(Exception, match="method must be one of"):
        g.inverse_opt(_toy(XTRUE), method="bogus")
    assert math.isfinite(float(g.inverse_opt(_toy(XTRUE))[1][0]))
