"""Port parity, learnable warpings: the iwgp/cwgp hyperprior menu, the
exact f64 warped objective (`engine.build_objective`), the mixed-precision
warped value+grad (`bigfit.make_warped_vg`) and MAP fit
(`bigfit.big_warped_map_fit`), the warped MCMC objective and the facade's
iwgp/cwgp fits with their write-back, against the JAX package on the same
numpy inputs.  It mirrors tests/test_bigfit_warped.py's 15 cases and the
warped facade tests of tests/test_gpmcmc.py (test_cwgp_fit,
test_iwgp_fit, test_iwgp_requires_wgp_xconrev) and
tests/test_gpmcmc_variants.py (test_none_with_cwgp).

The mixed route runs the kernels' plain versions (CPU tensors).  The JAX
mixed route runs with the pair carry and the fused gradient route forced
(PAIR_CARRY=2, ANDVARANAUT_FUSED_GRAD=2), so its Pallas kernels run in
interpret mode."""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from andvaranaut_tpu import GPMCMC as JGPMCMC
from andvaranaut_tpu import dists as jdists
from andvaranaut_tpu import transform as jtf
from andvaranaut_tpu.gp import bigfit as jbigfit
from andvaranaut_tpu.gp import engine as jengine
from andvaranaut_tpu.gp import kernels as jkernels
from andvaranaut_tpu.gp import precision as jprecision
from andvaranaut_tpu.lhc import _none_conrev as _jnone
from andvaranaut_torch import dists, gpmcmc
from andvaranaut_torch import transform as tf
from andvaranaut_torch.gp import bigfit, engine, kernels
from andvaranaut_torch.inference import nuts
from andvaranaut_torch.lhc import _none_conrev


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the suite runs in parallel
    workers, and a multi-threaded intra-op pool in each oversubscribes
    the cores.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _fused_route():
    """The reference's kernel route on the CPU: pair carries and the
    pair-native K^-1."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jprecision, "PAIR_CARRY", 2)
        mp.setenv("ANDVARANAUT_FUSED_GRAD", "2")
        yield


_ARITY = {"uniform": 0, "meanstd": 0, "kumaraswamy": 2, "sinharcsinh": 2,
          "affine": 2, "arcsinh": 4}
_DEF = {"kumaraswamy": [1.0, 1.0], "sinharcsinh": [0.0, 1.0],
        "affine": [0.1, 1.1], "arcsinh": [0.1, 1.0, 0.0, 1.0]}


def _cfgs(seed=3, n=48, iwgp=False, cwgp=False, kernel="RBF",
          xstages=("uniform", "kumaraswamy"),
          ystages=("meanstd", "sinharcsinh"), truncate=False):
    """tests/test_bigfit_warped.py's configuration, as (reference FitConfig,
    port FitConfig) on the same data."""
    out = []
    for tm, dm, em, km, none in ((jtf, jdists, jengine, jkernels, _jnone),
                                 (tf, dists, engine, kernels, _none_conrev)):
        rng = np.random.default_rng(seed)
        priors = [dm.Uniform(0.0, 2.0), dm.Uniform(1.0, 0.5)]
        X = np.stack([rng.uniform(0.0, 2.0, n), rng.uniform(1.0, 1.5, n)],
                     axis=1)
        y = (X[:, 0] ** 2 - X[:, 0] - X[:, 1] ** 2 * X[:, 0] + X[:, 1]
             + 0.01 * rng.normal(size=n)).reshape(-1, 1)
        if iwgp:
            xp = np.concatenate(
                [_DEF.get(s, []) for s in xstages if _ARITY[s]] or [[]])
            xconrevs = [tm.wgp(list(xstages), np.asarray(xp, dtype=float),
                               y=None, xdist=priors[0]),
                        tm.uniform(priors[1])]
        else:
            xconrevs = [tm.uniform(priors[0]), tm.uniform(priors[1])]
        if cwgp:
            yp = np.concatenate(
                [_DEF.get(s, []) for s in ystages if _ARITY[s]] or [[]])
            yconrevs = [tm.wgp(list(ystages), np.asarray(yp, dtype=float),
                               y=y[:, 0])]
        else:
            yconrevs = [none()]
        kerns, ops = km.parse_kernel(kernel)
        out.append(em.FitConfig(
            kerns=kerns, ops=ops, noise=True, truncate=truncate,
            jitter=1e-6, iwgp=iwgp, cwgp=cwgp, priors=priors,
            xconrevs=xconrevs, yconrevs=yconrevs, x=X, y=y))
    return out


def _z(rvpack, seed=3):
    rng = np.random.default_rng(seed)
    return rvpack.z0().numpy() + 0.05 * rng.standard_normal(rvpack.total)


def _ref_f64(jcfg, z):
    """(-logpost, its gradient) of the reference's f64 objective."""
    _, nlp = jengine.build_objective(jcfg)
    return float(nlp(jnp.asarray(z))), np.asarray(
        jax.grad(nlp)(jnp.asarray(z)))


def _port_f64(tcfg, z):
    rvpack, nlp = engine.build_objective(tcfg, device="cpu")
    zz = torch.tensor(z, requires_grad=True)
    u = nlp(zz)
    (g,) = torch.autograd.grad(u, zz)
    return float(u.detach()), g.numpy(), rvpack


def _port_mixed(tcfg, z, block=256):
    """(-logpost, gradient) through make_warped_vg plus the prior."""
    rvpack, vg = bigfit.make_warped_vg(tcfg, block=block, device="cpu")
    v, g = vg(z)
    zz = torch.tensor(z, requires_grad=True)
    lp = rvpack.log_prior(zz)
    (gp,) = torch.autograd.grad(lp, zz)
    return -(float(v) + float(lp.detach())), -(g.numpy() + gp.numpy())


def _check_parity(jcfg, tcfg):
    """The port's f64 objective against the reference's at rtol 1e-10;
    the port's mixed value+grad against the reference's f64 at the
    reference test's tolerances (value 1e-6 relative; gradient rtol 2e-4,
    atol 2e-5)."""
    rv_j = jengine.build_rvs(jcfg)
    rv_t = engine.build_rvs(tcfg)
    assert rv_t.total == rv_j.total
    z = _z(rv_t)
    u_ref, g_ref = _ref_f64(jcfg, z)
    u64, g64, _ = _port_f64(tcfg, z)
    assert abs(u64 - u_ref) <= 1e-10 * abs(u_ref)
    np.testing.assert_allclose(g64, g_ref, rtol=1e-10, atol=1e-10)
    um, gm = _port_mixed(tcfg, z)
    assert abs(um - u_ref) < 1e-6 * max(1.0, abs(u_ref))
    np.testing.assert_allclose(gm, g_ref, rtol=2e-4, atol=2e-5)


# ---- the 15 cases of tests/test_bigfit_warped.py --------------------------------

@pytest.mark.parametrize("iwgp,cwgp", [(False, True), (True, False),
                                       (True, True)])
def test_warped_vg_matches_autodiff(iwgp, cwgp):
    _check_parity(*_cfgs(iwgp=iwgp, cwgp=cwgp))


@pytest.mark.parametrize("kernel,iwgp,cwgp", [
    ("RatQuad", False, True),
    ("RatQuad", True, False),
    ("RatQuad", True, True),
    ("Matern52+RBF", False, True),
    ("Matern52+RBF", True, True),
    ("Matern32*RBF", True, False),
    ("Exponential", False, True),
])
def test_warped_vg_kernel_algebra(kernel, iwgp, cwgp):
    _check_parity(*_cfgs(iwgp=iwgp, cwgp=cwgp, kernel=kernel))


@pytest.mark.parametrize("iwgp,cwgp,xstages,ystages", [
    (False, True, None, ("meanstd", "sinharcsinh", "affine")),
    (False, True, None, ("meanstd", "arcsinh", "sinharcsinh")),
    (True, False, ("uniform", "kumaraswamy", "sinharcsinh"), None),
    (True, True, ("uniform", "sinharcsinh"),
     ("meanstd", "sinharcsinh", "affine")),
])
def test_warped_vg_multistage(iwgp, cwgp, xstages, ystages):
    kw = {}
    if xstages:
        kw["xstages"] = xstages
    if ystages:
        kw["ystages"] = ystages
    _check_parity(*_cfgs(iwgp=iwgp, cwgp=cwgp, **kw))


def test_warped_mcmc_mixed_objective():
    """sample_model(mixed=True) on a cwgp config routes through the
    warped autograd-Function objective and samples a sane posterior; the
    objective's value and autograd gradient are make_warped_vg's plus the
    prior's, and its batched call equals the serial one row by row."""
    _, cfg = _cfgs(n=32, cwgp=True)
    data = nuts.sample_model(cfg, draws=20, tune=20, chains=2,
                             random_seed=0, mixed=True, sampler="hmc",
                             max_treedepth=3, adapt_tlen=False,
                             verbose=False, device="cpu")
    post = data.posterior_mean()
    assert "cwgp" in post and "cwgp_pos" in post
    for v in post.values():
        assert np.isfinite(np.asarray(v)).all()
    assert np.isfinite(data.sample_stats["lp"]).all()
    rvpack, nlp = nuts._warped_mixed_objective(cfg, 32, "cpu")
    Z = np.stack([_z(rvpack, s) for s in (1, 2)])
    us, gs = nlp.vec_value_and_grad(Z)
    for c in range(2):
        zz = torch.tensor(Z[c], requires_grad=True)
        u = nlp(zz)
        (g,) = torch.autograd.grad(u, zz)
        assert float(u.detach()) == us[c]
        np.testing.assert_array_equal(g.numpy(), gs[c])
        um, gm = _port_mixed(cfg, Z[c], block=32)
        assert abs(float(u.detach()) - um) <= 1e-13 * abs(um)
        np.testing.assert_allclose(g.numpy(), gm, rtol=1e-13, atol=1e-13)


# ---- the mixed route against the reference's own ---------------------------------

@pytest.mark.parametrize("iwgp,cwgp,n,block", [
    (False, True, 48, 256), (True, False, 48, 256), (True, True, 48, 256),
    (True, True, 64, 32)])
def test_warped_vg_matches_reference_mixed(iwgp, cwgp, n, block):
    """make_warped_vg against the reference's make_warped_vg on its
    kernel route: one block (K3, K7) and, at block 32, the f64-carry
    route (K2, K8); value to 1e-8, gradient rtol 1e-5, atol 1e-6."""
    jcfg, tcfg = _cfgs(n=n, iwgp=iwgp, cwgp=cwgp)
    z = _z(engine.build_rvs(tcfg))
    with _fused_route():
        _, jvg = jbigfit.make_warped_vg(jcfg, block=block)
        v0, g0 = jvg(jnp.asarray(z))
    _, vg = bigfit.make_warped_vg(tcfg, block=block, device="cpu")
    v1, g1 = vg(z)
    assert vg.calls == 1
    np.testing.assert_allclose(float(v1), float(v0), rtol=1e-8)
    np.testing.assert_allclose(g1.numpy(), np.asarray(g0), rtol=1e-5,
                               atol=1e-6)


def test_warped_vg_pair_route():
    """Two blocks of 256 on the pair carry (the 16k route's K1-K6 plain
    versions, K^-1 through K4, K5 and K6) against the port's f64 warped
    objective, which the cases above hold to the reference's."""
    _, tcfg = _cfgs(n=512, iwgp=True, cwgp=True)
    z = _z(engine.build_rvs(tcfg))
    u64, g64, _ = _port_f64(tcfg, z)
    um, gm = _port_mixed(tcfg, z, block=256)
    assert abs(um - u64) < 1e-6 * abs(u64)
    np.testing.assert_allclose(gm, g64, rtol=2e-4, atol=2e-5)


# ---- the hyperprior menu ----------------------------------------------------------

@pytest.mark.parametrize("truncate", [False, True])
def test_build_rvs_warped_menu(truncate):
    """iwgp, cwgp_pos and cwgp in the reference's order, sizes and
    priors; interleave_cwgp restores the wgp's parameter order."""
    jcfg, tcfg = _cfgs(iwgp=True, cwgp=True, truncate=truncate,
                       xstages=("uniform", "kumaraswamy", "sinharcsinh"),
                       ystages=("meanstd", "sinharcsinh", "affine"))
    got, want = engine.build_rvs(tcfg), jengine.build_rvs(jcfg)
    assert [(r.name, r.size, r.prior) for r in got.rvs] == [
        (r.name, r.size, r.prior) for r in want.rvs]
    assert [r.name for r in got.rvs][-3:] == ["iwgp", "cwgp_pos", "cwgp"]
    vals = {"cwgp_pos": np.array([2.0, 3.0]), "cwgp": np.array([5.0, 7.0])}
    pos = tcfg.yconrevs[0].pos
    np.testing.assert_array_equal(
        engine.interleave_cwgp({k: torch.as_tensor(v)
                                for k, v in vals.items()}, pos).numpy(),
        np.asarray(jengine.interleave_cwgp(
            {k: jnp.asarray(v) for k, v in vals.items()}, pos)))


def test_build_rvs_refusals():
    """The reference's errors: iwgp without a wgp input conversion, cwgp
    without a wgp output conversion or with no tuneable parameter."""
    _, cfg = _cfgs()
    cfg.iwgp = True
    with pytest.raises(Exception, match="none of xconrevs are wgp"):
        engine.build_rvs(cfg)
    cfg.iwgp, cfg.cwgp = False, True
    with pytest.raises(Exception, match="yconrevs class is not wgp"):
        engine.build_rvs(cfg)
    cfg.yconrevs = [tf.wgp(["meanstd"], np.zeros(0), y=cfg.y[:, 0])]
    with pytest.raises(Exception, match="no tuneable"):
        engine.build_rvs(cfg)


def test_warped_objective_batched_rows():
    """The f64 warped objective's batched call equals its serial value and
    autograd gradient row by row."""
    _, tcfg = _cfgs(n=24, iwgp=True, cwgp=True)
    rvpack, nlp = engine.build_objective(tcfg, device="cpu")
    Z = np.stack([_z(rvpack, s) for s in (4, 5, 6)])
    us, gs = nlp.vec_value_and_grad(Z)
    for c in range(3):
        u, g, _ = _port_f64(tcfg, Z[c])
        assert u == us[c]
        np.testing.assert_array_equal(g, gs[c])


# ---- MAP fits --------------------------------------------------------------------

def test_big_warped_map_fit_matches_reference():
    """big_warped_map_fit at n=48 (iwgp and cwgp) against the reference's
    on its kernel route: the log posterior to 1e-6, the kernel
    hyperparameters to 1e-2 and the warping parameters to 1e-2."""
    jcfg, tcfg = _cfgs(iwgp=True, cwgp=True)
    with _fused_route():
        h0, lp0 = jbigfit.big_warped_map_fit(jcfg, block=256)
    h1, lp1 = bigfit.big_warped_map_fit(tcfg, block=256, device="cpu")
    assert set(h1) == set(h0)
    np.testing.assert_allclose(lp1, lp0, rtol=1e-6)
    for k in ("l", "kv", "iwgp", "cwgp", "cwgp_pos"):
        np.testing.assert_allclose(h1[k], h0[k], rtol=1e-2, atol=1e-4,
                                   err_msg=k)


def test_engine_map_fit_warped():
    """The exact f64 warped MAP fit (engine.map_fit through L-BFGS) ends
    where the mixed one does, its log posterior at the f64 objective's
    optimum to 1e-7."""
    _, tcfg = _cfgs(n=40, cwgp=True, iwgp=True)
    h64, lp64 = engine.map_fit(tcfg, device="cpu")
    hm, lpm = bigfit.big_warped_map_fit(tcfg, block=256, device="cpu",
                                        ftol=1e-12, maxiter=200)
    rvpack, nlp = engine.build_objective(tcfg, device="cpu")
    assert abs(-float(nlp(rvpack.pack_values(h64))) - lp64) <= 1e-9 * abs(
        lp64)
    assert abs(lpm - lp64) <= 1e-7 * abs(lp64)


# ---- the facade --------------------------------------------------------------------

def _toy(x):
    return np.array([x[0] ** 2 - x[0] - x[1] ** 2 * x[0] + x[1]])


def _facades(tmp_path, n, seed, iwgp):
    """The reference and the port facade on the same LHC sample, each
    with tests/test_gpmcmc.py's conversions for an iwgp or a cwgp fit."""
    out = []
    for G, dm, tm, kw in ((JGPMCMC, jdists, jtf, {}),
                          (gpmcmc.GPMCMC, dists, tf, {"device": "cpu"})):
        priors = [dm.Uniform(0.0, 2.0), dm.Uniform(1.0, 0.5)]
        if iwgp:
            xc = [tm.wgp(["uniform", "kumaraswamy"], np.array([1.0, 1.0]),
                         y=None, xdist=priors[0]), tm.uniform(priors[1])]
        else:
            xc = [tm.uniform(priors[0]), tm.uniform(priors[1])]
        g = G(nx=2, ny=1, priors=priors, target=_toy, xconrevs=xc,
              verbose=False, rundir=str(tmp_path / "runs"), **kw)
        out.append(g)
    gj, gp = out
    gj.sample(n, seed=seed)
    gp.set_data(gj.x, gj.y)
    for g, tm in ((gj, jtf), (gp, tf)):
        if iwgp:
            g.change_yconrevs([tm.meanstd(g.y[:, 0])])
        else:
            g.change_yconrevs([tm.wgp(["meanstd", "sinharcsinh"],
                                      np.array([0.0, 1.0]), y=g.y[:, 0])])
    return gj, gp


def _hold_hypers(gp, gj, rtol=2e-3):
    assert set(gp.hypers) == set(gj.hypers)
    for k in gj.hypers:
        np.testing.assert_allclose(np.asarray(gp.hypers[k]),
                                   np.asarray(gj.hypers[k]), rtol=rtol,
                                   atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def cwgp_pair(tmp_path_factory):
    """The reference and the port fitted by MAP with cwgp=True (40 LHC
    points, tests/test_gpmcmc.py::test_cwgp_fit's facade)."""
    gj, gp = _facades(tmp_path_factory.mktemp("cwgp"), 40, 7, iwgp=False)
    gj.fit(method="map", cwgp=True)
    gp.fit(method="map", cwgp=True)
    return gj, gp


def test_cwgp_fit(cwgp_pair):
    """The fitted hypers match the reference's; the output warper is
    written back with them in its own parameter order; predictions
    within the reference test's bound."""
    gj, g = cwgp_pair
    assert "cwgp" in g.hypers and "cwgp_pos" in g.hypers
    _hold_hypers(g, gj)
    got = np.array([float(g.hypers["cwgp"][0]),
                    float(g.hypers["cwgp_pos"][0])])
    cur = np.asarray(g.yconrevs[0].params, dtype=float)
    np.testing.assert_allclose(cur, got, rtol=1e-9)
    yhat = g.predict(g.x)
    assert np.abs(yhat[:, 0] - g.y[:, 0]).max() < 5e-2
    np.testing.assert_allclose(yhat, gj.predict(g.x), rtol=1e-3, atol=1e-4)


def test_none_with_cwgp(cwgp_pair, tmp_path):
    """method='none' rebinds the converted data with the existing hypers,
    the written-back warper included (a copy of the fitted facade)."""
    import copy

    _, g = cwgp_pair
    g = copy.deepcopy(g)
    h0 = {k: np.array(v) for k, v in g.hypers.items()}
    p0 = g.predict(g.x[:5])
    g.fit(method="none", cwgp=True)
    for k in h0:
        np.testing.assert_array_equal(np.asarray(g.hypers[k]), h0[k])
    np.testing.assert_allclose(g.predict(g.x[:5]), p0, rtol=1e-9)


def test_iwgp_fit(tmp_path):
    """The iwgp fit matches the reference's; the input warper is written
    back with the fitted parameters, which are positive; predictions
    within the reference test's bound."""
    gj, g = _facades(tmp_path, 40, 9, iwgp=True)
    gj.fit(method="map", iwgp=True)
    g.fit(method="map", iwgp=True)
    assert "iwgp" in g.hypers and len(g.hypers["iwgp"]) == 2
    assert (np.asarray(g.hypers["iwgp"]) > 0).all()
    _hold_hypers(g, gj)
    np.testing.assert_array_equal(np.asarray(g.xconrevs[0].params),
                                  g.hypers["iwgp"])
    yhat = g.predict(g.x)
    assert np.abs(yhat[:, 0] - g.y[:, 0]).max() < 5e-2


def test_iwgp_requires_wgp_xconrev(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    priors = [dists.Uniform(0.0, 2.0), dists.Uniform(1.0, 0.5)]
    g = gpmcmc.GPMCMC(nx=2, ny=1, priors=priors, target=_toy, verbose=False,
                      rundir=str(tmp_path / "runs"), device="cpu")
    g.sample(10, seed=1)
    with pytest.raises(Exception, match="none of xconrevs are wgp"):
        g.fit(method="map", iwgp=True)
    with pytest.raises(Exception, match="yconrevs class is not wgp"):
        g.fit(method="map", cwgp=True)


@pytest.mark.parametrize("method,kw", [
    ("map", {"precision": "mixed"}),
    ("mcmc_mean", {"draws": 10, "tune": 10, "chains": 2, "sampler": "hmc",
                   "max_treedepth": 3, "random_seed": 1})])
def test_facade_warped_routes(tmp_path, method, kw):
    """The facade's other routes with iwgp and cwgp together: the mixed
    MAP fit (big_warped_map_fit) and an MCMC fit (sample_model); both
    write the warpers back and predict finite values."""
    _, g = _facades(tmp_path, 30, 3, iwgp=True)
    g.change_yconrevs([tf.wgp(["meanstd", "sinharcsinh"],
                              np.array([0.0, 1.0]), y=g.y[:, 0])])
    g.fit(method=method, iwgp=True, cwgp=True, **kw)
    np.testing.assert_array_equal(np.asarray(g.xconrevs[0].params),
                                  np.asarray(g.hypers["iwgp"]))
    np.testing.assert_array_equal(
        np.asarray(g.yconrevs[0].params, dtype=float),
        np.concatenate([np.ravel(g.hypers["cwgp"]),
                        np.ravel(g.hypers["cwgp_pos"])]))
    assert np.isfinite(g.predict(g.x)).all()


def test_mcmc_fit_writes_back_one_parameter_blocks(tmp_path):
    """Reference defect: an MCMC fit's one-parameter iwgp, cwgp or
    cwgp_pos block is a 0-d posterior mean, and the reference's
    write-back indexes it (IndexError, andvaranaut_tpu/gpmcmc.py:370-380).
    The port writes such blocks back."""
    _, g = _facades(tmp_path, 20, 5, iwgp=True)
    g.change_xconrevs([tf.wgp(["uniform", "boxcox"], np.array([0.0]),
                              xdist=g.priors[0]), g.xconrevs[1]])
    g.change_yconrevs([tf.wgp(["meanstd", "sinharcsinh"],
                              np.array([0.0, 1.0]), y=g.y[:, 0])])
    g.fit(method="mcmc_mean", iwgp=True, cwgp=True, draws=5, tune=5,
          chains=2, sampler="hmc", max_treedepth=2, random_seed=0)
    assert all(np.ndim(g.hypers[k]) == 0 for k in ("iwgp", "cwgp",
                                                   "cwgp_pos"))
    assert float(g.xconrevs[0].params[0]) == float(g.hypers["iwgp"])
    np.testing.assert_array_equal(
        np.asarray(g.yconrevs[0].params, dtype=float),
        [float(g.hypers["cwgp"]), float(g.hypers["cwgp_pos"])])
    assert np.isfinite(g.predict(g.x)).all()
