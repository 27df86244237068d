"""Port parity, the row-sharded paths (andvaranaut_torch/gp/sharded.py)
on a pool of 4 gloo ranks, against the JAX package on a 4-device mesh.

The port's side runs on `distributed.RankPool(4, 'cpu')`, spawned once
for the module, through the bodies of tests/test_torch_sharded_ranks.py; the
JAX side runs in this process on `sharded.data_mesh(jax.devices()[:4])`,
so both sides use the same D and the same padding.  Inputs come from the
numpy seeds of tests/test_sharded.py.  Every case also holds each rank's
replicated outputs equal bit for bit to rank 0's.  The mixed route runs
the kernels' plain versions (CPU tensors).  Tolerances are those of
tests/test_sharded.py unless a docstring says otherwise; with D = 4 the
reference's padded sizes 43 and 44 divide or not differently, so the
padded cases take n = 53 and 46 (not multiples of 4)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_sharded_ranks as ranks
from andvaranaut_tpu import dists as jdists
from andvaranaut_tpu import transform as jtf
from andvaranaut_tpu.gp import bigfit as jbigfit
from andvaranaut_tpu.gp import engine as jengine
from andvaranaut_tpu.gp import kernels as jkernels
from andvaranaut_tpu.gp import precision as jprecision
from andvaranaut_tpu.gp import sharded as jsharded
from andvaranaut_tpu.lhc import _none_conrev as _jnone
from andvaranaut_torch import distributed
from andvaranaut_torch.gp import bigfit, precision, sharded

D = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module (the ranks run one each): the
    suite runs in parallel workers.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    p = distributed.RankPool(D, "cpu", threads=1)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jmesh():
    return jsharded.data_mesh(jax.devices()[:D])


def _same(a, b):
    """a and b equal bit for bit (nested tuples, lists, dicts, arrays)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    a, b = np.asarray(a), np.asarray(b)
    return np.array_equal(a, b, equal_nan=a.dtype.kind in "fc")


def _run(pool, fn, *args):
    """fn on every rank; rank 0's result, every rank's equal to it."""
    out, every = pool.run(fn, *args)
    for r, res in enumerate(every):
        assert _same(res, out), f"rank {r}'s replicated outputs differ"
    return out


def _jnlp(jmesh, kernel, noise, n, shift, **kw):
    """The JAX make_sharded_nlml (jitted): (value, gradient) at z0 +
    shift, and the f64 rounding band of both: the relative distance of
    the JAX dense objective (tests/test_sharded.py's _dense_nlp) from
    it."""
    kerns, ops = jkernels.parse_kernel(kernel)
    X, y = (jnp.asarray(a) for a in ranks.toy(n))
    build, nlp = jsharded.make_sharded_nlml(jmesh, kerns, ops, noise, 1e-6,
                                            **kw)
    rv = build(2)
    z = rv.z0() + shift
    v, g = jax.jit(jax.value_and_grad(lambda zz: nlp(zz, X, y, rv)))(z)

    def dense(zz):
        vals = rv.unpack(zz)
        gv = vals["gv"][0] if noise else 0.0
        alpha = vals["alpha"][0] if "alpha" in vals else None
        K = jkernels.gram(kerns, ops, X, None, vals["l"], vals["kv"], alpha)
        K = K + jnp.eye(n) * (1e-6 + gv)
        return -(jengine.chol_nlml(K, y) + rv.log_prior(zz))

    dv, dg = jax.value_and_grad(dense)(z)
    v, g, dv, dg = float(v), np.asarray(g), float(dv), np.asarray(dg)
    return v, g, abs(v - dv) / abs(dv), float(np.max(np.abs(g - dg)
                                                     / np.abs(dg)))


@pytest.mark.parametrize("kernel,noise,n,shift", [
    ("RBF", True, 48, 0.1),
    ("Matern52+RBF", True, 48, 0.1),
    ("RatQuad", False, 48, 0.1),
    ("RBF", True, 53, -0.2),     # padded: 53 % 4 != 0
])
def test_sharded_nlml_matches_reference(pool, jmesh, kernel, noise, n,
                                        shift):
    """make_sharded_nlml's value (rel 1e-10) and its autograd gradient
    through the collectives (rtol 1e-8) against the JAX one's, each
    widened to twice the f64 rounding band where that is larger: the
    noise-free RatQuad Gram (condition ~8e7) puts the JAX sharded value
    itself ~3e-10 from the JAX dense one at D=4."""
    v, g = _run(pool, ranks.nlml, kernel, noise, n, shift)
    jv, jg, band, gband = _jnlp(jmesh, kernel, noise, n, shift)
    assert float(v) == pytest.approx(jv, rel=max(1e-10, 2 * band))
    np.testing.assert_allclose(g, jg, rtol=max(1e-8, 2 * gband), atol=1e-10)


@pytest.mark.parametrize("n", [48, 53])
def test_sharded_nlml_cyclic_matches_reference(pool, jmesh, n):
    """The block-cyclic layout at C=2 (D C = 8), divisible and padded:
    value rel 1e-10, gradient rtol 1e-8."""
    v, g = _run(pool, ranks.nlml, "RBF", True, n, 0.1, "cyclic", 2)
    jv, jg, _, _ = _jnlp(jmesh, "RBF", True, n, 0.1, layout="cyclic",
                         cyc_blocks=2)
    assert float(v) == pytest.approx(jv, rel=1e-10)
    np.testing.assert_allclose(g, jg, rtol=1e-8, atol=1e-10)


def test_sharded_nlml_on_shard_data(pool, jmesh):
    """make_sharded_nlml on shard_data's row blocks (the dry run's route)
    equals the JAX value at z0 (rel 1e-10), with a finite gradient."""
    v, g = _run(pool, ranks.nlml_sharded_inputs, 64)
    jv, _, _, _ = _jnlp(jmesh, "RBF", True, 64, 0.0)
    assert float(v) == pytest.approx(jv, rel=1e-10)
    assert np.isfinite(g).all()


@pytest.mark.parametrize("kernel,noise,n", [
    ("RBF", True, 96),
    ("Matern52+RBF", True, 64),
])
def test_closed_form_exact_matches_reference(pool, jmesh, kernel, noise, n):
    """make_sharded_mixed_objective(mixed=False) against the JAX one with
    mixed=False: value rel 1e-10, gradient rtol 1e-8; neg_log_post's
    autograd equals -(value + prior) and its gradient."""
    v, g, u, gu = _run(pool, ranks.closed_form, kernel, noise, n, 0.1,
                       False)
    kerns, ops = jkernels.parse_kernel(kernel)
    X, y = ranks.toy(n)
    rv, jnlp, jvg = jsharded.make_sharded_mixed_objective(
        jmesh, X, y, kerns=kerns, ops=ops, noise=noise, block=32,
        mixed=False)
    z = rv.z0() + 0.1
    jv, jg = jvg(z)
    assert float(v) == pytest.approx(float(jv), rel=1e-10)
    np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-8, atol=1e-10)
    lp, gp = jax.value_and_grad(rv.log_prior)(z)
    assert float(u) == pytest.approx(-(float(v) + float(lp)), rel=1e-12)
    np.testing.assert_allclose(gu, -(g + np.asarray(gp)), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("kernel,noise,n,shift,grad_rtol", [
    ("RBF", True, 96, 0.1, 5e-6),
    ("Matern52+RBF", True, 64, 0.1, 5e-6),
    ("RBF", True, 53, -0.15, 1e-6),   # padded
])
def test_closed_form_mixed_matches_reference(pool, kernel, noise, n,
                                             shift, grad_rtol):
    """make_sharded_mixed_objective(mixed=True) (the kernels' plain
    versions) against the JAX bigfit.nlml_value_and_grad at block 32:
    value rtol 1e-7, gradient `grad_rtol` and atol 1e-8
    (tests/test_sharded.py:146-176); neg_log_post's autograd against
    -(value + prior) and its gradient at rel 1e-12 (the custom-VJP
    contract: the reference test held it against the single-device
    value+grad, which the first two checks hold already)."""
    v, g, u, gu = _run(pool, ranks.closed_form, kernel, noise, n, shift,
                       True)
    kerns, ops = jkernels.parse_kernel(kernel)
    X, y = ranks.toy(n)
    rv = jbigfit._default_rvpack(2, kerns, noise)
    z = rv.z0() + shift
    jv, jg = jbigfit.nlml_value_and_grad(
        jnp.asarray(X), jnp.asarray(y), z, kerns=kerns, ops=ops,
        noise=noise, block=32)
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-7)
    np.testing.assert_allclose(g, np.asarray(jg), rtol=grad_rtol, atol=1e-8)
    lp, gp = jax.value_and_grad(rv.log_prior)(z)
    assert float(u) == pytest.approx(-(float(v) + float(lp)), rel=1e-12)
    np.testing.assert_allclose(gu, -(g + np.asarray(gp)), rtol=1e-12,
                               atol=1e-12)


def _jwarped_cfg(n, iwgp=False, cwgp=False, seed=3):
    """tests/test_sharded.py's _warped_cfg through the JAX package."""
    priors = [jdists.Uniform(0.0, 2.0), jdists.Uniform(1.0, 0.5)]
    X, y = ranks.warped_data(n, seed)
    if iwgp:
        xconrevs = [jtf.wgp(["uniform", "kumaraswamy"], np.array([1.0, 1.0]),
                            y=None, xdist=priors[0]), jtf.uniform(priors[1])]
    else:
        xconrevs = [jtf.uniform(priors[0]), jtf.uniform(priors[1])]
    yconrevs = ([jtf.wgp(["meanstd", "sinharcsinh"], np.array([0.0, 1.0]),
                         y=y[:, 0])] if cwgp else [_jnone()])
    return jengine.FitConfig(
        kerns=("RBF",), ops=(), noise=True, truncate=False, jitter=1e-6,
        iwgp=iwgp, cwgp=cwgp, priors=priors, xconrevs=xconrevs,
        yconrevs=yconrevs, x=X, y=y)


@pytest.mark.parametrize("iwgp,cwgp,n", [
    (False, True, 48),
    (True, False, 48),
    (True, True, 46),    # padded: 46 % 4 != 0
])
def test_sharded_warped_vg_matches_reference(pool, iwgp, cwgp, n):
    """make_sharded_warped_objective against autograd of the JAX
    engine.build_objective: the log posterior within 1e-6 relative, the
    gradient rtol 2e-4, atol 2e-5; neg_log_post's custom-VJP contract
    against -(value + prior) at rel 1e-12 (tests/test_sharded.py:304-346)."""
    v, g, lp, gp, u, gu = _run(pool, ranks.warped, n, iwgp, cwgp)
    cfg = _jwarped_cfg(n, iwgp=iwgp, cwgp=cwgp)
    rv, nlp = jengine.build_objective(cfg)
    z = jnp.asarray(ranks.warped_z(rv.total, z0=np.asarray(rv.z0())))
    ref, gref = jax.value_and_grad(nlp)(z)
    got = -(float(v) + float(lp))
    assert abs(got - float(ref)) < 1e-6 * max(1.0, abs(float(ref)))
    np.testing.assert_allclose(-(g + gp), np.asarray(gref), rtol=2e-4,
                               atol=2e-5)
    assert float(u) == pytest.approx(got, rel=1e-12)
    np.testing.assert_allclose(gu, -(g + gp), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("mixed,n,kernel", [
    (False, 96, "RBF"),
    (True, 96, "RBF"),
    (True, 53, "RBF"),          # padded
    (True, 64, "Matern52+RBF"),
])
def test_sharded_predict_matches_reference(pool, mixed, n, kernel):
    """make_sharded_predict against the JAX engine.predict_diag: means
    rtol 1e-8 (exact) / 1e-7 (mixed), variances 1e-8 / 1e-4, atol 1e-10
    (tests/test_sharded.py:215-243)."""
    mu, var = _run(pool, ranks.predict, mixed, n, kernel)
    kerns, ops = jkernels.parse_kernel(kernel)
    X, y = ranks.toy(n)
    nkern = len(kerns)
    hypers = {"l": np.tile([0.4, 0.7], nkern), "kv": np.full(nkern, 1.3),
              "gv": np.array(1e-3)}
    Xq = np.random.default_rng(5).uniform(size=(23, 2))
    l, kv, gv, al = jengine.hypers_to_args(hypers, True)
    mu0, var0 = jengine.predict_diag(kerns, ops, jnp.asarray(X),
                                     jnp.asarray(y), jnp.asarray(Xq), l, kv,
                                     gv, al, 1e-6)
    mtol, vtol = (1e-7, 1e-4) if mixed else (1e-8, 1e-8)
    np.testing.assert_allclose(mu, np.asarray(mu0), rtol=mtol, atol=1e-10)
    np.testing.assert_allclose(var, np.asarray(var0), rtol=vtol, atol=1e-10)


def test_sharded_big_map_fit_matches_reference(pool):
    """sharded_big_map_fit against the JAX single-device big_map_fit:
    log posterior rel 1e-4 / abs 1e-3, lengthscales rtol 5e-2."""
    hypers, logp = _run(pool, ranks.big_map_fit)
    X, y = ranks.fit_data()
    h0, lp0 = jbigfit.big_map_fit(X, y, block=32, maxiter=100)
    assert float(logp) == pytest.approx(lp0, rel=1e-4, abs=1e-3)
    np.testing.assert_allclose(hypers["l"], h0["l"], rtol=5e-2)


def test_sharded_map_fit_matches_reference(pool):
    """sharded_map_fit (autograd through the collectives, the port's
    L-BFGS) against the JAX single-device engine.map_fit: log posterior
    rel 1e-4 / abs 1e-3, lengthscales rtol 2e-2."""
    hypers, logp, niter = _run(pool, ranks.map_fit)
    X, y = ranks.gp_data()
    cfg = jengine.FitConfig(
        kerns=("RBF",), ops=(), noise=True, truncate=False, jitter=1e-6,
        iwgp=False, cwgp=False, priors=[None] * 2,
        xconrevs=[_jnone()] * 2, yconrevs=[_jnone()], x=X,
        y=y.reshape(-1, 1))
    h0, lp0 = jengine.map_fit(cfg)
    assert np.isfinite(logp) and niter >= 1
    assert float(logp) == pytest.approx(lp0, rel=1e-4, abs=1e-3)
    np.testing.assert_allclose(hypers["l"], h0["l"], rtol=2e-2)


def test_sharded_big_warped_map_fit(pool):
    """sharded_big_warped_map_fit (cwgp, maxiter 12) returns the whole
    hyper and warping menu and improves on the start
    (tests/test_sharded.py:349-358); its log posterior lies within 1e-6
    relative of the JAX engine.build_objective's at its hypers."""
    hypers, logp, logp0 = _run(pool, ranks.big_warped_map_fit)
    assert {"gv", "l", "kv", "cwgp", "cwgp_pos"} <= set(hypers)
    assert float(logp) > float(logp0)
    cfg = _jwarped_cfg(48, cwgp=True)
    rv, nlp = jengine.build_objective(cfg)
    ref = -float(nlp(rv.pack_values(hypers)))
    assert abs(float(logp) - ref) < 1e-6 * max(1.0, abs(ref))


def test_sample_model_mesh_mcmc(pool):
    """sample_model(mesh=) with 2 lockstep hmc_host chains, cut from the
    reference test's 30 + 30 draws at max_treedepth 3 to 4 + 4
    (tests/test_sharded.py:361-397; the posterior-recovery checks on 30
    draws go with the cut): finite lp, the draws' shapes, gv > 0, and the
    lp at the last recorded draw within 1e-6 relative of the JAX
    engine.build_objective there."""
    post, lp = _run(pool, ranks.mcmc, 4, 4)
    assert post["l"].shape == (2, 4, 2)
    assert np.isfinite(lp).all()
    assert (post["gv"] > 0).all()
    X, y = ranks.mcmc_data()
    cfg = jengine.FitConfig(
        kerns=("RBF",), ops=(), noise=True, truncate=False, jitter=1e-6,
        iwgp=False, cwgp=False, priors=[None, None],
        xconrevs=[_jnone(), _jnone()], yconrevs=[_jnone()], x=X, y=y)
    rv, nlp = jengine.build_objective(cfg)
    z = rv.pack_values({"gv": float(post["gv"][0, -1]),
                        "l": post["l"][0, -1], "kv": float(post["kv"][0, -1])})
    lp_ref = -float(nlp(z))
    assert abs(lp_ref - float(lp[0, -1])) < 1e-6 * max(1.0, abs(lp_ref))


@pytest.mark.parametrize("cwgp", [False, True])
def test_fit_precision_distributed(pool, tmp_path, cwgp):
    """GPMCMC.fit(method='map', precision='distributed') on the pool's
    mesh (tests/test_gpmcmc_variants.py:163-190): plain, the lengthscales
    within rtol 5e-2 of the exact f64 fit's; cwgp (maxiter 15), the
    whole menu; predictions at the design points within 5e-2."""
    h0, h, yhat, y = _run(pool, ranks.facade, str(tmp_path), cwgp)
    if cwgp:
        assert {"gv", "l", "kv", "cwgp", "cwgp_pos"} <= set(h)
    else:
        np.testing.assert_allclose(h["l"], h0["l"], rtol=5e-2)
    assert np.abs(yhat[:, 0] - y[:, 0]).max() < 5e-2


@pytest.fixture
def one_rank_group():
    """The one-rank gloo group that data_mesh() forms in this process,
    left after the test."""
    assert not torch.distributed.is_initialized()
    yield
    torch.distributed.destroy_process_group()


def test_one_rank_group_matches_bigfit(one_rank_group):
    """data_mesh() with no process group forms a one-rank group, and the
    closed form runs through its collectives: value+grad against the
    port's own bigfit.nlml_value_and_grad (value rtol 1e-7, gradient rtol
    5e-6, atol 1e-8)."""
    mesh = sharded.data_mesh(device="cpu")
    assert torch.distributed.get_world_size() == 1
    X, y = ranks.toy(64)
    distributed.STATS.reset()
    rv, _, vg = sharded.make_sharded_mixed_objective(mesh, X, y, block=32)
    z = rv.z0() + 0.1
    v, g = vg(z)
    assert distributed.STATS.calls > 0
    bv, bg = bigfit.nlml_value_and_grad(X, y, z, block=32, device="cpu")
    np.testing.assert_allclose(float(v), float(bv), rtol=1e-7)
    np.testing.assert_allclose(g.numpy(), bg.numpy(), rtol=5e-6, atol=1e-8)


def test_tri_inv_mixed_base_matches_reference():
    """precision.tri_inv_mixed(L, base=32), the sharded mixed route's
    diagonal inverse at block 32, against the JAX tri_inv_mixed(L,
    base=32) at n=100 (off the grain, identity-padded): strictly lower,
    |X L - I| < 1e-6 (tests/test_precision.py:185-196), within 1e-6 of
    the reference's normwise; base=None is INV_BASE, bit for bit."""
    rng = np.random.default_rng(15)
    n = 100
    A = rng.normal(size=(n, n))
    Q, _ = np.linalg.qr(A)
    L = np.linalg.cholesky((Q * np.logspace(0, -4, n)) @ Q.T
                           + 1e-2 * np.eye(n))
    X = precision.tri_inv_mixed(torch.as_tensor(L), base=32).numpy()
    Xj = np.asarray(jprecision.tri_inv_mixed(jnp.asarray(L), base=32))
    assert np.abs(X @ L - np.eye(n)).max() < 1e-6
    assert np.abs(np.triu(X, 1)).max() == 0.0
    assert np.abs(X - Xj).max() <= 1e-6 * np.abs(Xj).max()
    Lt = torch.as_tensor(L)
    assert torch.equal(precision.tri_inv_mixed(Lt),
                       precision.tri_inv_mixed(Lt, base=precision.INV_BASE))
