"""Port parity, BO slice modules: K9's plain version, the fast Gram and
its gradients, the adjoint of the mixed blocked solve, Gauss-Hermite
statistics, the dists and transform subsets, LHC sampling, differential
evolution and L-BFGS, against the JAX reference on the same numpy
inputs (the reference's Pallas kernels in interpret mode, its pair-carry
route forced with PAIR_CARRY=2 where it matters)."""

import numpy as np
import pytest
import scipy.stats as st
from scipy.stats import qmc

import jax
import jax.numpy as jnp
import torch

from andvaranaut_tpu import dists as jdists
from andvaranaut_tpu import sampling as jsampling
from andvaranaut_tpu import transform as jtf
from andvaranaut_tpu.gp import kernels as jkernels
from andvaranaut_tpu.gp import pallas_ops
from andvaranaut_tpu.gp import precision as jprecision
from andvaranaut_tpu.gp import quad as jquad
from andvaranaut_tpu.gpmcmc import _transform_content_key as jkey
from andvaranaut_torch import _config, dists, sampling
from andvaranaut_torch import transform as tf
from andvaranaut_torch.gp import kernels, ops, precision, quad
from andvaranaut_torch.gpmcmc import _transform_content_key
from andvaranaut_torch.inference.de import differential_evolution
from andvaranaut_torch.inference.lbfgs import minimize_lbfgs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the suite runs in parallel
    workers, and a multi-threaded intra-op pool in each oversubscribes
    the cores.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


# ---- K9 and the fast Gram ------------------------------------------------

@pytest.mark.parametrize("name", ops.NAMES)
def test_k9_plain_matches_pallas_gram(name):
    """K9's plain version against pallas_gram (interpret mode) on the same
    pre-scaled f32 inputs, shapes off the tile edges, at the grade of
    test_pallas_ops.py; gram_component casts to f32 before dividing, as
    the reference's fast path does."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(70, 3))
    Y = rng.normal(size=(45, 3))
    ls = np.array([0.7, 1.3, 0.9])
    Xs = (X / ls).astype(np.float32)
    Ys = (Y / ls).astype(np.float32)
    want = np.asarray(pallas_ops.pallas_gram(name, jnp.asarray(Xs),
                                             jnp.asarray(Ys), alpha=1.7))
    got = ops.gram_tiles(name, torch.as_tensor(Xs), torch.as_tensor(Ys), 1.7)
    assert got.dtype == torch.float32 and got.shape == (70, 45)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    f32 = [jnp.asarray(v, dtype=jnp.float32) for v in (X, Y, ls)]
    want_c = np.asarray(pallas_ops.gram_component(
        name, *f32, alpha=jnp.asarray(1.7, dtype=jnp.float32)))
    got_c = ops.gram_component(
        name, *[torch.as_tensor(v, dtype=torch.float32) for v in (X, Y, ls)],
        alpha=torch.tensor(1.7, dtype=torch.float64))
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-6, atol=1e-6)


def test_gram_fast_values_and_gradients(monkeypatch):
    """gram_cross with the fast path opted in: values to the f32 grade of
    the exact Gram (2e-6), gradients those of the exact f64 form (1e-9)
    and of the reference's custom JVP (test_pallas_ops.py:239-266)."""
    monkeypatch.setenv("ANDVARANAUT_FAST_GRAM", "1")
    rng = np.random.default_rng(6)
    kerns, kops = ("RBF", "Matern32"), ("+",)
    X = rng.uniform(size=(40, 2))
    Y = rng.uniform(size=(25, 2))
    l = np.array([0.6, 1.1, 0.8, 0.9])
    kv = np.array([1.3, 0.7])
    lt = _t(l).requires_grad_()
    fast = kernels.gram_cross(kerns, kops, _t(X), _t(Y), lt, _t(kv))
    exact = kernels.gram(kerns, kops, _t(X), _t(Y), _t(l), _t(kv))
    np.testing.assert_allclose(fast.detach().numpy(), exact.numpy(),
                               rtol=2e-6, atol=2e-6)
    (g,) = torch.autograd.grad(fast.sum(), lt)
    le = _t(l).requires_grad_()
    (ge,) = torch.autograd.grad(
        kernels.gram(kerns, kops, _t(X), _t(Y), le, _t(kv)).sum(), le)
    np.testing.assert_allclose(g.numpy(), ge.numpy(), rtol=1e-9)

    def f(lv):
        return jnp.sum(jkernels.gram_cross(kerns, kops, jnp.asarray(X),
                                           jnp.asarray(Y), lv,
                                           jnp.asarray(kv)))

    gj = np.asarray(jax.grad(f)(jnp.asarray(l)))
    np.testing.assert_allclose(g.numpy(), gj, rtol=1e-9)


def test_gram_cross_opt_in(monkeypatch):
    """Off by default and with ANDVARANAUT_FAST_GRAM=0: the exact Gram bit
    for bit; on with 1."""
    monkeypatch.delenv("ANDVARANAUT_FAST_GRAM", raising=False)
    assert not _config.fast_gram()
    monkeypatch.setenv("ANDVARANAUT_FAST_GRAM", "0")
    assert not _config.fast_gram()
    X = _t(np.random.default_rng(7).uniform(size=(10, 2)))
    args = (("RatQuad",), (), X, X, _t([0.6, 1.1]), _t([1.0]),
            torch.tensor(1.3, dtype=torch.float64))
    assert torch.equal(kernels.gram_cross(*args), kernels.gram(*args))
    monkeypatch.setenv("ANDVARANAUT_FAST_GRAM", "1")
    assert _config.fast_gram()
    assert kernels.gram_cross(*args).dtype == torch.float64


# ---- the adjoint of the mixed blocked solve -------------------------------

def test_solve_lower_linear_vjp_matches_reference():
    """solve_lower_linear's backward (L^-T ct through the blocked upper
    solve) against the reference's custom VJP on the reference's own
    pair-carry factor, two 256-blocks, a matrix right-hand side."""
    rng = np.random.default_rng(8)
    n = 512
    A = rng.normal(size=(n, n))
    Q, _ = np.linalg.qr(A)
    K = (Q * np.logspace(0, -4, n)) @ Q.T + 1e-3 * np.eye(n)
    b = rng.normal(size=(n, 5))
    w = rng.normal(size=(n, 5))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jprecision, "PAIR_CARRY", 2)
        L, Dinv = jprecision.blocked_cholesky(jnp.asarray(K), block=256,
                                              return_inv=True)
        x_j, vjp = jax.vjp(lambda bb: jprecision.solve_lower_linear(
            L, bb, Dinv), jnp.asarray(b))
        (g_j,) = vjp(jnp.asarray(w))
    Lt = torch.as_tensor(np.tril(np.asarray(L)))
    Dt = torch.as_tensor(np.array(Dinv))
    bt = _t(b).requires_grad_()
    x = precision.solve_lower_linear(Lt, bt, Dt)
    (g,) = torch.autograd.grad((x * _t(w)).sum(), bt)
    for got, want in ((x.detach().numpy(), np.asarray(x_j)),
                      (g.numpy(), np.asarray(g_j))):
        assert np.abs(got - want).max() / np.abs(want).max() <= 1e-10
    exact = np.linalg.solve(np.tril(np.asarray(L)).T, w)
    assert np.abs(g.numpy() - exact).max() / np.abs(exact).max() <= 1e-9


# ---- Gauss-Hermite statistics -----------------------------------------------

def test_gh_stats_affine_exact():
    """For an affine reversion the quadrature is exact."""
    t = tf.affine(0.5, 2.0)
    mu = np.array([0.1, -0.3])
    var = np.array([0.04, 0.09])
    y, yv = quad.gh_stats(t.rev, mu, var)
    np.testing.assert_allclose(y.numpy(), (mu - 0.5) / 2.0, rtol=1e-12)
    np.testing.assert_allclose(yv.numpy(), var / 4.0, rtol=1e-9)
    ei, _ = quad.gh_stats(tf.affine(0.0, 1.0).rev, np.array([1.0, 3.0]),
                          np.array([1e-20, 1e-20]), EI=True, EIopt="min",
                          yopt=2.0)
    np.testing.assert_allclose(ei.numpy(), [1.0, 0.0], atol=1e-9)


@pytest.mark.parametrize("kw", [
    {}, {"normvar": True}, {"EI": True, "EIopt": "min", "yopt": 1.2},
    {"EI": True, "EIopt": "max", "yopt": 1.0}, {"deg": 12}])
def test_gh_stats_matches_reference(kw):
    """A nonlinear reversion (exp) with mean-function values, against the
    reference's vmapped quadrature at 1e-12."""
    rng = np.random.default_rng(9)
    mu = rng.normal(size=30) * 0.3
    var = rng.uniform(0.01, 0.2, size=30)
    mv = rng.normal(size=30)
    y, yv = quad.gh_stats(tf.logarithm().rev, mu, var, mv, **kw)
    yj, yvj = jquad.gh_stats(jtf.logarithm().rev, mu, var, mv, **kw)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-12)
    np.testing.assert_allclose(yv.numpy(), np.asarray(yvj), rtol=1e-12)
    v = quad.gh_var_inv(tf.logarithm().con, np.exp(mu), var * 0.1)
    vj = jquad.gh_var_inv(jtf.logarithm().con, np.exp(mu), var * 0.1)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=1e-12)


# ---- dists ---------------------------------------------------------------

DIST_CASES = [("Uniform", (0.5, 2.0)), ("Normal", (1.0, 0.3)),
              ("TruncNorm", (-1.0, 2.0, 0.5, 0.7)),
              ("TruncNorm", (0.5, 3.0, 0.2, 1.5))]


@pytest.mark.parametrize("name,args", DIST_CASES)
def test_dists_match_reference(name, args):
    d = getattr(dists, name)(*args)
    dj = getattr(jdists, name)(*args)
    q = np.linspace(0.01, 0.99, 23)
    lo, hi = (float(v) for v in dj.interval(0.999))
    x = np.linspace(lo - 0.1, hi + 0.1, 31)
    for meth, arg in (("ppf", q), ("isf", q), ("cdf", x), ("sf", x),
                      ("logpdf", x), ("pdf", x)):
        got = getattr(d, meth)(arg).numpy()
        want = np.asarray(getattr(dj, meth)(jnp.asarray(arg)))
        fin = np.isfinite(want)
        assert (np.isfinite(got) == fin).all(), meth
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12,
                                   atol=1e-14, err_msg=meth)
    for alpha in (1.0, 0.9):
        for a, b in zip(d.interval(alpha), dj.interval(alpha)):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-12)
    np.testing.assert_allclose(float(d.mean()), float(dj.mean()), rtol=1e-12)
    np.testing.assert_allclose(float(d.std()), float(dj.std()), rtol=1e-12)
    s1 = d.rvs(200, random_state=3)
    assert torch.equal(s1, d.rvs(200, random_state=3))
    ilo, ihi = (float(v) for v in d.interval(1.0))
    assert s1.shape == (200,) and ((s1 >= ilo) & (s1 <= ihi)).all()
    assert d.rvs().shape == ()


def test_from_prior_and_scipy_passthrough():
    assert dists.from_prior(st.uniform(0, 2)) == dists.Uniform(0.0, 2.0)
    assert dists.from_prior(st.norm(5, 0.1)) == dists.Normal(5.0, 0.1)
    tn = dists.from_prior(st.truncnorm(-1, 2, loc=0.5, scale=0.7))
    assert tn == dists.TruncNorm(-1.0, 2.0, 0.5, 0.7)
    # lognorm and halfnorm are native, as in the reference's from_prior
    assert dists.from_prior(st.lognorm(0.5, scale=2.0)) == dists.LogNormal(
        0.5, 0.0, 2.0)
    assert dists.from_prior(st.halfnorm(scale=2.0)) == dists.HalfNormal(
        0.0, 2.0)
    bt = dists.from_prior(st.beta(2.0, 3.0, scale=2.0))
    assert isinstance(bt, dists.ScipyDist)
    q = np.linspace(0.1, 0.9, 5)
    np.testing.assert_allclose(bt.ppf(q).numpy(),
                               st.beta(2.0, 3.0, scale=2.0).ppf(q),
                               rtol=1e-14)
    assert dists.is_distribution_like(st.beta(2, 3))
    assert not dists.is_distribution_like(object())
    with pytest.raises(TypeError):
        dists.from_prior(object())


# ---- transforms -----------------------------------------------------------

def _transform_pairs(y):
    u, uj = dists.Uniform(0.0, 2.0), jdists.Uniform(0.0, 2.0)
    nm, nmj = dists.Normal(1.0, 2.0), jdists.Normal(1.0, 2.0)
    tn, tnj = (dists.TruncNorm(-1.0, 1.5, 0.8, 0.6),
               jdists.TruncNorm(-1.0, 1.5, 0.8, 0.6))
    return [
        (tf.affine(0.3, 1.7), jtf.affine(0.3, 1.7)),
        (tf.meanstd(y), jtf.meanstd(y)),
        (tf.minshift(y), jtf.minshift(y)),
        (tf.stddev(y), jtf.stddev(y)),
        (tf.stdshift(0.2, y), jtf.stdshift(0.2, y)),
        (tf.maxmin(y), jtf.maxmin(y)),
        (tf.maxmin(y, centred=True), jtf.maxmin(y, centred=True)),
        (tf.uniform(u), jtf.uniform(uj)),
        (tf.normal(nm), jtf.normal(nmj)),
        (tf.logit_logistic(u), jtf.logit_logistic(uj)),
        (tf.logit_logistic(tn), jtf.logit_logistic(tnj)),
        (tf.logarithm(), jtf.logarithm()),
    ]


def test_transforms_match_reference():
    """con, rev and der of the ported subset at 1e-12, numpy and tensor
    inputs alike."""
    rng = np.random.default_rng(10)
    y = rng.uniform(0.25, 1.65, size=50)
    for t, tj in _transform_pairs(y):
        label = type(t).__name__
        for meth in ("con", "rev", "der"):
            if not hasattr(tj, meth):
                continue
            arg = y if meth != "rev" else np.asarray(tj.con(y))
            want = np.asarray(getattr(tj, meth)(jnp.asarray(arg)))
            got = getattr(t, meth)(arg)
            assert isinstance(got, torch.Tensor), label
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                       atol=1e-14, err_msg=f"{label}.{meth}")
            np.testing.assert_allclose(getattr(t, meth)(_t(arg)).numpy(),
                                       got.numpy(), rtol=0, atol=0)
        np.testing.assert_allclose(t.rev(t.con(y)).numpy(), y, rtol=1e-9)
    with pytest.raises(ValueError):
        tf.affine(0.0, -1.0)


def test_transform_content_key():
    y = np.linspace(-2.0, 3.0, 20)
    a, b = tf.meanstd(y), tf.meanstd(y)
    assert a is not b
    assert _transform_content_key(a) == _transform_content_key(b)
    assert _transform_content_key(a) != _transform_content_key(
        tf.meanstd(y * 2.0 + 1.0))
    assert _transform_content_key(tf.uniform(dists.Uniform(0.0, 2.0))) != \
        _transform_content_key(tf.uniform(dists.Uniform(0.0, 3.0)))
    assert jkey(jtf.meanstd(y)) == jkey(jtf.meanstd(y))


# ---- sampling -------------------------------------------------------------

def test_cd2_matches_reference_and_scipy():
    x = np.random.default_rng(1).uniform(size=(37, 3))
    got = float(sampling.cd2_discrepancy(x))
    np.testing.assert_allclose(got, float(jsampling.cd2_discrepancy(x)),
                               rtol=1e-12)
    np.testing.assert_allclose(got, float(qmc.discrepancy(x, method="CD")),
                               rtol=1e-10)


@pytest.mark.parametrize("r1,r2,c", [(3, 7, 0), (10, 2, 1), (5, 40, 2),
                                     (0, 49, 1)])
def test_swap_delta(r1, r2, c):
    """The exact change of cd2_discrepancy, which is the reference's
    delta plus the two diagonal entries H[r1, r1] and H[r2, r2] that the
    reference takes to cancel (they do only for d = 1)."""
    x = np.asarray(sampling._stratified(torch.Generator().manual_seed(4), 50,
                                        3))
    got = float(sampling._swap_delta(torch.as_tensor(x), r1, r2, c))
    xs = x.copy()
    xs[[r1, r2], c] = xs[[r2, r1], c]
    brute = float(sampling.cd2_discrepancy(xs) - sampling.cd2_discrepancy(x))
    assert abs(got - brute) <= 1e-9 * abs(brute) + 1e-15
    az = np.abs(x - 0.5)
    hd = np.prod(1.0 + az, axis=1)
    diag = (hd[r1] * ((1 + az[r2, c]) / (1 + az[r1, c]) - 1)
            + hd[r2] * ((1 + az[r1, c]) / (1 + az[r2, c]) - 1)) / 50 ** 2
    ref = float(jsampling._swap_delta(jnp.asarray(x), r1, r2, c))
    np.testing.assert_allclose(got, ref + diag, rtol=1e-12)


def test_latin_hypercube_stratified_and_refined():
    n, d = 64, 4
    pts = sampling.latin_hypercube(torch.Generator().manual_seed(0), n, d, 0)
    assert pts.shape == (n, d)
    for j in range(d):
        assert sorted(np.floor(pts[:, j].numpy() * n).astype(int)) == list(
            range(n))
    base = sampling.latin_hypercube(torch.Generator().manual_seed(3), 50, 2, 0)
    opt = sampling.latin_hypercube(torch.Generator().manual_seed(3), 50, 2,
                                   2000)
    assert float(sampling.cd2_discrepancy(opt)) < float(
        sampling.cd2_discrepancy(base))
    for j in range(2):
        assert sorted(np.floor(opt[:, j].numpy() * 50).astype(int)) == list(
            range(50))


def test_lhc_sample_priors_and_seed():
    priors = [dists.Uniform(0.0, 2.0), dists.Normal(5.0, 0.1)]
    x = sampling.lhc_sample(priors, 200, seed=7)
    assert x.shape == (200, 2) and isinstance(x, np.ndarray)
    assert (x[:, 0] >= 0).all() and (x[:, 0] <= 2).all()
    assert abs(x[:, 1].mean() - 5.0) < 0.01
    assert sampling.lhc_sample([st.uniform(0, 2), st.norm(5, 0.1)], 50,
                               seed=1).shape == (50, 2)
    a = sampling.lhc_sample([dists.Uniform(0.0, 1.0)], 16, seed=11)
    np.testing.assert_array_equal(
        a, sampling.lhc_sample([dists.Uniform(0.0, 1.0)], 16, seed=11))
    assert not np.array_equal(
        a, sampling.lhc_sample([dists.Uniform(0.0, 1.0)], 16, seed=12))
    assert sampling.default_cd_iters(10000, 2) == 0


# ---- optimisers -------------------------------------------------------------

def test_differential_evolution_finds_quadratic_minimum():
    c = torch.tensor([0.3, -1.2, 2.0], dtype=torch.float64)

    def fn(X):
        return ((X - c) ** 2).sum(1) + 1.0

    lo = torch.full((3,), -3.0, dtype=torch.float64)
    hi = torch.full((3,), 3.0, dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    x, f, n = differential_evolution(fn, lo, hi, gen, tol=1e-6)
    assert 0 < n <= 200
    assert float((x - c).abs().max()) < 1e-2
    assert abs(float(f) - 1.0) < 1e-4


def test_minimize_lbfgs_rosenbrock():
    def f(z):
        return 100.0 * (z[1] - z[0] ** 2) ** 2 + (1.0 - z[0]) ** 2

    z, val, gnorm, n = minimize_lbfgs(
        f, torch.tensor([-1.2, 1.0], dtype=torch.float64))
    np.testing.assert_allclose(z.numpy(), [1.0, 1.0], atol=1e-6)
    assert val < 1e-12 and 0 < n <= 500
