"""Port parity, warping stack: the LogNormal and HalfNormal distributions,
every transform class and free function of andvaranaut_torch.transform,
the data-fitted preprocessing (quantile, robust, powerT, boxcoxf) and the
composite `wgp` with its gradients, against the JAX package on the same
numpy inputs (the mirror of tests/test_transform.py and the LogNormal /
HalfNormal cases of tests/test_dists.py)."""

import numpy as np
import pytest
import scipy.stats as st

import jax
import jax.numpy as jnp
import torch

from andvaranaut_tpu import dists as jdists
from andvaranaut_tpu import transform as jtf
from andvaranaut_torch import dists
from andvaranaut_torch import transform as tf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the suite runs in parallel
    workers, and a multi-threaded intra-op pool in each oversubscribes
    the cores.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


YPOS = np.array([0.1, 0.5, 1.0, 2.3, 7.7])
YANY = np.array([-3.0, -0.4, 0.2, 1.1, 4.2])
Y01 = np.array([0.05, 0.2, 0.5, 0.8, 0.95])


def _close(got, want, rtol=1e-12, atol=1e-14, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, dtype=float),
                               np.asarray(want, dtype=float), rtol=rtol,
                               atol=atol, err_msg=msg)


# ---- LogNormal, HalfNormal ----------------------------------------------------

DIST_CASES = [
    (st.lognorm(0.9, scale=np.exp(0.3)),
     lambda m: m.LogNormal.from_mu_sigma(0.3, 0.9)),
    (st.lognorm(0.4, loc=-1.0, scale=2.0),
     lambda m: m.LogNormal(0.4, -1.0, 2.0)),
    (st.halfnorm(scale=2.0), lambda m: m.HalfNormal(0.0, 2.0)),
    (st.halfnorm(loc=0.5, scale=0.3), lambda m: m.HalfNormal(0.5, 0.3)),
]


@pytest.mark.parametrize("case", range(len(DIST_CASES)))
def test_lognormal_halfnormal_match_reference(case):
    """ppf, isf, cdf, sf, logpdf and pdf against the JAX package's at
    rtol 1e-12 and against scipy at tests/test_dists.py's tolerances;
    mean, std, interval and from_prior; seeded draws in the support."""
    sp, make = DIST_CASES[case]
    d, dj = make(dists), make(jdists)
    q = np.linspace(1e-8, 1 - 1e-8, 101)
    x = np.concatenate([sp.ppf(np.linspace(0.01, 0.99, 53)),
                        [float(sp.support()[0]) - 0.5]])
    for meth, arg in (("ppf", q), ("isf", q), ("cdf", x), ("sf", x),
                      ("logpdf", x), ("pdf", x)):
        got = getattr(d, meth)(arg).numpy()
        want = np.asarray(getattr(dj, meth)(jnp.asarray(arg)))
        fin = np.isfinite(want)
        assert (np.isfinite(got) == fin).all(), meth
        _close(got[fin], want[fin], msg=meth)
    _close(d.ppf(q), sp.ppf(q), rtol=1e-8, atol=2e-8)
    _close(d.isf(q), sp.isf(q), rtol=1e-8, atol=2e-8)
    x = x[:-1]
    _close(d.cdf(x), sp.cdf(x), rtol=1e-9, atol=1e-10)
    _close(d.sf(x), sp.sf(x), rtol=1e-9, atol=1e-12)
    _close(d.logpdf(x), sp.logpdf(x), rtol=1e-9, atol=1e-10)
    _close(d.mean(), sp.mean(), rtol=1e-10)
    _close(d.std(), sp.std(), rtol=1e-10)
    for alpha in (1.0, 0.9):
        for a, b in zip(d.interval(alpha), dj.interval(alpha)):
            _close(float(a), float(b))
    assert dists.from_prior(sp) == d
    s = d.rvs(300, random_state=4)
    assert torch.equal(s, d.rvs(300, random_state=4))
    lo = float(d.interval(1.0)[0])
    assert s.shape == (300,) and (s >= lo).all()
    g = torch.Generator().manual_seed(2)
    assert d.rvs((2, 3), generator=g).shape == (2, 3)


# ---- classes and free functions ----------------------------------------------

def _pairs():
    """(port transform, reference transform, inputs) for every class."""
    u = (dists.Uniform(1.0, 2.0), jdists.Uniform(1.0, 2.0))
    nm = (dists.Normal(1.0, 2.0), jdists.Normal(1.0, 2.0))
    tn = (dists.TruncNorm(-1.0, 1.5, 0.8, 0.6),
          jdists.TruncNorm(-1.0, 1.5, 0.8, 0.6))
    x12 = np.linspace(1.05, 2.95, 9)
    both = [
        ("normal", nm, x12), ("logit_logistic", u, x12),
        ("logit_logistic", tn, np.linspace(0.3, 1.6, 7)),
        ("cdf", u, x12), ("probit", u, x12), ("probit", nm, YANY),
        ("normalise", (3.3, 3.3), YANY), ("log1p", (), YPOS),
        ("log10", (), YPOS), ("nonneg", (), YPOS), ("logarithm", (), YPOS),
        ("affine", (0.3, 1.7), YANY),
        ("arcsinh", (0.1, 1.2, -0.3, 0.8), YANY), ("boxcox", (0.4,), YPOS),
        ("sinharcsinh", (0.2, 1.3), YANY),
        ("sal", (0.2, 1.3, -0.1, 0.9), YANY),
        ("kumaraswamy", (1.4, 2.2), Y01), ("meanstd", (YANY,), YANY),
        ("minshift", (YANY,), YANY), ("stddev", (YANY,), YANY),
        ("stdshift", (0.3, YANY), YANY), ("maxmin", (YANY,), YANY),
        ("uniform", (dists.Uniform(0.0, 2.0), jdists.Uniform(0.0, 2.0)),
         np.linspace(0.1, 1.9, 5)),
        ("preserve_zero", (YANY, 0.7), YANY),
    ]
    out = []
    for name, args, y in both:
        if name in ("normal", "logit_logistic", "cdf", "probit"):
            pa, ja = (args[0],), (args[1],)
        elif name == "normalise":
            pa = ja = (args[0],)
        elif name == "uniform":
            pa, ja = (args[0],), (args[1],)
        else:
            pa = ja = args
        out.append((name, getattr(tf, name)(*pa), getattr(jtf, name)(*ja), y))
    return out


PAIRS = _pairs()


@pytest.mark.parametrize("i", range(len(PAIRS)),
                         ids=[f"{p[0]}{i}" for i, p in enumerate(PAIRS)])
def test_class_matches_reference(i):
    """con, rev (on the converted values) and der, where the class has
    one, equal the reference's at rtol 1e-12 on numpy inputs and on a
    tensor; the aliases conmc/revmc/dermc are the same functions; every
    class with learnable parameters has the reference's default
    priors."""
    name, t, tj, y = PAIRS[i]
    c = t.con(y)
    assert c.dtype == torch.float64
    _close(c, tj.con(y), msg="con")
    _close(t.con(torch.as_tensor(y)), tj.con(y), msg="con tensor")
    _close(t.rev(c), tj.rev(jnp.asarray(c.numpy())), msg="rev")
    _close(t.rev(c), y, rtol=1e-9, atol=1e-9, msg="round trip")
    assert torch.equal(t.conmc(y), c) and torch.equal(t.revmc(c), t.rev(c))
    assert hasattr(t, "der") == hasattr(tj, "der")
    if hasattr(t, "der"):
        _close(t.der(y), tj.der(y), msg="der")
        assert torch.equal(t.dermc(y), t.der(y))
    assert hasattr(t, "default_priors") == hasattr(tj, "default_priors")
    if hasattr(tj, "default_priors"):
        assert [(type(p).__name__, p.loc, p.scale)
                for p in t.default_priors] == [
            (type(p).__name__, float(p.loc), float(p.scale))
            for p in tj.default_priors]


def test_free_functions_match_reference():
    """The free functions of the conversion tier at rtol 1e-12."""
    u, uj = dists.Uniform(1.0, 2.0), jdists.Uniform(1.0, 2.0)
    nm, nmj = dists.Normal(1.0, 2.0), jdists.Normal(1.0, 2.0)
    x12 = np.linspace(1.05, 2.95, 9)
    cases = [
        ("std_uniform", (x12, u), (x12, uj)),
        ("uniform_rev", (Y01, u), (Y01, uj)),
        ("std_normal", (YANY, nm), (YANY, nmj)),
        ("normal_rev", (YANY, nm), (YANY, nmj)),
        ("log1p_con", (YPOS,), None), ("log1p_rev", (YANY,), None),
        ("log10_con", (YPOS,), None), ("log10_rev", (YANY,), None),
        ("nonneg_con", (YPOS,), None), ("nonneg_rev", (YANY,), None),
        ("probit_con", (x12, u), (x12, uj)),
        ("probit_rev", (YANY, u), (YANY, uj)),
        ("cdf_con", (x12, u), (x12, uj)), ("cdf_rev", (Y01, u), (Y01, uj)),
        ("logit", (x12, u), (x12, uj)),
        ("logistic", (YANY, u), (YANY, uj)),
        ("normalise_con", (YANY, 3.3), None),
        ("normalise_rev", (YANY, 3.3), None),
        ("meanstd_con", (YANY, 0.4, 1.7), None),
        ("meanstd_rev", (YANY, 0.4, 1.7), None),
        ("robust_con", (YANY, 0.4, 1.7), None),
        ("robust_rev", (YANY, 0.4, 1.7), None),
    ]
    for name, pa, ja in cases:
        _close(getattr(tf, name)(*pa), getattr(jtf, name)(*(ja or pa)),
               msg=name)
    for lam in (0.0, 0.37, 2.0):
        for name in ("_yeojohnson_con", "_yeojohnson_rev"):
            _close(getattr(tf, name)(YANY, lam),
                   getattr(jtf, name)(YANY, lam), msg=f"{name} {lam}")
        for name in ("_boxcox_plain_con", "_boxcox_plain_rev"):
            _close(getattr(tf, name)(YPOS, lam),
                   getattr(jtf, name)(YPOS, lam), msg=f"{name} {lam}")
    for method in ("yeo-johnson", "box-cox"):
        args = (YPOS, 0.3, 0.2, 1.4, method)
        _close(tf.powerT_con(*args), jtf.powerT_con(*args), msg=method)
        _close(tf.powerT_rev(*args), jtf.powerT_rev(*args), msg=method)


def test_logit_clamping():
    """The reference's clamps: no inf at 0 and 1, logistic saturating."""
    t = tf.logit_logistic(dists.Uniform(0.0, 1.0))
    assert torch.isfinite(t.con(np.array([0.0, 1.0, 0.5]))).all()
    back = t.rev(np.array([-1e3, 1e3, 0.0]))
    assert torch.isfinite(back).all()
    _close(back[2], 0.5)


# ---- data-fitted preprocessing ------------------------------------------------

@pytest.mark.parametrize("cls,kw", [
    ("quantile", {}), ("quantile", {"mode": "uniform"}), ("robust", {}),
    ("powerT", {}), ("powerT", {"method": "box-cox"}), ("boxcoxf", {})])
def test_data_fitted_match_reference(cls, kw):
    """The host fits equal the JAX package's own (no sklearn): their
    parameters, con at points inside and outside the fitted range, and
    rev; the fitted data round-trip."""
    rng = np.random.default_rng(0)
    x = rng.lognormal(size=200)
    y = np.concatenate([rng.lognormal(size=30), [x.min() / 2, x.max() * 2]])
    t, tj = getattr(tf, cls)(x, **kw), getattr(jtf, cls)(x, **kw)
    for attr in ("quants", "refs", "center", "scale", "lam", "mean", "std",
                 "lamb"):
        if hasattr(tj, attr):
            _close(getattr(t, attr), getattr(tj, attr), msg=attr)
    c = t.con(y)
    _close(c, tj.con(y), msg="con")
    _close(t.rev(c), tj.rev(jnp.asarray(c.numpy())), msg="rev")
    _close(t.rev(t.con(x)), x, rtol=1e-6, atol=1e-6, msg="round trip")


def test_quantile_repeated_values():
    """Repeated quantile values (two-sided interpolation) and a scalar
    input, against the reference."""
    x = np.repeat([0.0, 1.0, 1.0, 1.0, 2.5, 4.0], 7)
    y = np.array([-1.0, 0.0, 0.5, 1.0, 1.0 + 1e-12, 3.0, 9.0])
    for mode in ("normal", "uniform"):
        t, tj = tf.quantile(x, mode=mode), jtf.quantile(x, mode=mode)
        _close(t.con(y), tj.con(y), msg=mode)
        _close(t.con(1.0), tj.con(1.0), msg=mode)
        z = np.asarray(tj.con(y))
        _close(t.rev(z), tj.rev(z), msg=mode)


def test_boxcoxf_refuses_grad_data():
    """boxcoxf's lambda is a host fit: data on a gradient's graph are
    refused, as the reference refuses traced data."""
    y = torch.tensor(YPOS, requires_grad=True)
    with pytest.raises(ValueError, match="concrete data"):
        tf.boxcoxf(y * 2.0)
    with pytest.raises(ValueError, match="concrete data"):
        tf.wgp(["affine", "boxcoxf"], torch.tensor([0.5, 1.0],
                                                   requires_grad=True),
               y=YPOS)
    tf.boxcoxf(y.detach())


# ---- repairs: host values, positivity on grad tensors, default priors ---------

def test_data_fits_host_values_unchanged():
    """Fitted on host data, the affine family's parameters are Python
    floats with the values of the float formulas the port computed them
    with before; fitted on data that carry a gradient they are tensors
    that carry it."""
    y = YANY
    yt = torch.as_tensor(y)
    m, s = float(torch.mean(yt)), float(torch.std(yt, correction=0))
    lo, hi = float(torch.min(yt)), float(torch.max(yt))
    xm = (hi - lo) / (1 - 2 * 0.01)
    expect = {
        "meanstd": ((y,), (-m / s, 1.0 / s)),
        "minshift": ((y,), (-lo * 1000, 1.0)),
        "stddev": ((y,), (0.0, 1.0 / s)),
        "stdshift": ((0.3, y), (0.3, 1.0 / s)),
        "maxmin": ((y,), (-lo / xm + 0.01, 1.0 / xm)),
        "preserve_zero": ((y, 0.7), (-0.7 / s, 1.0 / s)),
    }
    for name, (args, (a, b)) in expect.items():
        t = getattr(tf, name)(*args)
        assert type(t.a) is float and type(t.b) is float, name
        assert (t.a, t.b) == (a, b), name
    c = tf.maxmin(y, centred=True)
    assert (c.a, c.b) == (-(hi + lo) / xm, 2.0 / xm)
    yg = torch.tensor(y, requires_grad=True)
    for name in ("meanstd", "stddev", "maxmin", "preserve_zero"):
        args = (yg, 0.7) if name == "preserve_zero" else (yg,)
        t = getattr(tf, name)(*args)
        assert isinstance(t.b, torch.Tensor) and t.b.requires_grad, name
        (g,) = torch.autograd.grad(t.con(yg).sum(), yg)
        assert torch.isfinite(g).all(), name


def test_positivity_validation():
    """Concrete non-positive parameters are refused; a tensor that
    requires grad is not read back (the reference skips traced values)."""
    with pytest.raises(ValueError):
        tf.affine(0.0, -1.0)
    with pytest.raises(ValueError):
        tf.kumaraswamy(-1.0, 1.0)
    with pytest.raises(ValueError):
        tf.sal(0.0, 1.0, 0.0, torch.tensor(-2.0))
    b = torch.tensor(-1.0, requires_grad=True)
    out = tf.affine(0.0, b).con(1.0)
    (g,) = torch.autograd.grad(out, b)
    assert float(g) == 1.0
    tf.kumaraswamy(torch.tensor(-1.0, requires_grad=True), 1.0)


# ---- wgp ----------------------------------------------------------------------

def test_wgp_bookkeeping():
    """pid, pos, np and default_priors as the reference's; con, rev and
    der equal its own; round trip."""
    params = np.array([0.1, 1.2, 0.3, 1.1, 0.2, 0.9, 0.3, 1.4, 0.25])
    names = ["sinharcsinh", "affine", "meanstd", "arcsinh", "stdshift"]
    w = tf.wgp(names, params, y=YANY)
    wj = jtf.wgp(names, params, y=YANY)
    assert w.np == wj.np == 9
    np.testing.assert_array_equal(w.pid, wj.pid)
    np.testing.assert_array_equal(w.pos, wj.pos)
    assert w.warping_names == names
    assert [(p.loc, p.scale) for p in w.default_priors] == [
        (float(p.loc), float(p.scale)) for p in wj.default_priors]
    _close(w.con(YANY), wj.con(YANY))
    _close(w.der(YANY), wj.der(YANY))
    _close(w.log_det_jac(YANY), wj.log_det_jac(YANY))
    _close(w.rev(w.con(YANY)), YANY, rtol=1e-9, atol=1e-9)
    _close(w.rev(w.con(YANY)), wj.rev(wj.con(YANY)))


@pytest.mark.parametrize("names,params,y", [
    (["sinharcsinh", "meanstd"], [0.2, 1.1], YPOS),
    (["affine", "pzero"], [0.5, 2.0], YANY),
    (["uniform", "kumaraswamy"], [1.3, 0.8], np.linspace(0.1, 1.9, 6)),
    (["logarithm", "minshift", "boxcox", "maxmin", "stddev"], [0.3], YPOS),
    (["boxcoxf", "meanstd", "sal", "pzero"], [0.1, 1.2, 0.2, 0.8], YPOS),
])
def test_wgp_running_data_fits(names, params, y):
    """Data-fitted stages are fitted against the running warped data and
    pzero against the warped image of 0, as in the reference.  (boxcoxf
    comes first: its lambda is an optimiser's, ~1e-8 apart for data that
    differ in the last bit.)"""
    kw = {"xdist": dists.Uniform(0.0, 2.0)} if "uniform" in names else {}
    kwj = {"xdist": jdists.Uniform(0.0, 2.0)} if "uniform" in names else {}
    w = tf.wgp(names, np.asarray(params), y=y, **kw)
    wj = jtf.wgp(names, np.asarray(params), y=y, **kwj)
    _close(w.con(y), wj.con(y))
    _close(w.der(y), wj.der(y))
    _close(w.rev(w.con(y)), y, rtol=1e-8, atol=1e-8)
    if "pzero" in names:
        k = names.index("pzero")
        part = tf.wgp(names[:k + 1], np.asarray(params)[:w.pid[k]], y=y)
        _close(part.con(0.0), 0.0, atol=1e-12)


def test_wgp_refusals():
    with pytest.raises(ValueError, match="allowed"):
        tf.wgp(["nope"], np.zeros(1))
    with pytest.raises(ValueError, match="y array"):
        tf.wgp(["meanstd"], np.zeros(0))
    with pytest.raises(ValueError, match="x distribution"):
        tf.wgp(["uniform"], np.zeros(0), y=Y01)


@pytest.mark.parametrize("names,params,y,kw", [
    (["sinharcsinh", "meanstd"], [0.2, 1.1], YANY, {}),
    (["meanstd", "sinharcsinh"], [0.1, 1.3], YANY, {}),
    (["sinharcsinh", "stdshift", "affine", "pzero"],
     [0.2, 1.1, 0.4, 0.3, 1.2], YANY, {}),
    (["arcsinh", "maxmin", "boxcox", "minshift"],
     [0.1, 1.2, -0.2, 0.9, 0.3], YANY, {}),
    (["uniform", "kumaraswamy", "sinharcsinh"], [1.3, 0.8, 0.1, 1.2],
     np.linspace(0.1, 1.9, 7), {"xdist": 1}),
    (["meanstd", "sal", "stddev"], [0.1, 1.2, 0.2, 0.8], YPOS, {}),
])
def test_wgp_autograd_matches_jax_grad(names, params, y, kw):
    """The gradient of sum(con) + log_det_jac with respect to params, the
    warping refitted from data on the parameters' graph (data-fitted
    stages after learnable ones included), equals jax.grad of the JAX
    wgp's at rtol 1e-10 (atol 1e-12 for entries that vanish)."""
    p = np.asarray(params, dtype=float)
    xd = {"xdist": dists.Uniform(0.0, 2.0)} if kw else {}
    xdj = {"xdist": jdists.Uniform(0.0, 2.0)} if kw else {}
    yt = torch.as_tensor(y)

    def f(pp):
        w = tf.wgp(names, pp, y=yt, **xd)
        return w.con(yt).sum() + w.log_det_jac(yt)

    def fj(pp):
        w = jtf.wgp(names, pp, y=jnp.asarray(y), **xdj)
        return w.con(jnp.asarray(y)).sum() + w.log_det_jac(jnp.asarray(y))

    pt = torch.tensor(p, requires_grad=True)
    v = f(pt)
    (g,) = torch.autograd.grad(v, pt)
    _close(v, fj(jnp.asarray(p)), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(fj)(
        jnp.asarray(p))), rtol=1e-10, atol=1e-12)
    # the same through a per-point con (the Gram-side use)
    (g2,) = torch.autograd.grad(
        tf.wgp(names, pt, y=yt, **xd).con(yt)[-1], pt)
    gj2 = jax.grad(lambda pp: jtf.wgp(names, pp, y=jnp.asarray(y),
                                      **xdj).con(jnp.asarray(y))[-1])(
        jnp.asarray(p))
    np.testing.assert_allclose(g2.numpy(), np.asarray(gj2), rtol=1e-10,
                               atol=1e-12)
