"""Port parity, MAP-fit slice: the hyperprior reparameterisation, the
plain versions behind K4-K7, the L^-1 identity solve, the closed-form
value+grad and the L-BFGS-B MAP fit, against the JAX reference on the
same numpy inputs.

The JAX references run on the CPU with the pair carry and the fused
gradient route forced (PAIR_CARRY=2, ANDVARANAUT_FUSED_GRAD=2), so their
Pallas kernels (the TPU's K4-K7) run in interpret mode; each is computed
once per module.  The CUDA kernels are held to these plain versions on
the card (tests/test_torch_gpu.py and chip_smoke.py)."""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from andvaranaut_tpu.gp import bigfit as jbigfit
from andvaranaut_tpu.gp import engine as jengine
from andvaranaut_tpu.gp import kernels as jkernels
from andvaranaut_tpu.gp import pallas_panel, pallas_slicemm
from andvaranaut_tpu.gp import precision as jprecision
from andvaranaut_tpu.inference import unconstrained as jun
from andvaranaut_torch.gp import bigfit, engine, kernels, panel, precision
from andvaranaut_torch.gp import slicemm
from andvaranaut_torch.inference import unconstrained as un


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


def _spd(n, rng, cond=1e4):
    A = rng.normal(size=(n, n))
    Q, _ = np.linalg.qr(A)
    eigs = np.logspace(0, -np.log10(cond), n)
    return (Q * eigs) @ Q.T


def _lower_tiles(m):
    t = np.arange(m) // 256
    return t[:, None] >= t[None, :]


@contextlib.contextmanager
def _fused_route():
    """The reference's kernel route on the CPU: pair carries and the
    pair-native K^-1 (its _nlml_vg cache does not key on these knobs)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jprecision, "PAIR_CARRY", 2)
        mp.setenv("ANDVARANAUT_FUSED_GRAD", "2")
        jbigfit._nlml_vg.clear_cache()
        try:
            yield
        finally:
            jbigfit._nlml_vg.clear_cache()


# ---- RV / RVPack ------------------------------------------------------------

PRIORS = [("halfnormal", 1e-3), ("lognormal", 0.56, 0.75),
          ("normal", 0.3, 1.2), ("truncnormal", 0.5, 0.15, 1e-3, 100.0),
          ("uniform", -2.0, 3.0)]


@pytest.mark.parametrize("prior", PRIORS, ids=[p[0] for p in PRIORS])
def test_rvpack_parity(prior):
    rng = np.random.default_rng(3)
    spec = [("a", 2, prior), ("b", 1, ("lognormal", 0.0, 1.0))]
    jp = jun.RVPack(tuple(jun.RV(*s) for s in spec))
    tp = un.RVPack(tuple(un.RV(*s) for s in spec))
    z = rng.normal(size=3)
    jv = jp.unpack(jnp.asarray(z))
    tv = tp.unpack(_t(z))
    for k in jv:
        np.testing.assert_allclose(tv[k].numpy(), jv[k], rtol=1e-12)
    zt = _t(z).requires_grad_()
    lp = tp.log_prior(zt)
    (g,) = torch.autograd.grad(lp, zt)
    np.testing.assert_allclose(float(lp.detach()),
                               float(jp.log_prior(jnp.asarray(z))), rtol=1e-12)
    np.testing.assert_allclose(
        g.numpy(), jax.grad(jp.log_prior)(jnp.asarray(z)), rtol=1e-12,
        atol=1e-12)
    np.testing.assert_allclose(tp.z0().numpy(), jp.z0(), rtol=1e-12)
    vals = {k: np.asarray(v) for k, v in jv.items()}
    np.testing.assert_allclose(tp.pack_values(vals).numpy(),
                               jp.pack_values(vals), rtol=1e-12, atol=1e-12)


def test_build_rvs_menu():
    """The engine menu in reference order; iwgp without a wgp input
    conversion is refused."""
    from andvaranaut_torch.lhc import _none_conrev

    for truncate in (False, True):
        cfg = engine.FitConfig(
            kerns=("Matern52", "RatQuad"), ops=("+",), noise=True,
            truncate=truncate, jitter=1e-6, iwgp=False, cwgp=False,
            priors=[None] * 2, xconrevs=[_none_conrev()] * 2,
            yconrevs=[_none_conrev()], x=np.zeros((3, 2)),
            y=np.zeros((3, 1)))
        jcfg = jengine.FitConfig(**vars(cfg))
        got = engine.build_rvs(cfg)
        want = jengine.build_rvs(jcfg)
        assert [(r.name, r.size, r.prior) for r in got.rvs] == [
            (r.name, r.size, r.prior) for r in want.rvs]
    # iwgp without a wgp input conversion is refused, as the reference
    # refuses it
    cfg.iwgp = jcfg.iwgp = True
    with pytest.raises(Exception, match="iwgp set to true"):
        jengine.build_rvs(jcfg)
    with pytest.raises(Exception, match="iwgp set to true"):
        engine.build_rvs(cfg)


# ---- K4 ---------------------------------------------------------------------

def test_k4_plain_matches_reference():
    """Live tiles (rows >= row_start, cols < col_end) at the slice grade
    of the reference kernel; everything else bit-identical; an all-dead
    call leaves the carry as it was."""
    rng = np.random.default_rng(5)
    m, k, n, rs, ce = 512, 256, 768, 256, 512
    A = rng.normal(size=(m, k))
    A[:rs] = 0.0
    B = rng.normal(size=(k, n))
    B[:, ce:] = 0.0
    R = rng.normal(size=(m, n))
    Rhi, Rlo = jprecision._pair_split(jnp.asarray(R))
    nhi, nlo = pallas_slicemm.pallas_int_slice_mm_sub_pair(
        Rhi, Rlo, jnp.asarray(A), jnp.asarray(B), row_start=rs, col_end=ce)
    want = np.asarray(nhi, np.float64) + np.asarray(nlo, np.float64)
    h0 = torch.tensor(np.asarray(Rhi))
    l0 = torch.tensor(np.asarray(Rlo))
    h, lo = h0.clone(), l0.clone()
    n0 = slicemm.mm_sub_pair_.launches
    slicemm.mm_sub_pair_(h, lo, _t(A), _t(B), row_start=rs, col_end=ce)
    assert slicemm.mm_sub_pair_.launches == n0  # CPU: the plain version
    got = h.double().numpy() + lo.double().numpy()
    live = (np.arange(m)[:, None] >= rs) & (np.arange(n)[None, :] < ce)
    err = np.abs(got - want)[live].max() / np.abs(want).max()
    assert err <= 1e-12, err
    assert torch.equal(h[~torch.as_tensor(live)], h0[~torch.as_tensor(live)])
    assert torch.equal(lo[~torch.as_tensor(live)], l0[~torch.as_tensor(live)])
    slicemm.mm_sub_pair_(h, lo, _t(A), _t(B), row_start=m, col_end=ce)
    assert np.array_equal(h.double().numpy() + lo.double().numpy(), got)


# ---- K5 / K6 / K7 ------------------------------------------------------------

@pytest.fixture(scope="module")
def tri_pair():
    """A lower-triangular matrix with row-varying magnitudes as an f32
    pair, and the reference's K5 slices and scales of it at the port's
    slice count (TN_NSLICES = 8; the reference's kernels take the count
    as a parameter and default to 6)."""
    ns = slicemm.TN_NSLICES
    rng = np.random.default_rng(6)
    m = 512
    W = np.tril(rng.standard_normal((m, m)) * np.exp(rng.normal(size=(m, 1))))
    Wh = W.astype(np.float32)
    Wl = (W - Wh).astype(np.float32)
    jsl, jsb = pallas_panel.pair_to_slices_cols(jnp.asarray(Wh),
                                                jnp.asarray(Wl), nslices=ns)
    return ns, Wh, Wl, [np.asarray(s) for s in jsl], np.asarray(jsb)


def test_k5_plain_matches_reference(tri_pair):
    """Scales bit-equal to the reference's; both reconstructions within
    2^-40 of the largest scale; exact zeros stay zero.  The port's slices
    are in the tiled layout (`slicemm.tile_layout`), compared through
    `slicemm.untile_layout`."""
    ns, Wh, Wl, jsl, jsb = tri_pair
    w_sl, sW = panel.pair_to_slices_cols(torch.as_tensor(Wh),
                                         torch.as_tensor(Wl))
    assert w_sl.shape == (512 // 64, 512 // 32, ns, 2048)
    assert w_sl.dtype == torch.int8
    planes = slicemm.untile_layout(w_sl).numpy()
    assert planes.shape == (ns, 512, 512)
    assert np.array_equal(sW.numpy(), jsb.reshape(-1).astype(np.float64))
    v = Wh.astype(np.float64) + Wl
    w = [2.0 ** (-7.0 * (s + 1)) for s in range(ns)]
    rec_t = sum(planes[s].T.astype(np.float64) * w[s]
                for s in range(ns)) * sW.numpy()
    rec_j = sum(jsl[s].astype(np.float64) * w[s] for s in range(ns)) * jsb
    tol = 2.0 ** -40 * sW.numpy().max()
    assert np.abs(rec_t - v).max() < tol
    assert np.abs(rec_j - v).max() < tol
    upper = np.triu(np.ones((512, 512), bool), 1)
    assert (planes.transpose(0, 2, 1)[:, upper] == 0).all()


def test_k6_plain_matches_reference(tri_pair):
    """The port's K6 plain version on the reference's own K5 slices, in
    the port's tiled layout (`slicemm.tile_layout`), against the
    reference kernel, on lower tiles."""
    ns, _, _, jsl, jsb = tri_pair
    want = np.asarray(pallas_slicemm.pallas_int_slice_syrk_tn_lower_presliced(
        [jnp.asarray(s) for s in jsl], jnp.asarray(jsb), jnp.float64,
        w_lower=True))
    w_sl = slicemm.tile_layout(
        torch.as_tensor(np.stack([s.T for s in jsl]).copy()))
    sW = torch.as_tensor(jsb.reshape(-1).astype(np.float64))
    got = slicemm.syrk_tn_lower_presliced(w_sl, sW, w_lower=True).numpy()
    low = _lower_tiles(512)
    assert np.abs(got - want)[low].max() / np.abs(want[low]).max() <= 1e-13
    assert (got[~low] == 0.0).all()


@pytest.mark.parametrize("m", [300, 512])
def test_k7_plain_matches_reference(m):
    """Against the reference kernel at the same slice count, and against
    the f64 product at the 8-slice grade."""
    rng = np.random.default_rng(7)
    W = np.tril(rng.standard_normal((m, m)))
    want = np.asarray(pallas_slicemm.pallas_int_slice_syrk_tn_lower(
        jnp.asarray(W), nslices=slicemm.TN_NSLICES, w_lower=True))
    got = slicemm.syrk_tn_lower(_t(W), w_lower=True).numpy()
    low = _lower_tiles(m)
    assert np.abs(got - want)[low].max() / np.abs(want[low]).max() <= 1e-12
    exact = W.T @ W
    assert np.abs(got - exact)[low].max() / np.abs(exact).max() <= 1e-13


# ---- L^-1 -------------------------------------------------------------------

def test_blocked_inv_lower_matches_reference():
    """The pair-carry identity solve on the reference's own factor: a true
    inverse, an exactly zero upper triangle, and the reference's pair-path
    X to well under the slice grade."""
    rng = np.random.default_rng(8)
    n, block = 768, 256
    K = jnp.asarray(_spd(n, rng, cond=1e5) + 1e-4 * np.eye(n))
    with _fused_route():
        L, Dinv = jprecision.blocked_cholesky(K, block=block,
                                              return_inv=True)
        Xj = np.asarray(jprecision.blocked_inv_lower(L, Dinv=Dinv))
    Lt = torch.as_tensor(np.asarray(L))
    X = precision.blocked_inv_lower(Lt, torch.as_tensor(np.asarray(Dinv)))
    Xn = X.numpy()
    assert np.abs(np.eye(n) - np.tril(Lt.numpy()) @ Xn).max() <= 1e-8
    assert (np.triu(Xn, 1) == 0.0).all()
    assert np.abs(Xn - Xj).max() / np.abs(Xj).max() <= 1e-11
    hi, lo = precision.blocked_inv_lower(
        Lt, torch.as_tensor(np.asarray(Dinv)), return_pair=True)
    assert torch.equal(hi.double() + lo.double(), X)


def test_blocked_inv_lower_rejects_off_block():
    """Off the pair route, which the port once refused, L^-1 comes from
    the reference's generic identity solve: n 600 with 256-row inverses
    (n off the block: the padded substitution inverse) and n 480 at block
    96 (the blocked solve with rhs_lower).  Each a true inverse with an
    exactly zero upper triangle, within 1e-11 of the reference's from the
    same L and Dinv; return_pair gives its (hi, lo) split."""
    rng = np.random.default_rng(17)
    for n, block in ((600, 256), (480, 96)):
        L = np.linalg.cholesky(_spd(n, rng, cond=1e5) + 1e-4 * np.eye(n))
        nb = -(-n // block)
        Lp = np.eye(nb * block)
        Lp[:n, :n] = L
        Dinv = np.stack([np.linalg.inv(Lp[j * block:(j + 1) * block,
                                          j * block:(j + 1) * block])
                         for j in range(nb)])
        Xj = np.asarray(jprecision.blocked_inv_lower(
            jnp.asarray(L), Dinv=jnp.asarray(Dinv)))
        X = precision.blocked_inv_lower(_t(L), _t(Dinv))
        Xn = X.numpy()
        assert np.abs(np.eye(n) - L @ Xn).max() <= 1e-8
        assert (np.triu(Xn, 1) == 0.0).all()
        assert np.abs(Xn - Xj).max() / np.abs(Xj).max() <= 1e-11
        hi, lo = precision.blocked_inv_lower(_t(L), _t(Dinv),
                                             return_pair=True)
        h0, l0 = precision._pair_split(X)
        assert torch.equal(hi, h0) and torch.equal(lo, l0)


# ---- value + grad -------------------------------------------------------------

def _bench_data(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 2))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 + 0.01 * rng.normal(size=n)
    return X, y


def _exact_vg(X, y, z):
    """Value and gradient of the exact f64 NLML by JAX autodiff, for the
    plain RBF menu z = log(gv, l0, l1, kv)."""
    n = X.shape[0]

    def logl(zz):
        K = jkernels.gram(("RBF",), (), jnp.asarray(X), None,
                          jnp.exp(zz[1:3]), jnp.exp(zz[3:4]), None)
        K = K + (1e-6 + jnp.exp(zz[0])) * jnp.eye(n)
        return jengine.chol_nlml(K, jnp.asarray(y))

    v, g = jax.value_and_grad(logl)(jnp.asarray(z))
    return float(v), np.asarray(g)


@pytest.fixture(scope="module")
def vg_case():
    """n=512, block 256, at the reference test's hyperparameters
    (gv 1e-3, l 0.8/1.7, kv 2.5) and at a better-conditioned point (gv
    1e-2, l 0.3/0.4, kv 1), with the reference's fused-route value and
    gradient and the exact f64 ones."""
    X, y = _bench_data(512, 9)
    out = []
    for z in (np.log([1e-3, 0.8, 1.7, 2.5]), np.log([1e-2, 0.3, 0.4, 1.0])):
        with _fused_route():
            v0, g0 = jbigfit.nlml_value_and_grad(
                jnp.asarray(X), jnp.asarray(y), jnp.asarray(z), block=256)
        out.append((z, float(v0), np.asarray(g0), *_exact_vg(X, y, z)))
    return X, y, out


def test_value_and_grad_matches_fused_reference(vg_case):
    """The multi-block route (K4 -> K5 -> K6) at the reference test's
    hyperparameters, where the reference's own fused route is short of
    exact f64: its mixed value sits 2.3e-6 from it (the port's 4e-8),
    and its kv gradient entry 4.2e-4 (K^-1 = W^T W at 6 slices; the port
    runs that product at 8, slicemm.TN_NSLICES).  So the port is held to
    exact f64 autodiff, value 1e-7 and gradient rtol 1e-5, atol 1e-6,
    and to the reference within the reference's own distance from f64."""
    X, y, cases = vg_case
    z, v0, g0, vx, gx = cases[0]
    v1, g1 = bigfit.nlml_value_and_grad(X, y, z, block=256, device="cpu")
    g1 = g1.numpy()
    assert abs(float(v1) - vx) <= 1e-7 * abs(vx)
    np.testing.assert_allclose(g1, gx, rtol=1e-5, atol=1e-6)
    assert abs(float(v1) - v0) <= abs(v0 - vx) + 1e-7 * abs(vx)
    assert (np.abs(g1 - g0) <= np.abs(g0 - gx) + 1e-5 * np.abs(gx)).all()


def test_value_and_grad_matches_reference_well_conditioned(vg_case):
    """Where both factorisations sit within ~5e-9 of exact f64 (gv 1e-2),
    the value agrees with the reference's fused route to 1e-8 and the
    gradient to rtol 1e-4, atol 1e-6."""
    X, y, cases = vg_case
    z, v0, g0, vx, gx = cases[1]
    v1, g1 = bigfit.nlml_value_and_grad(X, y, z, block=256, device="cpu")
    np.testing.assert_allclose(float(v1), v0, rtol=1e-8)
    np.testing.assert_allclose(float(v1), vx, rtol=1e-8)
    np.testing.assert_allclose(g1.numpy(), g0, rtol=1e-4, atol=1e-6)


def test_value_and_grad_padded_blocks():
    """n=600 at block 256: the factorisation pads to 768 with identity
    rows and _kinv_lower pads L the same way; against exact f64 autodiff
    (value 1e-7, gradient rtol 1e-5, atol 1e-6)."""
    X, y = _bench_data(600, 13)
    z = np.log([1e-3, 0.5, 0.7, 1.0])
    vx, gx = _exact_vg(X, y, z)
    v1, g1 = bigfit.nlml_value_and_grad(X, y, z, block=256, device="cpu")
    assert abs(float(v1) - vx) <= 1e-7 * abs(vx)
    np.testing.assert_allclose(g1.numpy(), gx, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernel", ["RBF", "Matern52+RBF", "RBF*Matern32",
                                    "RatQuad"])
def test_value_and_grad_matches_autodiff(kernel):
    """n=96, one block (the K7 route), against JAX autodiff of the exact
    f64 NLML, across the kernel algebra (the grade of the reference's
    tests/test_precision.py::test_bigfit_gradients_match_autodiff)."""
    kerns, ops = kernels.parse_kernel(kernel)
    n, nx = 96, 2
    nkern = len(kerns)
    has_alpha = "RatQuad" in kerns
    rng = np.random.default_rng(10)
    X = rng.uniform(size=(n, nx))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2

    def exact_logl(z):
        gv = jnp.exp(z[0])
        l = jnp.exp(z[1:1 + nx * nkern])
        kv = jnp.exp(z[1 + nx * nkern:1 + nx * nkern + nkern])
        alpha = jnp.exp(z[1 + nx * nkern + nkern]) if has_alpha else None
        K = jkernels.gram(kerns, ops, jnp.asarray(X), None, l, kv, alpha)
        K = K + (1e-6 + gv) * jnp.eye(n)
        return jengine.chol_nlml(K, jnp.asarray(y))

    dim = 1 + nx * nkern + nkern + (1 if has_alpha else 0)
    z = np.asarray([-6.0] + [-0.5 + 0.1 * i for i in range(dim - 1)])
    v0 = float(exact_logl(jnp.asarray(z)))
    g0 = np.asarray(jax.grad(exact_logl)(jnp.asarray(z)))
    v1, g1 = bigfit.nlml_value_and_grad(X, y, z, kerns=kerns, ops=ops,
                                        device="cpu")
    np.testing.assert_allclose(float(v1), v0, rtol=1e-8)
    np.testing.assert_allclose(g1.numpy(), g0, rtol=1e-5, atol=5e-6)


def test_mixed_objective_autograd():
    """make_mixed_objective's autograd Function returns the closed-form
    gradient plus the prior's."""
    X, y = _bench_data(64, 11)
    rvpack, nlp = bigfit.make_mixed_objective(X, y, device="cpu")
    z = rvpack.z0().requires_grad_()
    val = nlp(z)
    (g,) = torch.autograd.grad(val, z)
    v1, g1 = bigfit.nlml_value_and_grad(X, y, z.detach(), rvpack=rvpack,
                                        block=256, device="cpu")
    zz = z.detach().requires_grad_()
    lp = rvpack.log_prior(zz)
    (gp,) = torch.autograd.grad(lp, zz)
    val = float(val.detach())
    assert abs(val + float(v1) + float(lp.detach())) <= 1e-12 * abs(val)
    np.testing.assert_allclose(g.numpy(), -(g1 + gp).numpy(), rtol=1e-12)


# ---- MAP fit ----------------------------------------------------------------

@pytest.mark.parametrize("kernel,truncate", [("RBF", False),
                                             ("Matern52+RBF", True)])
def test_big_map_fit_matches_reference(kernel, truncate):
    kerns, ops = kernels.parse_kernel(kernel)
    rng = np.random.default_rng(12)
    n = 80
    X = rng.uniform(size=(n, 2))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 + 0.01 * rng.normal(size=n)
    with _fused_route():
        h0, lp0 = jbigfit.big_map_fit(X, y, kerns=kerns, ops=ops,
                                      truncate=truncate)
    h1, lp1 = bigfit.big_map_fit(X, y, kerns=kerns, ops=ops,
                                 truncate=truncate, device="cpu")
    np.testing.assert_allclose(lp1, lp0, rtol=1e-6)
    np.testing.assert_allclose(h1["l"], h0["l"], rtol=1e-2)
    assert set(h1) == set(h0)
