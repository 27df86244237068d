"""Port parity, the MCMC slice: host HMC, NUTS, the diagnostics, the
chain-batched objective with its batched K3 and K7, sample_model and the
facade's mcmc_* fits, against the JAX reference on the same numpy inputs.

- host_hmc is NumPy in both packages: on the same numpy objectives and
  seeds the port's draws equal the reference's, on every route, except
  where the port fixes a reference defect (each such test names it).
- NUTS cannot reproduce the JAX PRNG stream: its tests mirror the
  posterior-recovery tests of tests/test_nuts.py by name and tolerance.
- The batched objective equals the per-chain serial one bit for bit, and
  matches jax.vmap of the reference's mixed objective (Pallas kernels in
  interpret mode, PAIR_CARRY=2, FUSED_CHOL=2; computed once per module).
"""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from andvaranaut_tpu.gp import bigfit as jbigfit
from andvaranaut_tpu.gp import engine as jengine
from andvaranaut_tpu.gp import pallas_cholinv
from andvaranaut_tpu.gp import precision as jprecision
from andvaranaut_tpu.inference import host_hmc as jhmc
from andvaranaut_tpu.inference import nuts as jnuts
from andvaranaut_tpu.lhc import _none_conrev as _jnone
from andvaranaut_torch.gp import bigfit, cholinv, engine, slicemm
from andvaranaut_torch.inference import host_hmc, nuts
from andvaranaut_torch.lhc import _none_conrev


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its tests run many small torch
    ops in loops, which wait on an oversubscribed intra-op thread pool
    when the suite runs in parallel workers.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gaussian_vg(scales):
    scales = np.asarray(scales, dtype=np.float64)

    def u_vg(z):
        z = np.asarray(z)
        return 0.5 * float(np.sum((z / scales) ** 2)), z / scales ** 2

    def vec_eval(Z):
        Z = np.asarray(Z)
        return 0.5 * np.sum((Z / scales) ** 2, axis=1), Z / scales ** 2

    return u_vg, vec_eval


def _dense_vg(prec):
    prec = np.asarray(prec)

    def u_vg(z):
        z = np.asarray(z)
        return 0.5 * float(z @ prec @ z), prec @ z

    def vec_eval(Z):
        Z = np.asarray(Z)
        return 0.5 * np.einsum("ci,ij,cj->c", Z, prec, Z), Z @ prec

    return u_vg, vec_eval


def _logp(u_vec):
    """A torch log density of U(z) = z'z/2-like numpy potentials, with
    the numpy batched potential as its `vec_value_and_grad` (the sampler
    takes that for every call)."""

    def logp(z):
        raise AssertionError("the batched form is used")

    logp.vec_value_and_grad = u_vec
    return logp


def _cfg(mod, conrev, X, y):
    return mod.FitConfig(
        kerns=("RBF",), ops=(), noise=True, truncate=False, jitter=1e-6,
        iwgp=False, cwgp=False, priors=[None, None],
        xconrevs=[conrev(), conrev()], yconrevs=[conrev()], x=X,
        y=y.reshape(-1, 1))


def _gp_data(n, seed, noise=0.05):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 2))
    y = np.sin(3 * X[:, 0]) + 0.2 * X[:, 1] + noise * rng.normal(size=n)
    return X, y


# ---- host_hmc: equal draws --------------------------------------------------

SCALES = [0.05, 1.0, 5.0]
PREC = np.linalg.inv(np.array([[1.0, 0.9], [0.9, 1.0]]))
_KW = dict(num_warmup=60, num_samples=60, budget=8)
HMC_ROUTES = {
    "serial": (SCALES, dict(num_chains=2, seed=1), False),
    "batched": (SCALES, dict(num_chains=3, seed=2), True),
    "batched_chees": (SCALES, dict(num_chains=3, seed=3, adapt_tlen=True,
                                   budget=16), True),
    "pilot": (SCALES, dict(num_chains=3, seed=4, pilot=20), True),
    "serial_pilot": ([1.0, 2.0, 0.5], dict(num_chains=1, seed=5, pilot=40),
                     False),
    "inv_mass0_fixed": (SCALES, dict(num_chains=2, seed=6,
                                     inv_mass0=np.asarray(SCALES) ** 2,
                                     adapt_mass=False), False),
    "dense_mass": (PREC, dict(num_chains=3, seed=7,
                              inv_mass0="dense", adapt_mass=False), True),
    "dense_mass_serial": (PREC, dict(num_chains=1, seed=8,
                                     inv_mass0="dense", adapt_mass=False),
                          False),
    "tempering": (SCALES, dict(num_chains=4, seed=9,
                               betas=np.asarray([1.0, 1.0, 0.6, 0.36])),
                  True),
    "eps0": (SCALES, dict(num_chains=2, seed=10, eps0=0.05), True),
}


@pytest.mark.parametrize("route", list(HMC_ROUTES))
def test_host_hmc_draws_equal_reference(route):
    """The port's host_hmc keeps the reference's numpy RNG call order: on
    the same objective and seed every output is equal (an ill-scaled
    Gaussian with diagonal masses, a correlated one with the dense
    mass; serial, batched, ChEES, pilot, fixed and dense mass,
    tempering)."""
    target, kw, batched = HMC_ROUTES[route]
    kw = {**_KW, **kw}
    dense = isinstance(target, np.ndarray) and target.ndim == 2
    u_vg, vec_eval = _dense_vg(target) if dense else _gaussian_vg(target)
    dim = 2 if dense else 3
    outs = []
    for mod in (jhmc, host_hmc):
        kk = dict(kw)
        if isinstance(kk.get("inv_mass0"), str):
            kk["inv_mass0"] = mod.DenseMass(np.linalg.inv(PREC) * 0.8)
        outs.append(mod.hmc_host_sample(
            u_vg, np.zeros(dim), vec_eval=vec_eval if batched else None,
            **kk))
    ref, port = outs
    assert set(port) == set(ref)
    for key in ("z", "lp", "accept", "eps", "depth", "diverging"):
        np.testing.assert_array_equal(port[key], ref[key], err_msg=key)
    if "swap_accept" in ref:
        np.testing.assert_array_equal(port["swap_accept"],
                                      ref["swap_accept"])


def test_host_hmc_curvature_masses_equal_reference():
    """map_diag_inv_mass, its batched form and the pilot estimators equal
    the reference's."""
    u_vg, vec_eval = _gaussian_vg(SCALES)
    z = np.asarray([0.1, -0.3, 2.0])
    for args in ((u_vg, z), ):
        np.testing.assert_array_equal(host_hmc.map_diag_inv_mass(*args),
                                      jhmc.map_diag_inv_mass(*args))
    np.testing.assert_array_equal(
        host_hmc.map_diag_inv_mass_batched(vec_eval, z, 4),
        jhmc.map_diag_inv_mass_batched(vec_eval, z, 4))
    draws = np.random.default_rng(0).normal(size=(2, 50, 3))
    np.testing.assert_array_equal(host_hmc.draws_inv_mass(draws),
                                  jhmc.draws_inv_mass(draws))
    np.testing.assert_array_equal(host_hmc.draws_dense_mass(draws).cov,
                                  jhmc.draws_dense_mass(draws).cov)


def _grad_blowup_vg(nan):
    """A potential whose value stays finite (bounded, or constant) and
    whose gradient overflows the kinetic energy (1e160 per entry) or is
    NaN."""
    big = np.nan if nan else 1e160

    def u_vg(z):
        z = np.asarray(z)
        return (0.0 if nan else float(np.sum(np.tanh(z)))), np.full_like(
            z, big)

    def vec_eval(Z):
        Z = np.asarray(Z)
        u = np.zeros(Z.shape[0]) if nan else np.sum(np.tanh(Z), axis=1)
        return u, np.full_like(Z, big)

    return u_vg, vec_eval


@pytest.mark.parametrize("nan", [False, True], ids=["overflow", "nan"])
@pytest.mark.parametrize("batched", [False, True], ids=["serial", "batched"])
def test_nonfinite_kinetic_is_divergence_without_warning(nan, batched):
    """Divergence from the reference (host_hmc.py:245-248): a kinetic
    energy that overflows reached the reference as a RuntimeWarning, and
    a NaN one was neither accepted nor counted as a divergence.  The
    port counts every non-finite energy as a divergence, silently."""
    u_vg, vec_eval = _grad_blowup_vg(nan)
    kw = dict(num_warmup=3, num_samples=5, num_chains=2, budget=4, eps0=1.0,
              seed=0, adapt_mass=False, vec_eval=vec_eval if batched else None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = host_hmc.hmc_host_sample(u_vg, np.zeros(2), **kw)
    assert res["diverging"].all()
    assert (res["accept"] == 0.0).all()
    assert (res["z"] == res["z"][:, :1]).all()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        ref = jhmc.hmc_host_sample(u_vg, np.zeros(2), **kw)
    if nan:
        # the reference's NaN energy: rejected but not a divergence
        assert not ref["diverging"].all()
    else:
        assert any(issubclass(w.category, RuntimeWarning) for w in rec)


def test_adapt_tlen_one_cold_lane_warns():
    """Divergence from the reference (host_hmc.py:752-761): adapt_tlen
    with one cold lane beside hot tempering lanes fell back to uniform
    jitter without a word (its check counted all lanes).  The port warns,
    naming the cold lanes, and then samples as the reference does."""
    _, vec_eval = _gaussian_vg([1.0, 1.0])
    kw = dict(num_warmup=10, num_samples=10, num_chains=3, budget=8,
              seed=2, vec_eval=vec_eval, adapt_tlen=True,
              betas=np.asarray([1.0, 0.6, 0.36]))
    with pytest.warns(UserWarning, match="cold"):
        port = host_hmc.hmc_host_sample(None, np.zeros(2), **kw)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        ref = jhmc.hmc_host_sample(None, np.zeros(2), **kw)
    assert not any("adapt_tlen" in str(w.message) for w in rec)
    np.testing.assert_array_equal(port["z"], ref["z"])


# ---- diagnostics -------------------------------------------------------------

def test_diagnostics_match_reference():
    """split_rhat, ess_bulk and the MCMCData carrier against the
    reference's on the same draws (rtol 1e-12)."""
    rng = np.random.default_rng(4)
    z = np.cumsum(rng.normal(size=(4, 300, 3)), axis=1) * 0.05 + \
        rng.normal(size=(4, 300, 3))
    np.testing.assert_allclose(nuts.split_rhat(z), jnuts.split_rhat(z),
                               rtol=1e-12)
    np.testing.assert_allclose(nuts.ess_bulk(z), jnuts.ess_bulk(z),
                               rtol=1e-12)
    np.testing.assert_allclose(nuts.ess_bulk(z[..., 0]),
                               jnuts.ess_bulk(z[..., 0]), rtol=1e-12)
    post = {"a": z[..., 0], "b": z[..., 1:]}
    stats = {"lp": -np.sum(z ** 2, axis=-1), "diverging": z[..., 0] > 2.5}
    pd, jd = nuts.MCMCData(post, stats), jnuts.MCMCData(post, stats)
    for k, v in jd.posterior_mean().items():
        np.testing.assert_allclose(pd.posterior_mean()[k], v, rtol=1e-12)
    (pp, lpp), (jp_, lpj) = pd.max_logp_point(), jd.max_logp_point()
    assert lpp == lpj and all(np.array_equal(pp[k], jp_[k]) for k in jp_)
    for k, v in jd.rhat().items():
        np.testing.assert_allclose(pd.rhat()[k], v, rtol=1e-12)
    for k, v in jd.ess().items():
        np.testing.assert_allclose(pd.ess()[k], v, rtol=1e-12)
    assert pd.summary() == jd.summary()
    dd, dj = pd.to_dict(), jd.to_dict()
    assert dd["dims"] == dj["dims"] and set(dd["coords"]) == set(
        dj["coords"])
    out = pd.to_inference_data()
    try:
        import arviz  # noqa: F401
        assert hasattr(out, "posterior")
    except ImportError:
        assert out["posterior"]["b"].shape == (4, 300, 2)
    assert nuts.as_inference_data(None) is None


# ---- batched K3 and K7 (plain versions) ---------------------------------------

def _spd_blocks(C, b, seed, cond=1e4):
    """C SPD blocks of condition `cond` (test_torch_kernels.py's _spd)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(C):
        Q, _ = np.linalg.qr(rng.normal(size=(b, b)))
        out.append((Q * np.logspace(0, -np.log10(cond), b)) @ Q.T)
    return torch.as_tensor(np.stack(out))


@pytest.mark.parametrize("b", [128, 256])
def test_batched_k3_plain_matches_single_and_reference(b):
    """chol_inv_blocks' plain version equals chol_inv_block per block bit
    for bit, and jax.vmap(chol_inv_block_pair) (the reference's K3 under
    vmap, interpret mode, at b = 128) to the grade of
    test_k3_plain_vs_pallas."""
    A = _spd_blocks(3, b, b)
    L, X, ok = cholinv.chol_inv_blocks(A)
    assert ok.shape == (3,) and bool(ok.all())
    for c in range(3):
        l1, x1, o1 = cholinv.chol_inv_block(A[c])
        assert torch.equal(l1, L[c]) and torch.equal(x1, X[c]) and bool(o1)
    if b != 128:
        return
    Lj, Xj, okj = jax.vmap(pallas_cholinv.chol_inv_block_pair)(
        jnp.asarray(A.numpy()))
    assert np.asarray(okj).all()
    Lj, Xj = np.asarray(Lj), np.asarray(Xj)
    for c in range(3):
        assert (np.abs(L[c].numpy() - Lj[c]).max()
                <= 1e-9 * np.abs(Lj[c]).max())
        assert np.abs(X[c].numpy() @ L[c].numpy() - np.eye(b)).max() <= 1e-7
    with pytest.raises(ValueError):
        cholinv.chol_inv_blocks(A[0])


@pytest.mark.parametrize("n", [48, 256])
def test_batched_k7_plain_matches_single(n):
    """syrk_tn_lower_batched's plain version (and the batched slicing's)
    equals the single plain versions per entry bit for bit."""
    rng = np.random.default_rng(n)
    W = torch.tril(torch.as_tensor(rng.normal(size=(3, n, n))))
    C = slicemm.syrk_tn_lower_batched(W, w_lower=True)
    sl, sc = slicemm.slice_operand_batched(W.transpose(1, 2),
                                           slicemm.TN_NSLICES)
    for c in range(3):
        assert torch.equal(C[c], slicemm.syrk_tn_lower(W[c], w_lower=True))
        s1, c1 = slicemm.slice_operand(W[c].T, slicemm.TN_NSLICES)
        assert torch.equal(sl[c], s1) and torch.equal(sc[c], c1)


# ---- the batched objective ---------------------------------------------------

@pytest.mark.parametrize("n,block", [(48, 48), (256, 256), (100, 48)])
def test_batched_objective_equals_serial_bit_for_bit(n, block):
    """make_mixed_objective's vec_value_and_grad equals the serial value
    and autograd gradient of neg_log_post per chain, bit for bit: at one
    block (n <= 512, the block sample_model picks) through the batched
    K3/K7 route, at n = 100, block 48 (several blocks) chain by chain."""
    X, y = _gp_data(n, n)
    rvpack, nlp = bigfit.make_mixed_objective(X, y, block=block,
                                              device="cpu")
    rng = np.random.default_rng(1)
    Z = rvpack.z0().numpy()[None] + 0.1 + 0.05 * rng.normal(
        size=(3, rvpack.total))
    U, G = nlp.vec_value_and_grad(Z)
    for c in range(3):
        z = torch.tensor(Z[c], requires_grad=True)
        u = nlp(z)
        (g,) = torch.autograd.grad(u, z)
        assert float(u.detach()) == U[c]
        np.testing.assert_array_equal(g.numpy(), G[c])


@pytest.fixture(scope="module")
def jax_vmapped():
    """jax.vmap(jax.value_and_grad(nlp)) of the reference's mixed
    objective at n = 48 and 256 (one block each), its kernels in
    interpret mode, and the reference's exact f64 value and gradient."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jprecision, "PAIR_CARRY", 2)
        mp.setattr(jprecision, "FUSED_CHOL", 2)
        for n in (48, 256):
            X, y = _gp_data(n, n, noise=0.0)
            rvj, nlpj = jbigfit.make_mixed_objective(
                jnp.asarray(X), jnp.asarray(y), block=n)
            _, nlp0 = jengine.build_objective(_cfg(jengine, _jnone, X, y))
            rng = np.random.default_rng(n)
            Z = np.asarray(rvj.z0())[None] + 0.1 + 0.05 * rng.normal(
                size=(3, rvj.total))
            v, g = jax.jit(jax.vmap(jax.value_and_grad(nlpj)))(
                jnp.asarray(Z))
            v0, g0 = jax.vmap(jax.value_and_grad(nlp0))(jnp.asarray(Z))
            out[n] = (X, y, Z, np.asarray(v), np.asarray(g),
                      np.asarray(v0), np.asarray(g0))
    return out


@pytest.mark.parametrize("n", [48, 256])
def test_batched_objective_matches_jax_vmap(jax_vmapped, n):
    """The batched value+grad against jax.vmap of the reference's mixed
    objective: value rtol 1e-7; gradient rtol 1e-5, atol 5e-6 (the grade
    of test_mixed_objective_matches_f64), against exact f64 autodiff
    too.  At n = 256 the reference's own gradient sits up to 1e-3 from
    exact f64 (its K^-1 = W^T W at 6 slices, ROADMAP Queue 3 "gradient
    grade"; the port runs 8): there the port is held to the reference
    within the reference's distance from f64, as
    test_torch_bigfit.py::test_value_and_grad_matches_fused_reference
    does."""
    X, y, Z, v, g, v0, g0 = jax_vmapped[n]
    _, nlp = bigfit.make_mixed_objective(X, y, block=n, device="cpu")
    U, G = nlp.vec_value_and_grad(Z)
    np.testing.assert_allclose(U, v, rtol=1e-7)
    np.testing.assert_allclose(U, v0, rtol=1e-7)
    np.testing.assert_allclose(G, g0, rtol=1e-5, atol=5e-6)
    if n == 48:
        np.testing.assert_allclose(G, g, rtol=1e-5, atol=5e-6)
    else:
        assert (np.abs(G - g) <= np.abs(g - g0) + 1e-5 * np.abs(g0)
                + 5e-6).all()


def test_f64_batched_objective_matches_serial():
    """engine.build_objective's batched form (one batched Cholesky, one
    autograd pass) against its serial value and gradient per chain, and
    NaN, not an exception, where the Gram is not positive definite."""
    X, y = _gp_data(40, 3)
    rvpack, nlp = engine.build_objective(_cfg(engine, _none_conrev, X, y),
                                         device="cpu")
    rng = np.random.default_rng(2)
    Z = rvpack.z0().numpy()[None] + 0.3 * rng.normal(size=(4, rvpack.total))
    Z[3, 0] = -800.0  # gv underflows: K singular -> NaN
    Z[3, 1:] = 40.0
    U, G = nlp.vec_value_and_grad(Z)
    for c in range(3):
        z = torch.tensor(Z[c], requires_grad=True)
        u = nlp(z)
        (g,) = torch.autograd.grad(u, z)
        np.testing.assert_allclose(U[c], float(u.detach()), rtol=1e-12)
        np.testing.assert_allclose(G[c], g.numpy(), rtol=1e-10,
                                   atol=1e-12)
    assert np.isnan(U[3]) and np.isfinite(U[:3]).all()


# ---- NUTS: mirrors of tests/test_nuts.py ---------------------------------

def _run(u_vec, dim, chains=4, draws=800, tune=800, seed=0):
    return nuts.nuts_sample(
        _logp(u_vec), np.zeros(dim), seed=seed, num_warmup=tune,
        num_samples=draws, num_chains=chains, device="cpu")


def test_std_normal():
    dim = 5
    res = _run(_gaussian_vg(np.ones(dim))[1], dim)
    z = np.asarray(res["z"])  # (chains, draws, dim)
    assert z.shape == (4, 800, dim)
    assert abs(z.mean()) < 0.08
    np.testing.assert_allclose(z.reshape(-1, dim).std(axis=0),
                               np.ones(dim), atol=0.1)
    rhat = nuts.split_rhat(z.reshape(4, 800, dim))
    assert (rhat < 1.05).all(), rhat
    assert np.asarray(res["diverging"]).mean() < 0.01


def test_ill_scaled_gaussian_mass_adaptation():
    """Scales spanning 1e-2..1e1 need the diagonal mass.  Until the mass
    window closes every transition runs the full 2^10 leaves, ~10 us of
    host work each, so 2 chains warm up for 200 transitions where the
    reference test ran 4 for 1000 (the Welford window still holds 160
    draws a chain), then draw 1500 each."""
    scales = np.asarray([0.01, 0.1, 1.0, 10.0])
    res = _run(_gaussian_vg(scales)[1], 4, chains=2, draws=1500, tune=200)
    z = np.asarray(res["z"]).reshape(-1, 4)
    np.testing.assert_allclose(z.std(axis=0), scales, rtol=0.15)


def test_correlated_gaussian():
    rho = 0.9
    prec = np.linalg.inv(np.array([[1.0, rho], [rho, 1.0]]))
    res = _run(_dense_vg(prec)[1], 2, draws=1500, tune=1000, seed=3)
    z = np.asarray(res["z"]).reshape(-1, 2)
    corr = np.corrcoef(z.T)[0, 1]
    assert abs(corr - rho) < 0.05
    np.testing.assert_allclose(z.std(axis=0), [1.0, 1.0], atol=0.12)


def test_ess_and_rhat_sane():
    res = _run(_gaussian_vg(np.ones(2))[1], 2, chains=4, draws=500,
               tune=500)
    z = np.asarray(res["z"])
    ess = nuts.ess_bulk(z[..., 0])
    assert ess > 200, "NUTS on std normal should give high ESS"
    # rhat on deliberately-unmixed fake draws should flag
    rng = np.random.default_rng(0)
    fake = np.concatenate(
        [rng.normal(size=(2, 500, 1)), 5 + rng.normal(size=(2, 500, 1))])
    assert (nuts.split_rhat(fake) > 1.5).all()


def test_nuts_lockstep_batches_and_autograd_fallback():
    """Every objective call of NUTS carries the chains still building
    their trees (at most `chains` rows, all of them at the start), and a
    torch log density without a batched form runs through autograd."""
    shapes = []
    _, base = _gaussian_vg(np.ones(2))

    def vec(Z):
        shapes.append(np.asarray(Z).shape)
        return base(Z)

    nuts.nuts_sample(_logp(vec), np.zeros(2), seed=1, num_warmup=20,
                     num_samples=20, num_chains=3, device="cpu")
    assert shapes[0] == (3, 2) and max(s[0] for s in shapes) == 3
    assert all(s[1] == 2 for s in shapes)
    res = nuts.nuts_sample(lambda z: -0.5 * (z * z).sum(), np.zeros(2),
                           seed=1, num_warmup=20, num_samples=20,
                           num_chains=3, device="cpu")
    again = nuts.nuts_sample(_logp(base), np.zeros(2), seed=1,
                             num_warmup=20, num_samples=20, num_chains=3,
                             device="cpu")
    np.testing.assert_allclose(res["z"], again["z"], rtol=1e-12,
                               atol=1e-12)


def test_sampler_hmc_is_host_integrator_with_budget():
    """sampler='hmc' runs host_hmc's integrator with the budget
    2**max_treedepth leapfrogs and ChEES trajectory-length adaptation
    (adapt_tlen), the same draws as host_hmc.hmc_host_sample called so."""
    u_vg, vec = _gaussian_vg(np.ones(3))
    res = nuts.nuts_sample(_logp(vec), np.zeros(3), seed=2, num_warmup=150,
                           num_samples=300, num_chains=4, sampler="hmc",
                           max_treedepth=4, device="cpu")
    ref = host_hmc.hmc_host_sample(
        u_vg, np.zeros(3), num_warmup=150, num_samples=300, num_chains=4,
        budget=16, seed=2, adapt_tlen=True, vec_eval=vec)
    np.testing.assert_array_equal(res["z"], ref["z"])
    assert res["depth"].max() <= 16 and res["depth"].min() >= 1
    z = res["z"].reshape(-1, 3)
    assert abs(z.mean()) < 0.15
    np.testing.assert_allclose(z.std(axis=0), np.ones(3), atol=0.2)


def test_sample_model_mixed_path():
    """NUTS through the mixed objective gives the f64 path's draws on a
    small GP, draw for draw at rtol 1e-6 (the mixed NLML's value grade;
    they sit ~3e-8 apart), and so its posterior means at the reference
    test's tolerance; both take the chains in one batched call per
    leapfrog.  Cut against tests/test_nuts.py:374-376 (4 chains of 150 +
    150): 2 chains of 20 + 20.  At the reference's length the two runs'
    trajectories part (an accept decision flips) and the mixed run takes
    ~66 s on the CPU."""
    X, y = _gp_data(48, 0)
    cfg = _cfg(engine, _none_conrev, X, y)
    d0 = nuts.sample_model(cfg, draws=20, tune=20, chains=2,
                           random_seed=0, mixed=False, device="cpu")
    d1 = nuts.sample_model(cfg, draws=20, tune=20, chains=2,
                           random_seed=0, mixed=True, device="cpu")
    for k in d0.posterior:
        np.testing.assert_allclose(
            np.asarray(d1.posterior[k]), np.asarray(d0.posterior[k]),
            rtol=1e-6, err_msg=k)
    m0 = d0.posterior_mean()
    m1 = d1.posterior_mean()
    for k in m0:
        np.testing.assert_allclose(
            np.asarray(m1[k]), np.asarray(m0[k]), rtol=0.35, atol=0.05,
            err_msg=k)


def test_hmc_gp_posterior_matches_nuts():
    """The port's NUTS (exact f64 objective) agrees with the reference's
    host_hmc sampler on a GP hyperposterior, at the reference test's
    tolerance.  The reference sampler (NumPy) runs on the port's f64
    objective, which equals the reference's to ~1e-12
    (test_batched_objective_matches_jax_vmap): a jitted JAX objective
    called ~3000 times from the host dominated the suite's time.  Cut
    against tests/test_nuts.py:324-326 (4 chains of 200 + 200 for both
    samplers): NUTS runs 2 chains of 100 + 100, host_hmc the reference's
    4 of 200 + 200; two samplers give no draw-for-draw comparison."""
    X, y = _gp_data(48, 5)
    rvpack, nlp = engine.build_objective(_cfg(engine, _none_conrev, X, y),
                                         device="cpu")
    d0 = nuts.sample_model(_cfg(engine, _none_conrev, X, y), draws=100,
                           tune=100, chains=2, random_seed=0, device="cpu")
    u_and_grad, vec_eval = nuts.potential_fns(nlp, "cpu")
    res = jhmc.hmc_host_sample(
        u_and_grad, rvpack.z0().numpy(), num_warmup=200, num_samples=200,
        num_chains=4, budget=16, seed=0, vec_eval=vec_eval)
    m0 = d0.posterior_mean()
    zr = torch.as_tensor(res["z"])
    for rv, off in zip(rvpack.rvs, rvpack.offsets):
        m1 = rv.forward(zr[..., off:off + rv.size]).numpy().mean(axis=(0, 1))
        np.testing.assert_allclose(
            np.asarray(m0[rv.name]).reshape(-1), m1.reshape(-1), rtol=0.35,
            atol=0.05, err_msg=rv.name)


def test_sample_model_mcmc_block_env_override(monkeypatch):
    """ANDVARANAUT_MCMC_BLOCK overrides the mixed-objective factorisation
    block."""
    X, y = _gp_data(48, 1)
    seen = {}

    def spy(xin, yin, **kw):
        seen["block"] = kw.get("block")
        raise RuntimeError("stop")

    monkeypatch.setattr(bigfit, "make_mixed_objective", spy)
    monkeypatch.setenv("ANDVARANAUT_MCMC_BLOCK", "16")
    with pytest.raises(RuntimeError, match="stop"):
        nuts.sample_model(_cfg(engine, _none_conrev, X, y), draws=5,
                          tune=5, chains=2, random_seed=0, mixed=True,
                          device="cpu")
    assert seen["block"] == 16


def test_sample_model_mcmc_block_env_rejects_nonpositive(monkeypatch):
    """A zero/negative ANDVARANAUT_MCMC_BLOCK fails fast with a message
    naming the env knob."""
    X, y = _gp_data(16, 2)
    monkeypatch.setenv("ANDVARANAUT_MCMC_BLOCK", "0")
    with pytest.raises(ValueError, match="ANDVARANAUT_MCMC_BLOCK"):
        nuts.sample_model(_cfg(engine, _none_conrev, X, y), draws=2,
                          tune=2, chains=2, random_seed=0, mixed=True,
                          device="cpu")


def test_resolve_mcmc_block_matches_reference(monkeypatch):
    monkeypatch.delenv("ANDVARANAUT_MCMC_BLOCK", raising=False)
    for n in (16, 48, 256, 512, 513, 1000, 16384):
        assert nuts._resolve_mcmc_block(n) == jnuts._resolve_mcmc_block(n)


def test_sample_rvpack_hmc_host_gp_tempered():
    """sampler='hmc_host' through sample_rvpack on a GP hyperposterior
    (the mixed objective, chains and tempering lanes in one batched
    call): `chains` cold chains come back, finite, moving."""
    X, y = _gp_data(48, 4, noise=0.01)
    rvpack, nlp = bigfit.make_mixed_objective(X, y, block=48, device="cpu")
    calls = []
    vec = nlp.vec_value_and_grad

    def counted(Z):
        calls.append(np.asarray(Z).shape[0])
        return vec(Z)

    nlp.vec_value_and_grad = counted
    data = nuts.sample_rvpack(
        rvpack, nlp, draws=20, tune=20, chains=2, sampler="hmc_host",
        max_treedepth=3, random_seed=5, temper=2, beta_min=0.4,
        device="cpu")
    post = data.posterior
    assert post["l"].shape == (2, 20, 2)
    assert np.isfinite(data.sample_stats["lp"]).all()
    assert np.unique(post["kv"]).size > 5
    assert set(calls) == {4}


def test_temper_without_hmc_host_raises():
    """Divergence from the reference (nuts.py:1220): temper was silently
    ignored unless sampler == 'hmc_host'.  The port raises."""
    rvpack, nlp = bigfit.make_mixed_objective(*_gp_data(16, 0), block=16,
                                              device="cpu")
    for sampler in ("nuts", "hmc", None):
        with pytest.raises(ValueError, match="hmc_host"):
            nuts.sample_rvpack(rvpack, nlp, draws=2, tune=2, chains=2,
                               sampler=sampler, temper=2, device="cpu")


@pytest.mark.parametrize("beta_min", [1.0, 0.0, 1.5, -0.2])
def test_beta_min_outside_unit_interval_raises(beta_min):
    """Divergence from the reference (nuts.py:1227): beta_min was not
    validated (at beta_min=1 the call returned chains + temper chains).
    The port requires 0 < beta_min < 1."""
    rvpack, nlp = bigfit.make_mixed_objective(*_gp_data(16, 0), block=16,
                                              device="cpu")
    with pytest.raises(ValueError, match="beta_min"):
        nuts.sample_rvpack(rvpack, nlp, draws=2, tune=2, chains=2,
                           sampler="hmc_host", temper=2, beta_min=beta_min,
                           device="cpu")


def test_sample_model_entry_points():
    """Defaults off a TPU (sampler 'nuts', the exact f64 objective), the
    RVPack's constrained draws, a mesh= that is not a DeviceMesh refused,
    and an unknown sampler refused."""
    X, y = _gp_data(24, 6)
    cfg = _cfg(engine, _none_conrev, X, y)
    data = nuts.sample_model(cfg, draws=10, tune=10, chains=2,
                             random_seed=3, device="cpu")
    assert data.posterior["l"].shape == (2, 10, 2)
    assert data.posterior["gv"].shape == (2, 10)
    assert (data.posterior["gv"] > 0).all()
    assert data.sample_stats["depth"].max() <= 10
    with pytest.raises(TypeError, match="DeviceMesh"):
        nuts.sample_model(cfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="sampler"):
        nuts.sample_model(cfg, sampler="hmc_fixed", device="cpu")


def test_da_adam_matches_reference():
    """The step-size adaptation states (dual averaging and its ADAM
    variant) follow the reference's updates."""
    da, ad = nuts._da_init(0.1), nuts._da_adam_init(0.1)
    jda = jnuts._da_init(jnp.asarray(0.1))
    jad = jnuts._da_adam_init(jnp.asarray(0.1))
    for a in [0.0] * 30 + [1.0] * 30 + [0.7] * 5:
        da, ad = nuts._da_update(da, a, 0.8), nuts._da_adam_update(ad, a, 0.8)
        jda = jnuts._da_update(jda, jnp.asarray(a), 0.8)
        jad = jnuts._da_adam_update(jad, jnp.asarray(a), 0.8)
    for p, j in ((da, jda), (ad, jad)):
        np.testing.assert_allclose(np.asarray(p), [float(x) for x in j],
                                   rtol=1e-12, atol=1e-12)
