"""Port parity, the factorisation's two other routes: K8 with the f64-carry
factorisation at blocks off the 256 grain (and the value+grad and MAP fit
through it), and the fused panel stage K10 -> K11 -> K12 of the pair
carry (ANDVARANAUT_FUSED_PANEL), against the JAX reference on the same
numpy inputs.

The JAX side runs on the CPU: its Pallas kernels (the TPU's K8, K10-K12)
in interpret mode, called directly, and its factorisation off the 256
grain on its composed route, which is what the reference runs there.
The port's wrappers take their plain versions for CPU tensors; the CUDA
kernels are held to those on the card (tests/test_torch_gpu.py and
chip_smoke.py)."""

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
from andvaranaut_torch.gp import bigfit, engine, kernels, panel, precision
from andvaranaut_torch.gp import slicemm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the suite runs in parallel
    workers, and a multi-threaded intra-op pool in each oversubscribes
    the cores.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TILE = 256


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _spd(n, rng, cond=1e4):
    A = rng.normal(size=(n, n))
    Q, _ = np.linalg.qr(A)
    eigs = np.logspace(0, -np.log10(cond), n)
    return (Q * eigs) @ Q.T


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _pair(V):
    hi = V.astype(np.float32)
    return hi, (V - hi).astype(np.float32)


# ---- K8 ---------------------------------------------------------------------

K8_CASES = {"dense": {}, "row_start": {"row_start": 256},
            "all_dead": {"row_start": 768}, "a_upper": {"a_upper": True}}


@pytest.mark.parametrize("case", list(K8_CASES))
def test_k8_plain_matches_reference(case):
    """A A^T on lower tiles at m 600, k 280 (m off the tile grain), as in
    tests/test_pallas_ops.py: within 1e-13 of the Pallas kernel on the
    live tiles (the reference combines in an f32 pair, the port in f64),
    exact zeros on every tile the contract leaves unvisited."""
    kw = K8_CASES[case]
    rng = np.random.default_rng(20)
    m = 600
    A = rng.normal(size=(m, 280)) * np.exp(rng.normal(size=(m, 1)))
    rs = kw.get("row_start", 0)
    A[:rs] = 0.0
    if kw.get("a_upper"):
        A = np.triu(A)
    want = np.asarray(pallas_slicemm.pallas_int_slice_syrk_lower(
        jnp.asarray(A), row_start=jnp.int32(rs),
        a_upper=kw.get("a_upper", False)))
    got = precision.slice_syrk_lower(_t(A), row_start=kw.get("row_start"),
                                     a_upper=kw.get("a_upper", False))
    got = got.numpy()
    ti = np.arange(m)[:, None] // TILE
    tj = np.arange(m)[None, :] // TILE
    live = (ti >= tj) & ((tj + 1) * TILE > rs)
    assert got.shape == want.shape == (m, m)
    assert (got[~live] == 0.0).all()
    if live.any():
        assert _rel(got[live], want[live]) <= 1e-13
        assert _rel(got[live], (A @ A.T)[live]) <= 1e-10
    else:
        assert case == "all_dead"


@pytest.mark.parametrize("rs", [256, 300])
def test_k8_in_place_step_matches_reference(rs):
    """K8's in-place step of the f64-carry factorisation (m 600, k 280,
    rows of P above row_start zero): `syrk_sub_lower_` equals the two-step
    form it replaced, A[rs:, rs:] -= syrk_lower(P, rs)[rs:, rs:], bit for
    bit, and the reference's step, A - where(upd, K8, 0) with its
    `pallas_int_slice_syrk_lower` in interpret mode, within 1e-13 of the
    subtracted syrk on the updated entries (the reference combines in an
    f32 pair, the port in f64); every other entry is bit-identical."""
    rng = np.random.default_rng(31)
    m = 600
    P = rng.normal(size=(m, 280)) * np.exp(rng.normal(size=(m, 1)))
    P[:rs] = 0.0
    A0 = rng.normal(size=(m, m))
    got = slicemm.syrk_sub_lower_(_t(A0.copy()), _t(P), rs)
    two = _t(A0.copy())
    two[rs:, rs:] -= slicemm.syrk_lower(_t(P), row_start=rs)[rs:, rs:]
    assert torch.equal(got, two)
    Csy = np.asarray(pallas_slicemm.pallas_int_slice_syrk_lower(
        jnp.asarray(P), row_start=jnp.int32(rs)))
    ti = np.arange(m)[:, None] // TILE
    tj = np.arange(m)[None, :] // TILE
    upd = (ti >= tj) & (np.arange(m)[None, :] >= rs)
    want = A0 - np.where(upd, Csy, 0.0)
    got = got.numpy()
    mine = (np.arange(m)[:, None] >= rs) & upd
    assert np.abs(got - want)[mine].max() <= 1e-13 * np.abs(Csy[mine]).max()
    np.testing.assert_array_equal(got[~mine], A0[~mine])
    np.testing.assert_array_equal(want[~mine], A0[~mine])


# ---- K10, K11, K12 --------------------------------------------------------------

def _carry(seed, m=512):
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((m, m)) * np.exp(rng.normal(size=(m, 1)))
    return rng, _pair(V)


@pytest.mark.parametrize("lo,rs", [(0, 256), (256, 256), (0, 300)])
def test_k11_plain_matches_reference(lo, rs):
    """Slices and pow2 row scales of the carry's column block against
    pallas_panel.pair_to_slices, m 512, block 256.  The scales are equal.
    The reference slices an f32 pair, whose rounding of hi + lo can move
    a slice by 1 and the next by -128 with the same represented value;
    the port slices the exact f64 value, so a few entries (at most 1e-4 of
    them) may differ, each with the same reconstruction.  Every row's
    reconstruction is the value to 2^-40 sa
    (test_fused_panel_slices_reconstruct), and rows above row_start are
    zero slices.  The port's slices are in the tiled layout of the wgmma
    tile (`slicemm.tile_layout`) and are untiled to compare."""
    _, (Vh, Vl) = _carry(21)
    block = 256
    sl, sa = pallas_panel.pair_to_slices(jnp.asarray(Vh), jnp.asarray(Vl),
                                         lo, rs, block)
    p_sl, psa = panel.pair_to_slices(torch.as_tensor(Vh),
                                     torch.as_tensor(Vl), lo, rs, block)
    c0 = rs // TILE * TILE
    assert p_sl.shape == ((512 - c0) // 64, block // 32, slicemm.INT_NSLICES,
                          2048)
    np.testing.assert_array_equal(psa.numpy(), np.asarray(sa)[c0:, 0])
    got = slicemm.untile_layout(p_sl).numpy()
    assert not got[:, :rs - c0].any()
    want = np.stack([np.asarray(s) for s in sl])[:, rs:]
    got = got[:, rs - c0:]
    w = 2.0 ** (-7.0 * (np.arange(len(sl)) + 1))

    def rec(s):
        return np.tensordot(w, s.astype(np.float64), 1)

    diff = (got != want).any(axis=0)
    assert diff.sum() <= 1e-4 * diff.size, diff.sum()
    scale = psa.numpy()[rs - c0:, None]
    assert (np.abs(rec(got) - rec(want))[diff] <= 2.0 ** -40).all()
    v = (Vh.astype(np.float64) + Vl)[rs:, lo:lo + block]
    assert np.abs(rec(got) * scale - v).max() < 2.0 ** -40 * scale.max()


@pytest.mark.parametrize("lo,rs", [(0, 256), (256, 256), (0, 300)])
def test_k10_plain_matches_reference(lo, rs):
    """The finished panel written into the carry against
    pallas_panel.panel_into_carry (m 512, block 256): within 1e-12 of it
    on the written window (its f32-pair combine and slicing against the
    port's f64), equal bit for bit to K2's panel of the same columns
    there, and every element outside the window (rows above row_start,
    columns outside [lo, lo + block)) bit-identical to the input.  The
    reference writes the whole 256-tile that row_start 300 straddles; the
    port leaves its rows above row_start as they were."""
    rng, (Vh, Vl) = _carry(22)
    block = 256
    Linv = np.tril(rng.normal(size=(block, block)))
    h, l_ = pallas_panel.panel_into_carry(
        jnp.asarray(Vh), jnp.asarray(Vl), jnp.asarray(Linv), lo, rs, block)
    want = np.asarray(h, np.float64) + np.asarray(l_, np.float64)
    th, tl = torch.as_tensor(Vh.copy()), torch.as_tensor(Vl.copy())
    panel.panel_into_carry_(th, tl, _t(Linv), lo, rs, block)
    win = np.zeros((512, 512), bool)
    win[rs:, lo:lo + block] = True
    got = th.double().numpy() + tl.double().numpy()
    assert _rel(got[win], want[win]) <= 1e-12
    np.testing.assert_array_equal(th.numpy()[~win], Vh[~win])
    np.testing.assert_array_equal(tl.numpy()[~win], Vl[~win])
    cols = _t(Vh[:, lo:lo + block].astype(np.float64) + Vl[:, lo:lo + block])
    P = slicemm.slice_matmul(cols, _t(Linv).T)[rs:]
    ph, pl = precision._pair_split(P)
    assert torch.equal(th[rs:, lo:lo + block], ph)
    assert torch.equal(tl[rs:, lo:lo + block], pl)


def test_k12_plain_matches_reference_and_k1():
    """K12 on K11's slices against the reference's presliced kernel on the
    same slices and scales (within 1e-13 of the carry on the updated
    tiles, the rest bit-identical), and bit for bit against the port's K1
    on the same panel (the pair's value, zero above row_start).  K11's
    slices are in the tiled layout, untiled for the reference."""
    _, (Vh, Vl) = _carry(23)
    m, block, lo, rs = 512, 256, 0, 256
    p_sl, sa = panel.pair_to_slices(torch.as_tensor(Vh), torch.as_tensor(Vl),
                                    lo, rs, block)
    full = np.zeros((slicemm.INT_NSLICES, m, block), np.int8)
    full[:, rs:] = slicemm.untile_layout(p_sl).numpy()
    sa32 = np.ones((m, 1), np.float32)
    sa32[rs:, 0] = sa.numpy()
    K = _spd(m, np.random.default_rng(24))
    Kh, Kl = _pair(K)
    nh, nl = pallas_slicemm.pallas_int_slice_syrk_sub_pair_presliced(
        jnp.asarray(Kh), jnp.asarray(Kl), [jnp.asarray(s) for s in full],
        jnp.asarray(sa32), row_start=rs)
    want = np.asarray(nh, np.float64) + np.asarray(nl, np.float64)
    h1, l1 = torch.as_tensor(Kh.copy()), torch.as_tensor(Kl.copy())
    slicemm.syrk_sub_pair_presliced_(h1, l1, p_sl, sa, row_start=rs)
    got = h1.double().numpy() + l1.double().numpy()
    ti = np.arange(m)[:, None] // TILE
    tj = np.arange(m)[None, :] // TILE
    upd = (ti >= tj) & ((tj + 1) * TILE > rs)
    assert _rel(got[upd], want[upd]) <= 1e-13
    np.testing.assert_array_equal(h1.numpy()[~upd], Kh[~upd])
    P = _t(Vh[:, lo:lo + block].astype(np.float64) + Vl[:, lo:lo + block])
    P[:rs] = 0.0
    h2, l2 = torch.as_tensor(Kh.copy()), torch.as_tensor(Kl.copy())
    slicemm.syrk_sub_pair_(h2, l2, P, row_start=rs)
    assert torch.equal(h1, h2) and torch.equal(l1, l2)


# ---- path A: the f64-carry factorisation ----------------------------------------

@pytest.mark.parametrize("n,block", [(333, 128), (192, 32)])
def test_blocked_cholesky_off_grain(n, block):
    """Off the 256 grain, the port factors where it used to refuse: n 333
    at block 128 (tests/test_precision.py::test_blocked_cholesky_padding)
    and n 192 at block 32, against the reference's factor and
    diagonal-block inverses at the grades of its pair-carry parity test
    (1e-9 of max|L|, 1e-7 of max|Dinv|), reconstruction 5e-7, an exactly
    zero upper triangle."""
    K = _spd(n, np.random.default_rng(25)) + 1e-6 * np.eye(n)
    Lj, Dj = jprecision.blocked_cholesky(jnp.asarray(K), block=block,
                                         return_inv=True)
    Lj, Dj = np.asarray(Lj), np.asarray(Dj)
    L, Dinv = precision.blocked_cholesky(_t(K), block=block, return_inv=True)
    L, Dinv = L.numpy(), Dinv.numpy()
    assert Dinv.shape == Dj.shape == (-(-n // block), block, block)
    assert np.abs(L - Lj).max() <= 1e-9 * np.abs(Lj).max()
    assert np.abs(Dinv - Dj).max() <= 1e-7 * np.abs(Dj).max()
    assert np.abs(L @ L.T - K).max() / np.abs(K).max() < 5e-7
    assert (np.triu(L, 1) == 0.0).all()


def test_pcg_solve_off_grain():
    """tests/test_precision.py::test_pcg_solve_beats_refinement_floor at
    its block 32: PCG preconditioned by the f64-carry factorisation
    reaches f64 grade on a near-interpolation kernel system."""
    rng = np.random.default_rng(26)
    n = 192
    X = rng.uniform(size=(n, 2))
    K = np.asarray(jkernels.gram(("RBF",), (), jnp.asarray(X), None,
                                 jnp.asarray([0.8, 1.2]), jnp.asarray([3.0]),
                                 None)) + 2e-4 * np.eye(n)
    y = rng.normal(size=n)
    L, Dinv = precision.blocked_cholesky(_t(K), block=32, return_inv=True)
    x = precision.pcg_solve(_t(K), _t(y), L, Dinv).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(K, y), rtol=1e-8,
                               atol=1e-8)


def test_mixed_nlml_off_grain():
    """The mixed NLML at block 128 (n 500, four steps on the f64 carry)
    within 1e-6 of f64 and within 1e-8 of the reference's mixed value, on
    the 1e-3 noise floor of test_torch_precision.py's parity case."""
    rng = np.random.default_rng(27)
    n = 500
    X = rng.uniform(size=(n, 2))
    y = np.sin(3 * X[:, 0]) + 0.01 * rng.normal(size=n)
    K = np.asarray(jkernels.gram(("RBF",), (), jnp.asarray(X), None,
                                 jnp.asarray([0.5, 0.7]), jnp.asarray([1.0]),
                                 None)) + (1e-3 + 1e-6) * np.eye(n)
    mixed_j = float(jprecision.mixed_nlml(jnp.asarray(K), jnp.asarray(y),
                                          block=128))
    exact = float(engine.chol_nlml(_t(K), _t(y)))
    got = float(precision.mixed_nlml(_t(K), _t(y), block=128))
    assert abs(got - exact) / abs(exact) <= 1e-6, (got, exact)
    assert abs(got - mixed_j) / abs(mixed_j) <= 1e-8, (got, mixed_j)


@pytest.mark.parametrize("kernel", ["RBF", "Matern52+RBF"])
def test_value_and_grad_block48(kernel):
    """nlml_value_and_grad at block 48 (n 96: two f64-carry steps, the
    generic identity solve, K7), as in
    tests/test_precision.py::test_bigfit_gradients_match_autodiff: value
    rtol 1e-8, gradient rtol 1e-5, atol 5e-6, against the reference at
    the same block and against JAX autodiff of the exact f64 NLML."""
    kerns, ops = kernels.parse_kernel(kernel)
    n, nx = 96, 2
    nkern = len(kerns)
    rng = np.random.default_rng(28)
    X = rng.uniform(size=(n, nx))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2

    def exact_logl(z):
        l = jnp.exp(z[1:1 + nx * nkern])
        kv = jnp.exp(z[1 + nx * nkern:1 + nx * nkern + nkern])
        K = jkernels.gram(kerns, ops, jnp.asarray(X), None, l, kv, None)
        K = K + (1e-6 + jnp.exp(z[0])) * jnp.eye(n)
        return jengine.chol_nlml(K, jnp.asarray(y))

    dim = 1 + nx * nkern + nkern
    z = np.asarray([-6.0] + [-0.5 + 0.1 * i for i in range(dim - 1)])
    v0 = float(exact_logl(jnp.asarray(z)))
    g0 = np.asarray(jax.grad(exact_logl)(jnp.asarray(z)))
    vj, gj = jbigfit.nlml_value_and_grad(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(z), kerns=kerns, ops=ops,
        block=48)
    v1, g1 = bigfit.nlml_value_and_grad(X, y, z, kerns=kerns, ops=ops,
                                        block=48, device="cpu")
    g1 = g1.numpy()
    np.testing.assert_allclose(float(v1), v0, rtol=1e-8)
    np.testing.assert_allclose(g1, g0, rtol=1e-5, atol=5e-6)
    np.testing.assert_allclose(float(v1), float(vj), rtol=1e-8)
    np.testing.assert_allclose(g1, np.asarray(gj), rtol=1e-5, atol=5e-6)


def test_big_map_fit_block48():
    """big_map_fit at block 48 (n 80, padded to 96 on the f64 carry)
    against the reference's fit at the same block
    (tests/test_precision.py::test_bigfit_matches_engine_map's data):
    logpost rtol 1e-6, lengthscales rtol 1e-2, as
    test_torch_bigfit.py holds the on-grain fit."""
    rng = np.random.default_rng(29)
    n = 80
    X = rng.uniform(size=(n, 2))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 + 0.01 * rng.normal(size=n)
    h0, lp0 = jbigfit.big_map_fit(X, y, block=48)
    h1, lp1 = bigfit.big_map_fit(X, y, block=48, device="cpu")
    np.testing.assert_allclose(lp1, lp0, rtol=1e-6)
    np.testing.assert_allclose(h1["l"], h0["l"], rtol=1e-2)
    assert set(h1) == set(h0)


# ---- path B: the fused panel stage ------------------------------------------------

def test_fused_panel_route(monkeypatch):
    """ANDVARANAUT_FUSED_PANEL=2 runs K10 -> K11 -> K12's plain versions on
    the CPU: the factor within 1e-9 of max|L| and the diagonal-block
    inverses within 1e-7 of max|Dinv| of the unfused pair route, at n 768,
    block 256 (the grades of test_fused_panel_cholesky_parity), and the
    mixed NLML within 1e-6 of f64 (test_fused_panel_nlml_parity)."""
    rng = np.random.default_rng(30)
    n = 768
    K = _t(_spd(n, rng, cond=1e6))
    monkeypatch.setenv("ANDVARANAUT_FUSED_PANEL", "0")
    assert not panel.use_fused_panel("cpu")
    L0, D0 = precision.blocked_cholesky(K, block=256, return_inv=True)
    monkeypatch.setenv("ANDVARANAUT_FUSED_PANEL", "1")
    assert not panel.use_fused_panel("cpu")
    assert panel.use_fused_panel("cuda")
    monkeypatch.setenv("ANDVARANAUT_FUSED_PANEL", "2")
    assert panel.use_fused_panel("cpu")
    L, D = precision.blocked_cholesky(K, block=256, return_inv=True)
    assert (L - L0).abs().max() <= 1e-9 * L0.abs().max()
    assert (D - D0).abs().max() <= 1e-7 * D0.abs().max()
    Ln, Kn = L.numpy(), K.numpy()
    assert np.abs(Ln @ Ln.T - Kn).max() / np.abs(Kn).max() < 5e-7
    X = rng.uniform(size=(n, 2))
    y = torch.as_tensor(np.sin(3 * X[:, 0]) + 0.01 * rng.normal(size=n))
    Kg = kernels.gram(("RBF",), (), _t(X), None, _t([0.5, 0.7]), _t([1.0]))
    Kg = Kg + (1e-4 + 1e-6) * torch.eye(n, dtype=torch.float64)
    got = float(precision.mixed_nlml(Kg, y, block=256))
    exact = float(engine.chol_nlml(Kg, y))
    assert abs(got - exact) / abs(exact) < 1e-6, (got, exact)
