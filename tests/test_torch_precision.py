"""Port parity, factorisation and NLML: the port's blocked Cholesky and
mixed NLML (plain kernel versions on the CPU) against the JAX reference
on its pair-carry path (PAIR_CARRY=2, FUSED_CHOL=2: the TPU kernel
algorithm, Pallas in interpret mode), computed once per module."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from andvaranaut_tpu.gp import engine as jengine
from andvaranaut_tpu.gp import kernels as jkernels
from andvaranaut_tpu.gp import precision as jprecision
from andvaranaut_torch.gp import engine, kernels, precision


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the suite runs in parallel
    workers, and a multi-threaded intra-op pool in each oversubscribes
    the cores.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(n, rng, cond=1e4):
    A = rng.normal(size=(n, n))
    Q, _ = np.linalg.qr(A)
    eigs = np.logspace(0, -np.log10(cond), n)
    return (Q * eigs) @ Q.T


def _kernel_problem(n, seed, noise):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 2))
    y = np.sin(3 * X[:, 0]) + 0.01 * rng.normal(size=n)
    K = np.asarray(jkernels.gram(("RBF",), (), jnp.asarray(X), None,
                                 jnp.asarray([0.5, 0.7]), jnp.asarray([1.0]),
                                 None)) + noise * np.eye(n)
    return X, y, K


@pytest.fixture(scope="module")
def chol_case():
    rng = np.random.default_rng(11)
    K = _spd(1024, rng, cond=1e6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jprecision, "PAIR_CARRY", 2)
        mp.setattr(jprecision, "FUSED_CHOL", 2)
        L, Dinv = jprecision.blocked_cholesky(
            jnp.asarray(K), block=256, return_inv=True)
    return K, np.tril(np.asarray(L)), np.asarray(Dinv)


@pytest.fixture(scope="module")
def nlml_case():
    X, y, K = _kernel_problem(768, 12, 1e-3 + 1e-6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jprecision, "PAIR_CARRY", 2)
        mp.setattr(jprecision, "FUSED_CHOL", 2)
        mixed = float(jprecision.mixed_nlml(jnp.asarray(K), jnp.asarray(y),
                                            block=256))
    exact = float(jengine.chol_nlml(jnp.asarray(K), jnp.asarray(y)))
    return X, y, K, mixed, exact


def test_blocked_cholesky_parity(chol_case):
    """The grades of the reference's pair-carry test: factor to 1e-9 of
    max|L|, diagonal-block inverses to 1e-7, reconstruction 5e-7."""
    K, Lj, Dj = chol_case
    L, Dinv = precision.blocked_cholesky(torch.as_tensor(K), block=256,
                                         return_inv=True)
    L, Dinv = L.numpy(), Dinv.numpy()
    assert Dinv.shape == Dj.shape == (4, 256, 256)
    assert np.abs(L - Lj).max() < 1e-9 * np.abs(Lj).max()
    assert np.abs(Dinv - Dj).max() < 1e-7 * np.abs(Dj).max()
    rec = np.abs(L @ L.T - K).max() / np.abs(K).max()
    assert rec < 5e-7, rec
    assert (np.triu(L, 1) == 0).all()


def test_blocked_cholesky_padded():
    """n off the block: identity padding, sliced back exactly."""
    rng = np.random.default_rng(13)
    n = 600
    K = _spd(n, rng) + 1e-6 * np.eye(n)
    L = precision.blocked_cholesky(torch.as_tensor(K), block=256).numpy()
    assert L.shape == (n, n)
    assert np.abs(L @ L.T - K).max() / np.abs(K).max() < 5e-7


def test_blocked_cholesky_rejects_off_tile_block():
    """A block off the 256 grain (128 at n 512), which the port once
    refused, now takes the f64-carry route (K8) as in the reference:
    the factor within 1e-9 of max|L| and the diagonal-block inverses
    within 1e-7 of max|Dinv| of the reference's at the same block,
    reconstruction 5e-7."""
    rng = np.random.default_rng(16)
    n, block = 512, 128
    K = _spd(n, rng) + 1e-6 * np.eye(n)
    Lj, Dj = jprecision.blocked_cholesky(jnp.asarray(K), block=block,
                                         return_inv=True)
    Lj, Dj = np.asarray(Lj), np.asarray(Dj)
    L, Dinv = precision.blocked_cholesky(torch.as_tensor(K), block=block,
                                         return_inv=True)
    L, Dinv = L.numpy(), Dinv.numpy()
    assert Dinv.shape == Dj.shape == (4, block, block)
    assert np.abs(L - Lj).max() <= 1e-9 * np.abs(Lj).max()
    assert np.abs(Dinv - Dj).max() <= 1e-7 * np.abs(Dj).max()
    assert np.abs(L @ L.T - K).max() / np.abs(K).max() < 5e-7


def test_mixed_nlml_parity(nlml_case):
    """The port's mixed NLML within 1e-6 of f64 and within 1e-8 of the
    reference's mixed value, at a 1e-3 noise floor.  (At the bench's
    1e-4 floor both mixed values sit ~1e-7 from f64 and the reference's
    own diagonal-block variants differ from each other by 2e-7, so the
    cross-implementation grade is set where the factorisation error
    does not dominate; the 1e-4 case is held to f64 below.)"""
    X, y, K, mixed_j, exact_j = nlml_case
    Kt, yt = torch.as_tensor(K), torch.as_tensor(y)
    got = float(precision.mixed_nlml(Kt, yt, block=256))
    exact = float(engine.chol_nlml(Kt, yt))
    assert abs(exact - exact_j) / abs(exact_j) < 1e-12
    assert abs(got - exact) / abs(exact) <= 1e-6, (got, exact)
    assert abs(got - mixed_j) / abs(mixed_j) <= 1e-8, (got, mixed_j)


def test_mixed_nlml_from_gram(nlml_case):
    """The bench path end to end at the bench's 1e-4 noise floor: the
    port's own Gram, noise diagonal and mixed NLML, against the
    reference's exact f64 value."""
    X, y, _, _, _ = nlml_case
    _, _, K = _kernel_problem(768, 12, 1e-4 + 1e-6)
    exact_j = float(jengine.chol_nlml(jnp.asarray(K), jnp.asarray(y)))
    Kt = kernels.gram(("RBF",), (), torch.as_tensor(X), None,
                      torch.tensor([0.5, 0.7], dtype=torch.float64),
                      torch.tensor([1.0], dtype=torch.float64))
    Kt = Kt + (1e-4 + 1e-6) * torch.eye(768, dtype=torch.float64)
    got = float(precision.mixed_nlml(Kt, torch.as_tensor(y), block=256))
    assert abs(got - exact_j) / abs(exact_j) <= 1e-6


@pytest.mark.parametrize("trans", [0, 1])
def test_blocked_solves(trans):
    """Lower and upper blocked solves, vector and matrix right-hand
    sides, through stored diagonal-block inverses."""
    rng = np.random.default_rng(14)
    n = 512
    K = _spd(n, rng) + 1e-3 * np.eye(n)
    L, Dinv = precision.blocked_cholesky(torch.as_tensor(K), block=256,
                                         return_inv=True)
    Ln = L.numpy()
    A = Ln.T if trans else Ln
    solve = (precision.blocked_solve_upper if trans
             else precision.blocked_solve_lower)
    for b in (rng.normal(size=n), rng.normal(size=(n, 40))):
        x = solve(L, torch.as_tensor(b), Dinv).numpy()
        x0 = np.linalg.solve(A, b)
        assert np.abs(x - x0).max() / np.abs(x0).max() < 1e-9


def test_tri_inv_mixed_indivisible():
    rng = np.random.default_rng(15)
    n = 300
    L = np.linalg.cholesky(_spd(n, rng) + 1e-2 * np.eye(n))
    X = precision.tri_inv_mixed(torch.as_tensor(L)).numpy()
    assert np.abs(X @ L - np.eye(n)).max() < 1e-9
