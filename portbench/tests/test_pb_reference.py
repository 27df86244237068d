"""The plain reference against closed forms at small N, and the test
functions against their published values."""

import math

import numpy as np
import pytest
import torch

from portbench import design
from portbench.reference import conversions, gp


def _kernel_np(name, r2):
    r = np.sqrt(r2)
    if name == "RBF":
        return np.exp(-0.5 * r2)
    if name == "Matern52":
        return (1 + math.sqrt(5) * r + 5 / 3 * r2) * np.exp(-math.sqrt(5) * r)
    return (1 + math.sqrt(3) * r) * np.exp(-math.sqrt(3) * r)


def _nlml_np(X, y, z, jitter, name):
    """logL by explicit inverse and determinant (numpy)."""
    gv, l, kv = math.exp(z[0]), np.exp(z[1:-1]), math.exp(z[-1])
    D = (X[:, None, :] - X[None, :, :]) / l
    K = kv * _kernel_np(name, (D * D).sum(-1)) + (jitter + gv) * np.eye(len(y))
    sign, logdet = np.linalg.slogdet(K)
    assert sign > 0
    return (-0.5 * y @ np.linalg.inv(K) @ y - 0.5 * logdet
            - 0.5 * len(y) * math.log(2 * math.pi))


@pytest.mark.parametrize("name", ["RBF", "Matern52", "Matern32"])
def test_nlml_and_gradient_against_closed_form(name):
    rng = np.random.default_rng(3)
    n, d = 9, 3
    X = rng.uniform(size=(n, d))
    y = rng.normal(size=n)
    z = np.log([1e-2, 0.4, 0.7, 1.3, 1.5])
    e = np.exp(z)
    v, g = gp.nlml_value_and_grad(X, y, e[0], e[1:-1], e[-1], 1e-6, name)
    assert v == pytest.approx(_nlml_np(X, y, z, 1e-6, name), rel=1e-12)
    h = 1e-6
    fd = [(_nlml_np(X, y, z + h * np.eye(5)[i], 1e-6, name)
           - _nlml_np(X, y, z - h * np.eye(5)[i], 1e-6, name)) / (2 * h)
          for i in range(5)]
    np.testing.assert_allclose(g, fd, rtol=1e-6, atol=1e-8)


def test_nlml_row_blocks_do_not_change_the_result(monkeypatch):
    rng = np.random.default_rng(4)
    X, y = rng.uniform(size=(40, 2)), rng.normal(size=40)
    args = (X, y, 1e-3, [0.3, 0.6], 1.1, 1e-6, "Matern52")
    whole = gp.nlml_value_and_grad(*args)
    monkeypatch.setattr(gp, "ROW_BLOCK", 7)
    blocked = gp.nlml_value_and_grad(*args)
    assert blocked[0] == pytest.approx(whole[0], rel=1e-13)
    np.testing.assert_allclose(blocked[1], whole[1], rtol=1e-11)


def test_prediction_against_closed_form():
    rng = np.random.default_rng(5)
    X, Xq = rng.uniform(size=(12, 2)), rng.uniform(size=(5, 2))
    y = rng.normal(size=12)
    gv, l, kv, jit = 1e-3, np.array([0.5, 0.8]), 1.4, 1e-6

    def k(A, B):
        D = (A[:, None, :] - B[None, :, :]) / l
        return kv * np.exp(-0.5 * (D * D).sum(-1))

    K = k(X, X) + (jit + gv) * np.eye(12)
    Ks = k(X, Xq)
    mu = Ks.T @ np.linalg.solve(K, y)
    var = kv - np.einsum("ij,ij->j", Ks, np.linalg.solve(K, Ks)) + gv
    st = gp.condition(X, y, gv, l, kv, jit, "RBF")
    m, v = gp.predict(st, Xq)
    np.testing.assert_allclose(m.numpy(), mu, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(v.numpy(), var, rtol=1e-9)
    a, b = 0.3, 2.0
    mr, vr = gp.revert_affine(m.numpy(), v.numpy(), a, b)
    np.testing.assert_allclose(a + b * mr, m.numpy(), rtol=1e-14)
    np.testing.assert_allclose(vr * b * b, v.numpy(), rtol=1e-14)


def test_float32_reference_is_float32():
    rng = np.random.default_rng(6)
    X, y = rng.uniform(size=(30, 2)), rng.normal(size=30)
    v64, _ = gp.nlml_value_and_grad(X, y, 1e-2, [0.5, 0.5], 1.0, 1e-6, "RBF")
    v32, _ = gp.nlml_value_and_grad(X, y, 1e-2, [0.5, 0.5], 1.0, 1e-6, "RBF",
                                    dtype=torch.float32)
    assert v32 != v64 and v32 == pytest.approx(v64, rel=1e-4)


def test_conversions():
    x = np.array([[-5.0, 0.0], [10.0, 15.0], [2.5, 7.5]])
    u = conversions.uniform_inputs(x, [["uniform", -5, 10], ["uniform", 0, 15]],
                                   1e-10)
    np.testing.assert_allclose(u, [[1e-10, 1e-10], [1 - 1e-10, 1 - 1e-10],
                                   [0.5, 0.5]], atol=1e-15)
    y = np.array([1.0, 2.0, 4.0])
    a, b = conversions.meanstd(y)
    yc = a + b * y
    assert abs(yc.mean()) < 1e-15 and yc.std() == pytest.approx(1.0)


def test_branin_published_minimum():
    f = design.function("branin")
    x = np.array([[-math.pi, 12.275], [math.pi, 2.275], [9.42478, 2.475]])
    np.testing.assert_allclose(f(x), 0.397887, atol=1e-6)


def test_borehole_at_prior_centre():
    """Written out by hand at rw = 0.1, r = e^7.71, the uniform inputs'
    midpoints."""
    f = design.function("borehole")
    x = np.array([[0.1, math.exp(7.71), 89335, 1050, 89.55, 760, 1400,
                   10950]])
    lr = math.log(math.exp(7.71) / 0.1)
    want = (2 * math.pi * 89335 * 290
            / (lr * (1 + 2 * 1400 * 89335 / (lr * 0.01 * 10950)
                     + 89335 / 89.55)))
    assert f(x)[0] == pytest.approx(want, rel=1e-14)


def test_latin_hypercube_strata_and_seed():
    u = design.lhc_unit(design.seed_rng(2**31 + 5, 0), 64, 3)
    for j in range(3):
        assert sorted(np.floor(u[:, j] * 64).astype(int)) == list(range(64))
    again = design.lhc_unit(design.seed_rng(2**31 + 5, 0), 64, 3)
    np.testing.assert_array_equal(u, again)
    other = design.lhc_unit(design.seed_rng(2**31 + 6, 0), 64, 3)
    assert not np.array_equal(u, other)


def test_prior_maps_round_trip():
    u = np.linspace(0.01, 0.99, 7)
    for prior in (["uniform", 2.0, 5.0], ["normal", 0.1, 0.02],
                  ["lognormal", 7.71, 1.0056]):
        np.testing.assert_allclose(design.cdf(prior, design.ppf(prior, u)), u,
                                   rtol=1e-12)
