"""Port parity, serving slice: GPState conditioning and prediction on the
mixed path (forced on the CPU) against the JAX reference's exact masked
path; the package's import isolation and device rule."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import andvaranaut_torch
from andvaranaut_tpu import gpmcmc as jgpmcmc
from andvaranaut_tpu.gp import engine as jengine
from andvaranaut_torch import gpmcmc
from andvaranaut_torch.gp import engine, precision


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the suite runs in parallel
    workers, and a multi-threaded intra-op pool in each oversubscribes
    the cores.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HYPERS = {"l": np.array([0.4, 0.7]), "kv": np.array([1.3]),
          "gv": np.array(1e-3)}


def _data(n, m, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 2))
    y = np.sin(3 * X[:, 0]) + 0.2 * X[:, 1]
    return X, y, rng.uniform(size=(m, 2))


@pytest.fixture(scope="module")
def serving_case():
    """n=1000 training rows (padded to 1024), 70 queries; the reference
    prediction from the JAX exact masked path."""
    X, y, Xq = _data(1000, 70, 16)
    l, kv, gv = (jnp.asarray(HYPERS[k]) for k in ("l", "kv", "gv"))
    xin_p, yin_p, valid = jengine.pad_data(X, y, 32)
    L0, v0 = jengine.chol_state_masked(
        ("RBF",), (), xin_p, yin_p, valid, l, kv, gv, None, 1e-6)
    mu0, var0 = jengine.predict_from_chol_masked(
        ("RBF",), (), xin_p, valid, L0, v0, jnp.asarray(Xq), l, kv, gv, None)
    return X, y, Xq, np.asarray(mu0), np.asarray(var0)


def test_gpstate_mixed_predict_parity(serving_case, monkeypatch):
    """Mixed GPState at block 256 (n padded to 1024): the grade of the
    reference's mixed-conditioning test, mu rtol 1e-8, var rtol 1e-6."""
    X, y, Xq, mu0, var0 = serving_case
    monkeypatch.setattr(gpmcmc, "FORCE_MIXED", True)
    monkeypatch.setattr(gpmcmc.GPState, "MIXED_BLOCK", 256)
    monkeypatch.setattr(gpmcmc.GPState, "DEVICE", "cpu")
    st = gpmcmc.GPState(("RBF",), (), True, 1e-6, X, y, HYPERS)
    L, v, xin_p, valid, Dinv = st.chol()
    assert xin_p.shape == (1024, 2) and Dinv.shape == (4, 256, 256)
    mu, var = st.predict(Xq)
    assert mu.shape == var.shape == (70,)
    np.testing.assert_allclose(mu, mu0, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(var, var0, rtol=1e-6, atol=1e-10)


def test_mixed_variance_grade_matches_reference(monkeypatch):
    """At n=2048, block 1024, the mixed predictive variance leaves the
    1e-6 grade in the JAX reference's own mixed path as well as in the
    port: kss - |L^-1 k*|^2 cancels against the noise floor, and the
    whitened solve's 6-slice products accumulate over the block steps.
    The port stays within 1e-5 and within twice the reference's error.
    Run with -s to see the values."""
    X, y, Xq = _data(2048, 100, 17)
    l, kv, gv = (jnp.asarray(HYPERS[k]) for k in ("l", "kv", "gv"))
    xin_p, yin_p, valid = jengine.pad_data(X, y, 1024)
    L0, v0 = jengine.chol_state_masked(
        ("RBF",), (), xin_p, yin_p, valid, l, kv, gv, None, 1e-6)
    mu0, var0 = map(np.asarray, jengine.predict_from_chol_masked(
        ("RBF",), (), xin_p, valid, L0, v0, jnp.asarray(Xq), l, kv, gv,
        None))
    L1, a1, D1 = jengine.chol_state_masked_mixed(
        ("RBF",), (), xin_p, yin_p, valid, l, kv, gv, None, 1e-6,
        block=1024)
    mu1, var1 = map(np.asarray, jengine.predict_from_chol_masked_mixed(
        ("RBF",), (), xin_p, valid, L1, a1, D1, jnp.asarray(Xq), l, kv, gv,
        None))
    monkeypatch.setattr(gpmcmc, "FORCE_MIXED", True)
    monkeypatch.setattr(gpmcmc.GPState, "DEVICE", "cpu")
    st = gpmcmc.GPState(("RBF",), (), True, 1e-6, X, y, HYPERS)
    mu2, var2 = st.predict(Xq)
    ref_err = np.max(np.abs(var1 - var0) / var0)
    port_err = np.max(np.abs(var2 - var0) / var0)
    print(f"n=2048 var rel err: reference mixed {ref_err:.3e}, "
          f"port mixed {port_err:.3e}; mean rel err: reference "
          f"{np.max(np.abs(mu1 - mu0) / np.abs(mu0)):.3e}, port "
          f"{np.max(np.abs(mu2 - mu0) / np.abs(mu0)):.3e}")
    assert port_err <= 1e-5 and port_err <= 2 * ref_err
    np.testing.assert_allclose(mu2, mu0, rtol=1e-8, atol=1e-10)


def test_mixed_variance_grade_at_fitted_hypers(monkeypatch):
    """At hypers like a 16k BO refit's (standardised outputs, kv 18.5, gv
    5.9e-4: kv/gv three times the bench's), the mixed predictive
    variance's error is cancellation against kss = kv.  Held on that
    scale: max |var - var_f64| <= 1e-8 kss for the port, which also stays
    below the reference's own mixed path (elementwise and on kss); the
    mean normwise at 1e-8 (the standardised mean crosses zero).  Run with
    -s to see the values."""
    X, y, Xq = _data(2048, 100, 17)
    y = (y - y.mean()) / y.std()
    hypers = {"l": np.array([0.885, 1.5456]), "kv": np.array([18.474]),
              "gv": np.array(5.925e-4)}
    l, kv, gv = (jnp.asarray(hypers[k]) for k in ("l", "kv", "gv"))
    xin_p, yin_p, valid = jengine.pad_data(X, y, 1024)
    L0, v0 = jengine.chol_state_masked(
        ("RBF",), (), xin_p, yin_p, valid, l, kv, gv, None, 1e-6)
    mu0, var0 = map(np.asarray, jengine.predict_from_chol_masked(
        ("RBF",), (), xin_p, valid, L0, v0, jnp.asarray(Xq), l, kv, gv,
        None))
    L1, a1, D1 = jengine.chol_state_masked_mixed(
        ("RBF",), (), xin_p, yin_p, valid, l, kv, gv, None, 1e-6,
        block=1024)
    mu1, var1 = map(np.asarray, jengine.predict_from_chol_masked_mixed(
        ("RBF",), (), xin_p, valid, L1, a1, D1, jnp.asarray(Xq), l, kv, gv,
        None))
    monkeypatch.setattr(gpmcmc, "FORCE_MIXED", True)
    monkeypatch.setattr(gpmcmc.GPState, "DEVICE", "cpu")
    st = gpmcmc.GPState(("RBF",), (), True, 1e-6, X, y, hypers)
    mu2, var2 = st.predict(Xq)
    kss = float(hypers["kv"][0])
    ref_kss = np.abs(var1 - var0).max() / kss
    port_kss = np.abs(var2 - var0).max() / kss
    ref_el = np.max(np.abs(var1 - var0) / var0)
    port_el = np.max(np.abs(var2 - var0) / var0)
    print(f"fitted hypers, n=2048: var max |dvar|/kss reference mixed "
          f"{ref_kss:.3e}, port mixed {port_kss:.3e}; elementwise "
          f"reference {ref_el:.3e}, port {port_el:.3e}; mean normwise port "
          f"{np.abs(mu2 - mu0).max() / np.abs(mu0).max():.3e}")
    assert port_kss <= 1e-8 and port_kss <= ref_kss and port_el <= ref_el
    assert np.abs(mu2 - mu0).max() <= 1e-8 * np.abs(mu0).max()


def test_gpstate_exact_predict_parity(serving_case, monkeypatch):
    """Without FORCE_MIXED the exact f64 path, to f64 round-off."""
    X, y, Xq, mu0, var0 = serving_case
    monkeypatch.setattr(gpmcmc.GPState, "DEVICE", "cpu")
    st = gpmcmc.GPState(("RBF",), (), True, 1e-6, X, y, HYPERS)
    assert st.chol()[4] is None
    mu, var = st.predict(Xq)
    np.testing.assert_allclose(mu, mu0, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(var, var0, rtol=1e-10, atol=1e-12)


def test_route_is_f64_off_tpu_as_in_reference(monkeypatch):
    """The port took the mixed factorisation on CUDA at n >= 4096 where
    the reference takes it only on a TPU (`is_tpu() and n >= MIXED_N`,
    andvaranaut_tpu/gpmcmc.py:61-64, 608): a GPState on the CUDA device
    and a GPMCMC's BO conditioning at 4096 rows compute in exact f64, as
    the reference does off a TPU, unless FORCE_MIXED asks for the mixed
    route.  Only the predicates run, so no card is needed."""
    X, y, _ = _data(4096, 1, 3)
    st = gpmcmc.GPState(("RBF",), (), True, 1e-6, X, y, HYPERS,
                        device="cuda")
    ref = jgpmcmc.GPState(("RBF",), (), True, 1e-6, X, y, HYPERS)
    bo = types.SimpleNamespace(xc=X, device=torch.device("cuda"))
    assert st.device.type == "cuda"
    assert not ref._mixed()
    assert not st._mixed() and not gpmcmc.GPMCMC._bo_mixed(bo)
    assert st._bucket() == gpmcmc.GPState.BUCKET
    monkeypatch.setattr(gpmcmc, "FORCE_MIXED", True)
    assert st._mixed() and gpmcmc.GPMCMC._bo_mixed(bo)
    assert st._bucket() == gpmcmc.GPState.MIXED_BLOCK


def test_predict_query_chunks(serving_case, monkeypatch):
    """Queries beyond QCHUNK are answered chunk by chunk, tail padded."""
    X, y, Xq, mu0, var0 = serving_case
    monkeypatch.setattr(gpmcmc.GPState, "DEVICE", "cpu")
    monkeypatch.setattr(gpmcmc.GPState, "QCHUNK", 32)
    st = gpmcmc.GPState(("RBF",), (), True, 1e-6, X, y, HYPERS)
    mu, var = st.predict(Xq)
    np.testing.assert_allclose(mu, mu0, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(var, var0, rtol=1e-10, atol=1e-12)


def test_hypers_to_args():
    l, kv, gv, alpha = engine.hypers_to_args(
        {"l": np.array([0.4, 0.7]), "kv": np.float64(1.3),
         "gv": np.array(1e-3), "alpha": np.array(2.0)}, True, device="cpu")
    assert l.dtype == kv.dtype == gv.dtype == torch.float64
    assert l.shape == (2,) and kv.shape == (1,) and gv.shape == ()
    assert float(alpha) == 2.0
    _, _, gv0, a0 = engine.hypers_to_args(HYPERS, False, device="cpu")
    assert float(gv0) == 0.0 and a0 is None


def test_import_isolation():
    """Every module of the port imports: none of them pulls in JAX or the
    JAX package, nor, at import time, a package the card's machine lacks
    (cloudpickle, optax, matplotlib, seaborn, netCDF4, arviz)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import andvaranaut_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "andvaranaut_torch.__path__, 'andvaranaut_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'andvaranaut_torch.gpmcmc', 'andvaranaut_torch.gp.ops', "
        "'andvaranaut_torch.inference.de', 'andvaranaut_torch.timing'} "
        "<= set(names), names\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'andvaranaut_tpu'))]\n"
        "assert not bad, bad\n"
        "lacking = ('cloudpickle', 'optax', 'matplotlib', 'seaborn', "
        "'netCDF4', 'arviz')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in lacking]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        andvaranaut_torch.default_device()
    with pytest.raises(RuntimeError):
        engine.pad_data(np.zeros((3, 2)), np.zeros(3))
    st = gpmcmc.GPState(("RBF",), (), True, 1e-6, np.zeros((3, 2)),
                        np.zeros(3), HYPERS)
    with pytest.raises(RuntimeError):
        st.predict(np.zeros((2, 2)))
    assert andvaranaut_torch.resolve_device("cpu").type == "cpu"


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; mixed or
    unsupported inputs raise rather than fall back."""
    A = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(TypeError):
        precision.slice_matmul(A.float(), A.float())
    with pytest.raises(ValueError):
        precision.slice_matmul(A, torch.zeros((3, 4), dtype=torch.float64))
    hi = torch.zeros((256, 256))
    with pytest.raises(ValueError):
        precision.slicemm.syrk_sub_pair_(
            hi, torch.zeros((256, 255)), torch.zeros((256, 8),
                                                     dtype=torch.float64))
