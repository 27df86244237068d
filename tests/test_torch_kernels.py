"""Port parity, kernel modules: the plain PyTorch versions behind K1-K3
(and the Gram) against the JAX reference on the same numpy inputs.

The JAX side runs on the CPU, its Pallas kernels in interpret mode; each
reference is computed once per module.  The CUDA kernels themselves are
held to these plain versions on the card (tests/test_torch_gpu.py and
chip_smoke.py)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from andvaranaut_tpu.gp import kernels as jkernels
from andvaranaut_tpu.gp import pallas_cholinv, pallas_slicemm
from andvaranaut_tpu.gp import precision as jprecision
from andvaranaut_torch.gp import cholinv, kernels, precision, slicemm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the suite runs in parallel
    workers, and a multi-threaded intra-op pool in each oversubscribes
    the cores.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CPU = torch.device("cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _spd(n, rng, cond=1e4):
    A = rng.normal(size=(n, n))
    Q, _ = np.linalg.qr(A)
    eigs = np.logspace(0, -np.log10(cond), n)
    return (Q * eigs) @ Q.T


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(
        np.asarray(b)).max()


# ---- Gram -----------------------------------------------------------------

GRAM_SPECS = ["RBF", "Matern52", "Matern32", "Exponential", "RatQuad",
              "RBF*Matern52+RatQuad"]


@pytest.mark.parametrize("spec", GRAM_SPECS)
def test_gram_parity(spec):
    rng = np.random.default_rng(1)
    kerns, ops = kernels.parse_kernel(spec)
    nk = len(kerns)
    X = rng.uniform(size=(40, 3))
    X2 = rng.uniform(size=(25, 3))
    l = rng.uniform(0.3, 1.5, size=3 * nk)
    kv = rng.uniform(0.5, 2.0, size=nk)
    alpha = 1.7
    want = np.asarray(jkernels.gram(
        kerns, ops, jnp.asarray(X), jnp.asarray(X2), jnp.asarray(l),
        jnp.asarray(kv), jnp.asarray(alpha)))
    got = kernels.gram(kerns, ops, _t(X), _t(X2), _t(l), _t(kv),
                       torch.tensor(alpha, dtype=torch.float64)).numpy()
    assert _rel(got, want) <= 1e-13
    gd = kernels.gram(kerns, ops, _t(X), None, _t(l), _t(kv),
                      torch.tensor(alpha, dtype=torch.float64), diag=True)
    wd = jkernels.gram(kerns, ops, jnp.asarray(X), None, jnp.asarray(l),
                       jnp.asarray(kv), jnp.asarray(alpha), diag=True)
    assert _rel(gd.numpy(), wd) <= 1e-13


def test_parse_kernel_rejects_unknown():
    assert kernels.parse_kernel("RBF+Matern32") == (
        ("RBF", "Matern32"), ("+",))
    with pytest.raises(ValueError):
        kernels.parse_kernel("RBF+Linear")


# ---- slicing ----------------------------------------------------------------

def test_pow2_scales_bit_exact():
    """Row, column and sqrt scales equal the reference bit for bit,
    including values whose f32 rounding carries into the exponent."""
    rng = np.random.default_rng(2)
    A = rng.normal(size=(64, 48)) * 10.0 ** rng.integers(-30, 30, (64, 1))
    A[0, 0] = np.nextafter(2.0, 0.0)  # f32 cast rounds up to 2.0
    A[1, :] = 0.0
    for axis in (0, 1):
        want = np.asarray(jprecision._pow2_row_scales(jnp.asarray(A), axis))
        got = slicemm.pow2_row_scales(_t(A), axis).numpy()
        np.testing.assert_array_equal(got, want)
    v = np.abs(A[:, 0]) + 1e-3
    v[2] = np.nextafter(4.0, 0.0)
    np.testing.assert_array_equal(
        cholinv.pow2_sqrt_scales(_t(v)).numpy(),
        np.asarray(jprecision._pow2_sqrt_scales(jnp.asarray(v))))


def test_int_slices_bit_exact():
    rng = np.random.default_rng(3)
    A = rng.uniform(-0.5, 0.5, size=(32, 40))
    want = [np.asarray(s) for s in jprecision._int_slices(jnp.asarray(A), 6)]
    got = slicemm.int_slices(_t(A), 6).numpy()
    np.testing.assert_array_equal(got, np.stack(want))


# ---- K2 ------------------------------------------------------------------

@pytest.fixture(scope="module")
def k2_case():
    """Operands spanning 2x2 output 256-tiles with ragged edges, and the
    reference products: composed, and the Pallas kernel under each flag."""
    rng = np.random.default_rng(4)
    A = rng.normal(size=(500, 300)) * 10.0 ** rng.integers(-3, 3, (500, 1))
    B = rng.normal(size=(300, 400))
    B[:, 300:] = 0.0  # col_end's guarantee: B zero from column 300 on
    Aj, Bj = jnp.asarray(A), jnp.asarray(B)
    flags = {
        "dense": {},
        "lower_only": {"lower_only": True},
        "row_start": {"row_start": 300},
        "col_start": {"col_start": 260},
        "col_end": {"col_end": 300},
    }
    ref = {name: np.asarray(pallas_slicemm.pallas_int_slice_matmul(
        Aj, Bj, **kw)) for name, kw in flags.items()}
    comp = np.asarray(jprecision.int_slice_matmul(Aj, Bj))
    return A, B, flags, ref, comp


def test_k2_plain_vs_composed(k2_case):
    A, B, _, _, comp = k2_case
    got = precision.int_slice_matmul(_t(A), _t(B)).numpy()
    assert _rel(got, comp) <= 1e-13
    assert _rel(got, A @ B) <= 1e-10


@pytest.mark.parametrize(
    "flag", ["dense", "lower_only", "row_start", "col_start", "col_end"])
def test_k2_plain_vs_pallas_contract(k2_case, flag):
    """K2's plain version on each contract flag, against the Pallas
    kernel on the region the contract defines (rows below row_start)."""
    A, B, flags, ref, _ = k2_case
    kw = flags[flag]
    got = slicemm.slice_matmul(_t(A), _t(B), **kw).numpy()
    rows = slice((kw["row_start"] // 256) * 256, None) if "row_start" in kw \
        else slice(None)
    assert _rel(got[rows], ref[flag][rows]) <= 1e-13
    if flag != "dense":
        # skipped tiles are exact zeros, as the kernel writes them
        keep = slicemm._contract_mask(500, 400, CPU, **{
            "lower_only": False, "row_start": None, "col_start": None,
            "col_end": None, **kw}).numpy()
        assert (got[~keep] == 0.0).all()


def test_k2_compose_eight_slices():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(256, 256)) * 100.0
    B = rng.normal(size=(256, 256))
    want = np.asarray(jprecision.int_slice_matmul(
        jnp.asarray(A), jnp.asarray(B), nslices=8))
    got = precision._compose_mm(_t(A), _t(B)).numpy()
    assert _rel(got, want) <= 1e-13
    assert _rel(got, A @ B) <= 1e-14


# ---- K1 ------------------------------------------------------------------

@pytest.fixture(scope="module")
def k1_case():
    rng = np.random.default_rng(6)
    n, rs = 512, 256
    K = _spd(n, rng, cond=1e4)
    panel = rng.normal(size=(n, 256))
    panel[:rs] = 0.0
    Ahi, Alo = jprecision._pair_split(jnp.asarray(K))
    nhi, nlo = pallas_slicemm.pallas_int_slice_syrk_sub_pair(
        Ahi, Alo, jnp.asarray(panel), nslices=6, row_start=rs)
    return (n, rs, panel, np.asarray(Ahi), np.asarray(Alo),
            np.asarray(nhi), np.asarray(nlo))


def test_k1_plain_vs_pallas(k1_case):
    n, rs, panel, ahi, alo, nhi, nlo = k1_case
    hi = torch.as_tensor(ahi.copy())
    lo = torch.as_tensor(alo.copy())
    slicemm.syrk_sub_pair_(hi, lo, _t(panel), row_start=rs)
    got = hi.double().numpy() + lo.double().numpy()
    want = nhi.astype(np.float64) + nlo.astype(np.float64)
    ti = np.arange(n)[:, None] // 256
    tj = np.arange(n)[None, :] // 256
    upd = (ti >= tj) & (((tj + 1) * 256) > rs)
    assert _rel(got[upd], want[upd]) <= 1e-12
    # passthrough region is bit-exact, in both implementations
    np.testing.assert_array_equal(hi.numpy()[~upd], ahi[~upd])
    np.testing.assert_array_equal(lo.numpy()[~upd], alo[~upd])
    np.testing.assert_array_equal(nhi[~upd], ahi[~upd])
    # the result is a proper pair: lo is below half an ulp of hi
    h, l_ = hi.numpy()[upd], lo.numpy()[upd]
    assert (np.abs(l_) <= np.spacing(np.abs(h)) / 2).all()


def test_k1_all_dead():
    rng = np.random.default_rng(7)
    n = 512
    K = _spd(n, rng)
    hi, lo = precision._pair_split(_t(K))
    hi0, lo0 = hi.clone(), lo.clone()
    slicemm.syrk_sub_pair_(hi, lo, torch.zeros(n, 256, dtype=torch.float64),
                           row_start=n)
    assert torch.equal(hi, hi0) and torch.equal(lo, lo0)
    jhi, jlo = jprecision._pair_split(jnp.asarray(K))
    nhi, _ = pallas_slicemm.pallas_int_slice_syrk_sub_pair(
        jhi, jlo, jnp.zeros((n, 256)), nslices=6, row_start=n)
    np.testing.assert_array_equal(np.asarray(nhi), hi.numpy())


# ---- K3 ------------------------------------------------------------------

def _k3_blocks():
    rng = np.random.default_rng(8)
    well = {b: _spd(b, rng) + 1e-4 * np.eye(b) for b in (256, 512)}
    # ill-conditioned yet factorable (min pivot ~1e-10 on unit diagonal)
    ill = _spd(256, rng, cond=1e10)
    # singular PSD: no pivot gate can pass
    G = rng.normal(size=(256, 100))
    nonpd = G @ G.T / 100.0 - 1e-3 * np.eye(256)
    return well, ill, nonpd


@pytest.fixture(scope="module")
def k3_case():
    well, ill, nonpd = _k3_blocks()
    ref = {}
    for key, A in [(256, well[256]), (512, well[512]), ("ill", ill),
                   ("nonpd", nonpd)]:
        L, X, ok = pallas_cholinv.chol_inv_block_pair(jnp.asarray(A))
        ref[key] = (A, np.asarray(L), np.asarray(X), bool(ok))
    return ref


@pytest.mark.parametrize("b", [256, 512])
def test_k3_plain_vs_pallas(k3_case, b):
    A, Lj, Xj, okj = k3_case[b]
    L, X, ok = cholinv.chol_inv_block(_t(A))
    L, X = L.numpy(), X.numpy()
    assert okj and bool(ok)
    assert _rel(L, Lj) <= 1e-9
    assert np.abs(X @ L - np.eye(b)).max() <= 1e-7
    assert np.abs(Xj @ Lj - np.eye(b)).max() <= 1e-7
    assert (np.triu(L, 1) == 0).all() and (np.triu(X, 1) == 0).all()


@pytest.mark.parametrize("key", ["ill", "nonpd"])
def test_k3_ok_gate_matches(k3_case, key):
    A, Lj, _, okj = k3_case[key]
    L, X, ok = cholinv.chol_inv_block(_t(A))
    assert bool(ok) == okj == (key == "ill")


# K3's shared-memory budget per CTA (csrc/cholinv.cu make_plan): the
# owner's block-rows plus 9 staging blocks, 32 x 32 doubles each, plus the
# b scales and their reciprocals, within the 232,448 bytes a block may use
# beside the kernel's static bytes
_K3_SMEM = 232448 - 256


@pytest.mark.parametrize("b", [32, 128, 384, 512])
def test_k3_cluster_plan_partition(b):
    """K3's work table on the 8-CTA cluster of a single block: each
    32-row block-row of the factor and each 16-column strip of the
    inverse has exactly one owner among the cluster's CTAs; the largest
    CTA's work (a block-row's i + 1 blocks of storage and update; a
    strip of column block j, (b/32 - j)^2) is within 4/3 of the larger
    of the mean and the heaviest single item, the bound of longest-
    processing-time-first; and the largest owner's rows fit in the
    kernel's shared memory beside its staging blocks."""
    rows, strips = cholinv.cluster_plan(b)
    nb = b // 32
    assert len(rows) == nb and len(strips) == 2 * nb
    for owners, w in ((rows, [i + 1 for i in range(nb)]),
                      (strips, [(nb - s // 2) ** 2 for s in range(2 * nb)])):
        assert all(0 <= o < cholinv.CLUSTER for o in owners)
        load = [sum(wi for wi, o in zip(w, owners) if o == c)
                for c in range(cholinv.CLUSTER)]
        assert sum(load) == sum(w)
        assert max(load) <= 4 / 3 * max(sum(w) / cholinv.CLUSTER, max(w))
    most = max(sum(i + 1 for i in range(nb) if rows[i] == c)
               for c in range(cholinv.CLUSTER))
    assert ((most + 9) * 32 * 32 + 2 * b) * 8 <= _K3_SMEM


def test_chol_inv_fused_1024():
    """1024 block: 2x2 recursion over two K3 blocks and four 8-slice K2
    compose products, against the reference's fused recursion."""
    rng = np.random.default_rng(9)
    b = 1024
    K = _spd(b, rng) + 1e-4 * np.eye(b)
    Lj, Xj = jprecision._chol_inv_fused(jnp.asarray(K), 6)
    Lj, Xj = np.asarray(Lj), np.asarray(Xj)
    calls = precision._chol_fallback.calls
    L, Xt = precision._chol_inv_fused(_t(K))
    L, Xt = L.numpy(), Xt.numpy()
    assert precision._chol_fallback.calls == calls
    assert _rel(L, Lj) <= 1e-9
    assert np.abs(Xt @ L - np.eye(b)).max() <= 1e-7
    assert _rel(L @ L.T, K) <= 1e-12


def test_chol_inv_fused_1024_noise_floor():
    """A bench-like RBF block on its 1e-4 noise floor.  The reference's
    f32-pair kernel sits ~2e-8 from exact f64 here, so the port (f64
    diagonal blocks) is held to exact f64 instead."""
    rng = np.random.default_rng(9)
    b = 1024
    X = rng.uniform(size=(b, 2))
    K = kernels.gram(("RBF",), (), _t(X), None, _t([0.5, 0.7]), _t([1.0]))
    K = K + 1.01e-4 * torch.eye(b, dtype=torch.float64)
    L, Xt = precision._chol_inv_fused(K)
    L0 = torch.linalg.cholesky(K)
    assert _rel(L.numpy(), L0.numpy()) <= 1e-10
    assert np.abs((Xt @ L).numpy() - np.eye(b)).max() <= 1e-7


def test_chol_inv_fused_fallback_counts():
    """A block the pivot gate rejects (PD in f64, but a Schur pivot near
    1e-13 puts min diag(L) below 1e-6) goes to the f64 fallback, and the
    fallback counter says so."""
    rng = np.random.default_rng(10)
    G = rng.normal(size=(256, 100)) / 10.0
    A = G @ G.T + 1e-13 * np.eye(256)
    calls = precision._chol_fallback.calls
    L, X = precision._chol_inv_fused(_t(A))
    assert precision._chol_fallback.calls == calls + 1
    assert _rel(L.numpy() @ L.numpy().T, A) <= 1e-12


@pytest.mark.parametrize("route", ["presliced", "sliced"])
def test_k6_k7_chunked_contraction(route, monkeypatch):
    """K6/K7 split contractions deeper than slicemm._K_CHUNK (2^14, the
    exact int32 depth) into chunks and add each group's integer sums
    before the one f64 combine.  With the chunk lowered to 64, a small
    problem runs in 8 chunks and equals the unchunked plain result bit
    for bit.  K6 takes its slices in the tiled layout that K5 writes
    (`slicemm.tile_layout`)."""
    rng = np.random.default_rng(21)
    m = 512
    W = np.tril(rng.standard_normal((m, m))) * np.exp(
        rng.standard_normal((m, 1)))
    Wt = _t(W)
    sW = slicemm._tn_scales(Wt)
    w_sl = slicemm.tile_layout(
        slicemm.int_slices((Wt / sW).T, slicemm.TN_NSLICES)).contiguous()

    def run():
        if route == "presliced":
            return slicemm.syrk_tn_lower_presliced(w_sl, sW, w_lower=True)
        return slicemm.syrk_tn_lower(Wt, w_lower=True)

    want = run()
    monkeypatch.setattr(slicemm, "_K_CHUNK", 64)
    got = run()
    assert torch.equal(got, want)
    assert _rel(got.numpy()[np.tril(np.ones((m, m), bool))],
                (W.T @ W)[np.tril(np.ones((m, m), bool))]) <= 1e-13
