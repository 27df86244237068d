"""Plain Gaussian-process reference of the benchmark: the objective and
the predictions that the timed paths return, in one stated precision
(float64 for the benchmark, float32 for its control), written from the
textbook formulas with `torch.linalg` and elementwise operations only.

It imports nothing of the program under test and takes nothing it made:
the caller hands it the raw design, the hyperparameters from the
configuration file and the query points.

Kernels (PyMC semantics, r2 the ARD-scaled squared distance
sum_k ((x_k - x'_k) / l_k)^2, r = sqrt(r2)):

    RBF       kv exp(-r2 / 2)
    Matern52  kv (1 + sqrt(5) r + 5/3 r2) exp(-sqrt(5) r)
    Matern32  kv (1 + sqrt(3) r) exp(-sqrt(3) r)

Objective, with K = k(X, X) + (jitter + gv) I and a = K^-1 y:

    logL = -1/2 y'a - sum log diag chol(K) - n/2 log 2 pi
    d logL / d theta = sum_ij W_ij dK_ij / d theta,  W = (a a' - K^-1) / 2

over z = (log gv, log l_1 .. log l_d, log kv), so dK/dz_gv = gv I,
dK/dz_kv = k(X, X), dK/dz_lk = kv phi(r) r2_k with r2_k = ((x_k - x'_k) /
l_k)^2 and phi = -2 dk/dr2 / kv.

Prediction (pred_noise): mu = k*' K^-1 y, var = max(k** - k*' K^-1 k*, 0)
+ gv, in converted units; `revert_affine` maps them back through an
affine output conversion y_c = a + b y.
"""

from __future__ import annotations

import math

import torch

_SQ5 = math.sqrt(5.0)
_SQ3 = math.sqrt(3.0)
#: rows of the Gram held at once while the gradient is contracted
ROW_BLOCK = 2048


def _kernel(name, r2):
    """(k / kv, phi) at r2: the unit kernel and -2 d(k / kv) / dr2."""
    if name == "RBF":
        k = torch.exp(-0.5 * r2)
        return k, k
    r = torch.sqrt(r2)
    if name == "Matern52":
        e = torch.exp(-_SQ5 * r)
        return (1.0 + _SQ5 * r + (5.0 / 3.0) * r2) * e, \
            (5.0 / 3.0) * (1.0 + _SQ5 * r) * e
    if name == "Matern32":
        e = torch.exp(-_SQ3 * r)
        return (1.0 + _SQ3 * r) * e, 3.0 * e
    raise ValueError(f"the reference has no kernel {name!r}")


def _sq_parts(A, B):
    """((x_k - x'_k))^2 for each input k: (d, rows of A, rows of B)."""
    return (A[:, None, :] - B[None, :, :]).square().permute(2, 0, 1)


def gram(name, A, B, l, kv):
    """kv k(A / l, B / l) in the tensors' dtype."""
    r2 = _sq_parts(A / l, B / l).sum(0)
    return kv * _kernel(name, r2)[0]


def _as(t, dtype, device):
    return torch.as_tensor(t, dtype=dtype, device=device)


def nlml_value_and_grad(X, y, gv, l, kv, jitter, kernel, dtype=torch.float64,
                        device="cpu"):
    """(logL, d logL / dz) as float64 numpy-ready Python values: logL a
    float, the gradient a list over z = (log gv, log l, log kv).  Raises
    torch.linalg.LinAlgError where K is not positive definite in dtype."""
    X = _as(X, dtype, device)
    y = _as(y, dtype, device).reshape(-1)
    lt = _as(l, dtype, device).reshape(-1)
    n, d = X.shape
    Xs = X / lt
    K = torch.empty((n, n), dtype=dtype, device=device)
    for s in range(0, n, ROW_BLOCK):
        K[s:s + ROW_BLOCK] = kv * _kernel(
            kernel, _sq_parts(Xs[s:s + ROW_BLOCK], Xs).sum(0))[0]
    K.diagonal().add_(jitter + gv)
    L = torch.linalg.cholesky(K)
    del K
    a = torch.cholesky_solve(y[:, None], L)[:, 0]
    logl = (-0.5 * torch.dot(y, a) - torch.log(L.diagonal()).sum()
            - 0.5 * n * math.log(2.0 * math.pi))
    Kinv = torch.cholesky_inverse(L)
    del L
    g_gv = torch.zeros((), dtype=dtype, device=device)
    g_l = torch.zeros(d, dtype=dtype, device=device)
    g_kv = torch.zeros((), dtype=dtype, device=device)
    for s in range(0, n, ROW_BLOCK):
        e = min(s + ROW_BLOCK, n)
        W = 0.5 * (a[s:e, None] * a[None, :] - Kinv[s:e])
        g_gv = g_gv + gv * W.diagonal(offset=s).sum()
        parts = _sq_parts(Xs[s:e], Xs)
        k, phi = _kernel(kernel, parts.sum(0))
        g_kv = g_kv + (W * kv * k).sum()
        Wphi = W * (kv * phi)
        g_l = g_l + (Wphi[None] * parts).sum((1, 2))
    grad = torch.cat([g_gv[None], g_l, g_kv[None]])
    return float(logl), grad.double().cpu().tolist()


def condition(X, y, gv, l, kv, jitter, kernel, dtype=torch.float64,
              device="cpu"):
    """The conditioned state (X, L, L^-1 y, hyperparameters) on converted
    training data."""
    X = _as(X, dtype, device)
    y = _as(y, dtype, device).reshape(-1)
    lt = _as(l, dtype, device).reshape(-1)
    K = torch.empty((X.shape[0],) * 2, dtype=dtype, device=device)
    for s in range(0, X.shape[0], ROW_BLOCK):
        K[s:s + ROW_BLOCK] = gram(kernel, X[s:s + ROW_BLOCK], X, lt, kv)
    K.diagonal().add_(jitter + gv)
    L = torch.linalg.cholesky(K)
    del K
    v = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    return {"X": X, "L": L, "v": v, "gv": gv, "l": lt, "kv": kv,
            "kernel": kernel}


def predict(state, Xq):
    """Latent (mu, var) at converted query points, in the state's dtype
    and device."""
    X, L = state["X"], state["L"]
    Xq = _as(Xq, X.dtype, X.device)
    Ks = gram(state["kernel"], X, Xq, state["l"], state["kv"])
    A = torch.linalg.solve_triangular(L, Ks, upper=False)
    del Ks
    mu = A.T @ state["v"]
    var = torch.clamp(state["kv"] - A.square().sum(0), min=0.0) + state["gv"]
    return mu, var


def revert_affine(mu, var, a, b):
    """Mean and variance of y where y_c = a + b y is Gaussian (mu, var):
    exact for an affine conversion."""
    return (mu - a) / b, var / (b * b)
