"""Row-sharded GP linear algebra for large training sets (counterpart of
andvaranaut_tpu/gp/sharded.py), over torch.distributed.

The reference runs `jax.shard_map` over a 1-D device mesh with axis
'data'.  Here one process runs each rank of a process group and a mesh
is a `torch.distributed.device_mesh.DeviceMesh` (`data_mesh`,
`distributed.global_data_mesh`, or the 'data' dimension of
`distributed.hierarchical_mesh`).  Every rank runs the same SPMD body on
its own block of m = N / D rows (rows padded to a multiple of D with
phantom rows that form an identity block) and meets the others in the
collectives of `distributed`:

- a block of rank k made replicated (the reference's psum of a block
  masked to rank k) is `broadcast` from k: exact, and half the traffic;
- a psum of per-rank contributions is `all_reduce`, the tiled all_gather
  `all_gather`, the psum_scatter of K^-1's products `reduce_scatter`;
- where a rank-k mask only selected which rank computes, the body
  branches on the rank instead; the results are the same.

Every rank is handed the whole (small, O(N nx)) data and slices its own
rows, so the inputs' all_gather of the reference is not needed.
Replicated outputs (values, gradients, alpha, predictions) are equal bit
for bit on every rank: they come from broadcast or all-reduced tensors
through the same operations, so host loops that run on every rank
(L-BFGS-B, HMC) step in lockstep.

Two routes:
- `make_sharded_nlml` (and `sharded_map_fit`): exact f64 with
  reverse-mode autograd through the collectives (`distributed.Chain`),
  torch.linalg.cholesky / solve_triangular as the reference's XLA ops;
  it launches no kernel.
- the closed form (`make_sharded_mixed_objective`,
  `make_sharded_warped_objective`, `make_sharded_predict`): the block-row
  factorisation `_dist_factor`, the solves, the L^-1 broadcast pipeline,
  K^-1 row blocks by reduce-scatter and the gradient contraction over
  column blocks.  mixed=True runs every diagonal factorisation through
  `precision.blocked_cholesky` (K1-K3 on the card), its inverse through
  `precision.tri_inv_mixed` (K2) and every O(N^3) product through
  `precision.slice_matmul` (K2) at 8 slices; mixed=False is exact f64.
  Where the reference's algorithm missed the single-device grade, the
  port refines as bigfit does (PANEL_REFINE, NSLICES, GRAD_INV_ITERS,
  and alpha with the quadratic form in `_closed_form_core`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import distributed as _dist
from .._config import DTYPE
from ..inference.unconstrained import RV, RVPack
from . import kernels
from .bigfit import _as_tensor

_LOG_2PI = math.log(2.0 * math.pi)
#: scipy's own L-BFGS-B ftol, which the reference's sharded fits keep
_SCIPY_FTOL = 2.220446049250313e-09
#: refinement passes of each panel block's solve through the diagonal
#: block's explicit inverse, and of the whitened solve's blocks (the
#: reference: none).  tri_inv_mixed's inverse of a large diagonal block
#: carries a residual |X L - I| ~1e-6 (n=4096 over 2 ranks, bench.py's
#: data), which a bare product puts into the panel (1.6e-6 from f64) and
#: every later Schur complement: the log-determinant sat 1.1e-2 from f64
#: there against the single-device factor's 1.3e-3.  One pass at
#: slicemm.TN_NSLICES slices (the panel, its refinement and the trailing
#: update; 6 slices left it at 4.9e-3) gives 1.1e-3; a second pass
#: changes nothing
PANEL_REFINE = 1
#: slice count of every K2 product of the mixed route (`_mixed_ops`):
#: slicemm.TN_NSLICES, as bigfit's K^-1, where the reference ran its
#: default.  At 6 slices the panels and Schur complements held the n=4096
#: log-determinant at 4.9e-3 from f64 (refined panels), and the K^-1
#: products are those of which 6 slices put bigfit's 16k gradient 0.13
#: from f64
NSLICES = 8
#: refinement passes of each L^-1 row block of the gradient pipeline
#: (bigfit's identity-solve sweeps)
GRAD_INV_ITERS = 1


class Shard(NamedTuple):
    """This rank's row block of a row-sharded array (`shard_data`)."""

    block: torch.Tensor  # this rank's rows, padded with zero rows
    rows: int            # rows of the whole array before padding


def data_mesh(devices=None, axis: str = "data", device=None):
    """1-D mesh over the ranks `devices` (global ranks; None: every rank
    of the group).  With no process group, a one-rank group on `device`
    (None: the card; `distributed.ensure_group`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    _dist.ensure_group(device)
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    return DeviceMesh(_dist._device_type(device), ranks,
                      mesh_dim_names=(axis,))


def _padded(n0: int, grain: int) -> int:
    return -(-n0 // grain) * grain


def shard_data(mesh, X, y, axis: str = "data"):
    """(Shard of X, Shard of y): this rank's row block of the data, padded
    with zero rows to a multiple of the mesh size, on the mesh's device."""
    _, d, D, dev = _dist.mesh_axis(mesh, axis)
    X = _as_tensor(X, dev)
    y = _as_tensor(y, dev).reshape(-1)
    n0 = X.shape[0]
    m = _padded(n0, D) // D
    Xp = X.new_zeros((m * D, X.shape[1]))
    Xp[:n0] = X
    yp = y.new_zeros(m * D)
    yp[:n0] = y
    return Shard(Xp[d * m:(d + 1) * m], n0), Shard(yp[d * m:(d + 1) * m], n0)


def _whole(v, group, dev):
    """The whole array from a Shard (all-gathered) or as given."""
    if isinstance(v, Shard):
        return _dist.all_gather(v.block, group)[:v.rows]
    return _as_tensor(v, dev)


def _dist_chol_quad(A, r, d, D: int, axis):
    """SPMD block-row distributed Cholesky with fused forward substitution,
    differentiable through `axis`'s collectives.

    A: (m, n) local row block of the SPD matrix (n = D m), r: (m,) local
    rhs block, d: this rank, axis: the data axis's `distributed.Chain`.
    Returns (quad, logdet) with quad =
    |L^-1 r|^2, both replicated.  At step k: Akk <- broadcast of rank
    k's diagonal block; Lkk <- chol(Akk) on every rank; the local panel
    A_dk Lkk^-T (ranks after k); the panel column all-gathered; the
    trailing update of the unfinished columns; beta_k = Lkk^-1 r_k."""
    m = A.shape[0]
    quad = A.new_zeros(())
    logdet = A.new_zeros(())
    for k in range(D):
        lo = k * m
        blk = A[:, lo:lo + m]
        Lkk = torch.linalg.cholesky(axis.broadcast(blk, k))
        rk = axis.broadcast(r, k)
        bk = torch.linalg.solve_triangular(Lkk, rk[:, None],
                                           upper=False)[:, 0]
        if d == k:
            Ldk = Lkk
        elif d > k:
            Ldk = torch.linalg.solve_triangular(Lkk, blk.T, upper=False).T
        else:
            Ldk = torch.zeros_like(blk)
        r = r - Ldk @ bk
        quad = quad + bk @ bk
        logdet = logdet + torch.log(torch.diagonal(Lkk)).sum()
        if k + 1 < D:
            panel = axis.all_gather(Ldk)  # (n, m)
            A = torch.cat([A[:, :lo + m],
                           A[:, lo + m:] - Ldk @ panel[lo + m:].T], dim=1)
    return quad, logdet


def _dist_chol_quad_cyclic(A, r, d, D: int, C: int, axis):
    """Block-CYCLIC SPMD distributed Cholesky with fused substitution,
    differentiable through `axis`.

    A: (C, mb, n), rank d's C row blocks, local slot c holding global
    block g = d + c D (n = D C mb); r: (C, mb); axis: the data axis's
    `distributed.Chain`.  Returns (quad, logdet),
    replicated, equal in exact arithmetic to `_dist_chol_quad`.  A slot
    is finished on every rank at the same step, so the local row stack
    shrinks by one slot every D steps (the trailing updates shrink with
    it)."""
    mb = A.shape[1]
    nb = D * C
    quad = A.new_zeros(())
    logdet = A.new_zeros(())
    drop = 0  # local slots removed so far
    gidx = d + D * torch.arange(C, device=A.device)
    for g in range(nb):
        o = g % D  # owning rank
        lo = g * mb
        # the owner's block g is its lowest unfinished slot: local slot 0
        Lgg = torch.linalg.cholesky(axis.broadcast(A[0][:, lo:lo + mb], o))
        rg = axis.broadcast(r[0], o)
        bg = torch.linalg.solve_triangular(Lgg, rg[:, None],
                                           upper=False)[:, 0]
        quad = quad + bg @ bg
        logdet = logdet + torch.log(torch.diagonal(Lgg)).sum()
        if g + 1 < nb:
            P = torch.linalg.solve_triangular(
                Lgg, A[:, :, lo:lo + mb].reshape(-1, mb).T,
                upper=False).T.reshape(A.shape[0], mb, mb)
            P = torch.where((gidx[drop:] > g)[:, None, None], P, 0.0)
            r = r - P @ bg
            # (D Ca, mb, mb) -> global row order: g' = d' + (c' + drop) D
            # ascends in (c', d')
            gat = axis.all_gather(P).reshape(D, -1, mb, mb)
            panel = gat.transpose(0, 1).reshape(-1, mb)
            hi = (g + 1) * mb
            A = torch.cat([A[:, :, :hi], A[:, :, hi:] - torch.einsum(
                "cik,jk->cij", P, panel[hi - drop * D * mb:])], dim=2)
            if g % D == D - 1:
                A = A[1:]
                r = r[1:]
                drop += 1
    return quad, logdet


def make_sharded_nlml(mesh, kerns, ops, noise: bool, jitter: float,
                      axis: str = "data", layout: str = "row",
                      cyc_blocks: int = 4):
    """(build_rvpack, neg_log_post): neg_log_post(z, X, y, rvpack) is the
    negative log posterior with the Gram matrix and its Cholesky
    factorisation distributed over the mesh (no rank holds the N x N
    matrix), differentiable by torch.autograd on every rank at once (the
    gradient is replicated), padded to the mesh, so any N works.  X, y:
    the whole data (array-like or tensors) or `shard_data`'s Shards.

    layout='cyclic' distributes rows block-cyclically with `cyc_blocks`
    blocks per rank (`_dist_chol_quad_cyclic`)."""
    group, d, D, dev = _dist.mesh_axis(mesh, axis)
    cyclic = layout == "cyclic"
    grain = D * cyc_blocks if cyclic else D

    def build_rvpack(nx: int):
        nkern = len(kerns)
        rvs = []
        if noise:
            rvs.append(RV("gv", 1, ("halfnormal", 1e-3)))
        rvs.append(RV("l", nx * nkern, ("lognormal", 0.0, 1.0)))
        rvs.append(RV("kv", nkern, ("lognormal", 0.56, 0.75)))
        if "RatQuad" in kerns:
            rvs.append(RV("alpha", 1, ("lognormal", 0.56, 0.75)))
        return RVPack(tuple(rvs))

    def _masked(K, grow, gcol, gvj, n0):
        """Phantom rows and columns as an identity block; the diagonal
        of the real rows gets jitter + gv."""
        real = (grow < n0)[:, None] & (gcol < n0)[None, :]
        K = torch.where(real, K, 0.0)
        eye = (grow[:, None] == gcol[None, :]).to(K.dtype)
        return K + eye * torch.where(grow < n0, gvj, 1.0)[:, None]

    def _body(X, y, l, kv, alpha, gvj, n0, chain):
        m = X.shape[0] // D
        grow = d * m + torch.arange(m, device=dev)
        gcol = torch.arange(X.shape[0], device=dev)
        K_loc = _masked(kernels.gram(kerns, ops, X[d * m:(d + 1) * m], X, l,
                                     kv, alpha), grow, gcol, gvj, n0)
        y_loc = torch.where(grow < n0, y[d * m:(d + 1) * m], 0.0)
        return _dist_chol_quad(K_loc, y_loc, d, D, chain)

    def _body_cyclic(X, y, l, kv, alpha, gvj, n0, chain):
        C = cyc_blocks
        mb = X.shape[0] // (D * C)
        gcol = torch.arange(X.shape[0], device=dev)
        K_slots, r_slots = [], []
        for c in range(C):
            g0 = (d + c * D) * mb  # first global row of this slot
            grow = g0 + torch.arange(mb, device=dev)
            K_slots.append(_masked(kernels.gram(
                kerns, ops, X[g0:g0 + mb], X, l, kv, alpha), grow, gcol,
                gvj, n0))
            r_slots.append(torch.where(grow < n0, y[g0:g0 + mb], 0.0))
        return _dist_chol_quad_cyclic(torch.stack(K_slots),
                                      torch.stack(r_slots), d, D, C, chain)

    body = _body_cyclic if cyclic else _body

    def neg_log_post(z, X, y, rvpack):
        X = _whole(X, group, dev)
        y = _whole(y, group, dev).reshape(-1)
        n0 = X.shape[0]
        npad = _padded(n0, grain)
        if npad != n0:
            X = torch.cat([X, X.new_zeros((npad - n0, X.shape[1]))])
            y = torch.cat([y, y.new_zeros(npad - n0)])
        chain = _dist.Chain(group)
        zz = chain.replicated(_as_tensor(z, dev))
        vals = rvpack.unpack(zz)
        gv = vals["gv"][0] if noise else zz.new_zeros(())
        alpha = vals["alpha"][0] if "alpha" in vals else None
        quad, logdet = body(X, y, vals["l"], vals["kv"], alpha, jitter + gv,
                            n0, chain)
        logl = -0.5 * quad - logdet - 0.5 * n0 * _LOG_2PI
        return chain.tie(-(logl + rvpack.log_prior(zz)))

    return build_rvpack, neg_log_post


# ---------------------------------------------------------------------------
# Distributed closed-form value-and-grad (the multi-rank bigfit)
# ---------------------------------------------------------------------------

def _mv(M, v):
    """Matrix-vector product (the reference's TPU-side broadcast-reduce
    form is an f64 matvec here)."""
    return M @ v


def _dist_factor(A, r, d, D: int, axis, mm, chol_inv):
    """SPMD block-row right-looking Cholesky with fused forward
    substitution (the shared core of the closed-form objective and the
    predict).

    A: (m, n) local row block of the SPD matrix, OVERWRITTEN by the
    trailing updates; r: (m,) local rhs block; d: this rank; axis: the
    data axis's process group (as in the solves below).  At step k
    rank k's diagonal block is broadcast and factorised (with its
    inverse, `chol_inv`) on every rank, since every rank needs the
    replicated beta_k, quadratic form and log-determinant; ranks after k
    form their panel block through the inverse with PANEL_REFINE
    refinement passes; the panel column is all-gathered and ranks after k
    update their trailing columns up to their own diagonal block (the
    columns right of it are never read).  The closed form takes its
    quadratic form from a refined solve instead of beta
    (`_closed_form_core`).

    Returns (L_loc, Linvs, beta, quad, logdet): the local (m, n) row
    block of L, the (D, m, m) diagonal-block inverses, beta = L^-1 r,
    |beta|^2 and the half log-determinant, the last four replicated."""
    m, n = A.shape
    dev = A.device
    L_loc = torch.zeros((m, n), dtype=A.dtype, device=dev)
    Linvs = torch.empty((D, m, m), dtype=A.dtype, device=dev)
    beta = torch.zeros(n, dtype=A.dtype, device=dev)
    quad = torch.zeros((), dtype=A.dtype, device=dev)
    logdet = torch.zeros((), dtype=A.dtype, device=dev)
    for k in range(D):
        lo, hi = k * m, (k + 1) * m
        blk = A[:, lo:hi]
        Akk = blk.clone() if d == k else torch.empty((m, m), dtype=A.dtype,
                                                     device=dev)
        Lkk, Linv_kk = chol_inv(_dist.broadcast(Akk, k, axis))
        del Akk
        rk = r.clone() if d == k else torch.empty(m, dtype=A.dtype,
                                                  device=dev)
        bk = _mv(Linv_kk, _dist.broadcast(rk, k, axis))
        Ldk = None
        if d == k:
            Ldk = Lkk
        elif d > k:
            # the panel block solves Ldk Lkk' = blk through the inverse,
            # refined: the inverse's own error would otherwise reach
            # every later Schur complement
            Ldk = mm(blk, Linv_kk.T)
            for _ in range(PANEL_REFINE):
                Ldk += mm(blk - mm(Ldk, Lkk.T), Linv_kk.T)
        if Ldk is not None:
            r = r - _mv(Ldk, bk)
            L_loc[:, lo:hi] = Ldk
        quad = quad + bk @ bk
        logdet = logdet + torch.log(torch.diagonal(Lkk)).sum()
        Linvs[k] = Linv_kk
        beta[lo:hi] = bk
        if k + 1 < D:
            panel = _dist.all_gather(
                Ldk if Ldk is not None else torch.zeros(
                    (m, m), dtype=A.dtype, device=dev), axis)
            if d > k:
                end = (d + 1) * m
                A[:, hi:end] -= mm(Ldk, panel[hi:end].T)
            del panel
    return L_loc, Linvs, beta, quad, logdet


def _dist_solve_upper_vec(L_loc, Linvs, w, d, D: int, axis):
    """Solve L^T x = w over the mesh (w, x replicated (n,) vectors): per
    step one m-vector all_reduce assembles the later ranks'
    contributions."""
    m, n = L_loc.shape
    out = torch.zeros(n, dtype=L_loc.dtype, device=L_loc.device)
    for k in range(D - 1, -1, -1):
        lo = k * m
        contrib = (_mv(L_loc[:, lo:lo + m].T, out[d * m:(d + 1) * m])
                   if d > k
                   else torch.zeros(m, dtype=L_loc.dtype,
                                    device=L_loc.device))
        s = _dist.all_reduce(contrib, axis)
        out[lo:lo + m] = _mv(Linvs[k].T, w[lo:lo + m] - s)
    return out


def _dist_solve_lower_vec(L_loc, Linvs, rhs, d, D: int, axis):
    """Solve L w = rhs over the mesh (rhs, w replicated (n,) vectors)."""
    m, n = L_loc.shape
    w = torch.zeros(n, dtype=L_loc.dtype, device=L_loc.device)
    r_loc = rhs[d * m:(d + 1) * m].clone()
    for k in range(D):
        lo = k * m
        rk = r_loc.clone() if d == k else torch.empty_like(r_loc)
        wk = _mv(Linvs[k], _dist.broadcast(rk, k, axis))
        if d > k:
            r_loc = r_loc - _mv(L_loc[:, lo:lo + m], wk)
        w[lo:lo + m] = wk
    return w


def _dist_solve_lower_ssq(L_loc, Linvs, R_loc, d, D: int, axis, mm):
    """Forward-substitute L A = R over the mesh for a matrix rhs given as
    local (m, q) row blocks, returning the column sums of squares of A
    (replicated (q,)): the whitened solve of the predictive variance.  A
    is never held beyond one (m, q) block."""
    m = L_loc.shape[0]
    q = R_loc.shape[1]
    ssq = torch.zeros(q, dtype=L_loc.dtype, device=L_loc.device)
    r = R_loc
    for k in range(D):
        lo = k * m
        if d == k:
            # rank k solves its block (refined, as the panels) and
            # broadcasts the solution: the reference broadcast r_k
            xk = mm(Linvs[k], r)
            for _ in range(PANEL_REFINE):
                xk += mm(Linvs[k], r - mm(L_loc[:, lo:lo + m], xk))
        else:
            xk = torch.empty_like(r)
        _dist.broadcast(xk, k, axis)
        if d > k:
            r = r - mm(L_loc[:, lo:lo + m], xk)
        ssq = ssq + (xk * xk).sum(0)
    return ssq


def _mixed_ops(block: int):
    """(mm, chol_inv) of the mixed route, shared by the closed-form
    objective and the predict: the diagonal factorisation by
    `precision.blocked_cholesky` (K1-K3 on the card), its inverse by
    `precision.tri_inv_mixed` at base min(block, INV_BASE) (K2), every
    product by `precision.slice_matmul` at NSLICES slices (K2)."""
    from . import precision

    def chol_inv(Akk):
        Lkk = precision.blocked_cholesky(Akk, block=block)
        return Lkk, precision.tri_inv_mixed(
            Lkk, base=min(block, precision.INV_BASE))

    def mm(a, b):
        return precision.slice_matmul(a, b, nslices=NSLICES)

    return mm, chol_inv


def _exact_ops():
    """(mm, chol_inv) of the exact f64 route."""

    def mm(a, b):
        return a @ b

    def chol_inv(Akk):
        Lkk = torch.linalg.cholesky(Akk)
        eye = torch.eye(Lkk.shape[0], dtype=Lkk.dtype, device=Lkk.device)
        return Lkk, torch.linalg.solve_triangular(Lkk, eye, upper=False)

    return mm, chol_inv


def _closed_form_core(K_loc, y_loc, z, d, D: int, axis, mm, chol_inv,
                      m: int, n: int, n0: int, gb: int, nblocks: int,
                      gram_block):
    """Stages 2-6 of the distributed closed form, shared by the fixed and
    the learnable-warping objectives:

      2. block-row factorisation (`_dist_factor`, on a copy of K_loc)
      3. alpha = K^-1 y, replicated, refined on f64 residuals of K_loc
         (precision.NLML_REFINE sweeps of the distributed solves), and the
         quadratic form y' alpha from it, as bigfit's value (the
         reference took |L^-1 y|^2 from the forward substitution: on
         bench.py's data at n=1024 over 2 ranks that put the value
         1.8e-6 from f64 where the refined one sits 8.9e-7)
      4. L^-1 row blocks by the broadcast pipeline: rank k solves
         L_kk B_k = E_k - S_k through Linv_kk with GRAD_INV_ITERS
         refinement passes (B_k is zero right of column (k+1) m) and
         broadcasts it; each later rank d adds L_dk B_k to its S_d
      5. K^-1 row blocks by reduce-scatter: rank k forms B_kc^T B_k for
         every column block c <= k (B_kc is zero for c > k), and the
         reduce-scatter lands the sum over k of row block c on rank c
      6. the gradient contraction over nblocks column blocks of width gb:
         d/dz sum(W_d o K_d(z)) with W_d = (alpha_d alpha' - Kinv_d) / 2
         against autograd of ``gram_block(zz, s, gcolB)`` (an (m, gb)
         local Gram block, the one hook the two objectives differ in),
         alpha and K^-1 held fixed, summed over ranks by all_reduce

    Returns (logl without any warping term, replicated alpha, replicated
    gradient)."""
    from . import precision

    dev = K_loc.device
    with torch.no_grad():
        y_full = _dist.all_gather(y_loc, axis)
        L_loc, Linvs, _, _, logdet = _dist_factor(
            K_loc.clone(), y_loc, d, D, axis, mm, chol_inv)
        # alpha = K^-1 y refined on f64 residuals, and the quadratic form
        # y' alpha from it (bigfit's `_logl_alpha`)
        alpha_vec = torch.zeros_like(y_full)
        for _ in range(precision.NLML_REFINE + 1):
            r = y_full - _dist.all_gather(_mv(K_loc, alpha_vec), axis)
            w = _dist_solve_lower_vec(L_loc, Linvs, r, d, D, axis)
            alpha_vec = alpha_vec + _dist_solve_upper_vec(L_loc, Linvs, w,
                                                          d, D, axis)
        del K_loc
        logl = -0.5 * (y_full @ alpha_vec) - logdet - 0.5 * n0 * _LOG_2PI

        S = torch.zeros((m, d * m), dtype=DTYPE, device=dev)
        B_loc = None
        for k in range(D):
            lo, hi = k * m, (k + 1) * m
            if d == k:
                # L_kk B_k = E_k - S_k through Linv_kk, refined as
                # bigfit's identity solve
                R = torch.zeros((m, hi), dtype=DTYPE, device=dev)
                R[:, lo:hi] = torch.eye(m, dtype=DTYPE, device=dev)
                R[:, :lo] -= S
                B_loc = mm(Linvs[k], R)
                for _ in range(GRAD_INV_ITERS):
                    B_loc += mm(Linvs[k], R - mm(L_loc[:, lo:hi], B_loc))
                del R
            if k + 1 < D:
                Bk = (B_loc if d == k else torch.empty(
                    (m, hi), dtype=DTYPE, device=dev))
                _dist.broadcast(Bk, k, axis)
                if d > k:
                    S[:, :hi] += mm(L_loc[:, lo:hi], Bk)
                del Bk
        del S, L_loc, Linvs

        w = (d + 1) * m
        prods = torch.zeros((D, m, n), dtype=DTYPE, device=dev)
        for c in range(d + 1):
            prods[c, :, :w] = mm(B_loc[:, c * m:(c + 1) * m].T, B_loc)
        del B_loc
        Kinv_loc = _dist.reduce_scatter(prods, axis)
        del prods

        grow = d * m + torch.arange(m, device=dev)
        a_loc = alpha_vec[d * m:(d + 1) * m]
        real_row = grow < n0
    grad = torch.zeros_like(z)
    for s in range(0, nblocks * gb, gb):
        with torch.no_grad():
            gcolB = s + torch.arange(gb, device=dev)
            WB = torch.where(
                real_row[:, None] & (gcolB < n0)[None, :],
                0.5 * (a_loc[:, None] * alpha_vec[None, s:s + gb]
                       - Kinv_loc[:, s:s + gb]), 0.0)
        with torch.enable_grad():
            zz = z.detach().requires_grad_()
            h = (WB * gram_block(zz, s, gcolB)).sum()
            grad += torch.autograd.grad(h, zz)[0]
    del Kinv_loc
    return logl, alpha_vec, _dist.all_reduce(grad, axis)


def _wrap_neg_log_post(rvpack, value_and_grad):
    """Scalar objective off a (logl, grad) pair (the host L-BFGS / MCMC
    contract shared by every sharded objective): an autograd Function
    whose forward computes value and gradient together and whose backward
    returns the saved gradient times the cotangent (the reference's
    custom VJP).  It runs collectives itself, so it carries
    `runs_collectives`: the samplers never split its chains over the
    ranks, which already share every evaluation."""

    class _LogL(torch.autograd.Function):
        @staticmethod
        def forward(ctx, z):
            val, grad = value_and_grad(z)
            ctx.save_for_backward(grad.to(z.device))
            return val.to(z.device)

        @staticmethod
        def backward(ctx, ct):
            (grad,) = ctx.saved_tensors
            return ct * grad

    def neg_log_post(z):
        return -(_LogL.apply(z) + rvpack.log_prior(z))

    neg_log_post.runs_collectives = True
    return neg_log_post


def _grad_block_width(grad_block: int, n: int) -> int:
    """The gradient's column-block width: grad_block halved until it
    divides n."""
    gb = min(grad_block, n)
    while n % gb:
        gb //= 2
    return gb


def make_sharded_mixed_objective(mesh, X, y, kerns=("RBF",), ops=(),
                                 noise: bool = True, truncate: bool = False,
                                 jitter: float = 1e-6, block: int = 256,
                                 grad_block: int = 2048, mixed: bool = True,
                                 axis: str = "data"):
    """(rvpack, neg_log_post, value_and_grad) with the whole closed-form
    NLML gradient pipeline distributed over the mesh, the multi-rank
    counterpart of bigfit.make_mixed_objective: no rank holds an N x N
    matrix (`_closed_form_core`).

    value_and_grad(z) -> (logl, d logl / dz), tensors on the mesh's
    device, replicated bit for bit; neg_log_post(z) is differentiable by
    autograd (`_wrap_neg_log_post`).  mixed=True runs the factorisations
    and products through the kernels (`_mixed_ops`), mixed=False in exact
    f64 (`_exact_ops`).  Every rank must call them together.
    `value_and_grad.calls` counts the evaluations."""
    from . import bigfit

    group, d, D, dev = _dist.mesh_axis(mesh, axis)
    X = _as_tensor(X, dev)
    y1 = _as_tensor(y, dev).reshape(-1)
    kerns = tuple(kerns)
    ops = tuple(ops)
    has_alpha = "RatQuad" in kerns
    nx = X.shape[1]
    rvpack = bigfit._default_rvpack(nx, kerns, noise, truncate)
    n0 = X.shape[0]
    n = _padded(n0, D)
    m = n // D
    Xp = X.new_zeros((n, nx))
    Xp[:n0] = X
    yp = y1.new_zeros(n)
    yp[:n0] = y1
    gb = _grad_block_width(grad_block, n)
    mm, chol_inv = _mixed_ops(block) if mixed else _exact_ops()
    X_loc = Xp[d * m:(d + 1) * m]
    grow = d * m + torch.arange(m, device=dev)
    gcol = torch.arange(n, device=dev)
    y_loc = torch.where(grow < n0, yp[d * m:(d + 1) * m], 0.0)

    def _gram_rows(z, X_cols, gcol_):
        """Local Gram rows of K(z) against X_cols, with the phantom
        identity block and the (jitter + gv) diagonal."""
        vals = rvpack.unpack(z)
        gv = vals["gv"][0] if noise else z.new_zeros(())
        al = vals["alpha"][0] if has_alpha else None
        K = kernels.gram(kerns, ops, X_loc, X_cols, vals["l"], vals["kv"],
                         al)
        real = (grow < n0)[:, None] & (gcol_ < n0)[None, :]
        K = torch.where(real, K, 0.0)
        diag = (grow[:, None] == gcol_[None, :]).to(K.dtype)
        return K + diag * torch.where((grow < n0)[:, None], jitter + gv,
                                      1.0)

    def gram_block(zz, s, gcolB):
        return _gram_rows(zz, Xp[s:s + gb], gcolB)

    def value_and_grad(z):
        """(logl, d logl / dz), both replicated."""
        value_and_grad.calls += 1
        z = _as_tensor(z, dev)
        with torch.no_grad():
            K_loc = _gram_rows(z, Xp, gcol)
        logl, _, grad = _closed_form_core(
            K_loc, y_loc, z, d, D, group, mm, chol_inv, m, n, n0, gb,
            n // gb, gram_block)
        return logl, grad

    value_and_grad.calls = 0
    return rvpack, _wrap_neg_log_post(rvpack, value_and_grad), \
        value_and_grad


def make_sharded_warped_objective(mesh, cfg, block: int = 256,
                                  grad_block: int = 2048,
                                  mixed: bool = True, axis: str = "data"):
    """(rvpack, neg_log_post, value_and_grad) of an iwgp/cwgp FitConfig
    with the closed-form gradient pipeline distributed over the mesh, the
    multi-rank counterpart of bigfit.make_warped_vg.

    The O(N^2) / O(N^3) stages are row-sharded as in
    `make_sharded_mixed_objective`; the warpings bolt on top:
    - x~(z), y~(z) and the log|J| term are elementwise over the N rows,
      computed replicated on every rank (`engine._Warps`), each rank
      slicing its own rows;
    - iwgp gradients flow through the Gram column blocks' autograd, which
      rebuilds the warped inputs from z inside each block;
    - the cwgp gradient needs no factorisation: -a' dy~/dz + dlog|J|/dz
      with a = K^-1 y~ held, one autograd pass over N-vectors, replicated.
    value_and_grad(z) -> (logl with the log|J| term, gradient),
    replicated; `value_and_grad.calls` counts the evaluations."""
    from . import engine

    group, d, D, dev = _dist.mesh_axis(mesh, axis)
    rvpack = engine.build_rvs(cfg)
    warps = engine._Warps(cfg, dev)
    n0, nx = cfg.x.shape
    kerns, ops = tuple(cfg.kerns), tuple(cfg.ops)
    noise = cfg.noise
    jitter = float(cfg.jitter)
    has_alpha = "RatQuad" in kerns
    n = _padded(n0, D)
    m = n // D
    gb = _grad_block_width(grad_block, n)
    mm, chol_inv = _mixed_ops(block) if mixed else _exact_ops()
    grow = d * m + torch.arange(m, device=dev)
    gcol = torch.arange(n, device=dev)

    def padded(v):
        out = v.new_zeros((n,) + tuple(v.shape[1:]))
        out[:n0] = v
        return out

    def gram_rows(xr, xc, gcol_, vals):
        gv = vals["gv"][0] if noise else xr.new_zeros(())
        al = vals["alpha"][0] if has_alpha else None
        K = kernels.gram(kerns, ops, xr, xc, vals["l"], vals["kv"], al)
        real = (grow < n0)[:, None] & (gcol_ < n0)[None, :]
        K = torch.where(real, K, 0.0)
        diag = (grow[:, None] == gcol_[None, :]).to(K.dtype)
        return K + diag * torch.where((grow < n0)[:, None], jitter + gv,
                                      1.0)

    def gram_block(zz, s, gcolB):
        # warped inputs rebuilt from zz: iwgp gradients flow through the
        # Gram's autograd
        vz = rvpack.unpack(zz)
        xz = padded(warps.inputs(vz))
        return gram_rows(xz[d * m:(d + 1) * m], xz[s:s + gb], gcolB, vz)

    def value_and_grad(z):
        """(logl incl. the log|J| warping term, d logl / dz),
        replicated."""
        value_and_grad.calls += 1
        with torch.enable_grad():
            zz = _as_tensor(z, dev).detach().requires_grad_()
            vals = rvpack.unpack(zz)
            yin, ldj = warps.targets(vals)
            xin = warps.inputs(vals)
        with torch.no_grad():
            xp = padded(xin.detach())
            K_loc = gram_rows(xp[d * m:(d + 1) * m], xp, gcol,
                              rvpack.unpack(zz.detach()))
            y_loc = torch.where(grow < n0,
                                padded(yin.detach())[d * m:(d + 1) * m],
                                0.0)
        logl, a_full, grad = _closed_form_core(
            K_loc, y_loc, zz.detach(), d, D, group, mm, chol_inv, m, n, n0,
            gb, n // gb, gram_block)
        if cfg.cwgp:
            with torch.enable_grad():
                (gw,) = torch.autograd.grad(-(a_full[:n0] @ yin) + ldj, zz)
            grad = grad + gw
        return logl + ldj.detach(), grad

    value_and_grad.calls = 0
    return rvpack, _wrap_neg_log_post(rvpack, value_and_grad), \
        value_and_grad


def _mesh_or_default(mesh, device):
    return mesh if mesh is not None else data_mesh(device=device)


def sharded_big_warped_map_fit(cfg, block: int = 256, maxiter: int = 50,
                               start=None, mesh=None, mixed: bool = True,
                               verbose: bool = False,
                               grad_block: int = 2048, device=None):
    """MAP fit with learnable warpings distributed over the mesh
    (`make_sharded_warped_objective`; None: `data_mesh(device=device)`):
    host L-BFGS-B (scipy's default ftol, no bounds, as the reference) on
    every rank in lockstep, the reference hyperprior and warping-prior
    menu.  Returns (hypers, log posterior), the route of
    GPMCMC.fit(precision='distributed', iwgp/cwgp=True)."""
    from . import bigfit

    rvpack, _, vg = make_sharded_warped_objective(
        _mesh_or_default(mesh, device), cfg, block=block,
        grad_block=grad_block, mixed=mixed)
    return bigfit._lbfgsb_restarts(
        vg, rvpack, start, 1, 0, None, maxiter, _SCIPY_FTOL, verbose,
        "sharded_big_warped_map_fit", "sharded warped MAP")


def sharded_big_map_fit(X, y, kerns=("RBF",), ops=(), noise: bool = True,
                        truncate: bool = False, jitter: float = 1e-6,
                        block: int = 256, maxiter: int = 50, start=None,
                        mesh=None, mixed: bool = True,
                        verbose: bool = False, device=None):
    """MAP fit with the closed-form NLML gradient pipeline distributed over
    the mesh (`make_sharded_mixed_objective`; None:
    `data_mesh(device=device)`): host L-BFGS-B (scipy's default ftol, no
    bounds, as the reference) over the unconstrained hyperparameters on
    every rank in lockstep, the reference hyperprior menu.  Returns
    (hypers dict, log posterior)."""
    from . import bigfit

    rvpack, _, vg = make_sharded_mixed_objective(
        _mesh_or_default(mesh, device), X, y, kerns=kerns, ops=ops,
        noise=noise, truncate=truncate, jitter=jitter, block=block,
        mixed=mixed)
    return bigfit._lbfgsb_restarts(
        vg, rvpack, start, 1, 0, None, maxiter, _SCIPY_FTOL, verbose,
        "sharded_big_map_fit", "sharded MAP")


def make_sharded_predict(mesh, X, y, hypers, kerns=("RBF",), ops=(),
                         noise: bool = True, jitter: float = 1e-6,
                         block: int = 256, mixed: bool = True,
                         pcg_iters: int = 12, qbucket: int = 256,
                         axis: str = "data"):
    """Distributed GP prediction: the conditioning state and every query's
    cross-Gram solves sharded over the mesh; no rank holds an N x N
    matrix or an (N, Q) cross-Gram.

    State, computed once: the block-row factorisation (`_dist_factor`),
    then alpha = K^-1 y refined by distributed PCG with the factorisation
    as preconditioner (plain substitution stalls at the factorisation's
    residual floor on the mixed route).  Per query batch, padded to a
    multiple of qbucket: each rank contracts its cross-Gram rows with its
    alpha rows (one q-vector all_reduce for the mean), and the whitened
    variance solve runs as a distributed forward substitution (one (m, q)
    broadcast per block step).  Returns predict(Xq) -> (mu, var) numpy
    arrays of length len(Xq), equal on every rank."""
    from . import engine

    group, d, D, dev = _dist.mesh_axis(mesh, axis)
    X = _as_tensor(X, dev)
    y1 = _as_tensor(y, dev).reshape(-1)
    kerns = tuple(kerns)
    ops = tuple(ops)
    nx = X.shape[1]
    n0 = X.shape[0]
    n = _padded(n0, D)
    m = n // D
    Xp = X.new_zeros((n, nx))
    Xp[:n0] = X
    l, kv, gv, alq = engine.hypers_to_args(hypers, noise, device=dev)
    mm, chol_inv = _mixed_ops(block) if mixed else _exact_ops()
    X_loc = Xp[d * m:(d + 1) * m]
    grow = d * m + torch.arange(m, device=dev)

    with torch.no_grad():
        gcol = torch.arange(n, device=dev)
        K = kernels.gram(kerns, ops, X_loc, Xp, l, kv, alq)
        real = (grow < n0)[:, None] & (gcol < n0)[None, :]
        K = torch.where(real, K, 0.0)
        diag = (grow[:, None] == gcol[None, :]).to(K.dtype)
        K_loc = K + diag * torch.where((grow < n0)[:, None], jitter + gv,
                                       1.0)
        del K, real, diag
        b = y1.new_zeros(n)
        b[:n0] = y1
        L_loc, Linvs, _, _, _ = _dist_factor(
            K_loc.clone(), b[d * m:(d + 1) * m], d, D, group, mm, chol_inv)

        def S(r):
            w = _dist_solve_lower_vec(L_loc, Linvs, r, d, D, group)
            return _dist_solve_upper_vec(L_loc, Linvs, w, d, D, group)

        def Kmv(v):
            return _dist.all_gather(K_loc @ v, group)

        zero = b.new_zeros(())
        x = torch.zeros_like(b)
        r = b
        p = S(b)
        rz = b @ p
        for _ in range(pcg_iters):
            Kp = Kmv(p)
            denom = p @ Kp
            a = torch.where(denom > 0.0, rz / denom, zero)
            x = x + a * p
            r = r - a * Kp
            zv = S(r)
            rz_new = r @ zv
            bcoef = torch.where(rz > 0.0, rz_new / rz, zero)
            p = zv + bcoef * p
            rz = rz_new
        alpha_vec = x
        del K_loc

    def predict(Xq):
        Xq = np.asarray(Xq, dtype=float)
        q = Xq.shape[0]
        qp = _padded(max(q, 1), qbucket)
        Xqp = np.zeros((qp, nx))
        Xqp[:q] = Xq
        with torch.no_grad():
            Xqt = torch.as_tensor(Xqp, device=dev)
            Kxs = kernels.gram(kerns, ops, X_loc, Xqt, l, kv, alq)
            Kxs = torch.where((grow < n0)[:, None], Kxs, 0.0)
            a_loc = alpha_vec[d * m:(d + 1) * m]
            mu = _dist.all_reduce((Kxs * a_loc[:, None]).sum(0), group)
            ssq = _dist_solve_lower_ssq(L_loc, Linvs, Kxs, d, D, group, mm)
            kss = kernels.gram(kerns, ops, Xqt, None, l, kv, alq, diag=True)
            var = torch.clamp(kss - ssq, min=0.0) + gv
        return mu[:q].cpu().numpy(), var[:q].cpu().numpy()

    return predict


def sharded_map_fit(X, y, kerns=("RBF",), ops=(), noise=True, jitter=1e-6,
                    mesh=None, max_iter: int = 200, tol: float = 1e-8,
                    device=None):
    """MAP fit with the Gram matrix and its Cholesky factorisation both
    distributed over the mesh (`make_sharded_nlml`; None:
    `data_mesh(device=device)`), by the port's L-BFGS
    (`inference.lbfgs.minimize_lbfgs`) over autograd through the
    collectives, on every rank in lockstep.  Returns (hypers, log
    posterior, iterations)."""
    from ..inference.lbfgs import minimize_lbfgs

    mesh = _mesh_or_default(mesh, device)
    dev = _dist.mesh_axis(mesh)[3]
    Xs, ys = shard_data(mesh, X, y)
    build_rvpack, nlp = make_sharded_nlml(mesh, tuple(kerns), tuple(ops),
                                          noise, jitter)
    rvpack = build_rvpack(np.shape(X)[1])
    z, val, _, niter = minimize_lbfgs(
        lambda z: nlp(z, Xs, ys, rvpack), rvpack.z0().to(dev),
        max_iter=max_iter, tol=tol)
    hypers = {k: v.detach().cpu().numpy()
              for k, v in rvpack.unpack(z).items()}
    return hypers, -float(val), int(niter)
