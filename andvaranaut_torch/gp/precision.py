"""Mixed-precision dense linear algebra for large-N GPs (counterpart of
andvaranaut_tpu/gp/precision.py).

`blocked_cholesky` is a right-looking blocked factorisation, one
full-height level, on one of two carries of the trailing matrix.

- The (hi, lo) f32 pair carry, at blocks and sizes on the 256 grain
  (`_use_pair_carry`; on the card it takes the place of the reference's
  PAIR_CARRY).  Per block step: K3 (`cholinv.chol_inv_block`, through
  `_chol_inv_fused`) factors and inverts the diagonal block, 1024 blocks
  recursing 2x2 over 512 halves with 8-slice compose products; K2
  (`slicemm.slice_matmul`) forms the panel below it; K1
  (`slicemm.syrk_sub_pair_`) subtracts the panel's syrk from the carry
  in place.  With ANDVARANAUT_FUSED_PANEL (`panel.use_fused_panel`) the
  panel stage is fused instead: K10 (`panel.panel_into_carry_`) writes the
  panel into the carry in place, K11 (`panel.pair_to_slices`) slices it
  from there, and K12 (`slicemm.syrk_sub_pair_presliced_`) subtracts.
- An f64 carry (`_chol_steps`) at blocks off the 256 grain: K2 panels,
  and K8's in-place step (`slicemm.syrk_sub_lower_`) subtracts the
  panel's syrk on lower tiles from the live trailing square.

`blocked_inv_lower` forms L^-1 for the MAP gradient by a blocked
identity solve: on a second pair carry, its trailing updates through K4
(`slicemm.mm_sub_pair_`), on the 256 grain; elsewhere by the generic
blocked solve with the identity as right-hand side.
`slice_syrk_tn_lower` forms W^T W on lower tiles through K7.

The solves (`blocked_solve_lower/upper`) reuse the stored diagonal-block
inverses: vector right-hand sides through f64 matvecs, matrix
right-hand sides through K2 slice products with refinement.
`mixed_nlml` adds iteratively refined solves and the log-determinant.
`single_block_cholesky_batched` is `blocked_cholesky`'s one-block branch
on a batch of matrices (the chains of the small-n MCMC objective): one
batched K3 launch (`cholinv.chol_inv_blocks`) for all of them, their
`ok` gates read in one host sync, the f64 fallback for the failed ones.

Not ported (TPU workarounds): the reference's CHOL_SHRINK levels, the
seeded diagonal path, the DIAG_BLOCK recursion and bf16 slices.  The
6-slice count is used everywhere (the reference's legacy `nslices`
arguments were ignored by its kernel dispatches too).  Functions that
update in place say so: the JAX reference aliased buffers, the port
mutates them.
"""

from __future__ import annotations

import math

import torch

from . import cholinv, panel, slicemm

INT_NSLICES = slicemm.INT_NSLICES
TILE = slicemm.TILE
#: slice count of the 2x2 diagonal recursion's compose products: the
#: triangular-inverse operands reach ~1e2, and 6 slices cost a 9x NLML
#: parity loss in the reference's measurements; 8 slices restore it
FUSED_COMPOSE_NSLICES = 8
#: grain of the substitution inverses of `tri_inv_mixed`
INV_BASE = 128
#: refinement passes of a matrix right-hand-side triangular solve
SOLVE_ITERS = 2
#: refinement sweeps of the NLML quadratic-form solve
NLML_REFINE = 2
#: conjugate-gradient iterations of `pcg_solve`
PCG_ITERS = 12

slice_matmul = slicemm.slice_matmul


def int_slice_matmul(A, B, nslices: int | None = None):
    """C = A @ B by the integer-Ozaki scheme, plain PyTorch on any
    device (the composed path of the reference)."""
    return slicemm.slice_matmul_plain(
        A, B, INT_NSLICES if nslices is None else nslices)


def _pair_split(A):
    """(hi, lo) f32 pair with hi + lo == A to ~2^-48 (exact for f32 A)."""
    hi = A.to(torch.float32)
    return hi, (A - hi.to(A.dtype)).to(torch.float32)


def _compose_mm(A, B):
    """8-slice K2 product for the diagonal recursion's assembly."""
    return slicemm.slice_matmul(A, B, nslices=FUSED_COMPOSE_NSLICES)


def _chol_fallback(Ajj):
    """f64 Cholesky plus substitution inverse, taken when K3's `ok` gate
    fails (the algorithm's own gate).  `_chol_fallback.calls` counts how
    often it fired."""
    _chol_fallback.calls += 1
    # row-major, as K3 writes its factor
    L = torch.linalg.cholesky(Ajj).contiguous()
    return L, tri_inv_mixed(L)


_chol_fallback.calls = 0


def _chol_inv_fused(Ajj):
    """(L, L^-1) of a diagonal block: one K3 launch per <=512 block,
    gated on its `ok` flag (a host sync per block); larger blocks take
    one level of 2x2 recursion: panel through the sub-block inverse,
    8-slice syrk, and X10 = -X11 L10 X00."""
    b = Ajj.shape[0]
    if b <= cholinv.MAX_BLOCK:
        L, X, ok = cholinv.chol_inv_block(Ajj)
        if bool(ok):
            return L, X
        return _chol_fallback(Ajj)
    m = cholinv.MAX_BLOCK
    mm = _compose_mm
    A10 = Ajj[m:, :m]
    L00, X00 = _chol_inv_fused(Ajj[:m, :m])
    L10 = mm(A10, X00.T)
    S = Ajj[m:, m:] - mm(L10, L10.T)
    S = 0.5 * (S + S.T)
    L11, X11 = _chol_inv_fused(S)
    X10 = -mm(X11, mm(L10, X00))
    L = torch.zeros_like(Ajj)
    X = torch.zeros_like(Ajj)
    L[:m, :m] = L00
    L[m:, :m] = L10
    L[m:, m:] = L11
    X[:m, :m] = X00
    X[m:, :m] = X10
    X[m:, m:] = X11
    return L, X


def _chol_inv_diag(Ajj):
    """(Ljj, Ljj^-1) for one diagonal block of the mixed factorisation."""
    b = Ajj.shape[0]
    if b >= 256 and b % 128 == 0:
        return _chol_inv_fused(Ajj)
    L = torch.linalg.cholesky(Ajj)
    return L, tri_inv_mixed(L)


def _subst_inv(L):
    """Lower-triangular inverse by row-by-row forward substitution in
    f64, batched over leading dimensions."""
    b = L.shape[-1]
    X = torch.zeros_like(L)
    eye = torch.eye(b, dtype=L.dtype, device=L.device)
    for i in range(b):
        acc = (L[..., i, :i, None] * X[..., :i, :]).sum(-2)
        X[..., i, :] = (eye[i] - acc) / L[..., i, i, None]
    return X


def tri_inv_mixed(L, base: int | None = None):
    """Lower-triangular inverse: substitution for small matrices, blocked
    substitution (identity right-hand side, per-block substitution
    inverses at the grain `base`, None: INV_BASE) for larger ones; sizes
    off the grain are identity-padded."""
    if base is None:
        base = INV_BASE
    b = L.shape[0]
    if b <= base:
        return _subst_inv(L)
    if b % base:
        bp = -(-b // base) * base
        Lp = torch.eye(bp, dtype=L.dtype, device=L.device)
        Lp[:b, :b] = L
        return tri_inv_mixed(Lp, base)[:b, :b]
    nb = b // base
    Ldiag = torch.stack([
        L[j * base:(j + 1) * base, j * base:(j + 1) * base]
        for j in range(nb)])
    Dinv = _subst_inv(Ldiag)
    eye = torch.eye(b, dtype=L.dtype, device=L.device)
    return blocked_solve_lower(L, eye, Dinv)


def tri_solve_mixed(L, b, trans: int = 0, Linv=None,
                    iters: int = SOLVE_ITERS, col_end=None):
    """Solve L x = b (or L^T x = b) through an explicit inverse plus
    residual refinement.  Vector right-hand sides: f64 matvecs (the
    reference's elementwise broadcast-reduce was a TPU workaround) and
    at most one refinement pass; matrix right-hand sides: K2 slice
    products and `iters` refinement passes.

    col_end: the caller guarantees b's columns from col_end on are exact
    zeros; every product of the solve then has exact-zero columns there
    as well, and each K2 product is told so (its tiles right of col_end
    are skipped)."""
    if Linv is None:
        Linv = tri_inv_mixed(L)
    A = L.T if trans else L
    X = Linv.T if trans else Linv
    if b.dim() == 1:
        x = X @ b
        for _ in range(min(iters, 1)):
            x = x + X @ (b - A @ x)
        return x
    x = slice_matmul(X, b, col_end=col_end)
    for _ in range(iters):
        x = x + slice_matmul(
            X, b - slice_matmul(A, x, col_end=col_end), col_end=col_end)
    return x


def _use_pair_carry(block: int, n: int) -> bool:
    """Whether the factorisation of an n x n matrix at `block` runs on the
    pair carry (K1's 256 grain) or on the f64 carry (K8)."""
    return block % TILE == 0 and n % TILE == 0


def _chol_steps_pair(Ahi, Alo, nsteps: int, block: int):
    """`nsteps` factorisation steps on the (hi, lo) f32 pair carry, IN
    PLACE: each finished column block (diagonal factor and panel) is
    written pair-split into the carry's columns.  Returns the (nsteps,
    block, block) diagonal-block inverses.

    Unfused, rows above the diagonal block of a finished column are
    zeroed.  Fused (`panel.use_fused_panel`): K10 writes the panel, the
    diagonal factor is written beside it, K11 slices the panel from the
    carry and K12 subtracts its syrk; finished columns keep stale values
    above the diagonal block, which every reader masks (the diagonal
    blocks are read from their lower triangles, and the factor is the
    carry's lower triangle)."""
    dt = torch.float64
    fused = panel.use_fused_panel(Ahi.device)
    Dinv = torch.empty((nsteps, block, block), dtype=dt, device=Ahi.device)
    for j in range(nsteps):
        lo = j * block
        hi = lo + block
        Ajj = Ahi[lo:hi, lo:hi].to(dt) + Alo[lo:hi, lo:hi].to(dt)
        # only the lower triangle of the carry is maintained
        Ajj = torch.tril(Ajj) + torch.tril(Ajj, -1).T
        Ljj, Linv = _chol_inv_diag(Ajj)
        Dinv[j] = Linv
        if fused:
            panel.panel_into_carry_(Ahi, Alo, Linv, lo, hi, block)
            Ljh, Ljl = _pair_split(Ljj)
            Ahi[lo:hi, lo:hi] = Ljh
            Alo[lo:hi, lo:hi] = Ljl
            p_sl, sa = panel.pair_to_slices(Ahi, Alo, lo, hi, block)
            slicemm.syrk_sub_pair_presliced_(Ahi, Alo, p_sl, sa,
                                             row_start=hi)
            continue
        cols = Ahi[:, lo:hi].to(dt) + Alo[:, lo:hi].to(dt)
        P = slice_matmul(cols, Linv.T, row_start=hi)
        P[:hi] = 0.0
        # fused in-place trailing update; unvisited tiles pass through
        slicemm.syrk_sub_pair_(Ahi, Alo, P, row_start=hi)
        P[lo:hi] = Ljj
        Lch, Lcl = _pair_split(P)
        Ahi[:, lo:hi] = Lch
        Alo[:, lo:hi] = Lcl
    return Dinv


def _chol_steps(A, nsteps: int, block: int):
    """`nsteps` factorisation steps on the f64 carry A, IN PLACE: the
    route at blocks off the 256 grain (reference `_chol_steps`).  Per
    step: the diagonal block symmetrised from its lower triangle, its
    factor and inverse, the K2 panel of the rows below it, K8's syrk of
    the panel on lower tiles subtracted in place from the live trailing
    square (`slicemm.syrk_sub_lower_`, no (m, m) product), and the
    finished column block written into A.  The reference's update mask
    (lower tiles, columns from row_start) is K8's grid: the in-place step
    touches nothing else, where the reference's K8 left those tiles
    unspecified.  Finished L columns accumulate in A's lower triangle;
    returns the (nsteps, block, block) diagonal-block inverses."""
    m = A.shape[0]
    Dinv = torch.empty((nsteps, block, block), dtype=A.dtype,
                       device=A.device)
    for j in range(nsteps):
        lo = j * block
        hi = lo + block
        Ajj = A[lo:hi, lo:hi]
        Ajj = torch.tril(Ajj) + torch.tril(Ajj, -1).T
        Ljj, Linv = _chol_inv_diag(Ajj)
        Dinv[j] = Linv
        P = slice_matmul(A[:, lo:hi], Linv.T, row_start=hi)
        P[:hi] = 0.0
        if hi < m:
            slicemm.syrk_sub_lower_(A, P, row_start=hi)
        P[lo:hi] = Ljj
        A[:, lo:hi] = P
    return Dinv


def _single_block_size(n0: int) -> int:
    """The padded size of a one-block factorisation: the fused diagonal
    path's 128 grain, at least 256."""
    return max(-(-n0 // 128) * 128, 256)


def single_block_batched(n0: int, block: int) -> bool:
    """Whether an n0 x n0 factorisation at `block` is one block that K3
    takes in one launch (so a batch of them is one batched launch)."""
    return n0 <= block and _single_block_size(n0) <= cholinv.MAX_BLOCK


def single_block_cholesky_batched(K):
    """`blocked_cholesky(K[c], block, return_inv=True)` for every matrix
    of a batch K (C, n0, n0) whose factorisation is one block
    (`single_block_batched`), as (L (C, n0, n0), Dinv (C, n0, n0)): the
    batch identity-padded as the one-block branch pads one matrix, ONE
    batched K3 launch, its `ok` gates read in one host sync, and
    `_chol_fallback` for the blocks whose gate failed (the algorithm's
    own gate, as the reference's lax.cond under vmap).  A block the
    fallback refuses (not positive definite) gives NaN in its entry
    instead of raising, so the other chains go on.  Each entry equals the
    one-block branch's bit for bit (`cholinv.chol_inv_blocks` equals
    `chol_inv_block` per block)."""
    nb, n0 = K.shape[0], K.shape[1]
    bp = _single_block_size(n0)
    Kp = K
    if bp != n0:
        Kp = torch.eye(bp, dtype=K.dtype, device=K.device).repeat(nb, 1, 1)
        Kp[:, :n0, :n0] = K
    L, X, ok = cholinv.chol_inv_blocks(Kp)
    for c in torch.nonzero(~ok.cpu()).reshape(-1).tolist():
        try:
            L[c], X[c] = _chol_fallback(Kp[c])
        except torch.linalg.LinAlgError:
            L[c] = math.nan
            X[c] = math.nan
    return L[:, :n0, :n0], X[:, :n0, :n0]


def blocked_cholesky(K, block: int = 256, return_inv: bool = False):
    """Right-looking blocked Cholesky, one full-height level: on the pair
    carry on the 256 grain, on the f64 carry (K8) at any other block.
    Sizes off the block are identity-padded (exact).  Returns L, or (L,
    Dinv) with the diagonal-block inverses.  K is not modified."""
    n0 = K.shape[0]
    if n0 <= block:
        # single block: the fused diagonal path at its 128 grain
        bp = _single_block_size(n0)
        Kp = K
        if bp != n0:
            Kp = torch.eye(bp, dtype=K.dtype, device=K.device)
            Kp[:n0, :n0] = K
        L, Linv = _chol_inv_diag(Kp)
        L = L[:n0, :n0]
        return (L, Linv[:n0, :n0][None]) if return_inv else L
    nb = -(-n0 // block)
    n = nb * block
    Kp = K
    if n != n0:
        Kp = torch.eye(n, dtype=K.dtype, device=K.device)
        Kp[:n0, :n0] = K
    if _use_pair_carry(block, n):
        Ahi, Alo = _pair_split(Kp)
        Dinv = _chol_steps_pair(Ahi, Alo, nb, block)
        L = torch.tril(Ahi.to(K.dtype) + Alo.to(K.dtype))
        del Ahi, Alo
    else:
        A = (Kp.clone(memory_format=torch.contiguous_format) if Kp is K
             else Kp)
        Dinv = _chol_steps(A, nb, block)
        L = torch.tril(A)
        del A
    if n != n0:
        L = L[:n0, :n0].contiguous()
    return (L, Dinv) if return_inv else L


def blocked_solve_lower(L, b, Dinv, solve_iters: int = SOLVE_ITERS,
                        rhs_lower: bool = False):
    """Solve L x = b by blocked forward substitution at the grain of the
    stored diagonal-block inverses Dinv: diagonal-block solves through
    them (`solve_iters` refinement passes for matrix b), off-diagonal
    updates as f64 matvecs (vector b) or K2 slice products of the live
    rows (matrix b).

    rhs_lower: the caller guarantees b's block-row j is zero from column
    (j + 1) * block on (b = I, giving x = L^-1); each update's product is
    then exactly zero right of the current block column, and K2 skips
    those tiles (col_end), as do the diagonal-block solves."""
    block = Dinv.shape[1]
    n = L.shape[0]
    if n <= block or n % block:
        return tri_solve_mixed(L, b, Linv=Dinv[0] if n <= block else None,
                               iters=solve_iters)
    vec = b.dim() == 1
    r = b.clone()
    x = torch.empty_like(b)
    for j in range(n // block):
        lo = j * block
        hi = lo + block
        ce = hi if rhs_lower and not vec else None
        xj = tri_solve_mixed(L[lo:hi, lo:hi], r[lo:hi], Linv=Dinv[j],
                             iters=solve_iters, col_end=ce)
        x[lo:hi] = xj
        if hi < n:
            Lcol = L[hi:, lo:hi]
            r[hi:] -= Lcol @ xj if vec else slice_matmul(Lcol, xj,
                                                         col_end=ce)
    return x


def blocked_solve_upper(L, b, Dinv):
    """Solve L^T x = b (L lower) by blocked backward substitution at the
    grain of Dinv."""
    block = Dinv.shape[1]
    n = L.shape[0]
    if n <= block or n % block:
        return tri_solve_mixed(L, b, trans=1,
                               Linv=Dinv[0] if n <= block else None)
    vec = b.dim() == 1
    nb = n // block
    r = b.clone()
    x = torch.empty_like(b)
    for jj in range(nb):
        j = nb - 1 - jj
        lo = j * block
        hi = lo + block
        xj = tri_solve_mixed(L[lo:hi, lo:hi], r[lo:hi], trans=1,
                             Linv=Dinv[j])
        x[lo:hi] = xj
        if lo > 0:
            Lrow = L[lo:hi, :lo].T
            r[:lo] -= Lrow @ xj if vec else slice_matmul(Lrow, xj)
    return x


class _SolveLowerLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, L, b, Dinv):
        ctx.save_for_backward(L, Dinv)
        with torch.no_grad():
            return blocked_solve_lower(L, b, Dinv)

    @staticmethod
    def backward(ctx, ct):
        L, Dinv = ctx.saved_tensors
        return None, blocked_solve_upper(L, ct.contiguous(), Dinv), None


def solve_lower_linear(L, b, Dinv):
    """blocked_solve_lower as a linear operator in b for autograd: its
    backward is the exact adjoint ct -> L^-T ct through the blocked upper
    solve (the slicing inside the mixed substitution has no derivative).
    L and Dinv are conditioning state held constant: they get no
    gradient, as in every caller (BO acquisition gradients with respect
    to the query points)."""
    return _SolveLowerLinear.apply(L, b, Dinv)


def _inv_lower_pair(L, Dinv, solve_iters: int):
    """L^-1 by blocked forward substitution on the identity, with the
    residual carried as ONE (hi, lo) f32 pair that becomes the solution.

    The carry starts as I.  Per block step j: the diagonal-block solve
    of the carry's block-row (through Dinv[j], `solve_iters` refinement
    passes, col_end = the block's end, since that row is zero right of
    it) is written pair-split into the carry's block-row, then K4
    (`slicemm.mm_sub_pair_`) subtracts L[rows below, block] @ x_j from
    the rows below IN PLACE, on columns left of the block's end.  Every
    update touches only rows below and columns left of the current
    block's end, and each solved block-row is exactly zero right of its
    block column (zero right-hand side, zero products), so the upper
    triangle stays exactly zero with no mask.  Returns (hi, lo)."""
    n = L.shape[0]
    block = Dinv.shape[1]
    dt = L.dtype
    rhi = torch.eye(n, dtype=torch.float32, device=L.device)
    rlo = torch.zeros((n, n), dtype=torch.float32, device=L.device)
    for j in range(n // block):
        lo = j * block
        hi = lo + block
        rblk = rhi[lo:hi].to(dt) + rlo[lo:hi].to(dt)
        xj = tri_solve_mixed(L[lo:hi, lo:hi], rblk, Linv=Dinv[j],
                             iters=solve_iters, col_end=hi)
        xh, xl = _pair_split(xj)
        rhi[lo:hi] = xh
        rlo[lo:hi] = xl
        if hi < n:
            # K4 reads L's rows from hi on only
            slicemm.mm_sub_pair_(rhi, rlo, L[:, lo:hi], xj, row_start=hi,
                                 col_end=hi)
    return rhi, rlo


def blocked_inv_lower(L, Dinv, solve_iters: int = SOLVE_ITERS,
                      return_pair: bool = False):
    """Full triangular inverse X = L^-1 (L lower) from the factorisation's
    diagonal-block inverses Dinv, in native layout, with an exactly zero
    upper triangle.

    One block (n <= block): X = tril(Dinv[0]).  n a multiple of a block on
    the 256 grain: the pair-carry identity solve (`_inv_lower_pair`, K4).
    Otherwise the generic identity solve, tril(blocked_solve_lower(L, I,
    rhs_lower=True)) (whose updates leave rows above each step undefined
    in the reference, hence the tril).  return_pair=True returns the
    (hi, lo) f32 pair instead of the f64 sum, which K5
    (`panel.pair_to_slices_cols`) slices directly."""
    block = Dinv.shape[1]
    n = L.shape[0]
    if n <= block:
        X = torch.tril(Dinv[0])
        return _pair_split(X) if return_pair else X
    if n % block == 0 and _use_pair_carry(block, n):
        rhi, rlo = _inv_lower_pair(L, Dinv, solve_iters)
        if return_pair:
            return rhi, rlo
        return rhi.to(L.dtype) + rlo.to(L.dtype)
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    X = torch.tril(blocked_solve_lower(L, eye, Dinv, solve_iters=solve_iters,
                                       rhs_lower=True))
    return _pair_split(X) if return_pair else X


def slice_syrk_lower(A, row_start=None, a_upper: bool = False):
    """A A^T on lower 256-tiles (strictly-upper tiles and tile columns
    wholly above row_start exact zeros), through K8
    (`slicemm.syrk_lower`); A's rows above row_start are zero; a_upper:
    A[i, k] == 0 for k < i."""
    return slicemm.syrk_lower(A, row_start=row_start, a_upper=a_upper)


def slice_syrk_tn_lower(W, w_lower: bool = False):
    """W^T W on lower 256-tiles (strictly-upper tiles exact zeros),
    through K7 (`slicemm.syrk_tn_lower`); w_lower: W[k, i] == 0 for
    k < i."""
    return slicemm.syrk_tn_lower(W, w_lower=w_lower)


def _chol_solve(L, Dinv, b):
    return blocked_solve_upper(L, blocked_solve_lower(L, b, Dinv), Dinv)


def refined_chol_solve(L, K, y, Dinv):
    """Solve K x = y through the mixed factorisation with NLML_REFINE
    sweeps of iterative refinement on f64 residuals."""
    x = torch.zeros_like(y)
    for _ in range(NLML_REFINE + 1):
        x = x + _chol_solve(L, Dinv, y - K @ x)
    return x


def pcg_solve(K, b, L, Dinv):
    """Solve K x = b by conjugate gradients preconditioned with the mixed
    factorisation (plain refinement stalls at the factorisation-residual
    floor; PCG reaches f64 grade in a dozen iterations)."""

    def S(r):
        return _chol_solve(L, Dinv, r)

    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    x = torch.zeros_like(b)
    r = b
    p = S(b)
    rz = b @ p
    for _ in range(PCG_ITERS):
        Kp = K @ p
        denom = p @ Kp
        a = torch.where(denom > 0.0, rz / denom, zero)
        x = x + a * p
        r = r - a * Kp
        z = S(r)
        rz_new = r @ z
        beta = torch.where(rz > 0.0, rz_new / rz, zero)
        p = z + beta * p
        rz = rz_new
    return x


def mixed_nlml(K, y, block: int = 256):
    """Gaussian log marginal likelihood through the mixed factorisation:
    refined solve for the quadratic form, log-determinant from the
    factor's diagonal.  Returns a 0-d f64 tensor."""
    L, Dinv = blocked_cholesky(K, block=block, return_inv=True)
    x = refined_chol_solve(L, K, y, Dinv)
    return (-0.5 * (y @ x) - torch.log(torch.diagonal(L)).sum()
            - 0.5 * y.shape[0] * math.log(2.0 * math.pi))
