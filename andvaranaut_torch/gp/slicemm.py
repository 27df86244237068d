"""K1 and K2: integer-Ozaki slice products (counterpart of
andvaranaut_tpu/gp/pallas_slicemm.py).

C = A B to ~2^-42 relative grade from int8 tensor-core products: exact
power-of-two row (column) scales bring every row of A (column of B) into
(-0.5, 0.5], each scaled operand splits into NS int8 mantissa slices
(As = sum_i c_i 2^-7(i+1)), and the slice-pair products of order
s = i + j < NS accumulate exactly in int32 and combine with the exact
weights 2^-7(s+2).

- K2 `slice_matmul` computes C = A B with the TPU kernel's 256-tile
  sparsity contract (lower_only / row_start / col_start / col_end).
- K1 `syrk_sub_pair_` subtracts P P^T from the lower live tiles of an
  (hi, lo) f32-pair carry IN PLACE (the JAX kernel aliased its outputs
  to the carry; here the tensors are mutated).

Each wrapper takes the plain PyTorch version for CPU tensors and
launches its CUDA kernel (csrc/slicemm.cu) for CUDA tensors, or raises.
The slices and scales are made by plain PyTorch on either device, as
XLA made them outside the Pallas kernel.  The plain versions do the
slice products as f64 matmuls of exact integers (every partial sum is
an integer below 2^53, so the result is exact) and combine the order
groups in the same order as the kernel: kernel and plain version agree
bit for bit.  `launches` on each wrapper counts its kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

#: int8 slice count of every production slice product (6 slices: 21
#: pair products at ~4e-11 product grade)
INT_NSLICES = 6
#: grain of the tile-sparsity contract
TILE = 256

_BM = 64  # CUDA output tile
_BK = 32  # CUDA k chunk
_MAX_K = 1 << 14  # int32 group sums stay exact up to this depth

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    "slice_matmul": [_VP] * 5 + [_I] * 11 + [_VP],
    "syrk_sub_pair": [_VP] * 4 + [_I] * 3 + [_VP],
}


def _lib():
    return _build.library("slicemm", _SIGS)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pow2_row_scales(A, dim: int):
    """Power-of-two scales per row (dim=1) or column (dim=0) so that
    A / scale lies in (-0.5, 0.5].  Built from the f32 cast's exponent
    bits exactly as the JAX reference does (frexp on the f64 value gives
    another exponent whenever the f32 rounding carries)."""
    m = A.abs().amax(dim=dim, keepdim=True)
    m32 = torch.clamp(m.to(torch.float32), min=1e-30)
    u = m32.view(torch.int32)
    e = ((u >> 23) & 0xFF) - 127
    e = torch.clamp(e + 2, -120, 120)
    return ((e + 127) << 23).view(torch.float32).to(A.dtype)


def int_slices(As, nslices: int):
    """(nslices, *As.shape) int8 mantissa slices of As in (-0.5, 0.5]:
    As ~= sum_k c_k 2^-7(k+1).  Every step is exact."""
    out = torch.empty((nslices, *As.shape), dtype=torch.int8,
                      device=As.device)
    R = As
    for i in range(nslices):
        R = R * 128.0
        c = torch.trunc(R)
        out[i] = c
        R = R - c
    return out


def _group_combine(a_sl, bt_sl):
    """sum_s 2^-7(s+2) sum_{i+j=s} a_i bt_j^T in f64, ascending s (the
    kernel's order)."""
    ns = a_sl.shape[0]
    af = a_sl.to(torch.float64)
    bf = bt_sl.to(torch.float64)
    C = torch.zeros((af.shape[1], bf.shape[1]), dtype=torch.float64,
                    device=af.device)
    for s in range(ns):
        acat = torch.cat([af[i] for i in range(s + 1)], dim=1)
        bcat = torch.cat([bf[s - i] for i in range(s + 1)], dim=1)
        C = C + (acat @ bcat.T) * 2.0 ** (-7 * (s + 2))
    return C


def _contract_mask(m, n, device, lower_only, row_start, col_start,
                   col_end):
    ti = torch.arange(m, device=device)[:, None] // TILE
    tj = torch.arange(n, device=device)[None, :] // TILE
    keep = torch.ones((m, n), dtype=torch.bool, device=device)
    if lower_only:
        keep = keep & (ti >= tj)
    if row_start is not None:
        keep = keep & ((ti + 1) * TILE > row_start)
    if col_start is not None:
        keep = keep & ((tj + 1) * TILE > col_start)
    if col_end is not None:
        keep = keep & (tj * TILE < col_end)
    return keep


def slice_matmul_plain(A, B, nslices: int = INT_NSLICES,
                       lower_only: bool = False, row_start=None,
                       col_start=None, col_end=None):
    """Plain PyTorch version of K2: the same slices, exact f64 products
    of the integer slices, exact zeros outside the live tiles."""
    sa = pow2_row_scales(A, 1)
    sb = pow2_row_scales(B, 0)
    a_sl = int_slices(A / sa, nslices)
    bt_sl = int_slices((B / sb).T, nslices)
    C = _group_combine(a_sl, bt_sl) * (sa * sb)
    if (lower_only or row_start is not None or col_start is not None
            or col_end is not None):
        keep = _contract_mask(C.shape[0], C.shape[1], C.device, lower_only,
                              row_start, col_start, col_end)
        C = torch.where(keep, C, 0.0)
    return C


def _padded_slices(X, rows: int, kp: int, nslices: int):
    R = torch.zeros((rows, kp), dtype=X.dtype, device=X.device)
    R[:X.shape[0], :X.shape[1]] = X
    return int_slices(R, nslices)


def _check_cuda(*ts):
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(
                f"expected all-CPU or all-CUDA tensors, got {t.device}")


def slice_matmul(A, B, nslices: int | None = None, lower_only: bool = False,
                 row_start=None, col_start=None, col_end=None):
    """K2: C = A @ B by the integer-Ozaki scheme (f64 in, f64 out).

    Contract, on 256-tiles as in the JAX kernel:
    - lower_only: strictly-upper tiles are exact zeros;
    - row_start: tile rows wholly above it are not computed (exact zeros
      here; the JAX contract leaves them undefined, callers mask them);
    - col_start: tiles wholly left of it are exact zeros;
    - col_end: the caller guarantees B is zero from this column on;
      tiles wholly right of it are exact zeros.
    """
    ns = INT_NSLICES if nslices is None else int(nslices)
    if A.dtype != torch.float64 or B.dtype != torch.float64:
        raise TypeError("slice_matmul takes float64 operands")
    if A.dim() != 2 or B.dim() != 2 or A.shape[1] != B.shape[0]:
        raise ValueError(f"bad shapes {tuple(A.shape)} @ {tuple(B.shape)}")
    if A.device.type == "cpu" and B.device.type == "cpu":
        return slice_matmul_plain(A, B, ns, lower_only, row_start,
                                  col_start, col_end)
    _check_cuda(A, B)
    m, k = A.shape
    n = B.shape[1]
    if k > _MAX_K:
        raise ValueError(f"k={k} exceeds the exact int32 depth {_MAX_K}")
    C = torch.empty((m, n), dtype=torch.float64, device=A.device)
    r0 = 0 if row_start is None else max(int(row_start), 0) // TILE * TILE
    r0 = min(r0, m)
    if r0 > 0:
        C[:r0].zero_()
    mr = m - r0
    if mr == 0:
        return C
    kp = _round_up(k, _BK)
    mp = _round_up(mr, _BM)
    np_ = _round_up(n, _BM)
    Ar = A[r0:]
    sa = pow2_row_scales(Ar, 1)
    sb = pow2_row_scales(B, 0)
    a_sl = _padded_slices(Ar / sa, mp, kp, ns)
    bt_sl = _padded_slices((B / sb).T, np_, kp, ns)
    sa = sa.reshape(-1).contiguous()
    sb = sb.reshape(-1).contiguous()
    Cr = C[r0:]
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().slice_matmul(
            a_sl.data_ptr(), bt_sl.data_ptr(), sa.data_ptr(), sb.data_ptr(),
            Cr.data_ptr(), mr, n, kp, mp, np_, ns, int(bool(lower_only)),
            0 if row_start is None else int(row_start),
            0 if col_start is None else int(col_start),
            np_ if col_end is None else int(col_end), r0, stream)
        slice_matmul.launches += 1
    _build.check(err, "slice_matmul")
    return C


slice_matmul.launches = 0


def syrk_sub_pair_plain_(Ahi, Alo, panel, row_start=None):
    """Plain PyTorch version of K1, in place on (Ahi, Alo)."""
    m = Ahi.shape[0]
    c0 = 0 if row_start is None else max(int(row_start), 0) // TILE * TILE
    if c0 >= m:
        return Ahi, Alo
    P = panel[c0:]
    sa = pow2_row_scales(P, 1)
    sl = int_slices(P / sa, INT_NSLICES)
    C = _group_combine(sl, sl) * (sa * sa.reshape(1, -1))
    t = torch.arange(m - c0, device=P.device) // TILE
    live = t[:, None] >= t[None, :]
    hi = Ahi[c0:, c0:]
    lo = Alo[c0:, c0:]
    R = (hi.double() + lo.double()) - C
    nh = R.to(torch.float32)
    nl = (R - nh.double()).to(torch.float32)
    hi.copy_(torch.where(live, nh, hi))
    lo.copy_(torch.where(live, nl, lo))
    return Ahi, Alo


def syrk_sub_pair_(Ahi, Alo, panel, row_start=None):
    """K1: (Ahi, Alo) -= panel @ panel.T on live lower 256-tiles, IN PLACE.

    Live tiles: tile row >= tile column, tile column at or right of
    row_start // 256 (the whole diagonal tile, its upper half included).
    Every other element is left bit-identical.  Panel rows above
    row_start must be zero (the caller's mask).  The carry is read as
    the exact f64 sum hi + lo, updated in f64 and split back into a
    proper f32 pair (~2^-48, above the product's ~2^-42 grade).  A call
    with no live tile (row_start >= m) launches nothing.  Returns
    (Ahi, Alo)."""
    m, k = panel.shape
    if Ahi.shape != (m, m) or Alo.shape != (m, m):
        raise ValueError("carry must be (m, m) with panel (m, k)")
    if Ahi.dtype != torch.float32 or Alo.dtype != torch.float32:
        raise TypeError("the pair carry is float32")
    if panel.dtype != torch.float64:
        raise TypeError("the panel is float64")
    if m % TILE:
        raise ValueError(f"pair carry needs m % {TILE} == 0, got {m}")
    if not (Ahi.is_contiguous() and Alo.is_contiguous()):
        raise ValueError("the pair carry must be contiguous")
    devs = {Ahi.device.type, Alo.device.type, panel.device.type}
    if devs == {"cpu"}:
        return syrk_sub_pair_plain_(Ahi, Alo, panel, row_start)
    _check_cuda(Ahi, Alo, panel)
    if k > _MAX_K:
        raise ValueError(f"k={k} exceeds the exact int32 depth {_MAX_K}")
    c0 = 0 if row_start is None else max(int(row_start), 0) // TILE * TILE
    if c0 >= m:
        return Ahi, Alo
    kp = _round_up(k, _BK)
    P = panel[c0:]
    sa = pow2_row_scales(P, 1)
    sl = _padded_slices(P / sa, m - c0, kp, INT_NSLICES)
    sa = sa.reshape(-1).contiguous()
    with torch.cuda.device(Ahi.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().syrk_sub_pair(
            sl.data_ptr(), sa.data_ptr(), Ahi.data_ptr(), Alo.data_ptr(),
            m, kp, c0, stream)
        syrk_sub_pair_.launches += 1
    _build.check(err, "syrk_sub_pair")
    return Ahi, Alo


syrk_sub_pair_.launches = 0
