"""K1, K2, K4, K6, K7, K8 and K12: integer-Ozaki slice products
(counterpart of andvaranaut_tpu/gp/pallas_slicemm.py).

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
- K4 `mm_sub_pair_` subtracts A B from the rectangular live tiles of an
  (hi, lo) pair carry IN PLACE (the identity solve for L^-1).
- K6 `syrk_tn_lower_presliced` computes W^T W on lower tiles from W's
  pre-made slices (K^-1 = L^-T L^-1 for the MAP gradient, on K5's
  slices, `panel.pair_to_slices_cols`); K7 `syrk_tn_lower` computes it
  from W itself.  Both launch one kernel.  `syrk_tn_lower_batched` is
  K7 on a batch (C, n, n) with n <= 2^14 (the chains of the small-n MCMC
  objective): one slicing call on the stacked operand
  (`slice_operand_batched`, the slicing kernel with the batch on its
  grid) and one launch of K7's kernel with the batch on its grid, each
  entry bit for bit what K7 gives it alone.
- K8 `syrk_lower` computes A A^T on lower 256-tiles, and
  `syrk_sub_lower_` subtracts it from an f64 carry IN PLACE (the f64-carry
  factorisation's trailing update, for blocks off the 256 grain).
- K12 `syrk_sub_pair_presliced_` is K1 on slices that K11
  (`panel.pair_to_slices`) cut from the carry (the fused panel stage),
  in the tiled layout of `tile_layout`.

Each wrapper takes the plain PyTorch version for CPU tensors and
launches its CUDA kernel (csrc/slicemm.cu) for CUDA tensors, or raises.
K1, K2, K4, K7 and K8 slice their operands on the card (`slice_operand`,
csrc/slicing.cu) and multiply on the wgmma tile (csrc/hopper_tile.cuh),
as do K12 on K11's slices and K6 on K5's (both the slicing kernel's pair
mode, in the tiled layout of `tile_layout`).  The
plain versions do the slice products as f64 matmuls of exact integers
(every partial sum is an integer below 2^53, so the result is exact) and
combine the order groups in the same order as the kernel: kernel and
plain version agree bit for bit.  `launches` on each wrapper counts its
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

#: int8 slice count of every production slice product (6 slices: 21
#: pair products at ~4e-11 product grade).  K1, K4 and K8 are compiled
#: for it and refuse another count; K2 takes 6 or 8.
INT_NSLICES = 6
#: slice count of the K^-1 = W^T W product of the MAP gradient (K5-K7).
#: The reference runs it at INT_NSLICES (its kernels take the count as a
#: parameter).  Its gradient contracts K^-1 against dK over all n^2
#: entries, where the truncation toward zero of every slice adds up: with
#: 6 slices the 16k gradient sat 0.13 (normwise) from f64 autograd on an
#: H100, with the kv entry's sign wrong; 8 slices (36 pair products, still
#: exact in int32 up to k = 2^14) bring the n=2048 gradient from 1.4e-3 to
#: 1.2e-7 of the same closed form through an f64 inverse (PERF.md,
#: Findings).  K6 and K7's kernel is compiled for it and refuses another
#: count.
TN_NSLICES = 8
#: grain of the tile-sparsity contract
TILE = 256

_BM = 64  # CUDA output tile
_BK = 32  # CUDA k chunk
_MAX_K = 1 << 14  # int32 group sums stay exact up to this depth
#: contraction chunk of K6/K7 and of the plain versions' group sums:
#: a K6/K7 tile deeper than this runs in k pieces whose exact group sums
#: are added before the one f64 combine (a multiple of _BK, at most
#: _MAX_K)
_K_CHUNK = _MAX_K

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGS = {
    "slice_matmul_tiled": [_VP] * 5 + [_I] * 9 + [_VP],
    "syrk_tn_tiled": [_VP] * 3 + [_I] * 5 + [_VP, _I, _I, _VP],
    "syrk_tn_tiled_batched": [_VP] * 3 + [_I] * 5 + [_VP],
    "syrk_sub_pair": [_VP] * 4 + [_I] * 4 + [_VP],
    "mm_sub_pair": [_VP] * 6 + [_I] * 6 + [_VP],
    "syrk_lower": [_VP] * 3 + [_I] * 5 + [_VP],
    "syrk_sub_lower": [_VP] * 3 + [_I] * 5 + [_VP],
}


_SLICING_SIGS = {"slice_rows": [_VP, _LL, _LL] + [_I] * 8 + [_VP] * 3,
                 "slice_rows_batched": [_VP, _LL, _LL, _LL] + [_I] * 9
                 + [_VP] * 3,
                 "slice_pair_rows": [_VP, _VP, _LL, _LL] + [_I] * 9
                 + [_VP] * 3}

#: the card's SMs: the slicing plan gives each a CTA where the operand can
SMS = 132
#: strip heights of the slicing kernel, tallest first: 16 rows for an
#: operand whose rows lie side by side in memory (sk != 1: 16 consecutive
#: elements at each k, 128 bytes of f64), 4 for rows along k (64 threads
#: a row, six CTAs an SM; 7 % faster than 8 at K2's first panel on the
#: H100, PERF.md); and its largest cluster (above 8 the kernel sets the
#: non-portable cluster attribute)
STRIP_HEIGHTS = (16, 8, 4, 2, 1)
ALONG_K_HEIGHTS = (4, 2, 1)
CLUSTER_MAX = 16
#: dynamic shared memory of one strip part: at most 72 KB where the depth
#: allows, so three CTAs share an SM and one strip's loads overlap
#: another's cut; at most the card's 227 KB less the kernel's static
#: arrays
STRIP_SMEM_TARGET = 72 * 1024
STRIP_SMEM_MAX = 232448 - 2048
#: elements (all operands together) from which the plan fills the card
#: with clusters; a smaller operand takes one CTA a strip (its time is
#: the host's, and a cluster launch costs it more)
FILL_MIN = 1 << 20


def strip_smem(h: int, kpart: int, pair: bool = False) -> int:
    """Dynamic shared memory of a slicing CTA: h rows of kpart 8-byte
    elements (an f64, or an f32 pair held as two planes), each row padded
    by 2 (4 for the pair) (csrc/slicing.cu's strip)."""
    return h * (kpart + (4 if pair else 2)) * 8


@functools.lru_cache(maxsize=None)
def slice_plan(rows_p: int, kp: int, nbatch: int = 1, side: bool = False,
               pair: bool = False):
    """The slicing kernel's plan for nbatch operands of (rows_p, kp), both
    padded (multiples of 64 and 32), with rows side by side in memory
    (`side`, sk != 1) or along k, f64 or an f32 pair: (h, cl, kpart),
    strips of h rows, each on a cluster of cl CTAs that hold kpart columns
    of it apiece (the last the rest, none empty).  The tallest strip (16
    rows side by side, else 4) whose part fits `STRIP_SMEM_TARGET` on the
    fewest of 1, 2, 4, 8, 16 parts (else `STRIP_SMEM_MAX`), then, from
    `FILL_MIN` elements, the parts doubled, up to 8, while the grid has
    fewer CTAs than the card's SMs.
    Raises ValueError where no plan fits (kp past 16 parts of the largest
    strip of one row, ~460k)."""
    if rows_p <= 0 or kp <= 0 or rows_p % _BM or kp % _BK or nbatch < 1:
        raise ValueError(f"no slicing plan for ({rows_p}, {kp}) x {nbatch}")
    nkc = kp // _BK
    heights = STRIP_HEIGHTS if side else ALONG_K_HEIGHTS
    for budget in (STRIP_SMEM_TARGET, STRIP_SMEM_MAX):
        for h in heights:
            for parts in (1, 2, 4, 8, CLUSTER_MAX):
                if strip_smem(h, -(-nkc // parts) * _BK, pair) <= budget:
                    break
            else:
                continue
            strips = nbatch * rows_p // h
            cap = max(parts, 8)  # the fill stays within portable clusters
            while (strips * parts < SMS and parts < cap and parts < nkc
                   and nbatch * rows_p * kp >= FILL_MIN):
                parts *= 2
            cpp = -(-nkc // parts)
            return h, -(-nkc // cpp), cpp * _BK
    raise ValueError(f"no slicing plan fits a depth of {kp}")


def _lib():
    return _build.library("slicemm", _SIGS)


def _slicing_lib():
    return _build.library("slicing", _SLICING_SIGS)


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
    kernel's order).  Each group's integer sum is formed over k-chunks of
    _K_CHUNK and added exactly, as the chunked kernel does."""
    ns, _, k = a_sl.shape
    af = a_sl.to(torch.float64)
    bf = bt_sl.to(torch.float64)
    C = torch.zeros((af.shape[1], bf.shape[1]), dtype=torch.float64,
                    device=af.device)
    for s in range(ns):
        G = None
        for k0 in range(0, k, _K_CHUNK):
            k1 = min(k0 + _K_CHUNK, k)
            acat = torch.cat([af[i, :, k0:k1] for i in range(s + 1)], dim=1)
            bcat = torch.cat([bf[s - i, :, k0:k1] for i in range(s + 1)],
                             dim=1)
            Gc = acat @ bcat.T
            G = Gc if G is None else G + Gc
        C = C + G * 2.0 ** (-7 * (s + 2))
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


def tile_layout(planes):
    """(ns, rows_p, kp) int8 planes (rows_p % 64 == 0, kp % 32 == 0) in
    the tiled layout of the wgmma tile (csrc/slicing.cu): (rows_p / 64,
    kp / 32, ns, 2048), each 2048-byte tile the 64 x 32 block of one plane
    as 8-row x 16-byte core matrices, byte (r, b) at ((r // 8) * 2 +
    b // 16) * 128 + (r % 8) * 16 + b % 16."""
    ns, rows_p, kp = planes.shape
    t = planes.reshape(ns, rows_p // _BM, 8, 8, kp // _BK, 2, 16)
    return t.permute(1, 4, 0, 2, 5, 3, 6).reshape(
        rows_p // _BM, kp // _BK, ns, _BM * _BK)


def untile_layout(tiled):
    """The inverse of `tile_layout`: (rows_p / 64, kp / 32, ns, 2048) int8
    tiles back to (ns, rows_p, kp) planes."""
    nrt, nkc, ns, _ = tiled.shape
    t = tiled.reshape(nrt, nkc, ns, 8, 2, 8, 16)
    return t.permute(2, 0, 3, 5, 1, 4, 6).reshape(ns, nrt * _BM, nkc * _BK)


def slice_operand_plain(X, nslices: int, rows_p: int, kp: int):
    """Plain PyTorch version of the slicing kernel: (tiled slices, scales)
    of the rows of X (rows, k) f64, from `pow2_row_scales`, `int_slices`
    and the zero padding to (rows_p, kp), in `tile_layout`."""
    sx = pow2_row_scales(X, 1)
    planes = _padded_slices(X / sx, rows_p, kp, nslices)
    return tile_layout(planes), sx.reshape(-1)


def _slicing_shape(X, nslices: int, rows_p, kp):
    """(rows_p, kp) checked, by default X's rows and k rounded up to 64
    and 32."""
    rows, k = X.shape
    rows_p = _round_up(rows, _BM) if rows_p is None else int(rows_p)
    kp = _round_up(k, _BK) if kp is None else int(kp)
    if rows == 0 or k == 0 or rows_p < rows or kp < k or rows_p % _BM or (
            kp % _BK):
        raise ValueError(f"cannot slice {tuple(X.shape)} into "
                         f"({rows_p}, {kp})")
    if nslices not in (INT_NSLICES, TN_NSLICES):
        raise ValueError(f"nslices must be {INT_NSLICES} or {TN_NSLICES}")
    return rows_p, kp


def _slicing_buffers(X, nslices: int, rows_p: int, kp: int,
                     nbatch: int | None = None):
    """The slicing kernel's outputs: tiled planes and scales (with a
    leading batch dimension where nbatch is given)."""
    rows = X.shape[-2]
    lead = () if nbatch is None else (nbatch,)
    out = torch.empty((*lead, rows_p // _BM, kp // _BK, nslices, _BM * _BK),
                      dtype=torch.int8, device=X.device)
    scale = torch.empty((*lead, rows), dtype=torch.float64, device=X.device)
    return out, scale


def slice_operand(X, nslices: int, rows_p: int | None = None,
                  kp: int | None = None):
    """Exact pow2 row scales (rows,) f64 of X (rows, k) f64 and its
    `nslices` int8 mantissa planes, zero-padded to (rows_p, kp) (by
    default rows and k rounded up to 64 and 32), in `tile_layout`: the
    operands of the wgmma tile of K1, K2, K4, K7, K8 and K10.  X may be any
    strided view (A[r0:], B.T, W.T): the kernel reads it in place.  One
    launch of csrc/slicing.cu's kernel (`slice_plan`) for a CUDA tensor;
    the plain version for a CPU one.  Returns (slices, scales)."""
    if X.dtype != torch.float64 or X.dim() != 2:
        raise TypeError("slice_operand takes a 2-D float64 operand")
    rows_p, kp = _slicing_shape(X, nslices, rows_p, kp)
    if X.device.type == "cpu":
        return slice_operand_plain(X, nslices, rows_p, kp)
    plan = slice_plan(rows_p, kp, 1, X.stride(1) != 1)
    out, scale = _slicing_buffers(X, nslices, rows_p, kp)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _slicing_lib().slice_rows(
            X.data_ptr(), X.stride(0), X.stride(1), *X.shape, rows_p, kp,
            nslices, *plan, scale.data_ptr(), out.data_ptr(), stream)
        slice_operand.launches += 1
    _build.check(err, "slice_rows")
    return out, scale


slice_operand.launches = 0


def slice_pair_operand_plain(Xhi, Xlo, nslices: int, zero_rows: int,
                             rows_p: int, kp: int):
    """Plain PyTorch version of the slicing kernel's pair mode: the
    scales of the hi plane's rows (`pow2_row_scales(Xhi, 1)`, as f64), the
    exact f64 value Xhi + Xlo divided by them, its first zero_rows rows
    zero, cut by `int_slices`, zero-padded to (rows_p, kp), in
    `tile_layout` (K11's plain version, `panel.pair_to_slices_plain`, on
    the carry's window)."""
    sx = pow2_row_scales(Xhi, 1).to(torch.float64)
    V = (Xhi.double() + Xlo.double()) / sx
    V[:zero_rows] = 0.0
    return tile_layout(_padded_slices(V, rows_p, kp, nslices)), sx.reshape(-1)


def slice_pair_operand(Xhi, Xlo, nslices: int, zero_rows: int = 0):
    """The slicing kernel's pair mode: `slice_operand` of the exact f64
    value of an f32 pair view (Xhi, Xlo) (rows, k), both with the same
    strides and read in place, with the row scales taken from the hi plane
    alone, as the reference takes them for the carry's window
    (pallas_panel.panel_into_carry).  The maximum of hi + lo could round
    across a power of two in f32 where that of hi does not, and give
    another scale.  The first zero_rows rows are zero planes (their scales
    are still the hi plane's).  Rows and k are zero-padded to multiples of
    64 and 32.  It cuts K10's window and is K11 (`panel.pair_to_slices`)
    and K5 (`panel.pair_to_slices_cols`).  One launch of csrc/slicing.cu's
    `slice_pair_rows` for CUDA tensors; the plain version for CPU ones.
    Returns (slices, scales), bit for bit with
    `slice_pair_operand_plain`."""
    if Xhi.dtype != torch.float32 or Xlo.dtype != torch.float32 or (
            Xhi.dim() != 2 or Xhi.shape != Xlo.shape):
        raise TypeError("slice_pair_operand takes a 2-D float32 pair")
    if Xhi.stride() != Xlo.stride():
        raise ValueError("the pair's two planes need the same strides")
    rows_p, kp = _slicing_shape(Xhi, nslices, None, None)
    if {Xhi.device.type, Xlo.device.type} == {"cpu"}:
        return slice_pair_operand_plain(Xhi, Xlo, nslices, zero_rows,
                                        rows_p, kp)
    _check_cuda(Xhi, Xlo)
    plan = slice_plan(rows_p, kp, 1, Xhi.stride(1) != 1, True)
    out, scale = _slicing_buffers(Xhi, nslices, rows_p, kp)
    with torch.cuda.device(Xhi.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _slicing_lib().slice_pair_rows(
            Xhi.data_ptr(), Xlo.data_ptr(), Xhi.stride(0), Xhi.stride(1),
            *Xhi.shape, max(int(zero_rows), 0), rows_p, kp, nslices, *plan,
            scale.data_ptr(), out.data_ptr(), stream)
        slice_pair_operand.launches += 1
    _build.check(err, "slice_pair_rows")
    return out, scale


slice_pair_operand.launches = 0


def slice_operand_batched_plain(X, nslices: int):
    """Plain PyTorch version of `slice_operand_batched`:
    `slice_operand_plain` of each entry, stacked."""
    rows_p, kp = _slicing_shape(X[0], nslices, None, None)
    outs = [slice_operand_plain(x, nslices, rows_p, kp) for x in X]
    return tuple(torch.stack(t) for t in zip(*outs))


def slice_operand_batched(X, nslices: int):
    """`slice_operand` of every entry of a batch X (C, rows, k) f64 (any
    strides, each entry read in place), rows and k padded to multiples of
    64 and 32: (slices (C, rows_p / 64, kp / 32, nslices, 2048), scales
    (C, rows)).  One launch of csrc/slicing.cu's `slice_rows_batched` for
    a CUDA tensor (the slicing kernel with the batch on its grid,
    `slice_plan(rows_p, kp, C, ...)`); the plain version for a CPU
    one."""
    if X.dtype != torch.float64 or X.dim() != 3 or X.shape[0] == 0:
        raise TypeError("slice_operand_batched takes a (C, rows, k) "
                        "float64 operand")
    if X.device.type == "cpu":
        return slice_operand_batched_plain(X, nslices)
    _check_cuda(X)
    nb, rows, k = X.shape
    rows_p, kp = _slicing_shape(X[0], nslices, None, None)
    plan = slice_plan(rows_p, kp, nb, X.stride(2) != 1)
    out, scale = _slicing_buffers(X, nslices, rows_p, kp, nb)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _slicing_lib().slice_rows_batched(
            X.data_ptr(), X.stride(0), X.stride(1), X.stride(2), nb, rows, k,
            rows_p, kp, nslices, *plan, scale.data_ptr(), out.data_ptr(),
            stream)
        slice_operand_batched.launches += 1
    _build.check(err, "slice_rows_batched")
    return out, scale


slice_operand_batched.launches = 0


def _check_cuda(*ts):
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(
                f"expected all-CPU or all-CUDA tensors, got {t.device}")


def _first_live(row_start) -> int:
    """row_start rounded down to the 256 grain: the first live tile row
    (or column, for the syrk contracts) of the 256-tile contracts; 0 for
    None."""
    return 0 if row_start is None else max(int(row_start), 0) // TILE * TILE


def _check_carry(Ahi, Alo):
    """Checks a square, contiguous f32 pair carry on the 256 grain;
    returns its size m."""
    m = Ahi.shape[0]
    if Ahi.shape != (m, m) or Alo.shape != (m, m):
        raise ValueError("the pair carry must be (m, m)")
    if Ahi.dtype != torch.float32 or Alo.dtype != torch.float32:
        raise TypeError("the pair carry is float32")
    if m % TILE:
        raise ValueError(f"pair carry needs m % {TILE} == 0, got {m}")
    if not (Ahi.is_contiguous() and Alo.is_contiguous()):
        raise ValueError("the pair carry must be contiguous")
    return m


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
    _check_depth(k)
    r0 = min(_first_live(row_start), m)
    if r0 == m or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.float64, device=A.device)
    ops = _k2_operands(A, B, ns, r0)
    C = torch.empty((m, n), dtype=torch.float64, device=A.device)
    _k2_product(ops, C, ns, lower_only, row_start, col_start, col_end, r0)
    return C


def _k2_operands(A, B, ns: int, r0: int):
    """K2's operands on the card: the tiled slices and scales of A's rows
    from r0 and of B's columns (the rows of B^T), one slicing launch
    each."""
    kp = _round_up(A.shape[1], _BK)
    return (*slice_operand(A[r0:], ns, kp=kp), *slice_operand(B.T, ns, kp=kp))


def _k2_product(ops, C, ns: int, lower_only=False, row_start=None,
                col_start=None, col_end=None, r0: int = 0):
    """K2's product kernel alone, on `_k2_operands`' output, into C."""
    a_sl, sa, bt_sl, sb = ops
    m, n = C.shape
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().slice_matmul_tiled(
            a_sl.data_ptr(), bt_sl.data_ptr(), sa.data_ptr(), sb.data_ptr(),
            C.data_ptr(), m, n, a_sl.shape[1] * _BK, ns,
            int(bool(lower_only)),
            0 if row_start is None else int(row_start),
            0 if col_start is None else int(col_start),
            _round_up(n, _BM) if col_end is None else int(col_end), r0,
            stream)
        slice_matmul.launches += 1
    _build.check(err, "slice_matmul")


slice_matmul.launches = 0


def _sub_lower_tiles_(Ahi, Alo, C, c0: int):
    """(Ahi, Alo) -= C on the lower 256-tiles of the trailing square from
    c0 (C is that square), in f64, split back into a proper f32 pair; the
    rest of the carry is left bit-identical."""
    m = Ahi.shape[0]
    t = torch.arange(m - c0, device=C.device) // TILE
    live = t[:, None] >= t[None, :]
    hi = Ahi[c0:, c0:]
    lo = Alo[c0:, c0:]
    R = (hi.double() + lo.double()) - C
    nh = R.to(torch.float32)
    nl = (R - nh.double()).to(torch.float32)
    hi.copy_(torch.where(live, nh, hi))
    lo.copy_(torch.where(live, nl, lo))
    return Ahi, Alo


def syrk_sub_pair_plain_(Ahi, Alo, panel, row_start=None):
    """Plain PyTorch version of K1, in place on (Ahi, Alo)."""
    m = Ahi.shape[0]
    c0 = _first_live(row_start)
    if c0 >= m:
        return Ahi, Alo
    P = panel[c0:]
    sa = pow2_row_scales(P, 1)
    sl = int_slices(P / sa, INT_NSLICES)
    C = _group_combine(sl, sl) * (sa * sa.reshape(1, -1))
    return _sub_lower_tiles_(Ahi, Alo, C, c0)


def syrk_sub_pair_(Ahi, Alo, panel, row_start=None):
    """K1: (Ahi, Alo) -= panel @ panel.T on live lower 256-tiles, IN PLACE.

    Live tiles: tile row >= tile column, tile column at or right of
    row_start // 256 (the whole diagonal tile, its upper half included).
    Every other element is left bit-identical.  Panel rows above
    row_start must be zero (the caller's mask).  The carry is read as
    the exact f64 sum hi + lo, updated in f64 and split back into a
    proper f32 pair (~2^-48, above the product's ~2^-42 grade).  A call
    with no live tile (row_start >= m) launches nothing.  On the card
    panel[c0:] (c0 = row_start rounded down to 256) is sliced in place
    once for both sides (`_k8_operands`) and multiplied on K8's wgmma
    kernel with the pair epilogue (`_k1_product`); the result equals
    `syrk_sub_pair_plain_` bit for bit.  Returns (Ahi, Alo)."""
    m, k = panel.shape
    if _check_carry(Ahi, Alo) != m:
        raise ValueError("carry must be (m, m) with panel (m, k)")
    if panel.dtype != torch.float64:
        raise TypeError("the panel is float64")
    devs = {Ahi.device.type, Alo.device.type, panel.device.type}
    if devs == {"cpu"}:
        return syrk_sub_pair_plain_(Ahi, Alo, panel, row_start)
    _check_cuda(Ahi, Alo, panel)
    _check_depth(k)
    c0 = _first_live(row_start)
    if c0 >= m:
        return Ahi, Alo
    _k1_product(_k8_operands(panel, c0), Ahi, Alo, c0)
    return Ahi, Alo


def _k1_product(ops, Ahi, Alo, c0: int, counted=None):
    """K1's product kernel alone, on `_k8_operands`' output (or K11's
    slices, for K12): (Ahi, Alo) -= P P^T in place on the live lower tiles
    of the trailing square from c0.  The launch counts on `counted`,
    K1's wrapper by default."""
    sl, sa = ops
    with torch.cuda.device(Ahi.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().syrk_sub_pair(
            sl.data_ptr(), sa.data_ptr(), Ahi.data_ptr(), Alo.data_ptr(),
            Ahi.shape[0], sl.shape[1] * _BK, c0, INT_NSLICES, stream)
        (counted or syrk_sub_pair_).launches += 1
    _build.check(err, "syrk_sub_pair")


syrk_sub_pair_.launches = 0


def syrk_sub_pair_presliced_plain_(Ahi, Alo, p_sl, sa, row_start=None):
    """Plain PyTorch version of K12, in place on (Ahi, Alo)."""
    c0 = _first_live(row_start)
    if c0 >= Ahi.shape[0]:
        return Ahi, Alo
    planes = untile_layout(p_sl)
    C = _group_combine(planes, planes) * (sa[:, None] * sa[None, :])
    return _sub_lower_tiles_(Ahi, Alo, C, c0)


def syrk_sub_pair_presliced_(Ahi, Alo, p_sl, sa, row_start=None):
    """K12: K1's update, (Ahi, Alo) -= P P^T on the live lower 256-tiles
    IN PLACE, with P given as its int8 slices and exact pow2 row scales
    for P's rows from c0 = row_start rounded down to 256, in the tiled
    layout of the slicing kernel (`tile_layout`): p_sl ((m - c0) / 64, kp
    / 32, INT_NSLICES, 2048) int8 and sa (m - c0,) f64, as K11
    (`panel.pair_to_slices`) writes them.  Slice rows above row_start
    must be zero.  Launches K1's product kernel on them as they are, with
    its own count; a call with no live tile (row_start >= m) launches
    nothing.  Returns (Ahi, Alo)."""
    m = _check_carry(Ahi, Alo)
    c0 = _first_live(row_start)
    nr = max(m - c0, 0)
    if p_sl.dtype != torch.int8 or p_sl.dim() != 4 or (
            p_sl.shape[0] != nr // _BM or p_sl.shape[2:] != (
                INT_NSLICES, _BM * _BK)):
        raise ValueError(
            f"p_sl must be ({nr // _BM}, kp / {_BK}, {INT_NSLICES}, "
            f"{_BM * _BK}) int8, got {tuple(p_sl.shape)} {p_sl.dtype}")
    kp = p_sl.shape[1] * _BK
    if kp > _MAX_K:
        raise ValueError(f"kp={kp} exceeds the exact int32 depth {_MAX_K}")
    if sa.dtype != torch.float64 or sa.shape != (nr,):
        raise ValueError(f"sa must be ({nr},) float64")
    devs = {Ahi.device.type, Alo.device.type, p_sl.device.type,
            sa.device.type}
    if devs == {"cpu"}:
        return syrk_sub_pair_presliced_plain_(Ahi, Alo, p_sl, sa, row_start)
    _check_cuda(Ahi, Alo, p_sl, sa)
    if nr == 0:
        return Ahi, Alo
    _k1_product((p_sl.contiguous(), sa.contiguous()), Ahi, Alo, c0,
                counted=syrk_sub_pair_presliced_)
    return Ahi, Alo


syrk_sub_pair_presliced_.launches = 0


def syrk_lower_plain(A, row_start=None, a_upper: bool = False):
    """Plain PyTorch version of K8 (a_upper only skips exact zeros in the
    kernel, so it changes nothing here)."""
    m = A.shape[0]
    sa = pow2_row_scales(A, 1)
    sl = int_slices(A / sa, INT_NSLICES)
    C = _group_combine(sl, sl) * (sa * sa.reshape(1, -1))
    keep = _contract_mask(m, m, C.device, True, None, row_start, None)
    return torch.where(keep, C, 0.0)


def _check_syrk(A):
    if A.dtype != torch.float64 or A.dim() != 2:
        raise TypeError("K8 takes a 2-D float64 operand")


def _check_depth(k: int):
    if k > _MAX_K:
        raise ValueError(f"k={k} exceeds the exact int32 depth {_MAX_K}")


def syrk_lower(A, row_start=None, a_upper: bool = False):
    """K8: C = A @ A.T (f64, (m, m)) on lower 256-tiles.

    The contract of the reference's triangular grid: tiles with tile row
    >= tile column are computed, diagonal tiles in full, except tile
    columns wholly above row_start (their entries are zero anyway, since
    the caller guarantees A's rows above row_start are zero).  Where the
    reference left the unvisited tiles undefined, they are exact zeros
    here, as K2 writes them.  a_upper: the caller guarantees A[i, k] == 0
    for k < i, and the kernel skips those exact-zero k ranges.  m need
    not be a multiple of 256.  On the card A[c0:] (c0 = row_start rounded
    down to 256) is sliced in place (`_k8_operands`) and multiplied on the
    wgmma tile, whose kernel also writes every zero of C (`_k8_product`):
    the result equals `syrk_lower_plain` bit for bit.  A call with
    row_start >= m (every operand row zero) returns zeros and launches
    nothing."""
    _check_syrk(A)
    if A.device.type == "cpu":
        return syrk_lower_plain(A, row_start, a_upper)
    _check_cuda(A)
    m, k = A.shape
    _check_depth(k)
    if k == 0 or (row_start is not None and int(row_start) >= m):
        return torch.zeros((m, m), dtype=torch.float64, device=A.device)
    c0 = _first_live(row_start)
    C = torch.empty((m, m), dtype=torch.float64, device=A.device)
    _k8_product(_k8_operands(A, c0), C, c0, a_upper=a_upper)
    return C


def syrk_sub_lower_plain_(A, P, row_start: int):
    """Plain PyTorch version of K8's in-place step:
    A[rs:, rs:] -= syrk_lower_plain(P, rs)[rs:, rs:]."""
    rs = int(row_start)
    A[rs:, rs:] -= syrk_lower_plain(P, rs)[rs:, rs:]
    return A


def syrk_sub_lower_(A, P, row_start: int):
    """K8's in-place step of the f64-carry factorisation: A[r, c] -= (P
    P^T)[r, c] for r, c >= row_start on K8's lower 256-tiles (diagonal
    256-tiles in full); nothing else of A is read or written, and no (m,
    m) product exists.  P (m, k) f64 with rows above row_start zero (the
    caller's mask), A (m, m) contiguous f64.  Equal bit for bit to
    `syrk_sub_lower_plain_`, the two-step form that subtracted all of
    `syrk_lower`'s C on A[rs:, rs:]: there C's strictly-upper tiles are
    exact zeros, and a - (+0.0) is a bit for bit.  (The reference's K8
    leaves those tiles unspecified and its caller masks them.)  Its
    launches count under `syrk_lower.launches`.  A call with row_start >=
    m launches nothing.  Returns A."""
    _check_syrk(P)
    m, k = P.shape
    if A.dtype != torch.float64 or A.shape != (m, m):
        raise ValueError(f"A must be ({m}, {m}) float64 with P ({m}, k)")
    if {A.device.type, P.device.type} == {"cpu"}:
        return syrk_sub_lower_plain_(A, P, row_start)
    _check_cuda(A, P)
    _check_depth(k)
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    rs = int(row_start)
    if k == 0 or rs >= m:
        return A
    c0 = _first_live(rs)
    _k8_product(_k8_operands(P, c0), A, c0, row_start=rs)
    return A


def _k8_operands(A, c0: int):
    """K8's (and K1's) operand on the card: the tiled slices and scales of
    A's rows from c0, one slicing launch; they serve as both sides of the
    product."""
    return slice_operand(A[c0:], INT_NSLICES, kp=_round_up(A.shape[1], _BK))



def _k8_product(ops, C, c0: int, a_upper: bool = False, row_start=None):
    """K8's product kernel alone, on `_k8_operands`' output: C = P P^T
    with every zero written (row_start None), or C -= P P^T in place from
    row_start on."""
    sl, sa = ops
    m = C.shape[0]
    kp = sl.shape[1] * _BK
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream().cuda_stream
        if row_start is None:
            err = _lib().syrk_lower(sl.data_ptr(), sa.data_ptr(),
                                    C.data_ptr(), m, kp, c0,
                                    int(bool(a_upper)), INT_NSLICES, stream)
        else:
            err = _lib().syrk_sub_lower(sl.data_ptr(), sa.data_ptr(),
                                        C.data_ptr(), m, kp, c0,
                                        int(row_start), INT_NSLICES, stream)
        syrk_lower.launches += 1
    _build.check(err, "syrk_lower")


syrk_lower.launches = 0


def _live_rect(m: int, n: int, row_start, col_end):
    """(first live row, live column count) of K4's 256-tile contract."""
    r0 = _first_live(row_start)
    nc = n if col_end is None else min(
        _round_up(max(int(col_end), 0), TILE), n)
    return r0, nc


def mm_sub_pair_plain_(Rhi, Rlo, A, B, row_start=None, col_end=None):
    """Plain PyTorch version of K4, in place on (Rhi, Rlo)."""
    m, n = Rhi.shape
    r0, nc = _live_rect(m, n, row_start, col_end)
    if r0 >= m or nc == 0:
        return Rhi, Rlo
    Ar = A[r0:]
    Bc = B[:, :nc]
    sa = pow2_row_scales(Ar, 1)
    sb = pow2_row_scales(Bc, 0)
    C = _group_combine(int_slices(Ar / sa, INT_NSLICES),
                       int_slices((Bc / sb).T, INT_NSLICES)) * (sa * sb)
    hi = Rhi[r0:, :nc]
    lo = Rlo[r0:, :nc]
    R = (hi.double() + lo.double()) - C
    nh = R.to(torch.float32)
    hi.copy_(nh)
    lo.copy_((R - nh.double()).to(torch.float32))
    return Rhi, Rlo


def mm_sub_pair_(Rhi, Rlo, A, B, row_start=None, col_end=None):
    """K4: (Rhi, Rlo) -= A @ B on the live 256-tiles, IN PLACE.

    Live tiles: tile rows at or below row_start // 256 and tile columns
    left of col_end (rounded up to 256).  Every other element is left
    bit-identical.  The caller guarantees that A's rows above row_start
    and B's columns from col_end on are zero, as the blocked identity
    solve's masks make them.  The carry is read as the exact f64 sum
    hi + lo, updated in f64 and split back into a proper f32 pair.  A
    call with no live tile (row_start >= m, or col_end <= 0) launches
    nothing.  Rows of A above row_start // 256 * 256 and columns of B from
    the live width on are never read.  On the card A[r0:] and B[:, :nc]^T
    are sliced in place (`slice_operand`) and multiplied on the wgmma tile
    (`_k4_product`); the result equals `mm_sub_pair_plain_` bit for bit.
    Returns (Rhi, Rlo)."""
    m, k = A.shape
    if B.dim() != 2 or B.shape[0] != k:
        raise ValueError(f"bad shapes {tuple(A.shape)} @ {tuple(B.shape)}")
    n = B.shape[1]
    if Rhi.shape != (m, n) or Rlo.shape != (m, n):
        raise ValueError("carry must be (m, n) with A (m, k), B (k, n)")
    if Rhi.dtype != torch.float32 or Rlo.dtype != torch.float32:
        raise TypeError("the pair carry is float32")
    if A.dtype != torch.float64 or B.dtype != torch.float64:
        raise TypeError("A and B are float64")
    if m % TILE or n % TILE:
        raise ValueError(f"pair carry needs m, n % {TILE} == 0, got {m}, {n}")
    if not (Rhi.is_contiguous() and Rlo.is_contiguous()):
        raise ValueError("the pair carry must be contiguous")
    devs = {Rhi.device.type, Rlo.device.type, A.device.type, B.device.type}
    if devs == {"cpu"}:
        return mm_sub_pair_plain_(Rhi, Rlo, A, B, row_start, col_end)
    _check_cuda(Rhi, Rlo, A, B)
    _check_depth(k)
    r0, nc = _live_rect(m, n, row_start, col_end)
    if r0 >= m or nc == 0:
        return Rhi, Rlo
    _k4_product(_k4_operands(A, B, r0, nc), Rhi, Rlo, r0)
    return Rhi, Rlo


def _k4_operands(A, B, r0: int, nc: int):
    """K4's operands on the card: the tiled slices and scales of A's rows
    from r0 and of B's first nc columns (the rows of B[:, :nc]^T), both
    views read in place, one slicing launch each."""
    kp = _round_up(A.shape[1], _BK)
    return (*slice_operand(A[r0:], INT_NSLICES, kp=kp),
            *slice_operand(B[:, :nc].T, INT_NSLICES, kp=kp))


def _k4_product(ops, Rhi, Rlo, r0: int):
    """K4's product kernel alone, on `_k4_operands`' output, into the
    live rectangle of (Rhi, Rlo) from row r0."""
    a_sl, sa, bt_sl, sb = ops
    m, n = Rhi.shape
    with torch.cuda.device(Rhi.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().mm_sub_pair(
            a_sl.data_ptr(), bt_sl.data_ptr(), sa.data_ptr(), sb.data_ptr(),
            Rhi.data_ptr(), Rlo.data_ptr(), m, n, a_sl.shape[1] * _BK, r0,
            bt_sl.shape[0] * _BM, INT_NSLICES, stream)
        mm_sub_pair_.launches += 1
    _build.check(err, "mm_sub_pair")


mm_sub_pair_.launches = 0


def _syrk_tn_plain(planes, sW):
    """W^T W on lower 256-tiles from W's planes in W^T layout (ns, m, kp)
    and its (m,) column scales, strictly-upper tiles exact zeros: the
    plain versions' arithmetic of K6 and K7."""
    m = planes.shape[1]
    C = _group_combine(planes, planes) * (sW[:, None] * sW[None, :])
    keep = _contract_mask(m, m, C.device, True, None, None, None)
    return torch.where(keep, C, 0.0)


def syrk_tn_lower_presliced_plain(w_sl, sW, w_lower: bool = False):
    """Plain PyTorch version of K6: its tiled slices back to planes
    (`untile_layout`), then `_group_combine` (w_lower only skips exact
    zeros in the kernel, so it changes nothing here)."""
    return _syrk_tn_plain(untile_layout(w_sl), sW)


def _deep_tiles(mp: int, kp: int, w_lower: bool) -> int:
    """nd: the 64-tiles deeper than _K_CHUNK are those in the first nd
    tile rows and columns (with w_lower a tile's depth is kp - max(row0,
    col0)) of mp rows (m rounded up to 64)."""
    if kp <= _K_CHUNK:
        return 0
    if not w_lower:
        return mp // _BM
    return min(-(-(kp - _K_CHUNK) // _BM), mp // _BM)


def syrk_tn_lower_presliced(w_sl, sW, w_lower: bool = False):
    """K6: C = W^T W (f64, (m, m)) from W's int8 slices in W^T layout.

    w_sl: (m / 64, m / 32, TN_NSLICES, 2048) int8, the slices of W^T's
    rows (W[k, i] / sW[i] in plane s at row i, column k) in the tiled
    layout of `tile_layout`, as K5 (`panel.pair_to_slices_cols`, the
    slicing kernel's pair mode on W^T) writes them; sW: (m,) f64 exact
    power-of-two column scales of W; m a multiple of 256.  Lower
    256-tiles are computed, diagonal tiles in full; strictly-upper tiles
    are exact zeros.  w_lower: the caller guarantees W[k, i] == 0 for
    k < i (W lower-triangular, as L^-1 is), and the kernel skips those
    exact-zero k ranges (~2/3 of the work).  On the card it launches K7's
    product on the slices as they are (`_k7_product`, its own count):
    tiles deeper than _K_CHUNK (2^14, the exact int32 depth of the slice
    sums) contract in k pieces whose exact group sums are added before
    the f64 combine, so any m gives the single-pass result, and C equals
    `syrk_tn_lower_presliced_plain` bit for bit."""
    if w_sl.dim() != 4 or w_sl.dtype != torch.int8:
        raise TypeError("w_sl must be the tiled (m / 64, m / 32, nslices, "
                        "2048) int8 slices")
    m = w_sl.shape[0] * _BM
    if w_sl.shape[1:] != (m // _BK, TN_NSLICES, _BM * _BK):
        raise ValueError(
            f"w_sl must be ({m // _BM}, {m // _BK}, {TN_NSLICES}, "
            f"{_BM * _BK}), got {tuple(w_sl.shape)}")
    if sW.dtype != torch.float64 or sW.shape != (m,):
        raise ValueError(f"sW must be ({m},) float64")
    if m % TILE:
        raise ValueError(f"K6 needs m % {TILE} == 0, got {m}")
    if {w_sl.device.type, sW.device.type} == {"cpu"}:
        return syrk_tn_lower_presliced_plain(w_sl, sW, w_lower)
    _check_cuda(w_sl, sW)
    if not w_sl.is_contiguous():
        raise ValueError("w_sl must be contiguous")
    C = torch.empty((m, m), dtype=torch.float64, device=w_sl.device)
    _k7_product(w_sl, sW.contiguous(), C, w_lower,
                counted=syrk_tn_lower_presliced)
    return C


syrk_tn_lower_presliced.launches = 0


def _tn_scales(W):
    """Exact pow2 column scales of W, shape (m,)."""
    return pow2_row_scales(W, 0).reshape(-1)


def syrk_tn_lower_plain(W, w_lower: bool = False):
    """Plain PyTorch version of K7."""
    sW = _tn_scales(W)
    return _syrk_tn_plain(int_slices((W / sW).T, TN_NSLICES), sW)


def syrk_tn_lower(W, w_lower: bool = False):
    """K7: C = W^T W (W f64 (k, m)) on lower 256-tiles, strictly-upper
    tiles exact zeros.  W is sliced on the card (`slice_operand` of W^T:
    TN_NSLICES planes with exact pow2 column scales, read in place) and
    multiplied on the wgmma tile, the k range of a tile deeper than
    _K_CHUNK cut into pieces whose exact int32 sums add before the f64
    combine (`_k7_product`).  w_lower: the caller
    guarantees W[k, i] == 0 for k < i, and the kernel skips those
    exact-zero k ranges.  The result equals `syrk_tn_lower_plain` bit for
    bit."""
    if W.dtype != torch.float64 or W.dim() != 2:
        raise TypeError("syrk_tn_lower takes a 2-D float64 operand")
    if W.device.type == "cpu":
        return syrk_tn_lower_plain(W, w_lower)
    _check_cuda(W)
    k, m = W.shape
    if m == 0 or k == 0:
        return torch.zeros((m, m), dtype=torch.float64, device=W.device)
    w_sl, sW = slice_operand(W.T, TN_NSLICES)
    C = torch.empty((m, m), dtype=torch.float64, device=W.device)
    _k7_product(w_sl, sW, C, w_lower)
    return C


def _k7_product(w_sl, sW, C, w_lower: bool, counted=None):
    """K7's product kernels alone (the pieces, and the combine of the
    tiles of several pieces) on `slice_operand(W.T, TN_NSLICES)`, or on
    K5's slices for K6.  The launch counts on `counted`, K7's wrapper by
    default.

    The grid is the live lower 64-tiles in L2-sharing groups of tile rows
    (K8's walk), and their mirrored upper tiles are zeroed in the same
    launch.  A tile's k range, from its own first chunk, runs in pieces
    of _K_CHUNK, so each piece's int32 group sums stay exact; the tiles of
    more than one piece (deeper than _K_CHUNK) are those in the first nd
    tile rows and columns (`_deep_tiles`), whose sums go to int32 slots
    that the combine kernel adds.  Shorter pieces, to balance the uneven
    tiles over the SMs, were slower on the card at every m measured, 300
    to 2048 (PERF.md, Findings)."""
    m = C.shape[0]
    nt, nkc = w_sl.shape[0], w_sl.shape[1]
    dc = _K_CHUNK // _BK
    nd = _deep_tiles(nt * _BM, nkc * _BK, w_lower)
    npieces = -(-nkc // dc)
    slots = (torch.empty((nd, nd, npieces, TN_NSLICES, _BM * _BM),
                         dtype=torch.int32, device=C.device) if nd else None)
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().syrk_tn_tiled(
            w_sl.data_ptr(), sW.data_ptr(), C.data_ptr(), m, nkc * _BK,
            TN_NSLICES, int(bool(w_lower)), dc,
            0 if slots is None else slots.data_ptr(), nd, npieces, stream)
        (counted or syrk_tn_lower).launches += 1
    _build.check(err, "syrk_tn_lower")


syrk_tn_lower.launches = 0


def syrk_tn_lower_batched_plain(W, w_lower: bool = False):
    """Plain PyTorch version of `syrk_tn_lower_batched`:
    `syrk_tn_lower_plain` of each entry, stacked."""
    return torch.stack([syrk_tn_lower_plain(w, w_lower) for w in W])


def syrk_tn_lower_batched(W, w_lower: bool = False):
    """K7 on a batch: C[i] = W[i]^T W[i] on lower 256-tiles for W (C, k, m)
    f64, k <= 2^14, strictly-upper tiles exact zeros; w_lower as in
    `syrk_tn_lower` (every entry lower-triangular).  On the card: one
    slicing call on the stacked W[i]^T (`slice_operand_batched`, one
    kernel reading each W[i] once, in place) and one launch of K7's product kernel with the batch index on
    its grid (no k pieces at this depth).  Entry i equals
    `syrk_tn_lower(W[i])` and `syrk_tn_lower_plain(W[i])` bit for bit."""
    if W.dtype != torch.float64 or W.dim() != 3 or W.shape[0] == 0:
        raise TypeError("syrk_tn_lower_batched takes a (C, k, m) float64 "
                        "operand")
    if W.device.type == "cpu":
        return syrk_tn_lower_batched_plain(W, w_lower)
    _check_cuda(W)
    nb, k, m = W.shape
    if k > _MAX_K:
        raise ValueError(f"syrk_tn_lower_batched takes k <= {_MAX_K}, "
                         f"got {k}")
    w_sl, sW = slice_operand_batched(W.transpose(1, 2), TN_NSLICES)
    C = torch.empty((nb, m, m), dtype=torch.float64, device=W.device)
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().syrk_tn_tiled_batched(
            w_sl.data_ptr(), sW.data_ptr(), C.data_ptr(), m,
            w_sl.shape[2] * _BK, TN_NSLICES, int(bool(w_lower)), nb, stream)
        syrk_tn_lower_batched.launches += 1
    _build.check(err, "syrk_tn_lower_batched")
    return C


syrk_tn_lower_batched.launches = 0
