"""K5, K10 and K11: the panel kernels of the pair-carry factorisation
(counterpart of andvaranaut_tpu/gp/pallas_panel.py).

`pair_to_slices_cols` (K5) turns the pair-carried L^-1 of the identity
solve into the operand of K6 (`slicemm.syrk_tn_lower_presliced`, K^-1 =
L^-T L^-1) without assembling an f64 copy of it: the slicing kernel's
pair mode on the transposed view, in the tiled layout that K6's wgmma
product streams.

The fused panel stage of `precision._chol_steps_pair`, chosen by
ANDVARANAUT_FUSED_PANEL (`use_fused_panel`), replaces each step's f64
column assembly, panel product (K2), mask, pair split and the trailing
update's slicing by two launches: `panel_into_carry_` (K10) writes the
finished panel into the carry's own column block in place, and
`pair_to_slices` (K11) cuts it from the carry into the slices that K12
(`slicemm.syrk_sub_pair_presliced_`) subtracts.  Both cut the window with
the slicing kernel's pair mode (`slicemm.slice_pair_operand`, csrc/
slicing.cu) into the tiled layout of the wgmma tile: K10 before its
product overwrites the window, K11 after.  They slice the pair in f64:
hi + lo of an f32 pair is exact in f64, and 6 x 7 bits stay inside f64's
mantissa, so the slices are those of the exact pair value.  The
reference's f32 two-sum arithmetic (`_extract_slices`) gives the same
slices except where its rounding of hi + lo moves one slice by 1 and the
next by -128 with the same represented value.  The row scales come from
the hi plane, as in the reference.

Each wrapper takes the plain version for CPU tensors and launches its
CUDA kernels (csrc/panel.cu for K10, csrc/slicing.cu for K5, K10's
window and K11) for CUDA tensors, or raises; `launches` counts the
wrapper's calls of its kernels.
"""

from __future__ import annotations

import ctypes
import os

import torch

from .. import _build
from .slicemm import (_BK, _BM, INT_NSLICES, TILE, TN_NSLICES,
                      _check_carry, _check_cuda, _first_live, _group_combine,
                      int_slices, pow2_row_scales, slice_operand,
                      slice_pair_operand, slice_pair_operand_plain,
                      untile_layout)

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"panel_into_carry": [_VP] * 6 + [_I] * 6 + [_VP]}


def use_fused_panel(device) -> bool:
    """Whether the pair-carry factorisation on `device` takes the fused
    panel stage (K10 -> K11 -> K12), from ANDVARANAUT_FUSED_PANEL, read at
    each call: 0 (the default) off; 1 on for CUDA devices; 2 on for any
    device, so the CPU runs the plain versions of the same route.  The
    reference's default is off too (a TPU measurement); this card's A/B
    is in PERF.md.  The knob chooses between two kernel routes and never
    a plain version on the card."""
    mode = int(os.environ.get("ANDVARANAUT_FUSED_PANEL", "0"))
    return mode == 2 or (mode == 1 and torch.device(device).type == "cuda")


def _lib():
    return _build.library("panel", _SIGS)


def pair_to_slices_cols_plain(Whi, Wlo):
    """Plain PyTorch version of K5: `slicemm.slice_pair_operand_plain` of
    the transposed view."""
    m = Whi.shape[0]
    return slice_pair_operand_plain(Whi.T, Wlo.T, TN_NSLICES, 0, m, m)


def pair_to_slices_cols(Whi, Wlo):
    """K5: the TN_NSLICES int8 slices (the slice count of the gradient's
    K^-1 product, 8 where the reference used 6) and pow2 column scales of
    the (m, m) pair W = Whi + Wlo, m a multiple of 256.  Returns (w_sl,
    sW): w_sl (m / 64, m / 32, TN_NSLICES, 2048) int8, the slices of W^T's
    rows (W[k, i] / sW[i] in plane s at row i, column k) in the tiled
    layout of `slicemm.tile_layout`, the operand of K6
    (`slicemm.syrk_tn_lower_presliced`); sW (m,) f64.

    It is the slicing kernel's pair mode (`slicemm.slice_pair_operand`)
    on the transposed view (Whi^T, Wlo^T), read in place: its row scales,
    from the hi plane, are W's column scales exactly as the reference
    makes them; the value is the exact f64 sum hi + lo, divided by its
    exact scale and cut by the exact `int_slices` steps, so kernel and
    plain version agree bit for bit.  The reference instead carried the
    value as an f32 pair, whose rounding can move one slice by 1 and the
    next by -128 with the same represented value (to the slice grade):
    compare the two by their reconstructions, not slice by slice.  Exact
    zeros (L^-1's upper triangle) give exact-zero slices, which K6's
    w_lower skip relies on.  On the card one launch of the pair mode,
    counted here and under `slicemm.slice_pair_operand`."""
    _check_carry(Whi, Wlo)
    if {Whi.device.type, Wlo.device.type} == {"cpu"}:
        return pair_to_slices_cols_plain(Whi, Wlo)
    _check_cuda(Whi, Wlo)
    out = slice_pair_operand(Whi.T, Wlo.T, TN_NSLICES)
    pair_to_slices_cols.launches += 1
    return out


pair_to_slices_cols.launches = 0


def _check_window(Ahi, Alo, lo: int, block: int):
    m = _check_carry(Ahi, Alo)
    if block <= 0 or block % TILE or lo < 0 or lo % TILE or lo + block > m:
        raise ValueError(
            f"the column block needs lo, block multiples of {TILE} with lo + "
            f"block <= m, got lo={lo}, block={block}, m={m}")
    return m


def _window_operand(Ahi, Alo, lo: int, row_start: int, block: int):
    """The slicing kernel's pair mode on the carry's column block [lo, lo
    + block), rows from c0 = row_start rounded down to 256, rows above
    row_start zero: (tiled slices, hi-plane scales).  One slicing launch
    on the card."""
    c0 = _first_live(row_start)
    cols = slice(lo, lo + block)
    return slice_pair_operand(Ahi[c0:, cols], Alo[c0:, cols], INT_NSLICES,
                              zero_rows=int(row_start) - c0)


def pair_to_slices_plain(Ahi, Alo, lo: int, row_start: int, block: int):
    """Plain PyTorch version of K11: `slicemm.slice_pair_operand_plain` of
    the window."""
    m = Ahi.shape[0]
    c0 = min(_first_live(row_start), m)
    cols = slice(lo, lo + block)
    return slice_pair_operand_plain(Ahi[c0:, cols], Alo[c0:, cols],
                                    INT_NSLICES, max(int(row_start) - c0, 0),
                                    m - c0, block)


def pair_to_slices(Ahi, Alo, lo: int, row_start: int, block: int):
    """K11: the INT_NSLICES int8 slices and exact pow2 row scales of the
    (m, m) pair carry's column block [lo, lo + block), rows from c0 =
    row_start rounded down to 256, in the tiled layout that K12 reads
    (`slicemm.tile_layout`): (p_sl ((m - c0) / 64, block / 32,
    INT_NSLICES, 2048) int8, sa (m - c0,) f64).  Slice rows above
    row_start are zero (the zero panel rows K12's update expects).  The
    scales come from the hi plane; m, lo and block are multiples of 256.
    On the card one launch of the slicing kernel's pair mode, counted
    here and under `slicemm.slice_pair_operand`; a call
    with no live row (row_start >= m) launches nothing."""
    m = _check_window(Ahi, Alo, lo, block)
    if {Ahi.device.type, Alo.device.type} == {"cpu"}:
        return pair_to_slices_plain(Ahi, Alo, lo, row_start, block)
    _check_cuda(Ahi, Alo)
    if _first_live(row_start) >= m:
        return (torch.empty((0, block // _BK, INT_NSLICES, _BM * _BK),
                            dtype=torch.int8, device=Ahi.device),
                torch.empty((0,), dtype=torch.float64, device=Ahi.device))
    out = _window_operand(Ahi, Alo, lo, row_start, block)
    pair_to_slices.launches += 1
    return out


pair_to_slices.launches = 0


def _linv_slices(Linv):
    """Linv's INT_NSLICES slices below exact pow2 row scales: the
    transposed second operand of P = A Linv^T, and the scales (block,)."""
    sb = pow2_row_scales(Linv, 1)
    return int_slices(Linv / sb, INT_NSLICES), sb.reshape(-1).contiguous()


def panel_into_carry_plain_(Ahi, Alo, Linv, lo: int, row_start: int,
                            block: int):
    """Plain PyTorch version of K10, in place on (Ahi, Alo)."""
    m = Ahi.shape[0]
    c0 = _first_live(row_start)
    if c0 >= m:
        return Ahi, Alo
    a_t, sa = pair_to_slices_plain(Ahi, Alo, lo, row_start, block)
    b_sl, sb = _linv_slices(Linv)
    C = _group_combine(untile_layout(a_t), b_sl) * (sa[:, None] * sb[None, :])
    h = C.to(torch.float32)
    r0 = int(row_start) - c0
    Ahi[row_start:, lo:lo + block] = h[r0:]
    Alo[row_start:, lo:lo + block] = (C - h.double()).to(torch.float32)[r0:]
    return Ahi, Alo


def panel_into_carry_(Ahi, Alo, Linv, lo: int, row_start: int, block: int):
    """K10: the finished panel P = A[:, lo:lo+block] @ Linv.T, A = Ahi +
    Alo, written IN PLACE into the carry's own column block as a proper
    f32 pair, rows >= row_start.  Rows above row_start and every column
    outside [lo, lo + block) are left bit-identical.  The product is K2's
    (the same slices and scales: the scales of the window's rows come from
    the hi plane, which gives the f64 rows' scales for a proper pair), so
    P equals `slicemm.slice_matmul(cols, Linv.T)` on those rows bit for
    bit.  On the card the window is cut by the slicing kernel's pair mode
    and Linv by `slice_operand` (`_k10_operands`), both before the wgmma
    product writes the carry (`_k10_product`).  m, lo and block are
    multiples of 256.  A call with no live row (row_start >= m) launches
    nothing.  Returns (Ahi, Alo)."""
    m = _check_window(Ahi, Alo, lo, block)
    if Linv.dtype != torch.float64 or Linv.shape != (block, block):
        raise ValueError(f"Linv must be ({block}, {block}) float64")
    if {Ahi.device.type, Alo.device.type, Linv.device.type} == {"cpu"}:
        return panel_into_carry_plain_(Ahi, Alo, Linv, lo, row_start, block)
    _check_cuda(Ahi, Alo, Linv)
    if _first_live(row_start) >= m:
        return Ahi, Alo
    _k10_product(_k10_operands(Ahi, Alo, Linv, lo, row_start, block), Ahi,
                 Alo, lo, row_start, block)
    return Ahi, Alo


def _k10_operands(Ahi, Alo, Linv, lo: int, row_start: int, block: int):
    """K10's operands on the card: the tiled slices and hi-plane scales of
    the window's rows from c0 (the pair mode, rows above row_start zero:
    K11's slices of the window before the product) and those of Linv's
    rows, one slicing launch each."""
    return (*_window_operand(Ahi, Alo, lo, row_start, block),
            *slice_operand(Linv, INT_NSLICES))


def _k10_product(ops, Ahi, Alo, lo: int, row_start: int, block: int):
    """K10's product kernel alone, on `_k10_operands`' output, into the
    carry's column block [lo, lo + block), rows >= row_start."""
    a_sl, sa, b_sl, sb = ops
    with torch.cuda.device(Ahi.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().panel_into_carry(
            Ahi.data_ptr(), Alo.data_ptr(), a_sl.data_ptr(), b_sl.data_ptr(),
            sa.data_ptr(), sb.data_ptr(), Ahi.shape[0], lo,
            _first_live(row_start), int(row_start), block, INT_NSLICES,
            stream)
        panel_into_carry_.launches += 1
    _build.check(err, "panel_into_carry")


panel_into_carry_.launches = 0
