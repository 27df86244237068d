"""K5: int8 slices of a pair-carried matrix with column scales
(counterpart of `pair_to_slices_cols` in
andvaranaut_tpu/gp/pallas_panel.py; the reference's other panel kernels
are not ported).

`pair_to_slices_cols` turns the pair-carried L^-1 of the identity solve
into the operand of K6 (`slicemm.syrk_tn_lower_presliced`, K^-1 =
L^-T L^-1) without assembling an f64 copy of it.  The wrapper takes the
plain version for CPU tensors and launches the CUDA kernel
(csrc/panel.cu) for CUDA tensors, or raises; `launches` counts the
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .slicemm import TILE, TN_NSLICES, int_slices, pow2_row_scales

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"pair_to_slices_cols": [_VP] * 4 + [_I] * 2 + [_VP]}


def _lib():
    return _build.library("panel", _SIGS)


def _col_scales(Whi):
    """Exact pow2 column scales from the hi plane, as the reference makes
    them (bit-equal to it), as an (m,) f64 tensor."""
    return pow2_row_scales(Whi, 0).reshape(-1).to(torch.float64)


def pair_to_slices_cols_plain(Whi, Wlo):
    """Plain PyTorch version of K5."""
    sW = _col_scales(Whi)
    W = (Whi.double() + Wlo.double()) / sW
    return int_slices(W.T, TN_NSLICES), sW


def pair_to_slices_cols(Whi, Wlo):
    """K5: the TN_NSLICES int8 slices (the slice count of the gradient's
    K^-1 product, 8 where the reference used 6) and pow2 column scales of
    the (m, m) pair W = Whi + Wlo.  Returns (w_sl, sW): w_sl
    (TN_NSLICES, m, m) int8 in W^T layout, w_sl[s, i, k] the s-th slice
    of W[k, i] / sW[i]; sW (m,) f64.

    The scales come from the hi plane, exactly as the reference makes
    them.  The value is the exact f64 sum hi + lo, divided by its exact
    scale and cut by the exact `int_slices` steps, so kernel and plain
    version agree bit for bit.  The reference instead carried the value
    as an f32 pair, whose rounding can move one slice by 1 and the next
    by -128 with the same represented value (to the slice grade):
    compare the two by their reconstructions, not slice by slice.  Exact
    zeros (L^-1's upper triangle) give exact-zero slices, which K6's
    w_lower skip relies on."""
    m = Whi.shape[0]
    if Whi.shape != (m, m) or Wlo.shape != (m, m):
        raise ValueError("the pair must be (m, m)")
    if Whi.dtype != torch.float32 or Wlo.dtype != torch.float32:
        raise TypeError("the pair is float32")
    if m % TILE:
        raise ValueError(f"K5 needs m % {TILE} == 0, got {m}")
    if {Whi.device.type, Wlo.device.type} == {"cpu"}:
        return pair_to_slices_cols_plain(Whi, Wlo)
    for t in (Whi, Wlo):
        if t.device.type != "cuda":
            raise ValueError(
                f"expected all-CPU or all-CUDA tensors, got {t.device}")
    if not (Whi.is_contiguous() and Wlo.is_contiguous()):
        raise ValueError("the pair must be contiguous")
    sW = _col_scales(Whi).contiguous()
    out = torch.empty((TN_NSLICES, m, m), dtype=torch.int8,
                      device=Whi.device)
    with torch.cuda.device(Whi.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().pair_to_slices_cols(
            Whi.data_ptr(), Wlo.data_ptr(), sW.data_ptr(), out.data_ptr(),
            m, TN_NSLICES, stream)
        pair_to_slices_cols.launches += 1
    _build.check(err, "pair_to_slices_cols")
    return out, sW


pair_to_slices_cols.launches = 0
