"""Fitted GP surrogate state (counterpart of GPState in
andvaranaut_tpu/gpmcmc.py; the GPMCMC facade is not ported yet).

A state fitted by the JAX package carries across as its constructor
arguments: kernel spec, converted data and the hypers dict of numpy
arrays (`GPMCMC.hypers` / `GPState.hypers`).
"""

from __future__ import annotations

import numpy as np
import torch

from ._config import DTYPE, resolve_device
from .gp import engine

__all__ = ["GPState"]

#: route conditioning and prediction through the mixed blocked
#: factorisation at any size and device (CPU parity tests); by default
#: it runs on CUDA at n >= GPState.MIXED_N
FORCE_MIXED = False


class GPState:
    """Converted data bound to hyperparameters; conditions once (cached
    per jitter) and predicts in query chunks.

    Data is bucket-padded with phantom identity rows.  At MIXED_N
    training rows and more on the card, conditioning and prediction run
    the mixed-precision blocked factorisation at MIXED_BLOCK, whose
    kernels (K1-K3) carry the O(n^3) work; below it the exact f64 path.
    The state lives on DEVICE: None means the CUDA card (an error
    without one); set it to "cpu" to run the plain versions."""

    BUCKET = 32
    MIXED_N = 4096
    MIXED_BLOCK = 1024
    #: query rows per predict call: bounds the (n_train, nq) f64
    #: cross-Gram (2 GB at 16k train rows)
    QCHUNK = 16384
    DEVICE = None

    def __init__(self, kerns, ops, noise, jitter, xin, yin, hypers):
        self.kerns = tuple(kerns)
        self.ops = tuple(ops)
        self.noise = noise
        self.jitter = jitter
        self.xin = np.asarray(xin)
        self.yin = np.asarray(yin)
        self.hypers = hypers
        self._cache = {}

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_cache"] = {}
        return d

    @property
    def device(self) -> torch.device:
        return resolve_device(self.DEVICE)

    def _mixed(self):
        if FORCE_MIXED:
            return True
        return (self.device.type == "cuda"
                and self.xin.shape[0] >= self.MIXED_N)

    def _bucket(self):
        return self.MIXED_BLOCK if self._mixed() else self.BUCKET

    def padded(self):
        return engine.pad_data(self.xin, self.yin, self._bucket(),
                               device=self.device)

    def hyper_args(self):
        return engine.hypers_to_args(self.hypers, self.noise,
                                     device=self.device)

    def chol(self, jitter=None):
        """Cached conditioning state over padded data: (L, v, xin_p,
        valid, Dinv); v is L^-1 y on the exact path and K^-1 y on the
        mixed path, Dinv the diagonal-block inverses (None when exact)."""
        j = self.jitter if jitter is None else jitter
        if j not in self._cache:
            l, kv, gv, alpha = self.hyper_args()
            xin_p, yin_p, valid = self.padded()
            if self._mixed():
                L, v, Dinv = engine.chol_state_masked_mixed(
                    self.kerns, self.ops, xin_p, yin_p, valid, l, kv, gv,
                    alpha, j, block=self.MIXED_BLOCK)
            else:
                L, v = engine.chol_state_masked(
                    self.kerns, self.ops, xin_p, yin_p, valid, l, kv, gv,
                    alpha, j)
                Dinv = None
            self._cache[j] = (L, v, xin_p, valid, Dinv)
        return self._cache[j]

    def predict(self, xnew, jitter=None):
        """Predictive mean and variance (numpy, f64) at xnew (m, nx)."""
        l, kv, gv, alpha = self.hyper_args()
        L, v, xin_p, valid, Dinv = self.chol(jitter)
        xq_all = torch.as_tensor(np.asarray(xnew, dtype=np.float64),
                                 dtype=DTYPE, device=xin_p.device)
        m = xq_all.shape[0]

        def run(xq):
            if Dinv is not None:
                return engine.predict_from_chol_masked_mixed(
                    self.kerns, self.ops, xin_p, valid, L, v, Dinv, xq,
                    l, kv, gv, alpha)
            return engine.predict_from_chol_masked(
                self.kerns, self.ops, xin_p, valid, L, v, xq, l, kv, gv,
                alpha)

        mus, vars_ = [], []
        for lo in range(0, max(m, 1), self.QCHUNK):
            xq = xq_all[lo:lo + self.QCHUNK]
            take = xq.shape[0]
            mpad = engine.round_up(max(take, 1), self.BUCKET)
            if mpad != take:
                xq = torch.cat([xq, xq.new_zeros((mpad - take,
                                                  xq.shape[1]))])
            mu, var = run(xq)
            mus.append(mu[:take].cpu().numpy())
            vars_.append(var[:take].cpu().numpy())
        return np.concatenate(mus), np.concatenate(vars_)
