"""Latin-hypercube dataset layer (counterpart of andvaranaut_tpu/lhc.py:
`LHC` with sampling, deletion and data injection, and the conversion
helpers the GPMCMC facade uses).

The reference's netCDF persistence, `y_dist` plots and the generic
`_surrogate` base are not ported yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import numpy as np

from . import sampling
from .core import _core

__all__ = ["LHC", "_none_conrev"]

_DELETION_MODES = ("coarse_lhc", "random", "specific")


class LHC(_core):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.x = np.empty((0, self.nx))
        self.y = np.empty((0, self.ny))

    # -- sampling --------------------------------------------------------
    def sample(self, nsamps, seed=None):
        """LHC-sample nsamps points, constraint-filter, evaluate the
        target, append."""
        if not isinstance(nsamps, int) or nsamps < 1:
            raise Exception("Error: nsamps argument must be an integer > 0")
        if self.verbose:
            print(f"Evaluating {nsamps} latin hypercube samples...")
        xsamps = self.__latin_sample(nsamps, seed)
        if self.constraints is not None:
            xsamps = self._core__check_constraints(xsamps)
        xsamps, ysamps = self._core__vector_solver(xsamps)
        self.x = np.r_[self.x, xsamps]
        self.y = np.r_[self.y, ysamps]
        self.nsamp = len(self.x)

    def __latin_sample(self, nsamps, seed=None):
        return sampling.lhc_sample(self.priors, nsamps, seed=seed)

    # -- deletion --------------------------------------------------------
    def del_samples(self, ndels=None, method="coarse_lhc", idx=None):
        keep = self.__keep_mask(ndels, method, idx)
        self.x = self.x[keep]
        self.y = self.y[keep]
        self.nsamp = len(self.x)

    def __keep_mask(self, ndels, method, idx):
        """Boolean kept-row mask for any deletion mode.

        coarse_lhc: draw an ndels-point coarse LHC and drop the nearest
        surviving sample to each coarse point in turn.  random: drop a
        random size-ndels subset.  specific: drop the given indices."""
        n = len(self.x)
        keep = np.ones(n, dtype=bool)
        if method == "coarse_lhc":
            if not isinstance(ndels, int) or ndels < 1:
                raise Exception("Error: must specify positive int for ndels")
            for pt in np.asarray(self.__latin_sample(ndels)):
                d2 = np.square(self.x - pt).sum(axis=1)
                d2[~keep] = np.inf
                keep[np.argmin(d2)] = False
        elif method == "random":
            if not isinstance(ndels, int) or ndels < 1:
                raise Exception("Error: must specify positive int for ndels")
            keep[np.random.choice(n, size=ndels, replace=False)] = False
        elif method == "specific":
            if not isinstance(idx, (int, list)):
                raise Exception(
                    "Error: must specify int or list of ints for idx")
            keep[idx] = False
        else:
            raise Exception(
                f"Error: method must be one of {list(_DELETION_MODES)}")
        return keep

    # -- data injection --------------------------------------------------
    def set_data(self, x, y):
        """Inject existing datasets, validated."""
        for arr, width, what in ((x, self.nx, "input"),
                                 (y, self.ny, "output")):
            if (not isinstance(arr, np.ndarray) or arr.ndim != 2
                    or arr.dtype != np.float64 or arr.shape[1] != width):
                raise Exception(
                    f"Error: Setting data requires a 2d numpy array of "
                    f"float64 {what}s")
        for i in range(self.nx):
            lo, hi = self.priors[i].interval(1.0)
            if np.any(x[:, i] < float(lo)) or np.any(x[:, i] > float(hi)):
                raise Exception(
                    "Error: provided x data must fit within provided input "
                    "distribution ranges.")
        self.x = x
        self.y = y
        self.nsamp = len(x)


def _convert_columns(conrevs, arr):
    """Apply per-column conversions; always an (n, d) float64 array."""
    n = arr.shape[0]
    if n == 0:
        return np.empty((0, len(conrevs)))
    return np.column_stack([
        np.asarray(cr.con(arr[:, i]), dtype=np.float64)
        for i, cr in enumerate(conrevs)])


def _validated_conrevs(conrevs, width, argname):
    """Validate a con/rev list, filling None slots with the identity."""
    if conrevs is None:
        conrevs = [None] * width
    if not isinstance(conrevs, list) or len(conrevs) != width:
        raise Exception(
            f"Error: {argname} must be None or list of conversion/"
            f"reversion classes of size {width}")
    out = []
    for cr in conrevs:
        if cr is None:
            out.append(_none_conrev())
        elif callable(getattr(cr, "con", None)) and callable(
                getattr(cr, "rev", None)):
            out.append(cr)
        else:
            raise Exception(
                "Error: Provided data conversion/reversion function not "
                "callable.")
    return out


class _none_conrev:
    """Identity conversion used for None conrev slots (reference
    lhc.py:276-280); `der` provided so inverse problems work without an
    explicit output warping."""

    def con(self, x):
        return x

    def rev(self, x):
        return x

    def der(self, x):
        return np.ones_like(np.asarray(x, dtype=float))
