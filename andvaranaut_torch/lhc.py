"""Latin-hypercube dataset layer (counterpart of andvaranaut_tpu/lhc.py):
`LHC` with sampling, deletion, data injection, output-distribution
plots and netCDF persistence; the generic surrogate base `_surrogate`
(converted copies xc/yc, forward UQ through any predict function); and
the conversion helpers the GPMCMC facade uses.

netCDF files keep the reference's layout (dimensions samples, inputs,
outputs; f8 variables input_samples, output_samples), so datasets
interchange between the two packages.  The plots import matplotlib and
seaborn when they draw, not before.
"""

from __future__ import annotations

import numpy as np

from . import sampling
from .core import _core, _netcdf_open

__all__ = ["LHC", "_surrogate", "_none_conrev"]

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

    # -- plotting --------------------------------------------------------
    def y_dist(self, mode="hist_kde"):
        """Plot the distribution of each sampled output."""
        self.__y_dist(self.y, mode)

    def __y_dist(self, y, mode):
        import matplotlib.pyplot as plt
        import seaborn as sns

        displot_kwargs = {
            "hist": {"kind": "hist"},
            "kde": {"kind": "kde"},
            "ecdf": {"kind": "ecdf"},
            "hist_kde": {"kind": "hist", "kde": True},
        }
        if mode not in displot_kwargs:
            raise Exception(
                f"Error: selected mode must be one of "
                f"{list(displot_kwargs)}")
        for i in range(self.ny):
            sns.displot(y[:, i], **displot_kwargs[mode])
            plt.xlabel(f"y[{i}]")
            plt.ylabel("Density")
            plt.show()

    # -- data injection and persistence ----------------------------------
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

    def save_netcdf(self, fname):
        """Write the dataset to netCDF in the reference's layout."""
        with _NetcdfFile(fname, "w") as f:
            f.write_xy(self.x, self.y)

    def load_netcdf(self, fname):
        """Replace the dataset by one written by `save_netcdf`."""
        with _NetcdfFile(fname, "r") as f:
            self.x, self.y = f.read_xy()
        self.nsamp = len(self.x)


class _NetcdfFile:
    """netCDF access in the reference's on-disk layout: dimensions
    (samples, inputs) and (samples, outputs), f8 variables input_samples
    and output_samples."""

    def __init__(self, fname, mode):
        self._f = _netcdf_open(fname, mode)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()
        return False

    def write_xy(self, x, y):
        f = self._f
        f.createDimension("inputs", x.shape[1])
        f.createDimension("outputs", y.shape[1])
        f.createDimension("samples", x.shape[0])
        f.createVariable("input_samples", "f8",
                         ("samples", "inputs"))[:, :] = x
        f.createVariable("output_samples", "f8",
                         ("samples", "outputs"))[:, :] = y

    def read_xy(self):
        f = self._f
        x = np.array(f.variables["input_samples"][:, :])
        y = np.array(f.variables["output_samples"][:, :])
        return x, y


class _surrogate(LHC):
    """Generic surrogate base keeping converted copies xc/yc of the
    dataset through per-column con/rev objects (GPMCMC does not inherit
    it: its outputs are converted after the mean function)."""

    def __init__(self, xconrevs=None, yconrevs=None, **kwargs):
        super().__init__(**kwargs)
        self.__conrev_check(xconrevs, yconrevs)
        self._reconvert()

    def _reconvert(self):
        """Rebuild xc/yc wholesale from x/y through the current conrevs."""
        self.xc = _convert_columns(self.xconrevs, self.x)
        self.yc = _convert_columns(self.yconrevs, self.y)

    def sample(self, nsamps, seed=None):
        nold = len(self.x)
        super().sample(nsamps, seed)
        self.xc = np.r_[
            self.xc, _convert_columns(self.xconrevs, self.x[nold:])]
        self.yc = np.r_[
            self.yc, _convert_columns(self.yconrevs, self.y[nold:])]

    def del_samples(self, ndels=None, method="coarse_lhc", idx=None):
        keep = self._LHC__keep_mask(ndels, method, idx)
        for name in ("x", "y", "xc", "yc"):
            setattr(self, name, getattr(self, name)[keep])
        self.nsamp = len(self.x)

    def change_conrevs(self, xconrevs=None, yconrevs=None):
        self.__conrev_check(xconrevs, yconrevs)
        self._reconvert()

    def change_xconrevs(self, xconrevs=None):
        self.__conrev_check(xconrevs, yconrevs=self.yconrevs)
        self.xc = _convert_columns(self.xconrevs, self.x)

    def change_yconrevs(self, yconrevs=None):
        self.__conrev_check(self.xconrevs, yconrevs)
        self.yc = _convert_columns(self.yconrevs, self.y)

    def __conrev_check(self, xconrevs, yconrevs):
        self.xconrevs = _validated_conrevs(xconrevs, self.nx, "xconrevs")
        self.yconrevs = _validated_conrevs(yconrevs, self.ny, "yconrevs")

    def set_data(self, x, y):
        super().set_data(x, y)
        self._reconvert()

    def y_dist(self, mode="hist_kde", nsamps=None, return_data=False,
               surrogate=True, predictfun=None):
        """Forward UQ: a fresh LHC of nsamps points (default 1000; the
        reference's None crashes) converted, passed through predictfun and
        reverted, then plotted; surrogate=False plots the sampled outputs
        instead."""
        if not isinstance(surrogate, bool):
            raise Exception("Error: surrogate argument must be of type bool")
        if not surrogate:
            super().y_dist(mode)
            return None
        if nsamps is None:
            nsamps = 1000
        xsamps = np.asarray(self._LHC__latin_sample(nsamps))
        xcons = _convert_columns(self.xconrevs, xsamps)
        ypreds = np.asarray(predictfun(xcons))
        yrevs = np.column_stack([
            np.asarray(cr.rev(ypreds[:, i]))
            for i, cr in enumerate(self.yconrevs)])
        self._LHC__y_dist(yrevs, mode)
        if return_data:
            return xsamps, yrevs
        return None


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
