"""Target-function execution and persistence (counterpart of
andvaranaut_tpu/core.py).

Targets are arbitrary user Python or external codes and run on the host,
serially or in a `concurrent.futures` process pool (spawned workers).
Results come back in submission order; each sample runs in its own
scratch directory `rundir/task{i}`; failed samples and non-finite
outputs are dropped with a warning.  The target travels to the workers
pickled by cloudpickle where it is installed (so lambdas and closures
work) and by the standard pickle otherwise.

Persistence: whole-object save/load through the same pickler, and
netCDF x/y files with the reference's dimension and variable names, so
files interchange between the two packages (netCDF4 where installed,
scipy's NetCDF3 `netcdf_file` otherwise).  A facade pickled on the card
holds no tensor (its conditioning cache is dropped), so it loads
anywhere; its `device` stays the card's until the caller sets another.
"""

from __future__ import annotations

import os
import pickle
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from time import time as stopwatch

import numpy as np

from . import dists

__all__ = ["save_object", "load_object", "save_xy", "load_xy", "_core"]


def _pickler():
    try:
        import cloudpickle
    except ImportError:
        return pickle
    return cloudpickle


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------

def save_object(obj, fname):
    """Pickle a whole instance (datasets, transforms, fitted state)."""
    with open(fname, "wb") as f:
        _pickler().dump(obj, f)


def load_object(fname):
    """Load an object written by `save_object` (unpickling runs code:
    load only files this program wrote)."""
    with open(fname, "rb") as f:
        return _pickler().load(f)


def _netcdf_backend():
    try:
        import netCDF4  # noqa: F401
    except ImportError:
        return "scipy"
    return "netCDF4"


def _netcdf_open(fname, mode):
    if _netcdf_backend() == "netCDF4":
        from netCDF4 import Dataset

        return Dataset(fname, mode)
    from scipy.io import netcdf_file

    return netcdf_file(fname, mode)


def save_xy(x, y=None, fname="savexy.nc"):
    """Save 1-D x (and optionally y) arrays to netCDF: dimension n, f8
    variables x and y."""
    x = np.asarray(x)
    f = _netcdf_open(fname, "w")
    try:
        f.createDimension("n", len(x))
        f.createVariable("x", "f8", ("n",))[:] = x
        if y is not None:
            f.createVariable("y", "f8", ("n",))[:] = np.asarray(y)
    finally:
        f.close()


def load_xy(fname, xonly=False):
    """Load netCDF x (and y unless xonly) written by `save_xy`."""
    f = _netcdf_open(fname, "r")
    try:
        x = np.array(f.variables["x"][:])
        y = None if xonly else np.array(f.variables["y"][:])
    finally:
        f.close()
    return x if xonly else (x, y)


def _parallel_wrap(payload, rundir, inp, idx):
    """Worker-side task: run the target inside its scratch directory."""
    fn = _pickler().loads(payload)
    d = os.path.join(rundir, f"task{idx}")
    os.makedirs(d, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        return fn(inp)
    finally:
        os.chdir(cwd)


class _core:
    """Execution core every public class inherits.  Accepts scipy.stats
    frozen priors and andvaranaut_torch.dists distributions alike."""

    def __init__(self, nx, ny, priors, target, parallel=False, nproc=1,
                 constraints=None, rundir=None, verbose=True, pulse=1):
        if (not isinstance(nx, int)) or nx < 1:
            raise Exception("Error: must specify an integer number of input "
                            "dimensions > 0")
        if (not isinstance(ny, int)) or ny < 1:
            raise Exception("Error: must specify an integer number of output "
                            "dimensions > 0")
        if (not isinstance(priors, list)) or len(priors) != nx:
            raise Exception(
                "Error: must provide list of univariate priors of length nx")
        if not all(dists.is_distribution_like(p) for p in priors):
            raise Exception(
                "Error: priors must be scipy.stats frozen distributions or "
                "andvaranaut_torch.dists distributions")
        if not callable(target):
            raise Exception(
                "Error: must provide target function which produces output "
                "from specified inputs")
        if not isinstance(parallel, bool):
            raise Exception("Error: parallel must be type bool.")
        if not isinstance(nproc, int) or nproc < 1:
            raise Exception("Error: nproc argument must be an integer > 0")
        if nproc > (os.cpu_count() or 1):
            import warnings

            warnings.warn(
                "nproc exceeds available processors; oversubscribing.")
        keys = ["constraints", "lower_bounds", "upper_bounds"]
        if constraints is not None:
            if not isinstance(constraints, dict) or not all(
                    k in constraints for k in keys):
                raise Exception(
                    f"Error: provided constraints must be a dictionary with "
                    f"keys {keys} and list items.")

        self.nx = nx
        self.ny = ny
        self.priors = [dists.from_prior(p) for p in priors]
        self.target = target
        self.parallel = parallel
        self.nproc = nproc
        self.pulse = pulse
        self.constraints = constraints
        self.verbose = verbose
        self.rundir = rundir if rundir is not None else "runs"
        self.nsamp = 0
        # every __vector_solver call gets fresh task{i} directories
        self._task_counter = 0

    def _next_task_ids(self, n):
        """Reserve n fresh task-directory indices."""
        base = self._task_counter
        self._task_counter = base + n
        return base

    # -- parallel path ---------------------------------------------------
    def __parallel_runs(self, inps, fun, task_base):
        payload = _pickler().dumps(fun)
        n = len(inps)
        results = [None] * n
        fails = []
        import multiprocessing

        # spawn: a forked child of a process holding CUDA or thread state
        # can deadlock
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=self.nproc,
                                 mp_context=ctx) as pool:
            futmap = {
                pool.submit(_parallel_wrap, payload, self.rundir, inps[i],
                            i + task_base): i
                for i in range(n)}
            pending = set(futmap)
            while pending:
                done, pending = wait(pending, timeout=self.pulse,
                                     return_when=FIRST_COMPLETED)
                for fut in done:
                    i = futmap[fut]
                    try:
                        results[i] = np.asarray(fut.result())
                    except Exception:  # a failed sample is dropped
                        fails.append(i)
        fails = np.array(sorted(fails), dtype=np.intc)
        mask = np.ones(n, dtype=bool)
        mask[fails] = False
        kept = [results[i] for i in range(n) if mask[i]]
        outs = (np.stack(kept).reshape(len(kept), -1)
                if kept else np.empty((0, self.ny)))
        return outs, fails

    # -- main evaluation loop -------------------------------------------
    def __vector_solver(self, xsamps, fun=None):
        if fun is None:
            fun = self.target
        t0 = stopwatch()
        n_samples = len(xsamps)
        os.makedirs(self.rundir, exist_ok=True)
        task_base = self._next_task_ids(n_samples)

        if self.parallel:
            ysamps, fails = self.__parallel_runs(xsamps, fun, task_base)
            if len(ysamps) and ysamps.shape[1] != self.ny:
                raise AssertionError(
                    "Specified ny does not match function output")
            for i in fails:
                print(f"Warning: Target function evaluation failed at sample "
                      f"{i} with x values: {xsamps[i, :]}")
        else:
            rangef = range
            if self.verbose:
                try:
                    from tqdm import trange as rangef
                except ImportError:
                    pass
            rows = []
            fails = np.empty(0, dtype=np.intc)
            cwd = os.getcwd()
            for i in rangef(n_samples):
                d = os.path.join(self.rundir, f"task{i + task_base}")
                os.makedirs(d, exist_ok=True)
                os.chdir(d)
                try:
                    yout = fun(xsamps[i, :])
                except Exception as e:  # a failed sample is dropped
                    print(f"Warning: Target function evaluation failed at "
                          f"sample {i} with x values: {xsamps[i, :]}; error "
                          f"message: {e}")
                    fails = np.append(fails, i)
                    continue
                finally:
                    os.chdir(cwd)
                yout = np.asarray(yout, dtype=np.float64).reshape(-1)
                if yout.size != self.ny:
                    raise Exception(
                        "Error: number of target function outputs is not "
                        "equal to ny")
                rows.append(yout)
            ysamps = (np.stack(rows) if rows
                      else np.empty((0, self.ny)))
        mask = np.ones(n_samples, dtype=bool)
        mask[fails] = False
        xsamps = xsamps[mask]
        t1 = stopwatch()

        # non-finite outputs are dropped
        bad = ~np.isfinite(ysamps).all(axis=1)
        for i in np.flatnonzero(bad):
            print(f"Warning: Target function evaluation returned inf/nan "
                  f"at sample with x values: {xsamps[i, :]}\n"
                  "Check range of input values valid.")
        xsamps = xsamps[~bad]
        ysamps = ysamps[~bad]

        from . import timing

        timing.record("vector_solver", t1 - t0)
        if self.verbose:
            print()
            print(f"Time taken: {t1 - t0:0.2f} s")
        return xsamps, ysamps

    # -- constraint filtering -------------------------------------------
    def __check_constraints(self, xsamps):
        nsamps0 = len(xsamps)
        mask = np.ones(nsamps0, dtype=bool)
        for i, x in enumerate(xsamps):
            for e, f in enumerate(self.constraints["constraints"]):
                flag = True
                res = f(x)
                lower_bounds = self.constraints["lower_bounds"][e]
                upper_bounds = self.constraints["upper_bounds"][e]
                if isinstance(lower_bounds, list):
                    for k, lb in enumerate(lower_bounds):
                        if res[k] < lb:
                            flag = False
                    for k, ub in enumerate(upper_bounds):
                        if res[k] > ub:
                            flag = False
                elif res < lower_bounds or res > upper_bounds:
                    flag = False
                mask[i] = flag
                if not flag:
                    print(f"Sample {i + 1} with x values {x} removed due to "
                          f"invalidating constraint {e + 1}.")
        xsamps = xsamps[mask]
        if len(xsamps) < nsamps0:
            print(f"{nsamps0 - len(xsamps)} samples removed due to violating "
                  "constraints.")
        return xsamps
