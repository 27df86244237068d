"""Port parity, persistence, timing and the public surface: `core`'s
save/load functions, `LHC`'s netCDF methods and `_surrogate` (mirrors of
tests/test_core_lhc.py and test_gpmcmc.py::test_pickle_fitted_model),
files interchanged with andvaranaut_tpu in both directions, `timing`'s
registry and device profile, and every public name and parameter of
andvaranaut_tpu's core, lhc, gpmcmc, timing and flat namespace present
in andvaranaut_torch (the in-repo analogue of tests/test_api_parity.py).
"""

import ast
import importlib
import inspect
import io
import json
import os
import pickle

import numpy as np
import pytest
import torch

import andvaranaut_tpu
from andvaranaut_tpu import LHC as JLHC
from andvaranaut_tpu import dists as jdists
from andvaranaut_tpu import load_xy as jload_xy
from andvaranaut_tpu import save_xy as jsave_xy
import andvaranaut_torch
from andvaranaut_torch import LHC, GPMCMC, dists, load_object, load_xy
from andvaranaut_torch import save_object, save_xy, timing
from andvaranaut_torch import transform as tf
from andvaranaut_torch.lhc import _surrogate


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module (the suite's parallel workers
    would oversubscribe a multi-threaded pool).  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy(x):
    return np.array([x[0] ** 2 - x[0] - x[1] ** 2 * x[0] + x[1]])


def _mk(tmp_path, target, cls=LHC, mod=dists):
    priors = [mod.Uniform(0.0, 2.0), mod.Uniform(1.0, 0.5)]
    return cls(nx=2, ny=1, priors=priors, target=target,
               rundir=str(tmp_path / "runs"), verbose=False)


# -- persistence --------------------------------------------------------------

def test_netcdf_roundtrip(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    l = _mk(tmp_path, _toy)
    l.sample(5, seed=0)
    fname = str(tmp_path / "data.nc")
    l.save_netcdf(fname)
    l2 = _mk(tmp_path, _toy)
    l2.load_netcdf(fname)
    np.testing.assert_allclose(l2.x, l.x)
    np.testing.assert_allclose(l2.y, l.y)
    assert l2.nsamp == 5


def test_save_xy_roundtrip(tmp_path):
    x = np.linspace(0, 1, 7)
    y = x ** 2
    fname = str(tmp_path / "xy.nc")
    save_xy(x, y, fname)
    x2, y2 = load_xy(fname)
    np.testing.assert_allclose(x2, x)
    np.testing.assert_allclose(y2, y)
    save_xy(x, fname=str(tmp_path / "x.nc"))
    x3 = load_xy(str(tmp_path / "x.nc"), xonly=True)
    np.testing.assert_allclose(x3, x)


def test_pickle_roundtrip(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    l = _mk(tmp_path, lambda x: np.array([x[0] + x[1]]))  # a lambda target
    l.sample(4, seed=0)
    fname = str(tmp_path / "obj.pkl")
    save_object(l, fname)
    l2 = load_object(fname)
    np.testing.assert_allclose(l2.x, l.x)
    np.testing.assert_allclose(l2.y, l.y)
    assert float(l2.target(np.array([1.0, 2.0]))[0]) == 3.0


def test_surrogate_conversion_tracking(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    priors = [dists.Uniform(0.0, 2.0), dists.Uniform(1.0, 0.5)]
    s = _surrogate(
        nx=2, ny=1, priors=priors, target=_toy,
        xconrevs=[tf.uniform(priors[0]), tf.uniform(priors[1])],
        yconrevs=None, rundir=str(tmp_path / "runs"), verbose=False)
    s.sample(6, seed=0)
    assert s.xc.shape == (6, 2)
    np.testing.assert_allclose(
        s.xc[:, 0], np.asarray(s.xconrevs[0].con(s.x[:, 0])))
    np.testing.assert_allclose(s.yc, s.y)  # identity yconrev
    s.del_samples(method="specific", idx=[0])
    assert s.xc.shape == (5, 2) and len(s.x) == 5
    s.change_yconrevs([tf.meanstd(s.y[:, 0])])
    np.testing.assert_allclose(
        s.yc[:, 0], np.asarray(s.yconrevs[0].con(s.y[:, 0])))


def test_surrogate_y_dist_predictfun(tmp_path, monkeypatch):
    """_surrogate.y_dist propagates a fresh LHC through any predict
    function of the converted inputs and reverts the outputs."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    monkeypatch.setattr(plt, "show", lambda: None)
    monkeypatch.chdir(tmp_path)
    priors = [dists.Uniform(0.0, 2.0), dists.Uniform(1.0, 0.5)]
    s = _surrogate(
        nx=2, ny=1, priors=priors, target=_toy,
        xconrevs=[tf.uniform(p) for p in priors], yconrevs=None,
        rundir=str(tmp_path / "runs"), verbose=False)
    s.sample(8, seed=0)
    s.change_yconrevs([tf.meanstd(s.y[:, 0])])

    def predictfun(xc):
        x = np.column_stack([np.asarray(c.rev(xc[:, i]))
                             for i, c in enumerate(s.xconrevs)])
        y = np.array([_toy(r)[0] for r in x])
        return np.asarray(s.yconrevs[0].con(y))[:, None]

    xs, ys = s.y_dist(nsamps=50, return_data=True, predictfun=predictfun)
    np.testing.assert_allclose(ys[:, 0], [_toy(r)[0] for r in xs],
                               rtol=1e-12, atol=1e-12)
    plt.close("all")


def test_pickle_fitted_model(tmp_path, monkeypatch):
    """A fitted facade round-trips and predicts the same, bit for bit;
    its pickled state holds no tensor (the conditioning cache is
    dropped), so a facade pickled on the card loads anywhere."""
    monkeypatch.chdir(tmp_path)
    priors = [dists.Uniform(0.0, 2.0), dists.Uniform(1.0, 0.5)]
    g = GPMCMC(nx=2, ny=1, priors=priors, target=_toy,
               xconrevs=[tf.uniform(p) for p in priors], verbose=False,
               rundir=str(tmp_path / "runs"), device="cpu")
    g.sample(30, seed=5)
    g.change_yconrevs([tf.meanstd(g.y[:, 0])])
    g.fit(method="map")
    g.gp.chol()  # a cached factor, which the pickle must drop
    f = str(tmp_path / "gp.pkl")
    save_object(g, f)
    g2 = load_object(f)
    np.testing.assert_array_equal(g2.predict(g.x[:5]), g.predict(g.x[:5]))

    tensors = []

    class Scan(pickle.Pickler):
        def reducer_override(self, obj):
            if isinstance(obj, torch.Tensor):
                tensors.append(obj.shape)
            return NotImplemented

    Scan(io.BytesIO()).dump(g)
    assert tensors == []


# -- interchange with andvaranaut_tpu -------------------------------------------

def test_xy_interchange(tmp_path):
    """save_xy files cross between the packages, with and without y."""
    x, y = np.linspace(-1, 1, 9), np.cos(np.linspace(-1, 1, 9))
    jsave_xy(x, y, str(tmp_path / "j.nc"))
    x1, y1 = load_xy(str(tmp_path / "j.nc"))
    save_xy(x, y, str(tmp_path / "p.nc"))
    x2, y2 = jload_xy(str(tmp_path / "p.nc"))
    for a, b in ((x1, x), (y1, y), (x2, x), (y2, y)):
        np.testing.assert_array_equal(a, b)
    save_xy(x, fname=str(tmp_path / "px.nc"))
    np.testing.assert_array_equal(
        jload_xy(str(tmp_path / "px.nc"), xonly=True), x)


def test_netcdf_interchange(tmp_path, monkeypatch):
    """LHC datasets cross between the packages both ways."""
    monkeypatch.chdir(tmp_path)
    lj = _mk(tmp_path, _toy, JLHC, jdists)
    lj.sample(6, seed=1)
    lj.save_netcdf(str(tmp_path / "j.nc"))
    lp = _mk(tmp_path, _toy)
    lp.load_netcdf(str(tmp_path / "j.nc"))
    np.testing.assert_array_equal(lp.x, lj.x)
    np.testing.assert_array_equal(lp.y, lj.y)
    lp.sample(3, seed=2)
    lp.save_netcdf(str(tmp_path / "p.nc"))
    lj2 = _mk(tmp_path, _toy, JLHC, jdists)
    lj2.load_netcdf(str(tmp_path / "p.nc"))
    np.testing.assert_array_equal(lj2.x, lp.x)
    np.testing.assert_array_equal(lj2.y, lp.y)
    assert lj2.nsamp == 9


# -- timing --------------------------------------------------------------------

def test_timing_registry_and_summary():
    timing.reset_timings()
    with timing.stopwatch("a"):
        pass
    timing.record("a", 2.0)
    timing.record("b", 0.5)
    t = timing.timings()
    assert set(t) == {"a", "b"} and len(t["a"]) == 2 and t["b"] == (0.5,)
    lines = timing.summary().splitlines()
    assert lines[0].startswith("a: n=2 total=") and lines[1] == (
        "b: n=1 total=0.500s mean=0.500s")
    timing.reset_timings()
    assert timing.timings() == {} and timing.summary() == ""


def test_device_profile_writes_trace(tmp_path):
    """Without a card, device_profile records the block's host activity
    into a Chrome trace in logdir."""
    logdir = str(tmp_path / "prof")
    with timing.device_profile(logdir):
        a = torch.ones(64, 64, dtype=torch.float64)
        (a @ a).sum()
    with open(os.path.join(logdir, "trace.json")) as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


# -- public surface --------------------------------------------------------------

#: public names of andvaranaut_tpu that the port does not have yet, each
#: with its ROADMAP Queue 1 item; this list only shrinks
NOT_PORTED = {}

#: what the port leaves out of a reference module on purpose, each with its
#: ROADMAP "Not to port" reason: (module, None, function) for a function,
#: (module, function, parameter) for a parameter
NOT_TO_PORT = {
    ("inference.nuts", None, "hmc_flat_sample"):
        "the flat leapfrog-level scan ('hmc', hmc_fixed), a TPU workaround; "
        "the port's 'hmc' is host_hmc's integrator",
    ("inference.nuts", "nuts_sample", "steps_per_call"):
        "steps_per_call chunking, which keeps TPU executions under the "
        "runtime's watchdogs",
    ("inference.nuts", "sample_rvpack", "steps_per_call"):
        "steps_per_call chunking, which keeps TPU executions under the "
        "runtime's watchdogs",
    ("inference.nuts", "sample_rvpack", "vec"):
        "the vec='map'/'vmap' split; the port always batches the chains",
    ("inference.nuts", "nuts_sample", "key"):
        "a JAX PRNG key: the port's chains draw from numpy Generators "
        "spawned from `seed`",
}

#: modules whose private helpers are the reference's compiled internals:
#: only their public names are compared
PUBLIC_ONLY = ("inference.nuts",)


def _defined(mod):
    """(class or None, name, object) of the functions and classes a module
    defines, with the classes' own methods (no dunder but __init__, no
    name-mangled private)."""
    out = []
    for name, obj in vars(mod).items():
        if name.startswith("__") or getattr(obj, "__module__",
                                            None) != mod.__name__:
            continue
        if inspect.isfunction(obj):
            out.append((None, name, obj))
        elif inspect.isclass(obj):
            out.append((None, name, obj))
            for m, f in vars(obj).items():
                if ((m.startswith("__") and m != "__init__")
                        or m.startswith(f"_{name}__")):
                    continue
                if isinstance(f, (staticmethod, classmethod)):
                    f = f.__func__
                if inspect.isfunction(f):
                    out.append((name, m, f))
    return out


def _missing_params(ref, port):
    ps = inspect.signature(port).parameters
    if any(p.kind == p.VAR_KEYWORD for p in ps.values()):
        return []
    return [p for p in inspect.signature(ref).parameters if p not in ps]


@pytest.mark.parametrize("mod", ["core", "lhc", "gpmcmc", "timing",
                                 "distributed", "gp.sharded",
                                 "inference.nuts"])
def test_public_surface_matches_reference(mod):
    """Every function, class and method andvaranaut_tpu's module defines
    (its public ones for PUBLIC_ONLY modules) exists in the port's, taking
    every parameter the reference's takes (extra keywords, such as device,
    are allowed), apart from NOT_TO_PORT's entries, each of which the port
    indeed lacks.  For inference.nuts this holds nuts_sample's `shard`."""
    ref = importlib.import_module(f"andvaranaut_tpu.{mod}")
    port = importlib.import_module(f"andvaranaut_torch.{mod}")
    missing, narrowed = [], []
    for cls, name, obj in _defined(ref):
        if (mod, cls, name) in NOT_PORTED or (mod, cls, name) in NOT_TO_PORT:
            continue
        if mod in PUBLIC_ONLY and (name.startswith("_")
                                   or (cls or "").startswith("_")):
            continue
        owner = port if cls is None else getattr(port, cls, None)
        pobj = getattr(owner, name, None)
        if pobj is None:
            missing.append(f"{cls}.{name}" if cls else name)
        elif not inspect.isclass(obj):
            bad = [p for p in _missing_params(obj, pobj)
                   if (mod, name, p) not in NOT_TO_PORT]
            if bad:
                narrowed.append((name, bad))
    assert not missing, missing
    assert not narrowed, narrowed
    for m, owner, name in NOT_TO_PORT:
        if m != mod:
            continue
        if owner is None:
            assert not hasattr(port, name), name
        else:
            ps = inspect.signature(getattr(port, owner)).parameters
            assert name not in ps, (owner, name)


def _reference_flat_names():
    """The names andvaranaut_tpu's __init__ binds itself (its imports,
    `transform`'s star export included), read from its source: the
    package object also gains every submodule that any test imports."""
    tree = ast.parse(inspect.getsource(andvaranaut_tpu))
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            for a in node.names:
                if a.name == "*":
                    mod = importlib.import_module(
                        f"andvaranaut_tpu.{node.module}")
                    names.update(mod.__all__)
                else:
                    names.add(a.asname or a.name)
        elif isinstance(node, ast.Try):
            for sub in node.body:
                if isinstance(sub, ast.ImportFrom):
                    names.update(a.asname or a.name for a in sub.names)
    return sorted(n for n in names if not n.startswith("_"))


def test_flat_namespace_matches_reference():
    """The port's package namespace holds every public name
    andvaranaut_tpu's __init__ binds, and the four it had before."""
    missing = [n for n in _reference_flat_names()
               if not hasattr(andvaranaut_torch, n)
               and ("__init__", None, n) not in NOT_PORTED]
    assert not missing, missing
    for n in ("DTYPE", "GPMCMC", "default_device", "resolve_device"):
        assert hasattr(andvaranaut_torch, n)


def test_not_ported_list_is_current():
    """Every public name of the reference is ported: the exemption list is
    empty (it only shrinks)."""
    assert NOT_PORTED == {}
