"""The benchmark's own data: a plain NumPy Latin hypercube of a
configuration's input priors, the priors' inverse CDFs and CDFs, and the
test function that gives the outputs.  The same arrays go to the program
and to the reference.

A prior is a JSON list: ["uniform", lo, hi], ["normal", mu, sd] or
["lognormal", mu, sd] (mu and sd of log x).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
from scipy.special import ndtr, ndtri

HERE = Path(__file__).resolve().parent


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of a run: any whole seed (beyond 32
    bits too) and a fixed stream index."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def lhc_unit(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    """n points of a Latin hypercube in (0, 1)^d: one point in each of
    the n strata of every input, strata paired at random."""
    u = (rng.permuted(np.tile(np.arange(n), (d, 1)), axis=1).T
         + rng.uniform(size=(n, d))) / n
    return np.clip(u, 0.5 / (16 * n), 1.0 - 0.5 / (16 * n))


def ppf(prior, u):
    kind = prior[0]
    if kind == "uniform":
        return prior[1] + (prior[2] - prior[1]) * u
    if kind == "normal":
        return prior[1] + prior[2] * ndtri(u)
    if kind == "lognormal":
        return np.exp(prior[1] + prior[2] * ndtri(u))
    raise ValueError(f"unknown prior {kind!r}")


def cdf(prior, x):
    kind = prior[0]
    if kind == "uniform":
        return (x - prior[1]) / (prior[2] - prior[1])
    if kind == "normal":
        return ndtr((x - prior[1]) / prior[2])
    if kind == "lognormal":
        return ndtr((np.log(x) - prior[1]) / prior[2])
    raise ValueError(f"unknown prior {kind!r}")


def sample_inputs(priors, rng, n: int) -> np.ndarray:
    """Raw inputs (n, d): the priors' inverse CDFs of a Latin hypercube."""
    u = lhc_unit(rng, n, len(priors))
    return np.column_stack([ppf(p, u[:, i]) for i, p in enumerate(priors)])


def function(name: str):
    """The test function `f(X) -> y` of `functions/<name>.py`."""
    path = HERE / "functions" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"pb_fn_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.f


def training_data(cfg: dict, seed: int):
    """(raw inputs (n, d), raw outputs (n,)) of a configuration's design
    from the seed."""
    x = sample_inputs(cfg["priors"], seed_rng(seed, 0), cfg["n"])
    return x, function(cfg["function"])(x)


def to_unit(cfg: dict, x: np.ndarray) -> np.ndarray:
    """Each input through its prior's CDF, onto [0, 1]."""
    return np.column_stack([cdf(p, x[:, i])
                            for i, p in enumerate(cfg["priors"])])


def standardise(y: np.ndarray) -> np.ndarray:
    return (y - y.mean()) / y.std()
