"""Rank-side bodies of tests/test_torch_chains.py (no tests of its own).

Each function runs on every rank of a `distributed.RankPool` (2 gloo
ranks on the CPU) and returns that rank's outputs, tensors as numpy
arrays.  The spawned ranks import this module and the port only, never
JAX; the test module makes the same inputs from the same numpy seeds for
its single-process runs."""

import numpy as np
import torch

from andvaranaut_torch import distributed
from andvaranaut_torch.gp import engine, sharded
from andvaranaut_torch.inference import nuts
from andvaranaut_torch.lhc import _none_conrev


def gp_data(n=48, seed=0):
    """tests/test_torch_mcmc.py's _gp_data."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 2))
    y = np.sin(3 * X[:, 0]) + 0.2 * X[:, 1] + 0.05 * rng.normal(size=n)
    return X, y


def gp_cfg(n=48, seed=0):
    X, y = gp_data(n, seed)
    return engine.FitConfig(
        kerns=("RBF",), ops=(), noise=True, truncate=False, jitter=1e-6,
        iwgp=False, cwgp=False, priors=[None, None],
        xconrevs=[_none_conrev(), _none_conrev()],
        yconrevs=[_none_conrev()], x=X, y=y.reshape(-1, 1))


def _result(data):
    return ({k: np.asarray(v) for k, v in data.posterior.items()},
            {k: np.asarray(v) for k, v in data.sample_stats.items()})


def _shards():
    s = nuts.SHARDS
    return {"route": s.route, "targets": list(s.targets),
            "calls": list(s.calls), "rows": list(s.rows),
            "max_rows": list(s.max_rows)}


def chains(kw):
    """sample_model(**kw) on gp_cfg() with no mesh: the chains split over
    the group's ranks.  Returns the draws, the stats, the split and the
    collectives layer's all_gather count."""
    distributed.STATS.reset()
    data = nuts.sample_model(gp_cfg(), device="cpu", **kw)
    return (*_result(data), _shards(), distributed.STATS.calls)


def mesh_chains(kw):
    """sample_model(mesh=, sampler='nuts') on gp_cfg(): the sharded
    objective runs collectives itself, so its chains are not split.
    Returns the split, the rows the sampler asked for and the rows this
    rank's objective evaluated."""
    asked = [0]
    orig = nuts._nuts_chains

    def counted(vec_eval, *a):
        def vec(Z):
            asked[0] += len(Z)
            return vec_eval(Z)
        return orig(vec, *a)

    made = []
    mk = sharded.make_sharded_mixed_objective

    def recording(*a, **k):
        res = mk(*a, **k)
        made.append(res[2])
        return res

    nuts._nuts_chains = counted
    sharded.make_sharded_mixed_objective = recording
    try:
        mesh = sharded.data_mesh(device="cpu")
        data = nuts.sample_model(gp_cfg(), mesh=mesh, sampler="nuts", **kw)
    finally:
        nuts._nuts_chains = orig
        sharded.make_sharded_mixed_objective = mk
    return _shards(), asked[0], made[-1].calls, np.asarray(
        data.sample_stats["lp"])


def failing_share(bad_rank):
    """nuts_sample with an objective that raises on `bad_rank`'s share:
    every rank's call fails.  Returns this rank's (exception type,
    message)."""

    def vec(Z):
        if torch.distributed.get_rank() == bad_rank:
            raise FloatingPointError(f"share of rank {bad_rank}")
        Z = np.asarray(Z)
        return 0.5 * np.sum(Z * Z, 1), Z.copy()

    def logp(z):
        raise AssertionError("the batched form is used")

    logp.vec_value_and_grad = vec
    try:
        nuts.nuts_sample(logp, np.zeros(2), seed=0, num_warmup=2,
                         num_samples=2, num_chains=2, device="cpu")
    except Exception as e:  # noqa: BLE001 — the test reads it
        return type(e).__name__, str(e)
    return None, None
