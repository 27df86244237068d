"""Rank-side bodies of tests/test_torch_sharded.py and
tests/test_torch_distributed.py (no tests of its own).

Each function runs on every rank of a `distributed.RankPool` (4 gloo
ranks on the CPU) and returns that rank's replicated outputs, tensors as
numpy arrays.  The spawned ranks import this module and the port only,
never JAX; the test modules make the same inputs from the same numpy
seeds for the JAX side."""

import numpy as np
import torch

from andvaranaut_torch import distributed, dists, gpmcmc
from andvaranaut_torch import transform as tf
from andvaranaut_torch.gp import engine, kernels, sharded
from andvaranaut_torch.inference import nuts
from andvaranaut_torch.lhc import _none_conrev


def toy(n, nx=2, seed=0):
    """tests/test_sharded.py's _toy."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, nx))
    y = np.sin(3 * X[:, 0]) + 0.1 * X.sum(1)
    return X, y


def fit_data(n=64, seed=3):
    """tests/test_sharded.py's sharded_big_map_fit data."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 2))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 + 0.05 * rng.normal(size=n)
    return X, y


def gp_data(n=64, seed=7):
    """tests/test_sharded.py's sharded_map_fit data (a GP draw)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 2))
    K = np.exp(-0.5 * (((X[:, None, :] - X[None, :, :])
                        / np.array([0.4, 0.8])) ** 2).sum(-1))
    y = np.linalg.cholesky(K + 1e-8 * np.eye(n)) @ rng.normal(size=n)
    return X, y


def mcmc_data(n=48, seed=0):
    """tests/test_sharded.py's sample_model(mesh=) data."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 2))
    y = (np.sin(3 * X[:, 0]) + 0.05 * rng.normal(size=n)).reshape(-1, 1)
    return X, y


def warped_data(n=44, seed=3):
    """tests/test_sharded.py's _warped_cfg data."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(0.0, 2.0, n), rng.uniform(1.0, 1.5, n)],
                 axis=1)
    y = (X[:, 0] ** 2 - X[:, 0] - X[:, 1] ** 2 * X[:, 0] + X[:, 1]
         + 0.01 * rng.normal(size=n)).reshape(-1, 1)
    return X, y


def warped_cfg(n=44, iwgp=False, cwgp=False, kernel="RBF", seed=3):
    """tests/test_sharded.py's _warped_cfg through the port."""
    priors = [dists.Uniform(0.0, 2.0), dists.Uniform(1.0, 0.5)]
    X, y = warped_data(n, seed)
    if iwgp:
        xconrevs = [tf.wgp(["uniform", "kumaraswamy"], np.array([1.0, 1.0]),
                           y=None, xdist=priors[0]), tf.uniform(priors[1])]
    else:
        xconrevs = [tf.uniform(priors[0]), tf.uniform(priors[1])]
    yconrevs = ([tf.wgp(["meanstd", "sinharcsinh"], np.array([0.0, 1.0]),
                        y=y[:, 0])] if cwgp else [_none_conrev()])
    kerns, ops = kernels.parse_kernel(kernel)
    return engine.FitConfig(
        kerns=kerns, ops=ops, noise=True, truncate=False, jitter=1e-6,
        iwgp=iwgp, cwgp=cwgp, priors=priors, xconrevs=xconrevs,
        yconrevs=yconrevs, x=X, y=y)


def warped_z(total, scale=0.05, seed=1, z0=None):
    rng = np.random.default_rng(seed)
    return np.asarray(z0) + scale * rng.standard_normal(total)


def _mesh():
    return sharded.data_mesh(device="cpu")


def _autograd(f, z):
    zz = torch.as_tensor(np.asarray(z, dtype=np.float64)).requires_grad_()
    u = f(zz)
    (g,) = torch.autograd.grad(u, zz)
    return u.detach(), g


def nlml(kernel, noise, n, shift, layout="row", cyc_blocks=4,
         num_slices=None):
    """make_sharded_nlml's value and autograd gradient at z0 + shift;
    num_slices: over the 'data' dimension of a hierarchical mesh."""
    kerns, ops = kernels.parse_kernel(kernel)
    X, y = toy(n)
    mesh = (_mesh() if num_slices is None else
            distributed.hierarchical_mesh(num_slices=num_slices,
                                          device="cpu"))
    build_rvpack, nlp = sharded.make_sharded_nlml(
        mesh, kerns, ops, noise, 1e-6, layout=layout, cyc_blocks=cyc_blocks)
    rvpack = build_rvpack(2)
    return _autograd(lambda z: nlp(z, X, y, rvpack),
                     rvpack.z0().numpy() + shift)


def nlml_sharded_inputs(n):
    """make_sharded_nlml on shard_data's row blocks (the dry run's
    route) at z0."""
    X, y = toy(n)
    mesh = _mesh()
    Xs, ys = sharded.shard_data(mesh, X, y)
    build_rvpack, nlp = sharded.make_sharded_nlml(mesh, ("RBF",), (), True,
                                                  1e-6)
    rvpack = build_rvpack(2)
    return _autograd(lambda z: nlp(z, Xs, ys, rvpack), rvpack.z0().numpy())


def closed_form(kernel, noise, n, shift, mixed, block=32):
    """make_sharded_mixed_objective's value_and_grad and neg_log_post
    (value, autograd gradient) at z0 + shift."""
    kerns, ops = kernels.parse_kernel(kernel)
    X, y = toy(n)
    rvpack, nlp, vg = sharded.make_sharded_mixed_objective(
        _mesh(), X, y, kerns=kerns, ops=ops, noise=noise, block=block,
        mixed=mixed)
    z = rvpack.z0() + shift
    v, g = vg(z)
    u, gu = _autograd(nlp, z)
    return v, g, u, gu


def warped(n, iwgp, cwgp, block=32):
    """make_sharded_warped_objective's value_and_grad, the prior's value
    and gradient, and neg_log_post by autograd, at z0 + 0.05 N(0, 1)
    (numpy seed 1)."""
    cfg = warped_cfg(n=n, iwgp=iwgp, cwgp=cwgp)
    rvpack, nlp, vg = sharded.make_sharded_warped_objective(_mesh(), cfg,
                                                            block=block)
    z = torch.as_tensor(warped_z(rvpack.total, z0=rvpack.z0().numpy()))
    v, g = vg(z)
    lp, gp = _autograd(rvpack.log_prior, z)
    u, gu = _autograd(nlp, z)
    return v, g, lp, gp, u, gu


def predict(mixed, n, kernel):
    """make_sharded_predict at tests/test_sharded.py's hypers and 23
    query points (numpy seed 5)."""
    kerns, ops = kernels.parse_kernel(kernel)
    X, y = toy(n)
    nkern = len(kerns)
    hypers = {"l": np.tile([0.4, 0.7], nkern), "kv": np.full(nkern, 1.3),
              "gv": np.array(1e-3)}
    pred = sharded.make_sharded_predict(
        _mesh(), X, y, hypers, kerns=kerns, ops=ops, block=32, mixed=mixed,
        qbucket=16)
    Xq = np.random.default_rng(5).uniform(size=(23, 2))
    return pred(Xq)


def big_map_fit():
    X, y = fit_data()
    hypers, logp = sharded.sharded_big_map_fit(X, y, mesh=_mesh(), block=32,
                                               maxiter=100)
    return hypers, logp


def map_fit():
    X, y = gp_data()
    return sharded.sharded_map_fit(X, y, mesh=_mesh(), max_iter=300)


def big_warped_map_fit():
    """sharded_big_warped_map_fit (cwgp, n=48, maxiter 12), with the
    sharded objective's log posterior at z0 for the reference test's
    improvement check."""
    cfg = warped_cfg(n=48, cwgp=True)
    hypers, logp = sharded.sharded_big_warped_map_fit(cfg, block=32,
                                                      maxiter=12,
                                                      mesh=_mesh())
    rvpack, nlp, _ = sharded.make_sharded_warped_objective(_mesh(), cfg,
                                                           block=32)
    return hypers, logp, -nlp(rvpack.z0()).detach()


def mcmc(draws, tune):
    """sample_model(mesh=) with 2 lockstep chains (hmc_host, budget 8)."""
    X, y = mcmc_data()
    cfg = engine.FitConfig(
        kerns=("RBF",), ops=(), noise=True, truncate=False, jitter=1e-6,
        iwgp=False, cwgp=False, priors=[None, None],
        xconrevs=[_none_conrev(), _none_conrev()],
        yconrevs=[_none_conrev()], x=X, y=y)
    data = nuts.sample_model(cfg, draws=draws, tune=tune, chains=2,
                             mesh=_mesh(), random_seed=1, max_treedepth=3)
    return ({k: np.asarray(v) for k, v in data.posterior.items()},
            np.asarray(data.sample_stats["lp"]))


def _toy_target(x):
    return np.array([x[0] ** 2 - x[0] - x[1] ** 2 * x[0] + x[1]])


def facade(rundir, cwgp):
    """tests/test_gpmcmc_variants.py's distributed facade fits: the exact
    f64 fit, then fit(precision='distributed') on the pool's mesh; the
    hypers of both and the predictions at the design points."""
    priors = [dists.Uniform(0.0, 2.0), dists.Uniform(1.0, 0.5)]
    rank = torch.distributed.get_rank()
    g = gpmcmc.GPMCMC(nx=2, ny=1, priors=priors, target=_toy_target,
                      xconrevs=[tf.uniform(priors[0]),
                                tf.uniform(priors[1])],
                      verbose=False, rundir=f"{rundir}/rank{rank}",
                      device="cpu")
    g.sample(48 if cwgp else 60, seed=2)
    g.change_yconrevs([tf.meanstd(g.y[:, 0])])
    h0 = None
    if cwgp:
        g.change_yconrevs([tf.wgp(["meanstd", "sinharcsinh"],
                                  np.array([0.0, 1.0]), y=g.y[:, 0])])
        g.fit(method="map", precision="distributed", cwgp=True, block=16,
              maxiter=15, mesh=_mesh())
    else:
        g.fit(method="map")
        h0 = {k: np.asarray(v) for k, v in g.hypers.items()}
        g.fit(method="map", precision="distributed", block=16,
              mesh=_mesh())
    h = {k: np.asarray(v) for k, v in g.hypers.items()}
    return h0, h, g.predict(g.x), g.y


def meshes():
    """global_data_mesh and hierarchical_mesh shapes; the ValueError at
    3 slices."""
    m1 = distributed.global_data_mesh(device="cpu")
    h1 = distributed.hierarchical_mesh(device="cpu")
    h2 = distributed.hierarchical_mesh(num_slices=2, device="cpu")
    try:
        distributed.hierarchical_mesh(num_slices=3, device="cpu")
        raised = False
    except ValueError:
        raised = True
    return (tuple(m1.shape), m1.mesh_dim_names, tuple(h1.shape),
            h1.mesh_dim_names, tuple(h2.shape), raised,
            distributed.initialize())


def raise_on(rank):
    """Raises on one rank (the others return)."""
    if torch.distributed.get_rank() == rank:
        raise ValueError(f"rank {rank} fails")
    return rank


def dryrun(n_ranks):
    return distributed.dryrun_multichip(n_ranks, device="cpu")
