"""Port parity, chain sharding of the samplers (`nuts_sample(shard=)`,
`sample_rvpack`, `sample_model`) against the reference's `shard=True`
(andvaranaut_tpu/inference/nuts.py:947-954, the chains on a 1-D
("chains",) mesh when they divide by the device count).

- In-process shards (`devices=["cpu"] * k`, a worker thread each) give
  draws and stats equal bit for bit to the unsharded run, for 'nuts' and
  'hmc', on a toy Gaussian and through sample_model(mixed=True) at one
  block (the plain K3b/K7b).
- The reference's rule: chains that do not divide by the targets run
  unsharded, as does 'hmc_host'; a failing shard fails the call.
- The counterparts of tests/test_nuts.py's sharded tests run 8 and 64
  chains over 8 in-process CPU targets beside the JAX sampler on the
  suite's 8-device CPU mesh, at the reference's limits.
- The rank route on a pool of 2 gloo ranks (bodies in
  tests/test_torch_chains_ranks.py, which imports no JAX): every rank's
  draws equal the single-process run's, one all_gather a round;
  sample_model(mesh=)'s objective is not split; the dry run includes the
  chain-sharded NUTS run.
"""

import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_chains_ranks as ranks
from andvaranaut_tpu.inference import nuts as jnuts
from andvaranaut_torch import distributed
from andvaranaut_torch.inference import nuts

STATS = ("lp", "diverging", "accept", "depth", "eps")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module (the worker threads and the ranks
    run one each).  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    p = distributed.RankPool(2, "cpu", threads=1)
    yield p
    p.close()


def _gaussian(mean=0.0, sd=1.0):
    """A log density whose numpy batched potential (U, dU/dz) is its
    `vec_value_and_grad`, device-free, so `replicate` returns it; every
    call is recorded with its thread's name and row count."""
    seen = []

    def vec(Z):
        Z = np.asarray(Z)
        seen.append((threading.current_thread().name, Z.shape[0]))
        d = (Z - mean) / sd ** 2
        return 0.5 * np.sum((Z - mean) * d, 1), d

    def logp(z):
        raise AssertionError("the batched form is used")

    logp.vec_value_and_grad = vec
    logp.replicate = lambda dev: logp
    logp.seen = seen
    return logp


def _equal(a, b):
    for k in ("z",) + STATS:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


_TOY = {"nuts": dict(num_warmup=30, num_samples=30),
        "hmc": dict(num_warmup=20, num_samples=20, max_treedepth=3)}


@pytest.mark.parametrize("sampler", ["nuts", "hmc"])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_in_process_shards_equal_unsharded_gaussian(sampler, k):
    """8 chains over k in-process targets: draws and stats bit for bit
    the unsharded run's; k worker threads did all the evaluations, each
    a contiguous share of at most 8 / k rows."""
    kw = dict(seed=3, num_chains=8, sampler=sampler, device="cpu",
              **_TOY[sampler])
    ref = nuts.nuts_sample(_gaussian(), np.zeros(3), shard=False, **kw)
    assert nuts.SHARDS.route is None
    logp = _gaussian()
    got = nuts.nuts_sample(logp, np.zeros(3), devices=["cpu"] * k, **kw)
    _equal(got, ref)
    s = nuts.SHARDS
    assert s.route == "devices" and s.targets == ["cpu"] * k
    assert min(s.calls) > 0 and max(s.max_rows) <= 8 // k
    names = {name for name, _ in logp.seen}
    assert names == {f"chain-shard-{t}" for t in range(k)}
    assert sum(m for _, m in logp.seen) == sum(s.rows)


@pytest.fixture(scope="module")
def mixed_ref():
    """sample_model(mixed=True) at n=48 (one block: the batched K3/K7
    plain versions), 8 chains, unsharded, per sampler."""
    cfg = ranks.gp_cfg()
    return {s: nuts.sample_model(cfg, mixed=True, sampler=s, chains=8,
                                 device="cpu", **_MIXED[s])
            for s in ("nuts", "hmc")}


_MIXED = {"nuts": dict(draws=3, tune=3, max_treedepth=3, random_seed=2),
          "hmc": dict(draws=3, tune=3, max_treedepth=2, random_seed=2)}


@pytest.mark.parametrize("sampler", ["nuts", "hmc"])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_in_process_shards_equal_unsharded_mixed(mixed_ref, sampler, k):
    """sample_model(mixed=True, devices=['cpu'] * k): the mixed objective's
    rows give the same bits in any batch, so the sharded posterior and
    stats equal the unsharded run's bit for bit."""
    got = nuts.sample_model(ranks.gp_cfg(), mixed=True, sampler=sampler,
                            chains=8, device="cpu", devices=["cpu"] * k,
                            **_MIXED[sampler])
    assert nuts.SHARDS.route == "devices" and len(nuts.SHARDS.targets) == k
    ref = mixed_ref[sampler]
    for name in ref.posterior:
        np.testing.assert_array_equal(got.posterior[name],
                                      ref.posterior[name], err_msg=name)
    for name in STATS:
        np.testing.assert_array_equal(got.sample_stats[name],
                                      ref.sample_stats[name], err_msg=name)


def test_indivisible_chains_and_hmc_host_run_unsharded():
    """The reference's rule (nuts.py:947): 6 chains over 4 targets run
    unsharded, every evaluation on the calling thread; so does shard=False
    and sampler='hmc_host' (never sharded, nuts.py:1201-1267)."""
    main = threading.current_thread().name
    for kw in (dict(num_chains=6, devices=["cpu"] * 4),
               dict(num_chains=4, devices=["cpu"] * 4, shard=False)):
        logp = _gaussian()
        nuts.nuts_sample(logp, np.zeros(2), seed=1, num_warmup=10,
                         num_samples=10, device="cpu", **kw)
        assert nuts.SHARDS.route is None
        assert {name for name, _ in logp.seen} == {main}
        assert max(m for _, m in logp.seen) == kw["num_chains"]
    logp = _gaussian()
    rv = _toy_rvpack()
    nuts.sample_rvpack(rv, nuts._negated(logp), draws=5, tune=5, chains=4,
                       sampler="hmc_host", device="cpu",
                       devices=["cpu"] * 2)
    assert nuts.SHARDS.route is None
    assert {name for name, _ in logp.seen} == {main}


def _toy_rvpack():
    from andvaranaut_torch.inference.unconstrained import RV, RVPack

    return RVPack((RV("x", 2, ("normal", 0.0, 1.0)),))


def test_failing_thread_fails_the_call():
    """A shard that raises fails the call with its own exception and
    traceback; nothing reruns on the calling thread afterwards."""
    logp = _gaussian()
    base = logp.vec_value_and_grad

    def vec(Z):
        if threading.current_thread().name == "chain-shard-1":
            raise FloatingPointError("shard 1 fails")
        return base(Z)

    logp.vec_value_and_grad = vec
    with pytest.raises(FloatingPointError, match="shard 1 fails") as info:
        nuts.nuts_sample(logp, np.zeros(2), seed=0, num_warmup=5,
                         num_samples=5, num_chains=4, device="cpu",
                         devices=["cpu"] * 2)
    assert any(f.name == "vec" for f in info.traceback)
    main = threading.current_thread().name
    assert all(name != main for name, _ in logp.seen)


def test_replicate_needed_for_a_batched_form_on_another_device():
    """A batched objective without replicate() cannot be rebuilt on
    another target device: ValueError, nothing runs."""
    logp = _gaussian()
    del logp.replicate
    with pytest.raises(ValueError, match="replicate"):
        nuts.nuts_sample(logp, np.zeros(2), seed=0, num_warmup=2,
                         num_samples=2, num_chains=2, device="cpu",
                         devices=["cpu", "meta"])
    assert not logp.seen


def test_plain_logp_runs_on_each_target_device():
    """A plain log density (no batched form) is called row by row with z
    on the target's device (autograd there), draws equal to unsharded."""
    kw = dict(seed=5, num_warmup=10, num_samples=10, num_chains=4,
              device="cpu", max_treedepth=4)
    devs = []

    def logp(z):
        devs.append(z.device.type)
        return -0.5 * (z * z).sum()

    ref = nuts.nuts_sample(logp, np.zeros(2), shard=False, **kw)
    got = nuts.nuts_sample(logp, np.zeros(2), devices=["cpu"] * 2, **kw)
    _equal(got, ref)
    assert set(devs) == {"cpu"}


# ---- counterparts of tests/test_nuts.py's sharded tests ----------------------

def _jax_sharded(logp, z0, seed, warm, draws, chains):
    """The reference's sharded sampler on the suite's 8-device CPU mesh."""
    assert jax.device_count() == 8
    return np.asarray(jnuts.nuts_sample(
        logp, z0, key=jax.random.PRNGKey(seed), num_warmup=warm,
        num_samples=draws, num_chains=chains, shard=True)["z"])


def test_chains_sharded_over_mesh():
    """tests/test_nuts.py:106-123: 8 chains of 300 + 300 on a standard
    normal, split-R-hat < 1.1; the port's over 8 in-process CPU targets,
    the reference's on the 8-device mesh, uncut."""
    res = nuts.nuts_sample(_gaussian(), np.zeros(3), seed=0,
                           num_warmup=300, num_samples=300, num_chains=8,
                           device="cpu", devices=["cpu"] * 8)
    assert nuts.SHARDS.route == "devices"
    z = np.asarray(res["z"])
    assert z.shape == (8, 300, 3)
    assert (nuts.split_rhat(z) < 1.1).all()
    zj = _jax_sharded(lambda z: -0.5 * jnp.sum(z * z), jnp.zeros(3), 0,
                      300, 300, 8)
    assert zj.shape == (8, 300, 3)
    assert (jnuts.split_rhat(zj) < 1.1).all()


def test_64_chains_sharded_over_mesh():
    """tests/test_nuts.py:125-140: 64 chains on N(1.5, 0.5^2), split-R-hat
    < 1.05, mean within 0.05 and sd within 0.07; the port's 150 + 150 over
    8 in-process CPU targets (8 chains a share at the start), uncut.  The
    reference's on the 8-device mesh is cut to 100 + 100: at 150 + 150 it
    took 18-48 s here (tests/test_nuts.py runs it uncut)."""
    res = nuts.nuts_sample(_gaussian(1.5, 0.5), np.zeros(2), seed=3,
                           num_warmup=150, num_samples=150, num_chains=64,
                           device="cpu", devices=["cpu"] * 8)
    assert nuts.SHARDS.route == "devices"
    assert max(nuts.SHARDS.max_rows) == 8
    zj = _jax_sharded(lambda z: -0.5 * jnp.sum((z - 1.5) ** 2 / 0.25),
                      jnp.zeros(2), 3, 100, 100, 64)
    assert np.asarray(res["z"]).shape == (64, 150, 2)
    assert zj.shape == (64, 100, 2)
    for z in (np.asarray(res["z"]), zj):
        assert (nuts.split_rhat(z) < 1.05).all()
        assert abs(z.mean() - 1.5) < 0.05
        assert abs(z.std() - 0.5) < 0.07


# ---- the rank route ----------------------------------------------------------

_RANK_KW = {"nuts": dict(draws=5, tune=5, max_treedepth=3),
            "hmc": dict(draws=6, tune=6, max_treedepth=3)}


@pytest.mark.parametrize("sampler", ["nuts", "hmc"])
def test_rank_route_equals_single_process(pool, sampler):
    """sample_model(mixed=True) with no mesh, 4 chains over 2 gloo ranks:
    each rank evaluates a contiguous share of every round and the shares
    meet in one all_gather a round (distributed.STATS); every rank's
    draws and stats equal the single-process run's bit for bit."""
    kw = dict(mixed=True, chains=4, sampler=sampler, random_seed=1,
              **_RANK_KW[sampler])
    _, every = pool.run(ranks.chains, kw)
    ref = nuts.sample_model(ranks.gp_cfg(), device="cpu", **kw)
    for post, stats, split, gathers in every:
        assert split["route"] == "ranks"
        assert split["targets"] == ["rank 0", "rank 1"]
        assert max(split["max_rows"]) <= 2 and min(split["calls"]) > 0
        # rank 0's share is never empty: one all_gather a round
        assert gathers == split["calls"][0]
        for name in ref.posterior:
            np.testing.assert_array_equal(post[name], ref.posterior[name],
                                          err_msg=name)
        for name in STATS:
            np.testing.assert_array_equal(stats[name],
                                          ref.sample_stats[name],
                                          err_msg=name)


def test_mesh_objective_is_not_split(pool):
    """sample_model(mesh=, sampler='nuts'): the row-sharded objective runs
    collectives itself (runs_collectives), so each rank evaluates every
    row the sampler asks for, and the ranks' lp agree."""
    _, every = pool.run(ranks.mesh_chains,
                        dict(chains=2, draws=2, tune=2, max_treedepth=3,
                             random_seed=0))
    for split, asked, evaluated, lp in every:
        assert split["route"] is None
        assert asked > 0 and evaluated == asked
        np.testing.assert_array_equal(lp, every[0][3])


def test_failing_rank_fails_every_rank(pool):
    """A rank whose share raises fails the call on every rank: there with
    its own exception, on the other naming it (the status rides in the
    round's all_gather, so no rank waits on a collective)."""
    _, every = pool.run(ranks.failing_share, 1)
    assert every[1] == ("FloatingPointError", "share of rank 1")
    assert every[0][0] == "RuntimeError" and "rank 1" in every[0][1]


def test_dryrun_multichip_includes_chain_sharded_run(pool):
    """dryrun_multichip(2) on the pool's 2 CPU ranks: besides the sharded
    paths, 2 NUTS chains of 4 + 4 transitions split over the ranks, lp
    finite."""
    out, every = pool.run(distributed.dryrun_multichip, 2, "cpu")
    assert out["chains_lp"].shape == (2, 4)
    assert np.isfinite(out["chains_lp"]).all()
    np.testing.assert_array_equal(every[1]["chains_lp"], out["chains_lp"])
