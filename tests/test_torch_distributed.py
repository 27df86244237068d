"""Port parity, the multi-process plumbing (andvaranaut_torch/distributed.py)
against tests/test_distributed.py: initialize() as a single-process no-op,
the 1-D and the hierarchical meshes on a pool of 4 gloo ranks, the
sharded NLML over the 'data' dimension of a 2 x 2 mesh against the JAX
dense objective, a rank's failure failing the call, and the multi-rank
dry run (the counterpart of __graft_entry__.dryrun_multichip) on 4 CPU
ranks."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_sharded_ranks as ranks
from andvaranaut_tpu.gp import engine as jengine
from andvaranaut_tpu.gp import kernels as jkernels
from andvaranaut_tpu.gp import sharded as jsharded
from andvaranaut_torch import distributed

D = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module (the ranks run one each).
    Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    p = distributed.RankPool(D, "cpu", threads=1)
    yield p
    p.close()


def test_initialize_single_process_noop(monkeypatch):
    """Without arguments or torchrun's environment: no group, False, and
    again False (idempotent)."""
    for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    assert distributed.initialize() is False
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()


def test_initialize_explicit_arguments_raise():
    """Explicit arguments that cannot form a group raise (the reference's
    rule); a world of 2 with rank 5 is refused before any rendezvous."""
    with pytest.raises((ValueError, RuntimeError)):
        distributed.initialize(f"file://{os.devnull}", 2, 5, device="cpu")
    assert not torch.distributed.is_initialized()


def test_meshes_on_four_ranks(pool):
    """global_data_mesh over the 4 ranks; hierarchical_mesh (1, 4) by
    default on one host and (2, 2) with num_slices=2, ValueError at 3;
    initialize() inside the group reports it."""
    out, every = pool.run(ranks.meshes)
    m1, names1, h1, hnames, h2, raised, active = out
    assert m1 == (D,) and names1 == ("data",)
    assert h1 == (1, D) and hnames == ("chains", "data")
    assert h2 == (2, D // 2)
    assert raised and active
    assert all(r == out for r in every)


def test_sharded_nlml_over_hierarchical_data_axis(pool):
    """make_sharded_nlml over the 'data' dimension of the 2 x 2 mesh
    (each row of 2 ranks factorises on its own) against the JAX dense
    objective, rel 1e-10 (tests/test_distributed.py:35-53); both rows,
    every rank, the same bits."""
    out, every = pool.run(ranks.nlml, "RBF", True, 32, 0.1, "row", 4, 2)
    for r in every:
        assert np.array_equal(r[0], out[0]) and np.array_equal(r[1], out[1])
    build, _ = jsharded.make_sharded_nlml(jsharded.data_mesh(
        jax.devices()[:1]), ("RBF",), (), True, 1e-6)
    rv = build(2)
    z = rv.z0() + 0.1
    X, y = (jnp.asarray(a) for a in ranks.toy(32))
    vals = rv.unpack(z)
    K = jkernels.gram(("RBF",), (), X, None, vals["l"], vals["kv"], None)
    K = K + jnp.eye(32) * (1e-6 + vals["gv"][0])
    want = float(-(jengine.chol_nlml(K, y) + rv.log_prior(z)))
    assert float(out[0]) == pytest.approx(want, rel=1e-10)


def test_launch_reraises_a_rank_failure():
    """A rank that raises fails the whole call, with its traceback."""
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        distributed.launch(ranks.raise_on, 2, "cpu", 1, threads=1)


def test_collectives_count_and_time():
    """The collectives layer counts calls and bytes, and times them when
    asked, on a one-rank group formed for the test (left after)."""
    assert not torch.distributed.is_initialized()
    distributed.ensure_group("cpu")
    try:
        group = torch.distributed.group.WORLD
        distributed.STATS.reset()
        distributed.STATS.timed = True
        x = torch.arange(6, dtype=torch.float64)
        assert torch.equal(distributed.all_reduce(x.clone(), group), x)
        assert torch.equal(distributed.broadcast(x.clone(), 0, group), x)
        assert torch.equal(distributed.all_gather(x, group), x)
        assert torch.equal(distributed.reduce_scatter(x[None], group), x)
        stats = distributed.STATS
        assert stats.calls == 4 and stats.bytes == 4 * 48
        assert stats.seconds > 0.0
    finally:
        distributed.STATS.timed = False
        torch.distributed.destroy_process_group()


def test_dryrun_multichip_cpu():
    """dryrun_multichip(4) on 4 spawned gloo ranks: one step each of the
    sharded NLML's value+grad, the closed form, the predict, the cwgp
    warped value+grad and sample_model(mesh=), and 4 NUTS chains of 4 + 4
    split over the ranks, every output finite."""
    out = distributed.dryrun_multichip(D, device="cpu")
    assert set(out) == {"nlml", "closed_form", "predict", "warped",
                        "mcmc_lp", "chains_lp"}
    assert out["mcmc_lp"].shape == (2, 2)
    assert out["chains_lp"].shape == (D, 4)
    assert out["predict"][0].shape == (8,)
