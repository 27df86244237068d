"""Multi-process execution of the port on torch.distributed (counterpart
of andvaranaut_tpu/distributed.py).

The reference's device-side axes are data rows (the O(N^2) Gram and
O(N^3) Cholesky, `gp/sharded.py`, psum / all_gather / psum_scatter over a
1-D mesh) and MCMC chains.  Here a mesh is a
`torch.distributed.device_mesh.DeviceMesh` with the dimension names
("data",), or ("chains", "data") for the hierarchical layout, and one
process runs each rank: every rank runs the same SPMD body on its own row
block and meets the others in the collectives below.  The chain axis is
the samplers' (`inference.nuts`): inside a group of more than one rank,
'nuts' and 'hmc' split each round's chain points over the ranks and
gather the values and gradients with one `all_gather`.

Backends follow the device: NCCL with one rank per card, gloo for CPU
tensors, and gloo for ranks that share one card (NCCL refuses two ranks
of one communicator on one device).  gloo takes CUDA tensors in all four
collectives the port uses (broadcast, all_reduce, all_gather_into_tensor,
reduce_scatter_tensor; checked on an H100 under torch 2.11), so no
collective is staged through host memory: the tensors stay on the card
and gloo moves them.

- `initialize` joins a process group from explicit arguments or from
  torchrun's environment (MASTER_ADDR, WORLD_SIZE, RANK).
- `global_data_mesh`, `hierarchical_mesh`: the 1-D and the 2-D mesh.
- The collectives layer (`broadcast`, `all_reduce`, `all_gather`,
  `reduce_scatter`) counts calls and bytes in `STATS`, and with
  `STATS.timed` their host seconds between device synchronisations
  (the split between compute and collective time of a rank).
- `Chain` makes them differentiable for reverse-mode autograd through an
  SPMD evaluation (the reference's AD through shard_map).
- `RankPool` / `launch` spawn ranks with a `file://` rendezvous in a fresh
  temporary directory; a rank's exception fails the call.
- `dryrun_multichip`: one step of each sharded path at tiny shapes, and
  NUTS chains split over the ranks (counterpart of
  __graft_entry__.dryrun_multichip).
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

from ._config import resolve_device


# -- process groups and meshes ------------------------------------------------

def _backend(dev: torch.device, local_ranks: int) -> str:
    """gloo for CPU tensors and for ranks that share a card; NCCL with one
    rank per card."""
    if dev.type != "cuda" or local_ranks > torch.cuda.device_count():
        return "gloo"
    return "nccl"


#: the device the group was formed on by this module (None: not by it)
_GROUP_DEVICE = None


def _form_group(init_method: str, world_size: int, rank: int, dev,
                local_ranks=None):
    """init_process_group on `dev` (its card taken as the rank's own when
    the host has one per rank)."""
    global _GROUP_DEVICE
    dev = torch.device(dev)
    local_ranks = world_size if local_ranks is None else local_ranks
    _GROUP_DEVICE = dev
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count()
                              if dev.index is None else dev.index)
    dist.init_process_group(_backend(dev, local_ranks),
                            init_method=init_method, world_size=world_size,
                            rank=rank)


def ensure_group(device=None) -> None:
    """A process group: the existing one, or a one-rank group on `device`
    (None: the card; NCCL there, gloo on the CPU) through a `file://`
    rendezvous in a fresh temporary directory.  The SPMD bodies then run
    through their collectives on one rank; nothing skips them."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    d = tempfile.mkdtemp(prefix="andvaranaut_group_")
    _form_group("file://" + os.path.join(d, "rendezvous"), 1, 0, dev)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=None) -> bool:
    """Join (or form) a multi-process group.

    Explicit arguments: coordinator_address ('host:port', or any
    init_method URL such as 'file:///path'), num_processes and
    process_id; a failure raises.  Without them, torchrun's environment
    (MASTER_ADDR, WORLD_SIZE, RANK; LOCAL_RANK picks the card); a failure
    there warns and stays single-process.  Neither: a no-op.  Idempotent;
    returns True when a group of more than one rank is active.  device
    (None: the card) picks the backend: NCCL with one rank per card,
    gloo otherwise."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = coordinator_address is not None or num_processes is not None
    env = all(v in os.environ for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK"))
    if not explicit and not env:
        return False
    try:
        if explicit:
            url = (coordinator_address if "://" in str(coordinator_address)
                   else f"tcp://{coordinator_address}")
            world, rank, local = (int(num_processes), int(process_id),
                                  int(num_processes))
        else:
            url = "env://"
            world, rank = int(os.environ["WORLD_SIZE"]), int(
                os.environ["RANK"])
            local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None and not explicit:
            dev = torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", rank))
                % torch.cuda.device_count())
        _form_group(url, world, rank, dev, local)
    except (ValueError, RuntimeError, TypeError) as e:
        if explicit:
            raise  # explicit arguments: misconfiguration is an error
        warnings.warn(f"torch.distributed initialisation from the "
                      f"environment failed ({e}); continuing single-process")
        return False
    return dist.get_world_size() > 1


def _device_type(device) -> str:
    """The mesh's device type: that of `device`, or that of the device
    the group was formed on (a group formed elsewhere: cuda under NCCL,
    the CPU under gloo)."""
    if device is not None:
        return torch.device(device).type
    if _GROUP_DEVICE is not None:
        return _GROUP_DEVICE.type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def global_data_mesh(axis: str = "data", device=None):
    """1-D mesh over every rank of the group (a one-rank group on
    `device` when there is none; `ensure_group`)."""
    from torch.distributed.device_mesh import DeviceMesh

    ensure_group(device)
    return DeviceMesh(_device_type(device), list(range(dist.get_world_size())),
                      mesh_dim_names=(axis,))


def hierarchical_mesh(chains_axis: str = "chains", data_axis: str = "data",
                      num_slices: int | None = None, device=None):
    """2-D (chains, data) mesh with the chain axis on the slow dimension:
    consecutive ranks (one host's cards, on NVLink) share a data row, so
    the Cholesky's collectives stay inside a host and only the chains,
    which need no collective, cross hosts.  num_slices defaults to the
    number of hosts (WORLD_SIZE / LOCAL_WORLD_SIZE, 1 on one host), which
    gives (1, world) on one host.  ValueError when the world does not
    split into num_slices."""
    from torch.distributed.device_mesh import DeviceMesh

    ensure_group(device)
    world = dist.get_world_size()
    if num_slices is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        num_slices = max(world // max(local, 1), 1)
    if world % num_slices:
        raise ValueError(f"{world} ranks do not split into {num_slices} "
                         f"slices")
    ranks = torch.arange(world).reshape(num_slices, world // num_slices)
    return DeviceMesh(_device_type(device), ranks,
                      mesh_dim_names=(chains_axis, data_axis))


def mesh_axis(mesh, axis: str = "data"):
    """(group, rank in the axis, axis size, device) of a DeviceMesh's
    named dimension; TypeError for anything that is not a DeviceMesh."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh must be a torch.distributed.device_mesh.DeviceMesh "
            f"(distributed.global_data_mesh, sharded.data_mesh), got "
            f"{type(mesh).__name__}")
    dim = mesh.mesh_dim_names.index(axis)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh.size(dim), dev)


# -- the collectives layer ---------------------------------------------------

class CollectiveStats:
    """Calls, bytes and (with `timed`) host seconds of this rank's
    collectives.  Timed, each collective is bracketed by device
    synchronisations, so compute queued before it is not counted as its
    time."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self):
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0


STATS = CollectiveStats()


# torch 2.13 renamed the tensor forms (the old names warn there)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _sync(x):
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _run(x, nbytes, fn):
    STATS.calls += 1
    STATS.bytes += int(nbytes)
    if not STATS.timed:
        fn()
        return
    _sync(x)
    t0 = time.perf_counter()
    fn()
    _sync(x)
    STATS.seconds += time.perf_counter() - t0


def broadcast(x, src: int, group):
    """x of the group's rank `src` on every rank, in place (exact: the
    reference's psum of a block masked to one rank, with half the
    traffic).  Returns x."""
    _run(x, x.numel() * x.element_size(),
         lambda: dist.broadcast(x, group=group, group_src=src))
    return x


def all_reduce(x, group):
    """The sum over the group's ranks, in place; every rank gets the same
    bits.  Returns x."""
    _run(x, x.numel() * x.element_size(),
         lambda: dist.all_reduce(x, group=group))
    return x


def all_gather(x, group):
    """The ranks' x concatenated along dim 0 in rank order (the
    reference's tiled all_gather)."""
    size = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    _run(x, out.numel() * out.element_size(),
         lambda: _ALL_GATHER(out, x, group=group))
    return out


def reduce_scatter(x, group):
    """x (size, ...) on every rank -> the sum over ranks of x[rank] (the
    reference's psum_scatter, untiled, scatter dimension 0)."""
    x = x.contiguous()
    out = x.new_empty(x[0].numel())
    _run(x, x.numel() * x.element_size(),
         lambda: _REDUCE_SCATTER(out, x.reshape(-1), group=group))
    return out.reshape(x.shape[1:])


class _Collective(torch.autograd.Function):
    """One differentiable collective with a token in and out.  Backward:
    broadcast -> the cotangents summed to the source rank; all_gather ->
    reduce-scatter of the cotangent; replicate (identity on a replicated
    input) -> the mean over ranks of the per-rank gradients."""

    @staticmethod
    def forward(ctx, kind, group, src, x, token):
        ctx.kind, ctx.group, ctx.src = kind, group, src
        ctx.rank = dist.get_rank(group)
        ctx.size = dist.get_world_size(group)
        fmt = torch.contiguous_format
        if kind == "broadcast":
            y = (x.detach().clone(memory_format=fmt) if ctx.rank == src
                 else torch.empty_like(x, memory_format=fmt))
            broadcast(y, src, group)
        elif kind == "all_gather":
            y = all_gather(x.detach(), group)
        else:
            y = x.detach().clone()
        return y, token.detach().clone()

    @staticmethod
    def backward(ctx, ct, ct_token):
        if ctx.kind == "broadcast":
            g = all_reduce(ct.contiguous().clone(), ctx.group)
            if ctx.rank != ctx.src:
                g = torch.zeros_like(g)
        elif ctx.kind == "all_gather":
            g = reduce_scatter(ct.reshape(
                (ctx.size, ct.shape[0] // ctx.size) + tuple(ct.shape[1:])),
                ctx.group)
        else:
            g = all_reduce(ct.contiguous().clone(), ctx.group) / ctx.size
        return None, None, None, g, ct_token


class Chain:
    """The differentiable collectives of one SPMD evaluation.

    Autograd runs a backward node when its inputs' gradients are ready,
    and that order could differ between ranks whose graphs branch on the
    rank; two ranks would then meet in different collectives.  So every
    collective takes the previous one's token and gives a new one: the
    backward pass meets them in exactly the reverse order on every rank,
    and every rank builds every node (the token requires grad even where
    the data do not).  `replicated(z)` is the evaluation's replicated
    input, first in the chain: its backward sums the per-rank gradients
    over the group and divides by the group's size, the reference's
    gradient of a replicated input.  `tie(out)` joins the last token to
    the output (adding 0), so that every rank runs the whole chain."""

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.token = None

    def _apply(self, kind, x, src=0):
        if self.token is None:
            self.token = x.new_zeros((), requires_grad=True)
        y, self.token = _Collective.apply(kind, self.group, src, x,
                                          self.token)
        return y

    def replicated(self, z):
        return self._apply("replicate", z)

    def broadcast(self, x, src):
        return self._apply("broadcast", x, src)

    def all_gather(self, x):
        return self._apply("all_gather", x)

    def tie(self, out):
        return out if self.token is None else out + 0.0 * self.token


# -- spawned ranks -----------------------------------------------------------

#: seconds a RankPool call may take before it fails
RUN_TIMEOUT = 1800.0

def _to_host(obj):
    """Tensors (anywhere in tuples, lists and dicts) as numpy arrays."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def _rank_main(rank, world, init, device, threads, tasks, results):
    try:
        if threads:
            torch.set_num_threads(int(threads))
        _form_group(init, world, rank, device)
    except Exception:  # noqa: BLE001 — reported to the parent
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                out = _to_host(fn(*args))
                results.put((rank, True, out))
            except Exception:  # noqa: BLE001 — reported to the parent
                results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankPool:
    """`world_size` spawned ranks in one process group on `device` ('cpu'
    or 'cuda'; the backend by `_backend`), kept alive between calls.
    `run(fn, *args)` runs fn(*args) on every rank (fn and args
    picklable, fn a module-level function) and returns (rank 0's
    result, every rank's result), tensors as numpy arrays.  A rank that
    raises or dies fails the call with its traceback and stops the pool.
    The rendezvous is a file in a fresh temporary directory, so that
    concurrent pools never share a port.  threads: torch threads per rank
    (None: torch's default).  A call that runs longer than RUN_TIMEOUT
    seconds fails."""

    def __init__(self, world_size: int, device="cpu", threads=None):
        ctx = multiprocessing.get_context("spawn")
        self.world_size = int(world_size)
        self._dir = tempfile.mkdtemp(prefix="andvaranaut_ranks_")
        init = "file://" + os.path.join(self._dir, "rendezvous")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.world_size)]
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, self.world_size, init, str(device), threads,
                  self._tasks[r], self._results))
            for r in range(self.world_size)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args):
        if self._procs is None:
            raise RuntimeError("the rank pool is closed")
        for q in self._tasks:
            q.put((fn, args))
        out = [None] * self.world_size
        pending = set(range(self.world_size))
        deadline = time.monotonic() + RUN_TIMEOUT
        while pending:
            try:
                rank, ok, res = self._results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r in pending
                        if self._procs[r].exitcode is not None]
                if dead:
                    code = self._procs[dead[0]].exitcode
                    self._stop()
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code {code} during "
                        f"{getattr(fn, '__name__', fn)}")
                if time.monotonic() > deadline:
                    self._stop()
                    raise TimeoutError(
                        f"{getattr(fn, '__name__', fn)} did not finish on "
                        f"ranks {sorted(pending)}")
                continue
            if not ok:
                self._stop()
                raise RuntimeError(f"rank {rank} failed in "
                                   f"{getattr(fn, '__name__', fn)}:\n{res}")
            out[rank] = res
            pending.discard(rank)
        return out[0], out

    def _stop(self):
        procs, self._procs = self._procs, None
        if procs is None:
            return
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        shutil.rmtree(self._dir, ignore_errors=True)

    def close(self):
        """Stop the ranks (they leave their group first)."""
        if self._procs is None:
            return
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=30)
        self._stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def launch(fn, world_size: int, device="cpu", *args, threads=None):
    """fn(*args) on `world_size` freshly spawned ranks (`RankPool`):
    returns (rank 0's result, every rank's result).  Any rank's exception
    is raised here (RuntimeError with its traceback)."""
    with RankPool(world_size, device, threads=threads) as pool:
        return pool.run(fn, *args)


# -- the dry run -------------------------------------------------------------

def _toy_data(n, nx=2):
    """__graft_entry__._toy_data's inputs and targets."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(n, nx))
    y = np.sin(3 * rng.uniform(size=n)) + rng.normal(size=n) * 0.01
    return X, y


def _dryrun_body(n_ranks: int, device):
    """One step of each sharded path on this rank's group: the sharded
    NLML's value+grad, the closed-form value+grad, the predict, the cwgp
    warped value+grad, sample_model(mesh=) with 2 chains of 2 + 2
    transitions and the chain-sharded NUTS run (n_ranks chains of 4 + 4
    transitions split over the ranks); each result checked finite.
    Returns the replicated outputs."""
    from . import transform as tf
    from .gp import engine, sharded
    from .inference import nuts
    from .lhc import _none_conrev

    dev = resolve_device(device)
    mesh = sharded.data_mesh(device=dev)
    n = 8 * n_ranks
    X, y = _toy_data(n)
    Xs, ys = sharded.shard_data(mesh, X, y)
    build_rvpack, nlp = sharded.make_sharded_nlml(mesh, ("RBF",), (), True,
                                                  1e-6)
    rvpack = build_rvpack(X.shape[1])
    z = rvpack.z0().requires_grad_()
    val = nlp(z, Xs, ys, rvpack)
    (grad,) = torch.autograd.grad(val, z)
    out = {"nlml": (val.detach(), grad)}

    rvp2, _, vg = sharded.make_sharded_mixed_objective(mesh, X, y, block=16)
    out["closed_form"] = vg(rvp2.z0())

    hypers = {"l": np.array([0.5, 0.7]), "kv": np.array([1.2]),
              "gv": np.array(1e-4)}
    predict = sharded.make_sharded_predict(mesh, X, y, hypers, block=16)
    out["predict"] = predict(X[:8] + 0.01)

    cfg_w = engine.FitConfig(
        kerns=("RBF",), ops=(), noise=True, truncate=False, jitter=1e-6,
        iwgp=False, cwgp=True, priors=[None, None],
        xconrevs=[_none_conrev(), _none_conrev()],
        yconrevs=[tf.wgp(["meanstd", "sinharcsinh"], np.array([0.0, 1.0]),
                         y=y)],
        x=X, y=y.reshape(-1, 1))
    rvp3, _, vgw = sharded.make_sharded_warped_objective(mesh, cfg_w,
                                                         block=16)
    out["warped"] = vgw(rvp3.z0())

    cfg_m = engine.FitConfig(
        kerns=("RBF",), ops=(), noise=True, truncate=False, jitter=1e-6,
        iwgp=False, cwgp=False, priors=[None, None],
        xconrevs=[_none_conrev(), _none_conrev()],
        yconrevs=[_none_conrev()], x=X, y=y.reshape(-1, 1))
    data = nuts.sample_model(cfg_m, draws=2, tune=2, chains=2, mesh=mesh,
                             max_treedepth=2, random_seed=0)
    out["mcmc_lp"] = np.asarray(data.sample_stats["lp"])

    # the reference's device-sharded NUTS chains: one chain a rank, 4 + 4
    # transitions of the same posterior's exact objective, the chains
    # split over the group's ranks
    data = nuts.sample_model(cfg_m, draws=4, tune=4, chains=n_ranks,
                             sampler="nuts", random_seed=0, device=dev)
    if n_ranks > 1 and nuts.SHARDS.route != "ranks":
        raise RuntimeError(f"dry run: the chains were not split over the "
                           f"ranks ({nuts.SHARDS.route})")
    out["chains_lp"] = np.asarray(data.sample_stats["lp"])
    out = _to_host(out)
    for key, v in out.items():
        for a in (v if isinstance(v, tuple) else (v,)):
            if not np.isfinite(np.asarray(a)).all():
                raise FloatingPointError(f"dry run {key}: non-finite {a}")
    return out


def dryrun_multichip(n_ranks: int, device=None):
    """The multi-rank dry run at n = 8 n_ranks rows (`_dryrun_body`).
    Inside a group of n_ranks ranks it runs there; otherwise it spawns
    n_ranks ranks on `device` (None: the card; ranks share it over gloo
    when there are fewer cards than ranks) through `launch`, CPU ranks
    sharing this process's torch threads.  Returns rank 0's outputs;
    raises when any rank fails or any output is not finite."""
    if dist.is_initialized() and dist.get_world_size() == n_ranks:
        return _dryrun_body(n_ranks, device)
    dev = resolve_device(device)
    threads = (max(1, torch.get_num_threads() // n_ranks)
               if dev.type == "cpu" else None)
    out, _ = launch(_dryrun_body, n_ranks, str(dev.type), n_ranks,
                    str(dev.type), threads=threads)
    return out
