"""Multi-chain MCMC over GP hyperparameters (counterpart of
andvaranaut_tpu/inference/nuts.py).

The samplers are host loops over value+grad calls of the objective,
advancing the chains in lockstep: every leapfrog step is ONE batched
call, `vec_eval(Z (C_active, dim)) -> (U (C_active,), dU/dz (C_active,
dim))`, over the chains that still need a point evaluated (what the
reference's jax.vmap over the chains does inside its compiled
while_loop).  The objectives carry that batched form as
`neg_log_post.vec_value_and_grad`: the mixed-precision one
(`gp.bigfit.make_mixed_objective`) runs one batched K3 and one batched
K7 launch for all chains at n <= 512; the exact f64 one
(`gp.engine.build_objective`) one batched Cholesky.

- 'nuts' (the default): multinomial NUTS (Betancourt 2017) with the
  reference's iterative checkpoint U-turn scheme, dual-averaging step
  size and the Welford diagonal mass window [0.15 W, 0.95 W) with its
  regularised variance and step-size restart.  Each chain's transition
  is a Python generator that yields the points it needs evaluated; the
  loop in `_lockstep` gathers the yields of all chains into one batched
  call.  Each chain draws from its own numpy Generator, spawned from
  `random_seed`, so a chain's draws do not depend on the batching.  They
  cannot equal the JAX PRNG stream: the tests hold them statistically.
- 'hmc': jittered HMC through `host_hmc.hmc_host_sample` with the budget
  2**max_treedepth leapfrogs and ChEES trajectory-length adaptation
  (`adapt_tlen`), the port's stand-in for the reference's flat-scan
  'hmc' (a TPU workaround that is not ported).
- 'hmc_host': `host_hmc.hmc_host_sample` with the reference's options
  (curvature or pilot mass, parallel tempering).

Chain sharding (the reference's `shard=True`, its chains on a 1-D
("chains",) mesh): 'nuts' and 'hmc' cut each round's batch into
contiguous shares, one per target, and evaluate the shares on the
targets at once; the host state stays global, so the draws equal the
unsharded run's bit for bit (`_chain_split`, `ShardStats`).  The targets
are explicit devices (a worker thread each, with the objective rebuilt
there), the ranks of a torch.distributed group (each rank's own
objective; one all_gather a round) or the process's cards.  'hmc_host'
is not sharded, as in the reference.

Not ported (TPU workarounds, ROADMAP "Not to port"): hmc_flat_sample,
_run_chunk_flat, hmc_fixed, steps_per_call chunking and the
vec='map'/'vmap' split (the port always batches the chains); `key` is
`seed`, the numpy seed of the chains' Generators.

Diagnostics (`split_rhat`, `ess_bulk`) and the `MCMCData` carrier are
NumPy, copied from the reference.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from .._config import DTYPE, resolve_device
from . import host_hmc

_MAX_DELTA_ENERGY = 1000.0
SAMPLERS = ("nuts", "hmc", "hmc_host")


class _DAState(NamedTuple):
    """Dual-averaging state (Hoffman & Gelman 2014, sec. 3.2)."""

    log_eps: float
    log_eps_bar: float
    h_bar: float
    mu: float
    t: float


def _da_init(eps0):
    return _DAState(math.log(eps0), 0.0, 0.0, math.log(10.0 * eps0), 0.0)


def _da_update(state: _DAState, accept_prob, target):
    gamma, t0, kappa = 0.05, 10.0, 0.75
    t = state.t + 1.0
    w = 1.0 / (t + t0)
    h_bar = (1.0 - w) * state.h_bar + w * (target - accept_prob)
    log_eps = state.mu - math.sqrt(t) / gamma * h_bar
    wt = t ** (-kappa)
    log_eps_bar = wt * log_eps + (1.0 - wt) * state.log_eps_bar
    return _DAState(log_eps, log_eps_bar, h_bar, state.mu, t)


def _da_adam_init(eps0):
    """ADAM step-size state (ChEES-HMC style), packed into _DAState:
    h_bar -> first moment, mu -> second moment, t -> step count."""
    return _DAState(math.log(eps0), 0.0, 0.0, 0.0, 0.0)


def _da_adam_update(state: _DAState, accept_prob, target):
    """Bounded ADAM ascent on log_eps toward the target acceptance.

    Dual averaging multiplies the running-mean acceptance excess by
    sqrt(t)/gamma, so a run of ~0 acceptances drives log_eps down by tens
    of nats, an absorbing collapse for a short warmup; ADAM's step is
    bounded by lr (~0.05 nats), and recovery runs at the same rate.
    host_hmc._AdamEps is the same update."""
    b1, b2, lr, kappa = 0.9, 0.95, 0.05, 0.75
    t = state.t + 1.0
    g = accept_prob - target
    m = b1 * state.h_bar + (1.0 - b1) * g
    v = b2 * state.mu + (1.0 - b2) * g * g
    mhat = m / (1.0 - b1 ** t)
    vhat = v / (1.0 - b2 ** t)
    log_eps = state.log_eps + lr * mhat / (math.sqrt(vhat) + 1e-8)
    wt = t ** (-kappa)
    log_eps_bar = wt * log_eps + (1.0 - wt) * state.log_eps_bar
    return _DAState(log_eps, log_eps_bar, m, v, t)


def _kinetic(r, inv_mass):
    return 0.5 * float(np.dot(inv_mass * r, r))


def _energy(U, r, inv_mass):
    """U + kinetic energy, +inf where that is not a number (the sampler
    runs with numpy's overflow and invalid warnings off: a non-finite
    energy is a divergence)."""
    H = U + _kinetic(r, inv_mass)
    return math.inf if math.isnan(H) else H


def _uturn(r_sum, r_first, r_last, inv_mass):
    v = inv_mass * r_sum
    return bool(np.dot(v, r_first) <= 0.0) or bool(np.dot(v, r_last) <= 0.0)


def _logaddexp(a: float, b: float) -> float:
    hi, lo = (a, b) if a >= b else (b, a)
    if lo == -math.inf:
        return hi
    return hi + math.log1p(math.exp(lo - hi))


def _trailing_ones(i: int) -> int:
    u = i + 1
    return ((u & -u) - 1).bit_count()


def _leapfrog(z, r, grad, eps, inv_mass):
    """One leapfrog step as a generator: yields the new position, is sent
    (U, grad) there, returns (z, r, U, grad)."""
    r = r - 0.5 * eps * grad
    z = z + eps * inv_mass * r
    U, grad = yield z
    r = r - 0.5 * eps * grad
    return z, r, U, grad


def _build_subtree(rng, depth, z0, r0, U0, grad0, direction, eps, inv_mass,
                   H0, max_treedepth):
    """Build a balanced subtree of 2^depth leaves from (z0, r0) in
    `direction`, one leapfrog per leaf (a generator over the points).

    Checkpoints: at an even leaf i the momentum and the running momentum
    sum before it go to slot popcount(i); at an odd leaf with t trailing
    ones the completed level-k subtrees (k = 1..t) are checked against
    slots popcount(i) - k.  Leaves are sampled multinomially within the
    subtree.  Returns a dict: endpoint state, momentum sum S, proposal
    (z, U, grad), log weight, accept-statistic sum, leaf count and the
    turning/diverging flags."""
    dim = z0.shape[0]
    seps = direction * eps
    z, r, U, grad = z0, r0, U0, grad0
    S = np.zeros(dim)
    lw = -math.inf
    prop = (z0, U0, grad0)
    sum_accept = 0.0
    turning = diverging = False
    r_ck = np.zeros((max_treedepth + 1, dim))
    s_ck = np.zeros((max_treedepth + 1, dim))
    i = 0
    while i < 2 ** depth and not turning and not diverging:
        z, r, U, grad = yield from _leapfrog(z, r, grad, seps, inv_mass)
        H = _energy(U, r, inv_mass)
        diverging = (H - H0) > _MAX_DELTA_ENERGY
        lw_leaf = H0 - H
        pc = i.bit_count()
        if i % 2 == 0:
            r_ck[pc] = r
            s_ck[pc] = S
        S = S + r
        turning = False
        for k in range(1, _trailing_ones(i) + 1):
            ck = min(max(pc - k, 0), max_treedepth)
            turning = turning or _uturn(S - s_ck[ck], r_ck[ck], r, inv_mass)
        lw_new = _logaddexp(lw, lw_leaf)
        p_take = math.exp(lw_leaf - lw_new) if lw_new > -math.inf else 0.0
        if rng.uniform() < p_take:
            prop = (z, U, grad)
        lw = lw_new
        sum_accept += math.exp(min(0.0, H0 - H))
        i += 1
    return {"z": z, "r": r, "U": U, "grad": grad, "S": S, "lw": lw,
            "prop": prop, "sum_accept": sum_accept, "n_leaves": i,
            "turning": turning, "diverging": diverging}


def _nuts_transition(rng, z, U, grad, eps, inv_mass, max_treedepth):
    """One NUTS trajectory from z (a generator over the points it needs
    evaluated).  Returns (z', U', grad', stats).  The proposal's value
    and gradient are carried from its leaf, where the reference
    evaluated the proposal once more."""
    dim = z.shape[0]
    r0 = rng.standard_normal(dim) / np.sqrt(inv_mass)
    H0 = U + _kinetic(r0, inv_mass)
    ends = {1: (z, r0, U, grad), -1: (z, r0, U, grad)}
    S = r0
    lw = 0.0
    prop = (z, U, grad)
    depth = 0
    turning = diverging = False
    sum_accept = 0.0
    n_leaves = 0
    while depth < max_treedepth and not turning and not diverging:
        direction = 1 if rng.uniform() < 0.5 else -1
        sub = yield from _build_subtree(
            rng, depth, *ends[direction], direction, eps, inv_mass, H0,
            max_treedepth)
        ok = not sub["turning"] and not sub["diverging"]
        if ok:
            ends[direction] = (sub["z"], sub["r"], sub["U"], sub["grad"])
        # biased progressive sampling: favour the new subtree
        p_new = math.exp(min(0.0, sub["lw"] - lw))
        if rng.uniform() < p_new and ok:
            prop = sub["prop"]
        if ok:
            lw = _logaddexp(lw, sub["lw"])
            S = S + sub["S"]
        full_turn = ok and _uturn(S, ends[-1][1], ends[1][1], inv_mass)
        turning = sub["turning"] or full_turn
        diverging = sub["diverging"]
        sum_accept += sub["sum_accept"]
        n_leaves += sub["n_leaves"]
        depth += 1
    stats = {"accept": sum_accept / max(n_leaves, 1),
             "diverging": diverging, "depth": depth, "n_leaves": n_leaves}
    return (*prop, stats)


def _find_reasonable_eps(rng, z, U, grad, inv_mass):
    """Heuristic initial step size (Hoffman & Gelman Alg. 4), a generator
    over the probes: from eps = 1, double (or halve) while one leapfrog's
    acceptance stays above (below) 1/2, at most 50 times, inside
    (1e-10, 1e10)."""
    r0 = rng.standard_normal(z.shape[0]) / np.sqrt(inv_mass)
    H0 = U + _kinetic(r0, inv_mass)

    def accept_prob(eps):
        _, r1, U1, _ = yield from _leapfrog(z, r0, grad, eps, inv_mass)
        return math.exp(min(H0 - _energy(U1, r1, inv_mass), 700.0))

    eps = 1.0
    p = yield from accept_prob(eps)
    up = p > 0.5
    it = 0
    while ((p > 0.5) if up else (p < 0.5)) and it < 50 and 1e-10 < eps < 1e10:
        eps = eps * (2.0 if up else 0.5)
        it += 1
        p = yield from accept_prob(eps)
    return eps


def _lockstep(gens, vec_eval):
    """Run generators to their ends in lockstep: each round gathers the
    point every live generator yielded into ONE batched evaluation and
    sends each its (U, grad).  Returns the generators' return values."""
    out = [None] * len(gens)
    pending = {}

    def advance(i, msg):
        try:
            pending[i] = gens[i].send(msg)
        except StopIteration as stop:
            out[i] = stop.value
            pending.pop(i, None)

    for i in range(len(gens)):
        advance(i, None)
    while pending:
        idx = list(pending)
        us, gs = vec_eval(np.stack([pending[i] for i in idx]))
        for j, i in enumerate(idx):
            advance(i, (float(us[j]), np.asarray(gs[j], dtype=np.float64)))
    return out


def _nuts_chains(vec_eval, z0, seed, num_warmup, num_samples, num_chains,
                 target_accept, max_treedepth, jitter_init):
    """Adaptive NUTS for `num_chains` chains in lockstep: the reference's
    _init_chain and _run_chunk on the host.  Returns the post-warmup
    draws as the nuts_sample dict."""
    z0 = np.asarray(z0, dtype=np.float64).reshape(-1)
    dim = z0.shape[0]
    C = num_chains
    seq = np.random.SeedSequence(seed)
    init_rng, *rngs = [np.random.default_rng(s) for s in seq.spawn(C + 1)]
    Z = z0[None, :] + init_rng.uniform(-jitter_init, jitter_init,
                                       size=(C, dim))
    U, G = vec_eval(Z)
    U = np.asarray(U, dtype=np.float64)
    G = np.asarray(G, dtype=np.float64)
    inv_mass = np.ones((C, dim))
    eps0 = _lockstep([_find_reasonable_eps(rngs[c], Z[c], U[c], G[c],
                                           inv_mass[c]) for c in range(C)],
                     vec_eval)
    da = [_da_init(e) for e in eps0]
    w_n = np.zeros(C)
    w_mean = np.zeros((C, dim))
    w_m2 = np.zeros((C, dim))
    # Welford mass window [0.15 W, 0.95 W)
    w_start = int(0.15 * num_warmup)
    w_end = max(int(0.95 * num_warmup), w_start + 1)
    total = num_warmup + num_samples
    out = {"z": np.empty((C, num_samples, dim)),
           "lp": np.empty((C, num_samples)),
           "diverging": np.zeros((C, num_samples), dtype=bool),
           "accept": np.empty((C, num_samples)),
           "depth": np.empty((C, num_samples), dtype=np.int64),
           "eps": np.empty((C, num_samples))}
    for step in range(total):
        warm = step < num_warmup
        eps = [math.exp(d.log_eps if warm else d.log_eps_bar) for d in da]
        res = _lockstep([_nuts_transition(rngs[c], Z[c], U[c], G[c], eps[c],
                                          inv_mass[c], max_treedepth)
                         for c in range(C)], vec_eval)
        for c, (z, u, g, st) in enumerate(res):
            Z[c], U[c], G[c] = z, u, g
            if warm:
                da[c] = _da_update(da[c], st["accept"], target_accept)
                if w_start <= step < w_end:
                    w_n[c] += 1
                    delta = z - w_mean[c]
                    w_mean[c] = w_mean[c] + delta / w_n[c]
                    w_m2[c] = w_m2[c] + delta * (z - w_mean[c])
            if step == w_end:
                # the mass estimate applies; step-size adaptation restarts
                cnt = max(w_n[c], 1.0)
                var = w_m2[c] / cnt
                inv_mass[c] = (cnt / (cnt + 5.0)) * var + 1e-3 * (
                    5.0 / (cnt + 5.0))
                da[c] = _da_init(math.exp(da[c].log_eps))
            if not warm:
                i = step - num_warmup
                out["z"][c, i] = z
                out["lp"][c, i] = -u
                out["diverging"][c, i] = st["diverging"]
                out["accept"][c, i] = st["accept"]
                out["depth"][c, i] = st["depth"]
                out["eps"][c, i] = eps[c]
    return out


def potential_fns(neg_log_post, device=None):
    """(u_and_grad, vec_eval): host NumPy callables of a torch potential
    U(z) (minus the log posterior over the unconstrained z).
    u_and_grad(z) -> (U, dU/dz) by torch.autograd, z placed on `device`
    (None: the card); vec_eval(Z (C, dim)) -> (U (C,), dU/dz (C, dim)) is
    the objective's own batched form `neg_log_post.vec_value_and_grad`
    where it has one, else u_and_grad row by row.  A factorisation that
    refuses a non-positive-definite matrix reads as U = NaN (the value
    the reference's f64 Cholesky gives there), which the samplers treat
    as a divergence."""
    dev = resolve_device(device)

    def u_and_grad(z):
        zt = torch.tensor(np.asarray(z, dtype=np.float64), dtype=DTYPE,
                          device=dev, requires_grad=True)
        try:
            u = neg_log_post(zt)
            (g,) = torch.autograd.grad(u, zt)
        except torch.linalg.LinAlgError:
            return math.nan, np.zeros(zt.shape[0])
        return float(u.detach()), g.cpu().numpy()

    vec_eval = getattr(neg_log_post, "vec_value_and_grad", None)
    if vec_eval is None:
        def vec_eval(Z):
            outs = [u_and_grad(z) for z in np.asarray(Z)]
            return (np.asarray([o[0] for o in outs]),
                    np.stack([o[1] for o in outs]))

    return u_and_grad, vec_eval


# ---------------------------------------------------------------------------
# Chain sharding
# ---------------------------------------------------------------------------

class ShardStats:
    """How the last 'nuts' or 'hmc' run split its chains: `route` (None:
    unsharded; 'devices': worker threads; 'ranks': a process group),
    `targets` (their names) and, per target, the batched calls it ran,
    the rows it evaluated and its largest share.  Every rank records
    every target's share (the split is the same on all of them)."""

    def __init__(self):
        self.reset()

    def reset(self, route=None, targets=()):
        self.route = route
        self.targets = [str(t) for t in targets]
        k = len(self.targets)
        self.calls, self.rows, self.max_rows = [0] * k, [0] * k, [0] * k

    def _add(self, bounds):
        for t in range(len(bounds) - 1):
            m = bounds[t + 1] - bounds[t]
            if m:
                self.calls[t] += 1
                self.rows[t] += m
                self.max_rows[t] = max(self.max_rows[t], m)


SHARDS = ShardStats()


def _bounds(m, k):
    """Row bounds of k contiguous shares of m rows (np.array_split's: the
    first m % k shares one row longer)."""
    q, r = divmod(m, k)
    return [t * q + min(t, r) for t in range(k + 1)]


def _canon(dev):
    """A torch.device with its card's index filled in."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class _ThreadShards:
    """The batched evaluation over in-process targets: one worker thread
    per target evaluates its contiguous share of every batch through
    `evals[t]` (the objective's replica on its device), on a CUDA stream
    of its own where the device is a card.  The shares come back to the
    host in row order; a share that raises fails the call with its
    traceback once every share has ended."""

    def __init__(self, evals, devices):
        import queue
        import threading

        self.evals = evals
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                        else None for d in devices]
        for d in {d for d in devices if d.type == "cuda"}:
            # the replicas' tensors were made on the default stream
            torch.cuda.synchronize(d)
        self.tasks = [queue.SimpleQueue() for _ in devices]
        self.done = queue.SimpleQueue()
        # a new thread starts with OpenMP's default pool, not the caller's
        threads = torch.get_num_threads()
        self.workers = [threading.Thread(target=self._work,
                                         args=(t, threads), daemon=True,
                                         name=f"chain-shard-{t}")
                        for t in range(len(devices))]
        for w in self.workers:
            w.start()

    def _work(self, t, threads):
        torch.set_num_threads(threads)
        stream = self.streams[t]
        while True:
            Z = self.tasks[t].get()
            if Z is None:
                return
            try:
                if stream is None:
                    out = self.evals[t](Z)
                else:
                    with torch.cuda.device(stream.device), \
                            torch.cuda.stream(stream):
                        out = self.evals[t](Z)
                self.done.put((t, True, out))
            except BaseException as e:  # noqa: BLE001 — raised by the caller
                self.done.put((t, False, e))

    def __call__(self, Z):
        Z = np.asarray(Z, dtype=np.float64)
        b = _bounds(Z.shape[0], len(self.tasks))
        live = [t for t in range(len(self.tasks)) if b[t + 1] > b[t]]
        for t in live:
            self.tasks[t].put(Z[b[t]:b[t + 1]])
        outs, err = {}, None
        for _ in live:
            t, ok, out = self.done.get()
            if ok:
                outs[t] = out
            elif err is None:
                err = out
        if err is not None:
            raise err
        SHARDS._add(b)
        return (np.concatenate([np.asarray(outs[t][0], dtype=np.float64)
                                .reshape(-1) for t in live]),
                np.concatenate([np.asarray(outs[t][1], dtype=np.float64)
                                .reshape(-1, Z.shape[1]) for t in live]))

    def close(self):
        for q in self.tasks:
            q.put(None)
        for w in self.workers:
            w.join()


class _RankShards:
    """The batched evaluation over a process group's ranks: each rank
    evaluates its contiguous share of every batch with its own objective,
    padded to the largest share, and the shares meet in one
    `distributed.all_gather` a round (a rank with an empty share joins
    it).  A status row rides along, so a rank whose share raised fails
    the call on every rank: there with its traceback, elsewhere naming
    it."""

    def __init__(self, vec_eval):
        import torch.distributed as dist

        self.vec_eval = vec_eval
        self.group = dist.group.WORLD
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.dev = (torch.device("cuda", torch.cuda.current_device())
                    if dist.get_backend() == "nccl" else torch.device("cpu"))

    def __call__(self, Z):
        from .. import distributed

        Z = np.asarray(Z, dtype=np.float64)
        m, dim = Z.shape
        b = _bounds(m, self.world)
        lo, hi = b[self.rank], b[self.rank + 1]
        pad = -(-m // self.world)
        buf = np.zeros((pad + 1, dim + 1))
        err = None
        if hi > lo:
            try:
                U, G = self.vec_eval(Z[lo:hi])
                buf[:hi - lo, 0] = np.asarray(U, dtype=np.float64)
                buf[:hi - lo, 1:] = np.asarray(G, dtype=np.float64)
            except Exception as e:  # noqa: BLE001 — raised after the gather
                err = e
                buf[pad, 0] = 1.0
        out = distributed.all_gather(
            torch.from_numpy(buf).to(self.dev), self.group).cpu().numpy()
        out = out.reshape(self.world, pad + 1, dim + 1)
        if err is not None:
            raise err
        failed = np.flatnonzero(out[:, pad, 0])
        if failed.size:
            raise RuntimeError(f"rank {int(failed[0])} failed evaluating its "
                               f"share of the chains")
        SHARDS._add(b)
        rows = np.concatenate([out[r, :b[r + 1] - b[r]]
                               for r in range(self.world)])
        return rows[:, 0].copy(), rows[:, 1:].copy()


def _shard_targets(nlp, device, devices):
    """(route, targets): ('devices', [torch.device]), ('ranks', [rank
    names]) or (None, []), in the reference's order (`nuts_sample`)."""
    import torch.distributed as dist

    if getattr(nlp, "runs_collectives", False):
        return None, []
    if devices is not None:
        return "devices", [torch.device(d) for d in devices]
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return "ranks", [f"rank {r}" for r in range(dist.get_world_size())]
    if (hasattr(nlp, "replicate") and torch.cuda.is_available()
            and torch.cuda.device_count() > 1
            and resolve_device(device).type == "cuda"):
        return "devices", [torch.device("cuda", i)
                           for i in range(torch.cuda.device_count())]
    return None, []


def _replica_evals(nlp, device, targets):
    """The batched evaluation of `nlp` on each target device: `nlp` itself
    on its own device, `nlp.replicate(dev)` on another (one replica a
    device, shared by its targets), a plain objective (no batched form)
    row by row with z on the target's device."""
    own = _canon(resolve_device(device))
    made = {}
    evals = []
    for dev in targets:
        key = _canon(dev)
        if key not in made:
            obj = nlp
            if key != own and hasattr(nlp, "replicate"):
                obj = nlp.replicate(key)
            elif key != own and hasattr(nlp, "vec_value_and_grad"):
                raise ValueError(
                    f"the objective's batched form runs on {own} and it has "
                    f"no replicate(device) to rebuild it on {key}; give it "
                    f"one or pass shard=False")
            made[key] = potential_fns(obj, key)[1]
        evals.append(made[key])
    return evals


@contextlib.contextmanager
def _chain_split(nlp, vec_eval, device, num_chains, shard, devices):
    """The batched evaluation a 'nuts' or 'hmc' run uses: `vec_eval`, or
    its chain-sharded form under the reference's rule (more than one
    target, and the chains divide by their count).  Records the split in
    `SHARDS`; the worker threads stop when the run ends."""
    route, targets = (_shard_targets(nlp, device, devices) if shard
                      else (None, []))
    if len(targets) < 2 or num_chains % len(targets):
        SHARDS.reset()
        yield vec_eval
        return
    SHARDS.reset(route, targets)
    if route == "ranks":
        yield _RankShards(vec_eval)
        return
    shards = _ThreadShards(_replica_evals(nlp, device, targets), targets)
    try:
        yield shards
    finally:
        shards.close()


def _sample_potential(nlp, u_and_grad, vec_eval, z0, *, seed, num_warmup,
                      num_samples, num_chains, target_accept, max_treedepth,
                      jitter_init, sampler, adapt_tlen, device, shard,
                      devices):
    if sampler not in ("nuts", "hmc"):
        raise ValueError(
            f"sampler must be 'nuts' or 'hmc' here, got {sampler!r}")
    with _chain_split(nlp, vec_eval, device, num_chains, shard,
                      devices) as vec:
        if sampler == "hmc":
            return host_hmc.hmc_host_sample(
                u_and_grad, z0, num_warmup=num_warmup,
                num_samples=num_samples, num_chains=num_chains,
                target_accept=target_accept, budget=2 ** max_treedepth,
                jitter_init=jitter_init, seed=seed, adapt_tlen=adapt_tlen,
                vec_eval=vec if num_chains >= 2 else None)
        # a non-finite energy is a divergence: numpy need not warn of it
        with np.errstate(over="ignore", invalid="ignore"):
            return _nuts_chains(vec, z0, seed, num_warmup, num_samples,
                                num_chains, target_accept, max_treedepth,
                                jitter_init)


def _negated(logp_fn):
    """minus `logp_fn`, carrying its batched form, its `replicate` (of
    the negation) and its collectives mark."""

    def nlp(z):
        return -logp_fn(z)

    vec = getattr(logp_fn, "vec_value_and_grad", None)
    if vec is not None:
        nlp.vec_value_and_grad = vec
    rep = getattr(logp_fn, "replicate", None)
    if rep is not None:
        nlp.replicate = lambda dev: _negated(rep(dev))
    if getattr(logp_fn, "runs_collectives", False):
        nlp.runs_collectives = True
    return nlp


def nuts_sample(logp_fn, z0, *, seed=0, num_warmup=1000, num_samples=1000,
                num_chains=4, target_accept=0.8, max_treedepth=10,
                jitter_init=1.0, sampler="nuts", adapt_tlen=True,
                shard=True, devices=None, device=None):
    """Run `num_chains` adaptive NUTS (or jittered HMC) chains in lockstep,
    sharded over the available targets.

    logp_fn: unconstrained log posterior, a torch function of a 1-D f64
    tensor on `device` (None: the card), differentiable by autograd; a
    `vec_value_and_grad` attribute on it (of minus the log posterior, as
    the objectives of gp.bigfit and gp.engine carry) is taken for the
    batched calls, and a `replicate(device)` attribute (the same function
    rebuilt on another device) for the in-process shards.  z0: (dim,)
    start; chains start at z0 + U(-jitter, jitter) (PyMC's
    jitter+adapt_diag init).  seed: the numpy seed of the chains'
    Generators (the reference's `key`).
    sampler: 'nuts' (adaptive tree building, at most 2**max_treedepth
    leapfrogs a transition) or 'hmc' (jittered trajectories with the
    budget 2**max_treedepth leapfrogs through host_hmc.hmc_host_sample,
    its ChEES trajectory-length adaptation on with adapt_tlen and two or
    more chains).

    shard (the reference's rule, nuts.py:947): the chains are sharded
    when there is more than one shard target and num_chains divides by
    their count; otherwise the loop runs unsharded.  The targets, first
    found first taken:
    1. `devices`, a list of devices (repeats allowed): one worker thread
       each, on a CUDA stream of its own on a card, with the objective's
       replica on its device (`replicate`, built once a device; a plain
       logp_fn is called with z on each target's device, and one that
       holds tensors on another device raises torch's device error);
    2. the ranks of an active torch.distributed group of world size > 1,
       each rank on its own device with its own copy of the objective
       (every rank must run the same call); the shares meet in one
       `distributed.all_gather` a round, counted in `distributed.STATS`;
    3. the process's CUDA devices, when there are more than one, device
       is a card and the objective has `replicate` (a plain function may
       hold tensors on one card, so it is split over cards only when
       `devices` names them).
    An objective that runs collectives itself (`runs_collectives`, those
    of gp.sharded, reached by sample_model(mesh=)) is never split: its
    ranks already share every evaluation.
    The split cuts each lockstep round's batch (the pending chains'
    points) into contiguous shares, one per target, rather than pinning
    chains to targets (the reference's P("chains")): NUTS trees of
    different depths then still balance.  The host state (generators,
    step sizes, masses, ChEES statistics) stays global and each chain's
    row gives the same bits in any batch, so the draws equal the
    unsharded run's bit for bit.  A target that raises fails the call
    with its traceback; nothing reruns unsharded or elsewhere.
    `SHARDS` records the split of the last run.
    Returns a dict of numpy arrays with leading (chains, draws): z, lp,
    diverging, accept, depth, eps."""
    nlp = _negated(logp_fn)
    u_and_grad, vec_eval = potential_fns(nlp, device)
    return _sample_potential(
        nlp, u_and_grad, vec_eval, z0, seed=seed, num_warmup=num_warmup,
        num_samples=num_samples, num_chains=num_chains,
        target_accept=target_accept, max_treedepth=max_treedepth,
        jitter_init=jitter_init, sampler=sampler, adapt_tlen=adapt_tlen,
        device=device, shard=shard, devices=devices)


# ---------------------------------------------------------------------------
# Diagnostics (arviz-free)
# ---------------------------------------------------------------------------

def split_rhat(x):
    """Split-R-hat over (chains, draws) samples (Vehtari et al. 2021)."""
    x = np.asarray(x)
    c, n = x.shape[:2]
    half = n // 2
    halves = np.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)
    m, nn = halves.shape[:2]
    chain_means = halves.mean(axis=1)
    chain_vars = halves.var(axis=1, ddof=1)
    W = chain_vars.mean(axis=0)
    B = nn * chain_means.var(axis=0, ddof=1)
    var_est = (nn - 1) / nn * W + B / nn
    return np.sqrt(var_est / W)


def ess_bulk(x):
    """Bulk effective sample size via autocorrelation (Geyer initial
    monotone sequence), on rank-normalised draws."""
    from scipy.special import ndtri

    x = np.asarray(x, dtype=np.float64)
    c, n = x.shape[:2]
    if x.ndim == 2:
        x = x[..., None]
    out = []
    for j in range(x.shape[-1]):
        xj = x[..., j]
        # rank-normalise
        r = np.argsort(np.argsort(xj.reshape(-1))).reshape(c, n) + 1.0
        z = ndtri((r - 0.375) / (c * n + 0.25))
        out.append(_ess_raw(z))
    return np.array(out) if len(out) > 1 else out[0]


def _ess_raw(x):
    c, n = x.shape
    means = x.mean(axis=1, keepdims=True)
    xc = x - means
    # per-chain autocovariance via FFT
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :n].real / n
    W = acov[:, 0].mean()
    var_w = x.var(axis=1, ddof=1).mean()
    B = x.mean(axis=1).var(ddof=1) * 1.0 if c > 1 else 0.0
    var_plus = (n - 1) / n * var_w + B
    rho = 1.0 - (W - acov.mean(axis=0)) / var_plus
    # Geyer initial monotone positive sequence
    prev = np.inf
    t = 1
    tau = 1.0
    while t + 1 < n:
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        pair = min(pair, prev)
        prev = pair
        tau += 2.0 * pair
        t += 2
    return c * n / max(tau, 1e-12)


class MCMCData:
    """Minimal InferenceData-like container: posterior draws per RV with
    leading (chain, draw) plus sample stats — what mean_extract/map_extract
    (gpmcmc.py:404-430) and the diagnostics need."""

    def __init__(self, posterior: dict, sample_stats: dict):
        self.posterior = posterior
        self.sample_stats = sample_stats

    def posterior_mean(self):
        return {
            k: np.asarray(v).mean(axis=(0, 1))
            for k, v in self.posterior.items()
        }

    def max_logp_point(self):
        lp = np.asarray(self.sample_stats["lp"])
        idx = np.unravel_index(np.argmax(lp), lp.shape)
        point = {
            k: np.asarray(v)[idx] for k, v in self.posterior.items()
        }
        return point, float(lp[idx])

    def rhat(self):
        return {
            k: split_rhat(
                np.asarray(v).reshape(v.shape[0], v.shape[1], -1))
            for k, v in self.posterior.items()
        }

    def ess(self):
        return {
            k: ess_bulk(np.asarray(v)) for k, v in self.posterior.items()
        }

    def summary(self):
        lines = []
        for k, v in self.posterior.items():
            v = np.asarray(v)
            lines.append(
                f"{k}: mean={v.mean(axis=(0, 1))}, rhat={self.rhat()[k]}")
        div = np.asarray(self.sample_stats.get("diverging", np.zeros(1)))
        lines.append(f"divergences: {int(div.sum())}")
        return "\n".join(lines)

    def to_dict(self):
        """The arviz ``from_dict`` schema: posterior/sample_stats groups of
        (chain, draw[, ...]) arrays plus coords/dims, so downstream arviz
        workflows (``fit(return_data=True)``) interchange without arviz
        installed."""
        chains, draws = next(iter(
            np.asarray(v).shape[:2] for v in self.posterior.values()))
        dims = {}
        coords = {"chain": np.arange(chains), "draw": np.arange(draws)}
        for k, v in self.posterior.items():
            v = np.asarray(v)
            if v.ndim > 2:
                dims[k] = [f"{k}_dim_{i}" for i in range(v.ndim - 2)]
                for i, size in enumerate(v.shape[2:]):
                    coords[f"{k}_dim_{i}"] = np.arange(size)
        return {
            "posterior": {k: np.asarray(v)
                          for k, v in self.posterior.items()},
            "sample_stats": {
                k: np.asarray(v) for k, v in self.sample_stats.items()},
            "coords": coords,
            "dims": dims,
        }

    def to_inference_data(self):
        """arviz InferenceData when arviz is importable; otherwise the
        equivalent ``to_dict`` schema (arviz is an optional dependency)."""
        d = self.to_dict()
        try:
            import arviz as az
        except ImportError:
            return d
        return az.from_dict(
            posterior=d["posterior"], sample_stats=d["sample_stats"],
            coords={k: v for k, v in d["coords"].items()
                    if k not in ("chain", "draw")},
            dims=d["dims"])


def as_inference_data(data):
    """arviz InferenceData when arviz is importable, the input otherwise
    — the facade's ``fit(return_data=True)`` contract (the reference
    returns pm.sample's InferenceData; MCMCData carries the same schema
    via .to_dict())."""
    if not isinstance(data, MCMCData):
        return data
    try:
        import arviz  # noqa: F401
    except ImportError:
        return data
    return data.to_inference_data()


def sample_rvpack(rvpack, neg_log_post, draws=1000, tune=1000, chains=4,
                  target_accept=0.8, random_seed=0, max_treedepth=10,
                  z0=None, verbose=False, sampler=None, adapt_tlen=True,
                  curvature_mass=False, pilot=0, temper=0, beta_min=0.25,
                  device=None, devices=None) -> MCMCData:
    """Sample over an RVPack's unconstrained space and unpack the draws
    into constrained posterior arrays.

    neg_log_post: a torch function of z on `device` (None: the card);
    its `vec_value_and_grad` attribute, where it has one, takes the
    batched calls (`potential_fns`).
    sampler: None (-> 'nuts', the reference's default off a TPU),
    'nuts', 'hmc' or 'hmc_host'; 'hmc' and 'hmc_host' take
    max_treedepth 6 where it is left at 10 (a budget of 64 leapfrogs).
    'nuts' and 'hmc' shard the chains under `nuts_sample`'s rule (more
    than one target, and the chains divide by their count) over, in this
    order, `devices` (one thread each, the objective rebuilt there by its
    `replicate`), the ranks of an active process group of world size > 1
    (each rank's own objective, every rank in the call) or the process's
    cards (objectives with `replicate`), cutting each round's batch into
    contiguous shares; an objective with `runs_collectives` is not split.
    The draws equal the unsharded run's bit for bit.
    'hmc_host' (host_hmc.hmc_host_sample, all chains batched when there
    are two or more; never sharded, as in the reference):
    - pilot > 0 runs the two-stage pilot-mass schedule;
    - temper > 0 adds `temper` parallel-tempering lanes on a geometric
      inverse-temperature ladder down to beta_min, in (0, 1); the
      returned MCMCData has `chains` chains, as without tempering;
    - curvature_mass with a warm z0 (a MAP point) fixes the mass to the
      finite-difference curvature there (through the batched call).
    temper with another sampler raises (the reference ignored it
    silently), as does beta_min outside (0, 1) (the reference then
    returned chains + temper chains)."""
    if sampler is None:
        sampler = "nuts"
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler must be one of {SAMPLERS}, got "
                         f"{sampler!r}")
    if temper:
        if sampler != "hmc_host":
            raise ValueError(
                f"temper={temper} needs sampler='hmc_host' (parallel "
                f"tempering runs on its batched lanes), got {sampler!r}")
        if not 0.0 < float(beta_min) < 1.0:
            raise ValueError(
                f"beta_min must lie in (0, 1), got {beta_min!r}")
    if sampler in ("hmc", "hmc_host") and max_treedepth == 10:
        # jittered trajectory lengths within 2**depth; these
        # low-dimensional hyperposteriors mix well under a 64-step budget
        max_treedepth = 6
    if z0 is None:
        z0 = rvpack.z0()
    z0 = np.asarray(torch.as_tensor(z0).cpu(), dtype=np.float64)
    u_and_grad, vec_eval = potential_fns(neg_log_post, device)
    if sampler == "hmc_host":
        SHARDS.reset()
        betas = None
        if temper:
            # geometric hot ladder below the cold chains: e.g. temper=4,
            # beta_min=0.25 -> 0.71, 0.50, 0.35, 0.25
            betas = np.concatenate([
                np.ones(chains),
                float(beta_min) ** (np.arange(1, int(temper) + 1)
                                    / float(temper))])
            chains = chains + int(temper)
        vec_fn = vec_eval if chains >= 2 else None
        if not curvature_mass or pilot:
            # an explicit pilot schedule supersedes the curvature mass
            im0 = None
        elif vec_fn is not None:
            im0 = host_hmc.map_diag_inv_mass_batched(vec_fn, z0, chains)
        else:
            im0 = host_hmc.map_diag_inv_mass(u_and_grad, z0)
        res = host_hmc.hmc_host_sample(
            u_and_grad, z0, num_warmup=tune, num_samples=draws,
            num_chains=chains, target_accept=target_accept,
            budget=2 ** max_treedepth, seed=random_seed, inv_mass0=im0,
            adapt_mass=im0 is None, vec_eval=vec_fn, pilot=pilot,
            betas=betas)
    else:
        res = _sample_potential(
            neg_log_post, u_and_grad, vec_eval, z0, seed=random_seed,
            num_warmup=tune, num_samples=draws, num_chains=chains,
            target_accept=target_accept, max_treedepth=max_treedepth,
            jitter_init=1.0, sampler=sampler, adapt_tlen=adapt_tlen,
            device=device, shard=True, devices=devices)
    zdraws = np.asarray(res["z"])  # (chains, draws, dim)
    posterior = {}
    for rv, off in zip(rvpack.rvs, rvpack.offsets):
        block = torch.as_tensor(zdraws[..., off:off + rv.size])
        vals = rv.forward(block).numpy()
        posterior[rv.name] = vals[..., 0] if rv.size == 1 else vals
    stats = {k: np.asarray(res[k])
             for k in ("lp", "diverging", "accept", "depth", "eps")}
    data = MCMCData(posterior, stats)
    if verbose:
        print(data.summary())
        if "swap_accept" in res:
            print("tempering ladder swap accept:",
                  np.array2string(np.asarray(res["swap_accept"]),
                                  precision=2))
    return data


def _warped_mixed_objective(cfg, block, device):
    """(rvpack, neg_log_post) of an iwgp/cwgp configuration through
    `bigfit.make_warped_vg`: the likelihood is an autograd Function whose
    forward computes the value and closed-form gradient together and
    whose backward returns the saved gradient times the cotangent (the
    reference's custom VJP).  neg_log_post.vec_value_and_grad evaluates
    the chains one by one; a chain whose factorisation the f64 fallback
    refuses gives NaN; neg_log_post.replicate(device) builds it again on
    another device."""
    from ..gp import bigfit

    dev = resolve_device(device)
    rvpack, vg = bigfit.make_warped_vg(cfg, block=block, device=dev)

    class _LogL(torch.autograd.Function):
        @staticmethod
        def forward(ctx, z):
            val, grad = vg(z)
            ctx.save_for_backward(grad.to(z.device))
            return val.to(z.device)

        @staticmethod
        def backward(ctx, ct):
            (grad,) = ctx.saved_tensors
            return ct * grad

    def neg_log_post(z):
        return -(_LogL.apply(z) + rvpack.log_prior(z))

    def vec_value_and_grad(Z):
        us, gs = [], []
        for z in np.asarray(Z, dtype=np.float64).reshape(-1, rvpack.total):
            zz = torch.tensor(z, device=dev, requires_grad=True)
            try:
                u = neg_log_post(zz)
                (g,) = torch.autograd.grad(u, zz)
            except torch.linalg.LinAlgError:
                u, g = zz.new_full((), math.nan), torch.full_like(zz,
                                                                  math.nan)
            us.append(u.detach())
            gs.append(g)
        return torch.stack(us).cpu().numpy(), torch.stack(gs).cpu().numpy()

    neg_log_post.vec_value_and_grad = vec_value_and_grad
    neg_log_post.replicate = lambda d: _warped_mixed_objective(
        cfg, block, d)[1]
    return rvpack, neg_log_post


def _resolve_mcmc_block(n: int) -> int:
    """Factorisation block of the mixed MCMC objective: one block up to
    n = 512 (one batched K3 and K7 launch for all chains), else
    min(256, n // 2) (floored at 32); ANDVARANAUT_MCMC_BLOCK overrides
    and must be a positive int."""
    env_block = os.environ.get("ANDVARANAUT_MCMC_BLOCK")
    if env_block:
        block = int(env_block)
        if block < 1:
            raise ValueError(
                "ANDVARANAUT_MCMC_BLOCK must be a positive int, got "
                f"{env_block!r}")
        return block
    return n if n <= 512 else min(256, max(32, n // 2))


def _sharded_objective(cfg, mesh, mixed, device):
    """(rvpack, neg_log_post, device) of sample_model(mesh=): the
    row-sharded closed form at block min(_resolve_mcmc_block(n), 256),
    mixed unless mixed=False, on the mesh's device unless `device` says
    otherwise."""
    from ..distributed import mesh_axis
    from ..gp import engine, sharded

    device = mesh_axis(mesh)[3] if device is None else device
    block = min(_resolve_mcmc_block(cfg.x.shape[0]), 256)
    mixed = True if mixed is None else bool(mixed)
    if cfg.iwgp or cfg.cwgp:
        rvpack, nlp, _ = sharded.make_sharded_warped_objective(
            mesh, cfg, block=block, mixed=mixed)
    else:
        xin, yin = engine._converted(cfg)
        rvpack, nlp, _ = sharded.make_sharded_mixed_objective(
            mesh, xin, yin, kerns=cfg.kerns, ops=cfg.ops, noise=cfg.noise,
            truncate=cfg.truncate, jitter=cfg.jitter, block=block,
            mixed=mixed)
    return rvpack, nlp, device


def sample_model(cfg, draws=1000, tune=1000, chains=4, target_accept=0.8,
                 random_seed=0, max_treedepth=10, verbose=False,
                 mixed=None, sampler=None, adapt_tlen=True, mesh=None,
                 pilot=0, temper=0, beta_min=0.25, device=None,
                 devices=None, **kwargs):
    """Posterior over a FitConfig's hyperparameters, the engine-level
    analogue of pm.sample inside the reference's fit (gpmcmc.py:351).

    mixed: None (-> False, the reference's default off a TPU) takes the
    exact f64 objective (`engine.build_objective`: batched Cholesky over
    the chains, or chain by chain with learnable warpings); True the
    mixed-precision closed form at `_resolve_mcmc_block(n)`:
    `bigfit.make_mixed_objective`, whose batched call runs one K3 and one
    K7 launch for all chains at n <= 512 and the K1-K6 value+grad chain
    by chain above that, or, with learnable warpings (iwgp/cwgp),
    `bigfit.make_warped_vg` as an autograd Function, its batched call
    chain by chain.
    sampler: None -> 'nuts'; 'hmc' or 'hmc_host' (`sample_rvpack`).
    start=hypers (a dict of constrained values, e.g. a MAP fit) starts
    the chains there and, for 'hmc_host', fixes the mass to the
    curvature there.  device: where the objective runs (None: the card).
    mesh: a DeviceMesh routes every leapfrog's value+grad through the
    row-sharded closed form at block min(_resolve_mcmc_block(n), 256)
    (`sharded.make_sharded_mixed_objective`, or the warped variant for
    iwgp/cwgp), mixed unless mixed=False, on the mesh's device; sampler
    then defaults to 'hmc_host', whose lockstep chains every rank runs
    together.
    Chain sharding (`sample_rvpack`, `nuts_sample`'s rule): 'nuts' and
    'hmc' cut each round's batch into contiguous shares over `devices`
    (the objective built once a device, through its `replicate`), else
    the ranks of an active process group of world size > 1 (every rank
    runs this call with its own objective), else the process's cards,
    when there is more than one target and the chains divide by their
    count; the draws equal the unsharded run's.  The mesh's objective
    runs collectives itself and is not split."""
    from ..gp import bigfit, engine

    if sampler is None:
        sampler = "hmc_host" if mesh is not None else "nuts"
    if mesh is not None:
        rvpack, nlp, device = _sharded_objective(cfg, mesh, mixed, device)
    elif mixed and (cfg.iwgp or cfg.cwgp):
        rvpack, nlp = _warped_mixed_objective(
            cfg, _resolve_mcmc_block(cfg.x.shape[0]), device)
    elif mixed:
        xin, yin = engine._converted(cfg)
        rvpack, nlp = bigfit.make_mixed_objective(
            xin, yin, kerns=cfg.kerns, ops=cfg.ops, noise=cfg.noise,
            truncate=cfg.truncate, jitter=cfg.jitter,
            block=_resolve_mcmc_block(cfg.x.shape[0]), device=device)
    else:
        rvpack, nlp = engine.build_objective(cfg, device=device)
    z0 = rvpack.z0()
    start = kwargs.pop("start", None)
    if kwargs:
        raise TypeError(f"unexpected arguments {sorted(kwargs)}")
    warm = False
    if start is not None:
        try:
            z0 = rvpack.pack_values(start)
            warm = True
        except (KeyError, TypeError):
            pass
    return sample_rvpack(
        rvpack, nlp, draws=draws, tune=tune, chains=chains,
        target_accept=target_accept, random_seed=random_seed,
        max_treedepth=max_treedepth, z0=z0, verbose=verbose,
        sampler=sampler, adapt_tlen=adapt_tlen,
        # a warm start is (almost always) a fitted MAP point: the host
        # sampler's mass is fixed to the curvature there
        curvature_mass=warm, pilot=pilot, temper=temper,
        beta_min=beta_min, device=device, devices=devices)
