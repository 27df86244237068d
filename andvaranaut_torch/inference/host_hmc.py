"""Host-driven jittered HMC (counterpart of
andvaranaut_tpu/inference/host_hmc.py, which is NumPy only: the port
keeps its own copy).

The integrator, the chain state (position, momentum, step size, mass)
and the adaptation live in NumPy on the host; each leapfrog step is one
value+grad call of the objective, or, with `vec_eval` and two or more
chains, one batched call that advances every chain a leapfrog.  On the
card that call is the mixed-precision closed-form value+grad
(`gp.bigfit.make_mixed_objective`), whose kernels at n <= 512 take all
chains in one launch each.

Adaptation: bounded-ADAM step-size ascent (dual averaging's collapse
mode is documented in nuts._da_adam_update), a Welford diagonal mass
applied at 0.6*warmup (pooled over the chains when batched), uniformly
jittered trajectory lengths within the budget or ChEES-adapted ones,
curvature, pilot and dense masses, and parallel tempering over the
batched lanes.

The random stream is the reference's: the same `np.random.default_rng`
calls in the same order, so on the same objective and seed the two give
equal draws.  Two of the reference's defects are fixed, each a
documented divergence: a non-finite kinetic energy (an overflow of
r' M^-1 r, which the reference met with a RuntimeWarning, and a NaN that
it neither accepted nor counted as a divergence) is a divergence,
silently; and `adapt_tlen=True` with fewer than two COLD lanes (one cold
chain beside hot tempering lanes) warns that ChEES falls back to uniform
jitter, where the reference warned only for one lane in all.
"""

from __future__ import annotations

import numpy as np

__all__ = ["hmc_host_sample"]


class _AdamEps:
    """Bounded ADAM ascent on log(eps) toward the target acceptance —
    the NumPy twin of nuts._da_adam_update (same constants)."""

    def __init__(self, eps0: float):
        self.log_eps = float(np.log(eps0))
        self.m = 0.0
        self.v = 0.0
        self.t = 0.0

    def update(self, accept_prob: float, target: float) -> None:
        b1, b2, lr = 0.9, 0.95, 0.05
        self.t += 1.0
        g = accept_prob - target
        self.m = b1 * self.m + (1.0 - b1) * g
        self.v = b2 * self.v + (1.0 - b2) * g * g
        mhat = self.m / (1.0 - b1 ** self.t)
        vhat = self.v / (1.0 - b2 ** self.t)
        self.log_eps += lr * mhat / (np.sqrt(vhat) + 1e-8)

    @property
    def eps(self) -> float:
        return float(np.exp(self.log_eps))


def _find_reasonable_eps(eval_ug, z, u, grad, inv_mass, rng,
                         eps0=1.0, max_doublings=30):
    """Hoffman-Gelman reasonable-epsilon search: double/halve eps until
    one leapfrog's acceptance crosses 1/2.  Essential at large n — the
    GP NLML's curvature scales with the dataset size (a 16k posterior
    needs eps ~1e-3 where n=256 wants ~0.3), far outside what a short
    bounded-ADAM warmup can traverse from a fixed start.  Costs one
    value+grad launch per probe."""
    r = _mass_draw(rng, inv_mass)
    h0 = u + float(_mass_kinetic(r, inv_mass))

    def dh_at(eps):
        rn = r - 0.5 * eps * grad
        zn = z + eps * _mass_vel(inv_mass, rn)
        un, gn = eval_ug(zn)
        if not np.isfinite(un):
            return np.inf
        rn = rn - 0.5 * eps * gn
        return un + float(_mass_kinetic(rn, inv_mass)) - h0

    eps = eps0
    dh = dh_at(eps)
    # direction: accept prob exp(-dh) vs 1/2  <=>  dh vs log 2
    up = dh < np.log(2.0)
    for _ in range(max_doublings):
        eps = eps * 2.0 if up else eps * 0.5
        dh = dh_at(eps)
        if up and dh >= np.log(2.0):
            return eps * 0.5
        if (not up) and dh < np.log(2.0):
            return eps
    return eps


class _ChainState:
    """Per-chain HMC state (position, cached value+grad, step-size
    ADAM, diagonal-mass Welford)."""

    def __init__(self, z, u, grad, adam, dim):
        self.z, self.u, self.grad, self.adam = z, u, grad, adam
        self.inv_mass = np.ones(dim)
        self.w_n, self.w_mean, self.w_m2 = 0, np.zeros(dim), np.zeros(dim)


def map_diag_inv_mass(u_and_grad, z_map, fd_h=1e-2, floor=1e-12,
                      clip_max=1.0, rel_tol=1e-5):
    """Diagonal inverse mass from the curvature at a MAP point.

    At the posterior mode the covariance is ~H^-1 (H = grad^2 U, U the
    negative log posterior), so inv_mass_i = 1/H_ii whitens the target
    far better than a Welford estimate built from a handful of
    correlated warmup transitions — the measured budget-16 failure mode
    at 16k (accept 0.08 post-apply: the mass landed mid-warmup off a
    ~18-transition window and the eps re-search had no room to recover,
    docs/TPU_NOTES.md).  Central differences of the gradient: 2*dim
    value+grad launches (~12 s at 16k) — negligible next to one
    transition.

    fd_h: step in unconstrained space.  NOT tiny: the mixed-precision
    16k gradient carries absolute noise that swamps H_ii*h at h=1e-4
    (measured: two of four dims came back NEGATIVE at the true
    optimum); 1e-2 is ~1 posterior std there and still well inside the
    quadratic basin.
    clip_max: upper clip on inv_mass_i (weakly-identified/noisy
    directions otherwise explode the step along that axis).  1.0 =
    unit mass, the prior z-scale of the GP hyperparameter menu
    (lognormal/halfnormal sigmas ~0.75-1) — the posterior cannot be
    wider.  Non-positive curvature directions fall back to the
    SMALLEST resolved inv_mass (conservative-small: the step-size
    search compensates an undersized axis upward, while one oversized
    axis collapses eps for every dimension at once — a unit fallback
    next to a 1e-5-variance dim was the measured 16k crawl mode); with
    no resolved dimension at all, to clip_max (or 1.0).
    rel_tol: "resolved" is RELATIVE — h_i > rel_tol * max(h) — not just
    sign-positive: the FD gradient noise that flips a dead direction
    negative equally often leaves it barely POSITIVE, and 1/h of a
    noise-sized positive clips to clip_max (the same crawl mode the
    smallest-resolved fallback exists to prevent).  1e-5 admits a 1e5
    curvature span (the GP hyperparameter menu's measured posterior
    variance span is ~1e2) while routing noise-scale survivors to the
    fallback.

    NOTE: when pilot draws are available, draws_inv_mass beats this
    estimator — at 16k the FD curvature overestimated the posterior
    z-variances 10-60x (gradient noise).
    """
    z = np.asarray(z_map, dtype=np.float64).reshape(-1)
    h = np.empty_like(z)
    for i in range(z.size):
        zp = z.copy()
        zp[i] += fd_h
        _, gp_ = u_and_grad(zp)
        zm = z.copy()
        zm[i] -= fd_h
        _, gm = u_and_grad(zm)
        h[i] = (np.asarray(gp_, dtype=np.float64)[i]
                - np.asarray(gm, dtype=np.float64)[i]) / (2.0 * fd_h)
    return _inv_mass_from_diag(h, floor, clip_max, rel_tol)


def map_diag_inv_mass_batched(vec_eval, z_map, lanes, fd_h=1e-2,
                              floor=1e-12, clip_max=1.0, rel_tol=1e-5):
    """map_diag_inv_mass through a BATCHED objective: the 2*dim central
    -difference probes run as ceil(2*dim/lanes) launches of the
    already-compiled chain-batched program instead of 2*dim serial
    launches of a program compiled ONLY for this (the serial 16k
    value+grad costs ~80 s of remote compile the batched MCMC run
    never otherwise needs).  `lanes` must equal the batch size
    vec_eval was built for (the chain count)."""
    z = np.asarray(z_map, dtype=np.float64).reshape(-1)
    dim = z.size
    probes = np.broadcast_to(z, (2 * dim, dim)).copy()
    for i in range(dim):
        probes[2 * i, i] += fd_h
        probes[2 * i + 1, i] -= fd_h
    grads = np.empty((2 * dim, dim))
    for s in range(0, 2 * dim, lanes):
        batch = probes[s:s + lanes]
        if batch.shape[0] < lanes:  # pad the last launch's dead lanes
            batch = np.concatenate(
                [batch, np.broadcast_to(z, (lanes - batch.shape[0],
                                            dim))])
        _, gs = vec_eval(batch)
        grads[s:s + lanes] = np.asarray(
            gs, dtype=np.float64)[:grads[s:s + lanes].shape[0]]
    h = np.asarray([
        (grads[2 * i, i] - grads[2 * i + 1, i]) / (2.0 * fd_h)
        for i in range(dim)])
    return _inv_mass_from_diag(h, floor, clip_max, rel_tol)


def _inv_mass_from_diag(h, floor, clip_max, rel_tol):
    """Shared tail of the curvature-mass estimators: relative
    resolution threshold, smallest-resolved fallback, clip."""
    resolved = h > max(floor, rel_tol * float(h.max(initial=0.0)))
    if resolved.any():
        fallback = float(1.0 / np.max(h[resolved]))
    else:
        fallback = 1.0 if clip_max is None else float(clip_max)
    im = np.where(resolved, 1.0 / np.maximum(h, floor), fallback)
    return np.minimum(im, clip_max) if clip_max is not None else im


class DenseMass:
    """Dense (full-covariance) mass matrix for the host sampler.

    Holds Sigma, the POSITION-covariance estimate (the inverse mass in
    the PyMC convention): momenta are drawn r ~ N(0, Sigma^-1), the
    kinetic energy is r' Sigma r / 2, and the leapfrog velocity is
    Sigma r.  A diagonal mass cannot whiten CORRELATED posteriors —
    the measured 16k regime: after diagonal whitening by the pilot
    variances the hyperposterior keeps a ~3.4x residual condition
    (docs/TPU_NOTES.md round 5), which short jittered trajectories
    random-walk along.  All operations are dim x dim host-side NumPy
    (dim ~ 4-10 for GP hyperposteriors) — free next to one objective
    launch."""

    def __init__(self, cov, ridge=0.0):
        self.cov = np.asarray(cov, dtype=np.float64)
        dim = self.cov.shape[0]
        if ridge:
            self.cov = self.cov + ridge * np.eye(dim)
        self.chol = np.linalg.cholesky(self.cov)
        self.chol_inv = np.linalg.inv(self.chol)

    def draw(self, rng, *lead):
        """r ~ N(0, Sigma^-1), shape (*lead, dim) (rows are draws)."""
        xi = rng.standard_normal((*lead, self.cov.shape[0]))
        return xi @ self.chol_inv  # row form of L^-T xi

    def kinetic(self, r):
        q = r @ self.chol
        return 0.5 * np.sum(q * q, axis=-1)

    def vel(self, r):
        return r @ self.cov


def _mass_draw(rng, im, *lead):
    if isinstance(im, DenseMass):
        return im.draw(rng, *lead)
    return rng.standard_normal((*lead, np.shape(im)[-1])) / np.sqrt(im)


def _mass_kinetic(r, im):
    """r' M^-1 r / 2; an overflow gives inf with no warning (the callers
    treat a non-finite energy as a divergence)."""
    with np.errstate(over="ignore", invalid="ignore"):
        if isinstance(im, DenseMass):
            return im.kinetic(r)
        return 0.5 * np.sum(r * im * r, axis=-1)


def _mass_vel(im, r):
    if isinstance(im, DenseMass):
        return im.vel(r)
    return im * r


def draws_dense_mass(z_draws, ridge=0.0):
    """DenseMass from a pilot run's draws: the full sample covariance
    (draws_inv_mass's dense analogue).  Correlated pilot draws
    underestimate scale — the safe direction — but capture the
    correlation DIRECTIONS that the diagonal estimator cannot."""
    z = np.asarray(z_draws, dtype=np.float64)
    z = z.reshape(-1, z.shape[-1])
    return DenseMass(np.cov(z.T), ridge=ridge)


def draws_inv_mass(z_draws, floor=1e-12):
    """Diagonal inverse mass from a pilot run's draws.

    z_draws: (..., dim) unconstrained draws (any leading shape — e.g.
    the ``z`` field of a previous hmc_host_sample result, or rows
    parsed from an MCMC_DRAWS_LOG file).  Returns the per-dimension
    sample variance — the estimand the in-sampler Welford window
    targets, but measured from actual posterior draws.

    Measured motivation (16k GP hyperposterior, docs/TPU_NOTES.md
    round 4): the posterior z-variances span [1e-5, 2.8e-4]; the
    finite-difference curvature overestimated them 10-60x (mixed-
    precision gradient noise) and PyMC-style additive regularisation
    toward 1e-3 would inflate the tightest dimension ~24x — so this
    estimator applies NO additive pull; correlated pilot draws
    UNDERestimate variance, which is the safe direction (the step-size
    search compensates upward, while an overestimated mass collapses
    eps for every dimension at once — the measured crawl mode).
    """
    z = np.asarray(z_draws, dtype=np.float64)
    z = z.reshape(-1, z.shape[-1])
    return np.maximum(z.var(axis=0, ddof=1), floor)


def _find_reasonable_eps_batched(eval_vec, Z, us, grads, IM, rng,
                                 eps0=1.0, max_doublings=30):
    """Lockstep reasonable-epsilon search for C chains: each probe is
    ONE batched launch; every chain doubles/halves its own eps until
    its one-leapfrog acceptance crosses 1/2 (finished chains ride
    along as wasted lanes — the search is <= ~15 probes total vs one
    launch per probe PER CHAIN serially)."""
    C, dim = Z.shape
    R = _mass_draw(rng, IM, C)
    h0 = us + _mass_kinetic(R, IM)
    log2 = float(np.log(2.0))

    def probe(eps):
        Rh = R - 0.5 * eps[:, None] * grads
        Zp = Z + eps[:, None] * _mass_vel(IM, Rh)
        up_, gp_ = eval_vec(Zp)
        Rh = Rh - 0.5 * eps[:, None] * gp_
        dh = np.where(np.isfinite(up_),
                      up_ + _mass_kinetic(Rh, IM) - h0,
                      np.inf)
        return dh

    eps = np.full(C, float(eps0))
    done = np.zeros(C, dtype=bool)
    dh = probe(eps)
    up = dh < log2
    for _ in range(max_doublings):
        eps = np.where(done, eps, eps * np.where(up, 2.0, 0.5))
        dh = probe(eps)
        newly_up = up & ~done & (dh >= log2)
        eps = np.where(newly_up, eps * 0.5, eps)
        newly_dn = ~up & ~done & (dh < log2)
        done = done | newly_up | newly_dn
        if done.all():
            break
    return eps


def _trajectory_eps_backoff(eval_vec, Z, us, grads, IM, rng, eps,
                            nleap, target=0.65, max_halvings=4):
    """Refine the 1-leapfrog reasonable eps against FULL-LENGTH
    trajectories: integrate nleap leapfrogs per lane and halve any
    lane's eps whose end-to-end acceptance falls below `target`.

    Why: the doubling search calibrates a SINGLE leapfrog (accept
    ~0.5-0.9 there), but leapfrog energy error compounds over an
    L-step trajectory — at 16k/budget-24 the measured result was
    accept ~0.4 after a 25-transition ADAM tail that could not close
    the gap (log-eps moves ~0.05/transition).  A handful of
    budget-length probes (each nleap batched launches) lands eps in
    the multi-step regime BEFORE warmup, so the ADAM only fine-tunes.
    Costs max_halvings x nleap launches worst-case; lanes already
    above target stop probing (their lanes ride along)."""
    C, dim = Z.shape

    def traj_dh(eps_vec):
        R = _mass_draw(rng, IM, C)
        h0 = us + _mass_kinetic(R, IM)
        Zn, Gn, Rn = Z.copy(), grads.copy(), R
        Un = us.copy()
        alive = np.ones(C, dtype=bool)
        for _ in range(int(nleap)):
            Rh = Rn - 0.5 * eps_vec[:, None] * Gn
            Zp = np.where(alive[:, None],
                          Zn + eps_vec[:, None] * _mass_vel(IM, Rh),
                          Zn)
            up_, gp_ = eval_vec(Zp)
            ok = alive & np.isfinite(up_)
            Rh = Rh - 0.5 * eps_vec[:, None] * gp_
            Zn = np.where(ok[:, None], Zp, Zn)
            Un = np.where(ok, up_, Un)
            Gn = np.where(ok[:, None], gp_, Gn)
            Rn = np.where(ok[:, None], Rh, Rn)
            alive = ok
            if not alive.any():
                break
        h1 = Un + _mass_kinetic(Rn, IM)
        return np.where(alive, h1 - h0, np.inf)

    for _ in range(max_halvings):
        dh = traj_dh(eps)
        acc = np.where(dh <= 0.0, 1.0,
                       np.exp(-np.minimum(np.maximum(dh, 0.0), 700.0)))
        low = acc < target
        if not low.any():
            break
        eps = np.where(low, eps * 0.5, eps)
    return eps


def _hmc_host_batched(vec_eval, z0, *, num_warmup, num_samples,
                      num_chains, target_accept, budget, eps0,
                      jitter_init, seed, max_delta_h, chees, callback,
                      on_draw, inv_mass0, adapt_mass, betas=None):
    """Lockstep-batched transitions: all chains share each
    transition's trajectory length (the ChEES-HMC convention) and ONE
    vmapped value+grad launch advances every chain a leapfrog.  At 16k
    this amortises the per-launch dispatch AND replaces C sequential
    1.4 s evals with one batched launch per leapfrog — the only
    multi-chain route on a platform where compiled transition programs
    fault (docs/TPU_NOTES.md round 3).  A lane that turns non-finite
    mid-trajectory freezes at its last finite state (divergence) while
    the other chains integrate on.  The Welford mass window is POOLED
    across chains (C x the draws per window — the serial sampler's
    correlated short window was the measured 16k accept collapse).

    betas: optional (C,) per-lane inverse temperatures — parallel
    tempering over the lockstep lanes.  A lane with beta < 1 samples
    the FLATTENED target exp(-beta*U) (same batched launch: the
    tempering is a host-side scale on U and grad), and after every
    transition adjacent temperature pairs propose a state swap with
    log-acceptance (beta_a - beta_b) * (U_a - U_b) — FREE, off the
    cached untempered U.  Pairing alternates even/odd ladder edges
    (deterministic-even-odd, the round-trip-optimal non-reversible
    schedule); with several cold lanes the ladder's junction cold lane
    rotates per transition so every cold chain drinks from the hot
    stream.  Only cold (beta == 1) lanes are recorded/returned.  This
    is the between-chain-exchange fix for the measured 16k failure
    mode (chains pinned in a ~5-nat-wide posterior basin, lp means
    spanning 51929.9-51935.2 across every mass-matrix configuration —
    docs/TPU_NOTES.md round 5): hot lanes cross the basin (at beta=0.25
    a 5-nat barrier is ~1 nat) and the swap ladder carries those
    crossings into the cold chains.  Mass/ChEES statistics pool COLD
    lanes only (hot-lane variance is inflated by design).
    """
    rng = np.random.default_rng(seed)
    z0 = np.asarray(z0, dtype=np.float64).reshape(-1)
    dim = z0.shape[0]
    C = num_chains
    apply_at = max(1, int(0.6 * num_warmup))

    if betas is None:
        betas = np.ones(C)
    else:
        betas = np.asarray(betas, dtype=np.float64).reshape(-1)
    cold = betas >= 1.0 - 1e-12
    cold_idx = np.flatnonzero(cold)
    n_cold = int(cold_idx.size)
    tempered = n_cold < C
    # hot lanes ordered by descending beta: ladder adjacency = maximal
    # tempered-density overlap between swap partners
    hot_idx = np.flatnonzero(~cold)
    hot_idx = hot_idx[np.argsort(-betas[hot_idx], kind="stable")]
    swap_try = np.zeros(max(hot_idx.size, 1))
    swap_acc = np.zeros(max(hot_idx.size, 1))

    def eval_vec(Z):
        us, gs = vec_eval(Z)
        return (np.asarray(us, dtype=np.float64),
                np.asarray(gs, dtype=np.float64))

    def eval_temp(Z):
        # tempered view for the eps searches (they treat the
        # objective as a black box: potential AND grad scaled)
        us, gs = eval_vec(Z)
        return betas * us, betas[:, None] * gs

    zs = np.empty((n_cold, num_samples, dim))
    lps = np.empty((n_cold, num_samples))
    divs = np.zeros((n_cold, num_samples), dtype=bool)
    accs = np.empty((n_cold, num_samples))
    depths = np.empty((n_cold, num_samples), dtype=np.int64)
    eps_out = np.empty((n_cold, num_samples))

    if isinstance(inv_mass0, DenseMass):
        IM = inv_mass0
    else:
        IM = np.broadcast_to(
            np.ones(dim) if inv_mass0 is None
            else np.asarray(inv_mass0, dtype=np.float64).reshape(-1),
            (C, dim)).copy()
    Z = z0[None, :] + rng.uniform(-jitter_init, jitter_init,
                                  size=(C, dim))
    U, G = eval_vec(Z)
    eps_init = (np.full(C, float(eps0)) if eps0 is not None
                else _find_reasonable_eps_batched(
                    eval_temp, Z, betas * U, betas[:, None] * G,
                    IM, rng))
    if eps0 is None and not adapt_mass:
        # fixed-mass production runs tune eps ONLY during warmup; the
        # 1-leapfrog search value must first be backed off into the
        # multi-step regime (full story in _trajectory_eps_backoff)
        eps_init = _trajectory_eps_backoff(
            eval_temp, Z, betas * U, betas[:, None] * G, IM, rng,
            eps_init, nleap=max(4, budget // 2),
            target=min(0.65, target_accept))
    adams = [_AdamEps(float(e)) for e in eps_init]
    # pooled Welford (all chains' positions feed one window)
    w_n, w_mean, w_m2 = 0, np.zeros(dim), np.zeros(dim)

    log_nmean = float(np.log(max(budget / 4.0, 2.0)))
    adm = adv = adc = 0.0
    zb_n, zb_mean = 0, np.zeros(dim)
    grace = 0
    grace_len = min(20, max(2, apply_at // 3))

    for t in range(num_warmup + num_samples):
        warm = t < num_warmup
        eps = np.asarray([a.eps for a in adams])
        if chees:
            u_draw = float(rng.uniform())
            ln_draw = min(log_nmean, np.log(budget / 2.0))
            ns = int(np.ceil(2.0 * np.exp(ln_draw)
                             * max(u_draw, 1e-12)))
            nleap = int(np.clip(ns, min(4, budget), budget))
        else:
            u_draw = 0.0
            nleap = int(rng.integers(1, budget + 1))
        R = _mass_draw(rng, IM, C)
        h0 = betas * U + _mass_kinetic(R, IM)
        Z_start = Z.copy()
        Zn, Un, Gn, Rn = Z.copy(), U.copy(), G.copy(), R.copy()
        alive = np.ones(C, dtype=bool)
        for _ in range(nleap):
            Rh = Rn - 0.5 * eps[:, None] * (betas[:, None] * Gn)
            Zp = np.where(alive[:, None],
                          Zn + eps[:, None] * _mass_vel(IM, Rh), Zn)
            up_, gp_ = eval_vec(Zp)
            ok = alive & np.isfinite(up_)
            Rh = Rh - 0.5 * eps[:, None] * (betas[:, None] * gp_)
            Zn = np.where(ok[:, None], Zp, Zn)
            Un = np.where(ok, up_, Un)
            Gn = np.where(ok[:, None], gp_, Gn)
            Rn = np.where(ok[:, None], Rh, Rn)
            alive = ok
            if not alive.any():
                break
        h1 = betas * Un + _mass_kinetic(Rn, IM)
        dh = np.where(alive, h1 - h0, np.inf)
        diverged = ~alive | ~np.isfinite(dh) | (dh > max_delta_h)
        # clip below at 0 too: np.where evaluates both branches, and
        # exp(-dh) of a very negative dh overflows (warning spew) even
        # though the <= 0 branch masks it
        accept_prob = np.where(dh <= 0.0, 1.0,
                               np.exp(-np.clip(dh, 0.0, 700.0)))
        accept_prob = np.where(np.isfinite(dh), accept_prob, 0.0)
        accepted = ~diverged & (rng.uniform(size=C) < accept_prob)
        Z = np.where(accepted[:, None], Zn, Z)
        U = np.where(accepted, Un, U)
        G = np.where(accepted[:, None], Gn, G)

        if tempered:
            # replica-exchange sweep: even/odd alternating ladder
            # edges (DEO); the junction cold lane rotates so every
            # cold chain receives swaps.  Exchanges (z, U, grad) —
            # beta and the per-lane eps adaptation stay with the SLOT
            # (a hot slot's eps is tuned for its flattened target).
            # The junction rotates on a HALF-SPEED clock: the
            # cold<->hot edge (ladder position 0) only fires on even
            # DEO sweeps, so a t%n_cold rotation with even n_cold
            # aliases — the junction would always be the same lane on
            # the sweeps that include edge 0 and the other cold lanes
            # would never swap (caught by the bimodal mixing test).
            jc = int(cold_idx[(t // 2) % n_cold])
            ladder = np.concatenate(([jc], hot_idx))
            for k in range(t % 2, ladder.size - 1, 2):
                a, b = int(ladder[k]), int(ladder[k + 1])
                la = (betas[a] - betas[b]) * (U[a] - U[b])
                swap_try[k] += 1
                if np.log(rng.uniform()) < la:
                    swap_acc[k] += 1
                    Z[[a, b]] = Z[[b, a]]
                    U[[a, b]] = U[[b, a]]
                    G[[a, b]] = G[[b, a]]

        if warm:
            for c in range(C):
                adams[c].update(float(accept_prob[c]), target_accept)
                if not cold[c]:
                    continue
                w_n += 1
                delta = Z[c] - w_mean
                w_mean = w_mean + delta / w_n
                w_m2 = w_m2 + delta * (Z[c] - w_mean)
                zb_n += 1
                zb_mean = zb_mean + (Z[c] - zb_mean) / zb_n
                if (chees and not diverged[c]
                        and t > grace + grace_len):
                    d1 = Zn[c] - zb_mean
                    d0 = Z_start[c] - zb_mean
                    v1 = _mass_vel(IM, Rn)[c]
                    dCdt = ((np.dot(d1, d1) - np.dot(d0, d0))
                            * np.dot(d1, v1))
                    g = (dCdt * u_draw * float(accept_prob[c])
                         * np.exp(log_nmean) * float(eps[c]))
                    if np.isfinite(g):
                        b1, b2, lr = 0.9, 0.999, 0.025
                        adc += 1.0
                        adm = b1 * adm + (1.0 - b1) * g
                        adv = b2 * adv + (1.0 - b2) * g * g
                        mhat = adm / (1.0 - b1 ** adc)
                        vhat = adv / (1.0 - b2 ** adc)
                        log_nmean = float(np.clip(
                            log_nmean
                            + lr * mhat / (np.sqrt(vhat) + 1e-10),
                            np.log(2.0), np.log(float(budget))))
            if adapt_mass and t + 1 == apply_at and w_n > 10:
                var = w_m2 / max(w_n - 1, 1)
                var = (w_n / (w_n + 5.0)) * var + 1e-3 * (
                    5.0 / (w_n + 5.0))
                IM = np.broadcast_to(var, (C, dim)).copy()
                w_n, w_mean, w_m2 = 0, np.zeros(dim), np.zeros(dim)
                eps_new = (np.full(C, float(eps0))
                           if eps0 is not None
                           else _find_reasonable_eps_batched(
                               eval_temp, Z, betas * U,
                               betas[:, None] * G, IM, rng))
                adams = [_AdamEps(float(e)) for e in eps_new]
                if num_warmup - apply_at >= 40:
                    log_nmean = float(np.log(max(budget / 4.0, 2.0)))
                adm = adv = adc = 0.0
                zb_n, zb_mean = 0, np.zeros(dim)
                grace = t
                grace_len = min(20, max(
                    2, (num_warmup - apply_at) // 3))
        else:
            i = t - num_warmup
            for ci, c in enumerate(cold_idx):
                zs[ci, i] = Z[c]
                lps[ci, i] = -U[c]
                divs[ci, i] = diverged[c]
                accs[ci, i] = accept_prob[c]
                depths[ci, i] = nleap
                eps_out[ci, i] = eps[c]
                if on_draw is not None:
                    on_draw(ci, i, Z[c], -U[c])
        if callback is not None:
            callback(-1, t, "warmup" if warm else "sample")

    out = {
        "z": zs,
        "lp": lps,
        "diverging": divs,
        "accept": accs,
        "depth": depths,
        "eps": eps_out,
    }
    if tempered:
        out["betas"] = betas
        out["swap_accept"] = swap_acc / np.maximum(swap_try, 1.0)
    return out


def hmc_host_sample(u_and_grad, z0, *, num_warmup=50, num_samples=50,
                    num_chains=1, target_accept=0.8, budget=16,
                    eps0=None, jitter_init=1.0, seed=0,
                    max_delta_h=1000.0, adapt_tlen=None, callback=None,
                    on_draw=None, inv_mass0=None, adapt_mass=True,
                    vec_eval=None, pilot=0, betas=None):
    """Jittered-trajectory HMC with a host-side integrator.

    u_and_grad: z -> (U, dU/dz) with U = -log posterior (unconstrained).
        Called once per leapfrog (nuts.sample_rvpack builds it from a
        torch objective by autograd, or takes its closed form).
    z0: (dim,) start; chains start at z0 + U(-jitter_init, jitter_init).
    budget: max leapfrogs per transition; lengths drawn U{1..budget}
    (uniform jitter) or ~U{1..2*nmean} under ChEES adaptation.
    eps0: initial step size; None (default) runs the reasonable-epsilon
    doubling search per chain (and again after the mass-matrix apply).
    adapt_tlen: ChEES-style warmup ascent on the mean trajectory length
    (the compiled flat sampler's measured 5-7x ESS/leapfrog lever —
    see nuts._run_chunk_flat for the derivation and the A/B matrix).
    The halting criterion is defined against the CROSS-chain mean, so
    chains advance in LOCKSTEP and pool a shared running mean; a single
    chain falls back to uniform jitter (a 1-chain self-mean is the
    measured runaway mode).  None (default) enables it only where the
    A/Bs measured a win: num_chains >= 2 AND num_warmup >= 100 AND
    budget >= 16 — short warmups cannot learn the length (the floor-4
    draws are then LESS diverse than uniform jitter and ESS drops:
    measured 5 vs 14 min-ESS at 50+100/budget-8 on a GP posterior,
    against 496 vs 226 at 200+400/budget-32).
    callback: optional f(chain, transition, phase) progress hook.
    on_draw: optional f(chain, draw_index, z, lp) called after each
    post-warmup draw is recorded — incremental persistence for long
    runs on a platform whose remote runtime can wedge mid-call
    (docs/TPU_NOTES.md; a blocked eval otherwise loses every draw,
    since results are only returned at the end).
    inv_mass0: (dim,) initial diagonal inverse mass (e.g.
    map_diag_inv_mass at a MAP start); adapt_mass=False keeps it for
    the whole run (no Welford apply, no mid-warmup eps re-search) —
    the right setting when the curvature mass is trusted and warmup is
    short.
    vec_eval: optional batched objective Zs (chains, dim) ->
    (Us (chains,), grads (chains, dim)) — e.g. the mixed objective's
    `vec_value_and_grad` (gp.bigfit.make_mixed_objective).  With >= 2
    chains the
    sampler then advances ALL chains in lockstep, one batched launch
    per leapfrog (shared per-transition trajectory length, the
    ChEES-HMC convention; per-chain step sizes; pooled Welford mass
    window).  The multi-chain route at 16k, where serial chains cost
    C x the launches.  The
    ChEES auto-gate then sees the true chain count (>= 2).

    pilot: > 0 runs a TWO-STAGE schedule — a pilot phase of
    pilot+pilot transitions under the default adaptation, then the
    requested warmup+samples with the mass FIXED to the pilot draws'
    empirical variances (draws_inv_mass) and chains re-started at the
    pilot's best-lp draw.  This automates the measured-best large-n
    recipe: at 16k the in-warmup Welford window is 0/3 measured
    configurations (correlated-window mass estimates collapse accept
    to 0.08-0.37, docs/TPU_NOTES.md round 4/5) while pilot-draw
    variances are the estimand itself.  Ignored when inv_mass0 is
    given.

    betas: optional (num_chains,) per-lane inverse temperatures —
    parallel tempering over the batched lanes (requires vec_eval and
    >= 2 lanes; see _hmc_host_batched).  Lanes with beta == 1 are the
    returned chains; beta < 1 lanes sample flattened targets and feed
    the cold chains through free host-side replica-exchange swaps —
    the between-chain mixing lever for wide flat posterior basins
    (the measured 16k regime).  The result dict then also carries
    'betas' and 'swap_accept' (per-ladder-edge swap rates).

    Returns the nuts_sample dict schema: z (chains, draws, dim), lp,
    diverging, accept, depth (actual leapfrog count per transition),
    eps — so MCMCData / sample_rvpack consume it unchanged.  Under
    tempering, 'chains' = the number of COLD lanes.
    """
    n_cold = num_chains
    if betas is not None:
        betas = np.asarray(betas, dtype=np.float64).reshape(-1)
        if vec_eval is None or num_chains < 2:
            raise ValueError(
                "betas (parallel tempering) requires the batched "
                "multi-chain route: vec_eval and num_chains >= 2")
        if betas.shape[0] != num_chains:
            raise ValueError(
                f"betas must have one entry per lane: got "
                f"{betas.shape[0]} for num_chains={num_chains}")
        if not ((betas > 0.0) & (betas <= 1.0)).all():
            raise ValueError("betas must lie in (0, 1]")
        n_cold = int((betas >= 1.0 - 1e-12).sum())
        if n_cold == 0:
            raise ValueError("betas needs >= 1 cold lane (beta == 1)")
    if pilot and inv_mass0 is None:
        pres = hmc_host_sample(
            u_and_grad, z0, num_warmup=int(pilot),
            num_samples=int(pilot), num_chains=num_chains,
            target_accept=target_accept, budget=budget, eps0=eps0,
            jitter_init=jitter_init, seed=seed,
            max_delta_h=max_delta_h, adapt_tlen=False,
            callback=callback, vec_eval=vec_eval, betas=betas)
        # DENSE pilot mass: the sample covariance also captures the
        # correlation directions a diagonal estimate cannot (the
        # measured 16k residual ~3.4x condition after diagonal
        # whitening, docs/TPU_NOTES.md round 5)
        inv_mass0 = draws_dense_mass(pres["z"])
        best = np.unravel_index(int(np.argmax(pres["lp"])),
                                pres["lp"].shape)
        z0 = pres["z"][best]
        adapt_mass = False
        # re-jitter at POSTERIOR scale: the default jitter_init=1.0 is
        # 30-90 posterior stds at 16k and would undo the bulk restart
        jitter_init = float(min(
            jitter_init,
            2.0 * np.sqrt(np.max(np.diag(inv_mass0.cov)))))
        seed = (int(seed) + 1000003) if np.isscalar(seed) else seed
    rng = np.random.default_rng(seed)
    z0 = np.asarray(z0, dtype=np.float64).reshape(-1)
    dim = z0.shape[0]
    apply_at = max(1, int(0.6 * num_warmup))
    if adapt_tlen and n_cold < 2:
        import warnings

        warnings.warn(
            "adapt_tlen requires >= 2 cold chains (the ChEES halting "
            "criterion is defined against the CROSS-chain mean of the "
            f"cold lanes; this run has {n_cold}); falling back to "
            "uniform trajectory jitter.", stacklevel=2)
    if adapt_tlen is None:
        chees = n_cold >= 2 and num_warmup >= 100 and budget >= 16
    else:
        chees = bool(adapt_tlen) and n_cold >= 2
    if vec_eval is not None and num_chains >= 2:
        return _hmc_host_batched(
            vec_eval, z0, num_warmup=num_warmup,
            num_samples=num_samples, num_chains=num_chains,
            target_accept=target_accept, budget=budget, eps0=eps0,
            jitter_init=jitter_init, seed=seed,
            max_delta_h=max_delta_h, chees=chees, callback=callback,
            on_draw=on_draw, inv_mass0=inv_mass0,
            adapt_mass=adapt_mass, betas=betas)

    def eval_ug(z):
        u, g = u_and_grad(z)
        return float(u), np.asarray(g, dtype=np.float64)

    zs = np.empty((num_chains, num_samples, dim))
    lps = np.empty((num_chains, num_samples))
    divs = np.zeros((num_chains, num_samples), dtype=bool)
    accs = np.empty((num_chains, num_samples))
    depths = np.empty((num_chains, num_samples), dtype=np.int64)
    eps_out = np.empty((num_chains, num_samples))

    if isinstance(inv_mass0, DenseMass):
        im0 = inv_mass0
    else:
        im0 = (np.ones(dim) if inv_mass0 is None
               else np.asarray(inv_mass0, dtype=np.float64).reshape(-1))
    chains = []
    for c in range(num_chains):
        z = z0 + rng.uniform(-jitter_init, jitter_init, size=dim)
        u, grad = eval_ug(z)
        adam = _AdamEps(
            eps0 if eps0 is not None else _find_reasonable_eps(
                eval_ug, z, u, grad, im0, rng))
        st = _ChainState(z, u, grad, adam, dim)
        st.inv_mass = im0 if isinstance(im0, DenseMass) else im0.copy()
        chains.append(st)

    # shared ChEES state: log mean trajectory length IN LEAPFROG STEPS
    # (the step-unit coordinate — eps motion cancels; nuts.py:616-630),
    # Adam moments, pooled cross-chain running mean, grace start.
    # Grace periods SCALE with the warmup (the compiled sampler's fixed
    # 20 assumes 300+-transition warmups; at the 16k scale tune is
    # 30-100 and a fixed 20 after the mass apply freezes adaptation for
    # the rest of warmup — measured: depths pinned at the 4-leapfrog
    # floor, min ESS 1.3/50 vs 6/100 for plain jitter)
    log_nmean = float(np.log(max(budget / 4.0, 2.0)))
    adm = adv = adc = 0.0
    zb_n, zb_mean = 0, np.zeros(dim)
    grace = 0
    grace_len = min(20, max(2, apply_at // 3))

    for t in range(num_warmup + num_samples):
        warm = t < num_warmup
        for c, st in enumerate(chains):
            eps = st.adam.eps
            if chees:
                u_draw = float(rng.uniform())
                ln_draw = min(log_nmean, np.log(budget / 2.0))
                ns = int(np.ceil(2.0 * np.exp(ln_draw) * max(u_draw,
                                                             1e-12)))
                nleap = int(np.clip(ns, min(4, budget), budget))
            else:
                u_draw = 0.0
                nleap = int(rng.integers(1, budget + 1))
            r = _mass_draw(rng, st.inv_mass)
            h0 = st.u + float(_mass_kinetic(r, st.inv_mass))
            z_start = st.z
            zn, un, gn, rn = st.z, st.u, st.grad, r
            diverged = False
            for _ in range(nleap):
                rn = rn - 0.5 * eps * gn
                zn = zn + eps * _mass_vel(st.inv_mass, rn)
                un, gn = eval_ug(zn)
                rn = rn - 0.5 * eps * gn
                if not np.isfinite(un):
                    diverged = True
                    break
            if diverged:
                accept_prob, accepted = 0.0, False
            else:
                h1 = un + float(_mass_kinetic(rn, st.inv_mass))
                dh = h1 - h0
                if not np.isfinite(dh):
                    diverged, accept_prob, accepted = True, 0.0, False
                else:
                    diverged = dh > max_delta_h
                    accept_prob = (1.0 if dh <= 0.0
                                   else float(np.exp(-min(dh, 700.0))))
                    accepted = (not diverged) and (
                        rng.uniform() < accept_prob)
            if accepted:
                st.z, st.u, st.grad = zn, un, gn

            if warm:
                st.adam.update(accept_prob, target_accept)
                st.w_n += 1
                delta = st.z - st.w_mean
                st.w_mean += delta / st.w_n
                st.w_m2 += delta * (st.z - st.w_mean)
                # pooled cross-chain running mean for ChEES
                zb_n += 1
                zb_mean = zb_mean + (st.z - zb_mean) / zb_n
                if chees and not diverged and t > grace + grace_len:
                    # halting derivative of the ChEES criterion at the
                    # PROPOSAL (accepted or not), nuts.py:644-649
                    d1 = zn - zb_mean
                    d0 = z_start - zb_mean
                    v1 = _mass_vel(st.inv_mass, rn)
                    dCdt = ((np.dot(d1, d1) - np.dot(d0, d0))
                            * np.dot(d1, v1))
                    g = (dCdt * u_draw * accept_prob
                         * np.exp(log_nmean) * eps)
                    if np.isfinite(g):
                        b1, b2, lr = 0.9, 0.999, 0.025
                        adc += 1.0
                        adm = b1 * adm + (1.0 - b1) * g
                        adv = b2 * adv + (1.0 - b2) * g * g
                        mhat = adm / (1.0 - b1 ** adc)
                        vhat = adv / (1.0 - b2 ** adc)
                        log_nmean = float(np.clip(
                            log_nmean
                            + lr * mhat / (np.sqrt(vhat) + 1e-10),
                            np.log(2.0), np.log(float(budget))))
                if adapt_mass and t + 1 == apply_at and st.w_n > 10:
                    var = st.w_m2 / max(st.w_n - 1, 1)
                    # regularised like PyMC's adapt_diag
                    var = (st.w_n / (st.w_n + 5.0)) * var + 1e-3 * (
                        5.0 / (st.w_n + 5.0))
                    st.inv_mass = var
                    # restart Welford + re-search eps for the new metric
                    st.w_n, st.w_mean, st.w_m2 = (
                        0, np.zeros(dim), np.zeros(dim))
                    st.adam = _AdamEps(
                        eps0 if eps0 is not None
                        else _find_reasonable_eps(
                            eval_ug, st.z, st.u, st.grad, st.inv_mass,
                            rng))
            else:
                i = t - num_warmup
                zs[c, i] = st.z
                lps[c, i] = -st.u
                divs[c, i] = diverged
                accs[c, i] = accept_prob
                depths[c, i] = nleap
                eps_out[c, i] = eps
                if on_draw is not None:
                    on_draw(c, i, st.z, -st.u)
            if callback is not None:
                callback(c, t, "warmup" if warm else "sample")
        if warm and adapt_mass and t + 1 == apply_at:
            # ChEES learned the OLD metric's optimum: fresh moments and
            # a grace period for the pooled mean to restabilise
            # (nuts.py:632-643).  The VALUE resets to half the
            # uniform-jitter mean only when enough warmup remains to
            # re-learn it; a short tail keeps the pre-apply value (a
            # metric-mistuned-but-learned length beats freezing at the
            # reset constant — the measured short-warmup failure mode)
            if num_warmup - apply_at >= 40:
                log_nmean = float(np.log(max(budget / 4.0, 2.0)))
            adm = adv = adc = 0.0
            zb_n, zb_mean = 0, np.zeros(dim)
            grace = t
            grace_len = min(20, max(2, (num_warmup - apply_at) // 3))

    return {
        "z": zs,
        "lp": lps,
        "diverging": divs,
        "accept": accs,
        "depth": depths,
        "eps": eps_out,
    }
