"""Differential evolution, best/1/bin with dithered mutation (counterpart
of andvaranaut_tpu/inference/de.py).

The reference runs the whole population loop in one compiled while loop.
Here it is a host loop: each generation draws its random numbers from an
explicit `torch.Generator` on the population's device, evaluates the
batched objective once on the whole trial population, and reads one
value back to the host, the convergence test.
"""

from __future__ import annotations

import torch


def differential_evolution(fn, lo, hi, gen, popsize: int = 0,
                           maxiter: int = 200, tol: float = 0.01,
                           recombination: float = 0.7):
    """Minimise fn over the box [lo, hi].

    fn: batched objective, (m, d) tensor -> (m,) tensor.
    lo, hi: (d,) float64 tensors on the device where the population
    lives; gen: a torch.Generator on that device.
    Returns (x_best (d,), f_best 0-d, n_gens)."""
    dev, dt = lo.device, lo.dtype
    d = lo.shape[0]
    npop = popsize if popsize > 0 else 15 * d

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=dt)

    def randint(high, *shape):
        return torch.randint(high, shape, generator=gen, device=dev)

    pop = lo + (hi - lo) * uniform(npop, d)
    f = fn(pop)
    idx = torch.arange(npop, device=dev)
    cols = torch.arange(d, device=dev)
    it = 0
    while it < maxiter:
        if bool(f.std(correction=0) <= tol * f.mean().abs() + 1e-12):
            break
        F = 0.5 + 0.5 * uniform()
        best = pop[torch.argmin(f)]
        r1 = randint(npop - 1, npop)
        r1 = torch.where(r1 >= idx, r1 + 1, r1)
        r2 = randint(npop - 1, npop)
        r2 = torch.where(r2 >= idx, r2 + 1, r2)
        mutant = best[None, :] + F * (pop[r1] - pop[r2])
        cross = uniform(npop, d) < recombination
        # at least one crossed dimension per member
        jrand = randint(d, npop)
        cross = cross | (cols[None, :] == jrand[:, None])
        trial = torch.where(cross, mutant, pop)
        trial = torch.minimum(torch.maximum(trial, lo), hi)
        ft = fn(trial)
        better = ft < f
        pop = torch.where(better[:, None], trial, pop)
        f = torch.where(better, ft, f)
        it += 1
    b = torch.argmin(f)
    return pop[b], f[b], it
