"""Latin-hypercube sampling with random-CD refinement (counterpart of
andvaranaut_tpu/sampling.py).

Points are drawn on the host from an explicit CPU `torch.Generator`
(seeded from `seed`, or from np.random when none is given), so a seed
gives the same design on every machine; the reference draws from a JAX
PRNG key, whose numbers differ.  The centred-L2-discrepancy refinement
is a host loop of O(n d) swap deltas.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dists


def cd2_discrepancy(x):
    """Centred L2 discrepancy (scipy.stats.qmc.discrepancy method='CD')."""
    x = torch.as_tensor(np.asarray(x, dtype=np.float64)) if not isinstance(
        x, torch.Tensor) else x.to(torch.float64)
    n, d = x.shape
    z = x - 0.5
    az = z.abs()
    g = 1.0 + 0.5 * az - 0.5 * z * z
    term2 = g.prod(1).sum()
    h = (1.0 + 0.5 * (az[:, None, :] + az[None, :, :])
         - 0.5 * (x[:, None, :] - x[None, :, :]).abs())
    term3 = h.prod(2).sum()
    return (13.0 / 12.0) ** d - (2.0 / n) * term2 + (1.0 / n ** 2) * term3


def _stratified(gen, n: int, d: int):
    """Classic LHC: per column, one uniform point in each of n strata,
    randomly permuted."""
    perms = torch.stack([torch.randperm(n, generator=gen) for _ in range(d)],
                        dim=1)
    u = torch.rand((n, d), generator=gen, dtype=torch.float64)
    return (perms.to(torch.float64) + u) / n


def _swap_deltas(x, r1, r2, c):
    """Changes in CD2 from swapping rows r1[b] and r2[b] in column c[b],
    each against the same x, for a batch of candidate swaps (int64
    tensors of shape (B,)); O(B n d).

    Only x[r1, c] and x[r2, c] change.  The pair term H[r1, r2] and every
    H entry without r1 or r2 are invariant, so the delta reduces to rows
    r1 and r2 against all other rows, their diagonal entries H[r1, r1] =
    prod_k (1 + |z_r1k|) and H[r2, r2], and the row-product (term2)
    updates.  The reference (andvaranaut_tpu/sampling.py:53-100) takes
    the diagonal entries to swap with no net change, which holds only
    for d = 1; here they are counted, so the delta is the exact change
    of `cd2_discrepancy`."""
    n, d = x.shape
    z = x - 0.5
    az = z.abs()
    g = 1.0 + 0.5 * az - 0.5 * z * z
    a1, a2 = x[r1, c], x[r2, c]
    za1, za2 = (a1 - 0.5).abs(), (a2 - 0.5).abs()
    g1_old, g1_new = g[r1, c], 1.0 + 0.5 * za2 - 0.5 * (a2 - 0.5) ** 2
    g2_old, g2_new = g[r2, c], 1.0 + 0.5 * za1 - 0.5 * (a1 - 0.5) ** 2
    p = g.prod(1)
    d_term2 = p[r1] * (g1_new / g1_old - 1.0) + p[r2] * (g2_new / g2_old - 1.0)

    xc = x[:, c].T
    azc = az[:, c].T
    h_r1 = (1.0 + 0.5 * (az[r1][:, None, :] + az[None])
            - 0.5 * (x[r1][:, None, :] - x[None]).abs()).prod(2)
    h_r2 = (1.0 + 0.5 * (az[r2][:, None, :] + az[None])
            - 0.5 * (x[r2][:, None, :] - x[None]).abs()).prod(2)
    za1, za2, a1, a2 = za1[:, None], za2[:, None], a1[:, None], a2[:, None]
    hc_r1_old = 1.0 + 0.5 * (za1 + azc) - 0.5 * (a1 - xc).abs()
    hc_r1_new = 1.0 + 0.5 * (za2 + azc) - 0.5 * (a2 - xc).abs()
    hc_r2_old = 1.0 + 0.5 * (za2 + azc) - 0.5 * (a2 - xc).abs()
    hc_r2_new = 1.0 + 0.5 * (za1 + azc) - 0.5 * (a1 - xc).abs()
    dh1 = h_r1 * (hc_r1_new / hc_r1_old - 1.0)
    dh2 = h_r2 * (hc_r2_new / hc_r2_old - 1.0)
    # exclude j in {r1, r2}: the pair entry is invariant, diagonals swap
    idx = torch.arange(n)
    mask = (idx[None, :] != r1[:, None]) & (idx[None, :] != r2[:, None])
    d_term3 = 2.0 * torch.where(mask, dh1 + dh2, 0.0).sum(1)
    hd = (1.0 + az).prod(1)
    za1, za2 = za1[:, 0], za2[:, 0]
    d_term3 = d_term3 + (hd[r1] * ((1.0 + za2) / (1.0 + za1) - 1.0)
                         + hd[r2] * ((1.0 + za1) / (1.0 + za2) - 1.0))
    return -(2.0 / n) * d_term2 + (1.0 / n ** 2) * d_term3


def _swap_delta(x, r1: int, r2: int, c: int):
    """Change in CD2 from swapping rows r1 and r2 in column c."""
    t = [torch.tensor([v]) for v in (r1, r2, c)]
    return _swap_deltas(x, *t)[0]


def latin_hypercube(gen, nsamps: int, nx: int, iters: int = 0):
    """(nsamps, nx) unit-cube LHC points from the CPU generator `gen`,
    refined by `iters` random-CD swaps, each kept when it lowers the
    discrepancy.  The candidates are drawn up front and their deltas
    evaluated in batches against the current points: the candidates
    before a batch's first improving one would have been rejected one by
    one, so after each accepted swap the next batch starts right behind
    it, which is the sequential loop's outcome."""
    x = _stratified(gen, nsamps, nx)
    if iters <= 0 or nsamps < 2:
        return x
    c = torch.randint(0, nx, (iters,), generator=gen)
    r1 = torch.randint(0, nsamps, (iters,), generator=gen)
    r2 = torch.randint(0, nsamps - 1, (iters,), generator=gen)
    r2 = r2 + (r2 >= r1).to(r2.dtype)
    i, batch = 0, 8
    while i < iters:
        e = min(i + batch, iters)
        neg = torch.nonzero(_swap_deltas(x, r1[i:e], r2[i:e], c[i:e]) < 0.0)
        if len(neg) == 0:
            i = e
            batch = min(2 * batch, 256)
            continue
        j = i + int(neg[0, 0])
        a, b, cc = int(r1[j]), int(r2[j]), int(c[j])
        x[a, cc], x[b, cc] = x[b, cc].clone(), x[a, cc].clone()
        i = j + 1
        batch = max(batch // 2, 8)
    return x


def default_cd_iters(nsamps: int, nx: int) -> int:
    """Swap budget: enough for experiment-design-sized draws, none for
    the large candidate draws of BO."""
    if nsamps > 2048:
        return 0
    return min(10_000, 10 * nsamps * nx)


def lhc_sample(priors, nsamps: int, seed=None,
               optimization: str = "random-cd", iters: int | None = None):
    """nsamps LHC samples mapped through each prior's ppf per column, as
    an (nsamps, nx) numpy array."""
    priors = [dists.from_prior(p) for p in priors]
    nx = len(priors)
    if seed is None:
        seed = int(np.random.randint(0, 2**31 - 1))
    gen = torch.Generator().manual_seed(int(seed))
    if optimization is None:
        n_iters = 0
    elif optimization == "random-cd":
        n_iters = default_cd_iters(nsamps, nx) if iters is None else iters
    else:
        raise ValueError("optimization must be None or 'random-cd'")
    pts = latin_hypercube(gen, nsamps, nx, n_iters)
    # strictly inside (0, 1) so unbounded priors stay finite
    pts = torch.clamp(pts, np.finfo(np.float64).tiny, 1.0 - 1e-16)
    return np.stack([np.asarray(priors[j].ppf(pts[:, j]))
                     for j in range(nx)], axis=1)
