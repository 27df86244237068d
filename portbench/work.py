"""Implementation-independent work of the program's calls, and the
least time the card could take for it (the yardstick of the roofline and
mfu metrics).  The counts are of the function, not of any one way to
compute it, so they read the same whatever later computes it.

The GP value and gradient at n points in d inputs (`vg_work`):
- the Cholesky factor of K: n^3 / 3 flop;
- the triangular inverse L^-1: n^3 / 3;
- the product K^-1 = L^-T L^-1: n^3 / 3;
- the solves for a = K^-1 y: 2 n^2 (forward and back substitution);
- the Gram over its n (n + 1) / 2 distinct entries: 3 d flop for the
  scaled squared distance and GRAM_KERNEL_FLOP for the kernel;
- the gradient's d + 2 contractions against W = (a a' - K^-1) / 2 over
  the same entries: 2 flop for W, and 2 for each derivative entry and its
  product with W.

Bytes: the inputs read once (X, y, z) and the outputs written once (the
value and the gradient), 8 bytes each.

The bound is the larger of the work over the card's highest dense
multiply rate (int8, 1979e12 op/s: no implementation of f64-accurate
work beats it, and emulation does beat the f64 peak) and the bytes over
its memory bandwidth.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
#: flop of one kernel evaluation from r2 (exp and a few products)
GRAM_KERNEL_FLOP = 8


def vg_work(n: int, d: int):
    """(flop, bytes) of one value and gradient."""
    entries = n * (n + 1) / 2
    flop = (n ** 3 + 2 * n * n + entries * (3 * d + GRAM_KERNEL_FLOP)
            + entries * (2 + 4 * (d + 2)))
    nbytes = 8 * (n * d + n + (d + 2)) + 8 * (1 + d + 2)
    return flop, nbytes


def bound_s(flop: float, nbytes: float, peaks=PEAKS):
    """(seconds, which bound sets it): the least time on the card."""
    t_ops = flop / peaks["int8_ops_per_s"]
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    return (t_ops, "compute") if t_ops >= t_bytes else (t_bytes, "bytes")
