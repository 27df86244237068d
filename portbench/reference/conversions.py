"""The configurations' conversions, written out from their files: the
inputs' uniform map onto the unit interval and the outputs'
standardisation, both affine (y_c = a + b y)."""

from __future__ import annotations

import numpy as np


def uniform_inputs(x, priors, safety):
    """Each uniform input onto [safety, 1 - safety]: x_c = a + b x."""
    cols = []
    for i, (_, lo, hi) in enumerate(priors):
        xminus = (hi - lo) / (1.0 - 2.0 * safety)
        cols.append(-lo / xminus + safety + x[:, i] / xminus)
    return np.column_stack(cols)


def meanstd(y):
    """(a, b) of y_c = a + b y with mean 0 and population sd 1."""
    mean, sd = float(np.mean(y)), float(np.std(y))
    return -mean / sd, 1.0 / sd
