"""Latin-hypercube workflow helpers of the port (so far only the identity
conversion that the fit configurations use; counterpart of
andvaranaut_tpu/lhc.py)."""

from __future__ import annotations

import numpy as np


class _none_conrev:
    """Identity conversion used for None conrev slots (reference
    lhc.py:276-280); `der` provided so inverse problems work without an
    explicit output warping."""

    def con(self, x):
        return x

    def rev(self, x):
        return x

    def der(self, x):
        return np.ones_like(np.asarray(x, dtype=float))
