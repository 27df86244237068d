"""Wall-clock sections (counterpart of the stopwatch of
andvaranaut_tpu/timing.py).

`stopwatch` keeps the reference's "Time taken" print and records every
timed section in a process-level registry that `timings()` returns.
"""

from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager
from time import perf_counter

__all__ = ["stopwatch", "record", "timings"]

_REGISTRY: dict = defaultdict(list)


@contextmanager
def stopwatch(name: str, verbose: bool = False):
    """Time a section into the registry; verbose=True also prints the
    reference's "Time taken: X s" line."""
    t0 = perf_counter()
    try:
        yield
    finally:
        dt = perf_counter() - t0
        _REGISTRY[name].append(dt)
        if verbose:
            print(f"Time taken: {dt:0.2f} s")


def record(name: str, dt: float) -> None:
    """Record an externally measured duration."""
    _REGISTRY[name].append(dt)


def timings() -> dict:
    """All recorded durations: {section: (seconds, ...)}."""
    return {k: tuple(v) for k, v in _REGISTRY.items()}
