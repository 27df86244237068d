"""Wall-clock sections and device traces (counterpart of
andvaranaut_tpu/timing.py).

`stopwatch` keeps the reference's "Time taken" print and records every
timed section in a process-level registry that `timings()` returns and
`summary()` formats; `device_profile` writes a `torch.profiler` Chrome
trace of a block.
"""

from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager
from time import perf_counter

__all__ = [
    "stopwatch", "record", "timings", "reset_timings", "summary",
    "device_profile",
]

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


def reset_timings() -> None:
    _REGISTRY.clear()


def summary() -> str:
    """One line per section: calls, total, mean."""
    lines = []
    for k in sorted(_REGISTRY):
        v = _REGISTRY[k]
        tot = sum(v)
        lines.append(
            f"{k}: n={len(v)} total={tot:0.3f}s mean={tot / len(v):0.3f}s")
    return "\n".join(lines)


@contextmanager
def device_profile(logdir: str):
    """`torch.profiler` trace around a block, written as a Chrome trace
    (`trace.json`, viewable in Perfetto) into logdir: the host's activity,
    and the CUDA card's where there is one.  Unlike the reference, which
    swallows profiler errors because a JAX backend may have no profiler,
    errors propagate: torch.profiler is always there."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
