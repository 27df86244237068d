"""Arithmetic shared by the metric readers in `metrics/`.  Each reader
takes the run's context: `records` [(index, start, end, ok, units)] of
the window's calls (perf_counter seconds), `t0` and `t_end` (the window's
start and the end of its last call), `setup_s`, `counters` (the launch
counters' change over the window), `table` (`port_kernels.json`), and
with `--trace 1` `trace` (`tracing.summarise_events` of the traced
stretch).  A reader with nothing to read returns None."""

from __future__ import annotations

import numpy as np


def window_s(ctx) -> float:
    return ctx["t_end"] - ctx["t0"]


def completed(ctx):
    return [r for r in ctx["records"] if r[3]]


def time_per_call(ctx):
    """The window's wall time over the calls completed in it (seconds)."""
    done = completed(ctx)
    return window_s(ctx) / len(done) if done else None


def time_per_unit(ctx):
    """The window's wall time over the units (points) completed in it."""
    units = sum(r[4] for r in completed(ctx))
    return window_s(ctx) / units if units else None


def latency_quantile(ctx, q: float):
    """The q-th percentile (linear between order statistics) of every
    call's latency in the window, failed ones included (seconds)."""
    lat = [r[2] - r[1] for r in ctx["records"]]
    return float(np.percentile(lat, q)) if lat else None


def traced(ctx):
    """The traced stretch's summary where the device ran something."""
    tr = ctx.get("trace")
    return tr if tr and tr["busy_s"] > 0 else None


def idle_share(ctx):
    tr = traced(ctx)
    return None if tr is None else 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def launches_per_call(ctx):
    done = len(ctx["records"])
    if not done or ctx["device"] == "cpu":
        return None
    return sum(ctx["counters"][k] for k in ctx["table"]["launch_counters"]) / done
