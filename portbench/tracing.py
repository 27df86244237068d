"""The traced stretch of a `--trace 1` run: `torch.profiler` over a few
calls of the window, the program's launch counters read around it, and
the reduction of its events to what the per-layer metrics read.

The stretch is kept short (the traffic mix's `trace_calls`): on this
card the profiler has been seen to drop device events after long
stretches, so its kernel events are held to the launch counters, and a
stretch where they disagree gives no per-layer metric.

Times are the profiler's own (microseconds on one timeline for host
spans and device events).  The window is the first call span's start to
the last one's end; the device is busy where any device event (kernel,
copy, fill) runs, overlaps counted once.
"""

from __future__ import annotations

import re
from collections import defaultdict

import numpy as np

#: name of the benchmark's host span around each call
SPAN = "portbench.call"
#: idle gaps shorter than this are summed under one label, not looked up
SHORT_GAP_US = 20.0


def _kernel_pattern(name: str):
    return re.compile(rf"(?<![A-Za-z0-9_]){re.escape(name)}(?![A-Za-z0-9_])")


def warm_profiler(device: str) -> None:
    """One throwaway profile in set-up, so that the profiler's own start
    (CUPTI on the card) is not paid inside the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        t = torch.ones(8, device=device)
        (t * 2).sum().item()


def union_length(intervals) -> float:
    """Total length covered by [(start, end)], overlaps counted once."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, w0: float, w1: float):
    """The stretches of [w0, w1] that no interval covers."""
    out = []
    at = w0
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, w1)))
        at = max(at, e)
        if at >= w1:
            break
    if at < w1:
        out.append((at, w1))
    return [(s, e) for s, e in out if e > s]


def summarise_events(spans, device_events, host_events, table):
    """The stretch's numbers from plain event lists (microseconds):
    spans [(start, end)] of the calls, device_events [(start, end, name)],
    host_events [(start, end, name)] (the host's operations, for the idle
    gaps).  Returns a dict in seconds."""
    spans = sorted(spans)
    w0, w1 = spans[0][0], spans[-1][1]
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in device_events
           if e > w0 and s < w1]
    busy = union_length([(s, e) for s, e, _ in dev])
    pats = {k: _kernel_pattern(k) for k in table["kernels"]}
    counts = defaultdict(int)
    port_us = defaultdict(float)
    other_us = 0.0
    by_name = defaultdict(float)
    for s, e, n in dev:
        by_name[n] += e - s
        for k, p in pats.items():
            if p.search(n):
                counts[k] += 1
                port_us[k] += e - s
                break
        else:
            other_us += e - s
    per_span = [union_length([(max(s, a), min(e, b)) for s, e, _ in dev
                              if e > a and s < b]) for a, b in spans]
    host_by = defaultdict(float)
    hs = np.array([s for s, _, _ in host_events] or [0.0])
    he = np.array([e for _, e, _ in host_events] or [-1.0])
    for g0, g1 in gaps([(s, e) for s, e, _ in dev], w0, w1):
        if g1 - g0 < SHORT_GAP_US:
            host_by[f"gaps under {SHORT_GAP_US:g} us between device ops"] += (
                g1 - g0)
            continue
        mid = 0.5 * (g0 + g1)
        inside = np.flatnonzero((hs <= mid) & (he >= mid))
        if inside.size:
            label = host_events[inside[np.argmin((he - hs)[inside])]][2]
        else:
            label = "host, outside any operation"
        host_by[label] += g1 - g0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(host_by.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6,
        "calls": len(spans),
        "span_s": [(b - a) * 1e-6 for a, b in spans],
        "span_busy_s": [u * 1e-6 for u in per_span],
        "kernel_counts": dict(counts),
        "port_s": {k: v * 1e-6 for k, v in port_us.items()},
        "other_s": other_us * 1e-6,
        "breakdown": {
            "device_ops": [[n[:160], v * 1e-6] for n, v in top],
            "idle_gaps": [[n[:160], v * 1e-6] for n, v in idle]},
    }


def kernel_mismatch(counts: dict, deltas: dict, table: dict):
    """Lines naming each of the program's kernels whose events in the
    trace differ from what the launch counters' deltas predict (an
    `at_most` kernel may launch fewer times than its counters say)."""
    bad = []
    for k, spec in table["kernels"].items():
        want = sum(deltas.get(c, 0) for c in spec["counters"])
        got = counts.get(k, 0)
        ok = got <= want if spec.get("at_most") else got == want
        if not ok:
            bad.append(f"{k}: {got} events in the trace, counters "
                       f"{'+'.join(spec['counters'])} predict "
                       f"{'at most ' if spec.get('at_most') else ''}{want}")
    return bad


class Stretch:
    """A context manager around the traced calls: the launch counters at
    its start and end, and the profiler between them."""

    def __init__(self, device: str, table: dict):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device != "cpu":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.table = table
        self.deltas = None

    def __enter__(self):
        from .harness import read_counters

        self.c0 = read_counters(self.table)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        from .harness import read_counters

        self.prof.__exit__(*exc)
        c1 = read_counters(self.table)
        self.deltas = {k: c1[k] - self.c0[k] for k in c1}
        return False

    def summary(self):
        from torch.autograd import DeviceType

        spans, dev, host = [], [], []
        for ev in self.prof.events():
            tr = ev.time_range
            if ev.name == SPAN:
                # the span is also annotated on the device's timeline;
                # only the host's one counts
                if ev.device_type != DeviceType.CUDA:
                    spans.append((tr.start, tr.end))
            elif ev.device_type == DeviceType.CUDA:
                dev.append((tr.start, tr.end, ev.name))
            else:
                host.append((tr.start, tr.end, ev.name))
        out = summarise_events(spans, dev, host, self.table)
        out["deltas"] = self.deltas
        self.counts = out["kernel_counts"]
        return out

    def kernel_mismatch(self):
        return kernel_mismatch(self.counts, self.deltas, self.table)
