"""The benchmark's general part: it finds a cell's configuration, traffic
mix, caller, limits and metric readers by name, runs set-up, the
measured window and the check against the plain reference, and builds
the result line.

Everything that belongs to one configuration, one traffic mix or one
metric sits in files of its own:

    configs/<config>.json      sizes, priors, hyperparameters, route
    traffic/<traffic>.json     the mix: its caller and parameters
    callers/<caller>.py        the call into the program under test
    limits/<cell>.json         the limits of the check that decides correct
    metrics/<metric>.py        read(ctx) -> number, or None where the run
                               has nothing to read

The window is a closed loop with one caller: a call is issued whenever
the previous one has returned, as long as the window is open; every call
issued in it runs to its end and is counted.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "andvaranaut_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from its file (metric readers: their names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def process_start_wall() -> float:
    """Wall-clock time at which this process started (from /proc), or,
    where that cannot be read, the time this module was first imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        ticks = os.sysconf("SC_CLK_TCK")
        return time.time() - (uptime - int(fields[19]) / ticks)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


class Cell:
    """One entry of `workloads` with everything found by its names."""

    def __init__(self, name: str, bench: dict | None = None,
                 overrides: dict | None = None):
        bench = bench or load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; known: "
                             f"{sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.config = load_json(HERE / "configs" / f"{self.entry['config']}.json")
        self.traffic = load_json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(HERE / "limits" / f"{name}.json")
        for key, val in (overrides or {}).items():
            part, _, k = key.partition(".")
            getattr(self, part)[k] = val
        self.caller = importlib.import_module(
            f"portbench.callers.{self.traffic['caller']}")
        self.bench = bench

    def metrics(self, trace: bool):
        """The metric entries this cell reports in this mode."""
        group = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[group]
                if self.name in m.get("workloads", [self.name])]


def read_counters(table: dict) -> dict:
    """{label: launches} of the program's kernel wrappers listed in
    `port_kernels.json` (modules already imported by the caller)."""
    out = {}
    for label, spec in table["counters"].items():
        mod = sys.modules.get(spec["module"])
        fn = getattr(mod, spec["function"], None) if mod else None
        out[label] = int(getattr(fn, "launches", 0)) if fn else 0
    return out


def forbidden_loaded() -> list:
    tops = {m.partition(".")[0] for m in list(sys.modules)}
    return sorted(t for t in FORBIDDEN if t in tops)


def run_window(caller, seconds: float, trace_plan=None, profiler=None):
    """The closed loop.  Returns (records, t0, t_end, prof): records
    [(index, start, end, ok, units)] in perf_counter seconds; with
    trace_plan = (first, count) the calls first .. first + count - 1 run
    under the profiler `prof = profiler()`, the window held open until
    they have run."""
    records = []
    t0 = time.perf_counter()
    i = 0
    prof = None
    traced = None
    stop_at = 0 if trace_plan is None else trace_plan[0] + trace_plan[1]
    while time.perf_counter() - t0 < seconds or i < stop_at:
        if trace_plan is not None and i == trace_plan[0]:
            prof = profiler()
            prof.__enter__()
        payload = caller.prepare(i)
        start = time.perf_counter()
        ok = False
        out = None
        try:
            with _span(prof if traced is None else None):
                out = caller.call(payload)
            ok = caller.ok(out)
        except Exception:  # noqa: BLE001 — a failed call is counted and
            # the loop goes on; its traceback goes to standard error
            traceback.print_exc()
        end = time.perf_counter()
        caller.keep(i, payload, out, ok)
        records.append((i, start, end, ok, caller.units(payload)))
        if prof is not None and i == trace_plan[0] + trace_plan[1] - 1:
            prof.__exit__(None, None, None)
            traced = (trace_plan[0], i)
        i += 1
    return records, t0, records[-1][2], prof


class _span:
    """A profiler span around one call (nothing without a profiler)."""

    def __init__(self, prof):
        self.rf = None
        if prof is not None:
            from torch.profiler import record_function

            self.rf = record_function("portbench.call")

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def check(caller, limits: dict) -> dict:
    """{number: {value, limit}}: the caller's sample of the window's calls
    against the float64 reference (no sample reads as infinitely wrong)."""
    picked = caller.sample()
    got = {}
    if picked:
        refs = [caller.reference(p) for p, _ in picked]
        got = caller.compare([o for _, o in picked], refs)
    return {k: {"value": got.get(k, float("inf")), "limit": v}
            for k, v in limits.items()}


def result_line(cell, seed, seconds, trace, device="cuda", chips=1,
                overrides=None, log=sys.stderr):
    """Runs one cell once and returns (exit code, result dict or None)."""
    import torch

    t_proc = process_start_wall()
    print(f"setup: process start to harness {time.time() - t_proc:.3f} s",
          file=log)
    cell = Cell(cell, overrides=overrides)
    table = load_json(HERE / "port_kernels.json")
    caller = cell.caller.Caller(cell.config, cell.traffic, seed, device, log)
    trace_plan = None
    profiler = None
    if trace:
        from . import tracing as tr

        trace_plan = (cell.traffic["trace_skip"], cell.traffic["trace_calls"])
        profiler = functools.partial(tr.Stretch, device, table)
        tr.warm_profiler(device)
    if device != "cpu":
        torch.cuda.synchronize()
    counters0 = read_counters(table)
    setup_s = time.time() - t_proc
    records, t0, t_end, prof = run_window(
        caller, seconds, trace_plan, profiler)
    counters1 = read_counters(table)
    peak = (torch.cuda.max_memory_allocated() if device != "cpu" else 0)
    ctx = {"cell": cell, "records": records, "t0": t0, "t_end": t_end,
           "setup_s": setup_s, "counters": {
               k: counters1[k] - counters0[k] for k in counters1},
           "table": table, "caller": caller, "device": device}
    summary = None
    if trace:
        summary = prof.summary()
        ctx["trace"] = summary
        per_call = {k: v / summary["calls"] for k, v in
                     summary["deltas"].items() if v}
        print(f"traced stretch: launches per call {per_call}", file=log)
        bad = prof.kernel_mismatch()
        if bad:
            print("refused: the profiler's kernel events disagree with the "
                  "launch counters over the traced stretch:", file=log)
            for line in bad:
                print("  " + line, file=log)
            return 4, None
    metrics = {}
    for m in cell.metrics(trace):
        mod = load_module(HERE / "metrics" / f"{m['name']}.py",
                          "pb_metric_" + m["name"].replace(".", "_"))
        val = mod.read(ctx)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    caller.release()
    if device != "cpu":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = check(caller, cell.limits["limits"])
    n_failed = sum(1 for r in records if not r[3])
    correct = n_failed == 0 and all(c["value"] <= c["limit"]
                                    for c in checks.values())
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(records),
           "failed": n_failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = summary["breakdown"]
    out["checks"] = checks
    found = forbidden_loaded()
    if found:
        print(f"refused: the run loaded {found}", file=log)
        return 3, None
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=log)
    return 0, out
