"""The harness's arithmetic on synthetic records and a synthetic trace,
its refusals, and BENCHMARK.json against the benchmark's files."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import harness, readers, tracing, work

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"


def _ctx(records, t0, t_end, **kw):
    return dict(records=records, t0=t0, t_end=t_end, **kw)


def test_rate_is_all_work_over_all_time():
    # three calls of 0.1, 0.3 and 0.2 s with client gaps between them
    recs = [(0, 0.00, 0.10, True, 100), (1, 0.12, 0.42, True, 300),
            (2, 0.45, 0.65, True, 100)]
    ctx = _ctx(recs, 0.0, 0.65)
    assert readers.time_per_call(ctx) == pytest.approx(0.65 / 3)
    assert readers.time_per_unit(ctx) == pytest.approx(0.65 / 500)


def test_failed_calls_do_not_count_as_completed_work():
    recs = [(0, 0.0, 0.1, True, 10), (1, 0.1, 0.5, False, 10)]
    ctx = _ctx(recs, 0.0, 0.5)
    assert readers.time_per_call(ctx) == pytest.approx(0.5)
    assert readers.time_per_unit(ctx) == pytest.approx(0.05)


def test_p95_is_over_every_request():
    lat = np.arange(1, 201) * 1e-3          # 1 .. 200 ms
    recs, t = [], 0.0
    for i, x in enumerate(lat):
        recs.append((i, t, t + x, i % 50 != 0, 1))   # some failed
        t += x
    ctx = _ctx(recs, 0.0, t)
    assert readers.latency_quantile(ctx, 95) == pytest.approx(
        np.percentile(lat, 95))


def test_trace_summary_idle_share_and_kernel_counts():
    table = harness.load_json(HERE / "port_kernels.json")
    spans = [(0.0, 1000.0), (1000.0, 2000.0)]
    dev = [(100.0, 300.0, "void (anonymous namespace)::slice_strip_kernel<6,"
            " F64Rows>(int)"),
           (250.0, 400.0, "sm90_xmma_gemm_f64"),            # overlaps: once
           (1200.0, 1700.0, "(anonymous namespace)::syrk_tn_wgmma_kernel()"),
           (1900.0, 2100.0, "Memcpy DtoH (Device -> Pageable)")]  # clipped
    host = [(400.0, 1200.0, "aten::mul"), (0.0, 2000.0, "python")]
    s = tracing.summarise_events(spans, dev, host, table)
    assert s["window_s"] == pytest.approx(2000e-6)
    assert s["busy_s"] == pytest.approx((300 + 500 + 100) * 1e-6)
    assert s["kernel_counts"] == {"slice_strip_kernel": 1,
                                  "syrk_tn_wgmma_kernel": 1}
    assert s["port_s"]["slice_strip_kernel"] == pytest.approx(200e-6)
    assert s["other_s"] == pytest.approx(250e-6)
    assert s["span_busy_s"] == pytest.approx([300e-6, 600e-6])
    ctx = {"trace": s}
    assert readers.idle_share(ctx) == pytest.approx(100 * (1 - 900 / 2000))
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps["aten::mul"] == pytest.approx(800e-6)
    assert gaps["python"] == pytest.approx(300e-6)   # 1700 .. 1900 and 0 .. 100


def test_kernel_events_held_to_the_counters():
    table = harness.load_json(HERE / "port_kernels.json")
    deltas = {k: 0 for k in table["counters"]}
    deltas.update(S=300, SP=1, K5=1, K6=1, K2=79)
    counts = {"slice_strip_kernel": 301, "syrk_tn_wgmma_kernel": 1,
              "slice_matmul_wgmma_kernel": 79}
    assert tracing.kernel_mismatch(counts, deltas, table) == []
    counts["slice_strip_kernel"] = 300          # the profiler lost one
    bad = tracing.kernel_mismatch(counts, deltas, table)
    assert len(bad) == 1 and "slice_strip_kernel: 300" in bad[0]
    counts["slice_strip_kernel"] = 301
    counts["syrk_tn_combine_kernel"] = 1        # at most K6 + K7
    assert tracing.kernel_mismatch(counts, deltas, table) == []
    counts["syrk_tn_combine_kernel"] = 2
    assert tracing.kernel_mismatch(counts, deltas, table)


def test_mfu_and_roofline_from_the_bound():
    cfg = {"n": 16384, "priors": [None] * 8}
    bound, _ = work.bound_s(*work.vg_work(16384, 8))
    tr = {"busy_s": 0.8, "window_s": 1.0, "calls": 2}

    class Cell:
        config = cfg

    ctx = {"trace": tr, "cell": Cell}
    mfu = harness.load_module(HERE / "metrics" / "vg_mfu.fit.py", "m1")
    roof = harness.load_module(HERE / "metrics" / "kernel_roofline.fit.py",
                               "m2")
    assert mfu.read(ctx) == pytest.approx(100 * bound / 0.5)
    assert roof.read(ctx) == pytest.approx(100 * bound / 0.4)
    ctx["trace"] = dict(tr, busy_s=0.0)       # nothing ran on the device
    assert mfu.read(ctx) is None and roof.read(ctx) is None


def test_window_is_a_closed_loop_that_finishes_its_calls():
    class D:
        def __init__(self):
            self.seen = []

        def prepare(self, i):
            return i

        def call(self, p):
            import time
            time.sleep(0.01)
            return p

        def ok(self, out):
            return True

        def units(self, p):
            return 1

        def keep(self, i, p, out, ok):
            self.seen.append(i)

    d = D()
    recs, t0, t_end, prof = harness.run_window(d, 0.05)
    assert prof is None and len(recs) >= 4
    assert [r[0] for r in recs] == d.seen == list(range(len(recs)))
    assert t_end == recs[-1][2] and recs[-1][1] - t0 < 0.05


def test_benchmark_json_names_its_files():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        cell = harness.Cell(w["name"], bench=b)
        assert cell.metrics(False) and cell.metrics(True)
        assert (HERE / "limits" / f"{w['name']}.json").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(["--workload", "borehole16k.fit", "--seed", str(2**31 + 9),
              "--seconds", "1", "--trace", "0"], ROOT, env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "refused" in p.stderr


def test_run_refuses_without_the_program(tmp_path, monkeypatch):
    """In a folder that holds only BENCHMARK.json and the benchmark, with
    a card made to appear, the run stops before it measures."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(sys, "path", list(sys.path))
    mod = harness.load_module(tmp_path / "portbench" / "run.py", "pb_run_copy")
    rc = mod.main(["--workload", "branin16k.serve", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
