#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (andvaranaut_torch) on one NVIDIA GPU.

Phases, each printed as it runs:
  1. the card (nvidia-smi name and power limit) and the kernels' build;
  2. every CUDA kernel of the main path (K1 syrk_sub_pair, K2
     slice_matmul, K3 chol_inv_block) against its plain PyTorch version
     on the card, at the shapes the 16k factorisation gives it, with
     kernel, plain and library times and the bound from its shapes;
  3. the bench.py workload through the port: Gram plus mixed NLML at
     N=16384, nx=2, RBF, block 1024, against f64 Cholesky on the card,
     with each kernel's launch count in that run;
  4. GPState serving: condition on 16384 rows once, answer 3 requests of
     2048 points, against the exact f64 path on the card.

The last two lines are a {"kernels": [...]} JSON line and
{"ok": true, "device": {...}}.  Any failure exits non-zero without the
ok line; so does a machine without CUDA or a directory without the port.

    python3 chip_smoke.py
"""

import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

N = 16384
NX = 2
BLOCK = 1024
REPS = 3
L_SCALES = (0.5, 0.7)
KV, GV, JITTER = 1.0, 1e-4, 1e-6
SERVE_REQUESTS = 3
SERVE_POINTS = 2048

# published H100 SXM peaks (dense): int8 tensor cores, f64 tensor cores,
# HBM3 bandwidth
PEAK_INT8_OPS = 1979e12
PEAK_F64_FLOPS = 67e12
PEAK_BYTES = 3.35e12

NLML_RTOL = 1e-6
# Predictions: the mean at the 1e-8 grade of tests/test_gp_engine.py;
# the variance at 1e-5, not that test's 1e-6: kss - |L^-1 k*|^2 cancels
# against the 1e-4 noise floor, and the whitened solve's 6-slice products
# (~2^-42 of their operands' maxima) accumulate over the block steps.
# The JAX reference's own mixed path misses 1e-6 the same way
# (tests/test_torch_engine.py::test_mixed_variance_grade_matches_reference);
# PERF.md gives the measured values.
MU_RTOL, VAR_RTOL, ATOL = 1e-8, 1e-5, 1e-10

FAILURES = []


def check(name, ok, detail):
    print(f"[{'PASS' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    if not ok:
        FAILURES.append(name)


def make_data(n, nx=NX, seed=0):
    """bench.py's inputs: uniform X, y = sin(3 x0) + x1^2 + noise."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, nx))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 + 0.01 * rng.normal(size=n)
    return X, y


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = out.strip().splitlines()
    return lines[0] if lines else "nvidia-smi gave no output"


def bound(ops, nbytes, peak_ops):
    t_ops = ops / peak_ops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class Phases:
    def __init__(self, torch):
        import andvaranaut_torch.gp.cholinv as cholinv
        import andvaranaut_torch.gp.engine as engine
        import andvaranaut_torch.gp.kernels as kernels
        import andvaranaut_torch.gp.precision as precision
        import andvaranaut_torch.gp.slicemm as slicemm
        from andvaranaut_torch import gpmcmc

        self.torch = torch
        self.dev = torch.device("cuda")
        self.cholinv, self.engine, self.kernels = cholinv, engine, kernels
        self.precision, self.slicemm, self.gpmcmc = precision, slicemm, gpmcmc
        self.rows = {}
        self.serve_counts = {}

    # -- helpers ---------------------------------------------------------
    def ms(self, fn, reps, warm=1):
        torch = self.torch
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def wall_ms(self, fn):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    def reset_counts(self):
        self.slicemm.slice_matmul.launches = 0
        self.slicemm.syrk_sub_pair_.launches = 0
        self.cholinv.chol_inv_block.launches = 0
        self.precision._chol_fallback.calls = 0

    def counts(self):
        return {"K1": self.slicemm.syrk_sub_pair_.launches,
                "K2": self.slicemm.slice_matmul.launches,
                "K3": self.cholinv.chol_inv_block.launches,
                "K3_fallback": self.precision._chol_fallback.calls}

    def f64(self, *shape, seed):
        g = self.torch.Generator(device=self.dev).manual_seed(seed)
        return self.torch.randn(*shape, generator=g, device=self.dev,
                                dtype=self.torch.float64)

    # -- phase 2: kernels against their plain versions -------------------
    def k1(self):
        torch, sm = self.torch, self.slicemm
        m, k, rs = N, BLOCK, BLOCK
        panel = self.f64(m, k, seed=1)
        panel[:rs] = 0.0
        hi0, lo0 = self.precision._pair_split(self.f64(m, m, seed=2))
        h1, l1 = hi0.clone(), lo0.clone()
        h2, l2 = hi0.clone(), lo0.clone()
        sm.syrk_sub_pair_(h1, l1, panel, row_start=rs)
        sm.syrk_sub_pair_plain_(h2, l2, panel, row_start=rs)
        torch.cuda.synchronize()
        got = h1.double() + l1.double()
        want = h2.double() + l2.double()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        del got, want
        c0 = rs // 256 * 256
        t = torch.arange(m - c0, device=self.dev) // 256
        upper = t[:, None] < t[None, :]
        passthrough = (
            torch.equal(h1[:c0], hi0[:c0]) and torch.equal(l1[:c0], lo0[:c0])
            and torch.equal(h1[:, :c0], hi0[:, :c0])
            and torch.equal(h1[c0:, c0:][upper], hi0[c0:, c0:][upper])
            and torch.equal(l1[c0:, c0:][upper], lo0[c0:, c0:][upper]))
        bitexact = torch.equal(h1, h2) and torch.equal(l1, l2)
        check("K1 vs plain (16384 carry, panel 16384x1024, row_start 1024)",
              rel <= 1e-12 and passthrough,
              f"max_abs_err={err:.3e} rel={rel:.3e} (limit 1e-12) "
              f"bit_exact={bitexact} passthrough_bit_exact={passthrough}")
        n0 = sm.syrk_sub_pair_.launches
        sm.syrk_sub_pair_(h1, l1, torch.zeros_like(panel), row_start=m)
        torch.cuda.synchronize()
        check("K1 all-dead row_start=16384",
              torch.equal(h1, h2) and sm.syrk_sub_pair_.launches == n0,
              "carry unchanged, no launch")
        del h2, l2
        ms = self.ms(lambda: sm.syrk_sub_pair_(h1, l1, panel, row_start=rs),
                     reps=3)
        h2, l2 = hi0.clone(), lo0.clone()
        plain_ms = self.ms(
            lambda: sm.syrk_sub_pair_plain_(h2, l2, panel, row_start=rs),
            reps=2)
        del h2, l2
        P = panel[c0:]
        lib_ms = self.ms(lambda: torch.matmul(P, P.T), reps=3)
        T = (m - c0) // 256
        elems = T * (T + 1) // 2 * 256 * 256
        npairs = sm.INT_NSLICES * (sm.INT_NSLICES + 1) // 2
        b_ms, b_by = bound(elems * k * 2 * npairs,
                           (m - c0) * k * 8 + elems * 16, PEAK_INT8_OPS)
        self.rows["K1"] = dict(
            name="K1 syrk_sub_pair_", source="andvaranaut_torch/csrc/slicemm.cu",
            replaces="andvaranaut_tpu/gp/pallas_slicemm.py:476",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms)
        print(f"  K1 ms={ms:.3f} plain_ms={plain_ms:.3f} "
              f"library_ms(f64 matmul)={lib_ms:.3f} bound_ms={b_ms:.3f} "
              f"({b_by})", flush=True)

    def _k2_case(self, label, A, B, limit=1e-14, **kw):
        sm = self.slicemm
        got = sm.slice_matmul(A, B, **kw)
        want = sm.slice_matmul_plain(A, B, **kw)
        self.torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-300)
        check(f"K2 vs plain {label}", rel <= limit,
              f"max_abs_err={err:.3e} rel={rel:.3e} (limit {limit:g}) "
              f"bit_exact={bool(self.torch.equal(got, want))}")
        return err

    def k2(self):
        torch, sm = self.torch, self.slicemm
        m, k, rs = N, BLOCK, BLOCK
        A = self.f64(m, k, seed=3)
        B = self.f64(k, k, seed=4)
        err = self._k2_case("panel 16384x1024 @ 1024x1024 row_start=1024",
                            A, B, row_start=rs)
        ms = self.ms(lambda: sm.slice_matmul(A, B, row_start=rs), reps=5)
        plain_ms = self.ms(
            lambda: sm.slice_matmul_plain(A, B, row_start=rs), reps=2)
        Al = A[rs:]
        lib_ms = self.ms(lambda: torch.matmul(Al, B), reps=5)
        npairs = sm.INT_NSLICES * (sm.INT_NSLICES + 1) // 2
        n = B.shape[1]
        b_ms, b_by = bound((m - rs) * k * n * 2 * npairs,
                           (m - rs) * k * 8 + k * n * 8 + m * n * 8,
                           PEAK_INT8_OPS)
        self.rows["K2"] = dict(
            name="K2 slice_matmul", source="andvaranaut_torch/csrc/slicemm.cu",
            replaces="andvaranaut_tpu/gp/pallas_slicemm.py:1140",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms)
        print(f"  K2 panel ms={ms:.3f} plain_ms={plain_ms:.3f} "
              f"library_ms(f64 matmul)={lib_ms:.3f} bound_ms={b_ms:.3f} "
              f"({b_by})", flush=True)
        del A, B, Al
        # contract flags at 2048 x 1024 @ 1024 x 2048
        A = self.f64(2048, k, seed=5)
        B = self.f64(k, 2048, seed=6)
        self._k2_case("lower_only", A, B, lower_only=True)
        self._k2_case("col_start=1024", A, B, col_start=1024)
        Bz = B.clone()
        Bz[:, 1280:] = 0.0
        self._k2_case("col_end=1280", A, Bz, col_end=1280)
        self._k2_case("row_start=700 (straddles a tile)", A, B,
                      row_start=700)
        # diagonal recursion: 512^3 at 8 slices
        A = self.f64(512, 512, seed=7) * 100.0
        B = self.f64(512, 512, seed=8)
        self._k2_case("compose 512^3 at 8 slices", A, B, nslices=8)
        c_ms = self.ms(lambda: sm.slice_matmul(A, B, nslices=8), reps=10)
        print(f"  K2 compose ms={c_ms:.3f}", flush=True)
        # prediction solves: (15360 x 1024) and (1024 x 1024) @ (1024 x 2048)
        A = self.f64(m - k, k, seed=9)
        B = self.f64(k, SERVE_POINTS, seed=10)
        self._k2_case("predict 15360x1024 @ 1024x2048", A, B)
        self._k2_case("predict 1024x1024 @ 1024x2048", A[:k], B)

    def k3(self):
        torch, ci = self.torch, self.cholinv
        X, _ = make_data(N)
        Xt = torch.as_tensor(X[:512], device=self.dev)
        l = torch.tensor(L_SCALES, dtype=torch.float64, device=self.dev)
        kv = torch.tensor([KV], dtype=torch.float64, device=self.dev)
        G = self.kernels.gram(("RBF",), (), Xt, None, l, kv)
        G.diagonal().add_(JITTER + GV)
        errs = []
        for b in (256, 512):
            A = G[:b, :b].contiguous()
            L, Xi, ok = ci.chol_inv_block(A)
            d = ci.pow2_sqrt_scales(torch.diagonal(A))
            Lp, Xp, okp = ci.chol_inv_plain(A / d[:, None] / d[None, :])
            Lp, Xp = Lp * d[:, None], Xp * (1.0 / d)[None, :]
            torch.cuda.synchronize()
            eL = float((L - Lp).abs().max())
            eX = float((Xi - Xp).abs().max())
            rL = eL / float(Lp.abs().max())
            rX = eX / float(Xp.abs().max())
            eye = torch.eye(b, dtype=torch.float64, device=self.dev)
            res = float((Xi @ L - eye).abs().max())
            check(f"K3 vs plain b={b} (bench Gram block)",
                  bool(ok) and bool(okp) and rL <= 1e-10 and rX <= 1e-8,
                  f"L rel={rL:.3e} (limit 1e-10) X rel={rX:.3e} (limit 1e-8) "
                  f"|XL-I|={res:.3e} ok={bool(ok)}/{bool(okp)}")
            errs.append(max(eL, eX))
        nonpd = A - 2.0 * torch.eye(512, dtype=torch.float64, device=self.dev)
        _, _, ok = ci.chol_inv_block(nonpd)
        check("K3 ok gate on a non-PD block", not bool(ok), f"ok={bool(ok)}")
        ms = self.ms(lambda: ci.chol_inv_block(A), reps=10)
        As = A / d[:, None] / d[None, :]
        plain_ms = self.ms(lambda: ci.chol_inv_plain(As), reps=10)
        eye = torch.eye(512, dtype=torch.float64, device=self.dev)
        lib_ms = self.ms(lambda: torch.linalg.solve_triangular(
            torch.linalg.cholesky(A), eye, upper=False), reps=10)
        b = 512
        b_ms, b_by = bound(2 * b ** 3 / 3, 3 * b * b * 8, PEAK_F64_FLOPS)
        self.rows["K3"] = dict(
            name="K3 chol_inv_block", source="andvaranaut_torch/csrc/cholinv.cu",
            replaces="andvaranaut_tpu/gp/pallas_cholinv.py:362",
            max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms)
        print(f"  K3 b=512 ms={ms:.3f} plain_ms={plain_ms:.3f} "
              f"library_ms(f64 cholesky+solve_triangular)={lib_ms:.3f} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)

    # -- phase 3: the 16k mixed NLML --------------------------------------
    def nlml(self):
        torch = self.torch
        X, y = make_data(N)
        Xt = torch.as_tensor(X, device=self.dev)
        yt = torch.as_tensor(y, device=self.dev)
        l = torch.tensor(L_SCALES, dtype=torch.float64, device=self.dev)
        kv = torch.tensor([KV], dtype=torch.float64, device=self.dev)

        def gram():
            K = self.kernels.gram(("RBF",), (), Xt, None, l, kv)
            K.diagonal().add_(JITTER + GV)
            return K

        def mixed():
            return float(self.precision.mixed_nlml(gram(), yt, block=BLOCK))

        def exact():
            return float(self.engine.chol_nlml(gram(), yt))

        self.reset_counts()
        first_ms, val = self.wall_ms(mixed)
        self.main_counts = self.counts()
        ref_times = []
        for _ in range(REPS):
            t, ref = self.wall_ms(exact)
            ref_times.append(t)
        times = []
        for _ in range(REPS):
            t, v = self.wall_ms(mixed)
            times.append(t)
        rel = abs(val - ref) / abs(ref)
        check("16k mixed NLML vs f64 cholesky on the card", rel <= NLML_RTOL,
              f"mixed={val:.10e} f64={ref:.10e} rel={rel:.3e} "
              f"(limit {NLML_RTOL:g}); repeat drift {abs(v - val):.3e}")
        c = self.main_counts
        check("16k NLML went through K1, K2, K3",
              c["K1"] > 0 and c["K2"] > 0 and c["K3"] > 0,
              f"launches K1={c['K1']} K2={c['K2']} K3={c['K3']}")
        check("16k NLML K3 fallbacks", c["K3_fallback"] == 0,
              f"fallbacks={c['K3_fallback']}")
        print(f"  nlml_ms median={statistics.median(times):.2f} "
              f"(runs {', '.join(f'{t:.2f}' for t in times)}; first "
              f"{first_ms:.2f}) f64_cholesky_nlml_ms median="
              f"{statistics.median(ref_times):.2f}; both include the Gram",
              flush=True)
        try:  # a diagnostic: its absence does not fail the run
            self.profile(mixed)
        except (RuntimeError, AttributeError, ImportError) as e:
            print(f"  profile unavailable: {e!r}", flush=True)

    def profile(self, fn):
        """Device time by kernel over one evaluation, and the device's
        busy share of the wall time (kernels run on one stream, so their
        durations do not overlap)."""
        from collections import defaultdict

        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name = defaultdict(lambda: [0.0, 0])
        for ev in prof.events():
            if ev.device_type != DeviceType.CUDA:
                continue
            label = ev.name
            for tag, short in (("syrk_sub_pair_kernel", "K1"),
                               ("slice_matmul_kernel", "K2"),
                               ("cholinv_kernel", "K3")):
                if tag in label:
                    label = short
            by_name[label][0] += ev.time_range.elapsed_us()
            by_name[label][1] += 1
        busy = sum(v[0] for v in by_name.values())
        print(f"  profile: wall_ms={wall_us / 1e3:.2f} device_busy_ms="
              f"{busy / 1e3:.2f} busy_share={busy / wall_us:.3f}",
              flush=True)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        for name, (us, count) in top:
            print(f"    {us / 1e3:9.3f} ms {count:6d}x  {name[:90]}",
                  flush=True)

    # -- phase 4: GPState serving at 16k ----------------------------------
    def serving(self):
        torch, gpm, eng = self.torch, self.gpmcmc, self.engine
        X, y = make_data(N)
        rng = np.random.default_rng(1)
        reqs = [rng.uniform(size=(SERVE_POINTS, NX))
                for _ in range(SERVE_REQUESTS)]
        hypers = {"l": np.array(L_SCALES), "kv": np.array([KV]),
                  "gv": np.array(GV)}
        self.reset_counts()
        st = gpm.GPState(("RBF",), (), True, JITTER, X, y, hypers)
        cond_ms, _ = self.wall_ms(st.chol)
        outs, req_ms = [], []
        for q in reqs:
            t, out = self.wall_ms(lambda q=q: st.predict(q))
            outs.append(out)
            req_ms.append(t)
        self.serve_counts = self.counts()
        check("GPState at 16k took the mixed path", st._mixed()
              and st.chol()[4] is not None, f"launches {self.serve_counts}")
        l, kv, gv, alpha = st.hyper_args()
        xin_p, yin_p, valid = eng.pad_data(X, y, 32, device=self.dev)
        L0, v0 = eng.chol_state_masked(("RBF",), (), xin_p, yin_p, valid, l,
                                       kv, gv, alpha, JITTER)
        emu = evar = 0.0
        ok = True
        for q, (mu, var) in zip(reqs, outs):
            mu0, var0 = eng.predict_from_chol_masked(
                ("RBF",), (), xin_p, valid, L0, v0,
                torch.as_tensor(q, device=self.dev), l, kv, gv, alpha)
            mu0, var0 = mu0.cpu().numpy(), var0.cpu().numpy()
            ok &= bool(np.allclose(mu, mu0, rtol=MU_RTOL, atol=ATOL))
            ok &= bool(np.allclose(var, var0, rtol=VAR_RTOL, atol=ATOL))
            emu = max(emu, float(np.max(np.abs(mu - mu0) / np.abs(mu0))))
            evar = max(evar, float(np.max(np.abs(var - var0) / np.abs(var0))))
            ok &= bool(np.isfinite(mu).all() and np.isfinite(var).all())
            ok &= mu.shape == var.shape == (SERVE_POINTS,)
        check("GPState 16k predictions vs exact f64 on the card", ok,
              f"mu max rel={emu:.3e} (rtol {MU_RTOL:g}, atol {ATOL:g}) "
              f"var max rel={evar:.3e} (rtol {VAR_RTOL:g})")
        us = sum(req_ms) / (SERVE_REQUESTS * SERVE_POINTS) * 1e3
        print(f"  conditioning_ms={cond_ms:.2f} request_ms="
              f"{', '.join(f'{t:.2f}' for t in req_ms)} predict_us_per_point="
              f"{us:.3f}", flush=True)


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from andvaranaut_torch import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    try:
        _build.build_all()
    except RuntimeError as e:
        print(f"[FAIL] build: {e}", flush=True)
        return 1
    print(f"build_seconds={time.perf_counter() - t0:.1f}", flush=True)
    for src, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}", flush=True)

    ph = Phases(torch)
    for name in ("k1", "k2", "k3", "nlml", "serving"):
        print(f"== {name}", flush=True)
        try:
            getattr(ph, name)()
        except Exception:  # a failed phase is reported, the rest still run
            traceback.print_exc(file=sys.stdout)
            FAILURES.append(name)
        torch.cuda.empty_cache()

    counts = getattr(ph, "main_counts", {})
    print(f"serving launches: {ph.serve_counts}", flush=True)
    rows = []
    for key in ("K1", "K2", "K3"):
        row = dict(ph.rows.get(key, {"name": key}))
        row = {"name": row.get("name", key), "route": "cuda",
               "source": row.get("source"), "replaces": row.get("replaces"),
               "launches": counts.get(key, 0),
               "max_abs_err": row.get("max_abs_err"), "ms": row.get("ms"),
               "plain_ms": row.get("plain_ms"),
               "bound_ms": row.get("bound_ms"),
               "bound_by": row.get("bound_by"),
               "library_ms": row.get("library_ms")}
        rows.append(row)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    if FAILURES:
        print(f"chip_smoke FAILED: {', '.join(FAILURES)}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
