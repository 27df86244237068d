"""Times the slicing kernel on one CUDA card, for the port in each tree
given (default: this checkout, unless only --plans or --inventory is
given).  Report only.

    python3 tools/slicing_kernels.py [--inventory] [--plans] [TREE ...]

Per case it prints one JSON line: the wrapper's time (CUDA events over
back-to-back calls), the device time per call from torch.profiler split
by kernel name (the kernel alone, whatever the tree's design: one kernel
or two), and the bound (bytes: 8 read and NS written an element, the
pair 8 read too).  The cases: S on K2's first-panel operands at 16384,
block 1024 (A[1024:] and B^T), on a whitened solve's blocks (1 x 1024,
64 x 1024) and on W^T at 16000 (K7 on path A); SP on K10's first window
(K11's operand); K5 on a 16384^2 pair; Sb on 8 and 64 chains of 256^2;
and two host-bound calls, the wrapper on a 64 x 1024 block and the
batched n=256, 8-chain value+grad of the small-n MCMC objective.
Then the device time under the slicing kernels inside one 16k NLML
(`precision.mixed_nlml`, bench data and hypers, block 1024), the fused
16k NLML (ANDVARANAUT_FUSED_PANEL=1) and one 16k value+grad
(`bigfit.nlml_value_and_grad`), beside all kernels' device time and the
wall.

Give two trees (a checkout of the parent commit and this one, in turns:
parent, change, change, parent) to compare them in one process on the
same card.  With --inventory it also records, in this checkout, every
slicing call of those runs and of the path-A value+grad (N 16000, block
1000) and the n=1000 value+grad: its operand's shape, layout and, where
the tree has `slicemm.slice_plan`, the plan.  With --plans it times this
checkout's kernel alone under other strip plans than the one
`slice_plan` picks, at the main path's shapes."""

import json
import os
import subprocess
import sys
from collections import Counter, defaultdict
from pathlib import Path

N, BLOCK, NX = 16384, 1024, 2
N_OFF, BLOCK_OFF, N1 = 16000, 1000, 1000
L_SCALES, KV, GV, JITTER = (0.5, 0.7), 1.0, 1e-4, 1e-6
PEAK_BYTES = 3.35e12
DEV = "cuda"
SLICING_TAGS = ("slice_strip_kernel", "slice_rows", "row_amax")


def events_ms(torch, fn, reps):
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


def device_ms(torch, fn, reps):
    """{kernel name: (device ms per call, launches per call)} over `reps`
    calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            v = by_name[ev.name[:70]]
            v[0] += ev.time_range.elapsed_us() / 1e3 / reps
            v[1] += 1 / reps
    return {k: (round(v[0], 5), v[1]) for k, v in by_name.items()}


def slicing_split(prof):
    """(slicing ms, slicing launches, all kernels' ms) of a device_ms
    result."""
    sl = [v for k, v in prof.items() if any(t in k for t in SLICING_TAGS)]
    return (sum(v[0] for v in sl), sum(v[1] for v in sl),
            sum(v[0] for v in prof.values()))


def make_data(n, seed=0):
    """bench.py's inputs: uniform X, y = sin(3 x0) + x1^2 + noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, NX))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 + 0.01 * rng.normal(size=n)
    return X, y


def f64(torch, *shape, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=DEV,
                       dtype=torch.float64)


def import_tree(tree):
    sys.path.insert(0, str(tree))
    for name in [m for m in sys.modules if m.startswith("andvaranaut_torch")]:
        del sys.modules[name]
    import andvaranaut_torch.gp.bigfit as bigfit
    import andvaranaut_torch.gp.kernels as kernels
    import andvaranaut_torch.gp.panel as panel
    import andvaranaut_torch.gp.precision as precision
    import andvaranaut_torch.gp.slicemm as slicemm
    sys.path.pop(0)
    return bigfit, kernels, panel, precision, slicemm


def kernel_cases(torch, pn, pr, sm):
    """(label, callable, bound ms) of the slicing calls timed."""
    def bnd(elems, ns, extra=0):
        return (elems * (8 + ns) + extra) / PEAK_BYTES * 1e3

    A = f64(torch, N, BLOCK, seed=3)
    B = f64(torch, BLOCK, BLOCK, seed=4)
    x1 = f64(torch, 1, BLOCK, seed=5)
    x64 = f64(torch, 64, BLOCK, seed=6)
    W = f64(torch, N_OFF, N_OFF, seed=7)
    V = f64(torch, N, N, seed=8)
    V.mul_(torch.exp(f64(torch, N, 1, seed=9)))
    hi, lo = pr._pair_split(V)
    del V
    T = torch.tril(f64(torch, N, N, seed=10))
    T.mul_(torch.exp(f64(torch, N, 1, seed=11)))
    thi, tlo = pr._pair_split(T)
    del T
    W8 = torch.tril(f64(torch, 8, 256, 256, seed=12))
    W64 = torch.tril(f64(torch, 64, 256, 256, seed=12))
    win = (slice(BLOCK, None), slice(0, BLOCK))
    rows = N - BLOCK
    yield ("S K2 first panel (A[1024:], B^T)",
           lambda: (sm.slice_operand(A[BLOCK:], 6, kp=BLOCK),
                    sm.slice_operand(B.T, 6, kp=BLOCK)),
           bnd(rows * BLOCK + BLOCK * BLOCK, 6))
    yield ("S A[1024:] 15360x1024", lambda: sm.slice_operand(A[BLOCK:], 6),
           bnd(rows * BLOCK, 6))
    yield ("S B^T 1024x1024", lambda: sm.slice_operand(B.T, 6),
           bnd(BLOCK * BLOCK, 6))
    yield ("S 1x1024", lambda: sm.slice_operand(x1, 6), bnd(BLOCK, 6))
    yield ("S 64x1024", lambda: sm.slice_operand(x64, 6), bnd(64 * BLOCK, 6))
    yield (f"S W^T {N_OFF}^2 (K7 path A, 8 slices)",
           lambda: sm.slice_operand(W.T, 8), bnd(N_OFF * N_OFF, 8))
    yield ("SP K10 first window (15360x1024)",
           lambda: sm.slice_pair_operand(hi[win], lo[win], 6, zero_rows=0),
           bnd(rows * BLOCK, 6))
    yield ("K11 first window", lambda: pn.pair_to_slices(hi, lo, 0, BLOCK,
                                                         BLOCK),
           bnd(rows * BLOCK, 6))
    yield ("K5 16384^2", lambda: pn.pair_to_slices_cols(thi, tlo),
           bnd(N * N, 8))
    yield ("Sb C=8 256^2", lambda: sm.slice_operand_batched(
        W8.transpose(1, 2), 8), bnd(8 * 256 * 256, 8))
    yield ("Sb C=64 256^2", lambda: sm.slice_operand_batched(
        W64.transpose(1, 2), 8), bnd(64 * 256 * 256, 8))


def path_runs(torch, bigfit, kernels, precision, n=N, block=BLOCK):
    """(label, callable) of the 16k NLML, fused NLML and value+grad."""
    X, y = make_data(n)
    Xt = torch.as_tensor(X, device=DEV)
    yt = torch.as_tensor(y, device=DEV)
    l = torch.tensor(L_SCALES, dtype=torch.float64, device=DEV)
    kv = torch.tensor([KV], dtype=torch.float64, device=DEV)
    z = torch.log(torch.tensor([GV, *L_SCALES, KV], dtype=torch.float64))

    def nlml():
        K = kernels.gram(("RBF",), (), Xt, None, l, kv)
        K.diagonal().add_(JITTER + GV)
        return float(precision.mixed_nlml(K, yt, block=block))

    def fused():
        old = os.environ.get("ANDVARANAUT_FUSED_PANEL")
        os.environ["ANDVARANAUT_FUSED_PANEL"] = "1"
        try:
            return nlml()
        finally:
            if old is None:
                del os.environ["ANDVARANAUT_FUSED_PANEL"]
            else:
                os.environ["ANDVARANAUT_FUSED_PANEL"] = old

    def vg():
        v, g = bigfit.nlml_value_and_grad(Xt, yt, z, block=block)
        return float(v), g

    return [("nlml", nlml), ("fused nlml", fused), ("value+grad", vg)]


def host_cases(torch, bigfit, sm):
    """(label, callable, reps) of host-bound calls: the wrapper on a
    whitened solve's small block, and the batched small-n MCMC value+grad
    (n=256, 8 chains: Sb once a call among ~230 other launches a chain)."""
    import numpy as np

    x64 = f64(torch, 64, BLOCK, seed=6)
    X, y = make_data(256)
    rvpack, nlp = bigfit.make_mixed_objective(X, y, block=256, device=DEV)
    rng = np.random.default_rng(3)
    Z = rvpack.z0().numpy()[None] + 0.1 + 0.05 * rng.normal(
        size=(8, rvpack.total))
    return [("S wrapper 64x1024 (host)", lambda: sm.slice_operand(x64, 6),
             200),
            ("batched value+grad n=256 C=8 (host)",
             lambda: nlp.vec_value_and_grad(Z), 10)]


def run_tree(torch, tree):
    bigfit, kernels, pn, pr, sm = import_tree(tree)
    out = []
    for label, fn, reps in host_cases(torch, bigfit, sm):
        out.append(dict(case=label, wrapper_ms=events_ms(torch, fn, reps),
                        kernel_ms=0.0, launches=0, bound_ms=0.0))
    for label, fn, b_ms in kernel_cases(torch, pn, pr, sm):
        prof = device_ms(torch, fn, 10)
        s_ms, s_n, _ = slicing_split(prof)
        out.append(dict(case=label, wrapper_ms=events_ms(torch, fn, 10),
                        kernel_ms=s_ms, launches=s_n, bound_ms=b_ms,
                        device_ms=prof))
        torch.cuda.empty_cache()
    for label, fn in path_runs(torch, bigfit, kernels, pr):
        prof = device_ms(torch, fn, 2)
        s_ms, s_n, busy = slicing_split(prof)
        wall = events_ms(torch, fn, 2)
        out.append(dict(case=label, wall_ms=wall, device_busy_ms=busy,
                        slicing_ms=s_ms, slicing_launches=s_n,
                        slicing_share=s_ms / busy if busy else None))
        torch.cuda.empty_cache()
    return out


def inventory(torch, tree):
    """Every slicing call of the main paths: {path: {shape key: calls}}."""
    bigfit, kernels, pn, pr, sm = import_tree(tree)
    plan = getattr(sm, "slice_plan", None)
    seen = Counter()

    def key(X, pair, ns):
        rows, k = X.shape
        sr, sk = X.stride()
        lay = "k-contiguous" if sk == 1 else ("rows side by side"
                                              if sr == 1 else "strided")
        rp, kp = -(-rows // 64) * 64, -(-k // 32) * 32
        return (f"{'SP' if pair else 'S'} {rows}x{k} {lay} ns={ns}"
                + (f" plan={plan(rp, kp, 1, sk != 1, pair)}" if plan
                   else ""))

    s_op, sp_op = sm.slice_operand, sm.slice_pair_operand

    def s_rec(X, nslices, *a, **kw):
        seen[key(X, False, nslices)] += 1
        return s_op(X, nslices, *a, **kw)

    def sp_rec(Xhi, Xlo, nslices, *a, **kw):
        seen[key(Xhi, True, nslices)] += 1
        return sp_op(Xhi, Xlo, nslices, *a, **kw)

    # the wrappers count their calls on themselves, looked up by name
    s_rec.launches = sp_rec.launches = 0

    mods = (sm, pn)
    old = [(m, {n: getattr(m, n) for n in ("slice_operand",
                                          "slice_pair_operand")
                if hasattr(m, n)}) for m in mods]
    runs = path_runs(torch, bigfit, kernels, pr) + [
        (f"value+grad N={N_OFF} block {BLOCK_OFF}",
         path_runs(torch, bigfit, kernels, pr, N_OFF, BLOCK_OFF)[2][1]),
        (f"value+grad n={N1}", path_runs(torch, bigfit, kernels, pr, N1,
                                         BLOCK)[2][1])]
    result = {}
    try:
        for m in mods:
            if hasattr(m, "slice_operand"):
                m.slice_operand = s_rec
            if hasattr(m, "slice_pair_operand"):
                m.slice_pair_operand = sp_rec
        for label, fn in runs:
            seen.clear()
            fn()
            if DEV == "cuda":
                torch.cuda.synchronize()
            result[label] = dict(sorted(seen.items(), key=lambda kv: -kv[1]))
    finally:
        for m, attrs in old:
            for n, f in attrs.items():
                setattr(m, n, f)
    return result


def plan_sweep(torch, tree):
    """The kernel alone (its C entry on outputs made once) under other
    plans than `slicemm.slice_plan`'s, at the main path's shapes: one
    JSON row a shape, {plan: ms}, the chosen plan first."""
    _, _, _, pr, sm = import_tree(tree)
    lib = sm._slicing_lib()
    stream = torch.cuda.current_stream().cuda_stream
    A = f64(torch, N - BLOCK, BLOCK, seed=3)
    B = f64(torch, BLOCK, BLOCK, seed=4)
    W = f64(torch, N_OFF, N_OFF, seed=7)
    V = f64(torch, N, N, seed=8)
    hi, lo = pr._pair_split(V)
    del V
    Wb = f64(torch, 64, 256, 256, seed=12)
    D = f64(torch, BLOCK, N, seed=13)
    cases = [
        ("S A[1024:]", A, 6, [(8, 2, 512), (16, 2, 512), (4, 1, 1024),
                              (2, 1, 1024)]),
        ("S B^T", B.T, 6, [(8, 2, 512), (16, 2, 512), (16, 1, 1024)]),
        (f"S {N - BLOCK}x{BLOCK} side by side", D[:, :N - BLOCK].T, 6,
         [(8, 2, 512), (8, 1, 1024), (16, 1, 1024), (4, 1, 1024)]),
        (f"S {BLOCK}x{N} along k", D, 8, [(4, 16, 1024), (8, 8, 2048)]),
        (f"S W^T {N_OFF}^2", W.T, 8, [(16, 16, 1024), (4, 16, 1024),
                                     (8, 8, 2016)]),
        ("SP window", (hi[BLOCK:, :BLOCK], lo[BLOCK:, :BLOCK]), 6,
         [(8, 2, 512), (16, 2, 512), (4, 1, 1024)]),
        ("K5", (hi.T, lo.T), 8, [(16, 16, 1024), (4, 16, 1024),
                                 (8, 8, 2048)]),
        ("Sb C=64", Wb.transpose(1, 2), 8, [(8, 1, 256), (16, 2, 128)]),
        ("Sb C=8", Wb[:8].transpose(1, 2), 8, [(16, 1, 256), (8, 1, 256)]),
    ]
    out = []
    for label, X, ns, others in cases:
        pair = isinstance(X, tuple)
        Xh = X[0] if pair else X
        nb = Xh.shape[0] if Xh.dim() == 3 else 1
        rows, k = Xh.shape[-2:]
        rows_p, kp = -(-rows // 64) * 64, -(-k // 32) * 32
        chosen = sm.slice_plan(rows_p, kp, nb, Xh.stride(-1) != 1, pair)
        o = torch.empty((nb, rows_p // 64, kp // 32, ns, 2048),
                        dtype=torch.int8, device=DEV)
        sc = torch.empty((nb, rows), dtype=torch.float64, device=DEV)
        times = {}
        for plan in [chosen] + others:
            if pair:
                args = (X[0].data_ptr(), X[1].data_ptr(), *Xh.stride(),
                        rows, k, 0, rows_p, kp, ns, *plan, sc.data_ptr(),
                        o.data_ptr(), stream)
                fn = lib.slice_pair_rows
            elif nb > 1:
                args = (Xh.data_ptr(), *Xh.stride(), nb, rows, k, rows_p, kp,
                        ns, *plan, sc.data_ptr(), o.data_ptr(), stream)
                fn = lib.slice_rows_batched
            else:
                args = (Xh.data_ptr(), *Xh.stride(), rows, k, rows_p, kp, ns,
                        *plan, sc.data_ptr(), o.data_ptr(), stream)
                fn = lib.slice_rows
            if fn(*args) != 0:
                times[str(plan)] = "refused"
                continue
            times[str(plan)] = events_ms(torch, lambda: fn(*args), 20)
        out.append(dict(case=label, plans=times))
    return out


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("slicing_kernels: no CUDA device", file=sys.stderr)
        return 1
    inv, sweep = "--inventory" in argv, "--plans" in argv
    argv = [a for a in argv if a not in ("--inventory", "--plans")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    here = Path(__file__).resolve().parent.parent
    # no tree given: this checkout, unless only --plans / --inventory
    trees = [Path(t).resolve() for t in argv] or (
        [] if sweep or inv else [here])
    for tree in trees:
        for row in run_tree(torch, tree):
            print(json.dumps(dict(tree=str(tree), **row)), flush=True)
    if sweep:
        for row in plan_sweep(torch, here):
            print(json.dumps(dict(tree=str(here), **row)), flush=True)
    if inv:
        for path, calls in inventory(torch, here).items():
            print(json.dumps(dict(tree=str(here), inventory=path,
                                  calls=calls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
