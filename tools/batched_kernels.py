"""Times the chain-batched kernels K3b (`cholinv.chol_inv_blocks`), K3
(`chol_inv_block`) and K7b (`slicemm.syrk_tn_lower_batched`), the batched
slicing Sb (`slice_operand_batched`) and, where the tree has it, K7b's
two-launch form (Sb, then the tn product on its planes), on one CUDA card,
for the port in the tree given (default: this checkout).  Report only.

    python3 tools/batched_kernels.py [TREE ...]

Give two trees (say a checkout of the parent commit and this one, in
turns: parent, change, change, parent) to compare them in one process on
the same card.  Per shape it prints one JSON line: the wrapper's time
(CUDA events over back-to-back calls), the device time per call from
torch.profiler, split by kernel name, and the library call's time (batched
f64 cholesky + solve_triangular, or W^T W)."""

import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

K3B = ((256, 8), (256, 64), (128, 8), (512, 8))
K7B = ((256, 8), (256, 64), (512, 8), (512, 64))
L_SCALES, KV, NOISE = (0.5, 0.7), 1.0, 1e-4 + 1e-6


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
    """{kernel name: device ms per call} over `reps` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name[:60]] += ev.time_range.elapsed_us() / 1e3 / reps
    return dict(by_name)


def spd_batch(torch, C, b, seed):
    """C Gram blocks of the bench kernel (RBF, l (0.5, 0.7), kv 1, noise
    1e-4 + jitter 1e-6) on uniform points."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.rand(C, b, 2, generator=g, device="cuda", dtype=torch.float64)
    X = X / torch.tensor(L_SCALES, dtype=torch.float64, device="cuda")
    K = KV * torch.exp(-0.5 * torch.cdist(X, X) ** 2)
    K.diagonal(dim1=1, dim2=2).add_(NOISE)
    return K


def run_tree(torch, tree):
    sys.path.insert(0, str(tree))
    for name in [m for m in sys.modules if m.startswith("andvaranaut_torch")]:
        del sys.modules[name]
    from andvaranaut_torch.gp import cholinv as ci
    from andvaranaut_torch.gp import slicemm as sm
    sys.path.pop(0)
    out = []
    for b, C in K3B + ((512, 1),):
        A = spd_batch(torch, C, b, seed=11)
        eye = torch.eye(b, dtype=torch.float64, device="cuda")
        fn = ((lambda: ci.chol_inv_block(A[0])) if C == 1
              else (lambda: ci.chol_inv_blocks(A)))
        out.append(dict(
            kernel="K3" if C == 1 else "K3b", b=b, C=C,
            wrapper_ms=events_ms(torch, fn, 20),
            device_ms=device_ms(torch, fn, 10),
            library_ms=events_ms(torch, lambda: torch.linalg.solve_triangular(
                torch.linalg.cholesky(A), eye, upper=False), 20)))
    for n, C in K7B:
        g = torch.Generator(device="cuda").manual_seed(12)
        W = torch.tril(torch.randn(C, n, n, generator=g, device="cuda",
                                   dtype=torch.float64))
        Wt = W.transpose(1, 2)
        row = dict(
            kernel="K7b", n=n, C=C,
            wrapper_ms=events_ms(
                torch, lambda: sm.syrk_tn_lower_batched(W, w_lower=True), 20),
            device_ms=device_ms(
                torch, lambda: sm.syrk_tn_lower_batched(W, w_lower=True), 10),
            sb_wrapper_ms=events_ms(
                torch, lambda: sm.slice_operand_batched(Wt, 8), 20),
            sb_device_ms=device_ms(
                torch, lambda: sm.slice_operand_batched(Wt, 8), 10),
            library_ms=events_ms(torch, lambda: torch.matmul(Wt, W), 20))
        two = getattr(sm, "_syrk_tn_lower_batched_two", None)
        if two is not None:
            row["two_wrapper_ms"] = events_ms(
                torch, lambda: two(W, w_lower=True), 20)
            row["two_device_ms"] = device_ms(
                torch, lambda: two(W, w_lower=True), 10)
            row["two_equal_bits"] = bool(torch.equal(
                two(W, w_lower=True), sm.syrk_tn_lower_batched(W, True)))
            sl, sc = sm.slice_operand_batched(Wt, 8)
            slp, scp = sm.slice_operand_batched_plain(Wt, 8)
            row["sb_equal_bits"] = bool(torch.equal(sl, slp)
                                        and torch.equal(sc, scp))
        out.append(row)
    return out


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("batched_kernels: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    trees = [Path(t).resolve() for t in argv] or [
        Path(__file__).resolve().parent.parent]
    for tree in trees:
        for row in run_tree(torch, tree):
            print(json.dumps(dict(tree=str(tree), **row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
