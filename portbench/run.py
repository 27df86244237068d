"""Runs one cell of the benchmark of andvaranaut_torch once and prints its
result as the last line of standard output.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  With --trace 0 the line holds the cell's
end-to-end metrics, with --trace 1 its per-layer metrics (a short
stretch of the window under torch.profiler).  The run exits with another
code than 0, and prints no result, without a CUDA card (or with fewer
than the cell asks for), without the program beside this folder, where
the run loaded JAX or the JAX package, or where the profiler's kernel
events disagree with the program's launch counters.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: one host thread for the host's numerical libraries: the benchmark is
#: one process, and a thread pool on a host shared with other work made
#: the facade's host stages swing by tens of milliseconds a request
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "OPENBLAS_NUM_THREADS": "1"}


def _finite(obj):
    """The result with every non-finite number as null (strict JSON)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.update(THREADS)
    t = time.perf_counter()
    import torch

    torch.set_num_threads(1)

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(
        args.workload)
    if chips is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"refused: {args.workload} needs {chips} CUDA card(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    t_torch = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    try:
        import andvaranaut_torch
    except ImportError as e:
        print(f"refused: the program is not beside the benchmark ({e})",
              file=sys.stderr)
        return 2
    if ROOT not in Path(andvaranaut_torch.__file__).resolve().parents:
        print(f"refused: andvaranaut_torch was found outside the checkout, "
              f"at {andvaranaut_torch.__file__}", file=sys.stderr)
        return 2
    print(f"setup: import torch {t_torch - t:.3f} s (the card found), "
          f"import andvaranaut_torch {time.perf_counter() - t_torch:.3f} s",
          file=sys.stderr)
    from portbench import harness

    rc, out = harness.result_line(args.workload, args.seed, args.seconds,
                                  bool(args.trace), device="cuda",
                                  chips=chips)
    if rc:
        return rc
    sys.stderr.flush()
    print(json.dumps(_finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
