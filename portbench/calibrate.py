"""Readings from which the limits of a cell's check are set: the program's
on many seeds and the control's on a few, in one process on the card.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \
        --control-seeds 1,2,3 [--seconds 4]

The cell runs as committed, at its own size, on the card.  For each
seed it runs the cell's set-up and a short window of its own
traffic, then compares the checked sample of the window's calls with the
float64 reference, as a run does (`program`).  On the control seeds it
also puts the cell's control in the program's place on the same sample
(`control`: the caller's `control`; a control that raises has failed and
gives no number).  Prints one JSON line a seed and writes all of them to
portbench/out/calibrate_<workload>.json.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))


def readings(cell, seed, seconds, control, log=sys.stderr):
    import torch

    from portbench import harness

    caller = cell.caller.Caller(cell.config, cell.traffic, seed, "cuda", log)
    records, t0, t_end, _ = harness.run_window(caller, seconds)
    picked = caller.sample()
    payloads = [p for p, _ in picked]
    row = {"seed": seed, "calls": len(records),
           "failed": sum(1 for r in records if not r[3]),
           "s_per_call": (t_end - t0) / len(records)}
    ctrl = None
    if control:
        try:
            ctrl = caller.control(payloads)
        except Exception as e:  # noqa: BLE001 — a control that fails has
            # failed the check; its error is the reading
            traceback.print_exc()
            row["control"] = f"failed: {e!r}"[:300]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    refs = [caller.reference(p) for p in payloads]
    row["program"] = caller.compare([o for _, o in picked], refs)
    if ctrl is not None:
        row["control"] = caller.compare(ctrl, refs)
    caller.release()
    del caller
    torch.cuda.empty_cache()
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        raise SystemExit("refused: calibration runs on a CUDA card")
    cell = harness.Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    out = HERE / "out" / f"calibrate_{args.workload}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in seeds + sorted(ctrl - set(seeds)):
        t = time.time()
        row = readings(cell, seed, args.seconds, seed in ctrl)
        row["wall_s"] = time.time() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
        out.write_text(json.dumps(rows, indent=1))
    for key in rows[0]["program"]:
        prog = [r["program"][key] for r in rows]
        cons = [r["control"][key] for r in rows
                if isinstance(r.get("control"), dict)]
        print(f"{key}: program max {max(prog)!r} over {len(prog)} seeds; "
              f"control min {min(cons) if cons else None!r} over "
              f"{len(cons)}", flush=True)


if __name__ == "__main__":
    main()
