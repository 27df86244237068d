"""How far `bigfit.big_map_fit`'s stop moves with its start and its ftol:
the fit of chip_smoke.py's `map_fit` phase (n = 4096, bench data, block
1024, maxiter 50) from the default start z0 and from z0 (1 + eps), at its
default ftol (1e-7) and at ftol 1e-12, beside L-BFGS-B on the f64 autograd
objective (chip_smoke's `_neg_logpost_f64`) from the same starts at ftol
1e-7 and, once, at ftol 1e-12 (the MAP the phase holds the fit to).  Each
port fit reports L-BFGS-B's stop message, its evaluations, how many of them
the factorisation refused, and its logpost trace.  On one CUDA card, for
the port in each tree given (default: this checkout).  Report only.

    python3 tools/map_fit_starts.py [TREE ...]
"""

import json
import subprocess
import sys
from pathlib import Path

EPS = (0.0, 1e-12, 1e-10, 1e-8)
PORT_FTOLS = (1e-7, 1e-12)


def run_tree(torch, tree):
    import numpy as np
    import scipy.optimize

    sys.path.insert(0, str(tree))
    for name in [m for m in sys.modules
                 if m.startswith("andvaranaut_torch") or m == "chip_smoke"]:
        del sys.modules[name]
    import chip_smoke as cs
    try:
        return _fits(torch, cs, np, scipy.optimize)
    finally:
        sys.path.pop(0)


def _traced(torch, bf, opt):
    """Wraps bigfit's value+grad and scipy's minimize so that a fit leaves
    its evaluations (logL, or the refusal) and its stop message behind."""
    trace = dict(evals=[], results=[])
    inner, minimize = bf._nlml_vg, opt.minimize

    def nlml_vg(*args):
        try:
            v, g = inner(*args)
        except torch.linalg.LinAlgError:
            trace["evals"].append(None)
            raise
        trace["evals"].append(float(v))
        return v, g

    def recorded(*args, **kwargs):
        res = minimize(*args, **kwargs)
        trace["results"].append(res)
        return res

    nlml_vg.calls = 0  # bigfit counts its calls on the module's name
    bf._nlml_vg, opt.minimize = nlml_vg, recorded
    return trace, lambda: (setattr(bf, "_nlml_vg", inner),
                           setattr(opt, "minimize", minimize))


def _fits(torch, cs, np, opt):
    ph = cs.Phases(torch)
    bf = ph.bigfit
    X, y = cs.make_data(cs.FIT_N)
    rv = bf._default_rvpack(cs.NX, ("RBF",), True)
    bounds = bf._log_bounds(cs.NX, ("RBF",), True)
    f64 = ph._neg_logpost_f64(torch.as_tensor(X, device="cuda"),
                              torch.as_tensor(y, device="cuda"), rv)
    z0 = rv.z0().numpy()
    ref = opt.minimize(f64, z0, jac=True, method="L-BFGS-B", bounds=bounds,
                       options={"maxiter": 500, "ftol": 1e-12})
    kv_map = float(np.exp(ref.x[-1]))
    out = [dict(fit="f64 ftol 1e-12", eps=0.0, evals=int(ref.nfev),
                logpost=-float(ref.fun), kv=kv_map, message=str(ref.message))]
    for eps in EPS:
        z = z0 * (1 + eps)
        start = {k: v.numpy() for k, v in rv.unpack(
            torch.as_tensor(z, dtype=torch.float64)).items()}
        for ftol in PORT_FTOLS:
            trace, undo = _traced(torch, bf, opt)
            try:
                h, lp = bf.big_map_fit(X, y, block=cs.BLOCK, maxiter=50,
                                       start=start, ftol=ftol)
            finally:
                undo()
            kv = float(np.asarray(h["kv"]).ravel()[0])
            res = trace["results"][-1]
            out.append(dict(
                fit=f"port, ftol {ftol:g}", eps=eps,
                evals=len(trace["evals"]), nit=int(res.nit),
                refused=sum(v is None for v in trace["evals"]),
                logpost=float(lp), kv=kv, kv_rel=abs(kv - kv_map) / kv_map,
                l=np.asarray(h["l"]).tolist(), message=str(res.message),
                logl_trace=[None if v is None else round(v, 4)
                            for v in trace["evals"]]))
        res = opt.minimize(f64, z, jac=True, method="L-BFGS-B",
                           bounds=bounds,
                           options={"maxiter": 50, "ftol": 1e-7})
        kv = float(np.exp(res.x[-1]))
        out.append(dict(fit="f64 ftol 1e-7", eps=eps, evals=int(res.nfev),
                        logpost=-float(res.fun), kv=kv,
                        kv_rel=abs(kv - kv_map) / kv_map,
                        message=str(res.message)))
    return out


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("map_fit_starts: no CUDA device", file=sys.stderr)
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
