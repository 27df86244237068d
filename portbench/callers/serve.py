"""The `serve` caller: one call is one `GPMCMC.predict(x,
return_var=True)` on `points` raw points drawn afresh from the priors'
Latin hypercube (from the seed and the call's index).  In set-up the
facade is built with the configuration's priors, conversions, kernel and
hyperparameters (bound by `fit(method='none')`) on the training design,
and `warmup_calls` requests are served.

The control (`control`) is the program with its own f32 path switched
on: the prediction cross-Gram through K9 (`ANDVARANAUT_FAST_GRAM=1`).

The check recomputes a sample of the window's requests (drawn from the
seed) with the plain reference in float64: the conversions, the Gram,
the Cholesky of the training rows, the cross-Gram, the solves and the
reversion.  `mean_gap` is max |mean - mean_ref| / sd(y) over the sampled
points, `var_rel` max |var - var_ref| / var_ref.
"""

from __future__ import annotations

import time

import numpy as np

from .. import design
from ..reference import conversions, gp as ref

#: the facade's scratch directory for its target and mean-function
#: evaluations (it makes one folder a training row in set_data)
RUNDIR = design.HERE / "out" / "runs"


class Caller:
    def __init__(self, cfg, traffic, seed, device, log):
        import andvaranaut_torch.transform as tf
        from andvaranaut_torch import GPMCMC, dists

        t = time.perf_counter()
        self.cfg, self.traffic, self.seed, self.device = (
            cfg, traffic, seed, device)
        self.x, self.y = design.training_data(cfg, seed)
        fn = design.function(cfg["function"])
        priors = [dists.Uniform(lo, hi - lo) for _, lo, hi in cfg["priors"]]
        gp = GPMCMC(nx=len(priors), ny=1, priors=priors,
                    target=lambda row: fn(np.asarray(row)[None])[:1],
                    xconrevs=[tf.uniform(p) for p in priors],
                    kernel=cfg["kernel"], noise=cfg["noise"], verbose=False,
                    device=device, rundir=str(RUNDIR))
        t1 = time.perf_counter()
        gp.set_data(self.x, self.y[:, None])
        t2 = time.perf_counter()
        gp.change_yconrevs([tf.meanstd(gp.y[:, 0])])
        h = cfg["hypers"]
        gp.hypers = {"l": np.array(h["l"], dtype=float),
                     "kv": np.array([h["kv"]], dtype=float),
                     "gv": np.array(h["gv"], dtype=float)}
        gp.fit(method="none", jitter=cfg["jitter"])
        self.gp = gp
        self.kept = {}
        self.states = {}
        for i in range(traffic["warmup_calls"]):
            self.call(self._points(-1 - i))
        print(f"setup: data and facade {t1 - t:.3f} s, set_data "
              f"{t2 - t1:.3f} s, hypers and {traffic['warmup_calls']} warm-up "
              f"requests {time.perf_counter() - t2:.3f} s", file=log)

    def _points(self, i):
        rng = design.seed_rng(self.seed, 3, i % (1 << 62))
        return design.sample_inputs(self.cfg["priors"], rng,
                                    self.traffic["points"])

    def prepare(self, i):
        return self._points(i)

    def call(self, xq):
        mu, var = self.gp.predict(xq, return_var=True,
                                  jitter=self.cfg["jitter"])
        return mu[:, 0], var[:, 0]

    @staticmethod
    def ok(out):
        return bool(np.isfinite(out[0]).all() and np.isfinite(out[1]).all()
                    and (out[1] > 0).all())

    def units(self, payload):
        return len(payload)

    def keep(self, i, payload, out, ok):
        if ok:
            self.kept[i] = out

    def release(self):
        self.gp = None

    def reference(self, xq, dtype="float64"):
        """(mean, var) of the plain reference at raw points xq, in dtype."""
        import torch

        cfg = self.cfg
        safety = cfg["conversions"]["x_safety"]
        a, b = conversions.meanstd(self.y)
        if dtype not in self.states:
            h = cfg["hypers"]
            self.states[dtype] = ref.condition(
                conversions.uniform_inputs(self.x, cfg["priors"], safety),
                a + b * self.y, h["gv"], h["l"], h["kv"], cfg["jitter"],
                cfg["kernel"], dtype=getattr(torch, dtype),
                device=self.device)
        mu, var = ref.predict(
            self.states[dtype],
            conversions.uniform_inputs(xq, cfg["priors"], safety))
        m, v = ref.revert_affine(mu.double().cpu().numpy(),
                                 var.double().cpu().numpy(), a, b)
        return m, v

    def control(self, payloads):
        """The control's outputs at these requests: the program with its
        own lower-precision path switched on, the cross-Gram through the
        f32 tile kernel K9 (ANDVARANAUT_FAST_GRAM=1); set-up must not
        have released the facade."""
        import os

        old = os.environ.get("ANDVARANAUT_FAST_GRAM")
        os.environ["ANDVARANAUT_FAST_GRAM"] = "1"
        try:
            return [self.call(xq) for xq in payloads]
        finally:
            if old is None:
                del os.environ["ANDVARANAUT_FAST_GRAM"]
            else:
                os.environ["ANDVARANAUT_FAST_GRAM"] = old

    def compare(self, outs, refs):
        sd = float(np.std(self.y))
        return {
            "mean_gap": max(float(np.max(np.abs(o[0] - r[0]))) / sd
                            for o, r in zip(outs, refs)),
            "var_rel": max(float(np.max(np.abs(o[1] - r[1]) / r[1]))
                           for o, r in zip(outs, refs))}

    def sample(self):
        """The checked requests: check_calls of the kept ones, from the
        seed, as (points, outputs)."""
        rng = design.seed_rng(self.seed, 2)
        keys = sorted(self.kept)
        k = min(self.traffic["check_calls"], len(keys))
        idx = sorted(rng.choice(len(keys), size=k, replace=False))
        return [(self._points(keys[j]), self.kept[keys[j]]) for j in idx]
