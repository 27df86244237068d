"""The `fit` caller: one call is one value and gradient of the GP log
marginal likelihood through the program's mixed-precision path,
`bigfit.nlml_value_and_grad(X, y, z, kerns, block=...)`, at z = z0 +
z_sd N(0, 1) from the run's seed, its value and gradient brought to the
host as NumPy.  X (CDF-mapped inputs) and y (standardised outputs) go to
the card once in set-up.

The control (`control`) is the reference itself in float32.

The check recomputes the objective at the z of a sample of the window's
calls (drawn from the seed) with the plain reference in float64 and
compares: `value_gap`, |logL - logL_ref| / n (nats per run); `grad_rel`,
max |g - g_ref| / max |g_ref|.  Both are the largest over the sample.
"""

from __future__ import annotations

import math
import time

import numpy as np

from .. import design
from ..reference import gp as ref


class Caller:
    def __init__(self, cfg, traffic, seed, device, log):
        import torch
        from andvaranaut_torch.gp import bigfit

        t = time.perf_counter()
        self.bigfit = bigfit
        self.cfg, self.traffic, self.seed, self.device = (
            cfg, traffic, seed, device)
        x, y = design.training_data(cfg, seed)
        self.X = design.to_unit(cfg, x)
        self.y = design.standardise(y)
        self.Xt = torch.as_tensor(self.X, dtype=torch.float64, device=device)
        self.yt = torch.as_tensor(self.y, dtype=torch.float64, device=device)
        h = cfg["hypers"]
        self.z0 = np.log(np.array([h["gv"], *h["l"], h["kv"]], dtype=float))
        self.rng = design.seed_rng(seed, 1)
        self.kept = []
        t1 = time.perf_counter()
        warm = []
        for _ in range(traffic["warmup_calls"]):
            self.call(self.z0)
            warm.append(time.perf_counter() - t1 - sum(warm))
        print(f"setup: data on the card {t1 - t:.3f} s, warm-up calls "
              + ", ".join(f"{w:.3f}" for w in warm) + " s", file=log)

    def prepare(self, i):
        return self.z0 + self.traffic["z_sd"] * self.rng.normal(
            size=self.z0.size)

    def call(self, z):
        v, g = self.bigfit.nlml_value_and_grad(
            self.Xt, self.yt, z, kerns=(self.cfg["kernel"],),
            noise=self.cfg["noise"], jitter=self.cfg["jitter"],
            block=self.traffic["block"], device=self.device)
        return float(v), g.cpu().numpy()

    @staticmethod
    def ok(out):
        return math.isfinite(out[0]) and bool(np.isfinite(out[1]).all())

    @staticmethod
    def units(payload):
        return 1

    def keep(self, i, payload, out, ok):
        if ok:
            self.kept.append((payload, out))

    def release(self):
        del self.Xt, self.yt

    def reference(self, z, dtype="float64"):
        """(logL, grad) of the plain reference at z, in dtype."""
        import torch

        e = np.exp(z)
        v, g = ref.nlml_value_and_grad(
            self.X, self.y, e[0], e[1:-1], e[-1], self.cfg["jitter"],
            self.cfg["kernel"], dtype=getattr(torch, dtype),
            device=self.device)
        return v, np.asarray(g)

    def control(self, payloads):
        """The control's outputs at these calls: the plain reference put
        in the program's place in float32 (TF32 off), the precision below
        the configuration's float64."""
        return [self.reference(z, "float32") for z in payloads]

    def compare(self, outs, refs):
        n = len(self.y)
        return {
            "value_gap": max(abs(o[0] - r[0]) / n for o, r in zip(outs, refs)),
            "grad_rel": max(float(np.max(np.abs(o[1] - r[1]))
                                  / np.max(np.abs(r[1])))
                            for o, r in zip(outs, refs))}

    def sample(self):
        """The checked calls: check_calls of the kept ones, from the seed."""
        rng = design.seed_rng(self.seed, 2)
        k = min(self.traffic["check_calls"], len(self.kept))
        idx = rng.choice(len(self.kept), size=k, replace=False)
        return [self.kept[i] for i in sorted(idx)]
