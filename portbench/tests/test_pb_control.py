"""The check that decides `correct` fails where it should.

On the CPU, at a small size, the rest of a run is driven with the timed
path broken underneath (the harness's look for a card skipped), and
`correct` must come out false: an answer altered where the program
produces it, and half of the training rows left out.  The two cells
have no state that a step carries (no training step) and run on one
chip (no exchange between chips), so those faults do not apply.

On the card (marked gpu), at each cell's own size, the control (the
caller's `control`: the float64 reference in float32 for fit, the
program's own f32 cross-Gram path for serve) is put in the program's
place on three seeds and must fail one of the cell's limits, while the
program itself passes them.
"""

import numpy as np
import pytest
import torch

from portbench import calibrate, harness

SMALL = {"borehole16k.fit": {"config.n": 512, "traffic.block": 256,
                             "traffic.warmup_calls": 1},
         "branin16k.serve": {"config.n": 600, "traffic.points": 300,
                             "traffic.warmup_calls": 1}}


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _run(cell, seconds=0.6):
    rc, out = harness.result_line(cell, 2**31 + 101, seconds, False,
                                  device="cpu", overrides=SMALL[cell])
    assert rc == 0
    return out


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_program_is_correct(cell):
    out = _run(cell)
    assert out["correct"] and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert all(c["value"] < c["limit"] for c in out["checks"].values())


def _alter_fit_answer(monkeypatch):
    from andvaranaut_torch.gp import bigfit

    real = bigfit._nlml_vg

    def broken(*a, **k):
        v, g = real(*a, **k)
        g = g.clone()
        g[1] = g[1] * (1 + 1e-4)
        return v, g

    broken.calls = 0   # the real function counts on its module's name
    monkeypatch.setattr(bigfit, "_nlml_vg", broken)


def _drop_fit_rows(monkeypatch):
    from andvaranaut_torch.gp import bigfit

    real = bigfit._nlml_vg

    def broken(X, y, *a, **k):
        h = X.shape[0] // 2
        return real(X[:h], y[:h], *a, **k)

    broken.calls = 0
    monkeypatch.setattr(bigfit, "_nlml_vg", broken)


def _alter_serve_answer(monkeypatch):
    from andvaranaut_torch.gpmcmc import GPState

    real = GPState.predict

    def broken(self, xnew, jitter=None):
        mu, var = real(self, xnew, jitter)
        mu = mu.copy()
        mu[0] += 1e-4
        return mu, var

    monkeypatch.setattr(GPState, "predict", broken)


def _drop_serve_rows(monkeypatch):
    from andvaranaut_torch.gpmcmc import GPState

    real = GPState.predict

    def broken(self, xnew, jitter=None):
        h = len(self.xin) // 2
        half = GPState(self.kerns, self.ops, self.noise, self.jitter,
                       self.xin[:h], self.yin[:h], self.hypers,
                       device=self.DEVICE)
        return real(half, xnew, jitter)

    monkeypatch.setattr(GPState, "predict", broken)


@pytest.mark.parametrize("cell,fault", [
    ("borehole16k.fit", _alter_fit_answer),
    ("borehole16k.fit", _drop_fit_rows),
    ("branin16k.serve", _alter_serve_answer),
    ("branin16k.serve", _drop_serve_rows)],
    ids=["fit-answer-altered", "fit-half-rows", "serve-answer-altered",
         "serve-half-rows"])
def test_broken_program_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(cell)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


CONTROL_SEEDS = (2**31 + 211, 2**31 + 223, 2**31 + 227)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = harness.Cell(cell)
    limits = c.limits["limits"]
    for seed in CONTROL_SEEDS:
        row = calibrate.readings(c, seed, 1.0, True)
        assert all(row["program"][k] <= v for k, v in limits.items()), row
        ctrl = row["control"]
        assert isinstance(ctrl, str) or any(
            ctrl[k] > v for k, v in limits.items()), row
    assert np.isfinite(list(row["program"].values())).all()
