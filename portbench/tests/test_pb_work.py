"""The work counts and the bound of the value and gradient."""

import pytest

from portbench import work


def test_vg_work_counts():
    n, d = 16384, 8
    flop, nbytes = work.vg_work(n, d)
    entries = n * (n + 1) / 2
    assert flop == n ** 3 + 2 * n * n + entries * (3 * d + 8) + entries * (
        2 + 4 * (d + 2))
    assert nbytes == 8 * (n * d + n + d + 2) + 8 * (d + 3)


def test_bound_at_16384_is_compute_and_2_23_ms():
    t, which = work.bound_s(*work.vg_work(16384, 8))
    assert which == "compute"
    assert t == pytest.approx(2.2276e-3, rel=1e-3)
    # the same work against the f64 tensor-core peak, for people to read
    assert work.vg_work(16384, 8)[0] / work.PEAKS["f64_tensor_flops_per_s"] \
        == pytest.approx(0.0658, rel=1e-2)


def test_bound_takes_bytes_where_they_dominate():
    t, which = work.bound_s(1e6, 1e9)
    assert which == "bytes" and t == pytest.approx(1e9 / 3.35e12)
