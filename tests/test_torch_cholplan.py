"""K3's host table and cluster-size rule (gp/cholinv.py), on the CPU.

The kernel (csrc/cholinv.cu) runs one cluster of `cluster_size(b, C)`
CTAs per block of a batch of C; which CTA holds each 32-row block-row
and solves each 16-column strip of the inverse is `cluster_plan(b,
cluster)`.  These tests hold the table to the kernel's contract (one
owner each, within the cluster, the largest owner's blocks beside the
staging blocks within the shared-memory budget) and the rule to a
function of (b, C) that lets a large batch run in fewer waves.  The
kernel itself is held to the plain version by the card tests of
tests/test_torch_gpu.py.
"""

import numpy as np
import pytest

from andvaranaut_torch.gp import cholinv

SIZES = list(range(32, cholinv.MAX_BLOCK + 1, 32))
BATCHES = [1, 2, 8, 17, 33, 64, 65, 128, 1000]


@pytest.mark.parametrize("b", SIZES)
def test_every_row_and_strip_has_one_owner(b):
    """At every cluster size the rule can pick for b: one owner per
    block-row and per strip, each a CTA of the cluster."""
    nb = b // 32
    for cl in {cholinv.cluster_size(b, C) for C in BATCHES}:
        rows, strips = cholinv.cluster_plan(b, cl)
        assert len(rows) == nb and len(strips) == 2 * nb
        assert all(0 <= o < cl for o in rows + strips)


@pytest.mark.parametrize("b", SIZES)
def test_each_cta_fits_shared_memory(b):
    """The largest owner's blocks (8 KB each) plus the staging blocks
    and the b scales and their reciprocals fit SMEM_MAX at the size the
    rule picks, and `smem_bytes` refuses the sizes that do not fit."""
    for C in BATCHES:
        cl = cholinv.cluster_size(b, C)
        rows, _ = cholinv.cluster_plan(b, cl)
        most = max(sum(i + 1 for i, o in enumerate(rows) if o == c)
                   for c in range(cl))
        need = ((most + cholinv.NSLOT) * 32 * 32 + 2 * b) * 8
        assert need <= cholinv.SMEM_MAX
        assert cholinv.smem_bytes(b, cl) == need
    for cl in cholinv.CLUSTERS:
        got = cholinv.smem_bytes(b, cl)
        rows, _ = cholinv.cluster_plan(b, cl)
        most = max(sum(i + 1 for i, o in enumerate(rows) if o == c)
                   for c in range(cl))
        need = ((most + cholinv.NSLOT) * 32 * 32 + 2 * b) * 8
        assert (got is not None) == (need <= cholinv.SMEM_MAX)


def test_rule_is_a_function_of_b_and_batch():
    """The same (b, C) gives the same size whatever was asked before, and
    the table depends on (b, size) alone."""
    pairs = [(b, C) for b in SIZES for C in BATCHES]
    first = {p: cholinv.cluster_size(*p) for p in pairs}
    rng = np.random.default_rng(0)
    for i in rng.permutation(len(pairs)):
        assert cholinv.cluster_size(*pairs[i]) == first[pairs[i]]
    assert cholinv.cluster_plan(256, 4) == cholinv.cluster_plan(256, 4)


@pytest.mark.parametrize("b", SIZES)
def test_large_batch_runs_in_fewer_waves(b):
    """A single block takes the largest size that fits; a batch whose
    clusters of that size overflow the card's SMs takes a smaller one
    when it fits, and never runs in more waves than the single block's
    size would."""
    def waves(C, cl):
        return -(-C * cl // cholinv.SMS)

    single = cholinv.cluster_size(b, 1)
    for C in BATCHES:
        cl = cholinv.cluster_size(b, C)
        assert cl <= single
        assert waves(C, cl) <= waves(C, single)
    if b == 256:
        # the MCMC benchmark's 64 chains of 256: one wave of 2-CTA
        # clusters where 8-CTA clusters would take four
        assert cholinv.cluster_size(256, 64) == 2
        assert waves(64, 2) == 1 < waves(64, 8)
    if b == 512:
        assert cholinv.cluster_size(512, 64) == 8  # only 8 CTAs hold it

