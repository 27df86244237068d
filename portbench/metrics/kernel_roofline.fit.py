"""kernel_roofline.fit: the value+grad's implementation-independent bound
(`work.vg_work` over the card's int8 peak) over the device's busy time per
evaluation in the traced stretch, in percent."""

from portbench import readers, work


def read(ctx):
    tr = readers.traced(ctx)
    if tr is None:
        return None
    cfg = ctx["cell"].config
    bound, _ = work.bound_s(*work.vg_work(cfg["n"], len(cfg["priors"])))
    return 100.0 * bound / (tr["busy_s"] / tr["calls"])
