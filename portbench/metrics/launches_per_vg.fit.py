"""launches_per_vg.fit: the change of the program's launch counters
(`port_kernels.json`'s launch_counters, each launch once) over the
window, per evaluation."""

from portbench import readers


def read(ctx):
    return readers.launches_per_call(ctx)
