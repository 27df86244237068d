"""vg_ms: the window's wall time over the value+grad evaluations
completed in it, in milliseconds."""

from portbench import readers


def read(ctx):
    t = readers.time_per_call(ctx)
    return None if t is None else t * 1e3
