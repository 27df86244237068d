"""predict_us_per_pt: the window's wall time over the points predicted in
it, in microseconds."""

from portbench import readers


def read(ctx):
    t = readers.time_per_unit(ctx)
    return None if t is None else t * 1e6
