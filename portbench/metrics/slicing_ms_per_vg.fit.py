"""slicing_ms_per_vg.fit: device time of the slicing kernel
(slice_strip_kernel: S, SP, Sb) per evaluation in the traced stretch, in
milliseconds."""

from portbench import readers


def read(ctx):
    tr = readers.traced(ctx)
    if tr is None:
        return None
    return 1e3 * tr["port_s"].get("slice_strip_kernel", 0.0) / tr["calls"]
