"""torch_ops_ms_per_vg.fit: device time of the device operations that are
not the program's own kernels (PyTorch's and the libraries' kernels,
copies and fills) per evaluation in the traced stretch, in
milliseconds."""

from portbench import readers


def read(ctx):
    tr = readers.traced(ctx)
    return None if tr is None else 1e3 * tr["other_s"] / tr["calls"]
