"""predict_p95_ms: the 95th percentile of request latency over every
request in the window, in milliseconds."""

from portbench import readers


def read(ctx):
    t = readers.latency_quantile(ctx, 95.0)
    return None if t is None else t * 1e3
