"""host_ms_per_req.serve: per request in the traced stretch, the
benchmark's span around GPMCMC.predict less the device's busy time inside
it, in milliseconds (the mean over the stretch's requests)."""

from portbench import readers


def read(ctx):
    tr = readers.traced(ctx)
    if tr is None:
        return None
    host = [s - b for s, b in zip(tr["span_s"], tr["span_busy_s"])]
    return 1e3 * sum(host) / len(host)
