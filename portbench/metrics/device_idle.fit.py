"""device_idle.fit: the share of the traced stretch in which no device
operation runs, in percent."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
