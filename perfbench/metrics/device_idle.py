"""`device_idle.train`, `device_idle.serve`: the share of the traced
window in which no operation ran on the device, 1 - the union of the
device's operations / the window."""

from perfbench.metrics._common import idle


def read(ctx):
    return idle(ctx)
