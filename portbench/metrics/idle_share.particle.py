"""The device's idle share, in %, over the profiled calls: one less the
union of the device ops' intervals over the calls' host-clock span."""

from portbench.metrics._idle import idle_share


def read(ctx):
    return idle_share(ctx)
