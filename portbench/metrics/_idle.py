"""The device's idle share of the profiled calls."""

from portbench.lib.profile import busy_ns


def idle_share(ctx):
    if ctx.profile is None or not ctx.profile.events:
        return None
    busy = busy_ns(ctx.profile.events) / 1e9
    return 100.0 * (1.0 - busy / ctx.profile.wall_s)
