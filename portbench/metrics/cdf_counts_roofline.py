"""The CDF-to-counts kernel's share, in %, of its roofline: the summed
least time of its launches in the profiled calls (8 bytes a particle at
the HBM's rate: read the log-weights, write the counts) over the summed
device time of its two functions."""

from portbench.metrics import _kernels


def read(ctx):
    ev = _kernels.events(ctx, "cdf_counts")
    n = _kernels.launches(ev) if ev else None
    if not n:
        return None
    least = n * ctx.work.cdf_counts_least_s(ctx.driver.n)
    return 100.0 * least / (sum(sum(v) for v in ev.values()) / 1e9)
