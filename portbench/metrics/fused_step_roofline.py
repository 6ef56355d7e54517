"""The fused filter step's share, in %, of its roofline: the summed least
time of the launches the profiled calls ran (16 bytes a particle at the
HBM's rate, ``work/<config>.py``) over their summed device time."""

from portbench.metrics import _kernels


def read(ctx):
    ev = _kernels.events(ctx, "fused_step")
    n = _kernels.launches(ev) if ev else None
    if not n:
        return None
    least = n * ctx.work.fused_step_least_s(ctx.driver.n)
    return 100.0 * least / (sum(ev["step"]) / 1e9)
