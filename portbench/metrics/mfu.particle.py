"""A filter call's share, in %, of the card's peak: the least time of the
work the window's calls needed (``work/<config>.call_least_s``: 16 bytes
a particle a step, 16 a resampling, at the HBM's rate; the resamplings a
call makes, the mean of the judged calls') over the window's wall."""


def read(ctx):
    w = ctx.window
    least = ctx.work.call_least_s(ctx.driver.n, ctx.steps, w.resamples)
    return 100.0 * least * w.calls / w.span_s
