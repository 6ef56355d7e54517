"""Particle-steps a second: particles × steps of every filter call that
completed in the window, over the window's wall (host clock, from the
first call's start to the last call's ``torch.cuda.synchronize()``;
the loop is closed, so the calls and the harness's bookkeeping between
them fill the window)."""


def read(ctx):
    return ctx.window.work / ctx.window.span_s
