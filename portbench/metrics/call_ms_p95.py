"""The 95th percentile, in ms, of the walls of every call in the window
(each from its start to its synchronize, host clock), by linear
interpolation between order statistics."""


def read(ctx):
    walls = sorted(ctx.window.walls)
    pos = 0.95 * (len(walls) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(walls) - 1)
    return 1e3 * (walls[lo] + (walls[hi] - walls[lo]) * (pos - lo))
