"""Seconds from the process's start to the first timed call: imports,
the port's kernel libraries built (the first run in a checkout) or
loaded, inputs made on the card, the cell's shapes warmed up."""


def read(ctx):
    return ctx.setup_s
