"""The share, in %, of the ops one filter call dispatches whose innermost
``genjax_torch`` frame is ``core/random.py``: the key layer's part of the
host's issue work."""

import os


def read(ctx):
    if not ctx.ops:
        return None
    key = os.path.join("core", "random.py")
    return 100.0 * ctx.ops.get(key, 0) / sum(ctx.ops.values())
