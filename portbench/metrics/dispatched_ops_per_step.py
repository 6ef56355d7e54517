"""PyTorch ops one filter call dispatches (a ``TorchDispatchMode`` count,
``lib/profile.ops_by_module``), over its steps: the drivers' host issue
work a step."""


def read(ctx):
    if not ctx.ops:
        return None
    return sum(ctx.ops.values()) / ctx.steps
