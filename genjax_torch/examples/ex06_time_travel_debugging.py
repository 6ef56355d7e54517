"""The time-travel debugger: record frames, navigate, run
counterfactuals.

The port records a frame at each ``rec`` while the function runs, and
resumes by running it again with the frames before the cursor replayed
(eager PyTorch has no jaxpr to cut); the function is deterministic given
its key, so a replay is exact."""

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.core.compiler.interpreters.time_travel import (
    rec,
    time_machine,
)
from genjax_torch.examples import resolve_device


@g.gen
def model(mu):
    x = g.normal(mu, 1.0) @ "x"
    doubled = rec(x * 2.0, name="doubled")
    y = g.normal(doubled, 0.1) @ "y"
    return rec(y + 1.0, name="shifted")


def main(device=None) -> dict:
    device = resolve_device(device)
    key = random.key(0, device=device)
    dbg = time_machine(
        lambda mu: model.simulate(key, (mu,)).get_retval()
    )(torch.tensor(0.5, device=device))
    out = {"debugger": repr(dbg),
           "frame_doubled": float(dbg.jump("doubled").frame.value),
           "final": float(dbg.final)}
    # Counterfactual: what if the doubled value had been 10?
    out["counterfactual"] = float(dbg.resume(
        value=torch.tensor(10.0, device=device)))
    # Re-execute with different arguments:
    out["remix_final"] = float(dbg.remix(
        torch.tensor(5.0, device=device)).final)
    return out


if __name__ == "__main__":
    r = main()
    print(r["debugger"])
    print("frame 'doubled':", r["frame_doubled"])
    print("final:", r["final"])
    print("counterfactual:", r["counterfactual"])
    print("remix(5.0) final:", r["remix_final"])
