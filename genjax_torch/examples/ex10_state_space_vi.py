"""Variational inference with a state-space (Scan) variational family —
reparam sites inside the Scan differentiate pathwise through ADEV.

The Scan of ``guide`` carries the shift through its steps; the port's
ADEV handler carries the tangent of ``shift`` through every step's
reparameterized draw."""

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.inference import Target, marginal, vi

T = 5
#: The documented size: gradient steps.
SIZES = {"steps": 200}
#: A smaller run of the same program (the CPU tests' live run and the
#: card's smoke run, where the documented size takes minutes).
REHEARSAL = {"steps": 20}


@g.gen
def ssm(shift):
    @g.gen
    def step(carry, _):
        x = g.normal(carry, 0.5) @ "x"
        _ = g.normal(x, 0.3) @ "y"
        return x, None

    _ = step.scan(n=T)(shift, None) @ "chain"


@marginal()
@g.gen
def guide(target):
    (shift,) = target.args

    @g.gen
    def gstep(carry, _):
        x = vi.normal_reparam(carry * 0.0 + shift, 0.4) @ "x"
        return x, None

    _ = gstep.scan(n=T)(shift, None) @ "chain"


def observations(device) -> g.ChoiceMap:
    obs = torch.full((T,), 2.0, device=device)
    obs_chm = g.ChoiceMap.empty()
    for t in range(T):
        obs_chm = obs_chm | g.C["chain", t, "y"].set(obs[t])
    return obs_chm


def main(device=None) -> dict:
    device = resolve_device(device)
    obs_chm = observations(device)
    elbo_grad = vi.ELBO(guide, lambda shift: Target(ssm, (shift,), obs_chm))
    shift = torch.tensor(0.0, device=device)
    for i in range(SIZES["steps"]):
        (dv,) = elbo_grad(random.key(i, device=device), (shift,))
        shift = shift - 5e-3 * dv
    return {"trained_mean": float(shift)}


if __name__ == "__main__":
    print("trained guide mean:", main()["trained_mean"],
          "(observations at 2.0)")
