"""Variational inference with ADEV gradient estimators: fit the
variational family ``guide`` by ELBO gradient descent.

``vi.ELBO`` returns the gradient estimator of the negative ELBO; each
call runs the reparameterized site of ``guide`` under the port's ADEV
handler on one key and returns the gradient in its argument."""

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.inference import Target, marginal, vi


@g.gen
def model(v):
    mu = g.normal(0.0, 10.0) @ "mu"
    _ = g.normal(mu, 0.1) @ "v"


@marginal()
@g.gen
def guide(target):
    (v,) = target.args
    _ = vi.normal_reparam(v, 0.1) @ "mu"


def main(device=None) -> dict:
    device = resolve_device(device)
    obs = torch.tensor(3.0, device=device)
    elbo_grad = vi.ELBO(guide, lambda v: Target(model, (v,),
                                                g.C["v"].set(obs)))
    v = torch.tensor(0.1, device=device)
    for step in range(200):
        (dv,) = elbo_grad(random.key(step, device=device), (v,))
        v = v - 1e-3 * dv
    return {"learned_v": float(v)}


if __name__ == "__main__":
    print("learned v:", main()["learned_v"], "(posterior mean ≈ 3.0)")
