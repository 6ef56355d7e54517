"""Tempered SMC: anneal from prior to posterior with HMC rejuvenation.

Under the particle batch ``mu`` has the batch's shape, so it gains the
observations' axis behind it."""

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.inference import HMC, Target, tempered_smc


@g.gen
def model():
    mu = g.normal(0.0, 3.0) @ "mu"
    ones = torch.ones(5, device=mu.device)
    _ = g.mv_normal_diag(mu[..., None] * ones, 0.5 * ones) @ "ys"


def main(device=None) -> dict:
    device = resolve_device(device)
    ys = torch.full((5,), 2.0, device=device)
    target = Target(model, (), g.C["ys"].set(ys))
    run = tempered_smc(
        target, n_particles=2048, n_temps=20,
        make_request=lambda: HMC(g.S.at["mu"], 0.1, 5), n_moves=1,
    )
    result = run(random.key(0, device=device))
    w = torch.softmax(result.log_weights, dim=0)
    mus = result.traces.get_choices()["mu"]
    return {"log_z": float(result.log_z),
            "posterior_mean": float((w * mus).sum()),
            "accept_rates": [float(a) for a in result.accept_rate]}


if __name__ == "__main__":
    r = main()
    print("logZ:", r["log_z"])
    # Exact posterior: precision 1/9 + 5/0.25, mean = 40 / 20.11 ≈ 1.99.
    print("posterior mean:", r["posterior_mean"], "(exact ≈ 1.99)")
    print("rejuvenation accept rates:", r["accept_rates"])
