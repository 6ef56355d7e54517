"""Hierarchical linear regression with NUTS (cross-chain warmup
adaptation) + convergence diagnostics.

Under the chain batch ``slope``, ``icept`` and ``log_sigma`` have the
chains' shape and ``xs`` leads with it, so each gains the points' axis
behind it."""

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.inference import Target, run_nuts, split_rhat

#: The documented sizes: chains, warmup and samples.
SIZES = {"chains": 4, "warmup": 400, "samples": 600}
#: A smaller run of the same program (the CPU tests' live run and the
#: card's smoke run, where the documented size takes minutes).
REHEARSAL = {"warmup": 20, "samples": 20}


@g.gen
def regression(xs):
    slope = g.normal(0.0, 2.0) @ "slope"
    icept = g.normal(0.0, 2.0) @ "icept"
    log_sigma = g.normal(-2.0, 0.5) @ "log_sigma"
    _ = g.mv_normal_diag(
        slope[..., None] * xs + icept[..., None],
        torch.exp(log_sigma)[..., None] * torch.ones_like(xs)) @ "ys"


def main(device=None) -> dict:
    device = resolve_device(device)
    xs = torch.linspace(-1.0, 1.0, 30, device=device)
    ys_obs = 2.0 * xs - 0.5
    target = Target(regression, (xs,), g.C["ys"].set(ys_obs))
    chms, infos = run_nuts(target, random.key(0, device=device),
                           n_chains=SIZES["chains"],
                           num_warmup=SIZES["warmup"],
                           num_samples=SIZES["samples"], max_depth=6)
    slopes = chms["slope"]
    return {"slope_mean": float(slopes.mean()),
            "slope_rhat": float(split_rhat(slopes)),
            "mean_accept": float(infos.accept_prob.mean())}


if __name__ == "__main__":
    r = main()
    print("slope mean:", r["slope_mean"], " (true 2.0)")
    print("slope R-hat:", r["slope_rhat"])
    print("mean accept:", r["mean_accept"])
