"""SMC samplers: waste-free tempering and data annealing."""

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.inference import (
    HMC,
    Target,
    data_annealed_smc,
    waste_free_tempered_smc,
)

OBS = [True, True, False, True, True]


@g.gen
def coins():
    p = g.beta(2.0, 2.0) @ "p"
    for i in range(len(OBS)):
        _ = g.flip(p) @ f"v{i}"


@g.gen
def gauss(s):
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, s) @ "y"


def main(device=None) -> dict:
    device = resolve_device(device)
    # Waste-free tempered SMC with HMC rejuvenation: every MCMC state
    # joins the ensemble.
    target = Target(gauss, (0.5,), g.C["y"].set(torch.tensor(1.0,
                                                             device=device)))
    run = waste_free_tempered_smc(
        target, n_resampled=128, n_moves_per_particle=8, n_temps=15,
        make_request=lambda: HMC(g.S.at["mu"], 0.25, 5),
    )
    r = run(random.key(0, device=device))

    # Data-annealed SMC: assimilate coin flips one at a time.
    schedule = [g.C[f"v{i}"].set(torch.tensor(OBS[i], device=device))
                for i in range(len(OBS))]
    run2 = data_annealed_smc(
        coins, (), schedule, n_particles=2048,
        make_request=lambda: g.Regenerate(g.S.at["p"]), n_moves=1,
    )
    r2 = run2(random.key(1, device=device))
    w = torch.softmax(r2.log_weights, dim=0)
    ps = r2.traces.get_choices()["p"]
    return {"waste_free_log_z": float(r.log_z),
            "ensemble": int(r.log_weights.shape[0]),
            "data_smc_mean_p": float((w * ps).sum()),
            "ess_history": [float(e) for e in r2.ess_history]}


if __name__ == "__main__":
    r = main()
    print("waste-free logZ:", r["waste_free_log_z"],
          "(exact -1.228); ensemble:", r["ensemble"])
    print("data-SMC posterior mean p:", r["data_smc_mean_p"],
          "(exact 0.667); ESS history:",
          [f"{e:.0f}" for e in r["ess_history"]])
